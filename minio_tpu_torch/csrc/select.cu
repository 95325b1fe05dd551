// S3 Select's device functions: CUDA C++ for sm_90a, a plain C interface
// bound with ctypes by minio_tpu_torch/ops/select_step.py.
//
// Four kernels, each held bit for bit against its plain PyTorch version:
//
// * screen_kernel<Q> (K8 select_screen) replaces select_step.screen_chunk
//   (XLA, minio_tpu/ops/select_step.py:184): the SWAR byte classification,
//   the statement's screen (an OR of ANDs of len/deep/byte0/nd/lex atoms),
//   the hazard flags and the per-64-byte block popcount sums.  The u64
//   expressions are carried over verbatim (_swar_eq's borrow between lanes
//   included): no byte compare, no 32-bit halves.
//   Bound: operations, the integer work of the memoized expression a word
//   (chip_smoke.screen_ops: each distinct view W(k), terminator set and
//   digit set once); the plane is read once and cand + blk written once.
//   The first version interpreted a program of 8-int records per word: it
//   recomputed every view and flag set for each atom, found each view's
//   two words and shifts at run time, and read each record from device
//   memory on every thread (2.2x its bound under Q1).  This one runs the
//   memoized expression.  The statement is encoded on the host
//   (select_step.screen_program) as masks of the offsets whose view,
//   terminator flags and nd flags it reads, and as 16-byte atom records
//   over those offsets.  Q, the lookahead in words (1..kMaxQ), is a
//   template argument, so every view is two funnel shifts by constant
//   amounts and, up to kMemoQ, every memo entry a register computed once a
//   word under a warp-uniform mask test; past kMemoQ an entry is computed
//   where an atom reads it.  The memo is pinned at the top of the record
//   loop, so the compiler cannot hoist each atom's work on every entry
//   ahead of the loop.  At Q = 1 a thread screens two words: the mask
//   tests, each record's read and dispatch and the epilogue's addressing
//   are paid once for both.  A thread reads its words straight from the
//   plane (neighbours' loads meet in L1).  The records travel by value in
//   the launch's parameters, the first kParamRecs of them: a constant-bank
//   read, no per-statement symbol (statements of several clients run at
//   once on their own streams) and no build per statement.  Records past
//   kParamRecs (an IN list of some hundred values) come from a device
//   buffer.
// * positions_kernel (K9 select_positions) replaces
//   select_step.extract_positions (:323): one thread per rank, a binary
//   search over the block cumsum (searchsorted, side right, clamped to the
//   last block), the word inside the 8-word block by running popcounts,
//   then the in-word select by halving popcounts.
// * spans_kernel<BACK> (K10 select_spans) replaces select_step.row_spans
//   (:358, BACK = false) and anchors_back (:371, BACK = true): one warp per
//   anchor, each lane looking at 8 consecutive offsets of a 256-offset
//   pass, the nearest newline by a ballot; rows are ~100-200 bytes, so the
//   first pass finds it and the warp stops.
// * gather_kernel (K11 select_gather) replaces select_step.gather_rows
//   (:387): the (C, window) byte gather.  Bound: bytes (the starts read,
//   the rows read and written once); at the path's shape (~10,000 rows of
//   256 bytes) the launch's fixed chain and the host's wrapper call are
//   most of a call.  A group of 1-32 lanes a row (window / 16 lanes, a
//   power of two); an interior row is read as aligned 16-byte chunks,
//   funnel-shifted into place, and written as 16-byte chunks; only rows
//   the clamp touches (and windows not a multiple of 16) take 4 clamped
//   byte loads per 32-bit store.  Any start and any plane offset: the
//   chunks are aligned on the absolute address, and each holds a byte of
//   the row.  The entry takes one packed struct.
//
// Every entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kLo = 0x0101010101010101ull;
constexpr u64 kHi = 0x8080808080808080ull;

constexpr int kScreenThreads = 256;    // threads per screen block
constexpr int kMaxShift = 47;          // largest byte offset a program may read
constexpr int kMaxQ = kMaxShift / 8 + 1;  // lookahead words: 1 .. kMaxQ
constexpr int kMemoQ = 2;              // lookaheads whose memo lives in registers
constexpr int kParamRecs = 128;        // records passed by value
constexpr int kMaxLex = 8;             // select_step.MAX_LEX
constexpr int kPopWords = 8;           // select_step.POP_WORDS

// program records (select_step.screen_program): op = kind | kLast | kFlag
constexpr unsigned kTerms = 1, kRange = 2, kNd = 3, kLex = 4;
constexpr unsigned kLast = 16;  // the last atom of its OR branch
constexpr unsigned kFlag = 32;  // deep's inversion, byte0's lo == 0, lex's len > MAX_LEX
// lex modes (select_step._MODE)
constexpr unsigned kLt = 0, kLe = 1, kEq = 2, kGe = 3, kGt = 4;

constexpr int kPosThreads = 256;
constexpr int kSpanWarps = 8;          // anchors per spans block
constexpr int kGatherThreads = 256;

struct Rec {
  uint32_t op;
  uint32_t arg;  // byte0: the bytes of its two lane constants; lex: mode | n << 8
  u64 m;         // len/deep/nd: the offsets read, as bits; lex: the first n literal bytes
};
static_assert(sizeof(Rec) == 16, "select_step._REC");

// K8's launch parameters, by value
struct ScreenArgs {
  const u64* plane;
  u64* cand;
  int* blk;
  int* scal;
  const Rec* more;  // records kParamRecs.. in device memory, or null
  long long nw;
  u64 vmask, tmask, dmask;  // bit k: the program reads W(k), term_at(k), digit_at(k) (nd)
  u64 fdl, qcl;             // the delimiter and quote bytes in every lane
  int field, sci, nrec, pad_;
  Rec rec[kParamRecs];
};

// a lane flag where the lane equals the byte replicated in c (the borrow
// of (x - kLo) flags the lane after a match too: the reference's
// arithmetic, kept)
__device__ __forceinline__ u64 eq_lanes(u64 w, u64 c) {
  const u64 x = w ^ c;
  return (x - kLo) & ~x & kHi;
}

// lanes >= the byte whose (0x80 - byte) is replicated in b (ASCII lanes)
__device__ __forceinline__ u64 ge_lanes(u64 w, u64 b) {
  return ((w & ~kHi) + b) & kHi;
}

__device__ __forceinline__ u64 term_lanes(u64 w, u64 fdl) {
  return eq_lanes(w, 10 * kLo) | eq_lanes(w, fdl);
}

__device__ __forceinline__ u64 digit_lanes(u64 w) {
  return ge_lanes(w, (0x80 - 0x30) * kLo) & ~ge_lanes(w, (0x80 - 0x3A) * kLo);
}

// the 32-bit x in both halves of a u64
__device__ __forceinline__ u64 both(uint32_t x) { return (u64(x) << 32) | x; }

// x as if changed here: what is computed from it stays after this point
// (the compiler would otherwise hoist each atom's work on every memo
// entry ahead of the record loop, whether or not an atom reads it)
__device__ __forceinline__ void pin(u64& x) { asm volatile("" : "+l"(x)); }

// words a thread screens at lookahead Q: two at Q = 1, where the memo is
// small, so the per-thread work that does not depend on the word (the
// memo's mask tests, each record's read and dispatch, the epilogue's
// addressing) is paid once for both; one past it
template <int Q>
constexpr int kWords = Q == 1 ? 2 : 1;

template <int Q>
__global__ void __launch_bounds__(kScreenThreads)
screen_kernel(const ScreenArgs a) {
  constexpr int K = 8 * Q;  // offsets 0 .. K-1 lie in the lookahead
  constexpr bool kMemo = Q <= kMemoQ;
  constexpr int W = kWords<Q>;
  constexpr int kBlockWords = kScreenThreads * W;
  static_assert(kPopWords % W == 0, "a thread's words lie in one block sum");
  __shared__ int warp_nl[kScreenThreads / 32];
  __shared__ int warp_hz[kScreenThreads / 32];
  const long long i0 = (long long)blockIdx.x * kBlockWords;
  const int t = threadIdx.x;
  const long long i = i0 + (long long)t * W;  // this thread's first word
  // its words, the one before them and the Q after them, straight from
  // the plane (neighbours' loads meet in L1); zero words stand before the
  // plane and past its end
  u64 w[Q + W + 1];
  if (i0 >= 1 && i0 + kBlockWords + Q <= a.nw) {
    const u64* p = a.plane + (i - 1);
#pragma unroll
    for (int j = 0; j < Q + W + 1; ++j) w[j] = __ldg(p + j);
  } else {
#pragma unroll
    for (int j = 0; j < Q + W + 1; ++j) {
      const long long g = i - 1 + j;
      w[j] = (g >= 0 && g < a.nw) ? __ldg(a.plane + g) : 0ull;
    }
  }
  // W(k) of the thread's word x, lanes of bytes p + k: two funnel shifts
  // by constant amounts once the loops below are unrolled (-1 <= k < K)
  auto view = [&](int x, int k) -> u64 {
    const int q = (k + 8) / 8 - 1;  // floor(k / 8)
    const int r = k - 8 * q;
    return r ? (w[x + q + 1] >> (8 * r)) | (w[x + q + 2] << (64 - 8 * r)) : w[x + q + 1];
  };
  auto nd_lanes = [&](u64 v, u64 tv) -> u64 { return ~digit_lanes(v) & ~tv & kHi; };
  // the memo for the offsets the masks name: V(k), term_at(k) and nd's
  // flags ~digit_at(k) & ~term_at(k) (digit_at is read by nd alone)
  u64 V[W][K], T[W][K], N[W][K];
#pragma unroll
  for (int x = 0; x < W; ++x) V[x][1] = view(x, 1);  // the bare-CR hazard reads W(1)
  if constexpr (kMemo) {
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (k > 1 && ((a.vmask >> k) & 1)) {
#pragma unroll
        for (int x = 0; x < W; ++x) V[x][k] = view(x, k);
      }
      if ((a.tmask >> k) & 1) {
#pragma unroll
        for (int x = 0; x < W; ++x) T[x][k] = term_lanes(V[x][k], a.fdl);
        if ((a.dmask >> k) & 1) {
#pragma unroll
          for (int x = 0; x < W; ++x) N[x][k] = nd_lanes(V[x][k], T[x][k]);
        }
      }
    }
  }
  // past kMemoQ each is computed where an atom reads it
  auto Vk = [&](int x, int k) -> u64 {
    if constexpr (kMemo) return V[x][k];
    else return k == 1 ? V[x][1] : view(x, k);
  };
  auto Tk = [&](int x, int k) -> u64 {
    if constexpr (kMemo) return T[x][k];
    else return term_lanes(Vk(x, k), a.fdl);
  };
  auto Nk = [&](int x, int k) -> u64 {
    if constexpr (kMemo) return N[x][k];
    else return nd_lanes(Vk(x, k), Tk(x, k));
  };

  u64 hit[W], bm[W];
#pragma unroll
  for (int x = 0; x < W; ++x) {
    hit[x] = 0;
    bm[x] = kHi;
  }
  for (int r = 0; r < a.nrec; ++r) {
#pragma unroll
    for (int x = 0; x < W; ++x) {
      if constexpr (kMemo) {
#pragma unroll
        for (int k = 1; k < K; ++k) {
          pin(V[x][k]);
          pin(T[x][k]);
          pin(N[x][k]);
        }
      }
    }
    if constexpr (!kMemo) {
#pragma unroll
      for (int j = 0; j < Q + W + 1; ++j) pin(w[j]);
    }
    Rec rec;  // a constant-bank read, or past kParamRecs a device one
    if (r < kParamRecs) rec = a.rec[r];
    else rec = a.more[r - kParamRecs];
    const unsigned kind = rec.op & 15u;
    u64 v[W];
    if (kind == kTerms) {
      // len: a terminator at any offset of the mask; deep: at none
      u64 acc[W];
#pragma unroll
      for (int x = 0; x < W; ++x) acc[x] = 0;
#pragma unroll
      for (int k = 1; k < K; ++k)
        if ((rec.m >> k) & 1) {
#pragma unroll
          for (int x = 0; x < W; ++x) acc[x] |= Tk(x, k);
        }
#pragma unroll
      for (int x = 0; x < W; ++x) v[x] = (rec.op & kFlag) ? ~acc[x] & kHi : acc[x];
    } else if (kind == kRange) {
      // byte0: lanes of W(1) in [lo, hi] (and, for lo 0, ASCII lanes)
      const u64 blo = both(__byte_perm(rec.arg, 0, 0x0000));
      const u64 bhi = both(__byte_perm(rec.arg, 0, 0x1111));
#pragma unroll
      for (int x = 0; x < W; ++x) {
        v[x] = ge_lanes(V[x][1], blo) & ~ge_lanes(V[x][1], bhi);
        if (rec.op & kFlag) v[x] &= ~V[x][1];
      }
    } else if (kind == kNd) {
      // a non-digit, non-terminator byte before the first terminator
      u64 seen[W], h[W];
#pragma unroll
      for (int x = 0; x < W; ++x) seen[x] = h[x] = 0;
#pragma unroll
      for (int k = 1; k < K; ++k)
        if ((rec.m >> k) & 1) {
#pragma unroll
          for (int x = 0; x < W; ++x) {
            h[x] |= Nk(x, k) & ~seen[x];
            seen[x] |= Tk(x, k);
          }
        }
#pragma unroll
      for (int x = 0; x < W; ++x) v[x] = h[x];
    } else {
      // lex: the field against the first n literal bytes, then the
      // terminator at n + 1; byte i of the literal in every lane is one
      // byte permute
      const unsigned mode = rec.arg & 0xFFu, n = rec.arg >> 8 & 0xFFu;
      const uint32_t lit[2] = {uint32_t(rec.m), uint32_t(rec.m >> 32)};
      u64 pref[W], h[W], endv[W];
#pragma unroll
      for (int x = 0; x < W; ++x) {
        pref[x] = kHi;
        h[x] = endv[x] = 0;
      }
      if (mode == kEq) {
#pragma unroll
        for (int i = 0; i <= kMaxLex && i + 1 < K; ++i) {
          if (i < n) {
            const u64 cc = both(__byte_perm(lit[i / 4], 0, (i & 3) * 0x1111));
#pragma unroll
            for (int x = 0; x < W; ++x) pref[x] &= eq_lanes(Vk(x, i + 1), cc);
          } else if (i == n) {
#pragma unroll
            for (int x = 0; x < W; ++x) endv[x] = Tk(x, i + 1);
          }
        }
      } else if (mode <= kLe) {
#pragma unroll
        for (int i = 0; i <= kMaxLex && i + 1 < K; ++i) {
          if (i < n) {
            const uint32_t c4 = __byte_perm(lit[i / 4], 0, (i & 3) * 0x1111);
            const u64 b = both(0x80808080u - c4);
#pragma unroll
            for (int x = 0; x < W; ++x) {
              const u64 wi = Vk(x, i + 1);
              // lanes below c (swar_ge(w, 0) is every lane), or the field ends
              const u64 below = c4 ? ~ge_lanes(wi, b) & kHi : 0;
              h[x] |= pref[x] & (below | Tk(x, i + 1));
              pref[x] &= eq_lanes(wi, both(c4));
            }
          } else if (i == n) {
#pragma unroll
            for (int x = 0; x < W; ++x) endv[x] = Tk(x, i + 1);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i <= kMaxLex && i + 1 < K; ++i) {
          if (i < n) {
            const uint32_t c4 = __byte_perm(lit[i / 4], 0, (i & 3) * 0x1111);
            // lanes above c: swar_ge(w, c + 1) or non-ASCII (0x7F: the latter)
            const u64 b = both((c4 & 0xFFu) < 0x7Fu ? 0x7F7F7F7Fu - c4 : 0u);
#pragma unroll
            for (int x = 0; x < W; ++x) {
              const u64 wi = Vk(x, i + 1);
              const u64 above = (((wi & ~kHi) + b) | wi) & kHi;
              h[x] |= pref[x] & above & ~Tk(x, i + 1);
              pref[x] &= eq_lanes(wi, both(c4));
            }
          } else if (i == n) {
#pragma unroll
            for (int x = 0; x < W; ++x) endv[x] = Tk(x, i + 1);
          }
        }
      }
      const bool over = rec.op & kFlag;
#pragma unroll
      for (int x = 0; x < W; ++x) {
        if (mode == kEq || mode == kLe || mode == kGe) h[x] |= over ? pref[x] : pref[x] & endv[x];
        if (mode == kGt || mode == kGe) h[x] |= pref[x] & ~endv[x];
        if (mode == kLt && over) h[x] |= pref[x];
        v[x] = h[x];
      }
    }
#pragma unroll
    for (int x = 0; x < W; ++x) {
      bm[x] &= v[x];
      if (rec.op & kLast) {
        hit[x] |= bm[x];
        bm[x] = kHi;
      }
    }
  }

  int combo = 0, pn = 0, hz = 0;
  u64 c[W];
#pragma unroll
  for (int x = 0; x < W; ++x) {
    const u64 ww = w[x + 1];
    const u64 nl = eq_lanes(ww, 10 * kLo);
    const u64 base = a.field ? term_lanes(ww, a.fdl) : nl;
    c[x] = base & hit[x];
    u64 haz = eq_lanes(ww, a.qcl) | (eq_lanes(ww, 13 * kLo) & ~eq_lanes(V[x][1], 10 * kLo)) |
              eq_lanes(ww, 0);
    if (a.sci) {
      const u64 e = eq_lanes(ww, 0x65 * kLo) | eq_lanes(ww, 0x45 * kLo);
      haz |= e & digit_lanes(view(x, -1));
    }
    const bool in = i + x < a.nw;
    const int p = in ? __popcll(nl) : 0;
    const int z = in && haz != 0;
    pn += p;
    hz |= z;
    combo += in ? (__popcll(c[x]) | (p << 7) | (z << 14)) : 0;
  }
  // the 8-word block sum over aligned groups of 8 / W lanes
#pragma unroll
  for (int d = 1; d < kPopWords / W; d <<= 1) combo += __shfl_xor_sync(0xffffffffu, combo, d);
  if (i < a.nw) {
    if constexpr (W == 2)
      reinterpret_cast<ulonglong2*>(a.cand)[i / 2] = make_ulonglong2(c[0], c[1]);
    else
      a.cand[i] = c[0];
    if ((t & (kPopWords / W - 1)) == 0) a.blk[i / kPopWords] = combo & 127;
  }
  // nrows sums the blocks' newline fields ((bs >> 7) & 127 <= 64 each,
  // no carry between fields): the sum of every word's newline popcount
  const int wn = __reduce_add_sync(0xffffffffu, pn);
  const int wh = __any_sync(0xffffffffu, hz);
  if ((t & 31) == 0) {
    warp_nl[t >> 5] = wn;
    warp_hz[t >> 5] = wh;
  }
  __syncthreads();
  if (t == 0) {
    int sn = 0, sh = 0;
    for (int q = 0; q < kScreenThreads / 32; ++q) {
      sn += warp_nl[q];
      sh |= warp_hz[q];
    }
    if (sn) atomicAdd(a.scal, sn);
    if (sh) atomicOr(a.scal + 1, 1);
  }
}

__global__ void __launch_bounds__(kPosThreads)
positions_kernel(const u64* __restrict__ cand, const int* __restrict__ cum,
                 int nblk, int cap, int* __restrict__ out) {
  const int k = blockIdx.x * kPosThreads + threadIdx.x;
  if (k >= cap) return;
  // searchsorted(cum, k, side="right"): the first block whose inclusive
  // count exceeds k, clamped to the last block
  int lo = 0, hi = nblk;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= k) lo = mid + 1;
    else hi = mid;
  }
  const int b = min(lo, nblk - 1);
  const int base = b > 0 ? cum[b - 1] : 0;
  const int lr = k - base;
  // the word holding rank lr (argmax of the in-word test: the first
  // such word, else word 0)
  int wsel = 0, psel = 0, pref = 0;
  bool found = false;
  u64 word = cand[(long long)b * kPopWords];
  for (int j = 0; j < kPopWords; ++j) {
    const u64 w = cand[(long long)b * kPopWords + j];
    const int pc = __popcll(w);
    if (!found && pref <= lr && lr < pref + pc) {
      found = true;
      wsel = j;
      psel = pref;
      word = w;
    }
    pref += pc;
  }
  const int need0 = lr - psel + 1;
  u64 need = u64(need0 > 1 ? need0 : 1);
  int p = 0;
  for (int half = 32; half; half >>= 1) {
    const u64 lowmask = (1ull << half) - 1ull;
    const u64 cnt = u64(__popcll(word & lowmask));
    if (cnt < need) {
      need -= cnt;
      word >>= half;
      p += half;
    }
  }
  out[k] = ((b * kPopWords + wsel) << 3) + (p >> 3);
}

template <bool BACK>
__global__ void __launch_bounds__(kSpanWarps * 32)
spans_kernel(const uint8_t* __restrict__ arr, long long n,
             const int* __restrict__ anchors, int count, int window,
             int* __restrict__ out, uint8_t* __restrict__ found) {
  const int lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * kSpanWarps + (threadIdx.x >> 5);
  if (wid >= count) return;  // whole warps leave together
  const long long a = anchors[wid];
  for (int pass = 0; pass < window; pass += 256) {
    int first = -1;
    for (int j = 0; j < 8; ++j) {
      const int off = pass + lane * 8 + j;
      if (off >= window) break;
      long long g = BACK ? a - off : a + 1 + off;
      if (BACK && g < 0) break;  // positions before the plane are no newline
      g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
      if (arr[g] == 10) {
        first = off;
        break;
      }
    }
    const unsigned got = __ballot_sync(0xffffffffu, first >= 0);
    if (got) {
      const int off = __shfl_sync(0xffffffffu, first, __ffs(got) - 1);
      if (lane == 0) {
        out[wid] = BACK ? int(a - off) : off;
        found[wid] = 1;
      }
      return;
    }
  }
  if (lane == 0) {
    out[wid] = BACK ? -1 : 0;
    found[wid] = BACK ? uint8_t(a - (window - 1) <= 0) : 0;
  }
}


// K11's launch parameters, by value
struct GatherArgs {
  const uint8_t* arr;
  const int* starts;
  uint8_t* out;
  long long n;
  int count, window, lg;  // 1 << lg lanes a row
  int pad_;
};

// bytes sh .. sh + 15 of the 32 bytes lo:hi (little-endian)
__device__ __forceinline__ uint4 bytes_at(const uint4 lo, const uint4 hi, unsigned sh) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned q = sh >> 2, r = (sh & 3u) * 8u;
  uint32_t y[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint32_t a = (q & 1u) ? x[j + 1] : x[j];
    const uint32_t b = (q & 1u) ? x[j + 3] : x[j + 2];
    y[j] = (q & 2u) ? b : a;
  }
  return make_uint4(__funnelshift_r(y[0], y[1], r), __funnelshift_r(y[1], y[2], r),
                    __funnelshift_r(y[2], y[3], r), __funnelshift_r(y[3], y[4], r));
}

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const GatherArgs a) {
  const int lanes = 1 << a.lg;
  const int lane = threadIdx.x & (lanes - 1);
  const long long row = ((long long)blockIdx.x * kGatherThreads + threadIdx.x) >> a.lg;
  if (row >= a.count) return;
  const long long s = a.starts[row];
  uint8_t* o = a.out + row * a.window;
  if ((a.window & 15) == 0 && s >= 0 && s + a.window <= a.n) {
    // an interior row: aligned 16-byte chunks, each holding a byte of it
    const uintptr_t p = reinterpret_cast<uintptr_t>(a.arr + s);
    const uint4* src = reinterpret_cast<const uint4*>(p & ~uintptr_t(15));
    const unsigned sh = unsigned(p & 15u);
    for (int j = lane; j < a.window / 16; j += lanes) {
      const uint4 lo = __ldg(src + j);
      const uint4 hi = sh ? __ldg(src + j + 1) : lo;
      reinterpret_cast<uint4*>(o)[j] = bytes_at(lo, hi, sh);
    }
  } else {
    // the clamp repeats the plane's first and last bytes
    for (int j = lane; j < a.window / 4; j += lanes) {
      uint32_t v = 0;
      for (int b = 0; b < 4; ++b) {
        long long g = s + 4 * j + b;
        g = g < 0 ? 0 : (g > a.n - 1 ? a.n - 1 : g);
        v |= uint32_t(a.arr[g]) << (8 * b);
      }
      reinterpret_cast<uint32_t*>(o)[j] = v;
    }
  }
}

template <int Q>
void launch_screen(const ScreenArgs& a, cudaStream_t st) {
  constexpr long long per_block = (long long)kScreenThreads * kWords<Q>;
  const unsigned blocks = (unsigned)((a.nw + per_block - 1) / per_block);
  screen_kernel<Q><<<blocks, kScreenThreads, 0, st>>>(a);
}

// the card the caller names, set only when it is not the current one
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace

extern "C" {

// K8's call, packed by select_step.screen_chunk (_SCREEN_CALL); recs is
// the host address of all nrec records, more their device copy from
// record kParamRecs on (null when nrec <= kParamRecs)
struct ScreenCall {
  uint64_t plane, cand, blk, scal, more, stream, recs;
  long long nw;
  uint64_t vmask, tmask, dmask;
  int device, fd, qc, field, sci, q, nrec, pad;
};
static_assert(sizeof(ScreenCall) == 120, "select_step._SCREEN_CALL");

int mts_screen(const ScreenCall* c) {
  const int q = c->q;
  const Rec* recs = reinterpret_cast<const Rec*>(c->recs);
  // masks inside the instantiation's offsets 1 .. 8q-1, views under
  // every flag set, nd's flags where terminators are, and records that
  // read only what the masks name
  const u64 span = (q >= 1 && q <= kMaxQ) ? ((1ull << (8 * q)) - 2ull) : 0ull;
  if (!span || c->nw <= 0 || c->nw % kPopWords || c->nrec < 0 ||
      (c->nrec > 0 && !recs) || (c->nrec > kParamRecs && !c->more) ||
      ((c->vmask | c->tmask | c->dmask) & ~span) ||
      ((c->tmask | c->dmask) & ~(c->vmask | 2ull)) || (c->dmask & ~c->tmask))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < c->nrec; ++r) {
    const unsigned kind = recs[r].op & 15u, n = recs[r].arg >> 8 & 0xFFu;
    const unsigned mode = recs[r].arg & 0xFFu;
    const u64 m = recs[r].m;
    bool ok = kind >= kTerms && kind <= kLex;
    if (kind == kTerms) ok = !(m & ~c->tmask);
    if (kind == kNd) ok = !(m & ~c->tmask) && !(m & ~c->dmask);
    if (kind == kLex) {
      const u64 pos = (2ull << n) - 2ull;  // offsets 1 .. n
      ok = mode <= kGt && n <= (unsigned)kMaxLex && (int)n + 1 < 8 * q &&
           !(pos & ~(c->vmask | 2ull)) && ((c->tmask >> (n + 1)) & 1) &&
           (mode == kEq || !(pos & ~c->tmask));
    }
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  ScreenArgs a;
  a.plane = reinterpret_cast<const u64*>(c->plane);
  a.cand = reinterpret_cast<u64*>(c->cand);
  a.blk = reinterpret_cast<int*>(c->blk);
  a.scal = reinterpret_cast<int*>(c->scal);
  a.more = reinterpret_cast<const Rec*>(c->more);
  a.nw = c->nw;
  a.vmask = c->vmask;
  a.tmask = c->tmask;
  a.dmask = c->dmask;
  a.fdl = u64(c->fd & 0xFF) * kLo;
  a.qcl = u64(c->qc & 0xFF) * kLo;
  a.field = c->field;
  a.sci = c->sci;
  a.nrec = c->nrec;
  a.pad_ = 0;
  const int here = c->nrec < kParamRecs ? c->nrec : kParamRecs;
  if (here) memcpy(a.rec, recs, here * sizeof(Rec));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(c->stream);
  cudaError_t e = use_device(c->device);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.scal, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  switch (q) {
    case 1: launch_screen<1>(a, st); break;
    case 2: launch_screen<2>(a, st); break;
    case 3: launch_screen<3>(a, st); break;
    case 4: launch_screen<4>(a, st); break;
    case 5: launch_screen<5>(a, st); break;
    default: launch_screen<6>(a, st); break;
  }
  return (int)cudaGetLastError();
}


int mts_positions(int device, const void* cand, const int* cum, int nblk, int cap, int* out,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  positions_kernel<<<(cap + kPosThreads - 1) / kPosThreads, kPosThreads, 0,
                     (cudaStream_t)stream>>>((const u64*)cand, cum, nblk, cap, out);
  return (int)cudaGetLastError();
}

int mts_spans(int device, const void* arr, long long n, const int* anchors, int count,
              int window, int back, int* out, void* found, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((count + kSpanWarps - 1) / kSpanWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (back)
    spans_kernel<true><<<blocks, kSpanWarps * 32, 0, st>>>(
        (const uint8_t*)arr, n, anchors, count, window, out, (uint8_t*)found);
  else
    spans_kernel<false><<<blocks, kSpanWarps * 32, 0, st>>>(
        (const uint8_t*)arr, n, anchors, count, window, out, (uint8_t*)found);
  return (int)cudaGetLastError();
}

// K11's call, packed by select_step.gather_rows (_GATHER_CALL)
struct GatherCall {
  uint64_t arr, starts, out, stream;
  long long n;
  int count, window, device, pad;
};
static_assert(sizeof(GatherCall) == 56, "select_step._GATHER_CALL");

int mts_gather(const GatherCall* c) {
  if (c->count <= 0 || c->window <= 0 || c->window % 4 || c->n <= 0 || !c->arr ||
      !c->starts || !c->out)
    return (int)cudaErrorInvalidValue;
  GatherArgs a;
  a.arr = reinterpret_cast<const uint8_t*>(c->arr);
  a.starts = reinterpret_cast<const int*>(c->starts);
  a.out = reinterpret_cast<uint8_t*>(c->out);
  a.n = c->n;
  a.count = c->count;
  a.window = c->window;
  // window / 16 lanes a row (window / 4 for the clamped form's words),
  // rounded up to a power of two, at most a warp
  const int chunks = c->window % 16 ? c->window / 4 : c->window / 16;
  a.lg = 0;
  while (a.lg < 5 && (1 << a.lg) < chunks) ++a.lg;
  a.pad_ = 0;
  cudaError_t e = use_device(c->device);
  if (e != cudaSuccess) return (int)e;
  const int rows = kGatherThreads >> a.lg;
  const long long blocks = ((long long)c->count + rows - 1) / rows;
  gather_kernel<<<(unsigned)blocks, kGatherThreads, 0,
                  reinterpret_cast<cudaStream_t>(c->stream)>>>(a);
  return (int)cudaGetLastError();
}

// the constants select_step.py must share, as "name=v[,v...]" words
const char* mts_constants() {
  static char buf[256];
  snprintf(buf, sizeof buf,
           "screen_threads=%d max_shift=%d param_recs=%d rec_bytes=%d max_lex=%d pop_words=%d "
           "ops=%u,%u,%u,%u last=%u flag=%u modes=%u,%u,%u,%u,%u screen_call_bytes=%d "
           "gather_call_bytes=%d",
           kScreenThreads, kMaxShift, kParamRecs, (int)sizeof(Rec), kMaxLex, kPopWords, kTerms,
           kRange, kNd, kLex, kLast, kFlag, kLt, kLe, kEq, kGe, kGt, (int)sizeof(ScreenCall),
           (int)sizeof(GatherCall));
  return buf;
}

}  // extern "C"
