// S3 Select's device functions: CUDA C++ for sm_90a, a plain C interface
// bound with ctypes by minio_tpu_torch/ops/select_step.py.
//
// Four kernels, each held bit for bit against its plain PyTorch version:
//
// * screen_kernel (K8 select_screen) replaces select_step.screen_chunk
//   (XLA, minio_tpu/ops/select_step.py:184): the SWAR byte classification,
//   the statement's screen (an OR of ANDs of len/deep/byte0/nd/lex atoms),
//   the hazard flags and the per-64-byte block popcount sums.  One thread
//   per u64 word; a block stages its 256 words, the word before them and
//   the lookahead words after them in shared memory, so the shifted views
//   W(k) (lanes of bytes p+k) read neighbouring words at no extra device
//   memory traffic.  The u64 expressions are carried over verbatim
//   (_swar_eq's borrow between lanes included): no byte compare.  The
//   screen is compiled per statement into a small program of 8-int records
//   in a device buffer (select_step.screen_program), which every thread
//   interprets: no build per statement, and an IN list of any length.
//   Bound: operations (the atom program's integer work per word); the
//   plane is read once and cand + blk written once.
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
//   (:387): the (C, window) byte gather, 4 output bytes per thread, one
//   32-bit store each.
//
// Every entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kLo = 0x0101010101010101ull;
constexpr u64 kHi = 0x8080808080808080ull;

constexpr int kScreenThreads = 256;    // words per screen block
constexpr int kMaxShift = 47;          // largest byte offset a program may read
constexpr int kMaxQ = kMaxShift / 8 + 1;
constexpr int kStage = kScreenThreads + kMaxQ + 2;  // staged words per block
constexpr int kRecInts = 8;            // ints per program record
constexpr int kMaxLex = 8;             // select_step.MAX_LEX
constexpr int kPopWords = 8;           // select_step.POP_WORDS

// program record kinds (select_step._KIND)
constexpr int kEnd = 0, kLen = 1, kDeep = 2, kByte0 = 3, kNd = 4, kLex = 5;
// lex modes (select_step._MODE)
constexpr int kLt = 0, kLe = 1, kEq = 2, kGe = 3, kGt = 4;

constexpr int kPosThreads = 256;
constexpr int kSpanWarps = 8;          // anchors per spans block
constexpr int kGatherThreads = 256;

__device__ __forceinline__ u64 swar_eq(u64 w, unsigned b) {
  const u64 x = w ^ (u64(b) * kLo);
  return (x - kLo) & ~x & kHi;
}

// c <= 0x80: the program encoder refuses what the reference's u64
// constant cannot hold
__device__ __forceinline__ u64 swar_ge(u64 w, unsigned c) {
  return ((w & ~kHi) + u64(0x80u - c) * kLo) & kHi;
}

struct Screen {
  const u64* s;  // staged words: s[j] is word i0 - 1 + j
  int t;         // this thread's word within the block
  unsigned fd;

  // lanes of bytes p + k (k >= -1)
  __device__ __forceinline__ u64 W(int k) const {
    const int q = (k + 8) / 8 - 1;  // floor(k / 8)
    const int r = k - 8 * q;
    const u64 lo = s[t + q + 1];
    if (r == 0) return lo;
    const u64 hi = s[t + q + 2];
    return (lo >> (8 * r)) | (hi << (64 - 8 * r));
  }
  __device__ __forceinline__ u64 term_at(int k) const {
    const u64 w = W(k);
    return swar_eq(w, 10) | swar_eq(w, fd);
  }
  __device__ __forceinline__ u64 digit_at(int k) const {
    const u64 w = W(k);
    return swar_ge(w, 0x30) & ~swar_ge(w, 0x3A);
  }

  __device__ u64 atom(const int* rec) const {
    const int kind = rec[0];
    if (kind == kLen) {
      u64 m = 0;
      for (int ln = rec[1]; ln <= rec[2]; ++ln) m |= term_at(ln + 1);
      return m;
    }
    if (kind == kDeep) {
      u64 seen = 0;
      for (int i = 1; i <= rec[1]; ++i) seen |= term_at(i);
      return ~seen & kHi;
    }
    if (kind == kByte0) {
      const u64 w1 = W(1);
      u64 m = swar_ge(w1, rec[1]) & ~swar_ge(w1, rec[2] + 1);
      if (rec[1] == 0) m &= ~(w1 & kHi);
      return m;
    }
    if (kind == kNd) {
      u64 seen = 0, hit = 0;
      for (int i = 1; i <= rec[1]; ++i) {
        const u64 term = term_at(i);
        const u64 nd = ~digit_at(i) & ~term & kHi;
        hit |= nd & ~seen;
        seen |= term;
      }
      return hit;
    }
    // kLex: rec[3] mode, rec[4] n = min(len, MAX_LEX), rec[5] len > MAX_LEX,
    // rec[6..7] the first n literal bytes, little-endian
    const int mode = rec[3], n = rec[4];
    const bool over = rec[5] != 0;
    const u64 lit = u64(unsigned(rec[6])) | (u64(unsigned(rec[7])) << 32);
    u64 pref = kHi, hit = 0;
    for (int i = 0; i < n; ++i) {
      const unsigned c = unsigned(lit >> (8 * i)) & 0xFFu;
      const u64 wi = W(i + 1);
      if (mode == kLt || mode == kLe) {
        const u64 below = c > 0 ? swar_ge(wi, 0) & ~swar_ge(wi, c) : 0;
        hit |= pref & below;
        hit |= pref & term_at(i + 1);
      } else if (mode == kGt || mode == kGe) {
        const u64 above = c < 0x7F ? (swar_ge(wi, c + 1) | (wi & kHi)) : (wi & kHi);
        hit |= pref & above & ~term_at(i + 1);
      }
      pref &= swar_eq(wi, c);
    }
    const u64 endv = term_at(n + 1);
    if (mode == kEq || mode == kLe || mode == kGe) hit |= over ? pref : (pref & endv);
    if (mode == kGt || mode == kGe) hit |= pref & ~endv;
    if (mode == kLt && over) hit |= pref;
    return hit;
  }
};

__global__ void __launch_bounds__(kScreenThreads)
screen_kernel(const u64* __restrict__ plane, long long nw,
              const int* __restrict__ prog, int nrec, unsigned fd, unsigned qc,
              int field, int sci, int qmax, u64* __restrict__ cand,
              int* __restrict__ blk, int* __restrict__ scal) {
  __shared__ u64 s[kStage];
  __shared__ int warp_nl[kScreenThreads / 32];
  __shared__ int warp_hz[kScreenThreads / 32];
  const long long i0 = (long long)blockIdx.x * kScreenThreads;
  const int t = threadIdx.x;
  // the word before the block, its words, then qmax + 1 lookahead words;
  // zero words stand before the plane and past its end
  const int staged = kScreenThreads + qmax + 2;
  for (int j = t; j < staged; j += kScreenThreads) {
    const long long g = i0 - 1 + j;
    s[j] = (g >= 0 && g < nw) ? plane[g] : 0ull;
  }
  __syncthreads();
  const long long i = i0 + t;
  const Screen sc{s, t, fd};

  const u64 ww = sc.W(0);
  const u64 nl = swar_eq(ww, 10);
  const u64 base = field ? sc.term_at(0) : nl;
  u64 hit = 0, bm = kHi;
  for (int r = 0; r < nrec; ++r) {
    const int* rec = prog + r * kRecInts;
    if (rec[0] == kEnd) {
      hit |= bm;
      bm = kHi;
    } else {
      bm &= sc.atom(rec);
    }
  }
  const u64 c = base & hit;
  u64 haz = swar_eq(ww, qc) | (swar_eq(ww, 13) & ~swar_eq(sc.W(1), 10)) | swar_eq(ww, 0);
  if (sci) {
    const u64 e = swar_eq(ww, 0x65) | swar_eq(ww, 0x45);
    haz |= e & sc.digit_at(-1);
  }
  const bool in = i < nw;
  const int pn = in ? __popcll(nl) : 0;
  const int hz = in && haz != 0;
  int combo = in ? (__popcll(c) | (pn << 7) | (hz << 14)) : 0;
  // the 8-word block sum over aligned groups of 8 lanes
  combo += __shfl_xor_sync(0xffffffffu, combo, 1);
  combo += __shfl_xor_sync(0xffffffffu, combo, 2);
  combo += __shfl_xor_sync(0xffffffffu, combo, 4);
  if (in) {
    cand[i] = c;
    if ((t & (kPopWords - 1)) == 0) blk[i / kPopWords] = combo & 127;
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
    for (int w = 0; w < kScreenThreads / 32; ++w) {
      sn += warp_nl[w];
      sh |= warp_hz[w];
    }
    if (sn) atomicAdd(scal, sn);
    if (sh) atomicOr(scal + 1, 1);
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

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const uint8_t* __restrict__ arr, long long n,
              const int* __restrict__ starts, int count, int window,
              uint32_t* __restrict__ out) {
  const long long quads = (long long)count * (window / 4);
  for (long long q = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
       q < quads; q += (long long)gridDim.x * kGatherThreads) {
    const long long row = q / (window / 4);
    const long long g0 = (long long)starts[row] + (q - row * (window / 4)) * 4;
    uint32_t v = 0;
    for (int b = 0; b < 4; ++b) {
      long long g = g0 + b;
      g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
      v |= uint32_t(arr[g]) << (8 * b);
    }
    out[q] = v;
  }
}

}  // namespace

extern "C" {

int mts_screen(int device, const void* plane, long long nw, const int* prog, int nrec,
               int fd, int qc, int field, int sci, int qmax, void* cand,
               int* blk, int* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (qmax < 1 || qmax > kMaxQ) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(scal, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (nw + kScreenThreads - 1) / kScreenThreads;
  screen_kernel<<<(unsigned)blocks, kScreenThreads, 0, st>>>(
      (const u64*)plane, nw, prog, nrec, unsigned(fd), unsigned(qc), field, sci,
      qmax, (u64*)cand, blk, scal);
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

int mts_gather(int device, const void* arr, long long n, const int* starts, int count,
               int window, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long quads = (long long)count * (window / 4);
  long long blocks = (quads + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  gather_kernel<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)arr, n, starts, count, window, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// the constants select_step.py must share, as "name=v[,v...]" words
const char* mts_constants() {
  static char buf[256];
  snprintf(buf, sizeof buf,
           "screen_threads=%d max_shift=%d rec_ints=%d max_lex=%d pop_words=%d "
           "kinds=%d,%d,%d,%d,%d,%d modes=%d,%d,%d,%d,%d",
           kScreenThreads, kMaxShift, kRecInts, kMaxLex, kPopWords, kEnd, kLen,
           kDeep, kByte0, kNd, kLex, kLt, kLe, kEq, kGe, kGt);
  return buf;
}

}  // extern "C"
