// Erasure codec kernels for Hopper (sm_90a): the PUT pass, the bitrot
// digest and the GF(2^8) product, each behind a plain C entry point that
// ops/kernels.py binds with ctypes.  Every entry launches on the stream it
// is given, allocates nothing (the Python wrapper passes outputs and
// zeroed accumulators) and returns cudaGetLastError() after each launch.
//
// Words are little-endian u32 (4 packed GF(2^8) elements).  The GF product
// uses the xtime-powers decomposition: for input word x the powers x, 2x,
// 4x, ..., 128x come from SWAR doublings, and every output word is the XOR
// of the powers its coefficients select.  The coefficient bits reach the
// kernel as a by-value GfPlan (kernel parameters live in the constant
// bank, so every thread reads them at the same address): rm[c*8+b] has
// bit r set when output row r takes power b of input row c.  All branches
// on the plan are uniform across the block.
//
// phash256 (ops/hash.py) mixes word j of a row with the key
// mix(j*C1+1) into two 32-bit lanes and XOR-folds them by j mod 4.  Every
// block here starts its columns at a multiple of 256 and a thread's
// columns are strided by 256, so a thread only ever feeds partition
// (threadIdx.x mod 4): it folds its columns in registers, a warp folds
// lanes with shuffles at offsets 16, 8, 4, shared memory folds the warps
// and one atomicXor per block per partition word reaches the zeroed
// (rows, 8) accumulator.  XOR is order-free, so the digest is bit-exact
// whatever order the blocks run in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // one thread per column of a tile
constexpr int kTile = kThreads;    // columns per tile == pack group (256)
constexpr int kMaxRows = 16;       // rows of a GF matrix / input rows
constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
constexpr uint32_t kM1 = 0xCC9E2D51u;
constexpr uint32_t kM2 = 0x1B873593u;

struct GfPlan {
  uint16_t rm[kMaxRows * 8];  // rm[c*8+b]: output rows taking power b of input c
  uint8_t nb[kMaxRows];       // xtime chain length of input c
  uint8_t row[kMaxRows];      // input row index of input c (gf_matmul_words)
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC2;
  x ^= x >> 13;
  x *= kC3;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (((x & 0x80808080u) >> 7) * 0x1Du);
}

__device__ __forceinline__ uint32_t hash_key(uint32_t col) {
  return mix32(col * kC1 + 1u);
}

// The phash256 mixes of one word: shared by encode_pack and phash256.
__device__ __forceinline__ void hash_word(uint32_t w, uint32_t key,
                                          uint32_t& h1, uint32_t& h2) {
  h1 ^= mix32((w ^ key) * kM1);
  h2 ^= mix32((w + key) * kM2);
}

// Fold a thread's (h1, h2) over the block into s[8] (zeroed by the
// caller, followed by __syncthreads()): lanes sharing lane mod 4 meet
// through shuffles, then lanes 0..3 of each warp XOR into shared memory.
__device__ __forceinline__ void fold_block(uint32_t h1, uint32_t h2,
                                           uint32_t* s) {
#pragma unroll
  for (int off = 16; off >= 4; off >>= 1) {
    h1 ^= __shfl_xor_sync(0xffffffffu, h1, off);
    h2 ^= __shfl_xor_sync(0xffffffffu, h2, off);
  }
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
    atomicXor(&s[lane], h1);
    atomicXor(&s[4 + lane], h2);
  }
}

// --------------------------------------------------------------------------
// K1 encode_pack: replaces rs_pallas.encode_pack_fused (P4) and its
// DMA-pipelined body encode_pack_pipelined (P6).
//
// Bound: bytes.  Per stripe it reads the k data rows once and writes the
// m parity rows (the pack leg then writes m packed rows), so at EC 8+4
// and 10 MiB blocks: 10 MiB in + 5 MiB parity + 5 MiB packed.
// Design: one thread per column; the k data words are loaded coalesced,
// hashed and multiplied into MB register accumulators in the same pass,
// so a data byte is read from device memory once.  The parity words are
// stored, hashed, and screened per 256-column tile (one tile is one pack
// group) with __syncthreads_or for the occupancy flags.  Hash partials
// stay in registers across the block's tiles.
// --------------------------------------------------------------------------

template <int KB, int MB>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ parity,
              uint32_t* __restrict__ partials, uint32_t* __restrict__ flags,
              int k, int m, int w, int ntiles, int tiles_per_block,
              const GfPlan plan) {
  __shared__ uint32_t s[(KB + MB) * 8];
  const int b = blockIdx.y;
  const int n = k + m;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  __syncthreads();

  uint32_t h1[KB + MB], h2[KB + MB];
#pragma unroll
  for (int r = 0; r < KB + MB; ++r) h1[r] = h2[r] = 0;

  const uint32_t* in = data + (size_t)b * k * w;
  uint32_t* out = parity + (size_t)b * m * w;
  const int g = w / kTile;  // flag columns (flags only when w % 256 == 0)

  for (int t = 0; t < tiles_per_block; ++t) {
    const int tile = blockIdx.x * tiles_per_block + t;
    if (tile >= ntiles) break;  // uniform across the block
    const int col = tile * kTile + tid;
    const bool valid = col < w;
    const uint32_t key = hash_key((uint32_t)col);
    uint32_t acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = 0;
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      if (c < k) {
        uint32_t p = valid ? in[(size_t)c * w + col] : 0u;
        if (valid) hash_word(p, key, h1[c], h2[c]);
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          if (bit >= plan.nb[c]) break;
          const uint32_t msk = plan.rm[c * 8 + bit];
#pragma unroll
          for (int r = 0; r < MB; ++r)
            if ((msk >> r) & 1u) acc[r] ^= p;
          p = xtime(p);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < m) {
        if (valid) {
          out[(size_t)r * w + col] = acc[r];
          hash_word(acc[r], key, h1[KB + r], h2[KB + r]);
        }
        if (flags != nullptr) {
          const int any = __syncthreads_or(valid && acc[r] != 0u);
          if (tid == 0) flags[((size_t)b * m + r) * g + tile] = any ? 1u : 0u;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < KB; ++c)
    if (c < k) fold_block(h1[c], h2[c], &s[c * 8]);
#pragma unroll
  for (int r = 0; r < MB; ++r)
    if (r < m) fold_block(h1[KB + r], h2[KB + r], &s[(k + r) * 8]);
  __syncthreads();
  for (int i = tid; i < n * 8; i += kThreads)
    if (s[i]) atomicXor(&partials[(size_t)b * n * 8 + i], s[i]);
}

// The pack leg: a parallel grid cannot carry the TPU kernel's sequential
// per-row slot counter, so a second launch places the groups.  Block
// (row, chunk) counts the nonzero flags before its chunk and in the whole
// row, then sends nonzero group j to slot nz_before(j) and zero group j
// to slot kept + (j - nz_before(j)) as zeros: every slot of the row is
// written exactly once, which equals the reference's full-row `packed`.
constexpr int kGroupsPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ parity, const uint32_t* __restrict__ flags,
            uint32_t* __restrict__ packed, int w, int g) {
  __shared__ int s_pre[kThreads / 32], s_tot[kThreads / 32];
  __shared__ int s_slot[kGroupsPerBlock];
  __shared__ uint32_t s_flag[kGroupsPerBlock];
  const size_t row = blockIdx.x;
  const int start = blockIdx.y * kGroupsPerBlock;
  const int end = min(start + kGroupsPerBlock, g);
  const uint32_t* f = flags + row * g;
  const int tid = threadIdx.x;

  int pre = 0, tot = 0;
  for (int j = tid; j < g; j += kThreads) {
    const int v = f[j] != 0u;
    tot += v;
    if (j < start) pre += v;
  }
  pre = __reduce_add_sync(0xffffffffu, pre);
  tot = __reduce_add_sync(0xffffffffu, tot);
  if ((tid & 31) == 0) {
    s_pre[tid >> 5] = pre;
    s_tot[tid >> 5] = tot;
  }
  __syncthreads();
  if (tid == 0) {
    int nz = 0, kept = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      nz += s_pre[i];
      kept += s_tot[i];
    }
    for (int j = start; j < end; ++j) {
      const uint32_t fl = f[j];
      s_flag[j - start] = fl;
      s_slot[j - start] = fl ? nz : kept + (j - nz);
      nz += fl ? 1 : 0;
    }
  }
  __syncthreads();
  const uint32_t* src = parity + row * w;
  uint32_t* dst = packed + row * w;
  for (int j = start; j < end; ++j) {
    const size_t slot = (size_t)s_slot[j - start];
    dst[slot * kTile + tid] =
        s_flag[j - start] ? src[(size_t)j * kTile + tid] : 0u;
  }
}

// Length fold of the XOR-combined partials (hash.finalize_partials),
// in place: (rows, 8) partials -> (rows, 8) digests.
__global__ void finalize_kernel(uint32_t* __restrict__ part, int count,
                                uint32_t nbytes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  part[i] = mix32(part[i] ^ (nbytes * kC1 + (uint32_t)(i & 7)));
}

// --------------------------------------------------------------------------
// K2 phash256_batched: replaces hash.phash256_words_batched (X1, which the
// JAX package leaves to XLA) on the healthy-GET verify.
//
// Bound: bytes (each word is read once; the digest is 32 bytes a row).
// Design: block (tile-run, row), one thread per column, the same
// hash_word and block fold as encode_pack, one atomicXor per block per
// partition word, then the finalize launch.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
phash_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ partials,
             int w, int ntiles, int tiles_per_block) {
  __shared__ uint32_t s[8];
  const int tid = threadIdx.x;
  if (tid < 8) s[tid] = 0;
  __syncthreads();
  const uint32_t* in = words + (size_t)blockIdx.y * w;
  uint32_t h1 = 0, h2 = 0;
  for (int t = 0; t < tiles_per_block; ++t) {
    const int tile = blockIdx.x * tiles_per_block + t;
    if (tile >= ntiles) break;
    const int col = tile * kTile + tid;
    if (col < w) hash_word(in[col], hash_key((uint32_t)col), h1, h2);
  }
  fold_block(h1, h2, s);
  __syncthreads();
  if (tid < 8 && s[tid]) atomicXor(&partials[(size_t)blockIdx.y * 8 + tid], s[tid]);
}

// --------------------------------------------------------------------------
// K3 gf_matmul_words: replaces rs_pallas.matmul_words (P1) on the
// degraded-GET reconstruct.  The matrix is known only at run time (it is
// the inverted sub-matrix of the survivor pattern) and arrives as a
// GfPlan, whose row[] picks the s input rows straight out of the
// (B, R, w) shard batch - no gather copy of the survivors.
//
// Bound: bytes (s rows in + o rows out per stripe: 10 MiB + 10 MiB at
// EC 8+4 with all k data rows rebuilt).
// Design: one thread per column, the xtime chain of each input word in a
// register, o <= OB accumulators in registers.
// --------------------------------------------------------------------------

template <int OB>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int rows_in, int o, int s, int w, const GfPlan plan) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= w) return;
  const uint32_t* src = in + (size_t)b * rows_in * w;
  uint32_t acc[OB];
#pragma unroll
  for (int r = 0; r < OB; ++r) acc[r] = 0;
  for (int c = 0; c < s; ++c) {
    uint32_t p = src[(size_t)plan.row[c] * w + col];
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      if (bit >= plan.nb[c]) break;
      const uint32_t msk = plan.rm[c * 8 + bit];
#pragma unroll
      for (int r = 0; r < OB; ++r)
        if ((msk >> r) & 1u) acc[r] ^= p;
      p = xtime(p);
    }
  }
  uint32_t* dst = out + (size_t)b * o * w;
#pragma unroll
  for (int r = 0; r < OB; ++r)
    if (r < o) dst[(size_t)r * w + col] = acc[r];
}

int bucket(int v) { return v <= 4 ? 4 : (v <= 8 ? 8 : 16); }

GfPlan make_plan(const uint16_t* rm, const uint8_t* nb, const uint8_t* row) {
  GfPlan p;
  for (int i = 0; i < kMaxRows * 8; ++i) p.rm[i] = rm[i];
  for (int i = 0; i < kMaxRows; ++i) {
    p.nb[i] = nb[i];
    p.row[i] = row ? row[i] : (uint8_t)i;
  }
  return p;
}

template <int KB, int MB>
void launch_encode(dim3 grid, cudaStream_t st, const uint32_t* data,
                   uint32_t* parity, uint32_t* partials, uint32_t* flags,
                   int k, int m, int w, int ntiles, int tpb, const GfPlan& plan) {
  encode_kernel<KB, MB><<<grid, kThreads, 0, st>>>(
      data, parity, partials, flags, k, m, w, ntiles, tpb, plan);
}

}  // namespace

extern "C" {

// words (B, k, w) -> parity (B, m, w), digests (B, k+m, 8) finalized in
// the zeroed `partials`, and with group == 256: flags (B, m, w/256) 0/1
// and packed (B, m, w).  Returns the first non-zero cudaGetLastError().
int mtt_encode_pack(int device, const uint32_t* data, uint32_t* parity, uint32_t* partials,
                    uint32_t* flags, uint32_t* packed, int B, int k, int m,
                    int w, int group, uint32_t nbytes, int tiles_per_block,
                    const uint16_t* rm, const uint8_t* nb, void* stream) {
  if (k < 1 || k > kMaxRows || m < 0 || m > kMaxRows || w <= 0 ||
      tiles_per_block < 1 || B <= 0 || B > 65535 ||
      (group != 0 && (group != kTile || w % kTile != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const GfPlan plan = make_plan(rm, nb, nullptr);
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, B);
  uint32_t* fl = group ? flags : nullptr;
  const int kb = bucket(k), mb = bucket(m);
#define MTT_ENC(KB_, MB_)                                                   \
  if (kb == KB_ && mb == MB_)                                               \
    launch_encode<KB_, MB_>(grid, st, data, parity, partials, fl, k, m, w, \
                            ntiles, tiles_per_block, plan);
  MTT_ENC(4, 4) MTT_ENC(4, 8) MTT_ENC(4, 16)
  MTT_ENC(8, 4) MTT_ENC(8, 8) MTT_ENC(8, 16)
  MTT_ENC(16, 4) MTT_ENC(16, 8) MTT_ENC(16, 16)
#undef MTT_ENC
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (group && m > 0) {
    const int g = w / kTile;
    dim3 pgrid(B * m, (g + kGroupsPerBlock - 1) / kGroupsPerBlock);
    pack_kernel<<<pgrid, kThreads, 0, st>>>(parity, flags, packed, w, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int count = B * (k + m) * 8;
  finalize_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partials, count, nbytes);
  return (int)cudaGetLastError();
}

// words (R, w) -> digests (R, 8), finalized in the zeroed `partials`.
int mtt_phash256(int device, const uint32_t* words, uint32_t* partials, int R, int w,
                 uint32_t nbytes, int tiles_per_block, void* stream) {
  if (R <= 0 || R > 65535 || w <= 0 || tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, R);
  phash_kernel<<<grid, kThreads, 0, st>>>(words, partials, w, ntiles,
                                          tiles_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = R * 8;
  finalize_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partials, count, nbytes);
  return (int)cudaGetLastError();
}

// (B, rows_in, w) words, plan rows row[0..s) -> (B, o, w).
int mtt_gf_matmul(int device, const uint32_t* in, uint32_t* out, int B, int rows_in,
                  int w, int o, int s, const uint16_t* rm, const uint8_t* nb,
                  const uint8_t* row, void* stream) {
  if (o < 1 || o > kMaxRows || s < 1 || s > kMaxRows || w <= 0 || B <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const GfPlan plan = make_plan(rm, nb, row);
  dim3 grid((w + kThreads - 1) / kThreads, B);
  const int ob = bucket(o);
  if (ob == 4)
    gf_matmul_kernel<4><<<grid, kThreads, 0, st>>>(in, out, rows_in, o, s, w, plan);
  else if (ob == 8)
    gf_matmul_kernel<8><<<grid, kThreads, 0, st>>>(in, out, rows_in, o, s, w, plan);
  else
    gf_matmul_kernel<16><<<grid, kThreads, 0, st>>>(in, out, rows_in, o, s, w, plan);
  return (int)cudaGetLastError();
}

}  // extern "C"
