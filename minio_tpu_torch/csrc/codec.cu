// Erasure codec kernels for Hopper (sm_90a): the PUT pass, the bitrot
// digest, the GF(2^8) product, heal's fused verify + reconstruct, and
// the pipelined twins of the PUT and heal passes, the legacy drain's
// occupancy screen and pack (K12, K13), each behind a plain C
// entry point that ops/kernels.py binds with ctypes.  Every entry
// launches on the stream it is given, allocates nothing (the Python
// wrapper passes outputs and zeroed accumulators) and returns
// cudaGetLastError() after each launch.
//
// Words are little-endian u32 (4 packed GF(2^8) elements), multiplied by
// SWAR doublings (xtime).  Every kernel takes the GF product in Horner form
// from a term program (GfTerms for K1, K3 and K5, VrTerms for K4 and K6):
// copies for unit rows, 7 xtimes a product row.  Term programs reach the
// kernel by value (kernel parameters live in the constant bank, so every
// thread reads them at the same address) or as masks it expands into
// shared memory; every branch on them is uniform across the block.
//
// The constants that ops/kernels.py shares with this file (the tile, row
// buckets, residencies, term-program sizes) are exported by
// mtt_constants(), which the loader checks against its own.
//
// phash256 (ops/hash.py) mixes word j of a row with the key
// mix(j*C1+1) into two 32-bit lanes and XOR-folds them by j mod 4.  In
// K1 and K4-K6 every block starts its columns at a multiple of 256 and a
// thread's columns are strided by 256, so a thread only ever feeds
// partition (threadIdx.x mod 4): it folds its columns in registers, a
// warp folds lanes with shuffles at offsets 16, 8, 4, shared memory folds
// the warps and one atomicXor per block per partition word reaches the
// zeroed (rows, 8) accumulator.  K2 gives a thread whole column quads
// instead (one word of each partition; see there).  XOR is order-free, so
// the digest is bit-exact whatever order the blocks run in.
//
// MINIO_TPU_CODEC_FORMULATION=mxu swaps the xtime chain of the PUT and
// heal passes (K1, K4, K5, K6: the `MXU` template parameter or an mxu
// kernel of their own) for a tensor-core product of the lifted GF(2) bit
// matrix (mxu_ring_tile, on a swizzled tile; K4 and K6 multiply only the
// rebuilt rows), and K7 runs a transposed product of its own on bytes
// (the data as the A operand; see K7).  Everything
// around the product - the hash leg, flags, pack leg, ring and finalize -
// is the swar kernels' code (on a tile swizzled for mxu_ring_tile), so
// the outputs are bit for bit the swar ones.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;      // one thread per column of a tile
constexpr int kTile = kThreads;    // columns per tile == pack group (256)
constexpr int kMaxRows = 16;       // rows of a GF matrix / input rows
constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
constexpr uint32_t kM1 = 0xCC9E2D51u;
constexpr uint32_t kM2 = 0x1B873593u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC2;
  x ^= x >> 13;
  x *= kC3;
  x ^= x >> 16;
  return x;
}

// Multiply each byte by x: shift, and reduce the bytes whose top bit
// was set (prmt's sign-spread bytes: 0xFF there) - 4 instructions.
__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  uint32_t sign;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(sign) : "r"(x));
  return ((x & 0x7F7F7F7Fu) << 1) ^ (sign & 0x1D1D1D1Du);
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

// Called by every thread after its block's atomicXors into `partials`
// (K1, K2, K4-K6): the block holding the last ticket applies the length
// fold of the XOR-combined partials (hash.finalize_partials) to all
// `count` words in place, turning (rows, 8) partials into (rows, 8)
// digests, so no finalize launch follows.  `ticket` arrives zeroed.
__device__ __forceinline__ void finalize_if_last(uint32_t* partials, int count,
                                                 uint32_t nbytes,
                                                 unsigned int* ticket) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    s_last = atomicAdd(ticket, 1u) == total - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const uint32_t p = __ldcg(partials + i);  // L2: the other blocks' XORs
    partials[i] = mix32(p ^ (nbytes * kC1 + (uint32_t)(i & 7)));
  }
}

// --------------------------------------------------------------------------
// The mxu product: replaces the body of rs_pallas._mxu_rows (the product
// P3-P7 run under MINIO_TPU_CODEC_FORMULATION=mxu).
//
// Multiplying a byte by a constant is an 8x8 linear map over GF(2), so an
// (o, s) GF(2^8) matrix lifts to the (8o, 8s) 0/1 matrix A whose row 8r+t,
// column 8c+b is bit t of matrix[r,c] * x^b, and every output bit is the
// parity of a row of A ANDed with the input bits.  The TPU kernel counts
// those bits with a bf16 matmul on the MXU and takes them mod 2.  Here the
// count is one 1-bit tensor-core instruction,
//   mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc,
// D = popc(A & B) over K = 128 bits: 8 bits of 16 input rows, the most the
// codec has, so one instruction covers the whole depth.  Its B operand is
// 32 bits of one byte column per thread: the bytes of input rows 4tig ..
// 4tig+3 at that column, which three byte permutes pull out of four words
// as they lie in shared memory - no bit unpacking and no unpacked copy of
// the tile.  (The int8 form m16n8k32.s8 would need every bit spread to a
// byte first; the 1-bit form computes the same popc(a & b) & 1.)
//
// Layout.  An n-tile is 8 byte columns: word columns wc, wc + 1 (bytes 0-3
// each).  An m-tile is 16 rows of A: output rows 2t and 2t + 1.  Lane
// (g, tig) = (lane / 4, lane % 4) feeds B column g (word wc + g/4, byte
// g%4); its A words (ops/kernels.py mxu_fragments, read once per block
// into registers) are the rows for bit g%4 and bit g%4 + 4 of output row
// 2t + g/4, so its accumulators c0..c3 hold those two bits of that row at
// byte columns 2tig, 2tig + 1.  mxu_ring_tile (below) gathers a row's 8
// bits over the 4 lanes that hold them with shuffles; the output word
// lands in shared memory, where the kernel's own thread for that column
// picks it up as it picked up its xtime accumulator.
//
// Bound: the kernels that call it move the same bytes as their swar twins,
// and the function needs only their hash leg on the integer pipe plus the
// product's bit pairs on the tensor cores, which take less time than the
// xtime chain.  The byte permutes, shuffles and shifts this design adds on
// the integer pipe are its own cost above that bound: it keeps the unpack
// at three permutes per 8 byte columns and input row quad, and the MMA
// count at (output rows / 2) per 8 byte columns.
// --------------------------------------------------------------------------

__device__ __forceinline__ void mma_b1(uint32_t a0, uint32_t a1, uint32_t b,
                                       uint32_t& d0, uint32_t& d1, uint32_t& d2,
                                       uint32_t& d3) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// The A words of m-tiles 0 .. MB/2 - 1 for this lane (kernels.mxu_fragments:
// 8 m-tiles x 32 lanes x 2 words).
template <int MB>
__device__ __forceinline__ void load_frags(const uint32_t* __restrict__ amat,
                                           uint32_t (&af)[MB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MB; ++i) af[i] = __ldg(amat + ((i >> 1) * 32 + lane) * 2 + (i & 1));
}

// --------------------------------------------------------------------------
// Term programs of a GF(2^8) product (K1 and K3; kernels.gf_terms and
// kernels.parity_terms compile them once per matrix on the host).
//
// Horner's form over the coefficient bits: product row r is
//   acc = S7; acc = xtime(acc) ^ S6; ...; acc = xtime(acc) ^ S0,
// where Sb is the XOR of the inputs whose coefficient for row r has bit
// b set: 7 xtimes a row, against up to 7 per input for the chain of
// powers, and no test per (input, bit, row).  bits[r][b] has bit j set
// where input j is in Sb.  The kernels expand them once per block into
// all-ones / zero words in shared memory (expand_masks), so a term is one
// LOP3 (acc ^ (x & mask)) and a 16-byte shared load brings the masks of
// four inputs.  For K3, an output row that is a unit row of the matrix is
// no product at all: copy[j] names the output row stored straight from
// input j, and only the other rows are product rows (out[r]).
// --------------------------------------------------------------------------

struct GfTerms {
  uint16_t bits[kMaxRows][8];  // bit j: input j's coefficient for product row r has bit b
  uint8_t row[kMaxRows];       // K3: the input row (of rows_in) of input j
  int8_t copy[kMaxRows];       // K3: the output row stored from input j, or -1
  uint8_t out[kMaxRows];       // K3: the output row of product row r
  int rows;                    // product rows
};

// The blob kernels.GfTerms packs: bits, row, copy, out, back to back.
constexpr size_t gf_terms_bytes() {
  return sizeof(GfTerms::bits) + sizeof(GfTerms::row) + sizeof(GfTerms::copy) +
         sizeof(GfTerms::out);
}

GfTerms make_gf_terms(const uint8_t* blob, int rows) {
  GfTerms t;
  memcpy(t.bits, blob, sizeof t.bits);
  blob += sizeof t.bits;
  memcpy(t.row, blob, sizeof t.row);
  memcpy(t.copy, blob + sizeof t.row, sizeof t.copy);
  memcpy(t.out, blob + sizeof t.row + sizeof t.copy, sizeof t.out);
  t.rows = rows;
  return t;
}

// masks[r][b][j] = ~0 where bit j of bits[r][b] is set (r < rows).  The
// caller syncs the block before reading them.
template <int SB>
__device__ __forceinline__ void expand_masks(const GfTerms& t, int rows,
                                             uint32_t (*masks)[8][SB]) {
  for (int i = threadIdx.x; i < rows * 8 * SB; i += kThreads) {
    const int j = i % SB, b = (i / SB) % 8, r = i / (8 * SB);
    masks[r][b][j] = ((t.bits[r][b] >> j) & 1u) ? ~0u : 0u;
  }
}

// One product row of one column word in Horner form; x[j] is 0 past the
// inputs, whose masks are zero too.
template <int SB>
__device__ __forceinline__ uint32_t horner(const uint32_t (&x)[SB],
                                           const uint32_t (*m)[SB]) {
  uint32_t acc = 0;
#pragma unroll
  for (int b = 7; b >= 0; --b) {
    acc = xtime(acc);
#pragma unroll
    for (int j = 0; j < SB; j += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(&m[b][j]);
      acc ^= (x[j] & v.x) ^ (x[j + 1] & v.y) ^ (x[j + 2] & v.z) ^ (x[j + 3] & v.w);
    }
  }
  return acc;
}

// The fixed geometries: fixed_parity<K, M> is the parity product of
// gf.parity_matrix(K, M) in Horner form with only its set terms, as
// straight-line code that kernels.build generates from the port's own
// matrix (MTT_FIXED_GEOMETRIES lists them).
template <int K, int M>
__device__ __forceinline__ void fixed_parity(const uint32_t* x, uint32_t* acc);

#include "mtt_fixed.cuh"

// --------------------------------------------------------------------------
// K1 encode_pack: replaces rs_pallas.encode_pack_fused (P4).  Without the
// pack leg it is also encode_hash_fused (P2), and with a word offset and
// no finalize it is the GPU body of codec_step.encode_subchunk_words
// (X2, left to XLA by the JAX package): one sub-chunk of the async
// overlap chain, XOR-accumulating into the caller's partials.
//
// Bound: operations.  Per stripe it reads the k data rows once and writes
// the m parity rows (the pack leg then writes m packed rows), so at EC 8+4
// and 10 MiB blocks: 10 MiB in + 5 MiB parity + 5 MiB packed; the hash of
// all n rows (19 integer instructions a word) and the parity product
// (172 a column at EC 8+4) on the integer pipe take longer.  What the design does about it:
// * The product in Horner form per parity row: 7 xtimes a row (4 x 7 at
//   EC 8+4, where a chain of powers per input needs 8 x 7) and no test
//   per (input, bit, row).  The fixed geometry (fixed_parity: EC 8+4)
//   runs only the matrix's set terms, generated at build time (4 x 7
//   xtimes and 116 terms a column, the XORs merged three at a time).
//   Every other (k, m) takes the masked form from the per-(k, m) term
//   program (kernels.parity_terms) expanded into shared memory.
// * One column per thread, a persistent grid (kernels.encode_grid: about
//   kEncBlocksPerSM blocks per SM split over the stripes), each block a
//   contiguous run of 256-column tiles; the next tile's k words are
//   loaded before this tile is hashed and multiplied.
// * Flags: a warp ballot per parity row into shared memory (two buffers,
//   by tile parity), read after one barrier per tile: a block-wide vote
//   per parity row would take m barriers a tile.
// * With a ticket the last block applies the length fold
//   (finalize_if_last) after the entry's one memset of accumulator and
//   ticket: group=0 is one launch, group=256 two (the pack leg needs
//   every flag of its row).  Without one the partials stay raw (X2).
// The mxu product runs in its own kernel (encode_mxu_kernel, after K5
// [mxu], whose product it shares), with the same flags and finalize.
// --------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kEncBlocksPerSM = 3;  // residency encode_grid sizes swar for

// Blocks per SM an instantiation is compiled for: the wider buckets keep
// more registers (two hash lanes per row) than a third of the file.
constexpr int enc_min_blocks(int kb, int mb) {
  return kb + mb > 16 ? (kb + mb <= 24 ? 2 : 1) : kEncBlocksPerSM;
}

// The flags of a tile from its per-warp ballots, once a barrier has
// made them visible: thread r < m ORs row r's.
template <int MB>
__device__ __forceinline__ void write_tile_flags(const uint32_t (&ballots)[MB][kWarps],
                                                 uint32_t* __restrict__ flags, int b,
                                                 int m, int g, int tile) {
  const int tid = threadIdx.x;
  if (tid < m) {
    uint32_t any = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) any |= ballots[tid][wp];
    flags[((size_t)b * m + tid) * g + tile] = any ? 1u : 0u;
  }
}

// A tile's flags after one barrier (K1).
template <int MB>
__device__ __forceinline__ void flags_of_tile(const uint32_t (&ballots)[MB][kWarps],
                                              uint32_t* __restrict__ flags, int b,
                                              int m, int g, int tile) {
  __syncthreads();
  write_tile_flags<MB>(ballots, flags, b, m, g, tile);
}

// The block's partials of all k + m rows XORed into `partials`, then the
// last block's finalize when there is a ticket.  `s` is zeroed.
template <int KB, int MB>
__device__ __forceinline__ void fold_and_finalize(
    const uint32_t (&h1)[KB + MB], const uint32_t (&h2)[KB + MB], uint32_t* s,
    uint32_t* __restrict__ partials, unsigned int* __restrict__ ticket, int k,
    int m, uint32_t nbytes) {
  const int n = k + m;
#pragma unroll
  for (int c = 0; c < KB; ++c)
    if (c < k) fold_block(h1[c], h2[c], &s[c * 8]);
#pragma unroll
  for (int r = 0; r < MB; ++r)
    if (r < m) fold_block(h1[KB + r], h2[KB + r], &s[(k + r) * 8]);
  __syncthreads();
  for (int i = threadIdx.x; i < n * 8; i += kThreads)
    if (s[i]) atomicXor(&partials[(size_t)blockIdx.y * n * 8 + i], s[i]);
  if (ticket != nullptr)
    finalize_if_last(partials, (int)gridDim.y * n * 8, nbytes, ticket);
}

// The k words of one column (zeros past k and at or past w).
template <int KB>
__device__ __forceinline__ void load_column(const uint32_t* __restrict__ in, int k,
                                            int w, int col, uint32_t (&x)[KB]) {
#pragma unroll
  for (int c = 0; c < KB; ++c)
    x[c] = c < k && col < w ? __ldg(in + (size_t)c * w + col) : 0u;
}

template <int KB, int MB, int FK, int FM>
__global__ void __launch_bounds__(kThreads, enc_min_blocks(KB, MB))
encode_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ parity,
              uint32_t* __restrict__ partials, unsigned int* __restrict__ ticket,
              uint32_t* __restrict__ flags, int k, int m, int w,
              uint32_t word_offset, uint32_t nbytes, int ntiles,
              int tiles_per_block, const GfTerms terms) {
  constexpr bool kMasked = FK == 0;
  __shared__ uint32_t s[(KB + MB) * 8];
  __shared__ __align__(16) uint32_t masks[kMasked ? MB : 1][8][KB];
  __shared__ uint32_t s_flag[2][MB][kWarps];
  const int b = blockIdx.y;
  const int n = k + m;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  if constexpr (kMasked) expand_masks<KB>(terms, m, masks);
  __syncthreads();

  uint32_t h1[KB + MB], h2[KB + MB];
#pragma unroll
  for (int r = 0; r < KB + MB; ++r) h1[r] = h2[r] = 0;

  const uint32_t* in = data + (size_t)b * k * w;
  uint32_t* out = parity + (size_t)b * m * w;
  const int g = w / kTile;  // flag columns (flags only when w % 256 == 0)
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1

  uint32_t x[KB];
  load_column<KB>(in, k, w, first * kTile + tid, x);
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const int tile = first + i;
    const int col = tile * kTile + tid;
    const bool valid = col < w;
    const uint32_t key = hash_key((uint32_t)col + word_offset);
    uint32_t acc[MB];  // the parity words
    uint32_t nx[KB];   // the next tile's words, in flight
    load_column<KB>(in, k, w, i + 1 < count ? col + kTile : w, nx);
#pragma unroll
    for (int c = 0; c < KB; ++c)
      if (c < k && valid) hash_word(x[c], key, h1[c], h2[c]);
    if constexpr (FK > 0) {
      fixed_parity<FK, FM>(x, acc);
    } else {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < m) acc[r] = horner<KB>(x, masks[r]);
    }
    // row by row: store, hash and the row's ballot
    uint32_t(&ballots)[MB][kWarps] = s_flag[i & 1];
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < m) {
        if (valid) {
          out[(size_t)r * w + col] = acc[r];
          hash_word(acc[r], key, h1[KB + r], h2[KB + r]);
        }
        if (flags != nullptr) {  // uniform
          const uint32_t bal = __ballot_sync(0xffffffffu, valid && acc[r] != 0u);
          if ((tid & 31) == 0) ballots[r][tid >> 5] = bal;
        }
      }
    }
    if (flags != nullptr) flags_of_tile<MB>(ballots, flags, b, m, g, tile);
#pragma unroll
    for (int c = 0; c < KB; ++c) x[c] = nx[c];
  }
  fold_and_finalize<KB, MB>(h1, h2, s, partials, ticket, k, m, nbytes);
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

// --------------------------------------------------------------------------
// K12 group_flags: replaces codec_step.group_flags (X8, which the JAX
// package leaves to XLA), the legacy drain's occupancy screen of a parity
// plane: flag[r][j] = 1 where words j*256 .. j*256+255 of row r hold a
// nonzero word.
//
// Bound: bytes - the plane read once (4 bytes a flag written on top), no
// arithmetic to speak of.  Rows are whole groups (w % 256 == 0), so group
// q of the flattened plane starts at word q * 256 whatever the row: the
// kernel walks groups, not rows.
// Design: warp v of the grid walks the contiguous run of groups
// v * run .. v * run + run - 1 (kernels.group_plan sets `run`, the grid
// is groups / (8 * run) blocks).  A group is two 16-byte loads a lane
// (words 4*lane .. 4*lane+3 and 128 further on: two fully coalesced
// 512-byte sweeps); the loads of kFlagsBatch groups are issued before
// the first of their votes, so up to 128 bytes are in flight a lane;
// lane i keeps the flag of the run's group i, and the flags of up to 32
// groups leave as one coalesced store.  On an H100 at the main path's
// plane, runs of 2 (1,280 blocks, 56 registers: 4 blocks an SM) read
// faster than one group a warp and than a persistent grid of one wave
// whose warps walk runs of 5 in two batches (chip_smoke.py --only
// legacy times each run).  The loads are streaming
// (ld.global.cs: evict-first in L2), so reading a plane that is read
// once does not push the dirty lines of earlier work out of L2.  A plane
// whose start is not 16-byte aligned (a view at a word offset) takes 8
// coalesced 4-byte loads a lane a group instead.
constexpr int kFlagsBatch = 4;
constexpr int kFlagsBlocksPerSM = 4;

template <bool kVec>
__device__ __forceinline__ uint32_t group_or(const uint32_t* g, int lane) {
  if (kVec) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(g) + lane);
    const uint4 b = __ldcs(reinterpret_cast<const uint4*>(g) + 32 + lane);
    return a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w;
  }
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < kTile / 32; ++i) v |= __ldcs(g + i * 32 + lane);
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kFlagsBlocksPerSM)
group_flags_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ flags,
                   long long groups, int run) {
  const long long first =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * run;
  if (first >= groups) return;  // uniform per warp
  const int n = (int)min((long long)run, groups - first);
  const int lane = threadIdx.x & 31;
  const uint32_t* base = words + first * kTile;
  for (int c = 0; c < n; c += 32) {
    const int cn = min(32, n - c);
    uint32_t mine = 0u;
    for (int b = 0; b < cn; b += kFlagsBatch) {
      uint32_t v[kFlagsBatch];
#pragma unroll
      for (int i = 0; i < kFlagsBatch; ++i)
        v[i] = b + i < cn ? group_or<kVec>(base + (size_t)(c + b + i) * kTile, lane) : 0u;
#pragma unroll
      for (int i = 0; i < kFlagsBatch; ++i) {
        const bool any = __any_sync(0xffffffffu, v[i] != 0u);
        if (lane == b + i) mine = any ? 1u : 0u;
      }
    }
    if (lane < cn) flags[first + c + lane] = mine;
  }
}

// --------------------------------------------------------------------------
// K2 phash256_batched: replaces hash.phash256_words_batched (X1, which the
// JAX package leaves to XLA) on the healthy-GET verify.
//
// Bound: bytes, nearly level with the operations.  The hash takes 19
// integer instructions a word and the key 10 a column, once for all rows;
// at (32, 327,680) that is 12.1 us on an H100's integer pipe against
// 12.5 us for reading each word once.
// Design, for bytes in flight and for the key:
// * A thread owns a column quad j..j+3 (j % 4 == 0) and loads it with one
//   16-byte load per row.  The quad is one word of each phash256
//   partition, so the thread folds into 4 + 4 registers per row and no
//   lane pattern is tied to a partition.
// * A block covers a run of 256-quad tiles of one group of kPhashRows
//   rows.  The 4 keys of a quad are computed once per tile and reused by
//   every row of the group.  Tiles go in pairs, and the next pair's
//   2 x kPhashRows 16-byte loads are issued before this pair is hashed,
//   so 16 loads are in flight while the thread computes (120 registers,
//   2 blocks per SM: the grid is one wave of them).
// * A warp folds its 8 partials per row with a transposing reduction (4,
//   2, 1 shuffles that halve the values held, then 2 that finish), so
//   lanes 0, 4, ..., 28 hold the 8 partition words; the warps meet in
//   shared memory and one atomicXor per block per word reaches the zeroed
//   accumulator.
// * One launch: the block that draws the last ticket applies the length
//   fold (finalize_if_last, as K5/K6), so the memset of the accumulator +
//   ticket (one buffer, zeroed by the entry) is the only other work on
//   the stream.  The ticket is part of each call's own buffer, never
//   cached across calls: concurrent GETs launch K2 on different streams.
// Rows that are not 16-byte aligned (a view at an odd offset) take four
// 4-byte loads instead; a uniform branch.
// --------------------------------------------------------------------------

constexpr int kPhashRows = 4;  // rows per K2 block: the group sharing the keys
constexpr int kPhashBlocksPerSM = 2;  // K2's one-wave grid (kernels.phash_grid)

__device__ __forceinline__ uint4 load_quad(const uint32_t* p, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// XOR of v[0..7] over the warp, transposed: lane l returns word
// 4*l[4] + 2*l[3] + l[2] of the fold (l[i]: bit i of the lane), the same
// in the 4 lanes that differ in bits 0, 1.
__device__ __forceinline__ uint32_t warp_fold8(uint32_t (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    const bool hi = lane & (half * 4);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const uint32_t send = hi ? v[i] : v[i + half];
      const uint32_t keep = hi ? v[i + half] : v[i];
      v[i] = keep ^ __shfl_xor_sync(0xffffffffu, send, half * 4);
    }
  }
  uint32_t x = v[0];
  x ^= __shfl_xor_sync(0xffffffffu, x, 2);
  x ^= __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ int warp_fold8_word() {
  const int lane = threadIdx.x & 31;
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ void hash_quad(uint4 v, const uint32_t (&key)[4],
                                          uint32_t (&h)[8]) {
  hash_word(v.x, key[0], h[0], h[4]);
  hash_word(v.y, key[1], h[1], h[5]);
  hash_word(v.z, key[2], h[2], h[6]);
  hash_word(v.w, key[3], h[3], h[7]);
}

// Quad q of the group's rows: zeros where `ok` is false or past the group.
__device__ __forceinline__ void load_tile(const uint32_t* in, int rows, int w,
                                          int q, bool ok, bool aligned,
                                          uint4 (&v)[kPhashRows]) {
#pragma unroll
  for (int r = 0; r < kPhashRows; ++r)
    v[r] = ok && r < rows ? load_quad(in + (size_t)r * w + 4 * q, aligned) : uint4{};
}

// The quad's 4 keys once, then every row of the group.
__device__ __forceinline__ void hash_tile(const uint4 (&v)[kPhashRows], int rows,
                                          int q, uint32_t (&h)[kPhashRows][8]) {
  uint32_t key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key[i] = hash_key((uint32_t)(4 * q + i));
#pragma unroll
  for (int r = 0; r < kPhashRows; ++r)
    if (r < rows) hash_quad(v[r], key, h[r]);
}

__global__ void __launch_bounds__(kThreads, kPhashBlocksPerSM)
phash_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ acc,
             int R, int w, int tiles_per_block, uint32_t nbytes, bool aligned) {
  __shared__ uint32_t s[kPhashRows * 8];
  const int tid = threadIdx.x;
  if (tid < kPhashRows * 8) s[tid] = 0;
  const int r0 = blockIdx.y * kPhashRows;
  const int rows = min(kPhashRows, R - r0);
  const int nq = w >> 2;  // column quads
  const uint32_t* in = words + (size_t)r0 * w;
  uint32_t h[kPhashRows][8];
#pragma unroll
  for (int r = 0; r < kPhashRows; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) h[r][i] = 0;

  // tile t of this block: quad q0 + 256 t; tiles go in pairs, and the
  // next pair's loads are issued before this pair is hashed
  const int q0 = blockIdx.x * tiles_per_block * kThreads + tid;
  const int tpb = tiles_per_block;
  uint4 a[kPhashRows], b[kPhashRows];
  load_tile(in, rows, w, q0, q0 < nq, aligned, a);
  load_tile(in, rows, w, q0 + kThreads, 1 < tpb && q0 + kThreads < nq, aligned, b);
#pragma unroll 1
  for (int t = 0; t < tpb; t += 2) {
    const int qa = q0 + t * kThreads, qb = qa + kThreads;
    const int qc = qb + kThreads, qd = qc + kThreads;
    uint4 c[kPhashRows], d[kPhashRows];
    load_tile(in, rows, w, qc, t + 2 < tpb && qc < nq, aligned, c);
    load_tile(in, rows, w, qd, t + 3 < tpb && qd < nq, aligned, d);
    if (qa < nq) hash_tile(a, rows, qa, h);
    if (t + 1 < tpb && qb < nq) hash_tile(b, rows, qb, h);
#pragma unroll
    for (int r = 0; r < kPhashRows; ++r) {
      a[r] = c[r];
      b[r] = d[r];
    }
  }

  __syncthreads();  // s zeroed
#pragma unroll
  for (int r = 0; r < kPhashRows; ++r) {
    if (r < rows) {
      const uint32_t x = warp_fold8(h[r]);
      if ((tid & 3) == 0) atomicXor(&s[r * 8 + warp_fold8_word()], x);
    }
  }
  __syncthreads();
  if (tid < rows * 8 && s[tid]) atomicXor(&acc[(size_t)r0 * 8 + tid], s[tid]);
  finalize_if_last(acc, R * 8, nbytes, reinterpret_cast<unsigned int*>(acc) + R * 8);
}

// --------------------------------------------------------------------------
// K3 gf_matmul_words: replaces rs_pallas.matmul_words (P1) on the
// degraded-GET reconstruct (and the backend's re-solve of a stripe).  The
// matrix is known only at run time (the inverted sub-matrix of the
// survivor pattern) and arrives as the GfTerms that kernels.gf_terms
// compiles once per (matrix, rows), whose row[] picks the s input rows
// straight out of the (B, rows_in, w) shard batch: no gather copy.
//
// Bound: bytes.  Degraded GET at EC 8+4 with shards 1, 3, 10, 12 absent
// rebuilds all 8 data rows, but 6 of them are unit rows of the matrix
// (present data rows): copies.  Only the 2 others take the product, 2 x
// (7 xtimes + 29 terms) = 86 instructions a column, which the integer pipe
// does in less time than reading 8 rows and writing 8 (20 MiB a stripe).
// Design, for bytes in flight:
// * A thread owns a column quad and moves it with one 16-byte load per
//   input row and one 16-byte store per output row (4-byte ones where a
//   row is not 16-byte aligned, or past w).  Copies are stored straight
//   from the loaded quad.
// * Product rows in Horner form from masks expanded into shared memory
//   (expand_masks); one 16-byte shared load brings four inputs' masks,
//   used for the quad's four words.
// * A grid of about kGfBlocksPerSM blocks per SM (kernels.gf_grid)
//   strides over the (stripe, 256-quad tile) pairs.
// --------------------------------------------------------------------------

constexpr int kGfBlocksPerSM = 4;  // the grid gf_grid sizes

__device__ __forceinline__ uint4 xtime4(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

// Words col .. col+3 of a row: one 16-byte load when `full` (16-byte
// aligned rows, the quad inside w), else 4-byte loads inside w.
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row, int col,
                                       int w, bool full) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(row + col));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (col < w) v.x = __ldg(row + col);
  if (col + 1 < w) v.y = __ldg(row + col + 1);
  if (col + 2 < w) v.z = __ldg(row + col + 2);
  if (col + 3 < w) v.w = __ldg(row + col + 3);
  return v;
}

__device__ __forceinline__ void store4(uint32_t* row, int col, int w, bool full,
                                       uint4 v) {
  if (full) {
    *reinterpret_cast<uint4*>(row + col) = v;
    return;
  }
  if (col < w) row[col] = v.x;
  if (col + 1 < w) row[col + 1] = v.y;
  if (col + 2 < w) row[col + 2] = v.z;
  if (col + 3 < w) row[col + 3] = v.w;
}

template <int SB>
__global__ void __launch_bounds__(kThreads, SB <= 8 ? kGfBlocksPerSM : 2)
gf_matmul_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int B, int rows_in, int o, int s, int w, bool aligned,
                 const GfTerms terms) {
  __shared__ __align__(16) uint32_t masks[kMaxRows][8][SB];
  expand_masks<SB>(terms, terms.rows, masks);
  __syncthreads();
  const int nq = (w + 3) >> 2;
  const int tiles = (nq + kThreads - 1) / kThreads;  // per stripe
#pragma unroll 1
  for (int t = blockIdx.x; t < B * tiles; t += gridDim.x) {
    const int b = t / tiles;
    const int col = 4 * ((t - b * tiles) * kThreads + threadIdx.x);
    if (col >= w) continue;
    const bool full = aligned && col + 4 <= w;
    const uint32_t* src = in + (size_t)b * rows_in * w;
    uint32_t* dst = out + (size_t)b * o * w;
    uint4 x[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j)
      x[j] = j < s ? load4(src + (size_t)terms.row[j] * w, col, w, full)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int d = terms.copy[j];
      if (j < s && d >= 0) store4(dst + (size_t)d * w, col, w, full, x[j]);
    }
#pragma unroll 1
    for (int r = 0; r < terms.rows; ++r) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int bit = 7; bit >= 0; --bit) {
        acc = xtime4(acc);
#pragma unroll
        for (int j = 0; j < SB; j += 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(&masks[r][bit][j]);
          const uint32_t mv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc.x ^= x[j + i].x & mv[i];
            acc.y ^= x[j + i].y & mv[i];
            acc.z ^= x[j + i].z & mv[i];
            acc.w ^= x[j + i].w & mv[i];
          }
        }
      }
      store4(dst + (size_t)terms.out[r] * w, col, w, full, acc);
    }
  }
}

// --------------------------------------------------------------------------
// The pipelined twins K5 and K6 (MINIO_TPU_CODEC_OVERLAP=pipeline).
//
// P6/P7 keep the stripe in HBM and walk its 4096-word tiles inside ONE
// kernel invocation per stripe: a 2-slot VMEM ring prefetches tile t+1
// while tile t computes, and the hash accumulator, flags and pack
// counter stay on the chip across the row.  Their (B,) grid would use
// 1 to 4 of the 132 SMs here, so K5/K6 keep the idea and not the grid:
//
// * Persistent grid.  The wrapper (kernels.pipelined_grid for K6 and K5
//   [mxu], kernels.encode_pipelined_grid for K5) launches about as many
//   blocks as fit resident - 2 per SM for K6 and K5 [mxu], 3 for K5,
//   which their __launch_bounds__ hold the register budget to - split
//   evenly over the B stripes; each block walks a CONTIGUOUS run of
//   256-column tiles of one stripe and keeps its (h1, h2) per row in
//   registers over the whole run.  At B = 1, EC 8+4 and 10 MiB blocks
//   that is 1,280 tiles over 256 blocks of 5: 256 atomicXors per digest
//   word, not one per tile.
// * Asynchronous staging.  The k (K5) or present n (K6) input rows of
//   a tile go global -> shared with 16-byte cp.async.cg copies into a
//   kStages-deep ring: tiles t+1 and t+2 are in flight while tile t
//   computes out of shared memory (one commit group per tile; K6 waits
//   with cp.async.wait_group kStages-1 after committing tile t+2, K5 with
//   kStages-2 before staging it, behind its one barrier a tile).  Outputs are
//   stored straight from registers; a store does not stall the thread,
//   so there is no outbound ring.  K6 stages only the present rows.
// * Ragged tails.  Every w % 4 == 0 is taken: a 16-byte copy past w is
//   zero-filled (src-size 0), and stores and hashing are masked.
// * Finalize by the last block.  Each block XORs its folded partials
//   into the zeroed accumulator, fences, and takes a ticket; the block
//   that draws the last ticket applies the length fold to all of them,
//   so no finalize launch follows.  K5's pack leg stays K1's second
//   launch (pack_kernel), which writes the full-row `packed`: the prefix
//   P6 promises, zeros behind it.
// Bound: as K1/K4 (each input row read once, outputs written once; the
// integer pipe's work takes longer).
// --------------------------------------------------------------------------

constexpr int kStages = 3;                 // ring depth: 2 tiles in flight
constexpr int kChunksPerRow = kTile / 4;   // 16-byte copies per tile row
constexpr int kPipeBlocksPerSM = 2;        // residency the grid is sized for

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The chunk swizzle of the mxu kernels' tiles and rings: rows 4t .. 4t + 3 XOR their chunk
// index by 2t.  mxu_ring_tile's lane (g, tig) reads a 16-byte chunk of
// rows 4 tig + i, so for each i the 8 chunks a warp reads (4 tig x 2
// chunks) fall on 8 different quads of banks; a warp reading one row's
// 32 consecutive words (the hash leg) still meets 32 banks, since the
// XOR only permutes the 8 chunks of an aligned 32-word run.
// kernels.ring_swizzle is the same function.
__host__ __device__ constexpr int ring_swizzle(int row) { return ((row >> 2) << 1) & 7; }

// Stage `rows` rows of tile `tile` into `slot` (row j of the slot <- input
// row src_row[j]), zero-filling the columns at or past w; with kSwizzle
// chunk c of row j lands at chunk c ^ ring_swizzle(j) (K6 [mxu]).
template <bool kSwizzle>
__device__ __forceinline__ void stage_tile(uint32_t* slot, const uint32_t* in,
                                           const uint8_t* src_row, int rows,
                                           int w, int tile) {
  const int base = tile * kTile;
  for (int i = threadIdx.x; i < rows * kChunksPerRow; i += kThreads) {
    const int j = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 4;
    const bool ok = base + c < w;
    const uint32_t* src = in + (size_t)src_row[j] * w + (ok ? base + c : 0);
    cp_async16(slot + j * kTile + (kSwizzle ? c ^ (ring_swizzle(j) << 2) : c), src,
               ok ? 16 : 0);
  }
}

// --------------------------------------------------------------------------
// K5 encode_pack_pipelined: replaces rs_pallas.encode_pack_pipelined (P6).
// P4's function (K1's outputs, bit for bit) on the pipelined design above.
//
// Bound: operations, as K1 (at EC 8+4 the hash of all 12 rows and the
// 172-instruction parity product a column take longer on the integer
// pipe than the 20 MiB a stripe take to move).  What the design does:
// * K1's product, called as K1 calls it: fixed_parity<FK, FM> for the
//   fixed geometries (EC 8+4), the masked Horner form over the term
//   program (kernels.parity_terms, expanded once per block) for every
//   other (k, m).  A thread reads its column's k words from the ring slot
//   into registers once, hashes them and multiplies them.
// * One barrier a tile.  Tile i's barrier (after its copies landed)
//   also frees the slot tile i + 2 is staged into (read in tile i - 1)
//   and publishes tile i - 1's flag ballots: a warp ballot per parity
//   row goes into shared memory (two buffers, by tile parity) and
//   threads r < m OR row r's after the next barrier.
// * K1's residency and grid (enc_min_blocks, kernels.encode_pipelined_grid):
//   3 blocks per SM at EC 8+4, whose register budget holds with no
//   next-tile registers; the ring takes 24 KiB a block at k = 8.  The
//   [mxu] kernel runs K6's 2 blocks per SM (kPipeBlocksPerSM), 1 past 16
//   rows.
// * A thread stages the same 16-byte chunk column of its rows in every
//   tile (stage_rows), and the fixed geometry compiles k and m in, so
//   no test on them is left in the tile loop.
//
// K5 [mxu] (encode_pipelined_mxu_kernel) has its own product,
// mxu_ring_tile, on a swizzled ring, which K1 [mxu], K4 [mxu] and K6 [mxu]
// share; K7 has a product of its own.
// --------------------------------------------------------------------------



// A thread's share of staging every tile: 16-byte chunk c = tid % 64 of
// rows tid / 64 + 4t (t < KB / 4, rows < k), the same chunk column in
// every tile, so only the tile's base moves (`src` is the thread's chunk
// of tile 0).  Columns at or past w are zero-filled.  With kSwizzle the
// chunk lands at c ^ ring_swizzle(row), which is 2t for all its rows.
template <int KB, bool kSwizzle>
__device__ __forceinline__ void stage_rows(uint32_t* slot, const uint32_t* in,
                                           const uint32_t* src, int k, int w,
                                           int tile) {
  const int c = threadIdx.x % kChunksPerRow, j0 = threadIdx.x / kChunksPerRow;
  const bool ok = tile * kTile + 4 * c < w;
  const uint32_t* from = ok ? src + tile * kTile : in;
#pragma unroll
  for (int t = 0; t < KB / 4; ++t) {
    const int dc = kSwizzle ? c ^ ring_swizzle(4 * t) : c;
    if (j0 + 4 * t < k)
      cp_async16(slot + (j0 + 4 * t) * kTile + 4 * dc, ok ? from + (size_t)4 * t * w : in,
                 ok ? 16 : 0);
  }
}

// A tile's parity words: store, hash and the rows' ballots into
// `ballots` (flags != nullptr).
template <int KB, int MB>
__device__ __forceinline__ void emit_parity(const uint32_t (&acc)[MB], int m, bool valid,
                                            uint32_t key, uint32_t* __restrict__ out,
                                            int w, int col, uint32_t (&h1)[KB + MB],
                                            uint32_t (&h2)[KB + MB], bool flags,
                                            uint32_t (&ballots)[MB][kWarps]) {
  if (valid) {
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < m) {
        out[(size_t)r * w + col] = acc[r];
        hash_word(acc[r], key, h1[KB + r], h2[KB + r]);
      }
    }
  }
  if (flags) {  // uniform
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < m) {
        const uint32_t bal = __ballot_sync(0xffffffffu, valid && acc[r] != 0u);
        if ((threadIdx.x & 31) == 0) ballots[r][threadIdx.x >> 5] = bal;
      }
    }
  }
}

template <int KB, int MB, int FK, int FM>
__global__ void __launch_bounds__(kThreads, enc_min_blocks(KB, MB))
encode_pipelined_kernel(const uint32_t* __restrict__ data,
                        uint32_t* __restrict__ parity,
                        uint32_t* __restrict__ partials,
                        unsigned int* __restrict__ ticket,
                        uint32_t* __restrict__ flags, int k_, int m_, int w,
                        int ntiles, int tiles_per_block, uint32_t nbytes,
                        const GfTerms terms) {
  constexpr bool kMasked = FK == 0;
  const int k = FK ? FK : k_, m = FK ? FM : m_;  // the fixed geometry's at compile time
  extern __shared__ __align__(16) uint32_t ring[];  // kStages x k x kTile
  __shared__ uint32_t s[(KB + MB) * 8];
  __shared__ __align__(16) uint32_t masks[kMasked ? MB : 1][8][KB];
  __shared__ uint32_t s_flag[2][MB][kWarps];
  const int b = blockIdx.y;
  const int n = k + m;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  if constexpr (kMasked) expand_masks<KB>(terms, m, masks);

  const uint32_t* in = data + (size_t)b * k * w;
  uint32_t* out = parity + (size_t)b * m * w;
  const int g = w / kTile;  // flag columns (flags only when w % 256 == 0)
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1
  const int slot_words = k * kTile;
  const uint32_t* src =
      in + (size_t)(tid / kChunksPerRow) * w + 4 * (tid % kChunksPerRow);

#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < count) stage_rows<KB, false>(ring + st * slot_words, in, src, k, w, first + st);
    cp_async_commit();
  }

  uint32_t h1[KB + MB], h2[KB + MB];
#pragma unroll
  for (int r = 0; r < KB + MB; ++r) h1[r] = h2[r] = 0;

#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // ... and every other thread's; slot (i-1) % kStages is free
    if (flags != nullptr && i > 0)
      write_tile_flags<MB>(s_flag[(i - 1) & 1], flags, b, m, g, first + i - 1);
    const int next = i + kStages - 1;
    if (next < count)
      stage_rows<KB, false>(ring + (next % kStages) * slot_words, in, src, k, w,
                            first + next);
    cp_async_commit();
    const uint32_t* cur = ring + (i % kStages) * slot_words;
    const int col = (first + i) * kTile + tid;
    const bool valid = col < w;
    const uint32_t key = hash_key((uint32_t)col);
    uint32_t x[KB];
#pragma unroll
    for (int c = 0; c < KB; ++c) x[c] = c < k ? cur[c * kTile + tid] : 0u;
    if (valid) {
#pragma unroll
      for (int c = 0; c < KB; ++c)
        if (c < k) hash_word(x[c], key, h1[c], h2[c]);
    }
    uint32_t acc[MB];
    if constexpr (FK > 0) {
      fixed_parity<FK, FM>(x, acc);
    } else {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < m) acc[r] = horner<KB>(x, masks[r]);
    }
    emit_parity<KB, MB>(acc, m, valid, key, out, w, col, h1, h2, flags != nullptr,
                        s_flag[i & 1]);
  }
  if (flags != nullptr) {
    __syncthreads();
    write_tile_flags<MB>(s_flag[(count - 1) & 1], flags, b, m, g, first + count - 1);
  }
  fold_and_finalize<KB, MB>(h1, h2, s, partials, ticket, k, m, nbytes);
}

// --------------------------------------------------------------------------
// K5 [mxu]'s product, mxu_ring_tile: the 1-bit tensor-core product above
// (A operand kernels.mxu_fragments; B words: byte q of input rows
// 4 tig .. 4 tig + 3) on the ring:
// * Loads.  A warp's 32 word columns are 4 groups of 8 (two 16-byte
//   chunks).  Lane (g, tig), h = g / 4, loads chunk h of the group from
//   each of its 4 rows with one 16-byte shared load (4 loads a group,
//   not 16 word loads), on the swizzled ring (ring_swizzle): no bank
//   conflicts.  Word j of the chunk feeds n-tile j of the group, whose 8
//   byte columns are words 8 grp + j (h = 0) and 8 grp + 4 + j (h = 1).
// * Latency.  A group's 4 n-tiles x (output rows / 2) m-tiles are
//   independent MMAs, unrolled together with the next group's loads.
// * Repack.  The m-tiles go in pairs: the 8 accumulators (counts of at
//   most 128) are summed into two words of bytes (c0, c1, d0, d1 and c2,
//   c3, d2, d3), whose bits 0 of each byte, moved to q and q + 4, give
//   both m-tiles' 16 output bits of this lane in one word; two shuffles
//   join the 4 lanes of a byte and one more brings the neighbouring half
//   word, so 3 shuffles serve 2 m-tiles, not one.  Sums and products,
//   not shifts and ORs: IMAD issues to the FMA pipe, beside the integer
//   pipe that the hash leg fills.
// * Return.  A warp's outputs are its own lanes' columns: they go
//   through out_s with one __syncwarp(), no block barrier.
// Bound: as its callers'; chip_smoke.mxu_ring_design_ops counts its
// integer work per word column.
// --------------------------------------------------------------------------

constexpr int kOutStride = kTile + 1;  // out_s rows: an m-tile's 2 rows on 2 banks

// This lane's 16-byte chunk of group grp from each of its rows 4 tig + i
// (zeros past k), on the swizzled ring.
__device__ __forceinline__ void ring_chunks(const uint32_t* slot, int k, int grp,
                                            uint4 (&x)[4]) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int chunk = ((threadIdx.x >> 5) * 8 + 2 * grp + (lane >> 4)) ^ ring_swizzle(4 * tig);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = 4 * tig + i < k
               ? *reinterpret_cast<const uint4*>(slot + (4 * tig + i) * kTile + 4 * chunk)
               : make_uint4(0u, 0u, 0u, 0u);
}

// An MMA's B word: byte `sel` picks of four rows' words.
__device__ __forceinline__ uint32_t b_word(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, uint32_t sel) {
  return __byte_perm(__byte_perm(r0, r1, sel), __byte_perm(r2, r3, sel), 0x5410);
}

template <int MB>
__device__ __forceinline__ void mxu_ring_tile(const uint32_t* slot, int k, int m,
                                              uint32_t* out_s,
                                              const uint32_t (&af)[MB]) {
  constexpr int kPairs = (MB / 2 + 1) / 2;  // m-tile pairs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, q = g & 3, h = g >> 2;
  const uint32_t sel = (uint32_t)q | ((uint32_t)(4 + q) << 4);
  const uint32_t qbit = 1u << q;
  const bool writer = q == 0 && (tig & 1) == 0;
  uint4 x[4];
  ring_chunks(slot, k, 0, x);
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    // the B words of n-tiles j = 0..3: byte q of word j of the 4 rows
    const uint32_t bw[4] = {b_word(x[0].x, x[1].x, x[2].x, x[3].x, sel),
                            b_word(x[0].y, x[1].y, x[2].y, x[3].y, sel),
                            b_word(x[0].z, x[1].z, x[2].z, x[3].z, sel),
                            b_word(x[0].w, x[1].w, x[2].w, x[3].w, sel)};
    if (grp < 3) ring_chunks(slot, k, grp + 1, x);  // the next group's, in flight
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (4 * p >= m) break;  // uniform
      const bool second = 4 * p + 2 < m;  // m-tile 2p + 1 has rows
      uint32_t c[4][4], d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // every MMA of the group first
        mma_b1(af[4 * p], af[4 * p + 1], bw[j], c[j][0], c[j][1], c[j][2], c[j][3]);
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0u;
        if (second)
          mma_b1(af[4 * p + 2], af[4 * p + 3], bw[j], d[j][0], d[j][1], d[j][2], d[j][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // bytes: columns 2 tig, 2 tig + 1 of m-tile 2p, then of 2p + 1
        // (the counts are at most 128: a sum places them), their bits 0
        // at q and q + 4; the lanes' bits are disjoint, so sums join them
        const uint32_t lo = c[j][0] + (c[j][1] << 8) + (d[j][0] << 16) + (d[j][1] << 24);
        const uint32_t hi = c[j][2] + (c[j][3] << 8) + (d[j][2] << 16) + (d[j][3] << 24);
        uint32_t v = ((lo & 0x01010101u) + (hi & 0x01010101u) * 16u) * qbit;
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, v, 1);
        if (writer) {
          const int col = warp * 32 + 8 * grp + 2 * tig + j;  // tig 0 or 2
          const int r0 = 4 * p + h;
          if (r0 < m) out_s[r0 * kOutStride + col] = __byte_perm(v, other, 0x5410);
          if (r0 + 2 < m) out_s[(r0 + 2) * kOutStride + col] = __byte_perm(v, other, 0x7632);
        }
      }
    }
  }
}

// K5 [mxu]: the ring of encode_pipelined_kernel, swizzled for
// mxu_ring_tile; the product comes back through out_s with a
// __syncwarp(), and flags, stores, hashing and finalize are swar's.
template <int KB, int MB, int FK, int FM>
__global__ void __launch_bounds__(kThreads, KB + MB > 16 ? 1 : kPipeBlocksPerSM)
encode_pipelined_mxu_kernel(const uint32_t* __restrict__ data,
                            uint32_t* __restrict__ parity,
                            uint32_t* __restrict__ partials,
                            unsigned int* __restrict__ ticket,
                            uint32_t* __restrict__ flags, int k_, int m_, int w,
                            int ntiles, int tiles_per_block, uint32_t nbytes,
                            const uint32_t* __restrict__ amat) {
  const int k = FK ? FK : k_, m = FK ? FM : m_;  // the fixed geometry's at compile time
  extern __shared__ __align__(16) uint32_t ring[];  // kStages x k x kTile
  __shared__ uint32_t s[(KB + MB) * 8];
  __shared__ uint32_t s_flag[2][MB][kWarps];
  __shared__ uint32_t out_s[MB * kOutStride];
  const int b = blockIdx.y;
  const int n = k + m;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  uint32_t af[MB];
  load_frags<MB>(amat, af);

  const uint32_t* in = data + (size_t)b * k * w;
  uint32_t* out = parity + (size_t)b * m * w;
  const int g = w / kTile;
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1
  const int slot_words = k * kTile;
  const uint32_t* src =
      in + (size_t)(tid / kChunksPerRow) * w + 4 * (tid % kChunksPerRow);

#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < count) stage_rows<KB, true>(ring + st * slot_words, in, src, k, w, first + st);
    cp_async_commit();
  }

  uint32_t h1[KB + MB], h2[KB + MB];
#pragma unroll
  for (int r = 0; r < KB + MB; ++r) h1[r] = h2[r] = 0;

#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (flags != nullptr && i > 0)
      write_tile_flags<MB>(s_flag[(i - 1) & 1], flags, b, m, g, first + i - 1);
    const int next = i + kStages - 1;
    if (next < count)
      stage_rows<KB, true>(ring + (next % kStages) * slot_words, in, src, k, w,
                            first + next);
    cp_async_commit();
    const uint32_t* cur = ring + (i % kStages) * slot_words;
    const int col = (first + i) * kTile + tid;
    const bool valid = col < w;
    const uint32_t key = hash_key((uint32_t)col);
    if (valid) {
#pragma unroll
      for (int c = 0; c < KB; ++c)
        if (c < k)
          hash_word(cur[c * kTile + (tid ^ (ring_swizzle(c) << 2))], key, h1[c], h2[c]);
    }
    mxu_ring_tile<MB>(cur, k, m, out_s, af);
    __syncwarp();
    uint32_t acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = r < m ? out_s[r * kOutStride + tid] : 0u;
    emit_parity<KB, MB>(acc, m, valid, key, out, w, col, h1, h2, flags != nullptr,
                        s_flag[i & 1]);
  }
  if (flags != nullptr) {
    __syncthreads();
    write_tile_flags<MB>(s_flag[(count - 1) & 1], flags, b, m, g, first + count - 1);
  }
  fold_and_finalize<KB, MB>(h1, h2, s, partials, ticket, k, m, nbytes);
}

// --------------------------------------------------------------------------
// K1 [mxu]: K5 [mxu]'s product on a tile staged through registers.
//
// encode_mxu_kernel computes K1's function (P4 under mxu: the parity
// product of _mxu_rows).  Bound: as K1 (operations, the hash of n rows on
// the integer pipe); the product's bit pairs on the tensor cores take
// less.  What the design does:
// * The product is mxu_ring_tile, as K5 [mxu] calls it, on a tile held in
//   two swizzled shared buffers (ring_swizzle): 16-byte B loads that meet
//   8 bank quads, a group's MMAs before their repack, m-tiles repacked in
//   pairs, results back through out_s with a __syncwarp().
// * Staging through registers, one barrier a tile.  A thread owns the
//   16-byte chunk column of stage_rows (chunk tid % 64 of slots tid / 64
//   + 4t), loads tile i + 1's chunks with 16-byte loads (load_chunks)
//   while tile i computes, and stores them at the swizzled chunk
//   (store_chunks) into the other buffer, which tile i - 1 read before
//   tile i's barrier.  No cp.async ring: the chunks in flight take
//   bucket(rows) / 4 x 16 bytes of registers a thread, the two buffers 2 x
//   rows KiB.  K5 [mxu]'s ring in its place, timed beside it on an H100,
//   ran 1-2 % faster (PERF.md); this staging stays because it takes two
//   buffers, not three, and K4 stores its copies from the same registers.
// * The hash leg reads the thread's column of each slot from the tile at
//   the swizzled index, as K5 [mxu] does.
// * Parity stores, hashing and ballot flags through emit_parity, the flags
//   published a tile late after the one barrier (K5's), the last-block
//   finalize of fold_and_finalize; EC 8+4 compiles k and m in.
// * A persistent grid of kPipeBlocksPerSM blocks per SM (the residency its
//   __launch_bounds__ holds; kernels.pipelined_grid), each block a
//   contiguous run of tiles of one stripe.
// Columns at or past w load as zeros and are neither stored nor hashed;
// rows that are not 16-byte aligned load 4 bytes at a time (load4).
// --------------------------------------------------------------------------

// A thread's chunks of tile `tile` (zeros past w): chunk tid % 64 of slots
// j = tid / 64 + 4t < rows, slot j lying in the row that row_of(j) points
// at.
template <int SB, typename RowOf>
__device__ __forceinline__ void load_chunks(RowOf row_of, int rows, int w, int tile,
                                            bool aligned, uint4 (&x)[SB / 4]) {
  const int j0 = threadIdx.x / kChunksPerRow;
  const int col = tile * kTile + 4 * (threadIdx.x % kChunksPerRow);
  const bool full = aligned && col + 4 <= w;
#pragma unroll
  for (int t = 0; t < SB / 4; ++t)
    x[t] = j0 + 4 * t < rows ? load4(row_of(j0 + 4 * t), col, w, full)
                             : make_uint4(0u, 0u, 0u, 0u);
}

// The chunks of load_chunks into a tile buffer, chunk c of slot j at chunk
// c ^ ring_swizzle(j) (ring_swizzle(j) == ring_swizzle(4t) for this
// thread's slots).
template <int SB>
__device__ __forceinline__ void store_chunks(uint32_t* buf, int rows,
                                             const uint4 (&x)[SB / 4]) {
  const int c = threadIdx.x % kChunksPerRow, j0 = threadIdx.x / kChunksPerRow;
#pragma unroll
  for (int t = 0; t < SB / 4; ++t)
    if (j0 + 4 * t < rows)
      *reinterpret_cast<uint4*>(buf + (j0 + 4 * t) * kTile + 4 * (c ^ ring_swizzle(4 * t))) =
          x[t];
}

template <int KB, int MB, int FK, int FM>
__global__ void __launch_bounds__(kThreads, KB + MB > 16 ? 1 : kPipeBlocksPerSM)
encode_mxu_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ parity,
                  uint32_t* __restrict__ partials, unsigned int* __restrict__ ticket,
                  uint32_t* __restrict__ flags, int k_, int m_, int w,
                  uint32_t word_offset, uint32_t nbytes, int ntiles,
                  int tiles_per_block, bool aligned, const uint32_t* __restrict__ amat) {
  const int k = FK ? FK : k_, m = FK ? FM : m_;  // the fixed geometry's at compile time
  extern __shared__ __align__(16) uint32_t tiles[];  // 2 x k x kTile, swizzled
  __shared__ uint32_t s[(KB + MB) * 8];
  __shared__ uint32_t s_flag[2][MB][kWarps];
  __shared__ uint32_t out_s[MB * kOutStride];
  const int b = blockIdx.y;
  const int n = k + m;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  uint32_t af[MB];
  load_frags<MB>(amat, af);

  const uint32_t* in = data + (size_t)b * k * w;
  uint32_t* out = parity + (size_t)b * m * w;
  const int g = w / kTile;  // flag columns (flags only when w % 256 == 0)
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1
  const int slot_words = k * kTile;
  const auto row_of = [&](int j) { return in + (size_t)j * w; };

  uint32_t h1[KB + MB], h2[KB + MB];
#pragma unroll
  for (int r = 0; r < KB + MB; ++r) h1[r] = h2[r] = 0;

  uint4 x[KB / 4];  // the next tile's chunks, in flight
  load_chunks<KB>(row_of, k, w, first, aligned, x);
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    uint32_t* cur = tiles + (i & 1) * slot_words;
    store_chunks<KB>(cur, k, x);
    if (i + 1 < count) load_chunks<KB>(row_of, k, w, first + i + 1, aligned, x);
    __syncthreads();  // tile i staged; tile i - 1's buffer and out_s are free
    if (flags != nullptr && i > 0)
      write_tile_flags<MB>(s_flag[(i - 1) & 1], flags, b, m, g, first + i - 1);
    const int col = (first + i) * kTile + tid;
    const bool valid = col < w;
    const uint32_t key = hash_key((uint32_t)col + word_offset);
    if (valid) {
#pragma unroll
      for (int c = 0; c < KB; ++c)
        if (c < k)
          hash_word(cur[c * kTile + (tid ^ (ring_swizzle(c) << 2))], key, h1[c], h2[c]);
    }
    mxu_ring_tile<MB>(cur, k, m, out_s, af);
    __syncwarp();
    uint32_t acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = r < m ? out_s[r * kOutStride + tid] : 0u;
    emit_parity<KB, MB>(acc, m, valid, key, out, w, col, h1, h2, flags != nullptr,
                        s_flag[i & 1]);
  }
  if (flags != nullptr) {
    __syncthreads();
    write_tile_flags<MB>(s_flag[(count - 1) & 1], flags, b, m, g, first + count - 1);
  }
  fold_and_finalize<KB, MB>(h1, h2, s, partials, ticket, k, m, nbytes);
}

// --------------------------------------------------------------------------
// K6 verify_reconstruct_pipelined: replaces
// rs_pallas.verify_reconstruct_pipelined (P7), and K4 verify_reconstruct:
// replaces rs_pallas.verify_reconstruct_fused (P5) on heal; with a word
// offset and no finalize K4 is also the GPU body of
// codec_step.verify_reconstruct_subchunk_words (X3, left to XLA by the JAX
// package): one sub-chunk of the async overlap chain.  Every present row
// of a (B, n, w) shard batch is hashed and the k data rows are rebuilt
// from the first k present rows (the survivors), in one pass.  Rows not in
// ``present`` are neither read nor hashed; their partials stay zero.  That
// differs from the TPU kernels, which hash absent rows' garbage too: the
// caller's ok mask is False for them whatever their digest.
//
// Bound: bytes (at heal's pattern, EC 8+4, shards 1, 3, 10, 12 gone, the
// operations come close: 8 present rows hashed, 2 data rows rebuilt in
// 2 x (7 xtimes + 29 terms) = 86 instructions a column).
// Both kernels stage the np present rows of a tile in row order (slot j
// holds shard row row[j]; slots 0 .. k - 1 are the survivors), K6 into its
// cp.async ring (swizzled for mxu), K4 through registers into two swizzled
// buffers (K1 [mxu]'s staging, one barrier a tile), and run one tile body
// (vr_tile).  The design of the product, for the terms the matrix has:
// * Output data rows that are present are copies: their row of the
//   reconstruction matrix is a unit vector.  K6 stores them straight from
//   the ring slot it hashes (copy[j]), K4 with 16-byte stores straight from
//   its staging registers.
// * Only the rb rebuilt rows go through the GF product.  swar takes it in
//   Horner form over the coefficient bits: acc = S7; acc = xtime(acc) ^
//   S6; ...; ^ S0, where Sb is the XOR of the k survivor words whose
//   coefficient for that row has bit b set.  The host compiles the masks
//   once per (present, k) (kernels.vr_terms) into the kernel parameters as
//   all-ones / zero words, indexed at compile time, so each candidate
//   term is one LOP3 (acc ^ (x & mask)) plus half a ULDC.64 (the masks
//   reach uniform registers two at a time), and a rebuilt row costs 7
//   xtimes + 8k such terms, with no test and no branch per term.  The
//   function itself needs only the set terms (heal's pattern: 7 xtimes
//   and 29 terms a row); skipping the others would take a test or a
//   branch per term.  mxu runs mxu_ring_tile on the swizzled tile, whose A
//   operand (kernels._mxu_rebuilt_operand) holds the (rb, k) rows of the
//   matrix (rb <= min(k, n - k) <= 8): one m-tile per n-tile at heal's
//   pattern, no product with every data row present; the results come
//   back through out_s with a __syncwarp().
// * A persistent grid of kPipeBlocksPerSM blocks per SM (the residency
//   their __launch_bounds__ hold; kernels.pipelined_grid), each block a
//   contiguous run of tiles of one stripe.  At B = 1, 2 blocks per SM of
//   5 tiles each put 10 tiles on every SM but 8.  Trial builds of K6 with
//   3 to 6 blocks per SM, a 2- or 4-deep ring, or staging from
//   precomputed per-block chunk offsets ran no faster at B = 1.
// * Finalize: the block holding the last ticket applies the length fold
//   (finalize_if_last), after the entry's one memset of digests and
//   ticket.  K4 without a ticket leaves its partials raw in the caller's
//   accumulator (X3's chunks before the last); the last chunk passes a
//   ticket in its own output buffer, zeroed on the stream.
// Columns at or past w load as zeros and are neither stored nor hashed;
// K4 loads rows that are not 16-byte aligned 4 bytes at a time (load4).
// --------------------------------------------------------------------------

// Rebuilt rows of a term program: at most min(k, n - k), so 8 for k <= 8
// and 7 once k > 8 (n <= 16) - which keeps VrTerms<16> inside the 4 KB of
// kernel parameters.
template <int KB>
constexpr int kRbMax = KB <= 4 ? 4 : (KB <= 8 ? 8 : 7);

template <int KB>
struct VrTerms {
  uint32_t m[kRbMax<KB>][8][KB];  // ~0u where bit b of (rebuilt o, survivor j) is set
  uint8_t row[kMaxRows];          // shard row staged in slot j
  int8_t copy[kMaxRows];          // data row slot j is stored to, or -1
  uint8_t rebuilt[kRbMax<KB>];    // data row of rebuilt output o
};

constexpr int kRebuiltMax = 8;  // rebuilt rows of the mxu product: min(k, n - k) <= 8

// The mxu kernels' slots, by value in the kernel parameters: VrTerms
// without the masks.
struct VrSlots {
  uint8_t row[kMaxRows];
  int8_t copy[kMaxRows];
  uint8_t rebuilt[kRebuiltMax];
};

// A K4 / K6 instantiation's term parameter: the slots and, for swar, the
// rebuilt rows' masks over QB survivor words (mxu: QB is the bucket of the
// rebuilt rows, whose product takes its operand from amat).
template <int QB, bool MXU>
using VrParams = std::conditional_t<MXU, VrSlots, VrTerms<QB>>;

// One tile of K4 / K6 at column col = tile * kTile + tid out of the staged
// tile `cur` (slot j: shard row t.row[j]; its chunks at c ^ ring_swizzle(j)
// when kSwizzled): every present slot's word hashed into its registers,
// the present data rows stored from the slot when kSlotCopies (K6), and the
// rb rebuilt rows - swar in Horner form over the survivors' words and the
// masks of `t`, mxu through mxu_ring_tile and out_s.  The caller's barrier
// comes before it.
template <int PB, int QB, bool MXU, bool kSwizzled, bool kSlotCopies>
__device__ __forceinline__ void vr_tile(const uint32_t* cur, const VrParams<QB, MXU>& t,
                                        int np, int k, int rb, bool valid, uint32_t key,
                                        uint32_t* __restrict__ out, int w, int col,
                                        uint32_t (&h1)[PB], uint32_t (&h2)[PB],
                                        uint32_t* out_s, const uint32_t (&af)[MXU ? QB : 1]) {
  const int tid = threadIdx.x;
  constexpr int KB = MXU ? 1 : QB;  // survivor words of the swar product
  uint32_t x[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) x[j] = 0;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    if (j < np) {
      const uint32_t v = cur[j * kTile + (kSwizzled ? tid ^ (ring_swizzle(j) << 2) : tid)];
      if (valid) hash_word(v, key, h1[j], h2[j]);
      if constexpr (!MXU) {
        if (j < KB) x[j] = v;
      }
      if constexpr (kSlotCopies) {
        const int d = t.copy[j];
        if (d >= 0 && valid) out[(size_t)d * w + col] = v;
      }
    }
  }
  if constexpr (MXU) {
    if (rb > 0) {  // uniform: the rebuilt rows
      mxu_ring_tile<QB>(cur, k, rb, out_s, af);
      __syncwarp();
      if (valid) {
#pragma unroll
        for (int o = 0; o < QB; ++o)
          if (o < rb) out[(size_t)t.rebuilt[o] * w + col] = out_s[o * kOutStride + tid];
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < kRbMax<KB>; ++o) {
      if (o >= rb) break;  // uniform
      uint32_t acc = 0;
#pragma unroll
      for (int bit = 7; bit >= 0; --bit) {
        acc = xtime(acc);
#pragma unroll
        for (int j = 0; j < KB; ++j) acc ^= x[j] & t.m[o][bit][j];
      }
      if (valid) out[(size_t)t.rebuilt[o] * w + col] = acc;
    }
  }
}

// The block's partials of its present slots XORed into `partials`, then,
// with a ticket, the last block's finalize.
template <int PB>
__device__ __forceinline__ void vr_fold(const uint32_t (&h1)[PB], const uint32_t (&h2)[PB],
                                        const uint8_t* row, int np, int n, uint32_t* s,
                                        uint32_t* __restrict__ partials,
                                        unsigned int* __restrict__ ticket, uint32_t nbytes) {
#pragma unroll
  for (int j = 0; j < PB; ++j)
    if (j < np) fold_block(h1[j], h2[j], &s[row[j] * 8]);
  __syncthreads();
  for (int i = threadIdx.x; i < n * 8; i += kThreads)
    if (s[i]) atomicXor(&partials[(size_t)blockIdx.y * n * 8 + i], s[i]);
  if (ticket != nullptr)  // uniform
    finalize_if_last(partials, (int)gridDim.y * n * 8, nbytes, ticket);
}

template <int PB, int QB, bool MXU>
__global__ void __launch_bounds__(kThreads, kPipeBlocksPerSM)
verify_reconstruct_pipelined_kernel(const uint32_t* __restrict__ shards,
                                    uint32_t* __restrict__ data,
                                    uint32_t* __restrict__ partials,
                                    unsigned int* __restrict__ ticket, int n,
                                    int k, int w, int np, int rb, int ntiles,
                                    int tiles_per_block, uint32_t nbytes,
                                    const VrParams<QB, MXU> t,
                                    const uint32_t* __restrict__ amat) {
  extern __shared__ __align__(16) uint32_t ring[];  // kStages x np x kTile
  __shared__ uint32_t s[kMaxRows * 8];
  __shared__ uint8_t s_row[kMaxRows];
  __shared__ uint32_t out_s[MXU ? QB * kOutStride : 1];
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  if (tid == 0) {  // constant indices: the parameters stay in the constant bank
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) s_row[j] = t.row[j];
  }
  __syncthreads();
  uint32_t af[MXU ? QB : 1];
  if constexpr (MXU) load_frags<QB>(amat, af);

  const uint32_t* in = shards + (size_t)blockIdx.y * n * w;
  uint32_t* out = data + (size_t)blockIdx.y * k * w;
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1
  const int slot_words = np * kTile;

#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < count) stage_tile<MXU>(ring + st * slot_words, in, s_row, np, w, first + st);
    cp_async_commit();
  }

  uint32_t h1[PB], h2[PB];  // per ring slot
#pragma unroll
  for (int j = 0; j < PB; ++j) h1[j] = h2[j] = 0;

#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    // tile i + 2's copies go out before tile i is waited for (a same-call
    // A/B on an H100 against K5's one barrier a tile, staging after the
    // wait, ran as fast or up to 2.5 % faster this way, PERF.md), so the
    // slot they fill, read in tile i - 1, is freed by a second barrier
    const int next = i + kStages - 1;
    if (next < count)
      stage_tile<MXU>(ring + (next % kStages) * slot_words, in, s_row, np, w, first + next);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile i landed
    __syncthreads();  // ... and every other thread's
    const int col = (first + i) * kTile + tid;
    vr_tile<PB, QB, MXU, MXU, true>(ring + (i % kStages) * slot_words, t, np, k, rb,
                                    col < w, hash_key((uint32_t)col), out, w, col, h1, h2,
                                    out_s, af);
    __syncthreads();  // the slot is refilled by iteration i + 1
  }
  vr_fold<PB>(h1, h2, s_row, np, n, s, partials, ticket, nbytes);
}

// K4 (and X3 with a word offset): the staging of K1 [mxu] over the np
// present rows, their copies stored from the staging registers, then
// vr_tile on the swizzled tile.  Without a ticket the partials stay raw.
template <int PB, int QB, bool MXU>
__global__ void __launch_bounds__(kThreads, kPipeBlocksPerSM)
verify_reconstruct_kernel(const uint32_t* __restrict__ shards, uint32_t* __restrict__ data,
                          uint32_t* __restrict__ partials, unsigned int* __restrict__ ticket,
                          int n, int k, int w, int np, int rb, int ntiles,
                          int tiles_per_block, uint32_t word_offset, uint32_t nbytes,
                          bool aligned, const VrParams<QB, MXU> t,
                          const uint32_t* __restrict__ amat) {
  extern __shared__ __align__(16) uint32_t tiles[];  // 2 x np x kTile, swizzled
  __shared__ uint32_t s[kMaxRows * 8];
  __shared__ uint32_t out_s[MXU ? QB * kOutStride : 1];
  __shared__ uint8_t s_row[kMaxRows];  // the slots a thread indexes by its own j
  __shared__ int8_t s_copy[kMaxRows];
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 8; i += kThreads) s[i] = 0;
  if (tid == 0) {  // constant indices: the parameters stay in the constant bank
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      s_row[j] = t.row[j];
      s_copy[j] = t.copy[j];
    }
  }
  __syncthreads();
  uint32_t af[MXU ? QB : 1];
  if constexpr (MXU) load_frags<QB>(amat, af);

  const uint32_t* in = shards + (size_t)blockIdx.y * n * w;
  uint32_t* out = data + (size_t)blockIdx.y * k * w;
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);  // >= 1
  const int slot_words = np * kTile;
  const auto row_of = [&](int j) { return in + (size_t)s_row[j] * w; };
  const int j0 = tid / kChunksPerRow;

  uint32_t h1[PB], h2[PB];  // per slot
#pragma unroll
  for (int j = 0; j < PB; ++j) h1[j] = h2[j] = 0;

  uint4 x[PB / 4];  // the next tile's chunks, in flight
  load_chunks<PB>(row_of, np, w, first, aligned, x);
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    uint32_t* cur = tiles + (i & 1) * slot_words;
    store_chunks<PB>(cur, np, x);
    // the present data rows: copies, straight from the staged chunks
    const int c0 = (first + i) * kTile + 4 * (tid % kChunksPerRow);
    if (c0 < w) {
#pragma unroll
      for (int q = 0; q < PB / 4; ++q) {
        const int j = j0 + 4 * q;
        const int d = j < np ? s_copy[j] : -1;
        if (d >= 0) *reinterpret_cast<uint4*>(out + (size_t)d * w + c0) = x[q];
      }
    }
    if (i + 1 < count) load_chunks<PB>(row_of, np, w, first + i + 1, aligned, x);
    __syncthreads();  // tile i staged; tile i - 1's buffer and out_s are free
    const int col = (first + i) * kTile + tid;
    vr_tile<PB, QB, MXU, true, false>(cur, t, np, k, rb, col < w,
                                      hash_key((uint32_t)col + word_offset), out, w, col,
                                      h1, h2, out_s, af);
  }
  vr_fold<PB>(h1, h2, s_row, np, n, s, partials, ticket, nbytes);
}

// --------------------------------------------------------------------------
// K7 gf_matmul_mxu: replaces rs_pallas.gf_matmul_mxu (P3): a runtime (o, s)
// GF(2^8) matrix over (s, length) bytes on the 1-bit tensor cores.  P3
// pads the rows to 8,192-byte tiles; here the ragged end is masked.
//
// Bound: bytes (s rows read once, o rows written once: 15.7 MB for EC
// 8+4's parity over a 10 MiB block's shards, 4.7 us); the product's bit
// pairs on the tensor cores take less.  The design's own integer work -
// the MMA operands out of bytes and the counts' low bits back into bytes
// - is kept below the bytes' time (chip_smoke.k7_design_ops):
// * The product transposed.  The data are the MMA's A operand: an m-tile
//   is 16 byte columns, and lane (g, tig) = (lane / 4, lane % 4) supplies
//   byte columns mu and mu + 8 of its 16-byte chunk g, K bits 32 tig ..
//   32 tig + 31 being input rows tig + 4i (byte i) and their 8 bits.  The
//   lifted matrix is the B operand (kernels.k7_fragments, in registers
//   for the whole run): n-tile j's column n is bit 2 (j % 4) + n % 2 of
//   output row n / 2 + 4 (j / 4).  So lane (g, tig) gets back the counts
//   of its own chunk's byte columns mu, mu + 8 for output rows tig + 4u,
//   two bits an n-tile, and after 8 m-tiles x OB n-tiles it holds every
//   bit of 16 bytes of each of its output rows: no shuffle and no shared
//   memory on the way out.  One funnel shift a count moves its low bit
//   into place (the counts come in output bit order), and each row goes
//   out as one 16-byte store.
// * A operands: one byte permute a word (two with 16 input rows), where
//   mxu_ring_tile's B words take three.
// * A persistent grid: k7_min_blocks(SB, OB) blocks per SM (2; 1 where
//   the registers would not fit 2 without spilling), each walking a
//   contiguous run of kMxTile-byte tiles (kernels.k7_grid; a block past
//   the last tile returns).
// * Bulk copies into a kMxStages-deep ring, issued by a producer warp:
//   its lane 0 issues the s row copies of a tile (cp.async.bulk, counted
//   in bytes by the stage's full mbarrier), the first kMxStages at once,
//   and refills a stage when the 8 compute warps have arrived on its
//   empty mbarrier.  A compute warp waits on the full barrier, loads its
//   operands, arrives, and multiplies and stores while later tiles land.
//   The copy engine paces the copies (about one 1 KiB copy per 90 cycles
//   on an H100): issued by a compute warp's thread 0, they held its
//   block about 2,900 cycles before its first tile.  Rows lie
//   kMxRowStride bytes apart in a slot (32 bytes of padding: the copy
//   cannot swizzle), so the 16-byte loads of rows tig + 4i by a quarter
//   warp (tig = 0..3, two chunks) meet 8 different quads of banks.
// * The bulk copy takes 16-byte aligned addresses and sizes.  When the
//   input or output rows are not (a base off alignment, length % 16 !=
//   0), the threads stage each tile byte by byte into the same slot
//   layout between two barriers, and the stores go out byte by byte; the
//   ragged last tile of an aligned run is a shorter copy.  Nothing past
//   `length` is stored.
// --------------------------------------------------------------------------

constexpr int kMxTile = 1024;                 // bytes of each row a tile
constexpr int kMxRowStride = kMxTile + 32;    // a slot's rows, padded
constexpr int kMxStages = 4;                  // ring depth: 4 tiles in flight
constexpr int kMxThreads = kThreads + 32;     // 8 compute warps and the producer

// Blocks per SM a K7 instantiation is compiled for (kernels.k7_grid).
constexpr int k7_min_blocks(int sb, int ob) { return ob <= 8 && sb + ob <= 20 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the mbarrier counts them in.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bulk_copy with an L2 cache policy (createpolicy) for the lines it reads.
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Thread 0: the s row copies of tile `tile` into `slot`, counted by `bar`.
__device__ __forceinline__ void k7_issue(uint8_t* slot, const uint8_t* in, int s,
                                         int length, int tile, uint64_t* bar) {
  const int col = tile * kMxTile;
  const unsigned bytes = (unsigned)min(kMxTile, length - col);
  mbar_expect_tx(bar, bytes * (unsigned)s);
  for (int r = 0; r < s; ++r)
    bulk_copy(slot + r * kMxRowStride, in + (size_t)r * length + col, bytes, bar);
}

// The threads' staging of tile `tile` into `slot`, zeros past length.
__device__ __forceinline__ void k7_stage(uint8_t* slot, const uint8_t* in, int s,
                                         int length, int tile) {
  constexpr int kWords = kMxTile / 4;
  for (int i = threadIdx.x; i < s * kWords; i += kThreads) {
    const int r = i / kWords, w = i % kWords;
    const long long col = (long long)tile * kMxTile + 4 * w;
    const uint8_t* src = in + (size_t)r * length;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (col + b < length) v |= (uint32_t)src[col + b] << (8 * b);
    *reinterpret_cast<uint32_t*>(slot + r * kMxRowStride + 4 * w) = v;
  }
}

// This lane's A words of one tile: a[p] holds byte column p of its chunk,
// byte i from input row tig + 4i.  Rows at or past s read as zeros; the
// bytes past SB / 4 carry whatever the permute leaves, since their B bits
// (input rows past s) are zero.
template <int SB>
__device__ __forceinline__ void k7_operands(const uint8_t* slot, int s,
                                            uint32_t (&a)[16]) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int chunk = (threadIdx.x >> 5) * 8 + (lane >> 2);
  uint4 x[SB / 4];
#pragma unroll
  for (int i = 0; i < SB / 4; ++i) {
    const int r = tig + 4 * i;
    x[i] = r < s ? *reinterpret_cast<const uint4*>(slot + r * kMxRowStride + 16 * chunk)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w0 = word_of(x[0], q);
    if constexpr (SB == 4) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[4 * q + r] = w0 >> (8 * r);
    } else if constexpr (SB == 8) {
      const uint32_t w1 = word_of(x[1], q);
#pragma unroll
      for (int r = 0; r < 4; ++r) a[4 * q + r] = __byte_perm(w0, w1, r | ((4 + r) << 4));
    } else {  // a 4 x 4 byte transpose of the four rows' words
      const uint32_t w1 = word_of(x[1], q), w2 = word_of(x[2], q), w3 = word_of(x[3], q);
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
      const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
      a[4 * q] = __byte_perm(lo01, lo23, 0x5410);
      a[4 * q + 1] = __byte_perm(lo01, lo23, 0x7632);
      a[4 * q + 2] = __byte_perm(hi01, hi23, 0x5410);
      a[4 * q + 3] = __byte_perm(hi01, hi23, 0x7632);
    }
  }
}

// The product of one tile for this lane: acc[u] = the 16 output bytes of
// row tig + 4u at its chunk, as 4 words.  Each word takes exactly 32
// funnel shifts, so what it held before does not matter.
template <int OB>
__device__ __forceinline__ void k7_product(const uint32_t (&a)[16], const uint32_t (&bf)[OB],
                                           uint32_t (&acc)[OB / 4][4]) {
#pragma unroll
  for (int mu = 0; mu < 8; ++mu) {
#pragma unroll
    for (int u = 0; u < OB / 4; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t d0, d1, d2, d3;
        mma_b1(a[mu], a[mu + 8], bf[4 * u + j], d0, d1, d2, d3);
        // bits 2j, 2j + 1 of byte mu (d0, d1) and of byte mu + 8 (d2, d3)
        uint32_t& lo = acc[u][mu >> 2];
        uint32_t& hi = acc[u][2 + (mu >> 2)];
        lo = __funnelshift_r(lo, d0, 1);
        lo = __funnelshift_r(lo, d1, 1);
        hi = __funnelshift_r(hi, d2, 1);
        hi = __funnelshift_r(hi, d3, 1);
      }
    }
  }
}

// Store this lane's output rows at its chunk of tile `tile`: one 16-byte
// store a row when `vec` (aligned rows, the chunk inside length), else
// the bytes inside length.
template <int OB>
__device__ __forceinline__ void k7_store(const uint32_t (&acc)[OB / 4][4], uint8_t* out,
                                         int o, int length, int tile, bool vec) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const long long col = (long long)tile * kMxTile + 16 * ((threadIdx.x >> 5) * 8 + (lane >> 2));
  if (col >= length) return;
#pragma unroll
  for (int u = 0; u < OB / 4; ++u) {
    const int row = tig + 4 * u;
    if (row >= o) break;
    uint8_t* dst = out + (size_t)row * length + col;
    if (vec && col + 16 <= length) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b < length) dst[b] = (uint8_t)(acc[u][b >> 2] >> (8 * (b & 3)));
    }
  }
}

// (o, s) @ (s, length) bytes -> (o, length), SB = bucket(s), OB =
// bucket(o); `frags` is kernels.k7_fragments (16 n-tiles x 32 lanes).
// Launched with kMxThreads threads when `bulk`, kThreads (no producer)
// otherwise.  With `stamps`, thread 0 writes its block's clock64 cycles
// before its first tile, waiting for input, in the product and in the
// stores, its %globaltimer at start and end and its SM (7 values a
// block; chip_smoke.k7_phases reads them).
template <int SB, int OB>
__global__ void __launch_bounds__(kMxThreads, k7_min_blocks(SB, OB))
gf_matmul_mxu_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     const uint32_t* __restrict__ frags, long long* __restrict__ stamps,
                     int o, int s, int length, int ntiles, int tiles_per_block,
                     bool bulk) {
  extern __shared__ __align__(128) uint8_t k7_ring[];  // kMxStages x s x kMxRowStride
  __shared__ __align__(8) uint64_t full[kMxStages], empty[kMxStages];
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, ntiles - first);
  if (count <= 0) return;  // uniform: past the last tile
  const int tid = threadIdx.x, lane = tid & 31;
  const bool timed = stamps != nullptr;
  long long t_setup = 0, t_load = 0, t_prod = 0, t_store = 0, g0 = 0, c0 = 0, cs = 0;
  if (timed) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    cs = clock64();
  }
  uint32_t bf[OB];
#pragma unroll
  for (int j = 0; j < OB; ++j) bf[j] = __ldg(frags + j * 32 + lane);
  const int slot_bytes = s * kMxRowStride;
  uint32_t acc[OB / 4][4] = {};
  uint32_t a[16];

  if (bulk) {
    if (tid == 0) {
      for (int st = 0; st < kMxStages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialized
    if ((tid >> 5) == kWarps) {  // the producer warp
      if (lane == 0) {
        for (int st = 0; st < kMxStages && st < count; ++st)
          k7_issue(k7_ring + st * slot_bytes, in, s, length, first + st, &full[st]);
        for (int i = 0; i + kMxStages < count; ++i) {
          const int st = i % kMxStages;
          mbar_wait(&empty[st], (unsigned)(i / kMxStages) & 1u);  // tile i was read
          k7_issue(k7_ring + st * slot_bytes, in, s, length, first + i + kMxStages,
                   &full[st]);
        }
      }
      return;
    }
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      const int st = i % kMxStages;
      const unsigned parity = (unsigned)(i / kMxStages) & 1u;
      uint8_t* slot = k7_ring + st * slot_bytes;
      if (timed) {
        c0 = clock64();
        if (i == 0) t_setup = c0 - cs;
      }
      mbar_wait(&full[st], parity);  // tile i landed
      long long c1 = 0;
      if (timed) c1 = clock64();
      k7_operands<SB>(slot, s, a);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the slot
      k7_product<OB>(a, bf, acc);
      long long c2 = 0;
      if (timed) c2 = clock64();
      k7_store<OB>(acc, out, o, length, first + i, true);
      if (timed) {
        t_load += c1 - c0;
        t_prod += c2 - c1;
        t_store += clock64() - c2;
      }
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      if (timed) {
        c0 = clock64();
        if (i == 0) t_setup = c0 - cs;
      }
      __syncthreads();  // the previous tile's reads are done
      k7_stage(k7_ring, in, s, length, first + i);
      __syncthreads();
      long long c1 = 0;
      if (timed) c1 = clock64();
      k7_operands<SB>(k7_ring, s, a);
      k7_product<OB>(a, bf, acc);
      long long c2 = 0;
      if (timed) c2 = clock64();
      k7_store<OB>(acc, out, o, length, first + i, false);
      if (timed) {
        const long long c3 = clock64();
        t_load += c1 - c0;
        t_prod += c2 - c1;
        t_store += c3 - c2;
      }
    }
  }
  if (timed && tid == 0) {
    long long g1;
    unsigned smid;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* st = stamps + (size_t)blockIdx.x * 7;
    st[0] = t_setup;
    st[1] = t_load;
    st[2] = t_prod;
    st[3] = t_store;
    st[4] = g0;
    st[5] = g1;
    st[6] = smid;
  }
}

// --------------------------------------------------------------------------
// K13 pack_nonzero_groups: replaces codec_step.pack_nonzero_groups (X9,
// left to XLA): the flags of K12 and each row's nonzero groups moved to
// the front in order, zeros behind them - the reference's full-row
// `packed`, every slot written once.
//
// Bound: bytes - the plane read once, the packed plane and the flags
// written once.  A slot depends on every earlier group of its row, which
// a grid of independent blocks could only learn from a second launch
// (the parent design: K12, then pack_kernel, reading the plane twice).
// Design, one launch that reads the plane once:
// * A thread-block cluster covers a row (kernels.pack_plan: 8 blocks, or
//   16 - a non-portable size - where 8 a row would leave most SMs idle,
//   as at heal's 4 rows).  Block `rank` takes segment [rank * seg,
//   (rank + 1) * seg) of each pass's span of cluster * seg groups.  The
//   plan takes the fewest passes whose clusters the card holds all at
//   once (mtt_pack_clusters): an H100 holds 15 clusters of 8 blocks of
//   160 KiB, so the main path's 16 rows take two passes of 80 KiB
//   segments rather than a second wave of clusters.
// * Thread 0 stages the block's segment in shared memory with
//   cp.async.bulk, kPackChunk groups a copy, each copy counted in by its
//   own mbarrier, so the warps flag the first groups (one warp a group,
//   two 16-byte shared loads a lane and __any_sync) while the later ones
//   land.  The copies and the stores below are evict-first in L2 (the
//   plane is read once, the packed prefix is read once by the D2H copy),
//   as K12's loads.  An unaligned plane is staged by the threads, 4
//   bytes each.
// * The flags leave as one coalesced store; a ballot a warp gives each
//   group its place among the block's nonzero groups, and the block's
//   count is posted in shared memory.
// * One cluster barrier, then each warp reads the cluster's counts
//   through distributed shared memory: its block's prefix and the pass's
//   total.  The nonzero groups go from shared memory to their slots with
//   16-byte stores; they are consecutive slots, so the stores of a block
//   are one contiguous run.
// * A row longer than a cluster's shared memory is walked in passes of
//   cluster * seg groups with a running prefix (the counts double-buffered
//   by pass, so one cluster barrier a pass suffices).  After the last
//   pass each block zeroes its share of the row's tail, slots kept .. g,
//   and a last cluster barrier keeps every block's counts alive until the
//   others have read them.
constexpr int kPackSegMax = 192;  // groups a block stages a pass (192 KiB)
constexpr int kPackChunk = 16;    // groups a bulk copy (one mbarrier each)
constexpr int kPackChunks = kPackSegMax / kPackChunk;
constexpr int kPackClusterMax = 16;

__device__ __forceinline__ unsigned cluster_reg(int which) {
  unsigned v;
  if (which == 0)
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  else if (which == 1)
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  else
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The word at `p` in the shared memory of cluster block `rank`.
__device__ __forceinline__ int dsmem_load(const int* p, unsigned rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
pack_groups_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ flags,
                   uint32_t* __restrict__ packed, int w, int seg) {
  extern __shared__ __align__(128) uint32_t stage[];  // seg x kTile words
  __shared__ uint64_t full[kPackChunks];
  __shared__ uint32_t s_flag[kPackSegMax];
  __shared__ int s_src[kPackSegMax];
  __shared__ int s_wsum[kThreads / 32];
  __shared__ int s_count[2];
  const unsigned rank = cluster_reg(0), csize = cluster_reg(1);
  const size_t row = cluster_reg(2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = w / kTile;
  const uint32_t* src = words + row * (size_t)w;
  uint32_t* dst = packed + row * (size_t)w;
  uint32_t* frow = flags + row * (size_t)g;
  const int span = (int)csize * seg;
  const int passes = (g + span - 1) / span;
  uint64_t policy = 0;
  if (kBulk) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    if (tid == 0) {
      for (int i = 0; i < kPackChunks; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialized
  }
  unsigned phase = 0u;  // bit c: the parity chunk c's barrier waits for
  int run = 0;          // nonzero groups of the row before this pass
  for (int p = 0; p < passes; ++p) {
    const int start = p * span + (int)rank * seg;
    const int n = max(0, min(seg, g - start));  // this block's groups
    const int nchunks = (n + kPackChunk - 1) / kPackChunk;
    if (kBulk) {
      if (tid == 0) {
        // the previous pass's shared reads are ordered before the copies
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int c = 0; c < nchunks; ++c) {
          const unsigned bytes =
              (unsigned)(min(kPackChunk, n - c * kPackChunk) * kTile * 4);
          mbar_expect_tx(&full[c], bytes);
          bulk_copy_hint(stage + c * kPackChunk * kTile,
                         src + (size_t)(start + c * kPackChunk) * kTile, bytes, &full[c],
                         policy);
        }
      }
    } else {
      const uint32_t* from = src + (size_t)start * kTile;
      for (int i = tid; i < n * kTile; i += kThreads) stage[i] = from[i];
      __syncthreads();
    }
    for (int j = warp; j < n; j += kThreads / 32) {
      if (kBulk) mbar_wait(&full[j / kPackChunk], (phase >> (j / kPackChunk)) & 1u);
      const uint4* gq = reinterpret_cast<const uint4*>(stage + j * kTile);
      const uint4 a = gq[lane], b = gq[32 + lane];
      const bool any =
          __any_sync(0xffffffffu, (a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) != 0u);
      if (lane == 0) s_flag[j] = any ? 1u : 0u;
    }
    phase ^= (1u << nchunks) - 1u;
    __syncthreads();
    const int f = tid < n ? (int)s_flag[tid] : 0;  // seg <= kThreads
    const unsigned vote = __ballot_sync(0xffffffffu, f != 0);
    if (lane == 0) s_wsum[warp] = __popc(vote);
    if (tid < n) frow[start + tid] = (uint32_t)f;
    __syncthreads();
    int pre = __popc(vote & ((1u << lane) - 1u)), cnt = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      pre += i < warp ? s_wsum[i] : 0;
      cnt += s_wsum[i];
    }
    if (f) s_src[pre] = tid;
    if (tid == 0) s_count[p & 1] = cnt;
    cluster_arrive();  // every block of the row has posted its count
    cluster_wait();
    const int v = lane < (int)csize ? dsmem_load(&s_count[p & 1], (unsigned)lane) : 0;
    const int before = __reduce_add_sync(0xffffffffu, lane < (int)rank ? v : 0);
    const int total = __reduce_add_sync(0xffffffffu, v);
    if (p == passes - 1) cluster_arrive();  // done with the others' counts
    uint4* out = reinterpret_cast<uint4*>(dst + (size_t)(run + before) * kTile);
    for (int i = tid; i < cnt * (kTile / 4); i += kThreads)
      __stcs(out + i, reinterpret_cast<const uint4*>(stage + s_src[i / (kTile / 4)] * kTile)
                          [i % (kTile / 4)]);
    run += total;
    __syncthreads();  // stage and s_src are free for the next pass
  }
  // the zero tail, slots run .. g, in csize shares
  const int share = (g - run + (int)csize - 1) / (int)csize;
  const int z0 = min(g, run + (int)rank * share), z1 = min(g, z0 + share);
  uint4* zq = reinterpret_cast<uint4*>(dst);
  for (size_t i = (size_t)z0 * (kTile / 4) + tid; i < (size_t)z1 * (kTile / 4); i += kThreads)
    __stcs(zq + i, make_uint4(0u, 0u, 0u, 0u));
  cluster_wait();
}

constexpr int bucket(int v) { return v <= 4 ? 4 : (v <= 8 ? 8 : 16); }

// Dynamic shared memory of a pipelined launch; above the default 48 KiB
// window only after the per-kernel opt-in.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The one-time opt-in of a kernel instantiation to `smem` bytes of
// dynamic shared memory (the most any of its launches takes), per device:
// cudaFuncSetAttribute is not called again for launches after the first.
template <auto Kernel>
cudaError_t smem_opt_in(int device, size_t smem) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  const cudaError_t err = prepare_smem(Kernel, smem);
  if (err == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// K1 swar or [mxu] (amat != nullptr); FK, FM > 0 compile the fixed
// geometry's k and m in (and its product, for swar).
template <int KB, int MB, int FK = 0, int FM = 0>
cudaError_t launch_encode(int device, dim3 grid, cudaStream_t st, const uint32_t* data,
                          uint32_t* parity, uint32_t* partials, unsigned int* ticket,
                          uint32_t* flags, int k, int m, int w, uint32_t word_offset,
                          uint32_t nbytes, int ntiles, int tpb, bool aligned,
                          const GfTerms& terms, const uint32_t* amat) {
  if (amat) {
    constexpr size_t kMaxSmem = (size_t)2 * KB * kTile * sizeof(uint32_t);
    const cudaError_t err = smem_opt_in<encode_mxu_kernel<KB, MB, FK, FM>>(device, kMaxSmem);
    if (err != cudaSuccess) return err;
    encode_mxu_kernel<KB, MB, FK, FM>
        <<<grid, kThreads, (size_t)2 * k * kTile * sizeof(uint32_t), st>>>(
            data, parity, partials, ticket, flags, k, m, w, word_offset, nbytes, ntiles,
            tpb, aligned, amat);
  } else {
    encode_kernel<KB, MB, FK, FM><<<grid, kThreads, 0, st>>>(
        data, parity, partials, ticket, flags, k, m, w, word_offset, nbytes, ntiles,
        tpb, terms);
  }
  return cudaGetLastError();
}

// K5 swar or [mxu] (amat != nullptr); FK, FM > 0 compile the fixed
// geometry's k and m in (and its product, for swar).
template <int KB, int MB, int FK = 0, int FM = 0>
cudaError_t launch_encode_pipelined(int device, dim3 grid, size_t smem, cudaStream_t st,
                                    const uint32_t* data, uint32_t* parity,
                                    uint32_t* partials, unsigned int* ticket,
                                    uint32_t* flags, int k, int m, int w, int ntiles,
                                    int tpb, uint32_t nbytes, const GfTerms& terms,
                                    const uint32_t* amat) {
  constexpr size_t kMaxSmem = (size_t)kStages * KB * kTile * sizeof(uint32_t);
  cudaError_t err;
  if (amat) {
    err = smem_opt_in<encode_pipelined_mxu_kernel<KB, MB, FK, FM>>(device, kMaxSmem);
    if (err != cudaSuccess) return err;
    encode_pipelined_mxu_kernel<KB, MB, FK, FM><<<grid, kThreads, smem, st>>>(
        data, parity, partials, ticket, flags, k, m, w, ntiles, tpb, nbytes, amat);
  } else {
    err = smem_opt_in<encode_pipelined_kernel<KB, MB, FK, FM>>(device, kMaxSmem);
    if (err != cudaSuccess) return err;
    encode_pipelined_kernel<KB, MB, FK, FM><<<grid, kThreads, smem, st>>>(
        data, parity, partials, ticket, flags, k, m, w, ntiles, tpb, nbytes, terms);
  }
  return cudaGetLastError();
}

// The term program as kernels.vr_terms packs it: m, row, copy, rebuilt,
// back to back, terms_bytes<KB>() in all (the entries refuse another size).
template <int KB>
constexpr size_t terms_bytes() {
  return sizeof(VrTerms<KB>::m) + sizeof(VrTerms<KB>::row) +
         sizeof(VrTerms<KB>::copy) + sizeof(VrTerms<KB>::rebuilt);
}

template <int KB>
VrTerms<KB> make_terms(const uint8_t* blob) {
  VrTerms<KB> t;
  memcpy(t.m, blob, sizeof t.m);
  blob += sizeof t.m;
  memcpy(t.row, blob, sizeof t.row);
  memcpy(t.copy, blob + sizeof t.row, sizeof t.copy);
  memcpy(t.rebuilt, blob + sizeof t.row + sizeof t.copy, sizeof t.rebuilt);
  return t;
}

// The slots of a term program for bucket(k) == kb, without its masks.
VrSlots make_slots(const uint8_t* blob, int kb) {
  const size_t masks = kb == 4 ? sizeof(VrTerms<4>::m)
                       : kb == 8 ? sizeof(VrTerms<8>::m) : sizeof(VrTerms<16>::m);
  const int rb_max = kb == 4 ? kRbMax<4> : kb == 8 ? kRbMax<8> : kRbMax<16>;
  VrSlots sl{};
  blob += masks;
  memcpy(sl.row, blob, sizeof sl.row);
  memcpy(sl.copy, blob + sizeof sl.row, sizeof sl.copy);
  memcpy(sl.rebuilt, blob + sizeof sl.row + sizeof sl.copy, rb_max);
  return sl;
}

// A term program's slots must be the np present rows in order with copies
// and rebuilt rows inside the k data rows: the kernels index by them.
bool slots_valid(const VrSlots& sl, int n, int k, int np, int rb, uint32_t present) {
  for (int j = 0; j < np; ++j)
    if (sl.row[j] >= n || !((present >> sl.row[j]) & 1u) || sl.copy[j] >= k ||
        (j > 0 && sl.row[j] <= sl.row[j - 1]))
      return false;
  for (int o = 0; o < rb; ++o)
    if (sl.rebuilt[o] >= k) return false;
  return true;
}

template <int PB, int QB, bool MXU>
cudaError_t launch_vr(int device, dim3 grid, size_t smem, cudaStream_t st,
                      const uint32_t* shards, uint32_t* data, uint32_t* acc,
                      unsigned int* ticket, int n, int k, int w, int np, int rb, int ntiles,
                      int tpb, uint32_t word_offset, uint32_t nbytes, bool aligned,
                      const VrParams<QB, MXU>& t, const uint32_t* amat) {
  constexpr size_t kMaxSmem = (size_t)2 * PB * kTile * sizeof(uint32_t);
  const cudaError_t err =
      smem_opt_in<verify_reconstruct_kernel<PB, QB, MXU>>(device, kMaxSmem);
  if (err != cudaSuccess) return err;
  verify_reconstruct_kernel<PB, QB, MXU><<<grid, kThreads, smem, st>>>(
      shards, data, acc, ticket, n, k, w, np, rb, ntiles, tpb, word_offset, nbytes, aligned,
      t, amat);
  return cudaGetLastError();
}

template <int PB, int QB, bool MXU>
cudaError_t launch_vr_pipelined(int device, dim3 grid, size_t smem, cudaStream_t st,
                                const uint32_t* shards, uint32_t* data,
                                uint32_t* partials, unsigned int* ticket, int n,
                                int k, int w, int np, int rb, int ntiles, int tpb,
                                uint32_t nbytes, const VrParams<QB, MXU>& t,
                                const uint32_t* amat) {
  constexpr size_t kMaxSmem = (size_t)kStages * PB * kTile * sizeof(uint32_t);
  const cudaError_t err =
      smem_opt_in<verify_reconstruct_pipelined_kernel<PB, QB, MXU>>(device, kMaxSmem);
  if (err != cudaSuccess) return err;
  verify_reconstruct_pipelined_kernel<PB, QB, MXU><<<grid, kThreads, smem, st>>>(
      shards, data, partials, ticket, n, k, w, np, rb, ntiles, tpb, nbytes, t, amat);
  return cudaGetLastError();
}

// K7 at buckets SB = bucket(s), OB = bucket(o).
template <int SB, int OB>
cudaError_t launch_gf_mxu(int device, int blocks, size_t smem, cudaStream_t st,
                          const uint8_t* in, uint8_t* out, const uint32_t* frags,
                          long long* stamps, int o, int s, int length, int ntiles,
                          int tpb, bool bulk) {
  constexpr size_t kMaxSmem = (size_t)kMxStages * SB * kMxRowStride;
  const cudaError_t err = smem_opt_in<gf_matmul_mxu_kernel<SB, OB>>(device, kMaxSmem);
  if (err != cudaSuccess) return err;
  gf_matmul_mxu_kernel<SB, OB><<<blocks, bulk ? kMxThreads : kThreads, smem, st>>>(
      in, out, frags, stamps, o, s, length, ntiles, tpb, bulk);
  return cudaGetLastError();
}

// The one-time opt-ins of a K13 instantiation per device: kPackSegMax
// groups of dynamic shared memory, and clusters past the portable 8.
template <bool kBulk>
cudaError_t pack_opt_in(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  cudaError_t err =
      prepare_smem(pack_groups_kernel<kBulk>, (size_t)kPackSegMax * kTile * sizeof(uint32_t));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pack_groups_kernel<kBulk>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The launch of K13 over `rows` clusters of `cluster` blocks, `seg` groups
// of each block's dynamic shared memory.
template <bool kBulk>
cudaError_t launch_pack(int device, const uint32_t* words, uint32_t* flags, uint32_t* packed,
                        long long rows, int w, int cluster, int seg, cudaStream_t st) {
  cudaError_t err = pack_opt_in<kBulk>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)seg * kTile * sizeof(uint32_t);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pack_groups_kernel<kBulk>, words, flags, packed, w, seg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Each export carries an "@ctypes" comment line, its ctypes signature: the
// signature ops/kernels.py (_load) binds.  `python -m
// minio_tpu_torch.analysis` holds both the binding and the comment
// against the ctypes this definition's C types map to (MTPU401-403).

// The arguments of one K1 launch, packed by kernels.py (_ENCODE_ARGS: 9
// addresses, 9 ints, 2 u32, 4 bytes of padding) and passed as one
// pointer: ctypes converts one argument instead of twenty.
struct EncodeArgs {
  uint64_t data, parity, acc, ticket, flags, packed, terms, amat, stream;
  int32_t device, B, k, m, w, group, zero_acc, tiles_per_block, terms_len;
  uint32_t nbytes, word_offset;
};
static_assert(sizeof(EncodeArgs) == 120, "kernels._ENCODE_ARGS packs 120 bytes");

// words (B, k, w) -> parity (B, m, w), the phash256 partials of all k+m
// rows XORed into `acc` (B, k+m, 8) with the hash key of column c taken
// at c + word_offset, and with group == 256: flags (B, m, w/256) 0/1 and
// packed (B, m, w).  zero_acc != 0 zeroes `acc` first (else the partials
// accumulate onto it, as a sub-chunk chain does).  A non-null `ticket`
// (zeroed here) makes the last block finalize the partials in place: the
// digests; with a null one they stay raw.  The whole-row call passes
// ticket == acc + B*(k+m)*8, so one memset zeroes both.  `terms` is the
// parity matrix's term program (kernels.parity_terms, gf_terms_bytes()
// long); the fixed geometry ignores it.  A non-null `amat` (the m x k
// parity matrix in kernels.mxu_fragments order) selects the mxu kernel,
// whose grid is kernels.pipelined_grid's.  Returns the first non-zero
// CUDA error.
// @ctypes mtt_encode_pack(c_char_p) -> c_int
int mtt_encode_pack(const EncodeArgs* a) {
  const uint32_t* data = reinterpret_cast<const uint32_t*>(a->data);
  uint32_t* parity = reinterpret_cast<uint32_t*>(a->parity);
  uint32_t* acc = reinterpret_cast<uint32_t*>(a->acc);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(a->ticket);
  uint32_t* flags = reinterpret_cast<uint32_t*>(a->flags);
  uint32_t* packed = reinterpret_cast<uint32_t*>(a->packed);
  const uint32_t* amat = reinterpret_cast<const uint32_t*>(a->amat);
  const int device = a->device, B = a->B, k = a->k, m = a->m, w = a->w,
            group = a->group, zero_acc = a->zero_acc,
            tiles_per_block = a->tiles_per_block;
  const uint32_t nbytes = a->nbytes, word_offset = a->word_offset;
  void* stream = reinterpret_cast<void*>(a->stream);
  if (k < 1 || k > kMaxRows || m < 0 || m > kMaxRows || w <= 0 ||
      tiles_per_block < 1 || B <= 0 || B > 65535 || word_offset % 4 != 0 ||
      (size_t)a->terms_len != gf_terms_bytes() ||
      (group != 0 && (group != kTile || w % kTile != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t count = (size_t)B * (k + m) * 8;
  const bool joint = ticket == reinterpret_cast<unsigned int*>(acc + count);
  if (zero_acc)
    err = cudaMemsetAsync(acc, 0, (count + (joint ? 1 : 0)) * sizeof(uint32_t), st);
  if (err == cudaSuccess && ticket != nullptr && !(zero_acc && joint))
    err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const GfTerms t = make_gf_terms(reinterpret_cast<const uint8_t*>(a->terms), m);
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, B);
  uint32_t* fl = group ? flags : nullptr;
  // the mxu kernel's 16-byte staging loads (4-byte ones otherwise)
  const bool aligned = (a->data & 15u) == 0 && w % 4 == 0;
  const int kb = bucket(k), mb = bucket(m);
  bool fixed = false;
  err = cudaErrorInvalidValue;
#define MTT_FIXED_ENC(K_, M_)                                                    \
  if (k == K_ && m == M_) {                                                      \
    err = launch_encode<bucket(K_), bucket(M_), K_, M_>(                         \
        device, grid, st, data, parity, acc, ticket, fl, k, m, w, word_offset,   \
        nbytes, ntiles, tiles_per_block, aligned, t, amat);                      \
    fixed = true;                                                                \
  }
  MTT_FIXED_GEOMETRIES(MTT_FIXED_ENC)
#undef MTT_FIXED_ENC
#define MTT_ENC(KB_, MB_)                                                        \
  if (!fixed && kb == KB_ && mb == MB_)                                          \
    err = launch_encode<KB_, MB_>(device, grid, st, data, parity, acc, ticket,   \
                                  fl, k, m, w, word_offset, nbytes, ntiles,      \
                                  tiles_per_block, aligned, t, amat);
  MTT_ENC(4, 4) MTT_ENC(4, 8) MTT_ENC(4, 16)
  MTT_ENC(8, 4) MTT_ENC(8, 8) MTT_ENC(8, 16)
  MTT_ENC(16, 4) MTT_ENC(16, 8) MTT_ENC(16, 16)
#undef MTT_ENC
  if (err != cudaSuccess || !group || m == 0) return (int)err;
  const int g = w / kTile;
  dim3 pgrid(B * m, (g + kGroupsPerBlock - 1) / kGroupsPerBlock);
  pack_kernel<<<pgrid, kThreads, 0, st>>>(parity, flags, packed, w, g);
  return (int)cudaGetLastError();
}

// The arguments of one K5 launch, packed by kernels.py (_ENCODE_PIPE_ARGS:
// 8 addresses, 8 ints, 1 u32, 4 bytes of padding).
struct EncodePipeArgs {
  uint64_t data, parity, packed, flags, acc, terms, amat, stream;
  int32_t device, B, k, m, w, group, tiles_per_block, terms_len;
  uint32_t nbytes;
};
static_assert(sizeof(EncodePipeArgs) == 104, "kernels._ENCODE_PIPE_ARGS packs 104 bytes");

// K5: mtt_encode_pack's outputs (finalize always on) from one memset, one
// pipelined launch and, with group == 256, the pack launch.  `acc` holds
// the (B, k+m, 8) digests and then the one-word last-block ticket; the
// entry zeroes both.  `terms` is the parity matrix's term program
// (kernels.parity_terms, gf_terms_bytes() long; the fixed geometry ignores
// it); a non-null `amat` (kernels.mxu_fragments order) selects the mxu
// kernel.  Takes m >= 1 and w % 4 == 0, with 16-byte aligned rows;
// tiles_per_block comes from kernels.encode_pipelined_grid.
// @ctypes mtt_encode_pack_pipelined(c_char_p) -> c_int
int mtt_encode_pack_pipelined(const EncodePipeArgs* a) {
  const uint32_t* data = reinterpret_cast<const uint32_t*>(a->data);
  uint32_t* parity = reinterpret_cast<uint32_t*>(a->parity);
  uint32_t* packed = reinterpret_cast<uint32_t*>(a->packed);
  uint32_t* flags = reinterpret_cast<uint32_t*>(a->flags);
  uint32_t* acc = reinterpret_cast<uint32_t*>(a->acc);
  const uint32_t* amat = reinterpret_cast<const uint32_t*>(a->amat);
  const int device = a->device, B = a->B, k = a->k, m = a->m, w = a->w,
            group = a->group, tiles_per_block = a->tiles_per_block;
  if (k < 1 || k > kMaxRows || m < 1 || m > kMaxRows || w <= 0 || w % 4 != 0 ||
      tiles_per_block < 1 || B <= 0 || B > 65535 || (a->data & 15u) != 0 ||
      (size_t)a->terms_len != gf_terms_bytes() ||
      (group != 0 && (group != kTile || w % kTile != 0 || !flags || !packed)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  const size_t count = (size_t)B * (k + m) * 8;
  err = cudaMemsetAsync(acc, 0, (count + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(acc + count);
  const GfTerms t = make_gf_terms(reinterpret_cast<const uint8_t*>(a->terms), m);
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, B);
  const size_t smem = (size_t)kStages * k * kTile * sizeof(uint32_t);
  uint32_t* fl = group ? flags : nullptr;
  const int kb = bucket(k), mb = bucket(m);
  bool fixed = false;
  err = cudaErrorInvalidValue;
#define MTT_FIXED_ENCP(K_, M_)                                                    \
  if (k == K_ && m == M_) {                                                       \
    err = launch_encode_pipelined<bucket(K_), bucket(M_), K_, M_>(                \
        device, grid, smem, st, data, parity, acc, ticket, fl, k, m, w, ntiles,   \
        tiles_per_block, a->nbytes, t, amat);                                     \
    fixed = true;                                                                 \
  }
  MTT_FIXED_GEOMETRIES(MTT_FIXED_ENCP)
#undef MTT_FIXED_ENCP
#define MTT_ENCP(KB_, MB_)                                                        \
  if (!fixed && kb == KB_ && mb == MB_)                                           \
    err = launch_encode_pipelined<KB_, MB_>(                                      \
        device, grid, smem, st, data, parity, acc, ticket, fl, k, m, w, ntiles,   \
        tiles_per_block, a->nbytes, t, amat);
  MTT_ENCP(4, 4) MTT_ENCP(4, 8) MTT_ENCP(4, 16)
  MTT_ENCP(8, 4) MTT_ENCP(8, 8) MTT_ENCP(8, 16)
  MTT_ENCP(16, 4) MTT_ENCP(16, 8) MTT_ENCP(16, 16)
#undef MTT_ENCP
  if (err != cudaSuccess) return (int)err;
  if (group) {
    const int g = w / kTile;
    dim3 pgrid(B * m, (g + kGroupsPerBlock - 1) / kGroupsPerBlock);
    pack_kernel<<<pgrid, kThreads, 0, st>>>(parity, flags, packed, w, g);
    err = cudaGetLastError();
  }
  return (int)err;
}

// K2: words (R, w), w % 4 == 0 -> digests (R, 8) in acc[0 .. 8R), with
// acc[8R] the last-block ticket; the entry zeroes all 8R + 1 words on the
// stream first.  tiles_per_block (of 256 column quads) comes from the
// wrapper's grid, which it sizes for rows_per_block (kPhashRows) rows per
// block.
// @ctypes mtt_phash256(c_int, c_void_p, c_void_p, c_int, c_int, c_uint32, c_int, c_int, c_void_p) -> c_int
int mtt_phash256(int device, const uint32_t* words, uint32_t* acc, int R, int w,
                 uint32_t nbytes, int rows_per_block, int tiles_per_block,
                 void* stream) {
  if (R <= 0 || R > 65535 || w <= 0 || w % 4 != 0 || tiles_per_block < 1 ||
      rows_per_block != kPhashRows)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(acc, 0, ((size_t)R * 8 + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int nq = w / 4;
  const int span = tiles_per_block * kThreads;  // quads per block
  dim3 grid((nq + span - 1) / span, (R + kPhashRows - 1) / kPhashRows);
  const bool aligned = ((uintptr_t)words & 15u) == 0;
  phash_kernel<<<grid, kThreads, 0, st>>>(words, acc, R, w, tiles_per_block,
                                          nbytes, aligned);
  return (int)cudaGetLastError();
}

// The arguments of one K3 launch, packed by kernels.py (_GF_ARGS: 4
// addresses, 9 ints, 4 bytes of padding).
struct GfMatmulArgs {
  uint64_t in, out, terms, stream;
  int32_t device, B, rows_in, w, o, s, blocks, terms_len, rows;
};
static_assert(sizeof(GfMatmulArgs) == 72, "kernels._GF_ARGS packs 72 bytes");

// (B, rows_in, w) words, inputs terms.row[0..s) -> (B, o, w), any w > 0.
// `terms` is the (o, s) matrix's term program (kernels.gf_terms,
// gf_terms_bytes() long) with `rows` product rows; the grid strides over
// the (stripe, 256-quad tile) pairs with `blocks` blocks.
// @ctypes mtt_gf_matmul(c_char_p) -> c_int
int mtt_gf_matmul(const GfMatmulArgs* a) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(a->in);
  uint32_t* out = reinterpret_cast<uint32_t*>(a->out);
  const int device = a->device, B = a->B, rows_in = a->rows_in, w = a->w,
            o = a->o, s = a->s, blocks = a->blocks, rows = a->rows;
  void* stream = reinterpret_cast<void*>(a->stream);
  if (o < 1 || o > kMaxRows || s < 1 || s > kMaxRows || w <= 0 || B <= 0 ||
      blocks < 1 || rows < 0 || rows > o || (size_t)a->terms_len != gf_terms_bytes())
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const GfTerms t = make_gf_terms(reinterpret_cast<const uint8_t*>(a->terms), rows);
  const bool aligned = w % 4 == 0 && ((uintptr_t)in & 15u) == 0 &&
                       ((uintptr_t)out & 15u) == 0;
  const int sb = bucket(s);
  if (sb == 4)
    gf_matmul_kernel<4><<<blocks, kThreads, 0, st>>>(in, out, B, rows_in, o, s, w, aligned, t);
  else if (sb == 8)
    gf_matmul_kernel<8><<<blocks, kThreads, 0, st>>>(in, out, B, rows_in, o, s, w, aligned, t);
  else
    gf_matmul_kernel<16><<<blocks, kThreads, 0, st>>>(in, out, B, rows_in, o, s, w, aligned, t);
  return (int)cudaGetLastError();
}

// The arguments of one K4 launch, packed by kernels.py (_VR_ARGS: 7
// addresses, 10 ints, 3 u32, 4 bytes of padding).
struct VrArgs {
  uint64_t shards, data, acc, ticket, terms, amat, stream;
  int32_t device, B, n, k, w, np, rb, tiles_per_block, terms_len, zero_acc;
  uint32_t present, nbytes, word_offset;
};
static_assert(sizeof(VrArgs) == 112, "kernels._VR_ARGS packs 112 bytes");

// K4, swar or [mxu] (amat != nullptr): shards (B, n, w), w % 4 == 0 ->
// data (B, k, w) rebuilt from the first k present rows (16-byte aligned:
// the copies are 16-byte stores), and the phash256 partials of the np
// present rows XORed into `acc` (B, n, 8) with the hash key of column c
// taken at c + word_offset.  zero_acc != 0 zeroes `acc` first (else the
// partials accumulate onto it, as a sub-chunk chain does).  A non-null
// `ticket` (zeroed here) makes the last block finalize the partials in
// place: the digests (absent rows get the finalize of zero partials); with
// a null one they stay raw.  The whole-row call passes ticket == acc +
// B*n*8, so one memset zeroes both.  `terms` is the term program
// kernels.vr_terms packs per (present, k) (terms_bytes<bucket(k)>() long,
// rb rebuilt rows); `amat` the (rb, k) matrix of the rebuilt rows in
// kernels.mxu_fragments order.  tiles_per_block comes from
// kernels.pipelined_grid.  Returns the first non-zero CUDA error.
// @ctypes mtt_verify_reconstruct(c_char_p) -> c_int
int mtt_verify_reconstruct(const VrArgs* a) {
  const int device = a->device, B = a->B, n = a->n, k = a->k, w = a->w, np = a->np,
            rb = a->rb, tiles_per_block = a->tiles_per_block;
  const uint8_t* blob = reinterpret_cast<const uint8_t*>(a->terms);
  const int kbk = bucket(k);
  const size_t want = kbk == 4 ? terms_bytes<4>() : kbk == 8 ? terms_bytes<8>() : terms_bytes<16>();
  const int rb_max = kbk == 4 ? kRbMax<4> : kbk == 8 ? kRbMax<8> : kRbMax<16>;
  if (n < 1 || n > kMaxRows || k < 1 || k > np || w <= 0 || w % 4 != 0 ||
      tiles_per_block < 1 || B <= 0 || B > 65535 || (a->present >> n) != 0u ||
      __builtin_popcount(a->present) != np || rb < 0 || rb > rb_max || rb > k ||
      a->word_offset % 4 != 0 || (a->data & 15u) != 0 || blob == nullptr ||
      (size_t)a->terms_len != want)
    return (int)cudaErrorInvalidValue;
  const VrSlots sl = make_slots(blob, kbk);
  if (!slots_valid(sl, n, k, np, rb, a->present)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  uint32_t* acc = reinterpret_cast<uint32_t*>(a->acc);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(a->ticket);
  const size_t count = (size_t)B * n * 8;
  const bool joint = ticket == reinterpret_cast<unsigned int*>(acc + count);
  if (a->zero_acc)
    err = cudaMemsetAsync(acc, 0, (count + (joint ? 1 : 0)) * sizeof(uint32_t), st);
  if (err == cudaSuccess && ticket != nullptr && !(a->zero_acc && joint))
    err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, B);
  const size_t smem = (size_t)2 * np * kTile * sizeof(uint32_t);
  const uint32_t* shards = reinterpret_cast<const uint32_t*>(a->shards);
  uint32_t* data = reinterpret_cast<uint32_t*>(a->data);
  const uint32_t* amat = reinterpret_cast<const uint32_t*>(a->amat);
  const bool aligned = (a->shards & 15u) == 0;
  const int pbk = bucket(np);
  err = cudaErrorInvalidValue;
  if (amat) {
    const int rbk = rb <= 4 ? 4 : 8;
#define MTT_VRM(PB_, RB_)                                                           \
  if (pbk == PB_ && rbk == RB_)                                                     \
    err = launch_vr<PB_, RB_, true>(device, grid, smem, st, shards, data, acc, ticket, \
                                    n, k, w, np, rb, ntiles, tiles_per_block,       \
                                    a->word_offset, a->nbytes, aligned, sl, amat);
    MTT_VRM(4, 4) MTT_VRM(8, 4) MTT_VRM(8, 8) MTT_VRM(16, 4) MTT_VRM(16, 8)
#undef MTT_VRM
  } else {
#define MTT_VRS(PB_, KB_)                                                           \
  if (pbk == PB_ && kbk == KB_)                                                     \
    err = launch_vr<PB_, KB_, false>(device, grid, smem, st, shards, data, acc,     \
                                     ticket, n, k, w, np, rb, ntiles,               \
                                     tiles_per_block, a->word_offset, a->nbytes,    \
                                     aligned, make_terms<KB_>(blob), nullptr);
    MTT_VRS(4, 4) MTT_VRS(8, 4) MTT_VRS(8, 8) MTT_VRS(16, 4) MTT_VRS(16, 8) MTT_VRS(16, 16)
#undef MTT_VRS
  }
  return (int)err;
}

// K6: mtt_verify_reconstruct's outputs (finalize always on) from one
// pipelined launch: data (B, k, w), and the digests (B, n, 8) in
// acc[0 .. 8Bn) with acc[8Bn] the last-block ticket, all zeroed by the
// entry on the stream first.  `terms` is the term program kernels.vr_terms
// packs per (present, k) - the (kRbMax, 8, bucket(k)) rebuilt-row masks,
// the 16 staged rows, the 16 copy targets, the kRbMax rebuilt rows - with
// `rb` rebuilt rows.  Takes w % 4 == 0 with 16-byte aligned rows; a
// non-null `amat` (the (rb, k) matrix of the rebuilt rows in
// kernels.mxu_fragments order) selects the mxu product.
// @ctypes mtt_verify_reconstruct_pipelined(c_int, c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_uint32, c_uint32, c_int, c_void_p, c_int, c_int, c_void_p, c_void_p) -> c_int
int mtt_verify_reconstruct_pipelined(int device, const uint32_t* shards,
                                     uint32_t* data, uint32_t* acc, int B,
                                     int n, int k, int w, uint32_t present,
                                     uint32_t nbytes, int tiles_per_block,
                                     const uint8_t* terms, int terms_len,
                                     int rb, const uint32_t* amat,
                                     void* stream) {
  const int np = __builtin_popcount(present);
  const int pbk = bucket(np), kbk = bucket(k);
  const bool t4 = kbk == 4, t8 = kbk == 8;
  if (n < 1 || n > kMaxRows || k < 1 || k > np || w <= 0 || w % 4 != 0 ||
      tiles_per_block < 1 || B <= 0 || B > 65535 || (present >> n) != 0u ||
      rb < 0 || rb > k || rb > (t4 ? kRbMax<4> : t8 ? kRbMax<8> : kRbMax<16>) ||
      terms == nullptr ||
      (size_t)terms_len != (t4 ? terms_bytes<4>() : t8 ? terms_bytes<8>()
                                                    : terms_bytes<16>()) ||
      ((uintptr_t)shards & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const VrSlots sl = make_slots(terms, kbk);
  if (!slots_valid(sl, n, k, np, rb, present)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t count = (size_t)B * n * 8;
  err = cudaMemsetAsync(acc, 0, (count + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(acc + count);
  const int ntiles = (w + kTile - 1) / kTile;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, B);
  const size_t smem = (size_t)kStages * np * kTile * sizeof(uint32_t);
  err = cudaErrorInvalidValue;
  if (amat) {
    const int rbk = rb <= 4 ? 4 : 8;
#define MTT_VRPM(PB_, RB_)                                                     \
  if (pbk == PB_ && rbk == RB_)                                                \
    err = launch_vr_pipelined<PB_, RB_, true>(device, grid, smem, st, shards,  \
                                              data, acc, ticket, n, k, w, np,  \
                                              rb, ntiles, tiles_per_block,     \
                                              nbytes, sl, amat);
    MTT_VRPM(4, 4) MTT_VRPM(8, 4) MTT_VRPM(8, 8) MTT_VRPM(16, 4) MTT_VRPM(16, 8)
#undef MTT_VRPM
  } else {
#define MTT_VRP(PB_, KB_)                                                      \
  if (pbk == PB_ && kbk == KB_)                                                \
    err = launch_vr_pipelined<PB_, KB_, false>(                                \
        device, grid, smem, st, shards, data, acc, ticket, n, k, w, np, rb,    \
        ntiles, tiles_per_block, nbytes, make_terms<KB_>(terms), nullptr);
    MTT_VRP(4, 4) MTT_VRP(8, 4) MTT_VRP(8, 8) MTT_VRP(16, 4) MTT_VRP(16, 8) MTT_VRP(16, 16)
#undef MTT_VRP
  }
  return (int)err;
}

// The arguments of one K7 launch, packed by kernels.py (_MXU_ARGS: 5
// addresses, 6 ints).
struct MxuArgs {
  uint64_t in, out, frags, stamps, stream;
  int32_t device, o, s, length, blocks, tiles_per_block;
};
static_assert(sizeof(MxuArgs) == 64, "kernels._MXU_ARGS packs 64 bytes");

// K7: (o, s) matrix as kernels.k7_fragments (`frags`) @ (s, length) bytes
// -> (o, length) bytes, rows `length` bytes apart, any length; `blocks`
// blocks of `tiles_per_block` kMxTile-byte tiles (kernels.k7_grid).
// @ctypes mtt_gf_matmul_mxu(c_char_p) -> c_int
int mtt_gf_matmul_mxu(const MxuArgs* a) {
  const uint8_t* in = reinterpret_cast<const uint8_t*>(a->in);
  uint8_t* out = reinterpret_cast<uint8_t*>(a->out);
  const uint32_t* frags = reinterpret_cast<const uint32_t*>(a->frags);
  long long* stamps = reinterpret_cast<long long*>(a->stamps);
  const int device = a->device, o = a->o, s = a->s, length = a->length,
            blocks = a->blocks, tpb = a->tiles_per_block;
  if (o < 1 || o > kMaxRows || s < 1 || s > kMaxRows || length <= 0 ||
      frags == nullptr || blocks < 1 || tpb < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (int)(((long long)length + kMxTile - 1) / kMxTile);
  if ((long long)blocks * tpb < ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  const bool bulk = length % 16 == 0 && ((uintptr_t)in & 15u) == 0 &&
                    ((uintptr_t)out & 15u) == 0;
  const size_t smem = (size_t)(bulk ? kMxStages : 1) * s * kMxRowStride;
  const int sb = bucket(s), ob = bucket(o);
  err = cudaErrorInvalidValue;
#define MTT_K7(SB_, OB_)                                                          \
  if (sb == SB_ && ob == OB_)                                                     \
    err = launch_gf_mxu<SB_, OB_>(device, blocks, smem, st, in, out, frags, stamps, \
                                  o, s, length, ntiles, tpb, bulk);
  MTT_K7(4, 4) MTT_K7(4, 8) MTT_K7(4, 16) MTT_K7(8, 4) MTT_K7(8, 8) MTT_K7(8, 16)
  MTT_K7(16, 4) MTT_K7(16, 8) MTT_K7(16, 16)
#undef MTT_K7
  return (int)err;
}

// The arguments of one K12 or K13 launch, packed by kernels.py
// (_GROUP_ARGS: 4 addresses, the rows, 4 ints; `cluster` is K13's, 0 for
// K12, `seg` K13's segment or K12's run).
struct GroupArgs {
  uint64_t words, flags, packed, stream;
  int64_t rows;
  int32_t device, w, cluster, seg;
};
static_assert(sizeof(GroupArgs) == 56, "kernels._GROUP_ARGS packs 56 bytes");

// K12: words (rows, w), w % 256 == 0 -> flags (rows, w / 256) 0/1, each
// warp a run of `seg` groups (kernels.group_plan).  With a non-null
// `packed`, K13 instead: the flags and the full-row prefix pack (rows, w)
// in one launch of `cluster`-block clusters, one a row, each block
// staging `seg` groups a pass (kernels.pack_plan).  Any rows, any 4-byte
// aligned start; `packed` 16-byte aligned.
// @ctypes mtt_group_flags(c_char_p) -> c_int
int mtt_group_flags(const GroupArgs* a) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(a->words);
  uint32_t* flags = reinterpret_cast<uint32_t*>(a->flags);
  uint32_t* packed = reinterpret_cast<uint32_t*>(a->packed);
  const long long rows = a->rows;
  const int w = a->w;
  if (rows <= 0 || w <= 0 || w % kTile != 0 || a->seg < 1) return (int)cudaErrorInvalidValue;
  const long long groups = rows * (w / kTile);
  const long long warps = packed == nullptr ? (groups + a->seg - 1) / a->seg : 0;
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (packed == nullptr
          ? blocks > 0x7fffffffLL
          : a->cluster < 1 || a->cluster > kPackClusterMax ||
                a->seg > kPackSegMax || rows * a->cluster > 0x7fffffffLL ||
                (reinterpret_cast<uintptr_t>(packed) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  const bool vec = (reinterpret_cast<uintptr_t>(words) & 15u) == 0;
  if (packed != nullptr)
    return (int)(vec ? launch_pack<true>(a->device, words, flags, packed, rows, w,
                                         a->cluster, a->seg, st)
                     : launch_pack<false>(a->device, words, flags, packed, rows, w,
                                          a->cluster, a->seg, st));
  if (vec)
    group_flags_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(words, flags, groups, a->seg);
  else
    group_flags_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(words, flags, groups, a->seg);
  return (int)cudaGetLastError();
}

// How many K13 clusters of `cluster` blocks with `seg` groups of shared
// memory each the card holds at once (kernels.pack_plan), -1 on an error.
// @ctypes mtt_pack_clusters(c_int, c_int, c_int) -> c_int
int mtt_pack_clusters(int device, int cluster, int seg) {
  if (cluster < 1 || cluster > kPackClusterMax || seg < 1 || seg > kPackSegMax) return -1;
  if (cudaSetDevice(device) != cudaSuccess || pack_opt_in<true>(device) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)seg * kTile * sizeof(uint32_t);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, pack_groups_kernel<true>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// The constants ops/kernels.py shares with this file, as "name=v[,v...]"
// words: the loader (kernels._load) refuses a library whose values
// differ from its own.
// @ctypes mtt_constants() -> c_char_p
const char* mtt_constants() {
#define MTT_FIXED_STR(K_, M_) "," #K_ "x" #M_
  static char buf[1024];
  static const int len = snprintf(
      buf, sizeof buf,
      "tile=%d max_rows=%d phash_rows=%d phash_blocks_per_sm=%d "
      "pipe_blocks_per_sm=%d enc_blocks_per_sm=%d "
      "gf_blocks_per_sm=%d "
      "bucket=%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d "
      "rb_max=%d,%d,%d vr_terms_bytes=%d,%d,%d gf_terms_bytes=%d "
      "encode_args_bytes=%d encode_pipe_args_bytes=%d gf_args_bytes=%d "
      "vr_args_bytes=%d rebuilt_max=%d "
      "mxu_tile_bytes=%d mxu_row_stride=%d mxu_stages=%d "
      "mxu_blocks_per_sm=%d,%d,%d,%d,%d,%d,%d,%d,%d mxu_args_bytes=%d "
      "ring_swizzle=%d,%d,%d,%d group_args_bytes=%d "
      "pack_seg_max=%d pack_cluster_max=%d flags_batch=%d flags_blocks_per_sm=%d "
      "fixed=%s",
      kTile, kMaxRows, kPhashRows, kPhashBlocksPerSM, kPipeBlocksPerSM,
      kEncBlocksPerSM, kGfBlocksPerSM, bucket(1), bucket(2), bucket(3), bucket(4), bucket(5),
      bucket(6), bucket(7), bucket(8), bucket(9), bucket(10), bucket(11),
      bucket(12), bucket(13), bucket(14), bucket(15), bucket(16), kRbMax<4>,
      kRbMax<8>, kRbMax<16>, (int)terms_bytes<4>(), (int)terms_bytes<8>(),
      (int)terms_bytes<16>(), (int)gf_terms_bytes(), (int)sizeof(EncodeArgs),
      (int)sizeof(EncodePipeArgs), (int)sizeof(GfMatmulArgs), (int)sizeof(VrArgs),
      kRebuiltMax, kMxTile, kMxRowStride, kMxStages, k7_min_blocks(4, 4),
      k7_min_blocks(4, 8), k7_min_blocks(4, 16), k7_min_blocks(8, 4), k7_min_blocks(8, 8),
      k7_min_blocks(8, 16), k7_min_blocks(16, 4), k7_min_blocks(16, 8),
      k7_min_blocks(16, 16),
      (int)sizeof(MxuArgs), ring_swizzle(0),
      ring_swizzle(4), ring_swizzle(8), ring_swizzle(12), (int)sizeof(GroupArgs),
      kPackSegMax, kPackClusterMax, kFlagsBatch, kFlagsBlocksPerSM,
      "" MTT_FIXED_GEOMETRIES(MTT_FIXED_STR));
#undef MTT_FIXED_STR
  (void)len;
  return buf;
}

}  // extern "C"
