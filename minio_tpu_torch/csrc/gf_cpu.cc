// Native CPU GF(2^8) matrix codec: the host erasure codec the server runs
// under MINIO_ERASURE_BACKEND=cpu (codec/backend.py CpuBackend), and the
// AVX2 yardstick the card's codec is measured beside.
//
// Implements the same technique as the reference's codec dependency
// (klauspost/reedsolomon v1.9.9 AVX2 assembly, wrapped by
// cmd/erasure-coding.go): multiply-by-constant via two 16-entry nibble
// tables applied with PSHUFB/VPSHUFB, XOR-accumulated across input shards.
// Scalar table fallback when AVX2 is unavailable.
//
// Exposed as a C ABI for ctypes (utils/native.py builds it with g++ and
// binds it; nothing here includes PyTorch's headers).

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr unsigned kPoly = 0x11d;

struct Tables {
  uint8_t mul[256][256];
  // nibble tables: low[c][x] = c*x for x in 0..15, high[c][x] = c*(x<<4)
  uint8_t low[256][16];
  uint8_t high[256][16];
  Tables() {
    // build via Russian-peasant multiply (no log/exp edge cases)
    for (unsigned a = 0; a < 256; ++a) {
      for (unsigned b = 0; b < 256; ++b) {
        unsigned x = a, y = b, r = 0;
        while (y) {
          if (y & 1) r ^= x;
          x <<= 1;
          if (x & 0x100) x ^= kPoly;
          y >>= 1;
        }
        mul[a][b] = static_cast<uint8_t>(r);
      }
    }
    for (unsigned c = 0; c < 256; ++c) {
      for (unsigned x = 0; x < 16; ++x) {
        low[c][x] = mul[c][x];
        high[c][x] = mul[c][x << 4];
      }
    }
  }
};

const Tables& tables() {
  static Tables t;
  return t;
}

// out ^= c * in over len bytes
void mul_acc_scalar(uint8_t c, const uint8_t* in, uint8_t* out, size_t len) {
  const uint8_t* row = tables().mul[c];
  for (size_t i = 0; i < len; ++i) out[i] ^= row[in[i]];
}

#if defined(__AVX2__)
void mul_acc_avx2(uint8_t c, const uint8_t* in, uint8_t* out, size_t len) {
  const Tables& t = tables();
  const __m128i lo128 = _mm_loadu_si128(
      reinterpret_cast<const __m128i*>(t.low[c]));
  const __m128i hi128 = _mm_loadu_si128(
      reinterpret_cast<const __m128i*>(t.high[c]));
  const __m256i lo = _mm256_broadcastsi128_si256(lo128);
  const __m256i hi = _mm256_broadcastsi128_si256(hi128);
  const __m256i mask = _mm256_set1_epi8(0x0f);
  size_t i = 0;
  for (; i + 32 <= len; i += 32) {
    __m256i v = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(in + i));
    __m256i vlo = _mm256_and_si256(v, mask);
    __m256i vhi = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
    __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(lo, vlo),
                                    _mm256_shuffle_epi8(hi, vhi));
    __m256i o = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(out + i));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                        _mm256_xor_si256(o, prod));
  }
  if (i < len) mul_acc_scalar(c, in + i, out + i, len - i);
}
#endif

void mul_acc(uint8_t c, const uint8_t* in, uint8_t* out, size_t len) {
  if (c == 0) return;
#if defined(__AVX2__)
  mul_acc_avx2(c, in, out, len);
#else
  mul_acc_scalar(c, in, out, len);
#endif
}

// ---------------------------------------------------------------------
// phash256: native twin of ops/hash.py phash256_host_batched
// (bit-identical).  Word-parallel by construction, so the AVX2 path
// processes 8 u32 lanes per step; lane j of the accumulators folds
// into digest partition j & 3.
// ---------------------------------------------------------------------

inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kM1 = 0xCC9E2D51u;
constexpr uint32_t kM2 = 0x1B873593u;

#if defined(__AVX2__)
inline __m256i mix256(__m256i x) {
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 16));
  x = _mm256_mullo_epi32(x, _mm256_set1_epi32((int)0x85EBCA6Bu));
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 13));
  x = _mm256_mullo_epi32(x, _mm256_set1_epi32((int)0xC2B2AE35u));
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 16));
  return x;
}
#endif

void phash_row(const uint32_t* w, size_t n, uint64_t nbytes,
               uint32_t* out8) {
  uint32_t p1[4] = {0, 0, 0, 0}, p2[4] = {0, 0, 0, 0};
  size_t i = 0;
#if defined(__AVX2__)
  if (n >= 8) {
    __m256i acc1 = _mm256_setzero_si256();
    __m256i acc2 = _mm256_setzero_si256();
    const __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    const __m256i vc1 = _mm256_set1_epi32((int)kC1);
    const __m256i vm1 = _mm256_set1_epi32((int)kM1);
    const __m256i vm2 = _mm256_set1_epi32((int)kM2);
    for (; i + 8 <= n; i += 8) {
      __m256i idx = _mm256_add_epi32(_mm256_set1_epi32((int)i), lane);
      __m256i key = mix256(_mm256_add_epi32(
          _mm256_mullo_epi32(idx, vc1), _mm256_set1_epi32(1)));
      __m256i x = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(w + i));
      __m256i t1 =
          mix256(_mm256_mullo_epi32(_mm256_xor_si256(x, key), vm1));
      __m256i t2 =
          mix256(_mm256_mullo_epi32(_mm256_add_epi32(x, key), vm2));
      acc1 = _mm256_xor_si256(acc1, t1);
      acc2 = _mm256_xor_si256(acc2, t2);
    }
    alignas(32) uint32_t a1[8], a2[8];
    _mm256_store_si256(reinterpret_cast<__m256i*>(a1), acc1);
    _mm256_store_si256(reinterpret_cast<__m256i*>(a2), acc2);
    for (int j = 0; j < 8; ++j) {
      p1[j & 3] ^= a1[j];
      p2[j & 3] ^= a2[j];
    }
  }
#endif
  for (; i < n; ++i) {
    uint32_t key = mix32((uint32_t)i * kC1 + 1u);
    uint32_t x = w[i];
    p1[i & 3] ^= mix32((x ^ key) * kM1);
    p2[i & 3] ^= mix32((x + key) * kM2);
  }
  uint32_t lenmix = (uint32_t)(nbytes * (uint64_t)kC1);
  for (int j = 0; j < 8; ++j) {
    uint32_t v = j < 4 ? p1[j] : p2[j - 4];
    out8[j] = mix32(v ^ (lenmix + (uint32_t)j));
  }
}

// ---------------------------------------------------------------------
// Streaming phash256 state: tile-resumable twin of phash_row.  The
// strided mod-4 partitions make the hash foldable over any contiguous
// split of the word stream, so the fused codec can advance a shard's
// digest one cache-resident tile at a time while the tile is still hot
// from the GF matmul instead of re-reading the whole shard from DRAM
// in a second pass.  Bit-identical to phash_row for every split.
// ---------------------------------------------------------------------

// The AVX2 accumulators are kept as plain uint32_t[8] and moved with
// unaligned loads/stores (per tile, not per word): a __m256i member
// would demand 32-byte alignment that pre-C++17 allocators (and
// std::vector on this toolchain's default -std) don't guarantee.
struct PhashState {
#if defined(__AVX2__)
  uint32_t a1[8], a2[8];  // lane j holds word indices == j (mod 8)
#endif
  uint32_t p1[4], p2[4];  // scalar partials (non-multiple-of-8 tails)
  size_t pos;             // next global word index
};

inline void phash_init(PhashState* st) {
  std::memset(st, 0, sizeof(*st));
}

void phash_update(PhashState* st, const uint32_t* w, size_t n) {
  size_t i = 0;
#if defined(__AVX2__)
  // lanes stay aligned with the global index only while pos % 8 == 0
  // (every tile but the last is a multiple of 8 words)
  if (st->pos % 8 == 0) {
    const __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    const __m256i vc1 = _mm256_set1_epi32((int)kC1);
    const __m256i vm1 = _mm256_set1_epi32((int)kM1);
    const __m256i vm2 = _mm256_set1_epi32((int)kM2);
    __m256i acc1 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(st->a1));
    __m256i acc2 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(st->a2));
    for (; i + 8 <= n; i += 8) {
      __m256i idx = _mm256_add_epi32(
          _mm256_set1_epi32((int)(st->pos + i)), lane);
      __m256i key = mix256(_mm256_add_epi32(
          _mm256_mullo_epi32(idx, vc1), _mm256_set1_epi32(1)));
      __m256i x = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(w + i));
      acc1 = _mm256_xor_si256(
          acc1, mix256(_mm256_mullo_epi32(_mm256_xor_si256(x, key), vm1)));
      acc2 = _mm256_xor_si256(
          acc2, mix256(_mm256_mullo_epi32(_mm256_add_epi32(x, key), vm2)));
    }
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(st->a1), acc1);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(st->a2), acc2);
  }
#endif
  for (; i < n; ++i) {
    size_t gi = st->pos + i;
    uint32_t key = mix32((uint32_t)gi * kC1 + 1u);
    uint32_t x = w[i];
    st->p1[gi & 3] ^= mix32((x ^ key) * kM1);
    st->p2[gi & 3] ^= mix32((x + key) * kM2);
  }
  st->pos += n;
}

void phash_final(const PhashState* st, uint64_t nbytes, uint32_t* out8) {
  uint32_t p1[4], p2[4];
  std::memcpy(p1, st->p1, sizeof(p1));
  std::memcpy(p2, st->p2, sizeof(p2));
#if defined(__AVX2__)
  for (int j = 0; j < 8; ++j) {
    p1[j & 3] ^= st->a1[j];
    p2[j & 3] ^= st->a2[j];
  }
#endif
  uint32_t lenmix = (uint32_t)(nbytes * (uint64_t)kC1);
  for (int j = 0; j < 8; ++j) {
    uint32_t v = j < 4 ? p1[j] : p2[j - 4];
    out8[j] = mix32(v ^ (lenmix + (uint32_t)j));
  }
}

// ---------------------------------------------------------------------
// Fused single-pass stripe kernels.  Tile size is chosen so one data
// row tile + all parity row tiles stay L1/L2 resident: each data byte
// is read once from DRAM, multiplied into every parity row and hashed
// while hot, and each parity byte is hashed the moment its tile's
// accumulation completes - one memory pass per byte instead of three
// (matmul, concatenate copy, digest).
// ---------------------------------------------------------------------

constexpr size_t kTileBytes = 16384;  // multiple of 32; 4096 words

void encode_stripe_fused(int k, int m, size_t L, const uint8_t* data,
                         const uint8_t* matrix, uint8_t* parity,
                         uint32_t* digests, PhashState* st /* k+m */) {
  for (int s = 0; s < k + m; ++s) phash_init(&st[s]);
  for (size_t off = 0; off < L; off += kTileBytes) {
    size_t t = L - off < kTileBytes ? L - off : kTileBytes;
    for (int r = 0; r < m; ++r) std::memset(parity + r * L + off, 0, t);
    for (int c = 0; c < k; ++c) {
      const uint8_t* in = data + c * L + off;
      phash_update(&st[c], reinterpret_cast<const uint32_t*>(in), t / 4);
      for (int r = 0; r < m; ++r) {
        mul_acc(matrix[r * k + c], in, parity + r * L + off, t);
      }
    }
    for (int r = 0; r < m; ++r) {
      phash_update(&st[k + r],
                   reinterpret_cast<const uint32_t*>(parity + r * L + off),
                   t / 4);
    }
  }
  for (int s = 0; s < k + m; ++s) phash_final(&st[s], L, digests + s * 8);
}

// out rows = rm (k x k) GF-matmul the k survivor rows, tile-resident.
void matmul_stripe_tiled(int k, size_t L, const uint8_t* shards,
                         const int32_t* surv, const uint8_t* rm,
                         uint8_t* out) {
  for (size_t off = 0; off < L; off += kTileBytes) {
    size_t t = L - off < kTileBytes ? L - off : kTileBytes;
    for (int r = 0; r < k; ++r) std::memset(out + r * L + off, 0, t);
    for (int c = 0; c < k; ++c) {
      const uint8_t* in = shards + (size_t)surv[c] * L + off;
      for (int r = 0; r < k; ++r) {
        mul_acc(rm[r * k + c], in, out + r * L + off, t);
      }
    }
  }
}

// Run f(b) over stripes [0, B) on up to nthreads workers.  ctypes
// releases the GIL around the whole batch call, so these threads
// compose with the Python-side iopool writers; on a single-core host
// nthreads==1 stays strictly inline (no spawn, no regression).
template <typename F>
void for_stripes(int B, int nthreads, F f) {
  if (nthreads > B) nthreads = B;
  if (nthreads <= 1 || B <= 1) {
    for (int b = 0; b < B; ++b) f(b);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    int b;
    while ((b = next.fetch_add(1)) < B) f(b);
  };
  std::vector<std::thread> ts;
  ts.reserve(nthreads - 1);
  for (int i = 1; i < nthreads; ++i) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
}

}  // namespace

// Every export below carries a `// @ctypes name(argtypes...) -> restype`
// annotation: the intended ctypes signature of its binding in
// minio_tpu_torch/utils/native.py.  The abi_contracts analysis pass (MTPU4xx)
// parses these and cross-checks them against both this file's C
// signatures and the Python bindings, so signature drift on either side
// of the FFI seam fails the tier-1 gate instead of corrupting memory.
extern "C" {

// out[r] = XOR_c matrix[r*in_n + c] * in[c], for r in [0, out_n).
// Each shard is `len` bytes. Out rows are zeroed first.
// @ctypes gf_matmul(c_int, c_int, c_void_p, POINTER(c_void_p), POINTER(c_void_p), c_size_t) -> None
void gf_matmul(int out_n, int in_n, const uint8_t* matrix,
               const uint8_t* const* in, uint8_t* const* out, size_t len) {
  for (int r = 0; r < out_n; ++r) {
    std::memset(out[r], 0, len);
    for (int c = 0; c < in_n; ++c) {
      mul_acc(matrix[r * in_n + c], in[c], out[r], len);
    }
  }
}

// Convenience single mul-acc (used by tests)
// @ctypes gf_mul_acc(c_uint8, c_void_p, c_void_p, c_size_t) -> None
void gf_mul_acc(uint8_t c, const uint8_t* in, uint8_t* out, size_t len) {
  mul_acc(c, in, out, len);
}

// digests[r*8..r*8+8) = phash256 of words[r*nwords..(r+1)*nwords)
// with the real (unpadded) byte length folded in.
// @ctypes phash256_rows(c_void_p, c_size_t, c_size_t, c_uint64, c_void_p) -> None
void phash256_rows(const uint32_t* words, size_t nrows, size_t nwords,
                   uint64_t nbytes, uint32_t* digests) {
  for (size_t r = 0; r < nrows; ++r) {
    phash_row(words + r * nwords, nwords, nbytes, digests + r * 8);
  }
}

// Fused single-pass batch encode: parity AND phash256 digests of the
// whole (B, k, L) batch in one call, one memory pass per byte.
//   data:    (B, k, L) uint8, C-contiguous
//   matrix:  (m, k) parity rows of the systematic generator
//   parity:  (B, m, L) uint8 out
//   digests: (B, k+m, 8) uint32 out, data rows then parity
// L must be a multiple of 32 (the erasure layer's shard padding).
// Stripes are dispatched over up to nthreads workers.
// @ctypes encode_and_hash(c_int, c_int, c_int, c_size_t, c_void_p, c_void_p, c_void_p, c_void_p, c_int) -> None
void encode_and_hash(int B, int k, int m, size_t L, const uint8_t* data,
                     const uint8_t* matrix, uint8_t* parity,
                     uint32_t* digests, int nthreads) {
  int n = k + m;
  for_stripes(B, nthreads, [&](int b) {
    std::vector<PhashState> st(n);
    encode_stripe_fused(k, m, L, data + (size_t)b * k * L, matrix,
                        parity + (size_t)b * m * L, digests + (size_t)b * n * 8,
                        st.data());
  });
}

// Batched reconstruct: out[b] = rm GF-matmul shards[b][surv], for the
// whole (B, n, L) batch in one call (pattern uniform across the batch).
// @ctypes reconstruct_batch(c_int, c_int, c_int, c_size_t, c_void_p, c_void_p, c_void_p, c_void_p, c_int) -> None
void reconstruct_batch(int B, int n, int k, size_t L, const uint8_t* shards,
                       const int32_t* surv, const uint8_t* rm, uint8_t* out,
                       int nthreads) {
  for_stripes(B, nthreads, [&](int b) {
    matmul_stripe_tiled(k, L, shards + (size_t)b * n * L, surv, rm,
                        out + (size_t)b * k * L);
  });
}

// Fused GET-side pass: verify the bitrot digests of every present
// shard AND decode the k data rows from the chosen survivors, touching
// each survivor byte once.  ok[b*n+s] = present[s] && digest match.
// The caller checks ok over `surv` and re-picks survivors on the rare
// verify failure; L must be a multiple of 4.
// @ctypes reconstruct_and_verify(c_int, c_int, c_int, c_size_t, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int) -> None
void reconstruct_and_verify(int B, int n, int k, size_t L,
                            const uint8_t* shards, const int32_t* surv,
                            const uint8_t* rm, const uint32_t* expect,
                            const uint8_t* present, uint8_t* ok,
                            uint8_t* out, int nthreads) {
  for_stripes(B, nthreads, [&](int b) {
    const uint8_t* sh = shards + (size_t)b * n * L;
    uint8_t* dst = out + (size_t)b * k * L;
    std::vector<PhashState> st(n);
    for (int s = 0; s < n; ++s) phash_init(&st[s]);
    for (size_t off = 0; off < L; off += kTileBytes) {
      size_t t = L - off < kTileBytes ? L - off : kTileBytes;
      for (int s = 0; s < n; ++s) {
        if (present[s]) {
          phash_update(&st[s],
                       reinterpret_cast<const uint32_t*>(sh + s * L + off),
                       t / 4);
        }
      }
      for (int r = 0; r < k; ++r) std::memset(dst + r * L + off, 0, t);
      for (int c = 0; c < k; ++c) {
        const uint8_t* in = sh + (size_t)surv[c] * L + off;
        for (int r = 0; r < k; ++r) {
          mul_acc(rm[r * k + c], in, dst + r * L + off, t);
        }
      }
    }
    for (int s = 0; s < n; ++s) {
      uint32_t got[8];
      if (!present[s]) {
        ok[(size_t)b * n + s] = 0;
        continue;
      }
      phash_final(&st[s], L, got);
      ok[(size_t)b * n + s] =
          std::memcmp(got, expect + ((size_t)b * n + s) * 8, 32) == 0;
    }
  });
}

// @ctypes gf_has_avx2() -> c_int
int gf_has_avx2(void) {
#if defined(__AVX2__)
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
