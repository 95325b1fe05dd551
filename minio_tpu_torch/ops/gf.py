"""Host-side GF(2^8) arithmetic and Reed-Solomon matrix construction.

This is the control-plane math behind the erasure codec: tiny (k+m)-sized
matrices are built and inverted here with numpy, then handed to the GF
product kernels as bit masks (see ops/rs.py and ops/kernels.py).  The
device never does table lookups.

Reference parity: klauspost/reedsolomon v1.9.9 (the dependency wrapped by
cmd/erasure-coding.go:54-64 in the reference), which uses the AES-agnostic
Reed-Solomon polynomial x^8+x^4+x^3+x^2+1 (0x11d) and a Vandermonde-derived
systematic generator matrix (reedsolomon.go buildMatrix).  We reproduce that
construction exactly so shard geometry and reconstruction semantics match.
"""

from __future__ import annotations

import functools

import numpy as np

# The Reed-Solomon field polynomial used by klauspost/reedsolomon (0x11d).
POLY = 0x11D
FIELD = 256


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) under POLY, generator 2."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    return exp, log


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply (table based)."""
    if a == 0 or b == 0:
        return 0
    exp, log = _tables()
    return int(exp[log[a] + log[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    exp, log = _tables()
    return int(exp[(log[a] - log[b]) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log = _tables()
    return int(exp[(log[a] * n) % 255])


@functools.lru_cache(maxsize=None)
def mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) product table (64 KiB) for vectorized host math."""
    exp, log = _tables()
    a = np.arange(256)
    la = log[a][:, None] + log[a][None, :]
    t = exp[la.clip(0, 509)]
    t = t.copy()
    t[0, :] = 0
    t[:, 0] = 0
    return t


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of uint8 matrices (host, for tiny matrices)."""
    t = mul_table()
    # products[i,j,l] = a[i,l]*b[l,j]; XOR-reduce over l.
    prods = t[a[:, None, :], b.T[None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=2).astype(np.uint8)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix via Gauss-Jordan elimination.

    Raises ValueError if singular (caller treats this as "data irrecoverable",
    mirroring reedsolomon.ErrTooFewShards semantics at the Erasure layer).
    """
    n = m.shape[0]
    t = mul_table()
    aug = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("singular matrix in GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = t[aug[col], inv]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= t[aug[col], int(aug[row, col])]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def rs_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic (data+parity) x data generator matrix.

    Same construction as klauspost/reedsolomon buildMatrix: take the
    (n x k) Vandermonde matrix V[r, c] = r^c, then left-multiply by the
    inverse of its top k x k block so the data rows become the identity.
    Any k rows of the result are linearly independent, which is the
    reconstruction guarantee the Erasure layer relies on
    (cmd/erasure-coding.go:89-113).
    """
    k, m = data_shards, parity_shards
    n = k + m
    if not (0 < k and 0 <= m and n <= FIELD):
        raise ValueError(f"invalid erasure config {k}+{m}")
    vand = np.zeros((n, k), dtype=np.uint8)
    for r in range(n):
        for c in range(k):
            vand[r, c] = gf_pow(r, c)
    top_inv = mat_inv(vand[:k, :k])
    return mat_mul(vand, top_inv)


def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (parity x data) rows of the systematic generator matrix."""
    return rs_matrix(data_shards, parity_shards)[data_shards:, :].copy()


@functools.lru_cache(maxsize=4096)
def reconstruction_matrix(
    data_shards: int, parity_shards: int, present: tuple[int, ...]
) -> np.ndarray:
    """Matrix mapping k surviving shards back to the k data shards.

    ``present`` lists >=k surviving shard indices (0..k-1 data, k..n-1 parity);
    only the first k are used.  Mirrors reedsolomon.Reconstruct's sub-matrix
    inversion.
    """
    k = data_shards
    rows = sorted(present)[:k]
    if len(rows) < k:
        raise ValueError(
            f"need {k} shards to reconstruct, have {len(rows)}"
        )
    gen = rs_matrix(data_shards, parity_shards)
    sub = gen[list(rows), :]
    return mat_inv(sub)


def encode_ref(data: np.ndarray, parity_shards: int) -> np.ndarray:
    """Pure-numpy reference encoder used by tests as the known answer.

    data: (k, length) uint8 -> parity (m, length) uint8.
    """
    k = data.shape[0]
    pm = parity_matrix(k, parity_shards)
    t = mul_table()
    out = np.zeros((parity_shards, data.shape[1]), dtype=np.uint8)
    for r in range(parity_shards):
        acc = np.zeros(data.shape[1], dtype=np.uint8)
        for c in range(k):
            acc ^= t[pm[r, c], data[c]]
        out[r] = acc
    return out
