"""phash256: the framework's parallel bitrot checksum.

Role-equivalent to HighwayHash-256 in the reference (cmd/bitrot.go:41-58):
every uint32 word is mixed with a position-derived key (splitmix32 of
its index), each word feeds two independent 32-bit mixes, and the mixes
are XOR-reduced into word-index-mod-4 partitions, then folded with the
byte length.  Depth is O(log n) and every word is independent, so the
CUDA kernels (csrc/codec.cu) compute it one word per thread and fold the
partitions with warp shuffles and XOR atomics - XOR is order-free, so
the result is bit-exact whatever the reduction order.

Threat model: an integrity checksum against accidental corruption, not
a MAC (the keys are public, like the reference's hard-coded HighwayHash
key).

Three bit-identical forms live here:

* ``phash256_host_batched`` / ``phash256_host``: numpy, on the host.
* ``phash256_words_batched`` / ``tile_partials`` / ``finalize_partials``:
  plain PyTorch over int32 tensors that reinterpret the u32 words.
  PyTorch has no logical shift on int32 (``>>`` is arithmetic) and no
  shift or add on uint32, so these compute in int64 holding the u32
  value and mask to 32 bits after every shift, add and multiply (a
  product that wraps int64 keeps its low 32 bits intact).
* the device function ``hash_word`` in csrc/codec.cu, shared by the
  encode_pack and phash256_batched kernels.
"""

from __future__ import annotations

import numpy as np
import torch

# odd constants from splitmix64/murmur3 literature, truncated to 32 bits
_C1 = np.uint32(0x9E3779B9)  # golden ratio
_C2 = np.uint32(0x85EBCA6B)
_C3 = np.uint32(0xC2B2AE35)
_M1 = np.uint32(0xCC9E2D51)
_M2 = np.uint32(0x1B873593)

PHASH_SIZE = 32  # digest bytes
_PARTS = 4  # partitions per mix lane; 2 mixes x 4 parts = 8 u32 words

MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# numpy twin (host)
# ---------------------------------------------------------------------------


def _mix_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= _C2
    x ^= x >> np.uint32(13)
    x *= _C3
    x ^= x >> np.uint32(16)
    return x


def _digest_np(words: np.ndarray, nbytes: int) -> np.ndarray:
    n = words.shape[0]
    pad = (-n) % _PARTS
    if pad:
        words = np.concatenate([words, np.zeros(pad, np.uint32)])
    idx = np.arange(words.shape[0], dtype=np.uint32)
    key = _mix_np(idx * _C1 + np.uint32(1))
    m1 = _mix_np((words ^ key) * _M1)
    m2 = _mix_np((words + key) * _M2)
    p1 = np.bitwise_xor.reduce(m1.reshape(-1, _PARTS), axis=0)
    p2 = np.bitwise_xor.reduce(m2.reshape(-1, _PARTS), axis=0)
    out = np.concatenate([p1, p2])
    # fold in total length so truncation/extension changes every word
    lenmix = (np.uint64(nbytes) * np.uint64(_C1)).astype(np.uint32)
    out = _mix_np(out ^ lenmix + np.arange(8, dtype=np.uint32))
    return out


def phash256_host_batched(words: np.ndarray, nbytes: int) -> np.ndarray:
    """Host digest over the last axis: (..., w) uint32 -> (..., 8) uint32."""
    n = words.shape[-1]
    if n % _PARTS:
        raise ValueError(f"word count {n} must be a multiple of {_PARTS}")
    idx = np.arange(n, dtype=np.uint32)
    key = _mix_np(idx * _C1 + np.uint32(1))
    m1 = _mix_np((words ^ key) * _M1)
    m2 = _mix_np((words + key) * _M2)
    lead = words.shape[:-1]
    p1 = np.bitwise_xor.reduce(
        m1.reshape(*lead, n // _PARTS, _PARTS), axis=-2
    )
    p2 = np.bitwise_xor.reduce(
        m2.reshape(*lead, n // _PARTS, _PARTS), axis=-2
    )
    out = np.concatenate([p1, p2], axis=-1)
    lenmix = (np.uint64(nbytes) * np.uint64(_C1)).astype(np.uint32)
    return _mix_np(out ^ lenmix + np.arange(8, dtype=np.uint32))


def phash256_host(data: "bytes | np.ndarray") -> bytes:
    """256-bit parallel bitrot digest of a byte string (host reference)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    nbytes = buf.shape[0]
    pad = (-nbytes) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    words = buf.view(np.uint32)
    return _digest_np(words, nbytes).tobytes()


# ---------------------------------------------------------------------------
# plain PyTorch (int64 lanes holding u32 values)
# ---------------------------------------------------------------------------


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 word tensor -> int64 tensor of the unsigned u32 values."""
    return words.to(torch.int64) & MASK32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> the int32 tensor with the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on int64 lanes in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * int(_C2)) & MASK32
    x = x ^ (x >> 13)
    x = (x * int(_C3)) & MASK32
    return x ^ (x >> 16)


def _xor_fold_parts(m: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., 4): XOR of the word-index-mod-4 partitions.

    PyTorch has no XOR reduction, so fold the (n//4, 4) view in halves;
    each step keeps the mod-4 classes intact."""
    lead = m.shape[:-1]
    x = m.reshape(*lead, -1, _PARTS)
    while x.shape[-2] > 1:
        rows = x.shape[-2]
        half = rows // 2
        folded = x[..., :half, :] ^ x[..., half : 2 * half, :]
        if rows % 2:
            folded[..., :1, :] ^= x[..., 2 * half :, :]
        x = folded
    return x[..., 0, :]


def _word_mixes(w64: torch.Tensor, gidx: torch.Tensor):
    key = _mix((gidx * int(_C1) + 1) & MASK32)
    m1 = _mix(((w64 ^ key) * int(_M1)) & MASK32)
    m2 = _mix((((w64 + key) & MASK32) * int(_M2)) & MASK32)
    return m1, m2


def tile_partials(words: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Un-finalized partials of a contiguous chunk over the LAST axis.

    words: (..., w) int32 with w a multiple of 4; ``offset`` is the
    global word index of the chunk start (a multiple of 4).  Returns
    (..., 8) int32: 4 partials of the m1 mix then 4 of m2.  XOR-fold
    the partials of all chunks, then apply finalize_partials."""
    n = words.shape[-1]
    if n % _PARTS or offset % _PARTS:
        raise ValueError(f"word count {n} must be a multiple of {_PARTS}")
    gidx = torch.arange(
        offset, offset + n, dtype=torch.int64, device=words.device
    )
    m1, m2 = _word_mixes(to_u32(words), gidx)
    return from_u32(
        torch.cat([_xor_fold_parts(m1), _xor_fold_parts(m2)], dim=-1)
    )


def finalize_partials(partials: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Length-fold of XOR-combined partials: (..., 8) -> (..., 8).

    Mind the precedence of the reference (hash.py:93,186-188):
    ``out ^ (lenmix + iota(8))``, all mod 2^32."""
    lenmix = (int(nbytes) * int(_C1)) & MASK32
    fold = (
        lenmix + torch.arange(8, dtype=torch.int64, device=partials.device)
    ) & MASK32
    return from_u32(_mix(to_u32(partials) ^ fold))


def phash256_words_batched(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Digest over the LAST axis: (..., w) int32 -> (..., 8) int32."""
    return finalize_partials(tile_partials(words, 0), nbytes)
