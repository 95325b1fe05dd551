"""Fused erasure data-plane steps: one device pass per stripe batch.

The reference's PutObject hot loop does RS-encode on CPU and then streams
each shard through a HighwayHash writer (cmd/erasure-encode.go:73-109 +
cmd/bitrot-streaming.go:38-88) - two passes over every byte.  Here both
happen in one fused device pass per batch (the encode_pack kernel), and
only the 32-byte digests must come back to the host eagerly.

Layout contract: the device works on int32 tensors that reinterpret the
little-endian u32 "words" (4 field elements per lane).  Byte views
happen on the host, where numpy's .view() is free: use
host_bytes_to_words / host_words_to_bytes at the boundary, and
words_to_tensor / tensor_to_words to cross it.

Every step dispatches on its tensor's device through the kernel
wrappers of ops/kernels.py: the hand-written CUDA kernel on the card,
the plain PyTorch version on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import gf, kernels


def host_bytes_to_words(a: np.ndarray) -> np.ndarray:
    """(..., L) uint8 -> (..., L//4) uint32 view (host, zero-copy)."""
    if a.dtype != np.uint8 or a.shape[-1] % 4:
        raise ValueError("expected uint8 rows whose length is a multiple of 4")
    a = np.ascontiguousarray(a)
    return a.view(np.uint32)


def host_words_to_bytes(a: np.ndarray) -> np.ndarray:
    """(..., w) uint32 -> (..., 4w) uint8 view (host, zero-copy)."""
    if a.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {a.dtype}")
    return np.ascontiguousarray(a).view(np.uint8)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """(..., w) uint32 host words -> int32 tensor with the same bits on
    ``device`` (zero-copy on the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    return t.to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> (..., w) uint32 host words (the D2H seam)."""
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Knobs of the JAX package that this port does not carry yet.  Each one,
# set to a non-default value, raises instead of being ignored.
# ---------------------------------------------------------------------------


def codec_kernel_mode() -> str:
    """MINIO_TPU_CODEC_KERNEL: only ``fused1`` (the default) is ported."""
    v = os.environ.get("MINIO_TPU_CODEC_KERNEL", "fused1").strip().lower()
    if v == "legacy":
        raise NotImplementedError(
            "MINIO_TPU_CODEC_KERNEL=legacy (the three-pass encode with "
            "group_flags/pack_nonzero_groups at drain) is ported in slice 9"
        )
    return "fused1"


def codec_formulation() -> str:
    """MINIO_TPU_CODEC_FORMULATION: only ``swar`` (the default) is ported."""
    v = os.environ.get("MINIO_TPU_CODEC_FORMULATION", "swar").strip().lower()
    if v == "mxu":
        raise NotImplementedError(
            "MINIO_TPU_CODEC_FORMULATION=mxu (gf_matmul_mxu, a tensor-core "
            "GF(2) product) is ported in slice 9"
        )
    return "swar"


def codec_overlap_mode() -> str:
    """MINIO_TPU_CODEC_OVERLAP: only ``off`` (the default) is ported."""
    v = os.environ.get("MINIO_TPU_CODEC_OVERLAP", "").strip().lower()
    if v in ("pipeline", "async"):
        raise NotImplementedError(
            f"MINIO_TPU_CODEC_OVERLAP={v} (the transfer/compute overlap "
            "pipeline) is ported in slice 9"
        )
    return "off"


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def encode_words_fused1(
    words: torch.Tensor, parity_shards: int, shard_len: int, group: int = 0
):
    """PUT codec step: parity + digests + occupancy + pack in one pass.

    words: (B, k, w) int32.  Returns (parity (B, m, w) int32, digests
    (B, n, 8) int32 finalized, flags (B, m, g) bool, packed (B, m, w)
    int32) with g = w // group; group == 0 disables the pack leg (flags
    has g == 0, packed is parity).  Only ``digests`` should be read back
    eagerly; parity/flags/packed stay device-resident until drain.
    """
    batch, k, w = words.shape
    if shard_len != 4 * w:
        raise ValueError("shard_len must equal 4 * words-per-shard")
    if w % 8:
        raise ValueError("words per shard must be a multiple of 8")
    if group and w % group:
        raise ValueError("words per shard must be a multiple of group")
    parity, digests, flags, packed = kernels.encode_pack(
        words, parity_shards, shard_len, group
    )
    return parity, digests, flags != 0, packed


def reconstruct_words_batch(
    shards: torch.Tensor,
    present: "tuple[bool, ...]",
    data_shards: int,
    parity_shards: int,
) -> torch.Tensor:
    """Static-pattern batched reconstruct: (B, n, w) -> (B, k, w) words.

    Column-locality makes the whole batch one product of the pattern's
    inverted sub-matrix with the first k present rows (rows where
    present is False hold garbage and are ignored)."""
    k, m = data_shards, parity_shards
    idx = [i for i, p in enumerate(present) if p][:k]
    if len(idx) < k:
        raise ValueError(f"need {k} shards, have {len(idx)}")
    rm = gf.reconstruction_matrix(k, m, tuple(idx))
    return kernels.gf_matmul_words(rm, shards, tuple(idx))


def digest_words_batched(words: torch.Tensor, shard_len: int) -> torch.Tensor:
    """Batched bitrot digest: (..., w) int32 -> (..., 8) int32."""
    return kernels.phash256_batched(words, shard_len)
