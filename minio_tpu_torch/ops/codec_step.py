"""Fused erasure data-plane steps: one device pass per stripe batch.

The reference's PutObject hot loop does RS-encode on CPU and then streams
each shard through a HighwayHash writer (cmd/erasure-encode.go:73-109 +
cmd/bitrot-streaming.go:38-88) - two passes over every byte.  Here both
happen in one fused device pass per batch (the encode_pack kernel), and
only the 32-byte digests must come back to the host eagerly.  Heal's
read side is fused the same way: one verify_reconstruct pass hashes the
survivors and rebuilds the data rows.

Layout contract: the device works on int32 tensors that reinterpret the
little-endian u32 "words" (4 field elements per lane).  Byte views
happen on the host, where numpy's .view() is free: use
host_bytes_to_words / host_words_to_bytes at the boundary, and
words_to_tensor / tensor_to_words to cross it.

Every step dispatches on its tensor's device through the kernel
wrappers of ops/kernels.py: the hand-written CUDA kernel on the card,
the plain PyTorch version on the CPU.  MINIO_TPU_CODEC_OVERLAP picks the
kernel of the PUT and heal passes, or splits them into sub-chunks
(codec_overlap_mode); MINIO_TPU_CODEC_FORMULATION picks the GF(2^8)
product inside those two passes (codec_formulation);
MINIO_TPU_CODEC_KERNEL=legacy replaces both with the pre-fusion passes
(codec_kernel_mode: the PUT pass without the pack leg, then group_flags
and pack_nonzero_groups at drain).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import gf, kernels, rs


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
# The codec knobs of the JAX package.  A value this port does not carry
# yet raises instead of being ignored.
# ---------------------------------------------------------------------------


def codec_kernel_mode() -> str:
    """MINIO_TPU_CODEC_KERNEL: ``fused1`` (default) or ``legacy``.

    ``legacy`` is the bisection oracle: the exact pre-fusion pass
    structure (the digest encode pass, then group_flags and
    pack_nonzero_groups at drain; verify, then reconstruct on heal) with
    byte-identical outputs, whatever the overlap mode or formulation.
    Flip it to attribute a regression to the fused kernels or to
    everything around them.  Unknown values resolve to ``fused1``."""
    v = os.environ.get("MINIO_TPU_CODEC_KERNEL", "fused1").strip().lower()
    return v if v in ("fused1", "legacy") else "fused1"


def codec_formulation() -> str:
    """MINIO_TPU_CODEC_FORMULATION: ``swar`` (default) or ``mxu``.

    Picks the GF(2^8) product inside the PUT pass (encode_words_fused1)
    and heal's read pass (verify_and_reconstruct_words): the xtime chain
    or the tensor-core product of the lifted GF(2) bit matrix (ops/rs.py
    module doc).  Both are bit-exact.  Heal's re-encode, the degraded-GET
    reconstruct and the async sub-chunk chain take no formulation, as in
    the JAX package.  Unknown values resolve to ``swar``."""
    v = os.environ.get("MINIO_TPU_CODEC_FORMULATION", "swar").strip().lower()
    return v if v in rs.FORMULATIONS else "swar"


def codec_overlap_mode(device=None) -> str:
    """MINIO_TPU_CODEC_OVERLAP: ``pipeline`` | ``async`` | ``off``.

    * ``pipeline``: the PUT and heal passes run the pipelined kernels
      (K5 encode_pack_pipelined, K6 verify_reconstruct_pipelined), still
      one kernel pass per direction.
    * ``async``: the backend splits the stripe batch along w into S
      sub-chunks and chains them through pinned ping-pong staging on a
      copy stream, so chunk s+1's H2D overlaps chunk s's pass, which
      overlaps chunk s-1's D2H (encode_subchunk_words /
      verify_reconstruct_subchunk_words).  S passes per direction.
    * ``off``: the serialized path (K1 / K4).

    An explicit value wins.  Unset (or unknown), it follows the codec's
    ``device`` as the JAX package follows its backend: ``pipeline`` on
    CUDA, ``off`` elsewhere.
    """
    v = os.environ.get("MINIO_TPU_CODEC_OVERLAP", "").strip().lower()
    if v in ("pipeline", "async", "off"):
        return v
    if device is not None and torch.device(device).type == "cuda":
        return "pipeline"
    return "off"


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def encode_words_fused1(
    words: torch.Tensor, parity_shards: int, shard_len: int, group: int = 0,
    pipeline: bool = False, formulation: str = "swar",
):
    """PUT codec step: parity + digests + occupancy + pack in one pass.

    words: (B, k, w) int32.  Returns (parity (B, m, w) int32, digests
    (B, n, 8) int32 finalized, flags (B, m, g) bool, packed (B, m, w)
    int32) with g = w // group; group == 0 disables the pack leg (flags
    has g == 0, packed is parity).  Only ``digests`` should be read back
    eagerly; parity/flags/packed stay device-resident until drain.
    ``pipeline`` runs encode_pack_pipelined (K5) instead of encode_pack
    (K1), except at m == 0, which K1 serves as in the JAX package.
    ``formulation`` (``swar`` | ``mxu``) picks the kernel's product.
    """
    batch, k, w = words.shape
    if shard_len != 4 * w:
        raise ValueError("shard_len must equal 4 * words-per-shard")
    if w % 8:
        raise ValueError("words per shard must be a multiple of 8")
    if group and w % group:
        raise ValueError("words per shard must be a multiple of group")
    enc = (
        kernels.encode_pack_pipelined
        if pipeline and parity_shards > 0
        else kernels.encode_pack
    )
    parity, digests, flags, packed = enc(
        words, parity_shards, shard_len, group, formulation
    )
    return parity, digests, flags != 0, packed


def group_flags(words: torch.Tensor, group: int) -> torch.Tensor:
    """Per-group nonzero flags: (..., w) int32 -> (..., w // group) int32
    0/1 (the JAX package's bool as 0/1, the convention of K1's flags).

    The legacy drain's compressibility screen: reading the flags costs
    one word per ``group`` words, and mostly-zero flags mean
    pack_nonzero_groups can shrink the parity D2H."""
    return kernels.group_flags(words, group)


def pack_nonzero_groups(words: torch.Tensor, group: int):
    """The legacy drain's pack pass: (..., w) int32 -> (flags (..., g)
    int32 0/1, packed (..., w) int32), g = w // group.  Within each row
    the nonzero groups keep their relative order at the front and zero
    groups follow, so the host pulls ``flags`` plus the first kept groups
    and scatters them back (codec/compress.py unpack_nonzero_groups)."""
    return kernels.pack_nonzero_groups(words, group)


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


def verify_and_reconstruct_words(
    shards: torch.Tensor,
    digests: torch.Tensor,
    present: "tuple[bool, ...]",
    data_shards: int,
    parity_shards: int,
    shard_len: int,
    pipeline: bool = False,
    formulation: str = "swar",
):
    """Heal codec step: digest-verify + reconstruct in ONE pass.

    shards: (B, n, w) int32 as read (absent rows hold garbage); digests:
    (B, n, 8) int32 stored; present: per-row availability.  Returns (data
    (B, k, w) int32 rebuilt from the first k present rows, ok (B, n) bool
    = digest match AND present).  The caller rechecks ok over its chosen
    survivors and re-solves the stripes where one was corrupt (backend
    reconstruct_and_verify escalation).  ``pipeline`` runs
    verify_reconstruct_pipelined (K6) instead of verify_reconstruct (K4);
    ``formulation`` (``swar`` | ``mxu``) picks the kernel's product."""
    k = data_shards
    n = shards.shape[1]
    if n != k + parity_shards:
        raise ValueError("shard rows must equal k + m")
    if shard_len != 4 * shards.shape[-1]:
        raise ValueError("shard_len must equal 4 * words-per-shard")
    vr = (
        kernels.verify_reconstruct_pipelined
        if pipeline
        else kernels.verify_reconstruct
    )
    data, got = vr(shards, present, k, shard_len, formulation)
    return data, _ok_mask(got, digests, present)


def _ok_mask(got, digests, present) -> torch.Tensor:
    pres = torch.tensor(present, dtype=torch.bool, device=got.device)
    return (got == digests).all(dim=-1) & pres


# ---------------------------------------------------------------------------
# Sub-chunk steps of the async overlap chain (MINIO_TPU_CODEC_OVERLAP=async)
# ---------------------------------------------------------------------------
#
# The backend splits a stripe batch along w into S sub-chunks.  RS parity
# is column-local, so per-chunk parity is exact; the phash256 partials
# XOR-accumulate across chunks in a (B, n, 8) accumulator whose hash key
# uses the GLOBAL word offset, and the last chunk finalizes them in its
# own launch.  The JAX package donates the accumulator into each step;
# here each step updates it in place.


def encode_subchunk_words(
    chunk: torch.Tensor,
    acc: torch.Tensor,
    word_offset: int,
    parity_shards: int,
    shard_len: int,
    group: int = 0,
    finalize: bool = False,
):
    """One PUT sub-chunk: parity + hash partials (+ flags/pack) of a
    (B, k, cw) int32 slice of the stripe batch at global ``word_offset``.

    ``acc`` (B, n, 8) int32 is updated IN PLACE: the chunk's partials are
    XORed in, and with ``finalize`` (the last chunk) it then holds the
    finalized digests.  Returns (parity (B, m, cw), acc, flags (B, m,
    gc) bool, packed (B, m, cw)); group == 0 disables the pack leg as in
    encode_words_fused1.  ``shard_len`` is the FULL row's byte length
    (the digest length fold), not the chunk's.
    """
    _b, _k, cw = chunk.shape
    if cw % 8:
        raise ValueError("chunk words must be a multiple of 8")
    if group and cw % group:
        raise ValueError("chunk words must be a multiple of group")
    parity, acc, flags, packed = kernels.encode_pack_subchunk(
        chunk, acc, word_offset, parity_shards, shard_len, group, finalize
    )
    return parity, acc, flags != 0, packed


def verify_reconstruct_subchunk_words(
    chunk: torch.Tensor,
    acc: torch.Tensor,
    digests: torch.Tensor,
    word_offset: int,
    present: "tuple[bool, ...]",
    data_shards: int,
    parity_shards: int,
    shard_len: int,
    finalize: bool = False,
):
    """One heal sub-chunk: reconstruct a (B, n, cw) slice of the shard
    rows AND accumulate the verify partials into ``acc`` (B, n, 8),
    IN PLACE (finalized on the ``finalize`` chunk).

    Returns (data (B, k, cw) int32, acc, ok (B, n) bool).  ``ok`` is
    meaningful only on the ``finalize`` call (digest match of the WHOLE
    row AND present); earlier chunks return all-False.
    """
    B, n, _cw = chunk.shape
    if n != data_shards + parity_shards:
        raise ValueError("shard rows must equal k + m")
    data, acc = kernels.verify_reconstruct_subchunk(
        chunk, acc, word_offset, present, data_shards, shard_len, finalize
    )
    if finalize:
        return data, acc, _ok_mask(acc, digests, present)
    return data, acc, torch.zeros((B, n), dtype=torch.bool, device=chunk.device)


def digest_words_batched(words: torch.Tensor, shard_len: int) -> torch.Tensor:
    """Batched bitrot digest: (..., w) int32 -> (..., 8) int32."""
    return kernels.phash256_batched(words, shard_len)
