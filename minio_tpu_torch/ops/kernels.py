"""The codec's CUDA kernels: build, binding, and the dispatching wrappers.

Seven kernels, all in ``csrc/codec.cu`` (CUDA C++ for ``sm_90a``):

* ``encode_pack`` (K1) replaces ``rs_pallas.encode_pack_fused`` (P4):
  parity + phash256 partials of all n rows + per-256-word occupancy
  flags + the nonzero-group prefix pack, plus the digest finalize.  With
  ``group=0`` it also computes ``rs_pallas.encode_hash_fused`` (P2),
  heal's re-encode.  ``encode_pack_subchunk`` is its sub-chunk form, the
  GPU body of ``codec_step.encode_subchunk_words`` (X2, left to XLA by
  the JAX package): a chunk at a global word offset, XOR-accumulating
  into the caller's partials, finalizing only on the last chunk.
* ``phash256_batched`` (K2) replaces ``hash.phash256_words_batched``
  (X1, left to XLA by the JAX package): (R, w) rows -> (R, 8) digests,
  in one launch that finalizes in its last block.
* ``gf_matmul_words`` (K3) replaces ``rs_pallas.matmul_words`` (P1): a
  runtime (o, s) GF(2^8) matrix over s selected rows of a (B, R, w)
  batch -> (B, o, w).
* ``verify_reconstruct`` (K4) replaces ``rs_pallas.verify_reconstruct_fused``
  (P5): finalized digests of the present rows of a (B, n, w) batch and
  the k data rows rebuilt from the first k present rows, in one pass.
  ``verify_reconstruct_subchunk`` is its sub-chunk form, the GPU body of
  ``codec_step.verify_reconstruct_subchunk_words`` (X3).
* ``encode_pack_pipelined`` (K5) replaces ``rs_pallas.encode_pack_pipelined``
  (P6) and ``verify_reconstruct_pipelined`` (K6) replaces
  ``rs_pallas.verify_reconstruct_pipelined`` (P7): K1's and K4's
  functions on a persistent grid that stages tiles into a shared-memory
  ring with ``cp.async`` and finalizes in its last block.  K6 copies the
  present data rows and rebuilds the others from a term program made
  once per (present, k) (``vr_terms``).
* ``gf_matmul_mxu`` (K7) replaces ``rs_pallas.gf_matmul_mxu`` (P3): a
  runtime (o, s) GF(2^8) matrix over (s, length) uint8 shards through a
  1-bit tensor-core product of the lifted (8o, 8s) GF(2) matrix.

``formulation="mxu"`` (MINIO_TPU_CODEC_FORMULATION) on K1, K4, K5 and K6
swaps their xtime chain for the same tensor-core product (the ``mxu``
instantiations), as ``_mxu_rows`` replaces ``_swar_rows`` inside P4-P7;
everything around the product is unchanged, so their outputs are bit for
bit the ``swar`` ones.  The lifted matrix reaches the kernel as a small
device tensor in the product's operand order (``_mxu_operand``), cached
per matrix and device.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``minio_tpu_torch/build/`` at first use, keyed by a hash of the sources
and flags, loaded with ctypes.  Nothing is built or imported from CUDA
when this module is imported.

Each wrapper takes int32 tensors that reinterpret u32 words.  For a CPU
tensor it runs the kernel's plain PyTorch version (``*_plain``, built on
ops/rs.py and ops/hash.py); for a CUDA tensor it launches the kernel on
``torch.cuda.current_stream()`` or raises - a failed build, a refused
launch (non-zero ``cudaGetLastError()``) or a wrong device, dtype, shape
or layout never falls back.  ``LAUNCHES`` counts kernel launches per
wrapper (never plain runs): ``encode_pack[group=0]`` counts the K1
launches without the pack leg among ``encode_pack``'s, and the two
``[subchunk]`` names count the sub-chunk forms and the four ``[mxu]``
names the ``mxu`` instantiations, which the base names do not;
``reset_launches`` zeroes it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import gf, hash as phash, rs

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "codec.cu",)
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

TILE = 256  # columns per block tile == PARITY_GROUP_WORDS
_MAX_ROWS = 16
_TARGET_BLOCKS = 132 * 8  # enough resident blocks to fill the SMs

_PIPE_BLOCKS_PER_SM = 2  # K5/K6 residency (kPipeBlocksPerSM in codec.cu)
_PHASH_ROWS = 4  # rows per K2 block (kPhashRows: the entry refuses another)
_PHASH_BLOCKS_PER_SM = 2  # K2's one-wave grid

LAUNCHES = {
    "encode_pack": 0, "encode_pack[group=0]": 0, "encode_pack[subchunk]": 0,
    "phash256_batched": 0, "gf_matmul_words": 0, "verify_reconstruct": 0,
    "verify_reconstruct[subchunk]": 0, "encode_pack_pipelined": 0,
    "verify_reconstruct_pipelined": 0, "gf_matmul_mxu": 0,
    "encode_pack[mxu]": 0, "verify_reconstruct[mxu]": 0,
    "encode_pack_pipelined[mxu]": 0, "verify_reconstruct_pipelined[mxu]": 0,
}
_count_lk = threading.Lock()

_lib = None
_lib_lk = threading.Lock()
BUILD_INFO: dict = {}


def reset_launches() -> None:
    with _count_lk:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lk:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# build + binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _fingerprint() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library
    path.  Raises RuntimeError with the compiler's output on failure."""
    out = BUILD_DIR / f"libmtt_codec-{_fingerprint()}.so"
    if out.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.monotonic() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lk:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            # the pointer before the stream of the four codec passes is
            # the mxu operand (None: the swar instantiation)
            lib.mtt_encode_pack.argtypes = [
                I, P, P, P, P, P, I, I, I, I, I, U, U, I, I, P, P, P, P,
            ]
            lib.mtt_encode_pack_pipelined.argtypes = [
                I, P, P, P, P, P, P, I, I, I, I, I, U, I, P, P, P, P,
            ]
            lib.mtt_phash256.argtypes = [I, P, P, I, I, U, I, I, P]
            lib.mtt_gf_matmul.argtypes = [I, P, P, I, I, I, I, I, P, P, P, P]
            lib.mtt_verify_reconstruct.argtypes = [
                I, P, P, P, I, I, I, I, U, U, U, I, I, P, P, P, P,
            ]
            lib.mtt_verify_reconstruct_pipelined.argtypes = [
                I, P, P, P, I, I, I, I, U, U, I, P, I, I, P, P,
            ]
            lib.mtt_gf_matmul_mxu.argtypes = [I, P, P, I, I, I, P, P]
            for fn in (lib.mtt_encode_pack, lib.mtt_encode_pack_pipelined,
                       lib.mtt_phash256, lib.mtt_gf_matmul,
                       lib.mtt_verify_reconstruct,
                       lib.mtt_verify_reconstruct_pipelined,
                       lib.mtt_gf_matmul_mxu):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _require_cuda(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _require_aligned(t: torch.Tensor, name: str) -> None:
    """The pipelined kernels stage rows with 16-byte copies."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's device (the call
    torch's own generated kernels use: no Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _rows_view(acc: torch.Tensor, lead: "tuple[int, ...]") -> torch.Tensor:
    """The first prod(lead) * 8 words of ``acc`` as a contiguous (*lead,
    8) view, in one call (a slice and a view cost twice the host time)."""
    shape = (*lead, 8)
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    return acc.as_strided(shape, tuple(reversed(strides)))


def _tiles_per_block(ntiles: int, rows: int) -> int:
    """Tiles a block walks: enough blocks to fill the card, and fewer
    global atomics per digest word as the grid grows."""
    return max(1, min(8, (ntiles * rows) // _TARGET_BLOCKS))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def pipelined_grid(B: int, w: int, sms: int) -> "tuple[int, int]":
    """(tiles per block, blocks per stripe) of K5/K6's persistent grid:
    about ``_PIPE_BLOCKS_PER_SM`` blocks per SM split evenly over the B
    stripes, each block a contiguous run of 256-column tiles."""
    ntiles = -(-w // TILE)
    resident = sms * _PIPE_BLOCKS_PER_SM
    per_stripe = min(ntiles, max(1, -(-resident // B)))
    tpb = -(-ntiles // per_stripe)
    return tpb, -(-ntiles // tpb)


def pipeline_windows(B: int, w: int, sms: int) -> int:
    """Overlap windows of one K5/K6 launch: the tile computes during
    which a later tile's copy was in flight.  A block walking c tiles
    has c - 1 of them, so the launch has B * (ntiles - blocks per
    stripe)."""
    _tpb, per_stripe = pipelined_grid(B, w, sms)
    return B * (-(-w // TILE) - per_stripe)


@functools.lru_cache(maxsize=1024)
def phash_grid(R: int, w: int, sms: int) -> int:
    """Tiles (of 256 column quads) per K2 block: one wave of
    ``_PHASH_BLOCKS_PER_SM`` blocks per SM over the quad tiles of every
    group of ``_PHASH_ROWS`` rows."""
    tiles = -(-(w // 4) // TILE)
    blocks = -(-R // _PHASH_ROWS) * tiles
    return max(1, min(tiles, -(-blocks // (sms * _PHASH_BLOCKS_PER_SM))))


@functools.lru_cache(maxsize=256)
def _plan(matrix_key: bytes, o: int, s: int, rows: "tuple[int, ...]"):
    """ctypes buffers of the kernels' GfPlan for one (o, s) matrix."""
    matrix = np.frombuffer(matrix_key, dtype=np.uint8).reshape(o, s)
    rm = np.zeros(_MAX_ROWS * 8, dtype=np.uint16)
    for c in range(s):
        for b in range(8):
            bits = 0
            for r in range(o):
                if (int(matrix[r, c]) >> b) & 1:
                    bits |= 1 << r
            rm[c * 8 + b] = bits
    nb = np.zeros(_MAX_ROWS, dtype=np.uint8)
    nb[:s] = rs.need_bits(matrix)
    row = np.zeros(_MAX_ROWS, dtype=np.uint8)
    row[: len(rows)] = rows
    return (
        (ctypes.c_uint16 * len(rm))(*rm.tolist()),
        (ctypes.c_uint8 * len(nb))(*nb.tolist()),
        (ctypes.c_uint8 * len(row))(*row.tolist()),
    )


def _matrix_plan(matrix: np.ndarray, rows: "tuple[int, ...]"):
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _plan(m.tobytes(), m.shape[0], m.shape[1], tuple(rows))


def mxu_fragments(matrix: np.ndarray) -> np.ndarray:
    """The lifted (8o, 8s) bit matrix of ``matrix`` (rs.bit_matrix) in the
    A-operand order of the kernels' ``mma.m16n8k128`` on 1-bit values:
    (8 m-tiles, 32 lanes, 2) uint32.  M-tile t covers output rows 2t and
    2t + 1; lane = tig + 4 g holds in word 0 the row for bit g % 4 of
    output row 2t + g // 4 and in word 1 the row for bit g % 4 + 4, each
    over the inputs' bits k in [32 tig, 32 tig + 32) (bit i: k = 32 tig +
    i, so input row 4 tig + i // 8, bit i % 8).  Rows and inputs past
    (o, s) are zero, up to 16 x 16."""
    o, s = matrix.shape
    full = np.zeros((8 * _MAX_ROWS, 8 * _MAX_ROWS), dtype=np.uint8)
    full[: 8 * o, : 8 * s] = rs.bit_matrix(matrix)
    packed = np.packbits(full, axis=1, bitorder="little").view("<u4")
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    row = 8 * (2 * np.arange(_MAX_ROWS // 2)[:, None] + (g >> 2)) + (g & 3)
    return np.stack([packed[row, tig], packed[row + 4, tig]], axis=-1).astype(
        np.uint32
    )


@functools.lru_cache(maxsize=64)
def _mxu_tensor(matrix_key: bytes, o: int, s: int, device: str) -> torch.Tensor:
    matrix = np.frombuffer(matrix_key, dtype=np.uint8).reshape(o, s)
    frags = np.ascontiguousarray(mxu_fragments(matrix)).view(np.int32)
    return torch.from_numpy(frags).to(device)


def _mxu_operand(matrix: np.ndarray, device: torch.device) -> torch.Tensor:
    """mxu_fragments(matrix) as a device tensor, made once per matrix and
    device (the kernels read it from global memory: at 16 rows the
    operand is 2 KiB, the kernel parameters already hold the GfPlan)."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _mxu_tensor(m.tobytes(), m.shape[0], m.shape[1], str(device))


# ---------------------------------------------------------------------------
# K1 encode_pack
# ---------------------------------------------------------------------------


def _flags_and_pack(parity: torch.Tensor, group: int):
    """Plain occupancy flags (B, m, w // group) int32 and the full-row
    prefix pack of a parity plane: nonzero groups first, in order, then
    zeros."""
    B, m, w = parity.shape
    if not group:
        empty = torch.zeros((B, m, 0), dtype=torch.int32, device=parity.device)
        return empty, parity
    g = w // group
    grouped = parity.reshape(B, m, g, group)
    flags = (grouped != 0).any(dim=-1)
    idx = torch.arange(g, dtype=torch.int64, device=parity.device)
    key = torch.where(flags, 0, g) + idx  # unique keys: nonzero groups first
    order = torch.argsort(key, dim=-1)
    packed = torch.take_along_dim(
        grouped, order[..., None].expand(B, m, g, group), dim=-2
    ).reshape(B, m, w)
    return flags.to(torch.int32), packed


def encode_pack_plain(words: torch.Tensor, parity_shards: int,
                      shard_len: int, group: int = 0,
                      formulation: str = "swar"):
    """Plain version of encode_pack (any device): the portable path of
    codec_step.encode_words_fused1 in the JAX package, with the product
    of ``formulation``."""
    parity = rs.encode_words(words, parity_shards, formulation)
    digests = phash.phash256_words_batched(
        torch.cat([words, parity], dim=1), shard_len
    )
    flags, packed = _flags_and_pack(parity, group)
    return parity, digests, flags, packed


def _check_group(group: int, w: int) -> None:
    if group not in (0, TILE) or (group and w % group):
        raise ValueError(f"group must be 0 or {TILE} dividing w, got {group}")


def encode_pack(words: torch.Tensor, parity_shards: int, shard_len: int,
                group: int = 0, formulation: str = "swar"):
    """(B, k, w) data words -> (parity (B, m, w), digests (B, k+m, 8)
    finalized, flags (B, m, w//group) 0/1, packed (B, m, w)), all int32.
    group == 0 disables the pack leg (flags has g == 0, packed is
    parity); otherwise group must be 256 and divide w.  ``formulation``
    picks the product (``swar`` or ``mxu``); the outputs are the same."""
    B, k, w = words.shape
    m = parity_shards
    _check_group(group, w)
    rs.check_formulation(formulation)
    if words.device.type == "cpu":
        return encode_pack_plain(words, m, shard_len, group, formulation)
    _require_cuda(words, "encode_pack", 3)
    digests = torch.zeros((B, k + m, 8), dtype=torch.int32, device=words.device)
    out = _launch_encode_pack(words, digests, 0, m, shard_len, group, True,
                              formulation)
    if formulation == "mxu":
        _count("encode_pack[mxu]")
        return out
    _count("encode_pack")
    if not group:
        _count("encode_pack[group=0]")
    return out


def _launch_encode_pack(words, partials, word_offset, m, shard_len, group,
                        finalize, formulation="swar"):
    """K1 on checked CUDA words, XORing into ``partials``."""
    B, k, w = words.shape
    if not (1 <= k <= _MAX_ROWS and 0 <= m <= _MAX_ROWS):
        raise ValueError(f"encode_pack supports k, m <= {_MAX_ROWS}")
    lib = _load()
    dev = words.device
    parity = torch.empty((B, m, w), dtype=torch.int32, device=dev)
    g = w // TILE if group else 0
    flags = torch.empty((B, m, g), dtype=torch.int32, device=dev)
    packed = torch.empty_like(parity) if group else parity
    pm = gf.parity_matrix(k, m)
    rm, nb, _row = _matrix_plan(pm, ())
    amat = _mxu_operand(pm, dev).data_ptr() if formulation == "mxu" else None
    ntiles = -(-w // TILE)
    rc = lib.mtt_encode_pack(
        dev.index or 0, words.data_ptr(), parity.data_ptr(),
        partials.data_ptr(), flags.data_ptr(), packed.data_ptr(),
        B, k, m, w, group, shard_len & 0xFFFFFFFF, word_offset & 0xFFFFFFFF,
        int(finalize), _tiles_per_block(ntiles, B), rm, nb, amat,
        _stream(words),
    )
    _check_rc(rc, "encode_pack")
    return parity, partials, flags, packed


def encode_pack_subchunk_plain(chunk: torch.Tensor, acc: torch.Tensor,
                               word_offset: int, parity_shards: int,
                               shard_len: int, group: int = 0,
                               finalize: bool = False):
    """Plain version of encode_pack_subchunk (any device): the function
    of codec_step.encode_subchunk_words in the JAX package, with ``acc``
    updated in place."""
    parity = rs.encode_words(chunk, parity_shards)
    acc ^= phash.tile_partials(torch.cat([chunk, parity], dim=1), word_offset)
    if finalize:
        acc.copy_(phash.finalize_partials(acc, shard_len))
    flags, packed = _flags_and_pack(parity, group)
    return parity, acc, flags, packed


def encode_pack_subchunk(chunk: torch.Tensor, acc: torch.Tensor,
                         word_offset: int, parity_shards: int,
                         shard_len: int, group: int = 0,
                         finalize: bool = False):
    """K1 on one (B, k, cw) sub-chunk whose first word is column
    ``word_offset`` of the row: (parity (B, m, cw), acc, flags (B, m,
    cw//group), packed (B, m, cw)).  The chunk's phash256 partials are
    XORed into ``acc`` (B, k+m, 8) IN PLACE; with ``finalize`` acc then
    holds the finalized digests of the whole row of ``shard_len``
    bytes."""
    B, k, cw = chunk.shape
    m = parity_shards
    _check_group(group, cw)
    if word_offset % 4:
        raise ValueError(f"word_offset {word_offset} must be a multiple of 4")
    if tuple(acc.shape) != (B, k + m, 8):
        raise ValueError(f"acc must be {(B, k + m, 8)}, got {tuple(acc.shape)}")
    if chunk.device.type == "cpu":
        return encode_pack_subchunk_plain(
            chunk, acc, word_offset, m, shard_len, group, finalize
        )
    _require_cuda(chunk, "encode_pack_subchunk", 3)
    _require_cuda(acc, "encode_pack_subchunk acc", 3)
    out = _launch_encode_pack(
        chunk, acc, word_offset, m, shard_len, group, finalize
    )
    _count("encode_pack[subchunk]")
    return out


# ---------------------------------------------------------------------------
# K5 encode_pack_pipelined
# ---------------------------------------------------------------------------


def encode_pack_pipelined_plain(words: torch.Tensor, parity_shards: int,
                                shard_len: int, group: int = 0,
                                formulation: str = "swar"):
    """Plain version of encode_pack_pipelined: P6 computes P4's
    function, so this is encode_pack_plain."""
    return encode_pack_plain(words, parity_shards, shard_len, group,
                             formulation)


def encode_pack_pipelined(words: torch.Tensor, parity_shards: int,
                          shard_len: int, group: int = 0,
                          formulation: str = "swar"):
    """K5: encode_pack's outputs, bit for bit, from the pipelined kernel
    (persistent grid, cp.async tile ring, last-block finalize).  Needs
    parity_shards >= 1, as P6 does, and w % 4 == 0."""
    B, k, w = words.shape
    m = parity_shards
    _check_group(group, w)
    rs.check_formulation(formulation)
    if m < 1:
        raise ValueError("encode_pack_pipelined needs parity_shards >= 1")
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")
    if words.device.type == "cpu":
        return encode_pack_pipelined_plain(words, m, shard_len, group,
                                           formulation)
    _require_cuda(words, "encode_pack_pipelined", 3)
    _require_aligned(words, "encode_pack_pipelined")
    if not (1 <= k <= _MAX_ROWS and m <= _MAX_ROWS):
        raise ValueError(f"encode_pack_pipelined supports k, m <= {_MAX_ROWS}")
    lib = _load()
    dev = words.device
    n = k + m
    parity = torch.empty((B, m, w), dtype=torch.int32, device=dev)
    # the digests and the last-block ticket share one zeroed allocation
    acc = torch.zeros(B * n * 8 + 1, dtype=torch.int32, device=dev)
    digests = acc[:-1].view(B, n, 8)
    g = w // TILE if group else 0
    flags = torch.empty((B, m, g), dtype=torch.int32, device=dev)
    packed = torch.empty_like(parity) if group else parity
    pm = gf.parity_matrix(k, m)
    rm, nb, _row = _matrix_plan(pm, ())
    amat = _mxu_operand(pm, dev).data_ptr() if formulation == "mxu" else None
    tpb, _per_stripe = pipelined_grid(B, w, sm_count(dev))
    rc = lib.mtt_encode_pack_pipelined(
        dev.index or 0, words.data_ptr(), parity.data_ptr(),
        digests.data_ptr(), flags.data_ptr(), packed.data_ptr(),
        acc[-1:].data_ptr(), B, k, m, w, group, shard_len & 0xFFFFFFFF, tpb,
        rm, nb, amat, _stream(words),
    )
    _check_rc(rc, "encode_pack_pipelined")
    _count("encode_pack_pipelined[mxu]" if formulation == "mxu"
           else "encode_pack_pipelined")
    return parity, digests, flags, packed


# ---------------------------------------------------------------------------
# K2 phash256_batched
# ---------------------------------------------------------------------------


def phash256_batched(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Finalized phash256 over the LAST axis: (..., w) int32 -> (..., 8).
    On the card: one memset and one K2 launch, for every w % 4 == 0 and
    at most 65535 rows."""
    if words.device.type == "cpu":
        return phash.phash256_words_batched(words, nbytes)
    lead, w = tuple(words.shape[:-1]), words.shape[-1]
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")
    flat = words.reshape(-1, w)
    _require_cuda(flat, "phash256_batched", 2)
    R = flat.shape[0]
    if R > 65535:
        raise ValueError("phash256_batched: at most 65535 rows per launch")
    dev = words.device
    if R == 0:
        return torch.zeros((*lead, 8), dtype=torch.int32, device=dev)
    # the digests and the last-block ticket: one buffer the entry zeroes
    acc = torch.empty(R * 8 + 1, dtype=torch.int32, device=dev)
    out = _rows_view(acc, lead)
    rc = _load().mtt_phash256(
        dev.index, flat.data_ptr(), acc.data_ptr(), R, w,
        nbytes & 0xFFFFFFFF, _PHASH_ROWS, phash_grid(R, w, sm_count(dev)),
        _stream(flat),
    )
    _check_rc(rc, "phash256_batched")
    _count("phash256_batched")
    return out


# ---------------------------------------------------------------------------
# K3 gf_matmul_words
# ---------------------------------------------------------------------------


def gf_matmul_words(matrix: np.ndarray, words: torch.Tensor,
                    rows: "tuple[int, ...]") -> torch.Tensor:
    """(o, s) GF matrix over rows ``rows`` of (B, R, w) words -> (B, o, w)."""
    o, s = matrix.shape
    if len(rows) != s:
        raise ValueError(f"matrix wants {s} input rows, got {len(rows)}")
    if words.device.type == "cpu":
        return rs.gf_matmul_words(matrix, words, rows)
    _require_cuda(words, "gf_matmul_words", 3)
    B, R, w = words.shape
    if not (1 <= o <= _MAX_ROWS and 1 <= s <= _MAX_ROWS):
        raise ValueError(f"gf_matmul_words supports o, s <= {_MAX_ROWS}")
    if any(not 0 <= r < R for r in rows):
        raise ValueError(f"row index out of range for {R} rows: {rows}")
    out = torch.empty((B, o, w), dtype=torch.int32, device=words.device)
    if B == 0 or w == 0:
        return out
    rm, nb, row = _matrix_plan(matrix, tuple(int(r) for r in rows))
    rc = _load().mtt_gf_matmul(
        words.device.index or 0, words.data_ptr(), out.data_ptr(),
        B, R, w, o, s, rm, nb, row, _stream(words),
    )
    _check_rc(rc, "gf_matmul_words")
    _count("gf_matmul_words")
    return out


# ---------------------------------------------------------------------------
# K4 verify_reconstruct
# ---------------------------------------------------------------------------


def _survivors(present: "tuple[bool, ...]", k: int) -> "tuple[int, ...]":
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    if len(idx) < k:
        raise ValueError(f"need {k} shards, have {len(idx)}")
    return idx


def verify_reconstruct_plain(shards: torch.Tensor, present: "tuple[bool, ...]",
                             data_shards: int, shard_len: int,
                             formulation: str = "swar"):
    """Plain version of verify_reconstruct (any device): the portable path
    of codec_step.verify_and_reconstruct_words in the JAX package, with
    the partials of absent rows zeroed as the kernel leaves them and the
    product of ``formulation``."""
    acc = torch.zeros(
        (shards.shape[0], shards.shape[1], 8), dtype=torch.int32,
        device=shards.device,
    )
    return verify_reconstruct_subchunk_plain(
        shards, acc, 0, present, data_shards, shard_len, True, formulation
    )


def verify_reconstruct_subchunk_plain(chunk: torch.Tensor, acc: torch.Tensor,
                                      word_offset: int,
                                      present: "tuple[bool, ...]",
                                      data_shards: int, shard_len: int,
                                      finalize: bool = False,
                                      formulation: str = "swar"):
    """Plain version of verify_reconstruct_subchunk (any device): the
    function of codec_step.verify_reconstruct_subchunk_words in the JAX
    package, with ``acc`` updated in place and absent rows unhashed."""
    n = chunk.shape[1]
    k = data_shards
    idx = _survivors(present, k)
    data = rs.gf_matmul_words(
        gf.reconstruction_matrix(k, n - k, idx), chunk, idx, formulation
    )
    mask = torch.tensor(present, dtype=torch.bool, device=chunk.device)
    acc ^= torch.where(mask[:, None], phash.tile_partials(chunk, word_offset), 0)
    if finalize:
        acc.copy_(phash.finalize_partials(acc, shard_len))
    return data, acc


def _check_vr(shards: torch.Tensor, present, k: int) -> None:
    n, w = shards.shape[1], shards.shape[2]
    if len(present) != n:
        raise ValueError(f"present has {len(present)} rows, shards {n}")
    if not 1 <= k <= n <= _MAX_ROWS:
        raise ValueError(f"verify_reconstruct supports k <= n <= {_MAX_ROWS}")
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")


@functools.lru_cache(maxsize=1024)
def _vr_plan(present: "tuple[bool, ...]", k: int):
    """K4's plan, indexed by shard row, made once per (present, k):
    survivors carry their column of the reconstruction matrix, every
    other row an empty chain; ``row`` lists the present rows."""
    n = len(present)
    idx = _survivors(present, k)
    full = np.zeros((k, n), dtype=np.uint8)
    full[:, list(idx)] = gf.reconstruction_matrix(k, n - k, idx)
    live = tuple(i for i, p in enumerate(present) if p)
    rm, nb, row = _matrix_plan(full, live)
    return rm, nb, row, sum(1 << i for i in live)


def _bucket(v: int) -> int:
    """The kernels' row bucket (``bucket`` in codec.cu; the K6 entry
    refuses a term program sized for another)."""
    return 4 if v <= 4 else (8 if v <= 8 else 16)


def _rb_max(kb: int) -> int:
    """Rebuilt rows a K6 term program holds (``kRbMax`` in codec.cu; the
    entry checks the program's size against its own)."""
    return {4: 4, 8: 8, 16: 7}[kb]


@dataclasses.dataclass(frozen=True, eq=False)
class VrTerms:
    """K6's term program for one (present, k), made once by ``vr_terms``.

    Ring slot j holds present row ``rows[j]``; slots 0 .. k-1 are the
    survivors.  A slot whose row is a data row is stored straight to that
    data row (``copy[j]``, else -1).  Data row ``rebuilt[o]`` is the GF
    product of the survivors with row ``rebuilt[o]`` of the reconstruction
    matrix, taken in Horner form over the coefficient bits:
    ``masks[o, b, j]`` is all ones where bit b of its coefficient for
    survivor j is set (zero past k), and the kernel computes
    ``acc = xtime(acc) ^ XOR_j(x_j & masks[o, b, j])`` for b = 7 .. 0.
    ``blob`` packs masks, rows, copy and rebuilt as the launch passes
    them (``make_terms`` in codec.cu)."""

    present_mask: int
    rows: "tuple[int, ...]"
    copy: "tuple[int, ...]"
    rebuilt: "tuple[int, ...]"
    masks: np.ndarray
    blob: ctypes.Array


@functools.lru_cache(maxsize=1024)
def vr_terms(present: "tuple[bool, ...]", k: int) -> VrTerms:
    """K6's term program (``VrTerms``), compiled once per (present, k)."""
    n = len(present)
    idx = _survivors(present, k)
    rmat = gf.reconstruction_matrix(k, n - k, idx)
    rows = tuple(i for i, p in enumerate(present) if p)
    kb = _bucket(k)
    rebuilt = tuple(d for d in range(k) if not present[d])
    if len(rebuilt) > _rb_max(kb):
        raise ValueError(f"{len(rebuilt)} rebuilt rows exceed {_rb_max(kb)}")
    copy = tuple(r if r < k else -1 for r in rows)
    masks = np.zeros((_rb_max(kb), 8, kb), dtype=np.uint32)
    for o, d in enumerate(rebuilt):
        for j in range(k):
            for b in range(8):
                if (int(rmat[d, j]) >> b) & 1:
                    masks[o, b, j] = 0xFFFFFFFF
    packed = b"".join((
        masks.astype("<u4").tobytes(),
        np.array(rows + (0,) * (_MAX_ROWS - len(rows)), np.uint8).tobytes(),
        np.array(copy + (-1,) * (_MAX_ROWS - len(copy)), np.int8).tobytes(),
        np.array(rebuilt + (0,) * (_rb_max(kb) - len(rebuilt)), np.uint8).tobytes(),
    ))
    blob = ctypes.create_string_buffer(packed, len(packed))
    return VrTerms(sum(1 << i for i in rows), rows, copy, rebuilt, masks, blob)


def verify_reconstruct(shards: torch.Tensor, present: "tuple[bool, ...]",
                       data_shards: int, shard_len: int,
                       formulation: str = "swar"):
    """(B, n, w) shard words as read + the present-row mask -> (data
    (B, k, w) rebuilt from the first k present rows, digests (B, n, 8)
    finalized), int32.  Only the digests of present rows are the rows'
    phash256; an absent row is neither read nor hashed.  ``formulation``
    picks the product (``swar`` or ``mxu``); the outputs are the same."""
    B, n, _w = shards.shape
    k = data_shards
    _check_vr(shards, present, k)
    rs.check_formulation(formulation)
    if shards.device.type == "cpu":
        return verify_reconstruct_plain(shards, present, k, shard_len,
                                        formulation)
    _require_cuda(shards, "verify_reconstruct", 3)
    digests = torch.zeros((B, n, 8), dtype=torch.int32, device=shards.device)
    out = _launch_verify_reconstruct(shards, digests, 0, present, k,
                                     shard_len, True, formulation)
    _count("verify_reconstruct[mxu]" if formulation == "mxu"
           else "verify_reconstruct")
    return out


@functools.lru_cache(maxsize=256)
def _mxu_vr_operand(present: "tuple[bool, ...]", k: int,
                    device) -> torch.Tensor:
    """K4/K6's mxu operand, made once per (present, k, device): the (k, k)
    reconstruction matrix over the first k present rows, as P5/P7 lift
    it."""
    idx = _survivors(present, k)
    rmat = gf.reconstruction_matrix(k, len(present) - k, idx)
    return _mxu_operand(rmat, device)


def _launch_verify_reconstruct(shards, partials, word_offset, present, k,
                               shard_len, finalize, formulation="swar"):
    """K4 on checked CUDA shards, XORing into ``partials``."""
    B, n, w = shards.shape
    rm, nb, _row, mask = _vr_plan(tuple(present), k)
    dev = shards.device
    amat = (_mxu_vr_operand(tuple(present), k, dev).data_ptr()
            if formulation == "mxu" else None)
    data = torch.empty((B, k, w), dtype=torch.int32, device=dev)
    if B == 0:
        return data, partials
    ntiles = -(-w // TILE)
    rc = _load().mtt_verify_reconstruct(
        dev.index or 0, shards.data_ptr(), data.data_ptr(),
        partials.data_ptr(), B, n, k, w, mask, shard_len & 0xFFFFFFFF,
        word_offset & 0xFFFFFFFF, int(finalize), _tiles_per_block(ntiles, B),
        rm, nb, amat, _stream(shards),
    )
    _check_rc(rc, "verify_reconstruct")
    return data, partials


def verify_reconstruct_subchunk(chunk: torch.Tensor, acc: torch.Tensor,
                                word_offset: int,
                                present: "tuple[bool, ...]",
                                data_shards: int, shard_len: int,
                                finalize: bool = False):
    """K4 on one (B, n, cw) sub-chunk whose first word is column
    ``word_offset`` of the row: (data (B, k, cw), acc).  The partials of
    the chunk's present rows are XORed into ``acc`` (B, n, 8) IN PLACE;
    with ``finalize`` acc then holds the finalized digests of the whole
    row of ``shard_len`` bytes."""
    B, n, _cw = chunk.shape
    k = data_shards
    _check_vr(chunk, present, k)
    if word_offset % 4:
        raise ValueError(f"word_offset {word_offset} must be a multiple of 4")
    if tuple(acc.shape) != (B, n, 8):
        raise ValueError(f"acc must be {(B, n, 8)}, got {tuple(acc.shape)}")
    if chunk.device.type == "cpu":
        return verify_reconstruct_subchunk_plain(
            chunk, acc, word_offset, present, k, shard_len, finalize
        )
    _require_cuda(chunk, "verify_reconstruct_subchunk", 3)
    _require_cuda(acc, "verify_reconstruct_subchunk acc", 3)
    out = _launch_verify_reconstruct(chunk, acc, word_offset, present, k,
                                     shard_len, finalize)
    _count("verify_reconstruct[subchunk]")
    return out


# ---------------------------------------------------------------------------
# K6 verify_reconstruct_pipelined
# ---------------------------------------------------------------------------


def verify_reconstruct_pipelined_plain(shards: torch.Tensor,
                                       present: "tuple[bool, ...]",
                                       data_shards: int, shard_len: int,
                                       formulation: str = "swar"):
    """Plain version of verify_reconstruct_pipelined: P7 computes P5's
    function, so this is verify_reconstruct_plain."""
    return verify_reconstruct_plain(shards, present, data_shards, shard_len,
                                    formulation)


def verify_reconstruct_pipelined(shards: torch.Tensor,
                                 present: "tuple[bool, ...]",
                                 data_shards: int, shard_len: int,
                                 formulation: str = "swar"):
    """K6: verify_reconstruct's outputs, bit for bit, from the pipelined
    kernel (persistent grid, cp.async ring of the present rows, copies of
    the present data rows and the product of ``vr_terms`` for the rest,
    last-block finalize)."""
    B, n, w = shards.shape
    k = data_shards
    _check_vr(shards, present, k)
    rs.check_formulation(formulation)
    if shards.device.type == "cpu":
        return verify_reconstruct_pipelined_plain(shards, present, k,
                                                  shard_len, formulation)
    _require_cuda(shards, "verify_reconstruct_pipelined", 3)
    _require_aligned(shards, "verify_reconstruct_pipelined")
    present = tuple(present)
    terms = vr_terms(present, k)
    dev = shards.device
    amat = (_mxu_vr_operand(present, k, dev).data_ptr()
            if formulation == "mxu" else None)
    data = torch.empty((B, k, w), dtype=torch.int32, device=dev)
    if B == 0:
        return data, torch.zeros((0, n, 8), dtype=torch.int32, device=dev)
    # the digests and the last-block ticket: one buffer the entry zeroes
    acc = torch.empty(B * n * 8 + 1, dtype=torch.int32, device=dev)
    digests = _rows_view(acc, (B, n))
    tpb, _per_stripe = pipelined_grid(B, w, sm_count(dev))
    rc = _load().mtt_verify_reconstruct_pipelined(
        dev.index, shards.data_ptr(), data.data_ptr(), acc.data_ptr(), B, n,
        k, w, terms.present_mask, shard_len & 0xFFFFFFFF, tpb, terms.blob,
        len(terms.blob), len(terms.rebuilt), amat, _stream(shards),
    )
    _check_rc(rc, "verify_reconstruct_pipelined")
    _count("verify_reconstruct_pipelined[mxu]" if formulation == "mxu"
           else "verify_reconstruct_pipelined")
    return data, digests


# ---------------------------------------------------------------------------
# K7 gf_matmul_mxu
# ---------------------------------------------------------------------------


def gf_matmul_mxu(matrix: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """(o, s) GF matrix @ (s, length) uint8 shards -> (o, length) uint8
    through the tensor-core product of the lifted bit matrix (K7); any
    length.  The plain version is rs.gf_matmul_mxu_plain."""
    o, s = matrix.shape
    if shards.dim() != 2 or shards.shape[0] != s:
        raise ValueError(
            f"matrix wants ({s}, length) shards, got {tuple(shards.shape)}"
        )
    if shards.device.type == "cpu":
        return rs.gf_matmul_mxu_plain(matrix, shards)
    if shards.device.type != "cuda":
        raise ValueError(f"gf_matmul_mxu: expected a CUDA tensor, got {shards.device}")
    if shards.dtype != torch.uint8:
        raise TypeError(f"gf_matmul_mxu: expected uint8 shards, got {shards.dtype}")
    if not shards.is_contiguous():
        raise ValueError("gf_matmul_mxu: expected a contiguous tensor")
    if not (1 <= o <= _MAX_ROWS and 1 <= s <= _MAX_ROWS):
        raise ValueError(f"gf_matmul_mxu supports o, s <= {_MAX_ROWS}")
    length = shards.shape[1]
    if length >= 1 << 31:
        raise ValueError("gf_matmul_mxu: rows of at most 2^31 - 1 bytes")
    dev = shards.device
    out = torch.empty((o, length), dtype=torch.uint8, device=dev)
    if length == 0:
        return out
    rc = _load().mtt_gf_matmul_mxu(
        dev.index or 0, shards.data_ptr(), out.data_ptr(), o, s, length,
        _mxu_operand(matrix, dev).data_ptr(), _stream(shards),
    )
    _check_rc(rc, "gf_matmul_mxu")
    _count("gf_matmul_mxu")
    return out
