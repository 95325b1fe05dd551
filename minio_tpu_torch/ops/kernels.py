"""The codec's CUDA kernels: build, binding, and the dispatching wrappers.

Three kernels, all in ``csrc/codec.cu`` (CUDA C++ for ``sm_90a``):

* ``encode_pack`` (K1) replaces ``rs_pallas.encode_pack_fused`` (P4) and
  its pipelined body ``encode_pack_pipelined`` (P6): parity + phash256
  partials of all n rows + per-256-word occupancy flags + the
  nonzero-group prefix pack, plus the digest finalize.
* ``phash256_batched`` (K2) replaces ``hash.phash256_words_batched``
  (X1, left to XLA by the JAX package): (R, w) rows -> (R, 8) digests.
* ``gf_matmul_words`` (K3) replaces ``rs_pallas.matmul_words`` (P1): a
  runtime (o, s) GF(2^8) matrix over s selected rows of a (B, R, w)
  batch -> (B, o, w).

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
wrapper (never plain runs); ``reset_launches`` zeroes it.
"""

from __future__ import annotations

import ctypes
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

LAUNCHES = {"encode_pack": 0, "phash256_batched": 0, "gf_matmul_words": 0}
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
            lib.mtt_encode_pack.argtypes = [
                I, P, P, P, P, P, I, I, I, I, I, U, I, P, P, P,
            ]
            lib.mtt_phash256.argtypes = [I, P, P, I, I, U, I, P]
            lib.mtt_gf_matmul.argtypes = [I, P, P, I, I, I, I, I, P, P, P, P]
            for fn in (lib.mtt_encode_pack, lib.mtt_phash256, lib.mtt_gf_matmul):
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tiles_per_block(ntiles: int, rows: int) -> int:
    """Tiles a block walks: enough blocks to fill the card, and fewer
    global atomics per digest word as the grid grows."""
    return max(1, min(8, (ntiles * rows) // _TARGET_BLOCKS))


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


# ---------------------------------------------------------------------------
# K1 encode_pack
# ---------------------------------------------------------------------------


def encode_pack_plain(words: torch.Tensor, parity_shards: int,
                      shard_len: int, group: int = 0):
    """Plain version of encode_pack (any device): the portable path of
    codec_step.encode_words_fused1 in the JAX package."""
    B, k, w = words.shape
    m = parity_shards
    parity = rs.encode_words(words, m)
    digests = phash.phash256_words_batched(
        torch.cat([words, parity], dim=1), shard_len
    )
    if not group:
        empty = torch.zeros((B, m, 0), dtype=torch.int32, device=words.device)
        return parity, digests, empty, parity
    g = w // group
    grouped = parity.reshape(B, m, g, group)
    flags = (grouped != 0).any(dim=-1)
    idx = torch.arange(g, dtype=torch.int64, device=words.device)
    key = torch.where(flags, 0, g) + idx  # unique keys: nonzero groups first
    order = torch.argsort(key, dim=-1)
    packed = torch.take_along_dim(
        grouped, order[..., None].expand(B, m, g, group), dim=-2
    ).reshape(B, m, w)
    return parity, digests, flags.to(torch.int32), packed


def encode_pack(words: torch.Tensor, parity_shards: int, shard_len: int,
                group: int = 0):
    """(B, k, w) data words -> (parity (B, m, w), digests (B, k+m, 8)
    finalized, flags (B, m, w//group) 0/1, packed (B, m, w)), all int32.
    group == 0 disables the pack leg (flags has g == 0, packed is
    parity); otherwise group must be 256 and divide w."""
    B, k, w = words.shape
    m = parity_shards
    if group not in (0, TILE) or (group and w % group):
        raise ValueError(f"group must be 0 or {TILE} dividing w, got {group}")
    if words.device.type == "cpu":
        return encode_pack_plain(words, m, shard_len, group)
    _require_cuda(words, "encode_pack", 3)
    if not (1 <= k <= _MAX_ROWS and 0 <= m <= _MAX_ROWS):
        raise ValueError(f"encode_pack supports k, m <= {_MAX_ROWS}")
    lib = _load()
    dev = words.device
    parity = torch.empty((B, m, w), dtype=torch.int32, device=dev)
    digests = torch.zeros((B, k + m, 8), dtype=torch.int32, device=dev)
    g = w // TILE if group else 0
    flags = torch.empty((B, m, g), dtype=torch.int32, device=dev)
    packed = torch.empty_like(parity) if group else parity
    rm, nb, _row = _matrix_plan(gf.parity_matrix(k, m), ())
    ntiles = -(-w // TILE)
    rc = lib.mtt_encode_pack(
        dev.index or 0, words.data_ptr(), parity.data_ptr(),
        digests.data_ptr(), flags.data_ptr(), packed.data_ptr(),
        B, k, m, w, group, shard_len & 0xFFFFFFFF,
        _tiles_per_block(ntiles, B), rm, nb, _stream(words),
    )
    _check_rc(rc, "encode_pack")
    _count("encode_pack")
    return parity, digests, flags, packed


# ---------------------------------------------------------------------------
# K2 phash256_batched
# ---------------------------------------------------------------------------


def phash256_batched(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Finalized phash256 over the LAST axis: (..., w) int32 -> (..., 8)."""
    if words.device.type == "cpu":
        return phash.phash256_words_batched(words, nbytes)
    lead, w = tuple(words.shape[:-1]), words.shape[-1]
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")
    flat = words.reshape(-1, w)
    _require_cuda(flat, "phash256_batched", 2)
    R = flat.shape[0]
    out = torch.zeros((R, 8), dtype=torch.int32, device=words.device)
    if R == 0:
        return out.reshape(*lead, 8)
    if R > 65535:
        raise ValueError("phash256_batched: at most 65535 rows per launch")
    ntiles = -(-w // TILE)
    rc = _load().mtt_phash256(
        words.device.index or 0, flat.data_ptr(), out.data_ptr(), R, w,
        nbytes & 0xFFFFFFFF, _tiles_per_block(ntiles, R), _stream(flat),
    )
    _check_rc(rc, "phash256_batched")
    _count("phash256_batched")
    return out.reshape(*lead, 8)


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
