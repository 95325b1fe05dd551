"""The codec's CUDA kernels: build, binding, and the dispatching wrappers.

Nine kernels, all in ``csrc/codec.cu`` (CUDA C++ for ``sm_90a``):

* ``encode_pack`` (K1) replaces ``rs_pallas.encode_pack_fused`` (P4):
  parity + phash256 partials of all n rows + per-256-word occupancy
  flags + the nonzero-group prefix pack, plus the digest finalize in its
  last block.  With ``group=0`` it also computes
  ``rs_pallas.encode_hash_fused`` (P2), heal's re-encode.  The parity
  product runs in Horner form: straight-line code with only the set
  terms for ``FIXED_GEOMETRIES`` (generated by ``fixed_source``), masks
  from ``parity_terms`` for every other (k, m).
  ``encode_pack_subchunk`` is its sub-chunk form, the GPU body of
  ``codec_step.encode_subchunk_words`` (X2, left to XLA by the JAX
  package): a chunk at a global word offset, XOR-accumulating into the
  caller's partials, finalizing only on the last chunk.
* ``phash256_batched`` (K2) replaces ``hash.phash256_words_batched``
  (X1, left to XLA by the JAX package): (R, w) rows -> (R, 8) digests,
  in one launch that finalizes in its last block.
* ``gf_matmul_words`` (K3) replaces ``rs_pallas.matmul_words`` (P1): a
  runtime (o, s) GF(2^8) matrix over s selected rows of a (B, R, w)
  batch -> (B, o, w); unit rows are copies, the others the Horner
  product of ``gf_terms`` (made once per (matrix, rows)).
* ``verify_reconstruct`` (K4) replaces ``rs_pallas.verify_reconstruct_fused``
  (P5): finalized digests of the present rows of a (B, n, w) batch and
  the k data rows rebuilt from the first k present rows, in one pass that
  copies the present data rows and rebuilds only the others (the term
  program of ``vr_terms``; under mxu ``_mxu_rebuilt_operand``), in one
  launch that finalizes in its last block.  ``verify_reconstruct_subchunk``
  is its sub-chunk form, the GPU body of
  ``codec_step.verify_reconstruct_subchunk_words`` (X3): a chunk at a
  global word offset, XOR-accumulating into the caller's partials,
  finalizing only on the last chunk.  Both take a plan per call shape
  (``_vr_plan``).
* ``encode_pack_pipelined`` (K5) replaces ``rs_pallas.encode_pack_pipelined``
  (P6) and ``verify_reconstruct_pipelined`` (K6) replaces
  ``rs_pallas.verify_reconstruct_pipelined`` (P7): K1's and K4's
  functions on a persistent grid that stages tiles into a shared-memory
  ring with ``cp.async`` and finalizes in its last block.  K5 runs K1's
  product (``fixed_source``, ``parity_terms``) from the ring slot, its
  mxu kernel a product of its own on a swizzled ring (``ring_swizzle``);
  K6 copies the present data rows and rebuilds the others from the term
  program made once per (present, k) (``vr_terms``), its mxu kernel from
  the rebuilt rows' operand (``_mxu_rebuilt_operand``).
* ``gf_matmul_mxu`` (K7) replaces ``rs_pallas.gf_matmul_mxu`` (P3): a
  runtime (o, s) GF(2^8) matrix over (s, length) uint8 shards through a
  1-bit tensor-core product of the lifted (8o, 8s) GF(2) matrix, the
  data as the A operand and the matrix as the B operand in its own order
  (``k7_fragments``), on a persistent grid (``k7_grid``) fed by a
  producer warp's bulk copies into a shared-memory ring; the operand is
  made once per matrix (``_k7_operand``), the grid once per shape.
* ``group_flags`` (K12) and ``pack_nonzero_groups`` (K13) are the GPU
  bodies of ``codec_step.group_flags`` and ``codec_step.pack_nonzero_groups``
  (X8, X9, left to XLA by the JAX package): the legacy drain's occupancy
  screen of a parity plane (one flag per 256-word group) and its
  nonzero-group prefix pack, as separate passes where K1's pack leg
  computes them inside the encode.  Both go through one entry and one
  packed struct (``_GROUP_ARGS``): K12 a grid of at most four waves whose
  warps walk runs of groups, all their streaming loads issued before
  their votes (``group_plan``, made once per shape); K13 in one launch of thread-block clusters, one a row, whose
  blocks stage the row in shared memory and meet through distributed
  shared memory for the prefix (``pack_plan``, made once per shape).

``formulation="mxu"`` (MINIO_TPU_CODEC_FORMULATION) on K1, K4, K5 and K6
swaps their xtime chain for the same tensor-core product (the ``mxu``
kernels, on a swizzled tile, ``ring_swizzle``), as
``_mxu_rows`` replaces ``_swar_rows`` inside P4-P7; their outputs are bit
for bit the ``swar`` ones.  The lifted matrix reaches the kernel as a small
device tensor in the product's operand order (``_mxu_operand``), cached
per matrix and device.

Build: one library of ``csrc/codec.cu`` and ``csrc/select.cu`` (S3
Select's kernels, bound by ``select_step.bind``), one ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -c`` per source started together, then
one link, into ``minio_tpu_torch/build/`` at first use, keyed by a hash
of the sources and flags, loaded with ctypes.  Nothing is built or
imported from CUDA when this module is imported.

Each wrapper takes int32 tensors that reinterpret u32 words.  For a CPU
tensor it runs the kernel's plain PyTorch version (``*_plain``, built on
ops/rs.py and ops/hash.py); for a CUDA tensor it launches the kernel on
``torch.cuda.current_stream()`` or raises - a failed build, a refused
launch (non-zero ``cudaGetLastError()``) or a wrong device, dtype, shape
or layout never falls back.  ``LAUNCHES`` counts kernel launches per
wrapper (never plain runs): ``encode_pack[group=0]`` counts the K1
launches without the pack leg among ``encode_pack``'s, and the two
``[subchunk]`` names count the sub-chunk forms and the four ``[mxu]``
names the ``mxu`` instantiations, which the base names do not; the
``select_*`` names count S3 Select's kernels (``ops/select_step.py``);
``reset_launches`` zeroes it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import gf, hash as phash, rs

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "codec.cu", _PKG / "csrc" / "select.cu")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Constants shared with csrc/codec.cu, which exports its own values
# (mtt_constants); _load refuses a library that differs from these.
TILE = 256  # columns per block tile == PARITY_GROUP_WORDS
_MAX_ROWS = 16

_PIPE_BLOCKS_PER_SM = 2  # K6 residency (kPipeBlocksPerSM)
_ENC_BLOCKS_PER_SM = 3  # K1's persistent grid (kEncBlocksPerSM)
_GF_BLOCKS_PER_SM = 4  # K3's grid (kGfBlocksPerSM)
_PHASH_ROWS = 4  # rows per K2 block (kPhashRows: the entry refuses another)
_PHASH_BLOCKS_PER_SM = 2  # K2's one-wave grid (kPhashBlocksPerSM)
K7_TILE = 1024  # bytes of each row a K7 tile (kMxTile)
_K7_ROW_STRIDE = K7_TILE + 32  # a ring slot's rows (kMxRowStride)
_K7_STAGES = 4  # K7's ring depth (kMxStages)
PACK_SEG_MAX = 192  # groups a K13 block stages a pass (kPackSegMax)
_PACK_CLUSTER_MAX = 16  # the largest K13 cluster (kPackClusterMax)
_FLAGS_BATCH = 4  # groups a K12 warp loads before its votes (kFlagsBatch)
_FLAGS_BLOCKS_PER_SM = 4  # K12's blocks an SM (kFlagsBlocksPerSM)

# (k, m) whose parity product K1 runs as straight-line code with only the
# matrix's set terms (fixed_parity in codec.cu, generated by fixed_source
# at build time); every other geometry takes the masked Horner form.  A
# geometry joins only with a same-call timing of both forms at its shape:
# EC 8+4 (the default deployment) has one.
FIXED_GEOMETRIES = ((8, 4),)

LAUNCHES = {
    "encode_pack": 0, "encode_pack[group=0]": 0, "encode_pack[subchunk]": 0,
    "phash256_batched": 0, "gf_matmul_words": 0, "verify_reconstruct": 0,
    "verify_reconstruct[subchunk]": 0, "encode_pack_pipelined": 0,
    "verify_reconstruct_pipelined": 0, "gf_matmul_mxu": 0,
    "encode_pack[mxu]": 0, "verify_reconstruct[mxu]": 0,
    "encode_pack_pipelined[mxu]": 0, "verify_reconstruct_pipelined[mxu]": 0,
    "group_flags": 0, "pack_nonzero_groups": 0,
    # S3 Select's kernels (ops/select_step.py, csrc/select.cu)
    "select_screen": 0, "select_positions": 0, "select_spans[row]": 0,
    "select_spans[back]": 0, "select_gather": 0,
}
_count_lk = threading.Lock()

_lib = None
_lib_lk = threading.Lock()
BUILD_INFO: dict = {}


def reset_launches() -> None:
    with _count_lk:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(*names: str) -> None:
    with _count_lk:
        for name in names:
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


def _fingerprint(generated: str) -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(generated.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_library(out: Path, sources, info: dict, extra=()) -> Path:
    """Build the shared library ``out`` unless it exists: one ``nvcc -c``
    per source, all started together, then one link.  ``info`` gets the
    wall ``seconds``, each source's compile seconds (``sources``) and the
    compiler's output (``log``).  Raises RuntimeError with the compiler's
    output on failure."""
    if out.exists():
        info.setdefault("seconds", 0.0)
        info.setdefault("sources", {})
        info.setdefault("log", "")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources]

    def run(cmd):
        t = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.monotonic() - t

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:
        done = list(pool.map(run, [
            [_nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ]))
    if all(proc.returncode == 0 for proc, _s in done):
        done.append(run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]))
    info["seconds"] = time.monotonic() - t0
    info["sources"] = {src.name: s for src, (_p, s) in zip(sources, done)}
    info["log"] = "".join(proc.stdout + proc.stderr for proc, _s in done)
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [proc for proc, _s in done if proc.returncode != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n{info['log']}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile the kernels (once per source hash, the generated
    ``mtt_fixed.cuh`` included) and return the library path.  Raises
    RuntimeError with the compiler's output on failure."""
    generated = fixed_source()
    fp = _fingerprint(generated)
    out = BUILD_DIR / f"libmtt_codec-{fp}.so"
    gen_dir = BUILD_DIR / f"gen-{fp}"
    if not out.exists():
        gen_dir.mkdir(parents=True, exist_ok=True)
        header = gen_dir / "mtt_fixed.cuh"
        tmp_header = header.with_suffix(f".{os.getpid()}.tmp")
        tmp_header.write_text(generated)
        os.replace(tmp_header, header)
    return compile_library(out, SOURCES, BUILD_INFO, ("-I", str(gen_dir)))


def _load():
    global _lib
    with _lib_lk:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            # K1, K3, K4, K5, K7 and K12/K13 take one packed argument
            # struct (_ENCODE_ARGS, _GF_ARGS, _VR_ARGS, _ENCODE_PIPE_ARGS,
            # _MXU_ARGS, _GROUP_ARGS):
            # ctypes converts one argument, not 13-20.  In K6 the pointer
            # before the stream is the mxu operand (None: the swar
            # instantiation).
            lib.mtt_encode_pack.argtypes = [ctypes.c_char_p]
            lib.mtt_encode_pack_pipelined.argtypes = [ctypes.c_char_p]
            lib.mtt_phash256.argtypes = [I, P, P, I, I, U, I, I, P]
            lib.mtt_gf_matmul.argtypes = [ctypes.c_char_p]
            lib.mtt_verify_reconstruct.argtypes = [ctypes.c_char_p]
            lib.mtt_verify_reconstruct_pipelined.argtypes = [
                I, P, P, P, I, I, I, I, U, U, I, P, I, I, P, P,
            ]
            lib.mtt_gf_matmul_mxu.argtypes = [ctypes.c_char_p]
            lib.mtt_group_flags.argtypes = [ctypes.c_char_p]
            lib.mtt_pack_clusters.argtypes = [I, I, I]
            for fn in (lib.mtt_encode_pack, lib.mtt_encode_pack_pipelined,
                       lib.mtt_phash256, lib.mtt_gf_matmul,
                       lib.mtt_verify_reconstruct,
                       lib.mtt_verify_reconstruct_pipelined,
                       lib.mtt_gf_matmul_mxu, lib.mtt_group_flags,
                       lib.mtt_pack_clusters):
                fn.restype = ctypes.c_int
            lib.mtt_constants.restype = ctypes.c_char_p
            _check_constants(lib.mtt_constants().decode())
            from . import select_step

            select_step.bind(lib)
            _lib = lib
        return _lib


def load() -> None:
    """Build (or find by its fingerprint) and load the kernel library
    now, not at the first launch: the server does it at boot, before it
    reports ready."""
    _load()


def _constants() -> dict:
    """The values codec.cu must export (mtt_constants), from this
    module's own."""
    return {
        "tile": (TILE,), "max_rows": (_MAX_ROWS,),
        "phash_rows": (_PHASH_ROWS,), "phash_blocks_per_sm": (_PHASH_BLOCKS_PER_SM,),
        "pipe_blocks_per_sm": (_PIPE_BLOCKS_PER_SM,),
        "enc_blocks_per_sm": (_ENC_BLOCKS_PER_SM,),
        "gf_blocks_per_sm": (_GF_BLOCKS_PER_SM,),
        "bucket": tuple(_bucket(v) for v in range(1, _MAX_ROWS + 1)),
        "rb_max": tuple(_rb_max(kb) for kb in (4, 8, 16)),
        "vr_terms_bytes": tuple(_vr_terms_bytes(kb) for kb in (4, 8, 16)),
        "gf_terms_bytes": (_GF_TERMS_BYTES,),
        "encode_args_bytes": (_ENCODE_ARGS.size,),
        "encode_pipe_args_bytes": (_ENCODE_PIPE_ARGS.size,),
        "gf_args_bytes": (_GF_ARGS.size,),
        "vr_args_bytes": (_VR_ARGS.size,), "rebuilt_max": (_REBUILT_MAX,),
        "mxu_tile_bytes": (K7_TILE,), "mxu_row_stride": (_K7_ROW_STRIDE,),
        "mxu_stages": (_K7_STAGES,),
        "mxu_blocks_per_sm": tuple(k7_blocks_per_sm(o, s) for s in (4, 8, 16)
                                   for o in (4, 8, 16)),
        "mxu_args_bytes": (_MXU_ARGS.size,),
        "group_args_bytes": (_GROUP_ARGS.size,),
        "pack_seg_max": (PACK_SEG_MAX,), "pack_cluster_max": (_PACK_CLUSTER_MAX,),
        "flags_batch": (_FLAGS_BATCH,), "flags_blocks_per_sm": (_FLAGS_BLOCKS_PER_SM,),
        "ring_swizzle": tuple(ring_swizzle(r) for r in (0, 4, 8, 12)),
        "fixed": tuple(f"{k}x{m}" for k, m in FIXED_GEOMETRIES),
    }


def parse_constants(text: str) -> dict:
    """mtt_constants' "name=v[,v...]" words -> {name: values}; ints where
    they parse as ints."""
    out = {}
    for word in text.split():
        name, _eq, vals = word.partition("=")
        items = [v for v in vals.split(",") if v]
        out[name] = tuple(int(v) if v.lstrip("-").isdigit() else v for v in items)
    return out


def _check_constants(text: str, want: "dict | None" = None,
                     what: str = "codec.cu") -> None:
    """Raise unless a library's exported constants (``text``) are
    ``want`` (by default this module's own, for codec.cu)."""
    want = _constants() if want is None else want
    got = parse_constants(text)
    if got != want:
        diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        diff.update({k: (v, None) for k, v in got.items() if k not in want})
        raise RuntimeError(f"{what} constants differ from the module's: {diff}")


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _require_cuda(t: torch.Tensor, name: str, ndim: int,
                  dtype=torch.int32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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


@functools.lru_cache(maxsize=1024)
def _rows_layout(lead: "tuple[int, ...]"):
    shape = (*lead, 8)
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    return shape, tuple(reversed(strides))


def _rows_view(acc: torch.Tensor, lead: "tuple[int, ...]") -> torch.Tensor:
    """The first prod(lead) * 8 words of ``acc`` as a contiguous (*lead,
    8) view, in one call (a slice and a view cost twice the host time)."""
    return acc.as_strided(*_rows_layout(lead))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _persistent_grid(B: int, w: int, resident: int) -> "tuple[int, int]":
    """(tiles per block, blocks per stripe): about ``resident`` blocks
    split evenly over the B stripes, each block a contiguous run of
    256-column tiles."""
    ntiles = -(-w // TILE)
    per_stripe = min(ntiles, max(1, -(-resident // B)))
    tpb = -(-ntiles // per_stripe)
    return tpb, -(-ntiles // tpb)


@functools.lru_cache(maxsize=1024)
def pipelined_grid(B: int, w: int, sms: int) -> "tuple[int, int]":
    """The persistent grid of K4, K6 and of the mxu kernels of K1 and K5:
    ``_PIPE_BLOCKS_PER_SM`` blocks per SM, the residency their
    ``__launch_bounds__`` hold."""
    return _persistent_grid(B, w, sms * _PIPE_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=1024)
def encode_pipelined_grid(B: int, w: int, sms: int,
                          mxu: bool = False) -> "tuple[int, int]":
    """K5's persistent grid: K1's (``encode_grid``, the residency K5's
    swar kernel is compiled for) or, for the mxu kernel, K6's
    (``pipelined_grid``)."""
    return pipelined_grid(B, w, sms) if mxu else encode_grid(B, w, sms)


@functools.lru_cache(maxsize=1024)
def encode_grid(B: int, w: int, sms: int) -> "tuple[int, int]":
    """K1's grid (swar): a persistent one of ``_ENC_BLOCKS_PER_SM`` blocks
    per SM; the mxu kernel takes ``pipelined_grid``."""
    return _persistent_grid(B, w, sms * _ENC_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=1024)
def gf_grid(B: int, w: int, sms: int) -> int:
    """K3's blocks: ``_GF_BLOCKS_PER_SM`` per SM, or one per (stripe,
    256-quad tile) pair when there are fewer; they stride over the
    pairs."""
    quads = -(-w // 4)
    tiles = -(-quads // TILE)  # per stripe
    return max(1, min(B * tiles, sms * _GF_BLOCKS_PER_SM))


def pipeline_windows(B: int, w: int, sms: int, encode: bool = False,
                     mxu: bool = False) -> int:
    """Overlap windows of one K6 launch (``encode``: K5, of the mxu
    kernel with ``mxu``): the tile computes during which a later tile's
    copy was in flight.  A block walking c tiles has c - 1 of them, so
    the launch has B * (ntiles - blocks per stripe)."""
    if encode:
        _tpb, per_stripe = encode_pipelined_grid(B, w, sms, mxu)
    else:
        _tpb, per_stripe = pipelined_grid(B, w, sms)
    return B * (-(-w // TILE) - per_stripe)


def ring_swizzle(row: int) -> int:
    """The chunk swizzle of the mxu kernels' rings and of K4's staged tile
    (``ring_swizzle`` in codec.cu):
    16-byte chunk c of ring row ``row`` lies at chunk c ^ ring_swizzle(row)
    of the slot's row, so that the warp's 16-byte B-operand loads of rows
    4 tig + i meet 8 different quads of banks."""
    return ((row >> 2) << 1) & 7


@functools.lru_cache(maxsize=1024)
def phash_grid(R: int, w: int, sms: int) -> int:
    """Tiles (of 256 column quads) per K2 block: one wave of
    ``_PHASH_BLOCKS_PER_SM`` blocks per SM over the quad tiles of every
    group of ``_PHASH_ROWS`` rows."""
    tiles = -(-(w // 4) // TILE)
    blocks = -(-R // _PHASH_ROWS) * tiles
    return max(1, min(tiles, -(-blocks // (sms * _PHASH_BLOCKS_PER_SM))))


# ---------------------------------------------------------------------------
# term programs (K1, K3, K4, K6): the GF product in Horner form
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _gf_program(matrix_key: bytes, o: int, s: int, copies: bool):
    """The term program of an (o, s) GF(2^8) matrix: (copy, out, bits).

    With ``copies``, an output row that is a unit row (one coefficient,
    1) is stored straight from its input: ``copy[j]`` is that output row
    for input j, else -1 (the first such row per input; another one with
    the same input is a product row).  Every other output row is a
    product row: ``out`` lists them in order and ``bits[r, b]`` (uint16)
    has bit j set where input j's coefficient for product row r has bit
    b, so the row is acc = xtime(acc) ^ XOR(inputs of bits[r, b]) for b =
    7 .. 0 (Horner's form)."""
    matrix = np.frombuffer(matrix_key, dtype=np.uint8).reshape(o, s)
    copy = [-1] * s
    out = []
    for r in range(o):
        nz = np.flatnonzero(matrix[r])
        if copies and len(nz) == 1 and matrix[r, nz[0]] == 1 and copy[nz[0]] < 0:
            copy[int(nz[0])] = r
        else:
            out.append(r)
    bits = np.zeros((len(out), 8), dtype=np.uint16)
    for i, r in enumerate(out):
        for j in range(s):
            for b in range(8):
                if (int(matrix[r, j]) >> b) & 1:
                    bits[i, b] |= 1 << j
    bits.setflags(write=False)
    return tuple(copy), tuple(out), bits


def horner_steps(bits_row: np.ndarray) -> "list[tuple[int, ...]]":
    """One product row's Horner steps from its top set bit down to bit 0:
    the inputs XORed in after each xtime (the first step starts from
    zero).  Empty for a zero row."""
    top = max((b for b in range(8) if bits_row[b]), default=-1)
    return [tuple(j for j in range(_MAX_ROWS) if (int(bits_row[b]) >> j) & 1)
            for b in range(top, -1, -1)]


_GF_TERMS_BYTES = 2 * _MAX_ROWS * 8 + 3 * _MAX_ROWS  # gf_terms_bytes() in codec.cu

# The K1 and K3 entries' argument structs (EncodeArgs, GfMatmulArgs in
# codec.cu): data, parity, acc, ticket, flags, packed, terms, amat, stream
# addresses; device, B, k, m, w, group, zero_acc, tiles_per_block,
# terms_len; nbytes, word_offset.  And in, out, terms, stream; device, B,
# rows_in, w, o, s, blocks, terms_len, rows.  A null address is 0.
_ENCODE_ARGS = struct.Struct("<9Q9i2I4x")
_GF_ARGS = struct.Struct("<4Q9i4x")
# K5's (EncodePipeArgs): data, parity, packed, flags, acc, terms, amat,
# stream addresses; device, B, k, m, w, group, tiles_per_block,
# terms_len; nbytes.
_ENCODE_PIPE_ARGS = struct.Struct("<8Q8iI4x")
# K4's (VrArgs): shards, data, acc, ticket, terms, amat, stream addresses;
# device, B, n, k, w, np, rb, tiles_per_block, terms_len, zero_acc;
# present, nbytes, word_offset.
_VR_ARGS = struct.Struct("<7Q10i3I4x")
# K7's (MxuArgs): in, out, frags, stamps, stream addresses; device, o, s,
# length, blocks, tiles_per_block.
_MXU_ARGS = struct.Struct("<5Q6i")
# K12's and K13's (GroupArgs): words, flags, packed, stream addresses;
# rows; device, w, cluster, seg (K13's plan; for K12 0 and its run).
_GROUP_ARGS = struct.Struct("<4Qq4i")
_REBUILT_MAX = 8  # rebuilt rows of the mxu product (kRebuiltMax): min(k, n - k) <= 8


@dataclasses.dataclass(frozen=True, eq=False)
class GfTerms:
    """K1's and K3's term program (``GfTerms`` in codec.cu) for one
    matrix: inputs ``rows`` (K3's picks out of the batch), ``copy[j]``
    the output row stored straight from input j or -1, product rows
    ``out`` with their Horner bits (``_gf_program``).  ``blob`` packs
    bits (16 x 8 uint16), row, copy and out (16 bytes each) as the entry
    takes them (``make_gf_terms``)."""

    rows: "tuple[int, ...]"
    copy: "tuple[int, ...]"
    out: "tuple[int, ...]"
    bits: np.ndarray
    blob: ctypes.Array


def _gf_terms(matrix_key: bytes, o: int, s: int, rows, copies: bool) -> GfTerms:
    copy, out, bits = _gf_program(matrix_key, o, s, copies)
    full = np.zeros((_MAX_ROWS, 8), dtype="<u2")
    full[: len(out)] = bits
    pad = _MAX_ROWS
    packed = b"".join((
        full.tobytes(),
        np.array(rows + (0,) * (pad - len(rows)), np.uint8).tobytes(),
        np.array(copy + (-1,) * (pad - len(copy)), np.int8).tobytes(),
        np.array(out + (0,) * (pad - len(out)), np.uint8).tobytes(),
    ))
    blob = ctypes.create_string_buffer(packed, len(packed))
    return GfTerms(rows, copy, out, bits, blob)


@functools.lru_cache(maxsize=1024)
def _gf_terms_cached(matrix_key: bytes, o: int, s: int,
                     rows: "tuple[int, ...]") -> GfTerms:
    return _gf_terms(matrix_key, o, s, rows, True)


def gf_terms(matrix: np.ndarray, rows: "tuple[int, ...]") -> GfTerms:
    """K3's term program for an (o, s) matrix over input rows ``rows``,
    compiled once per (matrix, rows): unit rows are copies."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _gf_terms_cached(m.tobytes(), m.shape[0], m.shape[1],
                            tuple(int(r) for r in rows))


@functools.lru_cache(maxsize=512)
def parity_terms(k: int, m: int) -> GfTerms:
    """K1's term program for gf.parity_matrix(k, m), compiled once per
    (k, m): every parity row is a product row."""
    pm = np.ascontiguousarray(gf.parity_matrix(k, m), dtype=np.uint8)
    return _gf_terms(pm.tobytes(), m, k, tuple(range(k)), False)


def fixed_source() -> str:
    """``mtt_fixed.cuh``, which codec.cu includes: the list of
    FIXED_GEOMETRIES and, per geometry, ``fixed_parity<k, m>``, the parity
    product of ``parity_terms(k, m)`` as straight-line Horner steps with
    only the set terms."""
    lines = [
        "// Generated by minio_tpu_torch/ops/kernels.py (fixed_source) from",
        "// gf.parity_matrix at build time; do not edit.",
        "#define MTT_FIXED_GEOMETRIES(X)"
        + "".join(f" X({k}, {m})" for k, m in FIXED_GEOMETRIES),
    ]
    for k, m in FIXED_GEOMETRIES:
        terms = parity_terms(k, m)
        lines += ["template <>",
                  f"__device__ __forceinline__ void fixed_parity<{k}, {m}>("
                  "const uint32_t* x, uint32_t* acc) {"]
        for r in range(m):
            steps = horner_steps(terms.bits[r])
            if not steps:
                lines.append(f"  acc[{r}] = 0u;")
                continue
            lines.append("  {")
            for i, inputs in enumerate(steps):
                terms_ = [f"x[{j}]" for j in inputs]
                if i == 0:
                    lines.append(f"    uint32_t a = {' ^ '.join(terms_) or '0u'};")
                else:
                    lines.append(f"    a = {' ^ '.join(['xtime(a)'] + terms_)};")
            lines += [f"    acc[{r}] = a;", "  }"]
        lines.append("}")
    return "\n".join(lines) + "\n"


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
    operand is 2 KiB)."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _mxu_tensor(m.tobytes(), m.shape[0], m.shape[1], str(device))


# ---------------------------------------------------------------------------
# K1 encode_pack
# ---------------------------------------------------------------------------


def _flags_and_pack(parity: torch.Tensor, group: int):
    """Plain occupancy flags (..., w // group) int32 and the full-row
    prefix pack of a parity plane (..., w): nonzero groups first, in
    order, then zeros."""
    *lead, w = parity.shape
    if not group:
        empty = torch.zeros((*lead, 0), dtype=torch.int32, device=parity.device)
        return empty, parity
    g = w // group
    grouped = parity.reshape(*lead, g, group)
    flags = (grouped != 0).any(dim=-1)
    idx = torch.arange(g, dtype=torch.int64, device=parity.device)
    key = torch.where(flags, 0, g) + idx  # unique keys: nonzero groups first
    order = torch.argsort(key, dim=-1)
    packed = torch.take_along_dim(
        grouped, order[..., None].expand(*lead, g, group), dim=-2
    ).reshape(*lead, w)
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
    picks the product (``swar`` or ``mxu``); the outputs are the same.
    On the card: one memset and one K1 launch (plus the pack launch with
    group == 256), finalized by K1's last block."""
    B, k, w = words.shape
    m = parity_shards
    _check_group(group, w)
    rs.check_formulation(formulation)
    dev = words.device
    if dev.type == "cpu":
        return encode_pack_plain(words, m, shard_len, group, formulation)
    _require_cuda(words, "encode_pack", 3)
    plan = _enc_plan(B, k, m, w, group, formulation, dev)
    # parity, then the digests and the last-block ticket: one allocation,
    # whose tail the entry zeroes with one memset
    buf = torch.empty(plan.buf_words, dtype=torch.int32, device=dev)
    parity = buf.as_strided(*plan.parity)
    acc = buf.data_ptr() + 4 * plan.parity_words
    flags, packed = _launch_encode_pack(
        plan, words, parity, acc, acc + 4 * plan.digest_words, True, 0,
        shard_len)
    digests = buf.as_strided(*plan.digests)
    if formulation == "mxu":
        _count("encode_pack[mxu]")
    elif group:
        _count("encode_pack")
    else:
        _count("encode_pack", "encode_pack[group=0]")
    return parity, digests, flags, packed


@dataclasses.dataclass(frozen=True, eq=False)
class _EncPlan:
    """K1's launch constants for one call shape (``_enc_plan``)."""

    B: int
    k: int
    m: int
    w: int
    group: int
    terms: int  # address of the term program's blob
    terms_len: int
    amat: int  # address of the mxu operand, or 0 (swar)
    operand: "torch.Tensor | None"  # holds amat (_mxu_tensor may drop it)
    tiles_per_block: int
    no_flags: "torch.Tensor | None"  # the (B, m, 0) flags of group=0
    parity_words: int
    digest_words: int
    buf_words: int  # parity + digests + the ticket
    parity: tuple  # as_strided (size, stride) of parity in encode_pack's buffer
    digests: tuple  # the same of the digests, after parity


@functools.lru_cache(maxsize=1024)
def _enc_plan(B: int, k: int, m: int, w: int, group: int, formulation: str,
              device: torch.device) -> _EncPlan:
    """K1's launch constants for one call shape, made once: the term
    program (cached per (k, m)), the mxu operand, the grid and the
    layout of encode_pack's one buffer."""
    if not (1 <= k <= _MAX_ROWS and 0 <= m <= _MAX_ROWS):
        raise ValueError(f"encode_pack supports k, m <= {_MAX_ROWS}")
    terms = parity_terms(k, m)
    operand = (_mxu_operand(gf.parity_matrix(k, m), device)
               if formulation == "mxu" else None)
    amat = 0 if operand is None else operand.data_ptr()
    grid = pipelined_grid if amat else encode_grid
    tpb, _per_stripe = grid(B, w, sm_count(device))
    no_flags = (None if group else
                torch.empty((B, m, 0), dtype=torch.int32, device=device))
    n, pw = k + m, B * m * w
    return _EncPlan(
        B, k, m, w, group, ctypes.addressof(terms.blob), len(terms.blob),
        amat, operand, tpb, no_flags, pw, B * n * 8, pw + B * n * 8 + 1,
        ((B, m, w), (m * w, w, 1)), ((B, n, 8), (n * 8, 8, 1), pw),
    )


def _launch_encode_pack(plan: _EncPlan, words, parity, acc_ptr, ticket_ptr,
                        zero_acc, word_offset, shard_len):
    """K1 on checked CUDA words into ``parity``, XORing the partials into
    the accumulator at ``acc_ptr`` (zeroed first with ``zero_acc``); a
    ticket address (``ticket_ptr``, or 0) makes the last block finalize
    them.  Returns (flags, packed)."""
    B, k, m, w = plan.B, plan.k, plan.m, plan.w
    dev = words.device
    if plan.group:
        flags = torch.empty((B, m, w // TILE), dtype=torch.int32, device=dev)
        packed = torch.empty_like(parity)
        fptr, pptr = flags.data_ptr(), packed.data_ptr()
    else:
        flags, packed, fptr, pptr = plan.no_flags, parity, 0, 0
    rc = _load().mtt_encode_pack(_ENCODE_ARGS.pack(
        words.data_ptr(), parity.data_ptr(), acc_ptr, ticket_ptr, fptr, pptr,
        plan.terms, plan.amat, torch._C._cuda_getCurrentRawStream(dev.index),
        dev.index, B, k, m, w, plan.group, int(zero_acc), plan.tiles_per_block,
        plan.terms_len, shard_len & 0xFFFFFFFF, word_offset & 0xFFFFFFFF,
    ))
    _check_rc(rc, "encode_pack")
    return flags, packed


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
    # the last chunk's last block finalizes: it needs a zeroed ticket,
    # held here until the launch is enqueued (a freed one could be handed
    # to the outputs)
    ticket = (torch.empty(1, dtype=torch.int32, device=chunk.device)
              if finalize else None)
    parity = torch.empty((B, m, cw), dtype=torch.int32, device=chunk.device)
    flags, packed = _launch_encode_pack(
        _enc_plan(B, k, m, cw, group, "swar", chunk.device), chunk, parity,
        acc.data_ptr(), 0 if ticket is None else ticket.data_ptr(), False,
        word_offset, shard_len,
    )
    _count("encode_pack[subchunk]")
    return parity, acc, flags, packed


# ---------------------------------------------------------------------------
# K12 group_flags, K13 pack_nonzero_groups (the legacy drain's passes)
# ---------------------------------------------------------------------------


def group_flags_plain(words: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version of group_flags (any device)."""
    *lead, w = words.shape
    grouped = words.reshape(*lead, w // group, group)
    return (grouped != 0).any(dim=-1).to(torch.int32)


def pack_nonzero_groups_plain(words: torch.Tensor, group: int):
    """Plain version of pack_nonzero_groups (any device): K1's pack leg's
    function on a plane of its own."""
    return _flags_and_pack(words, group)


def pack_split(g: int, cluster: int, passes: int = 1) -> "tuple[int, int]":
    """(seg, passes) of a row of ``g`` groups over a K13 cluster: at
    least ``passes`` passes and as many more as keep each block's segment
    within ``PACK_SEG_MAX`` groups, the groups spread evenly over them.
    Pass p's span is groups p * cluster * seg .. (p + 1) * cluster * seg
    - 1, block r's segment of it the r-th run of ``seg``."""
    passes = max(passes, -(-g // (cluster * PACK_SEG_MAX)))
    return -(-g // (cluster * passes)), passes


def pack_plan(rows: int, g: int, sms: int, resident) -> "tuple[int, int, int]":
    """K13's (cluster, seg, passes) for ``rows`` rows of ``g`` groups:
    one cluster a row, of 16 blocks where the rows at 16 still fit the
    SMs (heal's 4 rows: 64 SMs, where 8 a row would leave 100 idle), else
    of 8 (the portable size); then the fewest passes at which the card
    holds every row's cluster at once - ``resident(cluster, seg)``, the
    clusters of that split the card holds (``mtt_pack_clusters``).  A
    second wave of clusters waits for a whole first one: on an H100 the
    main path's 16 rows in one pass of 160-KiB segments fit 15 clusters
    of 8, and two passes of 80 KiB measured faster.  Past 16-group
    segments no split is tried: the fewest passes serve in waves."""
    for cluster in ((16, 8) if rows * 16 <= sms else (8,)):
        seg, passes = pack_split(g, cluster)
        while True:
            if resident(cluster, seg) >= rows:
                return cluster, seg, passes
            if seg <= 16:
                break
            seg, passes = pack_split(g, cluster, passes + 1)
    return (8, *pack_split(g, 8))


@functools.lru_cache(maxsize=1024)
def _pack_plan(rows: int, w: int, index: int) -> "tuple[int, int, int]":
    """K13's plan over a (rows, w) plane on device ``index``, made once
    per shape."""
    lib = _load()
    return pack_plan(rows, w // TILE, sm_count(torch.device("cuda", index)),
                     lambda cluster, seg: lib.mtt_pack_clusters(index, cluster, seg))


def group_plan(groups: int, sms: int) -> int:
    """K12's run: the groups each warp walks, at most ``_FLAGS_BATCH`` (so
    a warp issues all its loads before its first vote) and otherwise as
    few as keep the grid of ``-(-groups // (8 * run))`` blocks within four
    waves of ``_FLAGS_BLOCKS_PER_SM`` blocks an SM.  On an H100 that is
    run 2 at the main path's plane (1,280 blocks), which beat one group a
    warp and the one-wave grid of runs of 5 in ``chip_smoke.py --only
    legacy``'s sweep, and run 1 at heal's.  Warp v takes groups v * run ..
    v * run + run - 1 (the last warp fewer), so the runs cover every group
    once."""
    waves = 4 * sms * _FLAGS_BLOCKS_PER_SM * 8  # warps
    return min(_FLAGS_BATCH, max(1, -(-groups // waves)))


@functools.lru_cache(maxsize=1024)
def _group_plan(groups: int, index: int) -> int:
    """K12's run over ``groups`` groups on device ``index``, made once
    per shape."""
    return group_plan(groups, sm_count(torch.device("cuda", index)))


def _group_call(words: torch.Tensor, group: int, name: str, pack: bool,
                run: "int | None" = None):
    """K12 (or with ``pack`` K13) on ``words``, each check once and on the
    tensor's cheapest attributes (the call is a few microseconds of host
    time on the card): (flags, packed or None).  ``run`` overrides K12's
    plan (``group_plan``)."""
    shape = words.shape
    if not shape or group <= 0 or shape[-1] % group:
        raise ValueError(f"{name}: the last dim must be a multiple of group {group}")
    if not words.is_cuda:
        if words.device.type != "cpu":
            raise ValueError(f"{name}: expected a CUDA tensor, got {words.device}")
        if pack:
            return pack_nonzero_groups_plain(words, group)
        return group_flags_plain(words, group), None
    if words.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32, got {words.dtype}")
    if not words.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if group != TILE:
        raise ValueError(f"{name}: the kernel takes group {TILE}, got {group}")
    w = shape[-1]
    rows = words.numel() // w if w else 0
    index = words.get_device()
    flags = words.new_empty((*shape[:-1], w // TILE))
    packed = words.new_empty(shape) if pack else None
    if rows:
        if pack:
            cluster, seg, _passes = _pack_plan(rows, w, index)
        else:
            cluster, seg = 0, run or _group_plan(rows * (w // TILE), index)
        lib = _lib if _lib is not None else _load()
        rc = lib.mtt_group_flags(_GROUP_ARGS.pack(
            words.data_ptr(), flags.data_ptr(), packed.data_ptr() if pack else 0,
            torch._C._cuda_getCurrentRawStream(index), rows, index, w, cluster, seg,
        ))
        _check_rc(rc, name)
        _count("pack_nonzero_groups" if pack else "group_flags")
    return flags, packed


def group_flags(words: torch.Tensor, group: int = TILE) -> torch.Tensor:
    """(..., w) int32 words -> (..., w // group) int32 flags, 1 where the
    group of ``group`` words holds a nonzero word.  On the card: one K12
    launch, each warp a run of groups (``group_plan``; group must be
    256); any rows, any 4-byte aligned start."""
    return _group_call(words, group, "group_flags", False)[0]


def pack_nonzero_groups(words: torch.Tensor, group: int = TILE):
    """(..., w) int32 words -> (flags (..., g) int32 0/1, packed (..., w)
    int32): each row's nonzero groups moved to the front in order, zeros
    behind them.  On the card: one K13 launch, one cluster a row (group
    must be 256); any rows, any 4-byte aligned start."""
    return _group_call(words, group, "pack_nonzero_groups", True)


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


def _check_pipelined(m: int, w: int) -> None:
    if m < 1:
        raise ValueError("encode_pack_pipelined needs parity_shards >= 1")
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")


@dataclasses.dataclass(frozen=True, eq=False)
class _EncPipePlan:
    """K5's launch constants for one call shape (``_encp_plan``): the
    term program, the mxu operand, the grid, and where parity, packed,
    flags, digests and the ticket lie in the call's one buffer."""

    terms: int  # address of the term program's blob
    terms_len: int
    amat: int  # address of the mxu operand, or 0 (swar)
    operand: "torch.Tensor | None"  # holds amat (_mxu_tensor may drop it)
    tiles_per_block: int
    no_flags: "torch.Tensor | None"  # the (B, m, 0) flags of group=0
    buf_words: int  # parity, packed, flags, digests, ticket
    packed_off: int  # byte offsets into the buffer
    flags_off: int
    acc_off: int
    parity: tuple  # as_strided (size, stride[, offset]) of each output
    packed: tuple
    flags: tuple
    digests: tuple


@functools.lru_cache(maxsize=1024)
def _encp_plan(B: int, k: int, m: int, w: int, group: int, formulation: str,
               device: torch.device) -> _EncPipePlan:
    """K5's launch constants for one call shape, made once (checks the
    shape and the options on the first call of each)."""
    _check_group(group, w)
    rs.check_formulation(formulation)
    _check_pipelined(m, w)
    if not (1 <= k <= _MAX_ROWS and m <= _MAX_ROWS):
        raise ValueError(f"encode_pack_pipelined supports k, m <= {_MAX_ROWS}")
    terms = parity_terms(k, m)
    mxu = formulation == "mxu"
    operand = _mxu_operand(gf.parity_matrix(k, m), device) if mxu else None
    tpb, _per_stripe = encode_pipelined_grid(B, w, sm_count(device), mxu)
    n, pw = k + m, B * m * w
    g = w // TILE if group else 0
    packed_w = pw if group else 0
    flags_at, acc_at = pw + packed_w, pw + packed_w + B * m * g
    return _EncPipePlan(
        ctypes.addressof(terms.blob), len(terms.blob),
        0 if operand is None else operand.data_ptr(), operand, tpb,
        None if group else torch.empty((B, m, 0), dtype=torch.int32, device=device),
        acc_at + B * n * 8 + 1, 4 * pw, 4 * flags_at, 4 * acc_at,
        ((B, m, w), (m * w, w, 1)), ((B, m, w), (m * w, w, 1), pw),
        ((B, m, g), (m * g, g, 1), flags_at), ((B, n, 8), (n * 8, 8, 1), acc_at),
    )


def encode_pack_pipelined(words: torch.Tensor, parity_shards: int,
                          shard_len: int, group: int = 0,
                          formulation: str = "swar"):
    """K5: encode_pack's outputs, bit for bit, from the pipelined kernel
    (persistent grid, cp.async tile ring, K1's product, last-block
    finalize).  Needs parity_shards >= 1, as P6 does, and w % 4 == 0.
    On the card: one allocation for every output, the entry's memset of
    digests and ticket, the K5 launch and, with group == 256, the pack
    launch."""
    B, k, w = words.shape
    m = parity_shards
    if words.device.type == "cpu":
        _check_group(group, w)
        rs.check_formulation(formulation)
        _check_pipelined(m, w)
        return encode_pack_pipelined_plain(words, m, shard_len, group,
                                           formulation)
    _require_cuda(words, "encode_pack_pipelined", 3)
    src = words.data_ptr()
    if src % 16:
        raise ValueError("encode_pack_pipelined: expected a 16-byte aligned tensor")
    dev = words.device
    plan = _encp_plan(B, k, m, w, group, formulation, dev)
    buf = torch.empty(plan.buf_words, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    rc = _load().mtt_encode_pack_pipelined(_ENCODE_PIPE_ARGS.pack(
        src, base, base + plan.packed_off, base + plan.flags_off,
        base + plan.acc_off, plan.terms, plan.amat,
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index, B, k, m, w,
        group, plan.tiles_per_block, plan.terms_len, shard_len & 0xFFFFFFFF,
    ))
    _check_rc(rc, "encode_pack_pipelined")
    parity = buf.as_strided(*plan.parity)
    if group:
        packed, flags = buf.as_strided(*plan.packed), buf.as_strided(*plan.flags)
    else:
        packed, flags = parity, plan.no_flags
    _count("encode_pack_pipelined[mxu]" if plan.amat else "encode_pack_pipelined")
    return parity, buf.as_strided(*plan.digests), flags, packed


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
    """(o, s) GF matrix over rows ``rows`` of (B, R, w) words -> (B, o, w).
    On the card one K3 launch: unit rows of the matrix are copies, the
    others the product of ``gf_terms`` (made once per (matrix, rows))."""
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
    dev = words.device
    out = torch.empty((B, o, w), dtype=torch.int32, device=dev)
    if B == 0 or w == 0:
        return out
    terms = gf_terms(matrix, rows)
    rc = _load().mtt_gf_matmul(_GF_ARGS.pack(
        words.data_ptr(), out.data_ptr(), ctypes.addressof(terms.blob),
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index, B, R, w, o,
        s, gf_grid(B, w, sm_count(dev)), len(terms.blob), len(terms.out),
    ))
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


def _check_vr(n: int, w: int, present, k: int) -> None:
    if len(present) != n:
        raise ValueError(f"present has {len(present)} rows, shards {n}")
    if not 1 <= k <= n <= _MAX_ROWS:
        raise ValueError(f"verify_reconstruct supports k <= n <= {_MAX_ROWS}")
    if w % 4:
        raise ValueError(f"word count {w} must be a multiple of 4")


def _bucket(v: int) -> int:
    """The kernels' row bucket (``bucket`` in codec.cu; the K4 and K6
    entries refuse a term program sized for another)."""
    return 4 if v <= 4 else (8 if v <= 8 else 16)


def _rb_max(kb: int) -> int:
    """Rebuilt rows a K4 / K6 term program holds (``kRbMax`` in codec.cu;
    the entries check the program's size against their own)."""
    return {4: 4, 8: 8, 16: 7}[kb]


@dataclasses.dataclass(frozen=True, eq=False)
class VrTerms:
    """K4's and K6's term program for one (present, k), made once by
    ``vr_terms``.

    Tile slot j holds present row ``rows[j]``; slots 0 .. k-1 are the
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


def _vr_terms_bytes(kb: int) -> int:
    """The packed size of a K4 / K6 term program (``terms_bytes<KB>()`` in
    codec.cu; the entries refuse another): masks, row, copy, rebuilt."""
    return 4 * _rb_max(kb) * 8 * kb + 2 * _MAX_ROWS + _rb_max(kb)


@functools.lru_cache(maxsize=1024)
def vr_terms(present: "tuple[bool, ...]", k: int) -> VrTerms:
    """K4's and K6's term program (``VrTerms``), compiled once per (present, k)
    from the reconstruction matrix's term program (``_gf_program``): its
    copies are the present data rows, its product rows the absent ones."""
    n = len(present)
    idx = _survivors(present, k)
    rmat = np.ascontiguousarray(gf.reconstruction_matrix(k, n - k, idx))
    slot_copy, rebuilt, bits = _gf_program(rmat.tobytes(), k, k, True)
    rows = tuple(i for i, p in enumerate(present) if p)
    kb = _bucket(k)
    if len(rebuilt) > _rb_max(kb):
        raise ValueError(f"{len(rebuilt)} rebuilt rows exceed {_rb_max(kb)}")
    copy = slot_copy + (-1,) * (len(rows) - k)
    masks = np.zeros((_rb_max(kb), 8, kb), dtype=np.uint32)
    for j in range(k):
        masks[: len(rebuilt), :, j] = np.where((bits >> j) & 1, 0xFFFFFFFF, 0)
    packed = b"".join((
        masks.astype("<u4").tobytes(),
        np.array(rows + (0,) * (_MAX_ROWS - len(rows)), np.uint8).tobytes(),
        np.array(copy + (-1,) * (_MAX_ROWS - len(copy)), np.int8).tobytes(),
        np.array(rebuilt + (0,) * (_rb_max(kb) - len(rebuilt)), np.uint8).tobytes(),
    ))
    blob = ctypes.create_string_buffer(packed, len(packed))
    return VrTerms(sum(1 << i for i in rows), rows, copy, rebuilt, masks, blob)


@functools.lru_cache(maxsize=256)
def _mxu_rebuilt_operand(present: "tuple[bool, ...]", k: int,
                         device) -> torch.Tensor:
    """The A operand of K4 [mxu] and K6 [mxu], made once per (present, k,
    device): the rows of the reconstruction matrix over the first k
    present rows that are rebuilt (``vr_terms(present, k).rebuilt``),
    (rb, k), in ``mxu_fragments`` order.  The present data rows are copies
    and take none."""
    idx = _survivors(present, k)
    rmat = gf.reconstruction_matrix(k, len(present) - k, idx)
    return _mxu_operand(rmat[list(vr_terms(present, k).rebuilt)], device)


@dataclasses.dataclass(frozen=True, eq=False)
class _VrPlan:
    """K4's launch constants for one call shape (``_vr_plan``): the term
    program (slots, copies, rebuilt rows and their masks), the mxu
    operand, the grid, and where data, digests (whole rows) and the ticket
    lie in the call's one buffer."""

    terms: VrTerms
    operand: "torch.Tensor | None"  # _mxu_rebuilt_operand (mxu), else None
    amat: int  # its address, or 0 (swar)
    tiles_per_block: int
    np: int  # present rows: the tile's slots
    rb: int  # rebuilt rows
    buf_words: int  # data, [digests,] ticket
    acc_off: int  # byte offsets into the buffer: the digests (whole rows)
    ticket_off: int  # ... and the ticket
    data: tuple  # as_strided (size, stride[, offset]) of each output
    digests: "tuple | None"


@functools.lru_cache(maxsize=1024)
def _vr_plan(B: int, n: int, k: int, w: int, present: "tuple[bool, ...]",
             formulation: str, whole: bool, device: torch.device) -> _VrPlan:
    """K4's launch constants for one call shape, made once (checks the
    shape on the first call of each): the term program (``vr_terms``,
    cached per (present, k)), the rebuilt rows' operand (mxu),
    ``pipelined_grid`` and the buffer layout: data, then with ``whole``
    the digests, then the ticket."""
    _check_vr(n, w, present, k)
    if w < 1:
        raise ValueError("verify_reconstruct needs at least one word a row")
    terms = vr_terms(present, k)
    operand = (_mxu_rebuilt_operand(present, k, device)
               if formulation == "mxu" else None)
    tpb, _per_stripe = pipelined_grid(B, w, sm_count(device))
    dw = B * k * w
    dig = B * n * 8 if whole else 0
    return _VrPlan(
        terms, operand, 0 if operand is None else operand.data_ptr(), tpb,
        len(terms.rows), len(terms.rebuilt), dw + dig + 1, 4 * dw, 4 * (dw + dig),
        ((B, k, w), (k * w, w, 1)),
        ((B, n, 8), (n * 8, 8, 1), dw) if whole else None,
    )


def _launch_vr(plan: _VrPlan, shards, k: int, base: int, acc: int, ticket: int,
               zero_acc: bool, word_offset: int, shard_len: int) -> None:
    """K4 on checked CUDA shards: data into the buffer at ``base``,
    partials XORed into ``acc`` (zeroed first with ``zero_acc``); a ticket
    address (or 0) makes the last block finalize them."""
    B, n, w = shards.shape
    dev = shards.device
    t = plan.terms
    rc = _load().mtt_verify_reconstruct(_VR_ARGS.pack(
        shards.data_ptr(), base, acc, ticket, ctypes.addressof(t.blob), plan.amat,
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index, B, n, k, w,
        plan.np, plan.rb, plan.tiles_per_block, len(t.blob), int(zero_acc),
        t.present_mask, shard_len & 0xFFFFFFFF, word_offset & 0xFFFFFFFF,
    ))
    _check_rc(rc, "verify_reconstruct")


def verify_reconstruct(shards: torch.Tensor, present: "tuple[bool, ...]",
                       data_shards: int, shard_len: int,
                       formulation: str = "swar"):
    """(B, n, w) shard words as read + the present-row mask -> (data
    (B, k, w) rebuilt from the first k present rows, digests (B, n, 8)
    finalized), int32.  Only the digests of present rows are the rows'
    phash256; an absent row is neither read nor hashed.  ``formulation``
    picks the product (``swar`` or ``mxu``); the outputs are the same.
    On the card: one allocation for data, digests and ticket, the entry's
    memset and one K4 launch, finalized by its last block."""
    B, n, w = shards.shape
    k = data_shards
    rs.check_formulation(formulation)
    if shards.device.type == "cpu":
        _check_vr(n, w, present, k)
        return verify_reconstruct_plain(shards, present, k, shard_len,
                                        formulation)
    _require_cuda(shards, "verify_reconstruct", 3)
    dev = shards.device
    if B == 0:
        _check_vr(n, w, present, k)
        return (torch.empty((0, k, w), dtype=torch.int32, device=dev),
                torch.zeros((0, n, 8), dtype=torch.int32, device=dev))
    plan = _vr_plan(B, n, k, w, tuple(present), formulation, True, dev)
    buf = torch.empty(plan.buf_words, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    _launch_vr(plan, shards, k, base, base + plan.acc_off, base + plan.ticket_off,
               True, 0, shard_len)
    _count("verify_reconstruct[mxu]" if plan.amat else "verify_reconstruct")
    return buf.as_strided(*plan.data), buf.as_strided(*plan.digests)


def verify_reconstruct_subchunk(chunk: torch.Tensor, acc: torch.Tensor,
                                word_offset: int,
                                present: "tuple[bool, ...]",
                                data_shards: int, shard_len: int,
                                finalize: bool = False):
    """K4 on one (B, n, cw) sub-chunk whose first word is column
    ``word_offset`` of the row: (data (B, k, cw), acc).  The partials of
    the chunk's present rows are XORed into ``acc`` (B, n, 8) IN PLACE;
    with ``finalize`` acc then holds the finalized digests of the whole
    row of ``shard_len`` bytes.  On the card: one allocation (the data;
    with ``finalize`` the ticket after it, which the entry zeroes) and one
    K4 launch, whose last block finalizes with ``finalize``."""
    B, n, cw = chunk.shape
    k = data_shards
    if word_offset % 4:
        raise ValueError(f"word_offset {word_offset} must be a multiple of 4")
    if tuple(acc.shape) != (B, n, 8):
        raise ValueError(f"acc must be {(B, n, 8)}, got {tuple(acc.shape)}")
    if chunk.device.type == "cpu":
        _check_vr(n, cw, present, k)
        return verify_reconstruct_subchunk_plain(
            chunk, acc, word_offset, present, k, shard_len, finalize
        )
    _require_cuda(chunk, "verify_reconstruct_subchunk", 3)
    _require_cuda(acc, "verify_reconstruct_subchunk acc", 3)
    dev = chunk.device
    if B == 0:
        _check_vr(n, cw, present, k)
        return torch.empty((0, k, cw), dtype=torch.int32, device=dev), acc
    plan = _vr_plan(B, n, k, cw, tuple(present), "swar", False, dev)
    if finalize:
        buf = torch.empty(plan.buf_words, dtype=torch.int32, device=dev)
        data, ticket = buf.as_strided(*plan.data), buf.data_ptr() + plan.ticket_off
    else:  # no ticket: the data alone
        data, ticket = torch.empty(plan.data[0], dtype=torch.int32, device=dev), 0
    _launch_vr(plan, chunk, k, data.data_ptr(), acc.data_ptr(), ticket, False,
               word_offset, shard_len)
    _count("verify_reconstruct[subchunk]")
    return data, acc


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
    the present data rows and the product of ``vr_terms`` - under mxu of
    ``_mxu_rebuilt_operand`` - for the rest, last-block finalize)."""
    B, n, w = shards.shape
    k = data_shards
    _check_vr(n, w, present, k)
    rs.check_formulation(formulation)
    if shards.device.type == "cpu":
        return verify_reconstruct_pipelined_plain(shards, present, k,
                                                  shard_len, formulation)
    _require_cuda(shards, "verify_reconstruct_pipelined", 3)
    _require_aligned(shards, "verify_reconstruct_pipelined")
    present = tuple(present)
    terms = vr_terms(present, k)
    dev = shards.device
    amat = (_mxu_rebuilt_operand(present, k, dev).data_ptr()
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


def k7_fragments(matrix: np.ndarray) -> np.ndarray:
    """K7's B operand: the lifted (8o, 8s) bit matrix of ``matrix``
    (rs.bit_matrix) in the order of its transposed ``mma.m16n8k128`` on
    1-bit values, (16 n-tiles, 32 lanes) uint32.  Lane = tig + 4 g of
    n-tile j holds column g: bit 2 (j % 4) + g % 2 of output row g // 2 +
    4 (j // 4), over the K bits 32 tig + 8 i + b = bit b of input row
    tig + 4 i.  Rows and inputs past (o, s) are zero, up to 16 x 16; a
    launch reads the first bucket(o) n-tiles."""
    o, s = matrix.shape
    full = np.zeros((8 * _MAX_ROWS, 8 * _MAX_ROWS), dtype=np.uint32)
    full[: 8 * o, : 8 * s] = rs.bit_matrix(matrix)
    j = np.arange(16)[:, None, None, None]
    lane = np.arange(32)[None, :, None, None]
    g, tig = lane >> 2, lane & 3
    i = np.arange(4)[None, None, :, None]
    b = np.arange(8)[None, None, None, :]
    row = 8 * (g // 2 + 4 * (j // 4)) + 2 * (j % 4) + g % 2
    col = 8 * (tig + 4 * i) + b
    bits = full[row, col] << (8 * i + b).astype(np.uint32)
    return bits.reshape(16, 32, 32).sum(axis=-1, dtype=np.uint64).astype(np.uint32)


def k7_blocks_per_sm(o: int, s: int) -> int:
    """The residency K7's instantiation for (o, s) is compiled for
    (``k7_min_blocks`` in codec.cu): 2, or 1 where its registers would
    not fit 2 (16 output rows, or 8 with 16 input rows)."""
    ob, sb = _bucket(o), _bucket(s)
    return 2 if ob <= 8 and sb + ob <= 20 else 1


@functools.lru_cache(maxsize=1024)
def k7_grid(length: int, sms: int, o: int, s: int) -> "tuple[int, int]":
    """K7's persistent grid, (blocks, tiles per block): at most
    ``k7_blocks_per_sm(o, s)`` blocks per SM, each a contiguous run of
    ``K7_TILE``-byte tiles; blocks past the last tile (when the runs
    round up) return at once."""
    ntiles = -(-length // K7_TILE)
    blocks = min(ntiles, sms * k7_blocks_per_sm(o, s))
    return blocks, -(-ntiles // blocks)


@functools.lru_cache(maxsize=64)
def _k7_operand(matrix_key: bytes, o: int, s: int, device: torch.device) -> torch.Tensor:
    """k7_fragments of a matrix as a device tensor, made once per matrix
    and device (2 KiB)."""
    matrix = np.frombuffer(matrix_key, dtype=np.uint8).reshape(o, s)
    return torch.from_numpy(k7_fragments(matrix).view(np.int32)).to(device)


def gf_matmul_mxu(matrix: np.ndarray, shards: torch.Tensor,
                  stamps: "torch.Tensor | None" = None) -> torch.Tensor:
    """(o, s) GF matrix @ (s, length) uint8 shards -> (o, length) uint8
    through the tensor-core product of the lifted bit matrix (K7); any
    length.  The plain version is rs.gf_matmul_mxu_plain.  ``stamps``, a
    zeroed (blocks, 7) int64 tensor on the card, receives each block's
    phase cycles (codec.cu, chip_smoke.k7_phases)."""
    o, s = matrix.shape
    if shards.dim() != 2 or shards.shape[0] != s:
        raise ValueError(
            f"matrix wants ({s}, length) shards, got {tuple(shards.shape)}"
        )
    dev = shards.device
    if dev.type == "cpu":
        return rs.gf_matmul_mxu_plain(matrix, shards)
    if dev.type != "cuda":
        raise ValueError(f"gf_matmul_mxu: expected a CUDA tensor, got {dev}")
    if shards.dtype != torch.uint8:
        raise TypeError(f"gf_matmul_mxu: expected uint8 shards, got {shards.dtype}")
    if not shards.is_contiguous():
        raise ValueError("gf_matmul_mxu: expected a contiguous tensor")
    if not (1 <= o <= _MAX_ROWS and 1 <= s <= _MAX_ROWS):
        raise ValueError(f"gf_matmul_mxu supports o, s <= {_MAX_ROWS}")
    length = shards.shape[1]
    if length >= 1 << 31:
        raise ValueError("gf_matmul_mxu: rows of at most 2^31 - 1 bytes")
    out = torch.empty((o, length), dtype=torch.uint8, device=dev)
    if length == 0:
        return out
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    frags = _k7_operand(m.tobytes(), o, s, dev)
    blocks, tpb = k7_grid(length, sm_count(dev), o, s)
    if stamps is not None:
        _require_cuda(stamps, "stamps", 2, torch.int64)
        if stamps.shape[0] < blocks or stamps.shape[1] != 7:
            raise ValueError(f"stamps: expected ({blocks}, 7), got {tuple(stamps.shape)}")
    rc = _load().mtt_gf_matmul_mxu(_MXU_ARGS.pack(
        shards.data_ptr(), out.data_ptr(), frags.data_ptr(),
        0 if stamps is None else stamps.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index, o, s, length,
        blocks, tpb,
    ))
    _check_rc(rc, "gf_matmul_mxu")
    _count("gf_matmul_mxu")
    return out
