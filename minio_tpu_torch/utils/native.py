"""ctypes loader of the native C++ GF(2^8) codec (``csrc/gf_cpu.cc``).

The host erasure codec of the port: ``codec/backend.py``'s ``CpuBackend``
runs it, and the server serves every erasure set through it under
``MINIO_ERASURE_BACKEND=cpu``.  It is the counterpart of
klauspost/reedsolomon's role in the reference (AVX2 nibble-table GF
products), and the yardstick the card's codec is measured beside.

``lib()`` builds the shared library with g++ on first use into
``minio_tpu_torch/build/`` and loads it with ``ctypes.CDLL``, which
releases the GIL around every call.  The artifact is fingerprinted by a
hash of the source and the compiler flags (``libgf_cpu-<hash>.so``), so
an edited source or changed flags build anew instead of loading a stale
body.  A build goes to a per-process temporary file and ``os.replace``
puts it in place, so concurrent first uses (test workers, server
processes) each see a whole library; other fingerprints of the same
variant are pruned, and a file another process pruned first is no error.

There is no fallback: a failed build raises with the compiler's output,
and a library that lacks a symbol raises naming it.

The hot entry points are batch-native: ``encode_and_hash_cpu`` runs the
fused single-pass encode+digest over a whole (B, k, L) batch in ONE C
call (stripe-parallel inside, ``default_threads`` workers), and
``reconstruct_batch_cpu`` / ``reconstruct_and_verify_cpu`` are the decode
twins.  The per-stripe ``gf_matmul_cpu`` serves the split baseline
(``CpuBackend.encode_split``) and the tests.

``MINIO_TPU_SANITIZE=1`` selects an ASan/UBSan build under its own
fingerprint (``-san.so``); ``sanitizer_env`` is the environment of a
subprocess that can load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "gf_cpu.cc")
_BUILD_DIR = os.path.join(_PKG, "build")

_CFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

# ASan+UBSan build variant (MINIO_TPU_SANITIZE=1): undefined behaviour
# is fatal (-fno-sanitize-recover), frames are kept for readable
# reports.  -O1 instead of -O3: the redzone checks dominate anyway, and
# the sanitized library exists for the slow test sweep, not for speed.
_SAN_CFLAGS = [
    "-O1",
    "-g",
    "-fno-omit-frame-pointer",
    "-fsanitize=address,undefined",
    "-fno-sanitize-recover=all",
]

# every export of csrc/gf_cpu.cc, bound in lib()
SYMBOLS = ("gf_matmul", "gf_mul_acc", "phash256_rows", "encode_and_hash",
           "reconstruct_batch", "reconstruct_and_verify", "gf_has_avx2")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}


def _variant() -> str:
    """"" for the production build, "san" under MINIO_TPU_SANITIZE=1."""
    return "san" if os.environ.get("MINIO_TPU_SANITIZE") == "1" else ""


def _flags(variant: str = "") -> "list[str]":
    if variant == "san":
        return [f for f in _CFLAGS if f != "-O3"] + _SAN_CFLAGS
    return list(_CFLAGS)


def _fingerprint(variant: str = "") -> str:
    """Hash of the source body + compiler flags: the .so identity."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(b"\x00" + " ".join(_flags(variant)).encode())
    return h.hexdigest()[:16]


def _so_path(variant: str = "") -> str:
    suffix = f"-{variant}" if variant else ""
    return os.path.join(
        _BUILD_DIR, f"libgf_cpu-{_fingerprint(variant)}{suffix}.so"
    )


def _build(variant: str = "") -> str:
    """The library's path, compiled first when no build of this
    fingerprint exists.  Raises RuntimeError with the compiler's output
    when g++ fails (or is missing)."""
    so = _so_path(variant)
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp.{os.getpid()}"
    cmd = ["g++", *_flags(variant), "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native codec build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass  # g++ wrote nothing
        raise RuntimeError(
            f"native codec build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    # retire other fingerprints OF THE SAME VARIANT so the build dir does
    # not accrete one .so per edit; the sanitized and production
    # artifacts coexist (pruning across variants would rebuild on every
    # alternation between the sanitizer sweep and normal runs)
    for name in os.listdir(_BUILD_DIR):
        if (
            name.startswith("libgf_cpu-")
            and name.endswith(".so")
            and name.endswith("-san.so") == (variant == "san")
            and os.path.join(_BUILD_DIR, name) != so
        ):
            try:
                os.remove(os.path.join(_BUILD_DIR, name))
            except OSError:
                pass  # another process pruned it first
    return so


def default_threads() -> int:
    """Stripe-parallel worker count of the batch entry points.

    ``MINIO_TPU_NATIVE_THREADS`` overrides; the default is the host's
    core count.  At 1 the native passes run strictly inline (no thread
    spawn).  The workers split a batch by stripes, so a batch of one
    stripe runs on one core whatever the count.
    """
    try:
        v = int(os.environ.get("MINIO_TPU_NATIVE_THREADS") or 0)
    except ValueError:
        v = 0
    if v > 0:
        return v
    return os.cpu_count() or 1


def lib() -> ctypes.CDLL:
    """The loaded library of the current variant, built on first use."""
    variant = _variant()
    with _lock:
        if variant not in _libs:
            path = _build(variant)
            l = ctypes.CDLL(path)
            missing = [s for s in SYMBOLS if not hasattr(l, s)]
            if missing:
                raise RuntimeError(f"{path} lacks {missing}")
            I, P, Z = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
            l.gf_matmul.argtypes = [
                I, I, P, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p), Z,
            ]
            l.gf_mul_acc.argtypes = [ctypes.c_uint8, P, P, Z]
            l.phash256_rows.argtypes = [P, Z, Z, ctypes.c_uint64, P]
            l.encode_and_hash.argtypes = [I, I, I, Z, P, P, P, P, I]
            l.reconstruct_batch.argtypes = [I, I, I, Z, P, P, P, P, I]
            l.reconstruct_and_verify.argtypes = [
                I, I, I, Z, P, P, P, P, P, P, P, I,
            ]
            l.gf_has_avx2.argtypes = []
            for fn in (l.gf_matmul, l.gf_mul_acc, l.phash256_rows,
                       l.encode_and_hash, l.reconstruct_batch,
                       l.reconstruct_and_verify):
                fn.restype = None
            l.gf_has_avx2.restype = ctypes.c_int
            _libs[variant] = l
    return _libs[variant]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _ptr_array(arrs: "list[np.ndarray]") -> "ctypes.Array":
    ptrs = (ctypes.c_void_p * len(arrs))()
    for i, a in enumerate(arrs):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError("rows must be C-contiguous uint8")
        ptrs[i] = _ptr(a)
    return ptrs


def _matrix(m: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(m, dtype=np.uint8)


def gf_matmul_cpu(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out = matrix (o, s) GF-matmul shards (s, len) -> (o, len)."""
    o, s = matrix.shape
    if shards.shape[0] != s:
        raise ValueError(f"{shards.shape[0]} rows for a matrix of {s} columns")
    length = shards.shape[1]
    out = np.zeros((o, length), dtype=np.uint8)
    in_rows = [np.ascontiguousarray(shards[i], dtype=np.uint8) for i in range(s)]
    out_rows = [out[i] for i in range(o)]
    mat = _matrix(matrix)
    lib().gf_matmul(o, s, _ptr(mat), _ptr_array(in_rows),
                    _ptr_array(out_rows), length)
    return out


def gf_mul_acc_cpu(coef: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """dst ^= coef * src in GF(2^8): one native mul-acc (tests)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    dst = np.ascontiguousarray(dst, dtype=np.uint8)
    if src.shape != dst.shape:
        raise ValueError(f"shapes differ: {src.shape} and {dst.shape}")
    lib().gf_mul_acc(coef, _ptr(src), _ptr(dst), src.shape[0])
    return dst


def encode_cpu(data: np.ndarray, parity_shards: int) -> np.ndarray:
    """Native RS encode of one stripe: (k, len) -> (m, len)."""
    from ..ops import gf

    return gf_matmul_cpu(gf.parity_matrix(data.shape[0], parity_shards), data)


def _threads(nthreads: "int | None") -> int:
    return nthreads if nthreads is not None else default_threads()


def encode_and_hash_cpu(
    data: np.ndarray, parity_shards: int, nthreads: "int | None" = None
) -> "tuple[np.ndarray, np.ndarray]":
    """Fused single-pass batch encode+digest: ONE native call per batch.

    data: (B, k, L) uint8, L a multiple of 32.  Returns (parity (B, m, L)
    uint8, digests (B, k+m, 8) uint32, data rows first), bit-identical
    to the split gf_matmul + phash256 path and to the card's
    encode_pack; each byte is read once while L1/L2-hot instead of three
    times through memory.
    """
    from ..ops import gf

    data = np.ascontiguousarray(data, dtype=np.uint8)
    B, k, L = data.shape
    m = parity_shards
    if L % 32:
        raise ValueError(f"shard length {L} must be a multiple of 32")
    parity = np.empty((B, m, L), dtype=np.uint8)
    digests = np.empty((B, k + m, 8), dtype=np.uint32)
    matrix = _matrix(gf.parity_matrix(k, m) if m else np.zeros((0, k)))
    lib().encode_and_hash(
        B, k, m, L, _ptr(data), _ptr(matrix), _ptr(parity), _ptr(digests),
        _threads(nthreads),
    )
    return parity, digests


def _survivors(present: np.ndarray, k: int) -> "tuple[np.ndarray, tuple]":
    idx = tuple(int(i) for i in np.nonzero(present)[0])
    if len(idx) < k:
        raise ValueError(f"need {k} shards to reconstruct, have {len(idx)}")
    return np.asarray(idx[:k], dtype=np.int32), idx


def reconstruct_batch_cpu(
    shards: np.ndarray,
    present: np.ndarray,
    data_shards: int,
    parity_shards: int,
    nthreads: "int | None" = None,
) -> np.ndarray:
    """Batched native reconstruct: (B, n, L) + mask -> (B, k, L), one call."""
    from ..ops import gf

    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    B, n, L = shards.shape
    k = data_shards
    surv, idx = _survivors(np.asarray(present, dtype=bool), k)
    rm = _matrix(gf.reconstruction_matrix(k, parity_shards, idx))
    out = np.empty((B, k, L), dtype=np.uint8)
    lib().reconstruct_batch(
        B, n, k, L, _ptr(shards), _ptr(surv), _ptr(rm), _ptr(out),
        _threads(nthreads),
    )
    return out


def reconstruct_and_verify_cpu(
    shards: np.ndarray,
    digests: np.ndarray,
    present: np.ndarray,
    data_shards: int,
    parity_shards: int,
    nthreads: "int | None" = None,
) -> "tuple[np.ndarray, np.ndarray]":
    """Fused GET-side pass: verify the digests of the present shards AND
    decode the data rows from the first k of them, one memory pass.

    Returns (data (B, k, L) uint8, ok (B, n) bool).  ``data`` is valid
    for a stripe only where every chosen survivor verified; the caller
    re-picks survivors from ``ok`` on the rare bitrot hit.
    """
    from ..ops import gf

    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    B, n, L = shards.shape
    k = data_shards
    if L % 32:
        raise ValueError(f"shard length {L} must be a multiple of 32")
    if digests.shape != (B, n, 8):
        raise ValueError(f"digests must be {(B, n, 8)}, got {digests.shape}")
    pres = np.ascontiguousarray(np.asarray(present, dtype=bool), dtype=np.uint8)
    if pres.shape != (n,):
        raise ValueError(f"present must have {n} entries, got {pres.shape}")
    surv, idx = _survivors(pres.astype(bool), k)
    rm = _matrix(gf.reconstruction_matrix(k, parity_shards, idx))
    ok = np.empty((B, n), dtype=np.uint8)
    out = np.empty((B, k, L), dtype=np.uint8)
    lib().reconstruct_and_verify(
        B, n, k, L, _ptr(shards), _ptr(surv), _ptr(rm), _ptr(digests),
        _ptr(pres), _ptr(ok), _ptr(out), _threads(nthreads),
    )
    return out, ok.astype(bool)


def reconstruct_cpu(
    shards: np.ndarray,
    present: np.ndarray,
    data_shards: int,
    parity_shards: int,
) -> np.ndarray:
    """Native RS reconstruct of one stripe's data rows: -> (k, len)."""
    from ..ops import gf

    present = np.asarray(present, dtype=bool)
    idx = tuple(int(i) for i in np.nonzero(present)[0])
    rm = gf.reconstruction_matrix(data_shards, parity_shards, idx)
    return gf_matmul_cpu(rm, shards[list(idx[:data_shards])])


def has_avx2() -> bool:
    return bool(lib().gf_has_avx2())


def phash256_rows(words: np.ndarray, nbytes: int) -> np.ndarray:
    """Native phash256 over rows: (..., w) uint32 -> (..., 8) uint32,
    bit-identical to ops/hash.py ``phash256_host_batched`` and to the
    card's phash256_batched."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lead = words.shape[:-1]
    n = words.shape[-1]
    if n % 4:
        raise ValueError(f"word count {n} must be a multiple of 4")
    flat = words.reshape(-1, n)
    out = np.empty((flat.shape[0], 8), dtype=np.uint32)
    lib().phash256_rows(_ptr(flat), flat.shape[0], n, nbytes, _ptr(out))
    return out.reshape(*lead, 8)


# ---------------------------------------------------------------------
# Sanitizer harness (MINIO_TPU_SANITIZE=1)
#
# The instrumented library cannot be loaded into an uninstrumented
# CPython: the ASan runtime must come first in the initial library list.
# The recipe is a SUBPROCESS with the env from sanitizer_env(): LD_PRELOAD
# of the toolchain's libasan plus PYTHONMALLOC=malloc, so scratch buffers
# get real redzones instead of hiding inside pymalloc arenas (numpy
# buffers use malloc either way).
# ---------------------------------------------------------------------


def asan_runtime_path() -> "str | None":
    """The toolchain's libasan.so for LD_PRELOAD, or None if absent."""
    try:
        out = subprocess.run(
            ["g++", "-print-file-name=libasan.so"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    # an unresolved name is echoed back bare, with no directory part
    if os.path.sep in out and os.path.exists(out):
        return os.path.realpath(out)
    return None


def sanitizer_env(base: "dict | None" = None) -> "dict[str, str]":
    """Subprocess env in which lib() loads the instrumented build."""
    env = dict(os.environ if base is None else base)
    env["MINIO_TPU_SANITIZE"] = "1"
    env["PYTHONMALLOC"] = "malloc"
    rt = asan_runtime_path()
    if rt:
        env["LD_PRELOAD"] = rt
    # leaks are checked explicitly mid-run (lsan_recoverable_leak_check):
    # the at-exit sweep would drown in CPython's own still-reachable
    # allocations under PYTHONMALLOC=malloc
    env.setdefault("ASAN_OPTIONS", "detect_leaks=1:leak_check_at_exit=0")
    env.setdefault("UBSAN_OPTIONS", "print_stacktrace=1")
    return env


def lsan_recoverable_leak_check() -> int:
    """Run LeakSanitizer now; 0 = clean, nonzero = native leaks found.

    Only meaningful inside a sanitizer_env() subprocess; returns 0 when
    the LSan runtime is not loaded.
    """
    try:
        fn = ctypes.CDLL(None).__lsan_do_recoverable_leak_check
    except (AttributeError, OSError):
        return 0
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return int(fn())
