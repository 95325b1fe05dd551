"""The port's native C++ codec (``minio_tpu_torch/utils/native.py`` over
``minio_tpu_torch/csrc/gf_cpu.cc``) and its ``CpuBackend``.

Each test of the JAX package's ``tests/test_native.py`` has its
counterpart here, and every output is held bit for bit against the JAX
package's own native module and ``CpuBackend``, and against the port's
plain kernels (``ops/kernels.py`` ``encode_pack_plain``,
``phash256_batched`` and ``verify_reconstruct`` on CPU tensors), over
EC 4+2, 8+4, 12+4 and 16+4, batches of 1-5 stripes, ragged and unpadded
lengths and 1, 3 and the default count of threads.  The JAX package's
numpy fallback has no counterpart: a failed build raises, naming the
compiler's error.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minio_tpu.codec import backend as jbackend
from minio_tpu.utils import native as jnative
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.ops import codec_step, gf, hash as ph, kernels
from minio_tpu_torch.utils import native
from tests.test_torch_threads import torch_threads  # noqa: F401

GEOMETRIES = [(4, 2), (8, 4), (12, 4), (16, 4)]
BATCHES = [1, 2, 3, 4, 5]
# one tile, several, a ragged tail past the 16 KiB tile, 2.5 tiles
LENGTHS = (32, 96, 4096 + 32, 40960)
THREADS = [1, 3, None]


def _data(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return codec_step.words_to_tensor(codec_step.host_bytes_to_words(a), "cpu")


def _words(t: torch.Tensor) -> np.ndarray:
    return codec_step.tensor_to_words(t)


def _split_reference(data, m):
    """Parity + digests through the per-stripe primitives."""
    B, k, L = data.shape
    parity = (np.stack([native.encode_cpu(data[b], m) for b in range(B)])
              if m else np.zeros((B, 0, L), np.uint8))
    allsh = np.ascontiguousarray(np.concatenate([data, parity], axis=1))
    dig = ph.phash256_host_batched(
        allsh.reshape(B * (k + m), -1).view(np.uint32), L
    ).reshape(B, k + m, 8)
    return parity, dig


def _jax_cpu_backend():
    jbackend.CpuBackend._native_ok = None
    jbackend.CpuBackend._native_hash_ok = None
    return jbackend.CpuBackend()


def test_build_and_avx2_flag():
    assert isinstance(native.has_avx2(), bool)
    assert native.has_avx2() == jnative.has_avx2()


@pytest.mark.parametrize("k,m", [(2, 2), *GEOMETRIES])
def test_encode_matches_reference(k, m):
    rng = np.random.default_rng(0)
    data = _data(rng, (k, 1000))
    got = native.encode_cpu(data, m)
    assert np.array_equal(got, gf.encode_ref(data, m))
    assert np.array_equal(got, jnative.encode_cpu(data, m))


@pytest.mark.parametrize("L", (1, 31, 33, 100, 1023))
def test_encode_unaligned_tail(L):
    # lengths that are no multiple of 32 run the scalar tail
    rng = np.random.default_rng(1)
    data = _data(rng, (4, L))
    got = native.encode_cpu(data, 2)
    assert np.array_equal(got, gf.encode_ref(data, 2))
    assert np.array_equal(got, jnative.encode_cpu(data, 2))


def test_gf_mul_acc_matches_the_jax_library():
    rng = np.random.default_rng(13)
    src, dst = _data(rng, 1001), _data(rng, 1001)
    for coef in (0, 1, 2, 0x8E, 255):
        assert np.array_equal(native.gf_mul_acc_cpu(coef, src, dst.copy()),
                              jnative.gf_mul_acc_cpu(coef, src, dst.copy()))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruct_roundtrip(k, m):
    rng = np.random.default_rng(2)
    data = _data(rng, (k, 4096))
    parity = native.encode_cpu(data, m)
    shards = np.concatenate([data, parity])
    present = np.ones(k + m, bool)
    present[rng.choice(k + m, m, replace=False)] = False
    got = native.reconstruct_cpu(shards, present, k, m)
    assert np.array_equal(got, data)
    assert np.array_equal(got, jnative.reconstruct_cpu(shards, present, k, m))


@pytest.mark.parametrize("shape", [(3, 4, 256), (12, 4096), (1, 8), (2, 4),
                                   (5, 12)], ids=str)
def test_native_phash_bit_identical(shape):
    """The AVX2 phash256 equals the numpy form, the JAX library's and the
    port's plain torch form, at the padded and an unpadded byte length."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, shape, dtype=np.uint32)
    for nbytes in (shape[-1] * 4, shape[-1] * 4 - 3):
        a = native.phash256_rows(words, nbytes)
        assert np.array_equal(a, ph.phash256_host_batched(words, nbytes))
        assert np.array_equal(a, jnative.phash256_rows(words, nbytes))
        t = torch.from_numpy(words.view(np.int32))
        assert np.array_equal(a, _words(kernels.phash256_batched(t, nbytes)))


def test_native_phash_rejects_ragged_word_count():
    with pytest.raises(ValueError):
        native.phash256_rows(np.zeros((2, 6), np.uint32), 24)


# ---------------------------------------------------------------------
# The fused batch entry points (encode_and_hash / reconstruct)
# ---------------------------------------------------------------------


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_fused_encode_identity_grid(k, m, B):
    """The fused batch call against the split primitives, the JAX
    library and the port's plain encode_pack, over one-tile, multi-tile
    and ragged lengths."""
    rng = np.random.default_rng(3 + 7 * k + B)
    for L in LENGTHS:
        data = _data(rng, (B, k, L))
        par, dig = native.encode_and_hash_cpu(data, m)
        rpar, rdig = _split_reference(data, m)
        assert np.array_equal(par, rpar) and np.array_equal(dig, rdig), L
        jpar, jdig = jnative.encode_and_hash_cpu(data, m)
        assert np.array_equal(par, jpar) and np.array_equal(dig, jdig), L
        ppar, pdig, _f, _p = kernels.encode_pack_plain(_tensor(data), m, L)
        assert np.array_equal(par.view(np.uint32), _words(ppar)), L
        assert np.array_equal(dig, _words(pdig)), L


@pytest.mark.parametrize("nthreads", THREADS, ids=["1", "3", "default"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_fused_threads_bit_identical(k, m, nthreads):
    """The stripe workers split a batch without changing a bit: encode,
    reconstruct and reconstruct+verify at 1, 3 and the default threads."""
    rng = np.random.default_rng(4)
    data = _data(rng, (5, k, 4096 + 32))
    par, dig = native.encode_and_hash_cpu(data, m, nthreads=nthreads)
    jpar, jdig = jnative.encode_and_hash_cpu(data, m, nthreads=1)
    assert np.array_equal(par, jpar) and np.array_equal(dig, jdig)
    shards = np.concatenate([data, par], axis=1)
    present = np.ones(k + m, bool)
    present[[0, k]] = False
    got = native.reconstruct_batch_cpu(shards, present, k, m, nthreads=nthreads)
    assert np.array_equal(got, data)
    out, ok = native.reconstruct_and_verify_cpu(shards, dig, present, k, m,
                                                nthreads=nthreads)
    assert np.array_equal(out, data)
    assert np.array_equal(ok, np.tile(present, (5, 1)))


def test_fused_encode_zero_parity():
    rng = np.random.default_rng(4)
    data = _data(rng, (3, 4, 2048))
    par, dig = native.encode_and_hash_cpu(data, 0)
    assert par.shape == (3, 0, 2048)
    _, rdig = _split_reference(data, 0)
    assert np.array_equal(dig, rdig)
    assert np.array_equal(dig, jnative.encode_and_hash_cpu(data, 0)[1])


@pytest.mark.parametrize("L", (100, 4, 48))
def test_fused_entries_reject_unpadded_length(L):
    data = np.zeros((1, 4, L), dtype=np.uint8)
    with pytest.raises(ValueError):
        native.encode_and_hash_cpu(data, 2)
    with pytest.raises(ValueError):
        native.reconstruct_and_verify_cpu(
            np.zeros((1, 6, L), np.uint8), np.zeros((1, 6, 8), np.uint32),
            np.ones(6, bool), 4, 2)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruct_batch_cpu_matches_per_stripe(k, m):
    rng = np.random.default_rng(5)
    n = k + m
    data = _data(rng, (4, k, 1024))
    par, _ = native.encode_and_hash_cpu(data, m)
    shards = np.concatenate([data, par], axis=1)
    lost = rng.choice(n, m, replace=False)
    present = np.ones(n, bool)
    present[lost] = False
    shards[:, lost] = 0
    got = native.reconstruct_batch_cpu(shards, present, k, m)
    assert np.array_equal(got, data)
    assert np.array_equal(got, jnative.reconstruct_batch_cpu(shards, present, k, m))
    for b in range(4):
        assert np.array_equal(got[b], native.reconstruct_cpu(shards[b], present, k, m))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruct_and_verify_cpu_flags_bitrot(k, m):
    rng = np.random.default_rng(6)
    n = k + m
    data = _data(rng, (3, k, 512))
    par, dig = native.encode_and_hash_cpu(data, m)
    shards = np.concatenate([data, par], axis=1)
    present = np.ones(n, bool)
    present[1] = False
    shards[:, 1] = 0
    out, ok = native.reconstruct_and_verify_cpu(shards, dig, present, k, m)
    assert np.array_equal(out, data)
    assert np.array_equal(ok, np.tile(present, (3, 1)))
    # a flipped byte in a chosen survivor of stripe 1 only
    shards[1, 0, 7] ^= 0x40
    out, ok = native.reconstruct_and_verify_cpu(shards, dig, present, k, m)
    assert not ok[1, 0] and ok[0, 0] and ok[2, 0]
    assert np.array_equal(out[0], data[0]) and np.array_equal(out[2], data[2])
    jout, jok = jnative.reconstruct_and_verify_cpu(shards, dig, present, k, m)
    assert np.array_equal(out, jout) and np.array_equal(ok, jok)
    if n <= 16:  # the port's verify_reconstruct takes up to 16 rows
        pdata, pdig = kernels.verify_reconstruct(
            _tensor(shards), tuple(bool(p) for p in present), k, 512)
        assert np.array_equal(out[0].view(np.uint32), _words(pdata)[0])
        pok = (_words(pdig) == dig).all(axis=-1) & present
        assert np.array_equal(ok, pok)


# ---------------------------------------------------------------------
# CpuBackend: one native call a batch, bit-identity with the JAX
# package's CpuBackend and the port's TorchBackend on the CPU
# ---------------------------------------------------------------------


def test_cpu_backend_one_native_call_no_concat(monkeypatch):
    """encode() is exactly ONE native call per batch and never rebuilds
    the full shard batch to feed the digest."""
    be = tbackend.CpuBackend()
    rng = np.random.default_rng(7)
    data = _data(rng, (6, 8, 1024))
    rpar, rdig = _split_reference(data, 4)
    calls = {"fused": 0, "matmul": 0, "hash": 0}
    real = native.encode_and_hash_cpu

    def counting(data, m, nthreads=None):
        calls["fused"] += 1
        return real(data, m, nthreads)

    monkeypatch.setattr(native, "encode_and_hash_cpu", counting)
    monkeypatch.setattr(
        native, "gf_matmul_cpu",
        lambda *a, **k: calls.__setitem__("matmul", calls["matmul"] + 1))
    monkeypatch.setattr(
        native, "phash256_rows",
        lambda *a, **k: calls.__setitem__("hash", calls["hash"] + 1))
    par, dig = be.encode(data, 4)
    assert calls == {"fused": 1, "matmul": 0, "hash": 0}
    assert np.array_equal(par, rpar) and np.array_equal(dig, rdig)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_cross_backend_bit_identity(k, m):
    """Parity + digests equal across the fused and split native paths, the
    JAX package's CpuBackend, and the port's TorchBackend on the CPU (the
    plain kernels)."""
    be = tbackend.CpuBackend()
    jbe = _jax_cpu_backend()
    tb = tbackend.TorchBackend("cpu")
    rng = np.random.default_rng(8)
    for B, L in [(1, 32), (3, 96), (2, 4096 + 32)]:
        data = _data(rng, (B, k, L))
        par_f, dig_f = be.encode(data, m)
        for name, (p, d) in {
            "split": be.encode_split(data, m),
            "jax": jbe.encode(data, m),
            "jax_split": jbe.encode_split(data, m),
            "torch": tb.encode(data, m),
        }.items():
            assert np.array_equal(par_f, p), (name, B, L)
            assert np.array_equal(dig_f, d), (name, B, L)
        assert np.array_equal(be.digest(data), jbe.digest(data))


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses makes lib() and CpuBackend()
    raise, naming the compiler's error, and nothing is left loaded."""
    src = tmp_path / "broken.cc"
    src.write_text('extern "C" int gf_has_avx2(void) { return undeclared_x; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    for build in (native.lib, tbackend.CpuBackend):
        with pytest.raises(RuntimeError, match="undeclared_x"):
            build()
    assert native._libs == {}
    assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".so")]


def test_missing_symbol_raises(tmp_path, monkeypatch):
    src = tmp_path / "partial.cc"
    src.write_text('extern "C" int gf_has_avx2(void) { return 0; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="gf_matmul"):
        native.lib()


def test_cpu_backend_reconstruct_and_verify_repick():
    """Bitrot in a chosen survivor: the fused path re-picks survivors from
    the verified mask and returns the data, as the JAX CpuBackend does;
    the result is writable."""
    be = tbackend.CpuBackend()
    jbe = _jax_cpu_backend()
    rng = np.random.default_rng(10)
    k, m = 8, 4
    n = k + m
    data = _data(rng, (2, k, 1024))
    par, dig = be.encode(data, m)
    shards = np.concatenate([data, par], axis=1)
    present = np.ones(n, bool)
    shards[0, 2, 11] ^= 0x01  # bitrot in survivor 2, stripe 0 only
    out, ok = be.reconstruct_and_verify(shards, dig, present, k, m)
    assert not ok[0, 2] and ok[1, 2]
    assert np.array_equal(out, data) and out.flags.writeable
    jout, jok = jbe.reconstruct_and_verify(shards, dig, present, k, m)
    assert np.array_equal(out, jout) and np.array_equal(ok, jok)
    # below quorum: k-1 intact -> ValueError for the caller to map
    few = np.zeros(n, bool)
    few[: k - 1] = True
    with pytest.raises(ValueError):
        be.reconstruct_and_verify(shards, dig, few, k, m)


def test_wrappers_delegate_fused_seam():
    """Telemetry + batcher wrappers expose fused_encode and route
    reconstruct_and_verify to the native fused pass; ops are recorded
    under the backend name ``cpu``."""
    from minio_tpu_torch.codec.batcher import BatchingBackend
    from minio_tpu_torch.codec.telemetry import InstrumentedBackend, KernelStats

    stats = KernelStats()
    inst = InstrumentedBackend(tbackend.CpuBackend(), stats)
    assert inst.fused_encode is True and inst.name == "cpu"
    assert inst.device == torch.device("cpu")
    rng = np.random.default_rng(12)
    k, m = 4, 2
    data = _data(rng, (2, k, 128))
    par, dig = inst.encode(data, m)
    shards = np.concatenate([data, par], axis=1)
    present = np.ones(k + m, bool)
    out, ok = inst.reconstruct_and_verify(shards, dig, present, k, m)
    assert np.array_equal(out, data) and ok.all()
    rows = stats.snapshot()["ops"]
    assert {r["op"] for r in rows} == {"encode", "reconstruct_and_verify"}
    assert {r["backend"] for r in rows} == {"cpu"}
    batched = BatchingBackend(inst)
    try:
        assert batched.fused_encode is True
        out2, ok2 = batched.reconstruct_and_verify(shards, dig, present, k, m)
        assert np.array_equal(out2, data) and ok2.all()
    finally:
        batched.shutdown()


def test_native_backend_is_one_per_process():
    from minio_tpu_torch.codec.batcher import BatchingBackend

    be = tbackend.native_backend()
    try:
        assert be is tbackend.native_backend()
        assert be.name in ("batched", "cpu") and be.fused_encode is True
        inner = be.inner if isinstance(be, BatchingBackend) else be
        assert inner.name == "cpu"
        assert isinstance(inner.inner, tbackend.CpuBackend)
    finally:
        tbackend.reset_backend()


# ---------------------------------------------------------------------
# Build hygiene: the fingerprinted .so path
# ---------------------------------------------------------------------


def test_so_fingerprint_tracks_source_and_flags(tmp_path, monkeypatch):
    """Editing the source (or changing flags) changes the artifact path,
    forcing a rebuild instead of silently loading a stale body."""
    src = tmp_path / "mini.cc"
    src.write_text('extern "C" int mini_answer(void) { return 41; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    p1 = native._build()
    assert p1.endswith(".so") and "libgf_cpu-" in p1
    assert ctypes.CDLL(p1).mini_answer() == 41
    # source edit -> new fingerprint -> rebuild; stale artifact pruned
    src.write_text('extern "C" int mini_answer(void) { return 42; }\n')
    p2 = native._build()
    assert p2 != p1
    assert ctypes.CDLL(p2).mini_answer() == 42
    assert not os.path.exists(p1)
    # same source again: cached, the same path
    assert native._build() == p2
    # a flag change alone also re-fingerprints
    monkeypatch.setattr(native, "_CFLAGS", [*native._CFLAGS, "-DMINI_EXTRA"])
    assert native._so_path() != p2


def test_concurrent_builds_of_one_fingerprint(tmp_path):
    """Six processes build one fingerprint at once (as six test workers
    do): each loads a whole library, and one .so remains."""
    code = (
        "import sys; from minio_tpu_torch.utils import native as n; "
        f"n._BUILD_DIR = {str(tmp_path / 'build')!r}; "
        "sys.stdout.write(str(n.has_avx2()))"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert {o for o, _e in outs} == {str(native.has_avx2())}
    assert [n for n in os.listdir(tmp_path / "build")] == [
        os.path.basename(native._so_path())]


# ---------------------------------------------------------------------
# ASan/UBSan builds: the san variant compiles under its own fingerprint,
# and a slow sweep replays the grids above inside a sanitizer subprocess
# ---------------------------------------------------------------------


def test_sanitizer_variant_has_its_own_fingerprint():
    prod, san = native._so_path(), native._so_path("san")
    assert san != prod
    assert san.endswith("-san.so") and not prod.endswith("-san.so")
    flags = native._flags("san")
    assert "-O3" not in flags
    assert "-fsanitize=address,undefined" in flags
    assert "-O3" in native._flags()


def test_sanitize_knob_selects_the_variant(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SANITIZE", "1")
    assert native._variant() == "san"
    assert native.sanitizer_env({})["MINIO_TPU_SANITIZE"] == "1"
    monkeypatch.setenv("MINIO_TPU_SANITIZE", "0")
    assert native._variant() == ""


def test_native_threads_knob(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_NATIVE_THREADS", "3")
    assert native.default_threads() == 3
    monkeypatch.setenv("MINIO_TPU_NATIVE_THREADS", "x")
    assert native.default_threads() == (os.cpu_count() or 1)


def _run_sanitized(body, tmp_path):
    """Run a python snippet inside the ASan/UBSan subprocess env."""
    from minio_tpu_torch.analysis import REPO_ROOT

    script = tmp_path / "san_sweep.py"
    script.write_text(body)
    env = native.sanitizer_env()
    env["PYTHONPATH"] = REPO_ROOT
    return subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        text=True,
        timeout=900,
        env=env,
        cwd=REPO_ROOT,
    )


# the sweep imports no torch (its own start-up allocations would read as
# leaks): the split native path is its reference, held against the numpy
# and torch forms by the tests above
_SAN_SWEEP = """\
import sys

import numpy as np

from minio_tpu_torch.utils import native

assert native._variant() == "san", "sanitizer env did not propagate"

rng = np.random.default_rng(3)
for k, m in [(4, 2), (8, 4), (12, 4), (16, 4)]:
    for B in (1, 5):
        for L in (32, 96, 4096 + 32, 40960):
            data = rng.integers(0, 256, (B, k, L), dtype=np.uint8)
            par, dig = native.encode_and_hash_cpu(data, m)
            rpar = np.stack([native.encode_cpu(data[b], m) for b in range(B)])
            allsh = np.ascontiguousarray(np.concatenate([data, par], axis=1))
            rdig = native.phash256_rows(allsh.view(np.uint32), L)
            assert np.array_equal(par, rpar), (k, m, B, L)
            assert np.array_equal(dig, rdig), (k, m, B, L)

k, m = 8, 4
data = rng.integers(0, 256, (4, k, 1024), dtype=np.uint8)
par, _ = native.encode_and_hash_cpu(data, m)
shards = np.concatenate([data, par], axis=1)
present = np.ones(k + m, bool)
present[[0, 5, 9]] = False
shards[:, [0, 5, 9]] = 0
got = native.reconstruct_batch_cpu(shards, present, k, m)
assert np.array_equal(got, data)
for b in range(4):
    assert np.array_equal(
        native.reconstruct_cpu(shards[b], present, k, m), data[b]
    )

k, m = 4, 2
data = rng.integers(0, 256, (3, k, 512), dtype=np.uint8)
par, dig = native.encode_and_hash_cpu(data, m)
shards = np.concatenate([data, par], axis=1)
present = np.ones(k + m, bool)
present[1] = False
shards[:, 1] = 0
out, ok = native.reconstruct_and_verify_cpu(shards, dig, present, k, m)
assert np.array_equal(out, data)
assert np.array_equal(ok, np.tile(present, (3, 1)))
shards[1, 0, 7] ^= 0x40
out, ok = native.reconstruct_and_verify_cpu(shards, dig, present, k, m)
assert not ok[1, 0] and ok[0, 0] and ok[2, 0]
assert np.array_equal(out[0], data[0])
assert np.array_equal(out[2], data[2])

assert "torch" not in sys.modules
rc = native.lsan_recoverable_leak_check()
assert rc == 0, f"LeakSanitizer reported native leaks (rc={rc})"
print("SWEEP_OK")
"""

_SAN_OVERFLOW = """\
import ctypes

import numpy as np

from minio_tpu_torch.utils import native

src = np.ones(64, dtype=np.uint8)
dst = np.zeros(64, dtype=np.uint8)
# a corrupted length: 4096 > the 64-byte allocations - ASan must abort
native.lib().gf_mul_acc(
    2,
    src.ctypes.data_as(ctypes.c_void_p),
    dst.ctypes.data_as(ctypes.c_void_p),
    4096,
)
print("UNREACHABLE_OK")
"""


@pytest.mark.slow
def test_sanitizer_sweep_replays_grids_clean(tmp_path):
    if native.asan_runtime_path() is None:
        pytest.skip("toolchain has no libasan.so")
    r = _run_sanitized(_SAN_SWEEP, tmp_path)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "SWEEP_OK" in r.stdout


@pytest.mark.slow
def test_sanitizer_catches_corrupted_length(tmp_path):
    """The harness is live: a heap overflow from a wrong length argument
    crashes the sweep instead of passing silently."""
    if native.asan_runtime_path() is None:
        pytest.skip("toolchain has no libasan.so")
    r = _run_sanitized(_SAN_OVERFLOW, tmp_path)
    assert r.returncode != 0, r.stdout + "\n" + r.stderr
    assert "AddressSanitizer" in r.stderr
    assert "UNREACHABLE_OK" not in r.stdout
