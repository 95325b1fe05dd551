"""The port's codec backend held against the JAX package's TpuBackend.

TorchBackend("cpu") runs the plain PyTorch versions of the kernels;
TpuBackend runs on the JAX CPU platform with MINIO_MESH=0 (the
single-device path one card mirrors; tests/conftest.py forces 8 virtual
devices, which would otherwise take the mesh path).  Digests, drained
parity bytes, reconstructed rows and verify masks must be bit-identical.
"""

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS


@pytest.fixture
def backends(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield jbackend.TpuBackend(), tbackend.TorchBackend("cpu")
    jbackend.reset_backend()
    tbackend.reset_backend()


def _data(kind: str, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    out = np.zeros(shape, dtype=np.uint8)
    if kind == "sparse":
        out[:, 0, 1024:1100] = rng.integers(1, 256, 76, dtype=np.uint8)
    return out


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("kind", ["random", "sparse", "zeros"])
def test_encode_digest_and_drain(backends, monkeypatch, mode, kind):
    monkeypatch.setenv("MINIO_TPU_DEVICE_COMPRESS", mode)
    jb, tb = backends
    data = _data(kind, (3, 8, 4096), seed=len(kind))
    jd, jref = jb.encode_digest_end(jb.encode_digest_begin(data, 4))
    td, tref = tb.encode_digest_end(tb.encode_digest_begin(data, 4))
    assert np.array_equal(np.asarray(jd), td)
    assert np.array_equal(np.asarray(jref.drain()), tref.drain())
    assert tref.drain() is tref.drain()  # memoized: one transfer


@pytest.mark.parametrize("L", [32, 1056, 4096 * 4 + 32])
def test_encode_eager(backends, L):
    jb, tb = backends
    data = _data("random", (2, 4, L), seed=L)
    jp, jd = jb.encode(data, 2)
    tp, td = tb.encode(data, 2)
    assert np.array_equal(np.asarray(jp), tp)
    assert np.array_equal(np.asarray(jd), td)


def test_digest_and_verify(backends):
    jb, tb = backends
    shards = _data("random", (2, 12, 1056), seed=3)
    digests = np.asarray(jb.digest(shards))
    assert np.array_equal(tb.digest(shards), digests)
    bad = shards.copy()
    bad[1, 5, 17] ^= 0x40
    assert np.array_equal(tb.verify(bad, digests), np.asarray(jb.verify(bad, digests)))
    assert not tb.verify(bad, digests)[1, 5]
    assert tb.verify(bad, digests).sum() == 23


@pytest.mark.parametrize(
    "present",
    [
        (False, True, False, True) + (True,) * 8,
        (True,) * 4 + (False,) * 4 + (True,) * 4,
    ],
)
def test_reconstruct(backends, present):
    jb, tb = backends
    data = _data("random", (2, 8, 1056), seed=9)
    parity, _d = jb.encode(data, 4)
    shards = np.concatenate([data, np.asarray(parity)], axis=1)
    shards[:, [i for i, p in enumerate(present) if not p]] = 0xAA  # garbage
    got = tb.reconstruct(shards, present, 8, 4)
    assert np.array_equal(got, np.asarray(jb.reconstruct(shards, present, 8, 4)))
    assert np.array_equal(got, data)


def test_parity_cache_accounts_and_releases(backends):
    _jb, tb = backends
    data = _data("random", (1, 8, 4096), seed=1)
    _d, ref = tb.encode_digest_end(tb.encode_digest_begin(data, 4))
    from minio_tpu_torch.cache.allocator import device_budget

    stats = tbackend.parity_cache_stats()
    assert stats["entries"] == 1 and stats["occupancy_bytes"] > 0
    assert device_budget().usage("parity_plane") == stats["occupancy_bytes"]
    ref.release()
    assert tbackend.parity_cache_stats()["entries"] == 0
    assert device_budget().usage("parity_plane") == 0


@pytest.mark.parametrize("batch", ["on", "off"])
def test_get_backend_stack_counts_passes(monkeypatch, batch):
    monkeypatch.setenv("MINIO_CODEC_BATCH", batch)
    tbackend.reset_backend()
    KERNEL_STATS.reset()
    try:
        be = tbackend.get_backend("cpu")
        assert be is tbackend.get_backend("cpu")
        data = _data("random", (2, 8, 1024), seed=2)
        _d, ref = be.encode_digest_end(be.encode_digest_begin(data, 4))
        ref.drain()
        be.digest(np.concatenate([data, data], axis=1))
        passes = KERNEL_STATS.snapshot()["device_passes"]
        assert passes == {
            "encode_words_fused1": 1, "phash256_words_batched": 1
        }
    finally:
        tbackend.reset_backend()


def test_cuda_backend_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.get_backend()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.TorchBackend()
