"""The port's codec backend held against the JAX package's TpuBackend.

TorchBackend("cpu") runs the plain PyTorch versions of the kernels;
TpuBackend runs on the JAX CPU platform with MINIO_MESH=0 (the
single-device path one card mirrors; tests/conftest.py forces 8 virtual
devices, which would otherwise take the mesh path).  Digests, drained
parity bytes, reconstructed rows and verify masks must be bit-identical.
"""

import io

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from tests.test_torch_threads import torch_threads  # noqa: F401


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


def _heal_frames(present, seed=0, rot=None):
    """Encoded stripes as heal reads them: absent rows zero, and with
    ``rot`` = (stripe, row) one byte of a present row flipped."""
    data = _data("random", (3, 8, 1056), seed=seed)
    jb = jbackend.TpuBackend()
    parity, digests = jb.encode(data, 4)
    shards = np.concatenate([data, np.asarray(parity)], axis=1)
    shards[:, [i for i, p in enumerate(present) if not p]] = 0
    if rot is not None:
        shards[rot[0], rot[1], 100] ^= 0x21
    return data, shards, np.asarray(digests)


@pytest.mark.parametrize(
    "present,rot",
    [
        ((False, True, False, True) + (True,) * 8, None),
        ((True,) * 8 + (False,) * 4, None),
        # a chosen survivor bitrotted in stripe 2: the backend re-solves
        # that stripe from the verified mask (escalation through K3)
        ((False, True, False, True) + (True,) * 8, (2, 4)),
        # a spare present row bitrotted: ok flags it, no escalation
        ((True,) * 12, (1, 10)),
    ],
)
def test_reconstruct_and_verify(backends, present, rot):
    jb, tb = backends
    data, shards, digests = _heal_frames(present, seed=4, rot=rot)
    KERNEL_STATS.reset()
    got, ok = tb.reconstruct_and_verify(shards, digests, present, 8, 4)
    want, want_ok = jb.reconstruct_and_verify(shards, digests, present, 8, 4)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(ok, np.asarray(want_ok))
    assert np.array_equal(got, data)
    assert ok.sum() == sum(present) * 3 - (rot is not None)
    passes = KERNEL_STATS.snapshot()["device_passes"]
    assert passes["verify_and_reconstruct_words"] == 1
    assert passes.get("reconstruct_words_batch", 0) == (
        1 if rot == (2, 4) else 0
    )


def test_reconstruct_and_verify_below_k_raises(backends):
    jb, tb = backends
    present = (False, True, False, True, False, False) + (True,) * 6
    _data_, shards, digests = _heal_frames(present, seed=5, rot=(0, 6))
    for be in (tb, jb):
        with pytest.raises(ValueError, match="stripe 0: 7/12 shards intact"):
            be.reconstruct_and_verify(shards, digests, present, 8, 4)
    short = (False,) * 5 + (True,) * 7
    for be in (tb, jb):
        with pytest.raises(ValueError, match="need 8 shards, have 7"):
            be.reconstruct_and_verify(shards, digests, short, 8, 4)


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
        shards = np.concatenate([data, ref.drain()], axis=1)
        got, ok = be.reconstruct_and_verify(shards, _d, (True,) * 12, 8, 4)
        assert np.array_equal(got, data) and ok.all()
        snap = KERNEL_STATS.snapshot()
        assert snap["device_passes"] == {
            "encode_words_fused1": 1, "phash256_words_batched": 1,
            "verify_and_reconstruct_words": 1,
        }
        # the telemetry wrapper books it under the JAX package's op name
        assert any(o["op"] == "reconstruct_and_verify" for o in snap["ops"])
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


@pytest.mark.parametrize("clients", [1, 2])
def test_batcher_counts_cross_request_flushes(backends, clients):
    """Jobs of two requests (two submitting threads) merged into one
    flush count as a multi-client flush; each still gets its own rows,
    equal to the JAX package's digests."""
    from minio_tpu_torch.codec.batcher import BatchingBackend, _Job

    jax_be, port_be = backends
    be = BatchingBackend(port_be, deadline_s=1.0)
    KERNEL_STATS.reset()
    try:
        shards = [_data("random", (1, 12, 1024), seed=s) for s in (5, 6)]
        jobs = [_Job("digest", (12, 1024), (s,)) for s in shards]
        jobs[1].client = jobs[0].client + clients - 1
        with be._cv:  # both queued before the dispatcher looks
            be._jobs.extend(jobs)
            be._cv.notify_all()
        for j, s in zip(jobs, shards):
            assert j.done.wait(10) and j.error is None
            assert np.array_equal(j.result, jax_be.digest(s))
        batch = KERNEL_STATS.snapshot()["batch"]
        assert (batch["flushes"], batch["jobs"]) == (1, 2)
        assert batch["multi_client_flushes"] == (clients > 1)
    finally:
        be.shutdown()


class _MemShard:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        self.buf += b


def test_failed_encode_begin_ends_the_begun_handles(backends):
    """A batch of a full block and a short tail begins two handles; when
    the second begin raises, the first is ended before the error leaves
    encode, so the batcher counts no client active afterwards and the
    next PUT's flush waits for nobody."""
    from minio_tpu_torch.codec.batcher import BatchingBackend
    from minio_tpu_torch.codec.erasure import Erasure

    _jax_be, port_be = backends
    batcher = BatchingBackend(port_be, deadline_s=5.0)

    class SecondBeginFails:
        """The batcher, with its second encode_digest_begin raising."""

        begins = 0

        def __getattr__(self, name):
            return getattr(batcher, name)

        def encode_digest_begin(self, data, m):
            self.begins += 1
            if self.begins == 2:
                raise RuntimeError("injected begin failure")
            return batcher.encode_digest_begin(data, m)

    be = SecondBeginFails()
    payload = np.random.default_rng(3).bytes(2048 + 100)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            Erasure(4, 2, 2048).encode(
                io.BytesIO(payload), [_MemShard() for _ in range(6)], 5,
                backend=be)
        assert batcher._active == {}
        shards = [_MemShard() for _ in range(6)]
        assert Erasure(4, 2, 2048).encode(
            io.BytesIO(payload), shards, 5, backend=be) == len(payload)
        assert be.begins == 4 and batcher._active == {}
    finally:
        batcher.shutdown()


@pytest.mark.parametrize("knob", [None, "1"])
def test_no_instrument_knob_in_both_packages(backends, monkeypatch, knob):
    """MINIO_TPU_NO_INSTRUMENT=1 returns the backend bare in both
    packages; unset, both wrap it."""
    from minio_tpu.codec import telemetry as jtel
    from minio_tpu_torch.codec import telemetry as ttel

    if knob is None:
        monkeypatch.delenv("MINIO_TPU_NO_INSTRUMENT", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_NO_INSTRUMENT", knob)
    jax_be, port_be = backends
    got = (jtel.instrument(jax_be), ttel.instrument(port_be))
    if knob:
        assert got == (jax_be, port_be)
    else:
        assert isinstance(got[0], jtel.InstrumentedBackend)
        assert isinstance(got[1], ttel.InstrumentedBackend)
        assert got[1].inner is port_be
