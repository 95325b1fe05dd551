"""MINIO_TPU_CODEC_OVERLAP in the port, held against minio_tpu.

``pipeline`` (K5/K6, whose plain versions run here), ``async`` (the
sub-chunk chain of K1/K4) and ``off`` must give bit-identical digests,
parity, rebuilt data and verify masks, in the port and against the JAX
package's TpuBackend (MINIO_MESH=0: the single-device path one card
mirrors); K5's and K6's plain versions must equal P6 and P7 under
interpret; and the object layer must write the same part files and
xl.meta as minio_tpu's under every mode.  Also covered: the sizing
helper, the sub-chunk handle life cycle, the staging ledger and the
reference's own routes away from a mode (S < 3, m == 0).
"""

import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.erasure import subchunk_words as jax_subchunk_words
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.ops import hash as jhash, rs_pallas
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.cache.allocator import device_budget
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.erasure import subchunk_words
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer.erasure_object import (
    ErasureObjects,
    from_reference_disks,
)
from minio_tpu_torch.ops import codec_step as tcs, kernels
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

MODES = ["off", "pipeline", "async"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.delenv("MINIO_TPU_CODEC_OVERLAP", raising=False)
    jbackend.reset_backend()
    tbackend.reset_backend()
    KERNEL_STATS.reset()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _data(B, k, L, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, k, L), dtype=np.uint8)


def _roundtrip(be, data, m, drop=()):
    """PUT digest seam + drain, then heal's reconstruct_and_verify with
    ``drop`` shards absent (garbage in their rows)."""
    B, k, L = data.shape
    digests, ref = be.encode_digest_end(be.encode_digest_begin(data, m))
    parity = np.asarray(ref.drain())
    shards = np.concatenate([data, parity.reshape(B, m, L)], axis=1).copy()
    present = [i not in drop for i in range(k + m)]
    shards[:, list(drop), :] = 0x5A
    out, ok = be.reconstruct_and_verify(shards, digests, present, k, m)
    return np.asarray(digests), parity, np.asarray(out), np.asarray(ok)


def _port_run(monkeypatch, mode, data, m, drop=()):
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", mode)
    KERNEL_STATS.reset()
    got = _roundtrip(tbackend.TorchBackend("cpu"), data, m, drop)
    return got, KERNEL_STATS.snapshot()


def _assert_same(a, b, what):
    for x, y, name in zip(a, b, ("digests", "parity", "data", "ok")):
        assert np.array_equal(x, y), f"{what}: {name} diverged"


# (B, k, m, L bytes, sub-chunk KiB, dropped shards), the grid of
# tests/test_overlap.py: k = 1, m = 0, a ragged tail, S = 3 exactly
ASYNC_GRID = [
    (2, 4, 2, 4096, 1, (1, 4)),     # w=1024, cw=256, S=4, dividing
    (1, 1, 1, 4096, 1, (0,)),       # k=1: parity-only survivor
    (2, 3, 0, 4096, 1, ()),         # m=0: digest-only
    (1, 4, 2, 11264, 3, (0, 5)),    # w=2816, cw=768: ragged tail 512
    (2, 2, 1, 3072, 1, (2,)),       # w=768, cw=256, S=3 exactly
]


@pytest.mark.parametrize("B,k,m,L,sub_kb,drop", ASYNC_GRID)
def test_async_equals_off(monkeypatch, B, k, m, L, sub_kb, drop):
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", str(sub_kb))
    data = _data(B, k, L, seed=L)
    base, _ = _port_run(monkeypatch, "off", data, m, drop)
    got, snap = _port_run(monkeypatch, "async", data, m, drop)
    _assert_same(base, got, "async")
    S = -(-(L // 4) // subchunk_words(L // 4, 256 if m else 8))
    assert snap["overlap_windows"] == {"put": S - 1, "get": S - 1}
    assert snap["device_passes"]["encode_subchunk_words"] == S
    assert snap["device_passes"]["verify_reconstruct_subchunk_words"] == S
    assert "encode_words_fused1" not in snap["device_passes"]


@pytest.mark.parametrize("B,k,m,L,sub_kb,drop", [ASYNC_GRID[0], ASYNC_GRID[3]])
def test_async_and_pipeline_equal_jax_async(monkeypatch, B, k, m, L, sub_kb, drop):
    """The port under async and pipeline against TpuBackend under async
    on the same numpy inputs."""
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", str(sub_kb))
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "async")
    data = _data(B, k, L, seed=L + 1)
    want = _roundtrip(jbackend.TpuBackend(), data, m, drop)
    for mode in ("async", "pipeline"):
        got, _snap = _port_run(monkeypatch, mode, data, m, drop)
        _assert_same(want, got, mode)


def test_pipeline_equals_off_and_m0_takes_k1(monkeypatch):
    data = _data(2, 4, 8192, seed=3)
    base, _ = _port_run(monkeypatch, "off", data, 2, drop=(0, 3))
    got, snap = _port_run(monkeypatch, "pipeline", data, 2, drop=(0, 3))
    _assert_same(base, got, "pipeline")
    assert snap["device_passes"] == {
        "encode_words_fused1": 1, "verify_and_reconstruct_words": 1,
    }
    # m == 0 under pipeline: K1, as the JAX package routes it
    called = []
    real = kernels.encode_pack
    monkeypatch.setattr(
        kernels, "encode_pack",
        lambda *a, **kw: called.append(a[1]) or real(*a, **kw),
    )
    monkeypatch.setattr(
        kernels, "encode_pack_pipelined",
        lambda *a, **kw: pytest.fail("K5 ran at m == 0"),
    )
    words = tcs.words_to_tensor(tcs.host_bytes_to_words(data), "cpu")
    tcs.encode_words_fused1(words, 0, 8192, pipeline=True)
    assert called == [0]


def test_pipeline_windows_formula():
    """K5/K6's persistent grids and their overlap windows: B * (tiles -
    blocks per stripe), since a block walking c tiles overlaps c - 1.
    K6 sizes for 2 blocks per SM, K5 for 3 (its mxu kernel for 2)."""
    W = 327_680  # EC 8+4, 10 MiB blocks: 1,280 tiles of 256 words
    assert kernels.pipelined_grid(1, W, 132) == (5, 256)
    assert kernels.pipeline_windows(1, W, 132) == 1280 - 256
    assert kernels.pipelined_grid(4, W, 132) == (20, 64)
    assert kernels.pipeline_windows(4, W, 132) == 4 * (1280 - 64)
    assert kernels.pipeline_windows(2, 8, 132) == 0  # one tile per stripe
    assert kernels.pipelined_grid(300, 512, 132) == (2, 1)
    # K5
    assert kernels.encode_pipelined_grid(4, W, 132) == (13, 99)
    assert kernels.pipeline_windows(4, W, 132, encode=True) == 4 * (1280 - 99)
    assert kernels.encode_pipelined_grid(1, W, 132) == (4, 320)
    assert kernels.pipeline_windows(1, W, 132, encode=True) == 1280 - 320
    assert kernels.pipeline_windows(4, W, 132, encode=True, mxu=True) == 4 * (1280 - 64)
    assert kernels.pipeline_windows(2, 8, 132, encode=True) == 0


def _rand_words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("k,m,group", [(4, 2, 256), (8, 4, 0)])
def test_k5_plain_matches_p6_interpret(k, m, group):
    """P6 at a 2-tile geometry (w = 8192): parity, flags, finalized
    digests, and the packed prefix (P6 promises only the prefix)."""
    w = 8192
    words = _rand_words((1, k, w), seed=k)
    words[0, :, 512:4096] = 0  # zero groups for the pack leg
    parity, partials, flags, packed = rs_pallas.encode_pack_pipelined(
        jnp.asarray(words), m, group=group, interpret=True
    )
    t = tcs.words_to_tensor(words, "cpu")
    gp, gd, gf_, gpk = kernels.encode_pack_pipelined_plain(t, m, 4 * w, group)
    assert np.array_equal(tcs.tensor_to_words(gp), np.asarray(parity))
    assert np.array_equal(
        tcs.tensor_to_words(gd),
        np.asarray(jhash.finalize_partials(partials, 4 * w)),
    )
    if not group:
        return
    assert np.array_equal(gf_.numpy(), np.asarray(flags).astype(np.int32))
    kept = np.asarray(flags).sum(axis=-1)
    port, ref = tcs.tensor_to_words(gpk), np.asarray(packed)
    for r in range(m):
        n = int(kept[0, r]) * group
        assert np.array_equal(port[0, r, :n], ref[0, r, :n])
        assert not port[0, r, n:].any()


@pytest.mark.parametrize(
    "k,m,present",
    [(4, 2, (False, True, True, True, True, False)), (8, 4, (True,) * 12)],
)
def test_k6_plain_matches_p7_interpret(k, m, present):
    w = 8192
    shards = _rand_words((1, k + m, w), seed=k + m)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    data, partials = rs_pallas.verify_reconstruct_pipelined(
        jnp.asarray(shards), idx, k, m, interpret=True
    )
    got_d, got_dig = kernels.verify_reconstruct_pipelined_plain(
        tcs.words_to_tensor(shards, "cpu"), present, k, 4 * w
    )
    pres = np.asarray(present)
    assert np.array_equal(tcs.tensor_to_words(got_d), np.asarray(data))
    want = np.asarray(jhash.finalize_partials(partials, 4 * w))
    assert np.array_equal(tcs.tensor_to_words(got_dig)[:, pres], want[:, pres])


@pytest.mark.parametrize(
    "kb,w,quantum",
    [(None, 65536 * 5, 256), ("4", 1024 * 3, 256), ("4", 1024 * 3, 768),
     ("4", 1024 * 2, 256), ("0.001", 256 * 64, 256), ("bogus", 65536 * 4, 8),
     ("3", 2816, 8)],
)
def test_subchunk_words_matches_jax(monkeypatch, kb, w, quantum):
    if kb is None:
        monkeypatch.delenv("MINIO_TPU_CODEC_SUBCHUNK_KB", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", kb)
    assert subchunk_words(w, quantum) == jax_subchunk_words(w, quantum)


def test_subchunk_handle_life_cycle(monkeypatch):
    """encode_digest_end is idempotent, drain is memoized, the staging
    ledger holds two chunk buffers between begin and end and returns to
    0, the ref counts the packed twin, and release() works undrained."""
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "async")
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    B, k, m, L = 2, 4, 2, 4096
    be = tbackend.TorchBackend("cpu")
    h = be.encode_digest_begin(_data(B, k, L), m)
    cw = subchunk_words(L // 4, 256)
    assert tbackend._staging_bytes == 2 * B * k * cw * 4
    assert device_budget().usage("codec_staging") == tbackend._staging_bytes
    digests, ref = be.encode_digest_end(h)
    assert tbackend._staging_bytes == 0
    assert device_budget().usage("codec_staging") == 0
    assert isinstance(ref, tbackend._SubchunkParityRef)
    assert be.encode_digest_end(h) == (digests, ref)
    assert ref.nbytes == B * m * L * 2  # parity + packed twin
    parity = ref.drain()
    assert ref.drain() is parity and parity.shape == (B, m, L)
    ref.release()  # after the drain: a no-op
    _d, ref2 = be.encode_digest_end(be.encode_digest_begin(_data(1, k, L), m))
    cache = tbackend.parity_plane_cache()
    assert cache.stats()["occupancy_bytes"] == ref2.nbytes > 0
    ref2.release()
    assert cache.stats()["occupancy_bytes"] == 0


def test_async_small_batch_takes_serialized_path(monkeypatch):
    """S < 3 chunks: async takes the serialized path with zero windows."""
    data = _data(1, 2, 1024)
    base, _ = _port_run(monkeypatch, "off", data, 1, drop=(0,))
    got, snap = _port_run(monkeypatch, "async", data, 1, drop=(0,))
    _assert_same(base, got, "async")
    assert snap["overlap_windows"] == {"put": 0, "get": 0}
    assert snap["device_passes"] == {
        "encode_words_fused1": 1, "verify_and_reconstruct_words": 1,
    }
    assert tbackend._staging_bytes == 0


def test_async_behind_the_batcher(monkeypatch):
    """MINIO_CODEC_BATCH wraps the same chain: merged digest encodes
    drain through one sub-chunked parent ref."""
    monkeypatch.setenv("MINIO_CODEC_BATCH", "on")
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "async")
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    be = tbackend.get_backend("cpu")
    assert str(be.device) == "cpu"
    data = _data(2, 4, 4096, seed=8)
    got = _roundtrip(be, data, 2, drop=(1,))
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
    want = _roundtrip(tbackend.TorchBackend("cpu"), data, 2, drop=(1,))
    _assert_same(want, got, "batched async")
    assert KERNEL_STATS.snapshot()["overlap_windows"] == {"put": 3, "get": 3}


# ---------------------------------------------------------------------------
# The object layer under every mode, against minio_tpu's under off
# ---------------------------------------------------------------------------

K4, M2, BLOCK = 4, 2, 32 * 1024  # 2,048 words per shard: S = 8 at 1 KiB
SIZE = BLOCK * 7 // 2 + 17


def _part(root, name):
    fi = XLStorage(root).read_version("bkt", name)
    with open(os.path.join(root, "bkt", name, fi.data_dir, "part.1"), "rb") as f:
        return f.read()


def _meta_doc(root, name):
    with open(os.path.join(root, "bkt", name, "xl.meta"), "rb") as f:
        raw = f.read()
    out = []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _damage(roots, name, shards):
    dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
    for s in shards:
        shutil.rmtree(os.path.join(roots[dist.index(s)], "bkt", name))


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """minio_tpu's object layer under off: the object written, then
    healed after losing shards 1 and 6."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        mp.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
        jbackend.reset_backend()
        base = tmp_path_factory.mktemp("jax")
        roots = [str(base / f"d{i}") for i in range(K4 + M2)]
        ref = JaxObjects(
            [JaxStorage(r) for r in roots], parity_blocks=M2, block_size=BLOCK
        )
        ref.make_bucket("bkt")
        payload = np.random.default_rng(5).bytes(SIZE)
        ref.put_object("bkt", "obj", io.BytesIO(payload), SIZE)
        written = [(_part(r, "obj"), _meta_doc(r, "obj")) for r in roots]
        _damage(roots, "obj", (1, 6))
        healed = ref.heal_object("bkt", "obj")
        after = [(_part(r, "obj"), _meta_doc(r, "obj")) for r in roots]
        jbackend.reset_backend()
        yield payload, written, healed, after


@pytest.mark.parametrize("mode", MODES)
def test_object_layer_every_mode_matches_jax(jax_set, tmp_path, monkeypatch, mode):
    payload, written, healed, after = jax_set
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", mode)
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    roots = [str(tmp_path / f"d{i}") for i in range(K4 + M2)]
    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M2, block_size=BLOCK,
        device="cpu",
    )
    ol.make_bucket("bkt")
    ol.put_object("bkt", "obj", io.BytesIO(payload), SIZE)
    assert [(_part(r, "obj"), _meta_doc(r, "obj")) for r in roots] == written
    dist = XLStorage(roots[0]).read_version("bkt", "obj").erasure.distribution
    dead = {dist.index(s) for s in (1, 5)}  # shard 1 (data), 5 (parity)
    degraded = from_reference_disks(
        [None if d in dead else r for d, r in enumerate(roots)],
        parity_blocks=M2, block_size=BLOCK, device="cpu",
    )
    sink = io.BytesIO()
    degraded.get_object("bkt", "obj", sink)
    assert sink.getvalue() == payload
    _damage(roots, "obj", (1, 6))
    assert ol.heal_object("bkt", "obj") == healed
    assert [(_part(r, "obj"), _meta_doc(r, "obj")) for r in roots] == after
    windows = KERNEL_STATS.snapshot()["overlap_windows"]
    if mode == "async":
        assert windows["put"] > 0 and windows["get"] > 0
    else:
        assert windows == {"put": 0, "get": 0}
