"""The legacy pass structure (MINIO_TPU_CODEC_KERNEL=legacy) on the port.

``codec_step.group_flags`` and ``pack_nonzero_groups`` (K12, K13 on the
card; their plain versions here) against the JAX package's on dense,
sparse, all-zero and all-nonzero planes; the backend's passes and D2H
bytes against the JAX package's (one encode pass before the drain, three
after a sparse drain under MINIO_TPU_DEVICE_COMPRESS=on); legacy
``reconstruct_and_verify`` against fused1's and the JAX package's under
every overlap mode; and a legacy PUT, degraded GET and heal whose part
files and xl.meta equal the JAX package's legacy ones.  Everything runs
on the CPU (TorchBackend("cpu"); the JAX side with MINIO_MESH=0).
"""

import io
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.telemetry import KERNEL_STATS as JAX_STATS
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.ops import codec_step as jcs
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.ops import codec_step as tcs, kernels
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

G = 256
KINDS = ("dense", "sparse", "zeros", "nonzero", "full", "first", "last")
# planes on the edges of K12's and K13's partitions (tests/
# test_torch_legacy_redesign.py): 6 rows of 21 groups (16-block clusters,
# g not a multiple), 16 of 13 (8-block clusters), 12 of 5 and 1 of 3 (g
# below the cluster), 1 row of 3,077 and 9 of 1,541 groups (past one
# cluster's shared memory at 16 and 8 blocks: two passes)
EDGE_SHAPES = [(2, 3, 21 * G), (4, 4, 13 * G), (3, 4, 5 * G), (1, 3 * G),
               (1, 1, 3077 * G), (3, 3, 1541 * G)]


@pytest.fixture(autouse=True)
def _fresh_backends(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _plane(kind: str, shape, seed: int = 0) -> np.ndarray:
    """u32 words: random, random on a third of the groups, all zero, one
    nonzero word (high bit set) in every group, no zero word, or one
    nonzero word in each row's first or last group."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, shape, dtype=np.uint32)
    *lead, w = shape
    g = w // G
    if kind == "sparse":
        keep = rng.random((*lead, g)) < 1 / 3
        words = words * np.repeat(keep, G, axis=-1)
    elif kind == "zeros":
        words[:] = 0
    elif kind == "nonzero":
        words[:] = 0
        at = rng.integers(0, G, (*lead, g))
        grouped = words.reshape(*lead, g, G)
        np.put_along_axis(grouped, at[..., None], np.uint32(0x80000000), axis=-1)
    elif kind == "full":
        words |= np.uint32(1)
    elif kind in ("first", "last"):
        words[:] = 0
        rows = words.reshape(-1, w)
        at = rng.integers(0, G, len(rows)) + (0 if kind == "first" else w - G)
        rows[np.arange(len(rows)), at] = rng.integers(1, 2**32, len(rows), dtype=np.uint32)
    return words


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(2, 3, 4 * G), (5, 2 * G), (3, 2, 2, 16 * G),
                                   *EDGE_SHAPES])
def test_group_flags_and_pack_equal_jax(kind, shape):
    words = _plane(kind, shape, seed=len(shape))
    flags = tcs.group_flags(_t(words), G)
    assert flags.dtype == torch.int32
    want = np.asarray(jcs.group_flags(jnp.asarray(words), G))
    assert np.array_equal(flags.numpy(), want.astype(np.int32))
    pflags, packed = tcs.pack_nonzero_groups(_t(words), G)
    jflags, jpacked = jcs.pack_nonzero_groups(jnp.asarray(words), G)
    assert np.array_equal(pflags.numpy(), np.asarray(jflags).astype(np.int32))
    assert np.array_equal(packed.numpy().view(np.uint32), np.asarray(jpacked))
    # the prefix is the nonzero groups in order; zeros follow
    kept = want.sum(axis=-1)
    grouped = packed.numpy().view(np.uint32).reshape(*shape[:-1], -1, G)
    for idx in np.ndindex(*shape[:-1]):
        assert not grouped[idx][kept[idx]:].any()


def test_legacy_steps_count_no_launch_on_the_cpu():
    kernels.reset_launches()
    words = _t(_plane("sparse", (2, 4 * G)))
    tcs.group_flags(words, G)
    tcs.pack_nonzero_groups(words, G)
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="multiple of group"):
        tcs.group_flags(_t(_plane("dense", (2, 3 * G // 2))), G)


@pytest.mark.parametrize("value,mode", [("legacy", "legacy"), ("fused1", "fused1"),
                                        ("LEGACY ", "legacy"), ("other", "fused1")])
def test_codec_kernel_mode_resolves_as_jax(monkeypatch, value, mode):
    monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", value)
    assert tcs.codec_kernel_mode() == jcs.codec_kernel_mode() == mode


def _stripes(batch, k, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (batch, k, L), dtype=np.uint8)


def _encode_passes(be, stats, data, m):
    """(passes before the drain, after it, D2H bytes by plane, digests,
    parity) of one digest-only encode."""
    stats.reset()
    dig, ref = be.encode_digest_end(be.encode_digest_begin(data, m))
    pre = dict(stats.snapshot()["device_passes"])
    par = ref.drain()
    ref.release()
    snap = stats.snapshot()
    d2h = {d["plane"]: d["bytes"] for d in snap["d2h"]}
    return pre, dict(snap["device_passes"]), d2h, dig, par


@pytest.mark.parametrize("compress", ["on", "auto", "off"])
@pytest.mark.parametrize("kernel", ["legacy", "fused1"])
def test_put_passes_and_d2h_equal_jax(monkeypatch, compress, kernel):
    """JAX test_fused_codec's pass counts on TorchBackend("cpu"): legacy is
    one pass before the drain and three after a sparse one under
    MINIO_TPU_DEVICE_COMPRESS=on; fused1 one in all.  Passes, D2H bytes,
    digests and parity equal the JAX package's."""
    monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", kernel)
    monkeypatch.setenv("MINIO_TPU_DEVICE_COMPRESS", compress)
    data = _stripes(2, 4, 4096, seed=2)
    data[:, :, : 4096 // 2] = 0  # sparse: the pack pass runs
    got = _encode_passes(tbackend.TorchBackend("cpu"), KERNEL_STATS, data, 2)
    want = _encode_passes(jbackend.TpuBackend(), JAX_STATS, data, 2)
    assert got[:3] == want[:3]
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[4], want[4])
    pre, post = got[:2]
    if kernel == "fused1":
        assert pre == post == {"encode_words_fused1": 1}
    else:
        assert pre == {"encode_and_hash_words_digest": 1}
        if compress == "on":
            assert sum(post.values()) == 3
            assert post["group_flags"] == post["pack_nonzero_groups"] == 1


@pytest.mark.parametrize("kind", ["zeros", "dense"])
def test_legacy_drain_of_empty_and_dense_planes(monkeypatch, kind):
    """An all-zero plane drains as the flags alone; a dense one under
    auto as the raw plane after the screen (no pack pass), as in JAX."""
    monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", "legacy")
    data = _stripes(2, 4, 4096, seed=5)
    if kind == "zeros":
        data[:] = 0
    got = _encode_passes(tbackend.TorchBackend("cpu"), KERNEL_STATS, data, 2)
    want = _encode_passes(jbackend.TpuBackend(), JAX_STATS, data, 2)
    assert got[:3] == want[:3]
    assert np.array_equal(got[4], want[4])
    assert "pack_nonzero_groups" not in got[1]


@pytest.mark.parametrize("overlap", ["off", "pipeline", "async"])
def test_legacy_reconstruct_and_verify_equals_fused1_and_jax(monkeypatch, overlap):
    """Heal's read side under legacy (verify, then reconstruct) answers
    as fused1's one pass and the JAX package's legacy, with a bitrotted
    survivor among the present rows; legacy ignores the overlap mode."""
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", overlap)
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")  # async chains here
    k, m, L = 4, 2, 4096
    data = _stripes(3, k, L, seed=11)
    ref_be = jbackend.TpuBackend()
    parity, digests = ref_be.encode(data, m)
    shards = np.concatenate([data, parity], axis=1)
    shards[1, 2, 7] ^= 0x40  # bitrot in a present data row of stripe 1
    present = (True, False, True, True, True, True)

    def run(kernel, be, stats):
        monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", kernel)
        stats.reset()
        out = be.reconstruct_and_verify(shards.copy(), digests, present, k, m)
        return out, dict(stats.snapshot()["device_passes"])

    (ldata, lok), lpasses = run("legacy", tbackend.TorchBackend("cpu"), KERNEL_STATS)
    (fdata, fok), _f = run("fused1", tbackend.TorchBackend("cpu"), KERNEL_STATS)
    (jdata, jok), jpasses = run("legacy", jbackend.TpuBackend(), JAX_STATS)
    assert np.array_equal(ldata, data) and np.array_equal(ldata, fdata)
    assert np.array_equal(ldata, jdata)
    assert np.array_equal(lok, fok) and np.array_equal(lok, jok)
    assert not lok[1, 2] and lok[0].sum() == 5
    assert lpasses == jpasses
    assert set(lpasses) == {"phash256_words_batched", "reconstruct_words_batch"}


# -- the object layer under legacy on both packages --------------------------

N, M = 12, 4
BLOCK = 32 * 1024  # 1,024 words a shard: four groups, the screen runs
SIZE = BLOCK * 11 // 2
DEAD_SHARDS = (1, 3, 10, 12)


def _meta(root: str, name: str) -> list:
    with open(f"{root}/bkt/{name}/xl.meta", "rb") as f:
        versions = XLMeta.from_bytes(f.read()).versions
    out = []
    for v in versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _files(roots: list, name: str) -> list:
    out = []
    for r in roots:
        fi = XLStorage(r).read_version("bkt", name)
        with open(f"{r}/bkt/{name}/{fi.data_dir}/part.1", "rb") as f:
            out.append((f.read(), _meta(r, name)))
    return out


@pytest.mark.parametrize("compress", ["on", "auto"])
def test_legacy_put_get_heal_equal_jax(tmp_path, monkeypatch, compress):
    """A legacy PUT of a sparse and a dense object, a GET of each with
    shards 1, 3, 10 and 12 offline, and heal_object of those shards:
    part files and xl.meta equal the JAX package's legacy ones, and the
    port's fused1 PUT's."""
    monkeypatch.setenv("MINIO_TPU_DEVICE_COMPRESS", compress)
    # no cross-request batcher: it may merge a PUT's pipelined batches into
    # one pass, at random, so the pass counts would not be comparable
    monkeypatch.setenv("MINIO_CODEC_BATCH", "off")
    rng = np.random.default_rng(26)
    dense = rng.bytes(SIZE)
    sparse = bytearray(SIZE)
    sparse[BLOCK // 3: BLOCK // 3 + 5000] = rng.bytes(5000)
    payloads = {"dense": dense, "sparse": bytes(sparse)}
    layers, passes = {}, {}
    for kind, kernel in (("port", "fused1"), ("port", "legacy"), ("jax", "legacy")):
        monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", kernel)
        roots = [str(tmp_path / f"{kind}-{kernel}{i}") for i in range(N)]
        if kind == "port":
            ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                                block_size=BLOCK, device="cpu")
        else:
            ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                            block_size=BLOCK)
        ol.make_bucket("bkt")
        stats = KERNEL_STATS if kind == "port" else JAX_STATS
        stats.reset()
        for name, data in payloads.items():
            ol.put_object("bkt", name, io.BytesIO(data), len(data))
        passes[(kind, kernel)] = dict(stats.snapshot()["device_passes"])
        layers[(kind, kernel)] = (ol, roots)
    assert passes[("port", "legacy")] == passes[("jax", "legacy")]
    assert passes[("port", "legacy")]["group_flags"] >= 2
    assert "encode_words_fused1" not in passes[("port", "legacy")]
    want = {name: _files(layers[("jax", "legacy")][1], name) for name in payloads}
    for key in (("port", "legacy"), ("port", "fused1")):
        for name in payloads:
            assert _files(layers[key][1], name) == want[name]
    monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", "legacy")
    for (kind, _kernel), (ol, roots) in layers.items():
        for name, data in payloads.items():
            dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
            for d in range(N):
                if dist[d] in DEAD_SHARDS:  # two data and two parity shards lost
                    shutil.rmtree(f"{roots[d]}/bkt/{name}")
            buf = io.BytesIO()
            ol.get_object("bkt", name, buf)  # rebuilt from the 8 survivors
            assert buf.getvalue() == data
            assert ol.heal_object("bkt", name)["healed"] == [0, 2, 9, 11]
            assert _files(roots, name) == want[name]
