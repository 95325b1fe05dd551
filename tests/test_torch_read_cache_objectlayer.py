"""The read cache under the port's object layer, held against minio_tpu's.

Both packages' ``ErasureObjects`` (6 disks, EC 3+3, 4 KiB blocks; the
port on ``device="cpu"``) run the same sequence with
``MINIO_TPU_READ_CACHE`` set to ``host`` and to ``device``: GET and
ranged GET, overwrite, delete, heal and ``update_object_meta``
invalidation, a corrupted cached group, the FileInfo side-car serving a
GET without a quorum read, and a full hit opening no shard reader.
Bodies are bit-identical, the caches' stats equal after every step, and
shard files and ``xl.meta`` equal the JAX package's with the cache on and
off.  Also: the groups a PUT populates are the same under the overlap
modes ``off``, ``pipeline`` and ``async`` and the ``mxu`` formulation;
admission from reconstructed rows when parity shards are preferred; the
Select pushdown over the device tier (``device_scan_source``) against
the JAX package's host engine; no tensor the cache hands out is written.
"""

from __future__ import annotations

import io
import os
import shutil

import numpy as np
import pytest
import torch

from minio_tpu import cache as jcache
from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.erasure import Erasure as JaxErasure
from minio_tpu.objectlayer import erasure_object as jeo
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.s3select import engine as jeng
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.cache import tiered as ttiered
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.erasure import Erasure
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer import erasure_object as teo
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.s3select import device as tdev, engine as teng
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_select import _body, _rows, _run, _split
from tests.test_torch_sse import _files, _meta_doc, _pay
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096
MODES = ["host", "device"]
_ENV = ("MINIO_TPU_READ_CACHE", "MINIO_TPU_READ_CACHE_MB",
        "MINIO_TPU_READ_CACHE_DEVICE_MB", "MINIO_TPU_DEVICE_BUDGET_MB",
        "MINIO_TPU_CODEC_OVERLAP", "MINIO_TPU_CODEC_FORMULATION",
        "MINIO_TPU_CODEC_SUBCHUNK_KB", "MINIO_TPU_SELECT")


def _reset():
    for mod in (jcache, tcache):
        mod.reset_read_cache()
        mod.reset_device_budget()
    jbackend.reset_backend()
    tbackend.reset_backend()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    _reset()
    yield
    _reset()


def _cache(monkeypatch, mode):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", mode)
    for mod in (jcache, tcache):
        mod.reset_read_cache()


class Both:
    """The same calls on the port's and the JAX package's object layer."""

    def __init__(self, tmp_path, tag="", block=BLOCK):
        self.troots = [str(tmp_path / f"port{tag}{i}") for i in range(6)]
        self.jroots = [str(tmp_path / f"jax{tag}{i}") for i in range(6)]
        self.port = ErasureObjects([XLStorage(r) for r in self.troots],
                                   block_size=block, device="cpu")
        self.ref = JaxObjects([JaxStorage(r) for r in self.jroots],
                              block_size=block)
        for ol in (self.port, self.ref):
            ol.make_bucket("bkt")

    def put(self, name, data, **kw):
        for ol in (self.port, self.ref):
            ol.put_object("bkt", name, io.BytesIO(data), len(data), **kw)

    def get(self, name, offset=0, length=-1, **kw) -> bytes:
        out = []
        for ol in (self.port, self.ref):
            buf = io.BytesIO()
            ol.get_object("bkt", name, buf, offset, length, **kw)
            out.append(buf.getvalue())
        assert out[0] == out[1]
        return out[0]

    def call(self, method, *args, **kw):
        return [getattr(ol, method)(*args, **kw) for ol in (self.port, self.ref)]

    def same_stats(self) -> dict:
        st = tcache.read_cache_stats()
        assert st == jcache.read_cache_stats()
        return st

    def same_files(self, name):
        for tr, jr in zip(self.troots, self.jroots):
            assert _files(tr, name) == _files(jr, name)
            assert _meta_doc(tr, name) == _meta_doc(jr, name)


def _tier(st, mode):
    return st["tiers"][mode]


@pytest.mark.parametrize("mode", MODES)
def test_get_and_ranges_bit_identical(tmp_path, monkeypatch, mode):
    off = Both(tmp_path, "off")
    payload = _pay(5 * BLOCK + 123, 1)
    off.put("obj", payload)
    assert off.get("obj") == payload
    assert tcache.read_cache() is None and jcache.read_cache() is None
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    b.put("obj", payload)
    st = b.same_stats()
    assert _tier(st, mode)["entries"] == 3  # blocks 0-3, block 4, the tail
    for _ in range(2):
        assert b.get("obj") == payload
        b.same_stats()
    for off_, ln in ((0, 10), (BLOCK - 3, 7), (BLOCK, 2 * BLOCK), (17, -1),
                     (5 * BLOCK, 123)):
        want = payload[off_:] if ln < 0 else payload[off_:off_ + ln]
        assert b.get("obj", off_, ln) == want
        b.same_stats()
    st = b.same_stats()
    assert _tier(st, mode)["hits"] >= 4 and _tier(st, mode)["misses"] >= 1
    assert st["mode"] == mode
    # part files and xl.meta equal the JAX package's, cache on and off
    b.same_files("obj")
    for tr, jr in zip(b.troots, off.jroots):
        assert _files(tr, "obj") == _files(jr, "obj")
        assert _meta_doc(tr, "obj") == _meta_doc(jr, "obj")
    if mode == "device":
        ents = tcache.read_cache()._tiers["device"].values()
        assert all(isinstance(e.data, torch.Tensor) for e in ents)
        assert all(e.data.device == torch.device("cpu") for e in ents)


@pytest.mark.parametrize("value", ["off", "bogus", ""])
def test_off_mode_is_inert(tmp_path, monkeypatch, value):
    _cache(monkeypatch, value)
    b = Both(tmp_path)
    payload = _pay(2 * BLOCK, 3)
    b.put("obj", payload)
    assert b.get("obj") == payload
    assert tcache.read_cache() is None
    st = b.same_stats()
    assert st["mode"] == "off" and _tier(st, "host")["hits"] == 0
    b.same_files("obj")


@pytest.mark.parametrize("mode", MODES)
def test_overwrite_delete_invalidate(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    old, new = _pay(3 * BLOCK, 4), _pay(3 * BLOCK + 5, 5)
    b.put("obj", old)
    assert b.get("obj") == old
    b.put("obj", new)
    assert b.get("obj") == new
    assert b.get("obj") == new  # the hot path too
    st = b.same_stats()
    assert st["invalidations"] >= 1
    b.same_files("obj")
    before = st["invalidations"]
    b.call("delete_object", "bkt", "obj")
    st = b.same_stats()
    assert st["invalidations"] > before and _tier(st, mode)["entries"] == 0
    for ol in (b.port, b.ref):
        with pytest.raises(Exception, match="obj"):
            ol.get_object("bkt", "obj", io.BytesIO())


@pytest.mark.parametrize("mode", MODES)
def test_heal_invalidates(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    payload = _pay(2 * BLOCK + 9, 7)
    b.put("obj", payload)
    b.get("obj")
    for root in (b.troots[2], b.jroots[2]):
        shutil.rmtree(root)
        os.makedirs(os.path.join(root, ".sys", "tmp"))
    before = b.same_stats()["invalidations"]
    res = b.call("heal_object", "bkt", "obj")
    assert res[0]["healed"] == res[1]["healed"] and res[0]["healed"]
    st = b.same_stats()
    assert st["invalidations"] > before and _tier(st, mode)["entries"] == 0
    assert b.get("obj") == payload
    b.same_stats()
    b.same_files("obj")


@pytest.mark.parametrize("mode", MODES)
def test_update_object_meta_drops_the_sidecar(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    payload = _pay(16_000, 32)
    b.put("tagged", payload)
    assert b.get("tagged") == payload
    assert tcache.read_cache().meta_lookup("bkt", "tagged") is not None
    b.call("update_object_meta", "bkt", "tagged", {"x-amz-tagging": "team=storage"})
    assert tcache.read_cache().meta_lookup("bkt", "tagged") is None
    assert jcache.read_cache().meta_lookup("bkt", "tagged") is None
    infos = []
    for ol in (b.port, b.ref):
        buf = io.BytesIO()
        infos.append(ol.get_object("bkt", "tagged", buf).user_defined)
        assert buf.getvalue() == payload
    assert infos[0]["x-amz-tagging"] == infos[1]["x-amz-tagging"] == "team=storage"
    b.same_stats()
    b.same_files("tagged")


@pytest.mark.parametrize("mode", MODES)
def test_corrupted_cached_group_falls_back_to_quorum(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    payload = _pay(3 * BLOCK + 41, 8)
    b.put("obj", payload)
    b.get("obj")
    b.same_stats()
    # rot every cached group, in both packages
    for c in (tcache.read_cache(), jcache.read_cache()):
        tier = c._tiers[mode]
        assert tier, "PUT should have populated the cache"
        for ent in tier.values():
            if isinstance(ent.data, torch.Tensor):
                ent.data[..., 0] ^= 0xFF
            else:
                bad = np.array(ent.data, copy=True)
                bad[..., 0] ^= 0xFF
                ent.data = bad
    assert b.get("obj") == payload  # served from the quorum read, not rot
    st = b.same_stats()
    assert st["verify_drops"] == 2
    # the quorum read admitted the groups again: the next GET hits
    hits = _tier(st, mode)["hits"]
    assert b.get("obj") == payload
    assert _tier(b.same_stats(), mode)["hits"] == hits + 2


@pytest.mark.parametrize("mode", MODES)
def test_sidecar_and_full_hit_make_no_disk_reads(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    payload = _pay(24_000, 31)
    b.put("meta-obj", payload)
    assert b.get("meta-obj") == payload  # warm: stores the FileInfo

    def boom(*a, **kw):
        raise AssertionError("a full hit must not read xl.meta or open shards")

    calls0 = {i: dict(d.api_stats()) for i, d in enumerate(b.port.disks)}
    for mod in (teo, jeo):
        monkeypatch.setattr(mod, "read_all_fileinfo", boom)
    for ol in (b.port, b.ref):
        monkeypatch.setattr(ol, "_part_readers", boom)
    assert b.get("meta-obj") == payload  # fully cached: meta + groups
    b.same_stats()
    # the disks saw the bucket check alone
    for i, d in enumerate(b.port.disks):
        moved = {api: row["calls"] - calls0[i].get(api, {"calls": 0})["calls"]
                 for api, row in d.api_stats().items()}
        assert {a for a, n in moved.items() if n} <= {"stat_vol"}
    # version-pinned reads never use the side-car
    for ol in (b.port, b.ref):
        with pytest.raises(AssertionError):
            ol.get_object("bkt", "meta-obj", io.BytesIO(), version_id="null")
    # invalidation drops the side-car entry too: the next GET needs the
    # (now broken) quorum read again
    for mod in (tcache, jcache):
        mod.invalidate_local("bkt", "meta-obj")
    for ol in (b.port, b.ref):
        with pytest.raises(AssertionError):
            ol.get_object("bkt", "meta-obj", io.BytesIO())
    b.same_stats()


class _LocalityShard:
    """In-memory shard file whose locality the test controls: a node whose
    local drives hold parity prefers them, so a healthy GET reconstructs."""

    def __init__(self, is_local):
        self.is_local = is_local
        self.buf = bytearray()
        self.reads = 0

    def write(self, b):
        self.buf += b

    def read_at(self, off, length):
        self.reads += 1
        return bytes(self.buf[off:off + length])


@pytest.mark.parametrize("mode", MODES)
def test_admits_from_reconstructed_rows_when_parity_preferred(monkeypatch, mode):
    _cache(monkeypatch, mode)
    k, m, size = 3, 3, 40_000
    payload = _pay(size, 21)
    outs = {}
    for name, er, cache, be in (
        ("port", Erasure(k, m, 4096), tcache, tbackend.get_backend("cpu")),
        ("jax", JaxErasure(k, m, 4096), jcache, None),
    ):
        shards = [_LocalityShard(is_local=(i >= k)) for i in range(k + m)]
        kw = {"backend": be} if be is not None else {}
        er.encode(io.BytesIO(payload), list(shards), write_quorum=k + 1, **kw)
        ctx = (cache.context_for("bucket", "obj", "dd-rec", 1, "cpu")
               if cache is tcache else cache.context_for("bucket", "obj", "dd-rec", 1))
        out = io.BytesIO()
        written, heal = er.decode(out, list(shards), 0, size, size,
                                  cache_ctx=ctx, **kw)
        assert (written, heal, out.getvalue()) == (size, False, payload)
        assert all(s.reads == 0 for s in shards[:k])  # parity preferred

        def no_readers():
            raise AssertionError("a cache hit must not open shard readers")

        out2 = io.BytesIO()
        assert er.decode(out2, no_readers, 0, size, size, cache_ctx=ctx,
                         **kw) == (size, False)
        assert out2.getvalue() == payload
        outs[name] = cache.read_cache_stats()
    assert outs["port"] == outs["jax"]
    assert _tier(outs["port"], mode)["entries"] >= 1


def _groups(cache) -> dict:
    out = {}
    for tier in ttiered.TIERS:
        for key, ent in cache._tiers[tier].items():
            data = ent.data
            data = data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
            out[key[3:]] = (tier, data.tobytes(), np.asarray(ent.digests).tobytes())
    return out


@pytest.mark.parametrize("overlap,formulation", [
    ("off", "swar"), ("pipeline", "swar"), ("async", "swar"),
    ("pipeline", "mxu"), ("off", "mxu"),
])
@pytest.mark.parametrize("mode", MODES)
def test_populated_groups_equal_under_every_mode(tmp_path, monkeypatch, mode,
                                                 overlap, formulation):
    _cache(monkeypatch, mode)
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    payload = _pay(9 * 16 * BLOCK + 777, 40)
    ref = JaxObjects([JaxStorage(str(tmp_path / f"jax{i}")) for i in range(6)],
                     block_size=16 * BLOCK)
    ref.make_bucket("bkt")
    ref.put_object("bkt", "obj", io.BytesIO(payload), len(payload))
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", overlap)
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", formulation)
    tbackend.reset_backend()
    KERNEL_STATS.reset()
    roots = [str(tmp_path / f"port{i}") for i in range(6)]
    port = ErasureObjects([XLStorage(r) for r in roots], block_size=16 * BLOCK,
                          device="cpu")
    port.make_bucket("bkt")
    port.put_object("bkt", "obj", io.BytesIO(payload), len(payload))
    if overlap == "async":
        assert KERNEL_STATS.snapshot()["overlap_windows"]["put"] > 0
    got, want = _groups(tcache.read_cache()), _groups(jcache.read_cache())
    assert got == want
    # groups at absolute block coordinates: 4 + 4 + 1 full, then the tail
    assert sorted(k[1:3] for k in got) == [(0, 4), (4, 4), (8, 1), (9, 1)]
    assert tcache.read_cache_stats() == jcache.read_cache_stats()
    buf = io.BytesIO()
    port.get_object("bkt", "obj", buf)
    assert buf.getvalue() == payload
    assert _tier(tcache.read_cache_stats(), mode)["hits"] == 4
    for i, r in enumerate(roots):
        assert _files(r, "obj") == _files(str(tmp_path / f"jax{i}"), "obj")


# -- Select over the device tier ----------------------------------------------


SELECT_EXPRS = [
    "SELECT * FROM S3Object s WHERE s.k < 500",
    "SELECT s.k FROM S3Object s WHERE s.tag = 't2'",
    "SELECT COUNT(*) FROM S3Object s WHERE s.v < 0",
]


@pytest.mark.parametrize("expr", SELECT_EXPRS)
def test_device_tier_scan_matches_the_host_engine(tmp_path, monkeypatch, expr):
    _cache(monkeypatch, "device")
    data = _rows(3000, 6)
    port = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(6)],
                          block_size=16 * BLOCK, device="cpu")
    port.make_bucket("bkt")
    port.put_object("bkt", "rows.csv", io.BytesIO(data), len(data))
    c = tcache.read_cache()
    entries = c.device_entries("bkt", "rows.csv")
    kept = {k: v.clone() for k, v in entries.items()}
    monkeypatch.setattr(port, "_part_readers", lambda *a: pytest.fail("opened"))
    src = port.device_scan_source("bkt", "rows.csv")
    assert src is not None
    plane, nbytes = src
    assert nbytes == len(data) and plane.device == c.device
    frames: list = []
    sel = teng.S3Select(teng.SelectRequest.from_xml(_body(expr)), "cpu")
    assert sel.device_capable()
    s0 = tdev.STATS.snapshot()["requests"]["device"]
    sel.evaluate(None, len(data), frames.append, device_source=src)
    assert tdev.STATS.snapshot()["requests"]["device"] == s0 + 1
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, _body(expr), data)
    assert _split(frames) == _split(jf)
    # the plane is a copy; the cached tensors were never written
    ptrs = {t.untyped_storage().data_ptr() for t in entries.values()}
    assert plane.untyped_storage().data_ptr() not in ptrs
    for key, t in c.device_entries("bkt", "rows.csv").items():
        assert torch.equal(t, kept[key])


@pytest.mark.parametrize("case", ["host_mode", "host_tier", "compressed", "partial",
                                  "absent", "deleted", "off"])
def test_device_scan_source_declines(tmp_path, monkeypatch, case):
    _cache(monkeypatch, "host" if case == "host_mode" else
           "off" if case == "off" else "device")
    data = _rows(2000, 7)
    port = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(6)],
                          block_size=16 * BLOCK, device="cpu")
    port.make_bucket("bkt")
    port.put_object("bkt", "rows.csv", io.BytesIO(data), len(data),
                    compress=case == "compressed")
    c = tcache.read_cache()
    if case == "host_tier":
        for ent in list(c._tiers["device"].values()):
            c._evict(ent)  # demoted to the host tier
        assert c._tiers["host"]
    elif case == "partial":
        c._drop(next(iter(c._tiers["device"])))
    elif case == "deleted":
        port.delete_object("bkt", "rows.csv")
    name = "nothing.csv" if case == "absent" else "rows.csv"
    assert port.device_scan_source("bkt", name) is None


@pytest.mark.parametrize("mode", MODES)
def test_get_leaves_cached_tensors_unwritten(tmp_path, monkeypatch, mode):
    _cache(monkeypatch, mode)
    b = Both(tmp_path)
    payload = _pay(6 * BLOCK + 3, 11)
    b.put("obj", payload)
    c = tcache.read_cache()
    kept = {k: (e.data.clone() if isinstance(e.data, torch.Tensor)
                else e.data.copy()) for k, e in c._tiers[mode].items()}
    for off_, ln in ((0, -1), (5, 100), (BLOCK * 4, -1)):
        want = payload[off_:] if ln < 0 else payload[off_:off_ + ln]
        assert b.get("obj", off_, ln) == want
    for k, before in kept.items():
        now = c._tiers[mode][k].data
        if isinstance(now, torch.Tensor):
            assert torch.equal(now, before)
        else:
            assert np.array_equal(now, before)


def test_device_copy_failure_fails_put_and_get(tmp_path, monkeypatch):
    """``device`` mode never quietly serves from the host tier: a failed
    copy onto the device raises out of the PUT that populates and out of
    the GET that admits."""
    port = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(6)],
                          block_size=BLOCK, device="cpu")
    port.make_bucket("bkt")
    payload = _pay(3 * BLOCK, 12)
    port.put_object("bkt", "before", io.BytesIO(payload), len(payload))
    _cache(monkeypatch, "device")

    def oom(arr, device):
        raise RuntimeError("CUDA out of memory (forced)")

    monkeypatch.setattr(ttiered, "_to_device", oom)
    with pytest.raises(RuntimeError, match="out of memory"):
        port.put_object("bkt", "obj", io.BytesIO(payload), len(payload))
    with pytest.raises(RuntimeError, match="out of memory"):
        port.get_object("bkt", "before", io.BytesIO())
    st = tcache.read_cache_stats()
    assert st["tiers"]["host"]["entries"] == st["tiers"]["device"]["entries"] == 0
