"""The port's disk cache (objectlayer/cache.py) against the JAX package's.

Each test runs the same calls on a ``CacheObjectLayer`` of each package,
the JAX one over a JAX ``ErasureObjects``, the port's over a port
``ErasureObjects`` on ``device="cpu"`` (EC 2+2, 4 KiB blocks), with the
payloads made from one numpy seed.  It mirrors ``tests/test_disk_cache.py``
(read-through and hits, invalidation on overwrite and delete, the etag
check against the backend, LRU GC between the watermarks, objects over a
quarter of the quota never cached, range validation, passthrough,
re-population accounting, concurrent hits) and holds the answers, the
hit and miss counts, ``cache_stats()`` (drive roots made relative) and
the cache drives' entry files (``<h[:2]>/<h>/data`` and ``meta.json``)
byte-equal between the two packages.  The admin ``cache-stats`` route
answers alike on an ``S3Server`` of each package.
"""

from __future__ import annotations

import io
import os
import threading
import time

import numpy as np
import pytest

from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer.cache import CacheObjectLayer as JCache
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JObjects
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage.xl import XLStorage as JXL
from minio_tpu_torch.objectlayer import api as tapi
from minio_tpu_torch.objectlayer import cache as tcachemod
from minio_tpu_torch.objectlayer.cache import CacheObjectLayer as TCache
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects as TObjects
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage.xl import XLStorage as TXL
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096
KINDS = ("jax", "port")
RNG_SEED = 2323


def _backend(kind, root):
    if kind == "jax":
        return JObjects([JXL(os.path.join(root, f"d{i}")) for i in range(4)],
                        block_size=BLOCK, min_part_size=1)
    return TObjects([TXL(os.path.join(root, f"d{i}")) for i in range(4)],
                    block_size=BLOCK, device="cpu")


def _pair(tmp_path, quota=1 << 20, drives=2):
    """{kind: (backend, cache)} over fresh drives of their own."""
    out = {}
    for kind in KINDS:
        root = str(tmp_path / kind)
        backend = _backend(kind, root)
        cls = JCache if kind == "jax" else TCache
        cache = cls(backend, [os.path.join(root, f"cache{i}")
                              for i in range(drives)], quota_bytes=quota)
        cache.make_bucket("bkt")
        out[kind] = (backend, cache)
    return out


def _payloads(*sizes):
    rng = np.random.default_rng(RNG_SEED)
    return [rng.bytes(n) for n in sizes]


def _get(layer, key, **kw):
    buf = io.BytesIO()
    layer.get_object("bkt", key, buf, **kw)
    return buf.getvalue()


def _put(layer, key, data):
    layer.put_object("bkt", key, io.BytesIO(data), len(data))


def _entries(cache) -> dict:
    """Every file under the cache drives: (drive index, relative path)
    -> bytes."""
    out = {}
    for i, d in enumerate(cache.drives):
        for dirpath, _dirs, files in os.walk(d.root):
            for fn in files:
                p = os.path.join(dirpath, fn)
                with open(p, "rb") as f:
                    out[(i, os.path.relpath(p, d.root))] = f.read()
    return out


def _stats(cache) -> dict:
    doc = cache.cache_stats()
    for d in doc["drives"]:
        d["root"] = os.path.basename(d["root"])
    return doc


def _same(pair):
    """Stats and entry files equal between the packages."""
    got = {k: (_stats(c), _entries(c)) for k, (_b, c) in pair.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_read_through_and_hit(tmp_path):
    pair = _pair(tmp_path)
    (data,) = _payloads(9000)
    for _b, cache in pair.values():
        _put(cache, "obj", data)
        assert _get(cache, "obj") == data  # miss: populates
        assert (cache.misses, cache.hits) == (1, 0)
        assert _get(cache, "obj") == data  # hit
        assert cache.hits == 1
        # range served from the cached whole object
        assert _get(cache, "obj", offset=100, length=50) == data[100:150]
        assert cache.hits == 2
    stats, entries = _same(pair)
    assert sorted(p.rsplit(os.sep, 1)[1] for _i, p in entries) == ["data", "meta.json"]
    assert [v for (_i, p), v in entries.items() if p.endswith("data")] == [data]


def test_overwrite_invalidates(tmp_path):
    pair = _pair(tmp_path)
    for _b, cache in pair.values():
        _put(cache, "obj", b"v1-data!")
        assert _get(cache, "obj") == b"v1-data!"
        assert _get(cache, "obj") == b"v1-data!"
        _put(cache, "obj", b"v2-data!")
        assert _get(cache, "obj") == b"v2-data!"  # not the stale v1
    _same(pair)


def test_stale_etag_detected_even_without_invalidate(tmp_path):
    """Backend changed behind the cache's back (another node wrote):
    the etag check refuses the stale entry."""
    pair = _pair(tmp_path)
    for backend, cache in pair.values():
        _put(cache, "obj", b"first!!!")
        _get(cache, "obj")
        hits_before = cache.hits
        _put(backend, "obj", b"second!!")  # the cache is unaware
        assert _get(cache, "obj") == b"second!!"
        assert cache.hits == hits_before  # the stale entry did not serve
    _same(pair)


def test_delete_invalidates(tmp_path):
    pair = _pair(tmp_path)
    for kind, (_b, cache) in pair.items():
        _put(cache, "obj", b"bye")
        _get(cache, "obj")
        cache.delete_object("bkt", "obj")
        api = japi if kind == "jax" else tapi
        with pytest.raises(api.ObjectNotFound):
            _get(cache, "obj")
    stats, entries = _same(pair)
    assert entries == {} and stats["misses"] == 1


def test_lru_gc_evicts_oldest(tmp_path):
    quota = 100_000
    pair = _pair(tmp_path, quota=quota, drives=1)
    datas = _payloads(*[20_000] * 6)
    for i, data in enumerate(datas):
        for _b, cache in pair.values():
            _put(cache, f"o{i}", data)
            _get(cache, f"o{i}")
        time.sleep(0.01)  # distinct mtimes
    for _b, cache in pair.values():
        drive = cache.drives[0]
        assert drive.used <= quota * tcachemod.HIGH_WATERMARK + 20_000
        # oldest entries evicted, newest survive
        assert drive.get("bkt", "o5") is not None
        assert drive.get("bkt", "o0") is None
    _same(pair)


def test_huge_objects_not_cached(tmp_path):
    pair = _pair(tmp_path, quota=50_000, drives=1)
    (big,) = _payloads(30_000)  # over 25 % of the quota
    for _b, cache in pair.values():
        _put(cache, "big", big)
        assert _get(cache, "big") == big
        assert cache.drives[0].get("bkt", "big") is None  # skipped
        assert _get(cache, "big") == big  # still right, read through
    stats, entries = _same(pair)
    assert entries == {} and stats["misses"] == 2


def test_cached_range_validation_matches_backend(tmp_path):
    """Out-of-range reads on a cached object raise InvalidRange as the
    backend does."""
    pair = _pair(tmp_path)
    for kind, (_b, cache) in pair.items():
        api = japi if kind == "jax" else tapi
        _put(cache, "small", b"0123456789")
        _get(cache, "small")  # populate
        with pytest.raises(api.InvalidRange):
            _get(cache, "small", offset=5, length=20)
        with pytest.raises(api.InvalidRange):
            _get(cache, "small", offset=11)
    _same(pair)


def test_passthrough_methods(tmp_path):
    pair = _pair(tmp_path)
    for _b, cache in pair.values():
        _put(cache, "listed", b"x")
        res = cache.list_objects("bkt")
        assert "listed" in [o.name for o in res.objects]
        assert cache.storage_info()["disks"] == 4
    # the port's own hooks pass through too (the select scan's source,
    # the block size)
    _b, tcache = pair["port"]
    assert tcache.block_size == BLOCK
    assert callable(tcache.device_scan_source)


def test_repopulate_does_not_double_count(tmp_path):
    """Refreshing a stale entry in place swaps its bytes in the
    accounting instead of adding them again."""
    pair = _pair(tmp_path)
    (data,) = _payloads(4000)
    for backend, cache in pair.values():
        _put(cache, "obj", data)
        _get(cache, "obj")  # populate
        base = sum(d.used for d in cache.drives)
        _put(backend, "obj", data[::-1])  # behind the cache
        for _ in range(5):
            assert _get(cache, "obj") == data[::-1]
        assert sum(d.used for d in cache.drives) == base
    _same(pair)


def test_concurrent_hits_no_meta_race(tmp_path):
    """The read path does not rewrite meta.json: every later read of
    8 threads is a clean hit."""
    pair = _pair(tmp_path)
    (data,) = _payloads(6000)
    for _b, cache in pair.values():
        _put(cache, "obj", data)
        _get(cache, "obj")  # populate
        errs = []

        def reader(cache=cache):
            try:
                for _ in range(30):
                    assert _get(cache, "obj") == data
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=reader) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert (cache.misses, cache.hits) == (1, 240)
    _same(pair)


def test_cache_from_env(tmp_path, monkeypatch):
    """The same knobs wrap alike: no drives leave the layer bare, a
    quota in MiB and a bad quota (0) as the JAX package reads them."""
    from minio_tpu.objectlayer.cache import cache_from_env as jfrom_env

    for kind, fn in (("jax", jfrom_env), ("port", tcachemod.cache_from_env)):
        backend = _backend(kind, str(tmp_path / kind))
        monkeypatch.delenv("MINIO_TPU_CACHE_DRIVES", raising=False)
        assert fn(backend) is backend
        monkeypatch.setenv("MINIO_TPU_CACHE_DRIVES",
                           f" {tmp_path}/{kind}/c0 ,,{tmp_path}/{kind}/c1")
        for quota, want in (("8", 8 << 20), ("bad", 0)):
            monkeypatch.setenv("MINIO_TPU_CACHE_QUOTA_MB", quota)
            wrapped = fn(backend)
            assert [os.path.basename(d.root) for d in wrapped.drives] == ["c0", "c1"]
            assert {d.quota for d in wrapped.drives} == {want}


def _await_filled(layer, deadline_s: float = 30.0) -> None:
    """Wait until a GET's miss has filled the cache: the layer tees the
    body to the client and adopts the staged copy after the client holds
    the last byte, so the next request can be served first."""
    end = time.monotonic() + deadline_s
    while not any(d.used for d in layer.drives):
        assert time.monotonic() < end, "the miss never filled the cache"
        time.sleep(0.005)


def test_admin_cache_stats_route(tmp_path):
    """``cache-stats`` on a server whose layer is the disk cache, after
    a miss and a hit, and on one without it, answers alike."""
    got = {}
    (data,) = _payloads(5000)
    for kind in KINDS:
        root = str(tmp_path / f"srv-{kind}")
        backend = _backend(kind, root)
        cls, srv_cls = (JCache, JS3Server) if kind == "jax" else (TCache, TS3Server)
        answers = []
        for layer in (cls(backend, [os.path.join(root, "c0")], 1 << 20), backend):
            srv = srv_cls(layer, address="127.0.0.1:0").start()
            try:
                c = S3Client(srv.endpoint)
                if not answers:
                    assert c.make_bucket("bkt").status == 200
                    assert c.put_object("bkt", "o", data).status == 200
                    for _ in range(2):
                        assert c.get_object("bkt", "o").body == data
                        _await_filled(layer)
                r = c.request("GET", "/minio-tpu/admin/v1/cache-stats")
                body = r.body.replace(root.encode(), b"ROOT")
                answers.append((r.status, body))
            finally:
                srv.shutdown()
        got[kind] = answers
    assert got["port"] == got["jax"]
    assert b'"hits": 1' in got["port"][0][1] and got["port"][1] == (
        200, b'{"enabled": false}')
