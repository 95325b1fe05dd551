"""The port's data crawler and update tracker against the JAX package's.

* ``DataUpdateTracker``: the same marks and rotations give the same
  bloom filters, the same ``cyclebloom`` wire documents and a snapshot
  file byte for byte equal to the JAX tracker's ``msgpack`` file; each
  package loads the other's file into the same state (the in-flight
  cycle untrusted after the reload, as in the JAX package).
* ``DataCrawler`` on both packages' ``ErasureObjects`` (EC 4+2, the
  port on ``device="cpu"``, ``MINIO_MESH=0``) over one namespace made
  from a numpy seed: lifecycle expiry by date, by days and by tags,
  current-version expiry on a versioned bucket (a delete marker),
  noncurrent expiry, lone delete markers, stale multipart uploads, a
  FIFO quota that skips a locked version, and one object with a lost
  shard.  ``crawl_once(force=True)`` runs in-process with the clock
  moved ten days ahead; the usage snapshots (memory and persisted),
  the order of every delete the crawl issued, the heals it queued, the
  listing left behind and, with a tracker attached, which buckets each
  later sweep crawled or skipped, are equal.
* The admin ``datausage`` and ``crawl`` routes, the peer plane's
  ``cyclebloom`` (each package's client against the other's server),
  the admission's quota shed and the crawler's interval knob answer as
  the JAX package's do.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import numpy as np
import pytest

from minio_tpu.cluster import peer as jpeer
from minio_tpu.crawler import crawler as jcrawler
from minio_tpu.crawler import updatetracker as jut
from minio_tpu.objectlayer import bucket_meta as jbucket_meta
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JObjects
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage.xl import XLStorage as JXL
from minio_tpu_torch.cluster import peer as tpeer
from minio_tpu_torch.crawler import crawler as tcrawler
from minio_tpu_torch.crawler import updatetracker as tut
from minio_tpu_torch.dsync.namespace import LockTimeout
from minio_tpu_torch.objectlayer import bucket_meta as tbucket_meta
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects as TObjects
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage.xl import XLStorage as TXL
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "crawler-secret"
BLOCK = 4096
DAY_NS = 86400 * 10**9
FAR = "2090-01-01T00:00:00Z"
PKG = {
    "jax": (JObjects, JXL, jbucket_meta, jcrawler, jut),
    "port": (TObjects, TXL, tbucket_meta, tcrawler, tut),
}
LIFE_XML = (
    "<LifecycleConfiguration>"
    "<Rule><ID>date</ID><Status>Enabled</Status><Filter><Prefix>old/"
    "</Prefix></Filter><Expiration><Date>2020-01-01T00:00:00Z</Date>"
    "</Expiration></Rule>"
    "<Rule><ID>days</ID><Status>Enabled</Status><Filter><Prefix>tmp/"
    "</Prefix></Filter><Expiration><Days>3</Days></Expiration></Rule>"
    "<Rule><ID>tag</ID><Status>Enabled</Status><Filter><Tag><Key>t</Key>"
    "<Value>1</Value></Tag></Filter><Expiration><Days>5</Days>"
    "</Expiration></Rule>"
    "<Rule><ID>up</ID><Status>Enabled</Status><Filter><Prefix>up/</Prefix>"
    "</Filter><AbortIncompleteMultipartUpload><DaysAfterInitiation>1"
    "</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>"
    "</LifecycleConfiguration>"
)
VER_XML = (
    "<LifecycleConfiguration>"
    "<Rule><ID>cur</ID><Status>Enabled</Status><Filter><Prefix>cur/"
    "</Prefix></Filter><Expiration><Date>2020-01-01T00:00:00Z</Date>"
    "</Expiration></Rule>"
    "<Rule><ID>nc</ID><Status>Enabled</Status><Filter><Prefix>old/"
    "</Prefix></Filter><NoncurrentVersionExpiration><NoncurrentDays>2"
    "</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
    "<Rule><ID>dm</ID><Status>Enabled</Status><Filter><Prefix>dm/</Prefix>"
    "</Filter><Expiration><ExpiredObjectDeleteMarker>true"
    "</ExpiredObjectDeleteMarker></Expiration></Rule>"
    "</LifecycleConfiguration>"
)


def _pay(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _layer(kind: str, base) -> tuple:
    objects, xl, bm, _c, _u = PKG[kind]
    disks = [xl(str(base / f"{kind}{i}")) for i in range(6)]
    kw = {"device": "cpu"} if kind == "port" else {}
    ol = objects(disks, parity_blocks=2, block_size=BLOCK, **kw)
    return ol, bm.BucketMetadataSys(ol), [str(base / f"{kind}{i}")
                                          for i in range(6)]


def _put(ol, bucket, key, data, meta=None, versioned=False):
    return ol.put_object(bucket, key, io.BytesIO(data), len(data),
                         dict(meta or {}), versioned=versioned)


def _namespace(ol, meta, seed: int = 7) -> None:
    """The same buckets, objects and documents in either package."""
    rng = np.random.default_rng(seed)
    for b in ("fifo", "life", "plain", "ver"):
        ol.make_bucket(b)
    for i in range(12):
        _put(ol, "plain", f"p{i % 3}/o{i}", _pay(rng, int(rng.integers(1, 9000))))
    meta.update("life", lifecycle_xml=LIFE_XML)
    for pre in ("old", "tmp", "keep"):
        for i in range(4):
            tags = {"x-amz-tagging": "t=1"} if pre == "keep" and i < 2 else {}
            _put(ol, "life", f"{pre}/o{i}",
                 _pay(rng, int(rng.integers(1, 6000))), tags)
    ol.new_multipart_upload("life", "up/big", {})
    ol.new_multipart_upload("life", "keep/big", {})
    meta.update("ver", versioning="Enabled", lifecycle_xml=VER_XML)
    for key, n in (("cur/a", 2), ("old/b", 3), ("live/c", 1)):
        for _ in range(n):
            _put(ol, "ver", key, _pay(rng, 700), versioned=True)
    first = _put(ol, "ver", "dm/d", _pay(rng, 50), versioned=True)
    ol.delete_object("ver", "dm/d", "", versioned=True)
    ol.delete_object("ver", "dm/d", first.version_id)
    meta.update("fifo", quota_json='{"quota": 3000, "quotatype": "fifo"}')
    for i in range(6):
        lock = ({"x-amz-object-lock-mode": "GOVERNANCE",
                 "x-amz-object-lock-retain-until-date": FAR}
                if i == 1 else {})
        _put(ol, "fifo", f"f{i}", _pay(rng, 1000), lock)
        time.sleep(0.002)  # strictly increasing mod times


def _versions(ol) -> dict:
    out = {}
    for b in ol.list_buckets():
        if b.name.startswith("."):
            continue
        page = ol.list_object_versions(b.name, "", "", "", "", 1000)
        out[b.name] = [(v.name, v.is_latest, v.delete_marker, v.size)
                       for v in page.versions]
        out[b.name + "/uploads"] = sorted(
            u.object for u in ol.list_multipart_uploads(b.name))
    return out


def _usage_doc(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "last_update_ns"}


@pytest.fixture(scope="module")
def crawled(tmp_path_factory):
    """Each package's crawler over the same namespace: three sweeps."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        base = tmp_path_factory.mktemp("crawl")
        for kind in ("jax", "port"):
            ol, meta, roots = _layer(kind, base)
            _namespace(ol, meta)
            # one lost shard: the object's files gone from drive 3
            shutil.rmtree(os.path.join(roots[3], "plain", "p1", "o4"))
            deletes, heals, swept = [], [], []
            real_delete = ol.delete_object

            def delete(bucket, name, version_id="", *a, _d=real_delete, **kw):
                deletes.append((bucket, name, bool(version_id)))
                return _d(bucket, name, version_id, *a, **kw)

            ol.delete_object = delete
            tracker = PKG[kind][4].DataUpdateTracker()
            cr = PKG[kind][3].DataCrawler(
                ol, meta, sleep_every=0, tracker=tracker,
                heal_hook=lambda b, o, v: heals.append((b, o)))
            real_crawl_bucket = cr._crawl_bucket

            def crawl_bucket(bucket, _c=real_crawl_bucket, _s=swept):
                _s[-1].append(bucket)
                return _c(bucket)

            cr._crawl_bucket = crawl_bucket
            t0 = time.time_ns() + 10 * DAY_NS
            clock = iter(range(t0, t0 + 10**9))
            mp.setattr(time, "time_ns", lambda: next(clock))
            sweeps = []
            for i in range(3):
                if i == 2:
                    tracker.mark("plain/p0/o0")
                swept.append([])
                sweeps.append(cr.crawl_once(force=True).to_dict())
            mp.undo()
            mp.setenv("MINIO_MESH", "0")
            buf = io.BytesIO()
            ol.get_object(".sys", "data-usage/usage.json", buf)
            out[kind] = {
                "sweeps": sweeps, "deletes": deletes, "heals": heals,
                "swept": swept, "left": _versions(ol),
                "stored": json.loads(buf.getvalue()), "crawler": cr,
            }
    return out


@pytest.mark.parametrize("sweep", [0, 1, 2])
def test_usage_snapshot_equal(crawled, sweep):
    got = _usage_doc(crawled["port"]["sweeps"][sweep])
    assert got == _usage_doc(crawled["jax"]["sweeps"][sweep])
    assert got["cycles"] == sweep + 1


def test_persisted_usage_equal(crawled):
    got = crawled["port"]["stored"]
    assert _usage_doc(got) == _usage_doc(crawled["jax"]["stored"])
    assert _usage_doc(got) == _usage_doc(crawled["port"]["sweeps"][-1])


def test_delete_order_equal(crawled):
    """Lifecycle expiries and the FIFO evictions, call for call."""
    assert crawled["port"]["deletes"] == crawled["jax"]["deletes"]


def test_expired_and_evicted(crawled):
    left = crawled["port"]["left"]
    assert left == crawled["jax"]["left"]
    names = {v[0] for v in left["life"]}
    assert names == {"keep/o2", "keep/o3"}  # old/ by date, tmp/ by days,
    # keep/o0-1 by their tag
    assert left["life/uploads"] == ["keep/big"]  # up/big aborted
    # versioned: the current version hidden by a marker, the noncurrent
    # ones of old/b expired, the lone marker dm/d removed
    cur = [v for v in left["ver"] if v[0] == "cur/a"]
    assert cur[0][1:3] == (True, True) and len(cur) == 3
    assert [v for v in left["ver"] if v[0] == "old/b"] == [
        ("old/b", True, False, 700)]
    assert not [v for v in left["ver"] if v[0] == "dm/d"]
    # FIFO: oldest first down to the quota, the locked f1 kept
    assert sorted(v[0] for v in left["fifo"]) == ["f1", "f4", "f5"]
    evicted = [d[1] for d in crawled["port"]["deletes"] if d[0] == "fifo"]
    assert evicted == ["f0", "f2", "f3"]


def test_heal_queued_for_the_damaged_object(crawled):
    assert crawled["port"]["heals"] == crawled["jax"]["heals"] == [
        ("plain", "p1/o4")]


def test_tracker_skips_clean_buckets(crawled):
    """Sweep 2 skips the clean bucket (lifecycle and FIFO buckets are
    always swept); sweep 3 crawls it again after a mark."""
    swept = crawled["port"]["swept"]
    assert swept == crawled["jax"]["swept"]
    assert swept == [["fifo", "life", "plain", "ver"],
                     ["fifo", "life", "ver"],
                     ["fifo", "life", "plain", "ver"]]
    stats = crawled["port"]["crawler"].stats_snapshot()
    assert stats["sweeps"] == 3 and stats["buckets_skipped"] == 1
    assert stats["buckets_crawled"] == 11
    assert stats["heals_queued"] == 1 and stats["uploads_aborted"] == 1
    assert stats["evicted"] == 3
    assert stats["expired"] == sum(
        1 for d in crawled["port"]["deletes"] if d[0] != "fifo")


# -- the update tracker ----------------------------------------------------

MARKS = ["b1/x", "b1/a/b/c/d", "b2/y", ".sys/hidden", "", "b3", "./b4/z",
         "b1/a/b"]


def _drive(mod, path, m=2**14):
    t = mod.DataUpdateTracker(path=path, m=m, save_every=3)
    walls = []
    for i, mark in enumerate(MARKS):
        t.mark(mark)
        if i % 3 == 2:
            walls.append(t.cycle_filter(max(0, t.current() - 2),
                                        t.current() + 1).to_wire())
    t.save()
    return t, walls


def test_tracker_file_byte_equal(tmp_path):
    jt, jw = _drive(jut, str(tmp_path / "j" / "t.bin"))
    tt, tw = _drive(tut, str(tmp_path / "t" / "t.bin"))
    assert tw == jw
    raw = (tmp_path / "t" / "t.bin").read_bytes()
    assert raw == (tmp_path / "j" / "t.bin").read_bytes()
    assert tt.current() == jt.current() == 2


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_tracker_file_loads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "t.bin")
    w, _ = _drive(PKG[writer][4], path)
    r = PKG[reader][4].DataUpdateTracker(path=path, m=2**14)
    assert r.current_idx == w.current_idx
    assert bytes(r.cur.bits) == bytes(w.cur.bits)
    assert {i: bytes(f.bits) for i, f in r.history.items()} == \
        {i: bytes(f.bits) for i, f in w.history.items()}
    assert r.untrusted == w.untrusted | {w.current_idx}
    # the reloaded in-flight cycle cannot vouch for skipping
    assert not r.cycle_filter(0, r.current()).complete


def test_tracker_default_shape_byte_equal(tmp_path):
    files = {}
    for kind in ("jax", "port"):
        t = PKG[kind][4].DataUpdateTracker(path=str(tmp_path / kind))
        for mark in MARKS:
            t.mark(mark)
        t.cycle_filter(0, 1)
        t.mark("b9/after")
        t.save()
        files[kind] = (tmp_path / kind).read_bytes()
    assert files["port"] == files["jax"]


def test_object_path_updated_hook():
    trackers = {k: PKG[k][4].DataUpdateTracker(m=2**14) for k in PKG}
    try:
        for k, t in trackers.items():
            PKG[k][4].install_tracker(t)
            PKG[k][4].object_path_updated("bkt/a/b")
        resp = {k: t.cycle_filter(0, 1) for k, t in trackers.items()}
        assert resp["port"].to_wire() == resp["jax"].to_wire()
        assert resp["port"].filter.contains_dir("bkt")
    finally:
        for k in PKG:
            PKG[k][4].install_tracker(None)


# -- the crawler's other seams ---------------------------------------------

def test_leader_lock_timeout_serves_published_usage(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    ol, meta, _ = _layer("port", tmp_path)
    ol.make_bucket("bkt")
    first = tcrawler.DataCrawler(ol, meta, sleep_every=0).crawl_once()

    class Busy:
        def __enter__(self):
            raise LockTimeout("held elsewhere")

        def __exit__(self, *exc):
            return False

    cr = tcrawler.DataCrawler(ol, meta, leader_lock=Busy)
    got = cr.crawl_once(force=True)
    assert got.to_dict() == first.to_dict()
    assert cr.stats_snapshot()["sweeps"] == 0


def test_crawl_seeds_read_cache_heat(tmp_path, monkeypatch):
    """Each live latest version the crawl walks earns one admission
    credit in the read cache (``seed_heat``), as in the JAX package."""
    from minio_tpu import cache as jcache
    from minio_tpu_torch import cache as tcache

    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "host")
    heat = {}
    try:
        for kind, cache in (("jax", jcache), ("port", tcache)):
            cache.reset_read_cache()
            ol, meta, _ = _layer(kind, tmp_path / kind)
            ol.make_bucket("bkt")
            for i in range(3):
                _put(ol, "bkt", f"k{i}", b"x" * 10)
            ol.delete_object("bkt", "k2")
            PKG[kind][3].DataCrawler(ol, meta, sleep_every=0).crawl_once()
            adm = cache.read_cache().admission
            heat[kind] = [adm.estimate(f"bkt/k{i}") for i in range(3)]
    finally:
        for cache in (jcache, tcache):
            cache.reset_read_cache()
    assert heat["port"] == heat["jax"]
    # the deleted k2 kept only its PUT's credit; the live ones gained one
    assert heat["port"][0] == heat["port"][1] == heat["port"][2] + 1


@pytest.mark.parametrize("env", [None, "5", "0.2", "nan", "x", "120"])
def test_crawl_interval_knob(monkeypatch, tmp_path, env):
    if env is None:
        monkeypatch.delenv("MINIO_TPU_CRAWL_INTERVAL_S", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_CRAWL_INTERVAL_S", env)
    got = tcrawler.DataCrawler.__new__(tcrawler.DataCrawler)
    want = jcrawler.DataCrawler.__new__(jcrawler.DataCrawler)
    got._interval = want._interval = 30.0
    assert got._effective_interval() == want._effective_interval()


def _serve(kind, base, crawler=True):
    ol, meta, _ = _layer(kind, base)
    cls = TS3Server if kind == "port" else JS3Server
    srv = cls(ol, address="127.0.0.1:0", internode_secret=SECRET)
    if crawler:
        srv.crawler = PKG[kind][3].DataCrawler(ol, srv.bucket_meta,
                                               sleep_every=0)
    return srv.start()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        base = tmp_path_factory.mktemp("crawl-servers")
        srvs = {k: _serve(k, base / k) for k in PKG}
        bare = {k: _serve(k, base / f"{k}-bare", crawler=False) for k in PKG}
        try:
            yield srvs, bare
        finally:
            for s in list(srvs.values()) + list(bare.values()):
                s.shutdown()


ADMIN = "/minio-tpu/admin/v1"


def _ensure_bucket(srv, bucket="bkt"):
    if not any(b.name == bucket for b in srv.object_layer.list_buckets()):
        srv.object_layer.make_bucket(bucket)


def test_admin_datausage_and_crawl(servers):
    srvs, _bare = servers
    answers = {}
    for kind, srv in srvs.items():
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        for i in range(3):
            assert c.put_object("bkt", f"k{i}", b"x" * (100 * i + 1)).status \
                == 200
        before = c.request("GET", f"{ADMIN}/datausage")
        crawl = c.request("POST", f"{ADMIN}/crawl")
        after = c.request("GET", f"{ADMIN}/datausage")
        answers[kind] = [(r.status, _usage_doc(json.loads(r.body)))
                         for r in (before, crawl, after)]
    assert answers["port"] == answers["jax"]
    assert answers["port"][2][1]["buckets"]["bkt"]["objects"] == 3
    assert answers["port"][2][1]["size_total"] == 1 + 101 + 201


def test_admin_without_a_crawler(servers):
    _srvs, bare = servers
    got = {}
    for kind, srv in bare.items():
        c = S3Client(srv.endpoint)
        usage = c.request("GET", f"{ADMIN}/datausage")
        crawl = c.request("POST", f"{ADMIN}/crawl")
        got[kind] = (usage.status, usage.body, crawl.status, crawl.error_code)
    assert got["port"] == got["jax"]
    assert got["port"][2] == 503


def test_admission_quota_shed(servers):
    """The early shed reads the crawler's snapshot: a PUT that cannot
    fit the hard quota is shed before its body, on both packages."""
    srvs, bare = servers
    for srv in list(srvs.values()) + list(bare.values()):
        _ensure_bucket(srv)
    for kind, srv in srvs.items():
        srv.bucket_meta.update("bkt", quota_json='{"quota": 400}')
        srv.crawler.crawl_once(force=True)
    cases = [("PUT", "/bkt/x", "50"), ("PUT", "/bkt/x", "500"),
             ("PUT", "/bkt/x", "0"), ("GET", "/bkt/x", "500"),
             ("PUT", "/other/x", "500"), ("PUT", "/bkt/x", "nan"),
             ("PUT", "/", "5")]
    for srvset in (srvs, bare):
        got = {k: [s.admission.quota_rejects_put(m, p, {"Content-Length": n})
                   for m, p, n in cases] for k, s in srvset.items()}
        assert got["port"] == got["jax"]
    assert [srvs["port"].admission.quota_rejects_put(m, p, {
        "Content-Length": n}) for m, p, n in cases][:2] == [False, True]
    for srv in srvs.values():
        srv.bucket_meta.update("bkt", quota_json="")


def test_admission_quota_shed_reads_no_store(servers):
    """The async plane asks the admission on its event loop, so the
    port's shed consults only a cached bucket document: an uncached one
    is not shed and not read (the handler's own check answers)."""
    srvs, _bare = servers
    srv = srvs["port"]
    _ensure_bucket(srv)
    srv.bucket_meta.update("bkt", quota_json='{"quota": 1}')
    srv.crawler.crawl_once(force=True)
    head = {"Content-Length": "500"}
    try:
        assert srv.admission.quota_rejects_put("PUT", "/bkt/x", head)
        srv.bucket_meta.invalidate("bkt")
        loads = []
        real = srv.bucket_meta._load
        srv.bucket_meta._load = lambda b: loads.append(b) or real(b)
        try:
            assert not srv.admission.quota_rejects_put("PUT", "/bkt/x", head)
        finally:
            srv.bucket_meta._load = real
        assert loads == []
    finally:
        srv.bucket_meta.update("bkt", quota_json="")


@pytest.mark.parametrize("ckind,skind", [("port", "port"), ("port", "jax"),
                                         ("jax", "port")])
def test_peer_cyclebloom(tmp_path, ckind, skind):
    servers, wires = [], []
    try:
        for kind in ("port", "jax") if skind == "port" else ("jax", "port"):
            cls = TS3Server if kind == "port" else JS3Server
            srv = cls(None, address="127.0.0.1:0", internode_secret=SECRET)
            plane = (tpeer if kind == "port" else jpeer).PeerRESTServer(
                srv, SECRET, fingerprint={})
            srv.register_internode((tpeer if kind == "port" else jpeer).PREFIX,
                                   plane.handle)
            srv.update_tracker = PKG[kind][4].DataUpdateTracker(m=2**14)
            for mark in MARKS:
                srv.update_tracker.mark(mark)
            servers.append(srv.start())
        target = servers[0]
        mod = tpeer if ckind == "port" else jpeer
        client = mod.PeerRESTClient("127.0.0.1", target.port, SECRET)
        for oldest, current in ((0, 1), (0, 2), (1, 1)):
            wires.append(client.cycle_bloom(oldest, current))
        client.close()
        want = PKG["jax"][4].DataUpdateTracker(m=2**14)
        for mark in MARKS:
            want.mark(mark)
        expect = [want.cycle_filter(o, c).to_wire()
                  for o, c in ((0, 1), (0, 2), (1, 1))]
        assert [{k: v for k, v in w.items() if k != "ok"} for w in wires] \
            == expect
        # a node without a tracker answers None to the union
        target.update_tracker = None
        client = mod.PeerRESTClient("127.0.0.1", target.port, SECRET)
        assert client.cycle_bloom(0, 3) is None
        client.close()
    finally:
        for s in servers:
            s.shutdown()
