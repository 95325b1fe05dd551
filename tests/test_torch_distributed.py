"""A distributed erasure set of the port against the JAX package's.

* A mixed set on the CPU: four local drives and four remote ones, the
  remote ones served by an in-process ``S3Server`` over the storage REST
  plane, at the default parity (EC 4+4).  The same objects PUT through
  each package's object layer give equal part files and ``xl.meta`` (up
  to mod time, data dir and version id) drive by drive; GETs agree
  healthy and with the remote node gone; after part files are deleted
  on a local and a remote drive, heal puts back the same bytes.
* Read-after-write across nodes: a node's GET after another node's
  acknowledged overwrite whose cache invalidation was lost.  The JAX
  package's FileInfo side-car still names the old ``data_dir`` and its
  cached groups answer with the old body; the port (a broadcast
  registered, so no side-car) reads ``xl.meta`` by quorum and returns
  the new body.
* Three ``ClusterHarness`` runs of real ``python -m
  minio_tpu_torch.server`` processes, 2 nodes x 2 drives with
  ``MINIO_ERASURE_BACKEND=cpu`` (the native codec, 2 threads a batch):
  the boot (format agreement, a
  cross-node PUT and GET, peer-aggregated admin info, remote fault
  control, SIGTERM), a
  cross-node PUT race on one key through the dsync lock plane, and a
  SIGKILL, restart and admin heal.  They stay in this one file so
  ``--dist loadfile`` keeps their subprocesses on one worker.
"""

import hashlib
import io
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from minio_tpu import cache as jcache
from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JObjects
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage import rest_client as jrest_client
from minio_tpu.storage import rest_server as jrest_server
from minio_tpu.storage.xl import XLStorage as JXL
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.cluster.harness import ClusterHarness
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects as TObjects
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage import rest_client as trest_client
from minio_tpu_torch.storage import rest_server as trest_server
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage as TXL
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "cluster-secret"
BLOCK = 32 * 1024
SIZES = {"small": 1000, "blocks2_5": BLOCK * 5 // 2, "blocks6": BLOCK * 6}
PKG = {
    "port": (TXL, trest_server, trest_client, TS3Server, TObjects),
    "jax": (JXL, jrest_server, jrest_client, JS3Server, JObjects),
}


def _payload(name: str) -> bytes:
    return np.random.default_rng(len(name) * 7 + SIZES[name]).bytes(
        SIZES[name])


class _Node:
    """One package's mixed set: drives 0-3 local, 4-7 behind a storage
    REST server of the same package."""

    def __init__(self, kind: str, base, monkeypatch):
        xl, rest_server, rest_client, server_cls, objects = PKG[kind]
        self.roots = [str(base / f"d{i}") for i in range(8)]
        monkeypatch.setenv("MINIO_TPU_SERVER", "async")
        served = [xl(r) for r in self.roots[4:]]
        self.srv = server_cls(None, address="127.0.0.1:0", secret_key=SECRET,
                              internode_secret=SECRET)
        self.srv.register_internode(
            "/minio-tpu/storage/v1",
            rest_server.StorageRESTServer(served, SECRET).handle)
        self.srv.start()
        self.remote = [rest_client.StorageRESTClient(
            "127.0.0.1", self.srv.port, r, SECRET, timeout=5.0)
            for r in self.roots[4:]]
        disks = [xl(r) for r in self.roots[:4]] + self.remote
        kw = {"device": "cpu"} if kind == "port" else {}
        self.ol = objects(disks, block_size=BLOCK, **kw)

    def close(self):
        self.srv.shutdown()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        nodes = {k: _Node(k, tmp_path_factory.mktemp(k), mp)
                 for k in ("port", "jax")}
        for node in nodes.values():
            node.ol.make_bucket("bkt")
            for name in SIZES:
                data = _payload(name)
                node.ol.put_object("bkt", name, io.BytesIO(data), len(data))
        yield nodes
        for node in nodes.values():
            node.close()
        jbackend.reset_backend()
        tbackend.reset_backend()


def _part(root: str, name: str) -> bytes:
    fi = TXL(root).read_version("bkt", name)
    try:
        with open(f"{root}/bkt/{name}/{fi.data_dir}/part.1", "rb") as f:
            return f.read()
    except FileNotFoundError:
        return b""


def _meta_doc(root: str, name: str) -> list:
    raw = open(f"{root}/bkt/{name}/xl.meta", "rb").read()
    out = []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _get(ol, name) -> bytes:
    buf = io.BytesIO()
    ol.get_object("bkt", name, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", list(SIZES))
def test_mixed_set_disks_equal(mixed, name):
    tr, jr = mixed["port"].roots, mixed["jax"].roots
    for t, j in zip(tr, jr):
        assert _part(t, name) == _part(j, name) != b""
        assert _meta_doc(t, name) == _meta_doc(j, name)
    assert _meta_doc(tr[0], name)[0]["erasure"]["parity_blocks"] == 4


@pytest.mark.parametrize("name", list(SIZES))
def test_mixed_set_get_healthy(mixed, name):
    assert _get(mixed["port"].ol, name) == _payload(name) == \
        _get(mixed["jax"].ol, name)


@pytest.mark.parametrize("name", list(SIZES))
def test_mixed_set_heal_local_and_remote(mixed, name):
    """Part files deleted on one local and one remote drive come back
    equal to the JAX package's healed ones, and to what was there."""
    before = {k: [_part(r, name) for r in n.roots] for k, n in mixed.items()}
    for kind, node in mixed.items():
        for i in (1, 5):
            fi = TXL(node.roots[i]).read_version("bkt", name)
            os.remove(f"{node.roots[i]}/bkt/{name}/{fi.data_dir}/part.1")
        res = node.ol.heal_object("bkt", name)
        assert res, kind
    after = {k: [_part(r, name) for r in n.roots] for k, n in mixed.items()}
    assert after["port"] == after["jax"] == before["port"] == before["jax"]


def test_mixed_set_degraded_with_the_remote_node_gone(mixed, tmp_path):
    """The four remote drives go away with their server: GETs still
    answer from the four local ones (EC 4+4 read quorum), in both
    packages; the drives come back with a new server on the same port."""
    for kind in ("port", "jax"):
        node = mixed[kind]
        port = node.srv.port
        node.srv.shutdown()
        try:
            for name in SIZES:
                assert _get(node.ol, name) == _payload(name), (kind, name)
            assert not any(c.is_online() for c in node.remote)
        finally:
            xl, rest_server, _c, server_cls, _o = PKG[kind]
            node.srv = server_cls(None, address=f"127.0.0.1:{port}",
                                  secret_key=SECRET, internode_secret=SECRET)
            node.srv.register_internode(
                "/minio-tpu/storage/v1", rest_server.StorageRESTServer(
                    [xl(r) for r in node.roots[4:]], SECRET).handle)
            node.srv.start()


# -- read-after-write across nodes ------------------------------------------


@pytest.fixture()
def host_caches(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "host")
    for mod in (jcache, tcache):
        mod.reset_read_cache()
        mod.set_broadcast(None)
    yield
    for mod in (jcache, tcache):
        mod.set_broadcast(None)
        mod.reset_read_cache()


def test_read_after_write_with_a_lost_invalidation(tmp_path, monkeypatch,
                                                   host_caches):
    """Node A (this process's cache) reads an object hot; node B
    overwrites it and acknowledges, but the invalidation meant for A is
    lost.  A's next GET: the JAX package serves the old body from its
    FileInfo side-car and cached groups; the port returns the new one."""
    old = np.random.default_rng(1).bytes(150_000)
    new = np.random.default_rng(2).bytes(150_000)
    got = {}
    for kind, mod in (("jax", jcache), ("port", tcache)):
        xl, objects = PKG[kind][0], PKG[kind][4]
        roots = [str(tmp_path / kind / f"d{i}") for i in range(4)]
        kw = {"device": "cpu"} if kind == "port" else {}
        node_a = objects([xl(r) for r in roots], block_size=BLOCK, **kw)
        node_b = objects([xl(r) for r in roots], block_size=BLOCK, **kw)
        # a peer plane exists: mutations broadcast, and this one is lost
        mod.set_broadcast(lambda bucket, obj: None)
        node_a.make_bucket("bkt")
        node_a.put_object("bkt", "hot", io.BytesIO(old), len(old))
        for _ in range(3):
            assert _get(node_a, "hot") == old
        # node B's PUT drops only node B's own cache (another process's):
        # nothing reaches node A's
        with monkeypatch.context() as mp:
            mp.setattr(mod, "invalidate_object", lambda b, o: 0)
            node_b.put_object("bkt", "hot", io.BytesIO(new), len(new))
        try:
            got[kind] = _get(node_a, "hot")
        except Exception as e:  # noqa: BLE001 - shards of the old dir gone
            got[kind] = type(e).__name__
        mod.set_broadcast(None)
    assert got["jax"] == old  # stale: read-after-write broken
    assert got["port"] == new


# -- the cluster harness: real server processes ------------------------------


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_ERASURE_BACKEND", "cpu")
    # the native codec's stripe workers: 2 a batch, not a core each
    monkeypatch.setenv("MINIO_TPU_NATIVE_THREADS", "2")
    for name in ("MINIO_TPU_SERVER", "MINIO_TPU_READ_CACHE",
                 "MINIO_TPU_FEDERATION_DIR", "MINIO_TPU_CACHE_DRIVES"):
        monkeypatch.delenv(name, raising=False)
    h = ClusterHarness(tmp_path / "cl", nodes=2, drives_per_node=2,
                       env={"MINIO_TPU_SERVER_LOOPS": "2",
                            "MINIO_TPU_LOG_LEVEL": "warning",
                            "PYTHONUNBUFFERED": "1",
                            # no background crawl heals a node's missed
                            # writes before a test looks at them
                            "MINIO_TPU_CRAWL_INTERVAL_S": "3600"},
                       format_timeout_s=60)
    h.start(timeout_s=120)
    yield h
    h.stop()


def _put(h, i, key, data):
    c = h.client(i)
    try:
        return c.request("PUT", f"/bkt/{key}", body=data)[0]
    finally:
        c.close()


def _fetch(h, i, key):
    c = h.client(i)
    try:
        st, _hd, body = c.request("GET", f"/bkt/{key}")
        return st, body
    finally:
        c.close()


def _no_locks(h, i) -> None:
    """top-locks on node i drains to empty: a GET's read lock is released
    just after its last byte was sent, so poll briefly."""
    deadline = time.monotonic() + 10
    while True:
        st, doc = h.admin(i, "GET", "top-locks")
        assert st == 200
        if doc == {"locks": []} or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert doc == {"locks": []}


def _online(doc) -> "tuple[int, int]":
    """(online, disks) summed over a storageinfo document's zones."""
    sets = [s for z in doc["zones"] for s in z.get("sets", [z])]
    return sum(s["online"] for s in sets), sum(s["disks"] for s in sets)


def _await_all_online(h, i, disks, timeout_s=60.0) -> None:
    """Node i's storageinfo counts ``disks`` drives online and its
    breakers report every drive healthy (``h.disk_states``)."""
    deadline = time.monotonic() + timeout_s
    while True:
        st, doc = h.admin(i, "GET", "storageinfo")
        states = h.disk_states(i)
        if (st == 200 and _online(doc) == (disks, disks)
                and len(states) == disks
                and not any(states.values())):
            return
        assert time.monotonic() < deadline, (doc, states)
        time.sleep(0.1)


def _await_mrf_idle(h, i, tasks, timeout_s=60.0) -> None:
    """Node i's heal routine has taken ``tasks`` MRF heals and holds none
    queued (``background-heal/status``)."""
    deadline = time.monotonic() + timeout_s
    while True:
        st, doc = h.admin(i, "GET", "background-heal/status")
        me = doc["nodes"][0]
        if me["queued"] == 0 and me["healed"] + me["failed"] >= tasks:
            return
        assert time.monotonic() < deadline, doc
        time.sleep(0.1)


def _drive_parts(h, key) -> list:
    out = []
    for n in h.nodes:
        for d in n.drive_dirs:
            fi = TXL(str(d)).read_version("bkt", key)
            with open(f"{d}/bkt/{key}/{fi.data_dir}/part.1", "rb") as f:
                out.append(f.read())
    return out


def test_cluster_boot_and_cross_node_io(cluster):
    h = cluster
    fmts = [json.load(open(f"{d}/.sys/format.json"))
            for n in h.nodes for d in n.drive_dirs]
    assert len({f["id"] for f in fmts}) == 1
    assert sorted(f["erasure"]["this"] for f in fmts) == \
        sorted(fmts[0]["erasure"]["sets"][0])
    assert all(f["erasure"]["sets"] == fmts[0]["erasure"]["sets"]
               for f in fmts)
    c = h.client(0)
    assert c.request("PUT", "/bkt")[0] == 200
    c.close()
    objs = {f"o{i}": os.urandom(100_000 * i + 17) for i in range(3)}
    for i, (k, v) in enumerate(objs.items()):
        assert _put(h, i % 2, k, v) == 200
    for i, (k, v) in enumerate(objs.items()):
        assert _fetch(h, (i + 1) % 2, k) == (200, v)
    st, doc = h.admin(1, "GET", "info")
    assert st == 200 and doc["mode"] == "distributed"
    assert [n["state"] for n in doc["nodes"]] == ["online"]
    st, doc = h.admin(0, "GET", "healthinfo")
    assert st == 200 and len(doc["nodes"]) == 2
    # remote fault control over node 2's two FaultDisk drives
    assert len(h.inject_fault(1, "stat_vol", delay_s=0.01)["injected"]) == 2
    assert [v["rules"] for v in h.fault_status(1).values()] == [1, 1]
    assert len(h.clear_faults(1)["cleared"]) == 2
    assert [v["rules"] for v in h.fault_status(1).values()] == [0, 0]
    _no_locks(h, 0)
    for i in range(2):
        assert h.terminate(i) == 0
        assert "shutdown complete" in h.nodes[i].log_tail()


def test_cluster_put_race_through_the_lock_plane(cluster):
    h = cluster
    c = h.client(0)
    assert c.request("PUT", "/bkt")[0] == 200
    c.close()
    bodies = [os.urandom(200_000), os.urandom(150_000)]
    for _round in range(4):
        status = [None, None]

        def put(i):
            status[i] = _put(h, i, "race", bodies[i])

        ts = [threading.Thread(target=put, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert status == [200, 200]
        got = [_fetch(h, i, "race")[1] for i in (0, 1)]
        assert got[0] == got[1] and got[0] in bodies
        metas = [XLMeta.from_bytes(open(f"{d}/bkt/race/xl.meta", "rb")
                                   .read()) for n in h.nodes
                 for d in n.drive_dirs]
        assert all(len(m.versions) == 1 for m in metas)
        assert len({m.versions[0].data_dir for m in metas}) == 1
    for i in (0, 1):
        _no_locks(h, i)


def test_cluster_kill_restart_and_heal(cluster):
    h = cluster
    c = h.client(0)
    assert c.request("PUT", "/bkt")[0] == 200
    c.close()
    objs = {f"k{i}": os.urandom(80_000 * (i + 1)) for i in range(3)}
    for k, v in objs.items():
        assert _put(h, 0, k, v) == 200
    parts = {k: _drive_parts(h, k) for k in objs}
    # node 2's first drive: its shard position (erasure index - 1)
    wiped = h.nodes[1].drive_dirs[0]
    shard = {k: TXL(str(wiped)).read_version("bkt", k).erasure.index - 1
             for k in objs}
    h.kill(1)
    for k, v in objs.items():  # two of four drives: read quorum holds
        assert _fetch(h, 0, k) == (200, v)
    # those degraded GETs queued MRF heals on node 1; they run while node
    # 2 is down, so none of them heals after the restart below
    _await_mrf_idle(h, 0, len(objs))
    # node 2's first drive is wiped while it is down
    shutil.rmtree(wiped / "bkt")
    h.restart(1, timeout_s=120)
    # node 1 probes a drive that went down again only every few seconds:
    # heal once it sees all four drives online, breakers closed
    _await_all_online(h, 0, 4)
    for k in objs:
        st, doc = h.admin(0, "POST", "heal",
                          query={"bucket": "bkt", "object": k})
        assert st == 200, doc
        assert doc["healed"] == [shard[k]], doc
    for k, v in objs.items():
        assert _drive_parts(h, k) == parts[k]
        for i in (0, 1):
            st, body = _fetch(h, i, k)
            assert (st, hashlib.sha256(body).hexdigest()) == \
                (200, hashlib.sha256(v).hexdigest())
