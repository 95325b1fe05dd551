"""The port's peer plane (minio_tpu_torch/cluster/peer.py) against the
JAX package's.

* Two in-process nodes, one of each package, each an ``S3Server`` over
  its own erasure set with its ``PeerRESTServer`` on the internode
  route: every ported method of ``_METHODS`` answers the port's client
  as the JAX node answers (volatile fields - pids, times, endpoints,
  measured rates - compared by their keys; ``cyclebloom`` is held
  against the JAX node in ``tests/test_torch_crawler.py``).
* The cluster-wide listen (``listenon``/``listenbuf``/``listenoff``):
  each package's client against each package's node, the same events
  published into the node's notifier; the records drained, the filter
  applied, the unsubscribe and the expired listener's error agree, and
  the request and response bodies on the wire are byte-equal.  An
  orphaned subscription is reaped by the TTL sweeper on both.
* The port's ``PeerNotifier`` fans bucket-metadata, IAM and config
  changes out to both packages' nodes, and gathers their server infos
  and lock tables concurrently.
* The bootstrap handshake: the fingerprint equals the JAX package's for
  the same arguments, a disagreeing peer and a wrong secret are fatal,
  an unreachable peer is waited for.
* ``invalidatereadcache`` drops this node's cached groups and never
  re-broadcasts them; with a broadcast registered the object layer
  skips the FileInfo side-car.
* The admin routes this slice serves: ``top-locks`` from the local
  locker and its peers, and ``fault/inject``, ``fault/clear``,
  ``fault/status`` over FaultDisk drives.
"""

import json
import time

import pytest

from minio_tpu.cluster import peer as jpeer
from minio_tpu.codec import telemetry as jtelemetry
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JObjects
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage.xl import XLStorage as JXL
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.cluster import peer as tpeer
from minio_tpu_torch.codec import telemetry as ttelemetry
from minio_tpu_torch.dsync.drwmutex import LockArgs
from minio_tpu_torch.dsync.local_locker import LocalLocker
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects as TObjects
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage.faults import FaultDisk
from minio_tpu_torch.storage.xl import XLStorage as TXL
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "peer-secret"
BLOCK = 64 << 10
ARGS = ["http://127.0.0.1:{9001...9004}/d{1...4}"]


def _node(root, kind, fingerprint=None, locker=None, faults=False):
    disks = [(TXL if kind == "port" else JXL)(str(root / f"d{i}"))
             for i in range(4)]
    if faults:
        disks = [FaultDisk(d, seed=i) for i, d in enumerate(disks)]
    if kind == "port":
        ol = TObjects(disks, block_size=BLOCK, device="cpu")
        srv = TS3Server(ol, address="127.0.0.1:0", internode_secret=SECRET,
                        secret_key=SECRET)
        plane = tpeer.PeerRESTServer(srv, SECRET, fingerprint=fingerprint,
                                     local_locker=locker)
        srv.register_internode(tpeer.PREFIX, plane.handle)
        srv.local_locker = locker
        if faults:
            srv.fault_disks = {str(d.unwrapped.root): d for d in disks}
    else:
        ol = JObjects(disks, block_size=BLOCK)
        srv = JS3Server(ol, address="127.0.0.1:0", internode_secret=SECRET,
                        secret_key=SECRET)
        plane = jpeer.PeerRESTServer(srv, SECRET, fingerprint=fingerprint,
                                     local_locker=locker)
        srv.register_internode(jpeer.PREFIX, plane.handle)
    srv.peer_rest = plane
    srv.start()
    return srv


def _client(srv, mod=tpeer, secret=SECRET):
    host, port = srv.endpoint.split("//", 1)[-1].rsplit(":", 1)
    return mod.PeerRESTClient(host, int(port), secret)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    fp = tpeer.cluster_fingerprint(ARGS, "ak", "sk")
    out = {}
    for kind in ("port", "jax"):
        root = tmp_path_factory.mktemp(kind)
        out[kind] = _node(root, kind, fingerprint=dict(fp))
        out[kind].object_layer.make_bucket("bkt")
    yield out
    for srv in out.values():
        srv.shutdown()


def _ask(client, method, query=None, doc=None):
    try:
        return "ok", client.call(method, query, doc, retry=False)
    except ConnectionError as e:
        return "err", str(e).split("HTTP ", 1)[-1][:3]


def _shape(v):
    """Keys all the way down; leaves by type (bool kept apart from int)."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(x) for x in v[:1]]
    return type(v).__name__


EXACT, SHAPE = "exact", "shape"
FP = tpeer.cluster_fingerprint(ARGS, "ak", "sk")
# (method, query, doc, how to compare); one case each, in _METHODS order
METHODS = [
    ("health", None, None, EXACT),
    ("serverinfo", None, None, SHAPE),
    ("loadbucketmetadata", {"bucket": "bkt"}, None, EXACT),
    ("deletebucketmetadata", {"bucket": "bkt"}, None, EXACT),
    ("loadiam", None, None, EXACT),
    ("loadconfig", None, None, EXACT),
    ("getlocks", None, None, EXACT),
    ("tracebuf", {"since": str(1 << 62)}, None, SHAPE),
    ("trace", {"since": str(1 << 62)}, None, SHAPE),
    ("consolebuf", {"since": str(1 << 62)}, None, SHAPE),
    ("healthinfo", None, None, SHAPE),
    ("bghealstatus", None, None, SHAPE),
    ("backgroundhealstatus", None, None, SHAPE),
    ("signalservice", {"action": "bogus"}, None, EXACT),
    # a node without an update tracker: {"ok": False} from both
    ("cyclebloom", None, {"oldest": 0, "current": 1}, EXACT),
    ("verifyconfig", None, dict(FP), EXACT),
    ("verifyconfig_mismatch", None,
     tpeer.cluster_fingerprint(ARGS, "ak", "other"), EXACT),
    ("loaduser", {"name": "nobody"}, None, EXACT),
    ("loadserviceaccount", {"name": "nobody"}, None, EXACT),
    ("deleteuser", {"name": "nobody"}, None, EXACT),
    ("deleteserviceaccount", {"name": "nobody"}, None, EXACT),
    ("loadpolicy", {"name": "readonly"}, None, EXACT),
    ("deletepolicy", {"name": "nothing"}, None, EXACT),
    ("loadgroup", {"name": "g"}, None, EXACT),
    ("loadpolicymapping", {"name": "g", "isGroup": "1"}, None, EXACT),
    ("getlocaldiskids", None, None, SHAPE),
    ("reloadformat", None, None, EXACT),
    ("serverupdate", None, None, EXACT),
    ("log", None, {"time": 1.5, "level": "info", "msg": "from a peer"},
     EXACT),
    ("driveobdinfo", None, None, SHAPE),
    ("memobdinfo", None, None, SHAPE),
    ("cpuobdinfo", None, None, SHAPE),
    ("osinfoobdinfo", None, None, SHAPE),
    ("procobdinfo", None, None, SHAPE),
    ("diskhwobdinfo", None, None, SHAPE),
    ("netobdinfo", None, None, SHAPE),
    ("dispatchnetobdinfo", None, None, SHAPE),
    ("invalidatereadcache", {"bucket": "bkt", "object": "o"}, None, EXACT),
    ("invalidatereadcache_bad", {"bucket": "bkt"}, None, EXACT),
    ("nosuchmethod", None, None, EXACT),
]


@pytest.mark.parametrize("method,query,doc,how", METHODS,
                         ids=[m[0] for m in METHODS])
def test_method_answers_as_jax(nodes, method, query, doc, how, monkeypatch):
    wire = method.split("_")[0]
    if wire == "healthinfo":
        # the transfer counters are process-wide: give both packages the
        # same rows, so the shapes compared do not hang on which tests
        # ran earlier in this process
        for stats in (jtelemetry.KERNEL_STATS, ttelemetry.KERNEL_STATS):
            monkeypatch.setattr(stats, "_h2d", {"data": [1, 4096]})
            monkeypatch.setattr(stats, "_d2h", {"parity": [1, 2048]})
    got = {k: _ask(_client(srv), wire, query, doc)
           for k, srv in nodes.items()}
    assert got["port"][0] == got["jax"][0], got
    if how == EXACT:
        assert got["port"] == got["jax"]
    else:
        port = _shape(got["port"][1])
        # the port's Select stats add the screen's counts (``screened``)
        if isinstance(port, dict) and "select" in port:
            assert "rows" in port["select"].pop("screened")
        assert port == _shape(got["jax"][1])
    if wire != "nosuchmethod":
        assert got["port"][0] == "ok"


def test_profiling_rpcs_answer_as_jax(nodes):
    got = {}
    for kind, srv in nodes.items():
        c = _client(srv)
        got[kind] = [_ask(c, "startprofiling", {"type": "cpu"}),
                     _ask(c, "downloadprofiling", {"type": "cpu"}),
                     _ask(c, "startprofiling", {"type": "cpu"}),
                     _ask(c, "downloadprofilingdata", {"type": "cpu"})]
    assert [(s, _shape(v)) for s, v in got["port"]] == \
        [(s, _shape(v)) for s, v in got["jax"]]
    assert got["port"][1][0] == "ok" and got["port"][1][1]["profile"]


LISTEN_COMBOS = [(c, n) for c in ("port", "jax") for n in ("port", "jax")]
# (name, key): one matches the listener's filter, two do not
LISTEN_EVENTS = [
    ("s3:ObjectCreated:Put", "logs/a.txt"),
    ("s3:ObjectCreated:Put", "data/b.txt"),
    ("s3:ObjectRemoved:Delete", "logs/c.txt"),
    ("s3:ObjectCreated:Copy", "logs/d.log"),
]


def _publish(kind, srv, seq0: int) -> None:
    """The same events, field for field, into the node's notifier."""
    if kind == "jax":
        from minio_tpu.event.event import Event, Identity
    else:
        from minio_tpu_torch.event.event import Event, Identity
    for i, (name, key) in enumerate(LISTEN_EVENTS):
        srv.events.send(Event(
            name=name, bucket="bkt", object_key=key, etag="0123abcd",
            size=17 + i, version_id="", sequencer=f"{seq0 + i:016X}",
            identity=Identity("minioadmin", "127.0.0.1"),
            time_ns=1_700_000_000_123_000_000 + i, endpoint="http://node"))
    assert srv.events.flush()
    time.sleep(0.1)


@pytest.fixture(scope="module")
def listen_runs(nodes):
    """Each (client package, node package) pair: the records drained,
    the state after listenoff, and the internode bodies both ways."""
    out = {}
    for client_kind, node_kind in LISTEN_COMBOS:
        srv = nodes[node_kind]
        prefix = (tpeer if node_kind == "port" else jpeer).PREFIX
        inner = srv.internode[prefix]
        wire = []

        def recording(method, query, body, headers=None, inner=inner,
                      wire=wire):
            status, payload, extra = inner(method, query, body, headers)
            if method.startswith("listen"):
                wire.append((method, dict(query), body, status, payload))
            return status, payload, extra

        srv.internode[prefix] = recording
        try:
            client = _client(srv, tpeer if client_kind == "port" else jpeer)
            lid = "watcher-1"  # one id for every pair: equal bodies
            client.listen_on(lid, "bkt", "logs/", "",
                             {"s3:ObjectCreated:Put", "s3:ObjectCreated:Copy"})
            client.listen_on(lid, "bkt", "logs/", "", set())  # idempotent
            assert srv.events.has_listeners("bkt")
            _publish(node_kind, srv, 1)
            records = client.listen_buf(lid)
            again = client.listen_buf(lid)  # drained
            client.listen_off(lid)
            try:
                client.listen_buf(lid)
                expired = None
            except ConnectionError as e:
                expired = str(e)
            out[(client_kind, node_kind)] = {
                "records": records, "again": again, "expired": expired,
                "listeners": dict(srv.peer_rest._listeners),
                "subscribed": srv.events.has_listeners("bkt"),
                "wire": [(m, q, b, st, p) for m, q, b, st, p in wire],
            }
        finally:
            srv.internode[prefix] = inner
    return out


@pytest.mark.parametrize("client_kind,node_kind", LISTEN_COMBOS,
                         ids=[f"{c}-client-{n}-node" for c, n in LISTEN_COMBOS])
def test_listen_methods(listen_runs, client_kind, node_kind):
    """listenon/listenbuf/listenoff (once 501 naming slice 9c) answer
    each client as the JAX node answers the JAX client, byte for byte
    on the wire."""
    got = listen_runs[(client_kind, node_kind)]
    ref = listen_runs[("jax", "jax")]
    assert got == ref
    assert [(r["EventName"], r["Key"]) for r in got["records"]] == [
        ("s3:ObjectCreated:Put", "bkt/logs/a.txt"),
        ("s3:ObjectCreated:Copy", "bkt/logs/d.log")]
    assert got["again"] == [] and got["listeners"] == {}
    assert not got["subscribed"]
    assert "listener expired on peer" in got["expired"]
    assert [w[0] for w in got["wire"]] == [
        "listenon", "listenon", "listenbuf", "listenbuf", "listenoff",
        "listenbuf"]


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_listen_ttl_sweep(tmp_path, kind):
    """A watcher that stops polling is reaped by the background sweeper
    after the TTL, with no further listen traffic; shutdown drops what
    is left."""
    srv = _node(tmp_path, kind)
    try:
        srv.object_layer.make_bucket("bkt")
        plane = srv.peer_rest
        plane._LISTEN_TTL_S = 0.3
        client = _client(srv)
        client.listen_on("orphan", "bkt")
        assert "orphan" in plane._listeners
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and plane._listeners:
            time.sleep(0.05)
        assert plane._listeners == {}
        assert not srv.events.has_listeners("bkt")
        with pytest.raises(ConnectionError, match="expired"):
            client.listen_buf("orphan")
        plane._LISTEN_TTL_S = 60.0
        client.listen_on("kept", "bkt")
    finally:
        srv.shutdown()
    assert plane._listeners == {}
    assert not srv.events.has_listeners("bkt")


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_wrong_secret_refused(nodes, kind):
    bad = _client(nodes[kind], tpeer, "wrong-secret")
    with pytest.raises(tpeer.PeerAuthError):
        bad.health()
    assert not bad.is_online()
    jbad = _client(nodes[kind], jpeer, "wrong-secret")
    with pytest.raises(jpeer.PeerAuthError):
        jbad.health()


def test_notifier_fanout_and_gather(nodes, tmp_path):
    notifier = tpeer.PeerNotifier([_client(s) for s in nodes.values()])
    try:
        for srv in nodes.values():
            srv.bucket_meta._ttl = 3600.0
            assert srv.bucket_meta.get("bkt").versioning == ""
        # another writer changes the document under both caches
        for srv in nodes.values():
            bm = type(srv.bucket_meta)(srv.object_layer)
            bm.update("bkt", versioning="Enabled")
        notifier.bucket_meta_changed("bkt")
        deadline = time.time() + 5
        while time.time() < deadline and not all(
                s.bucket_meta.get("bkt").versioning == "Enabled"
                for s in nodes.values()):
            time.sleep(0.05)
        assert all(s.bucket_meta.get("bkt").versioning == "Enabled"
                   for s in nodes.values())
        infos = notifier.server_infos()
        assert [i["state"] for i in infos] == ["online", "online"]
        assert notifier.all_locks() == [[], []]
        notifier.iam_changed()
        notifier.iam_entity("users", "nobody")
        notifier.config_changed()
        notifier.read_cache_invalidated("bkt", "o")
    finally:
        notifier.close()


def test_gather_marks_a_down_peer_offline(nodes):
    down = tpeer.PeerRESTClient("127.0.0.1", 1, SECRET, timeout=0.5)
    notifier = tpeer.PeerNotifier([_client(nodes["jax"]), down])
    try:
        infos = notifier.server_infos()
        assert infos[0]["state"] == "online"
        assert infos[1] == {"endpoint": "127.0.0.1:1", "state": "offline"}
        notifier.bucket_meta_changed("bkt")  # dropped, never raised
    finally:
        notifier.close()


@pytest.mark.parametrize("zone_args,ak,sk", [
    (ARGS, "ak", "sk"),
    (["http://h{1...2}:9000/d{1...4}", "http://h{3...4}:9000/d{1...4}"],
     "minioadmin", "minioadmin"),
    (["/data/d{1...16}"], "a", "b"),
])
def test_fingerprint_equals_jax(zone_args, ak, sk):
    assert tpeer.cluster_fingerprint(zone_args, ak, sk) == \
        jpeer.cluster_fingerprint(zone_args, ak, sk)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_handshake_against_either_node(nodes, kind):
    c = _client(nodes[kind])
    tpeer.verify_cluster([c], dict(FP), timeout_s=5)
    with pytest.raises(RuntimeError, match="cred_hash"):
        tpeer.verify_cluster(
            [c], tpeer.cluster_fingerprint(ARGS, "ak", "DIFFERENT"),
            timeout_s=5)
    with pytest.raises(RuntimeError, match="endpoints"):
        tpeer.verify_cluster(
            [c], tpeer.cluster_fingerprint(["http://other/d"], "ak", "sk"),
            timeout_s=5)
    bad = _client(nodes[kind], tpeer, "other-secret")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="credentials"):
        tpeer.verify_cluster([bad], dict(FP), timeout_s=30)
    assert time.monotonic() - t0 < 5


def test_handshake_waits_for_unreachable_peer():
    c = tpeer.PeerRESTClient("127.0.0.1", 1, SECRET, timeout=0.2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        tpeer.verify_cluster([c], {}, timeout_s=1.0, interval_s=0.1)
    assert time.monotonic() - t0 >= 0.9


@pytest.fixture()
def host_cache(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "host")
    tcache.reset_read_cache()
    yield
    tcache.set_broadcast(None)
    tcache.reset_read_cache()


def test_invalidate_drops_locally_and_never_rebroadcasts(
        nodes, host_cache):
    import io

    ol = nodes["port"].object_layer
    body = bytes(range(256)) * 1024
    ol.put_object("bkt", "hot", io.BytesIO(body), len(body))
    for _ in range(3):
        ol.get_object("bkt", "hot", io.BytesIO())
    c = tcache.read_cache("cpu")
    assert c.stats()["tiers"]["host"]["entries"] > 0
    sent = []
    tcache.set_broadcast(lambda b, o: sent.append((b, o)))
    got = _client(nodes["port"]).call(
        "invalidatereadcache", {"bucket": "bkt", "object": "hot"})
    assert got["ok"] and got["dropped"] > 0
    assert c.stats()["tiers"]["host"]["entries"] == 0
    assert sent == []  # the remote-called twin never fans out again
    # a local mutation does fan out
    ol.put_object("bkt", "hot", io.BytesIO(body), len(body))
    assert sent == [("bkt", "hot")]


def test_broadcast_turns_the_sidecar_off(nodes, host_cache):
    import io

    ol = nodes["port"].object_layer
    body = b"x" * 70_000
    ol.put_object("bkt", "side", io.BytesIO(body), len(body))
    ol.get_object("bkt", "side", io.BytesIO())
    c = tcache.read_cache("cpu")
    assert tcache.sidecar_enabled()
    assert c.meta_lookup("bkt", "side") is not None
    tcache.set_broadcast(lambda b, o: None)
    assert not tcache.sidecar_enabled()
    c.invalidate("bkt", "side")
    out = io.BytesIO()
    ol.get_object("bkt", "side", out)
    assert out.getvalue() == body
    assert c.meta_lookup("bkt", "side") is None  # nothing stored


def test_admin_top_locks_local_and_peers(tmp_path):
    locker_a, locker_b = LocalLocker("local:a"), LocalLocker("local:b")
    locker_a.lock(LockArgs("u1", ("bkt/one",), "n1"))
    locker_b.rlock(LockArgs("u2", ("bkt/two",), "n2"))
    a = _node(tmp_path / "a", "port", locker=locker_a)
    b = _node(tmp_path / "b", "port", locker=locker_b)
    try:
        a.peer_notifier = tpeer.PeerNotifier([_client(b)])
        r = S3Client(a.endpoint, "minioadmin", SECRET).request(
            "GET", "/minio-tpu/admin/v1/top-locks")
        assert r.status == 200, r.body
        locks = json.loads(r.body)["locks"]
        assert sorted((x["endpoint"], x["resource"], x["writer"])
                      for x in locks) == [("local:a", "bkt/one", True),
                                          ("local:b", "bkt/two", False)]
    finally:
        a.shutdown()
        b.shutdown()


@pytest.fixture()
def fault_node(tmp_path):
    srv = _node(tmp_path, "port", faults=True)
    yield srv, S3Client(srv.endpoint, "minioadmin", SECRET)
    srv.shutdown()


def test_admin_fault_inject(fault_node):
    srv, c = fault_node
    r = c.request("POST", "/minio-tpu/admin/v1/fault/inject",
                  body=json.dumps({"disk": "d1", "api": "stat_vol",
                                   "error": True}).encode())
    assert r.status == 200, r.body
    [root] = json.loads(r.body)["injected"]
    assert root.endswith("d1")
    fd = srv.fault_disks[root]
    with pytest.raises(Exception) as ei:
        fd.stat_vol("bkt")
    assert type(ei.value).__name__ == "FaultyDisk"
    r = c.request("POST", "/minio-tpu/admin/v1/fault/inject",
                  body=json.dumps({"disk": "nope", "api": "x"}).encode())
    assert r.status == 400


def test_admin_fault_clear(fault_node):
    srv, c = fault_node
    for fd in srv.fault_disks.values():
        fd.inject("read_all", error=True)
    r = c.request("POST", "/minio-tpu/admin/v1/fault/clear",
                  body=json.dumps({"disk": "*"}).encode())
    assert r.status == 200
    assert len(json.loads(r.body)["cleared"]) == 4
    assert all(fd.rule_count() == 0 for fd in srv.fault_disks.values())


def test_admin_fault_status(fault_node):
    srv, c = fault_node
    fd = next(iter(srv.fault_disks.values()))
    fd.inject("stat_vol", error=True)
    with pytest.raises(Exception):
        fd.stat_vol("x")
    r = c.request("GET", "/minio-tpu/admin/v1/fault/status")
    doc = json.loads(r.body)
    assert r.status == 200 and len(doc) == 4
    assert doc[str(fd.unwrapped.root)] == {"rules": 1,
                                           "injected": {"error": 1}}


def test_admin_fault_routes_need_injection(nodes):
    r = S3Client(nodes["port"].endpoint, "minioadmin", SECRET).request(
        "GET", "/minio-tpu/admin/v1/fault/status")
    assert r.status == 400 and b"MINIO_TPU_FAULT_INJECTION" in r.body
