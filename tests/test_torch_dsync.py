"""The port's dsync (minio_tpu_torch/dsync) against the JAX package's.

* The JAX package's ``tests/test_dsync.py`` scenarios run on the port's
  ``LocalLocker``, ``Dsync``/``DRWMutex``, ``LockMaintenance`` and
  ``DistNamespaceLock``: write exclusion, stacked readers, unlock
  validation, all-or-nothing multi-resource grants, expiry, quorum
  math, mutual exclusion, a node down, partial grants released, lost
  refresh quorum, dead holders freed by expiry.
* The lock REST plane over real HTTP in three pairings: the port's
  client against the port's server, the port's client against the JAX
  ``LockRESTServer``, and the JAX client against the port's server;
  the bodies both packages send are byte-equal.
"""

import threading
import time

import msgpack
import pytest

from minio_tpu.dsync import lock_rest as jlock_rest
from minio_tpu.dsync.drwmutex import LockArgs as JLockArgs
from minio_tpu.dsync.local_locker import LocalLocker as JLocalLocker
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu_torch.dsync import lock_rest as tlock_rest
from minio_tpu_torch.dsync.drwmutex import (
    DRWMutex,
    Dsync,
    LockArgs,
    _quorums,
)
from minio_tpu_torch.dsync.local_locker import LocalLocker, LockMaintenance
from minio_tpu_torch.dsync.namespace import DistNamespaceLock, LockTimeout
from minio_tpu_torch.server.http import S3Server as TS3Server
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "minioadmin"


def args(uid, *resources):
    return LockArgs(uid=uid, resources=resources)


# -- LocalLocker unit semantics (local-locker.go) --------------------------


def test_local_locker_write_excludes():
    lk = LocalLocker()
    assert lk.lock(args("u1", "b/o"))
    assert not lk.lock(args("u2", "b/o"))
    assert not lk.rlock(args("u3", "b/o"))
    assert lk.unlock(args("u1", "b/o"))
    assert lk.lock(args("u2", "b/o"))


def test_local_locker_readers_stack():
    lk = LocalLocker()
    assert lk.rlock(args("r1", "b/o"))
    assert lk.rlock(args("r2", "b/o"))
    assert not lk.lock(args("w1", "b/o"))
    assert lk.runlock(args("r1", "b/o"))
    assert not lk.lock(args("w1", "b/o"))  # one reader left
    assert lk.runlock(args("r2", "b/o"))
    assert lk.lock(args("w1", "b/o"))


def test_local_locker_unlock_validation():
    lk = LocalLocker()
    assert not lk.unlock(args("nope", "b/o"))  # nothing held
    lk.rlock(args("r1", "b/o"))
    assert not lk.unlock(args("r1", "b/o"))  # write-unlock of read lock
    assert lk.runlock(args("r1", "b/o"))


def test_local_locker_multi_resource_all_or_nothing():
    lk = LocalLocker()
    lk.lock(args("u1", "b/a"))
    assert not lk.lock(args("u2", "b/a", "b/b"))
    assert lk.lock(args("u3", "b/b"))


def test_local_locker_expiry():
    lk = LocalLocker()
    lk.lock(args("dead", "b/o"))
    time.sleep(0.05)
    assert lk.expire_old(max_age_s=0.01) == 1
    assert lk.lock(args("alive", "b/o"))
    lk.refresh(args("alive", "b/o"))
    assert lk.expire_old(max_age_s=10.0) == 0


def test_local_locker_answers_as_jax_one():
    """One script of grants, releases and refreshes: every answer and the
    final dump (but for times) equal the JAX LocalLocker's."""
    script = [
        ("lock", "u1", ("b/a",)), ("lock", "u2", ("b/a", "b/b")),
        ("rlock", "r1", ("b/c",)), ("rlock", "r2", ("b/c",)),
        ("lock", "w", ("b/c",)), ("refresh", "u1", ("b/a",)),
        ("refresh", "zz", ("b/a",)), ("runlock", "r1", ("b/c",)),
        ("unlock", "r2", ("b/c",)), ("unlock", "u1", ("b/a",)),
        ("force_unlock", "", ("b/c",)), ("force_unlock", "", ("b/c",)),
        ("lock", "u3", ("b/b", "b/d")),
    ]
    t, j = LocalLocker("n"), JLocalLocker("n")
    for op, uid, res in script:
        got_t = getattr(t, op)(LockArgs(uid, res, "src"))
        got_j = getattr(j, op)(JLockArgs(uid, res, "src"))
        assert got_t == got_j, (op, uid, res)
    strip = ("age_s", "acquired_at")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in t.dump()] == \
        [{k: v for k, v in e.items() if k not in strip} for e in j.dump()]


# -- quorum math (drwmutex.go:184-199) -------------------------------------


@pytest.mark.parametrize(
    "n,read,quorum",
    [
        (1, False, 1), (2, False, 2), (3, False, 2), (4, False, 3),
        (8, False, 5), (2, True, 1), (3, True, 2), (4, True, 2),
        (8, True, 4),
    ],
)
def test_quorum_math(n, read, quorum):
    from minio_tpu.dsync.drwmutex import _quorums as jquorums

    q, tol = _quorums(n, read)
    assert q == quorum and q + tol == n
    assert (q, tol) == jquorums(n, read)


# -- DRWMutex over in-process lockers --------------------------------------


def _dsync(n=3, refresh=60.0):
    lockers = [LocalLocker(endpoint=f"n{i}") for i in range(n)]
    return Dsync(lockers, refresh_interval_s=refresh), lockers


def test_drwmutex_mutual_exclusion():
    ds, _ = _dsync()
    order = []

    def worker(tag):
        m = DRWMutex(ds, "bkt/obj")
        assert m.get_lock(tag, timeout=10)
        order.append(f"{tag}-in")
        time.sleep(0.05)
        order.append(f"{tag}-out")
        m.unlock()

    ts = [threading.Thread(target=worker, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert order in (
        ["a-in", "a-out", "b-in", "b-out"],
        ["b-in", "b-out", "a-in", "a-out"],
    )
    ds.close()


def test_drwmutex_readers_shared_writer_excluded():
    ds, _ = _dsync()
    r1 = DRWMutex(ds, "bkt/obj")
    r2 = DRWMutex(ds, "bkt/obj")
    assert r1.get_rlock(timeout=2)
    assert r2.get_rlock(timeout=2)
    w = DRWMutex(ds, "bkt/obj")
    assert not w.get_lock(timeout=0.3)
    r1.runlock()
    r2.runlock()
    assert w.get_lock(timeout=2)
    w.unlock()
    ds.close()


class _DeadLocker(LocalLocker):
    def lock(self, a):  # noqa: D102
        raise ConnectionError("down")

    def rlock(self, a):  # noqa: D102
        raise ConnectionError("down")


def test_drwmutex_quorum_with_node_down():
    lockers = [LocalLocker(), _DeadLocker(), LocalLocker()]
    ds = Dsync(lockers, refresh_interval_s=60.0)
    m = DRWMutex(ds, "bkt/obj")
    assert m.get_lock(timeout=2)
    m.unlock()
    ds.close()


def test_drwmutex_no_quorum_two_down():
    lockers = [LocalLocker(), _DeadLocker(), _DeadLocker()]
    ds = Dsync(lockers, refresh_interval_s=60.0)
    m = DRWMutex(ds, "bkt/obj")
    assert not m.get_lock(timeout=0.5)
    assert lockers[0].lock(args("fresh", "bkt/obj"))
    ds.close()


def test_drwmutex_failure_releases_partial_grants():
    ds, lockers = _dsync()
    held = DRWMutex(ds, "bkt/obj")
    assert held.get_lock(timeout=2)
    contender = DRWMutex(ds, "bkt/obj")
    assert not contender.get_lock(timeout=0.3)
    held.unlock()
    for lk in lockers:
        assert lk.lock(args("probe", "bkt/obj"))
        assert lk.unlock(args("probe", "bkt/obj"))
    ds.close()


def test_rlock_multi_resource_rejected():
    ds, _ = _dsync()
    m = DRWMutex(ds, "b/a", "b/b")
    with pytest.raises(ValueError):
        m.get_rlock(timeout=0.5)
    assert m.get_lock(timeout=2)
    m.unlock()
    ds.close()


class _RefusingRefresh(LocalLocker):
    def refresh(self, a):  # noqa: D102
        raise ConnectionError("down")


def test_refresh_quorum_loss_marks_lock_lost():
    lockers = [LocalLocker(), _RefusingRefresh(), _RefusingRefresh()]
    ds = Dsync(lockers, refresh_interval_s=0.05)
    m = DRWMutex(ds, "bkt/obj")
    assert m.get_lock(timeout=2)
    uid = m._uid
    deadline = time.monotonic() + 3
    while not ds.is_lost(uid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ds.is_lost(uid)
    ds.close()


def test_release_all_unwinds_held_locks():
    """Shutdown: every held grant is released on every locker."""
    ds, lockers = _dsync()
    ns = DistNamespaceLock(ds)
    w = DRWMutex(ds, "bkt/a")
    r = DRWMutex(ds, "bkt/b")
    assert w.get_lock(timeout=2) and r.get_rlock(timeout=2)
    assert sum(len(lk.dump()) for lk in lockers) == 6
    assert ns.release_all() == 2
    assert all(lk.dump() == [] for lk in lockers)


def test_dead_holder_lock_expires():
    ds_a, lockers = _dsync(refresh=0.05)
    m = DRWMutex(ds_a, "bkt/obj")
    assert m.get_lock(timeout=2)
    ds_a.close()
    maints = [LockMaintenance(lk, interval_s=0.05, expiry_s=0.2).start()
              for lk in lockers]
    try:
        ds_b = Dsync(lockers, refresh_interval_s=0.05)
        m2 = DRWMutex(ds_b, "bkt/obj")
        assert m2.get_lock(timeout=5), "expiry must free the dead lock"
        m2.unlock()
        ds_b.close()
    finally:
        for mt in maints:
            mt.stop()


def test_live_holder_survives_maintenance():
    ds, lockers = _dsync(refresh=0.05)
    maints = [LockMaintenance(lk, interval_s=0.05, expiry_s=0.3).start()
              for lk in lockers]
    try:
        m = DRWMutex(ds, "bkt/obj")
        assert m.get_lock(timeout=2)
        time.sleep(0.8)
        contender = DRWMutex(ds, "bkt/obj")
        assert not contender.get_lock(timeout=0.3)
        m.unlock()
    finally:
        for mt in maints:
            mt.stop()
        ds.close()


def test_dist_namespace_lock_interface():
    ds, _ = _dsync()
    ns = DistNamespaceLock(ds)
    with ns.write("bkt", "obj"):
        with pytest.raises(LockTimeout):
            with ns.write("bkt", "obj", timeout=0.2):
                pass
        with pytest.raises(LockTimeout):
            with ns.read("bkt", "obj", timeout=0.2):
                pass
    with ns.read("bkt", "obj"):
        with ns.read("bkt", "obj", timeout=1):
            pass
    ds.close()


# -- lock REST plane, both packages ----------------------------------------


@pytest.mark.parametrize("uid,resources,source", [
    ("u1", ("b/o",), ""),
    ("f" * 32, ("bkt/a", "bkt/b", "bkt/" + "x" * 300), "node-3:9000"),
    ("", (), "src"),
])
def test_lock_args_bytes_equal(uid, resources, source):
    body = tlock_rest._pack_args(LockArgs(uid, resources, source))
    assert body == jlock_rest._pack_args(JLockArgs(uid, resources, source))
    assert body == msgpack.packb(
        {"uid": uid, "resources": list(resources), "source": source},
        use_bin_type=True)
    assert tlock_rest._unpack_args(body) == LockArgs(uid, resources, source)


# (client package, server package)
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _server(kind):
    if kind == "port":
        locker = LocalLocker()
        srv = TS3Server(None, address="127.0.0.1:0", secret_key=SECRET)
        srv.register_internode(
            tlock_rest.PREFIX, tlock_rest.LockRESTServer(locker, SECRET).handle)
    else:
        locker = JLocalLocker()
        srv = JS3Server(None, address="127.0.0.1:0", secret_key=SECRET)
        srv.register_internode(
            jlock_rest.PREFIX, jlock_rest.LockRESTServer(locker, SECRET).handle)
    srv.start()
    return srv, locker


def _client(kind, port, secret=SECRET):
    mod = tlock_rest if kind == "port" else jlock_rest
    return mod.LockRESTClient("127.0.0.1", port, secret)


def _args(kind, uid, *res):
    return (LockArgs if kind == "port" else JLockArgs)(uid, res)


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def lock_cluster(request):
    ckind, skind = request.param
    servers = [_server(skind) for _ in range(3)]
    clients = [_client(ckind, srv.port) for srv, _ in servers]
    yield ckind, servers, clients
    for srv, _ in servers:
        srv.shutdown()


def test_lock_rest_roundtrip(lock_cluster):
    kind, _servers, clients = lock_cluster
    c = clients[0]
    a = lambda uid: _args(kind, uid, "b/o")  # noqa: E731
    assert c.lock(a("u1"))
    assert not c.lock(a("u2"))
    assert c.refresh(a("u1"))
    assert c.unlock(a("u1"))
    assert c.rlock(a("r1"))
    assert c.rlock(a("r2"))
    assert c.runlock(a("r1"))
    assert c.runlock(a("r2"))
    assert c.force_unlock(a("")) is False
    assert c.is_online()


def test_lock_rest_rejects_bad_jwt(lock_cluster):
    kind, servers, _ = lock_cluster
    bad = _client(kind, servers[0][0].port, "wrong-secret")
    with pytest.raises(ConnectionError):
        bad.lock(_args(kind, "u1", "b/o"))
    assert servers[0][1].dump() == []


def test_drwmutex_over_rest_plane(lock_cluster):
    """Two DRWMutexes of 'different processes' (separate Dsync
    instances) racing over the wire serialize; the first process holds
    the JAX package's or the port's clients as the pairing says, the
    second always the port's."""
    kind, _servers, clients = lock_cluster
    ds1 = Dsync(clients, refresh_interval_s=60.0)
    ds2 = Dsync([tlock_rest.LockRESTClient(c.host, c.port, SECRET)
                 for c in clients], refresh_interval_s=60.0)
    m1 = DRWMutex(ds1, "bkt/obj")
    m2 = DRWMutex(ds2, "bkt/obj")
    assert m1.get_lock(timeout=2)
    assert not m2.get_lock(timeout=0.3)
    m1.unlock()
    assert m2.get_lock(timeout=2)
    m2.unlock()
    ds1.close()
    ds2.close()


def test_dead_holder_over_rest_plane(lock_cluster):
    kind, servers, clients = lock_cluster
    ds_a = Dsync(clients, refresh_interval_s=0.05)
    m = DRWMutex(ds_a, "bkt/obj")
    assert m.get_lock(timeout=2)
    ds_a.close()
    maints = [LockMaintenance(locker, interval_s=0.05, expiry_s=0.2).start()
              for _, locker in servers]
    try:
        ds_b = Dsync([tlock_rest.LockRESTClient(c.host, c.port, SECRET)
                      for c in clients], refresh_interval_s=0.05)
        m2 = DRWMutex(ds_b, "bkt/obj")
        assert m2.get_lock(timeout=5)
        m2.unlock()
        ds_b.close()
    finally:
        for mt in maints:
            mt.stop()
