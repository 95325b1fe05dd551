"""The internode fan-outs of the port (parallel/fanout.py) and the request
stage spans (utils/spans.py).

* dsync asks remote lockers on persistent fan-out workers, so lock and
  release calls reuse each worker's keep-alive connection: 30 lock and
  unlock cycles over two remote lockers (one a JAX ``LockRESTServer``)
  open a handful of connections, not one a call.
* The acquisition's rules hold on the workers: quorum over port and JAX
  lock servers with a node down, a grant that arrives after the attempt
  was given up is released (late grant), and so is one that arrives
  after the lock it joined was released, and a grant applied behind a
  lost response is released (phantom grant), against a JAX
  ``LocalLocker`` on its own lock server too.
* ``read_all_fileinfo`` reads remote drives at once and answers as the
  JAX package's sequential reads do, error slots included.
* A GET's stage spans are recorded and the admin ``request-stages``
  route returns them, on both request planes.
"""

from __future__ import annotations

import io
import json
import threading
import time

import pytest

from minio_tpu.dsync import lock_rest as jlock_rest
from minio_tpu.dsync.local_locker import LocalLocker as JLocalLocker
from minio_tpu.objectlayer import metadata as jmetadata
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.dsync import drwmutex, lock_rest as tlock_rest
from minio_tpu_torch.dsync.drwmutex import DRWMutex, Dsync, LockArgs
from minio_tpu_torch.dsync.local_locker import LocalLocker
from minio_tpu_torch.objectlayer import metadata as tmetadata
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.parallel.fanout import Fanout, run_all
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage import rest_common, rest_server
from minio_tpu_torch.storage.rest_client import StorageRESTClient
from minio_tpu_torch.storage.xl import XLStorage
from minio_tpu_torch.utils import spans, tlsconf
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "minioadmin"


def _lock_server(kind):
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
    return srv.start(), locker


@pytest.fixture()
def remote_lockers():
    servers = [_lock_server("port"), _lock_server("jax")]
    yield servers
    for srv, _ in servers:
        srv.shutdown()


def test_lock_calls_reuse_keepalive_connections(remote_lockers, monkeypatch):
    opened = []
    real = tlsconf.client_connection

    def counted(host, port, timeout):
        opened.append(port)
        return real(host, port, timeout)

    monkeypatch.setattr(tlsconf, "client_connection", counted)
    clients = [tlock_rest.LockRESTClient("127.0.0.1", srv.port, SECRET)
               for srv, _ in remote_lockers]
    ds = Dsync([LocalLocker(), *clients], refresh_interval_s=60.0)
    try:
        for i in range(30):
            m = DRWMutex(ds, f"bkt/o{i % 3}")
            assert m.get_lock(timeout=5) if i % 2 else m.get_rlock(timeout=5)
            m.unlock()
        # every grant was released on both remote servers.  A remote
        # that granted after the quorum was met is released by its own
        # ask on a fan-out worker, which can land after unlock returns
        # (drwmutex.go releases such grants the same way): wait for it
        deadline = time.monotonic() + 10.0
        while not all(locker.dump() == [] for _, locker in remote_lockers):
            assert time.monotonic() < deadline, [
                locker.dump() for _, locker in remote_lockers]
            time.sleep(0.02)
    finally:
        ds.close()
    # one call a thread used to open one connection each: 120 here
    assert 2 <= len(opened) <= 16, len(opened)


def test_quorum_over_port_and_jax_servers_with_a_node_down(remote_lockers):
    (psrv, _), (jsrv, jlocker) = remote_lockers
    clients = [tlock_rest.LockRESTClient("127.0.0.1", s.port, SECRET)
               for s in (psrv, jsrv)]
    ds1 = Dsync([LocalLocker(), *clients], refresh_interval_s=60.0)
    ds2 = Dsync([LocalLocker(), *clients], refresh_interval_s=60.0)
    try:
        m1, m2 = DRWMutex(ds1, "bkt/q"), DRWMutex(ds2, "bkt/q")
        assert m1.get_lock(timeout=2)
        deadline = time.monotonic() + 5  # a straggler's grant still lands
        while not jlocker.dump() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [e["resource"] for e in jlocker.dump()] == ["bkt/q"]
        assert not m2.get_lock(timeout=0.3)  # one of three lockers free
        m1.unlock()
        jsrv.shutdown()  # the JAX node goes down: 2 of 3 still grant
        assert m2.get_lock(timeout=3)
        m2.unlock()
    finally:
        ds1.close()
        ds2.close()


class _Fake:
    """A remote locker whose answers the test scripts."""

    def __init__(self, grant=True, delay=0.0, lose_response=False):
        self.inner = LocalLocker()
        self.grant, self.delay = grant, delay
        self.lose_response = lose_response
        self.released: list = []

    def _ask(self, args):
        time.sleep(self.delay)
        ok = self.grant and self.inner.lock(args)
        if self.lose_response:
            raise ConnectionError("response lost")
        return ok

    lock = rlock = _ask

    def unlock(self, args):
        self.released.append(args.uid)
        return self.inner.unlock(args)

    runlock = unlock

    def refresh(self, args):
        return True

    def close(self):
        pass


def test_late_grant_is_released(monkeypatch):
    monkeypatch.setattr(drwmutex, "ACQUIRE_TIMEOUT_S", 0.2)
    late = _Fake(delay=0.5)
    ds = Dsync([late, _Fake(grant=False), _Fake(delay=0.5)],
               refresh_interval_s=60.0)
    try:
        args = LockArgs(uid="late-1", resources=("bkt/l",))
        assert not DRWMutex(ds, "bkt/l")._try_lock(args, read=False)
        deadline = time.monotonic() + 5
        while "late-1" not in late.released and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "late-1" in late.released
        assert late.inner.dump() == []
    finally:
        ds.close()


def test_grant_landing_after_the_unlock_is_released():
    """A straggler whose grant lands after the lock it joined was
    released releases it itself, instead of leaving an entry until
    expiry."""
    slow = _Fake(delay=0.4)
    ds = Dsync([LocalLocker(), slow, LocalLocker()], refresh_interval_s=60.0)
    try:
        m = DRWMutex(ds, "bkt/s")
        assert m.get_lock(timeout=2)  # the two in-process lockers grant
        uid = m._uid
        m.unlock()
        assert slow.inner.dump() == []  # not landed yet
        deadline = time.monotonic() + 5
        while uid not in slow.released[1:] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert slow.released.count(uid) == 2  # the unlock's, then its own
        assert slow.inner.dump() == []
    finally:
        ds.close()


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_phantom_grant_is_released(kind):
    """A grant applied behind a lost response is released; with ``jax``
    the lock plane behind the lost response is the JAX package's."""
    srv, locker = _lock_server(kind)
    try:
        real = tlock_rest.LockRESTClient("127.0.0.1", srv.port, SECRET)

        class Lossy:
            def lock(self, args):
                real.lock(args)
                raise ConnectionError("response lost")

            rlock = lock

            def unlock(self, args):
                return real.unlock(args)

            runlock = unlock

            def close(self):
                real.close()

        ds = Dsync([LocalLocker(), Lossy(), LocalLocker()],
                   refresh_interval_s=60.0)
        try:
            m = DRWMutex(ds, "bkt/p")
            assert m.get_lock(timeout=2)  # two of three grant
            deadline = time.monotonic() + 5
            while locker.dump() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert locker.dump() == []  # the phantom is gone
            m.unlock()
        finally:
            ds.close()
    finally:
        srv.shutdown()


def test_fanout_runs_all_and_returns_after_the_last():
    f = Fanout("t", cap=4)
    seen = []
    mu = threading.Lock()

    def job(i):
        def run():
            time.sleep(0.05)
            with mu:
                seen.append(i)
        return run

    t0 = time.monotonic()
    run_all([(f, job(i)) for i in range(7)] + [(None, job(7))])
    assert sorted(seen) == list(range(8))
    assert time.monotonic() - t0 < 0.35  # 4 workers and the caller at once
    f.close()


def test_read_all_fileinfo_remote_at_once_answers_as_jax(tmp_path):
    roots = [str(tmp_path / f"d{i}") for i in range(4)]
    ol = ErasureObjects([XLStorage(r) for r in roots], device="cpu")
    ol.make_bucket("bkt")
    ol.put_object("bkt", "obj", io.BytesIO(b"x" * 5000), 5000)
    srv = TS3Server(None, address="127.0.0.1:0", secret_key=SECRET,
                    internode_secret=SECRET)
    srv.register_internode(rest_common.PREFIX, rest_server.StorageRESTServer(
        [XLStorage(r) for r in roots[2:]], SECRET).handle)
    srv.start()
    try:
        disks = [XLStorage(roots[0]), None, *(
            StorageRESTClient("127.0.0.1", srv.port, r, SECRET)
            for r in roots[2:])]
        jdisks = [JaxStorage(roots[0]), None, JaxStorage(roots[2]),
                  JaxStorage(roots[3])]
        for key in ("obj", "missing"):
            fis, errs = tmetadata.read_all_fileinfo(disks, "bkt", key)
            jfis, jerrs = jmetadata.read_all_fileinfo(jdisks, "bkt", key)
            assert [type(e).__name__ for e in errs] == [
                type(e).__name__ for e in jerrs]
            assert [fi is None for fi in fis] == [fi is None for fi in jfis]
            assert [fi.data_dir for fi in fis if fi] == [
                fi.data_dir for fi in jfis if fi]
    finally:
        srv.shutdown()


STAGES_PATH = "/minio-tpu/admin/v1/request-stages"


def _await_record(match, deadline_s: float = 30.0) -> None:
    """Wait until a closed record that ``match`` accepts is in the ring:
    the plane closes a request's record after its last response byte, so
    the client's next request can be served first."""
    end = time.monotonic() + deadline_s
    while True:
        with spans._mu:
            if any(match(r) for r in spans._ring):
                return
        assert time.monotonic() < end, "the record never reached the ring"
        time.sleep(0.005)


def _await_request(method: str, path: str) -> None:
    _await_record(lambda r: (r.get("method"), r.get("path")) == (method, path))


@pytest.mark.parametrize("plane", ["threaded", "async"])
def test_get_stage_spans_recorded(tmp_path, monkeypatch, plane):
    monkeypatch.setenv("MINIO_TPU_SERVER", plane)
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(4)],
                        block_size=4096, device="cpu")
    srv = TS3Server(ol, address="127.0.0.1:0").start()
    try:
        c = S3Client(srv.endpoint)
        spans.drain()  # the ring is the process's: drop earlier tests' records
        c.make_bucket("bkt")
        _await_request("PUT", "/bkt")
        c.put_object("bkt", "obj", b"y" * 20000)
        _await_request("PUT", "/bkt/obj")
        c.request("GET", STAGES_PATH)
        _await_request("GET", STAGES_PATH)
        r = c.get_object("bkt", "obj")
        assert r.status == 200
        rid = r.headers["x-amz-request-id"]
        _await_record(lambda rec: rec.get("request_id") == rid)
        doc = json.loads(c.request("GET", STAGES_PATH).body)
        rec = {x.get("request_id"): x for x in doc["records"]}[rid]
        assert rec["method"] == "GET" and rec["path"] == "/bkt/obj"
        st = rec["stages"]
        for stage in ("lock", "meta", "open", "shard_reads", "verify",
                      "unlock"):
            assert st[stage] > 0, stage
        if plane == "async":
            assert st["queue"] >= 0 and st["write"] > 0
        assert rec["total"] >= st["lock"] + st["meta"] + st["open"]
        # reading cleared the ring: only the last read's own record is new
        _await_request("GET", STAGES_PATH)
        doc = json.loads(c.request("GET", STAGES_PATH).body)
        assert [x["path"] for x in doc["records"]] == [STAGES_PATH]
    finally:
        srv.shutdown()
