"""Internode keep-alive reuse under a short server idle timeout.

With ``MINIO_TPU_IDLE_TIMEOUT_S=0.3`` a server closes a keep-alive
connection that idles past 0.3 s: the port's planes without a word, the
JAX package's async plane after writing a 408 into it.  The port's lock
and peer clients replace a pooled connection idle longer than
``tlsconf.keepalive_reuse_s()`` - half the idle timeout, at most 15 s -
so neither a lock grant (never retried once it may have reached the
server) nor a fire-and-forget peer notification (``retry=False``) goes
into a closed connection or reads a stale 408.  Each call below comes
after a gap longer than the timeout, against the port's threaded and
async planes and the JAX package's server on both of its planes.
"""

from __future__ import annotations

import time

import pytest

from minio_tpu.cluster import peer as jpeer
from minio_tpu.dsync import lock_rest as jlock_rest
from minio_tpu.dsync.local_locker import LocalLocker as JLocalLocker
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu_torch.cluster import peer as tpeer
from minio_tpu_torch.dsync import lock_rest as tlock_rest
from minio_tpu_torch.dsync.drwmutex import LockArgs
from minio_tpu_torch.dsync.local_locker import LocalLocker
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.utils import tlsconf
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "keepalive-secret"
IDLE_S = 0.3
GAP_S = 0.8  # longer than the idle timeout before every call
CALLS = 4
TARGETS = [("port", "threaded"), ("port", "async"), ("jax", "async"),
           ("jax", "threaded")]
IDS = [f"{k}-{p}" for k, p in TARGETS]


@pytest.fixture
def short_idle(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_IDLE_TIMEOUT_S", str(IDLE_S))


def _server(kind: str, plane: str, monkeypatch):
    """An S3 server of ``kind`` on ``plane`` with the lock and peer
    planes mounted; the locker it grants from."""
    monkeypatch.setenv("MINIO_TPU_SERVER", plane)
    if kind == "port":
        srv = TS3Server(None, address="127.0.0.1:0", secret_key=SECRET,
                        internode_secret=SECRET)
        locker, lock_mod, peer_mod = LocalLocker(), tlock_rest, tpeer
    else:
        srv = JS3Server(None, address="127.0.0.1:0", secret_key=SECRET,
                        internode_secret=SECRET)
        locker, lock_mod, peer_mod = JLocalLocker(), jlock_rest, jpeer
    srv.register_internode(lock_mod.PREFIX,
                           lock_mod.LockRESTServer(locker, SECRET).handle)
    plane_srv = peer_mod.PeerRESTServer(srv, SECRET, fingerprint={})
    srv.register_internode(peer_mod.PREFIX, plane_srv.handle)
    return srv.start(), locker


@pytest.mark.parametrize("idle,want", [(None, 15.0), ("60", 15.0),
                                       ("20", 10.0), ("0.3", 0.15),
                                       ("bad", 15.0)])
def test_reuse_window_follows_idle_timeout(monkeypatch, idle, want):
    if idle is None:
        monkeypatch.delenv("MINIO_TPU_IDLE_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_IDLE_TIMEOUT_S", idle)
    assert tlsconf.keepalive_reuse_s() == want


@pytest.mark.parametrize("kind,plane", TARGETS, ids=IDS)
def test_lock_grants_after_idle(short_idle, monkeypatch, kind, plane):
    srv, locker = _server(kind, plane, monkeypatch)
    client = tlock_rest.LockRESTClient("127.0.0.1", srv.port, SECRET)
    try:
        for i in range(CALLS):
            time.sleep(GAP_S)
            args = LockArgs(uid=f"u{i}", resources=(f"bkt/o{i}",))
            assert client.lock(args)  # one send: never retried
            time.sleep(GAP_S)
            assert client.unlock(args)
        assert locker.dump() == []  # every grant released
    finally:
        client.close()
        srv.shutdown()


@pytest.mark.parametrize("kind,plane", TARGETS, ids=IDS)
def test_peer_notifications_after_idle(short_idle, monkeypatch, kind, plane):
    srv, _locker = _server(kind, plane, monkeypatch)
    client = tpeer.PeerRESTClient("127.0.0.1", srv.port, SECRET)
    try:
        for i in range(CALLS):
            time.sleep(GAP_S)
            # fire-and-forget: retry=False, one send
            client.invalidate_read_cache("bkt", f"o{i}")
    finally:
        client.close()
        srv.shutdown()
