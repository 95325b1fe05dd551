"""The port's async request plane held against minio_tpu's.

Both packages' ``S3Server`` run on their asyncio planes (server/aio.py)
over a four-drive erasure set each (EC 2+2, 4 KiB blocks; the port's
codec on the CPU).  The same signed requests go to both, over raw
sockets where the wire behaviour is the point; statuses, headers and
bodies must be equal once the ``Date``, ``x-amz-request-id`` and
``Last-Modified`` headers and ``<RequestId>`` are normalized:

* keep-alive pipelining: three GETs written back to back on one
  connection come back in order;
* ``Expect: 100-continue``: a waiting client gets its 100 and then its
  200; a request refused on its headers gets its 403 with no 100, and
  the connection closes;
* the slow-loris header timeout answers 408 and closes; an idle
  keep-alive connection is closed without a response (port only);
* 503 SlowDown shedding by handler backlog and by tenant, before any
  body byte, counted under the same reason;
* ``MINIO_TPU_SERVER_LOOPS=1`` against three loops (SO_REUSEPORT and
  the handoff fallback), readiness with every loop serving, and a drain
  of every loop on shutdown;
* the port's async plane byte-identical to its threaded plane: the
  same answers and the same shard files;
* four clients PUT and GET at once: every body equals its source.
"""

import datetime
import hashlib
import json
import os
import re
import socket
import threading
import time

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server import auth as jauth
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_sets_zones import _tree
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096
KINDS = ("jax", "port")


@pytest.fixture(autouse=True)
def _backends():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        yield
        jbackend.reset_backend()
        tbackend.reset_backend()


class _Booted:
    def __init__(self, srv, roots, saved):
        self.srv, self.roots, self.saved = srv, roots, saved

    def client(self) -> S3Client:
        return S3Client(self.srv.endpoint)

    def stop(self, drain_s: float = 5.0) -> None:
        try:
            self.srv.shutdown(drain_s=drain_s)
        finally:
            for k, v in self.saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def _boot(kind: str, base, mode: str = "async", **env) -> _Booted:
    env = {"MINIO_TPU_SERVER": mode, **env}
    env.setdefault("MINIO_TPU_SERVER_LOOPS", "1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    roots = [str(base / f"{kind}-{mode}{i}") for i in range(4)]
    if kind == "jax":
        ol = JaxObjects([JaxStorage(r) for r in roots], block_size=BLOCK)
        srv = JaxServer(ol, address="127.0.0.1:0").start()
    else:
        ol = ErasureObjects([XLStorage(r) for r in roots], block_size=BLOCK,
                            device="cpu")
        srv = S3Server(ol, address="127.0.0.1:0").start()
    return _Booted(srv, roots, saved)


def _pay(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _signed_head(c: S3Client, method: str, path: str, body: bytes = b"",
                 extra=None, secret=None) -> bytes:
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ")
    phash = hashlib.sha256(body).hexdigest()
    headers = {k.lower(): v for k, v in (extra or {}).items()}
    headers.setdefault("host", f"{c.host}:{c.port}")
    headers["x-amz-date"] = amz_date
    headers["x-amz-content-sha256"] = phash
    signed = sorted(headers)
    sig = jauth.sign_v4(method, path, {}, headers, signed, phash,
                        c.access_key, secret or c.secret_key, amz_date,
                        c.region)
    scope = f"{amz_date[:8]}/{c.region}/s3/aws4_request"
    headers["authorization"] = (
        f"{jauth.SIGN_V4_ALGORITHM} Credential={c.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    if body:
        headers["content-length"] = str(len(body))
    lines = [f"{method} {path} HTTP/1.1"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _read_response(f):
    status_line = f.readline()
    if not status_line:
        return None, {}, b""
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    body = b""
    if status != 100 and "content-length" in headers:
        body = f.read(int(headers["content-length"]))
    return status, headers, body


def _connect(srv) -> socket.socket:
    return socket.create_connection((srv.host, srv.port), timeout=10)


_VOLATILE = ("date", "x-amz-request-id", "last-modified")
_REQ_ID = re.compile(rb"<RequestId>[^<]*</RequestId>")


def _norm(res):
    status, headers, body = res
    return (status, {k: v for k, v in headers.items() if k not in _VOLATILE},
            _REQ_ID.sub(b"<RequestId/>", body))


def _res(r):
    return r.status, {k.lower(): v for k, v in r.headers.items()}, r.body


def _both(base, scenario, **env) -> dict:
    """Run ``scenario(booted)`` on each package's async plane."""
    out = {}
    for kind in KINDS:
        booted = _boot(kind, base / kind, **env)
        try:
            out[kind] = scenario(booted)
        finally:
            booted.stop()
    return out


def test_keepalive_pipelining(tmp_path):
    bodies = {f"o{i}": _pay(2048 + i, i) for i in (1, 2, 3)}

    def scenario(b):
        c = b.client()
        assert c.make_bucket("pipe").status == 200
        for k, v in bodies.items():
            assert c.put_object("pipe", k, v).status == 200
        s = _connect(b.srv)
        try:
            s.sendall(b"".join(_signed_head(c, "GET", f"/pipe/{k}")
                               for k in bodies))
            f = s.makefile("rb")
            return [_norm(_read_response(f)) for _ in bodies]
        finally:
            s.close()

    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    assert [r[2] for r in got["port"]] == list(bodies.values())


def test_expect_100_continue(tmp_path):
    body = _pay(8192, 3)

    def scenario(b):
        c = b.client()
        assert c.make_bucket("expect").status == 200
        s = _connect(b.srv)
        try:
            s.sendall(_signed_head(c, "PUT", "/expect/waits", body=body,
                                   extra={"expect": "100-continue"}))
            f = s.makefile("rb")
            first = _norm(_read_response(f))  # the body is not sent yet
            s.sendall(body)
            second = _norm(_read_response(f))
        finally:
            s.close()
        # refused on its headers: the final status, no 100, then EOF
        s = _connect(b.srv)
        try:
            s.sendall(_signed_head(c, "PUT", "/expect/denied", body=body,
                                   extra={"expect": "100-continue"},
                                   secret="wrong-secret"))
            f = s.makefile("rb")
            denied = _norm(_read_response(f))
            eof = f.read(1)
        finally:
            s.close()
        return first, second, denied, eof, c.get_object("expect",
                                                        "waits").body

    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    first, second, denied, eof, stored = got["port"]
    assert (first[0], second[0], denied[0], eof) == (100, 200, 403, b"")
    assert stored == body


def test_slow_loris_header_timeout(tmp_path):
    def scenario(b):
        s = _connect(b.srv)
        try:
            s.sendall(b"GET /loris HTTP/1.1\r\nHost: x")  # never finishes
            f = s.makefile("rb")
            t0 = time.monotonic()
            res = _norm(_read_response(f))
            return res, time.monotonic() - t0 < 8.0, f.read(1)
        finally:
            s.close()

    got = _both(tmp_path, scenario, MINIO_TPU_HEADER_TIMEOUT_S="0.5")
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 408 and got["port"][1:] == (True, b"")


def test_idle_keepalive_closed_without_a_response(tmp_path):
    """Between keep-alive requests the port's plane closes a connection
    idle past MINIO_TPU_IDLE_TIMEOUT_S without writing anything: a 408
    there would be read as the answer to the client's next request.
    (The JAX plane writes the 408; the port differs on purpose.)  A head
    begun after the idle wait is still bounded by the header timeout."""
    b = _boot("port", tmp_path / "port", MINIO_TPU_IDLE_TIMEOUT_S="0.5",
              MINIO_TPU_HEADER_TIMEOUT_S="0.5")
    try:
        c = b.client()
        assert c.make_bucket("idle").status == 200
        s = _connect(b.srv)
        try:
            s.sendall(_signed_head(c, "GET", "/idle"))
            f = s.makefile("rb")
            assert _read_response(f)[0] == 200
            t0 = time.monotonic()
            assert f.read(1) == b""
            assert 0.3 < time.monotonic() - t0 < 8.0
        finally:
            s.close()
        s = _connect(b.srv)
        try:
            s.sendall(_signed_head(c, "GET", "/idle"))
            f = s.makefile("rb")
            assert _read_response(f)[0] == 200
            s.sendall(b"GET /loris HTTP/1.1\r\nHost: x")  # never finishes
            assert _read_response(f)[0] == 408
            assert f.read(1) == b""
        finally:
            s.close()
    finally:
        b.stop()


class _Blocker:
    """Park GETs of one key on an Event, holding a worker."""

    def __init__(self, ol, key):
        self.ol, self.key = ol, key
        self.entered, self.release = threading.Event(), threading.Event()
        self._orig = ol.get_object

        def slow_get(bucket, name, writer, *a, **kw):
            if name == self.key:
                self.entered.set()
                assert self.release.wait(30.0)
            return self._orig(bucket, name, writer, *a, **kw)

        ol.get_object = slow_get

    def undo(self):
        self.release.set()
        self.ol.get_object = self._orig


def _retry_503(call, *args):
    r = call(*args)
    deadline = time.monotonic() + 10.0
    while r.status == 503 and time.monotonic() < deadline:
        time.sleep(0.05)
        r = call(*args)
    return r


def _shed_scenario(reason: str):
    def scenario(b):
        srv = b.srv
        c = b.client()
        assert _retry_503(c.make_bucket, "shed").status == 200
        assert _retry_503(c.put_object, "shed", "slow",
                          _pay(1024)).status == 200
        blocker = _Blocker(srv.object_layer, "slow")
        results, threads = {}, []

        def fetch(tag):
            results[tag] = _retry_503(
                S3Client(srv.endpoint).get_object, "shed", "slow")

        try:
            threads.append(threading.Thread(target=fetch, args=("a",)))
            threads[-1].start()
            assert blocker.entered.wait(10.0)
            if reason == "queue":
                # B fills the one-slot handler queue
                threads.append(threading.Thread(target=fetch, args=("b",)))
                threads[-1].start()
                deadline = time.monotonic() + 10.0
                while srv.plane_stats.snapshot()["stage_depth"].get(
                        "handler", 0) < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.02)
            shed = _res(S3Client(srv.endpoint).get_object("shed", "slow"))
            counted = srv.plane_stats.snapshot()["shed"][reason]
            blocker.release.set()
            for t in threads:
                t.join(30.0)
            return (_norm(shed), counted >= 1,
                    sorted((k, r.status, r.body) for k, r in results.items()))
        finally:
            blocker.undo()
            for t in threads:
                t.join(5.0)

    return scenario


def test_shed_by_backlog(tmp_path):
    got = _both(tmp_path, _shed_scenario("queue"),
                MINIO_TPU_SERVER_WORKERS="1", MINIO_TPU_SERVER_BACKLOG="1")
    assert got["port"] == got["jax"]
    shed, counted, served = got["port"]
    assert shed[0] == 503 and b"<Code>SlowDown</Code>" in shed[2]
    assert counted and [s for _k, s, _b in served] == [200, 200]


def test_shed_by_tenant(tmp_path):
    got = _both(tmp_path, _shed_scenario("tenant"),
                MINIO_TPU_TENANT_MAX_INFLIGHT="1")
    assert got["port"] == got["jax"]
    shed, counted, served = got["port"]
    assert shed[0] == 503 and counted and [s for _k, s, _b in served] == [200]


def _roundtrip(b, n_gets: int = 4):
    c = b.client()
    payload = _pay(96 * 1024 + 5, 23)
    put = _res(c.put_object("loops", "obj", payload)) if c.make_bucket(
        "loops").status == 200 else None
    gets = [_norm(_res(S3Client(b.srv.endpoint).get_object("loops", "obj")))
            for _ in range(n_gets)]
    return _norm(put), gets


@pytest.mark.parametrize("loops,reuseport", [("1", "auto"), ("3", "auto"),
                                             ("3", "off")])
def test_loop_counts_serve_alike(tmp_path, loops, reuseport):
    got = _both(tmp_path, _roundtrip, MINIO_TPU_SERVER_LOOPS=loops,
                MINIO_TPU_SERVER_REUSEPORT=reuseport)
    assert got["port"] == got["jax"]
    booted = _boot("port", tmp_path / "one", MINIO_TPU_SERVER_LOOPS="1")
    try:
        assert _roundtrip(booted) == got["port"]
    finally:
        booted.stop()


@pytest.mark.parametrize("loops,reuseport", [("1", "auto"), ("3", "auto"),
                                             ("3", "off")])
def test_readiness_and_describe(tmp_path, loops, reuseport):
    def scenario(b):
        ok, doc = b.srv.readiness()
        plane = b.srv._plane
        return (ok, json.loads(doc), len(plane.loops), plane.reuseport,
                b.srv.server_mode)

    got = _both(tmp_path, scenario, MINIO_TPU_SERVER_LOOPS=loops,
                MINIO_TPU_SERVER_REUSEPORT=reuseport)
    assert got["port"] == got["jax"]
    ok, doc, n, reuse, mode = got["port"]
    assert ok and doc["server_loops"] is True and mode == "async"
    assert doc["loops"] == {str(i): "serving" for i in range(int(loops))}
    assert n == int(loops) and reuse is (loops != "1" and reuseport == "auto")


def test_shutdown_drains_every_loop(tmp_path):
    def scenario(b):
        srv = b.srv
        c = b.client()
        assert c.make_bucket("drain").status == 200
        assert c.put_object("drain", "slow", _pay(1024)).status == 200
        blocker = _Blocker(srv.object_layer, "slow")
        results = {}

        def fetch():
            results["r"] = S3Client(srv.endpoint).get_object("drain", "slow")

        t = threading.Thread(target=fetch)
        t.start()
        try:
            assert blocker.entered.wait(10.0)
            threading.Timer(0.5, blocker.release.set).start()
            srv.shutdown(drain_s=10.0)
            t.join(10.0)
            states = [sl.state for sl in srv._plane.loops]
            t0 = time.monotonic()
            srv.shutdown(drain_s=10.0)  # idempotent
            again_s = time.monotonic() - t0
            ready, _doc = srv.readiness()
            return (_norm(_res(results["r"])), states, again_s < 1.0, ready)
        finally:
            blocker.undo()
            t.join(5.0)

    got = _both(tmp_path, scenario, MINIO_TPU_SERVER_LOOPS="2")
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (["stopped"] * 2, True, False)
    assert got["port"][0][0] == 200


def test_async_plane_matches_threaded(tmp_path):
    """The port's two planes: the same answers, the same shard files."""
    payloads = {f"k{i}": _pay(BLOCK * i + 9 * i + 1, 40 + i) for i in range(4)}

    def scenario(b):
        c = b.client()
        out = [_norm(_res(c.make_bucket("plane")))]
        for k, v in payloads.items():
            out.append(_norm(_res(c.put_object("plane", k, v))))
        for k in payloads:
            out.append(_norm(_res(c.get_object("plane", k))))
            out.append(_norm(_res(c.get_object(
                "plane", k, headers={"range": "bytes=3-4100"}))))
        out.append(_norm(_res(c.list_objects("plane"))))
        out.append(_norm(_res(c.get_object("plane", "missing"))))
        return out, [_tree(r) for r in b.roots]

    got = {}
    for mode in ("async", "threaded"):
        booted = _boot("port", tmp_path, mode=mode)
        try:
            got[mode] = scenario(booted)
            assert booted.srv.server_mode == mode
        finally:
            booted.stop()
    # ListObjects carries LastModified; the rest is byte-identical
    strip = re.compile(rb"<LastModified>[^<]*</LastModified>")
    a, t = got["async"], got["threaded"]
    assert [(s, h, strip.sub(b"", b)) for s, h, b in a[0]] == [
        (s, h, strip.sub(b"", b)) for s, h, b in t[0]]
    assert a[1] == t[1]
    assert a[0][1 + len(payloads)][2] == payloads["k0"]


def test_concurrent_clients_bodies(tmp_path):
    """Four clients on keep-alive connections PUT and GET at once: every
    body comes back equal to its source on both packages' async planes
    (the port's GET hands the writer memoryviews of decoded blocks)."""
    objs = {f"c{c}/o{i}": _pay(BLOCK * (40 + 7 * i) + 13 * c, 60 + 4 * c + i)
            for c in range(4) for i in range(2)}

    def scenario(b):
        assert b.client().make_bucket("conc").status == 200
        start = threading.Barrier(4)
        got, errors = {}, []

        def client(c):
            cl = b.client()
            try:
                start.wait()
                for i in range(2):
                    k = f"c{c}/o{i}"
                    assert cl.put_object("conc", k, objs[k]).status == 200
                start.wait()  # every PUT done: the GETs read all 8
                for k in sorted(objs):
                    r = cl.get_object("conc", k)
                    got[(c, k)] = (r.status, r.body == objs[k])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        return sorted(got.items())

    got = _both(tmp_path, scenario, MINIO_TPU_SERVER_LOOPS="2")
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 4 * len(objs)
    assert all(res == (200, True) for _k, res in got["port"])
