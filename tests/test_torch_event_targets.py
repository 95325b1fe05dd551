"""The port's notification targets and queue store against the JAX
package's (event/targets.py, event/queuestore.py, event/brokers.py).

* The queue store's FIFO and limit, the queued target's recovery, its
  order behind a backlog and its replay after a restart, run on both
  packages (``tests/test_event_targets.py`` for the JAX package alone).
* With the clock and the key suffix pinned, both stores write the same
  queue files, name for name and byte for byte, and each package's
  queued target replays a directory the other one wrote.
* Redis (RESP ``RPUSH``, with ``AUTH``), NATS (``CONNECT``, ``PUB``,
  ``PING``) and the webhook's ``POST`` put the same bytes on the wire for
  the same records, against in-process sinks speaking each protocol;
  Kafka hands its injected producer the same messages; the log-file
  target writes the same file.
* ``targets_from_env`` builds the same list from the same environment:
  kinds, ids, ARNs, endpoints and the queue-store wrapping.
"""

from __future__ import annotations

import http.server
import itertools
import json
import os
import socketserver
import threading
import time
import uuid

import pytest

from minio_tpu.event import brokers as jbrokers
from minio_tpu.event import queuestore as jqueue
from minio_tpu.event import targets as jtargets
from minio_tpu_torch.event import brokers as tbrokers
from minio_tpu_torch.event import queuestore as tqueue
from minio_tpu_torch.event import targets as ttargets
from tests.test_torch_threads import torch_threads  # noqa: F401

PKGS = {
    "jax": (jtargets, jqueue, jbrokers),
    "port": (ttargets, tqueue, tbrokers),
}
KINDS = sorted(PKGS)
RECORDS = [
    {"EventName": "s3:ObjectCreated:Put", "Key": "b/k", "Records": []},
    {"EventName": "s3:ObjectRemoved:Delete", "Key": "b/ü ñ", "n": 2},
    {"EventName": "s3:ObjectCreated:Copy", "Key": "", "Records": [{"a": 1}]},
]


class FlakyTarget:
    """Fails until .up is True; counts deliveries."""

    def __init__(self, error):
        self.id = "flaky"
        self.arn = "arn:minio:sqs::flaky:test"
        self.up = False
        self.records = []
        self._error = error

    def send(self, record):
        if not self.up:
            raise self._error("down")
        self.records.append(record)

    def close(self):
        pass


def _flaky(kind):
    return FlakyTarget(PKGS[kind][0].TargetError)


# -- queue store ----------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_store_fifo_roundtrip(tmp_path, kind):
    st = PKGS[kind][1].QueueStore(str(tmp_path / "q"))
    keys = [st.put({"n": i}) for i in range(5)]
    assert st.count() == 5
    assert st.list() == sorted(keys)
    assert [st.get(k)["n"] for k in st.list()] == [0, 1, 2, 3, 4]
    st.delete(keys[0])
    assert st.count() == 4


@pytest.mark.parametrize("kind", KINDS)
def test_store_limit(tmp_path, kind):
    mod = PKGS[kind][1]
    st = mod.QueueStore(str(tmp_path / "q"), limit=3)
    for i in range(3):
        st.put({"n": i})
    with pytest.raises(mod.StoreFull):
        st.put({"n": 99})


@pytest.mark.parametrize("kind", KINDS)
def test_queued_target_delivers_after_recovery(tmp_path, kind):
    inner = _flaky(kind)
    qt = PKGS[kind][1].QueuedTarget(inner, str(tmp_path / "q"),
                                    retry_interval_s=0.05)
    try:
        for i in range(4):
            qt.send({"n": i})  # all parked (target down)
        assert qt.store.count() == 4
        assert inner.records == []
        inner.up = True
        deadline = time.monotonic() + 5
        while qt.store.count() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [r["n"] for r in inner.records] == [0, 1, 2, 3]
    finally:
        qt.close()


@pytest.mark.parametrize("kind", KINDS)
def test_queued_target_preserves_order_with_backlog(tmp_path, kind):
    inner = _flaky(kind)
    qt = PKGS[kind][1].QueuedTarget(inner, str(tmp_path / "q"),
                                    retry_interval_s=999)
    try:
        qt.send({"n": 0})  # parked
        inner.up = True
        qt.send({"n": 1})  # must queue BEHIND the backlog
        assert inner.records == []
        assert qt.store.count() == 2
        assert qt.replay_once() == 2
        assert [r["n"] for r in inner.records] == [0, 1]
    finally:
        qt.close()


@pytest.mark.parametrize("writer,reader", list(itertools.product(KINDS, KINDS)))
def test_queued_target_survives_restart(tmp_path, writer, reader):
    """A record parked by one package's queued target is replayed by a
    new wrapper over the same directory - of either package."""
    qdir = str(tmp_path / "q")
    qt = PKGS[writer][1].QueuedTarget(_flaky(writer), qdir,
                                      retry_interval_s=999)
    qt.send({"n": 7})
    qt.close()
    inner2 = _flaky(reader)
    inner2.up = True
    qt2 = PKGS[reader][1].QueuedTarget(inner2, qdir, retry_interval_s=999)
    try:
        assert qt2.store.count() == 1
        assert qt2.replay_once() == 1
        assert inner2.records == [{"n": 7}]
        assert os.listdir(qdir) == []
    finally:
        qt2.close()


def _pinned(monkeypatch):
    """Pin the store's key source: the clock and the uuid suffix."""
    ns = itertools.count(1_700_000_000_000_000_000, 1000)
    ids = itertools.count(1)
    monkeypatch.setattr(time, "time_ns", lambda: next(ns))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))


def test_queue_files_byte_equal(tmp_path, monkeypatch):
    """The same records parked in each package's store give the same
    file names and the same bytes in each file."""
    files = {}
    for kind in KINDS:
        _pinned(monkeypatch)
        qdir = tmp_path / kind
        qt = PKGS[kind][1].QueuedTarget(_flaky(kind), str(qdir),
                                        retry_interval_s=999)
        try:
            for rec in RECORDS:
                qt.send(rec)
        finally:
            qt.close()
        files[kind] = {n: (qdir / n).read_bytes() for n in sorted(os.listdir(qdir))}
    assert len(files["port"]) == len(RECORDS)
    assert files["port"] == files["jax"]


# -- redis and nats: raw bytes on the wire ----------------------------------


class _Sink(socketserver.ThreadingTCPServer):
    """A loopback server that records every byte a client sent."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, handler):
        self.raw = bytearray()
        self.items = []
        super().__init__(("127.0.0.1", 0), handler)
        self._t = threading.Thread(target=self.serve_forever, daemon=True)
        self._t.start()

    @property
    def addr(self) -> str:
        host, port = self.server_address
        return f"{host}:{port}"

    def stop(self):
        self.shutdown()
        self.server_close()


class _RedisHandler(socketserver.StreamRequestHandler):
    def _line(self):
        line = self.rfile.readline()
        self.server.raw += line
        return line

    def handle(self):
        while True:
            line = self._line()
            if not line or not line.startswith(b"*"):
                return
            args = []
            for _ in range(int(line[1:])):
                n = int(self._line()[1:])
                data = self.rfile.read(n + 2)
                self.server.raw += data
                args.append(data[:-2])
            cmd = args[0].upper()
            if cmd == b"RPUSH":
                self.server.items.append((args[1], args[2]))
                self.wfile.write(b":%d\r\n" % len(self.server.items))
            elif cmd == b"AUTH":
                self.wfile.write(b"+OK\r\n")
            else:
                self.wfile.write(b"-ERR unknown\r\n")
            self.wfile.flush()


class _NATSHandler(socketserver.StreamRequestHandler):
    def handle(self):
        self.wfile.write(b'INFO {"server_id":"fake"}\r\n')
        self.wfile.flush()
        while True:
            line = self.rfile.readline()
            self.server.raw += line
            if not line:
                return
            if line.startswith(b"PUB"):
                parts = line.split()
                payload = self.rfile.read(int(parts[2]) + 2)
                self.server.raw += payload
                self.server.items.append((parts[1], payload[:-2]))
            elif line.startswith(b"PING"):
                self.wfile.write(b"PONG\r\n")
                self.wfile.flush()


def _wire(kind, build, handler):
    sink = _Sink(handler)
    try:
        target = build(PKGS[kind][2], sink.addr)
        for rec in RECORDS:
            target.send(rec)
        target.close()
        deadline = time.monotonic() + 5
        while len(sink.items) < len(RECORDS) and time.monotonic() < deadline:
            time.sleep(0.01)
        return bytes(sink.raw), list(sink.items)
    finally:
        sink.stop()


@pytest.mark.parametrize("password", ["", "s3cr3t"])
def test_redis_wire_bytes_equal(password):
    got = {k: _wire(k, lambda m, a: m.RedisTarget("r1", a, key="evts",
                                                  password=password),
                    _RedisHandler) for k in KINDS}
    assert got["port"] == got["jax"]
    raw, items = got["port"]
    assert [k for k, _ in items] == [b"evts"] * len(RECORDS)
    assert [json.loads(v) for _, v in items] == RECORDS
    assert raw.startswith(b"*2\r\n$4\r\nAUTH\r\n" if password else b"*3\r\n$5\r\nRPUSH")


def test_nats_wire_bytes_equal():
    got = {k: _wire(k, lambda m, a: m.NATSTarget("n1", a, subject="evts"),
                    _NATSHandler) for k in KINDS}
    assert got["port"] == got["jax"]
    raw, items = got["port"]
    assert raw.startswith(b'CONNECT {"verbose":false}\r\nPUB evts ')
    assert [json.loads(v) for _, v in items] == RECORDS


@pytest.mark.parametrize("kind", KINDS)
def test_broker_down_raises(kind):
    targets, _q, brokers = PKGS[kind]
    for t in (brokers.RedisTarget("r2", "127.0.0.1:1", timeout=0.2),
              brokers.NATSTarget("n2", "127.0.0.1:1", timeout=0.2)):
        with pytest.raises(targets.TargetError):
            t.send(RECORDS[0])
    with pytest.raises(targets.TargetError):
        brokers.RedisTarget("r3", "nohostport")


class _Producer:
    def __init__(self):
        self.messages = []
        self.closed = False

    def produce(self, topic, key, value):
        self.messages.append((topic, key, value))

    def close(self):
        self.closed = True


def test_kafka_messages_equal():
    got = {}
    for kind in KINDS:
        targets, _q, brokers = PKGS[kind]
        prod = _Producer()
        t = brokers.KafkaTarget("k1", "events-topic", producer=prod)
        for rec in RECORDS:
            t.send(rec)
        t.close()
        assert prod.closed
        # an unconfigured producer fails loudly (the store parks it)
        with pytest.raises(targets.TargetError):
            brokers.KafkaTarget("k2", "t").send(RECORDS[0])
        got[kind] = prod.messages
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == ("events-topic", b"b/k")


# -- webhook and log file ------------------------------------------------------


class _HookHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.items.append(
            (self.command, self.path, sorted(self.headers.items()), body))
        code = self.server.status
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _hook_server(status=200):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _HookHandler)
    srv.items = []
    srv.status = status
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_webhook_requests_equal():
    srv = _hook_server()
    try:
        got = {}
        port = srv.server_address[1]
        for kind in KINDS:
            srv.items.clear()
            t = PKGS[kind][0].WebhookTarget(
                "W", f"http://127.0.0.1:{port}/hook?x=1")
            assert t.arn == "arn:minio:sqs::W:webhook"
            for rec in RECORDS:
                t.send(rec)
            t.close()
            got[kind] = [(m, p, [(k, v.replace(str(port), "PORT")) for k, v in h], b)
                         for m, p, h, b in srv.items]
        assert got["port"] == got["jax"]
        assert [json.loads(b) for *_x, b in got["port"]] == RECORDS
        assert got["port"][0][1] == "/hook?x=1"
        srv.status = 500
        for kind in KINDS:
            t = PKGS[kind][0].WebhookTarget("W", f"http://127.0.0.1:{port}/h")
            with pytest.raises(PKGS[kind][0].TargetError, match="HTTP 500"):
                t.send(RECORDS[0])
            t.close()
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("kind", KINDS)
def test_webhook_unreachable_and_bad_endpoint(kind):
    targets = PKGS[kind][0]
    t = targets.WebhookTarget("W", "http://127.0.0.1:1/hook", timeout=0.5)
    with pytest.raises(targets.TargetError, match="unreachable"):
        t.send(RECORDS[0])
    with pytest.raises(targets.TargetError):
        targets.WebhookTarget("W", "ftp://host/x")


def test_logfile_and_memory_targets_equal(tmp_path):
    got = {}
    for kind in KINDS:
        targets = PKGS[kind][0]
        path = tmp_path / f"{kind}.log"
        lf = targets.LogFileTarget("L", str(path))
        mem = targets.MemoryTarget()
        for rec in RECORDS:
            lf.send(rec)
            mem.send(rec)
        lf.close()
        got[kind] = (lf.arn, path.read_bytes(), mem.arn, mem.records)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "arn:minio:sqs::L:logfile"


# -- env wiring -----------------------------------------------------------


def _describe(t) -> tuple:
    inner = getattr(t, "inner", None)
    core = inner if inner is not None else t
    fields = tuple(
        getattr(core, f, None)
        for f in ("endpoint", "path", "host", "port", "key", "password",
                  "subject"))
    return (type(t).__name__, type(core).__name__, t.id, t.arn, fields,
            os.path.basename(t.store.dir) if inner is not None else None)


def test_targets_from_env_builds_the_same_list(tmp_path):
    env = {
        "MINIO_TPU_NOTIFY_REDIS_ENABLE_R": "on",
        "MINIO_TPU_NOTIFY_REDIS_ADDRESS_R": "127.0.0.1:6379",
        "MINIO_TPU_NOTIFY_REDIS_KEY_R": "bucketevents",
        "MINIO_TPU_NOTIFY_NATS_ENABLE_N": "on",
        "MINIO_TPU_NOTIFY_NATS_ADDRESS_N": "127.0.0.1:4222",
        "MINIO_TPU_NOTIFY_NATS_QUEUE_DIR_N": str(tmp_path / "natsq"),
        "MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_W": "on",
        "MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_W": "http://127.0.0.1:9/x",
        "MINIO_TPU_NOTIFY_WEBHOOK_QUEUE_DIR_W": str(tmp_path / "hookq"),
        "MINIO_TPU_NOTIFY_LOGFILE_ENABLE_L": "on",
        "MINIO_TPU_NOTIFY_LOGFILE_PATH_L": str(tmp_path / "ev.log"),
        # skipped alike: off, no endpoint, a malformed endpoint, a kind
        # neither package knows
        "MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_OFF": "off",
        "MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_NOEP": "on",
        "MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_BAD": "on",
        "MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_BAD": "gopher://x",
        "MINIO_TPU_NOTIFY_AMQP_ENABLE_A": "on",
    }
    got = {}
    for kind in KINDS:
        targets = PKGS[kind][0].targets_from_env(env)
        try:
            got[kind] = [_describe(t) for t in targets]
        finally:
            for t in targets:
                t.close()
    assert got["port"] == got["jax"]
    assert [g[3] for g in got["port"]] == [
        "arn:minio:sqs::L:logfile", "arn:minio:sqs::N:nats",
        "arn:minio:sqs::R:redis", "arn:minio:sqs::W:webhook"]
    assert [g[0] for g in got["port"]] == [
        "LogFileTarget", "QueuedTarget", "RedisTarget", "QueuedTarget"]
    assert ttargets.targets_from_env({}) == []
