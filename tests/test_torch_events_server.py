"""Bucket event notification on the port's S3 front, held against
minio_tpu's over real HTTP.

A JAX and a port ``S3Server`` (threaded plane, EC 4+2 over six temp-dir
disks, the port on ``device="cpu"``) are built from the same
``MINIO_TPU_NOTIFY_*`` environment, each with a webhook target pointing
at a loopback sink of its own and a log-file target.  The same signed
requests go to both:

* ``GET``/``PUT ?notification``: the stored and the default documents
  byte-equal, and the answers to an unknown ARN, a bad event name and
  malformed XML;
* the records of PUT, CopyObject, CompleteMultipartUpload, a POST-policy
  upload, GET, HEAD, DELETE and a multi-delete, as the webhook sink
  received them and as the log file holds them, equal once the event
  time, the origin endpoint and the version id are normalized;
* the ListenBucketNotification stream (``GET ?events``): the same lines
  for the same writes, with the prefix filter applied;
* the listen route's bad event name, missing bucket and missing
  permission answers (``tests/test_events.py``);
* the rules reloaded from the stored document after the notifier forgot
  them, and the port's own admin ``listen-stats``.
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import re
import threading
import time
import urllib.parse

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.iam.policy import Policy as JPolicy
from minio_tpu.iam.sys import IAMSys as JIAM
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JObjects
from minio_tpu.server import auth as jauth
from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage.xl import XLStorage as JXL
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.iam.policy import Policy as TPolicy
from minio_tpu_torch.iam.sys import IAMSys as TIAM
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects as TObjects
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage.xl import XLStorage as TXL
from tests.s3client import S3Client
from tests.test_torch_server import _normalize, _pay, _res
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 4096
KINDS = ("jax", "port")
HOOK_ARN = "arn:minio:sqs::W:webhook"
LOG_ARN = "arn:minio:sqs::L:logfile"


def _cfg(arn: str, events=("s3:ObjectCreated:*", "s3:ObjectRemoved:*",
                           "s3:ObjectAccessed:*"), prefix="") -> bytes:
    ev = "".join(f"<Event>{e}</Event>" for e in events)
    flt = (f"<Filter><S3Key><FilterRule><Name>prefix</Name><Value>{prefix}"
           "</Value></FilterRule></S3Key></Filter>") if prefix else ""
    return (f"<NotificationConfiguration><QueueConfiguration><Id>q1</Id>"
            f"<Queue>{arn}</Queue>{ev}{flt}</QueueConfiguration>"
            "</NotificationConfiguration>").encode()


class _Sink(http.server.ThreadingHTTPServer):
    """A webhook endpoint recording each POSTed record."""

    daemon_threads = True

    def __init__(self):
        self.records = []
        super().__init__(("127.0.0.1", 0), _SinkHandler)
        threading.Thread(target=self.serve_forever, daemon=True).start()


class _SinkHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.records.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{kind: (server, client, sink, log path)}; bucket ``evb``."""
    base = tmp_path_factory.mktemp("events")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        for kind in KINDS:
            sink = _Sink()
            log = base / f"{kind}-events.jsonl"
            mp.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_W", "on")
            mp.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_W",
                      f"http://127.0.0.1:{sink.server_address[1]}/hook")
            mp.setenv("MINIO_TPU_NOTIFY_LOGFILE_ENABLE_L", "on")
            mp.setenv("MINIO_TPU_NOTIFY_LOGFILE_PATH_L", str(log))
            roots = [str(base / f"{kind}{i}") for i in range(N)]
            if kind == "jax":
                ol = JObjects([JXL(r) for r in roots], parity_blocks=M,
                              block_size=BLOCK)
                iam = JIAM("minioadmin", "minioadmin", ol)
                srv = JS3Server(ol, address="127.0.0.1:0", iam=iam).start()
            else:
                ol = TObjects([TXL(r) for r in roots], parity_blocks=M,
                              block_size=BLOCK, device="cpu")
                iam = TIAM("minioadmin", "minioadmin", ol)
                srv = TS3Server(ol, address="127.0.0.1:0", iam=iam).start()
            c = S3Client(srv.endpoint)
            assert c.make_bucket("evb").status == 200
            out[kind] = (srv, c, sink, log)
        try:
            yield out
        finally:
            for srv, _c, sink, _log in out.values():
                srv.shutdown()
                sink.shutdown()
                sink.server_close()
            jbackend.reset_backend()
            tbackend.reset_backend()


def _norm_record(rec: dict) -> dict:
    """A record with its time, origin endpoint and version id blanked."""
    rec = json.loads(json.dumps(rec))
    for r in rec.get("Records", [rec]):
        if "eventTime" in r:
            r["eventTime"] = "T"
            r["responseElements"]["x-minio-origin-endpoint"] = "E"
            r["s3"]["object"]["versionId"] = "V"
    return rec


def _await(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_notification_documents_equal(servers):
    got = {}
    for kind, (srv, c, _sink, _log) in servers.items():
        steps = [
            c.request("GET", "/evb", query={"notification": ""}),
            c.request("PUT", "/evb", query={"notification": ""},
                      body=_cfg("arn:minio:sqs::nope:webhook")),
            c.request("PUT", "/evb", query={"notification": ""},
                      body=_cfg(HOOK_ARN, events=("s3:Bogus:*",))),
            c.request("PUT", "/evb", query={"notification": ""},
                      body=b"<NotificationConfiguration><Queue"),
            c.request("GET", "/nobucket", query={"notification": ""}),
            c.request("PUT", "/evb", query={"notification": ""},
                      body=_cfg(HOOK_ARN, prefix="docs/")),
            c.request("GET", "/evb", query={"notification": ""}),
            c.request("PUT", "/evb", query={"notification": ""},
                      body=b"<NotificationConfiguration/>"),
            c.request("GET", "/evb", query={"notification": ""}),
        ]
        doc = srv.bucket_meta.get("evb").notification_xml
        got[kind] = ([_normalize(_res(r)) for r in steps], doc)
    assert got["port"] == got["jax"]
    answers = got["port"][0]
    assert [a[0] for a in answers] == [200, 400, 400, 400, 404, 200, 200,
                                      200, 200]
    assert b"<Prefix>" not in answers[6][2] and b"docs/" in answers[6][2]


def _event_traffic(c: S3Client) -> None:
    """Every write and read path that fires an event, in one order."""
    assert c.put_object("evb", "a.txt", _pay(5000, 1)).status == 200
    assert c.put_object("evb", "sp ace/ü.bin", b"x").status == 200
    r = c.request("PUT", "/evb/copy.txt",
                  headers={"x-amz-copy-source": "/evb/a.txt"})
    assert r.status == 200
    r = c.request("POST", "/evb/mp", query={"uploads": ""})
    uid = re.search(rb"<UploadId>([^<]+)</UploadId>", r.body).group(1).decode()
    part = _pay(6000, 2)
    r = c.request("PUT", "/evb/mp", query={"partNumber": "1", "uploadId": uid},
                  body=part)
    etag = r.headers["etag"]
    body = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>").encode()
    assert c.request("POST", "/evb/mp", query={"uploadId": uid},
                     body=body).status == 200
    assert _res(c.post_policy_upload("evb", "posted", b"form"))[0] in (200, 204)
    assert c.get_object("evb", "a.txt").status == 200
    assert c.request("HEAD", "/evb/copy.txt").status == 200
    assert c.delete_object("evb", "copy.txt").status == 204
    r = c.request("POST", "/evb", query={"delete": ""},
                  body=b"<Delete><Object><Key>posted</Key></Object>"
                  b"<Object><Key>mp</Key></Object></Delete>")
    assert r.status == 200


def test_records_equal(servers):
    got = {}
    for kind, (srv, c, sink, log) in servers.items():
        assert c.request("PUT", "/evb", query={"notification": ""},
                         body=_cfg(HOOK_ARN)).status == 200
        sink.records.clear()
        _event_traffic(c)
        assert srv.events.flush()
        _await(lambda: len(sink.records) >= 10, "webhook records")
        time.sleep(0.2)
        hook = [_norm_record(r) for r in sink.records]
        # the log-file target takes the same records under its own ARN
        assert c.request("PUT", "/evb", query={"notification": ""},
                         body=_cfg(LOG_ARN)).status == 200
        _event_traffic(c)
        assert srv.events.flush()
        _await(lambda: os.path.exists(log) and
               len(log.read_bytes().splitlines()) >= 10, "log-file records")
        time.sleep(0.2)
        lines = [_norm_record(json.loads(x)) for x in log.read_bytes().splitlines()]
        assert c.request("PUT", "/evb", query={"notification": ""},
                         body=b"<NotificationConfiguration/>").status == 200
        got[kind] = (hook, lines)
    assert got["port"] == got["jax"]
    hook, lines = got["port"]
    names = [r["EventName"] for r in hook]
    assert names == [
        "s3:ObjectCreated:Put", "s3:ObjectCreated:Put", "s3:ObjectCreated:Copy",
        "s3:ObjectCreated:CompleteMultipartUpload", "s3:ObjectCreated:Post",
        "s3:ObjectAccessed:Get", "s3:ObjectAccessed:Head",
        "s3:ObjectRemoved:Delete", "s3:ObjectRemoved:Delete",
        "s3:ObjectRemoved:Delete"]
    assert [r["EventName"] for r in lines] == names
    assert hook[1]["Records"][0]["s3"]["object"]["key"] == "sp%20ace/%C3%BC.bin"


def _listen(srv, bucket: str, query: dict, lines: list, opened: threading.Event):
    """Read a ListenBucketNotification stream (a presigned GET) into
    ``lines`` until the server closes it."""
    host, port = srv.endpoint.split("//")[1].rsplit(":", 1)
    sign = jauth.presign_url
    url = sign("GET", f"{srv.endpoint}/{bucket}?" + urllib.parse.urlencode(query),
               "minioadmin", "minioadmin")
    pr = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", f"{pr.path}?{pr.query}")
        resp = conn.getresponse()
        opened.set()
        if resp.status != 200:
            lines.append(("status", resp.status, resp.read()))
            return
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    lines.append(json.loads(line))
    except (OSError, http.client.HTTPException):
        pass
    finally:
        conn.close()


def test_listen_stream_lines_equal(servers):
    got = {}
    for kind, (srv, c, _sink, _log) in servers.items():
        lines: list = []
        opened = threading.Event()
        t = threading.Thread(target=_listen, daemon=True, args=(
            srv, "evb", {"events": "s3:ObjectCreated:*,s3:ObjectRemoved:*",
                         "prefix": "logs/"}, lines, opened))
        t.start()
        _await(lambda: srv.events.has_listeners("evb"), "the subscription")
        assert c.put_object("evb", "other/x", b"1").status == 200
        assert c.put_object("evb", "logs/app.log", b"22").status == 200
        assert c.get_object("evb", "logs/app.log").status == 200
        assert c.request("PUT", "/evb/logs/copy.log",
                         headers={"x-amz-copy-source": "/evb/logs/app.log"}
                         ).status == 200
        assert c.delete_object("evb", "logs/app.log").status == 204
        _await(lambda: len(lines) >= 3, "listen lines")
        time.sleep(0.3)  # any wrong extra line would land by now
        # the stream ends when the listener goes: stop it through the
        # server's drain flag, as shutdown does
        srv.draining = True
        t.join(timeout=5)
        srv.draining = False
        assert not t.is_alive()
        _await(lambda: not srv.events.has_listeners("evb"), "the unsubscribe")
        got[kind] = [_norm_record(x) for x in lines]
    assert got["port"] == got["jax"]
    assert [(x["EventName"], x["Key"]) for x in got["port"]] == [
        ("s3:ObjectCreated:Put", "evb/logs/app.log"),
        ("s3:ObjectCreated:Copy", "evb/logs/copy.log"),
        ("s3:ObjectRemoved:Delete", "evb/logs/app.log")]


@pytest.mark.parametrize("bucket,query", [
    ("evb", {"events": "s3:NotAThing"}),
    ("evb", {"events": "s3:ObjectCreated:*,s3:Nope:Put"}),
    ("missing-bkt", {"events": ""}),
])
def test_listen_rejects_bad_requests(servers, bucket, query):
    got = {k: _normalize(_res(c.request("GET", f"/{bucket}", query=query)))
           for k, (_s, c, _k, _l) in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] in (400, 404)


def test_listen_requires_listen_permission(servers):
    """``?location&events`` authorizes as the sub-resource that serves
    it (listen), not the weaker first match."""
    doc = json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Action": "s3:GetBucketLocation",
                       "Resource": "arn:aws:s3:::evb"}],
    })
    got = {}
    for kind, (srv, _c, _sink, _log) in servers.items():
        policy = JPolicy if kind == "jax" else TPolicy
        srv.iam.add_user("loconly", "loconly-secret-123", "")
        srv.iam.set_policy("loconly-pol", policy.from_json(doc))
        srv.iam.set_user_policy("loconly", "loconly-pol")
        c = S3Client(srv.endpoint, "loconly", "loconly-secret-123")
        got[kind] = [
            _normalize(_res(c.request("GET", "/evb", query={"location": ""}))),
            _normalize(_res(c.request(
                "GET", "/evb",
                query={"location": "", "events": "s3:ObjectCreated:*"}))),
        ]
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == [200, 403]


def test_notification_survives_restart_of_rules(servers):
    """The rules load lazily from the stored document: after the
    server forgets them (a peer's invalidation), the next write still
    fires - on both."""
    got = {}
    for kind, (srv, c, sink, _log) in servers.items():
        assert c.request("PUT", "/evb", query={"notification": ""},
                         body=_cfg(HOOK_ARN, events=("s3:ObjectCreated:Put",))
                         ).status == 200
        srv.invalidate_event_rules("evb")
        srv.events.remove_bucket("evb")
        sink.records.clear()
        assert c.put_object("evb", "again", b"v").status == 200
        assert srv.events.flush()
        _await(lambda: len(sink.records) >= 1, "the record")
        got[kind] = [_norm_record(r) for r in sink.records]
        assert c.request("PUT", "/evb", query={"notification": ""},
                         body=b"<NotificationConfiguration/>").status == 200
    assert got["port"] == got["jax"]
    assert [r["Key"] for r in got["port"]] == ["evb/again"]


def test_listen_stats_route(servers, tmp_path):
    """The port's own admin ``listen-stats`` counts a live stream's
    subscription, and the peers' remote listeners its peer plane holds."""
    from minio_tpu_torch.cluster import peer as tpeer

    srv, c, _sink, _log = servers["port"]
    admin = "/minio-tpu/admin/v1/listen-stats"
    assert json.loads(c.request("GET", admin).body) == {
        "subscriptions": 0, "remote": 0, "remote_buckets": []}
    lines: list = []
    opened = threading.Event()
    t = threading.Thread(target=_listen, daemon=True, args=(
        srv, "evb", {"events": "s3:ObjectCreated:*"}, lines, opened))
    t.start()
    _await(lambda: srv.events.has_listeners("evb"), "the subscription")
    plane = tpeer.PeerRESTServer(srv, "secret")
    srv.peer_rest = plane
    try:
        plane._listen_on({}, tpeer._pack({"id": "w1", "bucket": "evb"}))
        doc = json.loads(c.request("GET", admin).body)
        assert doc == {"subscriptions": 2, "remote": 1,
                       "remote_buckets": ["evb"]}
    finally:
        plane.close()
        srv.peer_rest = None
        srv.draining = True
        t.join(timeout=5)
        srv.draining = False
    _await(lambda: not srv.events.has_listeners("evb"), "the unsubscribe")
    assert json.loads(c.request("GET", admin).body)["subscriptions"] == 0
