"""SelectObjectContent on the port's S3 front held against minio_tpu's.

Two threaded servers side by side (``tests/test_torch_server.py``'s
deployment: six temp-dir disks, EC 4+2, 4 KiB blocks; the port's object
layer on the CPU), the same objects PUT to both and the same signed
``POST ?select&select-type=2`` requests sent to both.  Under
``MINIO_TPU_SELECT=host`` on both, status, headers and body (the
EventStream frames) are equal once the fresh request ids and dates are
normalized; with the port on its default engine (the device pre-filter,
run here by the plain versions of K8-K11) the Records are equal
unframed and the Stats and End frames equal.  Also: the select
admission cap and its 503, and the ``miniotpu_select_*`` families in
both Prometheus scrapes.  Exact everywhere.
"""

from __future__ import annotations

import bz2
import gzip

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.s3select import device as jdev, message as jmsg
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.s3select import device as tdev
from tests.s3client import S3Client
from tests.test_torch_server import N, _normalize, _res, _start
from tests.test_torch_threads import torch_threads  # noqa: F401

CSV = b"".join(
    f"{i},{(i * 37) % 101},{'abc'[i % 3]}x{i % 7}\n".encode()
    for i in range(1, 3000)
)
CSV = b"id,val,tag\n" + CSV
JSONL = b"".join(
    f'{{"id":{i},"tag":"t{i % 5}","v":{i * 3 % 17}}}\n'.encode()
    for i in range(400)
)

OBJECTS = {
    "data.csv": CSV,
    "quoted.csv": b'id,note\n1,"a, b"\n2,plain\n3,"x ""y"""\n',
    "data.json": JSONL,
    "data.csv.gz": gzip.compress(CSV),
    "data.csv.bz2": bz2.compress(CSV),
    "empty.csv": b"",
}


def _body(expr, inp="<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>",
          out="<CSV/>", comp=""):
    expr = expr.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    comp_xml = f"<CompressionType>{comp}</CompressionType>" if comp else ""
    return (
        "<SelectObjectContentRequest>"
        f"<Expression>{expr}</Expression><ExpressionType>SQL</ExpressionType>"
        f"<InputSerialization>{comp_xml}{inp}</InputSerialization>"
        f"<OutputSerialization>{out}</OutputSerialization>"
        "</SelectObjectContentRequest>"
    ).encode()


def _select(key, body, bucket="sel", query=None):
    return lambda c: c.request(
        "POST", f"/{bucket}/{key}",
        query=query or {"select": "", "select-type": "2"}, body=body)


JSON_IN = "<JSON><Type>LINES</Type></JSON>"
REQUESTS = {
    "star_where": _select("data.csv", _body(
        "SELECT * FROM S3Object s WHERE s.id < 120")),
    "projection_str": _select("data.csv", _body(
        "SELECT s.id, s.val FROM S3Object s WHERE s.tag = 'ax0'")),
    "between": _select("data.csv", _body(
        "SELECT s.id FROM S3Object s WHERE s.val BETWEEN 10 AND 12")),
    "in_list": _select("data.csv", _body(
        "SELECT * FROM S3Object s WHERE s.val IN (1, 2, 3, 5, 8, 13)")),
    "aggregate": _select("data.csv", _body(
        "SELECT COUNT(*), SUM(s.val), MAX(s.id) FROM S3Object s "
        "WHERE s.val > 50")),
    "limit": _select("data.csv", _body(
        "SELECT * FROM S3Object s WHERE s.val < 90 LIMIT 7")),
    "json_out": _select("data.csv", _body(
        "SELECT s.id, s.tag FROM S3Object s WHERE s.id < 40", out="<JSON/>")),
    "no_where": _select("data.csv", _body("SELECT s.tag FROM S3Object s")),
    "quoted": _select("quoted.csv", _body(
        "SELECT * FROM S3Object s WHERE s.id < 3")),
    "jsonl": _select("data.json", _body(
        "SELECT s.id FROM S3Object s WHERE s.v = 4", inp=JSON_IN,
        out="<JSON/>")),
    "gzip": _select("data.csv.gz", _body(
        "SELECT s.id FROM S3Object s WHERE s.val = 7", comp="GZIP")),
    "bzip2": _select("data.csv.bz2", _body(
        "SELECT COUNT(*) FROM S3Object s WHERE s.tag = 'bx1'", comp="BZIP2")),
    "empty_object": _select("empty.csv", _body("SELECT * FROM S3Object")),
    "bad_sql": _select("data.csv", _body("SELEKT nothing")),
    "bad_cast": _select("data.csv", _body(
        "SELECT CAST(s.tag AS INT) FROM S3Object s")),
    "malformed_xml": _select("data.csv", b"<SelectObjectContentRequest"),
    "empty_body": _select("data.csv", b""),
    "bad_compression": _select("data.csv", _body(
        "SELECT * FROM S3Object", comp="ZSTD")),
    "not_gzip": _select("data.csv", _body("SELECT * FROM S3Object",
                                          comp="GZIP")),
    "missing_key": _select("ghost.csv", _body("SELECT * FROM S3Object")),
    "missing_bucket": _select("data.csv", _body("SELECT * FROM S3Object"),
                              bucket="nobkt"),
    "select_without_type": _select("data.csv", _body(
        "SELECT s.id FROM S3Object s WHERE s.id < 5"), query={"select": ""}),
}


def _frames(body: bytes):
    msgs = jmsg.decode_all(body)
    recs = b"".join(m["payload"] for m in msgs
                    if m["headers"].get(":event-type") == "Records")
    return recs, [(m["headers"], m["payload"]) for m in msgs
                  if m["headers"].get(":event-type") != "Records"]


def _scrape_select(c: S3Client) -> list:
    body = c.request("GET", "/minio-tpu/prometheus/metrics").body
    return [ln for ln in body.decode().splitlines()
            if ln.startswith("miniotpu_select_")]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("select-servers")
        out = {}
        try:
            for kind in ("jax", "port"):
                srv = _start(kind, [str(base / f"{kind}{i}") for i in range(N)])
                c = S3Client(srv.endpoint)
                assert c.make_bucket("sel").status == 200
                for key, data in OBJECTS.items():
                    assert c.put_object("sel", key, data).status == 200
                out[kind] = (srv, c)
            yield out
        finally:
            for srv, _c in out.values():
                srv.shutdown()
            jbackend.reset_backend()
            tbackend.reset_backend()


@pytest.mark.parametrize("name", list(REQUESTS))
def test_host_engine_responses_equal(servers, monkeypatch, name):
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    got = {kind: _normalize(_res(REQUESTS[name](c)))
           for kind, (_srv, c) in servers.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_device_engine_answers_as_the_host_engine(servers, monkeypatch, name):
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    js, jh, jb = _normalize(_res(REQUESTS[name](servers["jax"][1])))
    monkeypatch.delenv("MINIO_TPU_SELECT")
    ts, th, tb = _normalize(_res(REQUESTS[name](servers["port"][1])))
    assert (ts, {k: v for k, v in th.items() if k != "content-length"}) == (
        js, {k: v for k, v in jh.items() if k != "content-length"})
    if ts == 200:
        assert _frames(tb) == _frames(jb)
    else:
        assert tb == jb


def test_the_device_engine_screened(servers, monkeypatch):
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
    before = tdev.STATS.snapshot()["requests"]["device"]
    r = REQUESTS["star_where"](servers["port"][1])
    assert r.status == 200
    assert tdev.STATS.snapshot()["requests"]["device"] == before + 1


def test_select_admission_cap_sheds_alike(servers, monkeypatch):
    """At MINIO_TPU_SELECT_MAX_INFLIGHT=1 with the one slot taken, both
    servers shed the scan with the same 503 and count reason select."""
    monkeypatch.setenv("MINIO_TPU_SELECT_MAX_INFLIGHT", "1")
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    got = {}
    for kind, (srv, c) in servers.items():
        assert srv.admission.try_enter_select()
        try:
            got[kind] = _normalize(_res(REQUESTS["star_where"](c)))
        finally:
            srv.admission.leave_select()
        assert srv.admission.select_inflight() == 0
        assert REQUESTS["limit"](c).status == 200  # the slot is free again
    assert got["port"] == got["jax"]
    assert got["port"][0] == 503 and b"<Code>SlowDown</Code>" in got["port"][2]


def test_select_metric_families(servers, monkeypatch):
    """The same requests under the host engine move the same counters
    by the same amounts; the families and their label sets are equal
    (every engine and reason zero-filled)."""
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jdev.STATS.reset()
    tdev.STATS.reset()
    for name in ("star_where", "aggregate", "jsonl", "gzip"):
        for _srv, c in servers.values():
            REQUESTS[name](c)
    jl, tl = (_scrape_select(servers[k][1]) for k in ("jax", "port"))
    assert tl == jl
    names = {ln.split("{")[0].split(" ")[0] for ln in tl}
    assert names == {
        "miniotpu_select_requests_total", "miniotpu_select_fallback_total",
        "miniotpu_select_scanned_bytes_total",
        "miniotpu_select_returned_bytes_total",
        "miniotpu_select_device_seconds_total",
    }
    # the JSON-lines projection is a row-engine scan; the others host
    assert 'miniotpu_select_requests_total{engine="host"} 3' in tl
    assert 'miniotpu_select_requests_total{engine="row"} 1' in tl
    # the port's default engine screens on its device and counts it
    monkeypatch.delenv("MINIO_TPU_SELECT")
    REQUESTS["star_where"](servers["port"][1])
    tl = _scrape_select(servers["port"][1])
    assert 'miniotpu_select_requests_total{engine="device"} 1' in tl
    assert any(ln.startswith("miniotpu_select_device_seconds_total ")
               and float(ln.split()[-1]) > 0 for ln in tl)


def test_async_plane_serves_select_through_the_same_handler(
        servers, monkeypatch, tmp_path):
    """The port on its async request plane answers the same selects as
    the JAX threaded server (host engine there, the default here)."""
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    monkeypatch.setenv("MINIO_TPU_SERVER", "async")
    monkeypatch.setenv("MINIO_TPU_SERVER_LOOPS", "1")
    ol = ErasureObjects([XLStorage(str(tmp_path / f"a{i}")) for i in range(N)],
                        parity_blocks=2, block_size=4096, device="cpu")
    srv = S3Server(ol, address="127.0.0.1:0").start()
    try:
        assert srv.server_mode == "async"
        c = S3Client(srv.endpoint)
        assert c.make_bucket("sel").status == 200
        assert c.put_object("sel", "data.csv", CSV).status == 200
        for name in ("star_where", "aggregate", "in_list", "bad_sql"):
            monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
            ts, _th, tb = _normalize(_res(REQUESTS[name](c)))
            monkeypatch.setenv("MINIO_TPU_SELECT", "host")
            js, _jh, jb = _normalize(_res(REQUESTS[name](servers["jax"][1])))
            assert ts == js
            assert (_frames(tb) == _frames(jb)) if ts == 200 else tb == jb
    finally:
        srv.shutdown()
