"""The port's S3 gateway held against minio_tpu's.

Every case of ``tests/test_gateway.py`` runs on three pairs of
(gateway, upstream): a port gateway in front of a port upstream, a port
gateway in front of a JAX upstream and a JAX gateway in front of a port
upstream; each pair's answers, reduced to plain data, must equal the
JAX gateway's in front of a JAX upstream.  An upstream is an erasure
``S3Server`` over four temp-dir drives (the port's with
``device="cpu"``); the front servers of the chain cases are the
gateway's package's ``S3Server`` over its ``S3Objects``.  Compared apart,
as first-seen placeholders: version ids and upload ids (random per
run); modification times are dropped (each run writes at its own
instant), and so are the ETags of encrypted objects (the upstream's
random package nonces); responses over HTTP are normalized as
``tests/test_torch_server.py`` normalizes them.

Beyond the cases: the two upstream clients' requests are byte-equal
(method, URL, headers with the signature, body) under a pinned clock;
a Select through a port gateway scans on the gateway server's device and
returns the Records of the host engine run on the JAX gateway; and the
pass-through SSE-C object is held encrypted upstream, with the gateway
never decrypting it.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import hashlib
import io
import os
import re
import types

import pytest

from minio_tpu.codec import kms as jkms
from minio_tpu.codec import sse as jsse
from minio_tpu.gateway import client as jclient
from minio_tpu.gateway.s3 import S3Objects as JaxGateway
from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import kms as tkms
from minio_tpu_torch.codec import sse as tsse
from minio_tpu_torch.gateway import client as tclient
from minio_tpu_torch.gateway.s3 import S3Objects as PortGateway
from minio_tpu_torch.objectlayer import api as tapi
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.ops import kernels
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_server import _normalize
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]

PKG = {
    "jax": types.SimpleNamespace(Gateway=JaxGateway, api=japi, sse=jsse,
                                 Server=JaxServer, kw={}),
    "port": types.SimpleNamespace(Gateway=PortGateway, api=tapi, sse=tsse,
                                  Server=S3Server, kw={"device": "cpu"}),
}


def _upstream(kind: str, root):
    if kind == "jax":
        ol = JaxObjects([JaxStorage(str(root / f"up{i}")) for i in range(4)],
                        block_size=BLOCK, min_part_size=1)
        return JaxServer(ol, address="127.0.0.1:0").start()
    ol = ErasureObjects([XLStorage(str(root / f"up{i}")) for i in range(4)],
                        block_size=BLOCK, device="cpu")
    ol.min_part_size = 1  # the port's layer reads it as an attribute
    return S3Server(ol, address="127.0.0.1:0").start()


_VOLATILE = ("version_id", "upload_id", "next_version_id_marker")
_DROPPED = ("mod_time_ns", "initiated_ns", "created_ns")


class _Log:
    """Answers as plain data; exceptions by class name."""

    def __init__(self):
        self.rows = []
        self.ids: list = []  # answers that are fresh ids (upload ids)

    def __call__(self, name, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
            self.rows.append((name, "ok", self.plain(out)))
            return out
        except Exception as e:  # noqa: BLE001 - the answer under test
            self.rows.append((name, "raise", type(e).__name__))
            return None

    def note(self, name, value):
        self.rows.append((name, "ok", self.plain(value)))

    def plain(self, x):
        if isinstance(x, (list, tuple)):
            return [self.plain(v) for v in x]
        if dataclasses.is_dataclass(x):
            d = {f.name: self.plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)}
            return (type(x).__name__, d)
        if isinstance(x, dict):
            return {k: self.plain(v) for k, v in x.items()}
        if hasattr(x, "status") and hasattr(x, "body"):  # an S3Response
            return _normalize((x.status, x.headers, x.body))
        return x


def _canon(rows, ids=()):
    """Volatile ids by first appearance; times dropped."""
    seen: dict = {v: f"<id{i}>" for i, v in enumerate(ids) if v}

    def walk(x, key=""):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
            return (x[0], walk(x[1]))
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in _DROPPED:
                    continue
                if k in _VOLATILE and v:
                    v = seen.setdefault(v, f"<id{len(seen)}>")
                out[k] = walk(v, k)
            return out
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, str):
            for vid, ph in seen.items():
                x = x.replace(vid, ph)
            return x
        if isinstance(x, bytes):
            for vid, ph in seen.items():
                x = x.replace(vid.encode(), ph.encode())
            return re.sub(rb"<UploadId>[^<]*</UploadId>", b"<UploadId/>", x)
        return x

    return walk(rows)


# -- the cases of tests/test_gateway.py, written once for every pair ------


def case_gateway_bucket_and_object_crud(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    log("make", gw.make_bucket, "gwb")
    log("buckets", lambda: sorted(b.name for b in gw.list_buckets()))
    log("info", gw.get_bucket_info, "gwb")
    log("info_missing", gw.get_bucket_info, "missing-bkt")
    data = _pay(50000, 1)
    log("put", gw.put_object, "gwb", "a/key.bin", io.BytesIO(data),
        len(data), {"x-amz-meta-tag": "v", "content-type": "app/x"})
    log("head", gw.get_object_info, "gwb", "a/key.bin")
    for off, n in ((0, -1), (1000, 500)):
        buf = io.BytesIO()
        log(f"get_{off}", gw.get_object, "gwb", "a/key.bin", buf, off, n)
        log(f"body_{off}", lambda: hashlib.sha256(buf.getvalue()).hexdigest())
    log("delete", gw.delete_object, "gwb", "a/key.bin")
    log("head_gone", gw.get_object_info, "gwb", "a/key.bin")
    log("get_gone", gw.get_object, "gwb", "a/key.bin", io.BytesIO())


def case_gateway_listing_pages_and_prefixes(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    gw.make_bucket("gwl")
    for i in range(7):
        gw.put_object("gwl", f"d/k{i}", io.BytesIO(b"x"), 1)
    gw.put_object("gwl", "top", io.BytesIO(b"y"), 1)
    log("delim", gw.list_objects, "gwl", delimiter="/")
    marker = ""
    while True:
        res = log(f"page_{marker}", gw.list_objects, "gwl", prefix="d/",
                  marker=marker, max_keys=3)
        if not res.is_truncated:
            break
        marker = res.next_marker


def case_gateway_copy_and_meta_update(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    gw.make_bucket("gwc")
    log("put", gw.put_object, "gwc", "src", io.BytesIO(b"copy-data"), 9,
        {"x-amz-meta-a": "1"})
    log("copy", gw.copy_object, "gwc", "src", "gwc", "dst")
    buf = io.BytesIO()
    log("get", gw.get_object, "gwc", "dst", buf)
    log("body", buf.getvalue)
    log("update", gw.update_object_meta, "gwc", "src", {"x-amz-meta-b": "2"})
    log("head", gw.get_object_info, "gwc", "src")
    log("copy_missing", gw.copy_object, "gwc", "nope", "gwc", "dst2")


def case_gateway_multipart(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    gw.make_bucket("gwm")
    uid = log("new", gw.new_multipart_upload, "gwm", "big", {})
    log.ids.append(uid)
    log("uploads", gw.list_multipart_uploads, "gwm")
    p1, p2 = _pay(5 << 20, 2), _pay(100, 3)
    pi1 = log("part1", gw.put_object_part, "gwm", "big", uid, 1,
              io.BytesIO(p1), len(p1))
    pi2 = log("part2", gw.put_object_part, "gwm", "big", uid, 2,
              io.BytesIO(p2), len(p2))
    log("parts", gw.list_object_parts, "gwm", "big", uid)
    log("complete", gw.complete_multipart_upload, "gwm", "big", uid,
        [G.api.CompletePart(1, pi1.etag), G.api.CompletePart(2, pi2.etag)])
    buf = io.BytesIO()
    log("get", gw.get_object, "gwm", "big", buf)
    log("body", lambda: buf.getvalue() == p1 + p2)
    uid2 = log("new2", gw.new_multipart_upload, "gwm", "nope", {})
    log.ids.append(uid2)
    log("abort", gw.abort_multipart_upload, "gwm", "nope", uid2)
    log("uploads_after", gw.list_multipart_uploads, "gwm")
    log("abort_again", gw.abort_multipart_upload, "gwm", "nope", uid2)


def case_gateway_served_through_front_server(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    front = G.Server(gw, address="127.0.0.1:0", **G.kw).start()
    try:
        c, u = S3Client(front.endpoint), S3Client(up.endpoint)
        data = _pay(30000, 4)
        log("make", c.make_bucket, "chain")
        log("put", c.put_object, "chain", "obj", data)
        log("get", c.get_object, "chain", "obj")
        log("range", c.request, "GET", "/chain/obj",
            headers={"Range": "bytes=100-299"})
        log("list", c.list_objects, "chain")
        log("upstream_get", u.get_object, "chain", "obj")
        log("delete", c.request, "DELETE", "/chain/obj")
        log("upstream_gone", u.get_object, "chain", "obj")
        log("versions", c.request, "GET", "/chain", query={"versions": ""})
        log("heal_bucket", gw.heal_bucket, "chain")
    finally:
        front.shutdown()


def case_nas_gateway_cli_shape(G, up, tmp_path, log):
    from minio_tpu.objectlayer.fs import FSObjects as JaxFS
    from minio_tpu_torch.objectlayer.fs import FSObjects as PortFS

    fs = (PortFS if G is PKG["port"] else JaxFS)(str(tmp_path / "nas"))
    srv = G.Server(fs, address="127.0.0.1:0", **G.kw).start()
    try:
        c = S3Client(srv.endpoint)
        log("make", c.make_bucket, "nasb")
        log("put", c.put_object, "nasb", "f.txt", b"nas-data")
        log("get", c.get_object, "nasb", "f.txt")
        log("file", (tmp_path / "nas" / "nasb" / "f.txt").read_bytes)
    finally:
        srv.shutdown()


def case_gateway_keys_needing_url_encoding(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    gw.make_bucket("gwq")
    for key in ("a b/c d.txt", "plus+sign", "uni-é中.txt"):
        data = key.encode() * 10
        log(f"put {key}", gw.put_object, "gwq", key, io.BytesIO(data),
            len(data))
        buf = io.BytesIO()
        log(f"get {key}", gw.get_object, "gwq", key, buf)
        log(f"body {key}", buf.getvalue)
        log(f"list {key}", gw.list_objects, "gwq")
        log(f"delete {key}", gw.delete_object, "gwq", key)


def case_gateway_sse_c_round_trip(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    up.tls = True  # the upstream demands TLS for SSE-C headers
    gw.make_bucket("gwsse")
    spec = G.sse.SSESpec("C", b"G" * 32)
    log("put", gw.put_object, "gwsse", "secret.bin",
        io.BytesIO(b"gateway-sse-payload"), 19, sse=spec)
    meta = up.object_layer.get_object_info("gwsse", "secret.bin").user_defined
    log.note("upstream_sealed", meta.get("x-internal-sse"))
    out = io.BytesIO()
    log("get", gw.get_object, "gwsse", "secret.bin", out, sse=spec)
    log("body", out.getvalue)
    log("get_wrong_key", gw.get_object, "gwsse", "secret.bin", io.BytesIO(),
        sse=G.sse.SSESpec("C", b"X" * 32))
    log("get_no_key", gw.get_object, "gwsse", "secret.bin", io.BytesIO())
    log("put_s3", gw.put_object, "gwsse", "s3mode.bin", io.BytesIO(b"abc"), 3,
        sse=G.sse.SSESpec("S3", b""))
    out = io.BytesIO()
    log("get_s3", gw.get_object, "gwsse", "s3mode.bin", out)
    log("body_s3", out.getvalue)


def case_gateway_versioned_reads(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    gw.make_bucket("gwver")
    cfg = (b"<VersioningConfiguration>"
           b"<Status>Enabled</Status></VersioningConfiguration>")
    log("enable", S3Client(up.endpoint).request, "PUT", "/gwver",
        query={"versioning": ""}, body=cfg)
    i1 = log("put1", gw.put_object, "gwver", "doc",
             io.BytesIO(b"version-one"), 11, versioned=True)
    log("put2", gw.put_object, "gwver", "doc", io.BytesIO(b"version-TWO"),
        11, versioned=True)
    out = io.BytesIO()
    log("get_latest", gw.get_object, "gwver", "doc", out)
    log("body_latest", out.getvalue)
    out = io.BytesIO()
    log("get_v1", gw.get_object, "gwver", "doc", out,
        version_id=i1.version_id)
    log("body_v1", out.getvalue)
    log("versions", gw.list_object_versions, "gwver", prefix="doc")
    log("has_versions", gw.has_object_versions, "gwver", "doc")
    log("delete_v1", gw.delete_object, "gwver", "doc",
        version_id=i1.version_id)
    log("versions_after", gw.list_object_versions, "gwver", prefix="doc")
    log("get_v1_gone", gw.get_object, "gwver", "doc", io.BytesIO(),
        version_id=i1.version_id)


def case_gateway_front_server_ssec(G, up, tmp_path, log):
    gw = G.Gateway(up.endpoint, "minioadmin", "minioadmin")
    up.tls = True
    front = G.Server(gw, address="127.0.0.1:0", **G.kw).start()
    ep = front.endpoint  # before the tls flag flips the scheme
    front.tls = True  # SSE-C headers accepted on the front too
    try:
        c = S3Client(ep)
        log("make", c.make_bucket, "fgsse")
        hdrs = ssec_headers(b"F" * 32)
        log("put", c.put_object, "fgsse", "sec", b"front-gw-sse",
            headers=hdrs)
        log("get", c.get_object, "fgsse", "sec", headers=hdrs)
        log("head", lambda: c.head_object("fgsse", "sec",
                                          headers=hdrs).status)
        log("get_no_key", lambda: c.get_object("fgsse", "sec").status)
        copy = dict(hdrs, **ssec_headers(b"F" * 32, copy_source=True),
                    **{"x-amz-copy-source": "/fgsse/sec"})
        log("copy", lambda: c.request("PUT", "/fgsse/sec2",
                                      headers=copy).status)
        log("get_copy", c.get_object, "fgsse", "sec2", headers=hdrs)
        sealed = up.object_layer.get_object_info("fgsse", "sec2")
        log.note("upstream_sealed", sealed.user_defined.get("x-internal-sse"))
    finally:
        front.shutdown()


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    p = ("x-amz-copy-source-server-side-encryption-customer"
         if copy_source else "x-amz-server-side-encryption-customer")
    return {f"{p}-algorithm": "AES256",
            f"{p}-key": base64.b64encode(key).decode(),
            f"{p}-key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


def _pay(size: int, seed: int) -> bytes:
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.fixture()
def kms_key(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_KMS_MASTER_KEY", "gwkey:" + "ef" * 32)
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    for k in (jkms, tkms):
        k.reset_kms_cache()
    yield
    for k in (jkms, tkms):
        k.reset_kms_cache()


def _run(case, gw_kind, up_kind, tmp_path) -> list:
    base = tmp_path / f"{gw_kind}-{up_kind}"
    base.mkdir()
    up = _upstream(up_kind, base)
    log = _Log()
    try:
        CASES[case](PKG[gw_kind], up, base, log)
    finally:
        up.shutdown()
    rows = _canon(log.rows, log.ids)
    if "sse" in case:  # the upstream's random package nonces
        rows = [(n, k, _drop_etags(v)) for n, k, v in rows]
    return rows


def _drop_etags(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
        return (x[0], {k: v for k, v in x[1].items() if k != "etag"})
    if isinstance(x, tuple) and len(x) == 3 and isinstance(x[1], dict):
        return (x[0], {k: v for k, v in x[1].items() if k != "etag"}, x[2])
    return x


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-gw-{p[1]}-up")
@pytest.mark.parametrize("case", sorted(CASES))
def test_same_answers(tmp_path, kms_key, case, pair):
    want = _run(case, "jax", "jax", tmp_path)
    got = _run(case, *pair, tmp_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g == w


def test_cases_cover_the_reference_suite():
    import tests.test_gateway as ref

    names = sorted(n[5:] for n in dir(ref) if n.startswith("test_"))
    assert len(names) == 10
    assert names == sorted(CASES)


class _RecConn:
    """A connection that records what a client sends and answers 200."""

    sent: list = []

    def request(self, method, url, body=None, headers=None):
        self.sent.append(("request", method, url, body, dict(headers)))

    def putrequest(self, method, url, skip_host=False):
        self.sent.append(("putrequest", method, url))

    def putheader(self, k, v):
        self.sent.append(("putheader", k, v))

    def endheaders(self):
        self.sent.append(("endheaders",))

    def send(self, data):
        self.sent.append(("send", bytes(data)))

    def getresponse(self):
        return types.SimpleNamespace(status=200, read=lambda *a: b"",
                                     getheaders=lambda: [], close=lambda: None)

    def close(self):
        pass


def test_upstream_requests_byte_equal_under_a_pinned_clock(monkeypatch):
    now = datetime.datetime(2026, 3, 4, 5, 6, 7,
                            tzinfo=datetime.timezone.utc)
    fake = types.SimpleNamespace(
        datetime=types.SimpleNamespace(now=lambda tz=None: now),
        timezone=datetime.timezone)
    sent = {}
    for name, mod in (("jax", jclient), ("port", tclient)):
        monkeypatch.setattr(mod, "datetime", fake)
        c = mod.S3UpstreamClient("https://upstream.example:9443", "AKID",
                                 "s3cr3t/key", region="eu-west-1")
        _RecConn.sent = []
        monkeypatch.setattr(c, "_conn", lambda: _RecConn())
        c.request("PUT", "/bkt/a b/ü+c.txt", headers={"X-Amz-Meta-A": "1"},
                  reader=io.BytesIO(b"x" * 3000), content_length=3000)
        c.request("GET", "/bkt", query={"list-type": "2", "prefix": "a b/",
                                        "delimiter": "/"})
        c.request("POST", "/bkt/k", query={"uploads": ""}, body=b"")
        c.request("POST", "/bkt/k", query={"uploadId": "u+1"},
                  body=b"<CompleteMultipartUpload/>")
        c.request("HEAD", "/bkt/k", query={"versionId": "v/1"})
        sent[name] = _RecConn.sent
    assert sent["port"] == sent["jax"]
    auths = [e[4]["authorization"] for e in sent["port"] if e[0] == "request"]
    assert len(auths) == 4 and all("Signature=" in a for a in auths)


def test_insecure_upstream_switch(monkeypatch):
    for mod in (jclient, tclient):
        c = mod.S3UpstreamClient("https://127.0.0.1:9", "a", "b")
        monkeypatch.setenv("MINIO_TPU_GATEWAY_INSECURE", "1")
        conn = c._conn()
        assert conn._context.verify_mode == 0 and not conn._context.check_hostname
        c._drop()
        monkeypatch.delenv("MINIO_TPU_GATEWAY_INSECURE")
        conn = c._conn()
        assert conn._context.verify_mode != 0
        c._drop()


_CSV = b"id,name,qty\n" + b"".join(
    b"%d,item%d,%d\n" % (i, i, i % 11) for i in range(3000))
_SELECT = (
    b"<SelectObjectContentRequest><Expression>SELECT s.id, s.name FROM "
    b"S3Object s WHERE s.qty &gt; 6</Expression><ExpressionType>SQL"
    b"</ExpressionType><InputSerialization><CSV><FileHeaderInfo>USE"
    b"</FileHeaderInfo></CSV></InputSerialization><OutputSerialization>"
    b"<CSV/></OutputSerialization></SelectObjectContentRequest>")


def _records(body: bytes) -> bytes:
    from minio_tpu_torch.s3select import message

    return b"".join(m["payload"] for m in message.decode_all(body)
                    if m["headers"].get(":event-type") == "Records")


@pytest.mark.parametrize("up_kind", ["port", "jax"])
def test_select_through_gateway_scans_on_the_servers_device(
        tmp_path, monkeypatch, up_kind):
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    up = _upstream(up_kind, tmp_path)
    try:
        S3Client(up.endpoint).make_bucket("sel")
        assert S3Client(up.endpoint).put_object("sel", "t.csv", _CSV).status == 200
        got = {}
        for kind in ("jax", "port"):
            G = PKG[kind]
            # the JAX select runs its host engine (its device engine needs
            # jax.experimental.enable_x64); the port's the default engine
            if kind == "jax":
                monkeypatch.setenv("MINIO_TPU_SELECT", "host")
            else:
                monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
            front = G.Server(G.Gateway(up.endpoint, "minioadmin",
                                       "minioadmin"),
                             address="127.0.0.1:0", **G.kw).start()
            try:
                r = S3Client(front.endpoint).request(
                    "POST", "/sel/t.csv",
                    query={"select": "", "select-type": "2"}, body=_SELECT)
                assert r.status == 200, r.body[:300]
                got[kind] = _records(r.body)
            finally:
                front.shutdown()
        assert got["port"] == got["jax"]
        assert got["port"].count(b"\n") == sum(
            1 for i in range(3000) if i % 11 > 6)
    finally:
        up.shutdown()


def test_gateway_server_device_is_the_scan_device():
    from minio_tpu_torch.server.select import scan_device

    srv = S3Server(PortGateway("http://127.0.0.1:9", "a", "b"),
                   address="127.0.0.1:0", device="cpu")
    assert scan_device(srv) == "cpu"
    assert S3Server(PortGateway("http://127.0.0.1:9", "a", "b"),
                    address="127.0.0.1:0").device == "cuda"
    assert kernels.LAUNCHES is not None
