"""The port's S3 server held against minio_tpu's, over real HTTP.

Two threaded servers run side by side: minio_tpu's ``S3Server`` over its
``ErasureObjects`` and minio_tpu_torch's over its own
(``device="cpu"``: the plain PyTorch versions of the kernels), each on
six temp-dir disks at EC 4+2 with 4 KiB blocks.  The same requests,
signed by ``tests/s3client.S3Client`` (or presigned / signed by hand
with the JAX package's auth module), go to both.  Statuses, headers and
bodies must be equal once these fields are normalized:

* the ``Date`` and ``x-amz-request-id`` headers and ``<RequestId>`` in
  error bodies (fresh per request);
* ``Last-Modified``, ``<LastModified>`` and ``<CreationDate>`` (the two
  servers write at different instants);
* ``x-amz-version-id`` (random per version).

Afterwards the part files must be byte-equal and ``xl.meta`` equal up
to mod time, data dir and version id on every disk, the ``.sys`` bucket
documents included (both packages' ``bucket_meta`` stamp documents
with one fixed ``created_ns`` here), and the two Prometheus scrapes must
count the same requests.  Unported routes and knobs are held on the
port alone: each answers ``NotImplemented`` naming its slice.
"""

from __future__ import annotations

import datetime
import hashlib
import http.client
import json
import os
import re
import time
import types
import urllib.parse

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import bucket_meta as jbucket_meta
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server import auth as jauth
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu.codec import kms as jkms
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import kms as tkms
from minio_tpu_torch.objectlayer import bucket_meta as tbucket_meta
from minio_tpu_torch.objectlayer.api import ObjectNotFound
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server import http as thttp
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 4096
CREATED_NS = 1_700_000_000_000_000_000  # bucket documents' created_ns

POLICY = (
    b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
    b'"Principal":{"AWS":["*"]},"Action":["s3:GetObject"],'
    b'"Resource":["arn:aws:s3:::pol/pub/*"]}]}'
)


def _pay(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8
    ).tobytes()


def _raw(endpoint: str, method: str, url: str, headers=None,
         body: bytes = b""):
    """One unsigned (or pre-signed) request; (status, headers, body)."""
    p = urllib.parse.urlsplit(endpoint)
    conn = http.client.HTTPConnection(p.hostname, p.port, timeout=30)
    try:
        conn.request(method, url, body=body or None, headers=headers or {})
        r = conn.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read())
    finally:
        conn.close()


def _unsigned_payload_put(c: S3Client, path: str, body: bytes):
    """PUT signed with x-amz-content-sha256: UNSIGNED-PAYLOAD."""
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ"
    )
    headers = {
        "host": f"{c.host}:{c.port}",
        "x-amz-date": amz_date,
        "x-amz-content-sha256": jauth.UNSIGNED_PAYLOAD,
    }
    signed = sorted(headers)
    sig = jauth.sign_v4("PUT", path, {}, headers, signed,
                        jauth.UNSIGNED_PAYLOAD, c.access_key, c.secret_key,
                        amz_date, c.region)
    scope = f"{amz_date[:8]}/{c.region}/s3/aws4_request"
    headers["authorization"] = (
        f"{jauth.SIGN_V4_ALGORITHM} Credential={c.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return _raw(f"http://{c.host}:{c.port}", "PUT", path, headers, body)


def _presigned_get(c: S3Client, path: str, amz_date: "str | None" = None,
                   expires: int = 3600):
    url = jauth.presign_url(
        "GET", f"http://{c.host}:{c.port}{path}", c.access_key,
        c.secret_key, expires=expires, region=c.region, amz_date=amz_date,
    )
    p = urllib.parse.urlsplit(url)
    return _raw(url, "GET", f"{p.path}?{p.query}")


def _res(r):
    if isinstance(r, tuple):
        return r
    return r.status, r.headers, r.body


def _steps():
    """(name, request) pairs, sent in this order to both servers."""
    big = _pay(BLOCK * 3 + 77, 1)
    chunked = _pay(BLOCK * 5 + 3, 2)
    unsigned = _pay(BLOCK + 9, 3)
    names = [
        "a/one", "a/two", "a/b/three", "b/four", "c", "sp ace/ü.txt",
        "z-last",
    ]
    steps = [
        ("bucket_create", lambda c: c.make_bucket("bkt")),
        ("bucket_create_dup", lambda c: c.make_bucket("bkt")),
        ("bucket_create_bad_lock_header", lambda c: c.request(
            "PUT", "/other", headers={
                "x-amz-bucket-object-lock-enabled": "maybe"})),
        ("bucket_create_invalid_name", lambda c: c.make_bucket("ab")),
        ("bucket_head", lambda c: c.request("HEAD", "/bkt")),
        ("bucket_head_missing", lambda c: c.request("HEAD", "/nope")),
        ("bucket_location", lambda c: c.request(
            "GET", "/bkt", query={"location": ""})),
        ("bucket_accelerate", lambda c: c.request(
            "GET", "/bkt", query={"accelerate": ""})),
        ("bucket_cors", lambda c: c.request(
            "GET", "/bkt", query={"cors": ""})),
        ("put_plain", lambda c: c.put_object(
            "bkt", "obj", big, headers={
                "content-type": "text/plain", "x-amz-meta-colour": "blue"})),
        ("put_unsigned_payload", lambda c: _unsigned_payload_put(
            c, "/bkt/unsigned", unsigned)),
        ("put_aws_chunked", lambda c: c.put_object_streaming(
            "bkt", "chunked", chunked, chunk_size=3000)),
        ("put_aws_chunked_bad_sig", lambda c: c.put_object_streaming(
            "bkt", "chunked-bad", chunked, corrupt_final_sig=True)),
        ("put_empty", lambda c: c.put_object("bkt", "empty", b"")),
        ("put_bad_md5", lambda c: c.put_object(
            "bkt", "md5", b"abc", headers={
                "content-md5": "AAAAAAAAAAAAAAAAAAAAAA=="})),
        ("put_no_bucket", lambda c: c.put_object("nope", "k", b"x")),
        ("get_whole", lambda c: c.get_object("bkt", "obj")),
        ("get_chunked", lambda c: c.get_object("bkt", "chunked")),
        ("get_unsigned", lambda c: c.get_object("bkt", "unsigned")),
        ("get_empty", lambda c: c.get_object("bkt", "empty")),
        ("get_range_mid", lambda c: c.get_object(
            "bkt", "obj", headers={"range": "bytes=4000-8300"})),
        ("get_range_suffix", lambda c: c.get_object(
            "bkt", "obj", headers={"range": "bytes=-100"})),
        ("get_range_open", lambda c: c.get_object(
            "bkt", "obj", headers={"range": "bytes=12000-"})),
        ("get_range_invalid", lambda c: c.get_object(
            "bkt", "obj", headers={"range": "bytes=99999999-"})),
        ("get_range_multi", lambda c: c.get_object(
            "bkt", "obj", headers={"range": "bytes=0-1,5-6"})),
        ("get_if_none_match", lambda c: c.get_object(
            "bkt", "obj", headers={
                "if-none-match":
                    '"' + hashlib.md5(big).hexdigest() + '"'})),
        ("get_if_match_wrong", lambda c: c.get_object(
            "bkt", "obj", headers={"if-match": '"0123"'})),
        ("get_if_modified_since_future", lambda c: c.get_object(
            "bkt", "obj", headers={
                "if-modified-since": "Fri, 01 Jan 2100 00:00:00 GMT"})),
        ("get_if_unmodified_since_past", lambda c: c.get_object(
            "bkt", "obj", headers={
                "if-unmodified-since": "Fri, 01 Jan 1999 00:00:00 GMT"})),
        ("get_missing", lambda c: c.get_object("bkt", "missing")),
        ("get_unknown_subresource", lambda c: c.get_object(
            "bkt", "obj", query={"torrent": ""})),
        ("head_object", lambda c: c.head_object("bkt", "obj")),
        ("head_missing", lambda c: c.head_object("bkt", "missing")),
    ]
    for i, name in enumerate(names):
        steps.append((f"put_list_{i}", lambda c, n=name, i=i: c.put_object(
            "lst", n, _pay(100 + i, 10 + i))))
    steps.insert(len(steps) - len(names),
                 ("bucket_create_lst", lambda c: c.make_bucket("lst")))
    lists = [
        ("v1_all", {}),
        ("v1_prefix", {"prefix": "a/"}),
        ("v1_delim", {"delimiter": "/"}),
        ("v1_prefix_delim", {"prefix": "a/", "delimiter": "/"}),
        ("v1_other_delim", {"delimiter": "o"}),
        ("v1_marker", {"marker": "a/two"}),
        ("v1_max1", {"max-keys": "1"}),
        ("v1_max0", {"max-keys": "0"}),
        ("v1_max_delim_page", {"max-keys": "2", "delimiter": "/"}),
        ("v1_url", {"encoding-type": "url"}),
        ("v1_bad_max", {"max-keys": "x"}),
        ("v1_neg_max", {"max-keys": "-1"}),
        ("v2_all", {"list-type": "2"}),
        ("v2_page1", {"list-type": "2", "max-keys": "2"}),
        ("v2_page2", {"list-type": "2", "max-keys": "2",
                      "continuation-token": "YS90d28="}),
        ("v2_start_after", {"list-type": "2", "start-after": "b/four"}),
        ("v2_delim_url", {"list-type": "2", "delimiter": "/",
                          "encoding-type": "url"}),
        ("v2_prefix_nomatch", {"list-type": "2", "prefix": "q"}),
        ("v2_bad_token", {"list-type": "2", "continuation-token": "%%%"}),
        ("v2_max1000", {"list-type": "2", "max-keys": "1000"}),
    ]
    for name, q in lists:
        steps.append((f"list_{name}", lambda c, q=q: c.list_objects(
            "lst", **q)))
    steps += [
        ("list_missing_bucket", lambda c: c.list_objects("nope")),
        ("list_buckets", lambda c: c.request("GET", "/")),
        ("bucket_delete_not_empty", lambda c: c.request("DELETE", "/lst")),
        ("delete_object", lambda c: c.delete_object("bkt", "empty")),
        ("delete_missing_key", lambda c: c.delete_object("bkt", "nokey")),
        ("get_deleted", lambda c: c.get_object("bkt", "empty")),
        # versioning: delete markers and version deletes
        ("bucket_create_ver", lambda c: c.make_bucket("ver")),
        ("versioning_get_unset", lambda c: c.request(
            "GET", "/ver", query={"versioning": ""})),
        ("versioning_enable", lambda c: c.request(
            "PUT", "/ver", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>")),
        ("versioning_bad", lambda c: c.request(
            "PUT", "/ver", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>On</Status>"
                 b"</VersioningConfiguration>")),
        ("versioning_get", lambda c: c.request(
            "GET", "/ver", query={"versioning": ""})),
        ("put_ver_1", lambda c: c.put_object("ver", "k", b"one")),
        ("put_ver_2", lambda c: c.put_object("ver", "k", b"two!")),
        ("get_ver", lambda c: c.get_object("ver", "k")),
        ("delete_ver_marker", lambda c: c.delete_object("ver", "k")),
        ("get_ver_after_marker", lambda c: c.get_object("ver", "k")),
        ("head_ver_after_marker", lambda c: c.head_object("ver", "k")),
        ("list_ver_after_marker", lambda c: c.list_objects("ver")),
        ("versioning_suspend", lambda c: c.request(
            "PUT", "/ver", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Suspended</Status>"
                 b"</VersioningConfiguration>")),
        ("put_ver_null", lambda c: c.put_object("ver", "n", b"null")),
        ("delete_ver_null_marker", lambda c: c.delete_object("ver", "n")),
        ("delete_ver_missing_version", lambda c: c.delete_object_version(
            "ver", "k", "00000000-0000-0000-0000-000000000000")),
        # bucket policy and anonymous access
        ("bucket_create_pol", lambda c: c.make_bucket("pol")),
        ("put_pol_pub", lambda c: c.put_object("pol", "pub/x", b"public")),
        ("put_pol_priv", lambda c: c.put_object("pol", "priv/y", b"priv")),
        ("anon_get_before_policy", lambda c: c.request(
            "GET", "/pol/pub/x", sign=False)),
        ("policy_get_missing", lambda c: c.request(
            "GET", "/pol", query={"policy": ""})),
        ("policy_put_malformed", lambda c: c.request(
            "PUT", "/pol", query={"policy": ""}, body=b"{not json")),
        ("policy_put", lambda c: c.request(
            "PUT", "/pol", query={"policy": ""}, body=POLICY)),
        ("policy_get", lambda c: c.request(
            "GET", "/pol", query={"policy": ""})),
        ("anon_get_allowed", lambda c: c.request(
            "GET", "/pol/pub/x", sign=False)),
        ("anon_get_denied", lambda c: c.request(
            "GET", "/pol/priv/y", sign=False)),
        ("anon_put_denied", lambda c: c.request(
            "PUT", "/pol/pub/z", body=b"no", sign=False)),
        ("anon_list_denied", lambda c: c.request(
            "GET", "/pol", sign=False)),
        ("put_after_policy", lambda c: c.put_object("pol", "pub/w", b"w")),
        ("policy_delete", lambda c: c.request(
            "DELETE", "/pol", query={"policy": ""})),
        ("anon_get_after_delete", lambda c: c.request(
            "GET", "/pol/pub/x", sign=False)),
        # authentication failures
        ("bad_signature", lambda c: S3Client(
            f"http://{c.host}:{c.port}", secret_key="wrong-secret"
        ).get_object("bkt", "obj")),
        ("unknown_access_key", lambda c: S3Client(
            f"http://{c.host}:{c.port}", access_key="nobody"
        ).get_object("bkt", "obj")),
        ("presign_ok", lambda c: _presigned_get(c, "/bkt/obj")),
        ("v2_get", lambda c: c.request_v2("GET", "/bkt/obj")),
        ("v2_list", lambda c: c.request_v2("GET", "/bkt")),
        ("v2_bad_signature", lambda c: S3Client(
            f"http://{c.host}:{c.port}", secret_key="wrong-secret"
        ).request_v2("GET", "/bkt/obj")),
        ("presign_expired", lambda c: _presigned_get(
            c, "/bkt/obj", amz_date="20200101T000000Z", expires=60)),
        ("wrong_session_token", lambda c: c.get_object(
            "bkt", "obj", headers={"x-amz-security-token": "bogus"})),
        # verbs and reserved buckets
        ("unknown_verb", lambda c: c.request("PATCH", "/bkt/obj")),
        ("options_verb", lambda c: c.request("OPTIONS", "/bkt")),
        ("reserved_sys_bucket", lambda c: c.request(
            "GET", "/.sys/buckets")),
        ("reserved_router_bucket", lambda c: c.request(
            "GET", "/minio-tpu/anything")),
        ("post_object_no_subresource", lambda c: c.request(
            "POST", "/bkt/obj")),
        ("delete_root", lambda c: c.request("DELETE", "/")),
        ("health_live", lambda c: _raw(
            f"http://{c.host}:{c.port}", "GET", "/minio/health/live")),
        ("health_ready", lambda c: _raw(
            f"http://{c.host}:{c.port}", "GET", "/minio/health/ready")),
        ("health_cluster", lambda c: _raw(
            f"http://{c.host}:{c.port}", "GET", "/minio/health/cluster")),
        ("metrics_anonymous", lambda c: _raw(
            f"http://{c.host}:{c.port}", "GET",
            "/minio-tpu/prometheus/metrics")),
        ("bucket_delete_empty", lambda c: (
            c.delete_object("bkt", "obj"), c.delete_object("bkt", "chunked"),
            c.delete_object("bkt", "unsigned"),
            c.request("DELETE", "/bkt"))[-1]),
        ("bucket_head_deleted", lambda c: c.request("HEAD", "/bkt")),
    ]
    return steps


STEPS = _steps()
STEP_NAMES = [name for name, _ in STEPS]
assert len(set(STEP_NAMES)) == len(STEP_NAMES)

_VOLATILE_HEADERS = ("date", "x-amz-request-id", "last-modified")
_BODY_SUBS = [
    (re.compile(rb"<RequestId>[^<]*</RequestId>"), b"<RequestId/>"),
    (re.compile(rb"<LastModified>[^<]*</LastModified>"), b"<LastModified/>"),
    (re.compile(rb"<CreationDate>[^<]*</CreationDate>"), b"<CreationDate/>"),
]


def _normalize(res):
    status, headers, body = res
    h = {k: v for k, v in headers.items() if k not in _VOLATILE_HEADERS}
    if "x-amz-version-id" in h:
        h["x-amz-version-id"] = "<version-id>"
    for pat, rep in _BODY_SUBS:
        body = pat.sub(rep, body)
    return status, h, body


def _counters(scrape: bytes) -> dict:
    out = {}
    for line in scrape.decode().splitlines():
        if line.startswith("miniotpu_s3_requests_total{"):
            series, _, value = line.rpartition(" ")
            out[series] = value
    return out


def _settled(read, pause: float = 0.05, tries: int = 100):
    """``read()`` once two reads ``pause`` apart agree."""
    last = read()
    for _ in range(tries):
        time.sleep(pause)
        now = read()
        if now == last:
            return now
        last = now
    raise AssertionError("the server's request books did not settle")


def _until(cond, timeout_s: float = 10.0) -> bool:
    """True once ``cond()`` holds, False after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _start(kind: str, roots: list):
    if kind == "jax":
        ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
        return JaxServer(ol, address="127.0.0.1:0").start()
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK, device="cpu")
    return S3Server(ol, address="127.0.0.1:0").start()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both servers, the whole sequence sent to each, then scraped."""
    fixed = types.SimpleNamespace(time_ns=lambda: CREATED_NS,
                                  monotonic=time.monotonic)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        mp.setattr(jbucket_meta, "time", fixed)
        mp.setattr(tbucket_meta, "time", fixed)
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("servers")
        out = {}
        for kind in ("jax", "port"):
            roots = [str(base / f"{kind}{i}") for i in range(N)]
            audit = base / f"{kind}-audit.jsonl"
            mp.setenv("MINIO_TPU_AUDIT_LOG_FILE", str(audit))
            srv = _start(kind, roots)
            traces = srv.tracer.pubsub.subscribe()
            try:
                client = S3Client(srv.endpoint)
                results = {name: _res(fn(client)) for name, fn in STEPS}
                # a handler books its request (metrics, trace, audit)
                # just after answering it: wait until the books settle
                counters = _settled(lambda: _counters(client.request(
                    "GET", "/minio-tpu/prometheus/metrics").body))
                audited = _settled(lambda: audit.read_text())
            finally:
                srv.shutdown()
            out[kind] = (results, counters, roots, traces.drain(),
                         [json.loads(line) for line in
                          audited.splitlines()])
        yield out
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.mark.parametrize("step", STEP_NAMES)
def test_same_response(runs, step):
    want = _normalize(runs["jax"][0][step])
    got = _normalize(runs["port"][0][step])
    assert got == want


def test_sequence_exercised_the_paths(runs):
    """The comparison is not vacuous: the ported routes succeeded."""
    res = runs["port"][0]
    assert res["put_aws_chunked"][0] == 200
    assert res["put_unsigned_payload"][0] == 200
    assert res["get_range_suffix"][0] == 206
    assert res["get_chunked"][2] == _pay(BLOCK * 5 + 3, 2)
    assert res["delete_ver_marker"][1]["x-amz-delete-marker"] == "true"
    assert res["anon_get_allowed"][:1] == (200,)
    assert res["anon_get_denied"][0] == 403
    assert res["presign_ok"][0] == 200
    assert b"<Code>ExpiredToken</Code>" in res["presign_expired"][2]
    assert res["bucket_delete_empty"][0] == 204


def test_request_counters_equal(runs):
    jax_counts = runs["jax"][1]
    port_counts = runs["port"][1]
    assert port_counts and port_counts == jax_counts


def _unordered(rows) -> list:
    """Each request's handler thread writes its record after answering,
    so consecutive requests may land in either order: compare sorted."""
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


_SIGNED_QUERY = re.compile(r"(X-Amz-(Signature|Date|Credential))=[^&]*")


def test_trace_records_equal(runs):
    """The trace hook publishes the same record per request (up to its
    time, duration and node, and the presigned URLs' signing values)."""
    def norm(rows):
        return _unordered(
            {**{k: v for k, v in r.items()
                if k not in ("time", "duration_ms", "node")},
             "query": _SIGNED_QUERY.sub(r"\1=", r["query"])}
            for r in rows
        )

    jax_rows = norm(runs["jax"][3])
    assert len(jax_rows) > len(STEPS) // 2
    assert norm(runs["port"][3]) == jax_rows


def test_audit_entries_equal(runs):
    """MINIO_TPU_AUDIT_LOG_FILE gets the same entry per request (up to
    its time and time to response)."""
    def norm(rows):
        out = []
        for r in rows:
            r = dict(r, api=dict(r["api"]))
            r.pop("time")
            r["api"].pop("timeToResponse_ms")
            out.append(r)
        return _unordered(out)

    jax_rows = norm(runs["jax"][4])
    assert len(jax_rows) > len(STEPS) // 2
    assert norm(runs["port"][4]) == jax_rows


def _objects(root: str) -> list:
    """(volume/object path, xl.meta docs, part files) under one disk."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        if "xl.meta" not in files:
            continue
        rel = os.path.relpath(dirpath, root)
        if rel.startswith(os.path.join(".sys", "tmp")):
            continue
        raw = open(os.path.join(dirpath, "xl.meta"), "rb").read()
        docs, parts = [], []
        for v in XLMeta.from_bytes(raw).versions:
            d = v.to_dict()
            data_dir = d.pop("data_dir")
            for volatile in ("mod_time_ns", "version_id"):
                d.pop(volatile)
            docs.append(d)
            if data_dir:
                ddir = os.path.join(dirpath, data_dir)
                for name in sorted(os.listdir(ddir)):
                    with open(os.path.join(ddir, name), "rb") as f:
                        parts.append((name, f.read()))
        out.append((rel, docs, parts))
    return sorted(out)


@pytest.mark.parametrize("disk", range(N))
def test_disks_equal(runs, disk):
    jax_objs = _objects(runs["jax"][2][disk])
    port_objs = _objects(runs["port"][2][disk])
    assert [o[0] for o in port_objs] == [o[0] for o in jax_objs]
    # the bucket documents and the listed objects are all there
    assert any(o[0].startswith(".sys") for o in port_objs)
    for (rel, tdocs, tparts), (_rel, jdocs, jparts) in zip(
        port_objs, jax_objs
    ):
        assert tdocs == jdocs, rel
        assert tparts == jparts, rel


# -- the port alone: unported routes and knobs -----------------------------


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("port-only")
        srv = _start("port", [str(base / f"d{i}") for i in range(N)])
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        assert c.put_object("bkt", "obj", b"hello").status == 200
        yield srv, c
        srv.shutdown()
        tbackend.reset_backend()


def _ep(c):
    return f"http://{c.host}:{c.port}"


UNPORTED = [
    # (name, slice, request)
    ("web_rpc", "9c", lambda c: _raw(_ep(c), "POST", "/minio-tpu/webrpc")),
    ("console", "9c", lambda c: _raw(_ep(c), "GET", "/minio-tpu/console")),
    ("sts", "9c", lambda c: c.request(
        "POST", "/", body=b"Action=AssumeRole&Version=2011-06-15",
        headers={"content-type": "application/x-www-form-urlencoded"})),
]

# the routes and headers slice 9c serves, once refused here: (name,
# expected status, request), sent to both servers in this order
# (tests/test_torch_bucket_config_server.py, test_torch_events_server.py,
# test_torch_replication.py and test_torch_disk_cache.py cover each in
# depth)
SERVED_9C = [
    ("admin", 200, lambda c: c.request(
        "GET", "/minio-tpu/admin/v1/cache-stats")),
    ("listen_notification", 400, lambda c: c.request(
        "GET", "/bkt", query={"events": "s3:ObjectCreated:Nope"})),
    ("bucket_notification", 200, lambda c: c.request(
        "GET", "/bkt", query={"notification": ""})),
    ("bucket_replication", 404, lambda c: c.request(
        "GET", "/bkt", query={"replication": ""})),
    ("object_tagging_get", 200, lambda c: c.request(
        "GET", "/bkt/obj", query={"tagging": ""})),
    ("object_tagging_put", 200, lambda c: c.request(
        "PUT", "/bkt/obj", query={"tagging": ""}, body=b"<Tagging/>")),
    ("object_tagging_delete", 204, lambda c: c.request(
        "DELETE", "/bkt/obj", query={"tagging": ""})),
    ("tagging_header_put", 200, lambda c: c.put_object(
        "bkt", "tagged", b"x", headers={"x-amz-tagging": "a=b"})),
    ("bucket_tagging", 404, lambda c: c.request(
        "GET", "/bkt", query={"tagging": ""})),
    ("retention_get", 400, lambda c: c.request(
        "GET", "/bkt/obj", query={"retention": ""})),
    ("legal_hold_put", 400, lambda c: c.request(
        "PUT", "/bkt/obj", query={"legal-hold": ""}, body=b"<LegalHold/>")),
    ("lock_headers_put", 400, lambda c: c.put_object(
        "bkt", "locked", b"x", headers={
            "x-amz-object-lock-legal-hold": "ON"})),
    ("bucket_object_lock", 404, lambda c: c.request(
        "GET", "/bkt", query={"object-lock": ""})),
    ("bucket_create_lock_enabled", 200, lambda c: c.request(
        "PUT", "/lockbkt", headers={
            "x-amz-bucket-object-lock-enabled": "true"})),
    ("bucket_lifecycle", 400, lambda c: c.request(
        "PUT", "/bkt", query={"lifecycle": ""}, body=b"<Lifecycle/>")),
    ("object_acl", 200, lambda c: c.request(
        "GET", "/bkt/obj", query={"acl": ""})),
    ("bucket_acl", 200, lambda c: c.request(
        "PUT", "/bkt", query={"acl": ""})),
]


@pytest.mark.parametrize(
    "name,slice_name,send", UNPORTED, ids=[u[0] for u in UNPORTED]
)
def test_unported_route_names_its_slice(port_server, name, slice_name,
                                        send):
    _srv, c = port_server
    status, _headers, body = _res(send(c))
    assert status == 501, body
    assert b"<Code>NotImplemented</Code>" in body
    assert f"(slice {slice_name})".encode() in body


@pytest.mark.parametrize(
    "name,status,send", SERVED_9C, ids=[u[0] for u in SERVED_9C]
)
def test_served_route_answers_as_the_reference(both_servers, name, status,
                                               send):
    """Each route of slice 9c's first half that answered NotImplemented
    here before answers as the JAX package's server does."""
    _srvs, clients = both_servers
    got = {k: _normalize(_res(send(c))) for k, c in clients.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == status, got["port"]


@pytest.mark.parametrize("field,value", [
    ("object_lock_xml",
     "<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
     "</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
     "<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>"),
    ("quota_json", '{"quota": 5, "quotatype": "hard"}'),
])
def test_served_bucket_config_applies_to_put(both_servers, field, value):
    """A bucket document that sets a quota or object lock (as the admin
    and bucket routes write it) takes PUTs again, as the JAX package's
    does: the lock default stamps the version, the quota refuses a PUT
    past it."""
    srvs, clients = both_servers
    bucket = "cfg-" + field.replace("_", "-")
    got = {}
    for kind, c in clients.items():
        assert c.make_bucket(bucket).status == 200
        srvs[kind].bucket_meta.update(bucket, **{field: value})
        put = _normalize(_res(c.put_object(bucket, "k", b"payload")))
        meta = {}
        if put[0] == 200:
            meta = srvs[kind].object_layer.get_object_info(
                bucket, "k").user_defined
        got[kind] = (put, sorted(meta))
        srvs[kind].bucket_meta.update(bucket, **{field: ""})
    assert got["port"] == got["jax"]
    if field == "quota_json":
        assert got["port"][0][0] == 400
        assert b"XMinioAdminBucketQuotaExceeded" in got["port"][0][2]
    else:
        assert got["port"][0][0] == 200
        assert "x-amz-object-lock-mode" in got["port"][1]


# -- slice 8's routes, once refused, held against the JAX package ----------

SSE_CONFIG = (
    b'<ServerSideEncryptionConfiguration xmlns="http://s3.amazonaws.com/'
    b'doc/2006-03-01/"><Rule><ApplyServerSideEncryptionByDefault>'
    b"<SSEAlgorithm>AES256</SSEAlgorithm>"
    b"</ApplyServerSideEncryptionByDefault></Rule>"
    b"</ServerSideEncryptionConfiguration>"
)


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """A JAX and a port server over plain HTTP, one master key in both
    packages' KMS; bucket ``bkt`` holds ``obj``."""
    mk = bytes(range(32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        tkms.set_kms(tkms.MasterKeyKMS("mk1", mk))
        jkms.set_kms(jkms.MasterKeyKMS("mk1", mk))
        base = tmp_path_factory.mktemp("sse-both")
        srvs = {
            kind: _start(kind, [str(base / f"{kind}{i}") for i in range(N)])
            for kind in ("jax", "port")
        }
        clients = {k: S3Client(v.endpoint) for k, v in srvs.items()}
        for c in clients.values():
            assert c.make_bucket("bkt").status == 200
            assert c.make_bucket("encb").status == 200
            assert c.put_object("bkt", "obj", b"hello").status == 200
        try:
            yield srvs, clients
        finally:
            for srv in srvs.values():
                srv.shutdown()
            for mod in (tkms, jkms):
                mod.set_kms(None)
                mod.reset_kms_cache()


# (name, expected status, request): sent to both servers in this order
SSE_SERVED = [
    ("sse_s3_put", 200, lambda c: c.put_object(
        "bkt", "enc", b"x" * 5000,
        headers={"x-amz-server-side-encryption": "AES256"})),
    ("sse_s3_get", 200, lambda c: c.get_object("bkt", "enc")),
    ("sse_s3_head", 200, lambda c: c.head_object("bkt", "enc")),
    ("sse_kms_put", 501, lambda c: c.put_object(
        "bkt", "enc", b"x", headers={"x-amz-server-side-encryption": "aws:kms"})),
    ("sse_bad_algo_put", 400, lambda c: c.put_object(
        "bkt", "enc", b"x", headers={"x-amz-server-side-encryption": "DES"})),
    ("sse_c_get", 400, lambda c: c.get_object("bkt", "obj", headers={
        "x-amz-server-side-encryption-customer-algorithm": "AES256"})),
    ("bucket_encryption_get_missing", 404, lambda c: c.request(
        "GET", "/encb", query={"encryption": ""})),
    ("bucket_encryption_put_kms", 501, lambda c: c.request(
        "PUT", "/encb", query={"encryption": ""},
        body=SSE_CONFIG.replace(b"AES256", b"aws:kms"))),
    ("bucket_encryption_put_malformed", 400, lambda c: c.request(
        "PUT", "/encb", query={"encryption": ""}, body=b"<not-xml")),
    ("bucket_encryption_put", 200, lambda c: c.request(
        "PUT", "/encb", query={"encryption": ""}, body=SSE_CONFIG)),
    ("bucket_encryption_get", 200, lambda c: c.request(
        "GET", "/encb", query={"encryption": ""})),
    ("bucket_default_put", 200, lambda c: c.put_object(
        "encb", "d", b"default encrypted")),
    ("bucket_default_head", 200, lambda c: c.head_object("encb", "d")),
    ("bucket_encryption", 204, lambda c: c.request(
        "DELETE", "/encb", query={"encryption": ""})),
    ("bucket_plain_put", 200, lambda c: c.put_object("encb", "p", b"plain")),
]


@pytest.mark.parametrize(
    "name,status,send", SSE_SERVED, ids=[u[0] for u in SSE_SERVED]
)
def test_sse_route_answers_as_the_reference(both_servers, name, status,
                                            send):
    """The routes and headers that slice 8 ports, refused as
    NotImplemented before, answer as the JAX package's server answers:
    SSE-S3 under a KMS, SSE-KMS NotImplemented, SSE-C over plain HTTP
    InvalidRequest, and the bucket ``?encryption`` documents."""
    _srvs, clients = both_servers
    got = {k: _normalize(_res(send(c))) for k, c in clients.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == status, got["port"]
    if name in ("sse_s3_put", "sse_s3_get", "bucket_default_put",
                "bucket_default_head"):
        assert got["port"][1]["x-amz-server-side-encryption"] == "AES256"
    if name == "bucket_plain_put":
        assert "x-amz-server-side-encryption" not in got["port"][1]


def test_bucket_default_encryption_is_stored_sealed(both_servers):
    """A bucket whose document sets a default rule (as the JAX package's
    ``?encryption`` route writes it) stores SSE-S3 objects: the seam that
    refused ``sse_config_xml`` now applies it, and the object's metadata
    carries the same transform as the JAX package's."""
    srvs, clients = both_servers
    metas = {}
    for kind, srv in srvs.items():
        srv.bucket_meta.update("bkt", sse_config_xml=SSE_CONFIG.decode())
        r = clients[kind].put_object("bkt", "dflt", b"payload" * 100)
        assert r.status == 200
        assert r.headers["x-amz-server-side-encryption"] == "AES256"
        srv.bucket_meta.update("bkt", sse_config_xml="")
        info = srv.object_layer.get_object_info("bkt", "dflt")
        metas[kind] = {k: v for k, v in info.user_defined.items()
                       if k.startswith("x-internal-sse")
                       and not k.endswith(("sealed-key", "sealed-dk",
                                           "nonce"))}
        assert info.size == 700
        assert clients[kind].get_object("bkt", "dflt").body == b"payload" * 100
    assert metas["port"] == metas["jax"]
    assert metas["port"]["x-internal-sse"] == "S3"


@pytest.mark.parametrize("field,versioned,status", [
    ("object_lock_xml", False, 204),
    ("object_lock_xml", True, 204),
    ("notification_xml", False, 204),
    ("replication_xml", False, 204),
])
def test_delete_seams(port_server, field, versioned, status):
    """DELETE consults what the JAX package's DELETE consults: object
    lock where it guards the data (not for a delete marker; a version
    without retention or legal hold goes) and the event rules;
    replication does not touch a DELETE there either."""
    srv, c = port_server
    bucket = f"del-{field.split('_')[0]}-{int(versioned)}"
    assert c.make_bucket(bucket).status == 200
    assert c.put_object(bucket, "k", b"payload").status == 200
    fields = {field: "set"}
    if versioned:
        fields["versioning"] = "Enabled"
    srv.bucket_meta.update(bucket, **fields)
    status_got, _h, body = _res(c.delete_object(bucket, "k"))
    assert status_got == status, body


def test_async_server_mode_names_slice_5b(tmp_path, monkeypatch):
    """MINIO_TPU_SERVER=async, the event-loop plane slice 5b ports: the
    server starts on it and serves (tests/test_torch_aio.py holds it
    against the JAX package's)."""
    monkeypatch.setenv("MINIO_TPU_SERVER", "async")
    monkeypatch.setenv("MINIO_TPU_SERVER_LOOPS", "2")
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                        parity_blocks=M, block_size=BLOCK, device="cpu")
    srv = S3Server(ol, address="127.0.0.1:0")
    try:
        srv.start()
        assert srv.server_mode == "async"
        assert len(srv._plane.loops) == 2 and srv._plane.loops_ready()
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        assert c.put_object("bkt", "obj", b"hello").status == 200
        r = c.get_object("bkt", "obj")
        assert (r.status, r.body) == (200, b"hello")
    finally:
        srv.shutdown()
    assert [sl.state for sl in srv._plane.loops] == ["stopped"] * 2


def test_unset_server_mode_is_threaded(port_server, tmp_path, monkeypatch):
    """The plane a server starts on: MINIO_TPU_SERVER=threaded (this
    module's fixture) gives the threaded oracle; unset, the default is
    the async plane since slice 5b, as in the JAX package."""
    srv, _c = port_server
    assert srv.server_mode == "threaded" and srv._plane is None
    assert thttp.DEFAULT_SERVER_MODE == "async"
    monkeypatch.delenv("MINIO_TPU_SERVER", raising=False)
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                        parity_blocks=M, block_size=BLOCK, device="cpu")
    unset = S3Server(ol, address="127.0.0.1:0").start()
    try:
        assert unset.server_mode == "async"
    finally:
        unset.shutdown()


def test_admin_info_answers(port_server):
    """The admin API answers the owner (it was NotImplemented before
    slice 5b) and refuses anyone else."""
    srv, c = port_server
    r = c.request("GET", "/minio-tpu/admin/v1/info")
    assert r.status == 200
    doc = json.loads(r.body)
    assert doc["storage"]["disks"] == N and doc["mode"] == "erasure"
    r = c.request("GET", "/minio-tpu/admin/v1/loops/status")
    assert json.loads(r.body)["mode"] == "threaded"
    other = S3Client(srv.endpoint, access_key="nobody")
    assert other.request("GET", "/minio-tpu/admin/v1/info").status == 403


def test_event_target_env_configures_the_server(tmp_path, monkeypatch):
    """A configured webhook target (once refused naming slice 9c) is
    built by ``targets_from_env`` and registered with the server's
    notifier, as the JAX package's server registers it."""
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_PRIMARY", "on")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_PRIMARY",
                       "http://127.0.0.1:1/hook")
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                        parity_blocks=M, block_size=BLOCK, device="cpu")
    jol = JaxObjects([JaxStorage(str(tmp_path / f"j{i}")) for i in range(N)],
                     parity_blocks=M, block_size=BLOCK)
    srvs = [S3Server(ol, address="127.0.0.1:0"),
            JaxServer(jol, address="127.0.0.1:0")]
    try:
        arns = [sorted(s.events.known_arns) for s in srvs]
        assert arns[0] == arns[1] == ["arn:minio:sqs::PRIMARY:webhook"]
    finally:
        for s in srvs:
            s.events.shutdown()
            s.console.uninstall()


def test_internode_and_federation_name_slice_9b(port_server):
    """The internode planes (once slice 9b) are served: a mounted plane
    answers its prefix, with the JWT checked before the body; federation
    (once slice 9d) is served: a bucket another cluster owns in the
    shared bucket DNS answers 307 to its owner, a bucket of this server
    is served locally, and a name no cluster holds is a 404."""
    from minio_tpu_torch.cluster.dns import BucketDNS, MemoryDNSStore
    from minio_tpu_torch.utils import jwt as tjwt

    srv, c = port_server
    calls = []

    def plane(tail, query, body, headers):
        calls.append((tail, body))
        return 200, b"pong", {}

    srv.register_internode("/minio-tpu/test/v1", plane)
    srv.internode_secret = "internode-secret"
    try:
        bad = _raw(_ep(c), "POST", "/minio-tpu/test/v1/ping", body=b"x")
        token = tjwt.sign({"sub": "n"}, "internode-secret")
        good = _raw(_ep(c), "POST", "/minio-tpu/test/v1/ping", body=b"x",
                    headers={"Authorization": f"Bearer {token}"})
    finally:
        srv.internode_secret = ""
        srv.internode.pop("/minio-tpu/test/v1")
    assert bad[0] == 401
    assert good[0] == 200 and good[2] == b"pong"
    assert calls == [("ping", b"x")]
    store = MemoryDNSStore()
    BucketDNS(store, "127.0.0.2", 9555).register("remote-bkt")
    srv.bucket_dns = BucketDNS(store, c.host, c.port)
    try:
        remote = _res(c.get_object("remote-bkt", "k"))
        local = _res(c.get_object("bkt", "obj"))
        missing = _res(c.get_object("no-such-bkt", "k"))
    finally:
        srv.bucket_dns = None
    assert remote[0] == 307, remote
    assert remote[1]["location"] == "http://127.0.0.2:9555/remote-bkt/k"
    assert local[0] == 200 and local[2] == b"hello"
    assert missing[0] == 404


def test_ported_routes_still_answer(port_server):
    """The unported-route tests above left the ported ones working."""
    _srv, c = port_server
    r = c.get_object("bkt", "obj")
    assert (r.status, r.body) == (200, b"hello")


def test_concurrent_clients(port_server, tmp_path):
    """Four clients, each on its own connection, PUT (one aws-chunked)
    and GET at once through the threaded plane: every body comes back
    and the part files equal those the JAX package writes for the same
    objects one at a time."""
    import concurrent.futures
    import io

    srv, c = port_server
    assert c.make_bucket("conc").status == 200
    payloads = {f"t{t}/o{i}": _pay(BLOCK * (3 + i) + t, 100 * t + i)
                for t in range(4) for i in range(2)}

    def client(t):
        cl = S3Client(srv.endpoint)
        for i in range(2):
            key = f"t{t}/o{i}"
            if t == 0 and i == 1:
                r = cl.put_object_streaming("conc", key, payloads[key],
                                            chunk_size=5000)
            else:
                r = cl.put_object("conc", key, payloads[key])
            assert r.status == 200, r.body
        return {k: cl.get_object("conc", k).body
                for k in payloads if k.startswith(f"t{t}/")}

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        got = {}
        for part in pool.map(client, range(4)):
            got.update(part)
    assert got == payloads
    roots = [str(tmp_path / f"j{i}") for i in range(N)]
    ref = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                     block_size=BLOCK)
    ref.make_bucket("conc")
    for key, data in payloads.items():
        ref.put_object("conc", key, io.BytesIO(data), len(data))
    port_roots = [d.root for d in _xl_disks(srv.object_layer)]
    for pr, jr in zip(port_roots, roots):
        want = [o for o in _objects(jr) if o[0].startswith("conc")]
        have = [o for o in _objects(pr) if o[0].startswith("conc")]
        assert [o[0] for o in have] == [o[0] for o in want]
        for (rel, tdocs, tparts), (_r, jdocs, jparts) in zip(have, want):
            assert tparts == jparts, rel


def _xl_disks(ol):
    """The XLStorage under each metered disk of a port object layer."""
    out = []
    for d in ol.disks:
        while not isinstance(d, XLStorage):
            d = d.unwrapped
        out.append(d)
    return out


def _parked_put(endpoint: str, path: str, body: bytes):
    """A signed UNSIGNED-PAYLOAD PUT sent with ``Expect: 100-continue``
    and held after the server's interim 100: the handler stays inside
    the request, reading a body that has not come yet.  Returns the
    socket and the body still to send."""
    import socket

    p = urllib.parse.urlsplit(endpoint)
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ")
    headers = {"host": f"{p.hostname}:{p.port}", "x-amz-date": amz_date,
               "x-amz-content-sha256": jauth.UNSIGNED_PAYLOAD}
    signed = sorted(headers)
    sig = jauth.sign_v4("PUT", path, {}, headers, signed,
                        jauth.UNSIGNED_PAYLOAD, "minioadmin", "minioadmin",
                        amz_date)
    headers["authorization"] = (
        f"{jauth.SIGN_V4_ALGORITHM} Credential=minioadmin/{amz_date[:8]}/"
        f"us-east-1/s3/aws4_request, SignedHeaders={';'.join(signed)}, "
        f"Signature={sig}")
    headers["expect"] = "100-continue"
    headers["content-length"] = str(len(body))
    sock = socket.create_connection((p.hostname, p.port), timeout=30)
    head = f"PUT {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
    sock.sendall(head.encode())
    got = b""
    while b"\r\n\r\n" not in got:
        got += sock.recv(4096)
    assert got.startswith(b"HTTP/1.1 100"), got
    return sock, body


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_tenant_shedding(tmp_path, monkeypatch, kind):
    """MINIO_TPU_TENANT_MAX_INFLIGHT=1: while one request of a tenant is
    inside the server, its next one is shed with 503 SlowDown (reason
    tenant) on both packages' threaded plane; the first then completes."""
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_TENANT_MAX_INFLIGHT", "1")
    srv = _start(kind, [str(tmp_path / f"d{i}") for i in range(N)])
    try:
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        # the bucket create's handler leaves its tenant slot just after
        # answering: wait until it has, so the parked PUT is the tenant's
        # only request inside the server
        assert _until(lambda: not srv.admission.tenant_inflight())
        sock, body = _parked_put(srv.endpoint, "/bkt/parked", b"x" * 5000)
        try:
            shed = c.get_object("bkt", "parked")
            sock.sendall(body)
            reply = b""
            while b"\r\n\r\n" not in reply:
                reply += sock.recv(4096)
        finally:
            sock.close()
        assert (shed.status, shed.error_code) == (503, "SlowDown")
        assert reply.startswith(b"HTTP/1.1 200"), reply
        assert srv.plane_stats.snapshot()["shed"]["tenant"] == 1
        assert _until(lambda: not srv.admission.tenant_inflight())
        assert c.get_object("bkt", "parked").body == b"x" * 5000
    finally:
        srv.shutdown()
