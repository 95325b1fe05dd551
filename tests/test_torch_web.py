"""The port's web plane held against minio_tpu's, over real HTTP.

Each test of ``tests/test_web.py`` runs on a JAX and a port
``S3Server`` side by side (``tests/test_torch_server.py``'s deployment:
six temp-dir disks, EC 4+2, 4 KiB blocks, the port on the CPU; the JAX
server on the threaded plane).  The same JSON-RPC calls, uploads,
downloads and zip requests go to both, and the answers must be equal
after normalization - exact equality of:

* the JSON-RPC documents, with login and URL tokens, ``serverTime_ns``,
  ``creationDate_ns``, ``lastModified_ns``, generated credentials and the
  presigned URL's endpoint and signing values replaced by placeholders;
* statuses, headers and bodies of the transfer endpoints, normalized as
  ``tests/test_torch_server.py`` normalizes them (``Date``,
  ``x-amz-request-id``, ``Last-Modified``, ``<RequestId>``), zip archives
  byte for byte;
* the part files and ``xl.meta`` (up to mod time, data dir and version
  id) an upload leaves on every disk, a bucket with default SSE-S3
  included (``secrets.token_bytes`` pinned to one seed before each
  package's upload, as ``tests/test_torch_sse.py`` pins it), and the
  events an upload fires.

Tokens cross packages: both servers sign with the root secret through
identical ``jwt`` modules, so a token minted by either is accepted by the
other.  The transfer tests run with the port on the threaded and on the
async plane.
"""

from __future__ import annotations

import io
import json
import os
import re
import secrets
import urllib.parse
import zipfile

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec import kms as jkms
from minio_tpu.codec import sse as jsse
from minio_tpu.objectlayer import objectlock as jolock
from minio_tpu.server import console_ui as jconsole
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import kms as tkms
from minio_tpu_torch.codec import sse as tsse
from minio_tpu_torch.objectlayer import objectlock as tolock
from minio_tpu_torch.server import console_ui as tconsole
from tests.s3client import S3Client
from tests.test_torch_server import (
    N, _normalize, _objects, _pay, _raw, _start,
)
from tests.test_torch_sse import _Pinned
from tests.test_torch_threads import torch_threads  # noqa: F401

RPC = "/minio-tpu/webrpc"
KINDS = ("jax", "port")
MK = bytes(range(32))
ROOT = {"username": "minioadmin", "password": "minioadmin"}
# normalized JSON-RPC fields: fresh per call or per server
_VOLATILE_KEYS = {
    "token": "<token>",
    "serverTime_ns": 0,
    "creationDate_ns": 0,
    "lastModified_ns": 0,
    "accessKey": "<access-key>",
    "secretKey": "<secret-key>",
}
_SIGNING = re.compile(r"(X-Amz-(Signature|Date|Credential))=[^&]*")


@pytest.fixture(scope="module", params=["threaded", "async"])
def pair(request, tmp_path_factory):
    """A JAX server (threaded plane) and a port server on the plane the
    parameter names, one master key in both packages' KMS."""
    plane = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        tkms.set_kms(tkms.MasterKeyKMS("mk1", MK))
        jkms.set_kms(jkms.MasterKeyKMS("mk1", MK))
        base = tmp_path_factory.mktemp(f"web-{plane}")
        srvs, roots = {}, {}
        try:
            for kind in KINDS:
                mp.setenv("MINIO_TPU_SERVER",
                          "threaded" if kind == "jax" else plane)
                roots[kind] = [str(base / f"{kind}{i}") for i in range(N)]
                srvs[kind] = _start(kind, roots[kind])
            yield srvs, roots
        finally:
            for srv in srvs.values():
                srv.shutdown()
            for mod in (tkms, jkms):
                mod.set_kms(None)
                mod.reset_kms_cache()
            jbackend.reset_backend()
            tbackend.reset_backend()


# the RPC-only tests need one plane: the threaded pair
threaded = pytest.mark.parametrize("pair", ["threaded"], indirect=True)


def _norm(doc, endpoint: str):
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in _VOLATILE_KEYS and v:
                out[k] = _VOLATILE_KEYS[k]
            elif k == "url":
                out[k] = _SIGNING.sub(r"\1=", v.replace(endpoint, "<ep>"))
            else:
                out[k] = _norm(v, endpoint)
        return out
    if isinstance(doc, list):
        return [_norm(v, endpoint) for v in doc]
    return doc


def _rpc(srv, method, params=None, token=None) -> dict:
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    status, _h, body = _raw(
        srv.endpoint, "POST", RPC,
        headers,
        json.dumps({"id": 1, "jsonrpc": "2.0", "method": method,
                    "params": params or {}}).encode(),
    )
    assert status == 200, body
    return json.loads(body)


def _token(srv, creds=None) -> str:
    doc = _rpc(srv, "web.Login", creds or ROOT)
    assert "result" in doc, doc
    return doc["result"]["token"]


def _url_token(srv, token) -> str:
    return _rpc(srv, "web.CreateURLToken", {}, token)["result"]["token"]


def _http(srv, method, path, body=b"", headers=None):
    """(status, headers, body), normalized as the S3 front's tests do."""
    return _normalize(_raw(srv.endpoint, method, path, headers, body))


class _Run:
    """One package's side of a test: its server, a login token, and the
    answers collected in order (normalized)."""

    def __init__(self, srv):
        self.srv = srv
        self.token = _token(srv)
        self.out: list = []

    def rpc(self, method, params=None, token=None) -> dict:
        doc = _rpc(self.srv, method, params, token or self.token)
        self.out.append(_norm(doc, self.srv.endpoint))
        return doc

    def http(self, method, path, body=b"", headers=None):
        res = _http(self.srv, method, path, body, headers)
        self.out.append(res)
        return res

    def upload(self, bucket, key, data, token=None, ctype=None):
        headers = {"Authorization": f"Bearer {token or self.token}",
                   "Content-Length": str(len(data))}
        if ctype:
            headers["Content-Type"] = ctype
        return self.http("PUT", f"/minio-tpu/web/upload/{bucket}/"
                         + urllib.parse.quote(key), data, headers)


def _both(pair, steps) -> dict:
    """``steps(run, kind)`` on each package; the runs' answers equal."""
    srvs, _roots = pair
    runs = {}
    for kind in KINDS:
        runs[kind] = _Run(srvs[kind])
        steps(runs[kind], kind)
    assert runs["port"].out == runs["jax"].out
    return runs


def _stored(pair, bucket: str) -> dict:
    """Each package's xl.meta docs and part files of ``bucket``."""
    _srvs, roots = pair
    return {
        kind: [[o for o in _objects(r) if o[0].split(os.sep)[0] == bucket]
               for r in roots[kind]]
        for kind in KINDS
    }


def _assert_same_disks(pair, bucket: str) -> None:
    got = _stored(pair, bucket)
    assert got["port"] == got["jax"]
    assert all(got["port"]), "no object of the bucket on some disk"


# -- the RPC plane ---------------------------------------------------------


@threaded
def test_login_and_bad_credentials(pair):
    srvs, _roots = pair

    def steps(run, _kind):
        run.rpc("web.Login", ROOT)
        doc = run.rpc("web.Login", {"username": "minioadmin",
                                    "password": "wrong"})
        assert "error" in doc
        run.out.append(_rpc(run.srv, "web.ListBuckets"))
        run.out.append(_rpc(run.srv, "web.ListBuckets", token="junk"))

    runs = _both(pair, steps)
    assert "authentication" in runs["port"].out[2]["error"]["message"]
    assert "error" in runs["port"].out[3]
    # a login token minted by either package is accepted by the other
    for kind, other in (("port", "jax"), ("jax", "port")):
        doc = _rpc(srvs[other], "web.ListBuckets", {}, runs[kind].token)
        assert "result" in doc, (kind, doc)


@pytest.mark.parametrize("cross", [False, True], ids=["own", "cross"])
def test_bucket_and_object_rpc_flow(pair, cross):
    """MakeBucket, an upload, ListObjects, a download by URL token (the
    other package's token with ``cross``), a presigned GET, RemoveObject,
    DeleteBucket; the upload's part files equal."""
    srvs, _roots = pair
    bucket = "webbkt-" + ("x" if cross else "o")
    payload = _pay(3 * 4096 + 17, 7)
    tokens = {}

    def steps(run, kind):
        other = "jax" if kind == "port" else "port"
        assert "result" in run.rpc("web.MakeBucket", {"bucketName": bucket})
        run.rpc("web.ListBuckets")
        assert run.upload(bucket, "dir/f.bin", payload,
                          ctype="text/plain")[0] == 200
        run.rpc("web.ListObjects", {"bucketName": bucket, "prefix": "dir/"})
        url_token = _url_token(run.srv, run.token)
        if cross:
            url_token = _url_token(srvs[other], _token(srvs[other]))
        tokens[kind] = url_token
        run.http("GET", f"/minio-tpu/web/download/{bucket}/dir/f.bin?"
                 + urllib.parse.urlencode({"token": url_token}))
        # a login token is NOT a download token
        run.http("GET", f"/minio-tpu/web/download/{bucket}/dir/f.bin?"
                 + urllib.parse.urlencode({"token": run.token}))
        url = run.rpc("web.PresignedGet", {
            "bucketName": bucket, "objectName": "dir/f.bin"})["result"]["url"]
        p = urllib.parse.urlsplit(url)
        run.http("GET", f"{p.path}?{p.query}")

    runs = _both(pair, steps)
    _assert_same_disks(pair, bucket)

    def finish(run, _kind):
        run.rpc("web.RemoveObject", {"bucketName": bucket,
                                     "objects": ["dir/f.bin"]})
        run.rpc("web.DeleteBucket", {"bucketName": bucket})

    done = _both(pair, finish)
    out = runs["port"].out
    assert bucket in [b["name"] for b in out[1]["result"]["buckets"]]
    assert [o["name"] for o in out[3]["result"]["objects"]] == ["dir/f.bin"]
    assert out[3]["result"]["objects"][0]["size"] == len(payload)
    assert out[4][0] == 200 and out[4][2] == payload
    assert "attachment" in out[4][1]["content-disposition"]
    assert out[5][0] == 403
    assert out[7][0] == 200 and out[7][2] == payload
    assert done["port"].out[0]["result"] == {"removed": ["dir/f.bin"],
                                             "errors": []}
    assert "result" in done["port"].out[1]


@threaded
def test_policy_rpc_and_info(pair):
    policy = json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Principal": "*",
                       "Action": "s3:GetObject",
                       "Resource": "arn:aws:s3:::polbkt/*"}],
    })

    def steps(run, _kind):
        run.rpc("web.MakeBucket", {"bucketName": "polbkt"})
        run.rpc("web.SetBucketPolicy", {"bucketName": "polbkt",
                                        "policy": policy})
        run.rpc("web.GetBucketPolicy", {"bucketName": "polbkt"})
        run.rpc("web.SetBucketPolicy", {"bucketName": "polbkt",
                                        "policy": "{bad"})
        run.rpc("web.ServerInfo")
        run.rpc("web.StorageInfo")
        run.rpc("web.NoSuchMethod")

    out = _both(pair, steps)["port"].out
    assert "result" in out[1]
    assert json.loads(out[2]["result"]["policy"]) == json.loads(policy)
    assert "error" in out[3]
    assert out[4]["result"]["MinioRuntime"] == "python"
    assert out[5]["result"]["disks"] == N
    assert "unknown method" in out[6]["error"]["message"]


@threaded
def test_iam_user_can_login(pair):
    srvs, _roots = pair
    for srv in srvs.values():
        srv.iam.add_user("webuser", "webuser-secret-123", "readwrite")
    creds = {"username": "webuser", "password": "webuser-secret-123"}

    def steps(run, _kind):
        tok = _token(run.srv, creds)
        run.rpc("web.ListBuckets", {}, tok)

    assert "result" in _both(pair, steps)["port"].out[0]


@threaded
def test_readonly_user_cannot_mutate(pair):
    """Web calls run the same policy engine as the S3 plane: a read-only
    user stays read-only, in both packages alike."""
    srvs, _roots = pair
    for srv in srvs.values():
        srv.iam.add_user("rouser", "rouser-secret-123", "readonly")
    creds = {"username": "rouser", "password": "rouser-secret-123"}

    def steps(run, _kind):
        tok = _token(run.srv, creds)
        run.rpc("web.MakeBucket", {"bucketName": "robkt"}, tok)
        run.rpc("web.MakeBucket", {"bucketName": "robkt"})
        run.rpc("web.PresignedGet", {"bucketName": "robkt",
                                     "objectName": "x"}, tok)
        run.rpc("web.ListObjects", {"bucketName": "robkt"}, tok)
        run.rpc("web.DeleteBucket", {"bucketName": "robkt"}, tok)
        run.rpc("web.RemoveObject", {"bucketName": "robkt",
                                     "objects": ["x"]}, tok)
        run.upload("robkt", "f", b"nope", token=tok)

    out = _both(pair, steps)["port"].out
    assert "error" in out[0] and "result" in out[1] and "result" in out[2]
    assert "error" in out[3] and "error" in out[4]
    assert out[5]["result"]["errors"] and not out[5]["result"]["removed"]
    assert out[6][0] == 403


@threaded
def test_sts_credentials_cannot_login(pair):
    def steps(run, _kind):
        cred = run.srv.iam.assume_role("minioadmin", duration_s=900)
        run.out.append(_rpc(run.srv, "web.Login", {
            "username": cred["access_key"], "password": cred["secret"]}))

    doc = _both(pair, steps)["port"].out[0]
    assert "temporary" in doc["error"]["message"]


def test_download_filename_sanitized(pair):
    evil = 'f\r\nSet-Cookie: x=1;.txt'

    def steps(run, _kind):
        run.rpc("web.MakeBucket", {"bucketName": "injbkt"})
        run.upload("injbkt", evil, b"data")
        run.http("GET", "/minio-tpu/web/download/injbkt/"
                 + urllib.parse.quote(evil) + "?"
                 + urllib.parse.urlencode(
                     {"token": _url_token(run.srv, run.token)}))

    out = _both(pair, steps)["port"].out
    assert out[1][0] == 200
    status, headers, body = out[2]
    assert status == 200 and body == b"data"
    assert "set-cookie" not in headers
    assert "\r" not in headers["content-disposition"]
    _assert_same_disks(pair, "injbkt")


@threaded
def test_console_page_served(pair):
    def steps(run, _kind):
        run.http("GET", "/minio-tpu/console")
        run.http("POST", "/minio-tpu/console")

    out = _both(pair, steps)["port"].out
    status, headers, body = out[0]
    assert status == 200 and "text/html" in headers["content-type"]
    assert body == tconsole.CONSOLE_HTML == jconsole.CONSOLE_HTML
    assert b"minio-tpu console" in body and b"web.Login" in body
    assert out[1][0] == 405


# -- uploads through the PUT invariant chain -------------------------------


SSE_CONFIG = (
    b"<ServerSideEncryptionConfiguration><Rule>"
    b"<ApplyServerSideEncryptionByDefault>"
    b"<SSEAlgorithm>AES256</SSEAlgorithm>"
    b"</ApplyServerSideEncryptionByDefault>"
    b"</Rule></ServerSideEncryptionConfiguration>"
)


def test_web_upload_honors_bucket_sse_and_emits_event(pair, monkeypatch):
    """The web upload applies the bucket's default SSE and fires
    s3:ObjectCreated:Put like the S3 PUT; with the random sources pinned
    the two packages write the same sealed keys and part files."""
    payload = _pay(2 * 4096 + 5, 8)
    events = {}

    def steps(run, kind):
        srv = run.srv
        c = S3Client(srv.endpoint)
        run.rpc("web.MakeBucket", {"bucketName": "webenc"})
        run.out.append(c.request("PUT", "/webenc", query={"encryption": ""},
                                 body=SSE_CONFIG).status)
        events[kind] = []
        monkeypatch.setattr(srv.events, "send", events[kind].append)
        # the no-rules, no-listeners short cut would skip send
        monkeypatch.setattr(srv.events, "has_listeners", lambda b: True)
        monkeypatch.setattr(secrets, "token_bytes", _Pinned(25))
        run.upload("webenc", "secret", payload)
        monkeypatch.undo()
        info = srv.object_layer.get_object_info("webenc", "secret")
        meta = (tsse if kind == "port" else jsse).META_SSE
        run.out.append(info.user_defined.get(meta))
        r = c.get_object("webenc", "secret")
        run.out.append((r.status, r.body))

    out = _both(pair, steps)["port"].out
    assert out[1] == 200 and out[2][0] == 200
    assert out[3] == "S3" and out[4] == (200, payload)
    got = {kind: [(e.name, e.bucket, e.object_key, e.etag, e.size,
                   e.identity.principal_id) for e in evs]
           for kind, evs in events.items()}
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == ["s3:ObjectCreated:Put"]
    assert got["port"][0][-1] == "minioadmin"
    _assert_same_disks(pair, "webenc")


def test_web_download_ssec_clean_error(pair, monkeypatch):
    """An SSE-C object fails the web download before its headers."""
    def steps(run, kind):
        run.rpc("web.MakeBucket", {"bucketName": "webssec"})
        sse = tsse if kind == "port" else jsse
        monkeypatch.setattr(secrets, "token_bytes", _Pinned(26))
        run.srv.object_layer.put_object(
            "webssec", "locked", io.BytesIO(b"secret-data"), 11,
            sse=sse.SSESpec("C", b"C" * 32))
        monkeypatch.undo()
        run.http("GET", "/minio-tpu/web/download/webssec/locked?"
                 + urllib.parse.urlencode(
                     {"token": _url_token(run.srv, run.token)}))
        run.http("POST", "/minio-tpu/web/zip?"
                 + urllib.parse.urlencode(
                     {"token": _url_token(run.srv, run.token)}),
                 json.dumps({"bucketName": "webssec",
                             "objects": ["locked"]}).encode(),
                 {"Content-Type": "application/json"})

    out = _both(pair, steps)["port"].out
    assert out[1][0] == 400 and b"Server Side Encryption" in out[1][2]
    assert out[2][0] == 400 and b"SSE-C" in out[2][2]


def test_web_upload_enforces_quota(pair):
    def steps(run, _kind):
        c = S3Client(run.srv.endpoint)
        run.rpc("web.MakeBucket", {"bucketName": "webq"})
        run.out.append(c.request(
            "PUT", "/minio-tpu/admin/v1/set-bucket-quota",
            query={"bucket": "webq"},
            body=json.dumps({"quota": 10, "quotatype": "hard"}).encode(),
        ).status)
        run.upload("webq", "big", b"x" * 100)
        run.upload("webq", "small", b"x" * 5)

    out = _both(pair, steps)["port"].out
    assert out[1] == 200
    assert out[2][0] == 400 and b"QuotaExceeded" in out[2][2]
    assert out[3][0] == 200
    _assert_same_disks(pair, "webq")


LOCK_CONFIG = (
    b"<ObjectLockConfiguration>"
    b"<ObjectLockEnabled>Enabled</ObjectLockEnabled>"
    b"<Rule><DefaultRetention><Mode>COMPLIANCE</Mode>"
    b"<Days>1</Days></DefaultRetention></Rule>"
    b"</ObjectLockConfiguration>"
)


def test_web_upload_applies_default_retention(pair, monkeypatch):
    """The bucket's default retention stamps web uploads too (else the
    web plane were a WORM bypass), and the WORM guard holds the locked
    version; the stamped documents are equal with the clock pinned."""
    import datetime

    now = datetime.datetime(2030, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)
    for mod in (tolock, jolock):
        monkeypatch.setattr(mod, "utcnow", lambda: now)

    def steps(run, _kind):
        c = S3Client(run.srv.endpoint)
        run.out.append(c.request("PUT", "/webworm", headers={
            "x-amz-bucket-object-lock-enabled": "true"}).status)
        run.out.append(c.request("PUT", "/webworm", query={
            "object-lock": ""}, body=LOCK_CONFIG).status)
        run.upload("webworm", "precious", b"keep-me")
        info = run.srv.object_layer.get_object_info("webworm", "precious")
        run.out.append({k: v for k, v in info.user_defined.items()
                        if "object-lock" in k})
        r = c.request("DELETE", "/webworm/precious",
                      query={"versionId": info.version_id})
        run.out.append((r.status, b"WORM" in r.body))

    out = _both(pair, steps)["port"].out
    assert out[0] == out[1] == 200 and out[2][0] == 200
    assert out[3]["x-amz-object-lock-mode"] == "COMPLIANCE"
    assert out[4][0] in (400, 403) and out[4][1]
    _assert_same_disks(pair, "webworm")


# -- the zip download ------------------------------------------------------


def test_web_download_zip(pair):
    """DownloadZip: objects and prefixes in, one streamed archive out,
    byte-equal between the packages; every entry holds the stored
    bytes; a bad token is refused before any byte."""
    payloads = {
        "a.txt": b"alpha" * 100,
        "docs/one.md": b"# one",
        "docs/two.md": b"# two" * 50,
        "docs/deep/three.bin": _pay(5 * 4096 + 3, 9),
    }

    def steps(run, _kind):
        c = S3Client(run.srv.endpoint)
        run.rpc("web.MakeBucket", {"bucketName": "zipbkt"})
        for k, v in payloads.items():
            assert c.put_object("zipbkt", k, v).status == 200
        url_token = _url_token(run.srv, run.token)
        for doc in ({"bucketName": "zipbkt", "prefix": "",
                     "objects": ["a.txt", "docs/"]},
                    {"bucketName": "zipbkt", "prefix": "docs/",
                     "objects": ["one.md", "deep/"]},
                    {"bucketName": "zipbkt", "objects": []}):
            run.http("POST", "/minio-tpu/web/zip?"
                     + urllib.parse.urlencode({"token": url_token}),
                     json.dumps(doc).encode(),
                     {"Content-Type": "application/json"})
        run.http("POST", "/minio-tpu/web/zip?token=bogus",
                 json.dumps({"bucketName": "zipbkt",
                             "objects": ["a.txt"]}).encode(),
                 {"Content-Type": "application/json"})

    out = _both(pair, steps)["port"].out
    status, headers, body = out[1]
    assert status == 200 and headers["content-type"] == "application/zip"
    assert headers["transfer-encoding"] == "chunked"
    zf = zipfile.ZipFile(io.BytesIO(body))
    assert {n: zf.read(n) for n in zf.namelist()} == payloads
    zf = zipfile.ZipFile(io.BytesIO(out[2][2]))
    assert {n: zf.read(n) for n in zf.namelist()} == {
        "one.md": payloads["docs/one.md"],
        "deep/three.bin": payloads["docs/deep/three.bin"]}
    assert out[3][0] == 400 and out[4][0] == 403


# -- credentials and policy summaries ---------------------------------------


@threaded
def test_generate_and_set_auth(pair):
    """GenerateAuth (owner only) and SetAuth rotating an IAM user's own
    secret."""
    srvs, _roots = pair
    for srv in srvs.values():
        srv.iam.add_user("authu", "firstsecret99", "readwrite")

    def steps(run, _kind):
        gen = run.rpc("web.GenerateAuth")["result"]
        assert len(gen["accessKey"]) >= 3 and len(gen["secretKey"]) >= 8
        utok = _token(run.srv, {"username": "authu",
                                "password": "firstsecret99"})
        run.rpc("web.GenerateAuth", {}, utok)
        run.rpc("web.SetAuth", {"currentSecretKey": "minioadmin",
                                "newSecretKey": "newrootpw999"})
        run.rpc("web.SetAuth", {"currentSecretKey": "wrong",
                                "newSecretKey": "nextsecret99"}, utok)
        run.rpc("web.SetAuth", {"currentSecretKey": "firstsecret99",
                                "newSecretKey": "short"}, utok)
        run.rpc("web.SetAuth", {"currentSecretKey": "firstsecret99",
                                "newSecretKey": "nextsecret99"}, utok)
        for pw in ("firstsecret99", "nextsecret99"):
            run.out.append(_norm(_rpc(run.srv, "web.Login", {
                "username": "authu", "password": pw}), ""))

    out = _both(pair, steps)["port"].out
    assert [("result" in d) for d in out] == [
        True, False, False, False, False, True, False, True]


@threaded
def test_list_all_bucket_policies(pair):
    policy = json.dumps({
        "Version": "2012-10-17",
        "Statement": [
            {"Effect": "Allow", "Principal": "*",
             "Action": ["s3:GetObject"],
             "Resource": "arn:aws:s3:::polsum/public/*"},
            {"Effect": "Allow", "Principal": "*",
             "Action": ["s3:GetObject", "s3:PutObject"],
             "Resource": "arn:aws:s3:::polsum/drop/*"},
        ],
    })

    def steps(run, _kind):
        run.rpc("web.MakeBucket", {"bucketName": "polsum"})
        run.rpc("web.ListAllBucketPolicies", {"bucketName": "polsum"})
        run.rpc("web.SetBucketPolicy", {"bucketName": "polsum",
                                        "policy": policy})
        run.rpc("web.ListAllBucketPolicies", {"bucketName": "polsum"})

    out = _both(pair, steps)["port"].out
    assert out[1]["result"] == {"policies": []}
    by_prefix = {p["prefix"]: p["policy"]
                 for p in out[3]["result"]["policies"]}
    assert by_prefix == {"public/": "readonly", "drop/": "readwrite"}
