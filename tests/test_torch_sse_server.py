"""Server-side encryption and compression on the port's S3 front, held
against minio_tpu's over real HTTPS and HTTP.

A JAX and a port server run side by side over TLS (one self-signed
certificate from the openssl CLI), on ``tests/test_torch_server.py``'s
deployment (six temp-dir disks, EC 4+2, 4 KiB blocks, the port on the
CPU), the same master key in both packages' KMS and
``MINIO_TPU_COMPRESS=on``.  The same signed requests go to both, in
order: SSE-C PUT/HEAD/GET and ranges across a 64 KiB package, a
compressed+SSE-C object, every SSE-C header fault (bad algorithm, key,
MD5, a missing or wrong key, SSE-C with SSE-S3), SSE-KMS, SSE-S3, the
listing's sizes, CopyObject SSE-C -> SSE-S3, an SSE-C multipart upload
with an UploadPartCopy from an SSE-C source, and the bucket default.
Statuses, headers and bodies must be equal once the request ids, dates,
upload ids and endpoints are normalized.  Select over an SSE-C and over
a compressed object (the port's default engine) answers the Records of
the JAX package's host engine over the same plaintext.  Over plain HTTP
SSE-C is InvalidRequest, and without a KMS SSE-S3 and a bucket default
are InvalidArgument, on both.  The port's async plane answers the
SSE-C steps as its threaded plane does.
"""

from __future__ import annotations

import base64
import hashlib
import re

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec import kms as jkms
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import kms as tkms
from tests.s3client import S3Client
from tests.test_torch_kms import self_signed
from tests.test_torch_select_server import CSV, _body, _frames
from tests.test_torch_server import N, _normalize, _pay, _res, _start
from tests.test_torch_sse import _text
from tests.test_torch_threads import torch_threads  # noqa: F401

MK = bytes(range(32))
CKEY = bytes(range(100, 132))
WRONG = bytes(range(1, 33))
ZIP = {"content-type": "application/zip"}  # excluded from compression
BIG = _pay(150_000, 61)  # crosses two 64 KiB packages
TEXT = _text(90_000, 62)
SSE_CONFIG = (
    b"<ServerSideEncryptionConfiguration><Rule>"
    b"<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256"
    b"</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>"
    b"</ServerSideEncryptionConfiguration>"
)


def ssec(key: bytes = CKEY, prefix="x-amz-server-side-encryption-customer",
         algo="AES256", md5: "str | None" = None, **extra) -> dict:
    """The SSE-C header triplet under ``prefix``."""
    h = {
        f"{prefix}-algorithm": algo,
        f"{prefix}-key": base64.b64encode(key).decode(),
        f"{prefix}-key-MD5": md5 if md5 is not None else base64.b64encode(
            hashlib.md5(key).digest()).decode(),
    }
    h.update(extra)
    return h


def copy_src(key: bytes = CKEY) -> dict:
    return ssec(key, prefix="x-amz-copy-source-server-side-encryption-customer")


def _uid(r) -> str:
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", r.body)
    return m.group(1).decode() if m else ""


def _steps():
    """(name, fn(client, ctx)) pairs, sent in this order to both
    servers; ``ctx`` carries the upload id a server handed out."""

    def req(method, path, **kw):
        return lambda c, ctx: c.request(method, path, **kw)

    def initiate(c, ctx):
        r = c.request("POST", "/bkt/mp", query={"uploads": ""}, headers={
            **ssec(), **ZIP})
        ctx["uid"] = _uid(r)
        return r

    def part(n, body=b"", headers=None):
        return lambda c, ctx: c.request(
            "PUT", "/bkt/mp", query={"partNumber": str(n), "uploadId": ctx["uid"]},
            body=body, headers=headers)

    def list_parts(c, ctx):
        return c.request("GET", "/bkt/mp", query={"uploadId": ctx["uid"]})

    def complete(c, ctx):
        etags = ctx["etags"]
        xml = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{etags[n]}</ETag></Part>"
            for n in sorted(etags))
        return c.request(
            "POST", "/bkt/mp", query={"uploadId": ctx["uid"]},
            body=f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>"
            .encode())

    def keep_etag(n, fn):
        def run(c, ctx):
            r = fn(c, ctx)
            etag = r.headers.get("etag")
            if not etag:  # UploadPartCopy answers it in the XML body
                m = re.search(rb"<ETag>(?:&quot;|\")?([0-9a-f]+)", r.body)
                etag = f'"{m.group(1).decode()}"'
            ctx.setdefault("etags", {})[n] = etag
            return r
        return run

    part1 = _pay(70_000, 63)
    part3 = _pay(17, 64)
    return [
        ("bucket", req("PUT", "/bkt")),
        ("put_ssec", req("PUT", "/bkt/c", body=BIG, headers={**ssec(), **ZIP})),
        ("head_ssec", req("HEAD", "/bkt/c", headers=ssec())),
        ("get_ssec", req("GET", "/bkt/c", headers=ssec())),
        ("get_ssec_package_edge", req("GET", "/bkt/c", headers={
            **ssec(), "Range": "bytes=65436-65635"})),
        ("get_ssec_suffix", req("GET", "/bkt/c", headers={
            **ssec(), "Range": "bytes=-17"})),
        ("get_ssec_no_key", req("GET", "/bkt/c")),
        ("head_ssec_no_key", req("HEAD", "/bkt/c")),
        ("get_ssec_wrong_key", req("GET", "/bkt/c", headers=ssec(WRONG))),
        ("get_bad_algo", req("GET", "/bkt/c", headers=ssec(algo="AES128"))),
        ("put_key_short", req("PUT", "/bkt/x", body=b"x",
                              headers=ssec(key=b"short"))),
        ("put_key_not_b64", req("PUT", "/bkt/x", body=b"x", headers={
            **ssec(), "x-amz-server-side-encryption-customer-key": "@@@"})),
        ("put_bad_md5", req("PUT", "/bkt/x", body=b"x",
                            headers=ssec(md5="AAAA"))),
        ("put_no_md5", req("PUT", "/bkt/x", body=b"x", headers={
            "x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(CKEY).decode()})),
        ("put_ssec_and_s3", req("PUT", "/bkt/x", body=b"x", headers={
            **ssec(), "x-amz-server-side-encryption": "AES256"})),
        ("put_kms", req("PUT", "/bkt/x", body=b"x", headers={
            "x-amz-server-side-encryption": "aws:kms"})),
        ("put_compressed_ssec", req("PUT", "/bkt/t.csv", body=TEXT,
                                    headers=ssec())),
        ("get_compressed_ssec_range", req("GET", "/bkt/t.csv", headers={
            **ssec(), "Range": "bytes=65000-70999"})),
        ("put_sses3", req("PUT", "/bkt/s3", body=BIG, headers={
            "x-amz-server-side-encryption": "AES256", **ZIP})),
        ("get_sses3", req("GET", "/bkt/s3")),
        ("get_sses3_with_key", req("GET", "/bkt/s3", headers=ssec())),
        ("put_compressed", req("PUT", "/bkt/plain.csv", body=CSV)),
        ("put_ssec_csv", req("PUT", "/bkt/sec.csv", body=CSV, headers=ssec())),
        ("head_compressed", req("HEAD", "/bkt/plain.csv")),
        ("list", req("GET", "/bkt", query={"list-type": "2"})),
        ("copy_ssec_to_sses3", req("PUT", "/bkt/copied", headers={
            "x-amz-copy-source": "/bkt/c", **copy_src(),
            "x-amz-server-side-encryption": "AES256"})),
        ("get_copied", req("GET", "/bkt/copied")),
        ("copy_no_source_key", req("PUT", "/bkt/copied2", headers={
            "x-amz-copy-source": "/bkt/c"})),
        ("copy_wrong_source_key", req("PUT", "/bkt/copied2", headers={
            "x-amz-copy-source": "/bkt/c", **copy_src(WRONG)})),
        ("mp_initiate", initiate),
        ("mp_part1", keep_etag(1, part(1, part1, ssec()))),
        ("mp_part2_copy", keep_etag(2, part(2, headers={
            "x-amz-copy-source": "/bkt/c", **copy_src(), **ssec(),
            "x-amz-copy-source-range": "bytes=1000-80999"}))),
        ("mp_part3_no_key", part(3, part3)),
        ("mp_part3", keep_etag(3, part(3, part3, ssec()))),
        ("mp_list_parts", list_parts),
        ("mp_complete", complete),
        ("mp_head", req("HEAD", "/bkt/mp", headers=ssec())),
        ("mp_get_across_parts", req("GET", "/bkt/mp", headers={
            **ssec(), "Range": "bytes=69990-70019"})),
        ("mp_get", req("GET", "/bkt/mp", headers=ssec())),
        ("bucket_default", req("PUT", "/bkt", query={"encryption": ""},
                               body=SSE_CONFIG)),
        ("put_default", req("PUT", "/bkt/dflt", body=b"hello", headers=ZIP)),
        ("head_default", req("HEAD", "/bkt/dflt")),
    ]


STEPS = _steps()
STEP_NAMES = [name for name, _ in STEPS]
WANT = {
    "put_ssec": 200, "get_ssec": 200, "get_ssec_package_edge": 206,
    "get_ssec_no_key": 400, "head_ssec_no_key": 400,
    "get_ssec_wrong_key": 403, "get_bad_algo": 400, "put_key_short": 400,
    "put_key_not_b64": 400, "put_bad_md5": 400, "put_no_md5": 400,
    "put_ssec_and_s3": 400, "put_kms": 501, "get_sses3_with_key": 400,
    "copy_ssec_to_sses3": 200, "copy_no_source_key": 400,
    "copy_wrong_source_key": 403, "mp_part2_copy": 200,
    "mp_part3_no_key": 403, "mp_complete": 200,
    "mp_get_across_parts": 206, "put_default": 200,
}


def _norm(res, ctx, endpoint):
    status, headers, body = _normalize(res)
    if ctx.get("uid"):
        body = body.replace(ctx["uid"].encode(), b"<upload>")
    body = body.replace(endpoint.encode(), b"<endpoint>")
    body = re.sub(rb"<Initiated>[^<]*</Initiated>", b"<Initiated/>", body)
    return status, headers, body


def _run(c: S3Client) -> dict:
    ctx: dict = {}
    endpoint = f"{c.host}:{c.port}"
    return {name: _norm(_res(fn(c, ctx)), ctx, endpoint)
            for name, fn in STEPS}


@pytest.fixture(scope="module")
def tls_servers(tmp_path_factory):
    """Both servers over TLS, every step sent to each; the servers stay
    up for the Select tests."""
    base = tmp_path_factory.mktemp("sse-tls")
    cert, key = self_signed(base)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        mp.setenv("MINIO_TPU_COMPRESS", "on")
        mp.setenv("MINIO_TPU_TLS", "on")
        mp.setenv("MINIO_TPU_CERT_FILE", cert)
        mp.setenv("MINIO_TPU_KEY_FILE", key)
        jbackend.reset_backend()
        tbackend.reset_backend()
        tkms.set_kms(tkms.MasterKeyKMS("mk1", MK))
        jkms.set_kms(jkms.MasterKeyKMS("mk1", MK))
        srvs, out = {}, {}
        try:
            for kind in ("jax", "port"):
                srvs[kind] = _start(
                    kind, [str(base / f"{kind}{i}") for i in range(N)])
                srvs[kind].object_layer.min_part_size = 1
                c = S3Client(srvs[kind].endpoint)
                assert c.tls
                out[kind] = (_run(c), c)
            yield srvs, out
        finally:
            for srv in srvs.values():
                srv.shutdown()
            for mod in (tkms, jkms):
                mod.set_kms(None)
                mod.reset_kms_cache()
            jbackend.reset_backend()
            tbackend.reset_backend()


@pytest.mark.parametrize("step", STEP_NAMES)
def test_same_response_over_tls(tls_servers, step):
    _srvs, out = tls_servers
    got, want = out["port"][0][step], out["jax"][0][step]
    assert got == want
    assert got[0] == WANT.get(step, got[0]), got
    assert got[0] < 500 or step == "put_kms"


def test_bodies_and_headers(tls_servers):
    """What the equal answers say: plaintext back, the SSE headers of
    each mode, the error codes, the actual sizes."""
    _srvs, out = tls_servers
    res = out["port"][0]
    md5 = base64.b64encode(hashlib.md5(CKEY).digest()).decode()
    assert res["get_ssec"][2] == BIG
    assert res["get_ssec"][1][
        "x-amz-server-side-encryption-customer-key-md5"] == md5
    assert res["head_ssec"][1]["content-length"] == str(len(BIG))
    assert res["get_ssec_package_edge"][2] == BIG[65436:65636]
    assert res["get_ssec_suffix"][2] == BIG[-17:]
    assert res["get_compressed_ssec_range"][2] == TEXT[65000:71000]
    for step, code in (("get_ssec_no_key", "InvalidRequest"),
                       ("get_ssec_wrong_key", "AccessDenied"),
                       ("get_bad_algo", "InvalidArgument"),
                       ("put_key_short", "InvalidArgument"),
                       ("put_bad_md5", "InvalidArgument"),
                       ("put_ssec_and_s3", "InvalidRequest"),
                       ("put_kms", "NotImplemented"),
                       ("mp_part3_no_key", "AccessDenied"),
                       ("copy_wrong_source_key", "AccessDenied")):
        assert f"<Code>{code}</Code>".encode() in res[step][2], step
    assert res["get_sses3"][2] == BIG
    assert res["get_sses3"][1]["x-amz-server-side-encryption"] == "AES256"
    assert res["head_compressed"][1]["content-length"] == str(len(CSV))
    assert f"<Size>{len(CSV)}</Size>".encode() in res["list"][2]
    assert f"<Size>{len(BIG)}</Size>".encode() in res["list"][2]
    assert res["get_copied"][2] == BIG
    assert res["get_copied"][1]["x-amz-server-side-encryption"] == "AES256"
    mp = _pay(70_000, 63) + BIG[1000:81000] + _pay(17, 64)
    assert res["mp_get"][2] == mp
    assert res["mp_get_across_parts"][2] == mp[69990:70020]
    assert b"<Size>70000</Size>" in res["mp_list_parts"][2]
    assert res["head_default"][1]["x-amz-server-side-encryption"] == "AES256"


def test_stored_transforms_match(tls_servers):
    """The objects' transform markers agree between the packages."""
    srvs, _out = tls_servers
    for name in ("c", "t.csv", "s3", "plain.csv", "sec.csv", "copied", "mp",
                 "dflt"):
        metas = {}
        for kind, srv in srvs.items():
            info = srv.object_layer.get_object_info("bkt", name)
            metas[kind] = {
                k: v for k, v in info.user_defined.items()
                if k.startswith("x-internal-") and not k.endswith(
                    ("sealed-key", "sealed-dk", "nonce"))
                and k not in ("x-internal-bucket", "x-internal-object")}
            assert info.size == srvs["jax"].object_layer.get_object_info(
                "bkt", name).size
        assert metas["port"] == metas["jax"], name


SELECTS = {
    "ssec_q": ("sec.csv", lambda: _body(
        "SELECT s.id, s.tag FROM S3Object s WHERE s.val = 7"), True),
    "ssec_agg": ("sec.csv", lambda: _body(
        "SELECT COUNT(*), MAX(s.id) FROM S3Object s WHERE s.tag = 'bx1'"),
        True),
    "compressed_q": ("plain.csv", lambda: _body(
        "SELECT s.id, s.val FROM S3Object s WHERE s.val BETWEEN 10 AND 12"),
        False),
    "compressed_agg": ("plain.csv", lambda: _body(
        "SELECT COUNT(*), SUM(s.val) FROM S3Object s WHERE s.val > 50"),
        False),
}


@pytest.mark.parametrize("name", list(SELECTS))
def test_select_over_transformed_objects(tls_servers, monkeypatch, name):
    """Select over an SSE-C object (with its key) and a compressed one:
    the port's default engine answers the Records, Stats and End of the
    JAX package's host engine over the same plaintext (the JAX
    package's own ``auto`` engine needs ``jax.experimental.enable_x64``,
    so it is held on its host engine)."""
    _srvs, out = tls_servers
    key, body, with_key = SELECTS[name]
    headers = ssec() if with_key else None

    def send(c):
        return _res(c.request("POST", f"/bkt/{key}",
                              query={"select": "", "select-type": "2"},
                              body=body(), headers=headers))

    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    js, _jh, jb = send(out["jax"][1])
    monkeypatch.delenv("MINIO_TPU_SELECT")
    ts, _th, tb = send(out["port"][1])
    assert ts == js == 200
    assert _frames(tb) == _frames(jb)
    assert _frames(tb)[0]
    if with_key:
        # without the key the object is not readable, on both
        no_key = {kind: _res(c.request(
            "POST", f"/bkt/{key}", query={"select": "", "select-type": "2"},
            body=body()))[0] for kind, (_r, c) in out.items()}
        assert no_key == {"jax": 400, "port": 400}


def test_plain_http_and_no_kms(tmp_path, monkeypatch):
    """Over plain HTTP SSE-C is InvalidRequest; with no KMS configured
    SSE-S3 and a bucket default are InvalidArgument; on both servers."""
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_TLS", "off")
    monkeypatch.delenv("MINIO_TPU_KMS_MASTER_KEY", raising=False)
    monkeypatch.delenv("MINIO_TPU_KMS_KES_ENDPOINT", raising=False)
    before = {mod: mod.get_kms() for mod in (tkms, jkms)}
    for mod in before:
        mod.set_kms(None)
        mod.reset_kms_cache()
    sends = [
        ("plain_put", lambda c: c.put_object("bkt", "k", b"x")),
        ("ssec_put", lambda c: c.put_object("bkt", "k", b"x", headers=ssec())),
        ("ssec_get", lambda c: c.get_object("bkt", "k", headers=ssec())),
        ("sses3_put", lambda c: c.put_object("bkt", "k", b"x", headers={
            "x-amz-server-side-encryption": "AES256"})),
        ("default_cfg", lambda c: c.request(
            "PUT", "/bkt", query={"encryption": ""}, body=SSE_CONFIG)),
        ("default_put", lambda c: c.put_object("bkt", "k", b"x")),
        ("kms_status", lambda c: c.request(
            "GET", "/minio-tpu/admin/v1/kms/key/status")),
    ]
    got = {}
    try:
        for kind in ("jax", "port"):
            srv = _start(kind, [str(tmp_path / f"{kind}{i}") for i in range(N)])
            try:
                c = S3Client(srv.endpoint)
                assert not c.tls and c.make_bucket("bkt").status == 200
                got[kind] = {name: _normalize(_res(fn(c)))
                             for name, fn in sends}
            finally:
                srv.shutdown()
    finally:
        for mod, kms in before.items():
            mod.set_kms(kms)
    assert got["port"] == got["jax"]
    codes = {name: (r[0], re.search(rb"<Code>(\w+)</Code>", r[2]).group(1)
                    if r[0] >= 400 else None)
             for name, r in got["port"].items()}
    assert codes == {
        "plain_put": (200, None),
        "ssec_put": (400, b"InvalidRequest"),
        "ssec_get": (400, b"InvalidRequest"),
        "sses3_put": (400, b"InvalidArgument"),
        "default_cfg": (200, None),
        "default_put": (400, b"InvalidArgument"),
        "kms_status": (400, b"InvalidArgument"),
    }


def test_async_plane_answers_as_the_threaded_plane(tls_servers, tmp_path,
                                                    monkeypatch):
    """The port's asyncio plane over TLS answers every step as its
    threaded plane did."""
    _srvs, out = tls_servers
    monkeypatch.setenv("MINIO_TPU_SERVER", "async")
    monkeypatch.setenv("MINIO_TPU_SERVER_LOOPS", "2")
    srv = _start("port", [str(tmp_path / f"a{i}") for i in range(N)])
    try:
        assert srv.server_mode == "async"
        srv.object_layer.min_part_size = 1
        got = _run(S3Client(srv.endpoint))
    finally:
        srv.shutdown()
    for step in STEP_NAMES:
        assert got[step] == out["port"][0][step], step
