"""The S3 front's device-free modules held against minio_tpu's.

The port carries its own copies of ``server/auth.py`` (SigV4, presign,
V2, the aws-chunked reader), ``iam/policy.py``, ``server/authz.py``,
``server/s3errors.py``, ``server/response.py`` and ``http._ChunkedReader``.
Each is fed the same inputs as the JAX package's module - hypothesis
draws the paths, queries and headers - and must give the same
signatures, decisions, error documents and XML bytes.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import string

import pytest
from hypothesis import given, settings, strategies as st

from minio_tpu.iam import policy as jpolicy
from minio_tpu.iam.sys import IAMSys as JaxIAM
from minio_tpu.objectlayer import api as japi
from minio_tpu.server import auth as jauth, authz as jauthz
from minio_tpu.server import http as jhttp
from minio_tpu.server import response as jresponse, s3errors as js3errors
from minio_tpu.storage import errors as jserrors
from minio_tpu.utils import hashreader as jhashreader
from minio_tpu_torch.dsync import namespace as tnamespace
from minio_tpu_torch.iam import policy as tpolicy
from minio_tpu_torch.iam.sys import IAMSys as PortIAM
from minio_tpu_torch.objectlayer import api as tapi
from minio_tpu_torch.server import auth as tauth, authz as tauthz
from minio_tpu_torch.server import http as thttp
from minio_tpu_torch.server import response as tresponse, s3errors as ts3errors
from minio_tpu_torch.storage import errors as tserrors
from minio_tpu_torch.utils import hashreader as thashreader
from tests.test_torch_threads import torch_threads  # noqa: F401

AK, SK = "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
AMZ_DATE = "20261017T120000Z"
CLOCK = datetime.datetime(2026, 10, 17, 12, 0, 30,
                          tzinfo=datetime.timezone.utc)

_seg = st.text(
    alphabet=string.ascii_letters + string.digits + "-_.~ +=%é/",
    min_size=0, max_size=12,
)
paths = st.lists(_seg, min_size=1, max_size=4).map(lambda s: "/" + "/".join(s))
queries = st.dictionaries(
    st.text(alphabet=string.ascii_letters + "-_.", min_size=1, max_size=8),
    st.lists(st.text(alphabet=string.printable, max_size=10),
             min_size=1, max_size=2),
    max_size=4,
)
header_values = st.text(alphabet=string.ascii_letters + string.digits
                        + " ;,=/:-", max_size=20)
headers = st.dictionaries(
    st.sampled_from(["x-amz-meta-a", "x-amz-meta-b", "content-type",
                     "content-md5", "x-amz-acl", "range"]),
    header_values, max_size=4,
)
methods = st.sampled_from(["GET", "PUT", "POST", "DELETE", "HEAD"])


@settings(max_examples=60, deadline=None)
@given(methods, paths, queries, headers)
def test_canonical_request_and_sign_v4(method, path, query, hdrs):
    hdrs = dict(hdrs, host="127.0.0.1:9000", **{"x-amz-date": AMZ_DATE})
    signed = sorted(hdrs)
    phash = hashlib.sha256(path.encode()).hexdigest()
    assert tauth.canonical_request(
        method, path, query, hdrs, signed, phash
    ) == jauth.canonical_request(method, path, query, hdrs, signed, phash)
    assert tauth.sign_v4(
        method, path, query, hdrs, signed, phash, AK, SK, AMZ_DATE
    ) == jauth.sign_v4(
        method, path, query, hdrs, signed, phash, AK, SK, AMZ_DATE
    )


@settings(max_examples=40, deadline=None)
@given(methods, paths, st.integers(1, 604800))
def test_presign_url(method, path, expires):
    url = "http://127.0.0.1:9000" + path
    assert tauth.presign_url(
        method, url, AK, SK, expires=expires, amz_date=AMZ_DATE
    ) == jauth.presign_url(
        method, url, AK, SK, expires=expires, amz_date=AMZ_DATE
    )


@settings(max_examples=40, deadline=None)
@given(methods, paths, queries, headers)
def test_sign_v2(method, path, query, hdrs):
    date = "Sat, 17 Oct 2026 12:00:00 GMT"
    assert tauth.sign_v2(method, path, query, hdrs, SK, date) == \
        jauth.sign_v2(method, path, query, hdrs, SK, date)


def _signed_headers(module, method, path, query, payload: bytes):
    hdrs = {"host": "127.0.0.1:9000", "x-amz-date": AMZ_DATE,
            "x-amz-content-sha256": hashlib.sha256(payload).hexdigest()}
    signed = sorted(hdrs)
    sig = module.sign_v4(method, path, query, hdrs, signed,
                         hdrs["x-amz-content-sha256"], AK, SK, AMZ_DATE)
    hdrs["authorization"] = (
        f"{module.SIGN_V4_ALGORITHM} Credential={AK}/{AMZ_DATE[:8]}/"
        f"us-east-1/s3/aws4_request, SignedHeaders={';'.join(signed)}, "
        f"Signature={sig}"
    )
    return hdrs


def _verify(module, method, path, query, hdrs, payload):
    v = module.SigV4Verifier(
        lambda ak: SK if ak == AK else None, clock=lambda: CLOCK
    )
    try:
        return ("ok", v.verify(method, path, query, hdrs, payload))
    except module.AuthError as e:
        return ("err", e.code)


@settings(max_examples=40, deadline=None)
@given(methods, paths, queries, st.binary(max_size=64), st.booleans())
def test_verifier_accepts_and_rejects_alike(method, path, query, payload,
                                            tamper):
    # the port verifies what the JAX package signed, and the reverse
    for signer in (jauth, tauth):
        hdrs = _signed_headers(signer, method, path, query, payload)
        body = payload + (b"x" if tamper else b"")
        got = _verify(tauth, method, path, query, hdrs, body)
        assert got == _verify(jauth, method, path, query, hdrs, body)
        assert (got[0] == "ok") == (not tamper)


def _chunked_body(data: bytes, chunk: int, corrupt: bool):
    """An aws-chunked body and the seed signature it chains from."""
    path = "/bkt/obj"
    hdrs = {"host": "127.0.0.1:9000", "x-amz-date": AMZ_DATE,
            "x-amz-content-sha256": jauth.STREAMING_PAYLOAD,
            "x-amz-decoded-content-length": str(len(data)),
            "content-encoding": "aws-chunked"}
    signed = sorted(hdrs)
    seed = jauth.sign_v4("PUT", path, {}, hdrs, signed,
                         jauth.STREAMING_PAYLOAD, AK, SK, AMZ_DATE)
    hdrs["authorization"] = (
        f"{jauth.SIGN_V4_ALGORITHM} Credential={AK}/{AMZ_DATE[:8]}/"
        f"us-east-1/s3/aws4_request, SignedHeaders={';'.join(signed)}, "
        f"Signature={seed}"
    )
    key = jauth._signing_key(SK, AMZ_DATE[:8], "us-east-1", "s3")
    scope = f"{AMZ_DATE[:8]}/us-east-1/s3/aws4_request"
    prev, body = seed, bytearray()
    pieces = [data[i:i + chunk] for i in range(0, len(data), chunk)] + [b""]
    for i, c in enumerate(pieces):
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", AMZ_DATE, scope, prev,
                         jauth.EMPTY_SHA256, hashlib.sha256(c).hexdigest()])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        prev = sig
        if corrupt and i == len(pieces) // 2:
            sig = "0" * 64
        body += f"{len(c):x};chunk-signature={sig}\r\n".encode()
        if c:
            body += c + b"\r\n"
    body += b"\r\n"
    return path, hdrs, bytes(body)


def _decode_chunked(module, data, chunk, corrupt):
    path, hdrs, body = _chunked_body(data, chunk, corrupt)
    v = module.SigV4Verifier(lambda ak: SK, clock=lambda: CLOCK)
    ctx = v.verify_stream("PUT", path, {}, hdrs)
    reader = module.SigV4ChunkedReader(io.BytesIO(body), ctx, len(data))
    out = bytearray()
    try:
        while True:
            piece = reader.read(1000)
            if not piece:
                break
            out += piece
        reader.finalize()
    except module.AuthError as e:
        return ("err", e.code, bytes(out))
    return ("ok", bytes(out))


@settings(max_examples=30, deadline=None)
@given(st.binary(max_size=5000), st.integers(1, 2048), st.booleans())
def test_sigv4_chunked_reader(data, chunk, corrupt):
    got = _decode_chunked(tauth, data, chunk, corrupt)
    assert got == _decode_chunked(jauth, data, chunk, corrupt)
    if not corrupt:
        assert got == ("ok", data)


def _te_chunked(data: bytes, chunk: int) -> bytes:
    out = bytearray()
    for i in range(0, len(data), chunk):
        c = data[i:i + chunk]
        out += f"{len(c):x}\r\n".encode() + c + b"\r\n"
    return bytes(out + b"0\r\n\r\n")


@settings(max_examples=30, deadline=None)
@given(st.binary(max_size=3000), st.integers(1, 700), st.integers(1, 512))
def test_transfer_encoding_chunked_reader(data, chunk, read_size):
    def decode(module):
        r = module._ChunkedReader(io.BytesIO(_te_chunked(data, chunk)))
        out = bytearray()
        while True:
            piece = r.read(read_size)
            if not piece:
                return bytes(out)
            out += piece

    assert decode(thttp) == decode(jhttp) == data


# -- policy evaluation and authorization -----------------------------------

_POLICIES = [
    {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
        "Resource": ["arn:aws:s3:::bkt/pub/*"]}]},
    {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Principal": {"AWS": ["*"]},
         "Action": ["s3:*"], "Resource": ["arn:aws:s3:::bkt*"]},
        {"Effect": "Deny", "Principal": "*", "Action": ["s3:DeleteObject"],
         "Resource": ["arn:aws:s3:::bkt/keep/*"]}]},
    {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": ["s3:ListBucket"],
        "Resource": ["arn:aws:s3:::bkt"],
        "Condition": {"StringLike": {"s3:prefix": ["pub/*"]}}}]},
    {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
        "Resource": ["arn:aws:s3:::bkt/*"],
        "Condition": {"IpAddress": {"aws:SourceIp": ["10.0.0.0/8"]}}}]},
]
_ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
            "s3:ListBucket", "s3:GetBucketPolicy", "s3:CreateBucket"]


@settings(max_examples=80, deadline=None)
@given(
    st.integers(0, len(_POLICIES) - 1), st.sampled_from(_ACTIONS),
    st.sampled_from(["bkt", "bkt2", "other"]),
    st.sampled_from(["", "pub/x", "keep/y", "priv/z"]),
    st.sampled_from(["", "pub/", "priv/"]),
    st.sampled_from(["", "10.1.2.3", "192.168.0.1"]),
)
def test_policy_decisions(pi, action, bucket, key, prefix, ip):
    import json

    raw = json.dumps(_POLICIES[pi])
    cond = {"prefix": [prefix]} if prefix else {}
    if ip:
        cond["sourceip"] = [ip]

    def decide(mod):
        args = mod.Args(account="", action=action, bucket=bucket,
                        object=key, conditions=dict(cond))
        return mod.Policy.from_json(raw).is_allowed(args)

    assert decide(tpolicy) == decide(jpolicy)


def test_policy_errors_alike():
    for raw in ["{", "[]", '{"Version":"2012-10-17"}',
                '{"Statement":[{"Effect":"Maybe"}]}']:
        for mod in (tpolicy, jpolicy):
            with pytest.raises(mod.PolicyError):
                mod.Policy.from_json(raw)


_SUBS = ["", "policy", "versioning", "location", "tagging", "uploads",
         "uploadId", "versionId", "delete", "select", "acl", "retention",
         "legal-hold", "events", "versions", "lifecycle", "notification"]


@pytest.mark.parametrize("method", ["GET", "PUT", "POST", "DELETE", "HEAD",
                                    "PATCH"])
@pytest.mark.parametrize("sub", _SUBS)
@pytest.mark.parametrize("key", ["", "obj"])
def test_action_for_request(method, sub, key):
    query = {sub: [""]} if sub else {}

    def action(mod):
        try:
            return mod.action_for_request(method, "bkt", key, query, {})
        except Exception as e:  # noqa: BLE001 - MethodNotAllowed
            return type(e).__name__, str(e)

    assert action(tauthz) == action(jauthz)


@pytest.mark.parametrize("anonymous", [False, True])
@pytest.mark.parametrize("action", _ACTIONS)
@pytest.mark.parametrize("key", ["pub/x", "priv/y"])
def test_authorize(anonymous, action, key):
    account = "" if anonymous else "minioadmin"

    def decide(authz_mod, policy_mod, iam_cls):
        iam = iam_cls("minioadmin", "minioadmin")
        pol = policy_mod.Policy.from_dict(_POLICIES[0])
        cond = authz_mod.condition_values(
            {}, {"x-amz-date": AMZ_DATE}, "127.0.0.1"
        )
        return authz_mod.authorize(iam, pol, account, action, "bkt", key,
                                   cond)

    assert decide(tauthz, tpolicy, PortIAM) == decide(jauthz, jpolicy,
                                                      JaxIAM)


@pytest.mark.parametrize("bucket", [".sys", ".x", "minio-tpu", "bkt",
                                    "minio"])
def test_reserved_buckets(bucket):
    assert tauthz.is_reserved_bucket(bucket) == \
        jauthz.is_reserved_bucket(bucket)


# -- errors ---------------------------------------------------------------


def _api(err):
    return err.code, err.message, err.status


_EXCEPTIONS = [
    ("BucketNotFound", "api"), ("BucketExists", "api"),
    ("BucketNotEmpty", "api"), ("InvalidBucketName", "api"),
    ("ObjectNotFound", "api"), ("VersionNotFound", "api"),
    ("InvalidObjectName", "api"), ("InvalidRange", "api"),
    ("ReadQuorumError", "api"), ("WriteQuorumError", "api"),
    ("FileNotFound", "errors"), ("VolumeNotFound", "errors"),
    ("BadDigest", "hashreader"), ("SizeMismatch", "hashreader"),
]
_EXC_ARGS = {"BadDigest": ("ab", "cd"), "SizeMismatch": (5, 3)}


@pytest.mark.parametrize("name,where", _EXCEPTIONS,
                         ids=[e[0] for e in _EXCEPTIONS])
def test_from_exception(name, where):
    port_mod = {"api": tapi, "errors": tserrors,
                "hashreader": thashreader}[where]
    jax_mod = {"api": japi, "errors": jserrors,
               "hashreader": jhashreader}[where]
    args = _EXC_ARGS.get(name, ("detail",))
    got = ts3errors.from_exception(getattr(port_mod, name)(*args))
    want = js3errors.from_exception(getattr(jax_mod, name)(*args))
    assert _api(got) == _api(want)


def test_from_exception_other_cases():
    assert ts3errors.from_exception(
        tnamespace.LockTimeout("k")
    ).code == "RequestTimeout"
    assert _api(ts3errors.from_exception(
        ts3errors.S3Error("NoSuchKey")
    )) == _api(js3errors.from_exception(js3errors.S3Error("NoSuchKey")))
    assert _api(ts3errors.from_exception(
        tauth.AuthError("SignatureDoesNotMatch", "x")
    )) == _api(js3errors.from_exception(
        jauth.AuthError("SignatureDoesNotMatch", "x")))
    err = ts3errors.from_exception(
        NotImplementedError("thing is not ported (slice 7)")
    )
    assert (err.code, err.status) == ("NotImplemented", 501)
    assert "(slice 7)" in err.message
    assert _api(ts3errors.from_exception(ValueError("boom"))) == \
        _api(js3errors.from_exception(ValueError("boom")))


@pytest.mark.parametrize("code", sorted(js3errors._E))
def test_error_table(code):
    assert _api(ts3errors.get(code)) == _api(js3errors.get(code))
    assert _api(ts3errors.get(code, "m")) == _api(js3errors.get(code, "m"))


# -- listing XML ----------------------------------------------------------


def _result(api, names, prefixes, truncated):
    res = api.ListObjectsInfo(is_truncated=truncated,
                              next_marker=names[-1] if names else "")
    for i, n in enumerate(names):
        res.objects.append(api.ObjectInfo(
            bucket="bkt", name=n, size=i * 7, mod_time_ns=1_700_000_000 * 10**9
            + i, etag=hashlib.md5(n.encode()).hexdigest()))
    res.prefixes.extend(prefixes)
    return res


_names = st.lists(st.text(alphabet=string.ascii_letters + " /é&<", min_size=1,
                          max_size=10), max_size=5)


@settings(max_examples=40, deadline=None)
@given(_names, _names, st.booleans(), st.booleans(), st.integers(0, 1000),
       st.sampled_from(["", "a/", "é"]), st.sampled_from(["", "/", "é"]))
def test_list_objects_xml(names, prefixes, truncated, encode, max_keys,
                          prefix, delimiter):
    t = _result(tapi, names, prefixes, truncated)
    j = _result(japi, names, prefixes, truncated)
    assert tresponse.list_objects_v1_xml(
        "bkt", prefix, "m", delimiter, max_keys, t, encode
    ) == jresponse.list_objects_v1_xml(
        "bkt", prefix, "m", delimiter, max_keys, j, encode
    )
    assert tresponse.list_objects_v2_xml(
        "bkt", prefix, delimiter, max_keys, "s", "dG9r", t, encode
    ) == jresponse.list_objects_v2_xml(
        "bkt", prefix, delimiter, max_keys, "s", "dG9r", j, encode
    )


def test_small_documents():
    assert tresponse.location_xml("") == jresponse.location_xml("")
    buckets = [tapi.BucketInfo("a-bkt", 10**18), tapi.BucketInfo("b", 0)]
    jbuckets = [japi.BucketInfo("a-bkt", 10**18), japi.BucketInfo("b", 0)]
    assert tresponse.list_buckets_xml(buckets) == \
        jresponse.list_buckets_xml(jbuckets)
    assert tresponse.error_xml("NoSuchKey", "m", "/r", "id") == \
        jresponse.error_xml("NoSuchKey", "m", "/r", "id")
