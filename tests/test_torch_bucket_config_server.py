"""The bucket-configuration routes of the port's S3 front against
minio_tpu's, over real HTTP.

A JAX and a port ``S3Server`` (threaded plane, EC 4+2 over six temp-dir
disks, the port on ``device="cpu"``) take the same signed requests in
the same order; statuses, bodies and the headers that matter must be
equal once the volatile fields are normalized (as in
``tests/test_torch_server.py``).  Both packages' object-lock clocks are
pinned to one instant, so default retentions stamp the same date.

Covered, each route of the slice: bucket ``?lifecycle``, ``?tagging``,
``?object-lock`` and ``?acl``; object ``?tagging``, ``?retention``,
``?legal-hold`` and ``?acl``; the ``x-amz-tagging`` and object-lock
headers on PUT, copy and multipart; CreateBucket with object lock; the
WORM guard on DELETE and multi-delete, with the governance bypass for an
allowed and a denied user; the retention strengthening matrix; hard
quotas on PUT, copy, UploadPart and UploadPartCopy, and the admin quota
routes.
"""

from __future__ import annotations

import datetime
import json
import re
import time
import types

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import bucket_meta as jbucket_meta
from minio_tpu.objectlayer import objectlock as jlock
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import bucket_meta as tbucket_meta
from minio_tpu_torch.objectlayer import objectlock as tlock
from tests.s3client import S3Client
from tests.test_torch_server import _normalize, _pay, _res, _start
from tests.test_torch_threads import torch_threads  # noqa: F401

ADMIN = "/minio-tpu/admin/v1"
CREATED_NS = 1_700_000_000_000_000_000
# every clock of the object-lock module reads this instant
NOW = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
FAR = "2090-01-01T00:00:00Z"
_VID = re.compile(rb"<VersionId>[^<]*</VersionId>")
_LOCATION = re.compile(rb"<Location>http://[^/<]+")


def _norm(res):
    status, headers, body = _normalize(_res(res))
    body = _LOCATION.sub(b"<Location>", _VID.sub(b"<VersionId/>", body))
    return status, headers, body


def _lc_doc(prefix="logs/", days=30) -> bytes:
    return (
        "<LifecycleConfiguration><Rule><ID>r1</ID><Status>Enabled</Status>"
        f"<Filter><Prefix>{prefix}</Prefix></Filter><Expiration><Days>"
        f"{days}</Days></Expiration></Rule></LifecycleConfiguration>"
    ).encode()


def _tags(*kv) -> bytes:
    return ("<Tagging><TagSet>" + "".join(
        f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>" for k, v in kv)
        + "</TagSet></Tagging>").encode()


def _retention(mode: str, until: str) -> bytes:
    return (f"<Retention><Mode>{mode}</Mode><RetainUntilDate>{until}"
            "</RetainUntilDate></Retention>").encode()


LOCK_GOV_1D = (
    b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
    b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
    b"<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>"
)
DELETE_ONLY_POLICY = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{
        "Effect": "Allow",
        "Action": ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
                   "s3:DeleteObjectVersion", "s3:GetBucketLocation",
                   "s3:ListBucket"],
        "Resource": ["arn:aws:s3:::*"],
    }],
}).encode()
BOB = ("bob12345", "bobsecret12345")


def _admin(c, method, tail, query=None, body=b""):
    return c.request(method, f"{ADMIN}/{tail}", query=query, body=body)


def _vid(st: dict, name: str):
    """The version id a step recorded on this server."""
    return st.get(name, "")


def _put_keep_vid(c, st, name, bucket, key, data=b"x", headers=None):
    r = c.put_object(bucket, key, data, headers=headers)
    st[name] = r.headers.get("x-amz-version-id", "")
    return r


def _bob(c):
    return S3Client(f"http://{c.host}:{c.port}", access_key=BOB[0],
                    secret_key=BOB[1])


def _multi_delete(keys) -> bytes:
    objs = "".join(
        f"<Object><Key>{k}</Key>" + (f"<VersionId>{v}</VersionId>" if v else "")
        + "</Object>" for k, v in keys)
    return f"<Delete>{objs}</Delete>".encode()


def _mp_put(c, st, bucket, key, size, headers=None):
    """Initiate an upload and send one part of ``size`` bytes; the
    part's answer."""
    r = c.request("POST", f"/{bucket}/{key}", query={"uploads": ""},
                  headers=headers)
    uid = re.search(rb"<UploadId>([^<]+)</UploadId>", r.body).group(1)
    st["upload:" + key] = uid.decode()
    return c.request("PUT", f"/{bucket}/{key}", body=_pay(size, 5),
                     query={"partNumber": "1", "uploadId": uid.decode()})


def _mp_complete(c, st, bucket, key):
    uid = st["upload:" + key]
    parts = c.request("GET", f"/{bucket}/{key}", query={"uploadId": uid})
    etag = re.search(rb"<ETag>([^<]+)</ETag>", parts.body).group(1).decode()
    body = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>").encode()
    return c.request("POST", f"/{bucket}/{key}", query={"uploadId": uid},
                     body=body)


STEPS = [
    # bucket lifecycle
    ("lc_get_missing", lambda c, st: c.request(
        "GET", "/cfg", query={"lifecycle": ""})),
    ("lc_put_malformed", lambda c, st: c.request(
        "PUT", "/cfg", query={"lifecycle": ""}, body=b"<Lifecycle")),
    ("lc_put_no_rules", lambda c, st: c.request(
        "PUT", "/cfg", query={"lifecycle": ""},
        body=b"<LifecycleConfiguration/>")),
    ("lc_put_transition", lambda c, st: c.request(
        "PUT", "/cfg", query={"lifecycle": ""}, body=_lc_doc().replace(
            b"<Expiration>", b"<Transition><Days>1</Days></Transition>"
            b"<Expiration>"))),
    ("lc_put", lambda c, st: c.request(
        "PUT", "/cfg", query={"lifecycle": ""}, body=_lc_doc())),
    ("lc_get", lambda c, st: c.request(
        "GET", "/cfg", query={"lifecycle": ""})),
    ("lc_put_replace", lambda c, st: c.request(
        "PUT", "/cfg", query={"lifecycle": ""},
        body=_lc_doc("tmp/", 7))),
    ("lc_get_replaced", lambda c, st: c.request(
        "GET", "/cfg", query={"lifecycle": ""})),
    ("lc_delete", lambda c, st: c.request(
        "DELETE", "/cfg", query={"lifecycle": ""})),
    ("lc_get_deleted", lambda c, st: c.request(
        "GET", "/cfg", query={"lifecycle": ""})),
    ("lc_put_no_bucket", lambda c, st: c.request(
        "PUT", "/nobucket", query={"lifecycle": ""}, body=_lc_doc())),
    # bucket tagging
    ("btag_get_missing", lambda c, st: c.request(
        "GET", "/cfg", query={"tagging": ""})),
    ("btag_put", lambda c, st: c.request(
        "PUT", "/cfg", query={"tagging": ""},
        body=_tags(("team", "a"), ("env", "dev &amp; test")))),
    ("btag_get", lambda c, st: c.request(
        "GET", "/cfg", query={"tagging": ""})),
    ("btag_put_dup", lambda c, st: c.request(
        "PUT", "/cfg", query={"tagging": ""},
        body=_tags(("k", "1"), ("k", "2")))),
    ("btag_put_malformed", lambda c, st: c.request(
        "PUT", "/cfg", query={"tagging": ""}, body=b"<Tagging><TagSet>")),
    ("btag_put_51", lambda c, st: c.request(
        "PUT", "/cfg", query={"tagging": ""},
        body=_tags(*[(f"k{i}", "v") for i in range(51)]))),
    ("btag_delete", lambda c, st: c.request(
        "DELETE", "/cfg", query={"tagging": ""})),
    ("btag_get_deleted", lambda c, st: c.request(
        "GET", "/cfg", query={"tagging": ""})),
    # bucket ACLs
    ("bucket_acl_get", lambda c, st: c.request(
        "GET", "/cfg", query={"acl": ""})),
    ("bucket_acl_put_private", lambda c, st: c.request(
        "PUT", "/cfg", query={"acl": ""}, headers={"x-amz-acl": "private"})),
    ("bucket_acl_put_public", lambda c, st: c.request(
        "PUT", "/cfg", query={"acl": ""},
        headers={"x-amz-acl": "public-read"})),
    ("bucket_acl_put_body", lambda c, st: c.request(
        "PUT", "/cfg", query={"acl": ""},
        body=b"<AccessControlPolicy><Grant><Permission>READ</Permission>"
             b"</Grant></AccessControlPolicy>")),
    ("bucket_acl_no_bucket", lambda c, st: c.request(
        "GET", "/nobucket", query={"acl": ""})),
    # object tagging and ACLs
    ("otag_put_header", lambda c, st: c.put_object(
        "cfg", "tagged", b"payload", headers={"x-amz-tagging": "a=1&b=two"})),
    ("otag_get", lambda c, st: c.request(
        "GET", "/cfg/tagged", query={"tagging": ""})),
    ("otag_object_get", lambda c, st: c.get_object("cfg", "tagged")),
    ("otag_put", lambda c, st: c.request(
        "PUT", "/cfg/tagged", query={"tagging": ""},
        body=_tags(("x", "y")))),
    ("otag_get_replaced", lambda c, st: c.request(
        "GET", "/cfg/tagged", query={"tagging": ""})),
    ("otag_put_11", lambda c, st: c.request(
        "PUT", "/cfg/tagged", query={"tagging": ""},
        body=_tags(*[(f"k{i}", "v") for i in range(11)]))),
    ("otag_put_malformed", lambda c, st: c.request(
        "PUT", "/cfg/tagged", query={"tagging": ""}, body=b"<x")),
    ("otag_delete", lambda c, st: c.request(
        "DELETE", "/cfg/tagged", query={"tagging": ""})),
    ("otag_get_deleted", lambda c, st: c.request(
        "GET", "/cfg/tagged", query={"tagging": ""})),
    ("otag_get_missing_key", lambda c, st: c.request(
        "GET", "/cfg/none", query={"tagging": ""})),
    ("otag_header_dup", lambda c, st: c.put_object(
        "cfg", "bad", b"x", headers={"x-amz-tagging": "a=1&a=2"})),
    ("otag_header_long", lambda c, st: c.put_object(
        "cfg", "bad", b"x", headers={"x-amz-tagging": "k=" + "v" * 257})),
    ("object_acl_get", lambda c, st: c.request(
        "GET", "/cfg/tagged", query={"acl": ""})),
    ("object_acl_put", lambda c, st: c.request(
        "PUT", "/cfg/tagged", query={"acl": ""},
        headers={"x-amz-acl": "private"})),
    ("object_acl_missing_key", lambda c, st: c.request(
        "GET", "/cfg/none", query={"acl": ""})),
    # object lock on a plain bucket
    ("olock_get_plain", lambda c, st: c.request(
        "GET", "/cfg", query={"object-lock": ""})),
    ("olock_put_plain", lambda c, st: c.request(
        "PUT", "/cfg", query={"object-lock": ""}, body=LOCK_GOV_1D)),
    ("retention_get_plain", lambda c, st: c.request(
        "GET", "/cfg/tagged", query={"retention": ""})),
    ("legal_hold_put_plain", lambda c, st: c.request(
        "PUT", "/cfg/tagged", query={"legal-hold": ""},
        body=b"<LegalHold><Status>ON</Status></LegalHold>")),
    ("lock_headers_plain", lambda c, st: c.put_object(
        "cfg", "locked", b"x",
        headers={"x-amz-object-lock-legal-hold": "ON"})),
    ("lock_headers_half", lambda c, st: c.put_object(
        "cfg", "locked", b"x",
        headers={"x-amz-object-lock-mode": "GOVERNANCE"})),
    # a bucket born with object lock, then its default rule
    ("lock_create", lambda c, st: c.request(
        "PUT", "/lockb", headers={"x-amz-bucket-object-lock-enabled": "true"})),
    ("lock_create_versioning", lambda c, st: c.request(
        "GET", "/lockb", query={"versioning": ""})),
    ("olock_get_basic", lambda c, st: c.request(
        "GET", "/lockb", query={"object-lock": ""})),
    ("olock_put_malformed", lambda c, st: c.request(
        "PUT", "/lockb", query={"object-lock": ""},
        body=b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>X"
             b"</Mode><Days>1</Days></DefaultRetention></Rule>"
             b"</ObjectLockConfiguration>")),
    ("olock_put", lambda c, st: c.request(
        "PUT", "/lockb", query={"object-lock": ""}, body=LOCK_GOV_1D)),
    ("olock_get", lambda c, st: c.request(
        "GET", "/lockb", query={"object-lock": ""})),
    ("lock_default_put", lambda c, st: _put_keep_vid(
        c, st, "dflt", "lockb", "dflt", b"default-retained")),
    ("lock_default_retention", lambda c, st: c.request(
        "GET", "/lockb/dflt", query={"retention": ""})),
    ("lock_legal_hold_default", lambda c, st: c.request(
        "GET", "/lockb/dflt", query={"legal-hold": ""})),
    ("lock_put_compliance", lambda c, st: _put_keep_vid(
        c, st, "comp", "lockb", "comp", b"c", headers={
            "x-amz-object-lock-mode": "COMPLIANCE",
            "x-amz-object-lock-retain-until-date": FAR})),
    ("lock_put_held", lambda c, st: _put_keep_vid(
        c, st, "held", "lockb", "held", b"h", headers={
            "x-amz-object-lock-legal-hold": "ON"})),
    ("lock_put_bad_mode", lambda c, st: c.put_object(
        "lockb", "bad", b"x", headers={
            "x-amz-object-lock-mode": "WORM",
            "x-amz-object-lock-retain-until-date": FAR})),
    ("lock_put_past", lambda c, st: c.put_object(
        "lockb", "bad", b"x", headers={
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": "2020-01-01T00:00:00Z"})),
    ("retention_get_comp", lambda c, st: c.request(
        "GET", "/lockb/comp", query={"retention": ""})),
    ("legal_hold_get_held", lambda c, st: c.request(
        "GET", "/lockb/held", query={"legal-hold": ""})),
    ("legal_hold_put_malformed", lambda c, st: c.request(
        "PUT", "/lockb/held", query={"legal-hold": ""},
        body=b"<LegalHold><Status>maybe</Status></LegalHold>")),
    ("retention_put_malformed", lambda c, st: c.request(
        "PUT", "/lockb/comp", query={"retention": ""},
        body=_retention("GOVERNANCE", "2020-01-01T00:00:00Z"))),
    # the WORM guard
    ("worm_marker_allowed", lambda c, st: c.delete_object("lockb", "dflt")),
    ("worm_delete_gov", lambda c, st: c.request(
        "DELETE", "/lockb/dflt", query={"versionId": _vid(st, "dflt")})),
    ("worm_delete_comp", lambda c, st: c.request(
        "DELETE", "/lockb/comp", query={"versionId": _vid(st, "comp")})),
    ("worm_delete_comp_bypass", lambda c, st: c.request(
        "DELETE", "/lockb/comp", query={"versionId": _vid(st, "comp")},
        headers={"x-amz-bypass-governance-retention": "true"})),
    ("worm_delete_held", lambda c, st: c.request(
        "DELETE", "/lockb/held", query={"versionId": _vid(st, "held")},
        headers={"x-amz-bypass-governance-retention": "true"})),
    ("worm_multi_delete", lambda c, st: c.request(
        "POST", "/lockb", query={"delete": ""}, body=_multi_delete([
            ("dflt", _vid(st, "dflt")), ("comp", _vid(st, "comp")),
            ("held", _vid(st, "held")), ("absent", "")]))),
    # a user without s3:BypassGovernanceRetention
    ("bob_policy", lambda c, st: _admin(
        c, "PUT", "add-canned-policy", {"name": "delonly"},
        DELETE_ONLY_POLICY)),
    ("bob_add", lambda c, st: _admin(
        c, "PUT", "add-user", {"accessKey": BOB[0]},
        json.dumps({"secretKey": BOB[1], "policy": "delonly"}).encode())),
    ("bob_set_policy", lambda c, st: _admin(
        c, "PUT", "set-user-policy",
        {"accessKey": BOB[0], "name": "delonly"})),
    ("worm_bypass_denied_user", lambda c, st: _bob(c).request(
        "DELETE", "/lockb/dflt", query={"versionId": _vid(st, "dflt")},
        headers={"x-amz-bypass-governance-retention": "true"})),
    ("worm_bypass_allowed_user", lambda c, st: c.request(
        "DELETE", "/lockb/dflt", query={"versionId": _vid(st, "dflt")},
        headers={"x-amz-bypass-governance-retention": "true"})),
    ("legal_hold_put_off", lambda c, st: c.request(
        "PUT", "/lockb/held", query={"legal-hold": "",
                                  "versionId": _vid(st, "held")},
        body=b"<LegalHold><Status>OFF</Status></LegalHold>")),
    ("legal_hold_get_off", lambda c, st: c.request(
        "GET", "/lockb/held", query={"legal-hold": "",
                                  "versionId": _vid(st, "held")})),
    ("worm_delete_released", lambda c, st: c.request(
        "DELETE", "/lockb/held", query={"versionId": _vid(st, "held")},
        headers={"x-amz-bypass-governance-retention": "true"})),
    # copies and multipart stamp tags and lock defaults
    ("copy_tagged_into_lock", lambda c, st: c.request(
        "PUT", "/lockb/copied", headers={
            "x-amz-copy-source": "/cfg/tagged",
            "x-amz-tagging": "c=3"})),
    ("copy_tags", lambda c, st: c.request(
        "GET", "/lockb/copied", query={"tagging": ""})),
    ("copy_retention", lambda c, st: c.request(
        "GET", "/lockb/copied", query={"retention": ""})),
    ("copy_replace_tagged", lambda c, st: c.request(
        "PUT", "/cfg/copied2", headers={
            "x-amz-copy-source": "/cfg/tagged",
            "x-amz-metadata-directive": "REPLACE",
            "x-amz-tagging-directive": "REPLACE",
            "x-amz-tagging": "d=4"})),
    ("copy_replace_tags", lambda c, st: c.request(
        "GET", "/cfg/copied2", query={"tagging": ""})),
    ("copy_lock_headers_plain", lambda c, st: c.request(
        "PUT", "/cfg/copied3", headers={
            "x-amz-copy-source": "/cfg/tagged",
            "x-amz-object-lock-legal-hold": "ON"})),
    ("mp_lock_part", lambda c, st: _mp_put(
        c, st, "lockb", "mp", 6000, headers={
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": FAR,
            "x-amz-tagging": "m=1"})),
    ("mp_lock_complete", lambda c, st: _mp_complete(c, st, "lockb", "mp")),
    ("mp_lock_retention", lambda c, st: c.request(
        "GET", "/lockb/mp", query={"retention": ""})),
    ("mp_lock_tags", lambda c, st: c.request(
        "GET", "/lockb/mp", query={"tagging": ""})),
    # hard quota: admin routes, then every write path
    ("quota_get_unset", lambda c, st: _admin(
        c, "GET", "get-bucket-quota", {"bucket": "quotab"})),
    ("quota_set_malformed", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "quotab"}, b"{x")),
    ("quota_set_bad_type", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "quotab"},
        b'{"quota": 10, "quotatype": "soft"}')),
    ("quota_set_no_bucket", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "nobucket"},
        b'{"quota": 10}')),
    ("quota_set", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "quotab"},
        b'{"quota": 10000, "quotatype": "hard"}')),
    ("quota_get", lambda c, st: _admin(
        c, "GET", "get-bucket-quota", {"bucket": "quotab"})),
    ("quota_put_fits", lambda c, st: c.put_object("quotab", "a", _pay(6000, 1))),
    ("quota_put_over", lambda c, st: c.put_object("quotab", "b", _pay(6000, 2))),
    ("quota_copy_over", lambda c, st: c.request(
        "PUT", "/quotab/c", headers={"x-amz-copy-source": "/quotab/a"})),
    ("quota_part_over", lambda c, st: _mp_put(c, st, "quotab", "mp", 6000)),
    ("quota_part_copy_over", lambda c, st: c.request(
        "PUT", "/quotab/mp", query={"partNumber": "2",
                                "uploadId": st["upload:mp"]},
        headers={"x-amz-copy-source": "/quotab/a"})),
    ("quota_put_small", lambda c, st: c.put_object("quotab", "s", _pay(4000, 3))),
    ("quota_set_fifo", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "quotab"},
        b'{"quota": 5000, "quotatype": "fifo"}')),
    ("quota_fifo_put_allowed", lambda c, st: c.put_object(
        "quotab", "f", _pay(6000, 4))),
    ("quota_clear", lambda c, st: _admin(
        c, "PUT", "set-bucket-quota", {"bucket": "quotab"}, b"{}")),
    ("quota_get_cleared", lambda c, st: _admin(
        c, "GET", "get-bucket-quota", {"bucket": "quotab"})),
    ("quota_get_no_bucket", lambda c, st: _admin(
        c, "GET", "get-bucket-quota", {"bucket": "nobucket"})),
]
STEP_NAMES = [n for n, _ in STEPS]
assert len(set(STEP_NAMES)) == len(STEP_NAMES)

# matrix of PUT ?retention against a version that already carries one:
# (current mode or "", requested mode, date against the current one,
#  bypass header)
MATRIX = [
    (cur, new, when, bypass)
    for cur in ("", "GOVERNANCE", "COMPLIANCE")
    for new in ("GOVERNANCE", "COMPLIANCE")
    for when in ("earlier", "same", "later")
    for bypass in (False, True)
]
_DATES = {"earlier": "2080-01-01T00:00:00Z", "same": FAR,
          "later": "2095-01-01T00:00:00Z"}


def _matrix_case(c, cur, new, when, bypass):
    key = f"m-{cur or 'none'}-{new}-{when}-{int(bypass)}"
    hdrs = ({"x-amz-object-lock-mode": cur,
             "x-amz-object-lock-retain-until-date": FAR} if cur else None)
    put = c.put_object("lockm", key, b"m", headers=hdrs)
    vid = put.headers.get("x-amz-version-id", "")
    extra = {"x-amz-bypass-governance-retention": "true"} if bypass else None
    r = c.request("PUT", f"/lockm/{key}",
                  query={"retention": "", "versionId": vid},
                  body=_retention(new, _DATES[when]), headers=extra)
    after = c.request("GET", f"/lockm/{key}",
                      query={"retention": "", "versionId": vid})
    return [_norm(put), _norm(r), _norm(after)]


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """Both servers; the step sequence and the retention matrix sent to
    each; every answer kept."""
    fixed = types.SimpleNamespace(time_ns=lambda: CREATED_NS,
                                  monotonic=time.monotonic)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        mp.setattr(jbucket_meta, "time", fixed)
        mp.setattr(tbucket_meta, "time", fixed)
        for mod in (jlock, tlock):
            mp.setattr(mod, "utcnow", lambda: NOW)
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("bucket-config")
        out = {}
        for kind in ("jax", "port"):
            srv = _start(kind, [str(base / f"{kind}{i}") for i in range(6)])
            try:
                c = S3Client(srv.endpoint)
                for b in ("cfg", "quotab"):
                    assert c.make_bucket(b).status == 200
                assert c.request("PUT", "/lockm", headers={
                    "x-amz-bucket-object-lock-enabled": "true"}).status == 200
                st: dict = {}
                steps = {}
                for name, fn in STEPS:
                    steps[name] = _norm(fn(c, st))
                matrix = {case: _matrix_case(c, *case) for case in MATRIX}
                docs = {
                    b: srv.bucket_meta.get(b).to_dict()
                    for b in ("cfg", "lockb", "quotab", "lockm")
                }
            finally:
                srv.shutdown()
            out[kind] = (steps, matrix, docs)
        yield out
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.mark.parametrize("step", STEP_NAMES)
def test_same_answer(answers, step):
    assert answers["port"][0][step] == answers["jax"][0][step]


@pytest.mark.parametrize("case", MATRIX,
                         ids=["-".join(map(str, c)) for c in MATRIX])
def test_retention_strengthening_matrix(answers, case):
    """A retention replaced over the one a version carries: COMPLIANCE
    is never weakened, GOVERNANCE only with the bypass, a later date or
    a stronger mode always goes - on both servers alike."""
    got, want = answers["port"][1][case], answers["jax"][1][case]
    assert got == want
    cur, new, when, bypass = case
    status = got[1][0]
    if not cur:
        assert status == 200
    elif cur == "COMPLIANCE" and (new != "COMPLIANCE" or when == "earlier"):
        assert status == 400 and b"<Code>InvalidRequest</Code>" in got[1][2]


def test_bucket_documents_equal(answers):
    assert answers["port"][2] == answers["jax"][2]


def test_sequence_exercised_the_paths(answers):
    """The comparison is not vacuous: the served routes did their work."""
    res = answers["port"][0]
    assert res["lc_put"][0] == 200
    assert b"<Prefix>logs/</Prefix>" in res["lc_get"][2]
    assert res["lc_get_deleted"][0] == 404
    assert b"dev &amp; test" in res["btag_get"][2]
    assert res["otag_object_get"][1]["x-amz-tagging-count"] == "2"
    assert b"<Key>x</Key>" in res["otag_get_replaced"][2]
    assert res["lock_create"][0] == 200
    assert b"<Status>Enabled</Status>" in res["lock_create_versioning"][2]
    until = (NOW + datetime.timedelta(days=1)).strftime("%Y-%m-%dT%H:%M:%SZ")
    assert f"<RetainUntilDate>{until}</RetainUntilDate>".encode() in \
        res["lock_default_retention"][2]
    assert res["worm_marker_allowed"][1]["x-amz-delete-marker"] == "true"
    for name in ("worm_delete_gov", "worm_delete_comp",
                 "worm_delete_comp_bypass", "worm_delete_held",
                 "worm_bypass_denied_user"):
        assert res[name][0] == 400, name
        assert b"<Code>InvalidRequest</Code>" in res[name][2], name
    assert res["worm_bypass_allowed_user"][0] == 204
    assert res["worm_delete_released"][0] == 204
    assert res["worm_multi_delete"][2].count(b"<Error>") == 3
    assert b"<Key>c</Key>" in res["copy_tags"][2]
    assert b"<Mode>GOVERNANCE</Mode>" in res["copy_retention"][2]
    assert b"<Key>d</Key>" in res["copy_replace_tags"][2]
    assert res["mp_lock_complete"][0] == 200
    assert b"<Mode>GOVERNANCE</Mode>" in res["mp_lock_retention"][2]
    assert res["quota_put_fits"][0] == 200
    for name in ("quota_put_over", "quota_copy_over", "quota_part_over",
                 "quota_part_copy_over"):
        assert res[name][0] == 400, name
        assert b"XMinioAdminBucketQuotaExceeded" in res[name][2], name
    assert res["quota_put_small"][0] == 200
    assert res["quota_fifo_put_allowed"][0] == 200
    assert json.loads(res["quota_get"][2]) == {"quota": 10000,
                                              "quotatype": "hard"}
    assert res["quota_get_cleared"][2] == b"{}"
