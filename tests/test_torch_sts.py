"""The port's STS AssumeRole, temp credentials and IAM groups held
against minio_tpu's, over real HTTP.

Each test of ``tests/test_sts.py`` runs on a JAX and a port ``S3Server``
side by side (``tests/test_torch_server.py``'s deployment, the threaded
plane, the port on the CPU), each with the policy ``rw`` and the user
``alice``.  The same signed requests go to both, and the answers must be
equal - exact equality of statuses, headers and bodies once the request
ids and dates are normalized (``tests/test_torch_server.py``) and, in the
STS XML, the minted ``AccessKeyId``, ``SecretAccessKey``,
``SessionToken`` and ``Expiration`` are replaced by placeholders.  The
IAM-level tests make the same calls on each package's ``IAMSys`` and
compare the outcomes.
"""

from __future__ import annotations

import json
import re
import time
import urllib.parse

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.iam.policy import Policy as JPolicy
from minio_tpu.iam.sys import IAMSys as JIAMSys
from minio_tpu.iam.sys import InvalidToken as JInvalidToken
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.iam.policy import Policy as TPolicy
from minio_tpu_torch.iam.sys import IAMSys as TIAMSys
from minio_tpu_torch.iam.sys import InvalidToken as TInvalidToken
from tests.s3client import S3Client
from tests.test_torch_server import N, _normalize, _res, _start
from tests.test_torch_threads import torch_threads  # noqa: F401

KINDS = ("jax", "port")
RW_POLICY = {
    "Version": "2012-10-17",
    "Statement": [
        {"Effect": "Allow", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::*"]}
    ],
}
READONLY_SESSION = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{
        "Effect": "Allow",
        "Action": ["s3:GetObject", "s3:ListBucket"],
        "Resource": ["arn:aws:s3:::*"],
    }],
})
POLICY = {"jax": JPolicy, "port": TPolicy}
IAM = {"jax": JIAMSys, "port": TIAMSys}
INVALID_TOKEN = {"jax": JInvalidToken, "port": TInvalidToken}
_MINTED = re.compile(
    rb"<(AccessKeyId|SecretAccessKey|SessionToken|Expiration)>[^<]*</\1>")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("sts")
        srvs = {}
        try:
            for kind in KINDS:
                srvs[kind] = _start(
                    kind, [str(base / f"{kind}{i}") for i in range(N)])
                srvs[kind].iam.set_policy(
                    "rw", POLICY[kind].from_dict(RW_POLICY))
                srvs[kind].iam.add_user("alice", "alice-secret-key", "rw")
                assert S3Client(srvs[kind].endpoint).make_bucket(
                    "stsbkt").status == 200
            yield srvs
        finally:
            for srv in srvs.values():
                srv.shutdown()
            jbackend.reset_backend()
            tbackend.reset_backend()


def _norm(r):
    status, headers, body = _normalize(_res(r))
    return status, headers, _MINTED.sub(rb"<\1/>", body)


def _assume_role(srv, access_key, secret_key, **params):
    c = S3Client(srv.endpoint, access_key, secret_key)
    form = {"Action": "AssumeRole", "Version": "2011-06-15", **params}
    return c.request(
        "POST", "/", body=urllib.parse.urlencode(form).encode(),
        headers={"content-type": "application/x-www-form-urlencoded"},
    )


def _creds(resp):
    return (
        resp.xml_text("AccessKeyId"),
        resp.xml_text("SecretAccessKey"),
        resp.xml_text("SessionToken"),
    )


def _both(servers, steps) -> list:
    """``steps(srv, kind)`` returns the answers to compare; they must be
    equal between the packages.  The port's are returned."""
    got = {kind: steps(servers[kind], kind) for kind in KINDS}
    assert got["port"] == got["jax"]
    return got["port"]


def test_assume_role_issues_working_creds(servers):
    expirations = []

    def steps(srv, _kind):
        r = _assume_role(srv, "alice", "alice-secret-key")
        ak, sk, token = _creds(r)
        assert ak and sk and token
        expirations.append(r.xml_text("Expiration"))
        tc = S3Client(srv.endpoint, ak, sk)
        hdr = {"x-amz-security-token": token}
        return [_norm(r),
                _norm(tc.put_object("stsbkt", "obj", b"temp!", headers=hdr)),
                _norm(tc.get_object("stsbkt", "obj", headers=hdr)),
                _norm(tc.request("DELETE", "/stsbkt/obj", headers=hdr))]

    out = _both(servers, steps)
    assert [o[0] for o in out] == [200, 200, 200, 204]
    assert b"<AssumeRoleResponse" in out[0][2] and out[2][2] == b"temp!"
    assert all(e.endswith("Z") for e in expirations)


def test_temp_creds_require_session_token(servers):
    def steps(srv, _kind):
        ak, sk, _token = _creds(_assume_role(srv, "alice", "alice-secret-key"))
        tc = S3Client(srv.endpoint, ak, sk)
        return [_norm(tc.put_object("stsbkt", "x", b"1")),
                _norm(tc.put_object("stsbkt", "x", b"1", headers={
                    "x-amz-security-token": "wrong"}))]

    assert [o[0] for o in _both(servers, steps)] == [403, 403]


def test_static_creds_reject_foreign_token(servers):
    def steps(srv, _kind):
        return _norm(S3Client(srv.endpoint).put_object(
            "stsbkt", "y", b"1", headers={"x-amz-security-token": "bogus"}))

    assert _both(servers, steps)[0] == 403


def test_session_policy_intersects(servers):
    def steps(srv, _kind):
        S3Client(srv.endpoint).put_object("stsbkt", "ro-obj", b"data")
        r = _assume_role(srv, "alice", "alice-secret-key",
                         Policy=READONLY_SESSION)
        ak, sk, token = _creds(r)
        tc = S3Client(srv.endpoint, ak, sk)
        hdr = {"x-amz-security-token": token}
        # read allowed by both the parent and the session policy; write
        # allowed by the parent but denied by the session policy
        return [_norm(r),
                _norm(tc.get_object("stsbkt", "ro-obj", headers=hdr)),
                _norm(tc.put_object("stsbkt", "nope", b"x", headers=hdr))]

    assert [o[0] for o in _both(servers, steps)] == [200, 200, 403]


def test_temp_cred_expiry(servers):
    def steps(srv, kind):
        cred = srv.iam.assume_role("alice", duration_s=900)
        ak = cred["access_key"]
        srv.iam._users[ak]["expiration"] = time.time() - 1
        out = [srv.iam.lookup_secret(ak)]
        with pytest.raises(INVALID_TOKEN[kind]) as err:
            srv.iam.validate_session_token(ak, cred["session_token"])
        out.append(str(err.value))
        out.append(srv.iam.purge_expired_sts() >= 1)
        out.append(ak in srv.iam._users)
        return out

    out = _both(servers, steps)
    assert out[0] is None and out[2:] == [True, False]


def test_temp_creds_cannot_assume_role(servers):
    def steps(srv, _kind):
        cred = srv.iam.assume_role("alice")
        # refused before the STS dispatch: a temp credential without its
        # token fails the session-token check
        return _norm(_assume_role(srv, cred["access_key"], cred["secret"]))

    assert _both(servers, steps)[0] in (400, 403)


def test_service_accounts_cannot_assume_role(servers):
    def steps(srv, _kind):
        ak, sk = srv.iam.add_service_account("alice")
        return _norm(_assume_role(srv, ak, sk))

    assert _both(servers, steps)[0] == 400


def test_refresh_keeps_fresh_temp_creds(servers):
    """A refresh racing assume_role must not drop the new credential."""
    def steps(srv, _kind):
        cred = srv.iam.assume_role("alice")
        srv.iam.refresh()
        return srv.iam.lookup_secret(cred["access_key"]) == cred["secret"]

    assert _both(servers, steps) is True


def test_duration_bounds(servers):
    def steps(srv, _kind):
        return [_norm(_assume_role(srv, "alice", "alice-secret-key",
                                   DurationSeconds=d))
                for d in ("10", "notanint", "900")]

    assert [o[0] for o in _both(servers, steps)] == [400, 400, 200]


def test_web_identity_rejected_cleanly(servers, monkeypatch):
    """With no OpenID provider configured the federation actions answer
    NotImplemented; LDAP and an unknown action are refused cleanly too."""
    from minio_tpu.iam import openid as jopenid
    from minio_tpu_torch.iam import openid as topenid

    for mod in (jopenid, topenid):
        monkeypatch.delenv(mod.ENV_CONFIG_URL, raising=False)
        mod.reset_validator_cache()

    def steps(srv, _kind):
        c = S3Client(srv.endpoint)
        out = []
        for action in ("AssumeRoleWithWebIdentity",
                       "AssumeRoleWithClientGrants",
                       "AssumeRoleWithLDAPIdentity", "NoSuchAction"):
            body = urllib.parse.urlencode(
                {"Action": action, "Version": "2011-06-15"}).encode()
            out.append(_norm(c.request(
                "POST", "/", body=body,
                headers={"content-type": "application/x-www-form-urlencoded"},
            )))
        return out

    assert [o[0] for o in _both(servers, steps)] == [501, 501, 501, 400]


# -- groups ---------------------------------------------------------------


def test_group_policy_grants_access(servers):
    def steps(srv, _kind):
        iam = srv.iam
        iam.add_user("bob", "bob-secret-key1")  # no direct policy
        bc = S3Client(srv.endpoint, "bob", "bob-secret-key1")
        S3Client(srv.endpoint).make_bucket("grpbkt")
        out = [_norm(bc.put_object("grpbkt", "o", b"x"))]
        iam.add_group_members("writers", ["bob"])
        iam.set_group_policy("writers", "rw")
        out.append(_norm(bc.put_object("grpbkt", "o", b"x")))
        # disabling the group revokes it
        iam.set_group_status("writers", False)
        out.append(_norm(bc.put_object("grpbkt", "o2", b"x")))
        iam.set_group_status("writers", True)
        out.append(_norm(bc.put_object("grpbkt", "o2", b"x")))
        # removing the member revokes it
        iam.remove_group_members("writers", ["bob"])
        out.append(_norm(bc.put_object("grpbkt", "o3", b"x")))
        return out

    assert [o[0] for o in _both(servers, steps)] == [403, 200, 403, 200, 403]


def test_group_persistence(servers):
    """A store-backed IAM persists groups and temp credentials: a fresh
    IAMSys over the same object layer sees both."""
    def steps(srv, kind):
        iam1 = IAM[kind]("minioadmin", "minioadmin", srv.object_layer)
        iam1.add_user("carol", "carol-secret-k1")
        iam1.add_group_members("persisted", ["carol"])
        iam1.set_policy("rw", POLICY[kind].from_dict(RW_POLICY))
        iam1.set_group_policy("persisted", "rw")
        cred = iam1.assume_role("carol", duration_s=900)
        iam2 = IAM[kind]("minioadmin", "minioadmin", srv.object_layer)
        iam2.validate_session_token(cred["access_key"],
                                    cred["session_token"])
        return ["persisted" in iam2.list_groups(),
                iam2.group_info("persisted")["members"],
                iam2.lookup_secret(cred["access_key"]) == cred["secret"]]

    assert _both(servers, steps) == [True, ["carol"], True]


def test_group_admin_routes(servers):
    def steps(srv, _kind):
        c = S3Client(srv.endpoint)
        out = [_norm(c.request(
            "PUT", "/minio-tpu/admin/v1/update-group-members",
            query={"group": "admgrp"},
            body=json.dumps({"members": ["alice"]}).encode(),
            headers={"content-type": "application/json"},
        ))]
        out.append("admgrp" in json.loads(
            c.request("GET", "/minio-tpu/admin/v1/groups").body))
        out.append(_norm(c.request("GET", "/minio-tpu/admin/v1/group",
                                   query={"group": "admgrp"})))
        out.append(_norm(c.request(
            "PUT", "/minio-tpu/admin/v1/set-group-policy",
            query={"group": "admgrp", "name": "rw"}, body=b"")))
        # an unknown member is an error
        out.append(_norm(c.request(
            "PUT", "/minio-tpu/admin/v1/update-group-members",
            query={"group": "admgrp"},
            body=json.dumps({"members": ["ghost-user"]}).encode())))
        return out

    out = _both(servers, steps)
    assert out[0][0] == 200 and out[1] is True
    assert json.loads(out[2][2])["members"] == ["alice"]
    assert out[3][0] == 200 and out[4][0] == 400
