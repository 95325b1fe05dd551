"""The port's OpenID federation held against minio_tpu's:
AssumeRoleWithWebIdentity / AssumeRoleWithClientGrants against the stub
provider of ``tests/test_sts_oidc.py`` (discovery and JWKS over HTTP on
loopback, RS256 tokens signed with a key generated in-process).

* ``rsa_verify_sha256``: the same verdict from both packages on valid,
  corrupted, truncated, out-of-range and too-small-key signatures.
* ``OpenIDValidator.validate`` and ``policy_claim``: the same claims, or
  an ``OpenIDError`` with the same message, on the same tokens and claim
  documents - signature, expiry, audience, issuer, unknown and rotated
  key ids, malformed tokens.
* Through the servers: a JAX and a port ``S3Server`` side by side
  (``tests/test_torch_server.py``'s deployment, the threaded plane), one
  provider configured in both; the same STS forms go to both and the
  answers must be equal once request ids and dates are normalized and
  the minted credential and its expiration are replaced by placeholders.
  The credentials then run the same object requests on each server.
"""

from __future__ import annotations

import base64
import json
import re
import time
import urllib.parse

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.iam import openid as jopenid
from minio_tpu.iam.policy import Policy as JPolicy
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.iam import openid as topenid
from minio_tpu_torch.iam.policy import Policy as TPolicy
from tests.s3client import S3Client
from tests.test_sts_oidc import StubIdP, _gen_rsa
from tests.test_torch_server import N, _normalize, _res, _start
from tests.test_torch_threads import torch_threads  # noqa: F401

KINDS = ("jax", "port")
OPENID = {"jax": jopenid, "port": topenid}
POLICY = {"jax": JPolicy, "port": TPolicy}
AUD = "minio-tpu-app"
OIDC_RW = {
    "Version": "2012-10-17",
    "Statement": [{
        "Effect": "Allow",
        "Action": ["s3:*"],
        "Resource": ["arn:aws:s3:::fedbkt", "arn:aws:s3:::fedbkt/*"],
    }],
}
_MINTED = re.compile(
    rb"<(AccessKeyId|SecretAccessKey|SessionToken|Expiration)>[^<]*</\1>")


@pytest.fixture(scope="module")
def idp():
    s = StubIdP()
    yield s
    s.close()


def _validators(idp, **kw) -> dict:
    url = f"{idp.issuer}/.well-known/openid-configuration"
    return {kind: mod.OpenIDValidator(url, client_id=AUD, **kw)
            for kind, mod in OPENID.items()}


def _verdict(kind, fn):
    """fn()'s value, or the OpenIDError's message of ``kind``'s package."""
    try:
        return ("ok", fn())
    except OPENID[kind].OpenIDError as e:
        return ("error", str(e))


def _same(fn) -> tuple:
    got = {kind: _verdict(kind, lambda k=kind: fn(k)) for kind in KINDS}
    assert got["port"] == got["jax"]
    return got["port"]


# -- the RS256 check ---------------------------------------------------------


def test_rsa_verify_sha256_verdicts(idp):
    msg = b"header.payload"
    tok = idp.token({"sub": "x"})
    signing, sig_b64 = tok.rsplit(".", 1)
    sig = topenid._b64u(sig_b64)
    n, e = idp.n, idp.e
    small_n, small_e, _d = _gen_rsa(256)  # no room for the padding
    cases = [
        (n, e, signing.encode(), sig, True),
        (n, e, msg, sig, False),
        (n, e, signing.encode(), bytes([sig[0] ^ 1]) + sig[1:], False),
        (n, e, signing.encode(), sig[1:], False),
        (n, e, signing.encode(), n.to_bytes(len(sig), "big"), False),
        (small_n, small_e, msg, b"\x01" * 32, False),
    ]
    for n_, e_, m, s, want in cases:
        got = {kind: OPENID[kind].rsa_verify_sha256(n_, e_, m, s)
               for kind in KINDS}
        assert got == {"jax": want, "port": want}


# -- the validator -----------------------------------------------------------


def test_valid_token_accepted(idp):
    vals = _validators(idp)
    tok = idp.token({"sub": "u1", "aud": AUD})
    assert _same(lambda k: vals[k].validate(tok))[1]["sub"] == "u1"
    # the audience may be a list, or the authorized party
    for claims in ({"sub": "u2", "aud": ["other", AUD]},
                   {"sub": "u3", "aud": "other", "azp": AUD}):
        tok = idp.token(claims)
        assert _same(lambda k: vals[k].validate(tok))[0] == "ok"


def test_bad_signature_rejected(idp):
    vals = _validators(idp)
    tok = idp.token({"aud": AUD}, corrupt=True)
    got = _same(lambda k: vals[k].validate(tok))
    assert got[0] == "error" and "signature" in got[1]


def test_expired_token_rejected(idp):
    vals = _validators(idp)
    for claims in ({"aud": AUD, "exp": time.time() - 10},
                   {"aud": AUD, "exp": "never"},
                   {"aud": AUD, "nbf": time.time() + 3600}):
        tok = idp.token(claims)
        got = _same(lambda k: vals[k].validate(tok))
        assert got[0] == "error" and ("expired" in got[1]
                                      or "not yet valid" in got[1])


def test_wrong_audience_rejected(idp):
    vals = _validators(idp)
    tok = idp.token({"aud": "someone-else"})
    got = _same(lambda k: vals[k].validate(tok))
    assert got == ("error", "audience mismatch")


def test_wrong_issuer_rejected(idp):
    vals = _validators(idp)
    tok = idp.token({"aud": AUD, "iss": "http://evil"})
    assert _same(lambda k: vals[k].validate(tok)) == (
        "error", "issuer mismatch")


def test_malformed_and_unknown_key_tokens(idp):
    """Not a JWS, a header that is no JSON object, another algorithm:
    the same error from both.  A kid the provider does not serve is
    refetched once; with one key served, that key verifies it."""
    vals = _validators(idp)
    _head, body, sig = idp.token({"aud": AUD}).split(".")

    def seg(doc) -> str:
        return base64.urlsafe_b64encode(
            json.dumps(doc).encode()).rstrip(b"=").decode()

    cases = [
        ("a.b", "error"),
        ("!!!." + body + "." + sig, "error"),
        (seg([1]) + "." + body + "." + sig, "error"),
        (seg({"alg": "HS256"}) + "." + body + "." + sig, "error"),
        (idp.token({"aud": AUD}, kid="rotated-away"), "ok"),
    ]
    for tok, want in cases:
        assert _same(lambda k: vals[k].validate(tok))[0] == want, tok


def test_policy_claim_extraction(idp):
    vals = _validators(idp)
    docs = [{"policy": "readwrite"}, {"policy": ["p1", "p2"]},
            {"policy": "a, b"}, {"policy": ""}, {"policy": [" ", ""]},
            {"other": "x"}]
    got = [_same(lambda k: vals[k].policy_claim(d)) for d in docs]
    assert got[:3] == [("ok", "readwrite"), ("ok", "p1,p2"), ("ok", "a,b")]
    assert all(g[0] == "error" for g in got[3:])
    named = _validators(idp, claim_name="groups")
    assert _same(lambda k: named[k].policy_claim(
        {"groups": ["g1"], "policy": "x"})) == ("ok", "g1")


# -- end to end through the servers ------------------------------------------


@pytest.fixture()
def servers(idp, tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.setenv("MINIO_MESH", "0")
    for mod in OPENID.values():
        monkeypatch.setenv(mod.ENV_CONFIG_URL,
                           f"{idp.issuer}/.well-known/openid-configuration")
        monkeypatch.setenv(mod.ENV_CLIENT_ID, AUD)
        mod.reset_validator_cache()
    jbackend.reset_backend()
    tbackend.reset_backend()
    srvs = {kind: _start(kind, [str(tmp_path / f"{kind}{i}")
                                for i in range(N)])
            for kind in KINDS}
    yield srvs
    for srv in srvs.values():
        srv.shutdown()
    for mod in OPENID.values():
        mod.reset_validator_cache()
    jbackend.reset_backend()
    tbackend.reset_backend()


def _sts_oidc(srv, action, token_field, token, extra=None):
    form = {"Action": action, "Version": "2011-06-15", token_field: token,
            **(extra or {})}
    return S3Client(srv.endpoint).request(
        "POST", "/", body=urllib.parse.urlencode(form).encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        sign=False,
    )


def _norm(r):
    status, headers, body = _normalize(_res(r))
    return status, headers, _MINTED.sub(rb"<\1/>", body)


def _creds_from(body: bytes):
    return tuple(
        re.search(rb"<%s>([^<]+)" % tag, body).group(1).decode()
        for tag in (b"AccessKeyId", b"SecretAccessKey", b"SessionToken"))


@pytest.mark.parametrize("action,field", [
    ("AssumeRoleWithWebIdentity", "WebIdentityToken"),
    ("AssumeRoleWithClientGrants", "Token"),
])
def test_oidc_sts_end_to_end(servers, idp, action, field):
    """A provider's token buys working temp credentials that pass object
    requests under the claimed policy - and nothing more - on both."""
    token = idp.token({"sub": "fed-user", "aud": AUD, "policy": "oidc-rw"})
    got = {}
    for kind, srv in servers.items():
        srv.iam.set_policy("oidc-rw", POLICY[kind].from_dict(OIDC_RW))
        root = S3Client(srv.endpoint)
        assert root.make_bucket("fedbkt").status == 200
        assert root.make_bucket("otherbkt").status == 200
        r = _sts_oidc(srv, action, field, token)
        ak, sk, st = _creds_from(r.body)
        exp = r.xml_text("Expiration")
        fed = S3Client(srv.endpoint, access_key=ak, secret_key=sk)
        hdr = {"x-amz-security-token": st}
        got[kind] = [
            _norm(r), exp.endswith("Z"),
            _norm(fed.put_object("fedbkt", "hello.txt", b"federated!",
                                 headers=hdr)),
            _norm(fed.get_object("fedbkt", "hello.txt", headers=hdr)),
            _norm(fed.request("DELETE", "/fedbkt/hello.txt", headers=hdr)),
            # the policy does NOT cover other buckets
            _norm(fed.put_object("otherbkt", "nope", b"x", headers=hdr)),
            # a temporary credential cannot log into the web console
            srv.iam.is_temp_credential(ak),
        ]
    assert got["port"] == got["jax"]
    out = got["port"]
    assert out[0][0] == 200 and f"<{action}Response".encode() in out[0][2]
    if action == "AssumeRoleWithWebIdentity":
        assert b"<SubjectFromWebIdentityToken>fed-user<" in out[0][2]
    assert out[1] is True and out[6] is True
    assert [o[0] for o in out[2:6]] == [200, 200, 204, 403]
    assert out[3][2] == b"federated!"


def test_oidc_sts_rejects_bad_tokens(servers, idp):
    """Corrupt signature, unknown policy, no token, a token too close to
    its expiry, a bad DurationSeconds: the same refusals on both; a
    DurationSeconds past the token's expiry is capped at it."""
    tokens = [
        idp.token({"aud": AUD, "policy": "p"}, corrupt=True),
        idp.token({"aud": AUD, "policy": "no-such-policy"}),
        "",
        idp.token({"aud": AUD, "policy": "readonly",
                   "exp": time.time() + 60}),
    ]
    capped = idp.token({"aud": AUD, "policy": "readonly",
                        "exp": time.time() + 1000})
    got = {}
    for kind, srv in servers.items():
        out = [_norm(_sts_oidc(srv, "AssumeRoleWithWebIdentity",
                               "WebIdentityToken", t)) for t in tokens]
        out.append(_norm(_sts_oidc(
            srv, "AssumeRoleWithWebIdentity", "WebIdentityToken", capped,
            {"DurationSeconds": "nope"})))
        r = _sts_oidc(srv, "AssumeRoleWithWebIdentity", "WebIdentityToken",
                      capped, {"DurationSeconds": "86400"})
        out.append(_norm(r))
        ak = _creds_from(r.body)[0]
        left = srv.iam._users[ak]["expiration"] - time.time()
        out.append(0 < left <= 1000)
        got[kind] = out
    assert got["port"] == got["jax"]
    assert [o[0] for o in got["port"][:6]] == [403, 403, 400, 403, 400, 200]
    assert b"AccessDenied" in got["port"][0][2]
    assert got["port"][6] is True


def test_oidc_unconfigured_is_clean_error(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.setenv("MINIO_MESH", "0")
    for mod in OPENID.values():
        monkeypatch.delenv(mod.ENV_CONFIG_URL, raising=False)
        mod.reset_validator_cache()
    srvs = {kind: _start(kind, [str(tmp_path / f"u{kind}{i}")
                                for i in range(N)])
            for kind in KINDS}
    try:
        got = {kind: _norm(_sts_oidc(srv, "AssumeRoleWithWebIdentity",
                                     "WebIdentityToken", "x.y.z"))
               for kind, srv in srvs.items()}
    finally:
        for srv in srvs.values():
            srv.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 501
