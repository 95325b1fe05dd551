"""STS API (cmd/sts-handlers.go): AssumeRole on the root path.

POST / with a form body ``Action=AssumeRole&Version=2011-06-15`` signed
with SigV4 by an existing static credential; responds with temp
credentials (access key, secret, session token, expiration).
AssumeRoleWithWebIdentity and AssumeRoleWithClientGrants exchange an
OpenID provider's ID token for a temp credential carrying the token's
policy claim (iam/openid.py; unsigned - the token is the proof);
AssumeRoleWithLDAPIdentity needs an external LDAP provider and answers
``NotImplemented``.
"""

from __future__ import annotations

import datetime
import time
import urllib.parse
import xml.sax.saxutils as sx

from ..iam import openid
from ..iam.sys import (
    STS_MAX_DURATION_S,
    STS_MIN_DURATION_S,
    IAMError,
    PolicyNotFound,
    UserNotFound,
)
from .s3errors import S3Error

STS_VERSION = "2011-06-15"
_NS = "https://sts.amazonaws.com/doc/2011-06-15/"


def parse_form(body: bytes) -> "dict[str, str]":
    return {
        k: v[0]
        for k, v in urllib.parse.parse_qs(
            body.decode("utf-8", "replace"), keep_blank_values=True
        ).items()
    }


def _duration(form: "dict[str, str]") -> "int | None":
    if not form.get("DurationSeconds"):
        return None
    try:
        return int(form["DurationSeconds"])
    except ValueError:
        raise S3Error("InvalidParameterValue", "DurationSeconds") from None


def _response(action: str, cred: dict, subject_el: str = "") -> bytes:
    exp = datetime.datetime.fromtimestamp(
        cred["expiration"], datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%SZ")
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f'<{action}Response xmlns="{_NS}">'
        f"<{action}Result>"
        f"{subject_el}"
        "<Credentials>"
        f"<AccessKeyId>{sx.escape(cred['access_key'])}</AccessKeyId>"
        f"<SecretAccessKey>{sx.escape(cred['secret'])}</SecretAccessKey>"
        f"<SessionToken>{sx.escape(cred['session_token'])}</SessionToken>"
        f"<Expiration>{exp}</Expiration>"
        "</Credentials>"
        f"</{action}Result>"
        "<ResponseMetadata/>"
        f"</{action}Response>"
    ).encode()


def handle_sts(handler, form: "dict[str, str]") -> None:
    """Dispatch one STS action for an authenticated caller."""
    action = form.get("Action", "")
    if action in (
        "AssumeRoleWithWebIdentity",
        "AssumeRoleWithClientGrants",
    ):
        return _handle_sts_oidc(handler, form, action)
    if action == "AssumeRoleWithLDAPIdentity":
        raise S3Error(
            "NotImplemented",
            f"{action} requires an external LDAP provider",
        )
    if action != "AssumeRole":
        raise S3Error("InvalidParameterValue", f"unknown Action {action!r}")
    if form.get("Version", "") != STS_VERSION:
        raise S3Error(
            "InvalidParameterValue", f"Version must be {STS_VERSION}"
        )
    ctx = handler._auth
    if ctx is None or ctx.anonymous:
        raise S3Error("AccessDenied", "AssumeRole requires signed creds")
    # the reference refuses AssumeRole for temp creds; root is allowed
    duration = _duration(form)
    try:
        cred = handler.s3.iam.assume_role(
            ctx.access_key,
            duration_s=duration,
            session_policy=form.get("Policy") or None,
        )
    except UserNotFound:
        raise S3Error("STSInvalidClientTokenId") from None
    except IAMError as e:
        raise S3Error("InvalidParameterValue", str(e)) from None
    handler._respond(200, _response(action, cred))


def _handle_sts_oidc(handler, form: "dict[str, str]", action: str):
    """AssumeRoleWithWebIdentity / AssumeRoleWithClientGrants
    (sts-handlers.go:293-443): validate the provider-issued JWT, read
    the policy claim, mint a parentless temp credential carrying that
    policy.  Unsigned requests are allowed - the token IS the proof."""
    if form.get("Version", "") != STS_VERSION:
        raise S3Error(
            "InvalidParameterValue", f"Version must be {STS_VERSION}"
        )
    validator = openid.get_validator()
    if validator is None:
        raise S3Error(
            "NotImplemented",
            f"{action} requires an OpenID provider "
            f"(set {openid.ENV_CONFIG_URL})",
        )
    token_field = (
        "WebIdentityToken"
        if action == "AssumeRoleWithWebIdentity"
        else "Token"
    )
    token = form.get(token_field, "")
    if not token:
        raise S3Error("InvalidParameterValue", f"missing {token_field}")
    try:
        claims = validator.validate(token)
    except openid.OpenIDError as e:
        raise S3Error("AccessDenied", f"invalid token: {e}") from None
    try:
        policy = validator.policy_claim(claims)
    except openid.OpenIDError as e:
        raise S3Error("AccessDenied", str(e)) from None
    # the credential must NEVER outlive the identity token: an
    # explicit DurationSeconds is capped at the token's remaining
    # validity, and a token with less than the minimum left is
    # rejected outright (flooring it up would mint creds that
    # outlive the identity provider's session)
    remaining = None
    if isinstance(claims.get("exp"), (int, float)):
        remaining = int(claims["exp"] - time.time())
        if remaining < STS_MIN_DURATION_S:
            raise S3Error(
                "AccessDenied",
                "token expires too soon for a temporary credential",
            )
    duration = _duration(form)
    if duration is not None:
        if remaining is not None:
            duration = min(duration, remaining)
    elif remaining is not None:
        duration = min(remaining, STS_MAX_DURATION_S)
    try:
        cred = handler.s3.iam.assume_role_with_token(
            policy, duration_s=duration,
            subject=str(claims.get("sub", "")),
        )
    except PolicyNotFound as e:
        raise S3Error(
            "AccessDenied", f"policy claim names an unknown policy: {e}"
        ) from None
    except IAMError as e:
        raise S3Error("InvalidParameterValue", str(e)) from None
    subject_el = (
        "<SubjectFromWebIdentityToken>"
        f"{sx.escape(str(claims.get('sub', '')))}"
        "</SubjectFromWebIdentityToken>"
        if action == "AssumeRoleWithWebIdentity"
        else ""
    )
    handler._respond(200, _response(action, cred, subject_el))
