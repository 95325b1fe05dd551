"""Minimal HMAC-SHA256 JWT for internode authentication (cmd/jwt.go).

Every internode request carries a short-lived token signed with the
cluster credentials (newAuthToken, jwt.go:164; validated by
authenticateNode, jwt.go:84).  Only HS256 is supported - the algorithm
field is verified, not trusted.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JWTError(Exception):
    pass


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = (-len(s)) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def sign(claims: dict, secret: str, expiry_s: int = 900) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    body = dict(claims)
    now = int(time.time())
    body.setdefault("iat", now)
    body.setdefault("exp", now + expiry_s)
    h = _b64(json.dumps(header, separators=(",", ":")).encode())
    p = _b64(json.dumps(body, separators=(",", ":")).encode())
    sig = hmac.new(
        secret.encode(), f"{h}.{p}".encode(), hashlib.sha256
    ).digest()
    return f"{h}.{p}.{_b64(sig)}"


def verify(token: str, secret: str) -> dict:
    try:
        h, p, s = token.split(".")
    except ValueError:
        raise JWTError("malformed token") from None
    try:
        header = json.loads(_unb64(h))
    except Exception:  # noqa: BLE001
        raise JWTError("bad header") from None
    if header.get("alg") != "HS256":
        raise JWTError(f"algorithm {header.get('alg')!r} not allowed")
    want = hmac.new(
        secret.encode(), f"{h}.{p}".encode(), hashlib.sha256
    ).digest()
    if not hmac.compare_digest(want, _unb64(s)):
        raise JWTError("signature mismatch")
    try:
        claims = json.loads(_unb64(p))
    except Exception:  # noqa: BLE001
        raise JWTError("bad claims") from None
    if claims.get("exp", 0) < time.time():
        raise JWTError("token expired")
    return claims
