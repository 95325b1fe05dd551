"""OpenID Connect token validation for the STS federation variants
(cmd/sts-handlers.go:293-443 AssumeRoleWithWebIdentity/ClientGrants;
pkg/iam/openid/jwt.go validator).

The validator fetches the provider's discovery document, caches its
JWKS, and verifies RS256 ID tokens with a pure-Python PKCS#1 v1.5
check (modular exponentiation + EMSA-PKCS1-v1_5 comparison) - no
external crypto dependency, same wire behavior as the reference's
coreos/go-oidc verification: signature, exp/nbf, issuer, audience.

Config (env or KV config, like the reference's identity_openid
subsystem):
  MINIO_TPU_IDENTITY_OPENID_CONFIG_URL  discovery document URL
  MINIO_TPU_IDENTITY_OPENID_CLIENT_ID   expected audience (optional)
  MINIO_TPU_IDENTITY_OPENID_CLAIM_NAME  policy claim (default "policy")
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import threading
import time
import urllib.request

# SHA-256 DigestInfo prefix (RFC 8017 EMSA-PKCS1-v1_5 encoding)
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)

ENV_CONFIG_URL = "MINIO_TPU_IDENTITY_OPENID_CONFIG_URL"
ENV_CLIENT_ID = "MINIO_TPU_IDENTITY_OPENID_CLIENT_ID"
ENV_CLAIM_NAME = "MINIO_TPU_IDENTITY_OPENID_CLAIM_NAME"

DEFAULT_CLAIM = "policy"
_JWKS_TTL_S = 300.0


class OpenIDError(Exception):
    pass


def _b64u(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    try:
        return base64.urlsafe_b64decode(data + pad)
    except (ValueError, TypeError) as e:
        raise OpenIDError(f"bad base64url: {e}") from None


def _b64u_int(data: str) -> int:
    return int.from_bytes(_b64u(data), "big")


def rsa_verify_sha256(n: int, e: int, msg: bytes, sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 with SHA-256, from first principles: one
    modular exponentiation and a constant-time padding comparison."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    ps_len = k - 3 - len(_SHA256_PREFIX) - 32
    if ps_len < 8:
        return False
    expected = (
        b"\x00\x01"
        + b"\xff" * ps_len
        + b"\x00"
        + _SHA256_PREFIX
        + hashlib.sha256(msg).digest()
    )
    return hmac.compare_digest(em, expected)


class OpenIDValidator:
    """Validates ID tokens from one OIDC provider."""

    def __init__(
        self,
        config_url: str,
        client_id: str = "",
        claim_name: str = DEFAULT_CLAIM,
        fetch=None,
    ):
        self.config_url = config_url
        self.client_id = client_id
        self.claim_name = claim_name or DEFAULT_CLAIM
        self._fetch = fetch or self._http_get
        self._mu = threading.Lock()
        self._issuer = ""
        self._keys: "dict[str, tuple[int, int]]" = {}
        self._keys_ts = 0.0

    @staticmethod
    def _http_get(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read())

    def _refresh_keys(self, force: bool = False) -> None:
        with self._mu:
            if (
                not force
                and self._keys
                and time.monotonic() - self._keys_ts < _JWKS_TTL_S
            ):
                return
            try:
                disc = self._fetch(self.config_url)
                jwks = self._fetch(disc["jwks_uri"])
            except (OSError, KeyError, ValueError) as e:
                raise OpenIDError(
                    f"OpenID discovery failed: {e}"
                ) from None
            self._issuer = disc.get("issuer", "")
            keys = {}
            for k in jwks.get("keys", []):
                if k.get("kty") != "RSA":
                    continue
                try:
                    keys[k.get("kid", "")] = (
                        _b64u_int(k["n"]),
                        _b64u_int(k["e"]),
                    )
                except (KeyError, OpenIDError):
                    continue
            if not keys:
                raise OpenIDError("provider JWKS has no RSA keys")
            self._keys = keys
            self._keys_ts = time.monotonic()

    def _key_for(self, kid: str) -> "tuple[int, int]":
        self._refresh_keys()
        with self._mu:
            key = self._keys.get(kid)
        if key is None:
            # unknown kid: the provider may have rotated - refetch once
            self._refresh_keys(force=True)
            with self._mu:
                key = self._keys.get(kid)
                if key is None and len(self._keys) == 1:
                    # tokens commonly omit kid when one key exists
                    key = next(iter(self._keys.values()))
        if key is None:
            raise OpenIDError(f"no JWKS key for kid {kid!r}")
        return key

    def validate(self, token: str) -> dict:
        """Claims of a valid token; raises OpenIDError otherwise."""
        parts = token.split(".")
        if len(parts) != 3:
            raise OpenIDError("token is not a JWS")
        try:
            header = json.loads(_b64u(parts[0]))
            claims = json.loads(_b64u(parts[1]))
        except ValueError as e:
            raise OpenIDError(f"bad token JSON: {e}") from None
        if not isinstance(header, dict) or not isinstance(
            claims, dict
        ):
            raise OpenIDError("token segments are not JSON objects")
        if header.get("alg") != "RS256":
            raise OpenIDError(
                f"algorithm {header.get('alg')!r} not allowed"
            )
        n, e = self._key_for(header.get("kid", ""))
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        if not rsa_verify_sha256(
            n, e, signing_input, _b64u(parts[2])
        ):
            raise OpenIDError("signature verification failed")
        now = time.time()
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)) or exp <= now:
            raise OpenIDError("token expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and nbf > now + 60:
            raise OpenIDError("token not yet valid")
        if self._issuer and claims.get("iss") != self._issuer:
            raise OpenIDError("issuer mismatch")
        if self.client_id:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.client_id not in auds and claims.get(
                "azp"
            ) != self.client_id:
                raise OpenIDError("audience mismatch")
        return claims

    def policy_claim(self, claims: dict) -> str:
        """The policy name(s) carried in the configured claim
        (pkg/iam/openid GetDefaultExpClaims policy extraction).
        Multiple policies arrive comma-separated or as a list; the
        normalized comma-joined form is stored on the credential."""
        v = claims.get(self.claim_name)
        if v is None:
            raise OpenIDError(
                f"token carries no {self.claim_name!r} claim"
            )
        if isinstance(v, (list, tuple)):
            names = [str(x).strip() for x in v if str(x).strip()]
        else:
            names = [s.strip() for s in str(v).split(",") if s.strip()]
        if not names:
            raise OpenIDError(f"empty {self.claim_name!r} claim")
        return ",".join(names)


_validator: "OpenIDValidator | None" = None
_validator_url = ""


def get_validator() -> "OpenIDValidator | None":
    """Process validator from env config; None when unconfigured."""
    global _validator, _validator_url
    url = os.environ.get(ENV_CONFIG_URL, "")
    if not url:
        _validator = None
        _validator_url = ""
        return None
    if _validator is None or _validator_url != url:
        _validator = OpenIDValidator(
            url,
            client_id=os.environ.get(ENV_CLIENT_ID, ""),
            claim_name=os.environ.get(ENV_CLAIM_NAME, DEFAULT_CLAIM),
        )
        _validator_url = url
    return _validator


def reset_validator_cache() -> None:
    """Testing aid: drop the cached validator (env changed)."""
    global _validator, _validator_url
    _validator = None
    _validator_url = ""
