"""KMS abstraction for SSE-S3 key management (cmd/crypto/kms.go).

Mirrors the reference's KMS interface: ``generate_key`` mints a fresh
per-object data key and returns (plaintext, sealed) so only the sealed
form is ever persisted; ``unseal_key`` reverses it.  The *context* (a
string->string map, canonically serialized) is cryptographically bound
to the sealed key - a sealed key lifted onto another object fails to
unseal (crypto.Context, cmd/crypto/kms.go:44-71).

Two implementations:

- :class:`MasterKeyKMS` - a single local 32-byte master key
  (``MINIO_TPU_KMS_MASTER_KEY=<id>:<hex>``), the masterKeyKMS
  bootstrap path (cmd/crypto/kms.go:104).
- :class:`KESClientKMS` - an HTTP client speaking the KES key-service
  API (``/v1/key/generate/<id>``, ``/v1/key/decrypt/<id>``,
  cmd/crypto/kes.go).  Auth is a bearer token
  (``MINIO_TPU_KMS_KES_TOKEN``) instead of the reference's mTLS
  client certificates - the wire shapes match, the transport
  credential is simpler.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import secrets
import threading
import urllib.parse

class KMSError(Exception):
    pass


# gate the hard dependency the same way codec/sse.py does: the module
# stays importable without `cryptography`, KMS operations fail with a
# clear KMSError at use time
try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    _CRYPTO_IMPORT_ERROR: "Exception | None" = None
except ImportError as _e:  # pragma: no cover - depends on environment
    _CRYPTO_IMPORT_ERROR = _e

    class InvalidTag(Exception):  # type: ignore[no-redef]
        pass

    class AESGCM:  # type: ignore[no-redef]
        def __init__(self, key):
            raise KMSError(
                "KMS sealing requires the 'cryptography' package: "
                f"{_CRYPTO_IMPORT_ERROR}"
            )


def context_aad(context: "dict[str, str]") -> bytes:
    """Canonical serialization of the KMS context, used as AEAD AAD
    (crypto.Context.MarshalText: sorted keys)."""
    return json.dumps(
        context or {}, sort_keys=True, separators=(",", ":")
    ).encode()


class KMS:
    """cmd/crypto/kms.go:74 interface."""

    def default_key_id(self) -> str:
        raise NotImplementedError

    def create_key(self, key_id: str) -> None:
        raise NotImplementedError

    def generate_key(
        self, key_id: str, context: "dict[str, str]"
    ) -> "tuple[bytes, bytes]":
        """(plaintext 32B data key, sealed data key)."""
        raise NotImplementedError

    def unseal_key(
        self, key_id: str, sealed: bytes, context: "dict[str, str]"
    ) -> bytes:
        raise NotImplementedError

    def info(self) -> dict:
        raise NotImplementedError


class MasterKeyKMS(KMS):
    def __init__(self, key_id: str, master_key: bytes):
        if len(master_key) != 32:
            raise KMSError("master key must be 32 bytes")
        self._id = key_id
        self._mk = master_key

    def default_key_id(self) -> str:
        return self._id

    def create_key(self, key_id: str) -> None:
        raise KMSError(
            "the local master-key KMS cannot create new keys"
        )

    def generate_key(self, key_id, context):
        if key_id != self._id:
            raise KMSError(f"unknown master key {key_id!r}")
        dk = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        sealed = nonce + AESGCM(self._mk).encrypt(
            nonce, dk, context_aad(context)
        )
        return dk, sealed

    def unseal_key(self, key_id, sealed, context):
        if key_id != self._id:
            raise KMSError(f"unknown master key {key_id!r}")
        try:
            return AESGCM(self._mk).decrypt(
                sealed[:12], sealed[12:], context_aad(context)
            )
        except (InvalidTag, ValueError):
            raise KMSError(
                "sealed key does not unseal under this master key / "
                "context"
            ) from None

    def info(self) -> dict:
        return {"endpoint": "local", "name": self._id, "auth": "master-key"}


class KESClientKMS(KMS):
    """KES-shaped HTTP key service client (cmd/crypto/kes.go:149)."""

    def __init__(self, endpoint: str, key_id: str, token: str = "",
                 timeout_s: float = 10.0):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise KMSError(f"bad KES endpoint {endpoint!r}")
        self._tls = u.scheme == "https"
        self._host = u.hostname
        self._port = u.port or (443 if self._tls else 80)
        self._token = token
        self._timeout = timeout_s
        self._id = key_id
        self._local = threading.local()

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            if self._tls:
                import ssl

                ctx = ssl.create_default_context()
                if os.environ.get("MINIO_TPU_KMS_KES_INSECURE") == "1":
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                c = http.client.HTTPSConnection(
                    self._host, self._port, timeout=self._timeout,
                    context=ctx,
                )
            else:
                c = http.client.HTTPConnection(
                    self._host, self._port, timeout=self._timeout
                )
            self._local.conn = c
        return c

    def _call(self, path: str, doc: dict) -> dict:
        body = json.dumps(doc).encode()
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        for attempt in (0, 1):  # one retry on a dropped keep-alive
            conn = self._conn()
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                break
            except (OSError, http.client.HTTPException):
                self._local.conn = None
                if attempt:
                    raise KMSError(
                        f"KES {self._host}:{self._port} unreachable"
                    ) from None
        if resp.status != 200:
            raise KMSError(
                f"KES {path}: HTTP {resp.status} "
                f"{payload[:200].decode(errors='replace')}"
            )
        try:
            return json.loads(payload)
        except ValueError:
            raise KMSError("KES returned malformed JSON") from None

    def default_key_id(self) -> str:
        return self._id

    def create_key(self, key_id: str) -> None:
        self._call(f"/v1/key/create/{urllib.parse.quote(key_id)}", {})

    def generate_key(self, key_id, context):
        doc = self._call(
            f"/v1/key/generate/{urllib.parse.quote(key_id)}",
            {
                "context": base64.b64encode(
                    context_aad(context)
                ).decode()
            },
        )
        try:
            return (
                base64.b64decode(doc["plaintext"]),
                base64.b64decode(doc["ciphertext"]),
            )
        except (KeyError, ValueError):
            raise KMSError("KES generate: bad response body") from None

    def unseal_key(self, key_id, sealed, context):
        doc = self._call(
            f"/v1/key/decrypt/{urllib.parse.quote(key_id)}",
            {
                "ciphertext": base64.b64encode(sealed).decode(),
                "context": base64.b64encode(
                    context_aad(context)
                ).decode(),
            },
        )
        try:
            return base64.b64decode(doc["plaintext"])
        except (KeyError, ValueError):
            raise KMSError("KES decrypt: bad response body") from None

    def info(self) -> dict:
        return {
            "endpoint": f"{'https' if self._tls else 'http'}://"
            f"{self._host}:{self._port}",
            "name": self._id,
            "auth": "token",
        }


# -- global KMS (GlobalKMS, cmd/globals.go) --------------------------------

_kms: "KMS | None" = None
_kms_loaded = False
_kms_lock = threading.Lock()


def set_kms(kms: "KMS | None") -> None:
    """Install explicitly (tests, embedders); None re-enables the
    env-driven lookup."""
    global _kms, _kms_loaded
    with _kms_lock:
        _kms = kms
        _kms_loaded = kms is not None


def get_kms() -> "KMS | None":
    """The process KMS: KES when configured, else the local master
    key, else None (SSE-S3 unavailable)."""
    global _kms, _kms_loaded
    with _kms_lock:
        if _kms_loaded:
            return _kms
        kes = os.environ.get("MINIO_TPU_KMS_KES_ENDPOINT", "")
        if kes:
            _kms = KESClientKMS(
                kes,
                os.environ.get("MINIO_TPU_KMS_KES_KEY_ID", "minio-tpu"),
                os.environ.get("MINIO_TPU_KMS_KES_TOKEN", ""),
            )
        else:
            raw = os.environ.get("MINIO_TPU_KMS_MASTER_KEY", "")
            if raw:
                key_id, sep, hexkey = raw.partition(":")
                if not sep or not key_id:
                    # a SET but malformed key is a config error, not
                    # "no KMS" - silence here would fail every SSE-S3
                    # write with a misleading 'not configured'
                    raise KMSError(
                        "MINIO_TPU_KMS_MASTER_KEY must be <id>:<hex>"
                    )
                try:
                    mk = bytes.fromhex(hexkey)
                except ValueError:
                    raise KMSError(
                        "MINIO_TPU_KMS_MASTER_KEY must be <id>:<hex>"
                    ) from None
                _kms = MasterKeyKMS(key_id, mk)
            else:
                _kms = None
        _kms_loaded = True
        return _kms


def reset_kms_cache() -> None:
    """Forget the cached env-derived KMS (tests changing env vars)."""
    global _kms, _kms_loaded
    with _kms_lock:
        _kms = None
        _kms_loaded = False
