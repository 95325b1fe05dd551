"""Server-side encryption core (cmd/encryption-v1.go, pkg/crypto,
and the DARE stream format of minio/sio).

Stored representation: the plaintext (possibly already deflated by the
compression seam) is split into fixed 64 KiB chunks; each chunk is
sealed independently with AES-256-GCM as ``[nonce(12)][ct][tag(16)]``.
The 12-byte nonce is an 8-byte random prefix (per object/part) plus a
4-byte big-endian chunk counter, so chunks cannot be reordered or
replayed across positions - the sio DARE package construction.

Key hierarchy (pkg/crypto):
- a random 32-byte **object encryption key** (OEK) encrypts the data;
- the OEK is sealed with AES-256-GCM under a **key encryption key**:
  the client's key for SSE-C, the KMS master key for SSE-S3, with the
  bucket/object path as AAD so a sealed key cannot be replayed onto
  another object (crypto.SealObjectKey);
- only the sealed OEK is stored; for SSE-C the server keeps nothing
  but the client key's MD5 (to reject wrong keys with a clear error).

Metadata contract (rides FileInfo.metadata like the compression seam):
  x-internal-sse            = "C" | "S3"
  x-internal-sse-sealed-key = base64 sealed OEK
  x-internal-sse-nonce      = base64 8-byte base nonce prefix
  x-internal-sse-key-md5    = base64 MD5 of the SSE-C client key
  x-internal-sse-kms-id     = master key id (SSE-S3)
  x-internal-actual-size    = plaintext byte count (shared with
                              compression; encryption adds ~28B/64KiB)
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import os
import secrets
import struct

# gate the hard dependency: environments without `cryptography` can
# still import the object layer (SSE requests fail with a clear
# SSEError at use time instead of the whole package failing to import)
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
            raise SSEError(
                "server-side encryption requires the 'cryptography' "
                f"package: {_CRYPTO_IMPORT_ERROR}"
            )

from .compress import RangeSatisfied

CHUNK = 64 << 10  # plaintext bytes per sealed package (DARE payload)
NONCE_LEN = 12
TAG_LEN = 16
OVERHEAD = NONCE_LEN + TAG_LEN  # per chunk

META_SSE = "x-internal-sse"
META_SSE_SEALED_KEY = "x-internal-sse-sealed-key"
META_SSE_NONCE = "x-internal-sse-nonce"
META_SSE_KEY_MD5 = "x-internal-sse-key-md5"
META_SSE_KMS_ID = "x-internal-sse-kms-id"
# the per-object data key sealed by the KMS (crypto.S3KMSSealedKey);
# the OEK is sealed under this data key, not the master key directly
META_SSE_KMS_SEALED_DK = "x-internal-sse-kms-sealed-dk"
# original (client) part numbers, comma-separated: chunk nonces derive
# from the number the part was UPLOADED under, which complete's
# renumbering would otherwise lose
META_SSE_PARTS = "x-internal-sse-parts"


class SSEError(Exception):
    """Key/ciphertext problems (wrong key, tampered data, no KMS)."""


@dataclasses.dataclass
class SSESpec:
    """Parsed per-request encryption intent (the ObjectOptions
    ServerSideEncryption field)."""

    mode: str  # "C" (client key) | "S3" (KMS master key)
    key: "bytes | None" = None  # raw 32B client key for SSE-C


def master_key() -> "tuple[str, bytes]":
    """(key_id, 32B key) from MINIO_TPU_KMS_MASTER_KEY='id:hex64'
    (the MINIO_SSE_MASTER_KEY bootstrap KMS, cmd/crypto/sse.go)."""
    raw = os.environ.get("MINIO_TPU_KMS_MASTER_KEY", "")
    if not raw or ":" not in raw:
        raise SSEError(
            "SSE-S3 requires MINIO_TPU_KMS_MASTER_KEY=<id>:<hex 32B key>"
        )
    key_id, _, hexkey = raw.partition(":")
    try:
        key = bytes.fromhex(hexkey)
    except ValueError:
        raise SSEError("master key must be hex") from None
    if len(key) != 32:
        raise SSEError("master key must be 32 bytes")
    return key_id, key


def sse_s3_available() -> bool:
    from . import kms as kmsmod

    try:
        return kmsmod.get_kms() is not None
    except kmsmod.KMSError:
        return False


def new_object_key() -> bytes:
    return secrets.token_bytes(32)


def new_nonce_base() -> bytes:
    return secrets.token_bytes(NONCE_LEN - 4)


def seal_key(kek: bytes, oek: bytes, aad: str) -> bytes:
    """Seal the object key under the KEK (crypto.SealObjectKey):
    [nonce(12)][ct||tag]."""
    nonce = secrets.token_bytes(NONCE_LEN)
    return nonce + AESGCM(kek).encrypt(nonce, oek, aad.encode())


def unseal_key(kek: bytes, sealed: bytes, aad: str) -> bytes:
    try:
        return AESGCM(kek).decrypt(
            sealed[:NONCE_LEN], sealed[NONCE_LEN:], aad.encode()
        )
    except (InvalidTag, ValueError):
        raise SSEError(
            "decryption key does not match the object key"
        ) from None


def part_nonce_base(base: bytes, part_number: int) -> bytes:
    """Per-part nonce prefix: parts of one upload share the OEK, so
    their chunk nonces must not collide."""
    if part_number <= 1:
        return base
    return hashlib.sha256(
        base + struct.pack(">I", part_number)
    ).digest()[: NONCE_LEN - 4]


def stored_size(plain: int) -> int:
    """Ciphertext size for `plain` plaintext bytes."""
    if plain <= 0:
        return 0
    chunks = (plain + CHUNK - 1) // CHUNK
    return plain + chunks * OVERHEAD


def key_md5_b64(key: bytes) -> str:
    return base64.b64encode(hashlib.md5(key).digest()).decode()


class EncryptReader:
    """Pull-style encryptor: read(n) returns sealed DARE packages while
    draining the plaintext stream underneath (the inner HashReader
    keeps hashing plaintext, so ETags stay client MD5s)."""

    def __init__(self, inner, oek: bytes, nonce_base: bytes):
        self._inner = inner
        self._aead = AESGCM(oek)
        self._nbase = nonce_base
        self._seq = 0
        self._buf = bytearray()
        self._eof = False

    def _seal_next(self) -> None:
        plain = b""
        while len(plain) < CHUNK:
            got = self._inner.read(CHUNK - len(plain))
            if not got:
                self._eof = True
                break
            plain += got
        if not plain:
            return
        nonce = self._nbase + struct.pack(">I", self._seq)
        self._seq += 1
        self._buf += nonce + self._aead.encrypt(nonce, plain, None)

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            self._seal_next()
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
            return out
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class DecryptWriter:
    """Push-style decryptor with range skip: sealed packages go in,
    plaintext [offset, offset+length) comes out to ``writer`` (which
    may itself be a skipping DecompressWriter when the object is both
    compressed and encrypted).

    Raises RangeSatisfied once the requested range is fully written, so
    the erasure decode stops paying I/O; SSEError on a wrong key or a
    tampered/reordered chunk (the GCM tag or nonce sequence fails).
    """

    def __init__(
        self,
        writer,
        oek: bytes,
        nonce_base: bytes,
        offset: int = 0,
        length: int = -1,
        first_chunk: int = 0,
    ):
        self._w = writer
        self._aead = AESGCM(oek)
        self._nbase = nonce_base
        self._seq = first_chunk
        self._skip = offset
        self._remaining = length
        self._buf = bytearray()
        self._downstream_done = False

    @property
    def done(self) -> bool:
        return self._remaining == 0 or self._downstream_done

    def _emit(self, data: bytes) -> None:
        if self._skip:
            drop = min(self._skip, len(data))
            self._skip -= drop
            data = data[drop:]
        if self._remaining >= 0:
            data = data[: self._remaining]
            self._remaining -= len(data)
        if data:
            try:
                self._w.write(data)
            except RangeSatisfied:
                # a chained skipping decompressor has its full range:
                # remember so finish() does not try to open a partial
                # trailing package from the cut-short stream
                self._downstream_done = True
                raise

    def _open_package(self, pkg: bytes) -> None:
        nonce, ct = pkg[:NONCE_LEN], pkg[NONCE_LEN:]
        expect = self._nbase + struct.pack(">I", self._seq)
        if nonce != expect:
            raise SSEError("ciphertext chunk out of sequence")
        self._seq += 1
        try:
            plain = self._aead.decrypt(nonce, ct, None)
        except (InvalidTag, ValueError):
            raise SSEError("ciphertext verification failed") from None
        self._emit(plain)

    def write(self, stored: bytes) -> int:
        if self._remaining == 0:
            raise RangeSatisfied()
        self._buf += stored
        full = CHUNK + OVERHEAD
        while len(self._buf) >= full:
            self._open_package(bytes(self._buf[:full]))
            del self._buf[:full]
            if self._remaining == 0:
                raise RangeSatisfied()
        return len(stored)

    def finish(self) -> None:
        """Open the trailing short package (the stream's last chunk)."""
        if self._remaining == 0 or self._downstream_done:
            return
        if len(self._buf) > OVERHEAD:
            try:
                self._open_package(bytes(self._buf))
            except RangeSatisfied:
                # the chained decompressor completed its range on the
                # final chunk - that IS a clean finish
                return
            self._buf.clear()
        elif self._buf:
            raise SSEError("truncated ciphertext")
        # forward the finish to a chained decompressor
        fin = getattr(self._w, "finish", None)
        if fin is not None:
            fin()
