"""Hash-verifying reader wrapper (pkg/hash PutObjReader equivalent).

Wraps every upload stream: counts bytes, computes MD5 (the S3 ETag) and
optionally verifies client-supplied MD5/SHA256 at EOF, like
pkg/hash/reader.go.
"""

from __future__ import annotations

import hashlib


class BadDigest(Exception):
    def __init__(self, want: str, got: str):
        super().__init__(f"bad digest: want {want} got {got}")
        self.want, self.got = want, got


class SizeMismatch(Exception):
    """Fewer bytes arrived than the declared size (errIncompleteBody)."""

    def __init__(self, want: int, got: int):
        super().__init__(f"incomplete body: want {want} got {got}")
        self.want, self.got = want, got


class HashReader:
    def __init__(
        self,
        reader,
        size: int = -1,
        md5_hex: str = "",
        sha256_hex: str = "",
    ):
        self._r = reader
        self.size = size
        self.bytes_read = 0
        self._md5 = hashlib.md5()
        self._sha = hashlib.sha256() if sha256_hex else None
        self._want_md5 = md5_hex.lower()
        self._want_sha = sha256_hex.lower()
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        if self._eof:
            return b""
        limit = n
        if self.size >= 0:
            remaining = self.size - self.bytes_read
            limit = remaining if n < 0 else min(n, remaining)
            if limit <= 0:
                self._finish()
                return b""
        chunk = self._r.read(limit)
        if not chunk:
            self._finish()
            return b""
        self.bytes_read += len(chunk)
        self._md5.update(chunk)
        if self._sha is not None:
            self._sha.update(chunk)
        return chunk

    def _finish(self) -> None:
        if self._eof:
            return
        self._eof = True
        # a framed stream (SigV4ChunkedReader) still holds its terminal
        # chunk + trailer signatures/checksums - verify them at EOF
        fin = getattr(self._r, "finalize", None)
        if fin is not None:
            fin()
        if 0 <= self.size != self.bytes_read:
            raise SizeMismatch(self.size, self.bytes_read)
        if self._want_md5 and self.md5_hex() != self._want_md5:
            raise BadDigest(self._want_md5, self.md5_hex())
        if self._want_sha and self._sha.hexdigest() != self._want_sha:
            raise BadDigest(self._want_sha, self._sha.hexdigest())

    def md5_hex(self) -> str:
        return self._md5.hexdigest()

    def etag(self) -> str:
        return self.md5_hex()
