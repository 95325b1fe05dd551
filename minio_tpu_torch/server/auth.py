"""AWS signature verification (cmd/signature-v4.go, signature-v2.go,
streaming-signature-v4.go, postpolicyform.go).

Supports:
* header SigV4 + presigned SigV4, with UNSIGNED-PAYLOAD / signed payloads
* streaming SigV4 ("aws-chunked" with per-chunk signatures) and the
  unsigned-trailer streaming variant, via SigV4ChunkedReader
* header SigV2 + presigned SigV2 (legacy HMAC-SHA1)
* POST form policy signatures (browser uploads)

Verification is two-phase so the server never buffers bodies for auth:
``verify_stream`` checks the signature against the *declared* payload
hash and returns an AuthContext describing how the body must be read
(chunk-signature framing and/or content-sha256 to verify at EOF).
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import hashlib
import hmac
import json
import urllib.parse

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
SIGN_V2_ALGORITHM = "AWS"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_PAYLOAD_TRAILER = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
PRESIGN_MAX_EXPIRES = 7 * 24 * 3600


class AuthError(Exception):
    """Maps to a specific S3 error code."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def _canonical_query(query: "dict[str, list[str]]", skip=("X-Amz-Signature",)) -> str:
    pairs = []
    for k in sorted(query):
        if k in skip:
            continue
        for v in sorted(query[k]):
            pairs.append(f"{_uri_encode(k)}={_uri_encode(v)}")
    return "&".join(pairs)


def _signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(
        ("AWS4" + secret).encode(), date.encode(), hashlib.sha256
    ).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _hmac_hex(key: bytes, msg: str) -> str:
    return hmac.new(key, msg.encode(), hashlib.sha256).hexdigest()


def canonical_request(
    method: str,
    path: str,
    query: "dict[str, list[str]]",
    headers: "dict[str, str]",
    signed_headers: list[str],
    payload_hash: str,
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers
    )
    return "\n".join(
        [
            method.upper(),
            _uri_encode(path, encode_slash=False) or "/",
            _canonical_query(query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join(
        [
            SIGN_V4_ALGORITHM,
            amz_date,
            scope,
            hashlib.sha256(creq.encode()).hexdigest(),
        ]
    )


def sign_v4(
    method: str,
    path: str,
    query: "dict[str, list[str]]",
    headers: "dict[str, str]",
    signed_headers: list[str],
    payload_hash: str,
    access_key: str,
    secret_key: str,
    amz_date: str,
    region: str = "us-east-1",
    service: str = "s3",
) -> str:
    """Compute the V4 signature (shared by verifier, clients, presigner)."""
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    creq = canonical_request(
        method, path, query, headers, signed_headers, payload_hash
    )
    sts = string_to_sign(amz_date, scope, creq)
    key = _signing_key(secret_key, date, region, service)
    return _hmac_hex(key, sts)


class Credentials:
    def __init__(self, access_key: str, secret_key: str):
        self.access_key = access_key
        self.secret_key = secret_key


@dataclasses.dataclass
class AuthContext:
    """How a request authenticated + how its body must be consumed.

    The auth-type classification the reference makes in
    getRequestAuthType (cmd/auth-handler.go:101), carried forward so
    handlers can wire the right body reader without re-parsing headers.
    """

    access_key: str = ""
    kind: str = "anonymous"  # v4 | v4-presigned | v2 | v2-presigned | anonymous
    content_sha256: "str | None" = None  # hex digest to verify at EOF
    streaming: bool = False  # body uses aws-chunked framing
    signed_chunks: bool = False  # each chunk carries a V4 signature
    trailer: bool = False  # trailing checksum headers after last chunk
    trailer_header: str = ""  # declared x-amz-trailer checksum name
    seed_signature: str = ""
    signing_key: bytes = b""
    amz_date: str = ""
    scope: str = ""

    @property
    def anonymous(self) -> bool:
        return self.kind == "anonymous"


class SigV4Verifier:
    """Verifies incoming requests against a credential lookup."""

    def __init__(self, lookup, region: str = "us-east-1", clock=None):
        """lookup(access_key) -> secret_key or None."""
        self._lookup = lookup
        self.region = region
        self._clock = clock or (
            lambda: datetime.datetime.now(datetime.timezone.utc)
        )

    # -- entry points ----------------------------------------------------

    def verify_stream(
        self,
        method: str,
        path: str,
        query: "dict[str, list[str]]",
        headers: "dict[str, str]",
    ) -> AuthContext:
        """Body-free verification: check the signature against the
        *declared* payload hash and describe how to read the body.

        Anonymous requests return an anonymous context (policy decides
        downstream); bad signatures raise AuthError.
        """
        headers = {k.lower(): v for k, v in headers.items()}
        auth = headers.get("authorization", "")
        if auth.startswith(SIGN_V4_ALGORITHM):
            return self._verify_header(method, path, query, headers)
        if "X-Amz-Algorithm" in query:
            return self._verify_presigned(method, path, query, headers)
        if auth.startswith(SIGN_V2_ALGORITHM + " "):
            return self._verify_v2_header(method, path, query, headers)
        if "Signature" in query and "AWSAccessKeyId" in query:
            return self._verify_v2_presigned(method, path, query, headers)
        return AuthContext()

    def verify_post_policy(self, form: "dict[str, str]") -> str:
        """POST form-upload verification against this verifier's
        credential store; returns the access key."""
        return verify_post_policy(
            form, self._lookup, self.region, self._clock
        )

    def verify(
        self,
        method: str,
        path: str,
        query: "dict[str, list[str]]",
        headers: "dict[str, str]",
        payload: bytes = b"",
    ) -> str:
        """Buffered-body compatibility wrapper: verify signature AND
        payload hash in one call.  Returns the access key."""
        headers = {k.lower(): v for k, v in headers.items()}
        if (
            headers.get("authorization", "").startswith(SIGN_V4_ALGORITHM)
            and "x-amz-content-sha256" not in headers
        ):
            # old-style clients sign the actual body hash without sending
            # the header; reconstruct it (possible here: we have the body)
            headers = dict(headers)
            headers["x-amz-content-sha256"] = hashlib.sha256(
                payload
            ).hexdigest()
        ctx = self.verify_stream(method, path, query, headers)
        if ctx.anonymous:
            raise AuthError("AccessDenied", "no credentials provided")
        if ctx.streaming:
            raise AuthError(
                "InvalidRequest", "streaming body in buffered verify"
            )
        if ctx.content_sha256 is not None:
            actual = hashlib.sha256(payload).hexdigest()
            if actual != ctx.content_sha256:
                raise AuthError(
                    "XAmzContentSHA256Mismatch", "payload hash mismatch"
                )
        return ctx.access_key

    # -- header auth -----------------------------------------------------

    def _verify_header(self, method, path, query, headers) -> AuthContext:
        auth = headers["authorization"]
        try:
            rest = auth[len(SIGN_V4_ALGORITHM):].strip()
            fields = dict(
                kv.strip().split("=", 1) for kv in rest.split(",")
            )
            credential = fields["Credential"]
            signed_headers = fields["SignedHeaders"].split(";")
            got_sig = fields["Signature"]
            access_key, date, region, service, term = (
                credential.split("/", 4)
            )
        except (KeyError, ValueError):
            raise AuthError(
                "AuthorizationHeaderMalformed", auth
            ) from None
        if term != "aws4_request" or service != "s3":
            raise AuthError("AuthorizationHeaderMalformed", credential)
        if region != self.region:
            raise AuthError(
                "AuthorizationHeaderMalformed",
                f"bad region {region}, expecting {self.region}",
            )
        secret = self._lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", access_key)
        amz_date = headers.get("x-amz-date", "")
        if not amz_date:
            # SigV4 permits signing with the RFC1123 Date header; the
            # string-to-sign timestamp is still ISO-basic
            rfc_date = headers.get("date", "")
            if not rfc_date:
                raise AuthError("AccessDenied", "missing date")
            import email.utils

            try:
                t = email.utils.parsedate_to_datetime(rfc_date)
            except (TypeError, ValueError):
                raise AuthError("MalformedDate", rfc_date) from None
            if t is None:
                raise AuthError("MalformedDate", rfc_date)
            amz_date = t.astimezone(datetime.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ"
            )
        self._check_skew(amz_date)
        payload_hash = headers.get("x-amz-content-sha256", "")
        if not payload_hash:
            raise AuthError(
                "InvalidRequest", "missing x-amz-content-sha256"
            )
        ctx = AuthContext(access_key=access_key, kind="v4")
        if payload_hash in (STREAMING_PAYLOAD, STREAMING_PAYLOAD_TRAILER):
            ctx.streaming = True
            ctx.signed_chunks = True
            ctx.trailer = payload_hash == STREAMING_PAYLOAD_TRAILER
        elif payload_hash == STREAMING_UNSIGNED_TRAILER:
            ctx.streaming = True
            ctx.trailer = True
        elif payload_hash != UNSIGNED_PAYLOAD:
            ctx.content_sha256 = payload_hash.lower()
        if ctx.trailer:
            ctx.trailer_header = headers.get("x-amz-trailer", "").strip().lower()
        want = sign_v4(
            method, path, query, headers, signed_headers, payload_hash,
            access_key, secret, amz_date, region,
        )
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch", "")
        ctx.seed_signature = got_sig
        ctx.signing_key = _signing_key(secret, amz_date[:8], region, "s3")
        ctx.amz_date = amz_date
        ctx.scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
        return ctx

    # -- presigned auth --------------------------------------------------

    def _verify_presigned(self, method, path, query, headers) -> AuthContext:
        q1 = {k: v[0] for k, v in query.items()}
        if q1.get("X-Amz-Algorithm") != SIGN_V4_ALGORITHM:
            raise AuthError("InvalidRequest", "bad algorithm")
        try:
            credential = q1["X-Amz-Credential"]
            amz_date = q1["X-Amz-Date"]
            expires = int(q1["X-Amz-Expires"])
            signed_headers = q1["X-Amz-SignedHeaders"].split(";")
            got_sig = q1["X-Amz-Signature"]
            access_key, date, region, service, term = (
                credential.split("/", 4)
            )
        except (KeyError, ValueError):
            raise AuthError(
                "AuthorizationQueryParametersError", ""
            ) from None
        if not (0 < expires <= PRESIGN_MAX_EXPIRES):
            raise AuthError(
                "AuthorizationQueryParametersError", "bad expires"
            )
        secret = self._lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", access_key)
        # expiry check
        try:
            t0 = datetime.datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ"
            ).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            raise AuthError("MalformedDate", amz_date) from None
        now = self._clock()
        if now < t0 - datetime.timedelta(minutes=15):
            raise AuthError("RequestNotReadyYet", "")
        if now > t0 + datetime.timedelta(seconds=expires):
            raise AuthError("ExpiredToken", "presigned URL expired")
        payload_hash = q1.get("X-Amz-Content-Sha256", UNSIGNED_PAYLOAD)
        want = sign_v4(
            method, path, query, headers, signed_headers, payload_hash,
            access_key, secret, amz_date, region,
        )
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch", "")
        ctx = AuthContext(access_key=access_key, kind="v4-presigned")
        if payload_hash not in (UNSIGNED_PAYLOAD, ""):
            ctx.content_sha256 = payload_hash.lower()
        return ctx

    # -- SigV2 (cmd/signature-v2.go) -------------------------------------

    def _v2_secret(self, access_key: str) -> str:
        secret = self._lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", access_key)
        return secret

    def _verify_v2_header(self, method, path, query, headers) -> AuthContext:
        auth = headers["authorization"]
        try:
            access_key, got_sig = auth[len(SIGN_V2_ALGORITHM) + 1 :].split(
                ":", 1
            )
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed", auth) from None
        secret = self._v2_secret(access_key)
        # Date slot is empty when x-amz-date is present (it is then part of
        # the canonical amz headers), mirroring signature-v2.go
        date_str = (
            "" if "x-amz-date" in headers else headers.get("date", "")
        )
        sts = _string_to_sign_v2(method, path, query, headers, date_str)
        want = base64.b64encode(
            hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch", "")
        return AuthContext(access_key=access_key, kind="v2")

    def _verify_v2_presigned(self, method, path, query, headers) -> AuthContext:
        q1 = {k: v[0] for k, v in query.items()}
        access_key = q1["AWSAccessKeyId"]
        got_sig = q1["Signature"]
        expires = q1.get("Expires", "")
        secret = self._v2_secret(access_key)
        try:
            exp_t = int(expires)
        except ValueError:
            raise AuthError(
                "AuthorizationQueryParametersError", "bad Expires"
            ) from None
        if self._clock().timestamp() > exp_t:
            raise AuthError("ExpiredToken", "presigned URL expired")
        sts = _string_to_sign_v2(method, path, query, headers, expires)
        want = base64.b64encode(
            hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch", "")
        return AuthContext(access_key=access_key, kind="v2-presigned")

    def _check_skew(self, amz_date: str) -> None:
        try:
            t = datetime.datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ"
            ).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            raise AuthError("MalformedDate", amz_date) from None
        skew = abs((self._clock() - t).total_seconds())
        if skew > 15 * 60:
            raise AuthError(
                "RequestTimeTooSkewed", f"skew {int(skew)}s"
            )


def presign_url(
    method: str,
    url: str,
    access_key: str,
    secret_key: str,
    expires: int = 3600,
    region: str = "us-east-1",
    amz_date: "str | None" = None,
) -> str:
    """Generate a presigned URL (client-side helper, web handlers)."""
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    if amz_date is None:
        amz_date = datetime.datetime.now(
            datetime.timezone.utc
        ).strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
    query.update(
        {
            "X-Amz-Algorithm": [SIGN_V4_ALGORITHM],
            "X-Amz-Credential": [
                f"{access_key}/{date}/{region}/s3/aws4_request"
            ],
            "X-Amz-Date": [amz_date],
            "X-Amz-Expires": [str(expires)],
            "X-Amz-SignedHeaders": ["host"],
        }
    )
    sig = sign_v4(
        method, parsed.path or "/", query, {"host": host}, ["host"],
        UNSIGNED_PAYLOAD, access_key, secret_key, amz_date, region,
    )
    query["X-Amz-Signature"] = [sig]
    qs = urllib.parse.urlencode(query, doseq=True, quote_via=urllib.parse.quote)
    return urllib.parse.urlunsplit(
        (parsed.scheme, parsed.netloc, parsed.path, qs, "")
    )


# ---------------------------------------------------------------------------
# SigV2 canonicalization (cmd/signature-v2.go resourceList + stringToSign)
# ---------------------------------------------------------------------------

V2_SUBRESOURCES = frozenset(
    {
        "acl", "delete", "lifecycle", "location", "logging",
        "notification", "partNumber", "policy", "requestPayment",
        "response-cache-control", "response-content-disposition",
        "response-content-encoding", "response-content-language",
        "response-content-type", "response-expires", "torrent",
        "uploadId", "uploads", "versionId", "versioning", "versions",
        "website",
    }
)


def _string_to_sign_v2(method, path, query, headers, date_str: str) -> str:
    amz: "dict[str, list[str]]" = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith("x-amz-"):
            amz.setdefault(lk, []).append(" ".join(v.split()))
    canon_amz = "".join(
        f"{k}:{','.join(amz[k])}\n" for k in sorted(amz)
    )
    sub = []
    for k in sorted(query):
        if k not in V2_SUBRESOURCES:
            continue
        vals = query[k]
        if vals and vals[0]:
            sub.append(f"{k}={vals[0]}")
        else:
            sub.append(k)
    resource = path + (f"?{'&'.join(sub)}" if sub else "")
    return (
        f"{method.upper()}\n"
        f"{headers.get('content-md5', '')}\n"
        f"{headers.get('content-type', '')}\n"
        f"{date_str}\n"
        f"{canon_amz}{resource}"
    )


def sign_v2(
    method, path, query, headers, secret_key: str, date_str: str
) -> str:
    """Compute the V2 signature (test-client helper)."""
    sts = _string_to_sign_v2(method, path, query, headers, date_str)
    return base64.b64encode(
        hmac.new(secret_key.encode(), sts.encode(), hashlib.sha1).digest()
    ).decode()


# ---------------------------------------------------------------------------
# Streaming SigV4 chunked reader (cmd/streaming-signature-v4.go)
# ---------------------------------------------------------------------------


def _crc32c_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE: "list[int] | None" = None


class _Crc32c:
    """Software CRC32C (no stdlib impl).  Table-driven Python - slow on
    big bodies, but only runs when a client declares this trailer."""

    def __init__(self):
        global _CRC32C_TABLE
        if _CRC32C_TABLE is None:
            _CRC32C_TABLE = _crc32c_table()
        self._crc = 0xFFFFFFFF

    def update(self, data: bytes) -> None:
        crc, table = self._crc, _CRC32C_TABLE
        for b in data:
            crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
        self._crc = crc

    def digest(self) -> bytes:
        return (self._crc ^ 0xFFFFFFFF).to_bytes(4, "big")


class _Crc32:
    def __init__(self):
        import zlib

        self._z = zlib
        self._crc = 0

    def update(self, data: bytes) -> None:
        self._crc = self._z.crc32(data, self._crc)

    def digest(self) -> bytes:
        return self._crc.to_bytes(4, "big")


class _HashlibChecksum:
    def __init__(self, name: str):
        self._h = hashlib.new(name)

    def update(self, data: bytes) -> None:
        self._h.update(data)

    def digest(self) -> bytes:
        return self._h.digest()


def _new_trailer_checksum(header: str):
    """Incremental checksum for a declared x-amz-checksum-* trailer, or
    None when the algorithm is unknown (forward compatibility)."""
    algo = header.rpartition("-")[2]
    if algo == "crc32":
        return _Crc32()
    if algo == "crc32c":
        return _Crc32c()
    if algo in ("sha1", "sha256"):
        return _HashlibChecksum(algo)
    return None


class SigV4ChunkedReader:
    """Decode an aws-chunked body, verifying each chunk's V4 signature.

    Framing: ``<hex-size>[;chunk-signature=<sig>]\\r\\n<data>\\r\\n`` ...
    terminated by a zero-size chunk, optionally followed by trailing
    headers (x-amz-checksum-*) and a trailer signature.  The per-chunk
    string-to-sign chains the previous signature exactly as
    newSignV4ChunkedReader does.
    """

    MAX_LINE = 4096  # maxLineLength, streaming-signature-v4.go
    MAX_CHUNK = 16 << 20  # sanity cap on a single declared chunk

    def __init__(self, raw, ctx: AuthContext, decoded_length: int = -1):
        self._raw = raw
        self._ctx = ctx
        self._prev = ctx.seed_signature
        self._buf = bytearray()
        self._chunk = b""
        self._off = 0
        self._done = False
        self.decoded_length = decoded_length
        self.trailers: "dict[str, str]" = {}
        self._cksum = (
            _new_trailer_checksum(ctx.trailer_header)
            if ctx.trailer and ctx.trailer_header
            else None
        )

    # internal buffered reads over the raw (already length-limited) stream

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self._raw.read(65536)
            if not chunk:
                raise AuthError("IncompleteBody", "truncated chunked body")
            self._buf.extend(chunk)

    def _read_exact(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _read_line(self) -> bytes:
        while True:
            idx = self._buf.find(b"\r\n")
            if idx >= 0:
                line = bytes(self._buf[:idx])
                del self._buf[: idx + 2]
                return line
            if len(self._buf) > self.MAX_LINE:
                # a chunk header/trailer line this long is an attack,
                # not a client (bounded-memory guarantee)
                raise AuthError("IncompleteBody", "chunk header too long")
            chunk = self._raw.read(65536)
            if not chunk:
                # final trailer lines may end without CRLF
                line = bytes(self._buf)
                del self._buf[:]
                return line
            self._buf.extend(chunk)

    def _verify_chunk(self, data: bytes) -> None:
        sts = "\n".join(
            [
                "AWS4-HMAC-SHA256-PAYLOAD",
                self._ctx.amz_date,
                self._ctx.scope,
                self._prev,
                EMPTY_SHA256,
                hashlib.sha256(data).hexdigest(),
            ]
        )
        want = _hmac_hex(self._ctx.signing_key, sts)
        if not hmac.compare_digest(want, self._sig):
            raise AuthError("SignatureDoesNotMatch", "chunk signature")
        self._prev = want

    def _next_chunk(self) -> None:
        line = self._read_line().decode("latin-1")
        size_s, _, ext = line.partition(";")
        try:
            size = int(size_s.strip(), 16)
        except ValueError:
            raise AuthError(
                "IncompleteBody", f"bad chunk header {line!r}"
            ) from None
        if size > self.MAX_CHUNK:
            raise AuthError("IncompleteBody", "chunk too large")
        self._sig = ""
        if ext.startswith("chunk-signature="):
            self._sig = ext[len("chunk-signature=") :].strip()
        if self._ctx.signed_chunks and not self._sig:
            raise AuthError("SignatureDoesNotMatch", "missing chunk sig")
        if size == 0:
            if self._ctx.signed_chunks:
                self._verify_chunk(b"")
            self._read_trailers()
            self._done = True
            return
        data = self._read_exact(size)
        crlf = self._read_exact(2)
        if crlf != b"\r\n":
            raise AuthError("IncompleteBody", "missing chunk CRLF")
        if self._ctx.signed_chunks:
            self._verify_chunk(data)
        if self._cksum is not None:
            self._cksum.update(data)
        self._chunk = data
        self._off = 0

    def _read_trailers(self) -> None:
        if not self._ctx.trailer:
            # consume the final CRLF if present
            if self._buf[:2] == b"\r\n":
                del self._buf[:2]
            return
        trailer_canon = []
        saw_trailer_sig = False
        while True:
            line = self._read_line()
            if not line:
                break
            name, _, value = line.decode("latin-1").partition(":")
            name = name.strip().lower()
            value = value.strip()
            if name == "x-amz-trailer-signature":
                saw_trailer_sig = True
                if self._ctx.signed_chunks:
                    sts = "\n".join(
                        [
                            "AWS4-HMAC-SHA256-TRAILER",
                            self._ctx.amz_date,
                            self._ctx.scope,
                            self._prev,
                            hashlib.sha256(
                                ("".join(trailer_canon)).encode()
                            ).hexdigest(),
                        ]
                    )
                    want = _hmac_hex(self._ctx.signing_key, sts)
                    if not hmac.compare_digest(want, value):
                        raise AuthError(
                            "SignatureDoesNotMatch", "trailer signature"
                        )
                break
            if name:
                self.trailers[name] = value
                trailer_canon.append(f"{name}:{value}\n")
        if self._ctx.signed_chunks and not saw_trailer_sig:
            raise AuthError(
                "SignatureDoesNotMatch", "missing trailer signature"
            )

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._off < len(self._chunk):
                take = len(self._chunk) - self._off
                if n >= 0:
                    take = min(take, n - len(out))
                out += self._chunk[self._off : self._off + take]
                self._off += take
                continue
            if self._done:
                break
            self._next_chunk()
        return bytes(out)

    def finalize(self) -> None:
        """Drive the terminal 0-chunk + trailer frames to completion.

        Callers stop read()ing once the declared decoded length arrives,
        which would leave the final chunk signature, trailer signature
        and trailing checksums unparsed - this
        consumes and verifies them.  Extra data past the declared length
        is an error, matching the strict framing of the reference.
        """
        while not self._done:
            if self._off < len(self._chunk):
                raise AuthError(
                    "IncompleteBody", "data past declared decoded length"
                )
            self._chunk, self._off = b"", 0
            self._next_chunk()
            if self._chunk:
                raise AuthError(
                    "IncompleteBody", "data past declared decoded length"
                )
        if self._cksum is not None:
            want = self.trailers.get(self._ctx.trailer_header, "")
            got = base64.b64encode(self._cksum.digest()).decode()
            if not want or not hmac.compare_digest(got, want):
                raise AuthError(
                    "XAmzContentChecksumMismatch",
                    f"{self._ctx.trailer_header}: want {want!r} got {got!r}",
                )


# ---------------------------------------------------------------------------
# POST form policy (cmd/postpolicyform.go + doesPolicySignatureMatch)
# ---------------------------------------------------------------------------


def verify_post_policy(
    form: "dict[str, str]",
    lookup,
    region: str,
    clock=None,
) -> str:
    """Verify a POST-upload form's policy signature + conditions.

    ``form`` maps lower-cased field names to values.  Returns the
    authenticated access key; raises AuthError on any failure.
    """
    clock = clock or (
        lambda: datetime.datetime.now(datetime.timezone.utc)
    )
    policy_b64 = form.get("policy", "")
    if not policy_b64:
        raise AuthError("AccessDenied", "missing policy")
    if "x-amz-signature" in form:  # V4
        try:
            credential = form["x-amz-credential"]
            amz_date = form["x-amz-date"]
            access_key, date, reg, service, term = credential.split("/", 4)
        except (KeyError, ValueError):
            raise AuthError(
                "AccessDenied", "malformed POST credential"
            ) from None
        secret = lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", access_key)
        key = _signing_key(secret, date, reg, service)
        want = _hmac_hex(key, policy_b64)
        if not hmac.compare_digest(want, form["x-amz-signature"]):
            raise AuthError("SignatureDoesNotMatch", "")
    elif "signature" in form:  # V2
        access_key = form.get("awsaccesskeyid", "")
        secret = lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", access_key)
        want = base64.b64encode(
            hmac.new(
                secret.encode(), policy_b64.encode(), hashlib.sha1
            ).digest()
        ).decode()
        if not hmac.compare_digest(want, form["signature"]):
            raise AuthError("SignatureDoesNotMatch", "")
    else:
        raise AuthError("AccessDenied", "no POST signature")
    check_post_policy(policy_b64, form, clock)
    return access_key


# fields that need no policy condition: auth material, the file itself,
# and server-injected values (checkPostPolicy's ignore list)
_POST_EXEMPT_FIELDS = frozenset(
    {
        "file", "policy", "x-amz-signature", "signature",
        "awsaccesskeyid", "bucket", "content-length",
        "x-amz-algorithm", "x-amz-credential", "x-amz-date",
        # derived from the file part's own Content-Type header, not a
        # client-authored form field
        "content-type",
    }
)


def check_post_policy(policy_b64: str, form: "dict[str, str]", clock) -> None:
    """Validate the decoded policy document against the form fields,
    both ways: every condition must hold AND every form field must be
    covered by a condition (checkPostPolicy, cmd/postpolicyform.go)."""
    try:
        doc = json.loads(base64.b64decode(policy_b64))
    except Exception:  # noqa: BLE001
        raise AuthError("MalformedPOSTRequest", "bad policy JSON") from None
    exp = doc.get("expiration", "")
    try:
        exp_t = datetime.datetime.strptime(
            exp, "%Y-%m-%dT%H:%M:%S.%fZ"
        ).replace(tzinfo=datetime.timezone.utc)
    except ValueError:
        try:
            exp_t = datetime.datetime.strptime(
                exp, "%Y-%m-%dT%H:%M:%SZ"
            ).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            raise AuthError(
                "MalformedPOSTRequest", "bad policy expiration"
            ) from None
    if clock() > exp_t:
        raise AuthError("AccessDenied", "policy expired")
    size = int(form.get("content-length", "0") or 0)
    covered: set[str] = set()
    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            items = [["eq", f"${k}", v] for k, v in cond.items()]
        elif isinstance(cond, list) and len(cond) == 3:
            items = [cond]
        else:
            raise AuthError("MalformedPOSTRequest", "bad condition")
        for op, target, value in items:
            op = str(op).lower()
            if op == "content-length-range":
                lo, hi = int(target), int(value)
                if not (lo <= size <= hi):
                    raise AuthError(
                        "EntityTooLarge"
                        if size > hi
                        else "EntityTooSmall",
                        "content-length-range",
                    )
                continue
            field = str(target).lstrip("$").lower()
            covered.add(field)
            got = form.get(field, "")
            if op == "eq":
                if got != value:
                    raise AuthError(
                        "AccessDenied", f"policy eq failed on {field}"
                    )
            elif op == "starts-with":
                if not got.startswith(value):
                    raise AuthError(
                        "AccessDenied",
                        f"policy starts-with failed on {field}",
                    )
            # unknown operators are ignored (forward compatibility)
    for field in form:
        if field in _POST_EXEMPT_FIELDS or field.startswith("x-ignore-"):
            continue
        if field not in covered:
            raise AuthError(
                "AccessDenied",
                f"form field {field} not covered by policy conditions",
            )
