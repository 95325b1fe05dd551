"""Minimal SigV4 S3 client for the gateway's upstream calls
(the role of minio-go inside cmd/gateway/s3/gateway-s3.go).

Streams bodies both ways: PUT sends from a reader without buffering
the object, GET hands back the raw HTTP response for the caller to
drain into its writer.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import threading
import urllib.parse
import xml.etree.ElementTree as ET

from ..utils.log import kv, logger

_log = logger("gateway")


class UpstreamError(Exception):
    def __init__(self, status: int, code: str, message: str = ""):
        super().__init__(f"{status} {code}: {message}")
        self.status = status
        self.code = code


def _sign_key(secret: str, date: str, region: str) -> bytes:
    k = hmac.new(
        f"AWS4{secret}".encode(), date.encode(), hashlib.sha256
    ).digest()
    for part in (region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


class S3UpstreamClient:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", timeout_s: float = 60.0):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise ValueError(f"bad upstream endpoint {endpoint!r}")
        self.tls = u.scheme == "https"
        self.host = u.hostname
        self.port = u.port or (443 if self.tls else 80)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self._timeout = timeout_s
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            cls = (
                http.client.HTTPSConnection
                if self.tls
                else http.client.HTTPConnection
            )
            kwargs = {"timeout": self._timeout}
            if self.tls:
                import os
                import ssl

                ctx = ssl.create_default_context()
                if os.environ.get("MINIO_TPU_GATEWAY_INSECURE") == "1":
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                kwargs["context"] = ctx
            c = cls(self.host, self.port, **kwargs)
            self._local.conn = c
        return c

    def _drop(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception as exc:
                _log.debug("upstream connection close failed", extra=kv(err=str(exc)))
        self._local.conn = None

    def request(
        self,
        method: str,
        path: str,
        query: "dict[str, str] | None" = None,
        body: "bytes | None" = b"",
        headers: "dict[str, str] | None" = None,
        reader=None,
        content_length: int = -1,
        stream_response: bool = False,
    ):
        """One signed request.  ``path`` is the RAW (unencoded)
        object path - it is percent-encoded exactly once, and the
        same encoding feeds both the canonical request and the wire
        URL so the upstream verifier recomputes an identical
        signature.  Exactly one of ``body`` or
        ``reader``+``content_length`` supplies the payload.  Returns
        (status, headers, body_bytes) - or the live HTTPResponse when
        ``stream_response`` (caller must ``.read()`` it fully)."""
        query = dict(query or {})
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = amz_date[:8]
        if reader is not None:
            # streamed payload: sign UNSIGNED-PAYLOAD (minio-go does
            # the same for streaming PUTs over TLS; over HTTP the
            # upstream still authenticates the headers)
            phash = "UNSIGNED-PAYLOAD"
        else:
            phash = hashlib.sha256(body or b"").hexdigest()
        headers["host"] = f"{self.host}:{self.port}"
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = phash
        signed = sorted(headers)
        canonical_q = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(query.items())
        )
        enc_path = urllib.parse.quote(path, safe="/-_.~")
        canonical = "\n".join(
            [
                method,
                enc_path,
                canonical_q,
                "".join(f"{h}:{headers[h].strip()}\n" for h in signed),
                ";".join(signed),
                phash,
            ]
        )
        scope = f"{date}/{self.region}/s3/aws4_request"
        sts = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        sig = hmac.new(
            _sign_key(self.secret_key, date, self.region),
            sts.encode(),
            hashlib.sha256,
        ).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"
        )
        # wire query must be byte-identical to canonical_q: urlencode's
        # quote_plus ('+' for space) would break verifiers that
        # canonicalize from the raw query string (ADVICE r4)
        url = enc_path + (f"?{canonical_q}" if query else "")
        for attempt in (0, 1):
            conn = self._conn()
            try:
                if reader is not None:
                    headers["content-length"] = str(content_length)
                    conn.putrequest(method, url, skip_host=True)
                    for k, v in headers.items():
                        conn.putheader(k, v)
                    conn.endheaders()
                    sent = 0
                    while sent < content_length:
                        chunk = reader.read(
                            min(1 << 20, content_length - sent)
                        )
                        if not chunk:
                            break
                        conn.send(chunk)
                        sent += len(chunk)
                else:
                    conn.request(method, url, body=body, headers=headers)
                resp = conn.getresponse()
                break
            except (OSError, http.client.HTTPException):
                self._drop()
                if attempt or reader is not None:
                    # a half-sent streamed body is not retryable
                    raise UpstreamError(
                        0, "UpstreamUnreachable",
                        f"{self.host}:{self.port}",
                    ) from None
        if stream_response and resp.status < 300:
            return resp
        payload = resp.read()
        return resp.status, dict(resp.getheaders()), payload

    @staticmethod
    def error_code(payload: bytes) -> "tuple[str, str]":
        try:
            root = ET.fromstring(payload)
            code = root.findtext("Code") or ""
            msg = root.findtext("Message") or ""
            return code, msg
        except ET.ParseError:
            return "", ""

    def raise_for(self, status: int, payload: bytes) -> None:
        code, msg = self.error_code(payload)
        raise UpstreamError(status, code or "UpstreamError", msg)
