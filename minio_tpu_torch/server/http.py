"""The S3 HTTP server: router + handlers (L6/L7 of the layer map).

One HTTP server hosting the S3 API surface
(cmd/api-router.go routes + cmd/object-handlers.go / bucket-handlers.go
glue).  Requests are authenticated with SigV4 (auth.py), dispatched on
(method, path-shape, query), and translated to ObjectLayer calls; errors
render as S3 XML (s3errors.py / response.py).

The reference funnels every handler through middleware
(maxClients(collectAPIStats(httpTrace(...))), api-router.go:94); here the
equivalent cross-cutting layer lives in _Handler.route(): auth, tracing
hooks, error rendering, request IDs.

The server fronts any of the port's object layers - one erasure set
(``S3Server(ErasureObjects(disks))``) or the zones over sets over
guarded drives that ``python -m minio_tpu_torch.server`` builds - on
the asyncio request plane (server/aio.py, the default) or the
thread-per-request stdlib plane (``MINIO_TPU_SERVER=threaded``, the
bisection oracle).  It serves health, metrics, ListBuckets, bucket
create / HEAD / DELETE / ``?location`` / ``?policy`` / ``?versioning``,
ListObjects V1 and V2, ListObjectVersions, PutObject / GetObject /
HeadObject / DeleteObject, CopyObject, multi-object delete, POST-policy
uploads and the multipart routes (CreateMultipartUpload, UploadPart,
UploadPartCopy, ListParts, ListMultipartUploads, AbortMultipartUpload,
CompleteMultipartUpload), bucket default encryption (``?encryption``),
server-side encryption (SSE-C headers, SSE-S3 and bucket defaults) on
every object write and read, bucket lifecycle, tagging, object-lock and
ACL documents, object tagging, retention, legal hold and ACLs, the
PUT-time lock and tag headers, the WORM guard on deletes, hard bucket
quotas on every write path, federation (a bucket owned by another
cluster sharing the bucket DNS answers 307 to its owner; creation is
unique across the federation; ListBuckets is the union), and the admin
API (server/admin.py) with its trace and console streams, bucket event
notification (``?notification``, the ListenBucketNotification stream
``?events``, cluster-wide over the peer plane, and the targets of
``MINIO_TPU_NOTIFY_*``), and bucket replication (``?replication``; PUT,
copy, Complete and POST policy stamp ``x-amz-replication-status:
PENDING`` and queue the version on the lazy ``S3Server.replication``
pool).  Every route of a feature not ported yet (the web and console
plane, STS) answers S3 ``NotImplemented`` with a message naming the
slice that ports it - nothing is silently ignored.
"""

from __future__ import annotations

import base64
import email.utils
import io
import os
import re
import threading
import time as _time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..codec import sse as ssemod
from ..iam.sys import IAMSys
from ..ilm import Lifecycle, LifecycleError
from ..objectlayer import objectlock as olock, quota as quotamod
from ..objectlayer.api import (
    BucketInfo,
    BucketNotFound,
    CompletePart,
    ObjectInfo,
    ObjectNotFound,
    VersionNotFound,
)
from ..objectlayer.bucket_meta import BucketMetadataSys
from ..replication.replicate import META_REPLICATION_STATUS, ReplicationPool
from ..utils import tags as tagmod
from ..utils.hashreader import HashReader
from ..utils.xmlutil import strip_ns
from . import authz, response as xmlr, s3errors
from .auth import (
    AuthError,
    SigV4ChunkedReader,
    SigV4Verifier,
)
from .s3errors import S3Error

from ..utils.log import kv, logger

_log = logger("http")

MAX_IN_MEMORY_BODY = 1 << 30  # buffered-body cap (XML configs)
MAX_OBJECT_SIZE = 5 << 40  # globalMaxObjectSize (cmd/globals.go)
MAX_MULTI_DELETE_BODY = 1 << 20  # multi-delete key lists
# internode requests are metadata or bounded shard flushes (4 MiB); a
# larger body is an attack, not a peer
MAX_INTERNODE_BODY = 64 << 20

# request-plane mode: the asyncio plane (server/aio.py) unless
# MINIO_TPU_SERVER=threaded asks for the thread-per-request oracle
DEFAULT_SERVER_MODE = "async"

# mounts of the web/console plane, not ported yet (slice 9c)
WEB_RPC_PATH = "/minio-tpu/webrpc"
WEB_PREFIX = "/minio-tpu/web"
WEB_CONSOLE_PATH = "/minio-tpu/console"


def unported(what: str, slice_name: str) -> NotImplementedError:
    """The error of a feature this package has not ported yet; S3 clients
    see it as ``NotImplemented`` with this message."""
    return NotImplementedError(
        f"{what} is not ported to minio_tpu_torch yet (slice {slice_name})"
    )


class _ChunkedReader:
    """Decode a chunked transfer-encoded body from the socket.

    The stdlib server leaves chunked TE undecoded; the internode shard
    plane streams CreateFile bodies through it without either
    side buffering a whole shard (storage-rest-server.go CreateFile).
    S3 requests never take it: ``_body_size`` refuses chunked TE.
    """

    MAX_CHUNK = 16 << 20

    def __init__(self, raw):
        self._raw = raw
        self._remaining = 0
        self._done = False

    def _read_line(self) -> bytes:
        line = self._raw.readline(1024)
        if not line.endswith(b"\r\n"):
            raise OSError("bad chunk framing")
        return line[:-2]

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while not self._done and (n < 0 or len(out) < n):
            if self._remaining == 0:
                size_s = self._read_line().split(b";")[0]
                try:
                    size = int(size_s, 16)
                except ValueError:
                    raise OSError("bad chunk size") from None
                if size > self.MAX_CHUNK:
                    raise OSError("chunk too large")
                if size == 0:
                    # consume optional trailers until the blank line
                    while self._read_line():
                        pass
                    self._done = True
                    break
                self._remaining = size
            want = self._remaining if n < 0 else min(
                self._remaining, n - len(out)
            )
            chunk = self._raw.read(want)
            if not chunk:
                raise OSError("truncated chunked body")
            out += chunk
            self._remaining -= len(chunk)
            if self._remaining == 0:
                if self._raw.read(2) != b"\r\n":
                    raise OSError("missing chunk CRLF")
        return bytes(out)

    def drain(self) -> None:
        while not self._done:
            if not self.read(1 << 20):
                break


class _LimitedReader:
    """Reads at most ``limit`` bytes from the underlying socket file."""

    def __init__(self, raw, limit: int):
        self._raw = raw
        self.remaining = limit

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        if n < 0 or n > self.remaining:
            n = self.remaining
        chunk = self._raw.read(n)
        self.remaining -= len(chunk)
        return chunk


class S3Server:
    """Owns the listener + object layer; one per process (xhttp.NewServer
    analogue, cmd/http/server.go:185).

    The server takes no device: the object layer it is given runs its
    codec on the device it was built for (the card by default)."""

    def __init__(
        self,
        object_layer,
        address: str = "127.0.0.1:9000",
        access_key: str = "minioadmin",
        secret_key: str = "minioadmin",
        region: str = "us-east-1",
        iam=None,
        internode_secret: str = "",
    ):
        self.object_layer = object_layer
        # when set, internode-plane requests must carry a valid JWT
        # BEFORE the server reads their body
        self.internode_secret = internode_secret
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.region = region
        # every server has an IAMSys; without one injected, a local
        # (non-persisted) system holding just the root credential
        self.iam = iam or IAMSys(access_key, secret_key)
        self.verifier = SigV4Verifier(self.iam.lookup_secret, region)
        self._bucket_meta: "BucketMetadataSys | None" = None
        from .metrics import Metrics

        self.metrics = Metrics()
        # "public" opens the scrape endpoint (MINIO_PROMETHEUS_AUTH_TYPE)
        self.metrics_public = (
            os.environ.get("MINIO_TPU_PROMETHEUS_AUTH_TYPE", "jwt")
            == "public"
        )
        self.heal_routine = None  # attached by the embedder
        self.heal_queue = None
        # readiness gate (healthcheck ready-parity): an embedder may
        # populate this dict as subsystems come up.  None keeps the
        # default semantics: ready as soon as an object layer is attached.
        self.boot_status: "dict[str, bool] | None" = None
        # federation bucket DNS (cluster/dns.BucketDNS); None when
        # this deployment is not federated
        self.bucket_dns = None
        # the data crawler and update tracker, attached by the server
        # main; the crawler's usage snapshot feeds quotas and admin
        # datausage
        self.crawler = None
        self.update_tracker = None
        # peer control plane (distributed mode): PeerNotifier fanning
        # out cache invalidations + aggregating node info; the server
        # main also sets peer_rest (closed at shutdown) and
        # local_locker (admin top-locks)
        self.peer_notifier = None
        self.peer_rest = None
        self.local_locker = None
        self.iam_refresher = None  # IAMSys.start_refresher's thread
        # FaultDisk per local drive root, set by the server main under
        # MINIO_TPU_FAULT_INJECTION (admin fault/* and loops/wedge)
        self.fault_disks: "dict | None" = None
        # bucket event notifications (pkg/event): targets from env,
        # rules loaded lazily per bucket from the metadata subsystem
        from ..event import EventNotifier, targets_from_env

        self.events = EventNotifier(targets_from_env()).start()
        self._event_rules_loaded: "set[str]" = set()
        # the replication pool starts at its first use; the lock keeps two
        # first requests from starting two pools (shutdown stops one)
        self._replication_pool = None
        self._replication_mu = threading.Lock()
        # tracing / audit / profiling / console capture (SURVEY §5)
        from ..utils.profiling import Profiler
        from .trace import AuditLog, ConsoleCapture, Tracer

        self.tracer = Tracer(node=address)
        self.audit = AuditLog()
        self.profiler = Profiler()
        self.console = ConsoleCapture(node=address).install()
        self._httpd: "ThreadingHTTPServer | None" = None
        self._thread: "threading.Thread | None" = None
        self.tls = False
        # admission control (handler-api.go:85 maxClients): bounded
        # concurrent S3 requests; excess waits up to the deadline then
        # gets 503.  0 = unlimited.
        self._inflight = 0
        # set at shutdown: long-lived streams (listen notifications)
        # must end so the drain window isn't spent waiting on them
        self.draining = False
        self._adm_mu = threading.Lock()
        self._adm_cv = threading.Condition(self._adm_mu)
        # background workers an embedder attaches (server/__main__.py):
        # shutdown() stops them after the drain
        self.disk_monitor = None
        # internode planes (storage/lock/peer REST, the
        # registerDistErasureRouters analogue, routers.go:25-38):
        # prefix -> handler(method_tail, query, body, headers)
        #           returning (status, body, extra_headers)
        self.internode: "dict[str, object]" = {}
        # server-plane telemetry + tenant/quota admission
        # (server/admission.py)
        from .admission import AdmissionController, PlaneStats

        self.plane_stats = PlaneStats()
        self.admission = AdmissionController(self, self.plane_stats)

        def _codec_depth() -> int:
            from ..parallel.iopool import queued_depth

            return queued_depth()

        self.plane_stats.register_stage("codec", _codec_depth)
        self._plane = None  # AsyncPlane when server_mode == "async"
        self.server_mode = "threaded"

    def _requests_max(self) -> int:
        try:
            return int(os.environ.get("MINIO_TPU_REQUESTS_MAX") or 0)
        except ValueError:
            return 0

    def _requests_deadline(self) -> float:
        try:
            return float(
                os.environ.get("MINIO_TPU_REQUESTS_DEADLINE_S") or 10.0
            )
        except ValueError:
            return 10.0

    def admit(self) -> bool:
        """Take an admission slot (True) or time out (False -> 503)."""
        limit = self._requests_max()
        with self._adm_cv:
            if limit <= 0:
                self._inflight += 1
                return True
            deadline = _time.monotonic() + self._requests_deadline()
            while self._inflight >= limit:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._adm_cv.wait(remaining)
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._adm_cv:
            self._inflight = max(0, self._inflight - 1)
            self._adm_cv.notify()

    def attach_iam(self, iam: IAMSys) -> None:
        """Swap in a store-backed IAMSys once the object layer is up
        (startBackgroundIAMLoad ordering, server-main.go:529)."""
        self.iam = iam
        iam.notifier = self.peer_notifier
        self.verifier = SigV4Verifier(iam.lookup_secret, self.region)

    def register_internode(self, prefix: str, handler) -> None:
        """Mount an internode REST plane under a path prefix."""
        self.internode[prefix] = handler

    def ensure_event_rules(self, bucket: str) -> None:
        """Lazily hydrate a bucket's notification rules from the
        persisted document (bucketRulesMap load, notification.go)."""
        if bucket in self._event_rules_loaded or self.object_layer is None:
            return
        try:
            raw = self.bucket_meta.get(bucket).notification_xml
        except Exception:  # noqa: BLE001
            # transient metadata-read failure: do NOT mark loaded, so
            # the next event retries instead of dropping forever
            return
        try:
            self.events.load_bucket_config(bucket, raw)
        except Exception as exc:
            _log.debug("bad persisted notification doc: no rules loaded", extra=kv(err=str(exc)))
        self._event_rules_loaded.add(bucket)

    def mark_event_rules_loaded(self, bucket: str) -> None:
        self._event_rules_loaded.add(bucket)

    def invalidate_event_rules(self, bucket: str) -> None:
        """Peer invalidation path: re-read the config on next event."""
        self._event_rules_loaded.discard(bucket)

    @property
    def replication(self):
        """Async replication pool, lazily started (bucket-replication)."""
        with self._replication_mu:
            if self._replication_pool is None:
                self._replication_pool = ReplicationPool(self).start()
            return self._replication_pool

    @property
    def config(self):
        """Runtime KV config subsystem, lazily bound to the object
        layer (cmd/config ConfigSys analogue)."""
        cs = getattr(self, "_config_sys", None)
        if cs is None or cs._ol is not self.object_layer:
            from ..config import ConfigSys

            cs = ConfigSys(self.object_layer)
            self._config_sys = cs
        cs.notifier = self.peer_notifier
        return cs

    @property
    def bucket_meta(self) -> BucketMetadataSys:
        """Bucket metadata subsystem, lazily bound once the object
        layer attaches (it persists through the layer)."""
        if (
            self._bucket_meta is None
            or self._bucket_meta._ol is not self.object_layer
        ):
            self._bucket_meta = BucketMetadataSys(self.object_layer)
            self._bucket_meta.notifier = self.peer_notifier
        return self._bucket_meta

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "S3Server":
        from ..utils import tlsconf

        server = self

        class Handler(_Handler):
            s3 = server

        self.tls = tlsconf.enabled()
        mode = (
            os.environ.get("MINIO_TPU_SERVER") or DEFAULT_SERVER_MODE
        ).lower()
        self.server_mode = "async" if mode == "async" else "threaded"
        if self.server_mode == "async":
            from . import aio

            ssl_ctx = tlsconf.server_context() if self.tls else None
            self._plane = aio.AsyncPlane(self)
            self._plane.start(Handler, self.host, self.port, ssl_ctx)
            self.port = self._plane.port
            return self
        # slow-loris guard for the threaded oracle: a per-connection
        # socket timeout covers the header/body read (the stdlib drops
        # the connection without a response on expiry)
        idle = os.environ.get("MINIO_TPU_IDLE_TIMEOUT_S")
        if idle:
            try:
                Handler.timeout = float(idle)
            except ValueError:
                pass
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        if self.tls:
            self._httpd.socket = tlsconf.server_context().wrap_socket(
                self._httpd.socket, server_side=True
            )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="s3-server", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self, drain_s: float = 10.0) -> None:
        """Stop accepting, then drain in-flight requests up to
        ``drain_s`` (the reference's graceful shutdown,
        cmd/http/server.go:116 request draining).  Idempotent: SIGTERM
        followed by an embedder's own shutdown() (or a double signal)
        must not re-stop half-torn-down subsystems - every loop drains
        exactly once."""
        self.draining = True
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        if self._plane is not None:
            self._plane.stop(drain_s)
        if self._httpd:
            self._httpd.shutdown()  # stop accepting new connections
        deadline = _time.monotonic() + drain_s
        while self._inflight > 0 and _time.monotonic() < deadline:
            _time.sleep(0.05)
        if self._httpd:
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.events.shutdown()
        # background maintenance threads (crawler, fresh-disk monitor,
        # heal routine) stop AFTER the drain so an in-flight PUT's heal
        # hooks land
        for attr in ("crawler", "disk_monitor", "heal_routine"):
            worker = getattr(self, attr, None)
            if worker is not None and hasattr(worker, "stop"):
                try:
                    worker.stop()
                except Exception as exc:
                    _log.debug(
                        "background worker stop failed",
                        extra=kv(worker=attr, err=str(exc)),
                    )
        # replication workers are per-server threads, not process
        # singletons: leaving them running after shutdown is a leak
        with self._replication_mu:
            repl = self._replication_pool
        if repl is not None:
            try:
                repl.stop()
            except Exception as exc:
                _log.debug("replication pool stop failed",
                           extra=kv(err=str(exc)))
        # the peer plane: the notifier's fan-out pool and connections
        # (the peer server's close drops its remote listeners), then the
        # IAM refresher (its reloads would hit a stopped layer)
        for attr in ("peer_notifier", "peer_rest"):
            obj = getattr(self, attr, None)
            if obj is not None:
                try:
                    obj.close()
                except Exception as exc:
                    _log.debug("peer plane close failed",
                               extra=kv(part=attr, err=str(exc)))
        if self.iam_refresher is not None:
            self.iam_refresher.stop.set()
        # detach the console ring from the package logger: a process
        # constructing several servers must not accumulate handlers
        self.console.uninstall()

    def readiness(self) -> "tuple[bool, bytes]":
        """(ready, JSON body) for /minio/health/ready: object layer
        attached, every boot_status subsystem up, and not draining."""
        import json as _json

        doc = {"object_layer": self.object_layer is not None}
        if self.boot_status is not None:
            doc.update(self.boot_status)
        plane = self._plane
        if plane is not None:
            # every server loop must be accepting before ready flips
            doc["server_loops"] = plane.loops_ready()
        ok = all(doc.values()) and not self.draining
        doc["draining"] = self.draining
        if plane is not None:
            # per-loop detail rides after the ok computation (like
            # "draining"): states are strings, not readiness gates
            doc["loops"] = {
                str(row["loop"]): row["state"]
                for row in plane.describe()["per_loop"]
            }
        return ok, _json.dumps(doc, sort_keys=True).encode()

    @property
    def endpoint(self) -> str:
        scheme = "https" if getattr(self, "tls", False) else "http"
        return f"{scheme}://{self.host}:{self.port}"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    s3: S3Server = None  # injected subclass attribute

    # silence default stderr logging
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- plumbing ---------------------------------------------------------

    def _parse(self):
        parsed = urllib.parse.urlsplit(self.path)
        path = urllib.parse.unquote(parsed.path)
        query = urllib.parse.parse_qs(
            parsed.query, keep_blank_values=True
        )
        return path, query

    def _body_size(self) -> int:
        """Declared body size; rejects framing we cannot stream safely."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if te and te != "identity":
            # stdlib does not decode chunked TE; reading it as raw bytes
            # would desync the connection
            self.close_connection = True
            raise S3Error("MissingContentLength")
        cl = self.headers.get("Content-Length")
        if cl is None:
            if self.command in ("PUT", "POST"):
                self.close_connection = True
                raise S3Error("MissingContentLength")
            return 0
        try:
            length = int(cl)
        except ValueError:
            self.close_connection = True
            raise S3Error("InvalidArgument", "Content-Length") from None
        if length < 0:
            self.close_connection = True
            raise S3Error("InvalidArgument", "Content-Length")
        return length

    def _open_body(self):
        """(reader, decoded_size): the auth-appropriate body stream.

        For aws-chunked requests the wire bytes are Content-Length long
        but the object data is x-amz-decoded-content-length long, framed
        and signature-verified by SigV4ChunkedReader.
        """
        length = self._body_size()
        # the framing is valid and a handler wants the body: release
        # the deferred 100 so a waiting client starts transmitting
        self._maybe_send_continue()
        raw = _LimitedReader(self.rfile, length)
        self._raw_body = raw
        ctx = self._auth
        if ctx is not None and ctx.streaming:
            decoded = self.headers.get("x-amz-decoded-content-length")
            if decoded is None:
                raise S3Error("MissingContentLength")
            return (
                SigV4ChunkedReader(raw, ctx, int(decoded)),
                int(decoded),
            )
        return raw, length

    def _hash_reader(self, reader, size: int) -> HashReader:
        """Wrap the body in the MD5/SHA256-verifying reader
        (pkg/hash PutObjReader): Content-MD5 and the signed
        x-amz-content-sha256 are checked as bytes stream through."""
        md5_hdr = self.headers.get("Content-MD5", "")
        md5_hex = ""
        if md5_hdr:
            try:
                md5_hex = base64.b64decode(md5_hdr).hex()
            except Exception:  # noqa: BLE001
                raise S3Error("InvalidDigest") from None
        sha_hex = ""
        ctx = self._auth
        if ctx is not None and ctx.content_sha256:
            sha_hex = ctx.content_sha256
        return HashReader(reader, size, md5_hex=md5_hex, sha256_hex=sha_hex)

    def _read_body(self) -> bytes:
        """Fully buffer a (bounded) body - XML/config payloads."""
        reader, size = self._open_body()
        if size > MAX_IN_MEMORY_BODY:
            self.close_connection = True
            raise S3Error("EntityTooLarge")
        hr = self._hash_reader(reader, size)
        chunks = []
        while True:
            c = hr.read(1 << 20)
            if not c:
                break
            chunks.append(c)
        body = b"".join(chunks)
        if len(body) != size:
            self.close_connection = True
            raise S3Error("IncompleteBody")
        return body

    def _respond(
        self,
        status: int,
        body: bytes = b"",
        headers: "dict | None" = None,
        content_type: str = "application/xml",
    ):
        self.send_response(status)
        self.send_header("Server", "MinIO-TPU")
        self.send_header(
            "x-amz-request-id", uuid.uuid4().hex[:16].upper()
        )
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if body or status not in (204, 304):
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
        else:
            self.send_header("Content-Length", "0")
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)
            self._resp_bytes += len(body)

    def _error(self, err: s3errors.APIError, resource: str):
        if err.status >= 500:
            from ..utils import log

            log.logger("http").error(
                "request failed",
                extra=log.kv(
                    code=err.code,
                    status=err.status,
                    resource=resource,
                    method=self.command,
                ),
            )
        if err.status == 304:  # Not Modified carries no body
            self._respond(304)
            return
        body = xmlr.error_xml(
            err.code, err.message, resource, uuid.uuid4().hex[:16]
        )
        self._respond(err.status, body)

    # -- entry ------------------------------------------------------------

    def end_headers(self):
        self._headers_sent = True
        super().end_headers()

    def send_response(self, code, message=None):
        self._last_status = code  # metrics middleware reads this
        # first status line of the request = first byte on the wire
        # (the TTFB sample; streaming bodies start right after it)
        if (
            getattr(self, "_t_start", None) is not None
            and getattr(self, "_ttfb", None) is None
        ):
            self._ttfb = _time.monotonic() - self._t_start
        super().send_response(code, message)

    def _finish_body(self) -> None:
        """Keep-alive hygiene: drain small unread remainders, otherwise
        mark the connection dirty so it is closed rather than desynced."""
        if getattr(self, "_expect_100", False) and not getattr(
            self, "_continue_sent", True
        ):
            # the client never got its 100 and is still holding the
            # body: there is nothing on the wire to drain — a drain
            # here would deadlock against a conforming client, so cut
            # the connection after the final status (RFC 7231 §5.1.1
            # permits closing instead of reading the unsent body)
            try:
                if int(self.headers.get("Content-Length") or 0) > 0:
                    self.close_connection = True
            except ValueError:
                self.close_connection = True
            return
        raw = getattr(self, "_raw_body", None)
        if raw is not None:
            if raw.remaining > (1 << 20):
                self.close_connection = True
            elif raw.remaining:
                raw.read(raw.remaining)
            return
        cl = self.headers.get("Content-Length")
        if cl and cl not in ("0", ""):
            try:
                n = int(cl)
            except ValueError:
                n = -1
            if 0 <= n <= (1 << 20):
                self.rfile.read(n)  # drain small, keep the connection
            else:
                self.close_connection = True

    def _is_post_policy(self, path: str, query) -> bool:
        return (
            self.command == "POST"
            and "/" not in path.lstrip("/").rstrip("/")
            and "delete" not in query
            and (self.headers.get("Content-Type") or "").startswith(
                "multipart/form-data"
            )
        )

    def handle_expect_100(self):
        """RFC 7231 §5.1.1: defer the interim 100 until a handler
        actually solicits the body (``_maybe_send_continue``) — a
        request rejected on its headers gets its final status with NO
        interim 100, and the body the client never sent is never
        "drained".  The stdlib default commits 100 at parse time,
        before auth or framing checks have run."""
        self._expect_100_req = True
        return True

    def _maybe_send_continue(self) -> None:
        """First body solicitation: release the deferred interim 100 so
        a conforming client that genuinely waits starts transmitting."""
        if getattr(self, "_expect_100", False) and not self._continue_sent:
            self._continue_sent = True
            self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            self.wfile.flush()

    def route(self):
        path, query = self._parse()
        self._headers_sent = False
        self._raw_body = None
        self._auth = None
        self._action = ""
        self._last_status = 0
        self._resp_bytes = 0
        self._t_start = None
        self._ttfb = None
        # Expect: 100-continue deferral (one instance serves a whole
        # keep-alive connection: the pending flag is per-request)
        self._expect_100 = self.__dict__.pop("_expect_100_req", False)
        self._continue_sent = False
        if self.command not in ("GET", "PUT", "POST", "DELETE", "HEAD"):
            # non-S3 verbs (PATCH, OPTIONS, PROPFIND, ...) answer the
            # S3 MethodNotAllowed document - with the body drained for
            # keep-alive hygiene, not the stdlib's bare 501 HTML
            self._finish_body()
            return self._error(s3errors.get("MethodNotAllowed"), path)
        for prefix, handler in self.s3.internode.items():
            if path.startswith(prefix + "/"):
                return self._route_internode(
                    handler, path[len(prefix) + 1 :], query
                )
        # health endpoints are unauthenticated (healthcheck-handler.go:26-66)
        if path == "/minio/health/live":
            self._finish_body()  # keep-alive hygiene on early return
            return self._respond(200, content_type="text/plain")
        if path in ("/minio/health/ready", "/minio/health/cluster"):
            self._finish_body()
            ready, doc = self.s3.readiness()
            return self._respond(
                200 if ready else 503,
                doc,
                content_type="application/json",
            )
        if path == "/minio-tpu/prometheus/metrics":
            self._finish_body()
            if not self.s3.metrics_public:
                # authenticated scrapes only by default (the reference
                # guards /minio/prometheus/metrics with JWT)
                try:
                    ctx = self.s3.verifier.verify_stream(
                        self.command, path, query,
                        dict(self.headers.items()),
                    )
                except AuthError:
                    return self._respond(
                        403, b"forbidden", content_type="text/plain"
                    )
                if ctx.anonymous:
                    return self._respond(
                        403, b"forbidden", content_type="text/plain"
                    )
            return self._respond(
                200,
                self.s3.metrics.render(
                    self.s3.object_layer,
                    self.s3.heal_routine,
                    self.s3.heal_queue,
                    audit=self.s3.audit,
                    plane=self.s3.plane_stats.snapshot(),
                ),
                content_type="text/plain; version=0.0.4",
            )
        # tenant/quota admission (server/admission.py): the async plane
        # runs this loop-side before enqueueing; the threaded oracle
        # runs it here so both modes shed with the same semantics
        tenant = None
        if not getattr(self, "_plane_admitted", False):
            adm = self.s3.admission
            if adm.quota_rejects_put(self.command, path, self.headers):
                self.s3.plane_stats.shed_inc("quota")
                self.s3.metrics.observe("Shed", 503, 0.0)
                self.close_connection = True
                return self._error(s3errors.get("SlowDown"), path)
            tenant = adm.tenant_of(self.headers)
            if not adm.try_enter_tenant(tenant):
                self.s3.plane_stats.shed_inc("tenant")
                self.s3.metrics.observe("Shed", 503, 0.0)
                self.close_connection = True
                return self._error(s3errors.get("SlowDown"), path)
        # admission control (maxClients, handler-api.go:85): overload
        # answers 503 instead of spawning unbounded work
        if not self.s3.admit():
            if tenant is not None:
                self.s3.admission.leave_tenant(tenant)
            self.s3.plane_stats.shed_inc("queue")
            self.s3.metrics.observe("Shed", 503, 0.0)
            self.close_connection = True
            self._error(s3errors.get("SlowDown"), path)
            return
        # multi-loop async plane: attribute the inflight gauge to the
        # owning loop's lock-free cell (threaded oracle: loop=None)
        _loop_ix = getattr(self, "_loop_index", None)
        self.s3.plane_stats.enter(loop=_loop_ix)
        t0 = _time.monotonic()
        self._t_start = t0
        try:
            if (
                path in (WEB_RPC_PATH, WEB_CONSOLE_PATH)
                or path.startswith(WEB_PREFIX + "/")
            ):
                # web/console plane: slice 9c
                self._action = "Web"
                self._finish_body()
                self._error(
                    s3errors.from_exception(
                        unported("the web and console plane", "9c")
                    ),
                    path,
                )
            else:
                self._route_authed(path, query)
        finally:
            self.s3.release()
            self.s3.plane_stats.leave(loop=_loop_ix)
            if tenant is not None:
                self.s3.admission.leave_tenant(tenant)
            # collectAPIStats analogue: every authed-path request lands
            # in the metrics registry
            try:
                cl = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                cl = 0
            dur = _time.monotonic() - t0
            self.s3.metrics.observe(
                self._action or "Unknown",
                self._last_status or 0,
                dur,
                bytes_in=cl,
                bytes_out=self._resp_bytes,
                ttfb=self._ttfb,
            )
            self._emit_trace_audit(path, query, dur, cl)

    def _emit_trace_audit(self, path, query, dur, bytes_in) -> None:
        """httpTrace + logger.AuditLog tail of every request."""
        from . import trace as tracemod

        client = self.client_address[0] if self.client_address else ""
        if self.s3.tracer.active:
            self.s3.tracer.publish(
                tracemod.trace_info(
                    self.s3.tracer.node,
                    self.command,
                    path,
                    "&".join(f"{k}={v[0]}" for k, v in query.items()),
                    self._last_status or 0,
                    dur,
                    bytes_in,
                    self._resp_bytes,
                    client,
                    self._action or "Unknown",
                )
            )
        if self.s3.audit.enabled:
            parts = path.lstrip("/").split("/", 1)
            self.s3.audit.log(
                {
                    "api": {
                        "name": self._action or "Unknown",
                        "bucket": parts[0],
                        "object": parts[1] if len(parts) > 1 else "",
                        "statusCode": self._last_status or 0,
                        "timeToResponse_ms": round(dur * 1e3, 3),
                    },
                    "remotehost": client,
                    "userAgent": self.headers.get("User-Agent", ""),
                    "accessKey": (
                        self._auth.access_key
                        if self._auth and not self._auth.anonymous
                        else ""
                    ),
                    "rx": bytes_in,
                    "tx": self._resp_bytes,
                }
            )

    def _route_authed(self, path: str, query) -> None:
        try:
            # safe mode: every S3 request is 503 until the object layer
            # attaches, even unauthenticated ones (server-main.go safe
            # mode)
            if self.s3.object_layer is None:
                raise S3Error("ServerNotInitialized")
            # body-framing validity precedes auth, matching the generic
            # middleware order (requestValidityHandler, routers.go:41-79)
            self._body_size()
            # authenticate on headers only (setAuthHandler analogue);
            # payload hashes are verified as the body streams through
            ctx = self.s3.verifier.verify_stream(
                self.command, path, query, dict(self.headers.items())
            )
            self._auth = ctx
            # temp credentials must present their session token; static
            # credentials must not carry one (checkClaimsFromToken)
            if not ctx.anonymous:
                from ..iam.sys import InvalidToken

                token = self.headers.get(
                    "x-amz-security-token"
                ) or query.get("X-Amz-Security-Token", [""])[0]
                try:
                    self.s3.iam.validate_session_token(
                        ctx.access_key, token or None
                    )
                except InvalidToken as e:
                    raise S3Error("InvalidTokenId", str(e)) from None
            from . import admin as adminmod

            if path.startswith(adminmod.PREFIX + "/"):
                return self._route_admin(
                    path[len(adminmod.PREFIX) + 1 :], query, ctx
                )
            # STS plane: POST / with a form body (registerSTSRouter
            # mounts on the root path)
            if (
                self.command == "POST"
                and path == "/"
                and (self.headers.get("Content-Type") or "").startswith(
                    "application/x-www-form-urlencoded"
                )
            ):
                raise unported("STS", "9c")
            self._authorize(path, query, ctx)
            self._dispatch(path, query)
        except Exception as e:  # noqa: BLE001
            if self._headers_sent:
                # mid-stream failure: a second response would be read as
                # body bytes - just cut the stream
                self.close_connection = True
                return
            self._finish_body()
            self._error(s3errors.from_exception(e), path)
        else:
            self._finish_body()

    def _route_admin(self, tail: str, query, ctx) -> None:
        """Admin plane: SigV4-authenticated, owner-only
        (adminAPIHandlers privilege default)."""
        from .admin import AdminAPI, map_admin_error

        # metrics label only after the owner check: unauthenticated
        # garbage paths must not mint registry keys (cardinality)
        self._action = "Admin"
        if ctx.anonymous or not self.s3.iam.is_owner(ctx.access_key):
            raise S3Error("AccessDenied", "admin requires the owner")
        self._action = f"Admin.{tail}"
        if tail in ("trace", "console"):
            self._finish_body()
            return self._admin_stream(tail, query)
        body = b""
        if self.command in ("PUT", "POST"):
            body = self._read_body()
        q1 = {k: v[0] for k, v in query.items()}
        try:
            status, payload = AdminAPI(self.s3).handle(
                self.command, tail, q1, body
            )
        except Exception as e:  # noqa: BLE001
            mapped = map_admin_error(e)
            if mapped is None:
                raise
            raise mapped from e
        self._finish_body()
        self._respond(status, payload, content_type="application/json")

    def _route_internode(self, handler, method_tail: str, query) -> None:
        """Dispatch an internode-plane request.

        The bearer JWT is checked BEFORE the body is read and body size
        is capped, so an unauthenticated client cannot make this node
        buffer arbitrary bytes; plane handlers re-verify on their
        dispatch path (storage-rest-server.go:63-104) as defense in
        depth.  A chunked body goes to the plane's ``handle_stream``.
        """
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_INTERNODE_BODY:
                self.close_connection = True
                self._respond(413, b"body too large", content_type="text/plain")
                return
            if self.s3.internode_secret:
                from ..utils import jwt as _jwt

                authz = self.headers.get("Authorization", "")
                try:
                    if not authz.startswith("Bearer "):
                        raise _jwt.JWTError("missing bearer token")
                    _jwt.verify(
                        authz[len("Bearer "):], self.s3.internode_secret
                    )
                except Exception:  # noqa: BLE001
                    self.close_connection = True
                    self._respond(
                        401, b"unauthorized", content_type="text/plain"
                    )
                    return
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if te == "chunked":
                # streaming shard plane: hand the decoded stream to the
                # plane handler - nothing buffers the whole body
                plane = getattr(handler, "__self__", None)
                stream_fn = getattr(plane, "handle_stream", None)
                if stream_fn is None:
                    self.close_connection = True
                    self._respond(
                        411, b"length required", content_type="text/plain"
                    )
                    return
                reader = _ChunkedReader(self.rfile)
                status, payload, extra = stream_fn(
                    method_tail, query, reader,
                    dict(self.headers.items()),
                )
                try:
                    reader.drain()  # keep-alive hygiene
                except OSError:
                    self.close_connection = True
                self._respond(
                    status, payload, extra,
                    content_type="application/octet-stream",
                )
                return
            body = self.rfile.read(length) if length else b""
            status, payload, extra = handler(
                method_tail, query, body, dict(self.headers.items())
            )
        except Exception as e:  # noqa: BLE001
            self.close_connection = True
            self._respond(
                500, str(e).encode(), content_type="text/plain"
            )
            return
        self._respond(
            status, payload, extra, content_type="application/octet-stream"
        )

    def _admin_stream(self, kind: str, query) -> None:
        """`mc admin trace` / `mc admin console`: stream JSON lines for
        ``duration`` seconds, merging this node's ring with every
        peer's (TraceHandler + peerRESTClient.Trace aggregation,
        cmd/admin-handlers.go:1007)."""
        import json as _json

        try:
            duration = float(query.get("duration", ["10"])[0])
        except ValueError:
            duration = 10.0
        duration = max(0.1, min(duration, 300.0))
        local_ring = (
            self.s3.tracer.ring
            if kind == "trace"
            else self.s3.console.ring
        )
        peers = (
            self.s3.peer_notifier.clients
            if self.s3.peer_notifier is not None
            else []
        )
        self.send_response(200)
        self.send_header("Server", "MinIO-TPU")
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        # poll positions: ours + one per peer
        local_seq, _ = self.s3.tracer.poll(1 << 62) if kind == "trace" \
            else local_ring.since(1 << 62)
        # peers start from NOW, not their whole ring history: a None
        # cursor means "not handshaken yet" and triggers a probe with
        # since=1<<62 (whose items are discarded) on the next loop
        # turn - an unreachable peer simply stays None until it
        # answers, never replaying its ring from cursor 0
        peer_seq: "dict[int, int | None]" = {id(p): None for p in peers}
        deadline = _time.monotonic() + duration
        while _time.monotonic() < deadline:
            batch: list = []
            if kind == "trace":
                local_seq, items = self.s3.tracer.poll(local_seq)
            else:
                local_seq, items = local_ring.since(local_seq)
            batch.extend(items)
            for p in peers:
                pseq = peer_seq[id(p)]
                try:
                    res = p.call(
                        f"{kind}buf",
                        {"since": str(1 << 62 if pseq is None else pseq)},
                    )
                except Exception:  # noqa: BLE001
                    continue
                if "seq" in res:
                    peer_seq[id(p)] = res["seq"]
                if pseq is not None:
                    batch.extend(res.get("items", []))
            batch.sort(key=lambda e: e.get("time", 0))
            try:
                for item in batch:
                    line = (_json.dumps(item) + "\n").encode()
                    self.wfile.write(line)
                    self._resp_bytes += len(line)
                self.wfile.flush()
            except OSError:
                return  # client went away
            _time.sleep(0.5)

    do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = route

    def __getattr__(self, name):
        """ANY verb reaches route() (which answers MethodNotAllowed
        for non-S3 ones with full per-request init and body drain);
        without this, unknown verbs fall through to the stdlib's bare
        501 HTML."""
        if name.startswith("do_"):
            return self.route
        raise AttributeError(name)

    # -- authorization (checkRequestAuthType, auth-handler.go:272) --------

    def _bucket_policy(self, bucket: str):
        try:
            return self.s3.bucket_meta.get(bucket).policy()
        except Exception:  # noqa: BLE001 - missing bucket -> no policy
            return None

    def _check_action(
        self, action: str, bucket: str, key: str, account: str
    ) -> bool:
        """One policy decision (used per-key by multi-delete too)."""
        cond = authz.condition_values(
            {k: v for k, v in self._query.items()},
            dict(self.headers.items()),
            self.client_address[0] if self.client_address else "",
        )
        return authz.authorize(
            self.s3.iam,
            self._bucket_policy(bucket) if bucket else None,
            account,
            action,
            bucket,
            key,
            cond,
        )

    def _authorize(self, path: str, query, ctx) -> None:
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        self._query = query
        if bucket and authz.is_reserved_bucket(bucket):
            raise S3Error("AllAccessDisabled")
        if ctx.anonymous and self._is_post_policy(path, query):
            # POST form uploads carry their own signature; authorization
            # happens after the form parses (access key known then)
            return
        if self.command == "POST" and not key and "delete" in query:
            # multi-delete authorizes each named key inside the handler
            # (DeleteMultipleObjectsHandler); anonymous callers with no
            # bucket policy at all are cut off before the body is read
            if ctx.anonymous and self._bucket_policy(bucket) is None:
                raise S3Error("AccessDenied")
            return
        action = authz.action_for_request(
            self.command, bucket, key, query, dict(self.headers.items())
        )
        self._action = action.partition(":")[2]  # metrics API label
        if not self._check_action(action, bucket, key, ctx.access_key):
            raise S3Error("AccessDenied")
        # CopyObject/UploadPartCopy additionally need read access on the
        # source object
        if (
            self.command == "PUT"
            and key
            and "x-amz-copy-source" in self.headers
        ):
            sb, sk = self._parse_copy_source()
            if authz.is_reserved_bucket(sb):
                raise S3Error("AllAccessDisabled")
            if not self._check_action(
                "s3:GetObject", sb, sk, ctx.access_key
            ):
                raise S3Error("AccessDenied")

    def _parse_copy_source(self) -> "tuple[str, str]":
        """(bucket, key) from x-amz-copy-source - one parser for both
        the authorization and handler sides so they cannot drift."""
        src = urllib.parse.unquote(
            self.headers["x-amz-copy-source"]
        ).lstrip("/")
        if "/" not in src:
            raise S3Error("InvalidArgument", "bad copy source")
        return src.split("/", 1)

    # -- dispatch (api-router.go route table) -----------------------------

    # Every S3 sub-resource keyword that selects a *different handler*.
    # After the explicit routes below, any of these still present means
    # the request asked for something this server does not serve - it
    # must fail loudly, never fall through to the default handler
    # (the reference's router matches these with mux .Queries() so a
    # miss lands on proper error handlers).
    _OBJECT_SUBRESOURCES = frozenset(
        (
            "acl", "tagging", "retention", "legal-hold", "torrent",
            "restore", "select", "attributes", "uploads", "uploadId",
            "partNumber",
        )
    )
    _BUCKET_SUBRESOURCES = frozenset(
        (
            "acl", "cors", "website", "accelerate", "requestPayment",
            "logging", "inventory", "metrics", "analytics", "replication",
            "tagging", "encryption", "object-lock", "policy",
            "versioning", "notification", "lifecycle", "location",
            "uploads", "versions", "delete", "events", "publicAccessBlock",
            "ownershipControls", "intelligent-tiering",
        )
    )

    def _reject_subresources(self, query, vocab) -> None:
        unknown = vocab & set(query)
        if unknown:
            raise S3Error(
                "NotImplemented", f"?{sorted(unknown)[0]} is not supported"
            )

    def _dispatch(self, path: str, query):
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        m = self.command
        ol = self.s3.object_layer
        if ol is None:  # still bootstrapping (server-main.go safe mode)
            raise S3Error("ServerNotInitialized")

        if not bucket:
            if m == "GET":
                return self._list_buckets()
            raise S3Error("MethodNotAllowed")

        if self.s3.bucket_dns is not None and self._federated_redirect(
            bucket, key, m, query
        ):
            return

        if key:
            if m == "GET":
                if "uploadId" in query:
                    return self._list_parts(bucket, key, query)
                if "tagging" in query:
                    return self._get_object_tagging(bucket, key, query)
                if "retention" in query:
                    return self._get_object_retention(bucket, key, query)
                if "legal-hold" in query:
                    return self._get_object_legal_hold(bucket, key, query)
                if "acl" in query:
                    return self._get_acl(bucket, key)
            if m == "PUT":
                if "partNumber" in query and "uploadId" in query:
                    return self._put_part(bucket, key, query)
                if "tagging" in query:
                    return self._put_object_tagging(bucket, key, query)
                if "retention" in query:
                    return self._put_object_retention(bucket, key, query)
                if "legal-hold" in query:
                    return self._put_object_legal_hold(bucket, key, query)
                if "acl" in query:
                    return self._put_acl(bucket, key)
            if m == "POST":
                if "uploads" in query:
                    return self._initiate_multipart(bucket, key)
                if "uploadId" in query:
                    return self._complete_multipart(
                        bucket, key, query, self._read_body()
                    )
                if "select" in query:
                    return self._select_object(bucket, key)
            if m == "DELETE":
                if "uploadId" in query:
                    return self._abort_multipart(bucket, key, query)
                if "tagging" in query:
                    return self._delete_object_tagging(bucket, key, query)
            if m == "GET":
                self._reject_subresources(
                    query, self._OBJECT_SUBRESOURCES
                )
                return self._get_object(bucket, key, query)
            if m == "HEAD":
                return self._head_object(bucket, key, query)
            if m == "PUT":
                self._reject_subresources(
                    query, self._OBJECT_SUBRESOURCES
                )
                if "x-amz-copy-source" in self.headers:
                    return self._copy_object(bucket, key)
                return self._put_object(bucket, key)
            if m == "POST":
                self._reject_subresources(
                    query, self._OBJECT_SUBRESOURCES
                )
            if m == "DELETE":
                self._reject_subresources(
                    query, self._OBJECT_SUBRESOURCES
                )
                return self._delete_object(bucket, key, query)
            raise S3Error("MethodNotAllowed")

        # bucket-level
        if m == "GET":
            if "events" in query:
                return self._listen_notification(bucket, query)
            if "location" in query:
                return self._respond(200, xmlr.location_xml(""))
            if "policy" in query:
                return self._get_bucket_policy(bucket)
            if "versions" in query:
                return self._list_object_versions(bucket, query)
            if "encryption" in query:
                return self._get_bucket_encryption(bucket)
            if "uploads" in query:
                return self._list_uploads(bucket, query)
            if "versioning" in query:
                ol.get_bucket_info(bucket)
                state = self.s3.bucket_meta.get(bucket).versioning
                inner = (
                    f"<Status>{state}</Status>" if state else ""
                ).encode()
                return self._respond(
                    200,
                    b'<?xml version="1.0" encoding="UTF-8"?>\n'
                    b'<VersioningConfiguration xmlns="'
                    + xmlr.S3_NS.encode()
                    + b'">' + inner + b"</VersioningConfiguration>",
                )
            if "notification" in query:
                return self._get_bucket_notification(bucket)
            if "lifecycle" in query:
                return self._get_bucket_lifecycle(bucket)
            if "tagging" in query:
                return self._get_bucket_tagging(bucket)
            if "object-lock" in query:
                return self._get_bucket_object_lock(bucket)
            if "acl" in query:
                return self._get_acl(bucket, "")
            # dummy configs the reference serves statically
            # (cmd/dummy-handlers.go): empty-but-valid documents
            if "accelerate" in query:
                ol.get_bucket_info(bucket)
                return self._respond(
                    200,
                    b'<?xml version="1.0" encoding="UTF-8"?>'
                    b"<AccelerateConfiguration "
                    b'xmlns="' + xmlr.S3_NS.encode() + b'"/>',
                )
            if "requestPayment" in query:
                ol.get_bucket_info(bucket)
                return self._respond(
                    200,
                    b'<?xml version="1.0" encoding="UTF-8"?>'
                    b'<RequestPaymentConfiguration xmlns="'
                    + xmlr.S3_NS.encode()
                    + b'"><Payer>BucketOwner</Payer>'
                    b"</RequestPaymentConfiguration>",
                )
            if "logging" in query:
                ol.get_bucket_info(bucket)
                return self._respond(
                    200,
                    b'<?xml version="1.0" encoding="UTF-8"?>'
                    b'<BucketLoggingStatus xmlns="'
                    + xmlr.S3_NS.encode()
                    + b'" />',
                )
            if "cors" in query:
                ol.get_bucket_info(bucket)
                raise S3Error("NoSuchCORSConfiguration")
            if "website" in query:
                ol.get_bucket_info(bucket)
                raise S3Error("NoSuchWebsiteConfiguration")
            if "replication" in query:
                return self._get_bucket_replication(bucket)
            self._reject_subresources(query, self._BUCKET_SUBRESOURCES)
            return self._list_objects(bucket, query)
        if m == "HEAD":
            ol.get_bucket_info(bucket)
            return self._respond(200)
        if m == "PUT":
            if "policy" in query:
                return self._put_bucket_policy(bucket, self._read_body())
            if "versioning" in query:
                return self._put_bucket_versioning(
                    bucket, self._read_body()
                )
            if "notification" in query:
                return self._put_bucket_notification(
                    bucket, self._read_body()
                )
            if "lifecycle" in query:
                return self._put_bucket_lifecycle(
                    bucket, self._read_body()
                )
            if "tagging" in query:
                return self._put_bucket_tagging(bucket, self._read_body())
            if "object-lock" in query:
                return self._put_bucket_object_lock(
                    bucket, self._read_body()
                )
            if "encryption" in query:
                return self._put_bucket_encryption(
                    bucket, self._read_body()
                )
            if "acl" in query:
                return self._put_acl(bucket, "")
            if "replication" in query:
                return self._put_bucket_replication(
                    bucket, self._read_body()
                )
            self._reject_subresources(query, self._BUCKET_SUBRESOURCES)
            return self._make_bucket(bucket)
        if m == "DELETE":
            if "policy" in query:
                ol.get_bucket_info(bucket)
                self.s3.bucket_meta.update(bucket, policy_json="")
                return self._respond(204)
            if "lifecycle" in query:
                ol.get_bucket_info(bucket)
                self.s3.bucket_meta.update(bucket, lifecycle_xml="")
                return self._respond(204)
            if "tagging" in query:
                ol.get_bucket_info(bucket)
                self.s3.bucket_meta.update(bucket, tagging_xml="")
                return self._respond(204)
            if "encryption" in query:
                ol.get_bucket_info(bucket)
                self.s3.bucket_meta.update(bucket, sse_config_xml="")
                return self._respond(204)
            if "replication" in query:
                return self._delete_bucket_replication(bucket)
            self._reject_subresources(query, self._BUCKET_SUBRESOURCES)
            self._bucket_delete(bucket)
            return self._respond(204)
        if m == "POST":
            if "delete" in query:
                # multi-delete bodies are key lists, not data: cap far
                # below the generic buffered-body limit before reading
                if self._body_size() > MAX_MULTI_DELETE_BODY:
                    raise S3Error("EntityTooLarge")
                return self._delete_multiple(bucket, self._read_body())
            if self._is_post_policy(path, query):
                return self._post_policy(bucket)
        raise S3Error("MethodNotAllowed")

    def _federated_redirect(self, bucket, key, m, query) -> bool:
        """Federation: requests for a bucket owned by ANOTHER cluster
        are answered 307 to its endpoint.  DELIBERATE DIVERGENCE from
        the reference, which relies on external DNS routing
        (bucket.domain) and only proxies the web plane - a redirect
        keeps path-style clients working without CoreDNS.  Returns
        True when the response was written."""
        from ..cluster.dns import DNSError, NoEntriesFound

        if not key and m == "PUT" and not query:
            return False  # bucket creation negotiates ownership itself
        try:
            self.s3.object_layer.get_bucket_info(bucket)
            return False  # ours: serve locally
        except BucketNotFound:
            pass
        except Exception:  # noqa: BLE001
            return False
        try:
            recs = self.s3.bucket_dns.lookup(bucket)
        except (NoEntriesFound, DNSError):
            return False  # genuinely absent: the normal 404 path
        if self.s3.bucket_dns.owned_by_us(recs):
            return False
        r = recs[0]
        # the OWNER's scheme rides the record - the local listener's
        # TLS mode says nothing about the remote cluster's
        self._respond(
            307,
            headers={
                "Location": f"{r.scheme}://{r.host}:{r.port}{self.path}"
            },
        )
        return True

    def _bucket_create(self, bucket: str) -> None:
        """Bucket creation incl. federation negotiation: a name is
        unique across every cluster sharing the bucket DNS."""
        dns = self.s3.bucket_dns
        if dns is not None:
            from ..cluster.dns import NoEntriesFound

            try:
                recs = dns.lookup(bucket)
            except NoEntriesFound:
                recs = None
            if recs is not None:
                # bucket names are globally unique across the
                # federation (bucket-handlers.go:601-609)
                raise S3Error(
                    "BucketAlreadyOwnedByYou"
                    if dns.owned_by_us(recs)
                    else "BucketAlreadyExists"
                )
        self.s3.object_layer.make_bucket(bucket)
        if dns is not None:
            from ..cluster.dns import RecordExists

            try:
                dns.register(bucket)
            except RecordExists:
                # lost the exclusive-create race to another cluster:
                # the bucket must not exist half-federated
                # (MakeBucket rollback, bucket-handlers.go:572)
                self.s3.object_layer.delete_bucket(bucket, force=True)
                raise S3Error("BucketAlreadyExists") from None
            except Exception:  # noqa: BLE001
                self.s3.object_layer.delete_bucket(bucket, force=True)
                raise S3Error(
                    "InternalError", "failed to register bucket in DNS"
                ) from None

    def _bucket_delete(self, bucket: str) -> None:
        """Bucket deletion incl. DNS unregistration and config/event
        cleanup."""
        self.s3.object_layer.delete_bucket(bucket)
        if self.s3.bucket_dns is not None:
            try:
                self.s3.bucket_dns.unregister(bucket)
            except Exception as exc:
                _log.debug("bucket DNS unregister failed; stale record", extra=kv(err=str(exc)))
        self.s3.bucket_meta.delete(bucket)
        # a recreated bucket must not inherit the old rules
        self.s3.events.remove_bucket(bucket)
        self.s3.invalidate_event_rules(bucket)

    def _make_bucket(self, bucket: str):
        """CreateBucket, honoring x-amz-bucket-object-lock-enabled
        (bucket-handlers.go:528): lock-enabled buckets are born
        versioned and carry a basic ObjectLockConfiguration."""
        lock_hdr = (
            self.headers.get("x-amz-bucket-object-lock-enabled") or ""
        ).lower()
        if lock_hdr and lock_hdr not in ("true", "false"):
            raise S3Error("InvalidRequest")
        self._bucket_create(bucket)
        if lock_hdr == "true":
            self.s3.bucket_meta.update(
                bucket,
                versioning="Enabled",
                object_lock_xml=olock.ObjectLockConfig().to_xml().decode(),
            )
        self._respond(200, headers={"Location": f"/{bucket}"})

    # -- service ----------------------------------------------------------

    def _listen_notification(self, bucket: str, query) -> None:
        """ListenBucketNotification (listen-notification-handlers.go):
        stream matching events to the client as JSON lines with
        whitespace keep-alives, until it disconnects.

        CLUSTER-WIDE: the subscription fans out over the peer plane
        (listenon/listenbuf/listenoff RPCs - the Listen peer RPC of
        cmd/notification.go:440), so a watcher on this node sees
        events originated on every node; remote records are polled by
        per-peer threads and merged into the same stream.
        """
        import json as _json
        import uuid as _uuid

        from ..event.event import EventName
        from ..event.event import matches_filter as ev_matches
        from ..event.event import to_listen_record

        self.s3.object_layer.get_bucket_info(bucket)
        prefix = query.get("prefix", [""])[0]
        suffix = query.get("suffix", [""])[0]
        names: "set[str]" = set()
        for raw in query.get("events", [""]):
            for part in raw.split(","):
                part = part.strip()
                if not part:
                    continue
                if not EventName.valid(part):
                    raise S3Error(
                        "InvalidArgument", f"unknown event {part!r}"
                    )
                names.update(EventName.expand(part))
        self._finish_body()
        sub = self.s3.events.subscribe_listener(bucket)
        # remote fan-out: register on every peer, poll each from its
        # own thread so one slow peer never stalls the stream
        import collections as _collections
        import threading as _threading

        remote_lines: "_collections.deque" = _collections.deque(
            maxlen=10_000
        )
        stop_remote = _threading.Event()
        pollers: "list[_threading.Thread]" = []
        lid = _uuid.uuid4().hex
        notifier = getattr(self.s3, "peer_notifier", None)

        def poll_peer(client):
            registered = False
            while not stop_remote.is_set():
                try:
                    if not registered:
                        client.listen_on(
                            lid, bucket, prefix, suffix, names
                        )
                        registered = True
                    for rec in client.listen_buf(lid):
                        remote_lines.append(
                            _json.dumps(rec).encode() + b"\n"
                        )
                except Exception:  # noqa: BLE001
                    registered = False  # peer bounced; re-register
                stop_remote.wait(0.25)
            if registered:
                try:
                    client.listen_off(lid)
                except Exception as exc:
                    _log.debug("remote listen_off failed", extra=kv(err=str(exc)))

        for client in getattr(notifier, "clients", []):
            t = _threading.Thread(
                target=poll_peer, args=(client,), daemon=True,
                name=f"listen-poll-{client.host}:{client.port}",
            )
            t.start()
            pollers.append(t)
        self.send_response(200)
        self.send_header("Server", "MinIO-TPU")
        self.send_header("Content-Type", "application/json")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        self._last_status = 200
        last_keepalive = _time.monotonic()
        try:
            while not self.s3.draining:
                ev = sub.get(timeout=0.5)
                now = _time.monotonic()
                # keep-alive on EVERY idle-enough iteration: a steady
                # stream of filtered-out events must not starve the
                # client of bytes (proxies kill silent connections)
                if now - last_keepalive >= 5.0:
                    self.wfile.write(b" ")
                    self.wfile.flush()
                    last_keepalive = now
                while remote_lines:
                    line = remote_lines.popleft()
                    self.wfile.write(line)
                    self.wfile.flush()
                    self._resp_bytes += len(line)
                    last_keepalive = now
                if ev is None:
                    continue
                if not ev_matches(ev, bucket, names, prefix, suffix):
                    continue
                line = _json.dumps(
                    to_listen_record(ev)
                ).encode() + b"\n"
                self.wfile.write(line)
                self.wfile.flush()
                self._resp_bytes += len(line)
                last_keepalive = now
        except OSError:
            pass  # client went away: the normal way this ends
        finally:
            stop_remote.set()
            # join so listen_off reliably fires before the handler
            # returns (each poller wakes within 0.25s)
            for t in pollers:
                t.join(timeout=2)
            self.s3.events.unsubscribe_listener(bucket, sub)

    def _list_buckets(self):
        buckets = self.s3.object_layer.list_buckets()
        if self.s3.bucket_dns is not None:
            # federated view: every cluster's buckets, deduped
            # (bucket-handlers.go:74 dnsBuckets merge)
            have = {b.name for b in buckets}
            try:
                federated = self.s3.bucket_dns.federated_buckets()
            except Exception:  # noqa: BLE001
                federated = {}
            for name, recs in sorted(federated.items()):
                if name not in have:
                    buckets.append(
                        BucketInfo(
                            name=name,
                            created_ns=min(
                                (r.creation_ns for r in recs),
                                default=0,
                            ),
                        )
                    )
            buckets.sort(key=lambda b: b.name)
        self._respond(200, xmlr.list_buckets_xml(buckets))

    # -- bucket ops -------------------------------------------------------

    def _list_objects(self, bucket: str, query):
        q1 = {k: v[0] for k, v in query.items()}
        try:
            max_keys = int(q1.get("max-keys", 1000))
        except ValueError:
            raise S3Error("InvalidArgument", "max-keys") from None
        if max_keys < 0:
            raise S3Error("InvalidArgument", "max-keys negative")
        prefix = q1.get("prefix", "")
        delimiter = q1.get("delimiter", "")
        encode = q1.get("encoding-type", "") == "url"
        if q1.get("list-type") == "2":
            token = q1.get("continuation-token", "")
            start_after = q1.get("start-after", "")
            try:
                marker = (
                    base64.urlsafe_b64decode(token.encode()).decode()
                    if token
                    else start_after
                )
            except Exception:  # noqa: BLE001
                raise S3Error(
                    "InvalidArgument", "continuation-token"
                ) from None
            res = self.s3.object_layer.list_objects(
                bucket, prefix, marker, delimiter, max_keys
            )
            body = xmlr.list_objects_v2_xml(
                bucket, prefix, delimiter, max_keys, start_after,
                token, res, encode,
            )
        else:
            marker = q1.get("marker", "")
            res = self.s3.object_layer.list_objects(
                bucket, prefix, marker, delimiter, max_keys
            )
            body = xmlr.list_objects_v1_xml(
                bucket, prefix, marker, delimiter, max_keys, res, encode
            )
        self._respond(200, body)

    # -- versioning (bucket-versioning-handler.go) ------------------------

    def _versioning(self, bucket: str) -> "tuple[bool, bool]":
        """(versioned, suspended) for the bucket."""
        try:
            bm = self.s3.bucket_meta.get(bucket)
        except Exception:  # noqa: BLE001
            return False, False
        return bm.versioning_enabled, bm.versioning_suspended

    def _put_bucket_versioning(self, bucket: str, body: bytes):
        self.s3.object_layer.get_bucket_info(bucket)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        ns = (
            root.tag[: root.tag.index("}") + 1]
            if root.tag.startswith("{")
            else ""
        )
        status = (root.findtext(f"{ns}Status") or "").strip()
        if status not in ("Enabled", "Suspended"):
            raise S3Error("MalformedXML", "bad versioning Status")
        # suspending versioning on a lock-enabled bucket would let PUTs
        # overwrite retained versions (AWS rejects with 409)
        if (
            status == "Suspended"
            and self.s3.bucket_meta.get(bucket).object_lock_xml
        ):
            raise S3Error(
                "InvalidBucketState",
                "versioning cannot be suspended on object-lock buckets",
            )
        self.s3.bucket_meta.update(bucket, versioning=status)
        self._respond(200)

    # -- bucket encryption config (bucket-encryption-handlers.go) ---------

    def _get_bucket_encryption(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).sse_config_xml
        if not raw:
            raise S3Error("ServerSideEncryptionConfigurationNotFoundError")
        self._respond(200, raw.encode())

    def _put_bucket_encryption(self, bucket: str, body: bytes):
        """Store the SSE default config; only SSE-S3 (AES256) is
        honored, mirroring validateBucketSSEConfig."""
        self.s3.object_layer.get_bucket_info(bucket)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        algos = [
            (el.text or "").strip()
            for el in root.iter()
            if strip_ns(el.tag) == "SSEAlgorithm"
        ]
        if algos != ["AES256"]:
            raise S3Error(
                "NotImplemented",
                "only a single AES256 default rule is supported",
            )
        self.s3.bucket_meta.update(
            bucket, sse_config_xml=body.decode("utf-8", "replace")
        )
        self._respond(200)

    # -- bucket notification (bucket-notification-handlers.go) ------------

    def _get_bucket_notification(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).notification_xml
        if raw:
            return self._respond(200, raw.encode())
        from ..event.rules import NotificationConfig

        self._respond(200, NotificationConfig().to_xml())

    def _put_bucket_notification(self, bucket: str, body: bytes):
        from ..event.rules import NotificationConfig, NotificationError

        self.s3.object_layer.get_bucket_info(bucket)
        try:
            cfg = NotificationConfig.from_xml(body)
            # validates ARNs against registered targets AND installs
            # the rules (config.Validate + bucketRulesMap update)
            self.s3.events.set_bucket_config(bucket, cfg)
        except NotificationError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        self.s3.bucket_meta.update(
            bucket, notification_xml=cfg.to_xml().decode()
        )
        self.s3.mark_event_rules_loaded(bucket)
        self._respond(200)

    # -- bucket lifecycle (bucket-lifecycle-handlers.go) ------------------

    def _get_bucket_lifecycle(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).lifecycle_xml
        if not raw:
            raise S3Error("NoSuchLifecycleConfiguration")
        self._respond(200, raw.encode())

    def _put_bucket_lifecycle(self, bucket: str, body: bytes):
        self.s3.object_layer.get_bucket_info(bucket)
        try:
            lc = Lifecycle.from_xml(body)
        except LifecycleError as e:
            raise S3Error("MalformedXML", str(e)) from None
        self.s3.bucket_meta.update(
            bucket, lifecycle_xml=lc.to_xml().decode()
        )
        self._respond(200)

    # -- bucket tagging (bucket-handlers.go PutBucketTaggingHandler) ------

    def _get_bucket_tagging(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).tagging_xml
        if not raw:
            raise S3Error("NoSuchTagSet")
        self._respond(200, raw.encode())

    def _put_bucket_tagging(self, bucket: str, body: bytes):
        self.s3.object_layer.get_bucket_info(bucket)
        tags = self._parse_tags(body, tagmod.MAX_BUCKET_TAGS)
        self.s3.bucket_meta.update(
            bucket, tagging_xml=tagmod.to_xml(tags).decode()
        )
        self._respond(200)

    @staticmethod
    def _parse_tags(body: bytes, limit: int) -> dict:
        try:
            return tagmod.from_xml(body, limit)
        except tagmod.TagXMLError as e:
            raise S3Error("MalformedXML", str(e)) from None
        except tagmod.TagError as e:
            raise S3Error("InvalidTag", str(e)) from None

    # -- bucket object lock (bucket-handlers.go:1026) ---------------------

    def _get_bucket_object_lock(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).object_lock_xml
        if not raw:
            raise S3Error("ObjectLockConfigurationNotFoundError")
        self._respond(200, raw.encode())

    def _put_bucket_object_lock(self, bucket: str, body: bytes):
        self.s3.object_layer.get_bucket_info(bucket)
        try:
            cfg = olock.ObjectLockConfig.from_xml(body)
        except olock.ObjectLockError as e:
            raise S3Error("MalformedXML", str(e)) from None
        # lock settings may only change on buckets born lock-enabled
        # (bucket-handlers.go:1060: "Deny object locking configuration
        # settings on existing buckets without object lock enabled")
        if not self.s3.bucket_meta.get(bucket).object_lock_xml:
            raise S3Error("ObjectLockConfigurationNotFoundError")
        self.s3.bucket_meta.update(
            bucket, object_lock_xml=cfg.to_xml().decode()
        )
        self._respond(200)

    # -- bucket replication config (the document; the async engine is
    #    replication/replicate.py behind S3Server.replication) -----------

    def _get_bucket_replication(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        raw = self.s3.bucket_meta.get(bucket).replication_xml
        if not raw:
            raise S3Error("ReplicationConfigurationNotFoundError")
        self._respond(200, raw.encode())

    def _put_bucket_replication(self, bucket: str, body: bytes):
        from ..replication.config import ReplicationConfig, ReplicationError

        self.s3.object_layer.get_bucket_info(bucket)
        if not self.s3.bucket_meta.get(bucket).versioning_enabled:
            raise S3Error("ReplicationSourceNotVersionedError")
        try:
            cfg = ReplicationConfig.from_xml(body)
        except ReplicationError as e:
            raise S3Error("MalformedXML", str(e)) from None
        self.s3.bucket_meta.update(
            bucket, replication_xml=cfg.to_xml().decode()
        )
        self._respond(200)

    def _delete_bucket_replication(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        self.s3.bucket_meta.update(bucket, replication_xml="")
        self._respond(204)

    # -- ACL stubs (cmd/acl-handlers.go: static FULL_CONTROL owner) -------

    def _get_acl(self, bucket: str, key: str):
        if key:
            self.s3.object_layer.get_object_info(bucket, key)
        else:
            self.s3.object_layer.get_bucket_info(bucket)
        self._respond(
            200,
            b'<?xml version="1.0" encoding="UTF-8"?>'
            b'<AccessControlPolicy xmlns="' + xmlr.S3_NS.encode() + b'">'
            b"<Owner><ID>minio</ID><DisplayName>minio</DisplayName></Owner>"
            b"<AccessControlList><Grant>"
            b'<Grantee xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"'
            b' xsi:type="CanonicalUser">'
            b"<ID>minio</ID><DisplayName>minio</DisplayName></Grantee>"
            b"<Permission>FULL_CONTROL</Permission>"
            b"</Grant></AccessControlList></AccessControlPolicy>",
        )

    def _put_acl(self, bucket: str, key: str):
        """Only the 'private' canned ACL round-trips; anything else is
        NotImplemented (PutBucketACLHandler)."""
        if key:
            self.s3.object_layer.get_object_info(bucket, key)
        else:
            self.s3.object_layer.get_bucket_info(bucket)
        canned = self.headers.get("x-amz-acl", "")
        body = self._read_body()
        if canned and canned != "private":
            raise S3Error("NotImplemented", "only private ACL")
        if body and b"FULL_CONTROL" not in body and b"private" not in body:
            raise S3Error("NotImplemented", "only private ACL")
        self._respond(200)

    # -- object tagging (object-handlers.go PutObjectTaggingHandler) ------

    def _get_object_tagging(self, bucket, key, query):
        vid = query.get("versionId", [""])[0]
        info = self.s3.object_layer.get_object_info(bucket, key, vid)
        tags = tagmod.decode(info.user_defined.get("x-amz-tagging", ""))
        hdrs = (
            {"x-amz-version-id": info.version_id}
            if info.version_id
            else None
        )
        self._respond(200, tagmod.to_xml(tags), hdrs)

    def _put_object_tagging(self, bucket, key, query):
        vid = query.get("versionId", [""])[0]
        tags = self._parse_tags(self._read_body(), tagmod.MAX_OBJECT_TAGS)
        self.s3.object_layer.update_object_meta(
            bucket, key, {"x-amz-tagging": tagmod.encode(tags)}, vid
        )
        self._respond(200)

    def _delete_object_tagging(self, bucket, key, query):
        vid = query.get("versionId", [""])[0]
        self.s3.object_layer.update_object_meta(
            bucket, key, {"x-amz-tagging": None}, vid
        )
        self._respond(204)

    # -- object retention / legal hold (object-handlers.go) ---------------

    def _require_lock_config(self, bucket: str):
        if not self.s3.bucket_meta.get(bucket).object_lock_xml:
            raise S3Error("InvalidBucketObjectLockConfiguration")

    def _get_object_retention(self, bucket, key, query):
        self._require_lock_config(bucket)
        vid = query.get("versionId", [""])[0]
        info = self.s3.object_layer.get_object_info(bucket, key, vid)
        ret = olock.Retention.from_meta(info.user_defined)
        if not ret.valid:
            raise S3Error("NoSuchObjectLockConfiguration")
        self._respond(200, ret.to_xml())

    def _put_object_retention(self, bucket, key, query):
        self._require_lock_config(bucket)
        vid = query.get("versionId", [""])[0]
        try:
            ret = olock.Retention.from_xml(self._read_body())
        except olock.ObjectLockError as e:
            raise S3Error("MalformedXML", str(e)) from None
        info = self.s3.object_layer.get_object_info(bucket, key, vid)
        cur = olock.Retention.from_meta(info.user_defined)
        active = (
            cur.valid
            and cur.retain_until is not None
            and cur.retain_until > olock.utcnow()
        )
        # strengthening is always allowed: same-or-stronger mode with a
        # same-or-later date (COMPLIANCE > GOVERNANCE).  Anything else
        # against an active retention is a weakening attempt.
        strengthens = ret.retain_until >= cur.retain_until if active else True
        if active and cur.mode == olock.COMPLIANCE:
            # COMPLIANCE can never be weakened, by anyone
            # (enforceRetentionBypassForPut compliance branch)
            if ret.mode != olock.COMPLIANCE or not strengthens:
                raise S3Error("ObjectLocked")
        elif active and cur.mode == olock.GOVERNANCE:
            # weakening GOVERNANCE needs the bypass header + permission;
            # upgrading to COMPLIANCE or extending the date does not
            if (
                not (strengthens and ret.mode in (olock.GOVERNANCE,
                                                  olock.COMPLIANCE))
                and not self._governance_bypass_allowed(bucket, key)
            ):
                raise S3Error("ObjectLocked")
        self.s3.object_layer.update_object_meta(
            bucket, key,
            {
                olock.META_MODE: ret.mode,
                olock.META_RETAIN_UNTIL: olock.format_iso8601(
                    ret.retain_until
                ),
            },
            vid,
        )
        self._respond(200)

    def _get_object_legal_hold(self, bucket, key, query):
        self._require_lock_config(bucket)
        vid = query.get("versionId", [""])[0]
        info = self.s3.object_layer.get_object_info(bucket, key, vid)
        status = info.user_defined.get(olock.META_LEGAL_HOLD, "OFF")
        self._respond(200, olock.legal_hold_xml(status))

    def _put_object_legal_hold(self, bucket, key, query):
        self._require_lock_config(bucket)
        vid = query.get("versionId", [""])[0]
        try:
            status = olock.parse_legal_hold_xml(self._read_body())
        except olock.ObjectLockError as e:
            raise S3Error("MalformedXML", str(e)) from None
        self.s3.object_layer.update_object_meta(
            bucket, key, {olock.META_LEGAL_HOLD: status}, vid
        )
        self._respond(200)

    def _governance_bypass_allowed(self, bucket: str, key: str) -> bool:
        """Caller set x-amz-bypass-governance-retention AND holds the
        bypass permission (enforceRetentionBypassForDelete)."""
        if not olock.is_governance_bypass(dict(self.headers.items())):
            return False
        account = self._auth.access_key if self._auth else ""
        return self._check_action(
            "s3:BypassGovernanceRetention", bucket, key, account
        )

    def _enforce_worm(self, bucket, key, version_id: str) -> None:
        """Block deletion of WORM-protected versions.  Only consulted
        when the bucket carries an object-lock configuration."""
        try:
            if not self.s3.bucket_meta.get(bucket).object_lock_xml:
                return
        except BucketNotFound:
            return
        try:
            info = self.s3.object_layer.get_object_info(
                bucket, key, version_id
            )
        except (ObjectNotFound, VersionNotFound):
            # absent version / delete marker: nothing to protect.  Any
            # OTHER failure (quorum loss, lock timeout) must propagate -
            # a WORM gate that fails open is not a gate.
            return
        blocked = olock.retention_blocks_delete(
            info.user_defined,
            bypass_governance=self._governance_bypass_allowed(bucket, key),
        )
        if blocked is not None:
            raise S3Error("ObjectLocked")

    def _list_object_versions(self, bucket: str, query):
        q1 = {k: v[0] for k, v in query.items()}
        try:
            max_keys = int(q1.get("max-keys", 1000))
        except ValueError:
            raise S3Error("InvalidArgument", "max-keys") from None
        if max_keys < 0:
            raise S3Error("InvalidArgument", "max-keys negative")
        prefix = q1.get("prefix", "")
        delimiter = q1.get("delimiter", "")
        key_marker = q1.get("key-marker", "")
        vid_marker = q1.get("version-id-marker", "")
        encode = q1.get("encoding-type", "") == "url"
        res = self.s3.object_layer.list_object_versions(
            bucket, prefix, key_marker, vid_marker, delimiter, max_keys
        )
        self._respond(
            200,
            xmlr.list_versions_xml(
                bucket, prefix, key_marker, vid_marker, delimiter,
                max_keys, res, encode,
            ),
        )

    # -- bucket policy (PutBucketPolicyHandler, bucket-policy-handlers.go)

    def _get_bucket_policy(self, bucket: str):
        self.s3.object_layer.get_bucket_info(bucket)
        pj = self.s3.bucket_meta.get(bucket).policy_json
        if not pj:
            raise S3Error("NoSuchBucketPolicy")
        self._respond(200, pj.encode(), content_type="application/json")

    def _put_bucket_policy(self, bucket: str, body: bytes):
        from ..iam.policy import Policy, PolicyError

        self.s3.object_layer.get_bucket_info(bucket)
        try:
            pol = Policy.from_json(body)
            pol.validate_bucket(bucket)
        except PolicyError as e:
            raise S3Error("MalformedPolicy", str(e)) from None
        self.s3.bucket_meta.update(
            bucket, policy_json=pol.to_json()
        )
        self._respond(204)

    def _notify(
        self, name, bucket, key, etag="", size=0, version_id=""
    ) -> None:
        """Queue a bucket event (sendEvent, cmd/notification.go) -
        O(1) when the bucket has no notification rules AND nobody is
        listening (live ListenBucketNotification streams receive
        events regardless of configured rules)."""
        s3 = self.s3
        s3.ensure_event_rules(bucket)
        if not s3.events.rules.has_rules(bucket) and not (
            s3.events.has_listeners(bucket)
        ):
            return
        from ..event import Event, Identity

        ctx = self._auth
        s3.events.send(
            Event(
                name=name,
                bucket=bucket,
                object_key=key,
                etag=etag,
                size=size,
                version_id=version_id,
                identity=Identity(
                    "" if ctx is None or ctx.anonymous else ctx.access_key,
                    self.client_address[0] if self.client_address else "",
                ),
                endpoint=s3.endpoint,
            )
        )

    def _delete_multiple(self, bucket: str, body: bytes):
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[: root.tag.index("}") + 1]
        quiet = (root.findtext(f"{ns}Quiet") or "").lower() == "true"
        deleted, errs = [], []
        account = self._auth.access_key if self._auth else ""
        versioned, suspended = self._versioning(bucket)
        objs = [
            (
                obj.findtext(f"{ns}Key") or "",
                (obj.findtext(f"{ns}VersionId") or "").strip(),
            )
            for obj in root.findall(f"{ns}Object")
        ]
        for key, vid in objs:
            # per-key authorization (DeleteMultipleObjectsHandler checks
            # DeleteObject for every named key)
            action = "s3:DeleteObjectVersion" if vid else "s3:DeleteObject"
            if not self._check_action(action, bucket, key, account):
                errs.append((key, "AccessDenied", "Access Denied."))
                continue
            # WORM guards a named version or unversioned data
            try:
                if vid or not (versioned or suspended):
                    self._enforce_worm(bucket, key, vid)
            except S3Error as e:
                errs.append((key, e.err.code, e.err.message))
                continue
            try:
                # a named version is removed outright; an unqualified
                # delete on a versioned bucket writes a marker
                dinfo = self.s3.object_layer.delete_object(
                    bucket, key, vid,
                    versioned=versioned, version_suspended=suspended,
                )
                from ..event.event import EventName

                self._notify(
                    EventName.OBJECT_REMOVED_DELETE_MARKER
                    if dinfo.delete_marker
                    else EventName.OBJECT_REMOVED_DELETE,
                    bucket, key, version_id=dinfo.version_id or vid,
                )
                if not quiet:
                    deleted.append(key)
            except Exception as e:  # noqa: BLE001 - a per-key error
                err = s3errors.from_exception(e)
                if err.code in ("NoSuchKey", "NoSuchVersion"):
                    if not quiet:
                        deleted.append(key)  # S3 treats as success
                else:
                    errs.append((key, err.code, err.message))
        self._respond(200, xmlr.delete_result_xml(deleted, errs))

    def _post_policy(self, bucket: str):
        """Browser form upload (PostPolicyBucketHandler,
        cmd/bucket-handlers.go): multipart/form-data with a signed,
        base64-encoded policy document."""
        ctype = self.headers.get("Content-Type", "")
        boundary = ""
        for param in ctype.split(";")[1:]:
            k, _, v = param.strip().partition("=")
            if k == "boundary":
                boundary = v.strip('"')
        if not boundary:
            raise S3Error("MalformedPOSTRequest", "missing boundary")
        reader, size = self._open_body()
        if size > MAX_IN_MEMORY_BODY:
            raise S3Error("EntityTooLarge")
        body = b""
        while len(body) < size:
            c = reader.read(size - len(body))
            if not c:
                break
            body += c
        form, file_data, file_name = _parse_multipart_form(body, boundary)
        key = form.get("key", "")
        if not key:
            raise S3Error("InvalidArgument", "POST requires key field")
        key = key.replace("${filename}", file_name)
        form["key"] = key
        form["bucket"] = bucket
        form["content-length"] = str(len(file_data))
        post_account = self.s3.verifier.verify_post_policy(form)
        # the form's signer must hold PutObject (isPutActionAllowed,
        # auth-handler.go:583)
        if not self._check_action(
            "s3:PutObject", bucket, key, post_account
        ):
            raise S3Error("AccessDenied")
        meta = {}
        if form.get("content-type"):
            meta["content-type"] = form["content-type"]
        for k, v in form.items():
            if k.startswith("x-amz-meta-"):
                meta[k] = v
        hreader = HashReader(io.BytesIO(file_data), len(file_data))
        from ..event.event import EventName

        info = self._checked_put(
            bucket, key, hreader, len(file_data), meta,
            versioned=self._versioning(bucket)[0],
            event_name=EventName.OBJECT_CREATED_POST,
        )
        status = form.get("success_action_status", "204")
        etag_hdr = {"ETag": f'"{info.etag}"'}
        if status == "201":
            location = f"{self.s3.endpoint}/{bucket}/{key}"
            self._respond(
                201,
                xmlr.post_response_xml(location, bucket, key, info.etag),
                {**etag_hdr, "Location": location},
            )
        elif status == "200":
            self._respond(200, b"", etag_hdr)
        else:
            self._respond(204, b"", etag_hdr)

    # -- object ops -------------------------------------------------------

    def _object_headers(self, info: ObjectInfo) -> dict:
        h = {
            "ETag": f'"{info.etag}"',
            "Last-Modified": email.utils.formatdate(
                info.mod_time, usegmt=True
            ),
            "Accept-Ranges": "bytes",
        }
        if info.content_type:
            h["Content-Type-Override"] = info.content_type
        for k, v in info.user_defined.items():
            if k.startswith("x-amz-meta-") or k.startswith(
                "x-amz-object-lock-"
            ):
                h[k] = v
        # the replication status rides GET and HEAD as in the reference
        # (setObjectHeaders); the JAX package keeps it internal
        status = info.user_defined.get(META_REPLICATION_STATUS)
        if status:
            h[META_REPLICATION_STATUS] = status
        if info.version_id:
            h["x-amz-version-id"] = info.version_id
        return h

    def _check_conditions(self, info: ObjectInfo):
        """Conditional header evaluation (object-handlers-common.go)."""
        inm = self.headers.get("If-None-Match")
        im = self.headers.get("If-Match")
        ims = self.headers.get("If-Modified-Since")
        ius = self.headers.get("If-Unmodified-Since")
        etag = f'"{info.etag}"'
        if im and im not in (etag, "*", info.etag):
            raise S3Error("PreconditionFailed")
        if inm and inm in (etag, "*", info.etag):
            raise S3Error("NotModified")
        if ims:
            t = email.utils.parsedate_to_datetime(ims)
            if t and info.mod_time <= t.timestamp():
                raise S3Error("NotModified")
        if ius:
            t = email.utils.parsedate_to_datetime(ius)
            if t and info.mod_time > t.timestamp():
                raise S3Error("PreconditionFailed")

    def _parse_range(self, total: int) -> "tuple[int, int] | None":
        """Parse Range: bytes=a-b (httprange.go)."""
        hdr = self.headers.get("Range")
        if not hdr:
            return None
        if not hdr.startswith("bytes="):
            return None  # ignored per RFC
        spec = hdr[len("bytes=") :]
        if "," in spec:
            raise S3Error("NotImplemented", "multiple ranges")
        lo_s, _, hi_s = spec.partition("-")
        try:
            if lo_s == "":
                # suffix range
                n = int(hi_s)
                if n == 0:
                    raise S3Error("InvalidRange")
                lo = max(0, total - n)
                hi = total - 1
            else:
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else total - 1
        except ValueError:
            raise S3Error("InvalidRange") from None
        if lo > hi or lo >= total:
            raise S3Error("InvalidRange")
        return lo, min(hi, total - 1)

    def _select_object(self, bucket, key):
        """SelectObjectContent (object-handlers.go:91): SQL over one
        object, streamed back as EventStream frames."""
        from . import select as selmod

        body = self._read_body()
        info = self.s3.object_layer.get_object_info(bucket, key)
        selmod.handle_select(self, bucket, key, info, body)

    def _get_object(self, bucket, key, query):
        """Stream the object body straight to the socket: headers go out
        first (size known from metadata), then the erasure decode writes
        block-by-block into wfile - constant memory per request."""
        ol = self.s3.object_layer
        version_id = query.get("versionId", [""])[0]
        info, sse = self._read_info_and_sse(ol, bucket, key, version_id)
        self._check_conditions(info)
        rng = self._parse_range(info.size)
        headers = self._object_headers(info)
        headers.update(self._sse_response_headers(info.user_defined))
        headers.pop("Content-Type-Override", None)
        # tag count rides GET responses only (GetObject API contract)
        tag_enc = info.user_defined.get("x-amz-tagging", "")
        if tag_enc:
            headers["x-amz-tagging-count"] = str(len(tag_enc.split("&")))
        ct = info.content_type or "application/octet-stream"
        if rng:
            lo, hi = rng
            status, length = 206, hi - lo + 1
            headers["Content-Range"] = f"bytes {lo}-{hi}/{info.size}"
        else:
            status, length = 200, info.size
            lo = 0
        self.send_response(status)
        self.send_header("Server", "MinIO-TPU")
        self.send_header(
            "x-amz-request-id", uuid.uuid4().hex[:16].upper()
        )
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Type", ct)
        self.send_header("Content-Length", str(length))
        self.end_headers()
        if length:
            try:
                ol.get_object(
                    bucket, key, self.wfile, lo, length, version_id, sse
                )
                self._resp_bytes += length
            except Exception:  # noqa: BLE001
                # headers already sent; the only honest signal is a
                # broken connection (the reference behaves the same)
                self.close_connection = True
                raise ConnectionError(
                    "mid-stream decode failure"
                ) from None
        from ..event.event import EventName

        self._notify(
            EventName.OBJECT_ACCESSED_GET, bucket, key,
            size=length, version_id=version_id,
        )

    def _head_object(self, bucket, key, query):
        version_id = query.get("versionId", [""])[0]
        info, _sse = self._read_info_and_sse(
            self.s3.object_layer, bucket, key, version_id
        )  # key required (and checked) for HEAD too
        self._check_conditions(info)
        headers = self._object_headers(info)
        headers.update(self._sse_response_headers(info.user_defined))
        headers.pop("Content-Type-Override", None)
        self.send_response(200)
        self.send_header("Server", "MinIO-TPU")
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header(
            "Content-Type",
            info.content_type or "application/octet-stream",
        )
        self.send_header("Content-Length", str(info.size))
        self.end_headers()
        from ..event.event import EventName

        self._notify(
            EventName.OBJECT_ACCESSED_HEAD, bucket, key,
            info.etag, info.size, info.version_id,
        )

    def _put_lock_and_tag_meta(self, bucket: str, key: str) -> dict:
        """PUT-time tagging + object-lock metadata
        (checkPutObjectLockAllowed, cmd/object-handlers.go; the
        x-amz-tagging header carries URL-encoded tags)."""
        meta: dict = {}
        tag_hdr = self.headers.get("x-amz-tagging", "")
        if tag_hdr:
            try:
                tags = tagmod.from_header(tag_hdr)
            except tagmod.TagError as e:
                raise S3Error("InvalidTag", str(e)) from None
            meta["x-amz-tagging"] = tagmod.encode(tags)
        try:
            lock_meta = olock.retention_meta_from_headers(
                dict(self.headers.items())
            )
        except olock.ObjectLockError as e:
            raise S3Error("ObjectLockInvalidHeaders", str(e)) from None
        lock_xml = ""
        try:
            lock_xml = self.s3.bucket_meta.get(bucket).object_lock_xml
        except Exception as exc:
            _log.debug("bucket object-lock config read failed", extra=kv(err=str(exc)))
        if lock_meta:
            # explicit lock headers need the bucket to be lock-enabled
            if not lock_xml:
                raise S3Error("InvalidBucketObjectLockConfiguration")
            meta.update(lock_meta)
        elif lock_xml:
            # no explicit headers: the bucket's default rule stamps
            # every new version
            try:
                cfg = olock.ObjectLockConfig.from_xml(lock_xml.encode())
                meta.update(cfg.default_retention_meta())
            except olock.ObjectLockError:
                pass
        return meta

    def _collect_user_metadata(self) -> dict:
        meta = {}
        ct = self.headers.get("Content-Type")
        if ct:
            meta["content-type"] = ct
        for k, v in self.headers.items():
            lk = k.lower()
            if lk.startswith("x-amz-meta-"):
                meta[lk] = v
        return meta

    def _checked_put(
        self, bucket, key, hreader, size, meta,
        versioned=False, event_name=None,
    ):
        """The full PUT invariant chain - size cap, quota,
        lock/tagging defaults, replication stamp + queue,
        bucket-default/requested SSE, event - shared by the S3 PUT and
        POST-policy paths so the invariants cannot drift between them
        (objectPutValidate* in the reference's object-handlers.go)."""
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        quotamod.enforce_put(self.s3, bucket, size)
        meta.update(self._put_lock_and_tag_meta(bucket, key))
        replicate = self.s3.replication.should_replicate(bucket, key)
        if replicate:
            meta[META_REPLICATION_STATUS] = "PENDING"
        sse = self._request_sse(bucket)
        # transparent compression (MINIO_TPU_COMPRESS) is decided inside
        # the object layer so POST-policy/multipart/copy share the seam
        info = self.s3.object_layer.put_object(
            bucket, key, hreader, size, meta, versioned=versioned, sse=sse,
        )
        if replicate:
            self.s3.replication.queue(bucket, key, info.version_id)
        from ..event.event import EventName

        self._notify(
            event_name or EventName.OBJECT_CREATED_PUT, bucket, key,
            info.etag, info.size, info.version_id,
        )
        return info

    def _put_object(self, bucket, key):
        """Stream the body straight into the erasure encoder in
        block_size chunks (cmd/erasure-encode.go:73-109) - bounded memory
        regardless of object size."""
        reader, size = self._open_body()
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        hreader = self._hash_reader(reader, size)
        versioned, _ = self._versioning(bucket)
        meta = self._collect_user_metadata()
        info = self._checked_put(
            bucket, key, hreader, size, meta, versioned=versioned
        )
        hdrs = {"ETag": f'"{info.etag}"'}
        hdrs.update(self._sse_response_headers(info.user_defined))
        if info.version_id:
            hdrs["x-amz-version-id"] = info.version_id
        self._respond(200, b"", hdrs)

    # -- server-side encryption plumbing (cmd/crypto/header.go,
    #    cmd/encryption-v1.go) ----------------------------------------

    def _parse_ssec_headers(self, prefix: str):
        """SSESpec from the SSE-C header triplet under ``prefix``, or
        None when absent.  Validation order and messages follow
        crypto.SSEC.ParseHTTP (cmd/crypto/header.go:208)."""
        algo = self.headers.get(f"{prefix}-algorithm")
        key_b64 = self.headers.get(f"{prefix}-key")
        md5_b64 = self.headers.get(f"{prefix}-key-MD5")
        if algo is None and key_b64 is None and md5_b64 is None:
            return None
        if not getattr(self.s3, "tls", False):
            # ErrInsecureSSECustomerRequest: keys must never ride
            # plaintext HTTP
            raise S3Error(
                "InvalidRequest",
                "Requests specifying Server Side Encryption with "
                "Customer provided keys must be made over a secure "
                "connection.",
            )
        if algo != "AES256":
            raise S3Error(
                "InvalidArgument",
                "Requests specifying Server Side Encryption with "
                "Customer provided keys must provide a valid "
                "encryption algorithm.",
            )
        if not key_b64:
            raise S3Error(
                "InvalidArgument",
                "Requests specifying Server Side Encryption with "
                "Customer provided keys must provide an appropriate "
                "secret key.",
            )
        if not md5_b64:
            raise S3Error(
                "InvalidArgument",
                "Requests specifying Server Side Encryption with "
                "Customer provided keys must provide the client "
                "calculated MD5 of the secret key.",
            )
        try:
            key = base64.b64decode(key_b64, validate=True)
        except ValueError:
            raise S3Error(
                "InvalidArgument", "The secret key was invalid."
            ) from None
        if len(key) != 32:
            raise S3Error(
                "InvalidArgument",
                "The secret key was invalid for the specified "
                "algorithm.",
            )
        if ssemod.key_md5_b64(key) != md5_b64:
            raise S3Error(
                "InvalidArgument",
                "The calculated MD5 hash of the key did not match "
                "the hash that was provided.",
            )
        return ssemod.SSESpec("C", key)

    def _request_sse(self, bucket: str):
        """Encryption intent of a write (PUT/copy-dest/initiate-
        multipart): explicit SSE-C or SSE-S3 headers, else the bucket's
        default encryption config.  SSE-KMS requests return
        NotImplemented exactly like the reference
        (object-handlers.go:102)."""
        spec = self._parse_ssec_headers(
            "x-amz-server-side-encryption-customer"
        )
        algo = self.headers.get("x-amz-server-side-encryption")
        if spec is not None:
            if algo:
                raise S3Error(
                    "InvalidRequest",
                    "SSE-C and SSE-S3 headers are mutually exclusive",
                )
            return spec
        if algo is not None:
            if algo == "aws:kms":
                raise S3Error("NotImplemented", "SSE-KMS")
            if algo != "AES256":
                raise S3Error(
                    "InvalidRequest",
                    "The encryption method specified is not supported",
                )
            if not ssemod.sse_s3_available():
                raise S3Error(
                    "InvalidArgument",
                    "Server side encryption specified but KMS is not "
                    "configured",
                )
            return ssemod.SSESpec("S3")
        # bucket-default SSE (PutBucketEncryption config): applied when
        # the request itself is silent (validateAndGetSSE)
        try:
            raw = self.s3.bucket_meta.get(bucket).sse_config_xml
        except Exception:  # noqa: BLE001 - missing bucket: no default
            raw = ""
        if raw and self._default_sse_algo(raw) == "AES256":
            if not ssemod.sse_s3_available():
                # the bucket DEMANDS encryption: storing plaintext
                # because the KMS went away would silently violate it
                raise S3Error(
                    "InvalidArgument",
                    "Bucket default encryption is configured but KMS "
                    "is not configured",
                )
            return ssemod.SSESpec("S3")
        return None

    @staticmethod
    def _default_sse_algo(raw: str) -> str:
        """SSEAlgorithm of the bucket's default-encryption rule (parsed,
        not substring-matched)."""
        try:
            root = ET.fromstring(raw)
        except ET.ParseError:
            return ""
        for el in root.iter():
            if el.tag.split("}")[-1] == "SSEAlgorithm":
                return (el.text or "").strip()
        return ""

    def _copy_source_info_and_sse(self, src_bucket, src_key):
        """(src_info, source read-spec) for copy operations."""
        info = self.s3.object_layer.get_object_info(src_bucket, src_key)
        return info, self._read_sse(info, copy_source=True)

    def _read_info_and_sse(self, ol, bucket, key, version_id):
        """(info, read-spec) for a GET/HEAD, checked before any header
        goes out."""
        info = ol.get_object_info(bucket, key, version_id)
        return info, self._read_sse(info)

    def _read_sse(self, info, copy_source: bool = False):
        """Spec needed to READ ``info``; enforces that SSE-C objects are
        fetched with their key and non-SSE-C objects without one
        (getEncryptedObject guards, cmd/encryption-v1.go)."""
        prefix = (
            "x-amz-copy-source-server-side-encryption-customer"
            if copy_source
            else "x-amz-server-side-encryption-customer"
        )
        spec = self._parse_ssec_headers(prefix)
        mode = (info.user_defined or {}).get(ssemod.META_SSE)
        if mode == "C" and spec is None:
            raise S3Error(
                "InvalidRequest",
                "The object was stored using a form of Server Side "
                "Encryption. The correct parameters must be provided "
                "to retrieve the object.",
            )
        if mode != "C" and spec is not None:
            raise S3Error(
                "InvalidRequest",
                "Encryption parameters were provided but the object "
                "is not encrypted with a customer key",
            )
        if mode == "C" and ssemod.key_md5_b64(spec.key) != (
            info.user_defined.get(ssemod.META_SSE_KEY_MD5)
        ):
            # wrong key, detected BEFORE headers go out - a mid-stream
            # decrypt failure can only abort the connection
            raise S3Error(
                "AccessDenied",
                "The provided encryption key does not match the key "
                "used to encrypt the object",
            )
        return spec if mode == "C" else None

    @staticmethod
    def _sse_response_headers(meta: dict) -> dict:
        mode = (meta or {}).get(ssemod.META_SSE)
        if mode == "C":
            return {
                "x-amz-server-side-encryption-customer-algorithm":
                    "AES256",
                "x-amz-server-side-encryption-customer-key-MD5":
                    meta.get(ssemod.META_SSE_KEY_MD5, ""),
            }
        if mode == "S3":
            return {"x-amz-server-side-encryption": "AES256"}
        return {}

    def _delete_object(self, bucket, key, query):
        version_id = query.get("versionId", [""])[0]
        versioned, suspended = self._versioning(bucket)
        # WORM: deleting a concrete version (or unversioned data) is
        # subject to retention/legal hold; writing a delete marker on a
        # versioned bucket is always allowed (bucket-object-lock.go:83)
        if version_id or not (versioned or suspended):
            self._enforce_worm(bucket, key, version_id)
        hdrs: dict = {}
        try:
            info = self.s3.object_layer.delete_object(
                bucket, key, version_id,
                versioned=versioned, version_suspended=suspended,
            )
            if info.delete_marker:
                hdrs["x-amz-delete-marker"] = "true"
            if info.version_id:
                hdrs["x-amz-version-id"] = info.version_id
            from ..event.event import EventName

            self._notify(
                EventName.OBJECT_REMOVED_DELETE_MARKER
                if info.delete_marker
                else EventName.OBJECT_REMOVED_DELETE,
                bucket, key, version_id=info.version_id,
            )
        except Exception as e:  # noqa: BLE001
            err = s3errors.from_exception(e)
            # deleting what is already gone is success (idempotent, and
            # consistent with the multi-delete path)
            if err.code not in ("NoSuchKey", "NoSuchVersion"):
                raise
        self._respond(204, b"", hdrs)

    # -- copy (CopyObjectHandler, object-handlers.go) ----------------------

    def _copy_object(self, bucket, key):
        src_bucket, src_key = self._parse_copy_source()
        directive = self.headers.get(
            "x-amz-metadata-directive", "COPY"
        )
        if (src_bucket, src_key) == (bucket, key) and directive != "REPLACE":
            # S3: copying onto itself without changing metadata is
            # rejected (CopyObjectHandler)
            raise S3Error(
                "InvalidRequest",
                "self-copy requires x-amz-metadata-directive: REPLACE",
            )
        # destination-bucket lock defaults / explicit lock headers and
        # REPLACE-directive tags stamp the new version
        lock_tag = self._put_lock_and_tag_meta(bucket, key)
        # decrypt with the copy-source key, re-encrypt under the
        # destination's regime (request headers or bucket default)
        src_info, sse_src = self._copy_source_info_and_sse(
            src_bucket, src_key
        )
        sse_dst = self._request_sse(bucket)
        # quota + replication apply to copies exactly like PUTs
        quotamod.enforce_put(self.s3, bucket, src_info.size)
        replicate = self.s3.replication.should_replicate(bucket, key)
        if replicate:
            lock_tag = {**lock_tag, META_REPLICATION_STATUS: "PENDING"}
        meta = (
            self._collect_user_metadata()
            if directive == "REPLACE"
            else None
        )
        if meta is not None:
            meta.update(lock_tag)
        versioned, _ = self._versioning(bucket)
        info = self.s3.object_layer.copy_object(
            src_bucket, src_key, bucket, key, meta,
            versioned=versioned, sse_src=sse_src, sse=sse_dst,
        )
        if meta is None and lock_tag:
            # COPY directive keeps source metadata; lock/replication
            # stamps still apply to the fresh destination version
            self.s3.object_layer.update_object_meta(
                bucket, key, lock_tag, info.version_id
            )
        if replicate:
            self.s3.replication.queue(bucket, key, info.version_id)
        hdrs = (
            {"x-amz-version-id": info.version_id}
            if info.version_id
            else None
        )
        from ..event.event import EventName

        self._notify(
            EventName.OBJECT_CREATED_COPY, bucket, key,
            info.etag, info.size, info.version_id,
        )
        self._respond(
            200, xmlr.copy_object_xml(info.etag, info.mod_time_ns), hdrs
        )

    # -- multipart (object-handlers.go multipart handlers) ----------------

    def _initiate_multipart(self, bucket, key):
        # lock headers and tagging ride an initiate as they ride a PUT
        # (checkPutObjectLockAllowed in NewMultipartUploadHandler), and
        # so does replication; SSE is sealed once per upload and the
        # object layer decides compression once per upload
        meta = self._collect_user_metadata()
        meta.update(self._put_lock_and_tag_meta(bucket, key))
        if self.s3.replication.should_replicate(bucket, key):
            meta[META_REPLICATION_STATUS] = "PENDING"
        sse = self._request_sse(bucket)
        uid = self.s3.object_layer.new_multipart_upload(
            bucket, key, meta, sse
        )
        hdrs = {}
        if sse is not None:
            hdrs = (
                {
                    "x-amz-server-side-encryption-customer-algorithm":
                        "AES256",
                    "x-amz-server-side-encryption-customer-key-MD5":
                        ssemod.key_md5_b64(sse.key),
                }
                if sse.mode == "C"
                else {"x-amz-server-side-encryption": "AES256"}
            )
        self._respond(
            200, xmlr.initiate_multipart_xml(bucket, key, uid), hdrs
        )

    def _part_number(self, query) -> int:
        try:
            return int(query["partNumber"][0])
        except (KeyError, ValueError):
            raise S3Error("InvalidArgument", "partNumber") from None

    def _put_part(self, bucket, key, query):
        if "x-amz-copy-source" in self.headers:
            return self._upload_part_copy(bucket, key, query)
        uid = query["uploadId"][0]
        pnum = self._part_number(query)
        reader, size = self._open_body()
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        quotamod.enforce_put(self.s3, bucket, size)
        hreader = self._hash_reader(reader, size)
        # SSE-C uploads must present the key on every part
        # (PutObjectPartHandler re-derives the seal per part)
        part_sse = self._parse_ssec_headers(
            "x-amz-server-side-encryption-customer"
        )
        pi = self.s3.object_layer.put_object_part(
            bucket, key, uid, pnum, hreader, size, part_sse
        )
        self._respond(200, b"", {"ETag": f'"{pi.etag}"'})

    def _upload_part_copy(self, bucket, key, query):
        """UploadPartCopy (CopyObjectPartHandler,
        object-handlers.go:795): stream a source object (or byte range
        of it) in as one part - decrypt with the copy-source key,
        re-encrypt under the upload's regime."""
        from ..utils.pipe import streaming_copy

        uid = query["uploadId"][0]
        pnum = self._part_number(query)
        src_bucket, src_key = self._parse_copy_source()
        ol = self.s3.object_layer
        src_info, sse_src = self._copy_source_info_and_sse(
            src_bucket, src_key
        )
        part_sse = self._parse_ssec_headers(
            "x-amz-server-side-encryption-customer"
        )
        offset, length = 0, -1
        rng = self.headers.get("x-amz-copy-source-range")
        if rng:
            # strict "bytes=a-b" (ErrInvalidCopyPartRange): open-ended
            # and suffix forms are NOT valid here, unlike GET ranges
            m = re.fullmatch(r"bytes=(\d+)-(\d+)", rng.strip())
            if not m:
                raise S3Error(
                    "InvalidArgument",
                    "The x-amz-copy-source-range value must be of the "
                    "form bytes=first-last where first and last are "
                    "the zero-based offsets of the first and last "
                    "bytes to copy",
                )
            lo, hi = int(m.group(1)), int(m.group(2))
            if lo > hi or hi >= src_info.size:
                raise S3Error(
                    "InvalidArgument",
                    f"Range specified is not valid for source object "
                    f"of size: {src_info.size}",
                )
            offset, length = lo, hi - lo + 1
        size = length if length >= 0 else src_info.size
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        quotamod.enforce_put(self.s3, bucket, size)
        # the source decodes in a reader thread into a bounded pipe
        # while this thread encodes the part from it
        pi = streaming_copy(
            lambda sink: ol.get_object(
                src_bucket, src_key, sink, offset, length, "", sse_src
            ),
            lambda source: ol.put_object_part(
                bucket, key, uid, pnum,
                HashReader(source, size), size, part_sse,
            ),
        )
        self._respond(
            200, xmlr.copy_part_xml(pi.etag, pi.mod_time_ns)
        )

    def _complete_multipart(self, bucket, key, query, body):
        uid = query["uploadId"][0]
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
        parts = []
        for pe in root.findall(f"{ns}Part"):
            parts.append(
                CompletePart(
                    int(pe.findtext(f"{ns}PartNumber")),
                    (pe.findtext(f"{ns}ETag") or "").strip('"'),
                )
            )
        versioned, _ = self._versioning(bucket)
        info = self.s3.object_layer.complete_multipart_upload(
            bucket, key, uid, parts, versioned=versioned
        )
        if self.s3.replication.should_replicate(bucket, key):
            self.s3.replication.queue(bucket, key, info.version_id)
        from ..event.event import EventName

        self._notify(
            EventName.OBJECT_CREATED_COMPLETE_MULTIPART, bucket, key,
            info.etag, info.size, info.version_id,
        )
        hdrs = (
            {"x-amz-version-id": info.version_id}
            if info.version_id
            else None
        )
        self._respond(
            200,
            xmlr.complete_multipart_xml(
                f"{self.s3.endpoint}/{bucket}/{key}",
                bucket,
                key,
                info.etag,
            ),
            hdrs,
        )

    def _abort_multipart(self, bucket, key, query):
        uid = query["uploadId"][0]
        self.s3.object_layer.abort_multipart_upload(bucket, key, uid)
        self._respond(204)

    def _list_parts(self, bucket, key, query):
        uid = query["uploadId"][0]
        parts = self.s3.object_layer.list_object_parts(bucket, key, uid)
        self._respond(
            200, xmlr.list_parts_xml(bucket, key, uid, parts)
        )

    def _list_uploads(self, bucket, query):
        prefix = query.get("prefix", [""])[0]
        ups = self.s3.object_layer.list_multipart_uploads(bucket, prefix)
        self._respond(200, xmlr.list_uploads_xml(bucket, ups))


def _parse_multipart_form(
    body: bytes, boundary: str
) -> "tuple[dict[str, str], bytes, str]":
    """Parse a multipart/form-data body into (fields, file_bytes, filename).

    Field names are lower-cased; only the "file" part keeps raw bytes.
    """
    delim = b"--" + boundary.encode()
    fields: dict[str, str] = {}
    file_data, file_name = b"", ""
    for part in body.split(delim)[1:]:
        if part in (b"--", b"--\r\n") or part.startswith(b"--"):
            break
        part = part.lstrip(b"\r\n")
        head, sep, data = part.partition(b"\r\n\r\n")
        if not sep:
            raise S3Error("MalformedPOSTRequest", "bad form part")
        data = data[:-2] if data.endswith(b"\r\n") else data
        name, fname, ctype = "", "", ""
        for line in head.split(b"\r\n"):
            hname, _, hval = line.decode("latin-1").partition(":")
            hname = hname.strip().lower()
            hval = hval.strip()
            if hname == "content-disposition":
                for piece in hval.split(";")[1:]:
                    pk, _, pv = piece.strip().partition("=")
                    pv = pv.strip('"')
                    if pk == "name":
                        name = pv
                    elif pk == "filename":
                        fname = pv
            elif hname == "content-type":
                ctype = hval
        if name.lower() == "file":
            file_data, file_name = data, fname
            if ctype and "content-type" not in fields:
                fields["content-type"] = ctype
        elif name:
            fields[name.lower()] = data.decode("utf-8", "replace")
    return fields, file_data, file_name
