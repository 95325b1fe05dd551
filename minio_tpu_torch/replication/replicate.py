"""Async bucket replication engine (cmd/bucket-replication.go +
crawler catch-up at data-crawler.go:756 healReplication).

Objects PUT into a bucket with a replication config are stamped
``x-amz-replication-status: PENDING`` and queued; a worker copies them
to the rule's destination and flips the status to COMPLETED (or FAILED,
which the crawler's catch-up pass re-queues).  Destinations resolve
through a target registry: the destination bucket name maps either to a
bucket on this same cluster (LocalTarget) or to a remote S3 endpoint
(HTTPTarget, SigV4-signed PUTs over the wire).
"""

from __future__ import annotations

import hashlib
import http.client
import queue
import threading
import urllib.parse

from .config import ReplicationConfig, ReplicationError

from ..utils.log import kv, logger

_log = logger("replication")

META_REPLICATION_STATUS = "x-amz-replication-status"

# object metadata that must not be copied onto the destination object
_INTERNAL_META = (
    "etag",
    META_REPLICATION_STATUS,
    "x-internal-compression",
    "x-internal-actual-size",
)


def _clean_meta(meta: dict) -> dict:
    return {
        k: v
        for k, v in meta.items()
        if k not in _INTERNAL_META and not k.startswith("x-internal-sse")
    }


class LocalTarget:
    """Destination bucket on this same cluster (in-cluster tiering)."""

    def __init__(self, object_layer, bucket: str):
        self._ol = object_layer
        self.bucket = bucket

    def put(self, key: str, reader, size: int, metadata: dict) -> None:
        self._ol.get_bucket_info(self.bucket)  # must exist
        self._ol.put_object(
            self.bucket, key, reader, size, _clean_meta(metadata)
        )


class HTTPTarget:
    """Remote S3 endpoint target (bucket-targets.go TargetClient):
    SigV4-signed PUTs straight over http.client - no SDK in-image."""

    def __init__(
        self,
        endpoint: str,
        access_key: str,
        secret_key: str,
        bucket: str,
        region: str = "us-east-1",
        timeout: float = 30.0,
    ):
        parsed = urllib.parse.urlsplit(endpoint)
        self.host = parsed.hostname or ""
        self.tls = parsed.scheme == "https"
        self.port = parsed.port or (443 if self.tls else 80)
        self.access_key = access_key
        self.secret_key = secret_key
        self.bucket = bucket
        self.region = region
        self.timeout = timeout

    def put(self, key: str, reader, size: int, metadata: dict) -> None:
        import datetime

        from ..server import auth as authmod

        path = f"/{self.bucket}/{key}"
        amz_date = datetime.datetime.now(
            datetime.timezone.utc
        ).strftime("%Y%m%dT%H%M%SZ")
        # hash pass over the (seekable) spool, then rewind to send -
        # the object is never held in memory whole
        h = hashlib.sha256()
        while True:
            chunk = reader.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
        phash = h.hexdigest()
        reader.seek(0)
        headers = {
            "host": f"{self.host}:{self.port}",
            "x-amz-date": amz_date,
            "x-amz-content-sha256": phash,
            "content-length": str(size),
        }
        for k, v in _clean_meta(metadata).items():
            if k.startswith("x-amz-meta-") or k == "content-type":
                headers[k] = v
        signed = sorted(k for k in headers if k != "content-length")
        sig = authmod.sign_v4(
            "PUT", path, {}, headers, signed, phash,
            self.access_key, self.secret_key, amz_date, self.region,
        )
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["authorization"] = (
            f"{authmod.SIGN_V4_ALGORITHM} "
            f"Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"
        )
        if self.tls:
            import ssl

            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=ssl.create_default_context(),
            )
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
        try:
            conn.putrequest(
                "PUT", urllib.parse.quote(path),
                skip_host=True, skip_accept_encoding=True,
            )
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
            while True:
                chunk = reader.read(1 << 20)
                if not chunk:
                    break
                conn.send(chunk)
            resp = conn.getresponse()
            resp.read()
            if resp.status not in (200, 204):
                raise OSError(
                    f"replication target HTTP {resp.status}"
                )
        finally:
            conn.close()


class ReplicationPool:
    """Queue + worker copying matched objects to their destinations
    (the replicateObject goroutine pool)."""

    def __init__(self, server, workers: int = 2):
        self.s3 = server
        self._q: "queue.Queue[tuple[str, str, str] | None]" = queue.Queue()
        # bucket -> explicit target (from the admin remote-target
        # registry); default is a LocalTarget on the rule's bucket name
        self.targets: "dict[str, object]" = {}
        # bucket -> (raw_xml, parsed ReplicationConfig)
        self._cfg_cache: "dict[str, tuple[str, object]]" = {}
        self._threads = [
            threading.Thread(
                target=self._work, name=f"replicate-{i}", daemon=True
            )
            for i in range(workers)
        ]
        self._started = False

    def start(self) -> "ReplicationPool":
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def stop(self) -> None:
        for _ in self._threads:
            self._q.put(None)

    def drain(self, timeout: float = 30.0) -> None:
        """Testing aid: block until every queued item is PROCESSED
        (queue emptiness alone races the in-flight copy)."""
        t = threading.Thread(target=self._q.join, daemon=True)
        t.start()
        t.join(timeout)

    # -- enqueue side -----------------------------------------------------

    def config_for(self, bucket: str) -> "ReplicationConfig | None":
        try:
            raw = self.s3.bucket_meta.get(bucket).replication_xml
        except Exception:  # noqa: BLE001
            return None
        if not raw:
            return None
        # parse once per document: PUT ingress checks this per request
        cached = self._cfg_cache.get(bucket)
        if cached is not None and cached[0] == raw:
            return cached[1]
        try:
            cfg = ReplicationConfig.from_xml(raw.encode())
        except ReplicationError:
            return None
        self._cfg_cache[bucket] = (raw, cfg)
        return cfg

    def should_replicate(self, bucket: str, key: str) -> bool:
        cfg = self.config_for(bucket)
        return cfg is not None and cfg.rule_for(key) is not None

    def queue(self, bucket: str, key: str, version_id: str = "") -> None:
        if self._started:
            self._q.put((bucket, key, version_id))

    # -- worker side ------------------------------------------------------

    def _target_for(self, bucket: str, rule) -> object:
        t = self.targets.get(bucket)
        if t is not None:
            return t
        # admin-registered remote targets persist in bucket metadata
        import json

        try:
            raw = self.s3.bucket_meta.get(bucket).replication_targets_json
        except Exception:  # noqa: BLE001
            raw = ""
        if raw:
            try:
                docs = json.loads(raw)
            except ValueError:
                docs = []
            match = next(
                (
                    d
                    for d in docs
                    if d.get("target_bucket") == rule.target_bucket
                ),
                docs[0] if docs else None,
            )
            if match is not None:
                return HTTPTarget(
                    match["endpoint"],
                    match["access_key"],
                    match["secret_key"],
                    match.get("target_bucket", rule.target_bucket),
                    match.get("region", "us-east-1"),
                )
        return LocalTarget(self.s3.object_layer, rule.target_bucket)

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            bucket, key, version_id = item
            try:
                self._replicate_one(bucket, key, version_id)
            except Exception as e:  # noqa: BLE001 - status stays FAILED
                from ..utils import log

                log.logger("replication").warning(
                    "replicate failed",
                    extra=log.kv(
                        bucket=bucket, key=key,
                        error=f"{type(e).__name__}: {e}",
                    ),
                )
            finally:
                self._q.task_done()

    def _replicate_one(self, bucket, key, version_id) -> None:
        ol = self.s3.object_layer
        cfg = self.config_for(bucket)
        rule = cfg.rule_for(key) if cfg else None
        if rule is None:
            return
        info = ol.get_object_info(bucket, key, version_id)
        status = "COMPLETED"
        try:
            # spool through memory up to 16 MiB, disk beyond - a
            # multi-GB object must not live in worker RAM
            import tempfile

            with tempfile.SpooledTemporaryFile(max_size=16 << 20) as sp:
                ol.get_object(bucket, key, sp, version_id=version_id)
                size = sp.tell()
                sp.seek(0)
                self._target_for(bucket, rule).put(
                    key, sp, size, dict(info.user_defined)
                )
        except Exception:  # noqa: BLE001
            status = "FAILED"
        try:
            ol.update_object_meta(
                bucket, key, {META_REPLICATION_STATUS: status},
                info.version_id,
            )
        except Exception as exc:
            _log.debug("replication status meta update failed", extra=kv(err=str(exc)))

