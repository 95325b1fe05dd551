"""Notification targets (pkg/event/target/webhook.go et al).

Each target consumes S3 event records.  The webhook target POSTs the
record JSON with a bounded retry-on-reconnect, the log-file target
appends JSON lines (the minio ``notify_webhook`` / audit-log shapes),
and MemoryTarget captures events for tests and the admin trace.

Targets are configured from the environment, mirroring the reference's
``MINIO_NOTIFY_WEBHOOK_ENABLE_<ID>`` convention
(cmd/config/notify/parse.go)::

    MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_PRIMARY=on
    MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_PRIMARY=http://host:port/path

yields a target with ARN ``arn:minio:sqs::PRIMARY:webhook``.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import urllib.parse

from ..utils.log import kv, logger

_log = logger("event")


class TargetError(Exception):
    pass


class WebhookTarget:
    """POST each event record to an HTTP endpoint
    (pkg/event/target/webhook.go:150 send)."""

    def __init__(self, target_id: str, endpoint: str, timeout: float = 5.0):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:webhook"
        self.endpoint = endpoint
        self._timeout = timeout
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise TargetError(f"bad webhook endpoint {endpoint!r}")
        self._host = u.hostname
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._path = u.path or "/"
        if u.query:
            self._path += "?" + u.query
        self._https = u.scheme == "https"
        self._local = threading.local()

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            cls = (
                http.client.HTTPSConnection
                if self._https
                else http.client.HTTPConnection
            )
            c = cls(self._host, self._port, timeout=self._timeout)
            self._local.conn = c
        return c

    def _drop(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception as exc:
                _log.debug("target connection close failed", extra=kv(err=str(exc)))
            self._local.conn = None

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        headers = {
            "Content-Type": "application/json",
            "Content-Length": str(len(body)),
        }
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request("POST", self._path, body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                break
            except (OSError, http.client.HTTPException):
                self._drop()
                if attempt == 1:
                    raise TargetError(
                        f"webhook {self.endpoint} unreachable"
                    ) from None
        if resp.status // 100 != 2:
            raise TargetError(
                f"webhook {self.endpoint}: HTTP {resp.status}"
            )

    def close(self) -> None:
        self._drop()


class LogFileTarget:
    """Append events as JSON lines (an event audit trail; the
    minio ``notify_webhook``-to-file dev pattern)."""

    def __init__(self, target_id: str, path: str):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:logfile"
        self.path = path
        self._mu = threading.Lock()

    def send(self, record: dict) -> None:
        line = json.dumps(record) + "\n"
        with self._mu:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)

    def close(self) -> None:
        pass


class MemoryTarget:
    """In-process capture (tests + admin introspection)."""

    def __init__(self, target_id: str = "memory"):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:memory"
        self.records: "list[dict]" = []
        self._mu = threading.Lock()

    def send(self, record: dict) -> None:
        with self._mu:
            self.records.append(record)

    def close(self) -> None:
        pass


def targets_from_env(environ=None) -> "list":
    """Build the target list from MINIO_TPU_NOTIFY_* variables
    (cmd/config/notify/parse.go GetNotifyWebhook and siblings).

    Any target gains at-least-once disk buffering when
    ``MINIO_TPU_NOTIFY_<KIND>_QUEUE_DIR_<ID>`` is set (the reference's
    per-target queueStore)."""
    env = os.environ if environ is None else environ
    out: list = []
    for key, val in sorted(env.items()):
        if not key.startswith("MINIO_TPU_NOTIFY_") or "_ENABLE_" not in key:
            continue
        if val != "on":
            continue
        prefix, _, tid = key.partition("_ENABLE_")
        kind = prefix[len("MINIO_TPU_NOTIFY_"):]
        target = None
        try:
            if kind == "WEBHOOK":
                ep = env.get(f"MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_{tid}", "")
                if ep:
                    target = WebhookTarget(tid, ep)
            elif kind == "LOGFILE":
                path = env.get(f"MINIO_TPU_NOTIFY_LOGFILE_PATH_{tid}", "")
                if path:
                    target = LogFileTarget(tid, path)
            elif kind == "REDIS":
                from .brokers import RedisTarget

                addr = env.get(f"MINIO_TPU_NOTIFY_REDIS_ADDRESS_{tid}", "")
                if addr:
                    target = RedisTarget(
                        tid, addr,
                        key=env.get(
                            f"MINIO_TPU_NOTIFY_REDIS_KEY_{tid}",
                            "minioevents",
                        ),
                        password=env.get(
                            f"MINIO_TPU_NOTIFY_REDIS_PASSWORD_{tid}", ""
                        ),
                    )
            elif kind == "NATS":
                from .brokers import NATSTarget

                addr = env.get(f"MINIO_TPU_NOTIFY_NATS_ADDRESS_{tid}", "")
                if addr:
                    target = NATSTarget(
                        tid, addr,
                        subject=env.get(
                            f"MINIO_TPU_NOTIFY_NATS_SUBJECT_{tid}",
                            "minioevents",
                        ),
                    )
        except TargetError:
            continue  # malformed config: skip this target
        if target is None:
            continue
        qdir = env.get(f"MINIO_TPU_NOTIFY_{kind}_QUEUE_DIR_{tid}", "")
        if qdir:
            from .queuestore import QueuedTarget

            target = QueuedTarget(target, qdir)
        out.append(target)
    return out
