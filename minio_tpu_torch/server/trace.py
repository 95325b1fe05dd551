"""HTTP tracing + audit logging + console-log capture
(cmd/http-tracer.go:99 Trace, cmd/logger/audit.go:129 AuditLog,
cmd/consolelogger.go).

Every S3/admin request produces a TraceInfo published to the node's
trace PubSub AND appended to a sequence-numbered ring buffer - the
ring is what peers poll (`tracebuf?since=N`) so `admin trace` streams
cluster-wide without holding a connection per peer.  The audit log is
an independent JSON-lines sink (file via MINIO_TPU_AUDIT_LOG_FILE).
Console capture attaches a logging.Handler feeding the same ring
mechanism for `admin console`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from ..utils.pubsub import PubSub

RING_MAX = 4096


class SeqRing:
    """Sequence-numbered ring buffer; readers poll with `since`.

    Sequences are contiguous (each append is +1), so a reader's cursor
    maps to a buffer offset arithmetically: `since` is O(returned)
    rather than a full-ring scan - peers polling `tracebuf?since=N`
    were rescanning all 4096 entries per poll per peer.
    """

    def __init__(self, maxlen: int = RING_MAX):
        self._mu = threading.Lock()
        self._maxlen = maxlen
        self._buf: list = []
        self._head = 0  # index of the OLDEST retained item once full
        self._seq = 0

    def append(self, item: dict) -> int:
        with self._mu:
            self._seq += 1
            if len(self._buf) < self._maxlen:
                self._buf.append(item)
            else:
                self._buf[self._head] = item
                self._head = (self._head + 1) % self._maxlen
            return self._seq

    def since(self, seq: int, limit: int = 1000) -> "tuple[int, list]":
        """Entries with sequence > seq -> (cursor, items).  The cursor
        is the sequence of the LAST RETURNED item - when `limit`
        truncates, the remainder is picked up by the next poll rather
        than silently skipped."""
        with self._mu:
            n = len(self._buf)
            first = self._seq - n + 1  # seq of the oldest retained item
            start = max(seq + 1, first)
            if n == 0 or start > self._seq:
                return self._seq, []
            count = min(self._seq - start + 1, limit)
            base = self._head + (start - first)
            items = [self._buf[(base + i) % n] for i in range(count)]
            return start + count - 1, items


class Tracer:
    """Per-node trace hub: pubsub for local subscribers + the ring
    peers poll."""

    def __init__(self, node: str = ""):
        self.node = node
        self.pubsub = PubSub()
        self.ring = SeqRing()
        # count ring polls as interest so traced nodes keep recording
        self._last_poll = 0.0

    @property
    def active(self) -> bool:
        return (
            self.pubsub.num_subscribers > 0
            or time.monotonic() - self._last_poll < 10.0
        )

    def publish(self, info: dict) -> None:
        info.setdefault("node", self.node)
        self.pubsub.publish(info)
        self.ring.append(info)

    def poll(self, since: int) -> "tuple[int, list]":
        self._last_poll = time.monotonic()
        return self.ring.since(since)


def trace_info(
    node: str,
    method: str,
    path: str,
    query: str,
    status: int,
    duration_s: float,
    bytes_in: int,
    bytes_out: int,
    client: str,
    api: str,
) -> dict:
    """The pkg/trace.Info DTO shape, trimmed to JSON-friendly fields."""
    return {
        "node": node,
        "time": time.time(),
        "api": api,
        "method": method,
        "path": path,
        "query": query,
        "status": status,
        "duration_ms": round(duration_s * 1e3, 3),
        "rx": bytes_in,
        "tx": bytes_out,
        "client": client,
    }


class AuditLog:
    """Per-request audit entries as JSON lines
    (logger.AuditLog, cmd/logger/audit.go:129)."""

    def __init__(self, path: "str | None" = None):
        self.path = path or os.environ.get(
            "MINIO_TPU_AUDIT_LOG_FILE", ""
        )
        self._mu = threading.Lock()
        # write failures: counted (miniotpu_audit_entries_dropped_total)
        # and warned about once, not silently swallowed
        self.dropped = 0
        self._warned = False

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def log(self, entry: dict) -> None:
        if not self.path:
            return
        entry.setdefault("version", "1")
        entry.setdefault("time", time.time())
        line = json.dumps(entry) + "\n"
        try:
            with self._mu, open(self.path, "a", encoding="utf-8") as f:
                f.write(line)
        except OSError as exc:
            with self._mu:
                self.dropped += 1
                warn = not self._warned
                self._warned = True
            if warn:
                logging.getLogger("minio_tpu_torch.audit").warning(
                    "audit log write failed; entries are being dropped "
                    "(target=%s error=%s) - further drops counted in "
                    "miniotpu_audit_entries_dropped_total",
                    self.path,
                    exc,
                )


class ConsoleCapture(logging.Handler):
    """Ring-buffered capture of this process's structured logs
    (cmd/consolelogger.go HTTPConsoleLoggerSys)."""

    def __init__(self, node: str = ""):
        super().__init__()
        self.node = node
        self.ring = SeqRing()
        # emit() runs inside the logging machinery, so a failure cannot
        # itself be logged (infinite recursion); count it instead
        self.dropped = 0

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.ring.append(
                {
                    "node": self.node,
                    "time": record.created,
                    "level": record.levelname,
                    "name": record.name,
                    "msg": record.getMessage(),
                }
            )
        except Exception:  # logging must never raise; count the drop
            self.dropped += 1

    def install(self) -> "ConsoleCapture":
        # capture attaches at the package logger, not the root
        logging.getLogger("minio_tpu_torch").addHandler(self)
        return self

    def uninstall(self) -> None:
        logging.getLogger("minio_tpu_torch").removeHandler(self)
