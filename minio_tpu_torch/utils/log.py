"""Structured logging helpers (cmd/logger analogue).

Loggers live under the ``minio_tpu_torch`` namespace; fields ride on the
record as ``record.fields`` (``log.info("msg", extra=kv(bucket=b))``).
``setup`` installs the server's handler: one JSON line per event,
``{"ts": ..., "level": ..., "name": ..., "msg": ..., **fields}``, or
plain text with MINIO_TPU_LOG=console (cmd/logger/logger.go:301-389).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys

_CONFIGURED = False


class _JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": datetime.datetime.fromtimestamp(
                record.created, tz=datetime.timezone.utc
            ).isoformat(timespec="milliseconds"),
            "level": record.levelname.lower(),
            "name": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            doc.update(extra)
        if record.exc_info and record.exc_info[0] is not None:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def setup(level: str = "info") -> None:
    """Install the process-wide handler (idempotent)."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True
    root = logging.getLogger("minio_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    h = logging.StreamHandler(sys.stdout)
    if os.environ.get("MINIO_TPU_LOG", "json") == "console":
        h.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
    else:
        h.setFormatter(_JSONFormatter())
    root.addHandler(h)
    root.propagate = False


def logger(name: str) -> logging.Logger:
    return logging.getLogger(f"minio_tpu_torch.{name}")


def kv(**fields) -> dict:
    """Attach structured fields: log.info("msg", extra=kv(bucket=b))."""
    return {"fields": fields}
