"""Structured logging helpers (cmd/logger analogue).

Loggers live under the ``minio_tpu_torch`` namespace; fields ride on the
record as ``record.fields`` (``log.info("msg", extra=kv(bucket=b))``),
the shape the JSON handler of the S3 front (a later slice) emits.
"""

from __future__ import annotations

import logging


def logger(name: str) -> logging.Logger:
    return logging.getLogger(f"minio_tpu_torch.{name}")


def kv(**fields) -> dict:
    """Attach structured fields: log.info("msg", extra=kv(bucket=b))."""
    return {"fields": fields}
