"""Notification targets (pkg/event/target).

The port carries no notification targets yet: the webhook, log-file,
Redis and NATS targets and their queue store come in slice 9c.  The
environment still configures them the reference way
(``MINIO_TPU_NOTIFY_<KIND>_ENABLE_<ID>=on``), so a configured target
raises instead of being silently dropped.
"""

from __future__ import annotations

import os


def configured_targets(environ=None) -> "list[str]":
    """Names of the ``MINIO_TPU_NOTIFY_*_ENABLE_*=on`` variables."""
    env = os.environ if environ is None else environ
    return sorted(
        key
        for key, val in env.items()
        if key.startswith("MINIO_TPU_NOTIFY_")
        and "_ENABLE_" in key
        and val == "on"
    )


def targets_from_env(environ=None) -> "list":
    """The target list from MINIO_TPU_NOTIFY_* variables: empty, or
    NotImplementedError naming slice 9c for a configured target."""
    names = configured_targets(environ)
    if names:
        raise NotImplementedError(
            f"event notification targets ({', '.join(names)}) are not "
            "ported to minio_tpu_torch yet (slice 9c)"
        )
    return []
