"""The read cache's knob (the cache itself is slice 9a).

``MINIO_TPU_READ_CACHE`` resolves as the JAX package resolves it
(``minio_tpu/cache/__init__.py`` ``cache_mode``): ``off`` (the default,
and every value it does not name), ``host``, ``device``, or ``auto`` -
``device`` when a card is visible, ``host`` otherwise.  This package
serves no cache yet, so a mode other than ``off`` is refused at boot and
by the object layer's PUT and GET, naming the slice, instead of being
ignored.
"""

from __future__ import annotations

import os

READ_CACHE_SLICE = "9a"


def cache_mode() -> str:
    """Resolved mode: off | host | device (``auto`` resolves here)."""
    raw = os.environ.get("MINIO_TPU_READ_CACHE", "off").strip().lower()
    if raw in ("off", "host", "device"):
        return raw
    if raw == "auto":
        import torch

        return "device" if torch.cuda.is_available() else "host"
    return "off"


def refused_read_cache() -> "str | None":
    """What a read cache of this package's environment would serve, as a
    refusal names it, or None when the mode resolves to ``off``."""
    mode = cache_mode()
    if mode == "off":
        return None
    raw = os.environ["MINIO_TPU_READ_CACHE"].strip()
    return f"the read cache (MINIO_TPU_READ_CACHE={raw}, {mode} tier)"
