"""minio_tpu_torch.cache - tiered read cache for hot encoded groups.

Process-wide singleton gated by MINIO_TPU_READ_CACHE, resolved as the
JAX package resolves it (``minio_tpu/cache/__init__.py``):

* ``off``  (the default, and every value it does not name) - GETs take
  exactly the quorum-read path; the bisection oracle for every cache
  bug.
* ``host``   - single host-RAM tier.
* ``device`` - device hot tier + host second tier.  The hot tier lives
  on the device of the object layer that creates the cache (its codec
  backend's: the card in the server, the CPU where a caller asks for
  it); a failed copy onto it raises rather than landing on the host.
* ``auto``   - ``device`` when ``torch.cuda.is_available()``, ``host``
  otherwise.

Budget knobs: MINIO_TPU_READ_CACHE_MB (host tier, default 64),
MINIO_TPU_READ_CACHE_DEVICE_MB (device tier, default 64, additionally
bounded by the shared DeviceBudget it splits with the parity plane and
the codec staging, MINIO_TPU_DEVICE_BUDGET_MB).

Coherence: the object layer calls ``invalidate_object`` on every
mutation; ``set_broadcast`` registers the fan-out of the peer plane
(cluster/peer.py ``PeerNotifier.read_cache_invalidated``, registered by
the server main when the layout has peers; ``invalidate_local`` is the
remote-called twin that must NOT re-broadcast).

Once a broadcast is registered the FileInfo side-car is off
(``sidecar_enabled``): the object layer then reads ``xl.meta`` by
quorum on every GET.  The side-car has no TTL and the fan-out is
fire-and-forget, so a PUT acknowledged on another node (its dsync lock
released) may not yet have dropped this node's entry; a side-car hit
would then name the overwritten ``data_dir`` and serve the old body.
The quorum read names the new one, and the cached groups, keyed by
``data_dir``, miss.  A single node keeps the side-car: there the
namespace lock orders every store against the mutation's invalidate.
"""

from __future__ import annotations

import os
import threading

from ..utils.log import kv, logger
from .admission import AdmissionFilter, FrequencySketch
from .allocator import DeviceBudget, device_budget, reset_device_budget
from .tiered import ReadCacheContext, TieredReadCache, TIERS

__all__ = [
    "AdmissionFilter",
    "FrequencySketch",
    "DeviceBudget",
    "device_budget",
    "reset_device_budget",
    "ReadCacheContext",
    "TieredReadCache",
    "TIERS",
    "cache_mode",
    "read_cache",
    "reset_read_cache",
    "context_for",
    "invalidate_object",
    "invalidate_local",
    "set_broadcast",
    "sidecar_enabled",
    "seed_heat",
    "read_cache_stats",
    "clear_read_cache",
]

_log = logger("cache")

_lock = threading.Lock()
_CACHE: "TieredReadCache | None" = None
_MODE: "str | None" = None
_BROADCAST = None  # fn(bucket, object_name) -> None


def _env_mb(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


def cache_mode() -> str:
    """Resolved mode: off | host | device (``auto`` resolves here)."""
    raw = os.environ.get("MINIO_TPU_READ_CACHE", "off").strip().lower()
    if raw in ("off", "host", "device"):
        return raw
    if raw == "auto":
        import torch

        return "device" if torch.cuda.is_available() else "host"
    return "off"


def read_cache(device=None) -> "TieredReadCache | None":
    """The process singleton, or None when the mode is off.  The call
    that creates it places the device tier on ``device`` (the card when
    None); later calls return it as it is."""
    global _CACHE, _MODE
    with _lock:
        if _MODE is None:
            _MODE = cache_mode()
            if _MODE != "off":
                _CACHE = TieredReadCache(
                    mode=_MODE,
                    host_capacity=_env_mb("MINIO_TPU_READ_CACHE_MB", 64)
                    << 20,
                    device_capacity=_env_mb(
                        "MINIO_TPU_READ_CACHE_DEVICE_MB", 64
                    )
                    << 20,
                    budget=device_budget() if _MODE == "device" else None,
                    device=device if device is not None else "cuda",
                )
        return _CACHE


def reset_read_cache() -> None:
    """Drop the singleton so the next call re-reads the environment
    (mirrors codec.backend.reset_backend)."""
    global _CACHE, _MODE
    with _lock:
        _CACHE = None
        _MODE = None


def context_for(
    bucket: str, object_name: str, data_dir: str, part: int, device=None
) -> "ReadCacheContext | None":
    c = read_cache(device)
    if c is None:
        return None
    return ReadCacheContext(c, bucket, object_name, data_dir, part)


def set_broadcast(fn) -> None:
    """Register the cross-node fan-out (a peer plane's hook); None
    unregisters it."""
    global _BROADCAST
    _BROADCAST = fn


def sidecar_enabled() -> bool:
    """True while no cross-node broadcast is registered: only a single
    node may answer a GET's FileInfo from the side-car."""
    return _BROADCAST is None


def invalidate_object(bucket: str, object_name: str) -> int:
    """Mutation seam: drop local cached groups AND tell every peer.
    Called on PUT/overwrite/heal/delete before the caller acks."""
    n = invalidate_local(bucket, object_name)
    fn = _BROADCAST
    if fn is not None:
        try:
            fn(bucket, object_name)
        except Exception as exc:  # noqa: BLE001 - fan-out is fire-and-forget
            _log.debug("invalidate broadcast failed", extra=kv(err=str(exc)))
    return n


def invalidate_local(bucket: str, object_name: str) -> int:
    """Peer-RPC twin of invalidate_object: never re-broadcasts."""
    c = _CACHE
    if c is None:
        return 0
    return c.invalidate(bucket, object_name)


def clear_read_cache() -> int:
    """Admin aid: drop every cached group (keeps admission history).
    Returns the number of entries dropped."""
    c = _CACHE
    if c is None:
        return 0
    return c.clear()


def seed_heat(bucket: str, object_name: str, hits: int = 2) -> None:
    """Crawler heat: pre-credit an object's admission frequency."""
    c = read_cache()
    if c is not None:
        c.admission.seed(f"{bucket}/{object_name}", hits=hits)


def _zero_stats() -> dict:
    tiers = {
        t: {
            "hits": 0, "misses": 0, "evictions": 0, "rejects": 0,
            "entries": 0, "occupancy_bytes": 0, "capacity_bytes": 0,
        }
        for t in TIERS
    }
    return {
        "mode": "off",
        "tiers": tiers,
        "demotions": 0,
        "invalidations": 0,
        "verify_drops": 0,
        "admission": {
            "recorded": 0, "seeded": 0, "admitted": 0, "rejected": 0,
            "sketch_ages": 0,
        },
    }


def read_cache_stats() -> dict:
    """Zero-filled when the cache is off/unused, so metrics and
    healthinfo render identical shapes in every mode."""
    c = _CACHE
    if c is None:
        return _zero_stats()
    return c.stats()
