"""Shared device-memory budget ledger for cache planes.

The parity plane (codec/backend.py ParityPlaneCache), the codec's
staging buffers and the read cache's device hot tier all pin bytes in
device memory.  Each keeps its own eviction policy, but they draw on ONE
budget: the ledger tracks live bytes per account (``parity_plane``,
``codec_staging``, ``read_cache``) so the read cache sizes its effective
device capacity to what the others are not using, instead of each
believing it owns the whole device.

Accounts are advisory for the parity plane and the staging (their own
knobs bound them) and binding for the read cache, which computes its
headroom against the combined total.
"""

from __future__ import annotations

import os
import threading

DEFAULT_BUDGET_MB = 192


class DeviceBudget:
    """Thread-safe ledger: account name -> live device bytes."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._mu = threading.Lock()
        self._usage: dict[str, int] = {}

    def set_usage(self, account: str, nbytes: int) -> None:
        with self._mu:
            if nbytes <= 0:
                self._usage.pop(account, None)
            else:
                self._usage[account] = int(nbytes)

    def usage(self, account: "str | None" = None) -> int:
        with self._mu:
            if account is not None:
                return self._usage.get(account, 0)
            return sum(self._usage.values())

    def headroom(self) -> int:
        """Unclaimed device bytes under the combined budget."""
        return max(0, self.capacity_bytes - self.usage())

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "capacity_bytes": self.capacity_bytes,
                "usage_bytes": sum(self._usage.values()),
                "accounts": dict(self._usage),
            }


_lock = threading.Lock()
_BUDGET: "DeviceBudget | None" = None


def device_budget() -> DeviceBudget:
    """Process-wide ledger; capacity from MINIO_TPU_DEVICE_BUDGET_MB
    (default covers the parity plane default plus a device hot tier)."""
    global _BUDGET
    with _lock:
        if _BUDGET is None:
            try:
                mb = int(
                    os.environ.get(
                        "MINIO_TPU_DEVICE_BUDGET_MB", str(DEFAULT_BUDGET_MB)
                    )
                )
            except ValueError:
                mb = DEFAULT_BUDGET_MB
            _BUDGET = DeviceBudget(max(1, mb) << 20)
        return _BUDGET


def reset_device_budget() -> None:
    """Drop the ledger so the next call re-reads the capacity knob; the
    planes post their live bytes to the new ledger at their next change."""
    global _BUDGET
    with _lock:
        _BUDGET = None
