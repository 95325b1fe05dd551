"""Shared device-memory budget ledger for cache planes.

The parity plane (codec/backend.py ParityPlaneCache) posts its live
device bytes here under the "parity_plane" account.  The account is
advisory for the parity plane (its own capacity knob bounds it); the
read cache's device tier, a later slice, sizes itself against the
combined usage.
"""

from __future__ import annotations

import threading


class DeviceBudget:
    """Thread-safe ledger: account name -> live device bytes."""

    def __init__(self):
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


_BUDGET = DeviceBudget()


def device_budget() -> DeviceBudget:
    """The process-wide ledger."""
    return _BUDGET
