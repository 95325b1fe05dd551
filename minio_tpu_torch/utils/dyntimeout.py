"""Self-tuning operation timeouts (cmd/dynamic-timeouts.go:42-89).

A DynamicTimeout starts at ``timeout`` and adapts from outcomes: after
every LOG_SIZE logged operations, if more than 33% hit the timeout the
budget grows by 25%; if fewer than 10% did, it shrinks toward the
observed average (with a 25% buffer), never below ``minimum``.
"""

from __future__ import annotations

import threading

LOG_SIZE = 16
INCREASE_THRESHOLD_PCT = 0.33
DECREASE_THRESHOLD_PCT = 0.10
_FAILURE = float("inf")


class DynamicTimeout:
    def __init__(self, timeout_s: float, minimum_s: float):
        if minimum_s <= 0 or timeout_s < minimum_s:
            raise ValueError("need timeout >= minimum > 0")
        self._timeout = timeout_s
        self._minimum = minimum_s
        self._mu = threading.Lock()
        self._log: list[float] = []

    @property
    def timeout(self) -> float:
        with self._mu:
            return self._timeout

    def log_success(self, duration_s: float) -> None:
        self._entry(duration_s)

    def log_failure(self) -> None:
        """The operation hit its timeout."""
        self._entry(_FAILURE)

    def _entry(self, duration_s: float) -> None:
        with self._mu:
            self._log.append(duration_s)
            if len(self._log) < LOG_SIZE:
                return
            entries, self._log = self._log, []
            self._adjust(entries)

    def _adjust(self, entries: list[float]) -> None:
        failures = sum(1 for e in entries if e == _FAILURE)
        successes = [e for e in entries if e != _FAILURE]
        hit_pct = failures / len(entries)
        if hit_pct > INCREASE_THRESHOLD_PCT:
            self._timeout *= 1.25
        elif hit_pct < DECREASE_THRESHOLD_PCT and successes:
            average = (sum(successes) / len(successes)) * 1.25
            self._timeout = max(
                (self._timeout + average) / 2, self._minimum
            )
