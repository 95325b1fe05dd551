"""Per-disk circuit breakers + pool-wide latency deadlines.

The degraded GET path needs two decisions made fast and without
coordination:

* **Should this disk be in the preference order at all?**  Each disk
  gets a ``DiskHealth`` state machine — ``healthy -> suspect ->
  tripped`` — driven by consecutive errors (a dead or flapping disk
  trips after ``MINIO_TPU_BREAKER_TRIP_ERRORS`` failures in a row) and
  by p99-outlier latency (reads far beyond the pool-wide p99, or reads
  abandoned by the hedging loop, accrue *slow strikes* that demote the
  disk to suspect for a decaying window).  Tripped disks are skipped
  everywhere ``_online_disks`` is consulted (GET preference, PUT
  fan-out bookkeeping, heal) and recover through a **half-open window**
  with exponential backoff: after the backoff lapses callers are
  admitted until the first verdict lands — success closes the breaker,
  failure re-trips it with doubled backoff — so a dead disk eats at
  most one concurrent round of probe traffic per backoff period.
* **How long is a shard read allowed to take?**  The registry keeps
  pool-wide streaming read quantiles (``P2Quantile`` from metered.py —
  constant memory); ``hedge_deadline()`` is the clamped multiple of the
  live p99 that ``codec/erasure.py`` races each round of shard reads
  against before launching a duplicate on the next parity shard.

Lock discipline: the registry lock only guards the disk table and the
pool estimators; each ``DiskHealth`` has its own lock and the two are
never nested (MeteredDisk likewise calls in only after releasing its
ledger lock).
"""

from __future__ import annotations

import os
import threading
import time

from ..utils.log import kv, logger
from .metered import P2Quantile

_log = logger("diskhealth")


# states, ordered by preference penalty (sort key in the GET path)
HEALTHY = 0
SUSPECT = 1
TRIPPED = 2
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect", TRIPPED: "tripped"}


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    try:
        v = float(os.environ.get(name) or default)
    except ValueError:
        v = default
    return max(lo, min(hi, v))


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    try:
        v = int(os.environ.get(name) or default)
    except ValueError:
        v = default
    return max(lo, min(hi, v))


class _Config:
    """Env-derived knobs, read once per registry (reset_registry()
    re-reads — tests set the env first, then reset)."""

    __slots__ = (
        "enabled",
        "trip_errors",
        "suspect_errors",
        "backoff_s",
        "backoff_cap_s",
        "outlier_factor",
        "slow_strikes",
        "slow_decay_s",
        "hedge_enabled",
        "hedge_factor",
        "hedge_min_s",
        "hedge_max_s",
    )

    def __init__(self):
        self.enabled = os.environ.get("MINIO_TPU_BREAKER", "1") != "0"
        self.trip_errors = _env_int(
            "MINIO_TPU_BREAKER_TRIP_ERRORS", 5, 1, 1000
        )
        self.suspect_errors = _env_int(
            "MINIO_TPU_BREAKER_SUSPECT_ERRORS", 2, 1, 1000
        )
        self.backoff_s = (
            _env_float("MINIO_TPU_BREAKER_BACKOFF_MS", 1000.0, 1.0, 6e5)
            / 1000.0
        )
        self.backoff_cap_s = 30.0
        self.outlier_factor = _env_float(
            "MINIO_TPU_BREAKER_OUTLIER", 4.0, 1.0, 1e6
        )
        self.slow_strikes = _env_int(
            "MINIO_TPU_BREAKER_SLOW_STRIKES", 2, 1, 1000
        )
        self.slow_decay_s = (
            _env_float("MINIO_TPU_BREAKER_SLOW_DECAY_MS", 2000.0, 1.0, 6e5)
            / 1000.0
        )
        self.hedge_enabled = os.environ.get("MINIO_TPU_HEDGE", "1") != "0"
        self.hedge_factor = _env_float(
            "MINIO_TPU_HEDGE_FACTOR", 3.0, 1.0, 1e3
        )
        self.hedge_min_s = (
            _env_float("MINIO_TPU_HEDGE_MIN_MS", 2.0, 0.01, 1e6) / 1000.0
        )
        self.hedge_max_s = (
            _env_float("MINIO_TPU_HEDGE_MAX_MS", 2000.0, 0.01, 1e7) / 1000.0
        )


class DiskHealth:
    """Circuit breaker for one disk endpoint.

    healthy --errors/slow strikes--> suspect --more errors--> tripped
    tripped --backoff expiry--> single probe --success--> healthy
                                             --failure--> tripped (2x)
    """

    def __init__(self, endpoint: str, cfg: _Config):
        self.endpoint = endpoint
        self._cfg = cfg
        self._mu = threading.Lock()
        self._state = HEALTHY
        self._consec_errors = 0
        self._slow_strikes = 0
        self._slow_until = 0.0
        self._until = 0.0  # trip expiry (monotonic)
        self._backoff_s = cfg.backoff_s
        self._probing = False
        self._probe_t0 = 0.0
        self.trips = 0
        self.recoveries = 0

    # -- admission --------------------------------------------------------

    def admit(self, now: "float | None" = None) -> bool:
        """May the caller touch this disk right now?

        Healthy/suspect disks always admit (suspect only demotes the
        *preference order*, it never blocks — a suspect disk may still
        be the only holder of a needed shard).  A tripped disk flips to
        half-open once its backoff expires and then admits every caller
        until a verdict lands: the first success closes the breaker,
        the first failure re-trips it with doubled backoff.  A one-shot
        probe token would deadlock here — ``_online_disks()`` admits at
        list-construction time, and many callers (bucket stat, list)
        touch only a prefix of that list, so the token could be burned
        without any call ever reaching the disk.
        """
        if not self._cfg.enabled:
            return True
        now = time.monotonic() if now is None else now
        with self._mu:
            if self._state != TRIPPED:
                return True
            if now < self._until:
                return False
            if not self._probing:
                self._probing = True
                self._probe_t0 = now
            return True

    def state(self, now: "float | None" = None) -> int:
        now = time.monotonic() if now is None else now
        with self._mu:
            return self._state_locked(now)

    def _state_locked(self, now: float) -> int:
        if self._state == TRIPPED:
            return TRIPPED
        if self._state == SUSPECT:
            return SUSPECT
        if self._slow_strikes >= self._cfg.slow_strikes and (
            now < self._slow_until
        ):
            return SUSPECT
        return HEALTHY

    def snapshot(self) -> dict:
        """The breaker's state for the metrics plane (server/metrics.py);
        this port keeps no per-disk read quantiles, only the pool's."""
        now = time.monotonic()
        with self._mu:
            out = {
                "state": STATE_NAMES[self._state_locked(now)],
                "consec_errors": self._consec_errors,
                "slow_strikes": self._slow_strikes,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "probing": self._probing,
            }
            if self._state == TRIPPED:
                out["retry_in_seconds"] = round(max(0.0, self._until - now), 3)
            return out

    # -- observations -----------------------------------------------------

    def record_api(self, api: str, seconds: float, ok: bool) -> None:
        """Verdict from a metered disk-API call (MeteredDisk._record)."""
        now = time.monotonic()
        with self._mu:
            if ok:
                self._on_success_locked(now)
            else:
                self._on_failure_locked(now, api)

    def record_shard_read(
        self,
        seconds: float,
        ok: bool,
        censored: bool = False,
        pool_p99: "float | None" = None,
    ) -> None:
        """Verdict from one GET shard read (codec/erasure.py).

        ``censored=True`` means the hedging loop abandoned the read at
        ``seconds`` elapsed without an outcome — the true latency is
        *at least* that, so it never feeds the quantile estimators
        (they would be biased fast) but it does count as a slow strike:
        a disk whose reads keep getting hedged past is degraded even if
        every read would eventually have succeeded.
        """
        now = time.monotonic()
        with self._mu:
            if not ok:
                self._on_failure_locked(now, "shard_read")
                return
            if censored:
                self._note_slow_locked(now)
                return
            # outlier strikes are floored at the minimum hedge deadline:
            # a read faster than we would ever hedge past cannot be
            # "slow", however small the pool p99 gets — without the
            # floor, microsecond-scale pools turn scheduler jitter into
            # spurious suspect demotions
            if (
                pool_p99 is not None
                and seconds > self._cfg.outlier_factor * pool_p99
                and seconds > self._cfg.hedge_min_s
            ):
                self._note_slow_locked(now)
                return
            self._on_success_locked(now)

    def _note_slow_locked(self, now: float) -> None:
        self._slow_strikes += 1
        self._slow_until = now + self._cfg.slow_decay_s
        # slow strikes resolve a probe too: a probe read that had to be
        # abandoned is not a recovery
        if self._probing and self._state == TRIPPED:
            self._retrip_locked(now, "probe read abandoned")

    def _on_success_locked(self, now: float) -> None:
        self._consec_errors = 0
        if self._slow_strikes and now >= self._slow_until:
            self._slow_strikes = 0
        if self._state == TRIPPED:
            if self._probing:
                self._probing = False
                self._state = HEALTHY
                self._slow_strikes = 0
                self._backoff_s = self._cfg.backoff_s
                self.recoveries += 1
                _log.info(
                    "disk breaker recovered",
                    extra=kv(disk=self.endpoint),
                )
        elif self._state == SUSPECT:
            self._state = HEALTHY

    def _on_failure_locked(self, now: float, api: str) -> None:
        self._consec_errors += 1
        if self._state == TRIPPED:
            if self._probing:
                self._retrip_locked(now, api)
            return
        if self._consec_errors >= self._cfg.trip_errors:
            self._state = TRIPPED
            self._until = now + self._backoff_s
            self._probing = False
            self.trips += 1
            _log.warning(
                "disk breaker tripped",
                extra=kv(
                    disk=self.endpoint,
                    api=api,
                    consec_errors=self._consec_errors,
                    backoff_s=round(self._backoff_s, 3),
                ),
            )
        elif self._consec_errors >= self._cfg.suspect_errors:
            self._state = SUSPECT

    def _retrip_locked(self, now: float, why: str) -> None:
        self._probing = False
        self._backoff_s = min(
            self._backoff_s * 2.0, self._cfg.backoff_cap_s
        )
        self._until = now + self._backoff_s
        self.trips += 1
        _log.warning(
            "disk breaker probe failed; re-tripped",
            extra=kv(
                disk=self.endpoint,
                why=why,
                backoff_s=round(self._backoff_s, 3),
            ),
        )

class HealthRegistry:
    """Process-wide table of DiskHealth breakers + pool read quantiles."""

    def __init__(self):
        self.cfg = _Config()
        self._mu = threading.Lock()  # disk table + pool estimators only
        self._disks: "dict[str, DiskHealth]" = {}
        self._pool_p99 = P2Quantile(0.99)

    def get_disk(self, endpoint: str) -> DiskHealth:
        with self._mu:
            dh = self._disks.get(endpoint)
            if dh is None:
                dh = DiskHealth(endpoint, self.cfg)
                self._disks[endpoint] = dh
            return dh

    def record_shard_read(
        self,
        endpoint: str,
        seconds: float,
        ok: bool,
        censored: bool = False,
    ) -> None:
        """One shard read's verdict: feeds the pool estimators (only
        clean successes — censored samples would bias the deadline
        fast) and the disk's breaker.  The two locks are taken in
        sequence, never nested."""
        pool_p99 = None
        if ok and not censored:
            with self._mu:
                self._pool_p99.observe(seconds)
                pool_p99 = self._pool_p99.value()
        elif ok:
            with self._mu:
                pool_p99 = self._pool_p99.value()
        self.get_disk(endpoint).record_shard_read(
            seconds, ok, censored=censored, pool_p99=pool_p99
        )

    def snapshot(self) -> dict:
        with self._mu:
            disks = dict(self._disks)
            p99 = self._pool_p99.value()
        return {
            "pool": {
                "read_p99_seconds": round(p99, 6) if p99 is not None else None,
            },
            "disks": {ep: dh.snapshot() for ep, dh in sorted(disks.items())},
        }

    def states(self) -> "dict[str, int]":
        """endpoint -> numeric state (Prometheus miniotpu_disk_state)."""
        with self._mu:
            disks = dict(self._disks)
        return {ep: dh.state() for ep, dh in disks.items()}

    def hedge_deadline(self) -> "float | None":
        """Seconds a shard read may run before the GET path hedges.

        None disables hedging this round: either MINIO_TPU_HEDGE=0 or
        the pool estimator hasn't seen a single successful read yet
        (first-ever GET has nothing to derive a deadline from).
        """
        if not self.cfg.hedge_enabled:
            return None
        with self._mu:
            p99 = self._pool_p99.value()
        if p99 is None:
            return None
        return max(
            self.cfg.hedge_min_s,
            min(self.cfg.hedge_max_s, p99 * self.cfg.hedge_factor),
        )

# -- process-wide singleton ------------------------------------------------

_REGISTRY: "HealthRegistry | None" = None
_REGISTRY_LK = threading.Lock()


def registry() -> HealthRegistry:
    global _REGISTRY
    r = _REGISTRY
    if r is None:
        with _REGISTRY_LK:
            if _REGISTRY is None:
                _REGISTRY = HealthRegistry()
            r = _REGISTRY
    return r


def reset_registry() -> None:
    """Discard all breaker state and re-read env knobs (tests)."""
    global _REGISTRY
    with _REGISTRY_LK:
        _REGISTRY = None


def should_skip(disk) -> bool:
    """True if the disk's breaker is open and no probe is due.

    Works on any layer of the wrap chain: a MeteredDisk carries the
    ``health`` attribute; bare disks (no metering, e.g. unit-test
    doubles) have no breaker and never skip.
    """
    h = getattr(disk, "health", None)
    if h is None:
        return False
    return not h.admit()
