"""Deterministic fault injection for the StorageAPI wrap chain.

``FaultDisk`` decorates any StorageAPI and executes programmable fault
schedules — delays, errors, corruption, hangs — keyed by API name, with
a seeded RNG so a chaos scenario replays byte-for-byte identically.  It
composes under the standard stack::

    DiskIDCheck(MeteredDisk(FaultDisk(XLStorage(...))))

so injected latency and errors flow through the *real* metering ledger
and circuit breaker exactly as a degraded drive's would: a chaos run
exercises the production path, not a mock of it.  The server wraps each
local drive so under ``MINIO_TPU_FAULT_INJECTION=1`` (seeded by
``MINIO_TPU_FAULT_SEED``), and the admin ``fault/*`` routes schedule
rules on it from another process (cluster/harness.py).

Schedule DSL::

    fd = FaultDisk(raw, seed=7)
    fd.inject("read_at", delay_s=0.05)              # every stream read
    fd.inject("*", error=True, calls=[3, 4])        # 3rd+4th call/API
    fd.inject("read_at", corrupt=True, prob=0.25)   # seeded coin flip
    fd.inject("stat_file", hang_s=30.0)             # parks until clear()
    fd.clear()                                      # lift everything

* ``api`` is a disk API name (``DiskIDCheck._CHECKED``), the
  stream-level ``"read_at"`` / ``"write"`` (shards move through
  ``read_file_stream``/``create_file`` handles, not API calls), or
  ``"*"`` for every disk API.
* ``calls`` filters on the per-API 1-based call number; ``prob`` draws
  from the seeded RNG (both evaluated under the schedule lock so the
  replay is deterministic; sleeps and raises happen OUTSIDE it).
* ``error`` raises ``serrors.FaultyDisk``; ``corrupt`` flips one
  seeded-random byte of the payload; ``hang_s`` parks the call on an
  event that ``clear()`` releases early, so wedged-disk tests tear
  down fast.
"""

from __future__ import annotations

import random
import threading
import time

from ..utils.log import kv, logger
from . import errors as serrors
from .diskcheck import DiskIDCheck

_log = logger("faults")

# stream-level ops: applied by the _FaultStream wrappers, not __getattr__
_STREAM_OPS = ("read_at", "write")


class FaultDisk:
    """StorageAPI decorator executing a deterministic fault schedule."""

    _FAULTED = DiskIDCheck._CHECKED

    def __init__(self, disk, seed: int = 0):
        self.unwrapped = disk
        self._mu = threading.Lock()
        self._rng = random.Random(seed)
        self._rules: "list[dict]" = []
        self._calls: "dict[str, int]" = {}
        # injected-action tally: kind -> count (test assertions)
        self._injected: "dict[str, int]" = {}
        self._release = threading.Event()  # set by clear(): ends hangs

    # -- schedule DSL -----------------------------------------------------

    def inject(
        self,
        api: str,
        delay_s: float = 0.0,
        hang_s: float = 0.0,
        error: bool = False,
        corrupt: bool = False,
        prob: float = 1.0,
        calls: "list[int] | None" = None,
    ) -> "FaultDisk":
        """Add one schedule rule (chainable)."""
        with self._mu:
            self._rules.append(
                {
                    "api": api,
                    "delay_s": float(delay_s),
                    "hang_s": float(hang_s),
                    "error": bool(error),
                    "corrupt": bool(corrupt),
                    "prob": float(prob),
                    "calls": None if calls is None else set(calls),
                }
            )
        return self

    def clear(self) -> None:
        """Lift every rule, release parked hangs, reset call counters."""
        with self._mu:
            self._rules = []
            self._calls.clear()
        self._release.set()
        self._release = threading.Event()
        _log.debug(
            "fault schedule cleared",
            extra=kv(disk=str(getattr(self.unwrapped, "root", "?"))),
        )

    def injected(self) -> "dict[str, int]":
        """Tally of executed fault actions: kind -> count."""
        with self._mu:
            return dict(self._injected)

    def rule_count(self) -> int:
        """Number of active schedule rules (admin fault/status)."""
        with self._mu:
            return len(self._rules)

    # -- schedule execution -----------------------------------------------

    def _plan(self, api: str) -> "dict | None":
        """Decide this call's fate under the lock (counter + RNG draws
        stay deterministic); the caller executes it lock-free."""
        with self._mu:
            if not self._rules:
                return None
            n = self._calls.get(api, 0) + 1
            self._calls[api] = n
            plan = None
            for rule in self._rules:
                if rule["api"] != api and not (
                    rule["api"] == "*" and api not in _STREAM_OPS
                ):
                    continue
                if rule["calls"] is not None and n not in rule["calls"]:
                    continue
                if rule["prob"] < 1.0 and self._rng.random() > rule["prob"]:
                    continue
                if plan is None:
                    plan = {
                        "delay_s": 0.0,
                        "hang_s": 0.0,
                        "error": False,
                        "corrupt": False,
                        "byte": 0,
                    }
                plan["delay_s"] += rule["delay_s"]
                plan["hang_s"] = max(plan["hang_s"], rule["hang_s"])
                plan["error"] = plan["error"] or rule["error"]
                plan["corrupt"] = plan["corrupt"] or rule["corrupt"]
            if plan is not None and plan["corrupt"]:
                plan["byte"] = self._rng.randrange(1 << 30)
            if plan is not None:
                release = self._release
                for kind in ("delay_s", "hang_s"):
                    if plan[kind] > 0:
                        self._injected[kind[:-2]] = (
                            self._injected.get(kind[:-2], 0) + 1
                        )
                for kind in ("error", "corrupt"):
                    if plan[kind]:
                        self._injected[kind] = (
                            self._injected.get(kind, 0) + 1
                        )
                plan["release"] = release
            return plan

    def _pre(self, api: str) -> "dict | None":
        """Run the blocking/raising half of the plan; return the rest."""
        plan = self._plan(api)
        if plan is None:
            return None
        if plan["delay_s"] > 0:
            time.sleep(plan["delay_s"])
        if plan["hang_s"] > 0:
            # parks until the schedule is cleared or the hang expires —
            # a wedged disk, but one the test harness can always free
            plan["release"].wait(plan["hang_s"])
        if plan["error"]:
            raise serrors.FaultyDisk(f"injected fault: {api}")
        return plan

    @staticmethod
    def _maybe_corrupt(plan: "dict | None", data):
        if plan is None or not plan["corrupt"] or not data:
            return data
        buf = bytearray(data)
        idx = plan["byte"] % len(buf)
        buf[idx] ^= 0xFF
        return bytes(buf)

    # -- StorageAPI surface -----------------------------------------------

    def read_file_stream(self, volume: str, path: str):
        self._pre("read_file_stream")
        return _FaultReader(
            self.unwrapped.read_file_stream(volume, path), self
        )

    def create_file(self, volume: str, path: str):
        self._pre("create_file")
        return _FaultWriter(
            self.unwrapped.create_file(volume, path), self
        )

    def __getattr__(self, name: str):
        attr = getattr(self.unwrapped, name)
        if name in self._FAULTED and callable(attr):
            def wrapped(*a, **k):
                plan = self._pre(name)
                result = attr(*a, **k)
                if isinstance(result, bytes):
                    result = self._maybe_corrupt(plan, result)
                return result

            wrapped.__name__ = name
            self.__dict__[name] = wrapped
            return wrapped
        return attr


class _FaultReader:
    """ShardReader wrapper applying the disk's ``read_at`` schedule."""

    def __init__(self, inner, disk: FaultDisk):
        self._inner = inner
        self._disk = disk
        self.is_local = getattr(inner, "is_local", True)

    def read_at(self, offset: int, length: int) -> bytes:
        plan = self._disk._pre("read_at")
        data = self._inner.read_at(offset, length)
        return self._disk._maybe_corrupt(plan, data)

    def close(self) -> None:
        self._inner.close()


class _FaultWriter:
    """ShardWriter wrapper applying the disk's ``write`` schedule."""

    def __init__(self, inner, disk: FaultDisk):
        self._inner = inner
        self._disk = disk

    def write(self, data: bytes) -> None:
        plan = self._disk._pre("write")
        self._inner.write(self._disk._maybe_corrupt(plan, data))

    def close(self) -> None:
        self._inner.close()

