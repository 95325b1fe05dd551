"""LocalLocker: this node's share of the distributed lock state
(cmd/local-locker.go).

A map of resource -> granted entries.  A write grant owns the resource
exclusively; read grants stack.  Entries carry the holder's UID and a
last-refresh timestamp; `expire_old` drops entries whose holder stopped
refreshing (dead process / partitioned node), which is what frees locks
after a holder dies (the modern analogue of lockMaintenance,
lock-rest-server.go:238).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from .drwmutex import EXPIRY_S, LockArgs

from ..utils.log import kv, logger

_log = logger("dsync")


@dataclasses.dataclass
class LockEntry:
    uid: str
    writer: bool
    source: str
    acquired_at: float
    refreshed_at: float


def _is_write_locked(entries: "list[LockEntry]") -> bool:
    return len(entries) == 1 and entries[0].writer


class LocalLocker:
    """In-process NetLocker backing one node's lock REST plane."""

    def __init__(self, endpoint: str = "local"):
        self.endpoint = endpoint
        self._mu = threading.Lock()
        self._locks: dict[str, list[LockEntry]] = {}

    # -- NetLocker --------------------------------------------------------

    def lock(self, args: LockArgs) -> bool:
        now = time.monotonic()
        with self._mu:
            # all-or-nothing across resources (canTakeLock,
            # local-locker.go:64-72)
            if any(r in self._locks for r in args.resources):
                return False
            for r in args.resources:
                self._locks[r] = [
                    LockEntry(
                        uid=args.uid,
                        writer=True,
                        source=args.source,
                        acquired_at=now,
                        refreshed_at=now,
                    )
                ]
            return True

    def unlock(self, args: LockArgs) -> bool:
        with self._mu:
            ok = True
            for r in args.resources:
                entries = self._locks.get(r)
                if entries is None or not _is_write_locked(entries):
                    ok = False
                    continue
                if not self._remove(r, args.uid):
                    ok = False
            return ok

    def rlock(self, args: LockArgs) -> bool:
        # read locks are single-resource by contract (the reference's
        # RLock also only honours Resources[0], local-locker.go:162)
        if len(args.resources) != 1:
            raise ValueError("read locks take exactly one resource")
        now = time.monotonic()
        resource = args.resources[0]
        entry = LockEntry(
            uid=args.uid,
            writer=False,
            source=args.source,
            acquired_at=now,
            refreshed_at=now,
        )
        with self._mu:
            entries = self._locks.get(resource)
            if entries is None:
                self._locks[resource] = [entry]
                return True
            if _is_write_locked(entries):
                return False
            entries.append(entry)
            return True

    def runlock(self, args: LockArgs) -> bool:
        if len(args.resources) != 1:
            raise ValueError("read locks take exactly one resource")
        resource = args.resources[0]
        with self._mu:
            entries = self._locks.get(resource)
            if entries is None or _is_write_locked(entries):
                return False
            return self._remove(resource, args.uid)

    def refresh(self, args: LockArgs) -> bool:
        now = time.monotonic()
        with self._mu:
            found = False
            for r in args.resources:
                for e in self._locks.get(r, ()):
                    if e.uid == args.uid:
                        e.refreshed_at = now
                        found = True
            return found

    def force_unlock(self, args: LockArgs) -> bool:
        """Admin: drop every entry for the resources unconditionally."""
        with self._mu:
            removed = False
            for r in args.resources:
                if self._locks.pop(r, None) is not None:
                    removed = True
            return removed

    def is_online(self) -> bool:
        return True

    def dump(self) -> "list[dict]":
        """Snapshot of held locks (admin top-locks / peer GetLocks).

        Entries carry this node's endpoint and WALL-clock acquisition
        time (internal timestamps are monotonic, which would be
        incomparable across processes when the admin API aggregates
        every node's dump)."""
        now_mono = time.monotonic()
        now_wall = time.time()
        with self._mu:
            return [
                {
                    "endpoint": self.endpoint,
                    "resource": r,
                    "uid": e.uid,
                    "writer": e.writer,
                    "source": e.source,
                    "age_s": round(now_mono - e.acquired_at, 3),
                    "acquired_at": round(
                        now_wall - (now_mono - e.acquired_at), 3
                    ),
                }
                for r, entries in self._locks.items()
                for e in entries
            ]

    def close(self) -> None:
        pass

    # -- maintenance ------------------------------------------------------

    def expire_old(self, max_age_s: float = EXPIRY_S) -> int:
        """Drop entries not refreshed within max_age_s; returns count."""
        cutoff = time.monotonic() - max_age_s
        dropped = 0
        with self._mu:
            for r in list(self._locks):
                entries = self._locks[r]
                keep = [e for e in entries if e.refreshed_at >= cutoff]
                dropped += len(entries) - len(keep)
                if keep:
                    self._locks[r] = keep
                else:
                    del self._locks[r]
        return dropped

    # internal; caller holds self._mu
    def _remove(self, resource: str, uid: str) -> bool:
        entries = self._locks.get(resource, [])
        for i, e in enumerate(entries):
            if e.uid == uid:
                del entries[i]
                if not entries:
                    del self._locks[resource]
                return True
        return False


class LockMaintenance:
    """Per-node expiry sweep: a daemon thread dropping unrefreshed
    entries from this node's LocalLocker (the lockMaintenance analogue,
    run against local state only - see module docstring)."""

    def __init__(
        self,
        locker: LocalLocker,
        interval_s: float = 10.0,
        expiry_s: float = EXPIRY_S,
    ):
        self._locker = locker
        self._interval = interval_s
        self._expiry = expiry_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def start(self) -> "LockMaintenance":
        self._thread = threading.Thread(
            target=self._run, name="lock-maintenance", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._locker.expire_old(self._expiry)
            except Exception as exc:
                _log.warning("lock maintenance sweep failed", extra=kv(err=str(exc)))
