"""dsync: distributed quorum RW mutex (pkg/dsync/drwmutex.go:180-321).

Algorithm (matching the reference's DRWMutex):

- A lock names one or more resources.  Acquisition broadcasts the request
  to every locker node in parallel; it succeeds iff a quorum grants it
  within the acquire window (DRWMutexAcquireTimeout, drwmutex.go:47).
- Write quorum is n - n//2, bumped by one when that equals the tolerance
  (even n) so two halves of a split brain cannot both hold the lock
  (drwmutex.go:190-199).  Read quorum is n - n//2.
- A failed attempt releases whatever grants it did collect
  (releaseAll, drwmutex.go:336) and retries with jittered backoff until
  the caller's timeout expires (lockBlocking, drwmutex.go:140-177).

Stale-lock recovery: the reference's 2020-era lockMaintenance loop
(lock-rest-server.go:238) polls peers with an Expired RPC once a minute;
it cannot free a fully-granted lock whose holder process died.  We keep
the same quorum acquisition but recover staleness the way the modern
dsync does: holders REFRESH their held locks on a cadence, and every
lock server locally expires entries that have not been refreshed within
the expiry window.  A dead holder stops refreshing, so its grants age
out on every node independently - no cross-node GC RPC required, and a
killed node's locks always free.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import uuid

from ..utils.log import kv, logger

_log = logger("dsync")

ACQUIRE_TIMEOUT_S = 1.0  # DRWMutexAcquireTimeout (drwmutex.go:47)
REFRESH_INTERVAL_S = 10.0  # holder-side refresh cadence
EXPIRY_S = 30.0  # server-side entry expiry (3 missed refreshes)


@dataclasses.dataclass(frozen=True)
class LockArgs:
    """One lock request (dsync.LockArgs)."""

    uid: str
    resources: tuple
    source: str = ""


class NetLocker:
    """The per-node lock service interface (pkg/dsync
    rpc-client-interface.go:35).  Implementations: LocalLocker
    (in-process) and LockRESTClient (peer node over the lock plane)."""

    def lock(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def unlock(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def rlock(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def runlock(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def refresh(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def force_unlock(self, args: LockArgs) -> bool:
        raise NotImplementedError

    def is_online(self) -> bool:
        return True

    def close(self) -> None:
        pass


class Dsync:
    """Locker topology + the holder-side refresh loop.

    One Dsync per process; its refresher thread keeps every currently
    held lock alive on all locker nodes until release.
    """

    def __init__(
        self,
        lockers: list,
        refresh_interval_s: float = REFRESH_INTERVAL_S,
    ):
        if not lockers:
            raise ValueError("dsync needs at least one locker")
        self.lockers = list(lockers)
        self._refresh_interval = refresh_interval_s
        self._held: dict[str, tuple] = {}  # uid -> (args, read)
        self._lost: set[str] = set()  # uids whose refresh lost quorum
        self._refresh_fails: dict[str, set] = {}  # uid -> failing idxs
        self._mu = threading.Lock()
        self._stop = threading.Event()
        # one refresher thread PER locker so a hung node cannot starve
        # refreshes to healthy nodes past the expiry window
        self._threads: "list[threading.Thread] | None" = None

    # -- held-lock registry (feeds the refreshers) ------------------------

    def track(self, args: LockArgs, read: bool = False) -> None:
        with self._mu:
            self._held[args.uid] = (args, read)
            if self._threads is None:
                self._threads = [
                    threading.Thread(
                        target=self._refresh_loop,
                        args=(i,),
                        name=f"dsync-refresh-{i}",
                        daemon=True,
                    )
                    for i in range(len(self.lockers))
                ]
                for t in self._threads:
                    t.start()

    def untrack(self, uid: str) -> None:
        with self._mu:
            self._held.pop(uid, None)
            self._lost.discard(uid)
            self._refresh_fails.pop(uid, None)

    def is_lost(self, uid: str) -> bool:
        """True when refresh lost quorum for this lock: the holder can
        no longer assume exclusivity (a stalled process may observe
        this after resuming and must treat the operation as failed)."""
        with self._mu:
            return uid in self._lost

    def release_all(self) -> int:
        """Release every held lock on every locker node (graceful
        shutdown): a restarting node must unwind its grants instead of
        leaving orphaned entries for peers to expire by timeout.
        Returns the number of locks released."""
        with self._mu:
            held = list(self._held.values())
            self._held.clear()
            self._lost.clear()
            self._refresh_fails.clear()
        for args, read in held:
            for c in self.lockers:
                try:
                    if read:
                        c.runlock(args)
                    else:
                        c.unlock(args)
                except Exception as exc:
                    _log.debug(
                        "shutdown release failed; entry ages out",
                        extra=kv(uid=args.uid, err=str(exc)),
                    )
        if held:
            _log.info(
                "released held locks at shutdown",
                extra=kv(count=len(held)),
            )
        return len(held)

    def close(self) -> None:
        self._stop.set()
        if self._threads is not None:
            for t in self._threads:
                t.join(timeout=2)
        for c in self.lockers:
            try:
                c.close()
            except Exception as exc:
                _log.debug("locker client close failed", extra=kv(err=str(exc)))

    def _refresh_loop(self, locker_index: int) -> None:
        c = self.lockers[locker_index]
        while not self._stop.wait(self._refresh_interval):
            with self._mu:
                batch = [a for a, _ in self._held.values()]
            for args in batch:
                try:
                    ok = c.refresh(args)
                except Exception:  # noqa: BLE001
                    ok = False  # unreachable node: entry ages out there
                self._note_refresh(args, locker_index, ok)

    def _note_refresh(self, args: LockArgs, idx: int, ok: bool) -> None:
        """Track per-uid refresh failures; when a full round cannot
        reach quorum anymore, mark the lock lost and stop refreshing so
        a zombie holder cannot keep a contested resource pinned."""
        with self._mu:
            entry = self._held.get(args.uid)
            if entry is None:
                return
            fails = self._refresh_fails.setdefault(args.uid, set())
            if ok:
                fails.discard(idx)
                return
            fails.add(idx)
            _, read = entry
            quorum, _tol = _quorums(len(self.lockers), read)
            if len(self.lockers) - len(fails) < quorum:
                self._lost.add(args.uid)
                self._held.pop(args.uid, None)
                self._refresh_fails.pop(args.uid, None)


def _quorums(n: int, read: bool) -> tuple[int, int]:
    """(quorum, tolerance) - drwmutex.go:184-199."""
    tolerance = n // 2
    quorum = n - tolerance
    if not read and quorum == tolerance:
        quorum += 1  # even n: write needs n/2+1 against split brain
    return quorum, n - quorum


class DRWMutex:
    """Distributed RW mutex over a Dsync locker set."""

    def __init__(self, ds: Dsync, *names: str):
        if not names:
            raise ValueError("lock needs at least one resource name")
        self._ds = ds
        self.names = tuple(names)
        self._uid = ""
        self._read = False

    # -- public API -------------------------------------------------------

    def get_lock(
        self, source: str = "", timeout: "float | None" = 30.0
    ) -> bool:
        return self._lock_blocking(source, read=False, timeout=timeout)

    def get_rlock(
        self, source: str = "", timeout: "float | None" = 30.0
    ) -> bool:
        return self._lock_blocking(source, read=True, timeout=timeout)

    def unlock(self) -> None:
        self._release()

    def runlock(self) -> None:
        self._release()

    # -- acquisition ------------------------------------------------------

    def _lock_blocking(
        self, source: str, read: bool, timeout: "float | None"
    ) -> bool:
        if read and len(self.names) != 1:
            raise ValueError("read locks take exactly one resource")
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        attempt = 0
        while True:
            args = LockArgs(
                uid=uuid.uuid4().hex,
                resources=self.names,
                source=source,
            )
            if self._try_lock(args, read):
                self._uid = args.uid
                self._read = read
                self._ds.track(args, read)
                return True
            attempt += 1
            # jittered incremental backoff (retry.NewTimer analogue)
            delay = min(0.003 * (2 ** min(attempt, 6)), 0.25)
            delay *= 0.5 + random.random()
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                delay = min(delay, rem)
            time.sleep(delay)

    def _try_lock(self, args: LockArgs, read: bool) -> bool:
        lockers = self._ds.lockers
        n = len(lockers)
        quorum, tolerance = _quorums(n, read)
        grants = [False] * n
        done = threading.Event()
        pending = [n]
        failed = [0]
        granted = [0]
        abandoned = [False]  # set when the attempt is given up
        mu = threading.Lock()

        def release_one(i: int) -> None:
            try:
                if read:
                    lockers[i].runlock(args)
                else:
                    lockers[i].unlock(args)
            except Exception as exc:
                _log.debug("release failed; entry ages out via expiry", extra=kv(err=str(exc)))

        def ask(i: int, c) -> None:
            ok = False
            errored = False
            try:
                ok = c.rlock(args) if read else c.lock(args)
            except Exception:  # noqa: BLE001
                errored = True
            if errored:
                # a lost response may have left a grant applied
                # server-side under this uid: best-effort cleanup so a
                # phantom grant cannot pin the resource until expiry
                release_one(i)
            with mu:
                grants[i] = ok
                pending[0] -= 1
                if ok:
                    granted[0] += 1
                else:
                    failed[0] += 1
                # early exit: quorum met, all answered, or impossible
                if (
                    granted[0] >= quorum
                    or pending[0] == 0
                    or failed[0] > tolerance
                ):
                    done.set()
                late_abandoned = abandoned[0] and ok
            if late_abandoned:
                # grant arrived after the attempt was given up
                # (drwmutex.go releases post-timeout grants the same way)
                release_one(i)

        threads = [
            threading.Thread(target=ask, args=(i, c), daemon=True)
            for i, c in enumerate(lockers)
        ]
        for t in threads:
            t.start()
        done.wait(ACQUIRE_TIMEOUT_S)
        with mu:
            met = granted[0] >= quorum
            if not met:
                abandoned[0] = True
            to_release = (
                [] if met else [i for i, g in enumerate(grants) if g]
            )
        if not met:
            self._send_release(args, read, to_release)
            return False
        # stragglers that grant after a successful acquire belong to the
        # held lock and are released at unlock (indices=None).
        return True

    def _send_release(
        self, args: LockArgs, read: bool, indices: "list[int] | None" = None
    ) -> None:
        lockers = self._ds.lockers
        idx = range(len(lockers)) if indices is None else indices
        for i in idx:
            try:
                if read:
                    lockers[i].runlock(args)
                else:
                    lockers[i].unlock(args)
            except Exception as exc:
                _log.debug("unlock on unreachable node; entry ages out", extra=kv(err=str(exc)))

    def _release(self) -> None:
        if not self._uid:
            return
        args = LockArgs(uid=self._uid, resources=self.names)
        self._ds.untrack(self._uid)
        self._send_release(args, self._read)
        self._uid = ""
