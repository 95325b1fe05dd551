"""Namespace locking: per-object ref-counted RW locks.

Local counterpart of cmd/namespace-lock.go (nsLockMap): every object
operation takes a read or write lock on "<volume>/<path>" so concurrent
PUT/GET/DELETE on one object serialize correctly.  In distributed mode the
same interface is backed by dsync quorum locks (dsync/drwmutex.py),
mirroring distLockInstance (namespace-lock.go:140).
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..utils import spans


class _RWLock:
    """Writer-preference RW lock with timeout support."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self.ref = 0  # nsLockMap refcount

    def acquire_read(self, timeout: "float | None" = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._writer or self._writers_waiting:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                if not self._cond.wait(rem):
                    return False
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: "float | None" = None) -> bool:
        with self._cond:
            self._writers_waiting += 1
            try:
                deadline = (
                    None if timeout is None else time.monotonic() + timeout
                )
                while self._writer or self._readers:
                    rem = (
                        None
                        if deadline is None
                        else deadline - time.monotonic()
                    )
                    if rem is not None and rem <= 0:
                        return False
                    if not self._cond.wait(rem):
                        return False
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class LockTimeout(Exception):
    pass


class NamespaceLock:
    """nsLockMap: path -> refcounted RW lock, created/destroyed on demand."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict[str, _RWLock] = {}

    def _get(self, key: str) -> _RWLock:
        with self._mu:
            lk = self._locks.get(key)
            if lk is None:
                lk = self._locks[key] = _RWLock()
            lk.ref += 1
            return lk

    def _put(self, key: str) -> None:
        with self._mu:
            lk = self._locks.get(key)
            if lk is None:
                return
            lk.ref -= 1
            if lk.ref <= 0:
                del self._locks[key]

    @contextlib.contextmanager
    def read(self, volume: str, path: str, timeout: "float | None" = 30.0):
        key = f"{volume}/{path}"
        lk = self._get(key)
        try:
            with spans.span("lock"):
                got = lk.acquire_read(timeout)
            if not got:
                raise LockTimeout(key)
            try:
                yield
            finally:
                with spans.span("unlock"):
                    lk.release_read()
        finally:
            self._put(key)

    @contextlib.contextmanager
    def write(self, volume: str, path: str, timeout: "float | None" = 30.0):
        key = f"{volume}/{path}"
        lk = self._get(key)
        try:
            with spans.span("lock"):
                got = lk.acquire_write(timeout)
            if not got:
                raise LockTimeout(key)
            try:
                yield
            finally:
                with spans.span("unlock"):
                    lk.release_write()
        finally:
            self._put(key)


class DistNamespaceLock:
    """NamespaceLock backed by dsync quorum locks (distLockInstance,
    namespace-lock.go:140): selected when the cluster spans more than
    one node, so concurrent object ops from different processes
    serialize through the lock plane."""

    def __init__(self, ds, source: str = ""):
        from ..utils.dyntimeout import DynamicTimeout

        self._ds = ds
        self._source = source
        # self-tuning lock-wait budgets (the reference wraps its object
        # locks in newDynamicTimeout(30s, 1s)); the write budget is
        # overridable so a write that can never reach lock quorum 503s
        # on an operator-chosen clock instead of 30s. Reads keep the
        # full default: a read below quorum fails fast anyway, and a
        # shorter seed decays to the 1s floor quickly enough to shed
        # healthy reads under hot-key load.
        import os

        wbudget = max(
            1.0,
            float(
                os.environ.get("MINIO_TPU_WRITE_LOCK_ACQUIRE_S") or 30.0
            ),
        )
        self._rtimeout = DynamicTimeout(30.0, 1.0)
        self._wtimeout = DynamicTimeout(wbudget, 1.0)

    def release_all(self) -> int:
        """Graceful-shutdown unwind: release every lock this process
        still holds on the cluster, then stop the refresher threads.
        Stragglers a peer could not be told about age out via expiry."""
        released = self._ds.release_all()
        self._ds.close()
        return released

    @contextlib.contextmanager
    def read(self, volume: str, path: str, timeout: "float | None" = None):
        import time as _t

        from .drwmutex import DRWMutex

        if timeout is None:
            timeout = self._rtimeout.timeout
        m = DRWMutex(self._ds, f"{volume}/{path}")
        t0 = _t.monotonic()
        got = m.get_rlock(self._source, timeout)
        spans.add("lock", _t.monotonic() - t0)
        if not got:
            self._rtimeout.log_failure()
            raise LockTimeout(f"{volume}/{path}")
        self._rtimeout.log_success(_t.monotonic() - t0)
        try:
            yield
        finally:
            with spans.span("unlock"):
                m.runlock()

    @contextlib.contextmanager
    def write(self, volume: str, path: str, timeout: "float | None" = None):
        import time as _t

        from .drwmutex import DRWMutex

        if timeout is None:
            timeout = self._wtimeout.timeout
        m = DRWMutex(self._ds, f"{volume}/{path}")
        t0 = _t.monotonic()
        got = m.get_lock(self._source, timeout)
        spans.add("lock", _t.monotonic() - t0)
        if not got:
            self._wtimeout.log_failure()
            raise LockTimeout(f"{volume}/{path}")
        self._wtimeout.log_success(_t.monotonic() - t0)
        try:
            yield
        finally:
            with spans.span("unlock"):
                m.unlock()
