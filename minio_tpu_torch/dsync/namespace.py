"""Namespace locking: per-object ref-counted RW locks.

Local counterpart of cmd/namespace-lock.go (nsLockMap): every object
operation takes a read or write lock on "<volume>/<path>" so concurrent
PUT/GET/DELETE on one object serialize correctly.  In distributed mode the
same interface is backed by dsync quorum locks, which this port carries
in a later slice.
"""

from __future__ import annotations

import contextlib
import threading
import time


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
            if not lk.acquire_read(timeout):
                raise LockTimeout(key)
            try:
                yield
            finally:
                lk.release_read()
        finally:
            self._put(key)

    @contextlib.contextmanager
    def write(self, volume: str, path: str, timeout: "float | None" = 30.0):
        key = f"{volume}/{path}"
        lk = self._get(key)
        try:
            if not lk.acquire_write(timeout):
                raise LockTimeout(key)
            try:
                yield
            finally:
                lk.release_write()
        finally:
            self._put(key)
