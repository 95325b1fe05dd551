"""Persistent workers for internode fan-outs (lock-plane asks, ``xl.meta``
reads of remote drives).

The internode clients keep one keep-alive connection per calling thread
(``utils/tlsconf.pooled_connection``).  A thread started for each call
opened a fresh TCP connection for every call, and the peer accepted and
served a new connection for each; these workers live on, so each keeps
its connection to every peer it calls.  Workers start on demand, up to
``cap``, and are daemons: a call hung on a dead peer holds one worker
until its own timeout, never the process's exit.
"""

from __future__ import annotations

import queue
import threading

from ..utils.log import kv, logger

_log = logger("fanout")


class Fanout:
    def __init__(self, name: str, cap: int = 64):
        self._name = name
        self._cap = cap
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._mu = threading.Lock()
        self._workers = 0
        self._idle = 0
        self._queued = 0

    def submit(self, fn) -> None:
        """Run ``fn()`` on a worker; it must report its own outcome."""
        with self._mu:
            self._queued += 1
            spawn = self._queued > self._idle and self._workers < self._cap
            if spawn:
                self._workers += 1
                n = self._workers
        if spawn:
            threading.Thread(
                target=self._run, name=f"{self._name}-{n}", daemon=True
            ).start()
        self._q.put(fn)

    def close(self) -> None:
        with self._mu:
            n, self._workers = self._workers, 0
            self._queued += n
        for _ in range(n):
            self._q.put(None)

    def _run(self) -> None:
        while True:
            with self._mu:
                self._idle += 1
            fn = self._q.get()
            with self._mu:
                self._idle -= 1
                self._queued -= 1
            if fn is None:
                return
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - the job reports its own
                _log.debug("fan-out job failed", extra=kv(err=str(exc)))


def run_all(jobs: list) -> None:
    """Run every ``(pool, fn)`` of ``jobs`` at once: ``fn()`` on a worker
    of ``pool``, or on the calling thread where ``pool`` is None (after
    the others are handed out); return when all have returned.  Each
    ``fn`` reports its own outcome."""
    done = threading.Semaphore(0)
    pooled = [(pool, fn) for pool, fn in jobs if pool is not None]

    def wrap(fn):
        def job():
            try:
                fn()
            finally:
                done.release()
        return job

    for pool, fn in pooled:
        pool.submit(wrap(fn))
    for pool, fn in jobs:
        if pool is None:
            fn()
    for _ in pooled:
        done.acquire()
