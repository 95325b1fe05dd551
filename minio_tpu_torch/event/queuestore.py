"""Persistent at-least-once event store
(pkg/event/target/queuestore.go + store.go sendEvents replay loop).

``QueueStore`` journals each undelivered event record as one JSON file
under a per-target directory (bounded by ``limit``, oldest kept - the
reference refuses new entries past maxLimit 10000).  ``QueuedTarget``
wraps any target with the store: a failed ``send`` parks the record on
disk and a replay thread retries in order once the target answers
again, so events fired while a sink is down are delivered after it
returns, surviving process restarts in between.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from ..utils.log import kv, logger

_log = logger("event")

DEFAULT_LIMIT = 10_000
RETRY_INTERVAL_S = 5.0


class StoreFull(Exception):
    pass


class QueueStore:
    """Directory-backed FIFO of JSON event records."""

    def __init__(self, directory: str, limit: int = DEFAULT_LIMIT):
        self.dir = directory
        self.limit = limit
        self._mu = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        # counter maintained in memory: listing+sorting the backlog dir
        # per enqueue would make a filling store O(n^2)
        self._count = len(self.list())

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key)

    def put(self, record: dict) -> str:
        """Persist one record; returns its key.  Keys sort in insertion
        order (time-prefixed) so replay preserves event order."""
        with self._mu:
            if self._count >= self.limit:
                raise StoreFull(f"store at limit {self.limit}")
            key = f"{time.time_ns():020d}-{uuid.uuid4().hex[:8]}.json"
            tmp = self._path(key + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f)
            os.replace(tmp, self._path(key))
            self._count += 1
            return key

    def get(self, key: str) -> dict:
        with open(self._path(key), encoding="utf-8") as f:
            return json.load(f)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            return
        with self._mu:
            self._count = max(0, self._count - 1)

    def list(self) -> "list[str]":
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names if n.endswith(".json"))

    def count(self) -> int:
        return self._count


class QueuedTarget:
    """Wrap a target with at-least-once disk buffering.

    Live sends go straight through; a failure parks the record and
    every ``retry_interval_s`` the replay thread attempts the backlog
    in order, stopping at the first failure (the sink is still down).
    """

    def __init__(
        self,
        target,
        directory: str,
        limit: int = DEFAULT_LIMIT,
        retry_interval_s: float = RETRY_INTERVAL_S,
    ):
        self.inner = target
        self.id = target.id
        self.arn = target.arn
        self.store = QueueStore(directory, limit)
        self._interval = retry_interval_s
        self._stop = threading.Event()
        self._replay_mu = threading.Lock()
        self._thread = threading.Thread(
            target=self._replay_loop, daemon=True,
            name=f"event-store-{target.id}",
        )
        self._thread.start()

    def send(self, record: dict) -> None:
        if self.store.count():
            # order preservation: with a backlog, new events queue
            # behind it rather than jumping ahead
            self.store.put(record)
            return
        try:
            self.inner.send(record)
        except Exception:  # noqa: BLE001 - park it for replay
            self.store.put(record)

    def replay_once(self) -> int:
        """Attempt the backlog in order; returns how many delivered."""
        delivered = 0
        with self._replay_mu:
            for key in self.store.list():
                try:
                    record = self.store.get(key)
                except (OSError, ValueError):
                    self.store.delete(key)  # corrupt entry
                    continue
                try:
                    self.inner.send(record)
                except Exception:  # noqa: BLE001 - still down
                    break
                self.store.delete(key)
                delivered += 1
        return delivered

    def _replay_loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.replay_once()
            except Exception as exc:
                _log.warning("queuestore replay cycle failed", extra=kv(err=str(exc)))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.inner.close()
