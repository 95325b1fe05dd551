"""Background healing: MRF queue and heal routine.

The reference splits this across pieces that we mirror:

- MRF ("most recently failed", erasure.go:40-45 + addPartial,
  erasure-object.go:999): writes that missed some disks, and reads that
  found missing or bitrotted shards, enqueue the object for immediate
  heal instead of waiting for a crawl.  ``ErasureObjects.heal_hook`` is
  the producer; wire it to ``HealQueue.push_object``.
- Heal routine (healRoutine.run, background-heal-ops.go:77): one
  background consumer draining heal tasks against the object layer,
  throttled so it cannot starve foreground I/O.

The fresh-disk monitor (a replaced drive detected through its missing
format.json, then swept) needs the format bootstrap and listing, which
come with the cluster slice.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time

from ..utils.log import kv, logger

_log = logger("heal")


@dataclasses.dataclass(frozen=True)
class HealTask:
    """One unit of heal work; object == "" heals the bucket only."""

    bucket: str
    object: str = ""
    version_id: str = ""


class HealQueue:
    """Deduplicating FIFO feeding the heal routine (the healTask
    channel analogue, bounded by dedup rather than depth)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._queue: collections.deque = collections.deque()
        self._pending: set = set()
        # popped but not yet task_done(): keeps idle() False while a
        # heal is mid-run, so drain() never sees a gap
        self._inflight = 0

    def push(self, task: HealTask) -> None:
        with self._cond:
            if task in self._pending:
                return
            self._pending.add(task)
            self._queue.append(task)
            self._cond.notify()

    def push_object(
        self, bucket: str, object_name: str, version_id: str = ""
    ) -> None:
        self.push(HealTask(bucket, object_name, version_id))

    def pop(self, timeout: "float | None" = None) -> "HealTask | None":
        with self._cond:
            if not self._queue and not self._cond.wait(timeout):
                return None
            if not self._queue:
                return None
            task = self._queue.popleft()
            self._pending.discard(task)
            self._inflight += 1
            return task

    def task_done(self) -> None:
        with self._mu:
            self._inflight -= 1

    def idle(self) -> bool:
        with self._mu:
            return not self._queue and self._inflight == 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._queue)


class HealRoutine:
    """Daemon consumer draining the queue against the object layer."""

    def __init__(
        self,
        object_layer,
        queue: HealQueue,
        throttle_s: float = 0.0,
    ):
        self._ol = object_layer
        self.queue = queue
        self._throttle = throttle_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.healed = 0
        self.failed = 0

    def start(self) -> "HealRoutine":
        self._thread = threading.Thread(
            target=self._run, name="heal-routine", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> bool:
        """Stop the consumer; True once its thread has exited."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            return not self._thread.is_alive()
        return True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for the queue to empty (tests / admin heal barrier);
        False when ``timeout_s`` passed first."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.queue.idle():
                return True
            time.sleep(0.05)
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            task = self.queue.pop(timeout=0.25)
            if task is None:
                continue
            try:
                if task.object:
                    self._ol.heal_object(
                        task.bucket, task.object, task.version_id
                    )
                else:
                    self._ol.heal_bucket(task.bucket)
                self.healed += 1
            except Exception as e:  # noqa: BLE001 - retried by later triggers
                self.failed += 1
                _log.warning(
                    "heal task failed",
                    extra=kv(
                        bucket=task.bucket,
                        object=task.object,
                        error=f"{type(e).__name__}: {e}",
                    ),
                )
            finally:
                self.queue.task_done()
            # runtime-editable throttle; a malformed value must never
            # kill this thread
            try:
                throttle = float(
                    os.environ.get("MINIO_TPU_HEAL_THROTTLE_S")
                    or self._throttle
                )
            except ValueError:
                throttle = self._throttle
            if throttle:
                self._stop.wait(throttle)
