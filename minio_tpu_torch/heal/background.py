"""Background healing: MRF queue, heal routine, fresh-disk monitor.

The reference splits this across pieces that we mirror:

- MRF ("most recently failed", erasure.go:40-45 + addPartial,
  erasure-object.go:999): writes that missed some disks, and reads that
  found missing or bitrotted shards, enqueue the object for immediate
  heal instead of waiting for a crawl.  ``ErasureObjects.heal_hook`` is
  the producer; wire it to ``HealQueue.push_object``.
- Heal routine (healRoutine.run, background-heal-ops.go:77): one
  background consumer draining heal tasks against the object layer,
  throttled so it cannot starve foreground I/O.
- Fresh-disk monitor (monitorLocalDisksAndHeal,
  background-newdisks-heal-ops.go:124 + healErasureSet,
  global-heal.go:92): detects a replaced/wiped drive (format.json gone),
  re-stamps it from the set's reference format, and sweeps the set's
  buckets + objects through the heal queue so the new drive converges
  with no operator action.
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


class FreshDiskMonitor:
    """Detects wiped/replaced local drives and heals them back in.

    Every interval, each LOCAL disk of every set is probed for its
    format document.  A reachable disk without one is a replacement:
    it is re-stamped with the uuid its slot records in the set's
    reference format (HealFormat semantics, erasure-sets.go:1328), and
    the set's namespace is swept into the heal queue (healErasureSet).
    """

    def __init__(
        self,
        zones_layer,
        queue: HealQueue,
        interval_s: float = 10.0,
    ):
        self._zones = zones_layer
        self._queue = queue
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.stamped = 0

    def start(self) -> "FreshDiskMonitor":
        self._thread = threading.Thread(
            target=self._run, name="fresh-disk-monitor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _effective_interval(self) -> float:
        try:
            v = float(
                os.environ.get("MINIO_TPU_FRESH_DISK_INTERVAL_S")
                or self._interval
            )
        except ValueError:
            return self._interval
        return v if v >= 1.0 else max(self._interval, 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self._effective_interval()):
            try:
                self.scan_once()
            except Exception as exc:
                _log.warning("background heal scan failed", extra=kv(err=str(exc)))

    def scan_once(self) -> int:
        """One probe pass; returns how many fresh disks were stamped."""
        from ..objectlayer.format import (
            FormatErasure,
            read_format,
            write_format,
        )

        stamped = 0
        for zone in getattr(self._zones, "zones", [self._zones]):
            ref = getattr(zone, "format_ref", None)
            if ref is None:
                continue
            for s_idx, eset in enumerate(zone.sets):
                fresh: list[int] = []
                for d_idx, disk in enumerate(eset.disks):
                    if disk is None:
                        continue
                    # probe THROUGH the decorator chain (DiskIDCheck,
                    # MeteredDisk - in either stacking order) to the
                    # raw disk: the ID check (rightly) fails every op
                    # on an unformatted drive, but this monitor's
                    # whole job is resurrecting exactly those drives
                    raw = disk
                    while True:
                        inner = (
                            raw.__dict__.get("unwrapped")
                            if hasattr(raw, "__dict__")
                            else None
                        )
                        if inner is None:
                            break
                        raw = inner
                    # stamped at boot (load_or_init_format hole fill):
                    # still needs its set swept
                    if getattr(raw, "_freshly_stamped", False):
                        raw._freshly_stamped = False
                        fresh.append(d_idx)
                        continue
                    if not raw.is_local() or not raw.is_online():
                        continue
                    try:
                        fmt = read_format(raw)
                    except Exception:  # noqa: BLE001
                        continue  # corrupt format: operator decision
                    if fmt is not None:
                        continue
                    # replaced drive: restore staging vol + identity
                    # (write_format recreates .sys itself)
                    try:
                        write_format(
                            raw,
                            FormatErasure(
                                id=ref.id,
                                this=ref.sets[s_idx][d_idx],
                                sets=ref.sets,
                            ),
                        )
                        fresh.append(d_idx)
                        stamped += 1
                    except Exception:  # noqa: BLE001
                        continue
                    # the identity check may hold a verdict cached
                    # while the drive was blank: drop it before the
                    # sweep's heals look for the drive
                    recheck = getattr(disk, "recheck", None)
                    if recheck is not None:
                        recheck()
                if fresh:
                    self._sweep_set(eset)
        self.stamped += stamped
        return stamped

    def _sweep_set(self, eset) -> None:
        """Enqueue every bucket + object of the set for heal
        (healErasureSet, global-heal.go:92)."""
        buckets: dict[str, None] = {}
        for disk in eset.disks:
            if disk is None or not disk.is_online():
                continue
            try:
                for v in disk.list_vols():
                    buckets[v.name] = None
            except Exception:  # noqa: BLE001
                continue
        for bucket in buckets:
            self._queue.push(HealTask(bucket))
            names: dict[str, None] = {}
            for disk in eset.disks:
                if disk is None or not disk.is_online():
                    continue
                try:
                    for name in disk.walk(bucket):
                        names[name] = None
                except Exception:  # noqa: BLE001
                    continue
            for name in names:
                self._queue.push(HealTask(bucket, name))
