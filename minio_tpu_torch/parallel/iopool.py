"""Per-disk I/O fan-out pool (the parallelWriter/parallelReader plane).

The reference fans every shard write out to one goroutine per disk with
quorum-aware early completion (cmd/erasure-encode.go:39-70
parallelWriter, cmd/erasure-decode.go parallelReader).  The Python
analogue here is a process-wide pool of ORDERED worker queues:

* One queue per routing key.  Writers/readers tagged with a stable
  ``io_key`` (the disk endpoint, set by the object layer) get a
  dedicated queue, so all writes to one shard file flow through one
  worker in submission order — shard-file framing survives concurrent
  PUTs without any per-file locking.
* Bounded depth per queue (backpressure): a slow disk stalls its own
  submitters instead of ballooning memory.
* ``ShardFlusher`` adds the quorum protocol on top: ``flush()`` returns
  as soon as ``quorum`` disks acked the batch, stragglers keep draining
  in the background, and failed disks are reported so the caller can
  mark ``writers[s] = None`` exactly like the sequential path did.

Worker threads are lazy, daemonized, and named ``iopool-<n>`` (the
leakcheck fixture allowlists the prefix: the global pool is a
process-lifetime singleton like the codec batcher).

Jobs run OUTSIDE every pool lock; a job submitted from its own queue's
worker thread executes inline (read-ahead jobs that fan out leaf reads
can never deadlock on their own queue).
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ..utils.log import kv, logger

_log = logger("iopool")

_MAX_STABLE_KEYS = 4096  # stop memoizing routing past this many keys


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    try:
        v = int(os.environ.get(name) or default)
    except ValueError:
        v = default
    return max(lo, min(hi, v))


class IopoolTimeout(TimeoutError):
    """A pool job missed its caller's deadline (the job itself may
    still be running; see IOFuture.abandon for the disavowal half)."""


class IopoolAbandoned(RuntimeError):
    """A queued job was abandoned before its worker dequeued it — the
    caller hedged past it and disavowed the result."""


class IOFuture:
    """Completion handle for one pool job (result OR error, both kept)."""

    __slots__ = (
        "_lk", "_event", "_finished", "_cbs", "abandoned", "result", "error"
    )

    def __init__(self):
        self._lk = threading.Lock()
        self._event = threading.Event()
        self._finished = False
        self._cbs: list = []
        self.abandoned = False
        self.result = None
        self.error: "BaseException | None" = None

    def abandon(self) -> None:
        """Disavow a hedged-past job: nobody will consume its result.

        Still-queued jobs resolve ``IopoolAbandoned`` at dequeue
        WITHOUT running — the band slot frees immediately instead of
        behind a straggling disk.  An already-running job finishes
        normally (its thread can't be interrupted) and simply resolves
        unobserved; either way the caller never blocks on it.
        """
        with self._lk:
            if not self._finished:
                self.abandoned = True

    def _resolve(self, result, error: "BaseException | None") -> None:
        with self._lk:
            self.result = result
            self.error = error
            self._finished = True
            cbs, self._cbs = self._cbs, []
        self._event.set()
        for cb in cbs:
            try:
                cb(self)
            except Exception as exc:  # callback bugs must not kill workers
                _log.warning("iopool callback failed", extra=kv(err=str(exc)))

    def add_done_callback(self, cb) -> None:
        with self._lk:
            if not self._finished:
                self._cbs.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: "float | None" = None) -> bool:
        return self._event.wait(timeout)

    def result_or_raise(self, timeout: "float | None" = None):
        if not self._event.wait(timeout):
            raise IopoolTimeout(
                f"iopool job did not complete within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.result


class _IOQueue:
    __slots__ = ("idx", "label", "cv", "items", "thread")

    def __init__(self, idx: int):
        self.idx = idx
        self.label = f"q{idx}"
        self.cv = threading.Condition()
        self.items: "collections.deque" = collections.deque()
        self.thread: "threading.Thread | None" = None


class IOPool:
    """Bounded pool of ordered per-key worker queues."""

    def __init__(
        self,
        queues: "int | None" = None,
        depth: "int | None" = None,
        name_prefix: str = "iopool",
    ):
        self.n_queues = queues if queues is not None else _env_int(
            "MINIO_TPU_IOPOOL_QUEUES", 16, 1, 256
        )
        self.depth = depth if depth is not None else _env_int(
            "MINIO_TPU_IOPOOL_DEPTH", 8, 1, 1024
        )
        self._name_prefix = name_prefix
        self._mu = threading.Lock()  # routing table + lifecycle
        self._assign: "dict[str, int]" = {}
        # two bands: leaf I/O jobs (shard reads/writes — never block
        # on another pool job) fill the main band; PIPELINE jobs that
        # themselves wait on leaf futures (decode read-ahead) live in
        # a small reserved aux band.  Waits only ever flow aux -> main,
        # so a pipeline job queued behind another pipeline job can
        # never close a cycle with the disk queues it is waiting on.
        self.n_aux = max(1, self.n_queues // 4) if self.n_queues > 1 else 0
        self.n_main = self.n_queues - self.n_aux
        self._queues = [_IOQueue(i) for i in range(self.n_queues)]
        self._running = True

    # -- routing ----------------------------------------------------------

    def _queue_for(self, key, aux: bool = False) -> _IOQueue:
        """Stable string keys (disk endpoints) get dedicated main-band
        queues round-robin — up to ``n_main`` disks never share a
        worker.  Ephemeral keys (id()s, read-ahead sequence tuples)
        hash-route: their ordering does not matter, only their
        concurrency."""
        if aux and self.n_aux:
            return self._queues[self.n_main + hash(key) % self.n_aux]
        if isinstance(key, str):
            with self._mu:
                idx = self._assign.get(key)
                if idx is None:
                    if len(self._assign) < _MAX_STABLE_KEYS:
                        idx = len(self._assign) % self.n_main
                        self._assign[key] = idx
                    else:
                        idx = hash(key) % self.n_main
            return self._queues[idx]
        return self._queues[hash(key) % self.n_main]

    # -- submission -------------------------------------------------------

    def submit(self, key, fn, nbytes: int = 0, aux: bool = False) -> IOFuture:
        """Enqueue ``fn`` on the key's ordered queue; returns a future.

        The job's exception (if any) lands in ``future.error`` — it is
        never raised on the worker.  Called from the owning worker
        thread itself, the job runs inline (nested fan-out can't
        deadlock on its own queue).  Jobs that BLOCK on other pool
        futures must pass ``aux=True`` to run in the reserved band —
        a blocking job in the main band can deadlock the disk queues
        it waits on."""
        q = self._queue_for(key, aux=aux)
        fut = IOFuture()
        if q.thread is threading.current_thread():
            self._run_job(q, fut, fn, nbytes, len(q.items))
            return fut
        with q.cv:
            while len(q.items) >= self.depth and self._running:
                q.cv.wait(0.5)
            if not self._running:
                raise RuntimeError("iopool is shut down")
            q.items.append((fut, fn, nbytes))
            depth = len(q.items)
            if q.thread is None:
                q.thread = threading.Thread(
                    target=self._worker,
                    args=(q,),
                    name=f"{self._name_prefix}-{q.idx}",
                    daemon=True,
                )
                q.thread.start()
            q.cv.notify_all()
        _stats_record_depth(q.label, depth)
        return fut

    # -- worker -----------------------------------------------------------

    def _worker(self, q: _IOQueue) -> None:
        while True:
            with q.cv:
                while not q.items and self._running:
                    q.cv.wait(0.5)
                if not q.items:
                    return  # shut down and drained
                fut, fn, nbytes = q.items.popleft()
                depth = len(q.items)
                q.cv.notify_all()  # wake backpressured submitters
            self._run_job(q, fut, fn, nbytes, depth)
            # an idle worker must not pin its last job's closure or
            # result (a decoded read-ahead batch is many MiB) until
            # the next job happens to arrive
            del fut, fn

    def submit_hedged(self, key, fn, nbytes: int = 0) -> IOFuture:
        """Launch a duplicate/alternate read racing a straggler
        (first useful result wins; the caller abandons whichever
        future it stops caring about).  Same ordered-queue semantics
        as ``submit`` — the hedge targets a DIFFERENT disk's queue, so
        it never queues behind the straggler it is hedging against.
        Counted as ``miniotpu_hedge_launched_total``."""
        try:
            _kernel_stats().record_hedge("launched")
        except Exception as exc:  # telemetry must never block a hedge
            _log.warning("hedge stats failed", extra=kv(err=str(exc)))
        return self.submit(key, fn, nbytes=nbytes)

    def _run_job(self, q, fut, fn, nbytes, depth) -> None:
        if fut.abandoned:
            # hedged past while still queued: resolve without running
            # so the band slot frees now, not behind a straggling disk
            fut._resolve(
                None, IopoolAbandoned("job abandoned before dequeue")
            )
            return
        t0 = time.monotonic()
        result = None
        error: "BaseException | None" = None
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 - surfaced via future
            error = e
        try:
            _stats_record_job(
                q.label, nbytes, time.monotonic() - t0, depth
            )
        except Exception as exc:  # stats must never wedge a future
            _log.warning("iopool stats failed", extra=kv(err=str(exc)))
        fut._resolve(result, error)

    # -- lifecycle --------------------------------------------------------

    def queued_jobs(self) -> int:
        """Jobs waiting (not yet dequeued) across every band - the
        server plane's codec-stage queue-depth gauge samples this."""
        return sum(len(q.items) for q in self._queues)

    def shutdown(self, timeout: float = 10.0) -> None:
        """Drain every queue and join the workers (tests / reset)."""
        with self._mu:
            self._running = False
        for q in self._queues:
            with q.cv:
                q.cv.notify_all()
        for q in self._queues:
            t = q.thread
            if t is not None:
                t.join(timeout)

class ShardFlusher:
    """Quorum-aware batch completion over an IOPool.

    One flusher per encode call.  ``flush(jobs, quorum)`` submits every
    job and returns once ``quorum`` distinct slots fully acked this
    batch — surviving stragglers drain in the background and are
    awaited by ``drain()`` (or the next flush's quorum math).  Failed
    slots accumulate; ``flush``/``drain`` return the newly-dead set so
    the caller can mark ``writers[s] = None``.
    """

    def __init__(self, pool: IOPool, quorum_exc: type = RuntimeError):
        self._pool = pool
        self._quorum_exc = quorum_exc
        self._cv = threading.Condition()
        self._pending_total = 0
        self._gen = 0
        self._cur_gen = -1
        self._cur_pending: "dict[int, int]" = {}
        self._cur_failed: "set[int]" = set()
        self._gen_pending: "dict[int, int]" = {}
        self._dead: "set[int]" = set()
        self._reported: "set[int]" = set()
        self.submitted = 0

    def _on_done(self, gen: int, slot: int, fut: IOFuture) -> None:
        with self._cv:
            self._pending_total -= 1
            left = self._gen_pending.get(gen, 1) - 1
            if left <= 0:
                self._gen_pending.pop(gen, None)
            else:
                self._gen_pending[gen] = left
            if fut.error is not None:
                self._dead.add(slot)
                _log.warning(
                    "shard writer failed; disk marked dead",
                    extra=kv(slot=slot, err=str(fut.error)),
                )
            if gen == self._cur_gen:
                self._cur_pending[slot] = self._cur_pending.get(slot, 1) - 1
                if fut.error is not None:
                    self._cur_failed.add(slot)
            self._cv.notify_all()

    def _take_dead_locked(self) -> "set[int]":
        new = self._dead - self._reported
        self._reported |= new
        return new

    def flush(self, jobs, quorum: int) -> "set[int]":
        """jobs: [(slot, key, fn, nbytes), ...].  Blocks until quorum
        slots acked every one of their jobs in this batch; raises
        ``quorum_exc`` the moment quorum becomes unreachable."""
        slots = {s for s, _k, _f, _n in jobs}
        gen = self._gen = self._gen + 1
        with self._cv:
            # bounded overlap: the previous batch must fully drain
            # before this one submits — the quorum-early return still
            # hides a straggler behind the NEXT batch's assemble+codec
            # work, but pinned shard buffers stay capped at ~1 batch
            # regardless of object size
            while any(
                g < gen and c > 0
                for g, c in self._gen_pending.items()
            ):
                self._cv.wait()
            self._cur_gen = gen
            self._cur_pending = {}
            self._cur_failed = set()
            for s, _k, _f, _n in jobs:
                self._cur_pending[s] = self._cur_pending.get(s, 0) + 1
            self._gen_pending[gen] = len(jobs)
            self._pending_total += len(jobs)
            self.submitted += len(jobs)
        for slot, key, fn, nbytes in jobs:
            fut = self._pool.submit(key, fn, nbytes=nbytes)
            fut.add_done_callback(
                lambda f, g=gen, s=slot: self._on_done(g, s, f)
            )
        with self._cv:
            while True:
                acked = sum(
                    1
                    for s in slots
                    if self._cur_pending.get(s, 0) == 0
                    and s not in self._cur_failed
                )
                if acked >= quorum:
                    return self._take_dead_locked()
                possible = len(slots) - len(self._cur_failed)
                if possible < quorum:
                    # dead slots stay un-reported: the caller's error
                    # path drain() still gets to mark its writers
                    raise self._quorum_exc(
                        f"write quorum lost: {possible} < {quorum}"
                    )
                self._cv.wait()

    def drain(self) -> "set[int]":
        """Wait for every outstanding job (all batches); newly-dead set."""
        with self._cv:
            while self._pending_total > 0:
                self._cv.wait()
            return self._take_dead_locked()

# -- telemetry seam (lazy: avoid import cycles, tolerate bare installs) ---

_KS = None


def _kernel_stats():
    global _KS
    if _KS is None:
        from ..codec.telemetry import KERNEL_STATS

        _KS = KERNEL_STATS
    return _KS


def _stats_record_job(queue: str, nbytes: int, seconds: float, depth: int):
    _kernel_stats().record_io_job(queue, nbytes, seconds, depth)


def _stats_record_depth(queue: str, depth: int):
    _kernel_stats().record_io_depth(queue, depth)


# -- process-wide singleton (one I/O plane per process) -------------------

_POOL: "IOPool | None" = None
_POOL_LK = threading.Lock()


def get_pool() -> IOPool:
    global _POOL
    p = _POOL
    if p is None:
        with _POOL_LK:
            if _POOL is None:
                _POOL = IOPool()
            p = _POOL
    return p


def queued_depth() -> int:
    """Codec-stage queue-depth gauge for the server plane - reads the
    singleton without instantiating it (a scrape must not boot an I/O
    plane)."""
    p = _POOL
    return p.queued_jobs() if p is not None else 0


def stream_io_key(stream):
    """Routing key of a tagged writer/reader (identity fallback keeps
    untagged streams hash-routed without serializing them)."""
    return getattr(stream, "io_key", None) or id(stream)


def fanout(ops, pool: "IOPool | None" = None) -> list:
    """Run ``[(key, fn), ...]`` concurrently; return ``[error, ...]``
    (None on success) in submission order.  The object layer's per-disk
    commit loops (writer close -> fsync, rename_data -> meta fsync) go
    through here so a PUT pays one disk's metadata latency, not the sum
    over all n — fsync parks in the kernel and releases the GIL, so the
    overlap is real even on a single-core host."""
    p = pool or get_pool()
    futs = [p.submit(k, f) for k, f in ops]
    errs = []
    for fut in futs:
        fut.wait()
        errs.append(fut.error)
    return errs


def wait_any(futs, timeout: "float | None" = None) -> list:
    """Block until at least one future is finished; return the finished
    subset (empty list = deadline expired with nothing done).

    This is the hedging loop's clock: ``codec/erasure.py`` waits on its
    outstanding shard reads with the p99-derived deadline and, when the
    list comes back empty, launches a duplicate read on the next
    preferred shard instead of blocking on the straggler.
    """
    done = [f for f in futs if f.done()]
    if done or not futs:
        return done
    ev = threading.Event()

    def _wake(_f, _ev=ev):
        _ev.set()

    for f in futs:
        f.add_done_callback(_wake)
    ev.wait(timeout)
    return [f for f in futs if f.done()]


def tag_io_key(obj, key: str) -> None:
    """Stamp a writer/reader with its routing key (best effort: remote
    stubs with __slots__ simply keep id()-hash routing)."""
    try:
        obj.io_key = key
    except AttributeError as exc:
        _log.debug("io_key tag skipped", extra=kv(key=key, err=str(exc)))


def disk_io_key(disk) -> "str | None":
    """Stable routing key for a StorageAPI disk: its endpoint string."""
    fn = getattr(disk, "endpoint", None)
    if fn is None:
        return None
    try:
        return str(fn())
    except Exception as exc:  # noqa: BLE001 - route by identity instead
        _log.debug("disk endpoint probe failed", extra=kv(err=str(exc)))
        return None


def tag_disk_stream(stream, disk):
    """Route a shard writer/reader to its disk's ordered pool queue;
    returns the stream for inline use at construction sites."""
    if stream is not None:
        key = disk_io_key(disk)
        if key:
            tag_io_key(stream, key)
    return stream
