"""Cross-request codec batching (SURVEY.md section 7 stage 8).

Concurrent PutObject/GetObject requests each produce small codec calls
(a few blocks per pass).  Launched independently they serialize on the
device and pay per-launch overhead; the reference's analogue is the
per-disk goroutine fan-out feeding one disk queue
(cmd/erasure-encode.go:39-70).  Here ALL requests feed one device queue:

* client threads submit jobs (encode / digest / reconstruct) and block;
* a single dispatcher thread coalesces jobs with identical geometry
  into one batched device call, then scatters results back;
* a batch is flushed as soon as every currently-active client has
  submitted (nobody left to wait for), or when ``deadline_s`` expires -
  so a lone stream pays ~zero extra latency while 8 concurrent streams
  coalesce into one launch (the "dynamic batch deadlines" risk note in
  SURVEY.md section 7).

Correctness is trivial: the grouped call is the same math on a
concatenated batch axis, and results are split back by row counts.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from .backend import CodecBackend
from .telemetry import KERNEL_STATS


class _Job:
    __slots__ = (
        "op", "key", "arrays", "result", "error", "done", "created",
        "client", "ended",
    )

    def __init__(self, op: str, key: tuple, arrays: tuple):
        self.op = op
        self.key = key
        self.arrays = arrays
        self.result = None
        self.error: "BaseException | None" = None
        self.done = threading.Event()
        self.created = time.monotonic()
        self.client = threading.get_ident()
        # set by the first encode_end: a second end of the same handle
        # (error-path cleanup racing the normal consume) must not
        # decrement _active again — that corrupts the distinct-client
        # flush signal for every later batch
        self.ended = False


class _SlicedParityRef:
    """View of a coalesced batch's parity ref: drain pulls the PARENT
    (one shared D2H for the whole merged flush) and hands back this
    job's rows.  release is a no-op — sibling jobs may still need the
    parent, which stays governed by the write-back cache either way."""

    __slots__ = ("_parent", "_lo", "_hi")

    def __init__(self, parent, lo: int, hi: int):
        self._parent = parent
        self._lo = lo
        self._hi = hi

    @property
    def nbytes(self) -> int:
        return 0  # the parent ref carries the cache accounting

    def drain(self):
        return self._parent.drain()[self._lo : self._hi]

    def release(self) -> None:
        return None


class BatchingBackend(CodecBackend):
    """Wrap any CodecBackend with cross-request batch coalescing."""

    name = "batched"

    def __init__(
        self,
        inner: CodecBackend,
        deadline_s: float = 0.004,
        max_batch_blocks: int = 256,
    ):
        self.inner = inner
        self.deadline_s = deadline_s
        self.max_batch_blocks = max_batch_blocks
        self._cv = threading.Condition()
        self._jobs: list[_Job] = []
        # client threads currently inside a codec call (submitted or
        # about to): thread ident -> outstanding call/handle count.
        # Distinct CLIENTS is the flush signal — a pipelined stream
        # holding an un-ended handle while submitting its next batch is
        # still one client, not two (counting raw handles makes the
        # "everyone submitted" fast path unreachable and every flush
        # waits out the full deadline)
        self._active: "dict[int, int]" = {}
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="codec-batcher", daemon=True
        )
        self._thread.start()

    # -- client side ------------------------------------------------------

    def _enter(self, client: int) -> None:
        """cv held: one more outstanding call/handle for ``client``."""
        self._active[client] = self._active.get(client, 0) + 1

    def _exit(self, client: int) -> None:
        """cv held: drop one outstanding call/handle for ``client``."""
        left = self._active.get(client, 0) - 1
        if left <= 0:
            self._active.pop(client, None)
        else:
            self._active[client] = left

    def _submit(self, op: str, key: tuple, arrays: tuple):
        job = _Job(op, key, arrays)
        with self._cv:
            self._jobs.append(job)
            self._cv.notify_all()
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def encode(self, data, parity_shards):
        return self.encode_end(self.encode_begin(data, parity_shards))

    def encode_begin(self, data, parity_shards):
        """Non-blocking submit: the job coalesces and runs on the
        dispatcher while the caller flushes its PREVIOUS batch; the
        handle resolves in encode_end (double-buffered PUT pipeline).

        The handle counts toward _active until encode_end so that
        concurrent pipelined streams still coalesce; encode_end's
        decrement NOTIFIES the dispatcher, which then flushes as soon
        as every remaining active client has submitted instead of
        sleeping out the coalesce deadline."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        B, k, L = data.shape
        job = _Job("encode", (k, L, parity_shards), (data,))
        with self._cv:
            self._enter(job.client)
            self._jobs.append(job)
            self._cv.notify_all()
        return job

    def encode_end(self, handle):
        job = handle
        job.done.wait()
        with self._cv:
            # pair with the SUBMITTING thread's entry exactly once: a
            # pipelined caller may end a handle from a different
            # thread, and error-path cleanup may end it a second time
            if not job.ended:
                job.ended = True
                self._exit(job.client)
                self._cv.notify_all()
        if job.error is not None:
            raise job.error
        return job.result

    def encode_digest_begin(self, data, parity_shards):
        """Digest-only twin of encode_begin: coalesces across requests
        like encode, and admission BACKS OFF while the inner backend's
        parity cache is over budget — the flush policy's cache-pressure
        term, bounding device-resident parity under concurrency."""
        self._cache_backoff()
        data = np.ascontiguousarray(data, dtype=np.uint8)
        B, k, L = data.shape
        job = _Job("encode_digest", (k, L, parity_shards), (data,))
        with self._cv:
            self._enter(job.client)
            self._jobs.append(job)
            self._cv.notify_all()
        return job

    def encode_digest_end(self, handle):
        # same handle protocol as encode_end (idempotent, _exit once);
        # the result is (digests, parity_ref) instead of (parity, digests)
        return self.encode_end(handle)

    def parity_cache_pressure(self) -> float:
        return self.inner.parity_cache_pressure()

    @property
    def device(self):
        """The wrapped backend's device: the codec overlap mode and the
        async chain's staging belong to it, and run unchanged inside the
        merged calls below (a merged encode_digest drains through one
        parent ref, sub-chunked or not)."""
        return getattr(self.inner, "device", None)

    def _cache_backoff(self, bound_s: float = 0.25) -> None:
        """Stall new digest-encode admission briefly while the parity
        cache is at/over budget, so lazy drains catch up instead of
        every insert forcing a synchronous write-back eviction.  Time-
        bounded: a wedged drain band degrades to eviction, not a hang."""
        if self.inner.parity_cache_pressure() < 1.0:
            return
        deadline = time.monotonic() + bound_s
        while (
            self.inner.parity_cache_pressure() >= 1.0
            and time.monotonic() < deadline
        ):
            time.sleep(0.002)

    def digest(self, shards):
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        B, n, L = shards.shape
        client = threading.get_ident()
        with self._cv:
            self._enter(client)
        try:
            return self._submit("digest", (n, L), (shards,))
        finally:
            with self._cv:
                self._exit(client)
                self._cv.notify_all()

    def reconstruct(self, shards, present, data_shards, parity_shards):
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        B, n, L = shards.shape
        key = (n, L, tuple(bool(b) for b in present), data_shards,
               parity_shards)
        client = threading.get_ident()
        with self._cv:
            self._enter(client)
        try:
            return self._submit("reconstruct", key, (shards,))
        finally:
            with self._cv:
                self._exit(client)
                self._cv.notify_all()

    @property
    def fused_encode(self):  # type: ignore[override]
        return getattr(self.inner, "fused_encode", False)

    def reconstruct_and_verify(
        self, shards, digests, present, data_shards, parity_shards
    ):
        # straight delegation, no coalescing: this op serves heal - rare,
        # latency-insensitive, and keyed by a per-call digest array that
        # would defeat batch merging anyway.  The default composition
        # would route through self.verify/self.reconstruct and lose the
        # inner fused pass.
        return self.inner.reconstruct_and_verify(
            shards, digests, present, data_shards, parity_shards
        )

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=2)

    # -- dispatcher -------------------------------------------------------

    def _collect(self) -> "list[_Job]":
        """Take a coalescible batch off the queue (holds no deadline
        when every active client has already submitted)."""
        with self._cv:
            while self._running and not self._jobs:
                self._cv.wait(0.1)
            if not self._running and not self._jobs:
                return []
            deadline = time.monotonic() + self.deadline_s
            while True:
                # flush when nobody else could still contribute, when
                # the batch is big enough, or at the deadline.  The
                # contribution test compares DISTINCT clients: every
                # queued job's submitter is guaranteed active, so the
                # batch is complete exactly when each active client
                # has at least one job queued (a client pipelining two
                # begins is one contributor, not two)
                if (
                    len({j.client for j in self._jobs})
                    >= len(self._active)
                ):
                    break
                if (
                    sum(j.arrays[0].shape[0] for j in self._jobs)
                    >= self.max_batch_blocks
                ):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            jobs, self._jobs = self._jobs, []
            return jobs

    def _loop(self) -> None:
        while True:
            jobs = self._collect()
            if not jobs:
                if not self._running:
                    return
                continue
            now = time.monotonic()
            KERNEL_STATS.record_batch_flush(
                len(jobs),
                sum(j.arrays[0].shape[0] for j in jobs),
                sum(now - j.created for j in jobs),
                clients=len({j.client for j in jobs}),
            )
            groups: dict[tuple, list[_Job]] = {}
            for j in jobs:
                groups.setdefault((j.op, j.key), []).append(j)
            for (op, key), group in groups.items():
                self._run_group_safe(op, key, group)

    def _run_group_safe(
        self, op: str, key: tuple, group: "list[_Job]"
    ) -> None:
        try:
            self._run_group(op, key, group)
        except BaseException as e:  # noqa: BLE001
            for j in group:
                j.error = e
                j.done.set()

    def _run_group(self, op: str, key: tuple, group: "list[_Job]") -> None:
        if len(group) == 1:
            j = group[0]
            j.result = self._call(op, key, j.arrays[0])
            j.done.set()
            return
        rows = [j.arrays[0].shape[0] for j in group]
        merged = np.concatenate([j.arrays[0] for j in group], axis=0)
        out = self._call(op, key, merged)
        # split along the batch axis and fulfill each job
        offsets = np.cumsum([0] + rows)
        for i, j in enumerate(group):
            lo, hi = offsets[i], offsets[i + 1]
            if op == "encode":
                parity, digests = out
                j.result = (parity[lo:hi], digests[lo:hi])
            elif op == "encode_digest":
                digests, pref = out
                j.result = (
                    digests[lo:hi], _SlicedParityRef(pref, lo, hi)
                )
            else:
                j.result = out[lo:hi]
            j.done.set()

    def _call(self, op: str, key: tuple, arr):
        if op == "encode":
            return self.inner.encode(arr, key[2])
        if op == "encode_digest":
            return self.inner.encode_digest_end(
                self.inner.encode_digest_begin(arr, key[2])
            )
        if op == "digest":
            return self.inner.digest(arr)
        if op == "reconstruct":
            n, L, present, k, m = key
            return self.inner.reconstruct(arr, present, k, m)
        raise ValueError(f"unknown op {op}")


def maybe_wrap(backend: CodecBackend) -> CodecBackend:
    """Apply batching per MINIO_CODEC_BATCH (default on; "0"/"off"
    disable - the admin config seam writes on/off)."""
    if os.environ.get("MINIO_CODEC_BATCH", "on").lower() in ("0", "off"):
        return backend
    deadline_ms = 4.0
    try:
        deadline_ms = float(
            os.environ.get("MINIO_CODEC_BATCH_DEADLINE_MS") or 4.0
        )
    except ValueError:
        pass
    return BatchingBackend(backend, deadline_s=deadline_ms / 1e3)
