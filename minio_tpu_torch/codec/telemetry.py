"""Codec kernel telemetry: what the fused device passes actually did.

The paper's thesis lives in the byte-crunching hot paths (RS erasure,
bitrot hashing) running as batched device passes behind the
``reedsolomon.Encoder``-shaped seam (backend.py).  This module measures
those passes in production:

* ``KernelStats`` - process-wide registry of per-op counters: calls,
  bytes processed, and host-observed device seconds, labeled by the
  resolved backend; plus batcher occupancy (jobs
  coalesced per flush, queue wait) and erasure-stream totals.
* ``InstrumentedBackend`` - a CodecBackend decorator recording every
  encode / encode_begin-end / digest / reconstruct /
  reconstruct_and_verify through the seam.
  It wraps the CONCRETE backend (below the batching layer), so a
  coalesced flush counts as one call and its seconds are real device
  launch time, not queue wait - queue wait is the batcher's own series.

"Device seconds" are host-observed: the time the calling thread spends
inside the codec call (for the async begin/end pair, dispatch time plus
materialization time).  On a host-only backend that IS compute time; on
a device backend it includes H2D/D2H transfers - which is exactly the
cost an operator provisioning the serving path cares about.

``KERNEL_STATS.snapshot()`` is the JSON-friendly dump (admin
``kernel-stats``), exported as ``miniotpu_codec_*`` Prometheus families
by server/metrics.py; the placement counters come from the batcher's
submesh routing (codec/batcher.py).  Kernel LAUNCHES (as opposed to
codec passes) are counted by ops/kernels.py.
"""

from __future__ import annotations

import os
import threading
import time

from .backend import CodecBackend


class KernelStats:
    """Thread-safe registry of codec hot-path counters."""

    def __init__(self):
        self._mu = threading.Lock()
        # (op, backend) -> [calls, bytes, seconds]
        self._ops: "dict[tuple[str, str], list]" = {}
        # batcher occupancy: flushes, jobs, blocks, queue-wait seconds
        # flushes, jobs, blocks, wait seconds, flushes merging clients
        self._batch = [0, 0, 0, 0.0, 0]
        # erasure-layer streams: kind -> [streams, bytes]
        self._streams: "dict[str, list]" = {}
        self._heal_required = 0
        # per-stream stage breakdown: (op, stage) -> [streams, seconds]
        # op in {"put","get","heal"}, stage in {"assemble","codec",
        # "codec_fused","disk"} - codec_fused is encode time on a
        # backend whose parity+digest pass is fused (erasure._codec_stage)
        self._stages: "dict[tuple[str, str], list]" = {}
        # iopool fan-out plane: queue -> [jobs, bytes, busy_seconds]
        self._iopool: "dict[str, list]" = {}
        self._iopool_depth_hwm = 0
        self._iopool_slowest_s = 0.0
        # hedged shard reads: kind in {launched, won, wasted}
        self._hedge: "dict[str, int]" = {}
        # device->host readback by plane: plane -> [transfers, bytes];
        # plane in {"data", "parity"} (digests ride the data plane).
        # The parity-plane PUT restructure exists to drive the parity
        # row of this table to the post-ack drain band only
        self._d2h: "dict[str, list]" = {}
        # host->device staging by plane (mirror of _d2h), and overlap
        # windows by direction (put|get): a sub-chunk or kernel tile step
        # whose transfer was in flight while a neighbour's compute ran -
        # the count that shows MINIO_TPU_CODEC_OVERLAP engaged
        self._h2d: "dict[str, list]" = {}
        self._overlap: "dict[str, int]" = {}
        # codec passes by entry point: fused1 runs one pass per
        # direction per batch
        self._passes: "dict[str, int]" = {}
        # submesh placement: outcome ("span"|"route") -> batches, and
        # per-submesh in-flight depth (current + high-water mark)
        self._placement: "dict[str, int]" = {}
        self._submesh_depth: "dict[str, int]" = {}
        self._submesh_depth_hwm: "dict[str, int]" = {}

    # -- recording --------------------------------------------------------

    def record_op(
        self, op: str, backend: str, nbytes: int, seconds: float
    ) -> None:
        with self._mu:
            row = self._ops.setdefault((op, backend), [0, 0, 0.0])
            row[0] += 1
            row[1] += nbytes
            row[2] += seconds

    def record_batch_flush(
        self, jobs: int, blocks: int, wait_s: float, clients: int = 1
    ) -> None:
        """One batcher flush of ``jobs`` jobs submitted by ``clients``
        distinct threads (requests): more than one is a cross-request
        merge."""
        with self._mu:
            self._batch[0] += 1
            self._batch[1] += jobs
            self._batch[2] += blocks
            self._batch[3] += wait_s
            self._batch[4] += clients > 1

    def record_stream(self, kind: str, nbytes: int) -> None:
        with self._mu:
            row = self._streams.setdefault(kind, [0, 0])
            row[0] += 1
            row[1] += nbytes

    def record_heal_required(self) -> None:
        with self._mu:
            self._heal_required += 1

    def record_d2h(self, plane: str, nbytes: int) -> None:
        """One device->host codec transfer (plane = data|parity)."""
        with self._mu:
            row = self._d2h.setdefault(plane, [0, 0])
            row[0] += 1
            row[1] += nbytes

    def record_h2d(self, plane: str, nbytes: int) -> None:
        """One host->device codec staging transfer (plane = data|parity)."""
        with self._mu:
            row = self._h2d.setdefault(plane, [0, 0])
            row[0] += 1
            row[1] += nbytes

    def record_overlap_windows(self, plane: str, windows: int) -> None:
        """``windows`` sub-chunks (or in-kernel tile steps) whose
        transfer overlapped a neighbour's compute, keyed by direction:
        plane = put (encode side) | get (verify/reconstruct side)."""
        with self._mu:
            self._overlap[plane] = self._overlap.get(plane, 0) + windows

    def record_pass(self, kernel: str) -> None:
        """One codec device pass by entry-point name — backend.py
        records these at every pass site."""
        with self._mu:
            self._passes[kernel] = self._passes.get(kernel, 0) + 1

    def record_stages(self, op: str, stages: "dict[str, float]") -> None:
        """One stream's stage breakdown (assemble / codec / disk)."""
        with self._mu:
            for stage, seconds in stages.items():
                row = self._stages.setdefault((op, stage), [0, 0.0])
                row[0] += 1
                row[1] += seconds

    def record_io_job(
        self, queue: str, nbytes: int, seconds: float, depth: int
    ) -> None:
        """One completed iopool job; ``depth`` is the queue's backlog
        at dequeue (the slowest-disk signal: a healthy disk drains to
        zero, a straggler's queue stays deep)."""
        with self._mu:
            row = self._iopool.setdefault(queue, [0, 0, 0.0])
            row[0] += 1
            row[1] += nbytes
            row[2] += seconds
            if depth > self._iopool_depth_hwm:
                self._iopool_depth_hwm = depth
            if seconds > self._iopool_slowest_s:
                self._iopool_slowest_s = seconds

    def record_hedge(self, kind: str) -> None:
        """One hedged-read event: ``launched`` (duplicate read fired),
        ``won`` (the hedge produced intact shard cells), ``wasted``
        (abandoned without contributing)."""
        with self._mu:
            self._hedge[kind] = self._hedge.get(kind, 0) + 1

    def record_io_depth(self, queue: str, depth: int) -> None:
        """Queue depth observed at enqueue (high-water mark only)."""
        with self._mu:
            if depth > self._iopool_depth_hwm:
                self._iopool_depth_hwm = depth

    def record_placement(self, outcome: str) -> None:
        """One batch placement decision (outcome = span|route)."""
        with self._mu:
            self._placement[outcome] = self._placement.get(outcome, 0) + 1

    def record_submesh_depths(self, depths: "dict[str, int]") -> None:
        """Live per-submesh queue depths from the placement router."""
        with self._mu:
            for name, depth in depths.items():
                self._submesh_depth[name] = depth
                if depth > self._submesh_depth_hwm.get(name, 0):
                    self._submesh_depth_hwm[name] = depth

    # -- reading ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-friendly dump of every counter."""
        with self._mu:
            return {
                "ops": [
                    {
                        "op": op,
                        "backend": be,
                        "calls": calls,
                        "bytes": nbytes,
                        "seconds": round(secs, 6),
                    }
                    for (op, be), (calls, nbytes, secs) in sorted(
                        self._ops.items()
                    )
                ],
                "batch": {
                    "flushes": self._batch[0],
                    "jobs": self._batch[1],
                    "blocks": self._batch[2],
                    "wait_seconds": round(self._batch[3], 6),
                    "multi_client_flushes": self._batch[4],
                },
                "streams": [
                    {"kind": kind, "streams": n, "bytes": nbytes}
                    for kind, (n, nbytes) in sorted(
                        self._streams.items()
                    )
                ],
                "heal_required": self._heal_required,
                "d2h": [
                    {"plane": plane, "transfers": n, "bytes": nbytes}
                    for plane, (n, nbytes) in sorted(self._d2h.items())
                ],
                "h2d": [
                    {"plane": plane, "transfers": n, "bytes": nbytes}
                    for plane, (n, nbytes) in sorted(self._h2d.items())
                ],
                "overlap_windows": {
                    plane: self._overlap.get(plane, 0)
                    for plane in ("put", "get")
                },
                "device_passes": dict(sorted(self._passes.items())),
                "parity_cache": _parity_cache_stats(),
                "hedge": {
                    kind: self._hedge.get(kind, 0)
                    for kind in ("launched", "won", "wasted")
                },
                "stages": [
                    {
                        "op": op,
                        "stage": stage,
                        "streams": n,
                        "seconds": round(secs, 6),
                    }
                    for (op, stage), (n, secs) in sorted(
                        self._stages.items()
                    )
                ],
                "placement": {
                    outcome: self._placement.get(outcome, 0)
                    for outcome in ("span", "route")
                },
                "submeshes": [
                    {
                        "submesh": name,
                        "depth": self._submesh_depth.get(name, 0),
                        "depth_hwm": hwm,
                    }
                    for name, hwm in sorted(
                        self._submesh_depth_hwm.items()
                    )
                ],
                "iopool": {
                    "queues": [
                        {
                            "queue": q,
                            "jobs": jobs,
                            "bytes": nbytes,
                            "busy_seconds": round(busy, 6),
                        }
                        for q, (jobs, nbytes, busy) in sorted(
                            self._iopool.items()
                        )
                    ],
                    "depth_hwm": self._iopool_depth_hwm,
                    "slowest_job_seconds": round(
                        self._iopool_slowest_s, 6
                    ),
                },
            }

    def reset(self) -> None:
        with self._mu:
            self._ops.clear()
            self._batch = [0, 0, 0, 0.0, 0]
            self._streams.clear()
            self._heal_required = 0
            self._stages.clear()
            self._iopool.clear()
            self._iopool_depth_hwm = 0
            self._iopool_slowest_s = 0.0
            self._hedge.clear()
            self._d2h.clear()
            self._h2d.clear()
            self._overlap.clear()
            self._passes.clear()
            self._placement.clear()
            self._submesh_depth.clear()
            self._submesh_depth_hwm.clear()


def _parity_cache_stats() -> dict:
    """Live occupancy of the device parity-plane cache (backend.py) —
    read at snapshot time, not accumulated here, because the cache is
    its own source of truth for current occupancy."""
    from . import backend as backend_mod

    return backend_mod.parity_cache_stats()


# Process-wide singleton: one codec seam per process (backend.py caches
# one backend), so one registry; tests reset() it.
KERNEL_STATS = KernelStats()


class InstrumentedBackend(CodecBackend):
    """CodecBackend decorator feeding a KernelStats registry.

    ``name`` mirrors the inner backend.
    ``verify`` is inherited from CodecBackend on purpose: the default
    routes through ``self.digest`` and is therefore recorded.
    """

    def __init__(self, inner: CodecBackend, stats: "KernelStats | None" = None):
        self.inner = inner
        self.stats = stats if stats is not None else KERNEL_STATS
        self.name = getattr(inner, "name", "unknown")

    @property
    def fused_encode(self):  # type: ignore[override]
        # live delegation, not an __init__ snapshot: CpuBackend demotes
        # this when its native build fails mid-process
        return getattr(self.inner, "fused_encode", False)

    def _timed(self, op: str, nbytes: int, fn):
        t0 = time.monotonic()
        try:
            return fn()
        finally:
            self.stats.record_op(
                op, self.name, nbytes, time.monotonic() - t0
            )

    def encode(self, data, parity_shards):
        return self._timed(
            "encode",
            data.nbytes,
            lambda: self.inner.encode(data, parity_shards),
        )

    def encode_begin(self, data, parity_shards):
        # async pair: dispatch time here, materialization time in
        # encode_end; recorded once, at end, as one encode call
        t0 = time.monotonic()
        handle = self.inner.encode_begin(data, parity_shards)
        return ("ktel", handle, time.monotonic() - t0, data.nbytes)

    def encode_end(self, handle):
        if not (
            isinstance(handle, tuple)
            and len(handle) == 4
            and handle[0] == "ktel"
        ):
            return self.inner.encode_end(handle)
        _tag, inner_handle, dispatch_s, nbytes = handle
        t0 = time.monotonic()
        try:
            return self.inner.encode_end(inner_handle)
        finally:
            self.stats.record_op(
                "encode",
                self.name,
                nbytes,
                dispatch_s + (time.monotonic() - t0),
            )

    def encode_digest_begin(self, data, parity_shards):
        # digest-only twin of the encode pair: same one-call recording
        # at end, under the op name "encode_digest" so the readback
        # restructure shows up as its own series next to "encode"
        t0 = time.monotonic()
        handle = self.inner.encode_digest_begin(data, parity_shards)
        return ("ktel", handle, time.monotonic() - t0, data.nbytes)

    def encode_digest_end(self, handle):
        if not (
            isinstance(handle, tuple)
            and len(handle) == 4
            and handle[0] == "ktel"
        ):
            return self.inner.encode_digest_end(handle)
        _tag, inner_handle, dispatch_s, nbytes = handle
        t0 = time.monotonic()
        try:
            return self.inner.encode_digest_end(inner_handle)
        finally:
            self.stats.record_op(
                "encode_digest",
                self.name,
                nbytes,
                dispatch_s + (time.monotonic() - t0),
            )

    def parity_cache_pressure(self) -> float:
        return self.inner.parity_cache_pressure()

    @property
    def device(self):
        """The inner backend's device (codec_overlap_mode resolves its
        default from it)."""
        return getattr(self.inner, "device", None)

    def placement_router(self):
        # explicit delegation (this wrapper has no __getattr__): the
        # batcher feature-detects the routing seam through it
        return self.inner.placement_router()

    def digest(self, shards):
        return self._timed(
            "digest", shards.nbytes, lambda: self.inner.digest(shards)
        )

    def reconstruct(self, shards, present, data_shards, parity_shards):
        return self._timed(
            "reconstruct",
            shards.nbytes,
            lambda: self.inner.reconstruct(
                shards, present, data_shards, parity_shards
            ),
        )

    def reconstruct_and_verify(
        self, shards, digests, present, data_shards, parity_shards
    ):
        # explicit delegation: the CodecBackend default would compose
        # self.verify + self.reconstruct and silently bypass the
        # inner backend's fused single-pass implementation
        return self._timed(
            "reconstruct_and_verify",
            shards.nbytes,
            lambda: self.inner.reconstruct_and_verify(
                shards, digests, present, data_shards, parity_shards
            ),
        )


def instrument(
    backend: CodecBackend, stats: "KernelStats | None" = None
) -> CodecBackend:
    """Wrap a concrete backend with kernel telemetry (idempotent).

    MINIO_TPU_NO_INSTRUMENT=1 returns the backend bare, as in the JAX
    package: the codec without the per-op timing and accounting wrapper
    in the loop."""
    if os.environ.get("MINIO_TPU_NO_INSTRUMENT") == "1":
        return backend
    if isinstance(backend, InstrumentedBackend):
        return backend
    return InstrumentedBackend(backend, stats)
