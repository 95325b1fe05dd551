"""Prometheus metrics (cmd/metrics.go:66-507).

A process-local registry fed by the request middleware plus live
gauges scraped from the object layer (per-disk usage + per-API disk
latencies), the heal routine, the codec kernel telemetry registry
(codec/telemetry.py), the tiered read cache (cache/), and the audit
log, rendered in the Prometheus text exposition format 0.0.4 at
``/minio-tpu/prometheus/metrics``.

The mesh placement families (slice 10) come with the slice that ports
what feeds them.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left

START_TIME = time.time()

# Serving-path latency distributions (cmd/metrics.go httpRequestsDuration).
# TTFB buckets reach lower: first byte on a cache/metadata hit is sub-ms.
DURATION_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
TTFB_BUCKETS = (
    0.001, 0.003, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def _escape_label(v) -> str:
    """Label-value escaping per the text-format spec: backslash first."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    """HELP text allows everything except raw newlines and backslashes."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_bound(b: float) -> str:
    """Bucket boundary as Prometheus renders it: 0.05, 1, 2.5."""
    return format(b, "g")


class Histogram:
    """Thread-safe fixed-bucket histogram keyed by one label value.

    Observations land in the first bucket whose upper bound is >= the
    value (``le`` semantics); values beyond the last bound go to the
    implicit ``+Inf`` overflow slot.  ``collect()`` returns cumulative
    bucket counts ready for ``_bucket``/``_sum``/``_count`` rendering.
    """

    def __init__(self, buckets: "tuple[float, ...]"):
        self.buckets = tuple(sorted(buckets))
        self._mu = threading.Lock()
        # key -> [per-bucket counts..., overflow]
        self._counts: "dict[str, list[int]]" = {}
        self._sums: "dict[str, float]" = {}

    def observe(self, key: str, value: float) -> None:
        if value < 0:
            value = 0.0
        idx = bisect_left(self.buckets, value)
        with self._mu:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[idx] += 1
            self._sums[key] += value

    def collect(self):
        """Per key: (cumulative bucket counts incl. +Inf, sum, count)."""
        with self._mu:
            snap = {
                k: (list(v), self._sums[k]) for k, v in self._counts.items()
            }
        out = []
        for key in sorted(snap):
            counts, total = snap[key]
            cum, acc = [], 0
            for c in counts:
                acc += c
                cum.append(acc)
            out.append((key, cum, total, acc))
        return out


class Metrics:
    """Thread-safe counters for the serving path."""

    def __init__(self):
        self._mu = threading.Lock()
        # (api, code) -> count
        self.requests: "dict[tuple[str, str], int]" = {}
        # api -> [count, total_seconds]
        self.latency: "dict[str, list]" = {}
        self.bytes_rx = 0
        self.bytes_tx = 0
        self.duration_hist = Histogram(DURATION_BUCKETS)
        self.ttfb_hist = Histogram(TTFB_BUCKETS)

    def observe(
        self,
        api: str,
        code: int,
        seconds: float,
        bytes_in: int = 0,
        bytes_out: int = 0,
        ttfb: "float | None" = None,
    ) -> None:
        with self._mu:
            key = (api, str(code))
            self.requests[key] = self.requests.get(key, 0) + 1
            lat = self.latency.setdefault(api, [0, 0.0])
            lat[0] += 1
            lat[1] += seconds
            self.bytes_rx += bytes_in
            self.bytes_tx += bytes_out
        self.duration_hist.observe(api, seconds)
        if ttfb is not None:
            self.ttfb_hist.observe(api, ttfb)

    # -- rendering --------------------------------------------------------

    def render(
        self, object_layer=None, heal=None, queue=None, audit=None,
        plane=None,
    ) -> bytes:
        """The exposition document; live gauges are sampled now."""
        out: list[str] = []

        def emit(name, mtype, help_, samples):
            out.append(f"# HELP {name} {_escape_help(help_)}")
            out.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                lbl = (
                    "{"
                    + ",".join(
                        f'{k}="{_escape_label(v)}"'
                        for k, v in labels.items()
                    )
                    + "}"
                    if labels
                    else ""
                )
                out.append(f"{name}{lbl} {value}")

        def emit_histogram(name, help_, hist, label):
            out.append(f"# HELP {name} {_escape_help(help_)}")
            out.append(f"# TYPE {name} histogram")
            for key, cum, total, count in hist.collect():
                kv = f'{label}="{_escape_label(key)}"'
                for bound, c in zip(hist.buckets, cum):
                    out.append(
                        f'{name}_bucket{{{kv},le="{_fmt_bound(bound)}"}} {c}'
                    )
                out.append(f'{name}_bucket{{{kv},le="+Inf"}} {count}')
                out.append(f"{name}_sum{{{kv}}} {total:.6f}")
                out.append(f"{name}_count{{{kv}}} {count}")

        with self._mu:
            reqs = dict(self.requests)
            lat = {k: list(v) for k, v in self.latency.items()}
            rx, tx = self.bytes_rx, self.bytes_tx

        emit(
            "miniotpu_s3_requests_total",
            "counter",
            "S3 requests by API and HTTP code",
            [
                ({"api": api, "code": code}, n)
                for (api, code), n in sorted(reqs.items())
            ],
        )
        emit(
            "miniotpu_s3_request_seconds_total",
            "counter",
            "Cumulative request wall time by API",
            [
                ({"api": api}, f"{total:.6f}")
                for api, (_n, total) in sorted(lat.items())
            ],
        )
        emit(
            # counters must not end in _count (reserved for histogram
            # series); see MTPU104 in minio_tpu/analysis
            "miniotpu_s3_request_seconds_observations_total",
            "counter",
            "Requests counted toward request_seconds by API",
            [({"api": api}, n) for api, (n, _t) in sorted(lat.items())],
        )
        emit_histogram(
            "miniotpu_s3_request_duration_seconds",
            "S3 request wall-time distribution by API",
            self.duration_hist,
            "api",
        )
        emit_histogram(
            "miniotpu_s3_ttfb_seconds",
            "Time to first response byte by API",
            self.ttfb_hist,
            "api",
        )
        emit(
            "miniotpu_s3_rx_bytes_total", "counter",
            "Bytes received from S3 clients", [({}, rx)],
        )
        emit(
            "miniotpu_s3_tx_bytes_total", "counter",
            "Bytes sent to S3 clients", [({}, tx)],
        )
        emit(
            "miniotpu_process_uptime_seconds", "gauge",
            "Seconds since process start",
            [({}, f"{time.time() - START_TIME:.1f}")],
        )

        self._emit_codec(emit)
        self._emit_read_cache(emit)
        self._emit_select(emit)
        self._emit_disk_health(emit)

        if object_layer is not None:
            disks, usage = _disk_samples(object_layer)
            emit(
                "miniotpu_disks_total", "gauge",
                "Configured disks", [({}, disks[0])],
            )
            emit(
                "miniotpu_disks_offline", "gauge",
                "Offline disks", [({}, disks[1])],
            )
            emit(
                "miniotpu_disk_storage_used_bytes", "gauge",
                "Used bytes per disk",
                [({"disk": ep}, u) for ep, (u, _f, _t) in usage],
            )
            emit(
                "miniotpu_disk_storage_available_bytes", "gauge",
                "Free bytes per disk",
                [({"disk": ep}, f) for ep, (_u, f, _t) in usage],
            )
            emit(
                "miniotpu_disk_storage_total_bytes", "gauge",
                "Capacity per disk",
                [({"disk": ep}, t) for ep, (_u, _f, t) in usage],
            )
            self._emit_disk_api(emit, object_layer)
        if heal is not None:
            emit(
                "miniotpu_heal_objects_healed_total", "counter",
                "Objects healed by the background routine",
                [({}, heal.healed)],
            )
            emit(
                "miniotpu_heal_objects_failed_total", "counter",
                "Background heals that failed",
                [({}, heal.failed)],
            )
        if queue is not None:
            emit(
                "miniotpu_heal_queue_depth", "gauge",
                "Tasks waiting in the heal queue",
                [({}, len(queue))],
            )
        if audit is not None:
            emit(
                "miniotpu_audit_entries_dropped_total", "counter",
                "Audit entries lost to target write failures",
                [({}, getattr(audit, "dropped", 0))],
            )
        if plane is not None:
            # server-plane admission/backpressure families (PlaneStats
            # snapshot, server/admission.py); shed reasons are
            # zero-filled so the label set is stable across scrapes
            emit(
                "miniotpu_server_inflight_requests", "gauge",
                "Admitted S3 requests currently executing",
                [({}, plane.get("inflight", 0))],
            )
            emit(
                "miniotpu_server_stage_queue_depth", "gauge",
                "Requests waiting per server-plane stage",
                [
                    ({"stage": stage}, depth)
                    for stage, depth in sorted(
                        plane.get("stage_depth", {}).items()
                    )
                ],
            )
            from .admission import SHED_REASONS

            shed = plane.get("shed", {})
            emit(
                "miniotpu_server_shed_total", "counter",
                "Requests shed by admission control, by reason",
                [
                    ({"reason": r}, shed.get(r, 0))
                    for r in SHED_REASONS
                ],
            )
            loops = plane.get("loops") or []
            if loops:
                # multi-loop plane breakdown: one series per loop for
                # every family (and per loop x reason for sheds), all
                # zero-filled from the loop list so a scrape's shape
                # never depends on which loop saw traffic
                emit(
                    "miniotpu_server_loop_connections", "gauge",
                    "Open connections owned by each server loop",
                    [
                        ({"loop": str(s["loop"])},
                         s["stage_depth"].get("parse", 0))
                        for s in loops
                    ],
                )
                emit(
                    "miniotpu_server_loop_inflight_requests", "gauge",
                    "Admitted requests executing per server loop",
                    [
                        ({"loop": str(s["loop"])}, s["inflight"])
                        for s in loops
                    ],
                )
                emit(
                    "miniotpu_server_loop_handler_queue_depth", "gauge",
                    "Requests queued for each loop's worker slice",
                    [
                        ({"loop": str(s["loop"])},
                         s["stage_depth"].get("handler", 0))
                        for s in loops
                    ],
                )
                emit(
                    "miniotpu_server_loop_shed_total", "counter",
                    "Requests shed per server loop, by reason",
                    [
                        ({"loop": str(s["loop"]), "reason": r},
                         s["shed"].get(r, 0))
                        for s in loops
                        for r in SHED_REASONS
                    ],
                )
        return ("\n".join(out) + "\n").encode()

    @staticmethod
    def _emit_select(emit):
        """S3 Select pushdown families; every engine/reason cell is
        zero-filled so the label set is stable whether or not a scan
        has run (or the device engine exists on this node)."""
        from ..s3select.device import STATS, SelectStats

        snap = STATS.snapshot()
        emit(
            "miniotpu_select_requests_total", "counter",
            "Select evaluations by executing engine",
            [
                ({"engine": e}, snap["requests"].get(e, 0))
                for e in SelectStats.ENGINES
            ],
        )
        emit(
            "miniotpu_select_fallback_total", "counter",
            "Device-scan fallbacks to the host engines, by reason",
            [
                ({"reason": r}, snap["fallbacks"].get(r, 0))
                for r in SelectStats.REASONS
            ],
        )
        emit(
            "miniotpu_select_scanned_bytes_total", "counter",
            "Object bytes scanned by select evaluations",
            [({}, snap["scanned_bytes"])],
        )
        emit(
            "miniotpu_select_returned_bytes_total", "counter",
            "Result bytes produced by select evaluations",
            [({}, snap["returned_bytes"])],
        )
        emit(
            "miniotpu_select_device_seconds_total", "counter",
            "Wall seconds spent in the device scan phase",
            [({}, f"{snap['device_seconds']:.6f}")],
        )

    @staticmethod
    def _emit_read_cache(emit):
        """Tiered read-cache families; every (family, tier) cell is
        zero-filled so dashboards see identical shapes whether the
        cache is off, cold, or hot."""
        from .. import cache as rcache

        st = rcache.read_cache_stats()
        tiers = st["tiers"]

        def per_tier(field):
            return [
                ({"tier": t}, tiers[t][field]) for t in rcache.TIERS
            ]

        emit(
            "miniotpu_cache_hits_total", "counter",
            "Read-cache group hits by tier (digest re-verified)",
            per_tier("hits"),
        )
        emit(
            "miniotpu_cache_misses_total", "counter",
            "Read-cache group misses by tier",
            per_tier("misses"),
        )
        emit(
            "miniotpu_cache_evictions_total", "counter",
            "Read-cache groups evicted under budget pressure by tier",
            per_tier("evictions"),
        )
        emit(
            "miniotpu_cache_rejects_total", "counter",
            "Read-cache admissions rejected by tier (frequency contest"
            " losses and digest-verification drops)",
            per_tier("rejects"),
        )
        emit(
            "miniotpu_cache_entries", "gauge",
            "Read-cache resident groups by tier",
            per_tier("entries"),
        )
        emit(
            "miniotpu_cache_occupancy_bytes", "gauge",
            "Read-cache resident bytes by tier",
            per_tier("occupancy_bytes"),
        )
        emit(
            "miniotpu_cache_budget_bytes", "gauge",
            "Read-cache configured capacity by tier",
            per_tier("capacity_bytes"),
        )
        emit(
            "miniotpu_cache_demotions_total", "counter",
            "Device-tier groups demoted (written back) to the host tier",
            [({}, st["demotions"])],
        )
        emit(
            "miniotpu_cache_invalidations_total", "counter",
            "Object invalidations applied to the read cache",
            [({}, st["invalidations"])],
        )
        adm = st["admission"]
        emit(
            "miniotpu_cache_admission_events_total", "counter",
            "TinyLFU admission-filter events by kind",
            [
                ({"kind": kind}, adm[kind])
                for kind in (
                    "recorded", "seeded", "admitted", "rejected"
                )
            ],
        )

    @staticmethod
    def _emit_codec(emit):
        """Codec kernel families from the process-wide KernelStats."""
        from ..codec.telemetry import KERNEL_STATS

        snap = KERNEL_STATS.snapshot()
        ops = snap["ops"]
        emit(
            "miniotpu_codec_ops_total", "counter",
            "Codec backend kernel invocations by op and backend",
            [
                ({"op": o["op"], "backend": o["backend"]}, o["calls"])
                for o in ops
            ],
        )
        emit(
            "miniotpu_codec_bytes_total", "counter",
            "Bytes processed by codec kernels by op and backend",
            [
                ({"op": o["op"], "backend": o["backend"]}, o["bytes"])
                for o in ops
            ],
        )
        emit(
            "miniotpu_codec_seconds_total", "counter",
            "Host-observed device seconds in codec kernels",
            [
                (
                    {"op": o["op"], "backend": o["backend"]},
                    f'{o["seconds"]:.6f}',
                )
                for o in ops
            ],
        )
        b = snap["batch"]
        emit(
            "miniotpu_codec_batch_flushes_total", "counter",
            "Coalesced codec batch flushes", [({}, b["flushes"])],
        )
        emit(
            "miniotpu_codec_batch_jobs_total", "counter",
            "Jobs coalesced into codec batch flushes",
            [({}, b["jobs"])],
        )
        emit(
            "miniotpu_codec_batch_multi_client_flushes_total", "counter",
            "Codec batch flushes that merged jobs of several requests",
            [({}, b["multi_client_flushes"])],
        )
        emit(
            "miniotpu_codec_batch_blocks_total", "counter",
            "Blocks merged across codec batch flushes",
            [({}, b["blocks"])],
        )
        emit(
            "miniotpu_codec_batch_wait_seconds_total", "counter",
            "Cumulative queue wait across coalesced codec jobs",
            [({}, f'{b["wait_seconds"]:.6f}')],
        )
        streams = snap["streams"]
        emit(
            "miniotpu_codec_streams_total", "counter",
            "Erasure-coded object streams by kind",
            [({"op": s["kind"]}, s["streams"]) for s in streams],
        )
        emit(
            "miniotpu_codec_stream_bytes_total", "counter",
            "Object bytes pushed through erasure streams by kind",
            [({"op": s["kind"]}, s["bytes"]) for s in streams],
        )
        emit(
            "miniotpu_codec_stream_heal_required_total", "counter",
            "Decoded streams that reported shards needing heal",
            [({}, snap["heal_required"])],
        )
        d2h = snap.get("d2h", [])
        emit(
            "miniotpu_codec_d2h_bytes_total", "counter",
            "Device->host codec readback bytes by plane (data|parity)",
            [({"plane": r["plane"]}, r["bytes"]) for r in d2h],
        )
        emit(
            "miniotpu_codec_d2h_transfers_total", "counter",
            "Device->host codec readback transfers by plane",
            [({"plane": r["plane"]}, r["transfers"]) for r in d2h],
        )
        h2d = {r["plane"]: r for r in snap.get("h2d", [])}
        emit(
            "miniotpu_codec_h2d_bytes_total", "counter",
            "Host->device codec staging bytes by plane (data|parity)",
            [({"plane": p}, h2d.get(p, {}).get("bytes", 0))
             for p in ("data", "parity")],
        )
        emit(
            "miniotpu_codec_h2d_transfers_total", "counter",
            "Host->device codec staging transfers by plane",
            [({"plane": p}, h2d.get(p, {}).get("transfers", 0))
             for p in ("data", "parity")],
        )
        ow = snap.get("overlap_windows", {})
        emit(
            "miniotpu_codec_overlap_windows_total", "counter",
            "Transfer/compute overlap windows opened by direction "
            "(put = encode side, get = verify/reconstruct side)",
            [({"direction": d}, ow.get(d, 0)) for d in ("put", "get")],
        )
        pc = snap.get("parity_cache", {})
        emit(
            "miniotpu_codec_parity_cache_bytes", "gauge",
            "Device-resident parity plane bytes currently cached",
            [({}, pc.get("occupancy_bytes", 0))],
        )
        emit(
            "miniotpu_codec_parity_cache_entries", "gauge",
            "Device-resident parity planes currently cached",
            [({}, pc.get("entries", 0))],
        )
        emit(
            "miniotpu_codec_parity_cache_evictions_total", "counter",
            "Parity planes drained early by write-back eviction",
            [({}, pc.get("evictions", 0))],
        )
        hedge = snap.get("hedge", {})
        emit(
            "miniotpu_hedge_launched_total", "counter",
            "Duplicate shard reads launched past the p99 deadline",
            [({}, hedge.get("launched", 0))],
        )
        emit(
            "miniotpu_hedge_won_total", "counter",
            "Hedged reads that delivered intact shard frames",
            [({}, hedge.get("won", 0))],
        )
        emit(
            "miniotpu_hedge_wasted_total", "counter",
            "Hedged reads abandoned without contributing",
            [({}, hedge.get("wasted", 0))],
        )
        stages = snap["stages"]
        emit(
            "miniotpu_codec_stage_seconds_total", "counter",
            "Per-stream stage time (assemble/codec/disk) by op",
            [
                (
                    {"op": s["op"], "stage": s["stage"]},
                    f'{s["seconds"]:.6f}',
                )
                for s in stages
            ],
        )
        io = snap["iopool"]
        emit(
            "miniotpu_iopool_jobs_total", "counter",
            "I/O fan-out jobs completed per pool queue",
            [({"queue": q["queue"]}, q["jobs"]) for q in io["queues"]],
        )
        emit(
            "miniotpu_iopool_bytes_total", "counter",
            "Shard bytes moved through the I/O fan-out per pool queue",
            [({"queue": q["queue"]}, q["bytes"]) for q in io["queues"]],
        )
        emit(
            "miniotpu_iopool_busy_seconds_total", "counter",
            "Worker time spent inside I/O jobs per pool queue",
            [
                ({"queue": q["queue"]}, f'{q["busy_seconds"]:.6f}')
                for q in io["queues"]
            ],
        )
        emit(
            "miniotpu_iopool_queue_depth_peak", "gauge",
            "High-water mark of any fan-out queue's backlog",
            [({}, io["depth_hwm"])],
        )
        emit(
            "miniotpu_iopool_slowest_job_seconds", "gauge",
            "Longest single I/O job observed (the slowest-disk signal)",
            [({}, f'{io["slowest_job_seconds"]:.6f}')],
        )

    @staticmethod
    def _emit_disk_health(emit):
        """Breaker states + read-latency quantiles (storage/health.py)."""
        from ..storage import health as disk_health

        reg = disk_health.registry()
        snap = reg.snapshot()
        states = reg.states()
        emit(
            "miniotpu_disk_state", "gauge",
            "Circuit-breaker state per disk"
            " (0=healthy, 1=suspect, 2=tripped)",
            [
                ({"disk": ep}, st)
                for ep, st in sorted(states.items())
            ],
        )
        p99s = [
            ({"disk": ep}, f'{row["read_p99_seconds"]:.6f}')
            for ep, row in sorted(snap["disks"].items())
            if row.get("read_p99_seconds") is not None
        ]
        pool_p99 = snap["pool"]["read_p99_seconds"]
        if pool_p99 is not None:
            p99s.append(({"disk": "_pool"}, f"{pool_p99:.6f}"))
        emit(
            "miniotpu_disk_read_p99_seconds", "gauge",
            "Streaming p99 of shard-read latency per disk"
            " (_pool = pool-wide, the hedge-deadline input)",
            p99s,
        )
        emit(
            "miniotpu_disk_breaker_trips_total", "counter",
            "Circuit-breaker trips per disk",
            [
                ({"disk": ep}, row["trips"])
                for ep, row in sorted(snap["disks"].items())
            ],
        )

    @staticmethod
    def _emit_disk_api(emit, object_layer):
        """Per-disk per-API families from any MeteredDisk in the layer."""
        calls, errors, seconds = [], [], []
        p99s = []
        for d in _iter_disks(object_layer):
            stats_fn = getattr(d, "api_stats", None)
            if not callable(stats_fn):
                continue
            try:
                ep, stats = d.metered_endpoint(), stats_fn()
            except Exception:  # noqa: BLE001
                continue
            for api, row in sorted(stats.items()):
                kv = {"disk": ep, "api": api}
                calls.append((kv, row["calls"]))
                errors.append((kv, row["errors"]))
                seconds.append((kv, f'{row["seconds"]:.6f}'))
                if row.get("p99_seconds") is not None:
                    p99s.append((kv, f'{row["p99_seconds"]:.6f}'))
        emit(
            "miniotpu_disk_api_calls_total", "counter",
            "Storage API calls by disk and API", calls,
        )
        emit(
            "miniotpu_disk_api_errors_total", "counter",
            "Storage API errors by disk and API", errors,
        )
        emit(
            "miniotpu_disk_api_seconds_total", "counter",
            "Cumulative storage API latency by disk and API", seconds,
        )
        emit(
            "miniotpu_disk_api_p99_seconds", "gauge",
            "Streaming p99 latency by disk and API (P2 estimator)",
            p99s,
        )


def _iter_disks(object_layer):
    zones = getattr(object_layer, "zones", None)
    if zones is not None:
        for z in zones:
            yield from _iter_disks(z)
        return
    sets = getattr(object_layer, "sets", None)
    if sets is not None:
        for s in sets:
            yield from _iter_disks(s)
        return
    yield from getattr(object_layer, "disks", [])


def _disk_samples(object_layer):
    total = offline = 0
    usage = []
    for d in _iter_disks(object_layer):
        total += 1
        if d is None or not _safe_online(d):
            offline += 1
            continue
        try:
            info = d.disk_info()
            usage.append(
                (info.endpoint, (info.used, info.free, info.total))
            )
        except Exception:  # noqa: BLE001
            offline += 1
    return (total, offline), usage


def _safe_online(d) -> bool:
    try:
        return d.is_online()
    except Exception:  # noqa: BLE001
        return False
