"""DataCrawler: the background namespace sweep
(cmd/data-crawler.go:62 runDataCrawler + cmd/data-usage.go).

One daemon thread cycles over every bucket:

- **usage accounting**: objects / versions / delete markers / logical
  bytes per bucket, persisted as one JSON document under the reserved
  meta volume (the dataUsageObjName cache the admin API and metrics
  serve) so a restart starts warm;
- **lifecycle enforcement**: each version is run through the bucket's
  parsed Lifecycle (ilm.ComputeAction) and expired objects/versions are
  deleted through the object layer - versioned buckets get a delete
  marker for current-version expiry exactly like applyLifecycle
  (data-crawler.go:877-907);
- **multipart hygiene**: incomplete uploads older than the rule's
  DaysAfterInitiation are aborted (the reference does this in the
  multipart cleanup sweep).

The crawler paces itself (``sleep_every``/``sleep_s``) instead of
scanning flat out - the dataCrawlSleepPerFolder throttle - so a big
namespace does not monopolize the disks.

When a :class:`~minio_tpu_torch.crawler.updatetracker.DataUpdateTracker`
is attached, each sweep first rotates the bloom filter
(cycleFilter, data-update-tracker.go:533) and skips buckets whose
cached usage exists and whose name never hit the filter.  Guards,
matching the reference's behavior: a bucket with lifecycle, FIFO
quota, or replication config is always swept (time alone changes what
those do), a full sweep runs every ``_FULL_SWEEP_EVERY`` cycles
(dataUsageUpdateDirCycles), and an incomplete filter (restart, peer
down) disables skipping for that sweep.

Full sweeps (and the first) also probe each latest version's shards
(``probe_object_health``, metadata only) and queue the damaged ones on
the MRF heal queue through ``heal_hook``.  ``stats`` counts what the
sweeps did - buckets crawled and skipped, versions expired, objects
evicted, heals queued, uploads aborted, replications re-queued - for
the admin API and the chip run; the usage snapshot itself is the JAX
package's document.  The replication catch-up pass (healReplication)
re-queues each latest version whose ``x-amz-replication-status`` is
still PENDING or FAILED on the ``replication`` pool.
"""

from __future__ import annotations

import dataclasses
import io
import os
import json
import threading
import time

from .. import cache as rcache
from ..ilm import Action, Lifecycle, LifecycleError
from ..objectlayer.api import META_BUCKET

from ..utils.log import kv, logger

_log = logger("crawler")

USAGE_PATH = "data-usage/usage.json"
# even "clean" buckets get re-swept this often (bloom false negatives
# are impossible, but cached usage can rot via out-of-band mutation)
_FULL_SWEEP_EVERY = 16
# counters of what the sweeps did (DataCrawler.stats)
STAT_KEYS = (
    "sweeps",
    "buckets_crawled",
    "buckets_skipped",
    "expired",
    "evicted",
    "heals_queued",
    "uploads_aborted",
    "replication_requeued",
)


@dataclasses.dataclass
class BucketUsage:
    objects: int = 0  # latest, non-delete-marker versions
    versions: int = 0  # every journal entry incl. markers
    delete_markers: int = 0
    size: int = 0  # logical (client-visible) bytes, latest versions
    versions_size: int = 0  # logical bytes across ALL versions

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DataUsage:
    """The cluster usage snapshot (madmin DataUsageInfo shape)."""

    last_update_ns: int = 0
    # bloom cycle index of the sweep that produced this snapshot
    cycles: int = 0
    buckets: "dict[str, BucketUsage]" = dataclasses.field(
        default_factory=dict
    )

    @property
    def objects_total(self) -> int:
        return sum(b.objects for b in self.buckets.values())

    @property
    def size_total(self) -> int:
        return sum(b.size for b in self.buckets.values())

    def to_dict(self) -> dict:
        return {
            "last_update_ns": self.last_update_ns,
            "cycles": self.cycles,
            "objects_total": self.objects_total,
            "size_total": self.size_total,
            "buckets_count": len(self.buckets),
            "buckets": {
                name: u.to_dict() for name, u in self.buckets.items()
            },
        }


class DataCrawler:
    """Background sweep thread; ``crawl_once`` is also callable
    directly (tests, admin-triggered scans)."""

    def __init__(
        self,
        object_layer,
        bucket_meta,
        interval_s: float = 60.0,
        events=None,
        ensure_event_rules=None,
        replication=None,
        sleep_every: int = 256,
        sleep_s: float = 0.05,
        tracker=None,
        cycle_bloom=None,
        leader_lock=None,
        heal_hook=None,
    ):
        self._ol = object_layer
        self._meta = bucket_meta
        self._interval = interval_s
        self._events = events
        # ReplicationPool for the healReplication catch-up pass
        self._replication = replication
        # data-update tracker: local instance, or a callable
        # (oldest, current) -> BloomResponse that unions the cluster's
        # filters (distributed mode); cycle_bloom wins when both given
        self._tracker = tracker
        self._cycle_bloom = cycle_bloom
        # distributed mode: a cluster-wide lock elects ONE sweeping
        # node per cycle (the reference serializes runDataCrawler
        # behind a leader lock for the same reason) - without it every
        # node would rotate every peer's bloom tracker with its own
        # unsynchronized counter and double-run lifecycle deletes
        self._leader_lock = leader_lock
        # heal-on-crawl (the reference's healObjects pass inside the
        # data scanner): on FULL sweeps, latest versions get a dry-run
        # shard probe and damaged objects are queued here
        self._heal_hook = heal_hook
        self._heal_sweep = False  # set per sweep in _crawl_locked
        # server callback hydrating a bucket's notification rules
        # before we fire (http.py ensure_event_rules); without it a
        # freshly restarted server would drop every expiry event
        self._ensure_event_rules = ensure_event_rules
        self._sleep_every = sleep_every
        self._sleep_s = sleep_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._mu = threading.Lock()
        self._crawl_mu = threading.Lock()  # one sweep at a time
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        self._usage = self._load_usage()

    def _count(self, key: str, n: int = 1) -> None:
        with self._mu:
            self.stats[key] += n

    def stats_snapshot(self) -> dict:
        with self._mu:
            return dict(self.stats)

    # -- usage persistence (data-usage.go storeDataUsageInBackend) --------

    def _load_usage(self) -> DataUsage:
        buf = io.BytesIO()
        try:
            self._ol.get_object(META_BUCKET, USAGE_PATH, buf)
            doc = json.loads(buf.getvalue())
            return DataUsage(
                last_update_ns=doc.get("last_update_ns", 0),
                cycles=doc.get("cycles", 0),
                buckets={
                    name: BucketUsage(**u)
                    for name, u in doc.get("buckets", {}).items()
                },
            )
        except Exception:  # noqa: BLE001 - cold start
            return DataUsage()

    def _store_usage(self, usage: DataUsage) -> None:
        raw = json.dumps(usage.to_dict()).encode()
        try:
            self._ol.put_object(
                META_BUCKET, USAGE_PATH, io.BytesIO(raw), len(raw)
            )
        except Exception as exc:
            _log.debug("usage cache store failed; next cycle retries", extra=kv(err=str(exc)))

    def usage(self) -> DataUsage:
        with self._mu:
            return self._usage

    # -- lifecycle --------------------------------------------------------

    def _bucket_lifecycle(self, bucket: str) -> "Lifecycle | None":
        try:
            raw = self._meta.get(bucket).lifecycle_xml
        except Exception:  # noqa: BLE001
            return None
        if not raw:
            return None
        try:
            return Lifecycle.from_xml(raw.encode())
        except LifecycleError:
            return None

    def _apply(self, bucket: str, oi, lc: "Lifecycle | None",
               versioned: bool, suspended: bool) -> bool:
        """Returns True when the version was expired (skip in usage)."""
        if lc is None:
            return False
        from ..ilm.lifecycle import ObjectOpts

        action = lc.compute_action(
            ObjectOpts(
                name=oi.name,
                mod_time_ns=oi.mod_time_ns,
                is_latest=oi.is_latest,
                delete_marker=oi.delete_marker,
                num_versions=getattr(oi, "num_versions", 1),
                successor_mod_time_ns=getattr(
                    oi, "successor_mod_time_ns", 0
                ),
                user_tags=(oi.user_defined or {}).get(
                    "x-amz-tagging", ""
                ),
            )
        )
        dinfo = None
        try:
            if action == Action.DELETE:
                # current-version expiry: a versioning-enabled OR
                # -suspended bucket mints a marker / replaces the null
                # version - passing versioned=False there would
                # recursively destroy every noncurrent version
                dinfo = self._ol.delete_object(
                    bucket, oi.name, "",
                    versioned=versioned, version_suspended=suspended,
                )
            elif action == Action.DELETE_VERSION:
                vid = oi.version_id or "null"
                self._ol.delete_object(bucket, oi.name, vid)
            else:
                return False
        except Exception:  # noqa: BLE001 - racing deletes are fine
            return False
        self._count("expired")
        if self._events is not None:
            from ..event.event import Event, EventName

            if self._ensure_event_rules is not None:
                try:
                    self._ensure_event_rules(bucket)
                except Exception as exc:
                    _log.debug("event-rule preload failed", extra=kv(err=str(exc)))
            made_marker = dinfo is not None and dinfo.delete_marker
            self._events.send(
                Event(
                    name=EventName.OBJECT_REMOVED_DELETE_MARKER
                    if made_marker
                    else EventName.OBJECT_REMOVED_DELETE,
                    bucket=bucket,
                    object_key=oi.name,
                    version_id=(
                        dinfo.version_id if made_marker else oi.version_id
                    ),
                )
            )
        return True

    def _abort_stale_uploads(
        self, bucket: str, lc: "Lifecycle | None"
    ) -> int:
        if lc is None:
            return 0
        aborted = 0
        try:
            uploads = self._ol.list_multipart_uploads(bucket)
        except Exception:  # noqa: BLE001
            return 0
        for up in uploads:
            cutoff = lc.abort_multipart_before_ns(up.object)
            if cutoff is None or up.initiated_ns >= cutoff:
                continue
            try:
                self._ol.abort_multipart_upload(
                    bucket, up.object, up.upload_id
                )
                aborted += 1
            except Exception:  # noqa: BLE001
                continue
        if aborted:
            self._count("uploads_aborted", aborted)
        return aborted

    # -- the sweep --------------------------------------------------------

    def crawl_once(self, force: bool = False) -> DataUsage:
        # one sweep at a time: an admin-triggered crawl and the
        # background cycle must not interleave deletes or publish
        # out-of-order usage snapshots
        with self._crawl_mu:
            if self._leader_lock is None:
                return self._crawl_locked()
            from ..dsync.namespace import LockTimeout

            try:
                with self._leader_lock():
                    # the lock serializes sweeps; ONE sweep per
                    # interval needs a freshness gate too, or K nodes
                    # each sweep the shared namespace once per
                    # interval, staggered by lock turnover
                    prev = self._load_usage()
                    if not force:
                        age_ns = time.time_ns() - prev.last_update_ns
                        # a NEGATIVE age (another node's future clock,
                        # or NTP stepping ours back) must read as
                        # stale, or a dead fast-clock leader would
                        # gate the whole cluster off sweeping
                        if (
                            prev.last_update_ns
                            and 0
                            <= age_ns
                            < self._effective_interval() * 0.5e9
                        ):
                            with self._mu:
                                self._usage = prev
                            return prev
                    return self._crawl_locked(prev)
            except LockTimeout:
                # another node holds crawl leadership this cycle;
                # serve ITS published numbers, not our boot snapshot
                fresh = self._load_usage()
                if fresh.last_update_ns:
                    with self._mu:
                        self._usage = fresh
                return self.usage()

    def _rotate_bloom(self, oldest: int, current: int):
        """Cluster-union update filter for [oldest, current), or None
        when no tracker is attached / the rotation failed."""
        try:
            if self._cycle_bloom is not None:
                return self._cycle_bloom(oldest, current)
            if self._tracker is not None:
                return self._tracker.cycle_filter(oldest, current)
        except Exception:  # noqa: BLE001 - a broken filter only
            return None  # disables skipping, never the sweep
        return None

    def _bucket_needs_sweep(self, bucket: str) -> bool:
        """Buckets where a sweep does WORK (lifecycle, FIFO quota,
        replication catch-up) are never bloom-skipped: time passing
        changes what those subsystems must do even with zero writes."""
        if self._bucket_lifecycle(bucket) is not None:
            return True
        from ..objectlayer import quota as quotamod

        qcfg = quotamod.config_for(self._meta, bucket)
        if qcfg is not None and qcfg.quota_type == "fifo":
            return True
        repl = self._replication
        return repl is not None and repl.config_for(bucket) is not None

    def _crawl_locked(self, prev: "DataUsage | None" = None) -> DataUsage:
        # re-read the persisted snapshot (unless the caller already
        # did): in distributed mode crawl leadership floats between
        # nodes and the cycle counter lives in the (shared) usage
        # document, not in process memory - a node that was follower
        # for N cycles must not rewind the cluster's bloom trackers
        # with its stale cached counter
        if prev is None:
            prev = self._load_usage()
        if prev.last_update_ns == 0 and prev.cycles == 0:
            prev = self.usage()  # store unreadable: trust memory
        next_cycle = prev.cycles + 1
        usage = DataUsage(
            last_update_ns=time.time_ns(), cycles=next_cycle
        )
        try:
            buckets = self._ol.list_buckets()
        except Exception:  # noqa: BLE001
            return prev
        resp = self._rotate_bloom(prev.cycles, next_cycle)
        full_sweep = next_cycle % _FULL_SWEEP_EVERY == 0
        skip_ok = (
            resp is not None and resp.complete and not full_sweep
        )
        # shard-health probes ride the forced full sweep only: a
        # dry-run heal per object is too heavy for every cycle (the
        # reference gates its crawler heal the same way)
        self._heal_sweep = self._heal_hook is not None and (
            full_sweep or prev.cycles == 0
        )
        for b in buckets:
            bucket = b.name
            if bucket.startswith("."):  # reserved meta volumes
                continue
            prior = prev.buckets.get(bucket)
            if (
                skip_ok
                and prior is not None
                and not resp.filter.contains_dir(bucket)
                and not self._bucket_needs_sweep(bucket)
            ):
                usage.buckets[bucket] = prior  # clean: reuse as-is
                self._count("buckets_skipped")
                continue
            usage.buckets[bucket] = self._crawl_bucket(bucket)
            self._count("buckets_crawled")
        with self._mu:
            self._usage = usage
            self.stats["sweeps"] += 1
        self._store_usage(usage)
        return usage

    def _crawl_bucket(self, bucket: str) -> BucketUsage:
        lc = self._bucket_lifecycle(bucket)
        versioned = suspended = False
        try:
            bm = self._meta.get(bucket)
            versioned = bm.versioning_enabled
            suspended = bm.versioning_suspended
        except Exception as exc:
            _log.debug("bucket versioning lookup failed", extra=kv(err=str(exc)))
        bu = BucketUsage()
        seen = 0
        # latest live versions - accumulated ONLY when a FIFO quota is
        # configured (the list is O(objects); without a quota the crawl
        # stays streaming)
        from ..objectlayer import quota as quotamod

        qcfg = quotamod.config_for(self._meta, bucket)
        fifo = qcfg is not None and qcfg.quota_type == "fifo"
        latest: list = []
        repl = self._replication
        repl_cfg = repl.config_for(bucket) if repl is not None else None

        def process_key(rows: list) -> None:
            """All versions of ONE key (journal order: newest first);
            grouping here gives lifecycle real num_versions and
            successor mod times."""
            nonlocal seen
            for idx, oi in enumerate(rows):
                seen += 1
                if self._sleep_every and seen % self._sleep_every == 0:
                    time.sleep(self._sleep_s)  # crawl throttle
                oi.num_versions = len(rows)
                oi.successor_mod_time_ns = (
                    rows[idx - 1].mod_time_ns if idx else 0
                )
                if self._apply(bucket, oi, lc, versioned, suspended):
                    continue
                bu.versions += 1
                if oi.delete_marker:
                    bu.delete_markers += 1
                else:
                    bu.versions_size += oi.size
                if oi.is_latest and not oi.delete_marker:
                    bu.objects += 1
                    bu.size += oi.size
                    # read-cache heat: a live latest version earns one
                    # admission-frequency credit, so objects that
                    # survive crawls win the TinyLFU contest against
                    # one-shot scan traffic before their first GET
                    try:
                        rcache.seed_heat(bucket, oi.name, hits=1)
                    except Exception as exc:  # noqa: BLE001
                        _log.debug(
                            "read-cache heat seed failed",
                            extra=kv(err=str(exc)),
                        )
                    if self._heal_sweep:
                        self._probe_heal(bucket, oi)
                    if fifo:
                        latest.append(oi)
                    # replication catch-up: PENDING/FAILED never made
                    # it to the target - queue it again
                    if repl_cfg is not None:
                        status = oi.user_defined.get(
                            "x-amz-replication-status", ""
                        )
                        if status in (
                            "PENDING", "FAILED"
                        ) and repl_cfg.rule_for(oi.name):
                            repl.queue(bucket, oi.name, oi.version_id)
                            self._count("replication_requeued")

        key_marker = vid_marker = ""
        group: list = []
        while True:
            try:
                page = self._ol.list_object_versions(
                    bucket, "", key_marker, vid_marker, "", 1000
                )
            except NotImplementedError:
                # FS backend: no version journal - stream the flat
                # namespace (marker-paged list_objects would re-walk
                # and re-sort the whole bucket per page)
                walker = getattr(self._ol, "iter_all_objects", None)
                try:
                    if walker is not None:
                        for oi in walker(bucket):
                            process_key([oi])
                    else:
                        marker = ""
                        while True:
                            res = self._ol.list_objects(
                                bucket, "", marker, "", 1000
                            )
                            for oi in res.objects:
                                process_key([oi])
                            if not res.is_truncated:
                                break
                            marker = res.next_marker
                except Exception as exc:
                    _log.debug("flat namespace sweep failed", extra=kv(err=str(exc)))
                group = []
                break
            except Exception:  # noqa: BLE001
                break
            for oi in page.versions:
                if group and oi.name != group[0].name:
                    process_key(group)
                    group = []
                group.append(oi)
            if not page.is_truncated:
                break
            # a key's versions may span pages: keep buffering the
            # current group across the boundary
            key_marker = page.next_key_marker
            vid_marker = page.next_version_id_marker
        if group:
            process_key(group)
        self._abort_stale_uploads(bucket, lc)
        self._enforce_fifo_quota(bucket, bu, latest, versioned, suspended)
        return bu

    def _probe_heal(self, bucket: str, oi) -> None:
        """Metadata-only shard probe; queue a real heal for damaged
        objects (healObject path of the reference's crawler).  The
        probe is lock-free and reads no shard data - the expensive
        verify happens inside the queued heal itself."""
        probe = getattr(self._ol, "probe_object_health", None)
        if probe is None:
            self._heal_sweep = False  # backend has no heal surface
            return
        try:
            res = probe(bucket, oi.name, oi.version_id)
        except Exception:  # noqa: BLE001
            return
        if res.get("outdated"):
            try:
                self._heal_hook(bucket, oi.name, oi.version_id)
                self._count("heals_queued")
            except Exception as exc:
                _log.debug("heal hook failed for crawled object", extra=kv(err=str(exc)))

    def _enforce_fifo_quota(
        self, bucket, bu, latest, versioned, suspended
    ) -> None:
        """FIFO quota: evict oldest objects until the bucket fits
        (bucket-quota.go enforceFIFOQuota on the crawler pass)."""
        from ..objectlayer import objectlock as olock, quota as quotamod

        cfg = quotamod.config_for(self._meta, bucket)
        if cfg is None or cfg.quota_type != "fifo":
            return
        over = bu.size - cfg.quota
        if over <= 0:
            return
        for oi in sorted(latest, key=lambda o: o.mod_time_ns):
            if over <= 0:
                break
            # WORM-protected versions are never evicted
            # (enforceRetentionForDeletion guard in the reference)
            if olock.retention_blocks_delete(oi.user_defined):
                continue
            try:
                self._ol.delete_object(
                    bucket, oi.name, oi.version_id,
                    versioned=versioned, version_suspended=suspended,
                )
            except Exception:  # noqa: BLE001
                continue
            over -= oi.size
            bu.size -= oi.size
            bu.objects -= 1
            self._count("evicted")

    # -- lifecycle of the thread itself -----------------------------------

    def start(self) -> "DataCrawler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="data-crawler"
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
                os.environ.get("MINIO_TPU_CRAWL_INTERVAL_S")
                or self._interval
            )
        except ValueError:
            return self._interval
        # floor of 1s: wait(0) would busy-loop full-cluster crawls
        import math

        if not math.isfinite(v) or v < 1.0:
            return max(self._interval, 1.0)
        return v

    def _run(self) -> None:
        # initial delay so boot IO settles (crawler waits a cycle)
        # interval re-read each cycle: runtime-editable via admin
        # set-config-kv (crawler.interval_s); malformed values must
        # never kill this thread
        while not self._stop.wait(self._effective_interval()):
            try:
                self.crawl_once()
            except Exception as exc:
                _log.warning("crawl cycle failed", extra=kv(err=str(exc)))
