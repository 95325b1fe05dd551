"""ErasureZones: capacity-routed server pools (cmd/erasure-zones.go).

The top-level ObjectLayer in server mode (newObjectLayer,
server-main.go:559): writes go to the zone with the most free space
(getAvailableZoneIdx, erasure-zones.go:113), reads/deletes query zones in
order, listings merge across zones.  Each zone is an ErasureSets.

Every mutation marks its path in the data-update tracker
(``object_path_updated``, crawler/updatetracker.py), whose bloom journal
lets the data crawler skip buckets nothing wrote to.
"""

from __future__ import annotations

import threading
import time
import zlib

from . import api
from .api import ListObjectsInfo, ObjectLayer
from .sets import ErasureSets, merge_list_results
from ..crawler.updatetracker import object_path_updated
from ..parallel.fanout import Fanout, run_all

from ..utils.log import kv, logger

_log = logger("objectlayer")

# Stop placing new objects in a zone once it is this full
# (diskFillFraction, erasure-zones.go:37).
_DISK_FILL_FRACTION = 0.95
# Free-space snapshots are refreshed at most this often; placement
# between refreshes reuses the cached distribution, so PUTs do not
# stat every disk (the reference reads cached StorageUsageInfo from
# the crawler rather than statting per call).
_USAGE_TTL_S = 10.0
# The workers of _put_zone_index's existence probes, one process-wide set.
_PROBES = Fanout("zone-probe")


class ErasureZones(ObjectLayer):
    def __init__(self, zones: list[ErasureSets]):
        if not zones:
            raise ValueError("need at least one zone")
        self.zones = zones
        self._bucket_ops_lock = threading.Lock()
        self._usage_lock = threading.Lock()
        self._usage_ts = 0.0
        self._usage: "list[tuple[int, int]]" = []  # (free, total) per zone
        self._usage_refreshing = False

    # -- placement --------------------------------------------------------

    def _zone_space(self, zone: ErasureSets) -> "tuple[int, int]":
        free = total = 0
        for s in zone.sets:
            for d in s._online_disks():
                if d is None:
                    continue
                try:
                    di = d.disk_info()
                    free += di.free
                    total += di.total
                except Exception as exc:
                    _log.debug("disk_info probe failed", extra=kv(err=str(exc)))
        return free, total

    def _usage_snapshot(self) -> "list[tuple[int, int]]":
        """TTL-cached free/total per zone.  The disk statting runs
        OUTSIDE the lock: when the TTL lapses one caller refreshes
        while concurrent PUTs keep placing on the stale snapshot
        instead of queueing behind a cluster-wide stat (a down remote
        disk's timeout must not stall every placement)."""
        now = time.monotonic()
        with self._usage_lock:
            fresh = self._usage and now - self._usage_ts <= _USAGE_TTL_S
            if fresh or (self._usage_refreshing and self._usage):
                return self._usage
            self._usage_refreshing = True
        try:
            snap = [self._zone_space(z) for z in self.zones]
        finally:
            with self._usage_lock:
                self._usage_refreshing = False
        with self._usage_lock:
            self._usage = snap
            self._usage_ts = time.monotonic()
        return snap

    def _available_space(self, size: int) -> "list[int]":
        """Post-write available bytes per zone; 0 when the write would
        not fit or would push the zone past the fill fraction
        (getZonesAvailableSpace, erasure-zones.go:135-181)."""
        size = max(size, 0)
        out = []
        for free, total in self._usage_snapshot():
            if free < size:
                out.append(0)
                continue
            avail = free - size
            want_left = int(total * (1.0 - _DISK_FILL_FRACTION))
            out.append(0 if avail <= want_left else avail)
        return out

    def _put_zone_index(self, bucket: str, object_name: str,
                        size: int = 0) -> int:
        """Zone for a new write: existing object stays in its zone
        (erasure-zones.go getZoneIdx); otherwise the key is hashed onto
        the cumulative free-space distribution — proportional-to-free
        like the reference's getAvailableZoneIdx but deterministic per
        key, so placement is reproducible and testable."""
        if len(self.zones) == 1:
            return 0
        # probe every zone CONCURRENTLY: the existence check is on the
        # write path, so its wall cost must be one zone's RTT, not the
        # sum.  The probes run on persistent workers (zone 0's on this
        # thread) and every one is joined before the answer: no thread
        # is started per PUT, and none outlives the call
        hits = [False] * len(self.zones)

        def probe(i, z):
            def run():
                try:
                    z.get_object_info(bucket, object_name)
                    hits[i] = True
                except Exception as exc:  # noqa: BLE001 - a miss
                    _log.debug("zone object probe failed", extra=kv(err=str(exc)))
            return run

        run_all([(None if i == 0 else _PROBES, probe(i, z))
                 for i, z in enumerate(self.zones)])
        for i, hit in enumerate(hits):
            if hit:  # lowest index wins, like the serial walk
                return i
        avail = self._available_space(size)
        total = sum(avail)
        if total <= 0:
            # every zone past the fill threshold: fall back to rawest
            # free space so writes degrade rather than fail
            snap = self._usage_snapshot()
            return max(range(len(snap)), key=lambda i: snap[i][0])
        frac = zlib.crc32(f"{bucket}/{object_name}".encode()) / 2**32
        choose = int(frac * total)
        acc = 0
        for i, a in enumerate(avail):
            acc += a
            if acc > choose and a > 0:
                return i
        return len(self.zones) - 1

    def _find_zone(self, bucket: str, object_name: str, version_id=""):
        last_err: Exception = api.ObjectNotFound(
            f"{bucket}/{object_name}"
        )
        for z in self.zones:
            try:
                z.get_object_info(bucket, object_name, version_id)
                return z
            except (api.ObjectNotFound, api.VersionNotFound) as e:
                last_err = e
        raise last_err

    # -- buckets ----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        # each zone owns a separate NamespaceLock, so the per-zone
        # bucket locks don't span the fan-out: a zones-level lock
        # keeps a concurrent delete from interleaving between zones
        # (the undoMakeBucket pattern of erasure-zones.go:331 plus
        # the per-bucket lock of erasure-sets.go:604)
        with self._bucket_ops_lock:
            made = []
            try:
                for z in self.zones:
                    z.make_bucket(bucket)
                    made.append(z)
            except Exception:
                for z in made:
                    try:
                        z.delete_bucket(bucket, force=True)
                    except Exception as exc:
                        _log.debug("undo bucket create failed", extra=kv(err=str(exc)))
                raise

    def get_bucket_info(self, bucket: str):
        return self.zones[0].get_bucket_info(bucket)

    def list_buckets(self):
        return self.zones[0].list_buckets()

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        with self._bucket_ops_lock:
            if not force:
                for z in self.zones:
                    if z.list_objects(bucket, max_keys=1).objects:
                        raise api.BucketNotEmpty(bucket)
            for z in self.zones:
                try:
                    z.delete_bucket(bucket, force=True)
                except api.BucketNotFound:
                    pass

    # -- objects ----------------------------------------------------------

    def put_object(self, bucket, object_name, reader, size=-1, metadata=None,
                   versioned=False, compress=None, sse=None):
        self.zones[0].get_bucket_info(bucket)  # bucket must exist
        zi = self._put_zone_index(bucket, object_name, max(size, 0))
        info = self.zones[zi].put_object(
            bucket, object_name, reader, size, metadata, versioned,
            compress, sse,
        )
        object_path_updated(f"{bucket}/{object_name}")
        return info

    # A single zone answers reads itself (z.SingleZone(), erasure-zones.go):
    # locating the object first would read xl.meta by quorum, and stat the
    # bucket, twice per request, with the same answers.

    def get_object(self, bucket, object_name, writer, offset=0, length=-1,
                   version_id="", sse=None):
        if len(self.zones) == 1:
            z = self.zones[0]
        else:
            self.zones[0].get_bucket_info(bucket)
            z = self._find_zone(bucket, object_name, version_id)
        return z.get_object(
            bucket, object_name, writer, offset, length, version_id,
            sse,
        )

    def get_object_info(self, bucket, object_name, version_id=""):
        if len(self.zones) == 1:
            return self.zones[0].get_object_info(
                bucket, object_name, version_id
            )
        self.zones[0].get_bucket_info(bucket)
        z = self._find_zone(bucket, object_name, version_id)
        return z.get_object_info(bucket, object_name, version_id)

    def device_scan_source(self, bucket, object_name):
        self.zones[0].get_bucket_info(bucket)
        z = self._find_zone(bucket, object_name, "")
        return z.device_scan_source(bucket, object_name)

    def update_object_meta(self, bucket, object_name, updates,
                           version_id=""):
        self.zones[0].get_bucket_info(bucket)
        z = self._find_zone(bucket, object_name, version_id)
        out = z.update_object_meta(
            bucket, object_name, updates, version_id
        )
        object_path_updated(f"{bucket}/{object_name}")
        return out

    def _zone_with_versions(self, bucket, object_name):
        """First zone holding ANY journal entry for the key (incl.
        delete markers, which get_object_info cannot see)."""
        return next(
            (
                z
                for z in self.zones
                if z.has_object_versions(bucket, object_name)
            ),
            None,
        )

    def delete_object(self, bucket, object_name, version_id="",
                      versioned=False, version_suspended=False):
        self.zones[0].get_bucket_info(bucket)
        if not version_id and (versioned or version_suspended):
            # marker goes to the object's zone, or the write zone when
            # the key never existed (AWS still mints a marker)
            z = self._zone_with_versions(bucket, object_name)
            if z is None:
                z = self.zones[self._put_zone_index(bucket, object_name)]
            dinfo = z.delete_object(
                bucket, object_name, "", versioned, version_suspended
            )
            object_path_updated(f"{bucket}/{object_name}")
            return dinfo
        try:
            z = self._find_zone(bucket, object_name, version_id)
        except (api.ObjectNotFound, api.VersionNotFound):
            # the named version may be a delete marker, invisible to
            # get_object_info - fall back to the journal probe
            z = self._zone_with_versions(bucket, object_name)
            if z is None:
                raise
        dinfo = z.delete_object(bucket, object_name, version_id)
        object_path_updated(f"{bucket}/{object_name}")
        return dinfo

    def copy_object(self, src_bucket, src_object, dst_bucket, dst_object,
                    metadata=None, versioned=False, sse_src=None,
                    sse=None):
        from ..utils.pipe import streaming_copy

        src_zone = self._find_zone(src_bucket, src_object)
        if src_bucket == dst_bucket and src_object == dst_object:
            # self-copy: delegate down to the set, whose sequential
            # path avoids the namespace-lock deadlock
            info = src_zone.copy_object(
                src_bucket, src_object, dst_bucket, dst_object,
                metadata, versioned, sse_src, sse,
            )
            object_path_updated(f"{dst_bucket}/{dst_object}")
            return info
        info = src_zone.get_object_info(src_bucket, src_object)
        meta = api.prepare_copy_meta(info, metadata)
        return streaming_copy(
            lambda sink: src_zone.get_object(
                src_bucket, src_object, sink, sse=sse_src
            ),
            lambda source: self.put_object(
                dst_bucket, dst_object, source, info.size, meta,
                versioned=versioned, sse=sse,
            ),
        )

    def heal_object(self, bucket, object_name, version_id="", dry_run=False):
        z = self._find_zone(bucket, object_name, version_id)
        return z.heal_object(bucket, object_name, version_id, dry_run)

    def probe_object_health(self, bucket, object_name, version_id=""):
        # probe zones directly: routing via get_object_info would
        # itself fail on the damaged (below-quorum) objects the probe
        # exists to find
        last: Exception = api.ObjectNotFound(f"{bucket}/{object_name}")
        for z in self.zones:
            try:
                return z.probe_object_health(
                    bucket, object_name, version_id
                )
            except (api.ObjectNotFound, api.VersionNotFound) as e:
                last = e
        raise last

    def heal_bucket(self, bucket, dry_run=False):
        healed = []
        found = False
        for zi, z in enumerate(self.zones):
            try:
                r = z.heal_bucket(bucket, dry_run)
                found = True
                healed.extend((zi, *t) for t in r["healed"])
            except api.BucketNotFound:
                continue
        if not found:
            raise api.BucketNotFound(bucket)
        return {"bucket": bucket, "healed": healed, "dry_run": dry_run}

    # -- listing ----------------------------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000) -> ListObjectsInfo:
        self.zones[0].get_bucket_info(bucket)
        results = [
            z.list_objects(bucket, prefix, marker, delimiter, max_keys)
            for z in self.zones
        ]
        return merge_list_results(results, max_keys)

    def list_object_versions(self, bucket, prefix="", key_marker="",
                             version_id_marker="", delimiter="",
                             max_keys=1000):
        from .sets import merge_version_results

        self.zones[0].get_bucket_info(bucket)
        results = [
            z.list_object_versions(
                bucket, prefix, key_marker, version_id_marker,
                delimiter, max_keys,
            )
            for z in self.zones
        ]
        return merge_version_results(results, max_keys)

    # -- multipart (pin the upload's zone at initiate time) ---------------

    def new_multipart_upload(self, bucket, object_name, metadata=None,
                             sse=None):
        self.zones[0].get_bucket_info(bucket)
        zi = self._put_zone_index(bucket, object_name)
        uid = self.zones[zi].new_multipart_upload(
            bucket, object_name, metadata, sse
        )
        return f"{zi}.{uid}"

    def _upload_zone(self, upload_id: str):
        try:
            zi, uid = upload_id.split(".", 1)
            return self.zones[int(zi)], uid
        except (ValueError, IndexError):
            raise api.InvalidUploadID(upload_id) from None

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        reader, size=-1, sse=None):
        z, uid = self._upload_zone(upload_id)
        return z.put_object_part(
            bucket, object_name, uid, part_number, reader, size, sse
        )

    def list_object_parts(self, bucket, object_name, upload_id,
                          part_marker=0, max_parts=1000):
        z, uid = self._upload_zone(upload_id)
        return z.list_object_parts(
            bucket, object_name, uid, part_marker, max_parts
        )

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for zi, z in enumerate(self.zones):
            for u in z.list_multipart_uploads(bucket, prefix):
                u.upload_id = f"{zi}.{u.upload_id}"
                out.append(u)
        out.sort(key=lambda u: (u.object, u.upload_id))
        return out

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        z, uid = self._upload_zone(upload_id)
        return z.abort_multipart_upload(bucket, object_name, uid)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, versioned=False):
        z, uid = self._upload_zone(upload_id)
        info = z.complete_multipart_upload(
            bucket, object_name, uid, parts, versioned
        )
        object_path_updated(f"{bucket}/{object_name}")
        return info

    def storage_info(self) -> dict:
        return {"zones": [z.storage_info() for z in self.zones]}
