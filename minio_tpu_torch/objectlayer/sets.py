"""ErasureSets: hash-routed collection of erasure sets (cmd/erasure-sets.go).

Data-parallel partitioning: S independent sets of N drives each; every
object deterministically lands in set crc32(key) % S (crcHashMod,
erasure-sets.go:560), so sets scale capacity and parallelism without
cross-set coordination.  Bucket operations fan out to every set; listings
merge lexically across sets (the lexicallySortedEntry merge,
erasure-sets.go:842).

Every set is built on one ``device`` and so shares that device's codec
backend and its cross-request batcher (codec/backend.py get_backend):
jobs of two sets with the same geometry merge into one launch, and each
job's result goes back to the set that queued it.
"""

from __future__ import annotations

import binascii

from . import api
from .api import ListObjectsInfo, ObjectLayer
from .erasure_object import ErasureObjects

from ..utils.log import kv, logger

_log = logger("objectlayer")


def crc_hash_mod(key: str, cardinality: int) -> int:
    """Set index for an object key (crcHashMod, erasure-sets.go:576)."""
    if cardinality <= 0:
        return -1
    return binascii.crc32(key.encode()) % cardinality


class ErasureSets(ObjectLayer):
    def __init__(
        self,
        disks: list,
        set_count: int,
        drives_per_set: int,
        parity_blocks: "int | None" = None,
        block_size: "int | None" = None,
        nslock=None,
        format_ref=None,
        device="cuda",
        backend=None,
    ):
        if len(disks) != set_count * drives_per_set:
            raise ValueError("disk count != sets * drives")
        from ..codec.erasure import BLOCK_SIZE_V1
        from ..dsync.namespace import NamespaceLock

        self.set_count = set_count
        self.drives_per_set = drives_per_set
        self.format_ref = format_ref  # FormatErasure (fresh-disk heal)
        nslock = nslock or NamespaceLock()
        self.sets: list[ErasureObjects] = [
            ErasureObjects(
                disks[i * drives_per_set : (i + 1) * drives_per_set],
                parity_blocks=parity_blocks,
                block_size=block_size or BLOCK_SIZE_V1,
                device=device,
                nslock=nslock,
                backend=backend,
            )
            for i in range(set_count)
        ]

    # -- routing ----------------------------------------------------------

    def set_for(self, object_name: str) -> ErasureObjects:
        return self.sets[crc_hash_mod(object_name, self.set_count)]

    # -- buckets (fan out to all sets) ------------------------------------

    def make_bucket(self, bucket: str) -> None:
        # one bucket lock over the whole fan-out so a concurrent
        # delete can't interleave between sets (erasure-sets.go:604
        # MakeBucketLocation); the per-set internals are unlocked
        # because all sets share this nslock and it isn't reentrant
        api.check_bucket_name(bucket)
        with self.sets[0].nslock.write(bucket, ""):
            made = []
            try:
                for s in self.sets:
                    s._make_bucket(bucket)
                    made.append(s)
            except Exception:
                for s in made:  # undo partial creation (undoMakeBucket)
                    try:
                        s._delete_bucket(bucket, force=True)
                    except Exception as exc:
                        _log.debug("undo bucket create failed", extra=kv(err=str(exc)))
                raise

    def get_bucket_info(self, bucket: str):
        return self.sets[0].get_bucket_info(bucket)

    def list_buckets(self):
        return self.sets[0].list_buckets()

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        with self.sets[0].nslock.write(bucket, ""):
            # validate emptiness across all sets first when not forcing
            if not force:
                for s in self.sets:
                    if s.list_objects(bucket, max_keys=1).objects:
                        raise api.BucketNotEmpty(bucket)
            for s in self.sets:
                try:
                    s._delete_bucket(bucket, force=True)
                except api.BucketNotFound:
                    pass

    # -- objects (route by key) -------------------------------------------

    def put_object(self, bucket, object_name, reader, size=-1, metadata=None,
                   versioned=False, compress=None, sse=None):
        return self.set_for(object_name).put_object(
            bucket, object_name, reader, size, metadata, versioned,
            compress, sse,
        )

    def get_object(self, bucket, object_name, writer, offset=0, length=-1,
                   version_id="", sse=None):
        return self.set_for(object_name).get_object(
            bucket, object_name, writer, offset, length, version_id,
            sse,
        )

    def get_object_info(self, bucket, object_name, version_id=""):
        return self.set_for(object_name).get_object_info(
            bucket, object_name, version_id
        )

    def device_scan_source(self, bucket, object_name):
        return self.set_for(object_name).device_scan_source(
            bucket, object_name
        )

    def update_object_meta(self, bucket, object_name, updates,
                           version_id=""):
        return self.set_for(object_name).update_object_meta(
            bucket, object_name, updates, version_id
        )

    def delete_object(self, bucket, object_name, version_id="",
                      versioned=False, version_suspended=False):
        return self.set_for(object_name).delete_object(
            bucket, object_name, version_id, versioned, version_suspended
        )

    def copy_object(self, src_bucket, src_object, dst_bucket, dst_object,
                    metadata=None, versioned=False, sse_src=None,
                    sse=None):
        src_set = self.set_for(src_object)
        dst_set = self.set_for(dst_object)
        if src_set is dst_set:
            return src_set.copy_object(
                src_bucket, src_object, dst_bucket, dst_object, metadata,
                versioned, sse_src, sse,
            )
        from ..utils.pipe import streaming_copy

        info = src_set.get_object_info(src_bucket, src_object)
        meta = api.prepare_copy_meta(info, metadata)
        return streaming_copy(
            lambda sink: src_set.get_object(
                src_bucket, src_object, sink, sse=sse_src
            ),
            lambda source: dst_set.put_object(
                dst_bucket, dst_object, source, info.size, meta,
                versioned=versioned, sse=sse,
            ),
        )

    def heal_object(self, bucket, object_name, version_id="", dry_run=False):
        return self.set_for(object_name).heal_object(
            bucket, object_name, version_id, dry_run
        )

    def probe_object_health(self, bucket, object_name, version_id=""):
        return self.set_for(object_name).probe_object_health(
            bucket, object_name, version_id
        )

    def heal_bucket(self, bucket, dry_run=False):
        """Tolerant fan-out: one bad set must not block healing the
        rest (erasure-healing.go healBucket sweeps every set)."""
        healed = []
        found = False
        for si, s in enumerate(self.sets):
            try:
                r = s.heal_bucket(bucket, dry_run)
                found = True
                healed.extend((si, i) for i in r["healed"])
            except api.BucketNotFound:
                continue
        if not found:
            raise api.BucketNotFound(bucket)
        return {"bucket": bucket, "healed": healed, "dry_run": dry_run}

    # -- listing (merge across sets) --------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000) -> ListObjectsInfo:
        results = [
            s.list_objects(bucket, prefix, marker, delimiter, max_keys)
            for s in self.sets
        ]
        return merge_list_results(results, max_keys)

    def has_object_versions(self, bucket, object_name) -> bool:
        return self.set_for(object_name).has_object_versions(
            bucket, object_name
        )

    def list_object_versions(self, bucket, prefix="", key_marker="",
                             version_id_marker="", delimiter="",
                             max_keys=1000):
        results = [
            s.list_object_versions(
                bucket, prefix, key_marker, version_id_marker,
                delimiter, max_keys,
            )
            for s in self.sets
        ]
        return merge_version_results(results, max_keys)

    # -- multipart (route by key) -----------------------------------------

    def new_multipart_upload(self, bucket, object_name, metadata=None,
                             sse=None):
        return self.set_for(object_name).new_multipart_upload(
            bucket, object_name, metadata, sse
        )

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        reader, size=-1, sse=None):
        return self.set_for(object_name).put_object_part(
            bucket, object_name, upload_id, part_number, reader, size,
            sse,
        )

    def list_object_parts(self, bucket, object_name, upload_id,
                          part_marker=0, max_parts=1000):
        return self.set_for(object_name).list_object_parts(
            bucket, object_name, upload_id, part_marker, max_parts
        )

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for s in self.sets:
            out.extend(s.list_multipart_uploads(bucket, prefix))
        out.sort(key=lambda u: (u.object, u.upload_id))
        return out

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        return self.set_for(object_name).abort_multipart_upload(
            bucket, object_name, upload_id
        )

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, versioned=False):
        return self.set_for(object_name).complete_multipart_upload(
            bucket, object_name, upload_id, parts, versioned
        )

    def storage_info(self) -> dict:
        infos = [s.storage_info() for s in self.sets]
        return {
            "sets": infos,
            "disks": sum(i["disks"] for i in infos),
            "online": sum(i["online"] for i in infos),
            "offline": sum(i["offline"] for i in infos),
        }


def _truncation_boundary(results: list, marker_attr: str) -> "str | None":
    """Lowest last-emitted key among truncated inputs.  A merged page
    must not emit entries PAST a truncated input's boundary: that input
    has unreturned keys below them, and a resume marker beyond the
    boundary would skip those keys forever (review finding r3)."""
    bounds = [
        getattr(r, marker_attr)
        for r in results
        if r.is_truncated and getattr(r, marker_attr)
    ]
    return min(bounds) if bounds else None


def merge_version_results(results: list, max_keys: int):
    """Version-aware lexical merge across sets/zones: entries key on
    (object name, newest-first position) - each key's versions stay
    contiguous and ordered, truncation re-applied at max_keys and at
    the lowest truncated input's boundary."""
    per_key: "dict[str, list]" = {}
    prefixes: set[str] = set()
    for r in results:
        prefixes.update(r.prefixes)
        for oi in r.versions:
            per_key.setdefault(oi.name, []).append(oi)
    boundary = _truncation_boundary(results, "next_key_marker")
    out = api.ListObjectVersionsInfo()
    entries = sorted(
        [(name, "o") for name in per_key]
        + [(p, "p") for p in prefixes]
    )
    count = 0
    for name, kind in entries:
        if boundary is not None and name > boundary:
            out.is_truncated = True
            return out
        if kind == "p":
            if count >= max_keys:
                out.is_truncated = True
                return out
            out.prefixes.append(name)
            out.next_key_marker = name
            out.next_version_id_marker = ""
            count += 1
            continue
        versions = sorted(
            per_key[name], key=lambda o: -o.mod_time_ns
        )
        for oi in versions:
            if count >= max_keys:
                out.is_truncated = True
                return out
            out.versions.append(oi)
            count += 1
            out.next_key_marker = name
            out.next_version_id_marker = oi.version_id or "null"
    out.is_truncated = boundary is not None
    return out


def merge_list_results(
    results: list[ListObjectsInfo], max_keys: int
) -> ListObjectsInfo:
    """Lexical merge of per-set/per-zone listings, re-truncated to
    max_keys and to the lowest truncated input's boundary
    (lexicallySortedEntry, erasure-sets.go:842)."""
    objects = {o.name: o for r in results for o in r.objects}
    prefixes = {p for r in results for p in r.prefixes}
    boundary = _truncation_boundary(results, "next_marker")
    entries = sorted(
        [(name, "o") for name in objects] + [(p, "p") for p in prefixes]
    )
    out = ListObjectsInfo()
    last = ""
    for name, kind in entries:
        if boundary is not None and name > boundary:
            out.is_truncated = True
            out.next_marker = last
            return out
        if len(out.objects) + len(out.prefixes) >= max_keys:
            out.is_truncated = True
            out.next_marker = last
            return out
        if kind == "o":
            out.objects.append(objects[name])
        else:
            out.prefixes.append(name)
        last = name
    out.is_truncated = boundary is not None
    out.next_marker = last if out.is_truncated else ""
    return out
