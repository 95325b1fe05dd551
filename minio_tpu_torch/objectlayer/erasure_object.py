"""ErasureObjects: one erasure set of N disks (cmd/erasure-object.go).

The core ObjectLayer: objects are striped across all disks of the set with
parity, committed via per-disk staging + atomic rename, read back through
metadata quorum + batched device decode.  Distribution, quorum and staging
semantics follow the reference call stack; the codec work itself is the
batched device pass in codec/erasure.py, run by the codec backend of the
set's ``device`` (the card unless the caller names another).

This slice carries buckets, PUT, GET (ranges and degraded reads
included), object info and DELETE.  What the JAX package layers on top -
transparent compression, SSE, multipart, heal, the read cache - raises
NotImplementedError naming the slice that ports it, instead of being
silently skipped.
"""

from __future__ import annotations

import os
import uuid

from ..codec import backend as backend_mod
from ..codec.erasure import BLOCK_SIZE_V1, Erasure, QuorumError
from ..dsync.namespace import NamespaceLock
from ..parallel import iopool
from ..parallel.iopool import tag_disk_stream
from ..storage import errors as serrors
from ..storage.meta import (
    ErasureInfo,
    FileInfo,
    ObjectPartInfo,
    new_version_id,
    now_ns,
)
from ..storage.xl import XLStorage
from ..utils.hashreader import HashReader
from ..utils.log import kv, logger
from . import api
from .api import (
    BucketExists,
    BucketInfo,
    BucketNotEmpty,
    BucketNotFound,
    ObjectInfo,
    ObjectLayer,
    ObjectNotFound,
    ReadQuorumError,
    WriteQuorumError,
    check_bucket_name,
    check_object_name,
)
from .metadata import (
    find_fileinfo_in_quorum,
    hash_order,
    read_all_fileinfo,
    reduce_errs,
    shuffle_disks,
)

SYS_VOL = ".sys"

# metadata markers of the JAX package's object transforms (compression,
# SSE): objects carrying them cannot be served by this slice
_META_COMPRESSION = "x-internal-compression"
_META_SSE = "x-internal-sse"

_log = logger("objectlayer")


def _unported(what: str, slice_no: int):
    return NotImplementedError(
        f"{what} is not ported to minio_tpu_torch yet (slice {slice_no})"
    )


def _check_parity_ack() -> None:
    """MINIO_TPU_PARITY_ACK: only ``settle`` (the default) is ported - a
    PUT returns after every shard, parity included, is written, closed
    and renamed.  ``early`` (ack at data-shard quorum, parity settled in
    the background and heal-flagged on failure) needs heal."""
    if os.environ.get("MINIO_TPU_PARITY_ACK", "settle").lower() == "early":
        raise _unported("MINIO_TPU_PARITY_ACK=early", 2)


class ErasureObjects(ObjectLayer):
    """One erasure set over ``disks`` (offline entries are None).

    ``device`` names the torch device the codec runs on; it defaults to
    the card and raises where there is none."""

    def __init__(
        self,
        disks: list,
        parity_blocks: "int | None" = None,
        block_size: int = BLOCK_SIZE_V1,
        device="cuda",
        nslock=None,
    ):
        if len(disks) < 2:
            raise ValueError("erasure set needs >= 2 disks")
        self.disks = list(disks)
        n = len(disks)
        self.parity_blocks = (
            parity_blocks if parity_blocks is not None else n // 2
        )
        self.data_blocks = n - self.parity_blocks
        if self.parity_blocks > n // 2:
            raise ValueError("parity cannot exceed half the disks")
        self.block_size = block_size
        self.backend = backend_mod.get_backend(device)
        self.nslock = nslock or NamespaceLock()
        # MRF seam (addPartial, erasure-object.go:999): called with
        # (bucket, object) when a write misses disks or a read detects
        # bitrot; the heal queue that consumes it is a later slice
        self.heal_hook = None

    # ------------------------------------------------------------------
    # quorums (erasure-object.go:593-596)
    # ------------------------------------------------------------------

    @property
    def read_quorum(self) -> int:
        return self.data_blocks

    @property
    def write_quorum(self) -> int:
        wq = self.data_blocks
        if self.data_blocks == self.parity_blocks:
            wq += 1
        return wq

    def _online_disks(self) -> list:
        """Live disks (offline ones as None): the single choke point
        every path derives its disk list from.  Masking breaker-tripped
        disks needs the metered disk layer, a later slice; the GET path
        already sorts suspect disks last (codec/erasure.py)."""
        return [
            d if d is not None and d.is_online() else None
            for d in self.disks
        ]

    # ------------------------------------------------------------------
    # buckets (cmd/erasure-bucket.go)
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        check_bucket_name(bucket)
        with self.nslock.write(bucket, ""):
            errs = []
            for d in self._online_disks():
                if d is None:
                    errs.append(serrors.DiskNotFound("offline"))
                    continue
                try:
                    d.make_vol(bucket)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 - per-disk error slot
                    errs.append(e)
            if any(isinstance(e, serrors.VolumeExists) for e in errs):
                raise BucketExists(bucket)
            reduce_errs(errs, self.write_quorum, WriteQuorumError)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        check_bucket_name(bucket)
        for d in self._online_disks():
            if d is None:
                continue
            try:
                vi = d.stat_vol(bucket)
                return BucketInfo(vi.name, vi.created_ns)
            except serrors.VolumeNotFound:
                raise BucketNotFound(bucket) from None
            except Exception:  # noqa: BLE001 - try the next disk
                continue
        raise BucketNotFound(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        for d in self._online_disks():
            if d is None:
                continue
            try:
                return [
                    BucketInfo(v.name, v.created_ns) for v in d.list_vols()
                ]
            except Exception:  # noqa: BLE001 - try the next disk
                continue
        return []

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        with self.nslock.write(bucket, ""):
            self.get_bucket_info(bucket)  # existence check
            errs = []
            nonempty = False
            for d in self._online_disks():
                if d is None:
                    errs.append(serrors.DiskNotFound("offline"))
                    continue
                try:
                    d.delete_vol(bucket, force=force)
                    errs.append(None)
                except serrors.VolumeNotEmpty as e:
                    nonempty = True
                    errs.append(e)
                except (serrors.VolumeNotFound, FileNotFoundError):
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 - per-disk error slot
                    errs.append(e)
            if nonempty:
                raise BucketNotEmpty(bucket)
            reduce_errs(errs, self.write_quorum, WriteQuorumError)

    def _require_bucket(self, bucket: str) -> None:
        self.get_bucket_info(bucket)

    # ------------------------------------------------------------------
    # put (erasure-object.go:570-765)
    # ------------------------------------------------------------------

    def put_object(
        self, bucket, object_name, reader, size=-1, metadata=None,
        versioned=False, compress=None, sse=None,
    ) -> ObjectInfo:
        if sse is not None:
            raise _unported("server-side encryption", 6)
        if compress or (
            compress is None
            and os.environ.get("MINIO_TPU_COMPRESS", "off") == "on"
        ):
            raise _unported("transparent object compression", 6)
        _check_parity_ack()
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.write(bucket, object_name):
            return self._put_object(
                bucket, object_name, reader, size, metadata, versioned
            )

    def _old_null_data_dir(self, bucket, object_name) -> str:
        """Data dir of the existing *null* version, if any - the only
        version an unversioned overwrite replaces."""
        try:
            fi, _ = self._read_quorum_fileinfo(bucket, object_name, "null")
            return fi.data_dir
        except Exception:  # noqa: BLE001 - no prior null version
            return ""

    def _put_object(
        self, bucket, object_name, reader, size, metadata, versioned=False
    ) -> ObjectInfo:
        k, m, n = self.data_blocks, self.parity_blocks, len(self.disks)
        er = Erasure(k, m, self.block_size)
        hreader = (
            reader if isinstance(reader, HashReader) else HashReader(reader, size)
        )
        distribution = hash_order(f"{bucket}/{object_name}", n)
        disks = shuffle_disks(self._online_disks(), distribution)

        data_dir = uuid.uuid4().hex
        tmp_ids = [uuid.uuid4().hex for _ in range(n)]
        writers: list = []
        for i, d in enumerate(disks):
            if d is None:
                writers.append(None)
                continue
            try:
                writers.append(
                    tag_disk_stream(
                        d.create_file(
                            SYS_VOL, f"tmp/{tmp_ids[i]}/{data_dir}/part.1"
                        ),
                        d,
                    )
                )
            except Exception:  # noqa: BLE001 - the disk misses this write
                writers.append(None)

        try:
            total = er.encode(
                hreader, writers, self.write_quorum, backend=self.backend
            )
        except QuorumError as e:
            # close writers FIRST, then reap the staging dirs
            for w in writers:
                if w is not None:
                    try:
                        w.close()
                    except Exception as exc:  # noqa: BLE001
                        _log.debug("shard writer close failed", extra=kv(err=str(exc)))
            self._cleanup_tmp(disks, tmp_ids)
            raise WriteQuorumError(str(e)) from e
        # close (flush + fsync) shard files concurrently, one job per
        # disk queue: the commit pays the slowest disk's fsync
        for err in iopool.fanout(
            [(iopool.stream_io_key(w), w.close) for w in writers if w is not None]
        ):
            if err is not None and not isinstance(err, OSError):
                raise err

        mod_time = now_ns()
        etag = hreader.etag()
        actual_size = hreader.bytes_read
        meta = dict(metadata or {})
        meta.setdefault("etag", etag)
        # versioned PUT mints a fresh id and preserves prior versions;
        # unversioned PUT overwrites the null version only
        version_id = new_version_id() if versioned else ""
        old_data_dir = (
            "" if versioned else self._old_null_data_dir(bucket, object_name)
        )

        # rename_data commits the version journal with its own fsync per
        # disk: fan the commits out on the disk queues
        rename_ops = []
        errs: list = [None] * len(disks)
        for i, d in enumerate(disks):
            if d is None or writers[i] is None:
                errs[i] = serrors.DiskNotFound("offline")
                continue
            fi = FileInfo(
                volume=bucket,
                name=object_name,
                version_id=version_id,
                data_dir=data_dir,
                size=total,
                mod_time_ns=mod_time,
                metadata=meta,
                parts=[ObjectPartInfo(1, total, actual_size)],
                erasure=ErasureInfo(
                    data_blocks=k,
                    parity_blocks=m,
                    block_size=self.block_size,
                    index=i + 1,
                    distribution=distribution,
                ),
            )
            fn = lambda d=d, fi=fi, tmp=tmp_ids[i]: d.rename_data(  # noqa: E731
                SYS_VOL, f"tmp/{tmp}", fi, bucket, object_name
            )
            rename_ops.append((i, iopool.disk_io_key(d) or f"disk-{i}", fn))
        for (i, _k, _f), err in zip(
            rename_ops,
            iopool.fanout([(key, fn) for _i, key, fn in rename_ops]),
        ):
            errs[i] = err
        try:
            reduce_errs(errs, self.write_quorum, WriteQuorumError)
        except WriteQuorumError:
            self._cleanup_tmp(disks, tmp_ids)
            raise
        # MRF: quorum met but some disks missed the write
        if self.heal_hook is not None and any(e is not None for e in errs):
            try:
                self.heal_hook(bucket, object_name)
            except Exception as exc:  # noqa: BLE001 - never fail the PUT
                _log.debug("partial-write heal hook failed", extra=kv(err=str(exc)))
        # overwrite cleanup: drop the replaced data dir (best effort)
        if old_data_dir and old_data_dir != data_dir:
            for d in disks:
                if d is None:
                    continue
                try:
                    d.delete_file(
                        bucket, f"{object_name}/{old_data_dir}", recursive=True
                    )
                except Exception as exc:  # noqa: BLE001
                    _log.debug("replaced data dir cleanup failed", extra=kv(err=str(exc)))
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=actual_size,
            mod_time_ns=mod_time,
            etag=etag,
            content_type=meta.get("content-type", ""),
            version_id=version_id,
            user_defined=meta,
        )

    def _cleanup_tmp(self, disks, tmp_ids) -> None:
        for i, d in enumerate(disks):
            if d is None:
                continue
            try:
                d.delete_file(SYS_VOL, f"tmp/{tmp_ids[i]}", recursive=True)
            except Exception as exc:  # noqa: BLE001 - best effort
                _log.debug("tmp staging cleanup failed", extra=kv(err=str(exc)))

    # ------------------------------------------------------------------
    # get (erasure-object.go:141-331)
    # ------------------------------------------------------------------

    def _read_quorum_fileinfo(
        self, bucket, object_name, version_id=""
    ) -> tuple[FileInfo, list]:
        disks = self._online_disks()
        fis, errs = read_all_fileinfo(disks, bucket, object_name, version_id)
        not_found = sum(
            isinstance(e, (serrors.FileNotFound, serrors.VersionNotFound))
            for e in errs
        )
        if not_found > len(self.disks) - self.read_quorum:
            if version_id and any(
                isinstance(e, serrors.VersionNotFound) for e in errs
            ):
                raise api.VersionNotFound(f"{bucket}/{object_name}")
            raise ObjectNotFound(f"{bucket}/{object_name}")
        fi = find_fileinfo_in_quorum(fis, self.read_quorum)
        return fi, fis

    def get_object_info(self, bucket, object_name, version_id="") -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        fi, _ = self._read_quorum_fileinfo(bucket, object_name, version_id)
        if fi.deleted:
            raise ObjectNotFound(f"{bucket}/{object_name}")
        return self._to_object_info(bucket, object_name, fi)

    @staticmethod
    def _to_object_info(bucket, object_name, fi: FileInfo) -> ObjectInfo:
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=fi.size,
            mod_time_ns=fi.mod_time_ns,
            etag=fi.metadata.get("etag", ""),
            content_type=fi.metadata.get("content-type", ""),
            version_id=fi.version_id,
            delete_marker=fi.deleted,
            user_defined=dict(fi.metadata),
            parts=list(fi.parts),
        )

    def get_object(
        self, bucket, object_name, writer, offset=0, length=-1,
        version_id="", sse=None,
    ) -> ObjectInfo:
        if sse is not None:
            raise _unported("server-side encryption", 6)
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.read(bucket, object_name):
            fi, _ = self._read_quorum_fileinfo(bucket, object_name, version_id)
            if fi.deleted:
                raise ObjectNotFound(f"{bucket}/{object_name}")
            if fi.metadata.get(_META_COMPRESSION) or fi.metadata.get(_META_SSE):
                raise _unported("reading compressed or encrypted objects", 6)
            if length < 0:
                length = fi.size - offset
            if offset < 0 or length < 0 or offset + length > fi.size:
                raise api.InvalidRange(f"range {offset}+{length} of {fi.size}")
            er = Erasure(
                fi.erasure.data_blocks,
                fi.erasure.parity_blocks,
                fi.erasure.block_size,
            )
            disks = shuffle_disks(self._online_disks(), fi.erasure.distribution)
            heal_required = False
            # stream the parts covering [offset, offset+length)
            part_off = 0
            remaining = length
            cur = offset
            for part in fi.parts:
                part_start = part_off
                part_end = part_off + part.size
                part_off = part_end
                if remaining <= 0:
                    break
                if part_end <= cur:
                    continue
                in_off = cur - part_start
                in_len = min(part.size - in_off, remaining)
                readers = self._part_readers(
                    disks, bucket, object_name, fi, part.number
                )
                try:
                    _, healed = er.decode(
                        writer, readers, in_off, in_len, part.size,
                        backend=self.backend,
                    )
                except QuorumError as e:
                    raise ReadQuorumError(str(e)) from e
                finally:
                    for r in readers:
                        if r is not None:
                            try:
                                r.close()
                            except Exception as exc:  # noqa: BLE001
                                _log.debug("shard reader close failed", extra=kv(err=str(exc)))
                heal_required = heal_required or healed
                cur += in_len
                remaining -= in_len
            info = self._to_object_info(bucket, object_name, fi)
            if heal_required:
                info.user_defined["x-internal-heal-required"] = "true"
                if self.heal_hook is not None:
                    try:
                        self.heal_hook(bucket, object_name)
                    except Exception as exc:  # noqa: BLE001 - never fail the GET
                        _log.debug("deep-heal hook failed", extra=kv(err=str(exc)))
            return info

    def _part_readers(
        self, disks, bucket, object_name, fi: FileInfo, part_number: int
    ) -> list:
        readers: list = []
        for d in disks:
            if d is None:
                readers.append(None)
                continue
            try:
                readers.append(
                    tag_disk_stream(
                        d.read_file_stream(
                            bucket,
                            f"{object_name}/{fi.data_dir}/part.{part_number}",
                        ),
                        d,
                    )
                )
            except Exception:  # noqa: BLE001 - a missing shard, not an error
                readers.append(None)
        return readers

    # ------------------------------------------------------------------
    # delete (erasure-object.go:793+)
    # ------------------------------------------------------------------

    def delete_object(
        self, bucket, object_name, version_id="", versioned=False,
        version_suspended=False,
    ) -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.write(bucket, object_name):
            if not version_id and (versioned or version_suspended):
                return self._write_delete_marker(bucket, object_name, versioned)
            fi, _ = self._read_quorum_fileinfo(bucket, object_name, version_id)
            errs = []
            for d in self._online_disks():
                if d is None:
                    errs.append(serrors.DiskNotFound("offline"))
                    continue
                try:
                    if version_id:
                        d.delete_version(bucket, object_name, fi)
                    else:
                        d.delete_file(bucket, object_name, recursive=True)
                    errs.append(None)
                except (serrors.FileNotFound, serrors.VersionNotFound):
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 - per-disk error slot
                    errs.append(e)
            reduce_errs(errs, self.write_quorum, WriteQuorumError)
            return ObjectInfo(
                bucket=bucket,
                name=object_name,
                version_id=version_id,
                delete_marker=fi.deleted if version_id else False,
            )

    def _write_delete_marker(self, bucket, object_name, versioned: bool):
        """Unqualified DELETE on a versioning-configured bucket appends a
        delete marker instead of removing data; suspended buckets write
        the *null* marker, replacing the null version."""
        marker_vid = new_version_id() if versioned else ""
        mod_time = now_ns()
        old_null_dir = (
            "" if versioned else self._old_null_data_dir(bucket, object_name)
        )
        fi = FileInfo(
            volume=bucket,
            name=object_name,
            version_id=marker_vid,
            deleted=True,
            mod_time_ns=mod_time,
        )
        errs = []
        disks = self._online_disks()
        for d in disks:
            if d is None:
                errs.append(serrors.DiskNotFound("offline"))
                continue
            try:
                d.write_metadata(bucket, object_name, fi)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 - per-disk error slot
                errs.append(e)
        reduce_errs(errs, self.write_quorum, WriteQuorumError)
        if old_null_dir:
            for d in disks:
                if d is None:
                    continue
                try:
                    d.delete_file(
                        bucket, f"{object_name}/{old_null_dir}", recursive=True
                    )
                except Exception as exc:  # noqa: BLE001 - best effort
                    _log.debug("null-version data dir cleanup failed", extra=kv(err=str(exc)))
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            version_id=marker_vid,
            delete_marker=True,
            mod_time_ns=mod_time,
        )

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------

    def new_multipart_upload(self, bucket, object_name, metadata=None):
        raise _unported("multipart upload", 5)

    def heal_object(self, bucket, object_name, version_id="", dry_run=False):
        raise _unported("object heal", 2)


def from_reference_disks(
    paths: list, parity_blocks: "int | None" = None,
    block_size: int = BLOCK_SIZE_V1, device="cuda",
) -> ErasureObjects:
    """Open an erasure set that the JAX package (or this port) wrote,
    one XLStorage per disk root in ``paths`` (None = offline disk).
    The on-disk format - shard framing, xl.meta - is shared, so objects
    read back through this port's codec."""
    disks = [XLStorage(p) if p is not None else None for p in paths]
    return ErasureObjects(
        disks, parity_blocks=parity_blocks, block_size=block_size,
        device=device,
    )
