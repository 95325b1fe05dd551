"""ErasureObjects: one erasure set of N disks (cmd/erasure-object.go).

The core ObjectLayer: objects are striped across all disks of the set with
parity, committed via per-disk staging + atomic rename, read back through
metadata quorum + batched device decode.  Distribution, quorum and staging
semantics follow the reference call stack; the codec work itself is the
batched device pass in codec/erasure.py, run by the codec backend of the
set's ``device`` (the card unless the caller names another).

The port carries buckets, PUT, GET (ranges and degraded reads
included), object info, metadata updates, CopyObject, DELETE, listing
(``list_objects`` over the disks' ordered walks, ``list_object_versions``
over the merged version journals), multipart uploads
(objectlayer/erasure_multipart.py) and heal (``heal_object`` /
``heal_bucket``, fed by ``heal_hook`` through heal/background.py), with
transparent compression (codec/compress.py) and server-side encryption
(codec/sse.py, keys from codec/kms.py) between the client's bytes and
the codec: stored = encrypt(compress(plaintext)), and the tiered read
cache (cache/) under GET, populated by PUT and by GET misses and
dropped on every mutation, with its FileInfo side-car and the device
tier's scan plane for S3 Select (``device_scan_source``).  Under
MINIO_TPU_PARITY_ACK=early a PUT acks at data-shard write quorum and a
background ParityBand (parallel/iopool.py) settles the parity writes,
closes and renames, heal-flagging whatever fails past the ack.
"""

from __future__ import annotations

import base64
import io
import os
import uuid

from .. import cache as rcache
from ..codec import backend as backend_mod, compress as compmod, kms as kmsmod, sse as ssemod
from ..codec.erasure import BLOCK_SIZE_V1, Erasure, QuorumError
from ..dsync.namespace import NamespaceLock
from ..parallel import iopool
from ..parallel.iopool import tag_disk_stream
from ..storage import errors as serrors, health as disk_health, metered
from ..storage.meta import (
    ErasureInfo,
    FileInfo,
    ObjectPartInfo,
    new_version_id,
    now_ns,
)
from ..storage.xl import XLStorage
from ..parallel.fanout import run_all
from ..utils import spans
from ..utils.hashreader import HashReader
from ..utils.log import kv, logger
from . import api, metadata as metadata_mod
from .api import (
    BucketExists,
    BucketInfo,
    BucketNotEmpty,
    BucketNotFound,
    ListObjectsInfo,
    ObjectInfo,
    ObjectLayer,
    ObjectNotFound,
    ReadQuorumError,
    WriteQuorumError,
    check_bucket_name,
    check_object_name,
)
from .erasure_multipart import MultipartMixin
from .metadata import (
    find_fileinfo_in_quorum,
    hash_order,
    read_all_fileinfo,
    reduce_errs,
    shuffle_disks,
)

SYS_VOL = ".sys"

_log = logger("objectlayer")


def _parity_ack_mode() -> str:
    """MINIO_TPU_PARITY_ACK = settle|early (default settle; any other
    value resolves to settle).

    settle: a PUT returns only after every shard, parity included, is
    written, closed and renamed.  early: a PUT acks at DATA-shard write
    quorum; parity writes, closes and renames drain in a background
    ParityBand whose failures are heal-flagged through the MRF hook."""
    v = os.environ.get("MINIO_TPU_PARITY_ACK", "settle").lower()
    return v if v in ("settle", "early") else "settle"


class ErasureObjects(MultipartMixin, ObjectLayer):
    """One erasure set over ``disks`` (offline entries are None).

    ``device`` names the torch device the codec runs on; it defaults to
    the card and raises where there is none.  ``backend`` is a codec
    backend to run instead of ``device``'s (the server passes the native
    CPU codec, ``codec.backend.native_backend()``, under
    MINIO_ERASURE_BACKEND=cpu)."""

    def __init__(
        self,
        disks: list,
        parity_blocks: "int | None" = None,
        block_size: int = BLOCK_SIZE_V1,
        device="cuda",
        nslock=None,
        backend=None,
    ):
        if len(disks) < 2:
            raise ValueError("erasure set needs >= 2 disks")
        # per-disk API ledgers feed each disk's circuit breaker; wrap()
        # is idempotent
        self.disks = [metered.wrap(d) for d in disks]
        n = len(disks)
        self.parity_blocks = (
            parity_blocks if parity_blocks is not None else n // 2
        )
        self.data_blocks = n - self.parity_blocks
        if self.parity_blocks > n // 2:
            raise ValueError("parity cannot exceed half the disks")
        self.block_size = block_size
        self.backend = (
            backend if backend is not None
            else backend_mod.get_backend(device)
        )
        self.nslock = nslock or NamespaceLock()
        # MRF seam (addPartial, erasure-object.go:999): called with
        # (bucket, object) when a write misses disks or a read detects
        # bitrot; wired to heal.background.HealQueue.push_object
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
        """Live disks, with breaker-tripped ones masked to None.

        This is the single choke point every path (GET preference, PUT
        fan-out, metadata quorums, heal) derives its disk list from, so
        an open circuit breaker (storage/health.py) makes the disk
        vanish uniformly until its backoff admits a probe."""
        return [
            d
            if (
                d is not None
                and not disk_health.should_skip(d)
                and d.is_online()
            )
            else None
            for d in self.disks
        ]

    # ------------------------------------------------------------------
    # buckets (cmd/erasure-bucket.go)
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        check_bucket_name(bucket)
        with self.nslock.write(bucket, ""):
            self._make_bucket(bucket)

    def _make_bucket(self, bucket: str) -> None:
        """make_bucket under a bucket lock the caller holds (ErasureSets
        takes one lock over its fan-out: the sets share one nslock,
        which is not reentrant)."""
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
        # one drive answers: a local one first, which costs no round trip
        online = [d for d in self._online_disks() if d is not None]
        for d in sorted(online, key=lambda d: not metadata_mod.is_local(d)):
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
            self._delete_bucket(bucket, force)

    def _delete_bucket(self, bucket: str, force: bool = False) -> None:
        """delete_bucket under a bucket lock the caller holds."""
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
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.write(bucket, object_name):
            return self._put_object(
                bucket, object_name, reader, size, metadata, versioned,
                compress, sse,
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
        self, bucket, object_name, reader, size, metadata,
        versioned=False, compress=None, sse=None,
    ) -> ObjectInfo:
        k, m, n = self.data_blocks, self.parity_blocks, len(self.disks)
        er = Erasure(k, m, self.block_size)
        hreader = (
            reader if isinstance(reader, HashReader) else HashReader(reader, size)
        )
        # transparent compression: the decision lives HERE so every
        # write path (PUT, POST-policy, CopyObject re-encode) shares it;
        # the codec sees STORED (deflate) bytes while the HashReader
        # keeps hashing the client payload so the ETag stays the
        # original MD5 (object-api-utils.go:434 seam)
        if compress is None:
            compress = compmod.should_compress(
                object_name, (metadata or {}).get("content-type", ""), size
            )
        src = compmod.CompressReader(hreader) if compress else hreader
        # SSE sits OUTSIDE compression (encrypting first would destroy
        # compressibility): stored = encrypt(compress(plaintext))
        sse_meta: dict = {}
        if sse is not None:
            oek = ssemod.new_object_key()
            nb = ssemod.new_nonce_base()
            sse_meta = self._seal_sse_meta(
                sse, oek, nb, f"{bucket}/{object_name}", part_numbers=[1]
            )
            src = ssemod.EncryptReader(src, oek, nb)
        distribution = hash_order(f"{bucket}/{object_name}", n)
        disks = shuffle_disks(self._online_disks(), distribution)

        data_dir = uuid.uuid4().hex
        # mutation seam: every prior generation's cached groups die
        # BEFORE the new generation encodes, so the PUT-side populate
        # below never races its own stale keys
        self._invalidate_read_cache(bucket, object_name)
        rctx = rcache.context_for(
            bucket, object_name, data_dir, 1, self.backend.device
        )
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

        # quorum-early commit: the band adopts the parity stragglers when
        # encode returns, then carries the parity closes and renames past
        # the ack
        band = (
            iopool.ParityBand()
            if _parity_ack_mode() == "early" and m > 0
            else None
        )
        try:
            total = er.encode(
                src, writers, self.write_quorum, backend=self.backend,
                parity_band=band, cache_ctx=rctx,
            )
        except QuorumError as e:
            self._invalidate_read_cache(bucket, object_name)
            # close writers FIRST, then reap the staging dirs
            for w in writers:
                if w is not None:
                    try:
                        w.close()
                    except Exception as exc:  # noqa: BLE001
                        _log.debug("shard writer close failed", extra=kv(err=str(exc)))
            self._cleanup_tmp(disks, tmp_ids)
            raise WriteQuorumError(str(e)) from e
        if band is not None and not band.adopted:
            band = None  # encode settled inline (no digest-only plane)
        # close (flush + fsync) shard files concurrently, one job per
        # disk queue: the commit pays the slowest disk's fsync.  Early
        # mode closes only the DATA shards here; the parity closes ride
        # the band, ordered after that disk's writes by its queue
        if band is not None:
            for s, w in enumerate(writers):
                if s >= k and w is not None:
                    band.submit(s, iopool.stream_io_key(w), w.close)
        for err in iopool.fanout(
            [(iopool.stream_io_key(w), w.close)
             for s, w in enumerate(writers)
             if w is not None and (band is None or s < k)]
        ):
            if err is not None and not isinstance(err, OSError):
                raise err

        mod_time = now_ns()
        etag = hreader.etag()
        actual_size = hreader.bytes_read
        meta = dict(metadata or {})
        meta.setdefault("etag", etag)
        if compress:
            meta[compmod.META_COMPRESSION] = compmod.ALGORITHM
        meta.update(sse_meta)
        if compress or sse_meta:
            meta[compmod.META_ACTUAL_SIZE] = str(actual_size)
        # versioned PUT mints a fresh id and preserves prior versions;
        # unversioned PUT overwrites the null version only
        version_id = new_version_id() if versioned else ""
        old_data_dir = (
            "" if versioned else self._old_null_data_dir(bucket, object_name)
        )

        # rename_data commits the version journal with its own fsync per
        # disk: fan the commits out on the disk queues.  Early mode renames
        # only the data shards before it acks; the parity renames ride the
        # band (the key of that disk's close, so the order holds) and
        # their slot errors stay optimistically None until it settles
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
            if band is not None and i >= k:
                band.submit(i, iopool.stream_io_key(writers[i]), fn)
                continue
            rename_ops.append((i, iopool.disk_io_key(d) or f"disk-{i}", fn))
        for (i, _k, _f), err in zip(
            rename_ops,
            iopool.fanout([(key, fn) for _i, key, fn in rename_ops]),
        ):
            errs[i] = err
        try:
            reduce_errs(errs, self.write_quorum, WriteQuorumError)
        except WriteQuorumError:
            self._invalidate_read_cache(bucket, object_name)
            self._cleanup_tmp(disks, tmp_ids)
            raise
        # MRF: quorum met but some disks missed the write
        if self.heal_hook is not None and any(e is not None for e in errs):
            try:
                self.heal_hook(bucket, object_name)
            except Exception as exc:  # noqa: BLE001 - never fail the PUT
                _log.debug("partial-write heal hook failed", extra=kv(err=str(exc)))
        if band is not None:
            # settle the parity plane in the background; whatever fails
            # past this ack is heal-flagged through the MRF hook
            hook = self.heal_hook

            def _on_settled(b, _bucket=bucket, _obj=object_name):
                if b.heal_required and hook is not None:
                    try:
                        hook(_bucket, _obj)
                    except Exception as exc:  # noqa: BLE001 - never fail the settle
                        _log.debug(
                            "parity settle heal hook failed",
                            extra=kv(err=str(exc)),
                        )

            band.finish(on_done=_on_settled)
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

    @staticmethod
    def _invalidate_read_cache(bucket, object_name) -> None:
        """The cache-invalidation seam: every path that mutates object
        data or metadata - PUT, overwrite, heal, delete, metadata
        update, multipart commit - flows through here so the read cache
        never serves a dead generation.  It never fails the write."""
        try:
            rcache.invalidate_object(bucket, object_name)
        except Exception as exc:  # noqa: BLE001 - never fail the write
            _log.debug("read-cache invalidate failed", extra=kv(err=str(exc)))

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
        with spans.span("meta"):
            fis, errs = read_all_fileinfo(
                disks, bucket, object_name, version_id
            )
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
        fi = find_fileinfo_in_quorum(fis, self.read_quorum, errs)
        return fi, fis

    def get_object_info(self, bucket, object_name, version_id="") -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        fi, _ = self._read_quorum_fileinfo(bucket, object_name, version_id)
        if fi.deleted:
            raise ObjectNotFound(f"{bucket}/{object_name}")
        return self._to_object_info(bucket, object_name, fi)

    @staticmethod
    def _seal_sse_meta(sse, oek: bytes, nonce_base: bytes, aad: str,
                       part_numbers: "list[int] | None" = None) -> dict:
        """Metadata carrying the sealed object key (SealObjectKey)."""
        out = {
            ssemod.META_SSE_NONCE: base64.b64encode(nonce_base).decode(),
        }
        if part_numbers:
            out[ssemod.META_SSE_PARTS] = ",".join(
                str(n) for n in part_numbers
            )
        if sse.mode == "C":
            if not sse.key or len(sse.key) != 32:
                raise ssemod.SSEError("SSE-C key must be 32 bytes")
            sealed = ssemod.seal_key(sse.key, oek, aad)
            out.update(
                {
                    ssemod.META_SSE: "C",
                    ssemod.META_SSE_SEALED_KEY: base64.b64encode(
                        sealed
                    ).decode(),
                    ssemod.META_SSE_KEY_MD5: ssemod.key_md5_b64(sse.key),
                }
            )
            return out
        # SSE-S3 key hierarchy (cmd/crypto/kms.go): the KMS mints a
        # per-object data key; the OEK seals under the data key and only
        # the KMS-sealed data key is persisted, so an external KMS (KES)
        # never sees object keys and master rotation never re-touches
        # objects
        kms = kmsmod.get_kms()
        if kms is None:
            raise ssemod.SSEError(
                "SSE-S3 requires a KMS (MINIO_TPU_KMS_MASTER_KEY or "
                "MINIO_TPU_KMS_KES_ENDPOINT)"
            )
        kid = kms.default_key_id()
        try:
            dk, sealed_dk = kms.generate_key(kid, {"path": aad})
        except kmsmod.KMSError as e:
            raise ssemod.SSEError(str(e)) from None
        sealed = ssemod.seal_key(dk, oek, aad)
        out.update(
            {
                ssemod.META_SSE: "S3",
                ssemod.META_SSE_SEALED_KEY: base64.b64encode(
                    sealed
                ).decode(),
                ssemod.META_SSE_KMS_ID: kid,
                ssemod.META_SSE_KMS_SEALED_DK: base64.b64encode(
                    sealed_dk
                ).decode(),
            }
        )
        return out

    @staticmethod
    def _unseal_oek(fi_meta: dict, sse, aad: str) -> "tuple[bytes, bytes]":
        """(object key, nonce base) for a stored encrypted object;
        raises SSEError on a missing or mismatched key."""
        mode = fi_meta.get(ssemod.META_SSE)
        sealed = base64.b64decode(fi_meta.get(ssemod.META_SSE_SEALED_KEY, ""))
        if mode == "C":
            if sse is None or not sse.key:
                raise ssemod.SSEError(
                    "object is encrypted with a customer key; the key "
                    "must be provided"
                )
            if ssemod.key_md5_b64(sse.key) != fi_meta.get(
                ssemod.META_SSE_KEY_MD5
            ):
                raise ssemod.SSEError(
                    "provided SSE-C key does not match the object key"
                )
            kek = sse.key
        elif fi_meta.get(ssemod.META_SSE_KMS_SEALED_DK):
            kms = kmsmod.get_kms()
            if kms is None:
                raise ssemod.SSEError(
                    "object is KMS-encrypted but no KMS is configured"
                )
            try:
                kek = kms.unseal_key(
                    fi_meta.get(ssemod.META_SSE_KMS_ID, ""),
                    base64.b64decode(fi_meta[ssemod.META_SSE_KMS_SEALED_DK]),
                    {"path": aad},
                )
            except kmsmod.KMSError as e:
                raise ssemod.SSEError(str(e)) from None
        else:
            # legacy layout: OEK sealed directly under the local master
            # key (pre data-key objects)
            _, kek = ssemod.master_key()
        oek = ssemod.unseal_key(kek, sealed, aad)
        nb = base64.b64decode(fi_meta.get(ssemod.META_SSE_NONCE, ""))
        return oek, nb

    @staticmethod
    def _to_object_info(bucket, object_name, fi: FileInfo) -> ObjectInfo:
        size = fi.size
        if fi.metadata.get(compmod.META_COMPRESSION) or fi.metadata.get(
            ssemod.META_SSE
        ):
            # clients see the original payload size, not stored bytes
            size = int(fi.metadata.get(compmod.META_ACTUAL_SIZE, size))
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=size,
            mod_time_ns=fi.mod_time_ns,
            etag=fi.metadata.get("etag", ""),
            content_type=fi.metadata.get("content-type", ""),
            version_id=fi.version_id,
            delete_marker=fi.deleted,
            user_defined=dict(fi.metadata),
            parts=list(fi.parts),
        )

    def update_object_meta(
        self, bucket, object_name, updates: dict, version_id=""
    ) -> ObjectInfo:
        """Merge metadata updates into an existing version on every disk
        holding it - the PutObjectTags / PutObjectRetention seam
        (erasure-object.go PutObjectTags -> disk.UpdateMetadata).

        A key mapped to None is removed; other keys are set.  The quorum
        version is located first, then each agreeing disk rewrites its
        own FileInfo (preserving its per-disk erasure index)."""
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.write(bucket, object_name):
            disks = self._online_disks()
            fis, _errs = read_all_fileinfo(
                disks, bucket, object_name, version_id
            )
            not_found = sum(
                isinstance(e, (serrors.FileNotFound, serrors.VersionNotFound))
                for e in _errs
            )
            if not_found > len(self.disks) - self.read_quorum:
                if version_id and any(
                    isinstance(e, serrors.VersionNotFound) for e in _errs
                ):
                    raise api.VersionNotFound(f"{bucket}/{object_name}")
                raise ObjectNotFound(f"{bucket}/{object_name}")
            fi = find_fileinfo_in_quorum(fis, self.read_quorum)
            if fi.deleted:
                raise ObjectNotFound(f"{bucket}/{object_name}")
            merged = dict(fi.metadata)
            for k, v in updates.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
            qkey = (fi.mod_time_ns, fi.data_dir, fi.deleted)
            errs = []
            for i, d in enumerate(disks):
                dfi = fis[i]
                if (
                    d is None
                    or dfi is None
                    or (dfi.mod_time_ns, dfi.data_dir, dfi.deleted) != qkey
                ):
                    errs.append(serrors.DiskNotFound("offline"))
                    continue
                dfi.metadata = dict(merged)
                try:
                    d.update_metadata(bucket, object_name, dfi)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 - per-disk error slot
                    errs.append(e)
            reduce_errs(errs, self.write_quorum, WriteQuorumError)
            self._invalidate_read_cache(bucket, object_name)
            fi.metadata = merged
            return self._to_object_info(bucket, object_name, fi)

    def get_object(
        self, bucket, object_name, writer, offset=0, length=-1,
        version_id="", sse=None,
    ) -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.read(bucket, object_name):
            # latest-version GETs consult the read cache's FileInfo
            # side-car before fanning xl.meta reads across the set; on
            # one node the namespace lock orders the store against any
            # mutation's post-commit invalidate, so a cached FileInfo is
            # never staler than what an uncached quorum read would
            # return.  Across nodes it is not (another node's PUT acks
            # before this node drops its entry), so with a peer plane
            # the side-car is skipped (cache.sidecar_enabled)
            rc = rcache.read_cache(self.backend.device) if not version_id else None
            sidecar = rc is not None and rcache.sidecar_enabled()
            fi = rc.meta_lookup(bucket, object_name) if sidecar else None
            if fi is None:
                fi, _ = self._read_quorum_fileinfo(
                    bucket, object_name, version_id
                )
                if sidecar and not fi.deleted:
                    rc.meta_store(bucket, object_name, fi)
            if fi.deleted:
                raise ObjectNotFound(f"{bucket}/{object_name}")
            compressed = bool(fi.metadata.get(compmod.META_COMPRESSION))
            encrypted = bool(fi.metadata.get(ssemod.META_SSE))
            transformed = compressed or encrypted
            logical_size = fi.size
            if transformed:
                logical_size = int(
                    fi.metadata.get(compmod.META_ACTUAL_SIZE, fi.size)
                )
            if length < 0:
                length = logical_size - offset
            if offset < 0 or length < 0 or offset + length > logical_size:
                raise api.InvalidRange(
                    f"range {offset}+{length} of {logical_size}"
                )
            oek = nonce_base = None
            orig_part_nums: "list[int]" = []
            if encrypted:
                oek, nonce_base = self._unseal_oek(
                    fi.metadata, sse, f"{bucket}/{object_name}"
                )
                raw_nums = fi.metadata.get(ssemod.META_SSE_PARTS, "")
                orig_part_nums = [
                    int(x) for x in raw_nums.split(",") if x
                ] or [p.number for p in fi.parts]
            er = Erasure(
                fi.erasure.data_blocks,
                fi.erasure.parity_blocks,
                fi.erasure.block_size,
            )
            disks = shuffle_disks(self._online_disks(), fi.erasure.distribution)
            heal_required = False
            # stream the parts covering [offset, offset+length).  Ranges
            # address LOGICAL bytes; each transformed part is an
            # independent stream (deflate and/or DARE packages), so
            # overlapping parts are decoded whole into a skipping
            # decrypt/decompress chain (decompress-and-skip,
            # object-api-utils.go:686; DecryptBlocksReader) while plain
            # parts decode just the overlapping slice.
            part_off = 0
            remaining = length
            cur = offset
            for pi, part in enumerate(fi.parts):
                span = part.actual_size if transformed else part.size
                part_start = part_off
                part_end = part_off + span
                part_off = part_end
                if remaining <= 0:
                    break
                if part_end <= cur:
                    continue
                in_off = cur - part_start
                in_len = min(span - in_off, remaining)
                sink = writer
                dec_off, dec_len = in_off, in_len
                if transformed:
                    dec_off, dec_len = 0, part.size
                    if compressed:
                        sink = compmod.DecompressWriter(writer, in_off, in_len)
                    if encrypted:
                        pn = (
                            orig_part_nums[pi]
                            if pi < len(orig_part_nums)
                            else part.number
                        )
                        sink = ssemod.DecryptWriter(
                            sink,
                            oek,
                            ssemod.part_nonce_base(nonce_base, pn),
                            0 if compressed else in_off,
                            -1 if compressed else in_len,
                        )
                rctx = rcache.context_for(
                    bucket, object_name, fi.data_dir, part.number,
                    self.backend.device,
                )
                opened: list = []
                if rctx is None:
                    with spans.span("open"):
                        readers = self._part_readers(
                            disks, bucket, object_name, fi, part.number
                        )
                    opened = readers
                else:
                    # lazy open: a part whose every group hits the cache
                    # never opens a shard stream (zero disk calls)
                    def readers(_opened=opened, _pn=part.number):
                        rs = self._part_readers(
                            disks, bucket, object_name, fi, _pn
                        )
                        _opened.extend(rs)
                        return rs
                try:
                    # decode returns early (heal verdict intact) once a
                    # downstream skipping writer's range is satisfied
                    _, healed = er.decode(
                        sink, readers, dec_off, dec_len, part.size,
                        backend=self.backend, cache_ctx=rctx,
                    )
                except QuorumError as e:
                    raise ReadQuorumError(str(e)) from e
                finally:
                    for r in opened:
                        if r is not None:
                            try:
                                r.close()
                            except Exception as exc:  # noqa: BLE001
                                _log.debug("shard reader close failed", extra=kv(err=str(exc)))
                if sink is not writer:
                    sink.finish()
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

    def device_scan_source(self, bucket, object_name):
        """Device-resident scan plane for the S3 Select pushdown, or None
        when the object cannot be served from the device cache tier
        (cache off or host mode, transformed bytes, partial group
        coverage) - the caller then takes the spooled read path.

        A full hit assembles the object's cached (g, k, shard_len) group
        tensors into one contiguous byte plane on the cache's device
        with device-side slicing and one concatenation (a copy: the
        cached tensors are never written): no shard reader opens, no
        host round-trip.  Returns ``(plane, nbytes)`` ready for
        S3Select.evaluate's ``device_source``."""
        check_object_name(object_name)
        self._require_bucket(bucket)
        with self.nslock.read(bucket, object_name):
            rc = rcache.read_cache(self.backend.device)
            if rc is None or rc.mode != "device":
                return None
            sidecar = rcache.sidecar_enabled()  # off with a peer plane
            fi = rc.meta_lookup(bucket, object_name) if sidecar else None
            if fi is None:
                try:
                    fi, _ = self._read_quorum_fileinfo(bucket, object_name, "")
                except Exception:  # noqa: BLE001 - a miss, not an error
                    return None
                if sidecar and not fi.deleted:
                    rc.meta_store(bucket, object_name, fi)
            if fi.deleted or fi.size <= 0:
                return None
            if fi.metadata.get(compmod.META_COMPRESSION) or fi.metadata.get(
                ssemod.META_SSE
            ):
                # the cache holds stored bytes; a scan needs plaintext
                return None
            entries = rc.device_entries(bucket, object_name)
            if not entries:
                return None
            by_first = {(key[3], key[4]): key for key in entries}
            er = Erasure(
                fi.erasure.data_blocks,
                fi.erasure.parity_blocks,
                fi.erasure.block_size,
            )
            chunks = []
            for part in fi.parts:
                nblocks = er.block_count(part.size)
                b = 0
                while b < nblocks:
                    key = by_first.get((part.number, b))
                    if key is None or key[2] != fi.data_dir:
                        return None
                    g, shard_len = key[5], key[6]
                    data = entries[key]
                    if b + g > nblocks:
                        return None
                    for gi in range(g):
                        block_len = er._block_len(b + gi, part.size)
                        if er.shard_size_padded(block_len) != shard_len:
                            return None
                        ss = er.shard_size(block_len)
                        chunks.append(data[gi, :, :ss].reshape(-1)[:block_len])
                    b += g
            from ..s3select import device as seldev

            return seldev.as_device_plane(chunks, fi.size, rc.device)

    def _part_readers(
        self, disks, bucket, object_name, fi: FileInfo, part_number: int
    ) -> list:
        readers: list = [None] * len(disks)
        path = f"{object_name}/{fi.data_dir}/part.{part_number}"

        def open_one(i: int, d) -> None:
            try:
                readers[i] = tag_disk_stream(d.read_file_stream(bucket, path), d)
            except Exception:  # noqa: BLE001 - a missing shard, not an error
                readers[i] = None

        # a remote drive's open is a round trip (statfile): all at once
        run_all([
            (None if metadata_mod.is_local(d) else metadata_mod.FANOUT,
             lambda i=i, d=d: open_one(i, d))
            for i, d in enumerate(disks) if d is not None
        ])
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
            self._invalidate_read_cache(bucket, object_name)
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
        self._invalidate_read_cache(bucket, object_name)
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
    # copy
    # ------------------------------------------------------------------

    def copy_object(
        self, src_bucket, src_object, dst_bucket, dst_object,
        metadata=None, versioned=False, sse_src=None, sse=None,
    ) -> ObjectInfo:
        from ..utils.pipe import streaming_copy

        src_info = self.get_object_info(src_bucket, src_object)
        # the copy pipe carries decoded plaintext (decrypted with
        # ``sse_src``, inflated); every x-internal- transform marker is
        # dropped and the destination PUT re-applies its own transforms
        meta = api.prepare_copy_meta(src_info, metadata)
        if src_bucket == dst_bucket and src_object == dst_object:
            # self-copy (metadata rewrite): the concurrent pipe would
            # deadlock the namespace lock against itself - run the read
            # fully before the write (small objects; the S3 layer only
            # permits self-copy with REPLACE)
            buf = io.BytesIO()
            self.get_object(src_bucket, src_object, buf, sse=sse_src)
            buf.seek(0)
            return self.put_object(
                dst_bucket, dst_object, buf, src_info.size, meta,
                versioned=versioned, sse=sse,
            )
        # decode streams into a bounded pipe while the encoder consumes
        # it - constant memory for any object size
        return streaming_copy(
            lambda sink: self.get_object(
                src_bucket, src_object, sink, sse=sse_src
            ),
            lambda source: self.put_object(
                dst_bucket, dst_object, source, src_info.size, meta,
                versioned=versioned, sse=sse,
            ),
        )

    # ------------------------------------------------------------------
    # list (merged walk; cmd/erasure-sets.go listing semantics simplified)
    # ------------------------------------------------------------------

    def _merged_walk(
        self, bucket, prefix, marker, recursive, inclusive=False
    ):
        """K-way lazy merge of the per-disk ordered walks, deduplicated
        by name (lexicallySortedEntry, erasure-sets.go:842) - nothing is
        materialized; a page pulls only what it emits."""
        import heapq

        def safe(gen):
            # one bad disk ends its stream, not the listing
            while True:
                try:
                    yield next(gen)
                except StopIteration:
                    return
                except Exception:  # noqa: BLE001
                    return

        its = []
        for d in self._online_disks():
            if d is None:
                continue
            try:
                its.append(
                    safe(
                        d.walk_sorted(
                            bucket, prefix, marker,
                            recursive=recursive, inclusive=inclusive,
                        )
                    )
                )
            except Exception:  # noqa: BLE001
                continue
        last = None
        for name, is_prefix in heapq.merge(*its):
            if name == last:
                continue
            last = name
            yield name, is_prefix

    def _list_entries(
        self, bucket, prefix, marker, delimiter, inclusive=False
    ):
        """Shared listing front half: merged walk filtered down to
        ("prefix", name) / ("key", name) entries in lexical order, with
        delimiter folding.  Pagination/truncation stays with callers
        (they differ: one entry per key vs one per version)."""
        # delimiter "/" maps onto single-level directory reads; other
        # delimiters need the full recursive stream (tree-walk.go)
        recursive = delimiter != "/"
        seen_prefixes: set[str] = set()
        for name, is_prefix in self._merged_walk(
            bucket, prefix, marker, recursive, inclusive=inclusive
        ):
            if is_prefix:
                if name <= marker:
                    continue
                yield "prefix", name
                continue
            if prefix and not name.startswith(prefix):
                continue
            if delimiter and recursive:
                # non-"/" delimiter: fold names into common prefixes
                rest = name[len(prefix):]
                di = rest.find(delimiter)
                if di >= 0:
                    cp = prefix + rest[: di + len(delimiter)]
                    if cp <= marker:
                        continue
                    if cp not in seen_prefixes:
                        seen_prefixes.add(cp)
                        yield "prefix", cp
                    continue
            if marker and (name < marker or (name == marker and not inclusive)):
                continue
            yield "key", name

    def list_objects(
        self, bucket, prefix="", marker="", delimiter="", max_keys=1000,
    ) -> ListObjectsInfo:
        self._require_bucket(bucket)
        max_keys = max(0, min(max_keys, 1000))
        out = ListObjectsInfo()
        count = 0
        last_key = ""
        for kind, name in self._list_entries(
            bucket, prefix, marker, delimiter
        ):
            if count >= max_keys:
                out.is_truncated = True
                out.next_marker = last_key
                break
            if kind == "prefix":
                out.prefixes.append(name)
                count += 1
                last_key = name
                continue
            try:
                fi, _ = self._read_quorum_fileinfo(bucket, name)
            except Exception:  # noqa: BLE001
                continue
            if fi.deleted:
                continue
            out.objects.append(self._to_object_info(bucket, name, fi))
            count += 1
            last_key = name
        return out

    # ------------------------------------------------------------------
    # version listing (ListObjectVersions merge)
    # ------------------------------------------------------------------

    def _read_version_journal(
        self, bucket, object_name
    ) -> "list[FileInfo]":
        """Merged, quorum-checked version journal for one object: every
        disk's xl.meta read, versions grouped by id, kept when at least
        read_quorum disks agree, newest first."""
        groups: "dict[str, list[FileInfo]]" = {}
        for d in self._online_disks():
            if d is None:
                continue
            try:
                xl = d.read_xl(bucket, object_name)
            except Exception:  # noqa: BLE001 - a disk without the key
                continue
            for v in xl.versions:
                groups.setdefault(v.version_id or "null", []).append(v)
        out: list[FileInfo] = []
        for vid, vs in groups.items():
            if len(vs) < self.read_quorum:
                continue
            fi = vs[0]
            fi.volume, fi.name = bucket, object_name
            out.append(fi)
        out.sort(key=lambda v: -v.mod_time_ns)
        for i, fi in enumerate(out):
            fi.is_latest = i == 0
        return out

    def has_object_versions(self, bucket, object_name) -> bool:
        """Any journal entry at all (incl. delete markers) - used by the
        zone router, where get_object_info hides marker-latest keys."""
        return bool(self._read_version_journal(bucket, object_name))

    def list_object_versions(
        self, bucket, prefix="", key_marker="", version_id_marker="",
        delimiter="", max_keys=1000,
    ) -> api.ListObjectVersionsInfo:
        self._require_bucket(bucket)
        max_keys = max(0, min(max_keys, 1000))
        out = api.ListObjectVersionsInfo()
        count = 0
        last = (key_marker, version_id_marker)  # last emitted (key, vid)
        # the marker key itself is re-visited (version resume)
        for kind, name in self._list_entries(
            bucket, prefix, key_marker, delimiter, inclusive=True
        ):
            if kind == "prefix":
                if count >= max_keys:
                    out.is_truncated = True
                    out.next_key_marker = last[0]
                    out.next_version_id_marker = last[1]
                    return out
                out.prefixes.append(name)
                count += 1
                last = (name, "")
                continue
            versions = self._read_version_journal(bucket, name)
            resumed = False
            if name == key_marker and version_id_marker:
                # if the marker version vanished between pages (deleted
                # concurrently), emit the whole key again - duplicates
                # beat silently dropping every remaining version
                if not any(
                    (fi.version_id or "null") == version_id_marker
                    for fi in versions
                ):
                    resumed = True
            for fi in versions:
                vid = fi.version_id or "null"
                if name == key_marker and not resumed:
                    # resume inside this key's version list: skip up to
                    # and including the version-id marker (no marker =
                    # the whole key was emitted last page)
                    if not version_id_marker:
                        continue
                    if vid == version_id_marker:
                        resumed = True
                    continue
                if count >= max_keys:
                    out.is_truncated = True
                    out.next_key_marker, out.next_version_id_marker = last
                    return out
                oi = self._to_object_info(bucket, name, fi)
                oi.is_latest = fi.is_latest
                oi.version_id = vid
                out.versions.append(oi)
                count += 1
                last = (name, vid)
        return out

    # ------------------------------------------------------------------
    # heal (erasure-healing.go:227 healObject)
    # ------------------------------------------------------------------

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> dict:
        """Recreate the bucket volume on online disks missing it
        (erasure-healing.go:105 healBucket): a replaced/wiped drive loses
        every volume, and object heal cannot rename into a volume that
        does not exist.  Quorum of present copies is required before we
        re-stamp the stragglers."""
        check_bucket_name(bucket)
        with self.nslock.write(bucket, ""):
            disks = self._online_disks()  # one snapshot for probe + repair
            present, missing = [], []
            for i, d in enumerate(disks):
                if d is None:
                    continue
                try:
                    d.stat_vol(bucket)
                    present.append(i)
                except serrors.VolumeNotFound:
                    missing.append(i)
                except Exception:  # noqa: BLE001
                    continue  # transient error: neither present nor missing
            if not present:
                raise BucketNotFound(bucket)
            result = {
                "bucket": bucket,
                "present": present,
                "healed": [],
                "dry_run": dry_run,
            }
            if len(present) < self.read_quorum:
                # bucket exists but too few confirmations to re-stamp
                # stragglers safely; report without mutating
                return result
            if dry_run:
                result["healed"] = missing
                return result
            for i in missing:
                try:
                    disks[i].make_vol(bucket)
                    result["healed"].append(i)
                except serrors.VolumeExists:
                    result["healed"].append(i)
                except Exception as exc:  # noqa: BLE001
                    _log.debug("bucket heal make_vol failed", extra=kv(err=str(exc)))
            return result

    def probe_object_health(
        self, bucket, object_name, version_id=""
    ) -> dict:
        """Metadata-only shard-health probe: per-disk xl.meta quorum
        compare, NO namespace lock and NO shard reads.  A racy false
        positive only queues a heal that then finds nothing.

        ObjectNotFound/VersionNotFound propagate (cleanly absent); an
        object damaged PAST read quorum reports every disk outdated -
        those are the most urgent heals, not exceptions to swallow."""
        out = {"bucket": bucket, "object": object_name}
        try:
            fi, fis = self._read_quorum_fileinfo(
                bucket, object_name, version_id
            )
        except ReadQuorumError:
            return {
                **out,
                "outdated": list(range(len(self.disks))),
                "no_quorum": True,
            }
        disks = self._online_disks()
        out["outdated"] = [
            i
            for i, (d, f) in enumerate(zip(disks, fis))
            if d is not None
            and (
                f is None
                or f.mod_time_ns != fi.mod_time_ns
                or f.data_dir != fi.data_dir
            )
        ]
        return out

    def heal_object(
        self, bucket, object_name, version_id="", dry_run=False
    ) -> dict:
        """Rebuild the shards of every outdated disk - xl.meta missing or
        stale, or a part file that fails the deep bitrot scan - from the
        survivors, and commit them with the same staging + rename as a
        PUT.  Indices in the result are shard positions (erasure index
        - 1)."""
        # heal the bucket volume first (MakeVol on wiped disks) so the
        # shard rename below has a destination (erasure-healing.go:105)
        self.heal_bucket(bucket, dry_run=dry_run)
        with self.nslock.write(bucket, object_name):
            disks_raw = self._online_disks()
            fis, errs = read_all_fileinfo(
                disks_raw, bucket, object_name, version_id
            )
            fi = find_fileinfo_in_quorum(fis, self.read_quorum, errs)
            disks = shuffle_disks(disks_raw, fi.erasure.distribution)
            fis_shuffled = shuffle_disks(fis, fi.erasure.distribution)
            er = Erasure(
                fi.erasure.data_blocks,
                fi.erasure.parity_blocks,
                fi.erasure.block_size,
            )
            # classify disks: ok / outdated (disksWithAllParts semantics)
            outdated: list[int] = []
            for i, d in enumerate(disks):
                f = fis_shuffled[i]
                if d is None:
                    continue  # offline: cannot heal
                if (
                    f is None
                    or f.mod_time_ns != fi.mod_time_ns
                    or f.data_dir != fi.data_dir
                ):
                    outdated.append(i)
                    continue
                try:
                    d.verify_file(bucket, object_name, fi)
                except Exception:  # noqa: BLE001 - any failure = outdated
                    outdated.append(i)
            result = {
                "bucket": bucket,
                "object": object_name,
                "disks": len(self.disks),
                "outdated": list(outdated),
                "healed": [],
                "dry_run": dry_run,
            }
            if not outdated or dry_run:
                return result
            tmp_ids = {i: uuid.uuid4().hex for i in outdated}
            # a fully wiped disk lost its staging volume too
            for i in outdated:
                try:
                    disks[i].make_vol(SYS_VOL)
                except Exception as exc:  # noqa: BLE001
                    _log.debug("staging vol re-create failed on wiped disk", extra=kv(err=str(exc)))
            for part in fi.parts:
                readers = []
                for i, d in enumerate(disks):
                    if d is None or i in outdated:
                        readers.append(None)
                        continue
                    try:
                        readers.append(
                            tag_disk_stream(
                                d.read_file_stream(
                                    bucket,
                                    f"{object_name}/{fi.data_dir}/part.{part.number}",
                                ),
                                d,
                            )
                        )
                    except Exception:  # noqa: BLE001 - a missing shard
                        readers.append(None)
                writers = [None] * len(disks)
                for i in outdated:
                    writers[i] = tag_disk_stream(
                        disks[i].create_file(
                            SYS_VOL,
                            f"tmp/{tmp_ids[i]}/{fi.data_dir}/part.{part.number}",
                        ),
                        disks[i],
                    )
                try:
                    er.heal(readers, writers, part.size, backend=self.backend)
                except QuorumError as e:
                    raise ReadQuorumError(str(e)) from e
                finally:
                    for r in readers:
                        if r is not None:
                            r.close()
                    for w in writers:
                        if w is not None:
                            w.close()
            for i in outdated:
                hfi = FileInfo(**{**fi.__dict__})
                hfi.erasure = ErasureInfo(**fi.erasure.__dict__)
                hfi.erasure.index = i + 1
                disks[i].rename_data(
                    SYS_VOL, f"tmp/{tmp_ids[i]}", hfi, bucket, object_name
                )
                result["healed"].append(i)
            # heal rewrote shard files: even though the reconstructed
            # bytes are identical, cached generations must re-verify
            # against the fresh frames, so drop them
            self._invalidate_read_cache(bucket, object_name)
            return result

    def storage_info(self) -> dict:
        online = sum(d is not None for d in self._online_disks())
        return {
            "disks": len(self.disks),
            "online": online,
            "offline": len(self.disks) - online,
            "data": self.data_blocks,
            "parity": self.parity_blocks,
        }


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
