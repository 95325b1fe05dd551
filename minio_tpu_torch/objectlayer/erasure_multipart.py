"""Multipart uploads for the erasure object layer (cmd/erasure-multipart.go).

Uploads are staged under the system volume:

    .sys/multipart/<upload_id>/xl.meta      upload metadata (journal)
    .sys/multipart/<upload_id>/part.N       framed erasure shards per part

Each part is erasure-encoded independently with the object's distribution
(deterministic from bucket/object, so every disk stages the shard it will
eventually serve), on the codec backend of the set's device.
CompleteMultipartUpload renames the chosen part files into the final
object data dir - no re-encoding, mirroring the rename-based commit of
CompleteMultipartUpload (erasure-multipart.go:642).

The multipart ETag is the S3 convention: md5(concat(part md5s)) + "-N".

Compression is decided once per upload and SSE seals one object key per
upload at initiation; every part is its own deflate stream and/or DARE
stream under a part-derived nonce prefix, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import uuid

from ..codec import compress as compmod, sse as ssemod
from ..codec.erasure import Erasure, QuorumError
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
from ..utils.hashreader import HashReader
from ..utils.log import kv, logger
from . import api
from .api import (
    CompletePart,
    InvalidPart,
    InvalidUploadID,
    ObjectInfo,
    PartInfo,
    WriteQuorumError,
    check_object_name,
)
from .metadata import (
    find_fileinfo_in_quorum,
    hash_order,
    read_all_fileinfo,
    reduce_errs,
    shuffle_disks,
)

_log = logger("objectlayer")

SYS_VOL = ".sys"
MP_DIR = "multipart"
# S3 minimum size for any part other than the last (globalMinPartSize)
MIN_PART_SIZE = 5 << 20


class MultipartMixin:
    """Multipart methods; mixed into ErasureObjects."""

    # -- helpers ---------------------------------------------------------

    def _mp_path(self, upload_id: str) -> str:
        return f"{MP_DIR}/{upload_id}"

    def _mp_read_meta(self, upload_id: str):
        disks = self._online_disks()
        fis, errs = read_all_fileinfo(
            disks, SYS_VOL, self._mp_path(upload_id)
        )
        alive = sum(f is not None for f in fis)
        if alive < self.read_quorum:
            raise InvalidUploadID(upload_id)
        return find_fileinfo_in_quorum(fis, self.read_quorum)

    # -- API -------------------------------------------------------------

    def new_multipart_upload(
        self, bucket, object_name, metadata=None, sse=None
    ) -> str:
        check_object_name(object_name)
        self._require_bucket(bucket)
        upload_id = uuid.uuid4().hex
        meta = dict(metadata or {})
        meta["x-internal-bucket"] = bucket
        meta["x-internal-object"] = object_name
        # compression is decided once per upload (part sizes are unknown
        # up front - streaming semantics) and every part inherits it so
        # the assembled object is uniformly coded
        if compmod.should_compress(
            object_name, meta.get("content-type", ""), -1
        ):
            meta[compmod.META_COMPRESSION] = compmod.ALGORITHM
        # one object key per upload, sealed at initiation; every part
        # encrypts under it with a part-derived nonce prefix
        if sse is not None:
            oek = ssemod.new_object_key()
            nb = ssemod.new_nonce_base()
            meta.update(
                self._seal_sse_meta(sse, oek, nb, f"{bucket}/{object_name}")
            )
        distribution = hash_order(
            f"{bucket}/{object_name}", len(self.disks)
        )
        mod_time = now_ns()
        errs = []
        for i, d in enumerate(self._online_disks()):
            if d is None:
                errs.append(serrors.DiskNotFound("offline"))
                continue
            fi = FileInfo(
                volume=SYS_VOL,
                name=self._mp_path(upload_id),
                data_dir="",
                size=0,
                mod_time_ns=mod_time,
                metadata=meta,
                erasure=ErasureInfo(
                    data_blocks=self.data_blocks,
                    parity_blocks=self.parity_blocks,
                    block_size=self.block_size,
                    index=i + 1,
                    distribution=distribution,
                ),
            )
            try:
                d.write_metadata(SYS_VOL, self._mp_path(upload_id), fi)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 - per-disk error slot
                errs.append(e)
        reduce_errs(errs, self.write_quorum, WriteQuorumError)
        return upload_id

    def put_object_part(
        self, bucket, object_name, upload_id, part_number, reader,
        size=-1, sse=None,
    ) -> PartInfo:
        if not (1 <= part_number <= 10000):
            raise InvalidPart(f"part number {part_number}")
        mfi = self._mp_read_meta(upload_id)
        er = Erasure(
            self.data_blocks, self.parity_blocks, self.block_size
        )
        hreader = HashReader(reader, size)
        # each part is an independent deflate stream: the GET path can
        # then skip whole parts by actual size and the part ETag stays
        # the plaintext MD5 the client computed
        compress = bool(mfi.metadata.get(compmod.META_COMPRESSION))
        src = compmod.CompressReader(hreader) if compress else hreader
        if sse is not None and mfi.metadata.get(ssemod.META_SSE) != "C":
            # a customer key on a part of an unencrypted OR SSE-S3
            # upload must fail, not be silently dropped (AWS rejects the
            # mode mismatch)
            raise ssemod.SSEError(
                "upload was not initiated with customer-key encryption"
            )
        if mfi.metadata.get(ssemod.META_SSE):
            bkt = mfi.metadata.get("x-internal-bucket", bucket)
            obj = mfi.metadata.get("x-internal-object", object_name)
            oek, nb = self._unseal_oek(mfi.metadata, sse, f"{bkt}/{obj}")
            src = ssemod.EncryptReader(
                src, oek, ssemod.part_nonce_base(nb, part_number)
            )
        disks = shuffle_disks(
            self._online_disks(), mfi.erasure.distribution
        )
        tmp_ids = [uuid.uuid4().hex for _ in disks]
        writers: list = []
        for i, d in enumerate(disks):
            if d is None:
                writers.append(None)
                continue
            try:
                writers.append(
                    tag_disk_stream(
                        d.create_file(
                            SYS_VOL,
                            f"tmp/{tmp_ids[i]}/part.{part_number}",
                        ),
                        d,
                    )
                )
            except Exception:  # noqa: BLE001 - the disk misses this part
                writers.append(None)
        try:
            total = er.encode(
                src, writers, self.write_quorum, backend=self.backend
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
        # fan the shard-file closes (flush + fsync) out per disk queue
        for err in iopool.fanout(
            [
                (iopool.stream_io_key(w), w.close)
                for w in writers
                if w is not None
            ]
        ):
            if err is not None and not isinstance(err, OSError):
                raise err
        etag = hreader.etag()
        actual = hreader.bytes_read
        mod = now_ns()
        # commit shard into the upload dir + record part metadata, one
        # pool job per disk (each commit touches only its own disk)
        commit_ops = []
        errs: list = [None] * len(disks)
        for i, d in enumerate(disks):
            if d is None or writers[i] is None:
                errs[i] = serrors.DiskNotFound("offline")
                continue

            def commit(d=d, tmp=tmp_ids[i]):
                d.rename_file(
                    SYS_VOL,
                    f"tmp/{tmp}/part.{part_number}",
                    SYS_VOL,
                    f"{self._mp_path(upload_id)}/part.{part_number}",
                )
                d.write_all(
                    SYS_VOL,
                    f"{self._mp_path(upload_id)}/part.{part_number}.meta",
                    f"{total}:{etag}:{mod}:{actual}".encode(),
                )
                d.delete_file(SYS_VOL, f"tmp/{tmp}", recursive=True)

            commit_ops.append((i, iopool.disk_io_key(d) or f"disk-{i}", commit))
        for (i, _k, _f), err in zip(
            commit_ops,
            iopool.fanout([(key, fn) for _i, key, fn in commit_ops]),
        ):
            errs[i] = err
        reduce_errs(errs, self.write_quorum, WriteQuorumError)
        return PartInfo(
            part_number=part_number,
            etag=etag,
            size=actual,
            actual_size=actual,
            mod_time_ns=mod,
        )

    def _read_part_meta(
        self, upload_id: str, part_number: int
    ) -> "tuple[int, str, int, int] | None":
        """-> (stored_size, etag, mod_time, actual_size)."""
        for d in self._online_disks():
            if d is None:
                continue
            try:
                raw = d.read_all(
                    SYS_VOL,
                    f"{self._mp_path(upload_id)}/part.{part_number}.meta",
                ).decode()
                fields = raw.split(":")
                size, etag, mod = fields[0], fields[1], fields[2]
                actual = fields[3] if len(fields) > 3 else size
                return int(size), etag, int(mod), int(actual)
            except Exception:  # noqa: BLE001 - try the next disk
                continue
        return None

    def list_object_parts(
        self, bucket, object_name, upload_id, part_marker=0,
        max_parts=1000,
    ) -> list[PartInfo]:
        self._mp_read_meta(upload_id)
        nums: set[int] = set()
        for d in self._online_disks():
            if d is None:
                continue
            try:
                for name in d.list_dir(SYS_VOL, self._mp_path(upload_id)):
                    if name.startswith("part.") and name.endswith(".meta"):
                        nums.add(int(name[5:-5]))
            except Exception:  # noqa: BLE001 - try the next disk
                continue
        out = []
        for n in sorted(nums):
            if n <= part_marker:
                continue
            pm = self._read_part_meta(upload_id, n)
            if pm is None:
                continue
            _size, etag, mod, actual = pm
            # clients always see the plaintext (actual) part size
            out.append(PartInfo(n, etag, actual, actual, mod))
            if len(out) >= max_parts:
                break
        return out

    def list_multipart_uploads(
        self, bucket, prefix=""
    ) -> list[api.MultipartInfo]:
        uploads = []
        seen = set()
        for d in self._online_disks():
            if d is None:
                continue
            try:
                ids = d.list_dir(SYS_VOL, MP_DIR)
            except Exception:  # noqa: BLE001 - try the next disk
                continue
            for uid in ids:
                uid = uid.rstrip("/")
                if uid in seen:
                    continue
                seen.add(uid)
                try:
                    mfi = self._mp_read_meta(uid)
                except Exception:  # noqa: BLE001 - a torn upload dir
                    continue
                b = mfi.metadata.get("x-internal-bucket", "")
                o = mfi.metadata.get("x-internal-object", "")
                if b != bucket or (prefix and not o.startswith(prefix)):
                    continue
                uploads.append(
                    api.MultipartInfo(b, o, uid, mfi.mod_time_ns)
                )
        uploads.sort(key=lambda u: (u.object, u.upload_id))
        return uploads

    def abort_multipart_upload(
        self, bucket, object_name, upload_id
    ) -> None:
        self._mp_read_meta(upload_id)  # validates
        for d in self._online_disks():
            if d is None:
                continue
            try:
                d.delete_file(
                    SYS_VOL, self._mp_path(upload_id), recursive=True
                )
            except Exception as exc:  # noqa: BLE001 - best effort
                _log.debug("upload dir cleanup failed", extra=kv(err=str(exc)))

    def complete_multipart_upload(
        self, bucket, object_name, upload_id, parts: list[CompletePart],
        versioned=False,
    ) -> ObjectInfo:
        self._require_bucket(bucket)
        mfi = self._mp_read_meta(upload_id)
        # the upload id must belong to this bucket/object
        # (CompleteMultipartUpload validates uploadID against the object,
        # erasure-multipart.go:642)
        if (
            mfi.metadata.get("x-internal-bucket") != bucket
            or mfi.metadata.get("x-internal-object") != object_name
        ):
            raise InvalidUploadID(upload_id)
        if not parts:
            raise InvalidPart("no parts")
        # validate + collect part metadata
        infos: list[tuple[CompletePart, int, int]] = []
        md5s = hashlib.md5()
        total = 0
        total_actual = 0
        last = 0
        min_part = getattr(self, "min_part_size", MIN_PART_SIZE)
        for i, cp in enumerate(parts):
            if cp.part_number <= last:
                raise api.InvalidPartOrder("parts out of order")
            last = cp.part_number
            pm = self._read_part_meta(upload_id, cp.part_number)
            if pm is None:
                raise InvalidPart(f"part {cp.part_number} not found")
            size, etag, _, actual = pm
            if cp.etag and cp.etag.strip('"') != etag:
                raise InvalidPart(f"part {cp.part_number} etag mismatch")
            # S3 minimum part size applies to all but the last part and
            # to the client-visible bytes
            if i != len(parts) - 1 and actual < min_part:
                raise api.EntityTooSmall(
                    f"part {cp.part_number} is {actual} bytes"
                )
            infos.append((cp, size, actual))
            md5s.update(bytes.fromhex(etag))
            total += size
            total_actual += actual
        final_etag = f"{md5s.hexdigest()}-{len(parts)}"
        mod_time = now_ns()
        data_dir = uuid.uuid4().hex
        distribution = mfi.erasure.distribution
        disks = shuffle_disks(self._online_disks(), distribution)
        meta = {
            k: v
            for k, v in mfi.metadata.items()
            if not k.startswith("x-internal-")
        }
        meta["etag"] = final_etag
        if mfi.metadata.get(compmod.META_COMPRESSION):
            meta[compmod.META_COMPRESSION] = compmod.ALGORITHM
        if mfi.metadata.get(ssemod.META_SSE):
            # carry the sealed key forward, plus the ORIGINAL part
            # numbers in completion order: chunk nonces derive from the
            # number each part was uploaded under, which the renumbering
            # below would otherwise lose
            for mk in (
                ssemod.META_SSE,
                ssemod.META_SSE_SEALED_KEY,
                ssemod.META_SSE_NONCE,
                ssemod.META_SSE_KEY_MD5,
                ssemod.META_SSE_KMS_ID,
                ssemod.META_SSE_KMS_SEALED_DK,
            ):
                if mk in mfi.metadata:
                    meta[mk] = mfi.metadata[mk]
            meta[ssemod.META_SSE_PARTS] = ",".join(
                str(cp.part_number) for cp, _s, _a in infos
            )
        if mfi.metadata.get(compmod.META_COMPRESSION) or mfi.metadata.get(
            ssemod.META_SSE
        ):
            meta[compmod.META_ACTUAL_SIZE] = str(total_actual)

        with self.nslock.write(bucket, object_name):
            version_id = new_version_id() if versioned else ""
            old_data_dir = (
                ""
                if versioned
                else self._old_null_data_dir(bucket, object_name)
            )
            errs = []
            staged: list[tuple] = []  # (disk, tmp) that moved parts out
            for i, d in enumerate(disks):
                if d is None:
                    errs.append(serrors.DiskNotFound("offline"))
                    continue
                tmp = uuid.uuid4().hex
                fi = FileInfo(
                    volume=bucket,
                    name=object_name,
                    version_id=version_id,
                    data_dir=data_dir,
                    size=total,
                    mod_time_ns=mod_time,
                    metadata=meta,
                    parts=[
                        ObjectPartInfo(idx + 1, size, actual)
                        for idx, (cp, size, actual) in enumerate(infos)
                    ],
                    erasure=ErasureInfo(
                        data_blocks=self.data_blocks,
                        parity_blocks=self.parity_blocks,
                        block_size=self.block_size,
                        index=i + 1,
                        distribution=distribution,
                    ),
                )
                try:
                    # move chosen parts into the staged data dir,
                    # renumbered consecutively (part.N -> part.idx+1)
                    for idx, (cp, _size, _actual) in enumerate(infos):
                        d.rename_file(
                            SYS_VOL,
                            f"{self._mp_path(upload_id)}/part.{cp.part_number}",
                            SYS_VOL,
                            f"tmp/{tmp}/{data_dir}/part.{idx + 1}",
                        )
                    staged.append((d, tmp))
                    d.rename_data(
                        SYS_VOL, f"tmp/{tmp}", fi, bucket, object_name
                    )
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 - per-disk error slot
                    errs.append(e)
            try:
                reduce_errs(errs, self.write_quorum, WriteQuorumError)
            except WriteQuorumError:
                # roll the staged parts back into the upload dir so the
                # client can retry CompleteMultipartUpload
                for d, tmp in staged:
                    for idx, (cp, _size, _actual) in enumerate(infos):
                        try:
                            d.rename_file(
                                SYS_VOL,
                                f"tmp/{tmp}/{data_dir}/part.{idx + 1}",
                                SYS_VOL,
                                f"{self._mp_path(upload_id)}/part.{cp.part_number}",
                            )
                        except Exception as exc:  # noqa: BLE001
                            _log.debug("part un-rename during complete rollback failed", extra=kv(err=str(exc)))
                    try:
                        d.delete_file(
                            SYS_VOL, f"tmp/{tmp}", recursive=True
                        )
                    except Exception as exc:  # noqa: BLE001
                        _log.debug("tmp cleanup during complete rollback failed", extra=kv(err=str(exc)))
                raise
            # mutation seam: the completed upload is the object's new
            # generation - cached groups of the old one die
            self._invalidate_read_cache(bucket, object_name)
            if old_data_dir and old_data_dir != data_dir:
                for d in disks:
                    if d is None:
                        continue
                    try:
                        d.delete_file(
                            bucket,
                            f"{object_name}/{old_data_dir}",
                            recursive=True,
                        )
                    except Exception as exc:  # noqa: BLE001
                        _log.debug("replaced data dir cleanup failed", extra=kv(err=str(exc)))
        # drop the upload dir
        for d in self._online_disks():
            if d is None:
                continue
            try:
                d.delete_file(
                    SYS_VOL, self._mp_path(upload_id), recursive=True
                )
            except Exception as exc:  # noqa: BLE001
                _log.debug("upload dir cleanup failed", extra=kv(err=str(exc)))
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=total_actual,  # clients see plaintext bytes
            mod_time_ns=mod_time,
            etag=final_etag,
            content_type=meta.get("content-type", ""),
            version_id=version_id,
            user_defined=meta,
        )
