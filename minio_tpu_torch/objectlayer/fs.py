"""FSObjects: single-disk, non-erasure ObjectLayer (cmd/fs-v1.go,
fs-v1-multipart.go, fs-v1-metadata.go).

The standalone mode the reference selects for one endpoint
(server-main.go:561-564): objects live as plain files under
``root/<bucket>/<object>`` (browsable in place, like fs-v1), metadata
documents under ``root/.fs.sys/meta/<bucket>/<object>.json`` (the
fs.json analogue), multipart staging under ``root/.fs.sys/multipart``.
Writes stage to tmp then os.replace (atomic commit); there is no
erasure, bitrot framing, or versioning - exactly the reference's FS
contract (versioned calls raise NotImplementedError -> S3
NotImplemented).

This package's copy of ``minio_tpu.objectlayer.fs``: the files it writes,
metadata documents included, are the JAX package's byte for byte, and
each package reads what the other wrote.  ``list_multipart_uploads``
answers ``MultipartInfo`` records, as the erasure layer does, so
ListMultipartUploads answers over the S3 front (the JAX copy's dicts
fail there with a 500).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
import uuid

from ..codec import compress as compmod
from ..utils.hashreader import HashReader
from ..crawler.updatetracker import object_path_updated
from . import api
from .api import (
    BucketExists,
    BucketInfo,
    BucketNotEmpty,
    BucketNotFound,
    CompletePart,
    ListObjectsInfo,
    MultipartInfo,
    ObjectInfo,
    ObjectLayer,
    ObjectNotFound,
    check_bucket_name,
    check_object_name,
    prepare_copy_meta,
)

SYS_DIR = ".fs.sys"


class FSObjects(ObjectLayer):
    """One-directory object store (NewFSObjectLayer)."""

    def __init__(self, root: str, min_part_size: "int | None" = None):
        self.root = os.path.abspath(root)
        os.makedirs(os.path.join(root, SYS_DIR, "tmp"), exist_ok=True)
        os.makedirs(os.path.join(root, SYS_DIR, "meta"), exist_ok=True)
        os.makedirs(
            os.path.join(root, SYS_DIR, "multipart"), exist_ok=True
        )
        if min_part_size is None:
            from .erasure_multipart import MIN_PART_SIZE

            min_part_size = MIN_PART_SIZE
        self.min_part_size = min_part_size
        self._mu = threading.RLock()

    # -- paths ------------------------------------------------------------

    def _bucket_dir(self, bucket: str) -> str:
        if bucket == api.META_BUCKET:
            # internal documents (IAM, bucket metadata) share the
            # data namespace under the sys dir
            return os.path.join(self.root, SYS_DIR, "metabucket")
        return os.path.join(self.root, bucket)

    def _obj_path(self, bucket: str, name: str) -> str:
        base = self._bucket_dir(bucket)  # absolute (root is abspath'd)
        p = os.path.normpath(os.path.join(base, name))
        # must stay strictly INSIDE the bucket dir: a trailing-sep
        # prefix check, so /data/bkt2 can't pass as inside /data/bkt
        if not p.startswith(base + os.sep):
            raise api.InvalidObjectName(name)
        return p

    def _meta_path(self, bucket: str, name: str) -> str:
        return os.path.join(
            self.root, SYS_DIR, "meta", bucket, name + ".fs.json"
        )

    # -- buckets ----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        check_bucket_name(bucket)
        d = self._bucket_dir(bucket)
        if os.path.isdir(d) and bucket != api.META_BUCKET:
            raise BucketExists(bucket)
        os.makedirs(d, exist_ok=True)

    def _require_bucket(self, bucket: str) -> str:
        d = self._bucket_dir(bucket)
        if bucket == api.META_BUCKET:
            os.makedirs(d, exist_ok=True)
            return d
        if not os.path.isdir(d):
            raise BucketNotFound(bucket)
        return d

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        d = self._require_bucket(bucket)
        try:
            return BucketInfo(bucket, int(os.stat(d).st_ctime_ns))
        except FileNotFoundError:
            # concurrent delete won between isdir and stat
            raise BucketNotFound(bucket) from None

    def list_buckets(self) -> "list[BucketInfo]":
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("."):
                continue
            full = os.path.join(self.root, name)
            if os.path.isdir(full):
                out.append(
                    BucketInfo(name, int(os.stat(full).st_ctime_ns))
                )
        return out

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        d = self._require_bucket(bucket)
        if not force and any(os.scandir(d)):
            raise BucketNotEmpty(bucket)
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(
            os.path.join(self.root, SYS_DIR, "meta", bucket),
            ignore_errors=True,
        )

    # -- metadata ---------------------------------------------------------

    def _load_meta(self, bucket: str, name: str) -> dict:
        try:
            with open(self._meta_path(bucket, name), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _store_meta(self, bucket: str, name: str, meta: dict) -> None:
        p = self._meta_path(bucket, name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(tmp, p)

    # -- objects ----------------------------------------------------------

    def put_object(
        self, bucket, object_name, reader, size=-1, metadata=None,
        versioned=False, compress=None, sse=None,
    ) -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        if sse is not None:
            raise NotImplementedError("SSE-C on the FS backend")
        hreader = (
            reader
            if isinstance(reader, HashReader)
            else HashReader(reader, size)
        )
        meta = dict(metadata or {})
        if compress is None:
            compress = compmod.should_compress(
                object_name, meta.get("content-type", ""), size
            )
        src = compmod.CompressReader(hreader) if compress else hreader
        tmp = os.path.join(
            self.root, SYS_DIR, "tmp", uuid.uuid4().hex
        )
        stored = 0
        with open(tmp, "wb") as f:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                stored += len(chunk)
        dst = self._obj_path(bucket, object_name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(tmp, dst)
        etag = hreader.etag()
        actual = hreader.bytes_read
        meta.setdefault("etag", etag)
        if compress:
            meta[compmod.META_COMPRESSION] = compmod.ALGORITHM
            meta[compmod.META_ACTUAL_SIZE] = str(actual)
        mod = time.time_ns()
        self._store_meta(
            bucket, object_name,
            {"meta": meta, "size": stored, "actual": actual, "mod": mod},
        )
        object_path_updated(f"{bucket}/{object_name}")
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=actual,
            mod_time_ns=mod,
            etag=etag,
            content_type=meta.get("content-type", ""),
            user_defined=meta,
        )

    def _stat(self, bucket, object_name) -> "tuple[str, dict]":
        p = self._obj_path(bucket, object_name)
        if not os.path.isfile(p):
            raise ObjectNotFound(f"{bucket}/{object_name}")
        return p, self._load_meta(bucket, object_name)

    def get_object_info(
        self, bucket, object_name, version_id=""
    ) -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        if version_id and version_id != "null":
            raise api.VersionNotFound(version_id)
        p, doc = self._stat(bucket, object_name)
        meta = doc.get("meta", {})
        st = os.stat(p)
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=doc.get("actual", st.st_size),
            mod_time_ns=doc.get("mod", int(st.st_mtime_ns)),
            etag=meta.get("etag", ""),
            content_type=meta.get("content-type", ""),
            user_defined=meta,
        )

    def get_object(
        self, bucket, object_name, writer, offset=0, length=-1,
        version_id="", sse=None,
    ) -> ObjectInfo:
        info = self.get_object_info(bucket, object_name, version_id)
        p, doc = self._stat(bucket, object_name)
        meta = doc.get("meta", {})
        logical = info.size
        if length < 0:
            length = logical - offset
        if offset < 0 or offset + length > logical:
            raise api.InvalidRange(f"{offset}+{length} of {logical}")
        compressed = bool(meta.get(compmod.META_COMPRESSION))
        with open(p, "rb") as f:
            if not compressed:
                f.seek(offset)
                remaining = length
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    writer.write(chunk)
                    remaining -= len(chunk)
            else:
                # decompress-and-skip, like the erasure read path
                dec = compmod.DecompressWriter(writer, offset, length)
                try:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        dec.write(chunk)
                    dec.finish()
                except compmod.RangeSatisfied:
                    pass
        return info

    def update_object_meta(
        self, bucket, object_name, updates: dict, version_id=""
    ) -> ObjectInfo:
        with self._mu:
            p, doc = self._stat(bucket, object_name)
            meta = doc.get("meta", {})
            for k, v in updates.items():
                if v is None:
                    meta.pop(k, None)
                else:
                    meta[k] = v
            doc["meta"] = meta
            self._store_meta(bucket, object_name, doc)
        object_path_updated(f"{bucket}/{object_name}")
        return self.get_object_info(bucket, object_name)

    def delete_object(
        self, bucket, object_name, version_id="", versioned=False,
        version_suspended=False,
    ) -> ObjectInfo:
        check_object_name(object_name)
        self._require_bucket(bucket)
        p = self._obj_path(bucket, object_name)
        if not os.path.isfile(p):
            raise ObjectNotFound(f"{bucket}/{object_name}")
        os.remove(p)
        try:
            os.remove(self._meta_path(bucket, object_name))
        except OSError:
            pass
        # prune now-empty parent dirs up to the bucket root
        d = os.path.dirname(p)
        stop = self._bucket_dir(bucket)
        while d != stop:
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)
        object_path_updated(f"{bucket}/{object_name}")
        return ObjectInfo(bucket=bucket, name=object_name)

    def copy_object(
        self, src_bucket, src_object, dst_bucket, dst_object,
        metadata=None, versioned=False, sse_src=None, sse=None,
    ) -> ObjectInfo:
        if sse is not None or sse_src is not None:
            # silently dropping an encryption demand would store
            # plaintext behind a 200
            raise NotImplementedError("SSE on the FS backend")
        src_info = self.get_object_info(src_bucket, src_object)
        meta = prepare_copy_meta(src_info, metadata)
        compmod.strip_internal_meta(meta)
        buf = io.BytesIO()
        self.get_object(src_bucket, src_object, buf)
        data = buf.getvalue()
        return self.put_object(
            dst_bucket, dst_object, io.BytesIO(data), len(data), meta
        )

    # -- listing ----------------------------------------------------------

    def _walk(self, bucket: str):
        base = self._bucket_dir(bucket)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                yield os.path.relpath(full, base).replace(os.sep, "/")

    def list_objects(
        self, bucket, prefix="", marker="", delimiter="", max_keys=1000
    ) -> ListObjectsInfo:
        self._require_bucket(bucket)
        out = ListObjectsInfo()
        prefixes: "set[str]" = set()
        last_emitted = marker
        names = sorted(self._walk(bucket))
        for name in names:
            if not name.startswith(prefix) or name <= marker:
                continue
            if len(out.objects) + len(prefixes) >= max_keys:
                # keys AND CommonPrefixes count toward max-keys (S3
                # pagination contract)
                out.is_truncated = True
                out.next_marker = last_emitted
                break
            if delimiter:
                rest = name[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter, 1)[0] + delimiter
                    if cp not in prefixes and cp > marker:
                        prefixes.add(cp)
                        last_emitted = cp
                    continue
            out.objects.append(self.get_object_info(bucket, name))
            last_emitted = name
        out.prefixes = sorted(prefixes)
        return out

    def iter_all_objects(self, bucket: str):
        """Streaming full-bucket walk (crawler seam): yields
        ObjectInfo without materializing or re-sorting the namespace
        per page."""
        self._require_bucket(bucket)
        for name in self._walk(bucket):
            try:
                yield self.get_object_info(bucket, name)
            except ObjectNotFound:
                continue

    def has_object_versions(self, bucket, object_name) -> bool:
        try:
            self._stat(bucket, object_name)
            return True
        except ObjectNotFound:
            return False

    def list_object_versions(self, *a, **k):
        raise NotImplementedError("versioning on the FS backend")

    # -- multipart (fs-v1-multipart.go) ------------------------------------

    def _upload_dir(self, upload_id: str) -> str:
        return os.path.join(self.root, SYS_DIR, "multipart", upload_id)

    def new_multipart_upload(
        self, bucket, object_name, metadata=None, sse=None, **kw
    ) -> str:
        check_object_name(object_name)
        self._require_bucket(bucket)
        if sse is not None:
            raise NotImplementedError("SSE on the FS backend")
        uid = uuid.uuid4().hex
        d = self._upload_dir(uid)
        os.makedirs(d)
        with open(
            os.path.join(d, "upload.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(
                {
                    "bucket": bucket,
                    "object": object_name,
                    "meta": dict(metadata or {}),
                    "started": time.time_ns(),
                },
                f,
            )
        return uid

    def _upload_doc(self, bucket, object_name, upload_id) -> dict:
        try:
            with open(
                os.path.join(self._upload_dir(upload_id), "upload.json"),
                encoding="utf-8",
            ) as f:
                doc = json.load(f)
        except OSError:
            raise api.InvalidUploadID(upload_id) from None
        if doc.get("bucket") != bucket or doc.get("object") != object_name:
            raise api.InvalidUploadID(upload_id)
        return doc

    def put_object_part(
        self, bucket, object_name, upload_id, part_number, reader,
        size=-1, sse=None, **kw
    ):
        from .api import PartInfo

        if sse is not None:
            raise NotImplementedError("SSE on the FS backend")
        self._upload_doc(bucket, object_name, upload_id)
        hreader = (
            reader
            if isinstance(reader, HashReader)
            else HashReader(reader, size)
        )
        tmp = os.path.join(
            self.root, SYS_DIR, "tmp", uuid.uuid4().hex
        )
        n = 0
        with open(tmp, "wb") as f:
            while True:
                chunk = hreader.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                n += len(chunk)
        d = self._upload_dir(upload_id)
        etag = hreader.etag()
        # persist the etag next to the part: complete validates the
        # client's CompletePart etags against these, and listing never
        # re-reads part bytes to hash them
        with open(
            os.path.join(d, f"part.{part_number}.etag"), "w",
            encoding="utf-8",
        ) as f:
            f.write(etag)
        os.replace(tmp, os.path.join(d, f"part.{part_number}"))
        return PartInfo(part_number, etag, n, n, time.time_ns())

    def list_object_parts(
        self, bucket, object_name, upload_id, **kw
    ) -> list:
        from .api import PartInfo

        self._upload_doc(bucket, object_name, upload_id)
        out = []
        d = self._upload_dir(upload_id)
        for fn in sorted(os.listdir(d)):
            if not fn.startswith("part.") or fn.endswith(".etag"):
                continue
            num = int(fn.split(".", 1)[1])
            full = os.path.join(d, fn)
            etag = self._part_etag(d, num)
            size = os.path.getsize(full)
            out.append(
                PartInfo(
                    num, etag, size, size,
                    int(os.stat(full).st_mtime_ns),
                )
            )
        return sorted(out, key=lambda p: p.part_number)

    @staticmethod
    def _part_etag(upload_dir: str, num: int) -> str:
        try:
            with open(
                os.path.join(upload_dir, f"part.{num}.etag"),
                encoding="utf-8",
            ) as f:
                return f.read().strip()
        except OSError:
            return ""

    def list_multipart_uploads(self, bucket, prefix="") -> list:
        out = []
        base = os.path.join(self.root, SYS_DIR, "multipart")
        for uid in sorted(os.listdir(base)):
            try:
                with open(
                    os.path.join(base, uid, "upload.json"),
                    encoding="utf-8",
                ) as f:
                    doc = json.load(f)
            except OSError:
                continue
            if doc.get("bucket") == bucket and doc.get(
                "object", ""
            ).startswith(prefix):
                out.append(
                    MultipartInfo(
                        bucket=bucket,
                        object=doc["object"],
                        upload_id=uid,
                        initiated_ns=doc.get("started", 0),
                    )
                )
        return out

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        self._upload_doc(bucket, object_name, upload_id)
        shutil.rmtree(self._upload_dir(upload_id), ignore_errors=True)

    def complete_multipart_upload(
        self, bucket, object_name, upload_id,
        parts: "list[CompletePart]", versioned=False, **kw
    ) -> ObjectInfo:
        doc = self._upload_doc(bucket, object_name, upload_id)
        d = self._upload_dir(upload_id)
        # validate order + sizes + etags (S3 complete-multipart rules)
        last = 0
        md5s = []
        total = 0
        for i, cp in enumerate(parts):
            if cp.part_number <= last:
                raise api.InvalidPartOrder(str(cp.part_number))
            last = cp.part_number
            p = os.path.join(d, f"part.{cp.part_number}")
            if not os.path.isfile(p):
                raise api.InvalidPart(str(cp.part_number))
            stored_etag = self._part_etag(d, cp.part_number)
            if cp.etag.strip('"') != stored_etag:
                raise api.InvalidPart(
                    f"part {cp.part_number} etag mismatch"
                )
            size = os.path.getsize(p)
            if i < len(parts) - 1 and size < self.min_part_size:
                raise api.EntityTooSmall(str(cp.part_number))
            md5s.append(bytes.fromhex(stored_etag))
            total += size
        tmp = os.path.join(self.root, SYS_DIR, "tmp", uuid.uuid4().hex)
        with open(tmp, "wb") as out:
            for cp in parts:
                with open(
                    os.path.join(d, f"part.{cp.part_number}"), "rb"
                ) as f:
                    shutil.copyfileobj(f, out)
        dst = self._obj_path(bucket, object_name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(tmp, dst)
        etag = (
            hashlib.md5(b"".join(md5s)).hexdigest() + f"-{len(parts)}"
        )
        meta = dict(doc.get("meta", {}))
        meta["etag"] = etag
        mod = time.time_ns()
        self._store_meta(
            bucket, object_name,
            {"meta": meta, "size": total, "actual": total, "mod": mod},
        )
        shutil.rmtree(d, ignore_errors=True)
        object_path_updated(f"{bucket}/{object_name}")
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=total,
            mod_time_ns=mod,
            etag=etag,
            content_type=meta.get("content-type", ""),
            user_defined=meta,
        )

    # -- heal / info -------------------------------------------------------

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> dict:
        self._require_bucket(bucket)
        return {"bucket": bucket, "healed": 0}

    def heal_object(self, bucket, object_name, version_id="",
                    dry_run=False) -> dict:
        self._stat(bucket, object_name)
        return {"object": object_name, "healed": 0}

    def storage_info(self) -> dict:
        st = os.statvfs(self.root)
        return {
            "backend": "fs",
            "disks": 1,
            "online": 1,
            "total": st.f_blocks * st.f_frsize,
            "free": st.f_bavail * st.f_frsize,
        }
