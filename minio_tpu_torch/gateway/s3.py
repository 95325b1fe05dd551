"""S3 gateway: ObjectLayer over an upstream S3-compatible store
(cmd/gateway/s3/gateway-s3.go).

Every ObjectLayer call maps to one upstream S3 request; bodies stream
both ways.  Versioning/heal surfaces raise NotImplementedError - the
reference's S3 gateway advertises the same reduced capability set
(gateway-s3.go IsCompressionSupported/IsEncryptionSupported gating).
"""

from __future__ import annotations

import email.utils
import threading
import urllib.parse
import xml.etree.ElementTree as ET

from ..objectlayer import api
from ..objectlayer.api import (
    BucketInfo,
    CompletePart,
    ListObjectsInfo,
    MultipartInfo,
    ObjectInfo,
    PartInfo,
    check_bucket_name,
    check_object_name,
    prepare_copy_meta,
)
from .client import S3UpstreamClient, UpstreamError

_ERR_MAP = {
    "NoSuchBucket": api.BucketNotFound,
    "NoSuchKey": api.ObjectNotFound,
    "NoSuchVersion": api.VersionNotFound,
    "BucketAlreadyOwnedByYou": api.BucketExists,
    "BucketAlreadyExists": api.BucketExists,
    "BucketNotEmpty": api.BucketNotEmpty,
    "InvalidBucketName": api.InvalidBucketName,
    "NoSuchUpload": api.InvalidUploadID,
    "InvalidPart": api.InvalidPart,
    "InvalidPartOrder": api.InvalidPartOrder,
    "EntityTooSmall": api.EntityTooSmall,
    "InvalidRange": api.InvalidRange,
    "PreconditionFailed": api.PreconditionFailed,
}


def _ns(tag: str) -> str:
    return tag.split("}")[-1]


def _find(el, name, default=""):
    for c in el:
        if _ns(c.tag) == name:
            return c.text or default
    return default


def _parse_http_date(raw: str) -> int:
    try:
        return int(
            email.utils.parsedate_to_datetime(raw).timestamp() * 1e9
        )
    except (TypeError, ValueError):
        return 0


def _parse_iso(raw: str) -> int:
    import datetime

    try:
        return int(
            datetime.datetime.fromisoformat(
                raw.replace("Z", "+00:00")
            ).timestamp()
            * 1e9
        )
    except ValueError:
        return 0


class S3Objects(api.ObjectLayer):
    # the fronting server forwards customer keys instead of running
    # its own SSE guards: the upstream owns encryption (_read_info_
    # and_sse in server/http.py keys off this)
    sse_passthrough = True

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        self._c = S3UpstreamClient(
            endpoint, access_key, secret_key, region
        )
        # the reserved meta volume cannot live upstream (the upstream
        # S3 router refuses its own reserved namespace), so bucket
        # config documents are node-local and ephemeral here - the
        # reference's S3 gateway keeps bucket config similarly
        # reduced (gateway-s3.go unsupported config surfaces)
        self._meta_store: "dict[str, bytes]" = {}
        self._meta_mu = threading.Lock()

    # -- error translation -------------------------------------------------

    def _raise(self, status: int, payload: bytes, what: str):
        code, msg = self._c.error_code(payload)
        exc = _ERR_MAP.get(code)
        if exc is not None:
            raise exc(msg or what)
        raise UpstreamError(status, code or "UpstreamError", msg or what)

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        check_bucket_name(bucket)
        if bucket == api.META_BUCKET:
            return
        st, _h, body = self._c.request("PUT", f"/{bucket}")
        if st not in (200, 204):
            self._raise(st, body, bucket)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        if bucket == api.META_BUCKET:
            return BucketInfo(name=bucket, created_ns=0)
        st, _h, body = self._c.request("HEAD", f"/{bucket}")
        if st == 404:
            raise api.BucketNotFound(bucket)
        if st >= 300:
            raise UpstreamError(st, "UpstreamError", bucket)
        return BucketInfo(name=bucket, created_ns=0)

    def list_buckets(self) -> "list[BucketInfo]":
        st, _h, body = self._c.request("GET", "/")
        if st != 200:
            self._raise(st, body, "list buckets")
        out = []
        root = ET.fromstring(body)
        for b in root.iter():
            if _ns(b.tag) == "Bucket":
                out.append(
                    BucketInfo(
                        name=_find(b, "Name"),
                        created_ns=_parse_iso(_find(b, "CreationDate")),
                    )
                )
        return out

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        if force:
            # upstream S3 has no force-delete: drain it first
            while True:
                res = self.list_objects(bucket, max_keys=1000)
                if not res.objects:
                    break
                for oi in res.objects:
                    self.delete_object(bucket, oi.name)
        st, _h, body = self._c.request("DELETE", f"/{bucket}")
        if st not in (200, 204):
            self._raise(st, body, bucket)

    # -- objects -----------------------------------------------------------

    @staticmethod
    def _sse_headers(sse, copy_source: bool = False) -> dict:
        """SSE passthrough headers for the upstream (the reference's
        gateway-s3-sse.go forwards customer keys verbatim; SSE-S3 is
        one algorithm header - the UPSTREAM owns the encryption)."""
        if sse is None:
            return {}
        if getattr(sse, "mode", "") == "C":
            import base64 as _b64

            from ..codec import sse as ssemod

            prefix = (
                "x-amz-copy-source-server-side-encryption-customer"
                if copy_source
                else "x-amz-server-side-encryption-customer"
            )
            return {
                f"{prefix}-algorithm": "AES256",
                f"{prefix}-key": _b64.b64encode(sse.key).decode(),
                f"{prefix}-key-MD5": ssemod.key_md5_b64(sse.key),
            }
        if copy_source:
            # an SSE-S3 SOURCE needs no request header (the upstream
            # decrypts transparently); emitting the destination
            # header here would silently encrypt the destination
            return {}
        return {"x-amz-server-side-encryption": "AES256"}

    @staticmethod
    def _meta_headers(metadata: "dict | None") -> dict:
        headers = {}
        for k, v in (metadata or {}).items():
            lk = k.lower()
            if lk == "content-type":
                headers["content-type"] = v
            elif lk.startswith("x-amz-meta-") or lk == "x-amz-tagging":
                headers[lk] = v
        return headers

    def put_object(self, bucket, object_name, reader, size=-1,
                   metadata=None, versioned=False, compress=None,
                   sse=None):
        check_object_name(object_name)
        if bucket == api.META_BUCKET:
            data = reader.read() if size < 0 else reader.read(size)
            with self._meta_mu:
                self._meta_store[object_name] = data
            return ObjectInfo(
                bucket=bucket, name=object_name, size=len(data)
            )
        if size < 0:
            raise NotImplementedError(
                "unsized streams through the S3 gateway"
            )
        headers = self._meta_headers(metadata)
        headers.update(self._sse_headers(sse))
        st, h, body = self._c.request(
            "PUT",
            f"/{bucket}/{object_name}",
            headers=headers,
            reader=reader,
            content_length=size,
        )
        if st != 200:
            self._raise(st, body, f"{bucket}/{object_name}")
        hl = {k.lower(): v for k, v in h.items()}
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=size,
            etag=hl.get("etag", "").strip('"'),
            version_id=hl.get("x-amz-version-id", ""),
            user_defined=dict(metadata or {}),
        )

    def _head(
        self, bucket, object_name, version_id="", sse=None
    ) -> "tuple[int, dict]":
        st, h, _b = self._c.request(
            "HEAD",
            f"/{bucket}/{object_name}",
            query={"versionId": version_id} if version_id else None,
            headers=self._sse_headers(sse) or None,
        )
        return st, {k.lower(): v for k, v in h.items()}

    def get_object_info(
        self, bucket, object_name, version_id="", sse=None
    ):
        check_object_name(object_name)
        if bucket == api.META_BUCKET:
            with self._meta_mu:
                data = self._meta_store.get(object_name)
            if data is None:
                raise api.ObjectNotFound(f"{bucket}/{object_name}")
            return ObjectInfo(
                bucket=bucket, name=object_name, size=len(data)
            )
        st, h = self._head(bucket, object_name, version_id, sse)
        if st == 404:
            if version_id:
                raise api.VersionNotFound(
                    f"{bucket}/{object_name}@{version_id}"
                )
            raise api.ObjectNotFound(f"{bucket}/{object_name}")
        if st >= 300:
            raise UpstreamError(st, "UpstreamError", object_name)
        meta = {
            k: v for k, v in h.items() if k.startswith("x-amz-meta-")
        }
        if "x-amz-tagging" in h:
            meta["x-amz-tagging"] = h["x-amz-tagging"]
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=int(h.get("content-length", 0)),
            mod_time_ns=_parse_http_date(h.get("last-modified", "")),
            etag=h.get("etag", "").strip('"'),
            content_type=h.get("content-type", ""),
            version_id=h.get("x-amz-version-id", ""),
            user_defined=meta,
        )

    def get_object(self, bucket, object_name, writer, offset=0,
                   length=-1, version_id="", sse=None):
        check_object_name(object_name)
        if bucket == api.META_BUCKET:
            with self._meta_mu:
                data = self._meta_store.get(object_name)
            if data is None:
                raise api.ObjectNotFound(f"{bucket}/{object_name}")
            end = offset + length if length >= 0 else len(data)
            writer.write(data[offset:end])
            return ObjectInfo(
                bucket=bucket, name=object_name, size=len(data)
            )
        headers = self._sse_headers(sse)
        if offset or length >= 0:
            end = f"{offset + length - 1}" if length >= 0 else ""
            headers["range"] = f"bytes={offset}-{end}"
        resp = self._c.request(
            "GET",
            f"/{bucket}/{object_name}",
            query={"versionId": version_id} if version_id else None,
            headers=headers,
            stream_response=True,
        )
        if isinstance(resp, tuple):  # error path: (st, h, body)
            st, _h, body = resp
            if st == 404 and version_id:
                raise api.VersionNotFound(
                    f"{bucket}/{object_name}@{version_id}"
                )
            self._raise(st, body, f"{bucket}/{object_name}")
        try:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                writer.write(chunk)
        finally:
            resp.close()
        return self.get_object_info(
            bucket, object_name, version_id, sse
        )

    def delete_object(self, bucket, object_name, version_id="",
                      versioned=False, version_suspended=False):
        check_object_name(object_name)
        if bucket == api.META_BUCKET:
            with self._meta_mu:
                if self._meta_store.pop(object_name, None) is None:
                    raise api.ObjectNotFound(
                        f"{bucket}/{object_name}"
                    )
            return ObjectInfo(bucket=bucket, name=object_name)
        st, h, body = self._c.request(
            "DELETE",
            f"/{bucket}/{object_name}",
            query={"versionId": version_id} if version_id else None,
        )
        if st not in (200, 204):
            self._raise(st, body, f"{bucket}/{object_name}")
        hl = {k.lower(): v for k, v in h.items()}
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            version_id=hl.get("x-amz-version-id", version_id),
            delete_marker=hl.get("x-amz-delete-marker") == "true",
        )

    def copy_object(self, src_bucket, src_object, dst_bucket,
                    dst_object, metadata=None, versioned=False,
                    sse_src=None, sse=None):
        src_info = self.get_object_info(
            src_bucket, src_object, sse=sse_src
        )
        headers = {
            "x-amz-copy-source": urllib.parse.quote(
                f"/{src_bucket}/{src_object}"
            ),
        }
        headers.update(self._sse_headers(sse_src, copy_source=True))
        headers.update(self._sse_headers(sse))
        if metadata is not None:
            headers["x-amz-metadata-directive"] = "REPLACE"
            headers.update(
                self._meta_headers(
                    prepare_copy_meta(src_info, metadata)
                )
            )
        st, _h, body = self._c.request(
            "PUT",
            f"/{dst_bucket}/{dst_object}",
            headers=headers,
        )
        if st != 200:
            self._raise(st, body, f"{dst_bucket}/{dst_object}")
        root = ET.fromstring(body)
        return ObjectInfo(
            bucket=dst_bucket,
            name=dst_object,
            size=src_info.size,
            etag=_find(root, "ETag").strip('"'),
        )

    def update_object_meta(self, bucket, object_name, updates,
                           version_id=""):
        info = self.get_object_info(bucket, object_name)
        meta = dict(info.user_defined)
        for k, v in updates.items():
            if v is None:
                meta.pop(k, None)
            else:
                meta[k] = v
        return self.copy_object(
            bucket, object_name, bucket, object_name, meta
        )

    # -- listing -----------------------------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000) -> ListObjectsInfo:
        q = {"max-keys": str(max_keys)}
        if prefix:
            q["prefix"] = prefix
        if marker:
            q["marker"] = marker
        if delimiter:
            q["delimiter"] = delimiter
        st, _h, body = self._c.request("GET", f"/{bucket}", query=q)
        if st != 200:
            self._raise(st, body, bucket)
        root = ET.fromstring(body)
        out = ListObjectsInfo()
        for el in root:
            tag = _ns(el.tag)
            if tag == "Contents":
                out.objects.append(
                    ObjectInfo(
                        bucket=bucket,
                        name=_find(el, "Key"),
                        size=int(_find(el, "Size", "0") or 0),
                        etag=_find(el, "ETag").strip('"'),
                        mod_time_ns=_parse_iso(
                            _find(el, "LastModified")
                        ),
                    )
                )
            elif tag == "CommonPrefixes":
                out.prefixes.append(_find(el, "Prefix"))
            elif tag == "IsTruncated":
                out.is_truncated = (el.text or "") == "true"
            elif tag == "NextMarker":
                out.next_marker = el.text or ""
        if out.is_truncated and not out.next_marker and out.objects:
            out.next_marker = out.objects[-1].name
        return out

    def has_object_versions(self, bucket, object_name) -> bool:
        res = self.list_object_versions(
            bucket, prefix=object_name, max_keys=2
        )
        return any(
            v.name == object_name and (
                v.version_id or v.delete_marker
            )
            for v in res.versions
        )

    def list_object_versions(
        self, bucket, prefix="", key_marker="", version_id_marker="",
        delimiter="", max_keys=1000,
    ):
        """Pass-through ListObjectVersions (?versions) with the
        upstream's XML mapped onto the layer's result shape."""
        q = {"versions": "", "max-keys": str(max_keys)}
        if prefix:
            q["prefix"] = prefix
        if key_marker:
            q["key-marker"] = key_marker
        if version_id_marker:
            q["version-id-marker"] = version_id_marker
        if delimiter:
            q["delimiter"] = delimiter
        st, _h, body = self._c.request("GET", f"/{bucket}", query=q)
        if st != 200:
            self._raise(st, body, bucket)
        root = ET.fromstring(body)
        out = api.ListObjectVersionsInfo(
            is_truncated=_find(root, "IsTruncated") == "true",
            next_key_marker=_find(root, "NextKeyMarker"),
            next_version_id_marker=_find(
                root, "NextVersionIdMarker"
            ),
        )
        for el in root:
            tag = el.tag.rsplit("}", 1)[-1]
            if tag == "CommonPrefixes":
                out.prefixes.append(_find(el, "Prefix"))
                continue
            if tag not in ("Version", "DeleteMarker"):
                continue
            vid = _find(el, "VersionId")
            out.versions.append(
                ObjectInfo(
                    bucket=bucket,
                    name=_find(el, "Key"),
                    size=int(_find(el, "Size") or 0),
                    etag=_find(el, "ETag").strip('"'),
                    mod_time_ns=_parse_iso(
                        _find(el, "LastModified")
                    ),
                    version_id="" if vid == "null" else vid,
                    is_latest=_find(el, "IsLatest") == "true",
                    delete_marker=tag == "DeleteMarker",
                )
            )
        return out

    # -- multipart ---------------------------------------------------------

    def new_multipart_upload(self, bucket, object_name, metadata=None,
                             sse=None):
        headers = self._meta_headers(metadata)
        headers.update(self._sse_headers(sse))
        st, _h, body = self._c.request(
            "POST",
            f"/{bucket}/{object_name}",
            query={"uploads": ""},
            headers=headers,
        )
        if st != 200:
            self._raise(st, body, f"{bucket}/{object_name}")
        return _find(ET.fromstring(body), "UploadId")

    def put_object_part(self, bucket, object_name, upload_id,
                        part_number, reader, size=-1, sse=None):
        if size < 0:
            raise NotImplementedError(
                "unsized parts through the S3 gateway"
            )
        st, h, body = self._c.request(
            "PUT",
            f"/{bucket}/{object_name}",
            query={
                "uploadId": upload_id,
                "partNumber": str(part_number),
            },
            headers=self._sse_headers(sse) or None,
            reader=reader,
            content_length=size,
        )
        if st != 200:
            self._raise(st, body, upload_id)
        hl = {k.lower(): v for k, v in h.items()}
        return PartInfo(
            part_number=part_number,
            etag=hl.get("etag", "").strip('"'),
            size=size,
            actual_size=size,
        )

    def list_object_parts(self, bucket, object_name, upload_id,
                          part_marker=0, max_parts=1000):
        st, _h, body = self._c.request(
            "GET",
            f"/{bucket}/{object_name}",
            query={
                "uploadId": upload_id,
                "part-number-marker": str(part_marker),
                "max-parts": str(max_parts),
            },
        )
        if st != 200:
            self._raise(st, body, upload_id)
        parts = []
        for el in ET.fromstring(body):
            if _ns(el.tag) == "Part":
                parts.append(
                    PartInfo(
                        part_number=int(_find(el, "PartNumber", "0")),
                        etag=_find(el, "ETag").strip('"'),
                        size=int(_find(el, "Size", "0") or 0),
                    )
                )
        return parts

    def list_multipart_uploads(self, bucket, prefix=""):
        st, _h, body = self._c.request(
            "GET", f"/{bucket}",
            query={"uploads": "", "prefix": prefix},
        )
        if st != 200:
            self._raise(st, body, bucket)
        out = []
        for el in ET.fromstring(body):
            if _ns(el.tag) == "Upload":
                out.append(
                    MultipartInfo(
                        bucket=bucket,
                        object=_find(el, "Key"),
                        upload_id=_find(el, "UploadId"),
                        initiated_ns=_parse_iso(
                            _find(el, "Initiated")
                        ),
                    )
                )
        return out

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        st, _h, body = self._c.request(
            "DELETE",
            f"/{bucket}/{object_name}",
            query={"uploadId": upload_id},
        )
        if st not in (200, 204):
            self._raise(st, body, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts: "list[CompletePart]",
                                  versioned=False, **kw):
        root = ET.Element("CompleteMultipartUpload")
        for cp in parts:
            pe = ET.SubElement(root, "Part")
            ET.SubElement(pe, "PartNumber").text = str(cp.part_number)
            ET.SubElement(pe, "ETag").text = cp.etag
        st, _h, body = self._c.request(
            "POST",
            f"/{bucket}/{object_name}",
            query={"uploadId": upload_id},
            body=ET.tostring(root),
        )
        if st != 200:
            self._raise(st, body, upload_id)
        etag = _find(ET.fromstring(body), "ETag").strip('"')
        info = self.get_object_info(bucket, object_name)
        info.etag = etag or info.etag
        return info

    # -- heal / info -------------------------------------------------------

    def heal_bucket(self, bucket, dry_run=False):
        raise NotImplementedError("heal through the S3 gateway")

    def heal_object(self, bucket, object_name, version_id="",
                    dry_run=False):
        raise NotImplementedError("heal through the S3 gateway")

    def storage_info(self) -> dict:
        return {
            "mode": "gateway-s3",
            "upstream": f"{self._c.host}:{self._c.port}",
        }
