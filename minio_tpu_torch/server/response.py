"""S3 XML response rendering (cmd/api-response.go).

Hand-built with xml.etree: responses are small and schema-fixed; the S3
namespace is applied on the root element like encodeResponse.
"""

from __future__ import annotations

import datetime
import urllib.parse
import xml.etree.ElementTree as ET

S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _render(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(
        root, encoding="unicode"
    ).encode()


def _iso(ns: int) -> str:
    return (
        datetime.datetime.fromtimestamp(
            ns / 1e9, tz=datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]
        + "Z"
    )


def error_xml(
    code: str, message: str, resource: str, request_id: str
) -> bytes:
    root = ET.Element("Error")
    _el(root, "Code", code)
    _el(root, "Message", message)
    _el(root, "Resource", resource)
    _el(root, "RequestId", request_id)
    _el(root, "HostId", "minio-tpu")
    return _render(root)


def list_buckets_xml(buckets, owner="minio") -> bytes:
    root = ET.Element(
        "ListAllMyBucketsResult", xmlns=S3_NS
    )
    own = _el(root, "Owner")
    _el(own, "ID", owner)
    _el(own, "DisplayName", owner)
    bs = _el(root, "Buckets")
    for b in buckets:
        be = _el(bs, "Bucket")
        _el(be, "Name", b.name)
        _el(be, "CreationDate", _iso(b.created_ns))
    return _render(root)


def _obj_entry(parent, o, encode: bool):
    c = _el(parent, "Contents")
    _el(c, "Key", _maybe_encode(o.name, encode))
    _el(c, "LastModified", _iso(o.mod_time_ns))
    _el(c, "ETag", f'"{o.etag}"')
    _el(c, "Size", o.size)
    _el(c, "StorageClass", "STANDARD")


def _maybe_encode(s: str, encode: bool) -> str:
    return urllib.parse.quote(s) if encode else s


def list_objects_v1_xml(
    bucket, prefix, marker, delimiter, max_keys, result, encode: bool
) -> bytes:
    root = ET.Element("ListBucketResult", xmlns=S3_NS)
    _el(root, "Name", bucket)
    _el(root, "Prefix", _maybe_encode(prefix, encode))
    _el(root, "Marker", _maybe_encode(marker, encode))
    _el(root, "MaxKeys", max_keys)
    if delimiter:
        _el(root, "Delimiter", _maybe_encode(delimiter, encode))
    _el(root, "IsTruncated", "true" if result.is_truncated else "false")
    if result.is_truncated and result.next_marker:
        _el(root, "NextMarker", _maybe_encode(result.next_marker, encode))
    for o in result.objects:
        _obj_entry(root, o, encode)
    for p in result.prefixes:
        cp = _el(root, "CommonPrefixes")
        _el(cp, "Prefix", _maybe_encode(p, encode))
    return _render(root)


def list_objects_v2_xml(
    bucket, prefix, delimiter, max_keys, start_after,
    continuation_token, result, encode: bool,
) -> bytes:
    root = ET.Element("ListBucketResult", xmlns=S3_NS)
    _el(root, "Name", bucket)
    _el(root, "Prefix", _maybe_encode(prefix, encode))
    _el(root, "MaxKeys", max_keys)
    if delimiter:
        _el(root, "Delimiter", _maybe_encode(delimiter, encode))
    _el(root, "KeyCount", len(result.objects) + len(result.prefixes))
    if start_after:
        _el(root, "StartAfter", _maybe_encode(start_after, encode))
    if continuation_token:
        _el(root, "ContinuationToken", continuation_token)
    _el(root, "IsTruncated", "true" if result.is_truncated else "false")
    if result.is_truncated and result.next_marker:
        import base64

        _el(
            root,
            "NextContinuationToken",
            base64.urlsafe_b64encode(
                result.next_marker.encode()
            ).decode(),
        )
    for o in result.objects:
        _obj_entry(root, o, encode)
    for p in result.prefixes:
        cp = _el(root, "CommonPrefixes")
        _el(cp, "Prefix", _maybe_encode(p, encode))
    return _render(root)


def location_xml(region: str = "") -> bytes:
    root = ET.Element("LocationConstraint", xmlns=S3_NS)
    root.text = region
    return _render(root)


def initiate_multipart_xml(bucket, key, upload_id) -> bytes:
    root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "UploadId", upload_id)
    return _render(root)


def complete_multipart_xml(location, bucket, key, etag) -> bytes:
    root = ET.Element("CompleteMultipartUploadResult", xmlns=S3_NS)
    _el(root, "Location", location)
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "ETag", f'"{etag}"')
    return _render(root)


def list_parts_xml(bucket, key, upload_id, parts) -> bytes:
    root = ET.Element("ListPartsResult", xmlns=S3_NS)
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "UploadId", upload_id)
    _el(root, "StorageClass", "STANDARD")
    _el(root, "IsTruncated", "false")
    for p in parts:
        pe = _el(root, "Part")
        _el(pe, "PartNumber", p.part_number)
        _el(pe, "LastModified", _iso(p.mod_time_ns))
        _el(pe, "ETag", f'"{p.etag}"')
        _el(pe, "Size", p.size)
    return _render(root)


def list_uploads_xml(bucket, uploads) -> bytes:
    root = ET.Element("ListMultipartUploadsResult", xmlns=S3_NS)
    _el(root, "Bucket", bucket)
    _el(root, "IsTruncated", "false")
    for u in uploads:
        ue = _el(root, "Upload")
        _el(ue, "Key", u.object)
        _el(ue, "UploadId", u.upload_id)
        _el(ue, "StorageClass", "STANDARD")
        _el(ue, "Initiated", _iso(u.initiated_ns))
    return _render(root)


def copy_object_xml(etag, mod_time_ns) -> bytes:
    root = ET.Element("CopyObjectResult", xmlns=S3_NS)
    _el(root, "LastModified", _iso(mod_time_ns))
    _el(root, "ETag", f'"{etag}"')
    return _render(root)


def copy_part_xml(etag, mod_time_ns) -> bytes:
    """UploadPartCopy response (CopyObjectPartResponse)."""
    root = ET.Element("CopyPartResult", xmlns=S3_NS)
    _el(root, "LastModified", _iso(mod_time_ns))
    _el(root, "ETag", f'"{etag}"')
    return _render(root)


def delete_result_xml(deleted: list[str], errors: list[tuple]) -> bytes:
    root = ET.Element("DeleteResult", xmlns=S3_NS)
    for key in deleted:
        de = _el(root, "Deleted")
        _el(de, "Key", key)
    for key, code, msg in errors:
        ee = _el(root, "Error")
        _el(ee, "Key", key)
        _el(ee, "Code", code)
        _el(ee, "Message", msg)
    return _render(root)


def post_response_xml(location, bucket, key, etag) -> bytes:
    """201 body for POST policy uploads with success_action_status=201."""
    root = ET.Element("PostResponse")
    _el(root, "Location", location)
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "ETag", f'"{etag}"')
    return _render(root)


def list_versions_xml(
    bucket, prefix, key_marker, version_id_marker, delimiter,
    max_keys, res, encode: bool = False,
) -> bytes:
    """ListVersionsResult: Version + DeleteMarker entries
    (generateListVersionsResponse, cmd/api-response.go)."""
    root = ET.Element("ListVersionsResult", xmlns=S3_NS)
    _el(root, "Name", bucket)
    _el(root, "Prefix", _maybe_encode(prefix, encode))
    _el(root, "KeyMarker", _maybe_encode(key_marker, encode))
    if version_id_marker:
        _el(root, "VersionIdMarker", version_id_marker)
    if delimiter:
        _el(root, "Delimiter", _maybe_encode(delimiter, encode))
    _el(root, "MaxKeys", max_keys)
    _el(root, "IsTruncated", "true" if res.is_truncated else "false")
    if res.is_truncated:
        _el(root, "NextKeyMarker", _maybe_encode(res.next_key_marker, encode))
        _el(root, "NextVersionIdMarker", res.next_version_id_marker)
    for o in res.versions:
        tag = "DeleteMarker" if o.delete_marker else "Version"
        ve = _el(root, tag)
        _el(ve, "Key", _maybe_encode(o.name, encode))
        _el(ve, "VersionId", o.version_id or "null")
        _el(ve, "IsLatest", "true" if o.is_latest else "false")
        _el(ve, "LastModified", _iso(o.mod_time_ns))
        if not o.delete_marker:
            _el(ve, "ETag", f'"{o.etag}"')
            _el(ve, "Size", o.size)
            _el(ve, "StorageClass", "STANDARD")
        own = _el(ve, "Owner")
        _el(own, "ID", "minio")
        _el(own, "DisplayName", "minio")
    for p in res.prefixes:
        cp = _el(root, "CommonPrefixes")
        _el(cp, "Prefix", _maybe_encode(p, encode))
    return _render(root)
