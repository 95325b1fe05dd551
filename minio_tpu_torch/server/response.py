"""S3 XML response rendering (cmd/api-response.go).

Hand-built with xml.etree: responses are small and schema-fixed; the S3
namespace is applied on the root element like encodeResponse.  The
multipart, version-listing, copy, multi-delete and POST-upload documents
come with the slices that port those routes.
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
