"""S3 tag sets (pkg/tags in later reference trees; mid-2020 reference
validates tags inline in the handlers).

One parser/serializer used by bucket tagging, object tagging, and the
``x-amz-tagging`` PUT header (URL-encoded form).
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET

from .xmlutil import strip_ns as _strip_ns

MAX_OBJECT_TAGS = 10
MAX_BUCKET_TAGS = 50
MAX_KEY_LEN = 128
MAX_VALUE_LEN = 256

_S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class TagError(Exception):
    pass


class TagXMLError(TagError):
    """Unparseable document: MalformedXML on the wire, not InvalidTag
    (AWS distinguishes schema failure from tag-content failure)."""


def validate(tags: "dict[str, str]", limit: int) -> None:
    if len(tags) > limit:
        raise TagError(f"too many tags (max {limit})")
    for k, v in tags.items():
        if not k or len(k) > MAX_KEY_LEN:
            raise TagError(f"invalid tag key {k!r}")
        if len(v) > MAX_VALUE_LEN:
            raise TagError(f"tag value too long for key {k!r}")


def from_xml(body: bytes, limit: int) -> "dict[str, str]":
    """Parse a <Tagging><TagSet><Tag>... document."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise TagXMLError("malformed XML") from None
    if _strip_ns(root.tag) != "Tagging":
        raise TagXMLError("not a Tagging document")
    tags: dict[str, str] = {}
    for el in root.iter():
        if _strip_ns(el.tag) != "Tag":
            continue
        key = value = None
        for child in el:
            name = _strip_ns(child.tag)
            if name == "Key":
                key = (child.text or "").strip()
            elif name == "Value":
                value = child.text or ""
        if key is None:
            raise TagError("Tag missing Key")
        if key in tags:
            raise TagError(f"duplicate tag key {key!r}")
        tags[key] = value or ""
    validate(tags, limit)
    return tags


def to_xml(tags: "dict[str, str]") -> bytes:
    import xml.sax.saxutils as sx

    items = "".join(
        f"<Tag><Key>{sx.escape(k)}</Key><Value>{sx.escape(v)}</Value></Tag>"
        for k, v in tags.items()
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f'<Tagging xmlns="{_S3_NS}"><TagSet>{items}</TagSet></Tagging>'
    ).encode()


def from_header(value: str, limit: int = MAX_OBJECT_TAGS) -> "dict[str, str]":
    """Parse the URL-encoded x-amz-tagging request header."""
    tags: dict[str, str] = {}
    if not value:
        return tags
    for k, v in urllib.parse.parse_qsl(value, keep_blank_values=True):
        if k in tags:
            raise TagError(f"duplicate tag key {k!r}")
        tags[k] = v
    validate(tags, limit)
    return tags


def encode(tags: "dict[str, str]") -> str:
    """Tags -> the URL-encoded form stored in object metadata
    (xhttp.AmzObjectTagging / UserTags in FileInfo)."""
    return urllib.parse.urlencode(tags)


def decode(value: str) -> "dict[str, str]":
    return dict(
        urllib.parse.parse_qsl(value, keep_blank_values=True)
    )
