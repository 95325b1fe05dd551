"""S3 event records (pkg/event/event.go).

Event names form a hierarchy: ``s3:ObjectCreated:Put`` is matched by the
wildcard ``s3:ObjectCreated:*`` (the expandEventName mask logic,
pkg/event/name.go:60-106).  ``to_record`` renders the AWS S3 event
record JSON (the Records[] element every notification target consumes,
pkg/event/event.go:76-113).
"""

from __future__ import annotations

import dataclasses
import datetime
import urllib.parse


class EventName:
    OBJECT_CREATED_PUT = "s3:ObjectCreated:Put"
    OBJECT_CREATED_POST = "s3:ObjectCreated:Post"
    OBJECT_CREATED_COPY = "s3:ObjectCreated:Copy"
    OBJECT_CREATED_COMPLETE_MULTIPART = (
        "s3:ObjectCreated:CompleteMultipartUpload"
    )
    OBJECT_REMOVED_DELETE = "s3:ObjectRemoved:Delete"
    OBJECT_REMOVED_DELETE_MARKER = (
        "s3:ObjectRemoved:DeleteMarkerCreated"
    )
    OBJECT_ACCESSED_GET = "s3:ObjectAccessed:Get"
    OBJECT_ACCESSED_HEAD = "s3:ObjectAccessed:Head"

    ALL = (
        OBJECT_CREATED_PUT,
        OBJECT_CREATED_POST,
        OBJECT_CREATED_COPY,
        OBJECT_CREATED_COMPLETE_MULTIPART,
        OBJECT_REMOVED_DELETE,
        OBJECT_REMOVED_DELETE_MARKER,
        OBJECT_ACCESSED_GET,
        OBJECT_ACCESSED_HEAD,
    )

    @staticmethod
    def expand(name: str) -> "tuple[str, ...]":
        """A wildcard covers every concrete name under its prefix
        (pkg/event/name.go Expand)."""
        if name.endswith(":*"):
            prefix = name[:-1]  # keep the trailing colon
            return tuple(
                n for n in EventName.ALL if n.startswith(prefix)
            )
        return (name,)

    @staticmethod
    def valid(name: str) -> bool:
        return bool(EventName.expand(name)) and (
            name in EventName.ALL or name.endswith(":*")
        )


@dataclasses.dataclass
class Identity:
    principal_id: str = ""
    source_ip: str = ""


@dataclasses.dataclass
class Event:
    """One bucket event; rendered as an AWS S3 record."""

    name: str
    bucket: str
    object_key: str
    etag: str = ""
    size: int = 0
    version_id: str = ""
    sequencer: str = ""
    identity: Identity = dataclasses.field(default_factory=Identity)
    time_ns: int = 0
    endpoint: str = ""

    def to_record(self) -> dict:
        ts = datetime.datetime.fromtimestamp(
            self.time_ns / 1e9, tz=datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
        return {
            "eventVersion": "2.1",
            "eventSource": "minio-tpu:s3",
            "awsRegion": "",
            "eventTime": ts,
            "eventName": self.name[len("s3:"):],
            "userIdentity": {
                "principalId": self.identity.principal_id
            },
            "requestParameters": {
                "sourceIPAddress": self.identity.source_ip
            },
            "responseElements": {
                "x-minio-origin-endpoint": self.endpoint,
            },
            "s3": {
                "s3SchemaVersion": "1.0",
                "bucket": {
                    "name": self.bucket,
                    "ownerIdentity": {
                        "principalId": self.identity.principal_id
                    },
                    "arn": f"arn:aws:s3:::{self.bucket}",
                },
                "object": {
                    "key": urllib.parse.quote(self.object_key),
                    "size": self.size,
                    "eTag": self.etag,
                    "versionId": self.version_id,
                    "sequencer": self.sequencer,
                },
            },
        }


def matches_filter(
    ev: "Event", bucket: str, names, prefix: str, suffix: str
) -> bool:
    """The ListenBucketNotification match predicate, shared by the
    local stream loop and the remote listenbuf RPC so local and
    cluster watchers can never disagree on what matches."""
    if ev.bucket != bucket:
        return False
    if names and ev.name not in names:
        return False
    key = ev.object_key
    return key.startswith(prefix) and key.endswith(suffix)


def to_listen_record(ev: "Event") -> dict:
    """Wire shape of one notification line/record."""
    return {
        "EventName": ev.name,
        "Key": f"{ev.bucket}/{ev.object_key}",
        "Records": [ev.to_record()],
    }
