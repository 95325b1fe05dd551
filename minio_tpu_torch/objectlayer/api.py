"""ObjectLayer interface + object-level data types and errors.

The seam between API handlers and storage backends
(cmd/object-api-interface.go:66-140 ObjectLayer; error types from
cmd/object-api-errors.go).  This port implements ErasureObjects (one
erasure set); the S3 front that calls it is ported in a later slice.
"""

from __future__ import annotations

import dataclasses


class ObjectLayerError(Exception):
    pass


class BucketNotFound(ObjectLayerError):
    pass


class BucketExists(ObjectLayerError):
    pass


class BucketNotEmpty(ObjectLayerError):
    pass


class InvalidBucketName(ObjectLayerError):
    pass


class ObjectNotFound(ObjectLayerError):
    pass


class VersionNotFound(ObjectLayerError):
    pass


class InvalidObjectName(ObjectLayerError):
    pass


class ReadQuorumError(ObjectLayerError):
    """errErasureReadQuorum."""


class WriteQuorumError(ObjectLayerError):
    """errErasureWriteQuorum."""


class InvalidRange(ObjectLayerError):
    pass


@dataclasses.dataclass
class BucketInfo:
    name: str
    created_ns: int


@dataclasses.dataclass
class ObjectInfo:
    """Object metadata surfaced to the API layer (cmd/object-api-datatypes.go)."""

    bucket: str
    name: str
    size: int = 0
    mod_time_ns: int = 0
    etag: str = ""
    content_type: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    user_defined: dict = dataclasses.field(default_factory=dict)
    parts: list = dataclasses.field(default_factory=list)
    is_dir: bool = False

    @property
    def mod_time(self) -> float:
        return self.mod_time_ns / 1e9


META_BUCKET = ".sys"


def check_bucket_name(name: str) -> None:
    """S3 bucket naming rules (IsValidBucketName, pkg bucket rules).

    The reserved meta volume is exempt (isMinioMetaBucketName): internal
    subsystems (IAM, bucket metadata) store erasure-coded documents
    there through the ordinary ObjectLayer path; the S3 router refuses
    it before any handler runs (authz.is_reserved_bucket)."""
    if name == META_BUCKET:
        return
    if not (3 <= len(name) <= 63):
        raise InvalidBucketName(name)
    if name.startswith((".", "-")) or name.endswith((".", "-")):
        raise InvalidBucketName(name)
    for ch in name:
        if not (ch.islower() and ch.isalnum() or ch.isdigit() or ch in ".-"):
            raise InvalidBucketName(name)
    if ".." in name or ".-" in name or "-." in name:
        raise InvalidBucketName(name)


def check_object_name(name: str) -> None:
    if not name or len(name) > 1024:
        raise InvalidObjectName(name)
    if name.startswith("/") or ".." in name.split("/"):
        raise InvalidObjectName(name)
    if "\0" in name:
        raise InvalidObjectName(name)


class ObjectLayer:
    """Abstract object store (subset grows as surfaces land)."""

    # buckets
    def make_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        raise NotImplementedError

    def list_buckets(self) -> list[BucketInfo]:
        raise NotImplementedError

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        raise NotImplementedError

    # objects
    def put_object(
        self, bucket: str, object_name: str, reader, size: int = -1,
        metadata: "dict | None" = None, versioned: bool = False,
    ) -> ObjectInfo:
        raise NotImplementedError

    def get_object_info(
        self, bucket: str, object_name: str, version_id: str = ""
    ) -> ObjectInfo:
        raise NotImplementedError

    def get_object(
        self, bucket: str, object_name: str, writer,
        offset: int = 0, length: int = -1, version_id: str = "",
    ) -> ObjectInfo:
        raise NotImplementedError

    def delete_object(
        self, bucket: str, object_name: str, version_id: str = ""
    ) -> ObjectInfo:
        raise NotImplementedError

    # health / maintenance
    def heal_object(
        self, bucket: str, object_name: str, version_id: str = "",
        dry_run: bool = False,
    ) -> dict:
        raise NotImplementedError

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> dict:
        raise NotImplementedError
