"""ObjectLayer interface + object-level data types and errors.

The seam between API handlers and storage backends
(cmd/object-api-interface.go:66-140 ObjectLayer; error types from
cmd/object-api-errors.go).  This port implements ErasureObjects (one
erasure set); the S3 front (server/http.py) calls it.
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


class InvalidUploadID(ObjectLayerError):
    pass


class InvalidPart(ObjectLayerError):
    pass


class InvalidPartOrder(ObjectLayerError):
    pass


class EntityTooSmall(ObjectLayerError):
    """Non-final multipart part below the S3 5 MiB minimum."""


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


@dataclasses.dataclass
class ListObjectsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    objects: list = dataclasses.field(default_factory=list)
    prefixes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ListObjectVersionsInfo:
    """ListObjectVersions result: versions + delete markers interleaved
    newest-first per key (ListObjectVersions, cmd/object-api-datatypes.go)."""

    is_truncated: bool = False
    next_key_marker: str = ""
    next_version_id_marker: str = ""
    versions: list = dataclasses.field(default_factory=list)
    prefixes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ListMultipartsInfo:
    uploads: list = dataclasses.field(default_factory=list)
    is_truncated: bool = False


@dataclasses.dataclass
class MultipartInfo:
    bucket: str = ""
    object: str = ""
    upload_id: str = ""
    initiated_ns: int = 0


@dataclasses.dataclass
class PartInfo:
    part_number: int = 0
    etag: str = ""
    size: int = 0
    actual_size: int = 0
    mod_time_ns: int = 0


@dataclasses.dataclass
class CompletePart:
    part_number: int
    etag: str


META_BUCKET = ".sys"

# metadata markers of the JAX package's object transforms (compression,
# SSE): an object or upload carrying one cannot be served until slice 8
META_COMPRESSION = "x-internal-compression"
META_SSE = "x-internal-sse"


def is_transformed(meta: dict) -> bool:
    return bool(meta.get(META_COMPRESSION) or meta.get(META_SSE))


def unported(what: str, slice_no: "int | str") -> NotImplementedError:
    """The error of a feature this package has not ported yet."""
    return NotImplementedError(
        f"{what} is not ported to minio_tpu_torch yet (slice {slice_no})"
    )


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


def prepare_copy_meta(src_info, metadata: "dict | None") -> dict:
    """Destination metadata for CopyObject: source user metadata with
    directive overrides applied, minus the etag and EVERY internal
    transform marker (compression, SSE, ...) - the copy pipe carries
    decoded plaintext and the destination put re-applies its own
    transforms, so a stale marker would make GET misinterpret the
    stored bytes."""
    meta = {
        k: v
        for k, v in src_info.user_defined.items()
        if not k.startswith("x-internal-")
    }
    if metadata:
        meta.update(metadata)
    meta.pop("etag", None)
    return meta


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

    def update_object_meta(
        self, bucket: str, object_name: str, updates: dict,
        version_id: str = "",
    ) -> ObjectInfo:
        """Merge metadata updates into an existing version (tags,
        retention, legal hold).  None values remove keys."""
        raise NotImplementedError

    def copy_object(
        self, src_bucket: str, src_object: str, dst_bucket: str,
        dst_object: str, metadata: "dict | None" = None,
        versioned: bool = False,
    ) -> ObjectInfo:
        raise NotImplementedError

    def list_object_versions(
        self, bucket: str, prefix: str = "", key_marker: str = "",
        version_id_marker: str = "", delimiter: str = "",
        max_keys: int = 1000,
    ) -> ListObjectVersionsInfo:
        raise NotImplementedError

    # multipart
    def new_multipart_upload(
        self, bucket: str, object_name: str, metadata: "dict | None" = None
    ) -> str:
        raise NotImplementedError

    def put_object_part(
        self, bucket: str, object_name: str, upload_id: str,
        part_number: int, reader, size: int = -1,
    ) -> PartInfo:
        raise NotImplementedError

    def list_object_parts(
        self, bucket: str, object_name: str, upload_id: str,
        part_marker: int = 0, max_parts: int = 1000,
    ) -> list[PartInfo]:
        raise NotImplementedError

    def list_multipart_uploads(
        self, bucket: str, prefix: str = ""
    ) -> list[MultipartInfo]:
        raise NotImplementedError

    def abort_multipart_upload(
        self, bucket: str, object_name: str, upload_id: str
    ) -> None:
        raise NotImplementedError

    def complete_multipart_upload(
        self, bucket: str, object_name: str, upload_id: str,
        parts: list[CompletePart],
    ) -> ObjectInfo:
        raise NotImplementedError

    # health / maintenance
    def heal_object(
        self, bucket: str, object_name: str, version_id: str = "",
        dry_run: bool = False,
    ) -> dict:
        raise NotImplementedError

    def list_objects(
        self, bucket: str, prefix: str = "", marker: str = "",
        delimiter: str = "", max_keys: int = 1000,
    ) -> ListObjectsInfo:
        raise NotImplementedError

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> dict:
        raise NotImplementedError

    def storage_info(self) -> dict:
        raise NotImplementedError
