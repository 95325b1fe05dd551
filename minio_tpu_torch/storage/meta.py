"""xl.meta: the per-object metadata journal (xl-storage-format-v2 analogue).

Every object directory holds one ``xl.meta`` file: a magic header plus a
MessagePack document (encoded by storage/mpack.py, byte-compatible with
msgpack's own) containing a *version journal* - an array of version
entries (objects and delete markers), newest first, exactly the shape of
xlMetaV2 (reference cmd/xl-storage-format-v2.go:140-228).  Each erasure
shard set member writes its own xl.meta differing only in
``erasure.index`` (which shard this disk holds), mirroring how the
reference stamps ErasureInfo.Index per disk.

Layout on disk (xl-storage-format-v2.go:71-83):

    <bucket>/<object>/xl.meta
    <bucket>/<object>/<data_dir-uuid>/part.1 ...
"""

from __future__ import annotations

import dataclasses
import time
import uuid

from . import mpack

XL_MAGIC = b"XLT1"  # this framework's format magic + version
NULL_VERSION_ID = "null"


@dataclasses.dataclass
class ErasureInfo:
    """Per-object erasure geometry (ErasureInfo, xl-storage-format-v1.go)."""

    algorithm: str = "rs-vandermonde"
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0  # 1-based shard index this disk holds
    distribution: list[int] = dataclasses.field(default_factory=list)
    checksum_algo: str = "phash256"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ErasureInfo":
        return cls(**d)


@dataclasses.dataclass
class ObjectPartInfo:
    """One multipart part (ObjectPartInfo, erasure-metadata.go)."""

    number: int
    size: int  # stored (possibly compressed/encrypted) size
    actual_size: int  # original client payload size

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectPartInfo":
        return cls(**d)


@dataclasses.dataclass
class FileInfo:
    """One object version's metadata (FileInfo, cmd/storage-datatypes.go).

    The unit the object layer reads/writes through StorageAPI
    ReadVersion/WriteMetadata and runs quorum over
    (findFileInfoInQuorum, cmd/erasure-metadata.go:215).
    """

    volume: str = ""
    name: str = ""
    version_id: str = ""
    is_latest: bool = True
    deleted: bool = False  # delete marker
    data_dir: str = ""
    size: int = 0
    mod_time_ns: int = 0
    metadata: dict = dataclasses.field(default_factory=dict)
    parts: list[ObjectPartInfo] = dataclasses.field(default_factory=list)
    erasure: ErasureInfo = dataclasses.field(default_factory=ErasureInfo)

    @property
    def mod_time(self) -> float:
        return self.mod_time_ns / 1e9

    def to_dict(self) -> dict:
        return {
            "version_id": self.version_id,
            "deleted": self.deleted,
            "data_dir": self.data_dir,
            "size": self.size,
            "mod_time_ns": self.mod_time_ns,
            "metadata": self.metadata,
            "parts": [p.to_dict() for p in self.parts],
            "erasure": self.erasure.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict, volume="", name="") -> "FileInfo":
        return cls(
            volume=volume,
            name=name,
            version_id=d.get("version_id", ""),
            deleted=d.get("deleted", False),
            data_dir=d.get("data_dir", ""),
            size=d.get("size", 0),
            mod_time_ns=d.get("mod_time_ns", 0),
            metadata=dict(d.get("metadata", {})),
            parts=[ObjectPartInfo.from_dict(p) for p in d.get("parts", [])],
            erasure=ErasureInfo.from_dict(
                d.get("erasure", ErasureInfo().to_dict())
            ),
        )


def new_version_id() -> str:
    return str(uuid.uuid4())


def now_ns() -> int:
    return time.time_ns()


class XLMeta:
    """The version journal held by one xl.meta file."""

    def __init__(self, versions: "list[FileInfo] | None" = None):
        self.versions: list[FileInfo] = versions or []

    # ---- journal ops (xlMetaV2 AddVersion/DeleteVersion semantics) ------

    def add_version(self, fi: FileInfo) -> None:
        """Insert/replace a version, newest kept first."""
        vid = fi.version_id or NULL_VERSION_ID
        self.versions = [
            v
            for v in self.versions
            if (v.version_id or NULL_VERSION_ID) != vid
        ]
        self.versions.insert(0, fi)
        self.versions.sort(key=lambda v: -v.mod_time_ns)

    def delete_version(self, version_id: str) -> FileInfo:
        vid = version_id or NULL_VERSION_ID
        for i, v in enumerate(self.versions):
            if (v.version_id or NULL_VERSION_ID) == vid:
                return self.versions.pop(i)
        from . import errors

        raise errors.VersionNotFound(version_id)

    def latest(self) -> FileInfo:
        from . import errors

        if not self.versions:
            raise errors.FileNotFound("no versions")
        return self.versions[0]

    def find(self, version_id: str) -> FileInfo:
        if not version_id:
            return self.latest()
        from . import errors

        for v in self.versions:
            if (v.version_id or NULL_VERSION_ID) == (
                version_id or NULL_VERSION_ID
            ):
                return v
        raise errors.VersionNotFound(version_id)

    # ---- serialization --------------------------------------------------

    def to_bytes(self) -> bytes:
        doc = {"versions": [v.to_dict() for v in self.versions]}
        return XL_MAGIC + mpack.packb(doc)

    @classmethod
    def from_bytes(cls, raw: bytes, volume="", name="") -> "XLMeta":
        from . import errors

        if len(raw) < len(XL_MAGIC) or raw[: len(XL_MAGIC)] != XL_MAGIC:
            raise errors.FileCorrupt("bad xl.meta magic")
        try:
            doc = mpack.unpackb(raw[len(XL_MAGIC) :])
            versions = [
                FileInfo.from_dict(d, volume, name)
                for d in doc.get("versions", [])
            ]
        except Exception as e:
            raise errors.FileCorrupt(f"xl.meta decode: {e}") from e
        return cls(versions)
