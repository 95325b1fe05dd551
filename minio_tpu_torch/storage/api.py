"""StorageAPI: the disk abstraction (cmd/storage-interface.go:25-79).

Implementations: xl.XLStorage (local POSIX) and
rest_client.StorageRESTClient (a remote disk over the storage REST
plane).  The object layer only ever talks to this interface, so local
and remote disks are interchangeable - the seam the reference uses to
make a distributed cluster look like a big JBOD.
"""

from __future__ import annotations

import dataclasses

from .meta import FileInfo


@dataclasses.dataclass
class VolInfo:
    name: str
    created_ns: int


@dataclasses.dataclass
class DiskInfo:
    total: int
    free: int
    used: int
    root_disk: bool
    endpoint: str
    mount_path: str
    disk_id: str
    error: str = ""


@dataclasses.dataclass
class StatInfo:
    size: int
    mod_time_ns: int
    is_dir: bool = False


class ShardWriter:
    """Streaming shard-file writer handle (CreateFile stream)."""

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class ShardReader:
    """Random-access shard-file reader handle (ReadFileStream)."""

    # local readers are preferred by the decode path so healthy GETs
    # avoid network RTTs (erasure-decode.go prefer[] semantics)
    is_local = True

    def read_at(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class StorageAPI:
    """Abstract disk; all paths are (volume, slash-separated path)."""

    # ---- identity / health ----------------------------------------------
    def is_online(self) -> bool:
        raise NotImplementedError

    def endpoint(self) -> str:
        raise NotImplementedError

    def is_local(self) -> bool:
        raise NotImplementedError

    def disk_info(self) -> DiskInfo:
        raise NotImplementedError

    def get_disk_id(self) -> str:
        raise NotImplementedError

    def set_disk_id(self, disk_id: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # ---- volumes --------------------------------------------------------
    def make_vol(self, volume: str) -> None:
        raise NotImplementedError

    def list_vols(self) -> list[VolInfo]:
        raise NotImplementedError

    def stat_vol(self, volume: str) -> VolInfo:
        raise NotImplementedError

    def delete_vol(self, volume: str, force: bool = False) -> None:
        raise NotImplementedError

    # ---- raw files ------------------------------------------------------
    def read_all(self, volume: str, path: str) -> bytes:
        raise NotImplementedError

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete_file(self, volume: str, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    # ---- shard streams --------------------------------------------------
    def rename_file(
        self, src_volume: str, src_path: str, dst_volume: str, dst_path: str
    ) -> None:
        raise NotImplementedError

    def stat_file(self, volume: str, path: str) -> StatInfo:
        raise NotImplementedError

    def create_file(self, volume: str, path: str) -> ShardWriter:
        raise NotImplementedError

    def read_file_stream(self, volume: str, path: str) -> ShardReader:
        raise NotImplementedError

    def append_file(
        self,
        volume: str,
        path: str,
        data: bytes,
        truncate: bool = False,
        offset: "int | None" = None,
    ) -> None:
        """Append a chunk to a shard file (the storage REST plane's
        bounded-memory CreateFile stream; truncate=True on the first
        chunk creates/resets the file).  ``offset`` declares where the
        chunk starts, making retried appends idempotent (the file is
        truncated back to it before writing)."""
        raise NotImplementedError

    # ---- object metadata (xl.meta journal) ------------------------------
    def read_version(
        self, volume: str, path: str, version_id: str = ""
    ) -> FileInfo:
        raise NotImplementedError

    def read_xl(self, volume: str, path: str):
        raise NotImplementedError

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        raise NotImplementedError

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        raise NotImplementedError

    def delete_version(
        self, volume: str, path: str, fi: FileInfo
    ) -> None:
        raise NotImplementedError

    def rename_data(
        self,
        src_volume: str,
        src_path: str,
        fi: FileInfo,
        dst_volume: str,
        dst_path: str,
    ) -> None:
        """Atomically move a staged object dir into place and commit its
        xl.meta version (the RenameData crash-consistency point,
        xl-storage.go:2000)."""
        raise NotImplementedError

    # ---- listing (cmd/tree-walk.go) --------------------------------------
    def list_dir(self, volume: str, dir_path: str, count: int = -1) -> list[str]:
        raise NotImplementedError

    def walk(self, volume: str, prefix: str = ""):
        """Yield object paths (directories holding xl.meta) under prefix."""
        raise NotImplementedError

    def walk_sorted(
        self, volume: str, prefix: str = "", marker: str = "",
        recursive: bool = True, inclusive: bool = False,
    ):
        """Yield (name, is_prefix) in lexical order, pruning subtrees
        outside prefix/after marker (tree-walk.go)."""
        raise NotImplementedError

    # ---- maintenance ----------------------------------------------------
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep scan every part's framed blocks against their digests;
        raises FileCorrupt on a truncated or bitrotted block."""
        raise NotImplementedError
