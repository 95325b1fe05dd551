"""XLStorage: local POSIX StorageAPI backend (cmd/xl-storage.go).

Disk layout (xl-storage-format-v2.go:71-83):

    <root>/.sys/tmp/<uuid>...            staging area (atomic renames)
    <root>/.sys/format.json              disk identity + set layout
    <root>/<bucket>/<object>/xl.meta     version journal (meta.XLMeta)
    <root>/<bucket>/<object>/<dataDir>/part.N   framed shard files

Crash consistency is by construction, like the reference: shard files and
metadata are staged under .sys/tmp and committed with a single directory
rename (rename_data, the analogue of xl-storage.go:2000 RenameData); a
crash leaves only garbage in tmp, never a torn object.
"""

from __future__ import annotations

import errno
import os
import shutil
import uuid

from . import errors
from .api import (
    DiskInfo,
    ShardReader,
    ShardWriter,
    StatInfo,
    StorageAPI,
    VolInfo,
)
from .meta import FileInfo, XLMeta

SYS_DIR = ".sys"
TMP_DIR = f"{SYS_DIR}/tmp"
XL_META = "xl.meta"


def _check_name(name: str) -> None:
    if not name or name.startswith("/") or ".." in name.split("/"):
        raise errors.FileAccessDenied(name)


class _FileShardWriter(ShardWriter):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def close(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()


class _FileShardReader(ShardReader):
    def __init__(self, path: str):
        try:
            self._f = open(path, "rb")
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None

    def read_at(self, offset: int, length: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(length)

    def close(self) -> None:
        self._f.close()


class XLStorage(StorageAPI):
    """One local disk rooted at ``root``."""

    def __init__(self, root: str, endpoint: str = ""):
        self.root = os.path.abspath(root)
        self._endpoint = endpoint or self.root
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)

    # ---- identity / health ----------------------------------------------

    def is_online(self) -> bool:
        return os.path.isdir(self.root)

    def endpoint(self) -> str:
        return self._endpoint

    def disk_info(self) -> DiskInfo:
        st = os.statvfs(self.root)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return DiskInfo(
            total=total,
            free=free,
            used=total - free,
            root_disk=False,
            endpoint=self._endpoint,
            mount_path=self.root,
            disk_id="",
        )

    # ---- path helpers ---------------------------------------------------

    def _vol_path(self, volume: str) -> str:
        _check_name(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        vp = self._vol_path(volume)
        _check_name(path or "x")
        return os.path.join(vp, *path.split("/")) if path else vp

    def _require_vol(self, volume: str) -> str:
        vp = self._vol_path(volume)
        if not os.path.isdir(vp):
            raise errors.VolumeNotFound(volume)
        return vp

    # ---- volumes --------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        vp = self._vol_path(volume)
        try:
            os.makedirs(vp)
        except FileExistsError:
            # atomic exists-check: a concurrent MakeVol racing this
            # one must surface VolumeExists, not an OS error that the
            # quorum reducer would count as a disk failure
            raise errors.VolumeExists(volume) from None

    def list_vols(self) -> list[VolInfo]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name == SYS_DIR or name.startswith("."):
                continue
            full = os.path.join(self.root, name)
            if os.path.isdir(full):
                out.append(
                    VolInfo(name, int(os.stat(full).st_ctime_ns))
                )
        return out

    def stat_vol(self, volume: str) -> VolInfo:
        vp = self._require_vol(volume)
        try:
            return VolInfo(volume, int(os.stat(vp).st_ctime_ns))
        except FileNotFoundError:
            # a concurrent DeleteVol won between the isdir check and
            # the stat: a bucket-level outcome, never a raw errno
            raise errors.VolumeNotFound(volume) from None

    def delete_vol(self, volume: str, force: bool = False) -> None:
        vp = self._require_vol(volume)
        if force:
            # rmtree racing a concurrent deleter (root vanishes) or a
            # concurrent writer (an entry vanishes mid-walk) surfaces
            # ENOENT; both are linearizable outcomes, not disk faults
            # (storage-errors.go errno mapping)
            for _ in range(8):
                try:
                    shutil.rmtree(vp)
                    return
                except FileNotFoundError:
                    if not os.path.lexists(vp):
                        raise errors.VolumeNotFound(volume) from None
                    continue  # entry vanished mid-walk; retry
                except OSError as e:
                    if e.errno in (errno.ENOTEMPTY, errno.EEXIST):
                        continue  # writer re-filled a dir mid-walk
                    raise
            shutil.rmtree(vp, ignore_errors=True)
            if os.path.lexists(vp):
                raise errors.VolumeNotEmpty(volume)
            return
        try:
            os.rmdir(vp)
        except FileNotFoundError:
            raise errors.VolumeNotFound(volume) from None
        except OSError:
            raise errors.VolumeNotEmpty(volume) from None

    # ---- raw files ------------------------------------------------------

    def list_dir(self, volume: str, dir_path: str, count: int = -1) -> list[str]:
        self._require_vol(volume)
        full = self._file_path(volume, dir_path) if dir_path else self._vol_path(volume)
        try:
            names = sorted(os.listdir(full))
        except FileNotFoundError:
            raise errors.FileNotFound(dir_path) from None
        except NotADirectoryError:
            raise errors.IsNotRegular(dir_path) from None
        out = []
        for nm in names:
            if os.path.isdir(os.path.join(full, nm)):
                nm += "/"
            out.append(nm)
            if 0 <= count <= len(out):
                break
        return out

    def read_all(self, volume: str, path: str) -> bytes:
        self._require_vol(volume)
        try:
            with open(self._file_path(volume, path), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._require_vol(volume)
        full = self._file_path(volume, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = os.path.join(
            self.root, TMP_DIR, f"wa-{uuid.uuid4().hex}"
        )
        # the tmp area may have been pruned by delete_file parent cleanup
        os.makedirs(os.path.dirname(tmp), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)

    def delete_file(self, volume: str, path: str, recursive: bool = False) -> None:
        self._require_vol(volume)
        full = self._file_path(volume, path)
        try:
            if os.path.isdir(full):
                if recursive:
                    shutil.rmtree(full)
                else:
                    os.rmdir(full)
            else:
                os.remove(full)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        # prune now-empty parents up to the volume root (deleteFile,
        # xl-storage.go parent cleanup)
        parent = os.path.dirname(full)
        vol = self._vol_path(volume)
        while parent != vol:
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    def rename_file(
        self, src_volume: str, src_path: str, dst_volume: str, dst_path: str
    ) -> None:
        self._require_vol(src_volume)
        self._require_vol(dst_volume)
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        if not os.path.exists(src):
            raise errors.FileNotFound(src_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(src, dst)

    def stat_file(self, volume: str, path: str) -> StatInfo:
        self._require_vol(volume)
        try:
            st = os.stat(self._file_path(volume, path))
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        return StatInfo(
            size=st.st_size,
            mod_time_ns=st.st_mtime_ns,
            is_dir=os.path.isdir(self._file_path(volume, path)),
        )

    # ---- shard streams --------------------------------------------------

    def create_file(self, volume: str, path: str) -> ShardWriter:
        self._require_vol(volume)
        return _FileShardWriter(self._file_path(volume, path))

    def read_file_stream(self, volume: str, path: str) -> ShardReader:
        self._require_vol(volume)
        return _FileShardReader(self._file_path(volume, path))

    # ---- object metadata ------------------------------------------------

    def read_xl(self, volume: str, path: str) -> XLMeta:
        raw = self.read_all(volume, f"{path}/{XL_META}")
        return XLMeta.from_bytes(raw, volume, path)

    def read_version(
        self, volume: str, path: str, version_id: str = ""
    ) -> FileInfo:
        xl = self.read_xl(volume, path)
        fi = xl.find(version_id)
        fi.volume, fi.name = volume, path
        return fi

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        try:
            xl = self.read_xl(volume, path)
        except errors.FileNotFound:
            xl = XLMeta()
        xl.add_version(fi)
        self.write_all(volume, f"{path}/{XL_META}", xl.to_bytes())

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        xl = self.read_xl(volume, path)  # must exist
        xl.add_version(fi)
        self.write_all(volume, f"{path}/{XL_META}", xl.to_bytes())

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        xl = self.read_xl(volume, path)
        victim = xl.delete_version(fi.version_id)
        if victim.data_dir:
            try:
                self.delete_file(
                    volume, f"{path}/{victim.data_dir}", recursive=True
                )
            except errors.FileNotFound:
                pass
        if xl.versions:
            self.write_all(volume, f"{path}/{XL_META}", xl.to_bytes())
        else:
            self.delete_file(volume, f"{path}/{XL_META}")

    def rename_data(
        self,
        src_volume: str,
        src_path: str,
        fi: FileInfo,
        dst_volume: str,
        dst_path: str,
    ) -> None:
        self._require_vol(src_volume)
        self._require_vol(dst_volume)
        src_dir = self._file_path(src_volume, src_path)
        dst_obj = self._file_path(dst_volume, dst_path)
        if not os.path.isdir(src_dir):
            raise errors.FileNotFound(src_path)
        os.makedirs(dst_obj, exist_ok=True)
        if fi.data_dir:
            dst_data = os.path.join(dst_obj, fi.data_dir)
            staged = os.path.join(src_dir, fi.data_dir)
            if not os.path.isdir(staged):
                raise errors.FileNotFound(f"{src_path}/{fi.data_dir}")
            if os.path.isdir(dst_data):
                shutil.rmtree(dst_data)
            os.replace(staged, dst_data)
        # merge + commit version journal
        try:
            xl = self.read_xl(dst_volume, dst_path)
        except errors.FileNotFound:
            xl = XLMeta()
        xl.add_version(fi)
        self.write_all(
            dst_volume, f"{dst_path}/{XL_META}", xl.to_bytes()
        )
        shutil.rmtree(src_dir, ignore_errors=True)

    # ---- maintenance ----------------------------------------------------

    def walk(self, volume: str, prefix: str = ""):
        """Yield object paths (dirs containing xl.meta) under prefix."""
        vol = self._require_vol(volume)
        base = (
            os.path.join(vol, *prefix.split("/")) if prefix else vol
        )
        if not os.path.isdir(base):
            return
        for dirpath, dirnames, filenames in os.walk(base):
            if XL_META in filenames:
                rel = os.path.relpath(dirpath, vol).replace(os.sep, "/")
                dirnames[:] = []  # don't descend into data dirs
                yield rel

    # ---- ordered bounded walk (tree-walk.go analogue) -------------------

    def walk_sorted(
        self,
        volume: str,
        prefix: str = "",
        marker: str = "",
        recursive: bool = True,
        inclusive: bool = False,
    ):
        """Yield ``(name, is_prefix)`` in lexical order, lazily.

        The scalable-listing primitive (cmd/tree-walk.go doTreeWalk):
        directories are read in sorted order and subtrees that cannot
        contain a name matching ``prefix`` and > ``marker`` are pruned,
        so one page of results touches only the directories it needs.
        ``recursive=False`` lists a single level (delimiter="/" mode):
        plain directories come back once as ("dir/", True) without
        descending.  ``inclusive`` keeps names equal to the marker
        (version listings re-visit the marker key).
        """
        vol = self._require_vol(volume)
        if recursive:
            yield from self._walk_rec(vol, "", prefix, marker, inclusive)
            return
        base, _, leaf = prefix.rpartition("/")
        base_fs = (
            os.path.join(vol, *base.split("/")) if base else vol
        )
        if base and os.path.isfile(os.path.join(base_fs, XL_META)):
            # the prefix points INSIDE an object's directory: its
            # children are erasure data dirs, not namespace entries -
            # leaking them as CommonPrefixes exposes internal layout
            return
        try:
            entries = sorted(os.listdir(base_fs))
        except (FileNotFoundError, NotADirectoryError):
            return
        basep = base + "/" if base else ""
        for e in entries:
            if leaf and not e.startswith(leaf):
                continue
            full = os.path.join(base_fs, e)
            if not os.path.isdir(full):
                continue
            if os.path.isfile(os.path.join(full, XL_META)):
                name = basep + e
                if name > marker or (inclusive and name == marker):
                    yield (name, False)
            else:
                cp = basep + e + "/"
                if cp > marker:
                    yield (cp, True)

    def _walk_rec(self, vol, rel, prefix, marker, inclusive):
        base = os.path.join(vol, *rel.split("/")) if rel else vol
        try:
            entries = sorted(os.listdir(base))
        except (FileNotFoundError, NotADirectoryError):
            return
        for e in entries:
            name = f"{rel}/{e}" if rel else e
            full = os.path.join(base, e)
            if not os.path.isdir(full):
                continue
            if os.path.isfile(os.path.join(full, XL_META)):
                if prefix and not name.startswith(prefix):
                    continue
                if name > marker or (inclusive and name == marker):
                    yield (name, False)
                continue  # object dirs hold data dirs, not children
            sub = name + "/"
            # prefix prune: the subtree's names all start with `sub`
            if prefix and not (
                sub.startswith(prefix) or prefix.startswith(sub)
            ):
                continue
            # marker prune: every name under `sub` is < marker exactly
            # when marker doesn't extend `sub` and sorts after it
            if (
                marker
                and not marker.startswith(sub)
                and sub < marker
            ):
                continue
            yield from self._walk_rec(vol, name, prefix, marker, inclusive)

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep scan every part's framed blocks against its digests (on
        the host: heal's per-disk check, erasure-healing.go
        disksWithAllParts)."""
        from ..codec import bitrot
        from ..codec.erasure import Erasure

        er = Erasure(
            fi.erasure.data_blocks,
            fi.erasure.parity_blocks,
            fi.erasure.block_size,
        )
        for part in fi.parts:
            rel = f"{path}/{fi.data_dir}/part.{part.number}"
            rd = self.read_file_stream(volume, rel)
            try:
                for b in range(er.block_count(part.size)):
                    block_len = min(
                        er.block_size, part.size - b * er.block_size
                    )
                    frame = bitrot.DIGEST_SIZE + er.shard_size_padded(
                        block_len
                    )
                    buf = rd.read_at(er.shard_block_offset(b), frame)
                    if len(buf) != frame:
                        raise errors.FileCorrupt(
                            f"{rel}: truncated block {b}"
                        )
                    if not bitrot.verify_block(
                        buf[bitrot.DIGEST_SIZE :],
                        buf[: bitrot.DIGEST_SIZE],
                    ):
                        raise errors.FileCorrupt(f"{rel}: bitrot block {b}")
            finally:
                rd.close()
