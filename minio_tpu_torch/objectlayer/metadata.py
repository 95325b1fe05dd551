"""FileInfo quorum logic (cmd/erasure-metadata.go / erasure-metadata-utils.go).

The object layer never trusts a single disk's metadata: it reads xl.meta
from every disk, groups by (mod_time, data_dir) and requires agreement
from a read quorum (findFileInfoInQuorum, erasure-metadata.go:215), then
picks a FileInfo whose erasure.index belongs to an online disk
(pickValidFileInfo, :259).
"""

from __future__ import annotations

import binascii

from ..storage import errors as serrors
from ..storage.meta import FileInfo
from ..utils.log import kv, logger
from . import api

_log = logger("objectlayer")


def hash_order(key: str, cardinality: int) -> list[int]:
    """1-based rotated disk order for an object key (hashOrder,
    cmd/erasure-metadata.go:324-340, crc32-seeded)."""
    if cardinality <= 0:
        return []
    start = binascii.crc32(key.encode()) % cardinality
    return [
        (start + i) % cardinality + 1 for i in range(cardinality)
    ]


def shuffle_disks(disks: list, distribution: list[int]) -> list:
    """Place disks so position i holds shard i+1 (shuffleDisks,
    erasure-object.go + erasure-metadata-utils.go:102)."""
    if not distribution:
        return list(disks)
    out = [None] * len(disks)
    for i, d in enumerate(disks):
        out[distribution[i] - 1] = d
    return out


def read_all_fileinfo(
    disks: list, volume: str, path: str, version_id: str = ""
) -> tuple[list, list]:
    """ReadVersion from every disk -> (fileinfos, errors) index-aligned
    (readAllFileInfo, erasure-metadata-utils.go)."""
    fis: list = [None] * len(disks)
    errs: list = [None] * len(disks)
    for i, disk in enumerate(disks):
        if disk is None:
            errs[i] = serrors.DiskNotFound("offline")
            continue
        try:
            fis[i] = disk.read_version(volume, path, version_id)
        except Exception as e:  # noqa: BLE001 - per-disk error slot
            errs[i] = e
    return fis, errs


def find_fileinfo_in_quorum(
    fis: list, quorum: int, errs: "list | None" = None
) -> FileInfo:
    """Pick the FileInfo agreeing across >= quorum disks
    (findFileInfoInQuorum, erasure-metadata.go:215: mod_time + data_dir
    grouping).  With ``errs`` (read_all_fileinfo's) a lost quorum is
    logged with each disk slot's error, so the node's log says which
    drives failed and how (the S3 answer names no drive)."""
    counts: dict = {}
    for fi in fis:
        if fi is None:
            continue
        key = (fi.mod_time_ns, fi.data_dir, fi.deleted)
        counts[key] = counts.get(key, 0) + 1
    best = None
    for fi in fis:
        if fi is None:
            continue
        key = (fi.mod_time_ns, fi.data_dir, fi.deleted)
        if counts[key] >= quorum:
            if best is None or fi.mod_time_ns > best.mod_time_ns:
                best = fi
    if best is None:
        msg = f"no metadata quorum ({quorum}) among {sum(f is not None for f in fis)} disks"
        if errs is not None:
            _log.warning(
                "metadata read quorum lost",
                extra=kv(
                    quorum=quorum,
                    errors=[
                        f"{i}: {type(e).__name__}: {e}"
                        for i, e in enumerate(errs) if e is not None
                    ],
                ),
            )
        raise api.ReadQuorumError(msg)
    return best


def reduce_errs(errs: list, quorum: int, err_cls) -> None:
    """Raise err_cls unless >= quorum slots succeeded (reduceWriteQuorumErrs
    semantics, erasure-metadata-utils.go:56)."""
    ok = sum(e is None for e in errs)
    if ok < quorum:
        first = next((e for e in errs if e is not None), None)
        raise err_cls(
            f"quorum {quorum} not met: {ok} ok, first error: {first}"
        )
