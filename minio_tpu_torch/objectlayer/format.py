"""format.json: disk identity + cluster layout (cmd/format-erasure.go).

Every disk carries ``.sys/format.json`` recording the deployment ID, its
own UUID, and the full set layout (formatErasureV3, format-erasure.go:105).
At boot the format is created on fresh disks, quorum-loaded from used ones
(waitForFormatErasure, prepare-storage.go:350), disks are re-ordered to
their recorded set positions (fixFormatErasureV3 ordering semantics), and
swapped/foreign disks are detected by UUID mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import uuid

from ..storage import errors as serrors

from ..utils.log import kv, logger

_log = logger("objectlayer")

FORMAT_FILE = "format.json"
FORMAT_BACKEND = "erasure-tpu"
DISTRIBUTION_ALGO = "CRCMOD"


@dataclasses.dataclass
class FormatErasure:
    """One disk's format document."""

    id: str  # deployment id (cluster-wide)
    this: str  # this disk's uuid
    sets: list[list[str]]  # disk uuids per set
    distribution_algo: str = DISTRIBUTION_ALGO
    version: str = "1"

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "version": self.version,
                "format": FORMAT_BACKEND,
                "id": self.id,
                "erasure": {
                    "version": "3",
                    "this": self.this,
                    "sets": self.sets,
                    "distributionAlgo": self.distribution_algo,
                },
            },
            indent=2,
        ).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "FormatErasure":
        try:
            doc = json.loads(raw)
            if doc.get("format") != FORMAT_BACKEND:
                raise ValueError(f"backend {doc.get('format')!r}")
            er = doc["erasure"]
            return cls(
                id=doc["id"],
                this=er["this"],
                sets=[list(s) for s in er["sets"]],
                distribution_algo=er.get(
                    "distributionAlgo", DISTRIBUTION_ALGO
                ),
                version=doc.get("version", "1"),
            )
        except (KeyError, ValueError, TypeError) as e:
            raise serrors.CorruptedFormat(str(e)) from e


def read_format(disk) -> "FormatErasure | None":
    """Load a disk's format; None when unformatted (fresh disk)."""
    try:
        raw = disk.read_all(".sys", FORMAT_FILE)
    except (serrors.FileNotFound, serrors.VolumeNotFound):
        return None
    return FormatErasure.from_bytes(raw)


def write_format(disk, fmt: FormatErasure) -> None:
    try:
        disk.make_vol(".sys")  # a wiped drive lost its staging volume
    except Exception as exc:
        _log.debug("staging vol re-create failed", extra=kv(err=str(exc)))
    disk.write_all(".sys", FORMAT_FILE, fmt.to_bytes())
    disk.set_disk_id(fmt.this)


def init_format_erasure(
    disks: list, set_count: int, drives_per_set: int
) -> FormatErasure:
    """Format a fresh cluster: mint UUIDs, stamp every disk
    (initFormatErasure, format-erasure.go:442)."""
    if len(disks) != set_count * drives_per_set:
        raise ValueError("disk count != sets * drives")
    deployment = str(uuid.uuid4())
    sets = [
        [str(uuid.uuid4()) for _ in range(drives_per_set)]
        for _ in range(set_count)
    ]
    ref = None
    for i, disk in enumerate(disks):
        s, d = divmod(i, drives_per_set)
        fmt = FormatErasure(
            id=deployment, this=sets[s][d], sets=sets
        )
        if disk is not None:
            write_format(disk, fmt)
        if ref is None:
            ref = fmt
    return ref


def wait_for_format(
    disks: list,
    set_count: int,
    drives_per_set: int,
    init_allowed: bool = True,
    timeout_s: float = 120.0,
    poll_s: float = 1.0,
) -> tuple["FormatErasure", list]:
    """Boot retry loop over possibly-remote disks
    (waitForFormatErasure, prepare-storage.go:350).

    Unreachable disks do NOT count as fresh - a fully fresh cluster is
    only initialized when every disk is reachable, and only by the node
    owning the first endpoint (init_allowed), so concurrent first boots
    cannot mint two deployments.  A formatted quorum proceeds with
    offline disks passed as None (healed later).
    """
    import time as _time

    deadline = _time.monotonic() + timeout_s
    last = "no probe yet"
    while True:
        fmts: list = []  # FormatErasure | None (fresh) | False (offline)
        for d in disks:
            try:
                fmts.append(read_format(d))
            except serrors.CorruptedFormat:
                raise
            except Exception:  # noqa: BLE001 - unreachable remote
                fmts.append(False)
        n_offline = sum(1 for f in fmts if f is False)
        live = [f for f in fmts if f]
        if not live:
            if n_offline == 0 and init_allowed:
                return load_or_init_format(
                    disks, set_count, drives_per_set
                )
            last = (
                f"fresh cluster: {n_offline} unreachable, "
                f"init_allowed={init_allowed}"
            )
        elif len(live) > len(disks) // 2:
            use = [
                None if f is False else d
                for d, f in zip(disks, fmts)
            ]
            return load_or_init_format(use, set_count, drives_per_set)
        else:
            last = f"format quorum {len(live)}/{len(disks)} not reached"
        if _time.monotonic() >= deadline:
            raise serrors.UnformattedDisk(
                f"timed out waiting for format: {last}"
            )
        _time.sleep(poll_s)


def load_or_init_format(
    disks: list, set_count: int, drives_per_set: int
) -> tuple[FormatErasure, list]:
    """Boot-time format resolution (connectLoadInitFormats semantics).

    Returns (reference_format, disks ordered by recorded set positions).
    Fresh disks among formatted ones are left in place unformatted (the
    heal path stamps them - monitorLocalDisksAndHeal analogue); a fully
    fresh cluster is initialized.
    """
    formats = [read_format(d) if d is not None else None for d in disks]
    live = [f for f in formats if f is not None]
    if not live:
        init_format_erasure(disks, set_count, drives_per_set)
        formats = [read_format(d) for d in disks]
        live = [f for f in formats if f is not None]
    # quorum reference format: majority deployment id
    by_id: dict[str, int] = {}
    for f in live:
        by_id[f.id] = by_id.get(f.id, 0) + 1
    ref_id = max(by_id, key=by_id.get)
    if by_id[ref_id] <= len(disks) // 2:
        raise serrors.CorruptedFormat(
            f"no format quorum: {by_id}"
        )
    ref = next(f for f in live if f.id == ref_id)
    if len(ref.sets) != set_count or len(ref.sets[0]) != drives_per_set:
        raise serrors.CorruptedFormat(
            f"layout mismatch: format says "
            f"{len(ref.sets)}x{len(ref.sets[0])}, "
            f"args say {set_count}x{drives_per_set}"
        )
    # order disks into their recorded positions
    pos: dict[str, int] = {}
    for s, set_ids in enumerate(ref.sets):
        for d, disk_id in enumerate(set_ids):
            pos[disk_id] = s * drives_per_set + d
    ordered: list = [None] * len(disks)
    fresh: list = []
    for disk, fmt in zip(disks, formats):
        if disk is None:
            continue
        if fmt is None:
            fresh.append(disk)
            continue
        if fmt.id != ref_id or fmt.this not in pos:
            raise serrors.InconsistentDisk(
                f"disk {disk.endpoint()} belongs to another deployment"
            )
        idx = pos[fmt.this]
        if ordered[idx] is not None:
            raise serrors.InconsistentDisk(
                f"duplicate disk uuid {fmt.this}"
            )
        ordered[idx] = disk
        disk.set_disk_id(fmt.this)
    # fresh disks fill remaining holes in argument order (to be healed)
    holes = [i for i, d in enumerate(ordered) if d is None]
    for disk, idx in zip(fresh, holes):
        fmt = FormatErasure(
            id=ref_id,
            this=ref.sets[idx // drives_per_set][idx % drives_per_set],
            sets=ref.sets,
        )
        write_format(disk, fmt)
        # flag for the fresh-disk monitor: this slot holds a replaced
        # drive whose set must be swept (healErasureSet) after boot
        disk._freshly_stamped = True
        ordered[idx] = disk
    return ref, ordered
