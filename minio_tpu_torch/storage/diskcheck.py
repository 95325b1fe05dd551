"""Per-operation disk-ID validation (cmd/xl-storage-disk-id-check.go).

Wraps any StorageAPI so every I/O first confirms the drive still holds
the format document this slot was admitted with:

- format.json unreadable -> the drive was wiped/replaced with an empty
  one: ops fail DiskNotFound until the fresh-disk monitor re-stamps and
  heals it (heal/background.py FreshDiskMonitor);
- disk uuid mismatch -> a DIFFERENT formatted drive was mounted into
  this slot (cabling/mount mixups): ops fail immediately instead of
  scribbling one cluster's shards onto another's drive.

The on-disk read is rate-limited (default 1s); in between, ops pass
straight through.  Local disks report offline while their root dir is
missing; together with the fresh-disk monitor this covers the
reference's connectDisks loop (erasure-sets.go:200-295) for the local
drives this package serves.

Stacking order: ``DiskIDCheck(MeteredDisk(XLStorage))``, each layer
keeping the next in ``__dict__["unwrapped"]`` - ``metered.is_metered``
finds the MeteredDisk inside the chain (so the object layer does not
meter a guarded drive twice) and the fresh-disk monitor walks the chain
to the raw drive.
"""

from __future__ import annotations

import threading
import time

from . import errors


class DiskIDCheck:
    """StorageAPI decorator validating the slot's disk identity."""

    # every method that touches the drive contents
    _CHECKED = frozenset(
        {
            "make_vol", "list_vols", "stat_vol", "delete_vol",
            "list_dir", "read_all", "write_all", "delete_file",
            "rename_file", "stat_file", "create_file", "append_file",
            "walk", "walk_sorted", "read_file_stream", "read_version",
            "read_xl", "write_metadata", "update_metadata",
            "delete_version", "rename_data", "verify_file",
        }
    )

    def __init__(self, disk, expected_id: str, check_interval_s: float = 1.0):
        self.unwrapped = disk
        self._expected = expected_id
        self._interval = check_interval_s
        self._mu = threading.Lock()
        self._last_check = 0.0
        self._last_err: "Exception | None" = None

    def _check(self) -> None:
        now = time.monotonic()
        with self._mu:
            if now - self._last_check < self._interval:
                if self._last_err is not None:
                    raise self._last_err
                return
            self._last_check = now
            err: "Exception | None" = None
            try:
                from ..objectlayer.format import read_format

                fmt = read_format(self.unwrapped)
            except Exception:  # noqa: BLE001
                err = errors.DiskNotFound(
                    "unformatted or unreadable disk (awaiting heal)"
                )
            else:
                if fmt is None:
                    err = errors.DiskNotFound(
                        "unformatted disk (awaiting heal)"
                    )
                elif fmt.this != self._expected:
                    err = errors.DiskNotFound(
                        f"disk ID mismatch: expected {self._expected}, "
                        f"found {fmt.this} - wrong drive mounted?"
                    )
            self._last_err = err
            if err is not None:
                raise err

    def recheck(self) -> None:
        """Drop the cached verdict so the next op reads format.json
        again: the fresh-disk monitor calls it once it has re-stamped
        the drive, so a verdict cached while the drive was blank does
        not hide the drive from the heal that follows."""
        with self._mu:
            self._last_check = 0.0
            self._last_err = None

    def is_online(self) -> bool:
        if not self.unwrapped.is_online():
            return False
        try:
            self._check()
        except Exception:  # noqa: BLE001
            return False
        return True

    def __getattr__(self, name: str):
        attr = getattr(self.unwrapped, name)
        if name in self._CHECKED and callable(attr):
            def wrapped(*a, **k):
                self._check()
                return attr(*a, **k)

            wrapped.__name__ = name
            return wrapped
        return attr
