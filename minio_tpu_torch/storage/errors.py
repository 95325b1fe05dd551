"""Storage error model (the typed errors of cmd/storage-errors.go).

The object layer's quorum logic counts these per-disk error types
(reduceErrs semantics in cmd/erasure-metadata-utils.go), so they are real
exception classes rather than errno checks.
"""

from __future__ import annotations


class StorageError(Exception):
    pass


class DiskNotFound(StorageError):
    """errDiskNotFound: disk offline/unreachable."""


class VolumeNotFound(StorageError):
    """errVolumeNotFound."""


class VolumeExists(StorageError):
    """errVolumeExists."""


class VolumeNotEmpty(StorageError):
    """errVolumeNotEmpty."""


class FileNotFound(StorageError):
    """errFileNotFound."""


class VersionNotFound(StorageError):
    """errFileVersionNotFound."""


class FileAccessDenied(StorageError):
    """errFileAccessDenied."""


class FileCorrupt(StorageError):
    """errFileCorrupt: bitrot or truncated metadata."""


class DiskFull(StorageError):
    """errDiskFull."""


class IsNotRegular(StorageError):
    """errIsNotRegular: path is a directory where a file was expected."""


class UnformattedDisk(StorageError):
    """errUnformattedDisk: format.json missing (fresh disk)."""


class CorruptedFormat(StorageError):
    """errCorruptedFormat."""


class InconsistentDisk(StorageError):
    """errInconsistentDisk: disk ID mismatch (swapped drive)."""


class FaultyDisk(StorageError):
    """errFaultyDisk: unexpected I/O error."""
