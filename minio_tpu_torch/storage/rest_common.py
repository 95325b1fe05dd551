"""Storage REST plane: wire protocol shared by server and client.

The reference exposes every StorageAPI method at
/minio/storage/v20/<method> (storage-rest-common.go:20-54) as HTTP POSTs
with query args + streaming bodies.  Same shape here under
/minio-tpu/storage/v1/, with MessagePack payloads and a typed-error
envelope so client-side exceptions match local disks exactly.

Payloads are encoded by storage/mpack.py, byte-equal to
``msgpack.packb(obj, use_bin_type=True)``, so a node of this package
and one of the JAX package read each other's requests and answers.
"""

from __future__ import annotations

from . import errors, mpack

PREFIX = "/minio-tpu/storage/v1"

# error class name <-> exception type (travels as the X-Storage-Error
# header / error payload; reduceErrs needs real types on the client)
_ERRORS = {
    cls.__name__: cls
    for cls in (
        errors.DiskNotFound,
        errors.VolumeNotFound,
        errors.VolumeExists,
        errors.VolumeNotEmpty,
        errors.FileNotFound,
        errors.VersionNotFound,
        errors.FileAccessDenied,
        errors.FileCorrupt,
        errors.DiskFull,
        errors.IsNotRegular,
        errors.UnformattedDisk,
        errors.CorruptedFormat,
        errors.InconsistentDisk,
        errors.FaultyDisk,
    )
}


def encode_error(e: Exception) -> tuple[str, str]:
    name = type(e).__name__
    if name not in _ERRORS:
        name = "FaultyDisk"
    return name, str(e)


def decode_error(name: str, message: str) -> Exception:
    return _ERRORS.get(name, errors.FaultyDisk)(message)


def pack(obj) -> bytes:
    return mpack.packb(obj)


def unpack(raw: bytes):
    return mpack.unpackb(raw)


def fileinfo_to_wire(fi) -> dict:
    d = fi.to_dict()
    d["volume"] = fi.volume
    d["name"] = fi.name
    return d


def fileinfo_from_wire(d: dict):
    from .meta import FileInfo

    volume = d.pop("volume", "")
    name = d.pop("name", "")
    return FileInfo.from_dict(d, volume, name)
