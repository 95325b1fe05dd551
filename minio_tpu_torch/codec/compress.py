"""Transparent object compression and the parity-plane transport
compression (the fused on-device leg).

Object compression (the S2 seam of the reference, MINIO_TPU_COMPRESS,
cmd/object-api-utils.go:434 isCompressible + :686 decompress-skip): the
stored representation is a raw-deflate stream (zlib level 1 - the
speed-over-ratio point S2 occupies in the reference); the erasure codec
and bitrot framing below this layer see only stored bytes, so heal and
verify are untouched.  Range reads decompress from the stream start and
discard up to the requested offset, exactly the reference's
decompress+skip semantics.  The metadata contract rides
FileInfo.metadata like X-Minio-Internal-*:
  x-internal-compression  = "deflate/v1"
  x-internal-actual-size  = original (client-visible) byte count

Transport compression: the stored representation is untouched, shard
files hold the exact same framed bytes either way.  What compresses
there is the BUS TRANSFER - the parity plane crossing device->host
during the lazy drain (codec/backend.py).  Parity of compressible or
zero-padded objects is mostly zero groups, so the encode_pack kernel
screens every 256-word group and compacts the nonzero groups to the
front of each row on the device; only the flags and the packed prefix
cross PCIe, and unpack_nonzero_groups below restores the full plane on
the host, bit-identically.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

ALGORITHM = "deflate/v1"
META_COMPRESSION = "x-internal-compression"
META_ACTUAL_SIZE = "x-internal-actual-size"

# words per transport group (1 KiB of parity per flag bit)
PARITY_GROUP_WORDS = 256

MIN_COMPRESS_SIZE = 4 << 10  # tiny objects gain nothing

# extensions/types that are already entropy-coded
# (cmd/config/compress standard excludes)
EXCLUDED_EXTENSIONS = frozenset(
    {
        ".gz", ".bz2", ".zip", ".rar", ".7z", ".xz", ".zst", ".lz4",
        ".mp4", ".mkv", ".mov", ".avi", ".webm",
        ".mp3", ".aac", ".ogg", ".flac",
        ".jpg", ".jpeg", ".png", ".gif", ".webp", ".heic",
        ".pdf", ".docx", ".xlsx", ".pptx",
    }
)
EXCLUDED_TYPE_PREFIXES = ("video/", "audio/", "image/")
EXCLUDED_TYPES = frozenset(
    {
        "application/zip", "application/gzip", "application/x-gzip",
        "application/x-bzip2", "application/x-xz", "application/zstd",
        "application/x-7z-compressed", "application/x-rar-compressed",
        "application/pdf",
    }
)


def enabled() -> bool:
    """Global compression switch (MINIO_TPU_COMPRESS=on), read per call."""
    return os.environ.get("MINIO_TPU_COMPRESS", "off") == "on"


def should_compress(key: str, content_type: str, size: int) -> bool:
    """The single write-path predicate: global switch AND per-object
    compressibility."""
    return enabled() and is_compressible(key, content_type, size)


def strip_internal_meta(meta: dict) -> dict:
    """Remove the compression markers before re-storing data that was
    read back decompressed (CopyObject pipes plaintext)."""
    meta.pop(META_COMPRESSION, None)
    meta.pop(META_ACTUAL_SIZE, None)
    return meta


def is_compressible(key: str, content_type: str, size: int) -> bool:
    """Whether a PUT should be transparently compressed
    (isCompressible, object-api-utils.go:434)."""
    if 0 <= size < MIN_COMPRESS_SIZE:
        return False
    dot = key.rfind(".")
    if dot >= 0 and key[dot:].lower() in EXCLUDED_EXTENSIONS:
        return False
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct in EXCLUDED_TYPES:
        return False
    if ct.startswith(EXCLUDED_TYPE_PREFIXES):
        return False
    return True


def device_compress_mode() -> str:
    """MINIO_TPU_DEVICE_COMPRESS = auto|on|off (default auto).

    auto: pack only when the nonzero fill is below
    parity_fill_threshold(); on: always pack; off: every drain moves
    the full plane.
    """
    v = os.environ.get("MINIO_TPU_DEVICE_COMPRESS", "auto").lower()
    return v if v in ("auto", "on", "off") else "auto"


def parity_fill_threshold() -> float:
    """Max nonzero-group fill ratio at which auto mode still packs
    (MINIO_TPU_DCOMP_MAX_FILL, default 0.75): past this the packed
    prefix approaches the full plane."""
    try:
        v = float(os.environ.get("MINIO_TPU_DCOMP_MAX_FILL") or 0.75)
    except ValueError:
        v = 0.75
    return min(1.0, max(0.0, v))


def prefix_keep(kept: int, groups: int) -> int:
    """Packed-prefix length (in groups) to move over the bus, rounded up
    to a power of two exactly as the JAX package rounds it, so both
    drains move the same slice."""
    if kept <= 0:
        return 0
    return min(1 << (kept - 1).bit_length(), groups)


def unpack_nonzero_groups(
    flags: np.ndarray, packed_prefix: np.ndarray, group: int, w: int
) -> np.ndarray:
    """Invert the device pack on the host.

    ``flags`` is the (..., g) bool mask, ``packed_prefix`` the leading
    (..., >=max_kept*group) u32 slice of the packed rows that actually
    crossed the bus.  Returns the full (..., w) u32 rows: packed groups
    scattered back to their np.nonzero(flags) positions, zeros elsewhere.
    """
    flags = np.asarray(flags, dtype=bool)
    lead = flags.shape[:-1]
    g = flags.shape[-1]
    if g * group != w:
        raise ValueError("flags width disagrees with w/group")
    prefix = np.ascontiguousarray(packed_prefix, dtype=np.uint32)
    out = np.zeros(lead + (g, group), dtype=np.uint32)
    flat_flags = flags.reshape(-1, g)
    flat_prefix = prefix.reshape(len(flat_flags), -1)
    flat_out = out.reshape(-1, g, group)
    for r in range(len(flat_flags)):
        nz = np.nonzero(flat_flags[r])[0]
        if nz.size:
            flat_out[r, nz] = flat_prefix[
                r, : nz.size * group
            ].reshape(nz.size, group)
    return out.reshape(lead + (w,))


class CompressReader:
    """Pull-style compressor: read(n) returns stored (deflate) bytes
    while draining the original stream underneath (so an inner
    HashReader still sees and hashes the client payload)."""

    def __init__(self, inner, chunk: int = 1 << 20):
        self._inner = inner
        self._chunk = chunk
        self._z = zlib.compressobj(1, zlib.DEFLATED, -15)
        self._buf = bytearray()
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            raw = self._inner.read(self._chunk)
            if not raw:
                self._buf += self._z.flush()
                self._eof = True
                break
            self._buf += self._z.compress(raw)
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
            return out
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class RangeSatisfied(Exception):
    """Control-flow signal: the requested range is fully written, the
    caller may stop reading/decoding stored bytes (early exit)."""


_INFLATE_CHUNK = 1 << 20


class DecompressWriter:
    """Push-style decompressor with range skip: stored bytes go in,
    decompressed bytes [offset, offset+length) come out to ``writer``
    (the decompress-and-discard of object-api-utils.go:686-697).

    Inflation is bounded: decompression emits at most 1 MiB at a time
    (a stored block of zeros can inflate thousandfold - one unbounded
    decompress() call would materialize it whole).  Once the range is
    satisfied the next write raises RangeSatisfied so the erasure decode
    can stop paying I/O for the tail.
    """

    def __init__(self, writer, offset: int = 0, length: int = -1):
        self._w = writer
        self._skip = offset
        self._remaining = length
        self._z = zlib.decompressobj(-15)

    @property
    def done(self) -> bool:
        return self._remaining == 0

    def write(self, stored: bytes) -> int:
        if self._remaining == 0:
            raise RangeSatisfied()
        data = self._z.decompress(stored, _INFLATE_CHUNK)
        self._emit(data)
        while self._z.unconsumed_tail and self._remaining != 0:
            data = self._z.decompress(
                self._z.unconsumed_tail, _INFLATE_CHUNK
            )
            self._emit(data)
        return len(stored)

    def _emit(self, data: bytes) -> None:
        if not data:
            return
        if self._skip:
            drop = min(self._skip, len(data))
            self._skip -= drop
            data = data[drop:]
            if not data:
                return
        if self._remaining >= 0:
            data = data[: self._remaining]
            self._remaining -= len(data)
        if data:
            self._w.write(data)

    def finish(self) -> None:
        while self._remaining != 0:
            tail = self._z.unconsumed_tail
            if not tail:
                break
            self._emit(self._z.decompress(tail, _INFLATE_CHUNK))
        if self._remaining == 0:
            # range satisfied: whatever is left in unconsumed_tail must
            # NOT be inflated - a crafted all-zeros stream expands ~1032x
            # and an unbounded flush() would materialize it whole
            return
        self._emit(self._z.flush())
