"""The parity-plane transport compression (the fused on-device leg).

The stored representation is untouched: shard files hold the exact same
framed bytes either way.  What compresses here is the BUS TRANSFER - the
parity plane crossing device->host during the lazy drain
(codec/backend.py).  Parity of compressible or zero-padded objects is
mostly zero groups, so the encode_pack kernel screens every 256-word
group and compacts the nonzero groups to the front of each row on the
device; only the flags and the packed prefix cross PCIe, and
unpack_nonzero_groups below restores the full plane on the host,
bit-identically.

Transparent object compression (the S2 seam of the reference,
MINIO_TPU_COMPRESS) is decided here too: ``should_compress`` is the
write-path predicate (cmd/object-api-utils.go:434 isCompressible).  The
raw-deflate transform itself comes in slice 8, so the object layer
refuses exactly the PUTs this predicate admits and stores every other
one uncompressed, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np

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


def is_compressible(key: str, content_type: str, size: int) -> bool:
    """Whether a PUT would be transparently compressed
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
