"""Bitrot shard-file framing (cmd/bitrot-streaming.go).

The default algorithm of the reference's registry (cmd/bitrot.go:41-58)
is replaced by ``phash256``, the parallel digest the encode pass computes
on the device (ops/hash.py).  It is a streaming algorithm: one 32-byte
digest is interleaved before every shard block,
``[digest][block][digest][block]...``, exactly like
streamingBitrotWriter (bitrot-streaming.go:38-88).

Shard blocks are zero-padded to 32-byte multiples (device word
alignment); the pad is part of the hashed payload, and true lengths are
recovered from object size metadata at decode.  phash256 is an
integrity checksum against accidental bitrot, not a MAC - see the
threat model in ops/hash.py.
"""

from __future__ import annotations

import numpy as np

from ..ops import hash as phash

DIGEST_SIZE = 32
ALIGN = 32  # shard blocks padded to this; also the digest frame size


def padded_len(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def frame_size(shard_block_len: int) -> int:
    """Bytes one framed shard block occupies on disk (digest + padding).

    The analogue of the per-block accounting in bitrotShardFileSize
    (cmd/bitrot.go:140-145).
    """
    return DIGEST_SIZE + padded_len(shard_block_len)


def digest_to_bytes(d: np.ndarray) -> bytes:
    """(8,) uint32 device digest -> 32-byte frame."""
    return np.ascontiguousarray(d, dtype=np.uint32).tobytes()


def digest_from_bytes(b: bytes) -> np.ndarray:
    if len(b) != DIGEST_SIZE:
        raise ValueError(f"bad digest frame length {len(b)}")
    return np.frombuffer(b, dtype=np.uint32).copy()


def verify_block(payload: bytes, digest_frame: bytes) -> bool:
    """Host-side single-block verification (heal's deep scan,
    XLStorage.verify_file).  The read path verifies in one batched
    device pass instead (codec backend verify())."""
    return phash.phash256_host(payload) == digest_frame
