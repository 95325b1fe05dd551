"""TinyLFU-style frequency admission for the tiered read cache.

A small count-min sketch estimates per-object access frequency (4-bit
counters, conservative update, periodic halving so the window tracks
RECENT popularity — the TinyLFU aging step).  Admission is the classic
contest: a candidate only displaces the eviction victim when its
estimated frequency is strictly higher, so a one-shot scan (frequency
1 per key) can never evict an established working set.

Keys are OBJECT-level ("bucket/object"), not group-level: one hot
object admits all of its encoded groups, and the crawler can seed heat
for keys it observes without knowing shard geometry.
"""

from __future__ import annotations

import hashlib
import threading

_MAX_COUNT = 15  # 4-bit counters, TinyLFU-style saturation
_ROW_SEEDS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
)


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "little"
    )


class FrequencySketch:
    """Count-min sketch with saturating counters and halving decay."""

    def __init__(self, width: int = 4096, depth: int = 4,
                 sample_factor: int = 8):
        if width & (width - 1):
            raise ValueError("width must be a power of two")
        self.width = width
        self.depth = min(depth, len(_ROW_SEEDS))
        self._rows = [bytearray(width) for _ in range(self.depth)]
        self._ops = 0
        self._sample = width * sample_factor
        self.ages = 0

    def _indexes(self, key: str) -> "list[int]":
        h = _hash64(key)
        mask = self.width - 1
        return [
            ((h ^ _ROW_SEEDS[r]) * _ROW_SEEDS[(r + 1) % len(_ROW_SEEDS)]
             >> 17) & mask
            for r in range(self.depth)
        ]

    def touch(self, key: str, hits: int = 1) -> int:
        """Record ``hits`` accesses; returns the new estimate."""
        est = _MAX_COUNT
        for _ in range(max(1, hits)):
            idxs = self._indexes(key)
            est = min(self._rows[r][i] for r, i in enumerate(idxs))
            if est < _MAX_COUNT:
                # conservative update: bump only the minimal counters,
                # halving over-counts from hash collisions
                for r, i in enumerate(idxs):
                    if self._rows[r][i] == est:
                        self._rows[r][i] = est + 1
                est += 1
            self._ops += 1
            if self._ops >= self._sample:
                self._age()
        return est

    def estimate(self, key: str) -> int:
        idxs = self._indexes(key)
        return min(self._rows[r][i] for r, i in enumerate(idxs))

    def _age(self) -> None:
        for row in self._rows:
            for i, v in enumerate(row):
                if v:
                    row[i] = v >> 1
        self._ops = 0
        self.ages += 1


class AdmissionFilter:
    """Frequency-contest gatekeeper in front of both cache tiers."""

    def __init__(self, sketch: "FrequencySketch | None" = None):
        self._mu = threading.Lock()
        self.sketch = sketch or FrequencySketch()
        self.recorded = 0
        self.seeded = 0
        self.admitted = 0
        self.rejected = 0

    def record(self, heat_key: str) -> None:
        with self._mu:
            self.sketch.touch(heat_key)
            self.recorded += 1

    def seed(self, heat_key: str, hits: int = 2) -> None:
        """Crawler heat: pre-warm a key's frequency so the first flood
        request already wins the admission contest."""
        with self._mu:
            self.sketch.touch(heat_key, hits=hits)
            self.seeded += 1

    def estimate(self, heat_key: str) -> int:
        with self._mu:
            return self.sketch.estimate(heat_key)

    def contest(self, candidate: str, victim: "str | None") -> bool:
        """True when ``candidate`` may displace ``victim`` (or there is
        no victim — free space is always admissible)."""
        with self._mu:
            if victim is None:
                ok = True
            else:
                ok = (
                    self.sketch.estimate(candidate)
                    > self.sketch.estimate(victim)
                )
            if ok:
                self.admitted += 1
            else:
                self.rejected += 1
            return ok

    def stats(self) -> dict:
        with self._mu:
            return {
                "recorded": self.recorded,
                "seeded": self.seeded,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "sketch_ages": self.sketch.ages,
            }
