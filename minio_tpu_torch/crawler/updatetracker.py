"""Data update tracker: a persisted bloom journal of dirty namespaces.

Role-equivalent of the reference's dataUpdateTracker
(cmd/data-update-tracker.go:63): every object mutation marks the
bucket plus up to three path levels into the current cycle's bloom
filter; before each sweep the crawler rotates the filter
(cycleFilter, data-update-tracker.go:533) and receives the union of
every cycle since its last completed run.  Buckets whose usage is
cached and whose name never hit the filter are skipped wholesale.

Design differences from the reference, deliberate:

- the reference journals every path to disk and replays on boot; we
  instead save atomically on every rotation (and every
  ``save_every`` marks) and mark the in-flight cycle *untrusted*
  after a reload — the first post-restart sweep is a full one, and
  skipping resumes the cycle after.  One extra sweep buys out the
  whole journal/replay subsystem.
- filters union with numpy over the packed bitset, not a byte loop.

The snapshot file is MessagePack written by ``storage/mpack.py``: byte
for byte what ``msgpack.packb`` writes for the same document, so either
package loads the other's file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import zlib

import numpy as np

from ..storage import mpack

# ~1% false-positive rate at ~440k distinct dirty prefixes; a false
# positive only costs one needless bucket crawl
_DEFAULT_BITS = 2**22
_DEFAULT_HASHES = 7
_DEFAULT_HISTORY = 16  # cycles retained (dataUpdateTrackerHistory)


def split_path_deterministic(path: str) -> "list[str]":
    """First <=3 path components, slash/dot prefixes trimmed
    (splitPathDeterministic, data-update-tracker.go:568)."""
    parts = [p for p in path.split("/") if p and p != "."]
    return parts[:3]


class BloomFilter:
    """Double-hashed bloom filter over a packed bitset."""

    __slots__ = ("m", "k", "bits")

    def __init__(self, m: int = _DEFAULT_BITS, k: int = _DEFAULT_HASHES,
                 bits: "bytes | bytearray | None" = None):
        if m % 8:
            raise ValueError("bits must be a multiple of 8")
        self.m = m
        self.k = k
        self.bits = bytearray(m // 8) if bits is None else bytearray(bits)
        if len(self.bits) != m // 8:
            raise ValueError("bitset length mismatch")

    def _positions(self, s: str):
        d = hashlib.blake2b(s.encode(), digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1  # odd: full-period step
        return ((h1 + i * h2) % self.m for i in range(self.k))

    def add(self, s: str) -> None:
        for p in self._positions(s):
            self.bits[p >> 3] |= 1 << (p & 7)

    def __contains__(self, s: str) -> bool:
        return all(
            self.bits[p >> 3] & (1 << (p & 7)) for p in self._positions(s)
        )

    def contains_dir(self, path: str) -> bool:
        """Whether a bucket/prefix was marked dirty
        (bloomFilter.containsDir, data-update-tracker.go:110)."""
        return path.strip("/") in self

    def union_into(self, other: "BloomFilter") -> None:
        """self |= other (shape-checked)."""
        if (other.m, other.k) != (self.m, self.k):
            raise ValueError("bloom shape mismatch")
        a = np.frombuffer(self.bits, dtype=np.uint8)
        b = np.frombuffer(other.bits, dtype=np.uint8)
        self.bits = bytearray(np.bitwise_or(a, b).tobytes())

    def copy(self) -> "BloomFilter":
        return BloomFilter(self.m, self.k, bytes(self.bits))

    def to_bytes(self) -> bytes:
        return zlib.compress(bytes(self.bits), 1)

    @classmethod
    def from_bytes(cls, m: int, k: int, raw: bytes) -> "BloomFilter":
        return cls(m, k, zlib.decompress(raw))


@dataclasses.dataclass
class BloomResponse:
    """cycleFilter reply (bloomFilterResponse,
    data-update-tracker.go:599)."""

    current_idx: int
    oldest_idx: int
    newest_idx: int
    complete: bool
    filter: BloomFilter

    def to_wire(self) -> dict:
        return {
            "current_idx": self.current_idx,
            "oldest_idx": self.oldest_idx,
            "newest_idx": self.newest_idx,
            "complete": self.complete,
            "m": self.filter.m,
            "k": self.filter.k,
            "filter": self.filter.to_bytes(),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "BloomResponse":
        return cls(
            current_idx=d["current_idx"],
            oldest_idx=d["oldest_idx"],
            newest_idx=d["newest_idx"],
            complete=d["complete"],
            filter=BloomFilter.from_bytes(d["m"], d["k"], d["filter"]),
        )


class DataUpdateTracker:
    def __init__(self, path: "str | None" = None, m: int = _DEFAULT_BITS,
                 k: int = _DEFAULT_HASHES,
                 history: int = _DEFAULT_HISTORY,
                 save_every: int = 2000):
        self._lock = threading.Lock()
        # serializes snapshot file writes, NOT taken under _lock:
        # compression and disk IO happen outside the mark hot path
        self._io_lock = threading.Lock()
        self._path = path
        self.m = m
        self.k = k
        self._keep = history
        self._save_every = save_every
        self._marks = 0
        self._snap_seq = 0  # monotone: stale snapshots never clobber
        self._written_seq = 0
        # compressed blobs of rotated (immutable) history filters so a
        # save never recompresses 16 x 512 KiB it already compressed
        self._hist_blobs: "dict[int, bytes]" = {}
        # starts at 0 so the crawler's first sweep (cycle 1) rotates:
        # marks that predate the sweep land in filter 0, inside its
        # window and OUTSIDE cycle 2's - without this every pre-boot
        # mutation would force a redundant re-crawl on the second sweep
        self.current_idx = 0
        self.cur = BloomFilter(m, k)
        self.history: "dict[int, BloomFilter]" = {}
        # cycle indices whose marks may be partially lost (the filter
        # that was live when a previous process died); ranges touching
        # them report complete=False, forcing one full sweep
        self.untrusted: "set[int]" = set()
        if path:
            self._load()

    # -- marking ----------------------------------------------------------

    def mark(self, path: str) -> None:
        """Record a mutation under bucket/object `path`.  Reserved
        volumes (dot-prefixed) are not tracked, like
        isReservedOrInvalidBucket in the reference collector."""
        parts = split_path_deterministic(path)
        if not parts or parts[0].startswith("."):
            return
        snap = None
        with self._lock:
            for i in range(len(parts)):
                self.cur.add("/".join(parts[: i + 1]))
            self._marks += 1
            if self._save_every and self._marks >= self._save_every:
                self._marks = 0
                snap = self._snapshot_locked()
        if snap is not None:
            self._write_snapshot(snap)

    def current(self) -> int:
        with self._lock:
            return self.current_idx

    # -- cycling ----------------------------------------------------------

    def cycle_filter(self, oldest: int, current: int) -> BloomResponse:
        """Start recording into cycle `current` and return the union
        filter covering [oldest, current) (cycleFilter,
        data-update-tracker.go:533)."""
        snap = None
        with self._lock:
            if current and current < self.current_idx:
                # a stale caller (e.g. a node that lost crawl
                # leadership cycles ago) must never rewind the
                # tracker; serve its window incomplete so it falls
                # back to a full sweep and resyncs its counter
                resp = self._filter_from_locked(oldest, self.current_idx)
                resp.complete = False
                return resp
            if current and self.current_idx != current:
                self.history[self.current_idx] = self.cur
                self._hist_blobs[self.current_idx] = self.cur.to_bytes()
                self.cur = BloomFilter(self.m, self.k)
                self.current_idx = current
                floor = max(oldest, current - self._keep)
                for idx in [i for i in self.history if i < floor]:
                    del self.history[idx]
                    self._hist_blobs.pop(idx, None)
                self.untrusted = {
                    i for i in self.untrusted if i >= floor
                }
                snap = self._snapshot_locked()
            resp = self._filter_from_locked(oldest, self.current_idx)
        if snap is not None:
            self._write_snapshot(snap)
        return resp

    def _filter_from_locked(self, oldest: int, newest: int) -> BloomResponse:
        out = BloomFilter(self.m, self.k)
        # the live filter (idx == newest) sits outside the window, but
        # if IT is untrusted (reloaded after a crash, no rotation yet)
        # its lost marks are unobservable anywhere - the window cannot
        # claim completeness
        complete = newest not in self.untrusted
        for idx in range(oldest, newest):
            bf = self.history.get(idx)
            if bf is None or idx in self.untrusted:
                complete = False
                continue
            out.union_into(bf)
        return BloomResponse(
            current_idx=newest,
            oldest_idx=oldest,
            newest_idx=newest,
            complete=complete,
            filter=out,
        )

    # -- persistence (atomic snapshot; see module docstring) ---------------

    def _snapshot_locked(self) -> "dict | None":
        """Cheap state capture under _lock: a copy of the live bitset
        plus already-compressed history blobs.  Compression of the
        live filter and the file write happen in _write_snapshot,
        outside the mark/rotate lock."""
        if not self._path:
            return None
        self._snap_seq += 1
        return {
            "seq": self._snap_seq,
            "idx": self.current_idx,
            "cur_raw": bytes(self.cur.bits),
            "hist": dict(self._hist_blobs),
            "untrusted": sorted(self.untrusted),
        }

    def _write_snapshot(self, snap: "dict | None") -> None:
        if snap is None:
            return
        doc = {
            "m": self.m,
            "k": self.k,
            "idx": snap["idx"],
            "cur": zlib.compress(snap.pop("cur_raw"), 1),
            "hist": snap["hist"],
            "untrusted": snap["untrusted"],
        }
        with self._io_lock:
            if snap["seq"] <= self._written_seq:
                return  # a newer snapshot already landed
            self._written_seq = snap["seq"]
            tmp = self._path + ".tmp"
            try:
                os.makedirs(os.path.dirname(self._path), exist_ok=True)
                with open(tmp, "wb") as f:
                    f.write(mpack.packb(doc))
                os.replace(tmp, self._path)
            except OSError:
                pass

    def save(self) -> None:
        with self._lock:
            snap = self._snapshot_locked()
        self._write_snapshot(snap)

    def _load(self) -> None:
        try:
            with open(self._path, "rb") as f:
                doc = mpack.unpackb(f.read())
        except (OSError, ValueError):
            return
        # parse into locals first: a partially-corrupt snapshot must
        # not leave half-adopted state behind (worse, state adopted
        # WITHOUT the untrusted marking below)
        try:
            if (doc["m"], doc["k"]) != (self.m, self.k):
                return  # shape changed: start fresh
            idx = int(doc["idx"])
            cur = BloomFilter(self.m, self.k, zlib.decompress(doc["cur"]))
            history = {
                int(i): BloomFilter.from_bytes(self.m, self.k, raw)
                for i, raw in doc.get("hist", {}).items()
            }
            hist_blobs = {
                int(i): raw for i, raw in doc.get("hist", {}).items()
            }
            untrusted = set(doc.get("untrusted", []))
        except (KeyError, TypeError, ValueError, zlib.error):
            return
        self.current_idx = idx
        self.cur = cur
        self.history = history
        self._hist_blobs = hist_blobs
        # marks after the last save died with the old process: the
        # in-flight cycle cannot be trusted for skipping
        self.untrusted = untrusted | {idx}


# -- process-wide mark hook (ObjectPathUpdated,
#    data-update-tracker.go:614) ------------------------------------------

_active: "DataUpdateTracker | None" = None


def install_tracker(tracker: "DataUpdateTracker | None") -> None:
    global _active
    _active = tracker


def object_path_updated(path: str) -> None:
    t = _active
    if t is not None:
        t.mark(path)
