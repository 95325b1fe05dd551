"""Two-tier read cache for digest-verified encoded groups.

The unit of caching is one decode group: the (g, k, shard_len) data
rows of ``g`` equal-size blocks plus their (g, k, 8) uint32 bitrot
digest words - exactly what ``Erasure._decode_blocks`` needs to stream
a group without touching ``_read_group_quorum``.  Entries are keyed by
(bucket, object, data_dir, part, first_block, g, shard_len): the
data_dir makes every PUT generation a distinct key space, and a
(bucket, object) prefix index gives O(entries-per-object)
invalidation.

Tiers:

* device - hot tier; the group's data rows live as a uint8 tensor on
  the cache's ``device`` (the codec backend's device in the server),
  charged against the shared DeviceBudget so the parity plane, the
  codec staging and the read cache split one pool instead of
  double-booking device memory.  A failed copy onto the device raises:
  the group never lands on the host tier in its place.
* host - second tier; plain numpy.  Device evictions demote here (a
  D2H copy); host evictions drop.

Both tiers sit behind the TinyLFU admission contest (admission.py),
and every hit re-verifies the stored digests against the stored rows
before serving - a device entry through the digest kernel on the
resident tensor, a host entry through the codec backend - so a
corrupted cached group is dropped and falls back to the quorum-read
path, never served.

Torch tensors are mutable where the JAX package's device buffers are
not: no code may write into a tensor this cache stores or hands out
(``device_entries``); readers copy (``torch.cat``, ``.to(copy=True)``).
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict

import numpy as np
import torch

from .admission import AdmissionFilter
from .allocator import DeviceBudget

TIER_DEVICE = "device"
TIER_HOST = "host"
TIERS = (TIER_DEVICE, TIER_HOST)

BUDGET_ACCOUNT = "read_cache"


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` that the cache owns.  Raises when
    the copy fails (no device, out of memory)."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, dtype=np.uint8, order="C")
    return torch.from_numpy(arr).to(device, copy=True)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a device entry's rows (the D2H seam)."""
    return t.to("cpu", copy=True).numpy()


def _verify_resident(t: torch.Tensor, digests: np.ndarray) -> bool:
    """Digest the resident rows where they lie (the digest kernel on the
    card, its plain version on the CPU) against the stored words."""
    from ..ops import codec_step

    got = codec_step.digest_words_batched(t.view(torch.int32), t.shape[-1])
    return bool(np.array_equal(codec_step.tensor_to_words(got), digests))


class _Entry:
    __slots__ = ("key", "heat_key", "data", "digests", "tier",
                 "nbytes", "pins")

    def __init__(self, key, heat_key, data, digests, tier, nbytes):
        self.key = key
        self.heat_key = heat_key
        self.data = data
        self.digests = digests
        self.tier = tier
        self.nbytes = nbytes
        self.pins = 0


class TieredReadCache:
    """Bounded two-tier group cache with admission, pinning and
    prefix invalidation.  All bookkeeping sits under one lock; the
    digest re-verification on hit runs OUTSIDE it with the entry
    pinned, so eviction never yanks a group mid-serve."""

    def __init__(
        self,
        mode: str,
        host_capacity: int,
        device_capacity: int,
        admission: "AdmissionFilter | None" = None,
        budget: "DeviceBudget | None" = None,
        device="cuda",
    ):
        if mode not in (TIER_HOST, TIER_DEVICE):
            raise ValueError(f"bad cache mode {mode!r}")
        self.mode = mode
        self.device = torch.device(device)
        self._mu = threading.Lock()
        self._tiers: "dict[str, OrderedDict]" = {
            t: OrderedDict() for t in TIERS
        }
        self._caps = {
            TIER_DEVICE: int(device_capacity) if mode == TIER_DEVICE else 0,
            TIER_HOST: int(host_capacity),
        }
        self._bytes = {t: 0 for t in TIERS}
        self._index: "dict[tuple, set]" = {}
        self.admission = admission or AdmissionFilter()
        self._budget = budget
        self._order = (
            (TIER_DEVICE, TIER_HOST) if mode == TIER_DEVICE
            else (TIER_HOST,)
        )
        self._hits = {t: 0 for t in TIERS}
        self._misses = {t: 0 for t in TIERS}
        self._evictions = {t: 0 for t in TIERS}
        self._rejects = {t: 0 for t in TIERS}
        self._demotions = 0
        self._invalidations = 0
        self._verify_drops = 0
        # FileInfo side-car: the latest-version metadata a locked GET
        # just quorum-read, keyed (bucket, object) and dropped through
        # the SAME invalidation seam as the groups - a full hit then
        # skips the per-GET xl.meta fan-out too.  Small fixed-count LRU;
        # entries are deep-copied on store so no caller aliases them.
        self._meta: "OrderedDict[tuple, object]" = OrderedDict()
        self._meta_cap = 4096

    # ---- read side ------------------------------------------------------

    def lookup(self, be, key: tuple, heat_key: str):
        """Return the verified (g, k, shard_len) host data rows, or None."""
        self.admission.record(heat_key)
        with self._mu:
            ent = None
            for tier in self._order:
                e = self._tiers[tier].get(key)
                if e is None:
                    self._misses[tier] += 1
                    continue
                e.pins += 1
                self._tiers[tier].move_to_end(key)
                ent = e
                break
            if ent is None:
                return None
        try:
            stored = ent.data
            if isinstance(stored, torch.Tensor):
                good = _verify_resident(stored, ent.digests)
                data = _to_host(stored) if good else None
            else:
                data = stored
                # verify on the raw backend: the batcher's submit/coalesce
                # hop buys nothing for one synchronous digest pass
                vbe = getattr(be, "inner", be)
                good = bool(np.all(vbe.verify(data, ent.digests)))
        finally:
            with self._mu:
                ent.pins -= 1
        if not good:
            # the cached copy rotted (or was tampered with): drop it and
            # miss through to the quorum read, which has the real
            # on-disk digests to arbitrate
            with self._mu:
                self._drop(key)
                self._rejects[ent.tier] += 1
                self._misses[ent.tier] += 1
                self._verify_drops += 1
                self._account()
            return None
        with self._mu:
            self._hits[ent.tier] += 1
        return data

    def device_entries(self, bucket: str, object_name: str) -> dict:
        """Device-tier group tensors of one object, keyed by full cache
        key, WITHOUT host materialization - the S3 Select pushdown
        assembles them into a scan plane on the device.

        Device-tier only: a host-tier or missing group keeps the scan on
        the spooled read path.  The tensors are the cache's own: the
        caller reads them and never writes them."""
        with self._mu:
            keys = self._index.get((bucket, object_name), ())
            out = {}
            for key in keys:
                e = self._tiers[TIER_DEVICE].get(key)
                if e is not None:
                    self._tiers[TIER_DEVICE].move_to_end(key)
                    out[key] = e.data
            if out:
                self._hits[TIER_DEVICE] += len(out)
            return out

    # ---- write side -----------------------------------------------------

    def put(
        self, key: tuple, heat_key: str,
        data: np.ndarray, digests: np.ndarray, source: str = "get",
    ) -> bool:
        """Admit one group.  ``data``/``digests`` must be safe for the
        cache to retain (callers copy views).  Returns admitted; raises
        when the copy onto the device tier fails."""
        nbytes = int(data.nbytes) + int(digests.nbytes)
        if source == "put":
            # a fresh write gets one frequency credit; it still cannot
            # displace an established hot object (contest is strict >)
            self.admission.record(heat_key)
        with self._mu:
            try:
                return self._put(key, heat_key, data, digests, nbytes)
            finally:
                self._account()

    def _put(self, key, heat_key, data, digests, nbytes) -> bool:
        self._drop(key)  # replacement: never two generations
        target = TIER_DEVICE if self._caps[TIER_DEVICE] else TIER_HOST
        if not self._make_room(target, nbytes, heat_key):
            if target != TIER_DEVICE:
                self._rejects[target] += 1
                return False
            target = TIER_HOST
            if not self._make_room(target, nbytes, heat_key):
                self._rejects[target] += 1
                return False
        stored = data
        if target == TIER_DEVICE:
            stored = _to_device(data, self.device)
        ent = _Entry(key, heat_key, stored, digests, target, nbytes)
        self._tiers[target][key] = ent
        self._bytes[target] += nbytes
        self._index.setdefault((key[0], key[1]), set()).add(key)
        return True

    # ---- FileInfo side-car ----------------------------------------------

    def meta_lookup(self, bucket: str, object_name: str):
        """Latest-version FileInfo cached by a locked GET, or None.

        The returned object is SHARED across hits - the GET path only
        reads it (``_to_object_info`` copies metadata/parts before
        anything downstream may mutate)."""
        with self._mu:
            fi = self._meta.get((bucket, object_name))
            if fi is not None:
                self._meta.move_to_end((bucket, object_name))
            return fi

    def meta_store(self, bucket: str, object_name: str, fi) -> None:
        """Retain the FileInfo a quorum read just produced (deep-copied
        once here so no caller aliases the stored instance).  Callers
        MUST hold the object's namespace lock for the read that
        produced ``fi`` - the lock orders this store against the
        post-commit invalidate of any concurrent mutation."""
        with self._mu:
            self._meta[(bucket, object_name)] = copy.deepcopy(fi)
            self._meta.move_to_end((bucket, object_name))
            while len(self._meta) > self._meta_cap:
                self._meta.popitem(last=False)

    # ---- invalidation ---------------------------------------------------

    def invalidate(self, bucket: str, object_name: str) -> int:
        """Drop every cached group AND the FileInfo side-car entry of
        (bucket, object); returns the group count."""
        with self._mu:
            self._meta.pop((bucket, object_name), None)
            keys = self._index.pop((bucket, object_name), None)
            if not keys:
                return 0
            n = 0
            for key in list(keys):
                if self._drop(key, unindex=False):
                    n += 1
            self._invalidations += 1
            self._account()
            return n

    def clear(self) -> int:
        with self._mu:
            n = sum(len(t) for t in self._tiers.values())
            for t in TIERS:
                self._tiers[t].clear()
                self._bytes[t] = 0
            self._index.clear()
            self._meta.clear()
            self._account()
            return n

    # ---- internals (lock held) ------------------------------------------

    def _account(self) -> None:
        if self._budget is not None:
            self._budget.set_usage(BUDGET_ACCOUNT, self._bytes[TIER_DEVICE])

    def _unindex(self, key: tuple) -> None:
        pref = self._index.get((key[0], key[1]))
        if pref is not None:
            pref.discard(key)
            if not pref:
                del self._index[(key[0], key[1])]

    def _drop(self, key: tuple, unindex: bool = True) -> bool:
        for tier in TIERS:
            ent = self._tiers[tier].pop(key, None)
            if ent is not None:
                self._bytes[tier] -= ent.nbytes
                if unindex:
                    self._unindex(key)
                return True
        return False

    def _free(self, tier: str) -> int:
        free = self._caps[tier] - self._bytes[tier]
        if tier == TIER_DEVICE and self._budget is not None:
            # the parity plane's and the staging's live bytes shrink our
            # headroom: one device, one budget
            free = min(free, self._budget.headroom())
        return free

    def _make_room(self, tier: str, nbytes: int, heat_key: str) -> bool:
        if self._caps[tier] <= 0 or nbytes > self._caps[tier]:
            return False
        while self._free(tier) < nbytes:
            victim = next(
                (e for e in self._tiers[tier].values() if e.pins == 0),
                None,
            )
            if victim is None:
                return False  # everything pinned mid-serve
            if not self.admission.contest(heat_key, victim.heat_key):
                return False
            self._evict(victim)
        return True

    def _evict(self, ent: "_Entry") -> None:
        self._tiers[ent.tier].pop(ent.key, None)
        self._bytes[ent.tier] -= ent.nbytes
        self._evictions[ent.tier] += 1
        if ent.tier == TIER_DEVICE:
            # write-back demotion: the device copy drains to the host
            # tier (same admission contest against host victims) before
            # the device bytes free up
            if self._make_room(TIER_HOST, ent.nbytes, ent.heat_key):
                ent.data = _to_host(ent.data)
                ent.tier = TIER_HOST
                self._tiers[TIER_HOST][ent.key] = ent
                self._bytes[TIER_HOST] += ent.nbytes
                self._demotions += 1
                self._account()
                return
        self._unindex(ent.key)
        self._account()

    # ---- introspection --------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            tiers = {}
            for t in TIERS:
                tiers[t] = {
                    "hits": self._hits[t],
                    "misses": self._misses[t],
                    "evictions": self._evictions[t],
                    "rejects": self._rejects[t],
                    "entries": len(self._tiers[t]),
                    "occupancy_bytes": self._bytes[t],
                    "capacity_bytes": self._caps[t],
                }
            return {
                "mode": self.mode,
                "tiers": tiers,
                "demotions": self._demotions,
                "invalidations": self._invalidations,
                "verify_drops": self._verify_drops,
                "admission": self.admission.stats(),
            }


class ReadCacheContext:
    """Per-(object, part) handle the codec threads through decode and
    encode: owns the key prefix so erasure.py only speaks in
    (first_block, g, shard_len) group coordinates."""

    __slots__ = ("cache", "bucket", "object_name", "data_dir", "part")

    def __init__(self, cache, bucket, object_name, data_dir, part):
        self.cache = cache
        self.bucket = bucket
        self.object_name = object_name
        self.data_dir = data_dir
        self.part = part

    def _key(self, first_block: int, g: int, shard_len: int) -> tuple:
        return (
            self.bucket, self.object_name, self.data_dir, self.part,
            first_block, g, shard_len,
        )

    @property
    def heat_key(self) -> str:
        return f"{self.bucket}/{self.object_name}"

    def lookup(self, be, first_block, g, shard_len):
        return self.cache.lookup(
            be, self._key(first_block, g, shard_len), self.heat_key
        )

    def admit_from_decode(self, first_block, g, shard_len,
                          data, digests) -> bool:
        """Cache-miss GET population: the decoded data rows + digest
        words (on-disk words when the data slots read intact, freshly
        computed when rows were reconstructed from verified parity;
        views into the quorum-read frame buffer are copied here so the
        cache owns its bytes)."""
        return self.cache.put(
            self._key(first_block, g, shard_len),
            self.heat_key,
            np.ascontiguousarray(data),
            np.ascontiguousarray(digests),
            source="get",
        )

    def populate_from_encode(self, first_block, batch, digests_u32) -> bool:
        """PUT population: the encode batch's data rows, already
        assembled; nothing writes the batch after the encode began, so
        the host tier retains it zero-copy (the device tier copies)."""
        g, _k, shard_len = batch.shape
        return self.cache.put(
            self._key(first_block, g, shard_len),
            self.heat_key,
            batch,
            np.ascontiguousarray(digests_u32),
            source="put",
        )
