"""Codec backend seam: the reedsolomon.Encoder-shaped boundary.

The reference hides its codec behind reedsolomon.Encoder constructed at
cmd/erasure-coding.go:54-64; everything above (Erasure.Encode/Decode) is
codec-agnostic.  This module is that seam for the port:

    backend = get_backend(device)     # default "cuda"; tests pass "cpu"

* TorchBackend(device): batched fused codec passes (ops/codec_step) on
  one torch device - the hand-written CUDA kernels on the card, their
  plain PyTorch versions on the CPU.  It keeps the parity plane
  device-resident and reads back only the digests at encode time.

There is no automatic choice of device and no silent fallback: asking
for the card where there is none raises.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..ops import codec_step
from ..utils.log import logger
from . import compress as compmod

_log = logger("codec.backend")


def _record_d2h(plane: str, nbytes: int) -> None:
    """Account one device->host transfer (plane = data|parity).

    Lazy import: telemetry imports this module at load, so the reverse
    edge must resolve at call time."""
    from .telemetry import KERNEL_STATS

    KERNEL_STATS.record_d2h(plane, int(nbytes))


def _record_pass(kernel: str) -> None:
    """Account one codec device pass by entry-point name (fused1 runs
    exactly one per direction per batch)."""
    from .telemetry import KERNEL_STATS

    KERNEL_STATS.record_pass(kernel)


def _record_h2d(plane: str, nbytes: int) -> None:
    """Account one host->device codec staging transfer."""
    from .telemetry import KERNEL_STATS

    KERNEL_STATS.record_h2d(plane, int(nbytes))


# ---------------------------------------------------------------------------
# Device-resident parity plane: refs + the bounded write-back cache
# ---------------------------------------------------------------------------


class ParityPlaneCache:
    """Bounded write-back cache of device-resident parity planes.

    One entry per (encode handle, shard-size group) — a ParityRef whose
    bytes still live on the device.  ``add`` evicts FIFO once occupancy
    exceeds the byte budget, and eviction IS the write-back: the victim
    ref drains D2H (outside the cache lock — drain re-enters via
    ``forget``), so a burst of concurrent PUTs can never pin unbounded
    device memory; it just loses laziness for the oldest planes.
    """

    def __init__(self, capacity_bytes: int):
        self._mu = threading.Lock()
        # insertion-ordered (dict preserves it): FIFO eviction
        self._refs: "dict[int, object]" = {}
        self._bytes = 0
        self.capacity = max(1, int(capacity_bytes))
        self.added = 0
        self.evictions = 0

    def _account(self) -> None:
        """Report occupancy to the shared device-byte ledger
        (cache/allocator.py). Lock held."""
        from ..cache.allocator import device_budget

        device_budget().set_usage("parity_plane", self._bytes)

    def add(self, ref) -> None:
        while True:
            victim = None
            with self._mu:
                if id(ref) not in self._refs:
                    self._refs[id(ref)] = ref
                    self._bytes += ref.nbytes
                    self.added += 1
                    self._account()
                if self._bytes > self.capacity:
                    for r in self._refs.values():
                        if r is not ref:
                            victim = r
                            break
                    if victim is not None:
                        self.evictions += 1
                if victim is None:
                    return  # within budget (or lone oversized plane)
            victim.drain()  # write-back outside the lock; drain forgets

    def forget(self, ref) -> None:
        """Drop a drained/released ref (called by the ref itself)."""
        with self._mu:
            if self._refs.pop(id(ref), None) is not None:
                self._bytes -= ref.nbytes
                self._account()

    def pressure(self) -> float:
        """Occupancy over budget; >= 1.0 means the batcher should back
        off admitting new encodes until drains catch up."""
        with self._mu:
            return self._bytes / self.capacity

    def stats(self) -> dict:
        with self._mu:
            return {
                "capacity_bytes": self.capacity,
                "occupancy_bytes": self._bytes,
                "entries": len(self._refs),
                "added": self.added,
                "evictions": self.evictions,
            }


class _EagerParityRef:
    """ParityRef over host-resident parity: the bytes are already on the
    host, so drain is a handover."""

    __slots__ = ("_parity",)

    def __init__(self, parity_b: np.ndarray):
        self._parity = parity_b

    @property
    def nbytes(self) -> int:
        return 0 if self._parity is None else self._parity.nbytes

    def drain(self) -> np.ndarray:
        return self._parity

    def release(self) -> None:
        self._parity = None


class _DeviceParityRef:
    """One batch's device-resident parity plane ((B, m, w) int32 words).

    ``drain()`` is the single D2H seam: thread-safe and memoized, so the
    m per-disk parity writers sharing this ref pay one transfer.  The
    occupancy ``flags`` and the prefix ``packed`` plane come out of the
    same encode_pack launch as the parity itself, so the drain launches
    no kernel - it only picks which precomputed plane crosses the bus.
    Registered with the ParityPlaneCache until drained or released.
    """

    __slots__ = (
        "_lk",
        "_cache",
        "_parity_w",
        "_flags",
        "_packed",
        "_group",
        "_host",
        "nbytes",
    )

    def __init__(
        self,
        cache: ParityPlaneCache,
        parity_w: torch.Tensor,
        flags: "torch.Tensor | None" = None,
        packed: "torch.Tensor | None" = None,
        group: int = 0,
    ):
        self._lk = threading.Lock()
        self._cache = cache
        self._parity_w = parity_w
        self._flags = flags
        self._packed = packed
        self._group = int(group)
        self._host: "np.ndarray | None" = None
        plane = int(parity_w.numel() * 4)
        # the packed twin is a second device-resident plane of the same
        # size: account it honestly against the write-back budget
        self.nbytes = plane * (2 if packed is not None else 1)
        cache.add(self)

    def drain(self) -> np.ndarray:
        """(B, m, L) uint8 parity bytes, materialized at most once."""
        with self._lk:
            if self._host is None and self._parity_w is not None:
                if self._packed is not None:
                    self._host = self._drain_precomputed(
                        self._parity_w, self._flags, self._packed,
                        self._group,
                    )
                else:
                    self._host = self._drain_raw(self._parity_w)
                self._parity_w = None
                self._flags = None
                self._packed = None
                self._cache.forget(self)
            return self._host

    def release(self) -> None:
        """Drop an unused plane without the transfer (error-path
        cleanup of handles whose writers were never scheduled)."""
        with self._lk:
            if self._parity_w is not None:
                self._parity_w = None
                self._flags = None
                self._packed = None
                self._cache.forget(self)

    @staticmethod
    def _drain_raw(parity_w: torch.Tensor) -> np.ndarray:
        """The whole plane over the bus (no pack leg ran)."""
        parity = codec_step.tensor_to_words(parity_w)
        _record_d2h("parity", parity.nbytes)
        return codec_step.host_words_to_bytes(parity)

    @staticmethod
    def _drain_precomputed(parity_w, flags_d, packed_d, group) -> np.ndarray:
        """Occupancy screen + pack came out of the encode launch itself:
        only the chosen plane's D2H (flags are a few bytes per row)."""
        w = int(parity_w.shape[-1])
        g = w // group
        flags = flags_d.cpu().numpy()  # (B, m, g) bool, tiny
        if compmod.device_compress_mode() != "off":
            kept = int(flags.sum(axis=-1).max()) if flags.size else 0
            if kept == 0:
                _record_d2h("parity", flags.nbytes)
                return np.zeros(
                    tuple(parity_w.shape[:-1]) + (w * 4,), dtype=np.uint8
                )
            if (
                compmod.device_compress_mode() == "on"
                or kept / g <= compmod.parity_fill_threshold()
            ):
                keep = compmod.prefix_keep(kept, g)
                prefix = codec_step.tensor_to_words(
                    packed_d[..., : keep * group]
                )
                _record_d2h("parity", flags.nbytes + prefix.nbytes)
                words = compmod.unpack_nonzero_groups(
                    flags, prefix, group, w
                )
                return codec_step.host_words_to_bytes(words)
        return _DeviceParityRef._drain_raw(parity_w)


class _ParityCaches:
    """One write-back cache per process (MINIO_TPU_PARITY_CACHE_MB,
    default 128 MiB; read once at creation, reset_backend() drops it)."""

    cache: "ParityPlaneCache | None" = None


def parity_plane_cache() -> ParityPlaneCache:
    c = _ParityCaches.cache
    if c is None:
        with _lock:
            if _ParityCaches.cache is None:
                try:
                    mb = float(
                        os.environ.get("MINIO_TPU_PARITY_CACHE_MB") or 128
                    )
                except ValueError:
                    mb = 128.0
                _ParityCaches.cache = ParityPlaneCache(int(mb * (1 << 20)))
            c = _ParityCaches.cache
    return c


def parity_cache_stats() -> dict:
    """Occupancy/eviction counters for telemetry (zeros before first use)."""
    c = _ParityCaches.cache
    if c is None:
        return {
            "capacity_bytes": 0,
            "occupancy_bytes": 0,
            "entries": 0,
            "added": 0,
            "evictions": 0,
        }
    return c.stats()


def parity_cache_pressure() -> float:
    """Cache pressure without forcing the singleton into existence."""
    c = _ParityCaches.cache
    return 0.0 if c is None else c.pressure()


class _AsyncHandle:
    """Mutable in-flight encode handle.

    ``consumed``/``result`` make encode_end IDEMPOTENT: error-path
    cleanup racing the normal consume gets the first call's result back
    instead of re-materializing.
    """

    __slots__ = ("kind", "payload", "consumed", "result")

    def __init__(self, kind: str, payload):
        self.kind = kind
        self.payload = payload
        self.consumed = False
        self.result = None


class CodecBackend:
    """Batched erasure codec + bitrot digest interface.

    Shapes are byte-domain; implementations may view as words internally.
    """

    name = "abstract"

    # True when encode() computes parity and digests in one fused pass
    # over the bytes; the erasure layer books its time as "codec_fused".
    fused_encode = False

    def encode(self, data: np.ndarray, parity_shards: int):
        """(B, k, L) u8 -> (parity (B, m, L) u8, digests (B, k+m, 8) u32).

        L must be a multiple of 32.  Digest order: data rows then parity.
        """
        raise NotImplementedError

    def reconstruct(
        self,
        shards: np.ndarray,
        present: "tuple[bool, ...]",
        data_shards: int,
        parity_shards: int,
    ) -> np.ndarray:
        """(B, n, L) u8 + survivor mask -> (B, k, L) u8 data rows."""
        raise NotImplementedError

    def digest(self, shards: np.ndarray) -> np.ndarray:
        """(B, n, L) u8 -> (B, n, 8) u32 phash256 digests."""
        raise NotImplementedError

    def verify(self, shards: np.ndarray, digests: np.ndarray) -> np.ndarray:
        """(B, n, L) u8 + (B, n, 8) digests -> (B, n) bool intact mask."""
        return (self.digest(shards) == np.asarray(digests)).all(axis=-1)

    def reconstruct_and_verify(
        self,
        shards: np.ndarray,
        digests: np.ndarray,
        present: "tuple[bool, ...] | np.ndarray",
        data_shards: int,
        parity_shards: int,
    ) -> "tuple[np.ndarray, np.ndarray]":
        """Verify digests of present shards AND decode the data rows.

        (B, n, L) u8 + (B, n, 8) digests + present mask ->
        (data (B, k, L) u8, ok (B, n) bool).  The returned ok mask
        reflects per-shard digest checks (absent shards are False);
        decode uses only shards that verified intact.  Raises
        ValueError when fewer than k shards verify for some stripe.
        Backends may fuse the two passes; this default composes them.
        """
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        pres = np.asarray(present, dtype=bool)
        ok = self.verify(shards, digests) & pres
        return (
            self._reconstruct_from_ok(
                shards, ok, data_shards, parity_shards
            ),
            ok,
        )

    def _reconstruct_from_ok(self, shards, ok, data_shards, parity_shards):
        """Decode each stripe from its own verified-intact shard set,
        grouping stripes that share a survivor pattern into one
        reconstruct call."""
        B, n, L = shards.shape
        out = np.empty((B, data_shards, L), dtype=np.uint8)
        groups: "dict[tuple[bool, ...], list[int]]" = {}
        for b in range(B):
            if int(ok[b].sum()) < data_shards:
                raise ValueError(
                    f"stripe {b}: {int(ok[b].sum())}/{n} shards intact,"
                    f" need {data_shards}"
                )
            groups.setdefault(tuple(bool(x) for x in ok[b]), []).append(b)
        for pat, idxs in groups.items():
            out[idxs] = self.reconstruct(
                shards[idxs], pat, data_shards, parity_shards
            )
        return out

    # -- async pipeline seam (erasure-encode.go:73-109 overlap) --------
    #
    # encode_begin enqueues the H2D transfer + device pass and returns an
    # opaque handle; encode_end materializes the results.  The streaming
    # encoder keeps one batch in flight so the device works on batch k
    # while the host writes batch k-1 to disk.

    def encode_begin(self, data: np.ndarray, parity_shards: int):
        return self.encode(data, parity_shards)

    def encode_end(self, handle):
        return handle

    # -- digest-only pipeline seam (device-resident parity plane) ------
    #
    # Same begin/end split, but _end eagerly materializes ONLY the
    # digests (all the commit path needs to build bitrot metadata and
    # ack) and returns the parity as a ParityRef whose .drain() is the
    # lazy D2H seam the parity writers pull through behind quorum.

    def encode_digest_begin(self, data: np.ndarray, parity_shards: int):
        return self.encode_begin(data, parity_shards)

    def encode_digest_end(self, handle):
        """handle -> (digests (B, k+m, 8) u32, parity ref)."""
        parity, digests = self.encode_end(handle)
        return (
            np.asarray(digests),
            _EagerParityRef(
                np.ascontiguousarray(parity, dtype=np.uint8)
            ),
        )

    def parity_cache_pressure(self) -> float:
        """Write-back cache pressure seen by this backend (0.0 when the
        backend keeps nothing device-resident)."""
        return 0.0


class TorchBackend(CodecBackend):
    """Device backend on one torch device: the counterpart of the JAX
    package's single-device TpuBackend.

    ``device`` is a torch.device (or its name).  On ``cuda`` every pass
    is a hand-written kernel (encode_pack, phash256_batched,
    gf_matmul_words); on ``cpu`` the same passes run their plain
    PyTorch versions.
    """

    name = "torch"
    fused_encode = True  # one encode_pack pass per batch

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: CUDA requested but torch.cuda.is_available()"
                " is False"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported codec device {self.device}")

    def _stage(self, words_h: np.ndarray) -> torch.Tensor:
        t = codec_step.words_to_tensor(words_h, self.device)
        _record_h2d("data", words_h.nbytes)
        return t

    def encode(self, data, parity_shards):
        return self.encode_end(self.encode_begin(data, parity_shards))

    def encode_begin(self, data, parity_shards):
        """Eager-readback encode: the launch is asynchronous on the card,
        so the pass runs while the caller streams the previous batch."""
        codec_step.codec_kernel_mode()
        codec_step.codec_formulation()
        codec_step.codec_overlap_mode()
        data = np.ascontiguousarray(data, dtype=np.uint8)
        L = data.shape[-1]
        words = self._stage(codec_step.host_bytes_to_words(data))
        parity_w, digests, _f, _p = codec_step.encode_words_fused1(
            words, parity_shards, L
        )
        _record_pass("encode_words_fused1")
        return _AsyncHandle("async", (parity_w, digests))

    def encode_end(self, handle):
        if not isinstance(handle, _AsyncHandle):
            return handle  # foreign/eager handle: already a result
        if handle.consumed:
            return handle.result
        if handle.kind != "async":
            raise ValueError(f"encode_end: unknown handle kind {handle.kind!r}")
        parity_w, digests_d = handle.payload
        parity = codec_step.tensor_to_words(parity_w)
        digests = codec_step.tensor_to_words(digests_d)
        _record_d2h("parity", parity.nbytes)
        _record_d2h("data", digests.nbytes)
        handle.result = codec_step.host_words_to_bytes(parity), digests
        handle.consumed = True
        handle.payload = None  # drop the device refs
        return handle.result

    def encode_digest_begin(self, data, parity_shards):
        """Digest-only start: the single encode_pack launch also emits
        the occupancy flags and the nonzero-group prefix pack when the
        plane is packable, so the eventual drain launches nothing."""
        codec_step.codec_kernel_mode()
        codec_step.codec_formulation()
        codec_step.codec_overlap_mode()
        data = np.ascontiguousarray(data, dtype=np.uint8)
        L = data.shape[-1]
        w = L // 4
        G = compmod.PARITY_GROUP_WORDS
        group = (
            G
            if (
                compmod.device_compress_mode() != "off"
                and w % G == 0
                and w // G >= 2
            )
            else 0
        )
        words = self._stage(codec_step.host_bytes_to_words(data))
        parity_w, digests, flags_d, packed_d = codec_step.encode_words_fused1(
            words, parity_shards, L, group=group
        )
        _record_pass("encode_words_fused1")
        return _AsyncHandle(
            "digest-fused1",
            (
                parity_w,
                digests,
                flags_d if group else None,
                packed_d if group else None,
                group,
            ),
        )

    def encode_digest_end(self, handle):
        if not isinstance(handle, _AsyncHandle) or handle.kind != (
            "digest-fused1"
        ):
            return super().encode_digest_end(handle)
        if handle.consumed:
            return handle.result
        # digests are the ONLY eager readback; parity, flags and packed
        # stay device-resident behind the ref
        parity_w, digests_d, flags_d, packed_d, group = handle.payload
        digests = codec_step.tensor_to_words(digests_d)
        _record_d2h("data", digests.nbytes)
        handle.result = (
            digests,
            _DeviceParityRef(
                parity_plane_cache(), parity_w, flags=flags_d,
                packed=packed_d, group=group,
            ),
        )
        handle.consumed = True
        handle.payload = None
        return handle.result

    def parity_cache_pressure(self) -> float:
        return parity_cache_pressure()

    def reconstruct(self, shards, present, data_shards, parity_shards):
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        words = self._stage(codec_step.host_bytes_to_words(shards))
        dw = codec_step.reconstruct_words_batch(
            words, tuple(bool(b) for b in present), data_shards,
            parity_shards,
        )
        _record_pass("reconstruct_words_batch")
        out = codec_step.tensor_to_words(dw)
        _record_d2h("data", out.nbytes)
        return codec_step.host_words_to_bytes(out)

    def digest(self, shards):
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        L = shards.shape[-1]
        words = self._stage(codec_step.host_bytes_to_words(shards))
        got = codec_step.digest_words_batched(words, L)
        _record_pass("phash256_words_batched")
        out = codec_step.tensor_to_words(got)
        _record_d2h("data", out.nbytes)
        return out

    def reconstruct_and_verify(
        self, shards, digests, present, data_shards, parity_shards
    ):
        """Heal's read side in ONE device pass (the verify_reconstruct
        kernel): decode from the first k present rows while hashing every
        present row.  On the rare digest mismatch among the chosen
        survivors, re-pick survivors from the verified mask and re-solve
        just the hit stripes (through gf_matmul_words)."""
        codec_step.codec_kernel_mode()
        codec_step.codec_formulation()
        codec_step.codec_overlap_mode()
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        pres = np.asarray(present, dtype=bool)
        L = shards.shape[-1]
        words = self._stage(codec_step.host_bytes_to_words(shards))
        stored = codec_step.words_to_tensor(
            np.ascontiguousarray(digests, dtype=np.uint32), self.device
        )
        dw_d, ok_d = codec_step.verify_and_reconstruct_words(
            words, stored, tuple(bool(b) for b in pres), data_shards,
            parity_shards, L,
        )
        _record_pass("verify_and_reconstruct_words")
        dw = codec_step.tensor_to_words(dw_d)
        ok = ok_d.cpu().numpy()
        _record_d2h("data", dw.nbytes)
        data = codec_step.host_words_to_bytes(dw)
        surv = np.nonzero(pres)[0][:data_shards]
        bad = ~ok[:, surv].all(axis=1)
        if bad.any():
            idxs = np.nonzero(bad)[0]
            data[idxs] = self._reconstruct_from_ok(
                shards[idxs], ok[idxs], data_shards, parity_shards
            )
        return data, ok


_lock = threading.Lock()
_backends: "dict[str, CodecBackend]" = {}


def get_backend(device="cuda") -> CodecBackend:
    """The process-wide codec backend of one device: TorchBackend wrapped
    in telemetry and cross-request batching (MINIO_CODEC_BATCH).

    ``device`` defaults to the card; building it raises where
    torch.cuda.is_available() is False.  There is no auto mode."""
    from .batcher import maybe_wrap
    from .telemetry import instrument

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    key = str(dev)
    with _lock:
        be = _backends.get(key)
        if be is None:
            be = maybe_wrap(instrument(TorchBackend(dev)))
            _backends[key] = be
        return be


def reset_backend() -> None:
    """Testing aid: drop the cached backends (and the parity cache) so
    env changes take effect."""
    from ..cache.allocator import device_budget

    with _lock:
        olds = list(_backends.values())
        _backends.clear()
        _ParityCaches.cache = None
    for be in olds:
        shutdown = getattr(be, "shutdown", None)
        if shutdown is not None:
            shutdown()
    device_budget().set_usage("parity_plane", 0)
