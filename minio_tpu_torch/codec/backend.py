"""Codec backend seam: the reedsolomon.Encoder-shaped boundary.

The reference hides its codec behind reedsolomon.Encoder constructed at
cmd/erasure-coding.go:54-64; everything above (Erasure.Encode/Decode) is
codec-agnostic.  This module is that seam for the port:

    backend = get_backend(device)     # default "cuda"; tests pass "cpu"

* TorchBackend(device): batched fused codec passes (ops/codec_step) on
  one torch device - the hand-written CUDA kernels on the card, their
  plain PyTorch versions on the CPU.  It keeps the parity plane
  device-resident and reads back only the digests at encode time.
  MINIO_TPU_CODEC_OVERLAP (codec_step.codec_overlap_mode) picks the PUT
  and heal passes: the pipelined kernels (``pipeline``, the default on
  the card), a sub-chunk chain through pinned staging on CUDA streams
  (``async``), or the serialized kernels (``off``, the default on the
  CPU).  MINIO_TPU_CODEC_KERNEL=legacy (codec_step.codec_kernel_mode)
  runs the pre-fusion passes instead, whatever the overlap mode and
  formulation: the digest encode (K1 without the pack leg), the drain's
  group_flags and pack_nonzero_groups, verify then reconstruct on heal.
* TorchBackend(devices=(...)): the same seam over a mesh of slots
  (parallel/mesh.py, repeats allowed); the mesh passes keep no parity
  plane on the device and record ``mesh_*`` passes, as the JAX
  package's multi-device TpuBackend does.  ``placement_router`` carves
  the slots into submeshes for the batcher (parallel/rules.py).

There is no automatic choice of device and no silent fallback: asking
for the card where there is none raises.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from ..ops import codec_step, kernels
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


def _record_overlap(plane: str, windows: int) -> None:
    """Account overlap windows (plane = put|get): sub-chunks, or kernel
    tile steps, whose transfer ran while a neighbour's compute ran."""
    from .telemetry import KERNEL_STATS

    KERNEL_STATS.record_overlap_windows(plane, int(windows))


# Ping-pong staging ledger of the async sub-chunk chain: while a batch is
# between encode_digest_begin and _end (or inside a heal chain), TWO
# sub-chunk input buffers are live on the device (the one computing and
# the one arriving) on top of the parity planes the ParityPlaneCache
# accounts.  Posted to the shared device-byte budget.
_staging_bytes = 0


def _stage_reserve(nbytes: int) -> int:
    global _staging_bytes
    nbytes = int(nbytes)
    with _lock:
        _staging_bytes += nbytes
        total = _staging_bytes
    _post_staging(total)
    return nbytes


def _stage_release(nbytes: int) -> None:
    global _staging_bytes
    with _lock:
        _staging_bytes = max(0, _staging_bytes - int(nbytes))
        total = _staging_bytes
    _post_staging(total)


def _post_staging(total: int) -> None:
    from ..cache.allocator import device_budget

    device_budget().set_usage("codec_staging", total)


class _PinnedStaging:
    """The async chain's host side on one CUDA device: two pinned input
    slots and two pinned output slots (ping-pong), a copy stream per
    direction and the events that order them.

    Allocated once per backend and grown when a chain needs larger
    slots (a pinned allocation costs milliseconds).  A slot is refilled
    only after the event of its previous copy completed; device tensors
    are allocated on the stream that writes them and ``record_stream``ed
    onto the stream that reads them, so the caching allocator never
    hands their memory out early.  ``lock`` serializes chains, which
    share the slots.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.h2d_stream = torch.cuda.Stream(device)
        self.d2h_stream = torch.cuda.Stream(device)
        self._in: list = [None, None]
        self._out: list = [None, None]
        self._in_done: list = [None, None]

    @staticmethod
    def _slot(bufs: list, slot: int, shape) -> torch.Tensor:
        nwords = int(np.prod(shape))
        buf = bufs[slot]
        if buf is None or buf.numel() < nwords:
            buf = torch.empty(nwords, dtype=torch.int32, pin_memory=True)
            bufs[slot] = buf
        return buf[:nwords].view(tuple(shape))

    def h2d(self, src: np.ndarray, slot: int) -> torch.Tensor:
        """uint32 host words -> int32 device tensor, copied on the copy
        stream; the current (compute) stream waits for it."""
        done = self._in_done[slot]
        if done is not None:
            done.synchronize()  # the slot's previous H2D has landed
        pinned = self._slot(self._in, slot, src.shape)
        np.copyto(pinned.numpy().view(np.uint32), src)
        with torch.cuda.stream(self.h2d_stream):
            dst = torch.empty(src.shape, dtype=torch.int32, device=self.device)
            dst.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.h2d_stream)
        self._in_done[slot] = done
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        dst.record_stream(compute)
        return dst

    def d2h_start(self, src: torch.Tensor, slot: int):
        """Queue src's D2H into output slot ``slot`` behind the compute
        stream's work so far; the caller has consumed the slot's previous
        content.  Returns (event, pinned view) for d2h_finish."""
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.d2h_stream.wait_event(ready)
        pinned = self._slot(self._out, slot, src.shape)
        with torch.cuda.stream(self.d2h_stream):
            pinned.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h_stream)
        src.record_stream(self.d2h_stream)
        return done, pinned

    @staticmethod
    def d2h_finish(started) -> np.ndarray:
        """Wait for a d2h_start and view its words (valid until the slot
        is reused)."""
        done, pinned = started
        done.synchronize()
        return pinned.numpy().view(np.uint32)


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
    m per-disk parity writers sharing this ref pay one transfer.  Under
    fused1 the occupancy ``flags`` and the prefix ``packed`` plane come
    out of the same encode_pack launch as the parity itself, so the drain
    launches no kernel - it only picks which precomputed plane crosses
    the bus.  A ref without precomputed planes (the legacy encode, or no
    pack leg) screens at drain time with group_flags and
    pack_nonzero_groups, as the JAX package's legacy ref does.
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
                    self._host = self._drain_screened(self._parity_w)
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
    def _drain_screened(parity_w: torch.Tensor) -> np.ndarray:
        """The drain of a plane without precomputed planes: the occupancy
        screen (group_flags) when the device-compress mode is not off and
        the row has two groups or more, zeros when no group is kept, the
        pack pass (pack_nonzero_groups) and the prefix's D2H when the mode
        is on or the fill is at or below the threshold, else the raw
        plane.  Passes and D2H bytes as in the JAX package (flags cross
        as one byte each, its bool)."""
        mode = compmod.device_compress_mode()
        w = int(parity_w.shape[-1])
        G = compmod.PARITY_GROUP_WORDS
        g = w // G if w % G == 0 else 0
        if mode != "off" and g >= 2:
            _record_pass("group_flags")
            flags = (codec_step.group_flags(parity_w, G) != 0).cpu().numpy()
            kept = int(flags.sum(axis=-1).max()) if flags.size else 0
            if kept == 0:
                _record_d2h("parity", flags.nbytes)
                return np.zeros(
                    tuple(parity_w.shape[:-1]) + (w * 4,), dtype=np.uint8
                )
            if mode == "on" or kept / g <= compmod.parity_fill_threshold():
                _record_pass("pack_nonzero_groups")
                _f, packed = codec_step.pack_nonzero_groups(parity_w, G)
                keep = compmod.prefix_keep(kept, g)
                prefix = codec_step.tensor_to_words(packed[..., : keep * G])
                _record_d2h("parity", flags.nbytes + prefix.nbytes)
                words = compmod.unpack_nonzero_groups(flags, prefix, G, w)
                return codec_step.host_words_to_bytes(words)
        return _DeviceParityRef._drain_raw(parity_w)

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


class _SubchunkParityRef:
    """One batch's device-resident parity plane held as the S sub-chunk
    tensors of the async chain (splits along the stripe-length axis).

    Same contract as _DeviceParityRef: ``drain()`` is the single memoized
    D2H seam shared by the m parity writers, ``release()`` drops the
    plane without the transfer, and the ParityPlaneCache accounts every
    live device plane - parity AND the packed twin when the pack leg ran.
    """

    __slots__ = (
        "_lk",
        "_cache",
        "_parity",
        "_flags",
        "_packed",
        "_group",
        "_host",
        "nbytes",
    )

    def __init__(self, cache: ParityPlaneCache, parity_chunks, flags=None,
                 packed=None, group: int = 0):
        self._lk = threading.Lock()
        self._cache = cache
        self._parity = list(parity_chunks)
        self._flags = list(flags) if flags else None
        self._packed = list(packed) if packed else None
        self._group = int(group)
        self._host: "np.ndarray | None" = None
        plane = sum(int(p.numel()) * 4 for p in self._parity)
        self.nbytes = plane * (2 if self._packed is not None else 1)
        cache.add(self)

    def drain(self) -> np.ndarray:
        """(B, m, L) uint8 parity bytes, materialized at most once."""
        with self._lk:
            if self._host is None and self._parity is not None:
                self._host = self._drain_chunks()
                self._parity = None
                self._flags = None
                self._packed = None
                self._cache.forget(self)
            return self._host

    def release(self) -> None:
        """Drop an undrained plane without the transfer."""
        with self._lk:
            if self._parity is not None:
                self._parity = None
                self._flags = None
                self._packed = None
                self._cache.forget(self)

    def _drain_chunks(self) -> np.ndarray:
        """Per-chunk D2H through the fused1 drain bodies, concatenated
        along the length axis: the occupancy screen picks the packed
        prefix or the raw plane per chunk, so a sparse chunk of a dense
        plane still crosses the bus compressed."""
        parts = [
            (
                _DeviceParityRef._drain_precomputed(
                    p, self._flags[i], self._packed[i], self._group
                )
                if self._packed is not None
                else _DeviceParityRef._drain_screened(p)
            )
            for i, p in enumerate(self._parity)
        ]
        return np.concatenate(parts, axis=-1)


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

    def placement_router(self):
        """Submesh router for multi-slot placement, or None when the
        backend has no device set to carve (a single slot).  The batcher
        feature-detects this seam to route independent merged batches
        to disjoint submeshes."""
        return None


class TorchBackend(CodecBackend):
    """Device backend: the counterpart of the JAX package's TpuBackend.

    ``device`` is a torch.device (or its name).  On ``cuda`` every pass
    is a hand-written kernel (encode_pack, phash256_batched,
    gf_matmul_words, verify_reconstruct); on ``cpu`` the same passes run
    their plain PyTorch versions.

    ``devices`` pins a mesh of slots (repeats allowed: one slot is one
    virtual device), and ``device`` becomes its first.  Over more than
    one slot the passes run mesh-parallel (parallel.mesh): stripes over
    "stripe", the k data shards over "shard" with an XOR all-reduce,
    mirroring the reference's set- and disk-level fan-out (SURVEY.md
    section 2.4).  ``None`` keeps one slot on ``device``.  Set
    MINIO_MESH=0 to force the single-slot path.
    """

    name = "torch"
    fused_encode = True  # one encode_pack pass per batch

    def __init__(self, device="cuda", devices=None):
        self._devices = (
            tuple(torch.device(d) for d in devices)
            if devices is not None else None
        )
        if self._devices is not None:
            if not self._devices:
                raise ValueError("TorchBackend: devices= is empty")
            device = self._devices[0]
        self.device = torch.device(device)
        for d in self._base_devices():
            if d.type != self.device.type or d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported codec device {d}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: CUDA requested but torch.cuda.is_available()"
                " is False"
            )
        self._staging_lk = threading.Lock()
        self._pinned: "dict[torch.device, _PinnedStaging]" = {}
        self._meshes: "dict[tuple, object]" = {}
        self._router = None
        self._router_mu = threading.Lock()

    def _base_devices(self) -> tuple:
        return self._devices if self._devices is not None else (self.device,)

    def _home(self) -> torch.device:
        """The device of this thread's single-slot passes: the slot of a
        submesh the batcher routed here (parallel.rules.placed), else
        ``device``."""
        from ..parallel import rules as prules

        routed = prules.current_placement()
        return routed[0] if routed else self.device

    def _mesh_for(self, batch: int, k: int):
        """Pick a mesh for this call's geometry, or None for one slot.

        A submesh routed by the batcher (parallel.rules.placed) narrows
        the slots for this thread; otherwise the full base set spans.
        """
        if os.environ.get("MINIO_MESH", "1") == "0":
            return None
        from ..parallel import mesh as pm, rules as prules

        devices = prules.current_placement() or self._base_devices()
        if len(devices) <= 1:
            return None
        stripe, shard = pm.pick_axes(len(devices), batch, k)
        key = (tuple(str(d) for d in devices), stripe, shard)
        m = self._meshes.get(key)
        if m is None:
            m = pm.make_mesh(list(devices), stripe=stripe, shard=shard)
            self._meshes[key] = m
        return m

    def placement_router(self):
        devices = self._base_devices()
        if len(devices) <= 1:
            return None
        with self._router_mu:
            if self._router is None:
                from ..parallel import rules as prules

                self._router = prules.PlacementRouter(devices)
            return self._router

    def _stage(self, words_h: np.ndarray) -> torch.Tensor:
        t = codec_step.words_to_tensor(words_h, self._home())
        _record_h2d("data", words_h.nbytes)
        return t

    def _overlap(self) -> str:
        return codec_step.codec_overlap_mode(self.device)

    def _record_pipelined(self, plane: str, B: int, w: int,
                          formulation: str = "swar") -> None:
        """Overlap windows of one K5 (``put``) or K6 (``get``) launch of
        ``formulation`` (none on the CPU, where the plain version
        runs)."""
        if self.device.type == "cuda":
            windows = kernels.pipeline_windows(
                B, w, kernels.sm_count(self._home()), encode=plane == "put",
                mxu=formulation == "mxu",
            )
            if windows:
                _record_overlap(plane, windows)

    def encode(self, data, parity_shards):
        return self.encode_end(self.encode_begin(data, parity_shards))

    def encode_begin(self, data, parity_shards):
        """Eager-readback encode: the launch is asynchronous on the card,
        so the pass runs while the caller streams the previous batch.
        MINIO_TPU_CODEC_OVERLAP and MINIO_TPU_CODEC_FORMULATION do not
        touch this seam (heal's re-encode), as in the JAX package: the
        formulation is only read to check the knob.  Over several slots
        the mesh pass (parallel.mesh.mesh_encode_hash_begin) is queued
        the same way."""
        codec_step.codec_formulation()
        data = np.ascontiguousarray(data, dtype=np.uint8)
        B, k, L = data.shape
        mesh = self._mesh_for(B, k)
        if mesh is not None:
            from ..parallel import mesh as pm

            words_h = codec_step.host_bytes_to_words(data)
            _record_h2d("data", words_h.nbytes)
            h = pm.mesh_encode_hash_begin(mesh, words_h, parity_shards, L)
            _record_pass("mesh_encode_hash")
            return _AsyncHandle("async-mesh", h)
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
        if handle.kind == "async-mesh":
            from ..parallel import mesh as pm

            parity, digests = pm.mesh_encode_hash_end(handle.payload)
        elif handle.kind == "async":
            parity_w, digests_d = handle.payload
            parity = codec_step.tensor_to_words(parity_w)
            digests = codec_step.tensor_to_words(digests_d)
        else:
            raise ValueError(f"encode_end: unknown handle kind {handle.kind!r}")
        _record_d2h("parity", parity.nbytes)
        _record_d2h("data", digests.nbytes)
        handle.result = codec_step.host_words_to_bytes(parity), digests
        handle.consumed = True
        handle.payload = None  # drop the device refs
        return handle.result

    def encode_digest_begin(self, data, parity_shards):
        """Digest-only start: the encode launch also emits the occupancy
        flags and the nonzero-group prefix pack when the plane is
        packable, so the eventual drain launches nothing.  ``pipeline``
        runs K5 (K1 at m == 0); ``async`` runs the sub-chunk chain, or
        the serialized path when the batch is too small to cut S >= 3
        chunks.  MINIO_TPU_CODEC_FORMULATION picks the serialized
        pass's product; the sub-chunk chain stays ``swar``.  Under
        MINIO_TPU_CODEC_KERNEL=legacy: the digest encode alone (K1 without
        the pack leg), whatever the overlap mode or formulation; the
        drain screens the plane (``"digest"`` handle).  Over several
        slots, whatever the kernel mode: the eager mesh encode."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        B, k, L = data.shape
        if self._mesh_for(B, k) is not None:
            if self._overlap() != "off":
                # overlap sub-chunking would fight the mesh "seq" axis
                # for the stripe-length dimension: warn once, fall back
                # to the serialized (bit-identical) mesh path
                from ..parallel import mesh as pm

                pm.warn_overlap_fallback()
            # the mesh path keeps no device-resident parity plane (its
            # planes live across slots): compose the eager seam, still
            # queued through the mesh begin/end split
            return _AsyncHandle(
                "digest-eager", self.encode_begin(data, parity_shards)
            )
        if codec_step.codec_kernel_mode() == "legacy":
            # the JAX package's encode_and_hash_words_digest: parity and
            # digests only, the drain screens the plane
            words = self._stage(codec_step.host_bytes_to_words(data))
            parity_w, digests, _f, _p = codec_step.encode_words_fused1(
                words, parity_shards, L
            )
            _record_pass("encode_and_hash_words_digest")
            return _AsyncHandle("digest", (parity_w, digests))
        formulation = codec_step.codec_formulation()
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
        words_h = codec_step.host_bytes_to_words(data)
        overlap = self._overlap()
        if overlap == "async":
            handle = self._encode_subchunk_begin(
                words_h, parity_shards, L, group
            )
            if handle is not None:
                return handle
        words = self._stage(words_h)
        pipeline = overlap == "pipeline"
        parity_w, digests, flags_d, packed_d = codec_step.encode_words_fused1(
            words, parity_shards, L, group=group, pipeline=pipeline,
            formulation=formulation,
        )
        _record_pass("encode_words_fused1")
        if pipeline and parity_shards > 0:
            self._record_pipelined("put", B, w, formulation)
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

    def _chain_stage(self, src: np.ndarray, slot: int) -> torch.Tensor:
        """One sub-chunk H2D of the async chain: through the pinned
        ping-pong slots and the copy stream on the card; a copy on the
        CPU."""
        _record_h2d("data", src.nbytes)
        if self.device.type == "cpu":
            return codec_step.words_to_tensor(np.ascontiguousarray(src), "cpu")
        return self._staging().h2d(src, slot)

    def _staging(self) -> _PinnedStaging:
        dev = self._home()
        with self._staging_lk:
            if dev not in self._pinned:
                self._pinned[dev] = _PinnedStaging(dev)
            return self._pinned[dev]

    def _chain_lock(self):
        """Serializes chains over the shared pinned slots (none on the
        CPU, where each chunk is its own copy)."""
        if self.device.type == "cuda":
            return self._staging().lock
        return contextlib.nullcontext()

    def _encode_subchunk_begin(self, words_h, parity_shards, shard_len, group):
        """MINIO_TPU_CODEC_OVERLAP=async PUT: split the stripe batch along
        w into S sub-chunks; chunk s+1's H2D (pinned slot, copy stream)
        overlaps chunk s's K1 pass, whose accumulator carries the
        phash256 partials; the LAST chunk's launch finalizes the digests.

        Returns the in-flight handle, or None when the batch is too small
        to cut S >= 3 chunks (the caller takes the serialized path).
        """
        from .erasure import subchunk_words

        B, k, w = words_h.shape
        m = parity_shards
        cw = subchunk_words(w, group if group else 8)
        if not cw:
            return None
        offs = list(range(0, w, cw))
        reserved = _stage_reserve(2 * B * k * cw * 4)
        try:
            with self._chain_lock():
                acc = torch.zeros(
                    (B, k + m, 8), dtype=torch.int32, device=self._home()
                )
                parity_c, flags_c, packed_c = [], [], []
                for i, off in enumerate(offs):
                    chunk = self._chain_stage(
                        words_h[:, :, off:off + cw], i % 2
                    )
                    p_c, acc, f_c, pk_c = codec_step.encode_subchunk_words(
                        chunk, acc, off, m, shard_len, group=group,
                        finalize=i == len(offs) - 1,
                    )
                    _record_pass("encode_subchunk_words")
                    parity_c.append(p_c)
                    if group:
                        flags_c.append(f_c)
                        packed_c.append(pk_c)
            _record_overlap("put", len(offs) - 1)
        except BaseException:
            _stage_release(reserved)
            raise
        return _AsyncHandle(
            "digest-subchunk",
            (parity_c, acc, flags_c or None, packed_c or None, group, reserved),
        )

    def encode_digest_end(self, handle):
        if not isinstance(handle, _AsyncHandle) or handle.kind not in (
            "digest", "digest-fused1", "digest-subchunk", "digest-eager",
        ):
            return super().encode_digest_end(handle)
        if handle.consumed:
            return handle.result
        if handle.kind == "digest-eager":
            parity, digests = self.encode_end(handle.payload)
            handle.result = (
                np.asarray(digests),
                _EagerParityRef(np.ascontiguousarray(parity, dtype=np.uint8)),
            )
            handle.consumed = True
            handle.payload = None
            return handle.result
        # digests are the ONLY eager readback; parity, flags and packed
        # stay device-resident behind the ref
        if handle.kind == "digest":
            parity_w, digests_d = handle.payload
            digests = codec_step.tensor_to_words(digests_d)
            _record_d2h("data", digests.nbytes)
            ref = _DeviceParityRef(parity_plane_cache(), parity_w)
        elif handle.kind == "digest-fused1":
            parity_w, digests_d, flags_d, packed_d, group = handle.payload
            digests = codec_step.tensor_to_words(digests_d)
            _record_d2h("data", digests.nbytes)
            ref = _DeviceParityRef(
                parity_plane_cache(), parity_w, flags=flags_d,
                packed=packed_d, group=group,
            )
        else:
            parity_c, digests_d, flags_c, packed_c, group, reserved = (
                handle.payload
            )
            # the staging reservation drops even when the digest D2H
            # throws: it must not strand ledger bytes for the process
            try:
                digests = codec_step.tensor_to_words(digests_d)
                _record_d2h("data", digests.nbytes)
            finally:
                _stage_release(reserved)
            ref = _SubchunkParityRef(
                parity_plane_cache(), parity_c, flags=flags_c,
                packed=packed_c, group=group,
            )
        handle.result = (digests, ref)
        handle.consumed = True
        handle.payload = None
        return handle.result

    def parity_cache_pressure(self) -> float:
        return parity_cache_pressure()

    def reconstruct(self, shards, present, data_shards, parity_shards):
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        mesh = self._mesh_for(shards.shape[0], data_shards)
        if mesh is not None:
            from ..parallel import mesh as pm

            words_h = codec_step.host_bytes_to_words(shards)
            _record_h2d("data", words_h.nbytes)
            dw = pm.mesh_reconstruct(
                mesh, words_h, tuple(bool(b) for b in present), data_shards,
                parity_shards,
            )
            _record_pass("mesh_reconstruct")
            _record_d2h("data", dw.nbytes)
            return codec_step.host_words_to_bytes(dw)
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
        B, n, L = shards.shape
        mesh = self._mesh_for(B * n, 1)
        if mesh is not None:
            from ..parallel import mesh as pm

            flat = codec_step.host_bytes_to_words(shards).reshape(B * n, -1)
            _record_h2d("data", flat.nbytes)
            _record_pass("mesh_digest")
            out = pm.mesh_digest(mesh, flat, L).reshape(B, n, 8)
            _record_d2h("data", out.nbytes)
            return out
        words = self._stage(codec_step.host_bytes_to_words(shards))
        got = codec_step.digest_words_batched(words, L)
        _record_pass("phash256_words_batched")
        out = codec_step.tensor_to_words(got)
        _record_d2h("data", out.nbytes)
        return out

    def reconstruct_and_verify(
        self, shards, digests, present, data_shards, parity_shards
    ):
        """Heal's read side in ONE device pass per batch: decode from the
        first k present rows while hashing every present row (K4; K6
        under ``pipeline``; the sub-chunk chain under ``async``).  On the
        rare digest mismatch among the chosen survivors, re-pick
        survivors from the verified mask and re-solve just the hit
        stripes (through gf_matmul_words).  MINIO_TPU_CODEC_FORMULATION
        picks the serialized pass's product; the sub-chunk chain and the
        re-solve stay ``swar``.  Under MINIO_TPU_CODEC_KERNEL=legacy the
        base class composes the separate passes instead, whatever the
        overlap mode: verify (K2 and a compare), then reconstruct (K3).
        Over several slots: the mesh pass (K4 once a stripe group), whatever
        the overlap mode or formulation."""
        if codec_step.codec_kernel_mode() == "legacy":
            return super().reconstruct_and_verify(
                shards, digests, present, data_shards, parity_shards
            )
        formulation = codec_step.codec_formulation()
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        pres = np.asarray(present, dtype=bool)
        B, _n, L = shards.shape
        present_t = tuple(bool(b) for b in pres)
        words_h = codec_step.host_bytes_to_words(shards)
        overlap = self._overlap()
        got = None
        mesh = self._mesh_for(B, data_shards)
        if mesh is not None:
            from ..parallel import mesh as pm

            if overlap != "off":
                pm.warn_overlap_fallback()
            _record_h2d("data", words_h.nbytes)
            got = pm.mesh_verify_reconstruct(
                mesh, words_h, np.asarray(digests), present_t, data_shards,
                parity_shards, L,
            )
            _record_pass("mesh_verify_reconstruct")
            _record_d2h("data", got[0].nbytes)
        elif overlap == "async":
            got = self._drain_vr_subchunks(
                words_h, digests, present_t, data_shards, parity_shards, L
            )
        if got is not None:
            dw, ok = got
        else:
            words = self._stage(words_h)
            stored = codec_step.words_to_tensor(
                np.ascontiguousarray(digests, dtype=np.uint32), words.device
            )
            pipeline = overlap == "pipeline"
            dw_d, ok_d = codec_step.verify_and_reconstruct_words(
                words, stored, present_t, data_shards, parity_shards, L,
                pipeline=pipeline, formulation=formulation,
            )
            _record_pass("verify_and_reconstruct_words")
            if pipeline:
                self._record_pipelined("get", B, L // 4)
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

    def _drain_vr_subchunks(
        self, words_h, digests, present, data_shards, parity_shards, shard_len
    ):
        """MINIO_TPU_CODEC_OVERLAP=async heal read side: the sub-chunked
        verify+reconstruct chain.  Chunk s+1's H2D (pinned slot, copy
        stream) overlaps chunk s's K4 pass, which overlaps chunk s-1's
        D2H into a pinned output slot on the D2H stream; the partials
        thread through the accumulator and the LAST chunk's launch
        finalizes them for the verify mask.

        Returns (data words (B, k, w), ok (B, n) bool), or None when the
        batch is too small to cut S >= 3 chunks.
        """
        from .erasure import subchunk_words

        B, n, w = words_h.shape
        cw = subchunk_words(w, 8)
        if not cw:
            return None
        offs = list(range(0, w, cw))
        out = np.empty((B, data_shards, w), dtype=np.uint32)
        reserved = _stage_reserve(2 * B * n * cw * 4)
        try:
            with self._chain_lock():
                digests_d = codec_step.words_to_tensor(
                    np.ascontiguousarray(digests, dtype=np.uint32),
                    self._home(),
                )
                acc = torch.zeros((B, n, 8), dtype=torch.int32,
                                  device=digests_d.device)
                pending = None
                for i, off in enumerate(offs):
                    chunk = self._chain_stage(
                        words_h[:, :, off:off + cw], i % 2
                    )
                    d_c, acc, ok_d = (
                        codec_step.verify_reconstruct_subchunk_words(
                            chunk, acc, digests_d, off, present, data_shards,
                            parity_shards, shard_len,
                            finalize=i == len(offs) - 1,
                        )
                    )
                    _record_pass("verify_reconstruct_subchunk_words")
                    started = (off, self._chain_d2h_start(d_c, i % 2))
                    if pending is not None:
                        # chunk i-1 drains while chunk i computes
                        self._chain_d2h_finish(out, pending)
                    pending = started
                self._chain_d2h_finish(out, pending)
                ok = ok_d.cpu().numpy()
            _record_overlap("get", len(offs) - 1)
        finally:
            _stage_release(reserved)
        return out, ok

    def _chain_d2h_start(self, d_c: torch.Tensor, slot: int):
        if self.device.type == "cpu":
            return d_c
        return self._staging().d2h_start(d_c, slot)

    def _chain_d2h_finish(self, out: np.ndarray, pending) -> None:
        off, started = pending
        if self.device.type == "cpu":
            part = codec_step.tensor_to_words(started)
        else:
            part = _PinnedStaging.d2h_finish(started)
        out[:, :, off:off + part.shape[-1]] = part
        _record_d2h("data", part.nbytes)


_lock = threading.Lock()
_backends: "dict[str, CodecBackend]" = {}


def get_backend(device="cuda") -> CodecBackend:
    """The process-wide codec backend of one device: TorchBackend wrapped
    in telemetry and cross-request batching (MINIO_CODEC_BATCH).

    ``device`` defaults to the card; building it raises where
    torch.cuda.is_available() is False.  There is no auto mode.  On the
    card the backend's slots are every visible CUDA device, ``device``
    first (the JAX package's TpuBackend takes jax.devices()): one slot
    on a one-GPU machine, the mesh path on a larger one."""
    from .batcher import maybe_wrap
    from .telemetry import instrument

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    key = str(dev)
    with _lock:
        be = _backends.get(key)
        if be is None:
            devices = None
            if dev.type == "cuda":
                devices = (dev,) + tuple(
                    torch.device("cuda", i)
                    for i in range(torch.cuda.device_count()) if i != dev.index
                )
            be = maybe_wrap(instrument(TorchBackend(dev, devices=devices)))
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
