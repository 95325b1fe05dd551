"""Erasure: streaming shard-geometry wrapper over the codec backend.

The counterpart of the reference's Erasure type (cmd/erasure-coding.go:28-143
shard math, cmd/erasure-encode.go Encode, cmd/erasure-decode.go Decode) -
redesigned around batched device passes instead of a per-block CPU loop:

* The object stream is cut into ``block_size`` blocks (blockSizeV1 = 10 MiB
  in the reference, cmd/object-api-common.go:31) and BATCHES of blocks are
  encoded/hashed in one fused device pass (ops/codec_step), amortizing
  launch overhead and keeping the device queue full.
* Shard files use the interleaved bitrot framing of bitrot-streaming.go:
  [32B digest][shard block]... with blocks zero-padded to 32B (device
  alignment); true lengths are recovered from the object size.

Writers/readers are any objects with ``write(bytes) -> None`` /
``read_at(offset, length) -> bytes`` (storage-layer bitrot streams); a
None writer/reader is an offline disk, tolerated down to the quorum.

* Heal (cmd/erasure-lowlevel-heal.go) rebuilds missing shard files one
  block at a time: one fused verify+reconstruct pass over the survivors,
  then the re-encode of the rebuilt data.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time

import numpy as np

from . import backend as backend_mod, bitrot, compress
from .telemetry import KERNEL_STATS
from ..parallel import iopool
from ..storage import health as disk_health
from ..utils.log import kv, logger

_log = logger("codec")

BLOCK_SIZE_V1 = 10 * 1024 * 1024  # reference blockSizeV1
DEFAULT_BATCH_BLOCKS = 4

# read-ahead jobs carry a fresh sequence key so concurrent GETs spread
# across pool queues instead of serializing behind one worker
_RA_SEQ = itertools.count()

# stage accounting from iopool workers (frame assembly runs on the
# writer's queue, not the submitting thread)
_STAGE_LK = threading.Lock()


def _codec_stage(be) -> str:
    """Stage key for encode time: backends whose encode() computes
    parity + digests in one fused pass book under "codec_fused" so the
    stage breakdown shows what the fusion bought; other encodes stay
    under "codec" alongside decode/verify time."""
    return "codec_fused" if getattr(be, "fused_encode", False) else "codec"


def _io_key(obj):
    """Routing key for a writer/reader: the object layer stamps disks
    with a stable endpoint ``io_key``; untagged test doubles hash by
    identity (still one ordered queue per instance)."""
    return getattr(obj, "io_key", None) or ("anon", id(obj))


def _parity_plane_on() -> bool:
    """MINIO_TPU_PARITY_PLANE = on|off (default on): route PUT encodes
    through the digest-only seam so parity stays device-resident until
    the writers pull it (codec/backend.py).  "off" restores the legacy
    eager encode_end readback."""
    return os.environ.get("MINIO_TPU_PARITY_PLANE", "on") != "off"


def subchunk_words(w: int, quantum: int) -> int:
    """Sub-chunk size in uint32 words for the async overlap chain
    (MINIO_TPU_CODEC_OVERLAP=async), or 0 when the batch is too small.

    MINIO_TPU_CODEC_SUBCHUNK_KB (default 256 KiB of shard bytes per
    sub-chunk; a value that does not parse falls back to it) is rounded
    down to a multiple of ``quantum`` words - the parity pack group when
    the pack leg is on, the hash partition stride otherwise - so chunk
    cuts land on group AND partition boundaries and the per-chunk math
    composes bit-identically.  The chain engages only at S >= 3 full
    chunks: below that the ping-pong staging cannot amortize its second
    buffer and the serialized path is strictly better.
    """
    try:
        kb = float(os.environ.get("MINIO_TPU_CODEC_SUBCHUNK_KB") or 256)
    except ValueError:
        kb = 256.0
    q = max(int(quantum), 1)
    cw = max(q, (int(kb * 256) // q) * q)  # KiB -> u32 words, quantized
    if w // cw < 3:
        return 0
    return cw


class _Begun:
    """One begun encode group: the SINGLE consume point for its handle.

    The success path calls ``end``/``end_digest`` exactly once; the
    error path calls ``cleanup``, which is a no-op for already-consumed
    records and otherwise ends the handle (releasing an undrained
    parity ref without paying the D2H).  The consumed flag replaces the
    old ``started[i] = None`` sentinel bookkeeping, so cleanup can
    never double-consume or leak a device handle no matter which
    iteration of the flush loop failed.
    """

    __slots__ = (
        "handle", "batch", "digest_mode", "consumed", "start_block"
    )

    def __init__(self, handle, batch, digest_mode: bool,
                 start_block: int = 0):
        self.handle = handle
        self.batch = batch
        self.digest_mode = digest_mode
        self.consumed = False
        # absolute index of the group's first object block: the read
        # cache keys groups by (first_block, g, shard_len), so the PUT
        # populate and the GET lookup must agree on block coordinates
        self.start_block = start_block

    def end(self, be):
        self.consumed = True
        return be.encode_end(self.handle)

    def end_digest(self, be):
        self.consumed = True
        return be.encode_digest_end(self.handle)

    def cleanup(self, be) -> None:
        if self.consumed:
            return
        self.consumed = True
        try:
            if self.digest_mode:
                _digests, ref = be.encode_digest_end(self.handle)
                ref.release()
            else:
                be.encode_end(self.handle)
        except Exception as exc:
            _log.debug(
                "encode handle cleanup failed", extra=kv(err=str(exc))
            )


class _ReaderBank:
    """Lazy shard-reader list for the decode path.

    ``source`` is either the reader list itself or a zero-arg callable
    producing it.  A GET whose every group hits the read cache never
    calls ``get`` - the shard streams are never opened, so a cache hit
    makes ZERO disk calls.  The list is materialized at most once and
    padded to ``n`` slots; the quorum reader's in-place
    ``readers[s] = None`` death marks persist across batches.
    """

    __slots__ = ("_source", "_list")

    def __init__(self, source):
        if callable(source):
            self._source = source
            self._list = None
        else:
            self._source = None
            self._list = list(source)

    def get(self, n: int) -> list:
        if self._list is None:
            self._list = list(self._source())
        while len(self._list) < n:
            self._list.append(None)
        return self._list


def _fanout_reads(fn, slots: list, readers, nbytes: int) -> list:
    """Run ``fn(slot)`` for every slot through the shared iopool, one
    job per shard.  ``fn`` must capture its own errors - a reader
    failure is data (a dead shard), not an exception."""
    if len(slots) <= 1:
        return [fn(s) for s in slots]
    pool = iopool.get_pool()
    futs = [
        pool.submit(_io_key(readers[s]), (lambda s=s: fn(s)), nbytes=nbytes)
        for s in slots
    ]
    return [f.result_or_raise() for f in futs]


class ErasureError(Exception):
    pass


class QuorumError(ErasureError):
    """Fewer healthy shards than required (errXLReadQuorum/WriteQuorum)."""


@dataclasses.dataclass(frozen=True)
class Erasure:
    """Shard geometry + streaming codec ops for one erasure config."""

    data_blocks: int
    parity_blocks: int
    block_size: int = BLOCK_SIZE_V1

    def __post_init__(self):
        if not (1 <= self.data_blocks <= 16):
            raise ValueError(f"dataBlocks {self.data_blocks} out of range")
        if not (0 <= self.parity_blocks <= 16):
            raise ValueError(f"parityBlocks {self.parity_blocks} out of range")
        if self.block_size <= 0:
            raise ValueError("blockSize must be positive")

    @property
    def total_shards(self) -> int:
        return self.data_blocks + self.parity_blocks

    # ---- shard math (cmd/erasure-coding.go:115-143 semantics + padding) --

    def shard_size(self, block_len: "int | None" = None) -> int:
        """Unpadded shard length for one object block (ShardSize)."""
        if block_len is None:
            block_len = self.block_size
        return -(-block_len // self.data_blocks)

    def shard_size_padded(self, block_len: "int | None" = None) -> int:
        """Device-aligned shard length actually encoded and stored."""
        return bitrot.padded_len(self.shard_size(block_len))

    def block_count(self, total_length: int) -> int:
        if total_length == 0:
            return 0
        return -(-total_length // self.block_size)

    def shard_block_offset(self, block_index: int) -> int:
        """Framed offset of block_index within every shard file."""
        return block_index * bitrot.frame_size(self.shard_size())

    def _block_len(self, block_index: int, total_length: int) -> int:
        start = block_index * self.block_size
        return min(self.block_size, total_length - start)

    # ---- streaming encode (cmd/erasure-encode.go:73-109) ----------------

    def encode(
        self,
        reader,
        writers: list,
        write_quorum: int,
        batch_blocks: int = DEFAULT_BATCH_BLOCKS,
        backend: "backend_mod.CodecBackend | None" = None,
        cache_ctx=None,
    ) -> int:
        """Stream from ``reader`` (has .read(n)) into framed shard writers.

        Batches of blocks share one device pass.  Returns total bytes
        consumed.  Raises QuorumError when healthy writers drop below
        write_quorum (the parallelWriter quorum reduction,
        erasure-encode.go:39-70).  With a ``cache_ctx`` every group's
        data rows and digest words populate the read cache before its
        shard writes go out.
        """
        be = backend or backend_mod.get_backend()
        digest_mode = _parity_plane_on() and self.parity_blocks > 0
        total = 0
        eof = False
        # quorum-aware shard fan-out: one ordered pool queue per disk,
        # flush() returns at write_quorum acks, stragglers drain in the
        # background (parallelWriter, erasure-encode.go:39-70)
        flusher = iopool.ShardFlusher(
            iopool.get_pool(), quorum_exc=QuorumError
        )
        stages = {
            "assemble": 0.0, "codec": 0.0, "codec_fused": 0.0,
            "codec_drain": 0.0, "disk": 0.0,
        }
        # double-buffered pipeline (erasure-encode.go:73-109 overlap,
        # SURVEY stage 8): batch k's H2D + device pass is in flight
        # while batch k-1's shards stream to disk/network; exactly one
        # batch pending bounds memory at 2 batches
        pending = None
        blocks_done = 0
        try:
            while not eof:
                blocks: list[bytes] = []
                while len(blocks) < batch_blocks and not eof:
                    buf = _read_full(reader, self.block_size)
                    if not buf:
                        eof = True
                        break
                    if len(buf) < self.block_size:
                        eof = True
                    blocks.append(buf)
                    total += len(buf)
                if not blocks:
                    break
                started = self._encode_begin_batch(
                    be, blocks, stages, digest_mode,
                    base_block=blocks_done,
                )
                blocks_done += len(blocks)
                blocks = None  # scattered into the batch arrays above
                if pending is not None:
                    try:
                        self._flush_batch(
                            be, pending, writers, write_quorum,
                            flusher, stages, cache_ctx,
                        )
                    finally:
                        pending = started
                else:
                    pending = started
            if pending is not None:
                p, pending = pending, None
                self._flush_batch(
                    be, p, writers, write_quorum, flusher, stages,
                    cache_ctx,
                )
            # early-acked batches may still have stragglers in flight:
            # settle them and re-check the quorum over the final disk
            # liveness picture before declaring the object durable
            t0 = time.monotonic()
            for s in flusher.drain():
                if s < len(writers):
                    writers[s] = None
            stages["disk"] += time.monotonic() - t0
            if flusher.submitted:
                alive = sum(1 for w in writers if w is not None)
                if alive < write_quorum:
                    raise QuorumError(
                        f"write quorum lost: {alive} < {write_quorum}"
                    )
            KERNEL_STATS.record_stream("encode", total)
            KERNEL_STATS.record_stages("put", stages)
            return total
        finally:
            # an error mid-flush must not abandon begun handles: a
            # batching backend counts them active until ended, so a
            # leak would degrade every later codec call
            for rec in pending or []:
                rec.cleanup(be)
            # nor may background shard writes race the caller closing
            # its writers: settle the pool before handing back
            for s in flusher.drain():
                if s < len(writers):
                    writers[s] = None

    def _encode_begin_batch(self, be, blocks, stages, digest_mode=False,
                            base_block=0):
        """Kick off the device passes for one batch of blocks; returns
        a list of _Begun records, one per uniform-shard-size group."""
        k = self.data_blocks
        m = self.parity_blocks
        # uniform batch: all blocks but possibly the last share shard size
        groups: list[tuple[int, int, list[bytes]]] = []
        full = [b for b in blocks if len(b) == self.block_size]
        tail = [b for b in blocks if len(b) != self.block_size]
        if full:
            groups.append((self.shard_size_padded(), base_block, full))
        for b in tail:
            # a short read ends the stream, so the tail block is always
            # the batch's last - its absolute index follows the fulls
            groups.append(
                (self.shard_size_padded(len(b)), base_block + len(full),
                 [b])
            )
        started = []
        for shard_len, group_block, group in groups:
            t0 = time.monotonic()
            batch = np.zeros((len(group), k, shard_len), dtype=np.uint8)
            for bi, block in enumerate(group):
                # one reshape scatters the whole block across its k
                # shard rows (the per-shard slice loop was O(k) tiny
                # copies per block)
                ss = self.shard_size(len(block))
                a = np.frombuffer(block, dtype=np.uint8)
                rows, rem = divmod(len(a), ss)
                if rows:
                    batch[bi, :rows, :ss] = a[: rows * ss].reshape(
                        rows, ss
                    )
                if rem:
                    batch[bi, rows, :rem] = a[rows * ss :]
            stages["assemble"] += time.monotonic() - t0
            t0 = time.monotonic()
            handle = (
                be.encode_digest_begin(batch, m)
                if digest_mode
                else be.encode_begin(batch, m)
            )
            started.append(
                _Begun(handle, batch, digest_mode, group_block)
            )
            stages[_codec_stage(be)] += time.monotonic() - t0
        return started

    def _flush_batch(
        self, be, started, writers, write_quorum, flusher, stages,
        cache_ctx=None,
    ) -> None:
        k, m = self.data_blocks, self.parity_blocks
        n = k + m
        try:
            self._flush_groups(
                be, started, writers, write_quorum, k, n, flusher, stages,
                cache_ctx,
            )
        except BaseException:
            # end the groups the failed iteration never reached
            # (batching backends count begun handles as active);
            # _Begun.cleanup skips consumed records, so this can never
            # double-end a handle the loop already materialized
            for rec in started:
                rec.cleanup(be)
            raise

    @staticmethod
    def _run_writer(w, dig_s, src, col, ds, stages):
        """Build the write job for one disk's byte run.  The interleave
        itself executes ON the iopool worker, and the closure pins only
        what this disk actually reads — its digest column plus EITHER
        the data batch OR the parity array — so a straggler generation
        costs one shared array, never per-disk copies."""
        def _job():
            t0 = time.monotonic()
            shard = src[:, col, :]
            B = shard.shape[0]
            run = np.empty((B, ds + shard.shape[1]), dtype=np.uint8)
            run[:, :ds] = dig_s
            run[:, ds:] = shard
            dt = time.monotonic() - t0
            with _STAGE_LK:
                stages["assemble"] += dt
            # hand the writer a view, not a bytes copy: every write
            # path (file, REST pipe, test shards) copies on its own
            # terms, so the run is never duplicated wholesale
            w.write(run.reshape(-1).data)
        return _job

    @staticmethod
    def _run_parity_writer(w, dig_s, pref, col, ds, stages):
        """Parity twin of _run_writer for the digest-only path: the
        closure pins the ParityRef, not host bytes.  The first parity
        job to run pays the (memoized, possibly device-compressed) lazy
        drain on its own iopool worker — behind the data-quorum ack —
        and the sibling parity disks reuse the materialized plane."""
        def _job():
            t0 = time.monotonic()
            par = pref.drain()
            dt = time.monotonic() - t0
            with _STAGE_LK:
                stages["codec_drain"] += dt
            t0 = time.monotonic()
            shard = par[:, col, :]
            B = shard.shape[0]
            run = np.empty((B, ds + shard.shape[1]), dtype=np.uint8)
            run[:, :ds] = dig_s
            run[:, ds:] = shard
            dt = time.monotonic() - t0
            with _STAGE_LK:
                stages["assemble"] += dt
            w.write(run.reshape(-1).data)
        return _job

    def _flush_groups(
        self, be, started, writers, write_quorum, k, n, flusher, stages,
        cache_ctx=None,
    ) -> None:
        """Assemble each disk's contiguous byte run for the whole batch
        with one numpy interleave (digest frames + payload rows) and
        fan the n runs out through the iopool — ONE buffer per disk per
        batch, the write twin of the one-ranged-read-per-shard GET.

        Digest-mode records materialize ONLY the digests here (all the
        metadata/ack path needs); their parity crosses the bus lazily
        inside the parity writers' jobs via the ParityRef."""
        jobs = []
        for rec in started:
            batch = rec.batch
            t0 = time.monotonic()
            if rec.digest_mode:
                digests, pref = rec.end_digest(be)
                par = None
            else:
                parity, digests = rec.end(be)
                par = np.asarray(parity, dtype=np.uint8)
                pref = None
            stages[_codec_stage(be)] += time.monotonic() - t0
            t0 = time.monotonic()
            B, shard_len = batch.shape[0], batch.shape[2]
            ds = bitrot.DIGEST_SIZE
            # digest words -> 32B frames, all (block, shard) cells at
            # once; byte layout matches bitrot.digest_to_bytes
            dig_u32 = np.ascontiguousarray(digests, dtype=np.uint32)
            dig = dig_u32.view(np.uint8).reshape(B, n, ds)
            stages["assemble"] += time.monotonic() - t0
            if cache_ctx is not None:
                # PUT population: the batch's data rows + their digest
                # words, before any disk write settles - the next GET
                # for this object never touches the quorum path
                cache_ctx.populate_from_encode(
                    rec.start_block, batch,
                    dig_u32.reshape(B, n, 8)[:, :k],
                )
            for s in range(n):
                w = writers[s] if s < len(writers) else None
                if w is None:
                    continue
                if s >= k and pref is not None:
                    fn = self._run_parity_writer(
                        w, dig[:, s, :], pref, s - k, ds, stages
                    )
                else:
                    fn = self._run_writer(
                        w,
                        dig[:, s, :],
                        batch if s < k else par,
                        s if s < k else s - k,
                        ds,
                        stages,
                    )
                jobs.append((s, _io_key(w), fn, B * (ds + shard_len)))
        alive = {s for s, _key, _fn, _nb in jobs}
        if len(alive) < write_quorum:
            raise QuorumError(
                f"write quorum lost: {len(alive)} < {write_quorum}"
            )
        t0 = time.monotonic()
        dead = flusher.flush(jobs, write_quorum)
        stages["disk"] += time.monotonic() - t0
        for s in dead:
            if s < len(writers):
                writers[s] = None

    # ---- streaming decode (cmd/erasure-decode.go:211-290) ---------------

    def decode(
        self,
        writer,
        readers: list,
        offset: int,
        length: int,
        total_length: int,
        batch_blocks: int = DEFAULT_BATCH_BLOCKS,
        backend: "backend_mod.CodecBackend | None" = None,
        cache_ctx=None,
    ) -> tuple[int, bool]:
        """Reconstruct [offset, offset+length) into ``writer``.

        ``readers`` is the shard reader list, one slot per shard (None
        for an offline disk), OR a zero-arg callable producing it (lazy
        open: with a ``cache_ctx`` whose groups all hit, the readers are
        never opened at all).

        Returns (bytes_written, heal_required): heal_required is set when
        any shard was missing or failed bitrot verification but quorum
        still allowed reconstruction (errHealRequired semantics,
        erasure-decode.go:165-167).
        """
        stages = {"assemble": 0.0, "codec": 0.0, "disk": 0.0}
        written, heal_required = self._decode_stream(
            writer, readers, offset, length, total_length,
            batch_blocks, backend, stages, cache_ctx,
        )
        KERNEL_STATS.record_stream("decode", written)
        KERNEL_STATS.record_stages("get", stages)
        if heal_required:
            KERNEL_STATS.record_heal_required()
        return written, heal_required

    def _decode_stream(
        self,
        writer,
        readers: list,
        offset: int,
        length: int,
        total_length: int,
        batch_blocks: int = DEFAULT_BATCH_BLOCKS,
        backend: "backend_mod.CodecBackend | None" = None,
        stages: "dict | None" = None,
        cache_ctx=None,
    ) -> tuple[int, bool]:
        if length == 0:
            return 0, False
        if offset < 0 or length < 0 or offset + length > total_length:
            raise ValueError("range out of bounds")
        be = backend or backend_mod.get_backend()
        # one list for the whole stream, opened at most once: the quorum
        # reader's in-place ``readers[s] = None`` death marks persist
        # across batches
        bank = _ReaderBank(readers)
        start_block = offset // self.block_size
        end_block = (offset + length - 1) // self.block_size
        batches: "list[list[int]]" = []
        bi = start_block
        while bi <= end_block:
            batch_idx = list(
                range(bi, min(bi + batch_blocks, end_block + 1))
            )
            batches.append(batch_idx)
            bi += len(batch_idx)
        written = 0
        heal_required = False
        if len(batches) <= 1:
            for batch_idx in batches:
                datas, healed = self._decode_blocks(
                    be, bank, batch_idx, total_length, stages, cache_ctx
                )
                heal_required = heal_required or healed
                w, done = self._write_blocks(
                    writer, datas, batch_idx, offset, length,
                    total_length,
                )
                written += w
                if done:
                    return written, heal_required
            return written, heal_required
        # read-ahead pipeline (the GET twin of the encode double
        # buffer): batch k+1's shard reads + verify + reconstruct run
        # on an iopool worker while batch k streams to the client —
        # now unconditionally: local reads also fan out per disk, so
        # the prefetch overlaps the decode device pass with the next
        # group's reads just like encode double-buffers its flush.
        # Exactly one prefetch is in flight, so _decode_blocks never
        # runs concurrently with itself (it mutates `readers`).
        pool = iopool.get_pool()
        fut = None
        try:
            # aux band: the prefetch BLOCKS on leaf read futures, so it
            # must never occupy (or queue behind) a disk queue worker
            fut = pool.submit(
                ("readahead", next(_RA_SEQ)),
                lambda b=batches[0]: self._decode_blocks(
                    be, bank, b, total_length, stages, cache_ctx
                ),
                aux=True,
            )
            for i, batch_idx in enumerate(batches):
                datas, healed = fut.result_or_raise()
                fut = None
                heal_required = heal_required or healed
                if i + 1 < len(batches):
                    fut = pool.submit(
                        ("readahead", next(_RA_SEQ)),
                        lambda b=batches[i + 1]: self._decode_blocks(
                            be, bank, b, total_length, stages, cache_ctx
                        ),
                        aux=True,
                    )
                w, done = self._write_blocks(
                    writer, datas, batch_idx, offset, length,
                    total_length,
                )
                datas = None  # release batch k before blocking on k+1
                written += w
                if done:
                    return written, heal_required
            return written, heal_required
        finally:
            # an early return (RangeSatisfied, client gone) must not
            # leave the prefetch racing the caller's reader close -
            # drain the in-flight read before handing back
            if fut is not None:
                fut.wait()
                if fut.error is not None:
                    _log.debug("prefetch drain after early return", extra=kv(err=str(fut.error)))

    def _write_blocks(
        self, writer, datas, batch_idx, offset, length, total_length
    ) -> "tuple[int, bool]":
        """Stream one decoded batch's range slices; (written, done)
        where done means a skipping decrypt/decompress writer downstream
        has its full range (RangeSatisfied - stop paying decode I/O, but
        keep the heal verdict observed so far: losing it would mask
        bitrot on range reads)."""
        written = 0
        for j, block_index in enumerate(batch_idx):
            block_start = block_index * self.block_size
            block_len = self._block_len(block_index, total_length)
            lo = max(offset, block_start) - block_start
            hi = (
                min(offset + length, block_start + block_len)
                - block_start
            )
            if hi > lo:
                # memoryview slice: the decoded block goes to the sink
                # without the copy a bytes slice would make
                try:
                    writer.write(memoryview(datas[j])[lo:hi])
                except compress.RangeSatisfied:
                    return written, True
                written += hi - lo
        return written, False

    def _decode_blocks(
        self, be, bank: "_ReaderBank", block_indices: list[int],
        total_length: int, stages: "dict | None" = None,
        cache_ctx=None,
    ) -> tuple[list[bytes], bool]:
        """Read + verify + reconstruct a batch of blocks -> raw block bytes.

        Reads only ``data_blocks`` shards up front (local readers
        preferred, data shards first among equals) and escalates to
        parity shards only on read failure or bitrot — a healthy GET
        never touches parity (erasure-decode.go:63-88 newParallelReader
        with prefer[], :120-183 Read with missingPartsHeal escalation).

        With a ``cache_ctx``, each group first consults the tiered read
        cache: a hit serves the digest-verified data rows without
        opening a single shard reader - no hedging, no breakers, no
        disk.  A miss that read no damage populates the cache (subject
        to frequency admission) from the decoded data rows - read intact
        with their on-disk digest words, or reconstructed from
        digest-verified shards with freshly computed words.
        """
        k, m = self.data_blocks, self.parity_blocks
        n = k + m
        if stages is None:
            stages = {"assemble": 0.0, "codec": 0.0, "disk": 0.0}
        sizes = [
            self.shard_size_padded(self._block_len(b, total_length))
            for b in block_indices
        ]
        readers = None
        heal = False
        out: list[bytes] = []
        # group contiguous runs with equal shard size into one device pass
        i = 0
        while i < len(block_indices):
            j = i
            while j < len(block_indices) and sizes[j] == sizes[i]:
                j += 1
            group = block_indices[i:j]
            shard_len = sizes[i]
            if cache_ctx is not None:
                t0 = time.monotonic()
                cached = cache_ctx.lookup(
                    be, group[0], len(group), shard_len
                )
                stages["codec"] += time.monotonic() - t0
                if cached is not None:
                    t0 = time.monotonic()
                    for gi, b in enumerate(group):
                        block_len = self._block_len(b, total_length)
                        ss = self.shard_size(block_len)
                        # one strided copy; the [:block_len] trim is a
                        # view and _write_blocks streams views as-is
                        flat = np.ascontiguousarray(
                            cached[gi, :, :ss]
                        ).reshape(-1)
                        out.append(flat[:block_len])
                    stages["assemble"] += time.monotonic() - t0
                    i = j
                    continue
            if readers is None:
                readers = bank.get(n)
                # a reader slot known-dead before we start is a missing
                # shard: flag heal even though the k-read path may never
                # need it (a fully-cached GET observes no disks at all)
                heal = heal or any(readers[s] is None for s in range(n))
            shards, digests, ok, g_heal = self._read_group_quorum(
                be, readers, group, shard_len, stages
            )
            heal = heal or g_heal
            # verify stays a separate pass HERE: the quorum read needs
            # per-shard verdicts BEFORE deciding whether to escalate to
            # more reads, and on the healthy path there is no reconstruct
            # at all - fusing would decode k rows per group that the
            # fast path below streams out as views
            # reconstruct per distinct pattern (usually one)
            t0 = time.monotonic()
            patterns: dict[tuple, list[int]] = {}
            for gi in range(len(group)):
                pat = tuple(bool(x) for x in ok[gi])
                patterns.setdefault(pat, []).append(gi)
            if len(patterns) == 1 and all(next(iter(patterns))[:k]):
                # healthy fast path: every block has its data rows
                # intact, so stream straight out of the frame buffer -
                # no (g, k, shard_len) copy, no fancy-index temporaries
                datas = shards[:, :k, :]
            else:
                datas = np.zeros(
                    (len(group), k, shard_len), dtype=np.uint8
                )
                for pat, gis in patterns.items():
                    if all(pat[:k]):
                        datas[gis] = shards[gis][:, :k]
                    else:
                        datas[np.asarray(gis)] = be.reconstruct(
                            shards[np.asarray(gis)], pat, k, m
                        )
            stages["codec"] += time.monotonic() - t0
            if cache_ctx is not None and not g_heal:
                # admit the decoded data rows.  When every data slot read
                # intact, reuse the digest words that just verified
                # against disk; when the preferred k readers included
                # parity (local shards first), the rows came out of
                # reconstruct over digest-verified shards, so recompute
                # their words - the cache only needs digests consistent
                # with the rows it stores to catch in-cache rot on hit
                if bool(ok[:, :k].all()):
                    cache_ctx.admit_from_decode(
                        group[0], len(group), shard_len,
                        datas, digests[:, :k, :],
                    )
                else:
                    cache_ctx.admit_from_decode(
                        group[0], len(group), shard_len,
                        datas, be.digest(datas),
                    )
            # raw frames die before blocks copy out
            shards = digests = ok = None
            t0 = time.monotonic()
            for gi, b in enumerate(group):
                block_len = self._block_len(b, total_length)
                ss = self.shard_size(block_len)
                block = datas[gi, :, :ss].reshape(-1)[:block_len]
                out.append(block.tobytes())
            datas = None  # only the extracted blocks survive the group
            stages["assemble"] += time.monotonic() - t0
            i = j
        return out, heal

    def _read_group_quorum(
        self, be, readers, group: list[int], shard_len: int,
        stages: "dict | None" = None,
    ):
        """Read shard frames for one equal-size block group until every
        block has >= k intact shards, escalating through the preference
        order; shard reads always fan out per disk through the shared
        iopool (local disks too — 12 spindles seek concurrently) and
        contiguous frames are fetched in one ranged read per shard (one
        RTT per shard per batch, the read twin of the pipelined shard
        writers).

        The escalation loop is hedged and deadline-bounded (the Tail at
        Scale discipline over the reference's parallelReader shape):
        outstanding reads race a deadline derived from the pool-wide
        read p99 (storage/health.py); when the deadline expires with
        the quorum still short, a duplicate read launches on the next
        preferred shard instead of blocking on the straggler.  Losers
        are abandoned — their band slot frees without blocking us — and
        reported to the straggler's circuit breaker as censored slow
        samples, so the NEXT GET's preference order already routes
        around the slow disk.  Suspect/tripped disks sort last among
        otherwise-equal shards; a straggler that merely lost a hedge
        race does NOT set the heal flag (slowness is not damage), but
        observed missing/short/corrupt frames still do.
        """
        if stages is None:
            stages = {"assemble": 0.0, "codec": 0.0, "disk": 0.0}
        k, m = self.data_blocks, self.parity_blocks
        n = k + m
        g = len(group)
        frame = bitrot.DIGEST_SIZE + shard_len
        # full-size blocks sit frame-by-frame in the shard file, so a
        # whole group is one contiguous byte range; the tail block's
        # shorter frame is its own group and reads individually
        contiguous = frame == bitrot.frame_size(self.shard_size())
        shards = np.zeros((g, n, shard_len), dtype=np.uint8)
        digests = np.zeros((g, n, 8), dtype=np.uint32)
        present = np.zeros((g, n), dtype=bool)
        ok = np.zeros((g, n), dtype=bool)
        heal = False

        reg = disk_health.registry()
        # endpoint per slot: only endpoint-tagged readers (the object
        # layer stamps disk streams) feed the breakers and estimators;
        # untagged unit-test doubles read exactly as before
        endpoints: "dict[int, str | None]" = {}
        for s in range(n):
            key = getattr(readers[s], "io_key", None)
            endpoints[s] = key if isinstance(key, str) else None

        def read_shard(s) -> "list[bytes | None]":
            r = readers[s]
            frames: "list[bytes | None]" = [None] * g
            if r is None:
                return frames
            ep = endpoints[s]
            t_read = time.monotonic()
            try:
                if contiguous:
                    base = self.shard_block_offset(group[0])
                    # zero-copy frame slices: one ranged read per
                    # shard, parsed as views, never re-copied
                    buf = memoryview(r.read_at(base, frame * g))
                    for gi in range(g):
                        c = buf[gi * frame : (gi + 1) * frame]
                        if len(c) == frame:
                            frames[gi] = c
                else:
                    for gi, b in enumerate(group):
                        c = r.read_at(self.shard_block_offset(b), frame)
                        if len(c) == frame:
                            frames[gi] = c
            except Exception:  # noqa: BLE001 - any failure = dead shard
                readers[s] = None
                if ep:
                    reg.record_shard_read(
                        ep, time.monotonic() - t_read, ok=False
                    )
                return [None] * g
            # service time recorded HERE, on the worker, so the sample
            # is pure disk latency — settle-side timing would fold in
            # decode/verify stalls and bias the hedge deadline slow.
            # An abandoned-but-running read that completes still lands
            # its true (slow) sample, exactly what the estimator wants.
            if ep:
                reg.record_shard_read(
                    ep, time.monotonic() - t_read, ok=True
                )
            return frames

        def slot_state(s: int) -> int:
            ep = endpoints[s]
            return reg.get_disk(ep).state() if ep else disk_health.HEALTHY

        # preference: live readers, breaker-healthy before suspect/
        # tripped, local before remote, then natural order (data shards
        # 0..k-1 first among equals)
        remaining = sorted(
            (s for s in range(n) if readers[s] is not None),
            key=lambda s: (
                slot_state(s),
                not getattr(readers[s], "is_local", True),
                s,
            ),
        )
        pool = iopool.get_pool()
        deadline = reg.hedge_deadline()
        outstanding: "dict[int, tuple]" = {}  # s -> (fut, t0, is_hedge)
        last_hedge = 0.0
        hedges = 0

        def launch(hedge: bool) -> None:
            s = remaining.pop(0)
            submit = pool.submit_hedged if hedge else pool.submit
            fut = submit(
                _io_key(readers[s]),
                (lambda s=s: read_shard(s)),
                nbytes=frame * g,
            )
            outstanding[s] = (fut, time.monotonic(), hedge)

        try:
            while True:
                deficit = int(k - ok.sum(axis=1).min()) if g else 0
                if deficit <= 0:
                    break
                while len(outstanding) < deficit and remaining:
                    launch(hedge=False)
                if not outstanding:
                    intact = int(ok.sum(axis=1).min())
                    raise QuorumError(
                        f"read quorum lost: {intact}/{n} shards intact,"
                        f" need {k}"
                    )
                t0 = time.monotonic()
                # wait for any completion, racing the hedge deadline
                # (clocked from the oldest outstanding read or the last
                # hedge, whichever is later — each hedge gets a full
                # deadline before the next one may fire)
                timeout = None
                if (
                    deadline is not None
                    and remaining
                    and hedges < m
                ):
                    base = max(
                        min(v[1] for v in outstanding.values()),
                        last_hedge,
                    )
                    timeout = max(0.0, base + deadline - t0)
                done = iopool.wait_any(
                    [v[0] for v in outstanding.values()], timeout
                )
                stages["disk"] += time.monotonic() - t0
                if not done:
                    # deadline expired, quorum still short: duplicate
                    # read on the next preferred (parity) shard
                    launch(hedge=True)
                    hedges += 1
                    last_hedge = time.monotonic()
                    continue
                # settle every completed slot in one batch
                batch = sorted(
                    s for s, v in outstanding.items() if v[0].done()
                )
                t0 = time.monotonic()
                for s in batch:
                    fut, t_launch, is_hedge = outstanding.pop(s)
                    frames = fut.result if fut.error is None else None
                    if frames is None:
                        frames = [None] * g
                    got_any = False
                    for gi, c in enumerate(frames):
                        if c is None:
                            heal = True  # chosen shard missing/short
                            continue
                        digests[gi, s] = bitrot.digest_from_bytes(
                            c[: bitrot.DIGEST_SIZE]
                        )
                        shards[gi, s] = np.frombuffer(
                            c[bitrot.DIGEST_SIZE :], dtype=np.uint8
                        )
                        present[gi, s] = True
                        got_any = True
                    if is_hedge and got_any:
                        KERNEL_STATS.record_hedge("won")
                frames = None  # ranged-read buffers die before verify
                stages["assemble"] += time.monotonic() - t0
                # verify only the shards just read: a healthy GET
                # hashes exactly k columns, and escalation rounds never
                # re-hash already-verified shards
                t0 = time.monotonic()
                bcols = np.asarray(batch)
                if batch == list(
                    range(batch[0], batch[0] + len(batch))
                ):
                    # contiguous columns (the healthy k-data-shard
                    # case): basic slices give verify views, not 4 MiB
                    # temporaries
                    sh_cols = shards[:, batch[0] : batch[0] + len(batch)]
                    dg_cols = digests[:, batch[0] : batch[0] + len(batch)]
                else:
                    sh_cols = shards[:, bcols]
                    dg_cols = digests[:, bcols]
                okb = be.verify(sh_cols, dg_cols) & present[:, bcols]
                sh_cols = dg_cols = None
                if (okb != present[:, bcols]).any():
                    heal = True  # bitrot detected somewhere
                ok[:, bcols] = okb
                stages["codec"] += time.monotonic() - t0
        finally:
            # disavow stragglers: quorum is met (or lost) without them.
            # Queued losers resolve IopoolAbandoned without running;
            # running ones finish unobserved.  Their elapsed time is a
            # CENSORED sample — real latency is at least this — so it
            # feeds the straggler's slow-strike ladder but never the
            # latency estimators.
            now = time.monotonic()
            for s, (fut, t_launch, is_hedge) in outstanding.items():
                fut.abandon()
                ep = endpoints[s]
                if ep:
                    reg.record_shard_read(
                        ep, now - t_launch, ok=True, censored=True
                    )
                if is_hedge:
                    KERNEL_STATS.record_hedge("wasted")
        return shards, digests, ok, heal

    # ---- heal (cmd/erasure-lowlevel-heal.go:28-48) ----------------------

    def heal(
        self,
        readers: list,
        writers: list,
        total_length: int,
        backend: "backend_mod.CodecBackend | None" = None,
    ) -> None:
        """Rebuild missing shard files from survivors (quorum = k).

        readers[i] is None for the outdated/offline disks; writers[i] is
        non-None exactly where a shard must be rebuilt.  Streams
        block-by-block: verify survivors, reconstruct all shards, re-frame
        and write the ones needed.
        """
        be = backend or backend_mod.get_backend()
        k, m = self.data_blocks, self.parity_blocks
        n = k + m
        stages = {"assemble": 0.0, "codec": 0.0, "disk": 0.0}
        for b in range(self.block_count(total_length)):
            block_len = self._block_len(b, total_length)
            shard_len = self.shard_size_padded(block_len)
            frame = bitrot.DIGEST_SIZE + shard_len
            off = self.shard_block_offset(b)
            shards = np.zeros((1, n, shard_len), dtype=np.uint8)
            digests = np.zeros((1, n, 8), dtype=np.uint32)
            present = np.zeros(n, dtype=bool)

            def read_frame(s):
                try:
                    buf = readers[s].read_at(off, frame)
                except Exception:  # noqa: BLE001 - dead shard
                    return None
                return buf if len(buf) == frame else None

            live = [
                s
                for s in range(n)
                if s < len(readers) and readers[s] is not None
            ]
            # survivors read concurrently, one iopool queue per disk
            # (the heal twin of the decode fan-out)
            t0 = time.monotonic()
            results = _fanout_reads(read_frame, live, readers, frame)
            stages["disk"] += time.monotonic() - t0
            t0 = time.monotonic()
            for s, buf in zip(live, results):
                if buf is None:
                    continue
                digests[0, s] = bitrot.digest_from_bytes(
                    buf[: bitrot.DIGEST_SIZE]
                )
                shards[0, s] = np.frombuffer(
                    buf[bitrot.DIGEST_SIZE :], dtype=np.uint8
                )
                present[s] = True
            results = None
            stages["assemble"] += time.monotonic() - t0
            # fused read side: digest checks + survivor decode in one
            # device pass (the verify_reconstruct kernel), then the
            # re-encode of the rebuilt data (encode_pack without the pack
            # leg).  The data crosses to the host and back between them,
            # as the JAX package's heal does.
            t0 = time.monotonic()
            try:
                data, ok = be.reconstruct_and_verify(
                    shards, digests, present, k, m
                )  # data (1, k, L)
            except ValueError:
                ok = (be.verify(shards, digests)[0]) & present
                raise QuorumError(
                    f"heal: {int(ok.sum())}/{n} shards intact, need {k}"
                ) from None
            parity, new_digests = be.encode(data, m)
            stages["codec"] += time.monotonic() - t0
            t0 = time.monotonic()
            full = np.concatenate([data, parity], axis=1)[0]
            for s in range(n):
                w = writers[s] if s < len(writers) else None
                if w is None:
                    continue
                frame_bytes = bitrot.digest_to_bytes(new_digests[0, s])
                w.write(frame_bytes + full[s].tobytes())
            stages["disk"] += time.monotonic() - t0
        KERNEL_STATS.record_stream("heal", total_length)
        KERNEL_STATS.record_stages("heal", stages)


def _read_full(reader, size: int) -> bytes:
    """Read exactly size bytes unless EOF (io.ReadFull semantics)."""
    chunks = []
    got = 0
    while got < size:
        chunk = reader.read(size - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
