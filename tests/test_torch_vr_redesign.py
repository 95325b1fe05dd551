"""The Hopper redesign of K6 verify_reconstruct_pipelined[mxu] and of K4
verify_reconstruct (swar, and its sub-chunk form X3), emulated on the CPU.

Neither kernel can run here, so these tests hold the designs'
decomposition against the references without a card:

* K6 [mxu]: the cp.async ring of the np present rows, swizzled by
  ``ring_swizzle`` (``stage_tile<true>``; tile i + 2 staged before tile i
  is waited for, into the slot tile i - 1 read, which the barrier ending
  iteration i - 1 freed), the present data rows stored straight from the
  slot, and only the rb rebuilt rows
  through ``mxu_ring_tile`` lane by lane with the (rb, k) operand
  ``kernels._mxu_rebuilt_operand``; against P7 under ``formulation="mxu"``
  in interpret mode and the port's plain version.
* K4 swar: K4 [mxu]'s register staging (``staged_walk``), the present data
  rows stored from the staging registers, the rebuilt rows in Horner form
  over the survivor words read from the swizzled tile with ``vr_terms``'
  all-ones masks, and the hash leg with the key of column c at c +
  word_offset; whole rows against P5 in interpret mode, and chained over
  sub-chunks at nonzero word offsets (X3) against
  ``minio_tpu.ops.codec_step.verify_reconstruct_subchunk_words`` chained
  over the same chunks, and against the port's plain versions.
* K4's launch plan per call shape, its buffer layout for whole rows and
  for sub-chunks, and the packed argument struct against codec.cu.

Everything is integer arithmetic: the tolerance is zero (bit-exact).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import codec_step as jcs, hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf, hash as thash, kernels
from tests.test_torch_mxu_redesign import (
    CHUNKS, K4_CASES, PW, SMS, TILE, U32, W, WALK_SMS, _present, hash_reads,
    ring_product, staged_walk,
)
from tests.test_torch_pipelined_design import _words
from tests.test_torch_redesign import _xtime
from tests.test_torch_threads import torch_threads  # noqa: F401

STAGES = 3  # kStages: K6's ring depth


def _case(name):
    k, m, absent, rb = K4_CASES[name]
    present = _present(k + m, absent)
    assert len(kernels.vr_terms(present, k).rebuilt) == rb
    return k, m, present


def _logical(rows: np.ndarray, tile: int) -> np.ndarray:
    """One tile of (rows, w) words as (rows, 256), zeros past w."""
    out = np.zeros((rows.shape[0], TILE), U32)
    part = rows[:, tile * TILE:(tile + 1) * TILE]
    out[:, :part.shape[1]] = part
    return out


def _digests(partials: np.ndarray, nbytes: int) -> np.ndarray:
    """The last block's length fold (finalize_if_last) of (B, n, 8)
    partials; absent rows' partials are zero."""
    fold = U32((nbytes * int(thash._C1)) & 0xFFFFFFFF) + np.arange(8, dtype=U32)
    return thash._mix_np(partials ^ fold)


def hash_tile(logical: np.ndarray, tile: int, w: int, word_offset: int) -> np.ndarray:
    """The hash leg of one tile: thread tid hashes its column's word of
    every slot with the key of column tile * 256 + tid + word_offset and
    folds it into partition tid % 4 (the block's shuffles and atomics are
    XORs, order-free): (slots, 8) partials, invalid columns skipped."""
    col = tile * TILE + np.arange(TILE)
    valid = col < w
    key = thash._mix_np((col + word_offset).astype(U32) * thash._C1 + U32(1))
    m1 = thash._mix_np((logical ^ key) * thash._M1)
    m2 = thash._mix_np((logical + key) * thash._M2)
    out = np.zeros((logical.shape[0], 8), U32)
    for p in range(4):
        sel = valid & (np.arange(TILE) % 4 == p)
        out[:, p] = np.bitwise_xor.reduce(m1[:, sel], axis=1)
        out[:, 4 + p] = np.bitwise_xor.reduce(m2[:, sel], axis=1)
    return out


# ---------------------------------------------------------------------------
# K6 [mxu]: the cp.async ring, swizzled, one barrier a tile
# ---------------------------------------------------------------------------


def stage_tile(rows: np.ndarray, tile: int) -> np.ndarray:
    """stage_tile<true>: chunk c of slot j lands at chunk c ^ ring_swizzle(j)
    of the ring slot (zeros past w)."""
    logical = _logical(rows, tile)
    phys = np.zeros_like(logical)
    for j in range(rows.shape[0]):
        src = np.arange(CHUNKS) ^ kernels.ring_swizzle(j)  # XOR: an involution
        phys[j] = logical[j].reshape(CHUNKS, 4)[src].reshape(-1)
    return phys


def ring_walk(rows: np.ndarray, B: int, sms: int, compute) -> None:
    """K6's tile loop for every block of one stripe on ``pipelined_grid``:
    tiles 0 and 1 of the block staged before the loop; iteration i stages
    tile i + 2 into slot (i + 2) % 3, waits for tile i, takes a barrier,
    computes tile i from slot i % 3 and takes a second barrier.  Checks
    that a slot is staged only after the barrier that follows its last
    read (at iteration i - 1 or earlier), that the slot computed holds its
    tile and that the hash reads give it back, and that every tile is
    staged once."""
    w = rows.shape[1]
    ntiles = -(-w // TILE)
    tpb, per_stripe = kernels.pipelined_grid(B, w, sms)
    staged = np.zeros(ntiles, np.int64)
    for blk in range(per_stripe):
        first = blk * tpb
        count = min(tpb, ntiles - first)
        ring = np.zeros((STAGES, rows.shape[0], TILE), U32)
        holds, last_read = [None] * STAGES, [-STAGES] * STAGES

        def stage(t, i, ring=ring, holds=holds, last_read=last_read, first=first):
            slot = t % STAGES
            assert last_read[slot] < i  # the barrier of iteration i lies between
            ring[slot] = stage_tile(rows, first + t)
            holds[slot] = t
            staged[first + t] += 1

        for st in range(STAGES - 1):
            if st < count:
                stage(st, -1)
        for i in range(count):
            if i + STAGES - 1 < count:
                stage(i + STAGES - 1, i)
            # cp.async.wait_group kStages - 1; __syncthreads()
            slot = i % STAGES
            assert holds[slot] == i
            assert np.array_equal(hash_reads(ring[slot]), _logical(rows, first + i))
            compute(first + i, ring[slot])
            last_read[slot] = i  # __syncthreads() ends the iteration
    assert (staged == 1).all()


def k6_mxu_emulate(shards: np.ndarray, present: tuple, k: int, sms: int = WALK_SMS):
    """K6 [mxu]'s outputs: per stripe the ring walk over the np present
    rows (slot j = vr_terms' rows[j]); the copies stored from the slot at
    the swizzled index; the rb rebuilt rows from mxu_ring_tile with the
    (rb, k) operand; the hash leg from the same reads, finalized."""
    B, n, w = shards.shape
    terms = kernels.vr_terms(present, k)
    rows, copy, rebuilt = terms.rows, terms.copy, terms.rebuilt
    idx = rows[:k]
    rmat = gf.reconstruction_matrix(k, n - k, idx)
    frags = kernels.mxu_fragments(rmat[list(rebuilt)])
    op = tcs.tensor_to_words(kernels._mxu_rebuilt_operand(present, k, torch.device("cpu")))
    assert np.array_equal(op.reshape(frags.shape), frags)
    data = np.full((B, k, w), 0xDEADBEEF, U32)
    writes = np.zeros((B, k, w), np.int64)
    partials = np.zeros((B, n, 8), U32)
    for b in range(B):
        def compute(tile, phys, b=b):
            logical = hash_reads(phys)
            col = tile * TILE + np.arange(TILE)
            valid = col < w
            partials[b, list(rows)] ^= hash_tile(logical, tile, w, 0)
            for j, d in enumerate(copy):
                if d >= 0:
                    data[b, d, col[valid]] = logical[j, valid]
                    writes[b, d, col[valid]] += 1
            if rebuilt:
                acc = ring_product(frags, phys, k, len(rebuilt))
                for o, d in enumerate(rebuilt):
                    data[b, d, col[valid]] = acc[o, valid]
                    writes[b, d, col[valid]] += 1

        ring_walk(shards[b][list(rows)], B, sms, compute)
    assert (writes == 1).all()  # every data word once: a copy or a rebuilt row
    return data, _digests(partials, 4 * w)


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k6_mxu_walk_matches_p7_mxu_interpret_and_plain(case):
    """The whole K6 [mxu] walk against P7 with formulation="mxu" in
    interpret mode (data, and the digests of the present rows) and the
    port's plain version, over heal's pattern, all present (no product),
    rb = 1, 3, 4 and k = 4, 8, 12."""
    k, m, present = _case(case)
    shards = _words((1, k + m, PW), seed=11 * k + sum(present))
    data, digests = k6_mxu_emulate(shards, present, k)
    want = kernels.verify_reconstruct_pipelined_plain(
        tcs.words_to_tensor(shards, "cpu"), present, k, 4 * PW, "mxu")
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(digests, tcs.tensor_to_words(want[1]))
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    p7_data, partials = rs_pallas.verify_reconstruct_pipelined(
        jnp.asarray(shards), idx, k, m, formulation="mxu", interpret=True)
    assert np.array_equal(data, np.asarray(p7_data))
    live = np.asarray(present)
    p7_dig = np.asarray(jhash.finalize_partials(partials, 4 * PW))
    assert np.array_equal(digests[:, live], p7_dig[:, live])


def test_k6_mxu_walk_eight_rebuilt_rows_ragged_width():
    """The 8-row bucket of the product (EC 8+8, every data row absent: no
    copy, 8 rebuilt rows) at a ragged width, B = 2 and blocks of several
    tiles, so every slot of the ring takes turns; against the plain
    version."""
    k, n, w = 8, 16, 4 * TILE + 8
    present = _present(n, range(8))
    shards = _words((2, n, w), seed=4)
    data, digests = k6_mxu_emulate(shards, present, k, sms=1)
    want = kernels.verify_reconstruct_pipelined_plain(
        tcs.words_to_tensor(shards, "cpu"), present, k, 4 * w, "mxu")
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(digests, tcs.tensor_to_words(want[1]))


def test_k6_ring_stages_each_tile_once_and_reuses_slots_after_the_barrier():
    """The ring walk alone at a ragged width over blocks of 1 to 6 tiles
    (pipelined_grid at 1, 2 and 132 SMs): each tile staged once, a slot
    restaged only after the barrier that follows its last read."""
    rows = _words((12, 11 * TILE + 100), seed=5)
    for sms in (1, 2, SMS):
        seen = []
        ring_walk(rows, 1, sms, lambda tile, phys: seen.append(tile))
        assert sorted(seen) == list(range(12))


# ---------------------------------------------------------------------------
# K4 swar and X3: register staging, copies, the Horner product
# ---------------------------------------------------------------------------


def k4_swar_emulate(shards: np.ndarray, present: tuple, k: int, word_offset: int = 0,
                    sms: int = WALK_SMS):
    """K4 swar over one (B, n, w) batch whose column c is column c +
    word_offset of the row: the staged walk over the np present rows, the
    present data rows stored from the staging registers (16-byte stores),
    the rb rebuilt rows in Horner form over the survivor words read from
    the swizzled tile with vr_terms' masks.  Returns (data, raw partials):
    the caller finalizes (the last chunk's last block)."""
    B, n, w = shards.shape
    terms = kernels.vr_terms(present, k)
    rows, copy, rebuilt, masks = terms.rows, terms.copy, terms.rebuilt, terms.masks
    kb = masks.shape[-1]
    data = np.full((B, k, w), 0xDEADBEEF, U32)
    writes = np.zeros((B, k, w), np.int64)
    partials = np.zeros((B, n, 8), U32)
    for b in range(B):
        def on_stage(tile, regs, b=b):
            for (j, c), v in regs.items():
                col = tile * TILE + 4 * c
                if copy[j] >= 0 and col < w:  # a 16-byte store (w % 4 == 0)
                    data[b, copy[j], col:col + 4] = v
                    writes[b, copy[j], col:col + 4] += 1

        def compute(tile, buf, b=b):
            logical = hash_reads(buf)
            col = tile * TILE + np.arange(TILE)
            valid = col < w
            partials[b, list(rows)] ^= hash_tile(logical, tile, w, word_offset)
            x = [logical[j] if j < len(rows) else np.zeros(TILE, U32) for j in range(kb)]
            for o, d in enumerate(rebuilt):
                acc = np.zeros(TILE, U32)
                for bit in range(7, -1, -1):
                    acc = _xtime(acc)
                    for j in range(kb):
                        acc ^= x[j] & masks[o, bit, j]
                data[b, d, col[valid]] = acc[valid]
                writes[b, d, col[valid]] += 1

        staged_walk(shards[b][list(rows)], B, sms, compute, on_stage)
    assert (writes == 1).all()
    return data, partials


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_swar_walk_matches_p5_interpret_and_plain(case):
    """The whole-row K4 swar walk against P5 in interpret mode (data, and
    the digests of the present rows) and the port's plain version."""
    k, m, present = _case(case)
    shards = _words((1, k + m, PW), seed=13 * k + sum(present))
    data, partials = k4_swar_emulate(shards, present, k)
    digests = _digests(partials, 4 * PW)
    want = kernels.verify_reconstruct_plain(tcs.words_to_tensor(shards, "cpu"), present,
                                            k, 4 * PW)
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(digests, tcs.tensor_to_words(want[1]))
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    p5_data, p5_partials = rs_pallas.verify_reconstruct_fused(
        jnp.asarray(shards), idx, k, m, interpret=True)
    assert np.array_equal(data, np.asarray(p5_data))
    live = np.asarray(present)
    p5_dig = np.asarray(jhash.finalize_partials(p5_partials, 4 * PW))
    assert np.array_equal(digests[:, live], p5_dig[:, live])


@pytest.mark.parametrize("case", list(K4_CASES))
def test_x3_chain_matches_jax_subchunk_chain_and_plain(case):
    """X3: the K4 swar walk chained over sub-chunks of a ragged row at
    nonzero word offsets (chunks off the 256-word tile, the last one
    shorter), the partials XORed across chunks and finalized by the last
    one, against codec_step.verify_reconstruct_subchunk_words of the JAX
    package chained over the same chunks (its ok flags included) and the
    port's plain chain; the data of every chunk, and the whole row's."""
    k, m, present = _case(case)
    n, w, cw = k + m, 2600, 1000
    B = 2
    shards = _words((B, n, w), seed=17 * k + sum(present))
    offs = list(range(0, w, cw))
    acc = np.zeros((B, n, 8), U32)
    jacc = jnp.zeros((B, n, 8), jnp.uint32)
    pacc = torch.zeros((B, n, 8), dtype=torch.int32)
    whole = kernels.verify_reconstruct_plain(tcs.words_to_tensor(shards, "cpu"), present,
                                             k, 4 * w)
    digests = jnp.asarray(tcs.tensor_to_words(whole[1]))
    live = np.asarray(present)
    outs = []
    for i, off in enumerate(offs):
        last = i == len(offs) - 1
        chunk = np.ascontiguousarray(shards[:, :, off:off + cw])
        data, part = k4_swar_emulate(chunk, present, k, off)
        acc ^= part
        if last:
            acc = _digests(acc, 4 * w)
        jdata, jacc, ok = jcs.verify_reconstruct_subchunk_words(
            jnp.asarray(chunk), jacc, digests, off, present, k, m, 4 * w, last)
        assert np.array_equal(data, np.asarray(jdata))
        pdata, pacc = kernels.verify_reconstruct_subchunk_plain(
            tcs.words_to_tensor(chunk, "cpu"), pacc, off, present, k, 4 * w, last)
        assert np.array_equal(data, tcs.tensor_to_words(pdata))
        want = np.asarray(jhash.finalize_partials(jacc, 4 * w)) if last else np.asarray(jacc)
        assert np.array_equal(acc[:, live], want[:, live])
        assert np.array_equal(acc, tcs.tensor_to_words(pacc))
        outs.append(data)
    assert np.asarray(ok)[:, live].all() and not np.asarray(ok)[:, ~live].any()
    assert np.array_equal(np.concatenate(outs, axis=-1), tcs.tensor_to_words(whole[0]))
    assert np.array_equal(acc, tcs.tensor_to_words(whole[1]))


def test_k4_swar_walk_seven_rebuilt_rows_widest_bucket():
    """The 16-row buckets (EC 12+4 with 4 data rows absent and k = 9, 7
    rebuilt rows: kRbMax<16>) at a ragged width and B = 2, against the
    plain version."""
    k, n, w = 9, 16, 3 * TILE + 12
    present = _present(n, (0, 1, 2, 3, 4, 5, 6))
    assert len(kernels.vr_terms(present, k).rebuilt) == 7
    shards = _words((2, n, w), seed=6)
    data, partials = k4_swar_emulate(shards, present, k, sms=1)
    want = kernels.verify_reconstruct_plain(tcs.words_to_tensor(shards, "cpu"), present,
                                            k, 4 * w)
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(_digests(partials, 4 * w), tcs.tensor_to_words(want[1]))


# ---------------------------------------------------------------------------
# K4's plan, buffer and packed arguments
# ---------------------------------------------------------------------------


@pytest.fixture
def vr_plans(monkeypatch):
    """_vr_plan on the CPU: the grid sized for an H100's SMs."""
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    kernels._vr_plan.cache_clear()
    yield kernels._vr_plan
    kernels._vr_plan.cache_clear()


def test_vr_plan_made_once_per_call_shape(vr_plans):
    """One plan per (B, n, k, w, present, formulation, whole rows or a
    sub-chunk): the cached term program, no operand for swar, the
    persistent grid (K4 swar walked 1 tile a block before: 5 now at heal's
    shape, and 1 at X3's chunk of 65,536 words)."""
    cpu = torch.device("cpu")
    heal = _present(12, (0, 2, 9, 11))
    a = vr_plans(1, 12, 8, W, heal, "swar", True, cpu)
    for _ in range(3):
        assert vr_plans(1, 12, 8, W, heal, "swar", True, cpu) is a
    chunk = vr_plans(1, 12, 8, 65536, heal, "swar", False, cpu)
    mxu = vr_plans(1, 12, 8, W, heal, "mxu", True, cpu)
    assert len({id(a), id(chunk), id(mxu)}) == 3
    assert vr_plans.cache_info().misses == 3
    assert a.terms is kernels.vr_terms(heal, 8) and a.operand is None and a.amat == 0
    assert (a.np, a.rb, a.tiles_per_block) == (8, 2, 5)
    assert chunk.tiles_per_block == 1 and chunk.digests is None
    assert mxu.operand is kernels._mxu_rebuilt_operand(heal, 8, cpu)
    with pytest.raises(ValueError, match="one word"):
        vr_plans(1, 12, 8, 0, heal, "swar", False, cpu)


@pytest.mark.parametrize("B,n,k,w", [(1, 12, 8, W), (4, 12, 8, 65536), (2, 6, 4, 1000)])
def test_vr_subchunk_buffer_layout(vr_plans, B, n, k, w):
    """A sub-chunk's one buffer holds its data at offset 0 (16-byte
    aligned rows for the copies' 16-byte stores) and then the word the
    last chunk's ticket takes: the digests stay in the caller's
    accumulator.  A whole row's holds data, digests, ticket (one memset
    zeroes the last two)."""
    present = _present(n, (1,))
    plan = vr_plans(B, n, k, w, present, "swar", False, torch.device("cpu"))
    assert plan.buf_words == B * k * w + 1 and plan.ticket_off == 4 * B * k * w
    buf = torch.arange(plan.buf_words, dtype=torch.int32)
    data = buf.as_strided(*plan.data)
    assert data.shape == (B, k, w) and data.storage_offset() == 0 and (4 * w) % 16 == 0
    assert int(data.reshape(-1)[-1]) == plan.buf_words - 2
    whole = vr_plans(B, n, k, w, present, "swar", True, torch.device("cpu"))
    assert whole.buf_words == B * k * w + B * n * 8 + 1
    assert whole.ticket_off == whole.acc_off + 4 * B * n * 8


def _struct_fields(name: str) -> list:
    """The fields of a struct of codec.cu, as (C type, count) in order."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "codec.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.strip().splitlines():
        ctype, names = line.strip().rstrip(";").split(None, 1)
        fields.append((ctype, len(names.split(","))))
    size = int(re.search(r"static_assert\(sizeof\(%s\) == (\d+)" % name, src).group(1))
    return fields, size


def test_vr_args_match_codec_cu():
    """_VR_ARGS packs VrArgs as codec.cu declares it: 7 u64 addresses, 10
    int32, 3 u32, padded to the static_assert'ed 112 bytes."""
    fields, size = _struct_fields("VrArgs")
    assert fields == [("uint64_t", 7), ("int32_t", 10), ("uint32_t", 3)]
    assert kernels._VR_ARGS.format == "<7Q10i3I4x" and kernels._VR_ARGS.size == size == 112
    assert kernels._constants()["vr_args_bytes"] == (112,)


def test_k4_and_k6_cpu_wrappers_stay_plain():
    """On the CPU, K4 swar, X3 and K6 [mxu] run their plain versions (no
    library is built or loaded); K6 [mxu]'s operand is the rebuilt rows'
    (the (k, k) operand it took is gone)."""
    present = _present(12, (0, 2, 9, 11))
    shards = tcs.words_to_tensor(_words((1, 12, 1024), seed=2), "cpu")
    want = kernels.verify_reconstruct_plain(shards, present, 8, 4096)
    for got in (kernels.verify_reconstruct(shards, present, 8, 4096),
                kernels.verify_reconstruct_pipelined(shards, present, 8, 4096, "mxu")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    acc = torch.zeros((1, 12, 8), dtype=torch.int32)
    data, acc = kernels.verify_reconstruct_subchunk(shards, acc, 0, present, 8, 4096, True)
    assert torch.equal(data, want[0]) and torch.equal(acc, want[1])
    assert not hasattr(kernels, "_mxu_vr_operand") and kernels._lib is None
