"""The Hopper design of K5 encode_pack_pipelined, swar and mxu, emulated on
the CPU.

Neither kernel can run here, so these tests hold the design's
decomposition against the references without a card:

* K5 swar: the persistent grid (``kernels.encode_pipelined_grid``), each
  block's run of 256-column tiles staged into the ring slot (zeros past
  w), a thread's column read from the slot into registers once, K1's
  product on them (the generated ``fixed_parity`` steps for EC 8+4, the
  masked Horner form over ``kernels.parity_terms`` for every other
  geometry), the per-warp flag ballots written by threads r < m one tile
  late (after the next tile's barrier, the last one after the loop) and
  the pack leg.  Against ``gf.encode_ref``, the port's plain version and
  ``rs_pallas.encode_pack_pipelined`` (P6) in interpret mode.
* K5 mxu: ``mxu_ring_tile`` lane by lane - the swizzled ring
  (``kernels.ring_swizzle``), one 16-byte load per row and group, the B
  words by byte permutes, ``mma.m16n8k128`` on 1-bit values with
  ``kernels.mxu_fragments`` as A, the paired repack, the three shuffles
  and the stores into ``out_s`` - against ``rs.mxu_rows`` and P6 under
  ``formulation="mxu"`` in interpret mode; and the bank of every shared
  access the swizzle is there for.
* The launch plan made once per call shape, its one buffer and the
  packed argument struct; K5's grid and ``pipeline_windows``; and
  ``chip_smoke.mxu_ring_design_ops``.

Everything is integer arithmetic: the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf, hash as thash, kernels, rs
from tests.test_torch_encode_matmul_design import k1_pack, k1_parity
from tests.test_torch_threads import torch_threads  # noqa: F401

SMS = 132  # an H100's SMs: the grid the wrappers size on the card
U32 = np.uint32
TILE = kernels.TILE
W = 327_680  # words per shard of a 10 MiB EC 8+4 block


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(U32)


def _data(B, k, w, seed):
    words = _words((B, k, w), seed)
    words[0, :, :64] = 0xFFFFFFFF
    words[-1, :, 512:2048] = 0  # zero groups for the pack leg
    return words


def _slot(stripe: np.ndarray, tile: int) -> np.ndarray:
    """stage_rows: the (k, 256) ring slot of one tile, zeros past w."""
    k, w = stripe.shape
    slot = np.zeros((k, TILE), U32)
    cols = stripe[:, tile * TILE:(tile + 1) * TILE]
    slot[:, :cols.shape[1]] = cols
    return slot


def _ballots(acc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Each warp's __ballot_sync(valid && acc[r] != 0): (m, 8) words."""
    nz = ((acc != 0) & valid).reshape(acc.shape[0], TILE // 32, 32)
    return (nz.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)


# ---------------------------------------------------------------------------
# K5 swar
# ---------------------------------------------------------------------------


def k5_walk(words: np.ndarray, m: int, group: int, product):
    """K5's grid and tile walk on (B, k, w) data: every block stages its
    tiles, reads its columns into registers once, takes ``product(x)``
    (k, 256) -> (m, 256), stores the valid columns and defers each
    tile's flags to the next tile's barrier.  Returns parity and flags;
    every parity column and every flag is written exactly once."""
    B, k, w = words.shape
    ntiles = -(-w // TILE)
    tpb, per_stripe = kernels.encode_pipelined_grid(B, w, SMS)
    assert per_stripe == -(-ntiles // tpb)
    g = w // TILE if group else 0
    parity = np.full((B, m, w), 0xDEADBEEF, U32)
    flags = np.full((B, m, g), 7, U32)
    writes = np.zeros((B, w), np.int64)
    flag_writes = np.zeros((B, g), np.int64)
    for b in range(B):
        for blk in range(per_stripe):
            first = blk * tpb
            count = min(tpb, ntiles - first)
            assert count >= 1
            pending = None  # (tile, ballots) whose flags the next barrier publishes
            for i in range(count):
                tile = first + i
                if group and pending is not None:  # after tile i's barrier
                    t_prev, bal = pending
                    flags[b, :, t_prev] = np.bitwise_or.reduce(bal, axis=1) != 0
                    flag_writes[b, t_prev] += 1
                x = _slot(words[b], tile)
                acc = product(x)
                col = tile * TILE + np.arange(TILE)
                valid = col < w
                parity[b, :, col[valid]] = acc[:, valid].T
                writes[b, col[valid]] += 1
                pending = (tile, _ballots(acc, valid))
            if group:  # the barrier after the loop
                t_prev, bal = pending
                flags[b, :, t_prev] = np.bitwise_or.reduce(bal, axis=1) != 0
                flag_writes[b, t_prev] += 1
    assert (writes == 1).all()
    assert (flag_writes == 1).all()
    return parity, flags


def k5_emulate(words: np.ndarray, m: int, group: int, product=None):
    """K5's outputs: parity, finalized digests (the port's host phash256 of
    data + parity, the hash leg being K1's), flags, packed."""
    B, k, w = words.shape
    if product is None:
        product = lambda x: k1_parity(x, m)  # noqa: E731 - the entry's form
    parity, flags = k5_walk(words, m, group, product)
    digests = np.stack([
        thash.phash256_host_batched(np.concatenate([words[b], parity[b]]), 4 * w)
        for b in range(B)
    ])
    if not group:
        return parity, digests, np.zeros((B, m, 0), U32), parity
    packed = np.stack([k1_pack(parity[b], flags[b]) for b in range(B)])
    return parity, digests, flags, packed


GEOMS = [(8, 4), (4, 2), (12, 4)]


@pytest.mark.parametrize("k,m", GEOMS)
@pytest.mark.parametrize("group", [0, 256])
def test_k5_emulation_matches_plain_and_encode_ref(k, m, group):
    """The walk with K1's product equals the port's plain version (which
    tests/test_torch_overlap.py holds to P6) and gf.encode_ref, at B = 2
    and a width whose last tile is ragged when there is no pack leg."""
    w = 8192 if group else 8192 + 100
    words = _data(2, k, w, seed=k * 7 + m + group)
    got = k5_emulate(words, m, group)
    want = kernels.encode_pack_pipelined(tcs.words_to_tensor(words, "cpu"), m, 4 * w, group)
    for a, b in zip(got, want):
        assert np.array_equal(a, tcs.tensor_to_words(b))
    ref = gf.encode_ref(words[1].view(np.uint8).reshape(k, -1), m)
    assert np.array_equal(got[0][1], ref.view(U32).reshape(m, w))


@pytest.mark.parametrize("k,m", GEOMS)
@pytest.mark.parametrize("group", [0, 256])
def test_k5_emulation_matches_p6_interpret(k, m, group):
    """Parity, digests and flags equal P6's in interpret mode at w =
    8,192 (two P6 tiles); packed equals P6's prefix, zeros behind it."""
    w = 8192
    words = _data(1, k, w, seed=k + m)
    parity, partials, flags, packed = rs_pallas.encode_pack_pipelined(
        jnp.asarray(words), m, group=group, interpret=True)
    got = k5_emulate(words, m, group)
    assert np.array_equal(got[0], np.asarray(parity))
    assert np.array_equal(got[1], np.asarray(jhash.finalize_partials(partials, 4 * w)))
    if not group:
        return
    assert np.array_equal(got[2], np.asarray(flags).astype(U32))
    kept = np.asarray(flags).sum(axis=-1) * group
    for r in range(m):
        n = int(kept[0, r])
        assert np.array_equal(got[3][0, r, :n], np.asarray(packed)[0, r, :n])
        assert not got[3][0, r, n:].any()


# ---------------------------------------------------------------------------
# K5 mxu: mxu_ring_tile lane by lane
# ---------------------------------------------------------------------------

LANE = np.arange(32)
G, TIG = LANE >> 2, LANE & 3
Q, H = G & 3, G >> 2


def swizzle_slot(slot: np.ndarray) -> np.ndarray:
    """stage_rows<true>: chunk c of row j at chunk c ^ ring_swizzle(j)."""
    k = slot.shape[0]
    out = np.zeros_like(slot)
    for j in range(k):
        for c in range(TILE // 4):
            d = c ^ kernels.ring_swizzle(j)
            out[j, 4 * d:4 * d + 4] = slot[j, 4 * c:4 * c + 4]
    return out


def _mma_b1(a_words: np.ndarray, b_words: np.ndarray) -> np.ndarray:
    """mma.m16n8k128.row.col.s32.b1.b1.s32.and.popc over the warp: A as
    (32 lanes, 2) words (a0 row g, a1 row g + 8, bits 32 tig ..), B as 32
    lane words (column g, bits 32 tig ..) -> c (32 lanes, 4) popcounts in
    the PTX fragment order (rows g, g + 8; columns 2 tig, 2 tig + 1)."""
    amat = np.zeros((16, 128), np.int64)
    bmat = np.zeros((128, 8), np.int64)
    bits = np.arange(32)
    for ln in range(32):
        g, tig = ln >> 2, ln & 3
        amat[g, 32 * tig:32 * tig + 32] = (int(a_words[ln, 0]) >> bits) & 1
        amat[g + 8, 32 * tig:32 * tig + 32] = (int(a_words[ln, 1]) >> bits) & 1
        bmat[32 * tig:32 * tig + 32, g] = (int(b_words[ln]) >> bits) & 1
    d = amat @ bmat
    return np.stack([d[G, 2 * TIG], d[G, 2 * TIG + 1], d[G + 8, 2 * TIG],
                     d[G + 8, 2 * TIG + 1]], axis=1).astype(np.uint64)


def _byte_perm(a, b, sel: int):
    """__byte_perm(a, b, sel) on lane arrays (no sign mode)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def ring_chunks(phys: np.ndarray, k: int, warp: int, grp: int) -> np.ndarray:
    """Each lane's 16-byte chunk of rows 4 tig + i: (32 lanes, 4 rows, 4)."""
    chunk = (warp * 8 + 2 * grp + H) ^ np.array([kernels.ring_swizzle(4 * t) for t in TIG])
    x = np.zeros((32, 4, 4), np.uint64)
    for ln in range(32):
        for i in range(4):
            r = 4 * TIG[ln] + i
            if r < k:
                x[ln, i] = phys[r, 4 * chunk[ln]:4 * chunk[ln] + 4]
    return x


def mxu_ring_emulate(frags: np.ndarray, phys: np.ndarray, k: int, m: int,
                     warp: int) -> np.ndarray:
    """mxu_ring_tile for one warp on the swizzled slot: out_s rows (m, 256)
    with this warp's 32 columns filled (the rest 0xDEADBEEF)."""
    mb = kernels._bucket(m)
    pairs = (mb // 2 + 1) // 2
    out = np.full((m, TILE), 0xDEADBEEF, np.uint64)
    sel = Q | ((4 + Q) << 4)
    writer = (Q == 0) & ((TIG & 1) == 0)
    af = frags.astype(np.uint64)  # (8 m-tiles, 32 lanes, 2)
    for grp in range(4):
        x = ring_chunks(phys, k, warp, grp)
        bw = []
        for j in range(4):
            lo = np.array([_byte_perm(x[ln, 0, j], x[ln, 1, j], int(sel[ln])) for ln in range(32)])
            hi = np.array([_byte_perm(x[ln, 2, j], x[ln, 3, j], int(sel[ln])) for ln in range(32)])
            bw.append(_byte_perm(lo, hi, 0x5410))
        for p in range(pairs):
            if 4 * p >= m:
                break
            for j in range(4):
                c = _mma_b1(af[2 * p], bw[j])
                d = (_mma_b1(af[2 * p + 1], bw[j]) if 4 * p + 2 < m
                     else np.zeros((32, 4), np.uint64))
                assert c.max() <= 128 and d.max() <= 128  # a byte each
                lo = c[:, 0] + (c[:, 1] << 8) + (d[:, 0] << 16) + (d[:, 1] << 24)
                hi = c[:, 2] + (c[:, 3] << 8) + (d[:, 2] << 16) + (d[:, 3] << 24)
                v = ((lo & 0x01010101) + (hi & 0x01010101) * 16) * (1 << Q.astype(np.uint64))
                assert not (v & v[LANE ^ 4]).any()  # disjoint: the sums are ORs
                v = v + v[LANE ^ 4]
                assert not (v & v[LANE ^ 8]).any()
                v = v + v[LANE ^ 8]
                other = v[LANE ^ 1]
                for ln in np.flatnonzero(writer):
                    col = warp * 32 + 8 * grp + 2 * TIG[ln] + j
                    r0 = 4 * p + H[ln]
                    if r0 < m:
                        out[r0, col] = _byte_perm(v[ln], other[ln], 0x5410)
                    if r0 + 2 < m:
                        out[r0 + 2, col] = _byte_perm(v[ln], other[ln], 0x7632)
    return out.astype(U32)


def mxu_ring_tile(slot: np.ndarray, m: int) -> np.ndarray:
    """K5 [mxu]'s product of one logical (k, 256) slot: every warp."""
    k = slot.shape[0]
    frags = kernels.mxu_fragments(gf.parity_matrix(k, m))
    phys = swizzle_slot(slot)
    out = np.zeros((m, TILE), U32)
    for warp in range(TILE // 32):
        part = mxu_ring_emulate(frags, phys, k, m, warp)
        cols = slice(32 * warp, 32 * warp + 32)
        out[:, cols] = part[:, cols]
    return out


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4), (5, 3), (16, 16), (2, 9)])
def test_mxu_ring_tile_matches_mxu_rows(k, m):
    """One tile of every warp through the emulated product equals the
    port's plain mxu product and the swar one (tile with 0xFFFFFFFF and
    0x80808080 columns, every row count of a bucket's edge)."""
    slot = _words((k, TILE), seed=k * 16 + m)
    slot[:, :8] = 0xFFFFFFFF
    slot[:, 8:16] = 0x80808080
    got = mxu_ring_tile(slot, m)
    pm = gf.parity_matrix(k, m)
    want = tcs.tensor_to_words(rs.mxu_rows(pm, tcs.words_to_tensor(slot, "cpu")))
    assert np.array_equal(got, want)
    assert np.array_equal(got, k1_parity(slot, m, "masked"))


@pytest.mark.parametrize("k,m,group", [(8, 4, 256), (4, 2, 0), (12, 4, 256)])
def test_k5_mxu_emulation_matches_p6_mxu_interpret(k, m, group):
    """The whole K5 [mxu] walk (mxu_ring_tile per tile) against P6 with
    formulation="mxu" in interpret mode and the port's plain version."""
    w = 4096
    words = _data(1, k, w, seed=3 * k + m)
    got = k5_emulate(words, m, group, lambda x: mxu_ring_tile(x, m))
    parity, partials, flags, _packed = rs_pallas.encode_pack_pipelined(
        jnp.asarray(words), m, group=group, formulation="mxu", interpret=True)
    assert np.array_equal(got[0], np.asarray(parity))
    assert np.array_equal(got[1], np.asarray(jhash.finalize_partials(partials, 4 * w)))
    if group:
        assert np.array_equal(got[2], np.asarray(flags).astype(U32))
    want = kernels.encode_pack_pipelined(tcs.words_to_tensor(words, "cpu"), m, 4 * w,
                                         group, formulation="mxu")
    for a, b in zip(got, want):
        assert np.array_equal(a, tcs.tensor_to_words(b))


def test_ring_swizzle_is_a_permutation_of_each_row():
    """Every logical word of a slot row lands once, and the emulated
    stage + swizzled reads give back the logical tile."""
    slot = _words((16, TILE), seed=9)
    phys = swizzle_slot(slot)
    for j in range(16):
        assert sorted(phys[j].tolist()) == sorted(slot[j].tolist())
        cols = np.arange(TILE) ^ (kernels.ring_swizzle(j) << 2)
        assert np.array_equal(phys[j, cols], slot[j])  # the hash leg's reads
    assert [kernels.ring_swizzle(r) for r in range(16)] == [0] * 4 + [2] * 4 + [4] * 4 + [6] * 4


@pytest.mark.parametrize("k", range(1, 17))
def test_stage_rows_covers_each_chunk_once(k):
    """stage_rows' thread assignment: thread tid stages chunk tid % 64 of
    rows tid / 64 + 4t (t < bucket(k) / 4), which covers every 16-byte
    chunk of the k slot rows exactly once; its rows share the swizzle
    ring_swizzle(4t)."""
    kb = kernels._bucket(k)
    seen = {}
    for tid in range(256):
        c, j0 = tid % 64, tid // 64
        for t in range(kb // 4):
            row = j0 + 4 * t
            if row < k:
                seen[(row, c)] = seen.get((row, c), 0) + 1
                assert kernels.ring_swizzle(row) == kernels.ring_swizzle(4 * t)
    assert seen == {(r, c): 1 for r in range(k) for c in range(64)}


def _bank(word_addr):
    return np.asarray(word_addr) % 32


def test_swizzle_spreads_the_b_operand_loads_over_the_banks():
    """For each warp, group and row offset i, the 16-byte loads of rows
    4 tig + i by the 8 (tig, h) address classes cover 8 different quads
    of banks (no conflict), where the unswizzled slot puts all 4 rows of
    a lane class on the same 2 quads."""
    for warp in range(8):
        for grp in range(4):
            for i in range(4):
                quads, plain = set(), set()
                for tig in range(4):
                    for h in range(2):
                        logical = warp * 8 + 2 * grp + h
                        row = 4 * tig + i
                        addr = row * TILE + 4 * (logical ^ kernels.ring_swizzle(row))
                        quads.add(int(_bank(addr)) // 4)
                        plain.add(int(_bank(row * TILE + 4 * logical)) // 4)
                assert len(quads) == 8
                assert len(plain) == 2


def test_swizzle_keeps_row_reads_and_stores_conflict_free():
    """A warp reading one row's 32 consecutive logical words (the hash
    leg), a warp's cp.async chunks of one row, and the writer lanes'
    out_s stores each meet distinct banks."""
    for row in range(16):
        for warp in range(8):
            tid = warp * 32 + LANE
            addr = row * TILE + (tid ^ (kernels.ring_swizzle(row) << 2))
            assert len(set(_bank(addr).tolist())) == 32
        for first in range(0, 64, 32):  # 32 threads, 32 chunks of the row
            c = first + LANE % 32
            d = c ^ kernels.ring_swizzle(row)
            assert len(set((d % 8).tolist())) == 8  # each quad of banks 4 times
            assert len(set(d.tolist())) == 32
    stride = TILE + 1  # kOutStride
    for warp in range(8):
        for grp in range(4):
            for j in range(4):
                addrs = [(4 * 0 + h) * stride + warp * 32 + 8 * grp + 2 * tig + j
                         for h in (0, 1) for tig in (0, 2)]
                assert len(set(_bank(addrs).tolist())) == 4


# ---------------------------------------------------------------------------
# the plan, the packed arguments, the grid
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_plans(monkeypatch):
    """_encp_plan on the CPU: the grid sized for an H100's SMs."""
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    kernels._encp_plan.cache_clear()
    yield kernels._encp_plan
    kernels._encp_plan.cache_clear()


def test_plan_made_once_per_call_shape(cpu_plans):
    cpu = torch.device("cpu")
    a = cpu_plans(4, 8, 4, W, 256, "swar", cpu)
    for _ in range(3):
        assert cpu_plans(4, 8, 4, W, 256, "swar", cpu) is a
    b = cpu_plans(1, 8, 4, W, 0, "swar", cpu)
    c = cpu_plans(4, 8, 4, W, 256, "mxu", cpu)
    assert b is not a and c is not a
    assert cpu_plans.cache_info().misses == 3
    assert a.terms == c.terms == kernels.ctypes.addressof(kernels.parity_terms(8, 4).blob)
    assert a.amat == 0 and c.amat == c.operand.data_ptr() and a.operand is None
    assert a.tiles_per_block == 13 and c.tiles_per_block == 20
    with pytest.raises(ValueError, match="parity_shards >= 1"):
        cpu_plans(1, 8, 0, 4096, 0, "swar", cpu)
    with pytest.raises(ValueError, match="group"):
        cpu_plans(1, 8, 4, 4100, 256, "swar", cpu)
    with pytest.raises(ValueError, match="formulation"):
        cpu_plans(1, 8, 4, 4096, 0, "bogus", cpu)


@pytest.mark.parametrize("B,k,m,w,group", [(4, 8, 4, W, 256), (1, 8, 4, W, 0),
                                           (2, 12, 4, 4096, 256), (3, 5, 3, 4100, 0)])
def test_plan_buffer_layout(cpu_plans, B, k, m, w, group):
    """One buffer holds parity, packed, flags, digests and the ticket, back
    to back, each view inside it and no two overlapping; packed starts
    16-byte aligned, and the ticket is the word after the digests (the
    entry zeroes both with one memset)."""
    plan = cpu_plans(B, k, m, w, group, "swar", torch.device("cpu"))
    buf = torch.arange(plan.buf_words, dtype=torch.int32)
    parity = buf.as_strided(*plan.parity)
    digests = buf.as_strided(*plan.digests)
    n, g = k + m, (w // TILE if group else 0)
    assert parity.shape == (B, m, w) and digests.shape == (B, n, 8)
    used = [parity]
    if group:
        packed, flags = buf.as_strided(*plan.packed), buf.as_strided(*plan.flags)
        assert packed.shape == (B, m, w) and flags.shape == (B, m, g)
        assert plan.packed_off == 4 * B * m * w and plan.packed_off % 16 == 0
        assert plan.flags_off == plan.packed_off + 4 * B * m * w
        used += [packed, flags]
    else:
        assert plan.no_flags.shape == (B, m, 0)
        assert plan.flags_off == plan.packed_off == 4 * B * m * w
    assert plan.acc_off == plan.flags_off + 4 * B * m * g
    used.append(digests)
    seen = torch.cat([t.reshape(-1) for t in used])
    assert seen.unique().numel() == seen.numel()  # no overlap
    assert int(digests.reshape(-1)[-1]) == plan.buf_words - 2  # then the ticket
    assert plan.acc_off // 4 + B * n * 8 + 1 == plan.buf_words


def test_packed_argument_layout():
    """_ENCODE_PIPE_ARGS is EncodePipeArgs: 8 addresses, 8 int32, the u32
    byte count and 4 bytes of padding (static_assert'ed at 104 in
    codec.cu, and exported by mtt_constants)."""
    args = kernels._ENCODE_PIPE_ARGS
    assert args.size == 104
    raw = args.pack(*range(1, 9), *range(10, 18), 0xFFFFFFFF)
    assert np.array_equal(np.frombuffer(raw[:64], "<u8"), np.arange(1, 9))
    assert np.array_equal(np.frombuffer(raw[64:96], "<i4"), np.arange(10, 18))
    assert np.frombuffer(raw[96:100], "<u4")[0] == 0xFFFFFFFF and raw[100:] == b"\0" * 4
    assert kernels._constants()["encode_pipe_args_bytes"] == (104,)


def test_k5_grid_and_windows():
    """K5 swar: 3 blocks per SM over the stripes (K1's grid); K5 mxu: 2,
    as K6; windows from K5's own grid."""
    assert kernels.encode_pipelined_grid(4, W, SMS) == (13, 99)
    assert kernels.encode_pipelined_grid(1, W, SMS) == (4, 320)
    assert kernels.encode_pipelined_grid(4, W, SMS, True) == kernels.pipelined_grid(4, W, SMS)
    assert kernels.encode_pipelined_grid(2, 8, SMS) == (1, 1)
    assert kernels.pipeline_windows(4, W, SMS, encode=True) == 4 * (1280 - 99)
    assert kernels.pipeline_windows(1, W, SMS, encode=True) == 1280 - 320
    assert kernels.pipeline_windows(4, W, SMS, encode=True, mxu=True) == 4 * (1280 - 64)
    assert kernels.pipeline_windows(1, W, SMS) == 1280 - 256  # K6


def test_cpu_wrapper_stays_plain_and_checks():
    words = _data(1, 8, 1024, seed=5)
    t = tcs.words_to_tensor(words, "cpu")
    for group in (0, 256):
        for form in ("swar", "mxu"):
            got = kernels.encode_pack_pipelined(t, 4, 4096, group, form)
            want = kernels.encode_pack_pipelined_plain(t, 4, 4096, group, form)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="parity_shards >= 1"):
        kernels.encode_pack_pipelined(t, 0, 4096)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.encode_pack_pipelined(t[:, :, :1022].contiguous(), 4, 4088)
    assert kernels._lib is None  # no library was built or loaded


@pytest.mark.parametrize("o,s,want", [(4, 8, 352), (8, 8, 656), (1, 1, 352), (16, 16, 1264)])
def test_ring_design_ops(o, s, want):
    """chip_smoke.mxu_ring_design_ops: per word column, 3 permutes per
    n-tile for its B word and 19 per pair of m-tiles for the repack (K7's
    first product, which took 19 per m-tile, is gone)."""
    import chip_smoke

    assert chip_smoke.mxu_ring_design_ops(o, s) == want

