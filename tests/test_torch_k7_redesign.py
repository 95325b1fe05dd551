"""The Hopper design of K7 gf_matmul_mxu, emulated on the CPU.

The kernel cannot run here, so these tests hold its decomposition
against the references without a card:

* The persistent walk (``kernels.k7_grid``, 2 blocks per SM, 1 past 8
  output rows): which block takes which 1,024-byte tiles, every tile
  exactly once, the blocks past the last tile returning at once.
* The ring: the producer warp's bulk copies into ``_K7_STAGES`` stages,
  the full and empty mbarriers' phases (each wait sees its own tile, a
  stage is refilled only after every compute warp read it), every byte of every input row
  copied in exactly once, stale bytes past the ragged end left in the
  slot; the padded rows (``_K7_ROW_STRIDE``) a bijection into the slot,
  and the 16-byte loads of each quarter warp on 8 different quads of
  banks.
* The thread-staged path (a base off alignment, length % 16 != 0): each
  tile staged byte by byte with zeros past length, stores byte by byte.
* The transposed product lane by lane: the A words by byte permutes for
  each row bucket, ``mma.m16n8k128`` on 1-bit values with
  ``kernels.k7_fragments`` as B (held against the PTX-order emulator of
  tests/test_torch_pipelined_design.py), one funnel shift a count, and
  each lane's 16-byte stores, masked at length.
* The whole launch against P3 (``rs_pallas.gf_matmul_mxu`` in interpret
  mode), ``rs.gf_matmul_mxu_plain`` and ``gf.encode_ref``, for the
  matrices 1x1, EC 8+4 parity (4x8), the rows that rebuild 4 lost data
  shards (4x8), 8x8 and 16x16 at lengths 5, 1,024, 8,192 + 17,
  4,104 x 4 + 3 and one that gives each block several tiles.
* K7's own operand against ``rs.bit_matrix``, the shared ``mxu_fragments``
  (K1, K4-K6 [mxu]) unchanged, the operand and grid made once,
  the packed argument struct and the constants against codec.cu, the
  wrapper's checks, and ``chip_smoke.k7_design_ops``.

Everything is integer arithmetic: the tolerance is zero.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import gf as jgf, rs_pallas
from minio_tpu_torch.ops import gf, kernels, rs
from tests.test_torch_pipelined_design import _byte_perm, _mma_b1
from tests.test_torch_threads import torch_threads  # noqa: F401

TILE = kernels.K7_TILE
STRIDE = kernels._K7_ROW_STRIDE
STAGES = kernels._K7_STAGES
WARPS = 8
SMS = 132  # an H100's SMs: the grid the wrapper sizes on the card
# SMs of a small card for the walks: 4 blocks, so that a few kilobytes
# give blocks several tiles, and some blocks none
WALK_SMS = 2
LANE = np.arange(32)
G, TIG = LANE >> 2, LANE & 3
CHUNK = 8 * np.arange(WARPS)[:, None] + G[None, :]  # (warp, lane) -> 16-byte chunk


def _lost(k, m, lost):
    return tuple(i for i in range(k + m) if i not in lost)


MATRICES = {
    "1x1": np.array([[0x8E]], dtype=np.uint8),
    "parity 4x8": gf.parity_matrix(8, 4),
    # the rows that rebuild data shards 0-3 of EC 8+4 when they are lost
    "recon 4x8": gf.reconstruction_matrix(8, 4, _lost(8, 4, (0, 1, 2, 3)))[:4],
    "recon 8x8": gf.reconstruction_matrix(8, 4, _lost(8, 4, (0, 2, 9, 11))),
    "dense 16x16": np.random.default_rng(16).integers(0, 256, (16, 16)).astype(np.uint8),
}
# 5 bytes (one ragged tile), one tile, 9 tiles with a ragged end (one
# block left without a tile on the walk's card), 17 tiles with a 3-byte
# end, and 41 tiles: 11 a block
LENGTHS = [5, 1024, 8192 + 17, 4104 * 4 + 3, 40 * 1024 + 48]


def _shards(s, length, seed):
    x = np.random.default_rng(seed).integers(0, 256, (s, length), dtype=np.uint8)
    x[:, :16] = 0xFF
    x[:, 16:32] = 0x80
    return x


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def walk(length: int, sms: int, o: int = 4, s: int = 8) -> list:
    """k7_grid's runs: per block, (first tile, count); count <= 0 for a
    block past the last tile."""
    blocks, tpb = kernels.k7_grid(length, sms, o, s)
    ntiles = -(-length // TILE)
    return [(b * tpb, min(tpb, ntiles - b * tpb)) for b in range(blocks)]


def mma_counts(a0: np.ndarray, a1: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.m16n8k128 .b1 .and.popc of many warps at once: a0, a1 (...,
    32 lanes) are rows g and g + 8 of A, b (32 lanes) column g of B, each
    over the bits 32 tig ..; returns (..., 32 lanes, 4) counts in the
    PTX fragment order (rows g, g + 8; columns 2 tig, 2 tig + 1)."""
    a = np.concatenate([a0.reshape(a0.shape[:-1] + (8, 4)),
                        a1.reshape(a1.shape[:-1] + (8, 4))], axis=-2)  # (..., 16, tig)
    bm = b.astype(np.uint64).reshape(8, 4)  # (n, tig)
    d = np.bitwise_count(a[..., :, None, :].astype(np.uint64) & bm).sum(-1)  # (..., 16, 8)
    return np.stack([d[..., G, 2 * TIG], d[..., G, 2 * TIG + 1],
                     d[..., G + 8, 2 * TIG], d[..., G + 8, 2 * TIG + 1]], axis=-1)


def quarter_warp_banks(addr: np.ndarray, active: np.ndarray) -> None:
    """A 16-byte shared load of one warp: each quarter warp's active
    lanes meet distinct quads of banks (one wavefront each)."""
    for q in range(4):
        lanes = slice(8 * q, 8 * q + 8)
        quads = (addr[lanes][active[lanes]] // 16) % 8
        assert len(set(quads.tolist())) == len(quads)


def operands(slot: np.ndarray, s: int, sb: int) -> np.ndarray:
    """k7_operands of every lane of every warp: (warp, lane, 16) A words
    (byte column p of the lane's chunk; byte i from input row tig + 4i).
    Checks the banks of each of the lane's 16-byte loads."""
    words = np.ascontiguousarray(slot).view("<u4").astype(np.uint64)  # (s, STRIDE / 4)
    x = np.zeros((WARPS, 32, sb // 4, 4), np.uint64)
    for i in range(sb // 4):
        r = TIG + 4 * i
        ok = r < s
        for w in range(WARPS):
            addr = np.minimum(r, s - 1) * STRIDE + 16 * CHUNK[w]
            quarter_warp_banks(addr, ok)
            for q in range(4):
                x[w, :, i, q] = np.where(ok, words[np.minimum(r, s - 1), 4 * CHUNK[w] + q], 0)
    a = np.zeros((WARPS, 32, 16), np.uint64)
    for q in range(4):
        w0 = x[..., 0, q]
        if sb == 4:
            for r in range(4):
                a[..., 4 * q + r] = w0 >> np.uint64(8 * r)
        elif sb == 8:
            w1 = x[..., 1, q]
            for r in range(4):
                a[..., 4 * q + r] = _byte_perm(w0, w1, r | ((4 + r) << 4))
        else:
            w1, w2, w3 = x[..., 1, q], x[..., 2, q], x[..., 3, q]
            lo01, hi01 = _byte_perm(w0, w1, 0x5140), _byte_perm(w0, w1, 0x7362)
            lo23, hi23 = _byte_perm(w2, w3, 0x5140), _byte_perm(w2, w3, 0x7362)
            a[..., 4 * q] = _byte_perm(lo01, lo23, 0x5410)
            a[..., 4 * q + 1] = _byte_perm(lo01, lo23, 0x7632)
            a[..., 4 * q + 2] = _byte_perm(hi01, hi23, 0x5410)
            a[..., 4 * q + 3] = _byte_perm(hi01, hi23, 0x7632)
    return a


def funnel(acc: np.ndarray, d: np.ndarray) -> np.ndarray:
    """__funnelshift_r(acc, d, 1): d's bit 0 enters at bit 31."""
    return (acc >> np.uint64(1)) | ((d.astype(np.uint64) & np.uint64(1)) << np.uint64(31))


def product(a: np.ndarray, frags: np.ndarray, ob: int, s: int) -> np.ndarray:
    """k7_product of every lane: (warp, lane, ob / 4, 4) output words, word
    q of row tig + 4u holding bytes 4q .. 4q + 3 of the lane's chunk."""
    acc = np.full((WARPS, 32, ob // 4, 4), 0x5A5A5A5A, np.uint64)  # shifted out
    for mu in range(8):
        for u in range(ob // 4):
            for j in range(4):
                d = mma_counts(a[..., mu], a[..., mu + 8], frags[4 * u + j])
                assert d.max() <= 8 * s
                lo, hi = mu >> 2, 2 + (mu >> 2)
                acc[..., u, lo] = funnel(funnel(acc[..., u, lo], d[..., 0]), d[..., 1])
                acc[..., u, hi] = funnel(funnel(acc[..., u, hi], d[..., 2]), d[..., 3])
    return acc


def store(acc, out, writes, o: int, tile: int, vec: bool, stores: dict) -> None:
    """k7_store: row tig + 4u of each lane at its chunk, one 16-byte store
    when ``vec`` and the chunk lies inside length, else the bytes inside."""
    length = out.shape[1]
    for w in range(WARPS):
        for ln in range(32):
            col = tile * TILE + 16 * int(CHUNK[w, ln])
            if col >= length:
                continue
            for u in range(acc.shape[2]):
                row = int(TIG[ln]) + 4 * u
                if row >= o:
                    break
                data = acc[w, ln, u].astype("<u4").view(np.uint8)
                n = min(16, length - col)
                kind = "vec" if vec and n == 16 else "bytes"
                stores[kind] += 1
                out[row, col:col + n] = data[:n]
                writes[row, col:col + n] += 1


def emulate(matrix: np.ndarray, shards: np.ndarray, sms: int = WALK_SMS,
            bulk: "bool | None" = None, runs=None) -> "tuple[np.ndarray, dict]":
    """The whole K7 launch as the kernel runs it: each block's run of
    tiles (``walk``, or ``runs``) through the ring (``bulk``: rows, bases
    and length 16-byte aligned - by default when length % 16 == 0) or
    staged by the threads, the product and the stores.  Returns the
    output and what happened (idle blocks, copies, stores)."""
    o, s = matrix.shape
    length = shards.shape[1]
    sb, ob = kernels._bucket(s), kernels._bucket(o)
    bulk = length % 16 == 0 if bulk is None else bulk
    assert not bulk or length % 16 == 0
    frags = kernels.k7_fragments(matrix)[:ob]
    out = np.zeros((o, length), np.uint8)
    writes = np.zeros((o, length), np.int64)
    copied = np.zeros((s, length), np.int64)
    info = {"idle": [], "copies": 0, "stores": {"vec": 0, "bytes": 0}, "tiles": []}
    rng = np.random.default_rng(length)

    def compute(slot, tile):
        info["tiles"].append(tile)
        acc = product(operands(slot, s, sb), frags, ob, s)
        store(acc, out, writes, o, tile, bulk, info["stores"])

    for blk, (first, count) in enumerate(runs or walk(length, sms, o, s)):
        if count <= 0:
            info["idle"].append(blk)
            continue
        # the slot bytes the kernel never writes hold what was there
        ring = rng.integers(0, 256, (STAGES, s, STRIDE), dtype=np.uint8)
        if not bulk:
            for i in range(count):
                tile = first + i
                slot = ring[0]
                for r in range(s):  # k7_stage: zeros past length
                    for wd in range(TILE // 4):
                        col = tile * TILE + 4 * wd
                        v = np.zeros(4, np.uint8)
                        n = max(0, min(4, length - col))
                        v[:n] = shards[r, col:col + n]
                        copied[r, col:col + n] += 1
                        slot[r, 4 * wd:4 * wd + 4] = v
                compute(slot, tile)
            continue
        full = [0] * STAGES  # completed phases
        empty = [0] * STAGES
        held = [None] * STAGES

        def issue(st, tile):
            col = tile * TILE
            nbytes = min(TILE, length - col)
            assert nbytes % 16 == 0 and nbytes > 0
            for r in range(s):  # one bulk copy a row
                ring[st, r, :nbytes] = shards[r, col:col + nbytes]
                copied[r, col:col + nbytes] += 1
                info["copies"] += 1
            held[st] = tile
            full[st] += 1

        for st in range(min(STAGES, count)):  # the producer: the first stages at once
            issue(st, first + st)
        for i in range(count):  # the compute warps
            st, parity = i % STAGES, (i // STAGES) & 1
            # mbar_wait(full[st], parity): the phase of parity `parity`
            # completed, and no later one (the stage is not refilled early)
            assert full[st] == i // STAGES + 1 and (full[st] & 1) != parity
            assert held[st] == first + i
            compute(ring[st], first + i)
            empty[st] += 1  # every compute warp's arrival
            if i + STAGES < count:  # the producer's wait on empty[st], then its refill
                assert empty[st] == i // STAGES + 1 and (empty[st] & 1) != parity
                issue(st, first + i + STAGES)
    assert (copied == 1).all()  # every input byte brought in once
    assert (writes == 1).all()  # every output byte stored once
    assert sorted(info["tiles"]) == list(range(-(-length // TILE)))
    return out, info


# ---------------------------------------------------------------------------
# the walk, the ring and the banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("o,s", [(4, 8), (8, 8), (8, 16), (16, 4)])
@pytest.mark.parametrize("length,sms", [(5, SMS), (1024, SMS), (1024 * 1280, SMS),
                                        (1024 * 1280 - 16, SMS), (300 * 1024, SMS),
                                        (8192 + 17, WALK_SMS), (40 * 1024 + 48, WALK_SMS)])
def test_walk_takes_every_tile_once(length, sms, o, s):
    """Contiguous runs: every tile once, in order, at most 2 blocks per
    SM (1 past 8 output rows, or 8 with 16 inputs), every block but those
    past the last tile has work."""
    runs = walk(length, sms, o, s)
    ntiles = -(-length // TILE)
    tiles = [t for first, count in runs for t in range(first, first + max(count, 0))]
    assert tiles == list(range(ntiles))
    assert len(runs) <= sms * (2 if (o, s) in ((4, 8), (8, 8)) else 1)
    blocks, tpb = kernels.k7_grid(length, sms, o, s)
    idle = [b for b, (_f, c) in enumerate(runs) if c <= 0]
    assert idle == list(range(-(-ntiles // tpb), blocks))
    assert all(c == tpb for _f, c in runs[:-(len(idle) + 1)])


def test_main_shape_grid():
    """EC 8+4 parity over a 10 MiB block's shards: 1,280 tiles on 264
    blocks of 5, the last 8 blocks idle; 16 output rows: 132 blocks of
    10; one tile: one block."""
    assert kernels.k7_grid(1024 * 1280, SMS, 4, 8) == (264, 5)
    runs = walk(1024 * 1280, SMS)
    assert sum(c > 0 for _f, c in runs) == 256
    assert kernels.k7_grid(1024 * 1280, SMS, 16, 16) == (132, 10)
    assert kernels.k7_grid(1024, SMS, 4, 8) == (1, 1)
    assert kernels.k7_grid(5, SMS, 16, 1) == (1, 1)


def test_slot_rows_are_a_bijection_and_loads_meet_distinct_banks():
    """Row r of a slot at r * kMxRowStride: the rows' bytes never overlap,
    every row starts 16-byte aligned (the bulk copy's destination), and
    for every row count and warp the quarter warps' 16-byte loads of rows
    tig + 4i meet 8 different quads of banks."""
    assert STRIDE % 16 == 0 and STRIDE >= TILE and TILE // 16 == 8 * WARPS
    for s in range(1, 17):
        offs = (np.arange(s)[:, None] * STRIDE + np.arange(TILE)[None, :]).ravel()
        assert len(np.unique(offs)) == offs.size and offs.max() < s * STRIDE
        for i in range(kernels._bucket(s) // 4):
            r = TIG + 4 * i
            for w in range(WARPS):
                quarter_warp_banks(np.minimum(r, s - 1) * STRIDE + 16 * CHUNK[w], r < s)
    # without the padding, rows 4 apart would meet the same banks
    r = TIG
    addr = r * TILE + 16 * CHUNK[0]
    with pytest.raises(AssertionError):
        quarter_warp_banks(addr, np.ones(32, bool))


@pytest.mark.parametrize("count", [1, 3, 4, 5, 11])
def test_ring_phases(count):
    """The ring of one block over runs shorter and longer than its depth:
    copies in flight before the first wait, each wait sees its tile,
    every tile copied once (emulate asserts each step)."""
    m = MATRICES["parity 4x8"]
    x = _shards(8, count * TILE, seed=count)
    got, info = emulate(m, x, runs=[(0, count)])
    assert info["copies"] == 8 * count and not info["idle"]
    assert np.array_equal(got, rs.gf_matmul_mxu_plain(m, torch.from_numpy(x)).numpy())


def test_mma_emulator_matches_ptx_order_emulator():
    """mma_counts equals the lane-by-lane PTX fragment emulator the K5
    [mxu] tests use."""
    rng = np.random.default_rng(7)
    for _ in range(4):
        a = rng.integers(0, 1 << 32, (32, 2), dtype=np.uint64)
        b = rng.integers(0, 1 << 32, 32, dtype=np.uint64)
        want = _mma_b1(a, b)
        got = mma_counts(a[:, 0], a[:, 1], b)
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# K7's operand
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATRICES))
def test_k7_fragments_hold_the_bit_matrix(name):
    """Decoding k7_fragments gives rs.bit_matrix back: n-tile j, lane (g,
    tig), bit 8i + b is entry (8 (g // 2 + 4 (j // 4)) + 2 (j % 4) + g % 2,
    8 (tig + 4i) + b); zeros past (o, s)."""
    m = MATRICES[name]
    o, s = m.shape
    f = kernels.k7_fragments(m)
    assert f.shape == (16, 32) and f.dtype == np.uint32
    want = np.zeros((128, 128), np.uint8)
    want[:8 * o, :8 * s] = rs.bit_matrix(m)
    got = np.zeros((128, 128), np.uint8)
    for j in range(16):
        for ln in range(32):
            g, tig = ln >> 2, ln & 3
            row = 8 * (g // 2 + 4 * (j // 4)) + 2 * (j % 4) + g % 2
            for i in range(4):
                for b in range(8):
                    got[row, 8 * (tig + 4 * i) + b] = (int(f[j, ln]) >> (8 * i + b)) & 1
    assert np.array_equal(got, want)
    assert not f[4 * -(-o // 4):].any()  # n-tiles past the output rows


def _mxu_fragments_by_formula(matrix):
    """The [mxu] kernels' A operand as its docstring defines it, entry by
    entry: m-tile t, lane tig + 4g, word h: the lifted row for bit g % 4 +
    4h of output row 2t + g // 4, over input bits 32 tig .. 32 tig + 31."""
    o, s = matrix.shape
    full = np.zeros((128, 128), np.uint8)
    full[:8 * o, :8 * s] = rs.bit_matrix(matrix)
    out = np.zeros((8, 32, 2), np.uint32)
    for t in range(8):
        for ln in range(32):
            g, tig = ln >> 2, ln & 3
            for h in range(2):
                row = 8 * (2 * t + g // 4) + g % 4 + 4 * h
                bits = full[row, 32 * tig:32 * tig + 32].astype(np.uint64)
                out[t, ln, h] = int((bits << np.arange(32, dtype=np.uint64)).sum())
    return out


@pytest.mark.parametrize("name", ["parity 4x8", "recon 8x8", "dense 16x16", "1x1"])
def test_shared_mxu_operand_is_unchanged(name):
    """K1, K4, K5 and K6 [mxu] keep their operand: mxu_fragments and
    _mxu_operand as before, and K7's is a different array."""
    m = MATRICES[name]
    want = _mxu_fragments_by_formula(m)
    assert np.array_equal(kernels.mxu_fragments(m), want)
    op = kernels._mxu_operand(m, torch.device("cpu"))
    assert np.array_equal(op.numpy().view(np.uint32), want)
    assert op.shape == (8, 32, 2)
    assert kernels.k7_fragments(m).shape != want.shape


# ---------------------------------------------------------------------------
# the whole launch against the references
# ---------------------------------------------------------------------------


def _p3(matrix, x):
    return np.asarray(rs_pallas.gf_matmul_mxu(matrix, jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_launch_matches_p3_and_plain(name, length):
    """The emulated launch equals P3 in interpret mode and the port's
    plain version bit for bit (the bulk path where length % 16 == 0, the
    thread-staged path otherwise)."""
    m = MATRICES[name]
    o, s = m.shape
    x = _shards(s, length, seed=o * 31 + s + length)
    got, info = emulate(m, x)
    plain = rs.gf_matmul_mxu_plain(m, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _p3(m, x))
    if length % 16 == 0:
        assert info["stores"]["bytes"] == 0 and info["copies"] > 0
    else:
        assert info["copies"] == 0


@pytest.mark.parametrize("length", [1024, 4104 * 4, 40 * 1024 + 48])
def test_staged_path_on_aligned_lengths(length):
    """A base off 16-byte alignment takes the thread-staged path at any
    length; its output is the bulk path's."""
    m = MATRICES["recon 4x8"]
    x = _shards(8, length, seed=length)
    staged, info = emulate(m, x, bulk=False)
    bulk, _ = emulate(m, x, bulk=True)
    assert info["copies"] == 0 and info["stores"]["vec"] == 0
    assert np.array_equal(staged, bulk)
    assert np.array_equal(staged, rs.gf_matmul_mxu_plain(m, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("length", [64, 8192 + 16, 4104 * 4 + 3])
def test_parity_matches_encode_ref(length):
    """EC 8+4 parity through the emulated launch is gf.encode_ref's (the
    JAX package's and the port's)."""
    x = _shards(8, length, seed=3)
    got, _ = emulate(MATRICES["parity 4x8"], x)
    assert np.array_equal(got, gf.encode_ref(x, 4))
    assert np.array_equal(got, jgf.encode_ref(x, 4))


@pytest.mark.parametrize("o,s", [(1, 1), (3, 5), (4, 4), (5, 8), (8, 12), (9, 3),
                                 (12, 16), (16, 9)])
def test_every_bucket(o, s):
    """Every (row bucket, output bucket) pair the entry dispatches, at a
    ragged 2-tile length, against the plain version."""
    m = np.random.default_rng(o * 17 + s).integers(0, 256, (o, s)).astype(np.uint8)
    x = _shards(s, 2048 + 48, seed=o + s)
    got, _ = emulate(m, x)
    assert np.array_equal(got, rs.gf_matmul_mxu_plain(m, torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# plan, struct, constants, wrapper, design ops
# ---------------------------------------------------------------------------


def _struct_fields(name: str) -> "tuple[list, int]":
    src = (Path(kernels.__file__).parent.parent / "csrc" / "codec.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.strip().splitlines():
        ctype, names = line.strip().rstrip(";").split(None, 1)
        fields.append((ctype, [n.strip() for n in names.split(",")]))
    size = int(re.search(r"static_assert\(sizeof\(%s\) == (\d+)" % name, src).group(1))
    return fields, size


def test_mxu_args_match_codec_cu():
    """_MXU_ARGS packs MxuArgs as codec.cu declares it: in, out, frags,
    stamps, stream; device, o, s, length, blocks, tiles_per_block (64
    bytes, no padding), and mtt_constants exports its size."""
    fields, size = _struct_fields("MxuArgs")
    assert fields == [("uint64_t", ["in", "out", "frags", "stamps", "stream"]),
                      ("int32_t", ["device", "o", "s", "length", "blocks",
                                   "tiles_per_block"])]
    assert kernels._MXU_ARGS.format == "<5Q6i" and kernels._MXU_ARGS.size == size == 64
    assert kernels._constants()["mxu_args_bytes"] == (64,)


def test_constants_match_codec_cu():
    """The tile, row stride, ring depth and residency kernels.py sizes
    with are codec.cu's, and mtt_constants names each."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "codec.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kMx\w+) = ([^;]+);", src))
    assert int(consts["kMxTile"]) == TILE == 1024
    assert consts["kMxRowStride"].strip() == "kMxTile + 32" and STRIDE == TILE + 32
    assert int(consts["kMxStages"]) == STAGES
    assert consts["kMxThreads"].strip() == "kThreads + 32"  # 8 compute warps, 1 producer
    body = re.search(r"constexpr int k7_min_blocks\(int sb, int ob\) \{ (.*?) \}", src).group(1)
    assert body == "return ob <= 8 && sb + ob <= 20 ? 2 : 1;"
    got = [[kernels.k7_blocks_per_sm(o, s) for o in (4, 8, 16)] for s in (4, 8, 16)]
    assert got == [[2, 2, 1], [2, 2, 1], [2, 1, 1]]
    assert kernels._constants()["mxu_blocks_per_sm"] == (2, 2, 1, 2, 2, 1, 2, 1, 1)
    for name in ("mxu_tile_bytes", "mxu_row_stride", "mxu_stages",
                 "mxu_blocks_per_sm", "mxu_args_bytes"):
        assert name in kernels._constants() and f"{name}=" in src


def test_operand_and_grid_are_made_once():
    """_k7_operand: K7's B operand on the device, cached per matrix and
    device; k7_grid cached per (length, SMs, o, s)."""
    m = MATRICES["parity 4x8"]
    cpu = torch.device("cpu")
    op = kernels._k7_operand(m.tobytes(), 4, 8, cpu)
    assert kernels._k7_operand(m.tobytes(), 4, 8, cpu) is op
    assert np.array_equal(op.numpy().view(np.uint32), kernels.k7_fragments(m))
    assert kernels.k7_grid(1024 * 1280, SMS, 4, 8) is kernels.k7_grid(1024 * 1280, SMS, 4, 8)
    assert kernels.k7_grid(4096, SMS, 4, 8) == (4, 1)


def _fake(dtype=torch.uint8, shape=(8, 4096), device="cuda", contiguous=True):
    """A stand-in for a tensor: what the wrapper's checks read, no storage."""
    return types.SimpleNamespace(
        dtype=dtype, shape=shape, device=types.SimpleNamespace(type=device, index=0),
        dim=lambda: len(shape), is_contiguous=lambda: contiguous, data_ptr=lambda: 256)


def test_wrapper_checks_and_cpu_plain(monkeypatch):
    """On the CPU the wrapper runs the plain version; a CUDA tensor of the
    wrong dtype or layout, a tensor on another device and o, s > 16 raise
    before anything is built or launched."""
    monkeypatch.setattr(kernels, "_lib", None)
    m = MATRICES["parity 4x8"]
    x = torch.from_numpy(_shards(8, 100, seed=1))
    assert torch.equal(kernels.gf_matmul_mxu(m, x), rs.gf_matmul_mxu_plain(m, x))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.gf_matmul_mxu(m, _fake(device="meta"))
    with pytest.raises(TypeError, match="uint8"):
        kernels.gf_matmul_mxu(m, _fake(dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gf_matmul_mxu(m, _fake(contiguous=False))
    big = np.ones((17, 8), np.uint8)
    with pytest.raises(ValueError, match="o, s <= 16"):
        kernels.gf_matmul_mxu(big, _fake())
    with pytest.raises(ValueError, match="shards"):
        kernels.gf_matmul_mxu(m, _fake(shape=(7, 4096)))
    assert kernels._lib is None


@pytest.mark.parametrize("o,s,want", [(4, 8, 144), (1, 1, 140), (8, 8, 272),
                                      (16, 16, 544), (4, 16, 160)])
def test_k7_design_ops(o, s, want):
    """chip_smoke.k7_design_ops: per word column, the A words' permutes
    (12, 16 or 32 by row bucket) and one funnel shift a count (32 an
    output bucket's n-tile); below mxu_ring_tile's count everywhere."""
    import chip_smoke

    assert chip_smoke.k7_design_ops(o, s) == want
    assert chip_smoke.k7_design_ops(o, s) < chip_smoke.mxu_ring_design_ops(o, s)
