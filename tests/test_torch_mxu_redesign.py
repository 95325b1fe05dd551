"""The Hopper design of K1 encode_pack[mxu] and K4 verify_reconstruct[mxu],
emulated on the CPU.

Neither kernel can run here, so these tests hold the design's
decomposition against the references without a card:

* The register staging both kernels share: thread tid loads 16-byte chunk
  tid % 64 of slots tid / 64 + 4t of the next tile (``load_chunks``),
  stores them after this tile's product into the other of two shared
  buffers at the chunk ``c ^ ring_swizzle(j)`` (``store_chunks``), and one
  barrier a tile separates a buffer's last read from its next write.
  Every chunk of every tile is loaded once, each buffer write is a
  permutation of the tile's chunks, and the hash leg's swizzled reads
  give back the logical tile.
* K1 [mxu]: that walk over ``kernels.pipelined_grid``, K5 [mxu]'s
  product ``mxu_ring_tile`` lane by lane on the buffer
  (``mxu_ring_emulate``), flags a tile late; against P4 under
  ``formulation="mxu"`` in interpret mode and the port's plain version.
* K4 [mxu]: the present rows in the tile (survivors first), the present
  data rows stored straight from the staging registers, only the rb
  rebuilt rows through ``mxu_ring_tile`` with the (rb, k) operand
  (``kernels._mxu_rebuilt_operand``); against ``rs.mxu_rows``,
  ``kernels.verify_reconstruct_plain`` and P5 under ``mxu`` in interpret
  mode, over heal's pattern, all rows present (rb = 0), rb = 1, 3, 4 and
  k = 4, 8, 12.
* The grids, the K4 [mxu] launch plan made once per call shape, its one
  buffer and its packed argument struct.

Everything is integer arithmetic: the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf, hash as thash, kernels, rs
from tests.test_torch_encode_matmul_design import k1_pack
from tests.test_torch_pipelined_design import _ballots, _data, _words, mxu_ring_emulate
from tests.test_torch_threads import torch_threads  # noqa: F401

U32 = np.uint32
TILE = kernels.TILE
CHUNKS = TILE // 4  # 16-byte chunks of a tile row
SMS = 132  # an H100's SMs: the grid the wrappers size on the card
W = 327_680  # words per shard of a 10 MiB EC 8+4 block
PW = 4096  # one P4/P5 tile: the JAX kernels take w % 4096 == 0
# SMs of a small card for the walks: at PW its blocks walk several tiles,
# so both buffers of the double buffer take turns
WALK_SMS = 2


# ---------------------------------------------------------------------------
# the register staging of K1 [mxu] and K4 [mxu]
# ---------------------------------------------------------------------------


def thread_chunks(rows: int) -> dict:
    """load_chunks' assignment: thread tid -> its (slot j, chunk c), chunk
    tid % 64 of slots tid / 64 + 4t for t < bucket(rows) / 4, j < rows."""
    sb = kernels._bucket(rows)
    return {tid: [(tid // CHUNKS + 4 * t, tid % CHUNKS) for t in range(sb // 4)
                  if tid // CHUNKS + 4 * t < rows] for tid in range(TILE)}


def load_chunks(slots: np.ndarray, tile: int, loads: np.ndarray) -> dict:
    """Every thread's registers for one tile of a (rows, w) stripe of
    slots: {(j, c): 4 words}, zeros past w; each load counted in
    ``loads`` (rows, tiles, 64)."""
    rows, w = slots.shape
    regs = {}
    for pairs in thread_chunks(rows).values():
        for j, c in pairs:
            col = tile * TILE + 4 * c
            v = np.zeros(4, U32)
            part = slots[j, col:min(col + 4, w)]
            v[:len(part)] = part
            regs[(j, c)] = v
            loads[j, tile, c] += 1
    return regs


def store_chunks(buf: np.ndarray, regs: dict) -> None:
    """store_chunks: chunk c of slot j at chunk c ^ ring_swizzle(j); every
    chunk of the buffer's slots is written exactly once."""
    written = np.zeros((buf.shape[0], CHUNKS), np.int64)
    for (j, c), v in regs.items():
        d = c ^ kernels.ring_swizzle(j)
        buf[j, 4 * d:4 * d + 4] = v
        written[j, d] += 1
    assert (written == 1).all()


def hash_reads(buf: np.ndarray) -> np.ndarray:
    """The hash leg's reads: thread tid takes slot j's word at tid ^
    (ring_swizzle(j) << 2); (rows, 256) logical words."""
    tid = np.arange(TILE)
    return np.stack([buf[j, tid ^ (kernels.ring_swizzle(j) << 2)]
                     for j in range(buf.shape[0])])


def staged_walk(slots: np.ndarray, B: int, sms: int, compute, on_stage=None) -> None:
    """The tile loop of every block of one stripe on ``pipelined_grid``:
    tile first + i is stored into buffer i & 1 from the registers loaded
    during tile i - 1 (``on_stage(tile, regs)`` sees them, as K4's copies
    do), the next tile's chunks are loaded, one barrier, then
    ``compute(tile, buffer)``.  Checks that a buffer is written only when
    the barrier of the iteration after its last read lies between, that
    the hash reads give back the tile, and that every chunk of every tile
    of the stripe is loaded exactly once."""
    rows, w = slots.shape
    ntiles = -(-w // TILE)
    tpb, per_stripe = kernels.pipelined_grid(B, w, sms)
    loads = np.zeros((rows, ntiles, CHUNKS), np.int64)
    for blk in range(per_stripe):
        first = blk * tpb
        count = min(tpb, ntiles - first)
        assert count >= 1
        bufs = np.zeros((2, rows, TILE), U32)
        last_read = [-2, -2]
        regs = load_chunks(slots, first, loads)
        for i in range(count):
            cur = i & 1
            assert last_read[cur] <= i - 2  # the barrier of iteration i - 1 between
            store_chunks(bufs[cur], regs)
            if on_stage is not None:
                on_stage(first + i, regs)
            if i + 1 < count:
                regs = load_chunks(slots, first + i + 1, loads)
            # __syncthreads(): the tile is staged
            want = np.zeros((rows, TILE), U32)
            part = slots[:, (first + i) * TILE:(first + i + 1) * TILE]
            want[:, :part.shape[1]] = part
            assert np.array_equal(hash_reads(bufs[cur]), want)
            compute(first + i, bufs[cur])
            last_read[cur] = i
        if count > 1:
            assert last_read[0] >= 0 and last_read[1] >= 0  # both buffers took turns
    assert (loads == 1).all()


def ring_product(frags: np.ndarray, buf: np.ndarray, k: int, m: int) -> np.ndarray:
    """mxu_ring_tile of every warp on the swizzled buffer: (m, 256)."""
    out = np.zeros((m, TILE), U32)
    for warp in range(TILE // 32):
        cols = slice(32 * warp, 32 * warp + 32)
        out[:, cols] = mxu_ring_emulate(frags, buf, k, m, warp)[:, cols]
    return out


@pytest.mark.parametrize("rows", [1, 3, 4, 8, 9, 12, 16])
def test_staging_loads_each_chunk_once_and_swizzles_a_permutation(rows):
    """The walk at a width whose last tile is ragged, over blocks of
    several tiles: every chunk loaded once, each buffer write a
    permutation, both buffers in turn."""
    w = 5 * TILE + 100
    slots = _words((rows, w), seed=rows)
    seen = []
    staged_walk(slots, 1, 1, lambda tile, buf: seen.append(tile))
    assert seen == list(range(-(-w // TILE)))


def test_staging_threads_cover_the_tile():
    """load_chunks' threads cover every chunk of the k slot rows exactly
    once, and a warp's 32 threads take 32 consecutive chunks of one slot
    (512 contiguous bytes a load, 4 wavefronts a store after the XOR)."""
    for rows in range(1, 17):
        pairs = [p for ps in thread_chunks(rows).values() for p in ps]
        assert sorted(pairs) == [(j, c) for j in range(rows) for c in range(CHUNKS)]
    for rows in (8, 16):
        chunks = thread_chunks(rows)
        for warp in range(TILE // 32):
            for t in range(len(chunks[32 * warp])):
                js = {chunks[32 * warp + ln][t][0] for ln in range(32)}
                cs = [chunks[32 * warp + ln][t][1] for ln in range(32)]
                assert len(js) == 1 and cs == list(range(cs[0], cs[0] + 32))
                (j,) = js
                assert len({c ^ kernels.ring_swizzle(j) for c in cs}) == 32


# ---------------------------------------------------------------------------
# K1 [mxu]
# ---------------------------------------------------------------------------


def k1_mxu_emulate(words: np.ndarray, m: int, group: int, sms: int = WALK_SMS):
    """K1 [mxu]'s outputs: the staged walk per stripe, mxu_ring_tile on
    the buffer, parity stored for the valid columns, each tile's flags
    published after the next barrier; digests by the port's host phash256
    of data + parity (the hash leg is K1's), the pack leg K1's."""
    B, k, w = words.shape
    frags = kernels.mxu_fragments(gf.parity_matrix(k, m))
    g = w // TILE if group else 0
    parity = np.full((B, m, w), 0xDEADBEEF, U32)
    flags = np.full((B, m, g), 7, U32)
    for b in range(B):
        def compute(tile, buf, b=b):
            acc = ring_product(frags, buf, k, m)
            col = tile * TILE + np.arange(TILE)
            valid = col < w
            parity[b, :, col[valid]] = acc[:, valid].T
            if group:
                flags[b, :, tile] = np.bitwise_or.reduce(_ballots(acc, valid), axis=1) != 0

        staged_walk(words[b], B, sms, compute)
    digests = np.stack([
        thash.phash256_host_batched(np.concatenate([words[b], parity[b]]), 4 * w)
        for b in range(B)
    ])
    if not group:
        return parity, digests, np.zeros((B, m, 0), U32), parity
    packed = np.stack([k1_pack(parity[b], flags[b]) for b in range(B)])
    return parity, digests, flags, packed


@pytest.mark.parametrize("k,m,group", [(8, 4, 256), (12, 4, 0)])
def test_k1_mxu_walk_matches_p4_mxu_interpret(k, m, group):
    """The whole K1 [mxu] walk against P4 with formulation="mxu" in
    interpret mode (parity, digests, flags, packed prefix) and the port's
    plain version."""
    words = _data(1, k, PW, seed=5 * k + m)
    got = k1_mxu_emulate(words, m, group)
    parity, partials, flags, packed = rs_pallas.encode_pack_fused(
        jnp.asarray(words), m, group=group, formulation="mxu", interpret=True)
    assert np.array_equal(got[0], np.asarray(parity))
    assert np.array_equal(got[1], np.asarray(jhash.finalize_partials(partials, 4 * PW)))
    if group:
        assert np.array_equal(got[2], np.asarray(flags).astype(U32))
        kept = np.asarray(flags).sum(axis=-1) * group
        for r in range(m):
            n = int(kept[0, r])
            assert np.array_equal(got[3][0, r, :n], np.asarray(packed)[0, r, :n])
    want = kernels.encode_pack(tcs.words_to_tensor(words, "cpu"), m, 4 * PW, group,
                               formulation="mxu")
    for a, b in zip(got, want):
        assert np.array_equal(a, tcs.tensor_to_words(b))


def test_k1_mxu_walk_ragged_width_matches_plain():
    """A width whose last tile is ragged (zeros past w in the buffer, no
    store or hash there), B = 2, against the port's plain version."""
    w = 3 * TILE + 36
    words = _data(2, 4, w, seed=11)
    got = k1_mxu_emulate(words, 3, 0, sms=1)
    want = kernels.encode_pack_plain(tcs.words_to_tensor(words, "cpu"), 3, 4 * w, 0, "mxu")
    for a, b in zip(got, want):
        assert np.array_equal(a, tcs.tensor_to_words(b))


# ---------------------------------------------------------------------------
# K4 [mxu]
# ---------------------------------------------------------------------------


def k4_mxu_emulate(shards: np.ndarray, present: tuple, k: int, sms: int = WALK_SMS):
    """K4 [mxu]'s outputs: per stripe the walk over the np present rows
    (slot j = vr_terms' rows[j]), the copies stored from the staging
    registers, the rb rebuilt rows from mxu_ring_tile with the (rb, k)
    operand; digests of the present rows by the port's host phash256,
    the absent rows' the finalize of zero partials."""
    B, n, w = shards.shape
    terms = kernels.vr_terms(present, k)
    rows, copy, rebuilt = terms.rows, terms.copy, terms.rebuilt
    rb = len(rebuilt)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    rmat = gf.reconstruction_matrix(k, n - k, idx)
    frags = kernels.mxu_fragments(rmat[list(rebuilt)])
    op = tcs.tensor_to_words(kernels._mxu_rebuilt_operand(present, k, torch.device("cpu")))
    assert np.array_equal(op.reshape(frags.shape), frags)
    data = np.full((B, k, w), 0xDEADBEEF, U32)
    writes = np.zeros((B, k, w), np.int64)
    for b in range(B):
        def on_stage(tile, regs, b=b):
            for (j, c), v in regs.items():
                col = tile * TILE + 4 * c
                if copy[j] >= 0 and col < w:  # a 16-byte store (w % 4 == 0)
                    data[b, copy[j], col:col + 4] = v
                    writes[b, copy[j], col:col + 4] += 1

        def compute(tile, buf, b=b):
            if not rb:
                return
            acc = ring_product(frags, buf, k, rb)
            col = tile * TILE + np.arange(TILE)
            valid = col < w
            for o, d in enumerate(rebuilt):
                data[b, d, col[valid]] = acc[o, valid]
                writes[b, d, col[valid]] += 1

        staged_walk(shards[b][list(rows)], B, sms, compute, on_stage)
    assert (writes == 1).all()  # every data word once: a copy or a rebuilt row
    digests = tcs.tensor_to_words(thash.finalize_partials(
        torch.zeros((B, n, 8), dtype=torch.int32), 4 * w))
    for b in range(B):
        digests[b, list(rows)] = thash.phash256_host_batched(shards[b][list(rows)], 4 * w)
    return data, digests


def _present(n, absent):
    return tuple(i not in absent for i in range(n))


# (k, m, absent rows, rebuilt rows)
K4_CASES = {
    "heal's pattern": (8, 4, (0, 2, 9, 11), 2),
    "all present": (8, 4, (), 0),
    "rb=1": (8, 4, (5,), 1),
    "rb=3": (8, 4, (0, 1, 2), 3),
    "rb=4": (8, 4, (0, 1, 2, 3), 4),
    "k=4": (4, 2, (0, 3), 2),
    "k=12": (12, 4, (1, 7, 13), 2),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_mxu_walk_matches_mxu_rows_plain_and_p5_interpret(case):
    """The whole K4 [mxu] walk against rs.mxu_rows of the survivors, the
    port's plain version and P5 with formulation="mxu" in interpret mode
    (data, and the digests of the present rows)."""
    k, m, absent, rb = K4_CASES[case]
    n = k + m
    present = _present(n, absent)
    assert len(kernels.vr_terms(present, k).rebuilt) == rb
    shards = _words((1, n, PW), seed=7 * k + len(absent))
    data, digests = k4_mxu_emulate(shards, present, k)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    rmat = gf.reconstruction_matrix(k, m, idx)
    mxu = rs.mxu_rows(rmat, tcs.words_to_tensor(shards[0][list(idx)], "cpu"))
    assert np.array_equal(data[0], tcs.tensor_to_words(mxu))
    t = tcs.words_to_tensor(shards, "cpu")
    want = kernels.verify_reconstruct_plain(t, present, k, 4 * PW, "mxu")
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(digests, tcs.tensor_to_words(want[1]))
    p5_data, partials = rs_pallas.verify_reconstruct_fused(
        jnp.asarray(shards), idx, k, m, formulation="mxu", interpret=True)
    assert np.array_equal(data, np.asarray(p5_data))
    live = np.asarray(present)
    p5_dig = np.asarray(jhash.finalize_partials(partials, 4 * PW))
    assert np.array_equal(digests[:, live], p5_dig[:, live])


def test_k4_mxu_walk_eight_rebuilt_rows_ragged_width():
    """The 8-row bucket of the product (EC 8+8, every data row absent: no
    copy, 8 rebuilt rows) at a ragged width and B = 2, against the plain
    version."""
    k, n, w = 8, 16, 2 * TILE + 8
    present = _present(n, range(8))
    shards = _words((2, n, w), seed=3)
    data, digests = k4_mxu_emulate(shards, present, k, sms=1)
    want = kernels.verify_reconstruct_plain(tcs.words_to_tensor(shards, "cpu"), present,
                                            k, 4 * w, "mxu")
    assert np.array_equal(data, tcs.tensor_to_words(want[0]))
    assert np.array_equal(digests, tcs.tensor_to_words(want[1]))


@pytest.mark.parametrize("case", list(K4_CASES))
def test_rebuilt_operand_holds_only_the_rebuilt_rows(case):
    """The (rb, k) operand: the reconstruction matrix's rows that are not
    unit rows, in mxu_fragments order, zero past rb (all zero at rb = 0);
    vr_terms' copies are the unit rows, whose slot is their one
    coefficient."""
    k, m, absent, rb = K4_CASES[case]
    present = _present(k + m, absent)
    terms = kernels.vr_terms(present, k)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    rmat = gf.reconstruction_matrix(k, m, idx)
    for j, d in enumerate(terms.copy):
        if d >= 0:
            assert j < k and np.array_equal(rmat[d], np.eye(k, dtype=np.uint8)[j])
    assert sorted(terms.rebuilt + tuple(d for d in terms.copy if d >= 0)) == list(range(k))
    op = tcs.tensor_to_words(kernels._mxu_rebuilt_operand(present, k, torch.device("cpu")))
    assert op.shape == (8, 32, 2)
    assert np.array_equal(op, kernels.mxu_fragments(rmat[list(terms.rebuilt)]))
    assert not op[-(-rb // 2):].any()  # m-tiles past the rebuilt rows are zero


# ---------------------------------------------------------------------------
# grids, the K4 [mxu] plan, its buffer and its packed arguments
# ---------------------------------------------------------------------------


def test_mxu_kernels_take_the_persistent_grid(monkeypatch):
    """K1 [mxu] and K4 [mxu] run kernels.pipelined_grid (2 blocks per SM,
    the residency their __launch_bounds__ hold); K1 swar keeps its own."""
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    kernels._enc_plan.cache_clear()
    cpu = torch.device("cpu")
    try:
        assert kernels._enc_plan(4, 8, 4, W, 256, "mxu", cpu).tiles_per_block == 20
        assert kernels._enc_plan(1, 8, 4, W, 0, "mxu", cpu).tiles_per_block == 5
        assert kernels._enc_plan(4, 8, 4, W, 256, "swar", cpu).tiles_per_block == 13
    finally:
        kernels._enc_plan.cache_clear()
    assert kernels.pipelined_grid(4, W, SMS) == (20, 64)
    assert kernels.pipelined_grid(1, W, SMS) == (5, 256)
    assert kernels.pipelined_grid(2, 8, SMS) == (1, 1)


@pytest.fixture
def vr_plans(monkeypatch):
    """K4's launch plan under mxu for whole rows (_vr_plan) on the CPU:
    the grid sized for an H100's SMs."""
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    kernels._vr_plan.cache_clear()
    yield lambda B, n, k, w, present, device: kernels._vr_plan(
        B, n, k, w, present, "mxu", True, device)
    kernels._vr_plan.cache_clear()


def test_vr_mxu_plan_made_once_per_call_shape(vr_plans):
    cpu = torch.device("cpu")
    heal, every = _present(12, (0, 2, 9, 11)), _present(12, ())
    a = vr_plans(1, 12, 8, W, heal, cpu)
    for _ in range(3):
        assert vr_plans(1, 12, 8, W, heal, cpu) is a
    b = vr_plans(4, 12, 8, W, heal, cpu)
    c = vr_plans(1, 12, 8, W, every, cpu)
    assert b is not a and c is not a and kernels._vr_plan.cache_info().misses == 3
    assert (a.np, a.rb, a.tiles_per_block) == (8, 2, 5)
    assert (b.tiles_per_block, c.np, c.rb) == (20, 12, 0)
    t = a.terms
    assert t is kernels.vr_terms(heal, 8)
    assert t.present_mask == sum(1 << i for i, p in enumerate(heal) if p)
    assert t.rows == (1, 3, 4, 5, 6, 7, 8, 10)
    assert t.copy == (1, 3, 4, 5, 6, 7, -1, -1)
    assert t.rebuilt == (0, 2)
    assert a.operand is kernels._mxu_rebuilt_operand(heal, 8, cpu)
    assert a.amat == a.operand.data_ptr()
    with pytest.raises(ValueError, match="need 8 shards"):
        vr_plans(1, 12, 8, W, _present(12, (0, 1, 2, 3, 4)), cpu)
    with pytest.raises(ValueError, match="one word"):
        vr_plans(1, 12, 8, 0, heal, cpu)


@pytest.mark.parametrize("B,n,k,w", [(1, 12, 8, W), (4, 12, 8, W), (2, 6, 4, 4104)])
def test_vr_mxu_buffer_layout(vr_plans, B, n, k, w):
    """One buffer holds data, digests and the ticket, back to back: data
    at offset 0 (16-byte aligned for the copies' 16-byte stores), the
    digests after it, the ticket the word after the digests (the entry
    zeroes digests and ticket with one memset); no overlap."""
    present = _present(n, (0,))
    plan = vr_plans(B, n, k, w, present, torch.device("cpu"))
    buf = torch.arange(plan.buf_words, dtype=torch.int32)
    data, digests = buf.as_strided(*plan.data), buf.as_strided(*plan.digests)
    assert data.shape == (B, k, w) and digests.shape == (B, n, 8)
    assert data.storage_offset() == 0 and (4 * w) % 16 == 0
    assert plan.acc_off == 4 * B * k * w
    seen = torch.cat([data.reshape(-1), digests.reshape(-1)])
    assert seen.unique().numel() == seen.numel() == plan.buf_words - 1
    assert int(digests.reshape(-1)[-1]) == plan.buf_words - 2  # then the ticket
    assert plan.ticket_off == 4 * (plan.buf_words - 1)


def test_vr_mxu_packed_argument_layout():
    """_VR_ARGS is VrArgs, which K4 [mxu] shares with K4 swar and X3: 7
    addresses, 10 int32, 3 u32 and 4 bytes of padding - 112 bytes
    (static_assert'ed in codec.cu, exported by mtt_constants); the slots
    travel in the term program's blob."""
    args = kernels._VR_ARGS
    assert args.size == 112
    raw = args.pack(*range(1, 8), *range(10, 20), 0xFFFFFFFF, 7, 1 << 31)
    assert np.array_equal(np.frombuffer(raw[:56], "<u8"), np.arange(1, 8))
    assert np.array_equal(np.frombuffer(raw[56:96], "<i4"), np.arange(10, 20))
    assert np.frombuffer(raw[96:108], "<u4").tolist() == [0xFFFFFFFF, 7, 1 << 31]
    assert raw[108:] == bytes(4)
    consts = kernels._constants()
    assert consts["vr_args_bytes"] == (112,) and consts["rebuilt_max"] == (8,)


def test_cpu_wrappers_stay_plain():
    """On the CPU both mxu wrappers run their plain versions (no library
    is built or loaded), with the same outputs as swar."""
    shards = tcs.words_to_tensor(_words((1, 12, 1024), seed=2), "cpu")
    present = _present(12, (0, 2, 9, 11))
    got = kernels.verify_reconstruct(shards, present, 8, 4096, "mxu")
    for want in (kernels.verify_reconstruct_plain(shards, present, 8, 4096, "mxu"),
                 kernels.verify_reconstruct(shards, present, 8, 4096)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    words = tcs.words_to_tensor(_data(1, 8, 1024, seed=3), "cpu")
    got = kernels.encode_pack(words, 4, 4096, 256, "mxu")
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.encode_pack(words, 4, 4096, 256)))
    assert kernels._lib is None


@pytest.mark.parametrize("o,s,want", [(2, 8, 352), (0, 8, 0), (8, 8, 656)])
def test_rebuilt_rows_design_ops(o, s, want):
    """chip_smoke counts K4 [mxu]'s design work with mxu_ring_design_ops
    over the rebuilt rows: one pair of m-tiles at heal's 2 rows, none
    without a rebuilt row (no product runs)."""
    import chip_smoke

    assert chip_smoke.mxu_ring_design_ops(o, s) == want
