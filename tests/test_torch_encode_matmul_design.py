"""The Hopper designs of K1 encode_pack and K3 gf_matmul_words, emulated
on the CPU.

Neither kernel can run here, so these tests hold each design's
decomposition against the references without a card:

* K1: the parity product as the kernel walks it - the straight-line
  Horner steps of the generated ``fixed_parity`` (``kernels.fixed_source``,
  read back line by line) for the fixed geometries, and the masked
  Horner form over the term program (``kernels.parity_terms``, expanded
  to all-ones / zero masks as ``expand_masks`` does) for every other -
  then the per-warp flag ballots of each 256-column tile and the pack
  leg's slot placement.  Against ``gf.encode_ref``, the port's plain
  version, ``rs_pallas.encode_pack_fused`` (P4) and
  ``rs_pallas.encode_hash_fused`` (P2) in interpret mode, at EC 8+4,
  4+2, 12+4 and one (k, m) in each row bucket of the entry.
* K3: copies for the unit rows and the masked Horner form over column
  quads for the others (``kernels.gf_terms``), for every EC 8+4 survivor
  pattern with 0-4 rows absent, every EC 4+2 one and edge matrices,
  against the port's plain product, the encoded data and
  ``rs_pallas.matmul_words`` (P1) in interpret mode.
* The term programs are made once per (k, m) and per (matrix, rows), the
  CPU wrappers stay the plain versions, and the loader's check of the
  constants codec.cu exports.

Everything is integer arithmetic: the tolerance is zero.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import gf as jgf, hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf, hash as thash, kernels, rs
from tests.test_torch_threads import torch_threads  # noqa: F401

U32 = np.uint32
SMS = 132  # an H100's SMs: the grid the wrappers size on the card
W = 327_680  # words per shard of a 10 MiB EC 8+4 block


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(U32)


def _sign_bytes(x: np.ndarray) -> np.ndarray:
    """prmt.b32 x, 0, 0xBA98: each byte 0xFF where its top bit is set."""
    b = np.ascontiguousarray(x).view(np.uint8)
    return np.where(b & 0x80, np.uint8(0xFF), np.uint8(0)).astype(np.uint8).view(U32)


def _xtime(x: np.ndarray) -> np.ndarray:
    """codec.cu's xtime: the shifted bytes, reduced through the sign-spread
    bytes."""
    return ((x & U32(0x7F7F7F7F)) << U32(1)) ^ (_sign_bytes(x) & U32(0x1D1D1D1D))


def _masks(bits: np.ndarray, rows: int, sb: int) -> np.ndarray:
    """expand_masks: (rows, 8, sb) all-ones / zero words."""
    j = np.arange(sb)
    on = (bits[:rows, :, None].astype(np.int64) >> j) & 1
    return np.where(on != 0, U32(0xFFFFFFFF), U32(0)).astype(U32)


def _horner_masked(x: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """horner<SB>: one product row over x (sb, ...) with masks (8, sb):
    xtime, then the terms four inputs at a time, for bit 7 .. 0."""
    acc = np.zeros(x.shape[1:], U32)
    for b in range(7, -1, -1):
        acc = _xtime(acc)
        for j in range(0, x.shape[0], 4):
            for i in range(4):
                acc ^= x[j + i] & masks[b, j + i]
    return acc


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

_FIXED_HEAD = re.compile(r"void fixed_parity<(\d+), (\d+)>\(")
_FIRST = re.compile(r"^uint32_t a = (.*);$")
_STEP = re.compile(r"^a = xtime\(a\)(.*);$")
_STORE = re.compile(r"^acc\[(\d+)\] = (a|0u);$")


def fixed_programs() -> dict:
    """The generated mtt_fixed.cuh read back: (k, m) -> per parity row,
    its Horner steps as lists of input indices (empty: a zero row)."""
    progs, cur, steps = {}, None, []
    for line in kernels.fixed_source().splitlines():
        line = line.strip()
        head = _FIXED_HEAD.search(line)
        if head:
            cur = progs.setdefault((int(head.group(1)), int(head.group(2))), {})
            continue
        first, step, store = _FIRST.match(line), _STEP.match(line), _STORE.match(line)
        if first:
            steps = [[int(v) for v in re.findall(r"x\[(\d+)\]", first.group(1))]]
        elif step:
            steps.append([int(v) for v in re.findall(r"x\[(\d+)\]", step.group(1))])
        elif store:
            cur[int(store.group(1))] = steps if store.group(2) == "a" else []
            steps = []
    return progs


def _run_fixed(prog: dict, x: np.ndarray, m: int) -> np.ndarray:
    """fixed_parity as generated: each row's straight-line steps."""
    out = np.zeros((m,) + x.shape[1:], U32)
    for r in range(m):
        acc = np.zeros(x.shape[1:], U32)
        for i, inputs in enumerate(prog[r]):
            if i:
                acc = _xtime(acc)
            for j in inputs:
                acc = acc ^ x[j]
        out[r] = acc
    return out


def k1_parity(data: np.ndarray, m: int, form: str = "entry") -> np.ndarray:
    """K1's product on (k, w) data words: the fixed program where the
    entry has one (``form="entry"``), else the masked Horner form."""
    k = data.shape[0]
    if form == "fixed" or (form == "entry" and (k, m) in kernels.FIXED_GEOMETRIES):
        return _run_fixed(fixed_programs()[(k, m)], data, m)
    kb = kernels._bucket(k)
    x = np.zeros((kb,) + data.shape[1:], U32)
    x[:k] = data
    masks = _masks(kernels.parity_terms(k, m).bits, m, kb)
    return np.stack([_horner_masked(x, masks[r]) for r in range(m)]) if m else (
        np.zeros((0,) + data.shape[1:], U32))


def k1_flags(parity: np.ndarray) -> np.ndarray:
    """The per-warp ballots of each 256-column tile, OR-ed by the
    tile's m first threads: (m, w) -> (m, w / 256) 0/1."""
    m, w = parity.shape
    nz = (parity != 0).reshape(m, w // kernels.TILE, kernels.TILE // 32, 32)
    ballots = (nz.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return (np.bitwise_or.reduce(ballots, axis=-1) != 0).astype(U32)


def k1_pack(parity: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """pack_kernel: nonzero group j to slot nz_before(j), zero group j to
    slot kept + (j - nz_before(j)) as zeros."""
    m, w = parity.shape
    t = kernels.TILE
    out = np.full_like(parity, 0xDEADBEEF)
    for r in range(m):
        kept = int(flags[r].sum())
        nz = 0
        for j in range(w // t):
            slot = nz if flags[r, j] else kept + (j - nz)
            out[r, slot * t:(slot + 1) * t] = parity[r, j * t:(j + 1) * t] if flags[r, j] else 0
            nz += int(flags[r, j])
    return out


def k1_emulate(words: np.ndarray, m: int, group: int):
    """(B, k, w) -> parity, finalized digests, flags, packed as K1 writes
    them (digests from the port's host phash256 of data + parity)."""
    B, k, w = words.shape
    parity = np.stack([k1_parity(words[b], m) for b in range(B)])
    digests = np.stack([
        thash.phash256_host_batched(np.concatenate([words[b], parity[b]]), 4 * w)
        for b in range(B)
    ])
    if not group:
        return parity, digests, np.zeros((B, m, 0), U32), parity
    flags = np.stack([k1_flags(parity[b]) for b in range(B)])
    packed = np.stack([k1_pack(parity[b], flags[b]) for b in range(B)])
    return parity, digests, flags, packed


# one (k, m) per (bucket(k), bucket(m)) the entry takes, plus m = 0
BUCKET_GEOMS = [(3, 2), (4, 6), (2, 12), (6, 3), (8, 8), (5, 11), (13, 3),
                (10, 6), (16, 16), (4, 0)]


def _data(k, w, seed):
    words = _words((2, k, w), seed)
    words[0, :, :8] = 0xFFFFFFFF
    words[1, :, 256:1024] = 0  # zero groups for the pack leg
    return words


def test_fixed_source_lists_every_fixed_geometry():
    src = kernels.fixed_source()
    listed = re.search(r"#define MTT_FIXED_GEOMETRIES\(X\)(.*)", src).group(1)
    assert re.findall(r"X\((\d+), (\d+)\)", listed) == [
        (str(k), str(m)) for k, m in kernels.FIXED_GEOMETRIES
    ]
    progs = fixed_programs()
    assert sorted(progs) == sorted(kernels.FIXED_GEOMETRIES)
    for (k, m), prog in progs.items():
        assert sorted(prog) == list(range(m))


def test_fixed_parity_8_4_runs_only_the_set_terms():
    """EC 8+4: 116 set coefficient bits of 256 candidates, 4 x 7 xtimes."""
    prog = fixed_programs()[(8, 4)]
    assert sum(len(s) for row in prog.values() for s in row) == 116
    assert sum(len(row) - 1 for row in prog.values()) == 28
    pm = gf.parity_matrix(8, 4)
    assert 116 == sum(bin(int(v)).count("1") for v in pm.reshape(-1))


@pytest.mark.parametrize("k,m", [(8, 4), (12, 4), (4, 2)] + BUCKET_GEOMS)
def test_k1_product_matches_encode_ref(k, m):
    """Both forms of the product (the generated fixed steps where the
    entry has them, the masked Horner form everywhere) equal the numpy
    encode of the JAX package and the port."""
    data = _words((k, 264), seed=k * 31 + m)
    data[:, :4] = 0xFFFFFFFF
    want = jgf.encode_ref(data.view(np.uint8).reshape(k, -1), m).view(U32).reshape(m, data.shape[1])
    assert np.array_equal(k1_parity(data, m, "masked"), want)
    assert np.array_equal(k1_parity(data, m), want)
    assert np.array_equal(
        want, gf.encode_ref(data.view(np.uint8).reshape(k, -1), m).view(U32).reshape(m, data.shape[1]))


@pytest.mark.parametrize("k,m,group", [
    (k, m, group) for k, m in BUCKET_GEOMS for group in ((0, 256) if m else (0,))
])
def test_k1_emulation_matches_plain_per_bucket(k, m, group):
    """The whole K1 emulation (product, ballots, pack) equals the port's
    plain encode_pack in every row bucket (the plain version is held to
    P4 in tests/test_torch_ops.py)."""
    w = 2048
    words = _data(k, w, seed=k * 17 + m)
    got = k1_emulate(words, m, group)
    want = kernels.encode_pack(tcs.words_to_tensor(words, "cpu"), m, 4 * w, group)
    for a, b in zip(got, want):
        assert np.array_equal(a, tcs.tensor_to_words(b))


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4)])
def test_k1_emulation_matches_p4_interpret(k, m):
    """Parity, digests, flags and packed of the emulation equal P4's
    (group 256) in interpret mode, at a 1-tile (4,096-word) width."""
    w = 4096
    words = _data(k, w, seed=k + m)[:1]
    parity, partials, flags, packed = rs_pallas.encode_pack_fused(
        jnp.asarray(words), m, group=256, interpret=True
    )
    got = k1_emulate(words, m, 256)
    assert np.array_equal(got[0], np.asarray(parity))
    assert np.array_equal(got[1], np.asarray(jhash.finalize_partials(partials, 4 * w)))
    assert np.array_equal(got[2], np.asarray(flags))
    assert np.array_equal(got[3], np.asarray(packed))


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4), (6, 3)])
def test_k1_group0_matches_p2_interpret(k, m):
    """Without the pack leg K1 computes P2 (heal's re-encode)."""
    w = 4096
    words = _data(k, w, seed=3 * k + m)
    parity, partials = rs_pallas.encode_hash_fused(jnp.asarray(words), m, interpret=True)
    got = k1_emulate(words, m, 0)
    assert np.array_equal(got[0], np.asarray(parity))
    assert np.array_equal(got[1], np.asarray(jhash.finalize_partials(partials, 4 * w)))


def test_k1_ballots_flag_every_nonzero_group():
    parity = np.zeros((3, 4 * 256), U32)
    parity[0, 5] = 1  # warp 0 of group 0
    parity[1, 256 + 255] = 0x80  # the last lane of group 1
    parity[2, 3 * 256 + 100] = 7
    assert k1_flags(parity).tolist() == [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]]


def test_parity_terms_made_once_per_geometry():
    kernels.parity_terms.cache_clear()
    first = {g: kernels.parity_terms(*g) for g in [(8, 4), (4, 2), (12, 4)]}
    for _ in range(4):
        for g, t in first.items():
            assert kernels.parity_terms(*g) is t
    assert kernels.parity_terms.cache_info().misses == 3
    t = first[(8, 4)]
    assert t.out == (0, 1, 2, 3) and t.copy == (-1,) * 8  # no copies in K1


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def k3_emulate(matrix: np.ndarray, shards: np.ndarray, rows) -> np.ndarray:
    """K3 on (R, w) uint32 shard words as the kernel walks its term
    program: column quads of the s inputs, the copies stored from them,
    then each product row in Horner form over the masks; every output row
    must be written once."""
    o, s = matrix.shape
    t = kernels.gf_terms(matrix, rows)
    sb = kernels._bucket(s)
    w = shards.shape[1]
    nq = -(-w // 4)
    x = np.zeros((sb, 4 * nq), U32)
    for j in range(s):
        x[j, :w] = shards[t.rows[j]]
    x = x.reshape(sb, nq, 4)
    out = np.full((o, nq, 4), 0xDEADBEEF, U32)
    written = []
    for j in range(s):
        if t.copy[j] >= 0:
            out[t.copy[j]] = x[j]
            written.append(t.copy[j])
    masks = _masks(t.bits, len(t.out), sb)
    for r, d in enumerate(t.out):
        out[d] = _horner_masked(x, masks[r])
        written.append(d)
    assert sorted(written) == list(range(o))
    return out.reshape(o, -1)[:, :w]


def _patterns(k, m):
    n = k + m
    for lost in range(m + 1):
        for gone in itertools.combinations(range(n), lost):
            yield tuple(i not in gone for i in range(n))


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2)])
def test_k3_every_survivor_pattern(k, m):
    """Copies + Horner == the reconstruction-matrix product == the
    encoded data for every pattern with 0..m rows absent (garbage in the
    absent rows); the copies are exactly the present data rows."""
    n, w = k + m, 36
    data = _words((k, w), seed=k)
    parity = gf.encode_ref(data.view(np.uint8).reshape(k, -1), m)
    full = np.concatenate([data, parity.view(U32).reshape(m, w)])
    count = 0
    for present in _patterns(k, m):
        shards = full.copy()
        for r, p in enumerate(present):
            if not p:
                shards[r] = _words((w,), seed=r + 100)
        idx = tuple(i for i, p in enumerate(present) if p)[:k]
        rmat = gf.reconstruction_matrix(k, m, idx)
        got = k3_emulate(rmat, shards, idx)
        want = rs.gf_matmul_words(rmat, tcs.words_to_tensor(shards[None], "cpu"), idx)
        assert np.array_equal(got, tcs.tensor_to_words(want)[0]), present
        assert np.array_equal(got, data), present
        t = kernels.gf_terms(rmat, idx)
        assert sorted(d for d in t.copy if d >= 0) == [d for d in range(k) if present[d]]
        assert t.out == tuple(d for d in range(k) if not present[d])
        count += 1
    assert count == sum(len(list(itertools.combinations(range(n), j))) for j in range(m + 1))


def _edge_cases():
    pm = gf.parity_matrix(8, 4)
    dup = np.zeros((5, 3), dtype=np.uint8)
    dup[0, 1] = dup[2, 1] = dup[3, 0] = 1  # rows 0 and 2 copy input 1
    dup[1] = [7, 200, 1]  # row 4 stays zero
    return [
        ("o=1", pm[:1], tuple(range(8)), 12),
        ("o=16, s=16", gf.parity_matrix(16, 16), tuple(range(16)), 16),
        ("s=16, o=4", gf.parity_matrix(16, 4), tuple(range(15, -1, -1)), 16),
        ("rows out of order", pm, (11, 3, 0, 7, 5, 9, 1, 4), 12),
        ("identity", np.eye(6, dtype=np.uint8), (5, 4, 3, 2, 1, 0), 6),
        ("repeated unit row, zero row", dup, (2, 0, 1), 3),
    ]


@pytest.mark.parametrize("label,matrix,rows,R", _edge_cases(), ids=lambda v: v if isinstance(v, str) else "")
@pytest.mark.parametrize("w", [1, 7, 4104])
def test_k3_edge_matrices(label, matrix, rows, R, w):
    shards = _words((R, w), seed=len(label) + w)
    got = k3_emulate(matrix, shards, rows)
    want = rs.gf_matmul_words(matrix, tcs.words_to_tensor(shards[None], "cpu"), rows)
    assert np.array_equal(got, tcs.tensor_to_words(want)[0])


def test_k3_repeated_unit_row_is_a_product_row():
    """Two output rows with the same unit row: the first is the input's
    copy, the second a product row; a zero row is a product row too."""
    _label, dup, rows, _R = _edge_cases()[-1]
    t = kernels.gf_terms(dup, rows)
    assert t.copy == (3, 0, -1) and t.out == (1, 2, 4)
    assert t.bits[1].tolist() == [2, 0, 0, 0, 0, 0, 0, 0]  # input 1, bit 0
    assert not t.bits[2].any()


@pytest.mark.parametrize("present", [
    (True,) * 12,
    tuple(i != 4 for i in range(12)),
    tuple(i not in (0, 2, 9, 11) for i in range(12)),  # the degraded GET's
    tuple(i not in (0, 1, 2, 3) for i in range(12)),
])
def test_k3_matches_p1_interpret(present):
    k, m, w = 8, 4, 4104
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    rmat = gf.reconstruction_matrix(k, m, idx)
    shards = _words((k + m, w), seed=sum(idx))
    ref = rs_pallas.matmul_words(rmat, jnp.asarray(shards[list(idx)]), interpret=True)
    assert np.array_equal(k3_emulate(rmat, shards, idx), np.asarray(ref))


def test_k3_edge_matches_p1_interpret():
    """A non-square matrix over rows picked out of order."""
    pm = gf.parity_matrix(6, 3)
    rows = (7, 2, 0, 5, 8, 1)
    shards = _words((9, 1000), seed=5)
    ref = rs_pallas.matmul_words(pm, jnp.asarray(shards[list(rows)]), interpret=True)
    assert np.array_equal(k3_emulate(pm, shards, rows), np.asarray(ref))


def test_gf_terms_made_once_per_matrix_and_rows():
    kernels._gf_terms_cached.cache_clear()
    rmat = gf.reconstruction_matrix(8, 4, (1, 3, 4, 5, 6, 7, 8, 9))
    a = kernels.gf_terms(rmat, (1, 3, 4, 5, 6, 7, 8, 9))
    for _ in range(3):
        assert kernels.gf_terms(rmat.copy(), [1, 3, 4, 5, 6, 7, 8, 9]) is a
    b = kernels.gf_terms(rmat, (1, 3, 4, 5, 6, 7, 8, 10))
    assert b is not a and b.rows[-1] == 10
    assert kernels._gf_terms_cached.cache_info().misses == 2


def test_gf_terms_blob_layout():
    """The packed buffer the entries take (make_gf_terms in codec.cu):
    16 x 8 uint16 bits, then 16 input rows, 16 copy targets, 16 product
    rows' outputs."""
    rmat = gf.reconstruction_matrix(8, 4, (1, 3, 4, 5, 6, 7, 8, 9))
    t = kernels.gf_terms(rmat, (1, 3, 4, 5, 6, 7, 8, 9))
    raw = bytes(t.blob)
    assert len(raw) == kernels._GF_TERMS_BYTES == 304
    bits = np.frombuffer(raw[:256], "<u2").reshape(16, 8)
    assert np.array_equal(bits[: len(t.out)], t.bits) and not bits[len(t.out):].any()
    assert tuple(raw[256:264]) == t.rows and not any(raw[264:272])
    copy = np.frombuffer(raw[272:288], np.int8)
    assert tuple(copy[:8]) == t.copy and (copy[8:] == -1).all()
    assert tuple(raw[288:288 + len(t.out)]) == t.out == (0, 2)


def test_vr_terms_share_the_product_program():
    """K6's masks are the reconstruction matrix's term program expanded,
    and its copies K3's copies."""
    present = tuple(i not in (0, 2, 9, 11) for i in range(12))
    idx = tuple(i for i, p in enumerate(present) if p)[:8]
    vt = kernels.vr_terms(present, 8)
    gt = kernels.gf_terms(gf.reconstruction_matrix(8, 4, idx), idx)
    assert vt.rebuilt == gt.out and vt.copy[:8] == gt.copy
    assert np.array_equal(vt.masks[: len(gt.out)], _masks(gt.bits, len(gt.out), 8))


# ---------------------------------------------------------------------------
# wrappers, grids and the shared constants
# ---------------------------------------------------------------------------


def test_cpu_wrappers_stay_plain():
    words = _data(8, 1024, seed=2)
    t = tcs.words_to_tensor(words, "cpu")
    for group in (0, 256):
        got = kernels.encode_pack(t, 4, 4096, group)
        want = kernels.encode_pack_plain(t, 4, 4096, group)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    rmat = gf.reconstruction_matrix(8, 4, (1, 3, 4, 5, 6, 7, 8, 9))
    x = tcs.words_to_tensor(_words((2, 12, 100), 4), "cpu")
    rows = (1, 3, 4, 5, 6, 7, 8, 9)
    assert torch.equal(kernels.gf_matmul_words(rmat, x, rows),
                       rs.gf_matmul_words(rmat, x, rows))
    assert kernels._lib is None  # no library was built or loaded


def test_grids_follow_the_sm_count():
    """K1: about 3 blocks per SM over the stripes, contiguous tile runs
    (mxu: K6's persistent grid, 2 blocks per SM); K3: 4 blocks per SM
    striding over (stripe, quad tile) pairs."""
    assert kernels.encode_grid(4, W, SMS) == (13, 99)
    assert kernels.encode_grid(1, W, SMS) == (4, 320)
    assert kernels.encode_grid(1, 256, SMS) == (1, 1)
    assert kernels.encode_grid(4, W, 66) == (26, 50)
    assert kernels.pipelined_grid(4, W, SMS) == (20, 64)  # mxu
    assert kernels.pipelined_grid(1, W, SMS) == (5, 256)
    assert kernels.gf_grid(4, W, SMS) == 4 * SMS
    assert kernels.gf_grid(1, 256, SMS) == 1
    assert kernels.gf_grid(2, 4101, SMS) == 2 * 5


def test_xtime_doubles_every_byte():
    """The kernels' xtime (shift, then 0x1D where a byte's top bit was set,
    from prmt's sign-spread bytes) is GF(2^8) multiplication by 2 in each
    byte lane."""
    v = np.arange(256, dtype=np.uint8)
    words = np.stack([v, np.roll(v, 1), np.roll(v, 2), v[::-1]], axis=1)
    got = _xtime(np.ascontiguousarray(words).view(U32).reshape(-1)).view(np.uint8)
    want = np.array([jgf.gf_mul(int(b), 2) for b in words.reshape(-1)], np.uint8)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case,want", [
    ("identity", 0), ("x0 ^ 2 x1", 5), ("EC 8+4 parity", 172),
    ("EC 8+4 shards 1, 3, 10, 12 absent", 86),
])
def test_bound_counts_the_product_in_instructions(case, want):
    """chip_smoke.gf_ops, the integer instructions a column of the GF
    product needs: unit rows free, Horner's form or a chain per input,
    whichever is cheaper, with an xtime of 4 and XORs folded two to a
    LOP3."""
    import chip_smoke

    matrix = {
        "identity": np.eye(4, dtype=np.uint8),
        "x0 ^ 2 x1": np.array([[1, 2]], np.uint8),
        "EC 8+4 parity": gf.parity_matrix(8, 4),
        "EC 8+4 shards 1, 3, 10, 12 absent": gf.reconstruction_matrix(
            8, 4, (1, 3, 4, 5, 6, 7, 8, 10)),
    }[case]
    assert chip_smoke.gf_ops(matrix) == want


def test_constants_check_accepts_the_library_string_and_refuses_drift():
    fixed = ",".join(f"{k}x{m}" for k, m in kernels.FIXED_GEOMETRIES)
    text = (
        "tile=256 max_rows=16 phash_rows=4 phash_blocks_per_sm=2 "
        "pipe_blocks_per_sm=2 enc_blocks_per_sm=3 gf_blocks_per_sm=4 "
        "bucket=4,4,4,4,8,8,8,8,16,16,16,16,16,16,16,16 rb_max=4,8,7 "
        "vr_terms_bytes=548,2088,3623 gf_terms_bytes=304 encode_args_bytes=120 "
        "encode_pipe_args_bytes=104 gf_args_bytes=72 vr_args_bytes=112 "
        "rebuilt_max=8 mxu_tile_bytes=1024 mxu_row_stride=1056 mxu_stages=4 "
        "mxu_blocks_per_sm=2,2,1,2,2,1,2,1,1 mxu_args_bytes=64 "
        "ring_swizzle=0,2,4,6 group_args_bytes=56 pack_seg_max=192 "
        "pack_cluster_max=16 flags_batch=4 flags_blocks_per_sm=4 fixed=," + fixed
    )
    kernels._check_constants(text)
    assert kernels.parse_constants(text)["vr_terms_bytes"] == (548, 2088, 3623)
    with pytest.raises(RuntimeError, match="tile"):
        kernels._check_constants(text.replace("tile=256", "tile=128"))
    with pytest.raises(RuntimeError, match="fixed"):
        kernels._check_constants(text.replace(",8x4", ""))
    for kb in (4, 8, 16):  # the K6 blob the wrapper packs has that size
        k = kb // 2 + 1  # in the bucket
        present = tuple(i != 0 for i in range(k + 2))
        assert len(kernels.vr_terms(present, k).blob) == kernels._vr_terms_bytes(kb)
