"""The Hopper designs of K2 phash256_batched and K6
verify_reconstruct_pipelined, emulated on the CPU.

Neither kernel can run here, so these tests hold each design's
decomposition against the references without a card:

* K2: a numpy emulation of the kernel's grid (``kernels.phash_grid``),
  its thread -> column-quad and row-group assignment, the per-row
  partition registers, the warp's transposing fold (lane by lane, with
  the shuffle steps of ``warp_fold8`` in csrc/codec.cu), the shared-memory
  and global XOR atomics and the last block's length fold, at ragged row
  counts and widths, against ``phash256_host_batched`` and
  ``minio_tpu.ops.hash.phash256_words_batched``.
* K6: the term program ``kernels.vr_terms`` walked as the kernel walks it
  (copies from the ring slots, then each rebuilt row in Horner form over
  the coefficient bits) for every EC 8+4 and 4+2 survivor pattern,
  against the reconstruction-matrix product and the encoded data, and
  against ``rs_pallas.verify_reconstruct_pipelined`` in interpret mode.
* The plan and the term program are made once per (present, k).

Everything is integer arithmetic: the tolerance is zero.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf, hash as thash, kernels, rs
from tests.test_torch_threads import torch_threads  # noqa: F401

SMS = 132  # an H100's SMs: the grid the wrappers size on the card
U32 = np.uint32


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(U32)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _warp_fold8(v: np.ndarray) -> np.ndarray:
    """warp_fold8 lane by lane: v (..., 32 lanes, 8) -> (..., 32), lane l
    holding word 4*l[4] + 2*l[3] + l[2] of the XOR over the warp."""
    v = v.copy()
    lane = np.arange(32)
    for half in (4, 2, 1):
        hi = (lane & (half * 4)) != 0
        partner = lane ^ (half * 4)
        for i in range(half):
            send = np.where(hi, v[..., i], v[..., i + half])
            keep = np.where(hi, v[..., i + half], v[..., i])
            v[..., i] = keep ^ send[..., partner]
    x = v[..., 0]
    x = x ^ x[..., lane ^ 2]
    return x ^ x[..., lane ^ 1]


def _fold_word(lane: np.ndarray) -> np.ndarray:
    return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1)


def emulate_k2(words: np.ndarray, nbytes: int) -> np.ndarray:
    """K2 on a (R, w) uint32 array, block by block, as the kernel runs."""
    R, w = words.shape
    tpb = kernels.phash_grid(R, w, SMS)
    nq = w // 4
    span = tpb * kernels.TILE  # quads per block
    gx = -(-nq // span)
    gy = -(-R // kernels._PHASH_ROWS)
    idx = np.arange(w, dtype=U32)
    key = thash._mix_np(idx * thash._C1 + U32(1))  # hash_key(col)
    m1 = thash._mix_np((words ^ key) * thash._M1)
    m2 = thash._mix_np((words + key) * thash._M2)
    # thread (bx, tid) owns quads bx * span + t * 256 + tid, t < tpb; the
    # quad's 4 words are one word of each partition
    pad = gx * span - nq
    quads = np.stack([m1.reshape(R, nq, 4), m2.reshape(R, nq, 4)], axis=-2)
    quads = np.concatenate(
        [quads, np.zeros((R, pad, 2, 4), dtype=U32)], axis=1
    ).reshape(R, gx, tpb, kernels.TILE, 8)
    h = np.bitwise_xor.reduce(quads, axis=2)  # (R, gx, 256 threads, 8)
    partials = np.zeros((R, 8), dtype=U32)
    lane = np.arange(32)
    writers = lane % 4 == 0
    for by in range(gy):
        r0 = by * kernels._PHASH_ROWS
        for r in range(r0, min(r0 + kernels._PHASH_ROWS, R)):
            for bx in range(gx):
                s = np.zeros(8, dtype=U32)
                warps = h[r, bx].reshape(kernels.TILE // 32, 32, 8)
                x = _warp_fold8(warps)
                for wx in range(warps.shape[0]):
                    for ln in lane[writers]:
                        s[_fold_word(ln)] ^= x[wx, ln]
                partials[r] ^= s
    # the last block's length fold (finalize_if_last)
    lenmix = U32((nbytes * int(thash._C1)) & 0xFFFFFFFF)
    fold = lenmix + np.arange(8, dtype=U32)
    return thash._mix_np(partials ^ fold)


def test_warp_fold8_is_a_transposed_xor():
    v = _words((3, 32, 8), seed=8)
    got = _warp_fold8(v)
    want = np.bitwise_xor.reduce(v, axis=1)  # (3, 8)
    lane = np.arange(32)
    assert np.array_equal(got, want[:, _fold_word(lane)])
    # each word has exactly one writer lane per warp among lanes % 4 == 0
    assert sorted(_fold_word(lane[lane % 4 == 0])) == list(range(8))


@pytest.mark.parametrize("R,w", list(itertools.product([1, 3, 33], [4, 8, 4104, 131076])))
def test_k2_emulation_matches_references(R, w):
    words = _words((R, w), seed=R * 7 + w)
    got = emulate_k2(words, 4 * w)
    assert np.array_equal(got, thash.phash256_host_batched(words, 4 * w))
    jax_ref = np.asarray(jhash.phash256_words_batched(jnp.asarray(words), 4 * w))
    assert np.array_equal(got, jax_ref)


def test_k2_grid_is_one_wave():
    """The main path's (32, 327,680): 320 quad tiles x 8 row groups in 256
    blocks of 10 tiles, inside 2 blocks per SM; small inputs one tile."""
    W = 327_680
    assert kernels.phash_grid(32, W, SMS) == 10
    tiles = -(-(W // 4) // kernels.TILE)
    assert -(-tiles // 10) * 8 <= 2 * SMS
    assert kernels.phash_grid(1, 4, SMS) == 1
    assert kernels.phash_grid(33, 131076, SMS) >= 1


def test_k2_wrapper_cpu_is_plain_and_checks_width():
    words = _words((2, 3, 1000), seed=3)
    t = tcs.words_to_tensor(words, "cpu")
    got = kernels.phash256_batched(t, 4000)
    assert got.shape == (2, 3, 8)
    assert np.array_equal(
        tcs.tensor_to_words(got), thash.phash256_host_batched(words, 4000)
    )
    with pytest.raises(ValueError):
        kernels.phash256_batched(tcs.words_to_tensor(_words((2, 6), 1), "cpu"), 24)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _xtime(x: np.ndarray) -> np.ndarray:
    return ((x & U32(0x7F7F7F7F)) << U32(1)) ^ (
        ((x & U32(0x80808080)) >> U32(7)) * U32(0x1D)
    )


def walk_terms(shards: np.ndarray, present, k: int) -> np.ndarray:
    """K6's product on (n, w) uint32 shard words, as the kernel walks its
    term program: slot j holds present row rows[j]; copies first, then
    each rebuilt row's Horner steps over bits 7 .. 0 and slots 0 .. KB-1."""
    t = kernels.vr_terms(tuple(present), k)
    kb = t.masks.shape[-1]
    w = shards.shape[1]
    x = [shards[t.rows[j]] if j < len(t.rows) else np.zeros(w, U32)
         for j in range(kb)]
    out = np.full((k, w), 0xDEADBEEF, dtype=U32)  # every row must be written
    for j, d in enumerate(t.copy):
        if d >= 0:
            out[d] = shards[t.rows[j]]
    for o, d in enumerate(t.rebuilt):
        acc = np.zeros(w, U32)
        for b in range(7, -1, -1):
            acc = _xtime(acc)
            for j in range(kb):
                acc ^= x[j] & t.masks[o, b, j]
        out[d] = acc
    return out


def _patterns(k, m, lost):
    n = k + m
    for gone in itertools.combinations(range(n), lost):
        yield tuple(i not in gone for i in range(n))


CASES = [(8, 4, lost) for lost in range(5)] + [(4, 2, lost) for lost in range(3)]


@pytest.mark.parametrize("k,m,lost", CASES)
def test_k6_term_walk_every_survivor_pattern(k, m, lost):
    """Copies + Horner walk == the reconstruction-matrix product (the
    port's plain GF product) == the encoded data, for every pattern with
    ``lost`` shards absent (garbage in their rows)."""
    n, w = k + m, 16
    data = _words((k, w), seed=k * 100 + lost)
    parity = gf.encode_ref(data.view(np.uint8).reshape(k, -1), m)
    full = np.concatenate([data, parity.view(U32).reshape(m, w)])
    for present in _patterns(k, m, lost):
        shards = full.copy()
        for r, p in enumerate(present):
            if not p:
                shards[r] = _words((w,), seed=r)
        got = walk_terms(shards, present, k)
        idx = tuple(i for i, p in enumerate(present) if p)[:k]
        rmat = gf.reconstruction_matrix(k, m, idx)
        want = rs.gf_matmul_words(rmat, tcs.words_to_tensor(shards[None], "cpu"), idx)
        assert np.array_equal(got, tcs.tensor_to_words(want)[0]), present
        assert np.array_equal(got, data), present


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4), (6, 3)])
def test_k6_term_program_structure(k, m):
    """Copies are exactly the present data rows and their matrix rows are
    unit vectors at their slot; rebuilt rows are the absent data rows;
    the masks are the coefficient bits, zero past k."""
    n = k + m
    for lost in range(m + 1):
        for present in _patterns(k, m, lost):
            t = kernels.vr_terms(present, k)
            idx = tuple(i for i, p in enumerate(present) if p)[:k]
            rmat = gf.reconstruction_matrix(k, m, idx)
            assert t.rows == tuple(i for i in range(n) if present[i])
            assert t.rebuilt == tuple(d for d in range(k) if not present[d])
            assert sorted(d for d in t.copy if d >= 0) == [
                d for d in range(k) if present[d]
            ]
            for j, d in enumerate(t.copy):
                if d >= 0:
                    assert list(rmat[d]) == [int(i == j) for i in range(k)]
            for o, d in enumerate(t.rebuilt):
                for j in range(t.masks.shape[-1]):
                    c = int(rmat[d, j]) if j < k else 0
                    bits = [(c >> b) & 1 for b in range(8)]
                    assert list(t.masks[o, :, j] != 0) == [bool(x) for x in bits]
            assert not t.masks[len(t.rebuilt):].any()
            assert t.present_mask == sum(1 << i for i in t.rows)


def test_k6_term_walk_matches_p7_interpret():
    """At heal's pattern (shards 1, 3, 10, 12 gone) and a 2-tile width,
    the term walk rebuilds what P7 rebuilds, and the plain K6 digests of
    the present rows equal P7's."""
    k, m, w = 8, 4, 8192
    present = tuple(i not in (0, 2, 9, 11) for i in range(k + m))
    shards = _words((1, k + m, w), seed=6)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    data, partials = rs_pallas.verify_reconstruct_pipelined(
        jnp.asarray(shards), idx, k, m, interpret=True
    )
    assert np.array_equal(walk_terms(shards[0], present, k), np.asarray(data)[0])
    _d, dig = kernels.verify_reconstruct_pipelined_plain(
        tcs.words_to_tensor(shards, "cpu"), present, k, 4 * w
    )
    want = np.asarray(jhash.finalize_partials(partials, 4 * w))
    pres = np.asarray(present)
    assert np.array_equal(tcs.tensor_to_words(dig)[:, pres], want[:, pres])


def test_plan_and_terms_made_once_per_pattern(monkeypatch):
    """The term program once per (present, k) and K4's launch plan once
    per call shape (here one shape per pattern), the plan holding the
    cached program."""
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    kernels.vr_terms.cache_clear()
    kernels._vr_plan.cache_clear()
    cpu = torch.device("cpu")
    pats = [tuple(i not in lost for i in range(12))
            for lost in [(0, 2, 9, 11), (), (5,)]]

    def plan(p):
        return kernels._vr_plan(1, 12, 8, 327_680, p, "swar", True, cpu)

    try:
        first = {p: (kernels.vr_terms(p, 8), plan(p)) for p in pats}
        for _ in range(5):
            for p in pats:
                terms, got = kernels.vr_terms(p, 8), plan(p)
                assert terms is first[p][0] and got is first[p][1]
                assert got.terms is terms
        assert kernels.vr_terms.cache_info().misses == len(pats)
        assert kernels._vr_plan.cache_info().misses == len(pats)
    finally:
        kernels._vr_plan.cache_clear()


def test_k6_wrapper_cpu_is_plain():
    """On a CPU tensor the wrapper runs the plain version (no term
    program is needed there)."""
    k, m, w = 8, 4, 64
    present = tuple(i not in (0, 2, 9, 11) for i in range(k + m))
    shards = tcs.words_to_tensor(_words((2, k + m, w), seed=9), "cpu")
    got = kernels.verify_reconstruct_pipelined(shards, present, k, 4 * w)
    want = kernels.verify_reconstruct_plain(shards, present, k, 4 * w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4)])
def test_k6_term_blob_layout(k, m):
    """The packed buffer the launch passes (make_terms in codec.cu):
    masks, then 16 staged rows, 16 copy targets, kRbMax rebuilt rows."""
    present = tuple(i not in (0, k + 1) for i in range(k + m))
    t = kernels.vr_terms(present, k)
    raw = bytes(t.blob)
    nm = t.masks.nbytes
    rbmax = t.masks.shape[0]
    assert len(raw) == nm + 32 + rbmax
    assert np.array_equal(np.frombuffer(raw[:nm], "<u4").reshape(t.masks.shape), t.masks)
    rows = np.frombuffer(raw[nm:nm + 16], np.uint8)
    copy = np.frombuffer(raw[nm + 16:nm + 32], np.int8)
    rebuilt = np.frombuffer(raw[nm + 32:], np.uint8)
    assert tuple(rows[:len(t.rows)]) == t.rows and not rows[len(t.rows):].any()
    assert tuple(copy[:len(t.copy)]) == t.copy and (copy[len(t.copy):] == -1).all()
    assert tuple(rebuilt[:len(t.rebuilt)]) == t.rebuilt


def test_digest_view_of_the_accumulator():
    """The wrappers return the first R * 8 words of the accumulator +
    ticket buffer as a contiguous (*lead, 8) view."""
    acc = torch.arange(3 * 4 * 8 + 1, dtype=torch.int32)
    view = kernels._rows_view(acc, (3, 4))
    assert view.is_contiguous() and torch.equal(view, acc[:-1].view(3, 4, 8))
    assert view.data_ptr() == acc.data_ptr()
    assert torch.equal(kernels._rows_view(acc[:9], ()), acc[:8])
