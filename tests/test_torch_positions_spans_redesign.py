"""K9 ``select_positions`` and K10 ``select_spans`` (minio_tpu_torch.ops.
select_step, csrc/select.cu) as the kernels compute, on the CPU.

``_positions_emulated`` is positions_kernel's arithmetic in int64 numpy
and torch: per block of ``_POS_THREADS`` ranks, warp 0's and warp 1's
searches of the cumsum (128 probes a round, the probes at or below the
key summed) for the first block and the block of the last rank below
the count, the run between them staged (``_POS_RUN`` entries) and
searched per rank, the last rank below the count on warp 1's block, a
rank past the staged run searching the rest in memory, a rank past the
count on the last block; then the word by running popcounts and the bit
by halving popcounts.
``_spans_emulated`` is spans_kernel<BACK>'s: the window's positions inside
the plane, one read of a plane end's byte where the clamp repeats it, and
aligned 16-byte chunks numbered on the absolute address, ``_SPAN_LANES``
lanes of ``_SPAN_CHUNKS`` chunks a step (8 x 1 forward, 4 x 2 backward;
the plane's base offset modulo 16 is a parameter, and the bytes outside
the plane are newlines, so a byte the masks let through would show),
each chunk's newline bits by the SWAR zero test of ``x ^ 0x0A0A0A0A``
gathered by one multiply, masked to the window, the first chunk's lowest
bit forward and its highest backward.

Both are held against the JAX package's ``extract_positions``,
``row_spans`` and ``anchors_back`` (under ``jax.enable_x64``, as the JAX
package's own tests run them on the CPU) over whole outputs with
tolerance zero (everything is integer arithmetic): the seed corpus of
``test_torch_select_step.py``, hypothesis planes, every base offset
0-15, anchors -1, n-1 and past n, hits within ``window - 1`` of 0, rows
wider than the window, a newline at ``arr[n-1]``, ``cap`` far above the
count, a rank far from its block's others (a chunk's last newline),
and candidates spread thinly enough to take K9's search in memory.  The call structs and constants are held against select.cu's
source, and the wrappers' refusals are checked.  The kernels run only on
the card: the test here that needs one skips without it
(``chip_smoke.py`` holds them on the H100).
"""

from __future__ import annotations

import functools
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from minio_tpu.ops import select_step as jss
from minio_tpu_torch.ops import kernels, select_step as tss
from tests.test_torch_select_step import (
    ALPHABET, SCREENS, _csvish, _fields, _jax_screen, _plane, _span_inputs)
from tests.test_torch_threads import torch_threads  # noqa: F401

SELECT_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "minio_tpu_torch", "csrc", "select.cu")


# ---------------------------------------------------------------------------
# K9: positions_kernel's arithmetic
# ---------------------------------------------------------------------------


def _warp_upper_bound(cum: np.ndarray, key, rounds=None) -> int:
    """warp_upper_bound: searchsorted(cum, key, side="right") by 128
    probes a round (4 a lane), the probes at or below the key summed.
    ``key`` is called after the first round's probes are placed (the
    kernel loads it beside them); ``rounds`` (a list) gets the number of
    rounds."""
    n = len(cum)
    R = 32 * tss._POS_PROBES
    idx = np.arange(R)
    lo, hi = 0, n
    step = -(-n // R)

    def place():
        p = lo + (idx + 1) * step - 1
        return np.where(p < hi, cum[np.minimum(p, n - 1)], 2**31 - 1)

    v = place()
    k = key()
    r = 0
    while lo < hi:
        r += 1
        f = int((v <= k).sum())
        if f == R:
            lo = hi
            break
        hi = min(lo + (f + 1) * step - 1, hi)
        lo += f * step
        step = -(-(hi - lo) // R)
        if lo < hi:
            v = place()
    if rounds is not None:
        rounds.append(r)
    return lo


def _bsearch(vals: np.ndarray, keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Per key: the first index j in [lo, hi] with vals[j] > key (the
    answer is known to lie there), by the kernel's binary search."""
    lo = np.full(len(keys), lo, np.int64)
    hi = np.full(len(keys), hi, np.int64)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        le = vals[np.where(act, mid, 0)] <= keys
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    return lo


def _positions_emulated(cand: np.ndarray, cum: np.ndarray, cap: int,
                        paths=None) -> np.ndarray:
    """positions_kernel over ``cap`` ranks; ``paths`` (a list) gets each
    block's path: "past" (no rank below the count), "staged" (every rank
    below the count from the staged run or warp 1's block) or "memory"
    (some from the search in memory), with "+far" where the run is longer
    than the staged entries."""
    cum = cum.astype(np.int64)
    nblk = len(cum)
    T = tss._POS_THREADS
    b_of = np.empty(cap, np.int64)
    base_of = np.empty(cap, np.int64)

    def before(b):
        return np.where(b > 0, cum[np.maximum(b - 1, 0)], 0)

    for k0 in range(0, cap, T):
        kl = min(k0 + T, cap) - 1
        b0 = _warp_upper_bound(cum, lambda: k0)
        got = {}

        def last_key():
            got["total"] = int(cum[nblk - 1])
            return min(kl, got["total"] - 1)

        b1 = min(_warp_upper_bound(cum, last_key), nblk - 1)
        total = got["total"]
        key1 = min(kl, total - 1)
        sl = min(b1 - b0 + 1, tss._POS_RUN)
        ks = np.arange(k0, kl + 1, dtype=np.int64)
        b = np.full(len(ks), nblk - 1, np.int64)  # past the count
        path = "past"
        real = ks < total
        if real.any():
            stage = before(np.arange(b0, b0 + sl + 1))  # cum[b0 - 1 + j]
            last = real & (ks == key1)
            b[last] = b1
            inrun = real & ~last & (stage[sl] > ks)
            b[inrun] = b0 + _bsearch(stage, ks[inrun], 1, sl) - 1
            mem = real & ~last & ~inrun
            b[mem] = _bsearch(cum, ks[mem], b0 + sl, b1)
            path = ("memory" if mem.any() else "staged") + (
                "+far" if b1 - b0 + 1 > tss._POS_RUN else "")
        if paths is not None:
            paths.append(path)
        b_of[k0:kl + 1] = b
        base_of[k0:kl + 1] = before(b)
    # round 3: the rank's word and bit, in int64 torch
    k = torch.arange(cap, dtype=torch.int64)
    b = torch.from_numpy(b_of)
    lr = k - torch.from_numpy(base_of)
    w = torch.from_numpy(cand.reshape(-1, tss.POP_WORDS).copy())[b]
    wsel = torch.zeros(cap, dtype=torch.int64)
    psel = torch.zeros(cap, dtype=torch.int64)
    word = w[:, 0].clone()
    found = torch.zeros(cap, dtype=torch.bool)
    pref = torch.zeros(cap, dtype=torch.int64)
    for j in range(tss.POP_WORDS):
        pc = tss._popc(w[:, j])
        hit = ~found & (pref <= lr) & (lr < pref + pc)
        wsel = torch.where(hit, j, wsel)
        psel = torch.where(hit, pref, psel)
        word = torch.where(hit, w[:, j], word)
        found |= hit
        pref = pref + pc
    need = torch.clamp(lr - psel + 1, min=1)
    p = torch.zeros(cap, dtype=torch.int64)
    half = 32
    while half:
        cnt = tss._popc(word & ((1 << half) - 1))
        go = cnt < need
        need = torch.where(go, need - cnt, need)
        word = torch.where(go, tss._srl(word, half), word)
        p = torch.where(go, p + half, p)
        half //= 2
    return (((b * tss.POP_WORDS + wsel) << 3) + (p >> 3)).to(torch.int32).numpy()
def _jax_positions(cand: np.ndarray, cum: np.ndarray, cap: int) -> np.ndarray:
    with jax.enable_x64(True):
        return np.asarray(jss.extract_positions(
            jnp.asarray(cand.view(np.uint64)), jnp.asarray(cum), cap=cap))


def _same_positions(cand, cum, cap):
    paths = []
    got = _positions_emulated(cand, cum, cap, paths)
    want = _jax_positions(cand, cum, cap)
    assert np.array_equal(got, want)
    assert np.array_equal(got, tss.extract_positions_plain(
        torch.from_numpy(cand.copy()), torch.from_numpy(cum), cap=cap).numpy())
    return got, paths


def _flags(nbytes: int, at: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Candidate words with a flag at each byte of ``at`` and their block
    cumsum, as screen_chunk hands them on."""
    b = np.zeros(nbytes, np.uint8)
    b[at] = 0x80
    cand = b.view(np.int64).copy()
    blk = (b.reshape(-1, 64) != 0).sum(axis=1)
    return cand, np.cumsum(blk).astype(np.int32)


@pytest.mark.parametrize("which,anchor", [
    ("numeric_lt", "row"), ("string_eq", "field"), ("every_kind", "field"),
    ("in16", "row")])
@pytest.mark.parametrize("seed", [0, 5])
def test_positions_seed_corpus(which, anchor, seed):
    arr = _plane(_fields(seed, 900))
    cand, blk, _n, _h = _jax_screen(arr, SCREENS[which], anchor, True)
    cum = np.cumsum(blk).astype(np.int32)
    count = int(cum[-1])
    assert count
    for cap in (1 << max(6, (count - 1).bit_length()), count, 4 * count + 300):
        got, paths = _same_positions(cand, cum, cap)
        assert "staged" in paths
        if cap > count + tss._POS_THREADS:
            assert "past" in paths


def test_positions_dense_words():
    """Every lane flagged: eight candidates a word, 64 a block."""
    cand = np.full(8 * 64, np.int64(-0x7F7F7F7F7F7F7F80))
    cum = np.cumsum(np.full(64, 64, np.int32)).astype(np.int32)
    got, paths = _same_positions(cand, cum, 4096 + 77)
    assert got[:4096].tolist() == list(range(4096))
    assert paths.count("staged") == 4096 // tss._POS_THREADS and "past" in paths


def test_positions_far_last_rank_takes_warp_1s_block():
    """Q1's pattern: dense candidates at the chunk's start and one at its
    last newline.  The block holding both has a run longer than it
    stages; the far rank takes warp 1's block, and no rank searches
    memory."""
    rng = np.random.default_rng(4)
    nbytes = 1 << 21  # 32,768 blocks
    at = np.concatenate([np.sort(rng.choice(1 << 16, 1000, replace=False)),
                         [nbytes - 70]])
    cand, cum = _flags(nbytes, at)
    got, paths = _same_positions(cand, cum, 1024)
    assert got[:len(at)].tolist() == at.tolist()
    assert paths[len(at) // tss._POS_THREADS] == "staged+far"
    assert not any(p.startswith("memory") for p in paths)


def test_positions_thin_candidates_take_the_memory_search():
    """Candidates 40 blocks apart: a block's 128 ranks span 5,100 blocks,
    past the 2,048 it stages; the ranks past the staged run search the
    rest of it in memory."""
    rng = np.random.default_rng(3)
    count = 700
    gaps = 40 * 64 + rng.integers(-7, 8, count)
    at = np.cumsum(gaps) + 5
    nbytes = (int(at[-1]) // 4096 + 2) * 4096
    cand, cum = _flags(nbytes, at)
    got, paths = _same_positions(cand, cum, 1024)
    assert got[:count].tolist() == at.tolist()
    assert paths[:2] == ["memory+far", "memory+far"] and paths[-1] == "past"


def test_positions_one_candidate_and_none():
    """One candidate at the last block's end (a chunk's last newline) or
    none at all: the ranks past the count take the last block."""
    cand, cum = _flags(8192, np.array([8191]))
    got, paths = _same_positions(cand, cum, 64)
    assert got[0] == 8191 and paths == ["staged"]
    cand, cum = _flags(8192, np.array([3]))
    _same_positions(cand, cum, 600)
    cand, cum = _flags(512, np.array([], np.int64))
    _, paths = _same_positions(cand, cum, 300)
    assert set(paths) == {"past"}


@settings(max_examples=25, deadline=None)
@given(
    density=st.sampled_from([0.0002, 0.002, 0.02, 0.2]),
    nbytes=st.sampled_from([1 << 15, 1 << 18, (1 << 18) + 192]),
    seed=st.integers(0, 2**31),
    extra=st.integers(0, 700),
)
def test_positions_random_planes(density, nbytes, seed, extra):
    """Random flags over 512-4,099 blocks (windows of 1-5, a cumsum whose
    length is not a multiple of 4 or of the window count)."""
    rng = np.random.default_rng(seed)
    at = np.flatnonzero(rng.random(nbytes) < density)
    cand, cum = _flags(nbytes, at)
    count = len(at)
    got, _ = _same_positions(cand, cum, max(1, count + extra))
    assert got[:count].tolist() == at.tolist()


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 5000, 524288])
def test_the_128_probe_search_takes_3_rounds(n):
    """The warp search is searchsorted (side right) for every key, in at
    most 3 dependent rounds over a 32 MiB chunk's 524,288 blocks (a
    binary search's 19)."""
    rng = np.random.default_rng(n)
    cum = np.cumsum(rng.integers(0, 3, n))
    rounds = []
    for key in (-1, 0, 1, int(cum[-1]) - 1, int(cum[-1]), 10**7,
                *rng.integers(0, int(cum[-1]) + 1, 100).tolist()):
        assert _warp_upper_bound(cum, lambda key=key: key, rounds) == \
            np.searchsorted(cum, key, side="right")
    assert max(rounds) <= (3 if n == 524288 else 2)


# ---------------------------------------------------------------------------
# K10: spans_kernel's arithmetic
# ---------------------------------------------------------------------------

_LOW = np.array([(m & -m).bit_length() - 1 for m in range(1 << 16)], np.int64)
_HIGH = np.array([m.bit_length() - 1 for m in range(1 << 16)], np.int64)


def _newline_bits(chunks: torch.Tensor) -> torch.Tensor:
    """newline_bits of (C, 16) uint8 chunks: the exact zero-byte test of
    each little-endian 32-bit word ^ 0x0A0A0A0A, its four 0x80 flags
    gathered by the multiply into four bits."""
    x = chunks.to(torch.int64).reshape(-1, 4, 4)
    words = x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24
    m = torch.zeros(words.shape[0], dtype=torch.int64)
    for j in range(4):
        y = words[:, j] ^ 0x0A0A0A0A
        z = ~(((y & 0x7F7F7F7F) + 0x7F7F7F7F) | y) & 0x80808080
        m |= ((((z >> 7) * 0x00204081) & 0xFFFFFFFF) >> 21 & 15) << (4 * j)
    return m


def _spans_emulated(arr: np.ndarray, anchors: np.ndarray, window: int,
                    back: bool, base: int):
    """spans_kernel<back> with the plane's first byte at absolute address
    ``base`` (mod 16); the memory around the plane holds newlines."""
    n = len(arr)
    mem = np.full(base + n + 64, 10, np.uint8)
    mem[base:base + n] = arr
    mem = torch.from_numpy(mem)
    h = torch.from_numpy(anchors.astype(np.int64))
    s = h if back else h + 1
    glo = torch.clamp(h - (window - 1), min=0) if back else torch.clamp(s, min=0)
    ghi = torch.clamp(h, max=n - 1) if back else torch.clamp(s + window - 1, max=n - 1)
    edge = torch.where(s > n - 1, n - 1, torch.where(
        torch.tensor(not back) & (s < 0), 0, -1))
    at_edge = (edge >= 0) & (torch.from_numpy(arr.copy())[edge.clamp(min=0)] == 10)
    g = torch.full_like(h, -1)
    live = ~at_edge & (glo <= ghi)
    c0, c1 = (base + glo) >> 4, (base + ghi) >> 4
    L, C = tss._SPAN_LANES[back], tss._SPAN_CHUNKS[back]
    table = _HIGH if back else _LOW
    j = 0
    while True:
        live &= j <= c1 - c0
        if not live.any():
            break
        first = torch.full_like(h, -1)  # the lowest lane with a newline wins
        for lane in range(L):
            mine = torch.full_like(h, -1)
            for q in reversed(range(C)):  # the lane's first chunk in scan order
                c = c1 - j - lane * C - q if back else c0 + j + lane * C + q
                ok = live & ((c >= c0) if back else (c <= c1))
                cc = torch.where(ok, c, 0)
                m = _newline_bits(mem[(16 * cc)[:, None] + torch.arange(16)[None, :]])
                at = 16 * c - base
                lo = torch.clamp(glo - at, 0, 16)
                hi = torch.clamp(ghi - at + 1, 0, 16)
                m = torch.where(ok, m & ((1 << hi) - 1) & ~((1 << lo) - 1), 0)
                mine = torch.where(m != 0, at + torch.from_numpy(table[m.numpy()]), mine)
            first = torch.where((first < 0) & (mine >= 0), mine, first)
        g = torch.where(live & (first >= 0), first, g)
        live &= first < 0
        j += L * C
    if back:
        out = torch.where(at_edge, h, g)
        found = at_edge | (g >= 0) | (h - (window - 1) <= 0)
    else:
        out = torch.where(at_edge | (g < 0), 0, g - s)
        found = at_edge | (g >= 0)
    return out.to(torch.int32).numpy(), found.numpy()


@functools.lru_cache(maxsize=64)
def _jax_span_fn(back: bool, window: int):
    fn = jss.anchors_back if back else jss.row_spans
    return functools.partial(fn, window=window)


def _same_spans(arr: np.ndarray, anchors: np.ndarray, window: int, back: bool,
                bases=range(16)):
    with jax.enable_x64(True):
        jo, jf = _jax_span_fn(back, window)(jnp.asarray(arr), jnp.asarray(anchors))
    jo, jf = np.asarray(jo), np.asarray(jf)
    plain = tss.anchors_back_plain if back else tss.row_spans_plain
    to, tf = plain(torch.from_numpy(arr.copy()), torch.from_numpy(anchors),
                   window=window)
    assert np.array_equal(jo, to.numpy()) and np.array_equal(jf, tf.numpy())
    for base in bases:
        eo, ef = _spans_emulated(arr, anchors, window, back, base)
        assert np.array_equal(eo, jo), base
        assert np.array_equal(ef, jf), base
    return jo, jf


def _edges(n: int, window: int) -> np.ndarray:
    """Anchors at and past both ends of the plane, and within window - 1
    of its start."""
    return np.array([-5000, -2, -1, 0, 1, 2, window - 2, window - 1, window,
                     n - 3, n - 2, n - 1, n, n + 1, n + window, 2**31 - 1 - window],
                    np.int32)


@pytest.mark.parametrize("back,window", [(False, 256), (False, 1024),
                                         (False, 4096), (True, 256), (True, 1024),
                                         (True, 1), (False, 1), (True, 17)])
@pytest.mark.parametrize("seed", [0, 1])
def test_spans_seed_corpus_every_base(back, window, seed):
    """The rows of test_torch_select_step.py (0-1,500 bytes: wider than the
    window too), their newlines and random mid-row anchors, and the
    edges, at every base offset 0-15."""
    arr, anchors, mids = _span_inputs(seed)
    a = np.concatenate([anchors, mids, _edges(len(arr), window)]).astype(np.int32)
    jo, jf = _same_spans(arr, a, window, back)
    if window >= 256:  # rows found, and rows wider than the window
        assert jf.any() and (window == 4096 or not jf.all())


@pytest.mark.parametrize("back", [False, True])
def test_spans_newline_at_the_plane_end(back):
    """The plane ends in a newline and its last byte is it: the clamp
    repeats it past the end (found at offset 0 forward past n - 1, and
    backward from a hit past n - 1 at the hit itself)."""
    data = b"abc\n" + b"x" * 300 + b"\n" + b"y" * 57 + b"\n"
    arr = np.frombuffer(data, np.uint8).copy()
    n = len(arr)
    a = np.array([-3, -1, 0, 3, 4, 300, n - 2, n - 1, n, n + 3, n + 500], np.int32)
    for window in (1, 2, 16, 64, 256):
        jo, jf = _same_spans(arr, a, window, back)
    assert jf[-3:].all()


@pytest.mark.parametrize("back", [False, True])
def test_spans_plane_starting_with_a_newline(back):
    """arr[0] is a newline: anchors before the plane read it at offset 0."""
    arr = np.frombuffer(b"\n" + b"z" * 200 + b"\nq" * 10, np.uint8).copy()
    a = np.array([-400, -9, -2, -1, 0, 1, 150, 199, 200, 201], np.int32)
    for window in (1, 5, 128, 256):
        _same_spans(arr, a, window, back)


@pytest.mark.parametrize("back", [False, True])
def test_spans_lineitem_like_rows(back):
    """Rows of 1-5 fields (test_torch_select_step.py's _fields) and the
    csv-ish corpus: every newline as an anchor, every field hit."""
    for data in (_fields(31, 400), _csvish(7, 6000)):
        arr = _plane(data)
        nl = np.flatnonzero(arr == 10).astype(np.int32)
        hits = np.flatnonzero((arr == ord(",")) | (arr == 10)).astype(np.int32)
        a = np.concatenate([[-1], nl]) if not back else hits
        _same_spans(arr, a.astype(np.int32), 1024 if back else 256, back,
                    bases=(0, 3, 8, 13, 15))


@settings(max_examples=30, deadline=None)
@given(
    data=st.binary(min_size=1024, max_size=1024).map(
        lambda b: np.frombuffer(bytes(ALPHABET[x % len(ALPHABET)] for x in b),
                                np.uint8).copy()),
    anchors=st.lists(st.integers(-300, 1400), min_size=64, max_size=64),
    back=st.booleans(),
    window=st.sampled_from([1, 16, 100, 256]),
    base=st.integers(0, 15),
)
def test_spans_random_planes(data, anchors, back, window, base):
    _same_spans(data, np.array(anchors, np.int32), window, back, bases=(base,))


# ---------------------------------------------------------------------------
# structs, constants and the wrappers' refusals
# ---------------------------------------------------------------------------


def _cu() -> str:
    with open(SELECT_CU) as f:
        return f.read()


def test_call_structs_and_constants_match_select_cu():
    src = _cu()
    sizes = dict(re.findall(r"static_assert\(sizeof\((\w+)\) == (\d+)", src))
    assert int(sizes["PositionsCall"]) == tss._POSITIONS_CALL.size == 48
    assert int(sizes["SpansCall"]) == tss._SPANS_CALL.size == 64
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kPosThreads"]) == tss._POS_THREADS
    assert int(consts["kPosProbes"]) == tss._POS_PROBES
    assert int(consts["kPosRun"]) == tss._POS_RUN
    assert int(consts["kSpanThreads"]) == tss._SPAN_THREADS
    shapes = re.findall(r"static constexpr int lanes = (\d+), chunks = (\d+);", src)
    assert [tuple(map(int, x)) for x in shapes] == list(zip(tss._SPAN_LANES,
                                                             tss._SPAN_CHUNKS))
    assert all(32 % lanes == 0 for lanes in tss._SPAN_LANES)
    assert tss._SPAN_THREADS % 32 == 0
    assert tss._POS_RUN % 4 == 0  # staged as 16-byte groups
    names = set(tss._constants())
    for name in ("pos_threads", "pos_probes", "pos_run", "span_lanes",
                 "span_chunks", "span_threads", "positions_call_bytes",
                 "spans_call_bytes"):
        assert name in names and f"{name}=" in src


def _fake(dtype, shape=(512,), cuda=True, contiguous=True, device=0, ptr=256):
    """A stand-in for a CUDA tensor: what the checks read, no storage."""
    return types.SimpleNamespace(
        is_cuda=cuda, dtype=dtype, shape=shape, device=types.SimpleNamespace(
            type="cuda" if cuda else "cpu"),
        dim=lambda: len(shape), numel=lambda: int(np.prod(shape)),
        is_contiguous=lambda: contiguous, get_device=lambda: device,
        data_ptr=lambda: ptr)


W64, I32 = torch.int64, torch.int32


@pytest.mark.parametrize("cand,cum,cap,exc,match", [
    (_fake(W64), _fake(I32, (64,), cuda=False), 64, ValueError, "CUDA"),
    (_fake(I32), _fake(I32, (64,)), 64, TypeError, "int64"),
    (_fake(W64), _fake(W64, (64,)), 64, TypeError, "int32"),
    (_fake(W64, (64, 8)), _fake(I32, (64,)), 64, ValueError, "1 dim"),
    (_fake(W64, contiguous=False), _fake(I32, (64,)), 64, ValueError, "contiguous"),
    (_fake(W64), _fake(I32, (64,), device=1), 64, ValueError, "different devices"),
    (_fake(W64), _fake(I32, (63,)), 64, ValueError, "512 words for 63 blocks"),
    (_fake(W64, (0,)), _fake(I32, (0,)), 64, ValueError, "for 0 blocks"),
    (_fake(W64), _fake(I32, (64,)), -1, ValueError, "cap -1"),
    (_fake(W64), _fake(I32, (64,)), 2**31, ValueError, "cap"),
    (_fake(W64, ptr=264), _fake(I32, (64,)), 64, ValueError, "16-byte aligned"),
    (_fake(W64), _fake(I32, (64,), ptr=260), 64, ValueError, "16-byte aligned"),
])
def test_positions_wrapper_refusals(cand, cum, cap, exc, match):
    """extract_positions refuses, before it allocates or launches, what
    K9 does not take: no fallback to the plain version."""
    kernels.reset_launches()
    with pytest.raises(exc, match=match):
        tss.extract_positions(cand, cum, cap=cap)
    assert kernels.LAUNCHES["select_positions"] == 0


@pytest.mark.parametrize("fn", [tss.row_spans, tss.anchors_back])
@pytest.mark.parametrize("arr,idx,window,exc,match", [
    (_fake(torch.uint8), _fake(I32, cuda=False), 64, ValueError, "CUDA"),
    (_fake(I32), _fake(I32), 64, TypeError, "uint8"),
    (_fake(torch.uint8), _fake(W64), 64, TypeError, "int32"),
    (_fake(torch.uint8), _fake(I32, (3, 2)), 64, ValueError, "1 dim"),
    (_fake(torch.uint8, contiguous=False), _fake(I32), 64, ValueError, "contiguous"),
    (_fake(torch.uint8), _fake(I32, device=1), 64, ValueError, "different devices"),
    (_fake(torch.uint8), _fake(I32), 0, ValueError, "window 0"),
    (_fake(torch.uint8, (0,)), _fake(I32), 64, ValueError, "over 0 bytes"),
])
def test_spans_wrapper_refusals(fn, arr, idx, window, exc, match):
    kernels.reset_launches()
    with pytest.raises(exc, match=match):
        fn(arr, idx, window=window)
    assert kernels.LAUNCHES["select_spans[row]"] == 0
    assert kernels.LAUNCHES["select_spans[back]"] == 0


def test_wrappers_refuse_meta_tensors():
    meta = torch.empty(512, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tss.extract_positions(meta, torch.zeros(64, dtype=I32), cap=64)
    with pytest.raises(ValueError, match="CUDA"):
        tss.row_spans(meta.view(torch.uint8), torch.zeros(3, dtype=I32), window=64)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/select.cu run "
                    "only there (chip_smoke.py holds them on the H100)")
    return torch.device("cuda", 0)


def test_redesigned_kernels_on_the_card(card):
    """K9 over whole outputs (dense, thin, none, cap far above the count)
    and K10 both ways at every plane offset 0-15 and the edges, each bit
    for bit against its plain version; the entries refuse a faulty
    call."""
    rng = np.random.default_rng(11)
    for at in (np.flatnonzero(rng.random(1 << 16) < 0.02),
               np.cumsum(40 * 64 + rng.integers(-7, 8, 700)) + 5,
               np.array([], np.int64), np.arange(4096)):
        nbytes = max(1 << 16, (int(at.max(initial=0)) // 4096 + 2) * 4096)
        cand, cum = _flags(nbytes, at)
        c, k = torch.from_numpy(cand).to(card), torch.from_numpy(cum).to(card)
        for cap in (64, len(at) + 1, 4 * len(at) + 300):
            assert torch.equal(tss.extract_positions(c, k, cap=cap),
                               tss.extract_positions_plain(c, k, cap=cap))
    arr, anchors, mids = _span_inputs(3)
    buf = torch.from_numpy(np.concatenate([arr, np.full(16, 10, np.uint8)])).to(card)
    for off in range(16):
        sub = buf[off:off + len(arr)]
        n = sub.numel()
        for back, windows in ((False, (1, 17, 256, 1024, 4096)), (True, (1, 17, 1024))):
            a = torch.from_numpy(np.concatenate([anchors, mids, _edges(n, 256)]).astype(
                np.int32)).to(card)
            fn = tss.anchors_back if back else tss.row_spans
            plain = tss.anchors_back_plain if back else tss.row_spans_plain
            for w in windows:
                got, want = fn(sub, a, window=w), plain(sub, a, window=w)
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (off, back, w)
    lib = kernels._load()
    assert lib.mts_positions(tss._POSITIONS_CALL.pack(
        c.data_ptr() + 8, k.data_ptr(), k.data_ptr(), 0, k.numel(), 64, 0, 0)) != 0
    assert lib.mts_spans(tss._SPANS_CALL.pack(
        buf.data_ptr(), a.data_ptr(), a.data_ptr(), a.data_ptr(), 0, n, 3, 0, 0, 0)) != 0
