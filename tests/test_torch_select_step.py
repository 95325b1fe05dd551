"""The port's S3 Select device functions (minio_tpu_torch.ops.select_step)
held against minio_tpu.ops.select_step.

The same numpy planes and anchors go through the JAX package's functions,
called directly under ``jax.enable_x64(True)`` (their u64 flag words need
x64), and through the port's wrappers, which run their plain PyTorch
versions for CPU tensors.  Everything is integer arithmetic, so every
comparison is exact (tolerance zero): the candidate words, the block
sums, the row count, the hazard, the positions up to the candidate count
(entries past it are garbage both sides slice off), the spans and found
flags, and the gathered rows.  The CUDA kernels (csrc/select.cu) are held
against the same plain versions on the card by ``chip_smoke.py``; the
tests here that need the card skip without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from minio_tpu.ops import select_step as jss
from minio_tpu_torch.ops import kernels, select_step as tss
from tests.test_torch_threads import torch_threads  # noqa: F401

FD = ord(",")
QC = ord('"')


def _plane(data: bytes) -> np.ndarray:
    pad = (-len(data)) % jss.BLOCK_BYTES
    return np.frombuffer(data + bytes([jss.PAD_BYTE]) * pad, dtype=np.uint8)


def _jax_screen(arr, atoms, anchor, sci, fd=FD, qc=QC):
    with jax.enable_x64(True):
        cand, blk, nrows, haz = jss.screen_chunk(
            jnp.asarray(arr), fd=fd, qc=qc, atoms=atoms, anchor=anchor,
            sci_guard=sci)
        return (np.asarray(cand).view(np.int64), np.asarray(blk),
                int(nrows), bool(haz))


def _port_screen(arr, atoms, anchor, sci, fd=FD, qc=QC):
    cand, blk, nrows, haz = tss.screen_chunk(
        torch.from_numpy(arr.copy()), fd=fd, qc=qc, atoms=atoms,
        anchor=anchor, sci_guard=sci)
    return cand.numpy(), blk.numpy(), int(nrows), bool(haz)


def _same_screen(arr, atoms, anchor, sci, fd=FD, qc=QC):
    j = _jax_screen(arr, atoms, anchor, sci, fd, qc)
    t = _port_screen(arr, atoms, anchor, sci, fd, qc)
    assert np.array_equal(j[0], t[0]), "candidate words"
    assert np.array_equal(j[1], t[1]), "block sums"
    assert j[2:] == t[2:], "row count and hazard"
    return j


def _flag_bytes(cand: np.ndarray) -> list:
    bits = np.unpackbits(cand.view(np.uint8), bitorder="little")
    return (np.flatnonzero(bits) // 8).tolist()


# the screens of the JAX compiler's shapes, and one of every atom kind
NUMERIC_LT = ((("len", 0, 4),), (("nd", 6),), (("byte0", 43, 48),),
              (("lex", b"1000", "lt"),))
NUMERIC_GE = ((("deep", 3),), (("byte0", 43, 48),), (("lex", b"12.5", "ge"),))
NUMERIC_EQ = ((("lex", b"7", "eq"),), (("byte0", 43, 48),), (("nd", 3),))
STRING_EQ = ((("lex", b"AIR", "eq"),),)
IN_LIST = tuple(
    branch for v in range(16)
    for branch in ((("lex", str(v * 7).encode(), "eq"),),
                   (("byte0", 43, 48),), (("nd", len(str(v * 7)) + 2),)))
EVERY_KIND = ((("len", 1, 3), ("byte0", 48, 57)), (("deep", 5), ("nd", 7)),
              (("lex", b"abcdefghij", "le"),), (("lex", b"abcdefghijk", "gt"),),
              (("lex", b"zz", "lt"),), (("lex", b"b", "ge"),),
              (("byte0", 0, 50), ("len", 0, 0)))
SCREENS = {
    "numeric_lt": NUMERIC_LT, "numeric_ge": NUMERIC_GE,
    "numeric_eq": NUMERIC_EQ, "string_eq": STRING_EQ, "in16": IN_LIST,
    "every_kind": EVERY_KIND,
}
ALPHABET = np.frombuffer(b"0123456789,,,\n\n-+./eEabcxyzAIR 7", np.uint8)
HAZARDS = np.frombuffer(b'"\r\x00', np.uint8)


def _csvish(seed: int, n: int, hazards: bool = False) -> bytes:
    rng = np.random.default_rng(seed)
    alpha = np.concatenate([ALPHABET, HAZARDS]) if hazards else ALPHABET
    return alpha[rng.integers(0, len(alpha), n)].tobytes() + b"\n"


def test_swar_borrow_flags_the_lane_after_a_match():
    """_swar_eq's borrow: after the ``,`` at byte 4, byte 5 (``-``,
    0x2D = ``,`` ^ 1) reads as a terminator, so ``deep(2)`` is not met
    at byte 4; the screen flags bytes 8 and 13 only, where a byte-exact
    compare would also flag byte 5."""
    arr = _plane(b"a,b\n1,-5\n22,7\n")
    j = _same_screen(arr, ((("deep", 2),),), "field", False)
    assert _flag_bytes(j[0]) == [8, 13]


@pytest.mark.parametrize("anchor", ["row", "field"])
@pytest.mark.parametrize("sci", [False, True])
@pytest.mark.parametrize("name", list(SCREENS))
@pytest.mark.parametrize("seed", [0, 1])
def test_screen_chunk_matches(name, anchor, sci, seed):
    arr = _plane(_csvish(seed, 3000 + 517 * seed))
    _same_screen(arr, SCREENS[name], anchor, sci)


@pytest.mark.parametrize("name", ["numeric_lt", "string_eq", "every_kind"])
@pytest.mark.parametrize("sci", [False, True])
def test_screen_hazards_match(name, sci):
    arr = _plane(_csvish(7, 5000, hazards=True))
    j = _same_screen(arr, SCREENS[name], "field", sci)
    assert j[3]


@pytest.mark.parametrize("text,sci,hazard", [
    (b"a,b\n1,2\n", False, False),
    (b'a,"b"\n1,2\n', False, True),  # quote
    (b"a,b\r\n1,2\n", False, False),  # CR before a newline is no hazard
    (b"a,b\r1,2\n", False, True),  # bare CR
    (b"a,b\n1,\x002\n", False, True),  # NUL
    (b"a,b\n1e5,2\n", False, False),
    (b"a,b\n1e5,2\n", True, True),  # digit then e under the sci guard
    (b"a,b\nE5,2\n", True, False),  # no digit before the e
    (b"a,b\n9E,2\n", True, True),
])
def test_hazard_cases(text, sci, hazard):
    j = _same_screen(_plane(text), NUMERIC_LT, "row", sci)
    assert j[3] is hazard


def test_screen_across_a_window_edge():
    """Wider than the JAX package's WINDOW_WORDS cache window: its
    windows and the port's one pass give the same bits, lookahead and
    the sci guard's byte p-1 across the edge included."""
    n = jss.WINDOW_WORDS * 8 + 3000
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 10 ** 6, n // 6).astype(str)
    data = ("\n".join(rows) + "\n").encode()[:n]
    data = data[:data.rfind(b"\n") + 1]
    for atoms, anchor in ((NUMERIC_LT, "row"), (EVERY_KIND, "field")):
        _same_screen(_plane(data), atoms, anchor, True)


def test_screen_other_delimiter_and_quote():
    arr = _plane(_csvish(11, 4000).replace(b",", b"|"))
    _same_screen(arr, NUMERIC_EQ, "field", True, fd=ord("|"), qc=ord("'"))


@settings(max_examples=25, deadline=None)
@given(
    data=st.binary(min_size=1, max_size=900).map(
        lambda b: bytes(ALPHABET[x % len(ALPHABET)] for x in b) + b"\n"),
    which=st.sampled_from(sorted(SCREENS)),
    anchor=st.sampled_from(["row", "field"]),
    sci=st.booleans(),
)
def test_screen_random_planes(data, which, anchor, sci):
    _same_screen(_plane(data), SCREENS[which], anchor, sci)


VOCAB = ["AIR", "7", "14", "1000", "999", "12.5", "abc", "-3", "0.5", "zz",
         "b", "abcdefghij", "abcdefghijkl", "0", "105", "AIRS", ""]


def _fields(seed: int, rows: int) -> bytes:
    """Rows of 1-5 fields drawn from VOCAB and random integers, so every
    screen has candidates."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        k = int(rng.integers(1, 6))
        out.append(",".join(
            VOCAB[i] if i < len(VOCAB) else str(int(rng.integers(0, 99999)))
            for i in rng.integers(0, len(VOCAB) + 4, k)))
    return ("\n".join(out) + "\n").encode()


@pytest.mark.parametrize("name", list(SCREENS))
@pytest.mark.parametrize("anchor", ["row", "field"])
def test_screen_field_rows_match(name, anchor):
    j = _same_screen(_plane(_fields(21, 700)), SCREENS[name], anchor, True)
    assert j[1].sum() > 0


def _positions_case(seed: int, which: str, anchor: str):
    arr = _plane(_fields(seed, 900))
    cand, blk, _n, _h = _jax_screen(arr, SCREENS[which], anchor, True)
    cum = np.cumsum(blk).astype(np.int32)
    return arr, cand, cum, int(cum[-1])


@pytest.mark.parametrize("which,anchor", [
    ("numeric_lt", "row"), ("string_eq", "field"), ("every_kind", "field"),
    ("in16", "row")])
@pytest.mark.parametrize("seed", [0, 5])
def test_extract_positions_matches(which, anchor, seed):
    arr, cand, cum, count = _positions_case(seed, which, anchor)
    assert count
    cap = 1 << max(6, (count - 1).bit_length())
    with jax.enable_x64(True):
        jp = np.asarray(jss.extract_positions(
            jnp.asarray(cand.view(np.uint64)), jnp.asarray(cum), cap=cap))
    tp = tss.extract_positions(torch.from_numpy(cand.copy()),
                               torch.from_numpy(cum), cap=cap).numpy()
    assert np.array_equal(jp[:count], tp[:count])
    assert tp[:count].tolist() == [p for p in _flag_bytes(cand)][:count]


def test_extract_positions_dense_words():
    """Every lane flagged: eight candidates a word, the in-word select at
    every lane."""
    cand = np.full(64, np.int64(-0x7F7F7F7F7F7F7F80))  # 0x80 in each lane
    blk = np.full(8, 64, np.int32)
    cum = np.cumsum(blk).astype(np.int32)
    with jax.enable_x64(True):
        jp = np.asarray(jss.extract_positions(
            jnp.asarray(cand.view(np.uint64)), jnp.asarray(cum), cap=512))
    tp = tss.extract_positions(torch.from_numpy(cand), torch.from_numpy(cum),
                               cap=512).numpy()
    assert np.array_equal(jp, tp)
    assert tp.tolist() == list(range(512))


def _span_inputs(seed: int):
    rng = np.random.default_rng(seed)
    rows = [b"r" * int(n) + b"\n" for n in rng.integers(0, 1500, 120)]
    arr = _plane(b"".join(rows))
    nl = np.flatnonzero(arr == 10).astype(np.int32)
    mids = rng.integers(0, len(arr), 200).astype(np.int32)
    return arr, np.concatenate([[-1], nl]).astype(np.int32), mids


@pytest.mark.parametrize("window", [256, 1024, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_spans_match(window, seed):
    arr, anchors, mids = _span_inputs(seed)
    for a in (anchors, mids, np.array([len(arr) - 2, len(arr) + 5], np.int32)):
        with jax.enable_x64(True):
            jl, jf = jss.row_spans(jnp.asarray(arr), jnp.asarray(a), window=window)
        tl, tf = tss.row_spans(torch.from_numpy(arr.copy()), torch.from_numpy(a),
                               window=window)
        assert np.array_equal(np.asarray(jl), tl.numpy())
        assert np.array_equal(np.asarray(jf), tf.numpy())
    assert not tf.numpy().all() or window == 4096


@pytest.mark.parametrize("window", [256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_anchors_back_match(window, seed):
    arr, _anchors, mids = _span_inputs(seed)
    hits = np.concatenate([mids, np.arange(0, 1100, 13, dtype=np.int32)])
    with jax.enable_x64(True):
        ja, jf = jss.anchors_back(jnp.asarray(arr), jnp.asarray(hits),
                                  window=window)
    ta, tf = tss.anchors_back(torch.from_numpy(arr.copy()),
                              torch.from_numpy(hits), window=window)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    # found at the chunk start with no newline before it, and not found
    assert (tf.numpy() & (ta.numpy() == -1)).any()
    assert not tf.numpy().all()


@pytest.mark.parametrize("window", [64, 256, 4096])
def test_gather_rows_match(window):
    arr, anchors, mids = _span_inputs(2)
    starts = np.concatenate([anchors + 1, mids, [len(arr) - 3]]).astype(np.int32)
    with jax.enable_x64(True):
        jg = np.asarray(jss.gather_rows(jnp.asarray(arr), jnp.asarray(starts),
                                        window=window))
    tg = tss.gather_rows(torch.from_numpy(arr.copy()), torch.from_numpy(starts),
                         window=window).numpy()
    assert np.array_equal(jg, tg)


def test_max_shift_matches_the_reference():
    for atoms in SCREENS.values():
        for sci in (False, True):
            assert tss._max_shift(atoms, sci) == jss._max_shift(atoms, sci)
    assert (tss.PAD_BYTE, tss.BLOCK_BYTES, tss.POP_WORDS, tss.MAX_LEX) == (
        jss.PAD_BYTE, jss.BLOCK_BYTES, jss.POP_WORDS, jss.MAX_LEX)


@pytest.mark.parametrize("atoms", [
    ((("lex", "é".encode(), "lt"),),),  # a lt/le byte past 0x80
    ((("byte0", 0, 200),),),  # a byte0 bound past 0x80
])
def test_unformable_constants_raise_like_the_reference(atoms):
    """A u64 constant the JAX package cannot form raises OverflowError
    there; the port's plain version and its program encoder do too."""
    arr = _plane(b"a,b\n\xc3\xa9,1\n")
    with pytest.raises(OverflowError):
        _jax_screen(arr, atoms, "field", False)
    with pytest.raises(OverflowError):
        _port_screen(arr, atoms, "field", False)
    with pytest.raises(OverflowError):
        tss.screen_program(atoms)


def test_non_ascii_literal_screens_where_the_reference_does():
    """gt/ge/eq never form the lane constant of a byte past 0x7F."""
    arr = _plane("a,b\né,1\nz,2\n".encode())
    for mode in ("gt", "ge", "eq"):
        _same_screen(arr, ((("lex", "é".encode(), mode),),), "field", False)


def test_screen_program_records():
    """K8's program of NUMERIC_LT: one 16-byte record per atom, each the
    last of its one-atom branch, over the offsets the reference reads."""
    prog = tss.screen_program(NUMERIC_LT)
    last = tss._LAST
    assert prog.records["op"].tolist() == [
        tss._OP["terms"] | last, tss._OP["nd"] | last, tss._OP["range"] | last,
        tss._OP["lex"] | last]
    # len 0-4: a terminator at offset 1-5; nd 6: offsets 1-6
    assert prog.records["m"][:2].tolist() == [0b111110, 0b1111110]
    assert prog.records["arg"][2] == (0x80 - 43) | (0x80 - 49) << 8  # byte0 43-48
    lex = prog.records[3]
    assert lex["arg"] & 0xFF == tss._MODE["lt"] and lex["arg"] >> 8 == 4
    assert int(lex["m"]).to_bytes(8, "little") == b"1000\0\0\0\0"
    assert (prog.q, prog.vmask, prog.tmask, prog.dmask) == (
        1, 0b1111110, 0b1111110, 0b1111110)
    long = tss.screen_program(((("lex", b"abcdefghijk", "ge"),),))
    rec = long.records[0]
    assert rec["arg"] >> 8 == tss.MAX_LEX and rec["op"] & tss._FLAG
    assert int(rec["m"]).to_bytes(8, "little") == b"abcdefgh"
    assert long.q == 2 and long.tmask == sum(1 << k for k in range(1, 10))
    # 16 lex branches, one byte0 branch for all 16, one nd per width
    assert tss.screen_program(IN_LIST).nrec == 16 + 1 + 3


def test_popcount_and_shift_on_int64():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, 512, dtype=np.uint64)
    t = torch.from_numpy(x.view(np.int64).copy())
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(tss._popc(t).numpy(), want)
    for k in (1, 7, 8, 56, 63):
        assert np.array_equal(tss._srl(t, k).numpy().view(np.uint64), x >> np.uint64(k))


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launches()
    arr = torch.from_numpy(_plane(_csvish(4, 2000)).copy())
    cand, blk, _n, _h = tss.screen_chunk(arr, fd=FD, qc=QC, atoms=NUMERIC_LT,
                                         anchor="row", sci_guard=True)
    cum = torch.cumsum(blk, 0, dtype=torch.int32)
    pos = tss.extract_positions(cand, cum, cap=64)
    tss.row_spans(arr, pos, window=256)
    tss.anchors_back(arr, pos, window=1024)
    tss.gather_rows(arr, pos, window=64)
    assert all(kernels.LAUNCHES[n] == 0 for n in tss.LAUNCH_NAMES)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.empty(512, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tss.screen_chunk(meta, fd=FD, qc=QC, atoms=STRING_EQ, anchor="row",
                         sci_guard=False)
    with pytest.raises(ValueError, match="anchor"):
        tss.screen_chunk(meta, fd=FD, qc=QC, atoms=STRING_EQ, anchor="cell",
                         sci_guard=False)
    with pytest.raises(ValueError, match="CUDA"):
        tss.gather_rows(meta, torch.empty(3, dtype=torch.int32, device="meta"),
                        window=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/select.cu run "
                    "only there (chip_smoke.py holds them on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", list(SCREENS))
def test_kernels_match_plain_versions_on_the_card(card, name):
    # a ``,`` at byte 3 of a word and ``-`` = ``,`` ^ 1 at byte 4: the
    # borrow of _swar_eq crosses the word's 32-bit halves there
    borrow = b"xyz,-a,b\n,-1,22\n" * 64
    arr = torch.from_numpy(_plane(_csvish(12, 200_000) + borrow).copy()).to(card)
    for anchor in ("row", "field"):
        got = tss.screen_chunk(arr, fd=FD, qc=QC, atoms=SCREENS[name],
                               anchor=anchor, sci_guard=True)
        want = tss.screen_chunk_plain(arr, fd=FD, qc=QC, atoms=SCREENS[name],
                                      anchor=anchor, sci_guard=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        count = int(got[1].sum())
        if not count:
            continue
        cum = torch.cumsum(got[1], 0, dtype=torch.int32)
        cap = 1 << max(6, (count - 1).bit_length())
        pos = tss.extract_positions(got[0], cum, cap=cap)[:count]
        assert torch.equal(pos, tss.extract_positions_plain(got[0], cum, cap=cap)[:count])
        for fn, plain, w in ((tss.row_spans, tss.row_spans_plain, 256),
                             (tss.anchors_back, tss.anchors_back_plain, 1024)):
            assert all(torch.equal(a, b) for a, b in zip(fn(arr, pos, window=w),
                                                         plain(arr, pos, window=w)))
        assert torch.equal(tss.gather_rows(arr, pos, window=64),
                           tss.gather_rows_plain(arr, pos, window=64))
    # K11 at both clamped ends: rows before the plane and past its end
    n = arr.numel()
    ends = torch.tensor([-300, -64, -1, 0, n - 300, n - 64, n - 1, n, n + 5],
                        dtype=torch.int32, device=card)
    for window in (64, 256, 4096):
        assert torch.equal(tss.gather_rows(arr, ends, window=window),
                           tss.gather_rows_plain(arr, ends, window=window))
