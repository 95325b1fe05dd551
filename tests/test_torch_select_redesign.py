"""K8 ``select_screen``'s program encoding and K11 ``select_gather``'s
wrapper (minio_tpu_torch.ops.select_step) on the CPU.

K8 runs a statement as ``screen_program`` encodes it: masks of the
offsets whose view W(k), terminator flags term_at(k) and digit flags
digit_at(k) the atoms read (the memo, one register each a word), and one
16-byte record per atom over those offsets.  ``_evaluate`` below is the
kernel's arithmetic in int64 torch: the memo filled from the masks
alone (an entry the masks do not name is a KeyError here, where the
kernel would read a register never written), then every record in
order.  The encoding is held through it against the JAX package's
``screen_chunk`` (under ``jax.enable_x64``) on the seed corpus of
``test_torch_select_step.py``, the Q1-Q4 and IN programs of
``chip_smoke.py``, every atom kind, both anchors, the sci guard on and
off, a program for each lookahead of 1-6 words and hypothesis planes.
Everything is integer arithmetic: every comparison is exact (tolerance
zero).  The memo masks are held against ``chip_smoke.screen_ops``'s own
distinct offsets (the ones the bound charges), the lookahead against
``_max_shift``, and every program against the checks of select.cu's
entry.  The kernels run only on the card; the test here that needs one
skips without it (``chip_smoke.py`` holds them on the H100).
"""

from __future__ import annotations

import ctypes
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from minio_tpu.ops import select_step as jss
from minio_tpu_torch.ops import kernels, select_step as tss
from minio_tpu_torch.s3select import device as sdev, sql
from tests.test_torch_select_step import (
    ALPHABET, EVERY_KIND, IN_LIST, SCREENS, _csvish, _fields, _plane)
from tests.test_torch_threads import torch_threads  # noqa: F401

FD = ord(",")
QC = ord('"')
HI = tss._SHI


# ---------------------------------------------------------------------------
# the kernel's arithmetic over the encoding
# ---------------------------------------------------------------------------


def _ge_bytes(w, b: int):
    """ge_lanes: lanes >= the byte whose (0x80 - byte) is ``b``."""
    return ((w & ~HI) + tss._s64(b * tss._LO)) & HI


def _term(w, fd):
    return tss._swar_eq(w, 10) | tss._swar_eq(w, fd)


def _digit(w):
    return _ge_bytes(w, 0x80 - 0x30) & ~_ge_bytes(w, 0x80 - 0x3A)


def _evaluate(arr: torch.Tensor, prog, *, fd: int, qc: int, anchor: str,
              sci: bool):
    """screen_kernel<prog.q> on a CPU plane: (cand, blk, nrows, hazard)."""
    w = tss._words(arr)
    nw = w.shape[0]
    q = prog.q
    K = 8 * q
    wp = torch.cat([w.new_zeros(1), w, w.new_zeros(q + 1)])

    def view(k):
        qq, r = divmod(k, 8)
        lo = wp[qq + 1:qq + 1 + nw]
        if not r:
            return lo
        return tss._srl(lo, 8 * r) | (wp[qq + 2:qq + 2 + nw] << (64 - 8 * r))

    # the memo: views, terminator flags and nd's flags ~digit & ~term
    V, T, N = {1: view(1)}, {}, {}
    for k in range(2, K):
        if prog.vmask >> k & 1:
            V[k] = view(k)
    for k in range(1, K):
        if prog.tmask >> k & 1:
            T[k] = _term(V[k], fd)
        if prog.dmask >> k & 1:
            N[k] = ~_digit(V[k]) & ~T[k] & HI
    full = torch.full_like(w, HI)
    hit, bm = torch.zeros_like(w), full
    for rec in prog.records:
        op, arg, m = int(rec["op"]), int(rec["arg"]), int(rec["m"])
        kind = op & 15
        if kind == tss._OP["terms"]:
            acc = torch.zeros_like(w)
            for k in range(1, K):
                if m >> k & 1:
                    acc = acc | T[k]
            v = ~acc & HI if op & tss._FLAG else acc
        elif kind == tss._OP["range"]:
            v = _ge_bytes(V[1], arg & 0xFF) & ~_ge_bytes(V[1], arg >> 8 & 0xFF)
            if op & tss._FLAG:
                v = v & ~V[1]
        elif kind == tss._OP["nd"]:
            seen = h = torch.zeros_like(w)
            for k in range(1, K):
                if m >> k & 1:
                    h = h | (N[k] & ~seen)
                    seen = seen | T[k]
            v = h
        else:
            assert kind == tss._OP["lex"]
            mode, n = arg & 0xFF, arg >> 8 & 0xFF
            pref, h, endv = full, torch.zeros_like(w), None
            for i in range(min(tss.MAX_LEX + 1, K - 1)):
                if i < n:
                    c = m >> (8 * i) & 0xFF
                    wi = V[i + 1]
                    if mode <= tss._MODE["le"]:
                        below = ~_ge_bytes(wi, 0x80 - c) & HI if c else 0
                        h = h | (pref & (below | T[i + 1]))
                    elif mode >= tss._MODE["ge"]:
                        b = 0x7F - c if c < 0x7F else 0
                        above = (((wi & ~HI) + tss._s64(b * tss._LO)) | wi) & HI
                        h = h | (pref & above & ~T[i + 1])
                    pref = pref & tss._swar_eq(wi, c)
                elif i == n:
                    endv = T[i + 1]
            over = bool(op & tss._FLAG)
            if mode in (tss._MODE["eq"], tss._MODE["le"], tss._MODE["ge"]):
                h = h | (pref if over else pref & endv)
            if mode in (tss._MODE["gt"], tss._MODE["ge"]):
                h = h | (pref & ~endv)
            if mode == tss._MODE["lt"] and over:
                h = h | pref
            v = h
        bm = bm & v
        if op & tss._LAST:
            hit, bm = hit | bm, full
    ww = wp[1:1 + nw]
    nl = tss._swar_eq(ww, 10)
    base = _term(ww, fd) if anchor == "field" else nl
    cand = base & hit
    haz = (tss._swar_eq(ww, qc) | (tss._swar_eq(ww, 13) & ~tss._swar_eq(V[1], 10))
           | tss._swar_eq(ww, 0))
    if sci:
        e = tss._swar_eq(ww, 0x65) | tss._swar_eq(ww, 0x45)
        haz = haz | (e & _digit(view(-1)))
    combo = tss._popc(cand) | (tss._popc(nl) << 7) | ((haz != 0).to(torch.int64) << 14)
    bs = combo.view(-1, tss.POP_WORDS).sum(dim=1).to(torch.int32)
    return cand, bs & 127, int(((bs >> 7) & 127).sum()), bool((bs >> 14).any())


def _entry_accepts(prog) -> bool:
    """The checks mts_screen makes before it launches (select.cu)."""
    q = prog.q
    if not 1 <= q <= tss._MAX_Q:
        return False
    span = (1 << 8 * q) - 2
    if (prog.vmask | prog.tmask | prog.dmask) & ~span:
        return False
    if (prog.tmask | prog.dmask) & ~(prog.vmask | 2) or prog.dmask & ~prog.tmask:
        return False
    for rec in prog.records:
        op, arg, m = int(rec["op"]), int(rec["arg"]), int(rec["m"])
        kind, mode, n = op & 15, arg & 0xFF, arg >> 8 & 0xFF
        if kind == tss._OP["terms"]:
            ok = not m & ~prog.tmask
        elif kind == tss._OP["nd"]:
            ok = not m & ~prog.tmask and not m & ~prog.dmask
        elif kind == tss._OP["lex"]:
            pos = (2 << n) - 2
            ok = (mode <= tss._MODE["gt"] and n <= tss.MAX_LEX and n + 1 < 8 * q
                  and not pos & ~(prog.vmask | 2) and prog.tmask >> (n + 1) & 1
                  and (mode == tss._MODE["eq"] or not pos & ~prog.tmask))
        else:
            ok = kind == tss._OP["range"]
        if not ok:
            return False
    return True


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------


def _screen(where: str):
    header = chip_smoke.LI_HEADER.split("|")
    return sdev.compile_screen(
        sql.parse(f"SELECT * FROM S3Object s WHERE {where}").where, header)


def _compiled(where: str):
    return _screen(where).atoms


KEYS = ", ".join(map(str, (17, 4242, 199999, 6, 73011, 1000, 55555, 123456, 8,
                           90210, 31, 777, 150001, 42, 2, 65536)))  # 1-6 digits
WHERE = {  # chip_smoke.py's queries and IN programs
    "Q1": "s.l_orderkey < 1000", "Q2": "s.l_shipmode = 'AIR'",
    "Q3": "s.l_quantity < 24", "Q4": "s.l_linestatus = 'O'",
    "IN16 field": f"s.l_partkey IN ({KEYS})",
    "IN16 row": f"s.l_orderkey IN ({KEYS})",
}
KINDS = ((("len", 1, 3), ("byte0", 48, 57)), (("deep", 5), ("nd", 7)),
         (("lex", b"1000", "lt"),), (("lex", b"TAKE BACK RETURN", "le"),),
         (("lex", b"MAIL", "eq"),), (("lex", b"1997-09", "ge"),),
         (("lex", b"SHIP", "gt"),), (("byte0", 0, 50), ("len", 0, 0)))
PROGRAMS = dict(SCREENS)
PROGRAMS.update({name: _compiled(where) for name, where in WHERE.items()})
PROGRAMS.update({
    "kinds": KINDS,
    # lex at its edges: past MAX_LEX in every mode, a NUL and a 0x80 byte
    # under lt/le, 0x7E/0x7F under gt/ge, the empty literal
    "lex edges": tuple((("lex", lit, mode),) for lit, mode in (
        (b"abcdefghijk", "lt"), (b"abcdefghijk", "le"), (b"abcdefghijk", "eq"),
        (b"abcdefghijk", "ge"), (b"abcdefghijk", "gt"), (b"a\x00b", "lt"),
        (b"1\x80", "le"), (b"~x", "gt"), (b"\x7f", "ge"), (b"", "eq"),
        (b"", "lt"), (b"", "gt"))),
    # byte0 at its edges: lo 0, a negative lo, hi 0x7F
    "byte0 edges": ((("byte0", 0, 47),), (("byte0", -5, 60),),
                    (("byte0", 100, 127), ("len", 2, 2))),
    # repeated branches and atoms, an empty branch
    "repeats": ((("len", 0, 2), ("len", 0, 2)), (("nd", 3),), (("len", 0, 2),),
                (("nd", 3),), (("byte0", 43, 48), ("len", 0, 2))),
    "empty branch": ((("lex", b"zz", "gt"),), ()),
    "no branch": (),
})
# one program for each lookahead: q words read offsets up to 8q - 1
for _q in range(1, tss._MAX_Q + 1):
    PROGRAMS[f"q{_q}"] = ((("len", 0, 8 * _q - 2),), (("nd", 8 * _q - 1),),
                          (("deep", 8 * _q - 3), ("lex", b"12", "ge")))


def _jax_screen(arr, atoms, anchor, sci, fd=FD, qc=QC):
    with jax.enable_x64(True):
        cand, blk, nrows, haz = jss.screen_chunk(
            jnp.asarray(arr), fd=fd, qc=qc, atoms=atoms, anchor=anchor,
            sci_guard=sci)
        return (np.asarray(cand).view(np.int64), np.asarray(blk),
                int(nrows), bool(haz))


def _same(arr: np.ndarray, atoms, anchor, sci, fd=FD, qc=QC, want=None):
    got = _evaluate(torch.from_numpy(arr.copy()), tss.screen_program(atoms),
                    fd=fd, qc=qc, anchor=anchor, sci=sci)
    if want is None:
        want = _jax_screen(arr, atoms, anchor, sci, fd, qc)
    assert np.array_equal(got[0].numpy(), want[0]), "candidate words"
    assert np.array_equal(got[1].numpy(), want[1]), "block sums"
    assert got[2:] == tuple(want[2:]), "row count and hazard"
    return got


@functools.lru_cache(maxsize=4)
def _lineitem(nbytes: int) -> bytes:
    return chip_smoke.lineitem_csv(chip_smoke.SEED + 15, nbytes)


# ---------------------------------------------------------------------------
# the encoding against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sci", [False, True])
@pytest.mark.parametrize("anchor", ["row", "field"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_the_reference(name, anchor, sci):
    """Mixed planes: random bytes of the test alphabet, fields of the
    seed corpus's vocabulary, and hazards."""
    data = _csvish(31, 1500) + _fields(32, 60) + _csvish(33, 300, hazards=True)
    _same(_plane(data), PROGRAMS[name], anchor, sci)


@pytest.mark.parametrize("name", [*WHERE, "kinds"])
def test_lineitem_rows_match_the_reference(name):
    """The select path's own rows (chip_smoke.lineitem_csv), under the
    anchor and sci guard the compiler gives each query."""
    data = _lineitem(6000)
    scr = sdev._Screen(KINDS, "field", True) if name == "kinds" else _screen(
        WHERE[name])
    got = _same(_plane(data), scr.atoms, scr.anchor, scr.sci_guard, fd=ord("|"))
    assert got[2] == data.count(b"\n")


@settings(max_examples=30, deadline=None)
@given(
    data=st.binary(min_size=1, max_size=900).map(
        lambda b: bytes(ALPHABET[x % len(ALPHABET)] for x in b) + b"\n"),
    which=st.sampled_from(["Q1", "IN16 field", "kinds", "lex edges", "q2", "q6",
                           "repeats", "every_kind"]),
    anchor=st.sampled_from(["row", "field"]),
    sci=st.booleans(),
)
def test_program_random_planes(data, which, anchor, sci):
    _same(_plane(data), PROGRAMS[which], anchor, sci)


def test_swar_borrow_across_the_word_halves():
    """_swar_eq's borrow from lane 3 into lane 4 (a ``,`` at byte 3 of a
    word and ``-`` = ``,`` ^ 1 at byte 4): the 64-bit arithmetic keeps
    it, so ``deep(2)`` is not met there; the evaluator flags what the
    reference flags."""
    arr = _plane(b"xyz,-a,b\n,-1,22\n")
    got = _same(arr, ((("deep", 2),),), "field", False)
    flags = np.unpackbits(got[0].numpy().view(np.uint8), bitorder="little")
    assert 3 not in (np.flatnonzero(flags) // 8).tolist()


def test_records_past_the_launch_parameters():
    """An IN list of 150 options: more records than a launch passes by
    value.  The rest travel in a device buffer (here the CPU's), in the
    records' own layout; the program screens as the reference does."""
    opts = ", ".join(str(v * 13 + 1) for v in range(150))
    atoms = _compiled(f"s.l_partkey IN ({opts})")
    prog = tss.screen_program(atoms)
    assert prog.nrec > tss._PARAM_RECS
    more = tss._program_tensor(atoms, torch.device("cpu"))
    assert more.dtype == torch.uint8
    assert more.numpy().tobytes() == prog.records[tss._PARAM_RECS:].tobytes()
    assert tss._program_tensor(PROGRAMS["Q1"], torch.device("cpu")).numel() == 0
    arr = _plane(_fields(40, 200).replace(b",", b"|") + _lineitem(3000))
    want = tss.screen_chunk_plain(torch.from_numpy(arr.copy()), fd=ord("|"),
                                  qc=QC, atoms=atoms, anchor="field",
                                  sci_guard=True)
    _same(arr, atoms, "field", True, fd=ord("|"),
          want=(want[0].numpy(), want[1].numpy(), int(want[2]), bool(want[3])))


# ---------------------------------------------------------------------------
# the encoding's own properties
# ---------------------------------------------------------------------------


class _Seen(set):
    """screen_ops's memo set, recording every distinct key it holds."""

    last: "_Seen | None" = None

    def __init__(self, *args):
        super().__init__(*args)
        type(self).last = self


@pytest.mark.parametrize("sci", [False, True])
@pytest.mark.parametrize("anchor", ["row", "field"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_memo_masks_are_the_bounds_offsets(name, anchor, sci, monkeypatch):
    """The memo masks name exactly the distinct offsets that
    chip_smoke.screen_ops charges (its own memo set, read as it runs):
    the kernel computes each of them once a word and no other, beside
    the ones every word needs (W(0), W(1), term_at(0) under a field
    anchor, W(-1) and digit_at(-1) under the sci guard)."""
    monkeypatch.setattr(chip_smoke, "set", _Seen, raising=False)
    chip_smoke.screen_ops(PROGRAMS[name], anchor, sci)
    seen = _Seen.last
    prog = tss.screen_program(PROGRAMS[name])

    def keys(tag):
        return {k for t, k in seen if t == tag}

    def bits(mask):
        return {k for k in range(64) if mask >> k & 1}

    fixed_v = {0, 1} | ({-1} if sci else set())
    assert keys("w") == bits(prog.vmask) | fixed_v
    assert keys("t") == bits(prog.tmask) | ({0} if anchor == "field" else set())
    assert keys("d") == bits(prog.dmask) | ({-1} if sci else set())


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_lookahead_picks_the_instantiation(name):
    """q = _max_shift // 8 + 1 words, one of screen_kernel<1> .. <6>,
    and every offset the program reads lies inside it; the entry's
    checks accept the program."""
    atoms = PROGRAMS[name]
    prog = tss.screen_program(atoms)
    assert prog.q == tss._max_shift(atoms, False) // 8 + 1
    assert 1 <= prog.q <= tss._MAX_Q
    assert (prog.vmask | prog.tmask | prog.dmask) >> (8 * prog.q) == 0
    assert not (prog.vmask | prog.tmask | prog.dmask) & 1
    assert _entry_accepts(prog)


def test_every_instantiation_is_reached():
    assert {tss.screen_program(a).q for a in PROGRAMS.values()} == set(
        range(1, tss._MAX_Q + 1))
    assert tss.screen_program(PROGRAMS["Q1"]).q == 1
    assert tss.screen_program(PROGRAMS["IN16 field"]).q == 2


def test_entry_refuses_a_faulty_program():
    """What the entry's checks catch: a mask past the lookahead, a flag
    set without its view, a record reading an offset no mask names."""
    prog = tss.screen_program(PROGRAMS["Q1"])

    def with_(**kw):
        fields = {f: getattr(prog, f) for f in ("q", "vmask", "tmask", "dmask",
                                                "records", "blob")}
        fields.update(kw)
        return tss.ScreenProgram(**fields)

    assert _entry_accepts(prog)
    assert not _entry_accepts(with_(vmask=prog.vmask | 1 << 8))
    assert not _entry_accepts(with_(q=7))
    assert not _entry_accepts(with_(vmask=2))
    assert not _entry_accepts(with_(tmask=prog.tmask & ~(1 << 3)))
    assert not _entry_accepts(with_(dmask=0))
    assert not _entry_accepts(with_(tmask=prog.tmask & ~(1 << 6)))


def test_repeated_branches_and_atoms_are_dropped():
    prog = tss.screen_program(PROGRAMS["repeats"])
    # (len, len) -> one len; the second nd and len branches repeat
    assert prog.nrec == 4
    assert [int(o) & tss._LAST for o in prog.records["op"]] == [
        tss._LAST, tss._LAST, 0, tss._LAST]
    assert tss.screen_program(IN_LIST).nrec == 16 + 1 + 3
    assert tss.screen_program(PROGRAMS["IN16 field"]).nrec < len(
        PROGRAMS["IN16 field"])
    empty = tss.screen_program(((),)).records
    assert len(empty) == 1 and int(empty["op"][0]) == (
        tss._OP["terms"] | tss._FLAG | tss._LAST) and int(empty["m"][0]) == 0
    assert tss.screen_program(()).nrec == 0


@pytest.mark.parametrize("branch,exc", [
    ((("len", 0, 47),), ValueError),  # past the 47-byte lookahead
    ((("nd", 48),), ValueError),
    ((("lex", b"abc", "lt"), ("spam", 1)), ValueError),  # unknown atom
    ((("lex", b"abc", "ne"),), ValueError),  # unknown lex mode
    ((("len", -2, 3),), ValueError),  # a field length below 0
    ((("lex", "é".encode(), "lt"),), OverflowError),  # lt byte past 0x80
    ((("byte0", 0, 200),), OverflowError),  # byte0 bound past 0x80
    ((("byte0", -200, 20),), OverflowError),
])
def test_refusals(branch, exc):
    with pytest.raises(exc):
        tss.screen_program((branch,))


def test_large_in_lists_stay_supported():
    """An IN list of 1,000 options encodes (records past 128 go to the
    device buffer); its memo is the one of a single option's."""
    opts = ", ".join(str(v * 7919 % 200000 + 100000) for v in range(1000))
    prog = tss.screen_program(_compiled(f"s.l_partkey IN ({opts})"))
    assert prog.nrec > 1000 and prog.q == 2 and _entry_accepts(prog)
    single = tss.screen_program(_compiled("s.l_partkey IN (123456)"))
    assert (prog.vmask, prog.tmask, prog.dmask) == (
        single.vmask, single.tmask, single.dmask)


# ---------------------------------------------------------------------------
# K11's wrapper
# ---------------------------------------------------------------------------


def _fake(dtype, shape=(512,), cuda=True, contiguous=True, device=0):
    """A stand-in for a CUDA tensor: what the checks read, no storage."""
    return types.SimpleNamespace(
        is_cuda=cuda, dtype=dtype, shape=shape, device=types.SimpleNamespace(
            type="cuda" if cuda else "cpu"),
        dim=lambda: len(shape), numel=lambda: int(np.prod(shape)),
        is_contiguous=lambda: contiguous, get_device=lambda: device)


@pytest.mark.parametrize("arr,idx,window,exc,match", [
    (_fake(torch.uint8), _fake(torch.int32, cuda=False), 64, ValueError, "CUDA"),
    (_fake(torch.int32), _fake(torch.int32), 64, TypeError, "uint8"),
    (_fake(torch.uint8), _fake(torch.int64), 64, TypeError, "int32"),
    (_fake(torch.uint8, (8, 64)), _fake(torch.int32), 64, ValueError, "1 dim"),
    (_fake(torch.uint8), _fake(torch.int32, (3, 2)), 64, ValueError, "1 dim"),
    (_fake(torch.uint8, contiguous=False), _fake(torch.int32), 64, ValueError,
     "contiguous"),
    (_fake(torch.uint8), _fake(torch.int32, device=1), 64, ValueError,
     "different devices"),
    (_fake(torch.uint8), _fake(torch.int32), 66, ValueError, "window 66"),
    (_fake(torch.uint8), _fake(torch.int32), 0, ValueError, "window 0"),
    (_fake(torch.uint8, (0,)), _fake(torch.int32), 64, ValueError, "over 0 bytes"),
])
def test_gather_wrapper_refusals(arr, idx, window, exc, match):
    """gather_rows refuses, before it allocates or launches, what K11
    does not take: no fallback to the plain version."""
    kernels.reset_launches()
    with pytest.raises(exc, match=match):
        tss.gather_rows(arr, idx, window=window)
    assert kernels.LAUNCHES["select_gather"] == 0


def test_gather_wrapper_refuses_meta_tensors():
    meta = torch.empty(512, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tss.gather_rows(meta, torch.zeros(3, dtype=torch.int32), window=64)


def test_call_structs_match_select_cu():
    """The packed calls' sizes, as select.cu's static_asserts fix them."""
    assert tss._SCREEN_CALL.size == 120 and tss._GATHER_CALL.size == 56
    assert tss._REC.itemsize == 16
    prog = tss.screen_program(PROGRAMS["Q1"])
    assert ctypes.sizeof(prog.blob) == prog.records.nbytes


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
    """K8 under every program of the corpus (each lookahead, records past
    the launch's parameters) and K11 at every window, start alignment and
    plane offset, each bit for bit against its plain version; the
    entries refuse a faulty call."""
    data = _csvish(41, 60_000) + _lineitem(40_000).replace(b"|", b",")
    arr = torch.from_numpy(_plane(data).copy()).to(card)
    opts = ", ".join(str(v * 13 + 1) for v in range(150))
    progs = dict(PROGRAMS, big=_compiled(f"s.l_partkey IN ({opts})"))
    for name, atoms in progs.items():
        for anchor in ("row", "field"):
            got = tss.screen_chunk(arr, fd=FD, qc=QC, atoms=atoms, anchor=anchor,
                                   sci_guard=True)
            want = tss.screen_chunk_plain(arr, fd=FD, qc=QC, atoms=atoms,
                                          anchor=anchor, sci_guard=True)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    n = arr.numel()
    rng = np.random.default_rng(5)
    starts = torch.from_numpy(np.concatenate([
        rng.integers(-300, n + 300, 700), [0, -1, n - 1, n, 1, 15, 17]]
    ).astype(np.int32)).to(card)
    for off in (0, 1, 3, 8, 13):
        sub = arr[off:]
        for window in (4, 12, 36, 64, 256, 1024, 4096):
            assert torch.equal(tss.gather_rows(sub, starts, window=window),
                               tss.gather_rows_plain(sub, starts, window=window))
    lib = kernels._load()
    assert lib.mts_gather(tss._GATHER_CALL.pack(
        arr.data_ptr(), starts.data_ptr(), arr.data_ptr(), 0, n, 3, 6, 0, 0)) != 0
    prog = tss.screen_program(PROGRAMS["Q1"])
    assert lib.mts_screen(tss._SCREEN_CALL.pack(
        arr.data_ptr(), 0, 0, 0, 0, 0, prog.addr, n // 8, prog.vmask | 1 << 9,
        prog.tmask, prog.dmask, 0, FD, QC, 0, 0, prog.q, prog.nrec, 0)) != 0
