"""S3 Select's device functions (SWAR over uint64 word planes): the
wrappers, their plain PyTorch versions, and the binding of their kernels.

Layout contract
---------------

* ``arr`` is the chunk's bytes as a flat uint8 plane, padded to a
  multiple of 512 bytes with a filler byte that is never a newline,
  field delimiter, quote, CR, or NUL (the engine uses ``b"x"``), and
  always ending (before the pad) in a newline.
* Flag words are u64 with ``0x80`` set in each byte lane that matches;
  the word view is a little-endian bitcast of 8 consecutive bytes, so
  lane ``i`` of word ``w`` is byte ``8*w + i``.  They travel as int64
  tensors holding the same bits.
* ``screen_chunk`` is the only O(N) pass: it fuses byte
  classification, the statement-compiled candidate screen, the hazard
  scalar, and per-64-byte (8-word) block popcount sums.  The screen is
  CONSERVATIVE - it may flag rows that do not match, never the
  reverse; exactness lives entirely in the host engines that re-filter
  the candidate rows.  Everything after it is O(candidates).
* Candidate flags sit on the ``\\n`` (anchor mode ``row``) or on any
  field-opening terminator (anchor mode ``field``); the byte AFTER a
  flagged position starts the screened field.

Screen atoms (static, hashable) compiled by s3select/device.py:

* ``("len", lo, hi)`` - first field length in [lo, hi] (a terminator
  at offset length+1 from the flag).
* ``("deep", k)``     - no terminator within the first k field bytes.
* ``("byte0", lo, hi)`` - first field byte in [lo, hi] (ASCII).
* ``("nd", k)``       - a non-digit, non-terminator byte within the
  first k field bytes.
* ``("lex", lit, mode)`` - field lexicographically <, <=, ==, >=, >
  the literal byte string (mode in "lt|le|eq|ge|gt"), exact over the
  first ``len(lit)`` bytes plus the terminator.

The kernels (``csrc/select.cu``, CUDA C++ for ``sm_90a``):

* ``select_screen`` (K8) replaces ``select_step.screen_chunk`` (X4, XLA
  in the JAX package).  It is bound by its integer operations: the
  memoized expression (each distinct view and flag set once a word) over
  a plane read once.  ``screen_program`` encodes the statement as the
  reference memoizes it - masks of the offsets whose view, terminator
  flags and digit flags it reads, and one 16-byte record per atom over
  those offsets, repeated branches dropped - and the wrapper launches
  ``screen_kernel<q>`` for the statement's lookahead q (1-6 words): each
  view two funnel shifts by constant amounts, each memo entry a
  register computed once a word, the records in the launch's parameters
  (past 128 from a device buffer).  One packed struct, one memset (the
  two scalars) and one launch.
* ``select_positions`` (K9) replaces ``extract_positions`` (X5).  The
  block cumsum before it stays ``torch.cumsum``, outside the function
  as in the JAX package.
* ``select_spans`` (K10) replaces ``row_spans`` (``[row]``) and
  ``anchors_back`` (``[back]``) (X6): one template, two directions.
* ``select_gather`` (K11) replaces ``gather_rows`` (X7).  It is bound by
  bytes; at the path's shape most of a call is the host's wrapper and
  the launch, so the wrapper checks both tensors in one pass and passes
  one packed struct, and the kernel gives each row 1-32 lanes that read
  aligned 16-byte chunks and write 16-byte chunks (a byte path only for
  rows the clamp touches).

Each wrapper runs its plain version (``*_plain``) for a CPU tensor and
launches its kernel on ``torch.cuda.current_stream()`` for a CUDA
tensor, or raises: a failed build, a refused launch or a wrong device,
dtype, shape or layout never falls back.  The plain versions work in
int64 with the mask applied after every right shift (int64 ``>>`` is
arithmetic, and torch has no u64 ``>>`` and no popcount); they run on
either device, so the card's kernels are held against them there.

Build: ``csrc/select.cu`` is one of ``kernels.SOURCES``, so it builds
into the codec's library (its own ``nvcc -c`` beside codec.cu's, started
together), and ``kernels._load`` calls ``bind`` on it.  Launches count
into ``kernels.LAUNCHES`` under ``LAUNCH_NAMES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct

import numpy as np
import torch

from . import kernels

PAD_BYTE = 0x78  # b"x": never nl/fd/quote/CR/NUL
BLOCK_BYTES = 512  # plane padding granularity (callers pad to this)
POP_WORDS = 8  # words per popcount block (64 bytes): the reshape
# factor of screen_chunk's block sums and extract_positions' ranks
MAX_LEX = 8  # lex/byte-chain depth cap (screen shifts stay bounded)

_LO = 0x0101010101010101
_HI = 0x8080808080808080


def _max_shift(atoms, sci_guard: bool) -> int:
    """Largest forward byte offset any atom (or the hazard pass)
    reads - sizes the zero pad behind the word buffer."""
    m = 1  # bare-CR hazard looks at p+1
    for branch in atoms:
        for atom in branch:
            kind = atom[0]
            if kind == "len":
                m = max(m, atom[2] + 1)
            elif kind in ("deep", "nd"):
                m = max(m, atom[1])
            elif kind == "byte0":
                m = max(m, 1)
            elif kind == "lex":
                m = max(m, min(len(atom[1]), MAX_LEX) + 1)
    return m


# ---------------------------------------------------------------------------
# u64 arithmetic on int64 tensors
# ---------------------------------------------------------------------------


def _s64(x: int) -> int:
    """A u64 constant as the int64 holding its bits; like the JAX
    package's ``jnp.uint64(np.uint64(x))``, a value outside u64 raises
    OverflowError."""
    if not 0 <= x < 1 << 64:
        raise OverflowError(f"Python integer {x} out of bounds for uint64")
    return x - (1 << 64) if x >> 63 else x


_SLO = _s64(_LO)
_SHI = _s64(_HI)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


_M1 = _s64(0x5555555555555555)
_M2 = _s64(0x3333333333333333)
_M4 = _s64(0x0F0F0F0F0F0F0F0F)


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each u64 word (SWAR popcount on int64)."""
    x = x - (_srl(x, 1) & _M1)
    x = (x & _M2) + (_srl(x, 2) & _M2)
    x = (x + _srl(x, 4)) & _M4
    return _srl(x * _SLO, 56)


def _words(arr: torch.Tensor) -> torch.Tensor:
    """Little-endian u64 view (as int64) of the byte plane."""
    return arr.reshape(-1).view(torch.int64)


def _swar_eq(w, byte):
    """0x80 flag in each lane equal to ``byte``."""
    x = w ^ _s64(byte * _LO)
    return (x - _SLO) & ~x & _SHI


def _swar_ge(w, c):
    """0x80 flag where lane >= c; only meaningful for ASCII lanes
    (< 0x80) - non-ASCII lanes are ORed in separately by callers that
    need them."""
    return ((w & ~_SHI) + _s64((0x80 - c) * _LO)) & _SHI


def _atom_words(atom, W, term_at, digit_at):
    """Flag-words for one screen atom, anchored one byte BEFORE the
    field (i.e. on the opening terminator).  ``W(k)`` is the word
    plane shifted so lane p carries byte p+k; ``term_at(k)`` /
    ``digit_at(k)`` are the memoized terminator / digit flags on it."""
    kind = atom[0]
    zero = torch.zeros_like(W(0))
    if kind == "len":
        lo, hi = atom[1], atom[2]
        m = zero
        for ln in range(lo, hi + 1):
            m = m | term_at(ln + 1)
        return m
    if kind == "deep":
        k = atom[1]
        seen = zero
        for i in range(1, k + 1):
            seen = seen | term_at(i)
        return ~seen & _SHI
    if kind == "byte0":
        lo, hi = atom[1], atom[2]
        w1 = W(1)
        m = _swar_ge(w1, lo) & ~_swar_ge(w1, hi + 1)
        if lo == 0:
            # ASCII-only trick misses nothing at the low end, but a
            # [0, hi] range must not claim non-ASCII lanes
            m = m & ~(w1 & _SHI)
        return m
    if kind == "nd":
        k = atom[1]
        seen = zero
        hit = zero
        for i in range(1, k + 1):
            nd = ~digit_at(i) & ~term_at(i) & _SHI
            hit = hit | (nd & ~seen)
            seen = seen | term_at(i)
        return hit
    if kind == "lex":
        lit, mode = atom[1], atom[2]
        n = min(len(lit), MAX_LEX)
        pref = zero | _SHI  # field[:i] == lit[:i] so far (i = 0)
        hit = zero
        for i in range(n):
            wi = W(i + 1)
            if mode in ("lt", "le"):
                below = (
                    _swar_ge(wi, 0) & ~_swar_ge(wi, lit[i])
                    if lit[i] > 0 else zero
                )
                hit = hit | (pref & below)
                # strict prefix (field ends first) sorts below
                hit = hit | (pref & term_at(i + 1))
            elif mode in ("gt", "ge"):
                above = (_swar_ge(wi, lit[i] + 1) | (wi & _SHI)) \
                    if lit[i] < 0x7F else (wi & _SHI)
                hit = hit | (pref & above & ~term_at(i + 1))
            pref = pref & _swar_eq(wi, lit[i])
        endv = term_at(n + 1)
        if mode in ("eq", "le", "ge"):
            if len(lit) <= MAX_LEX:
                hit = hit | (pref & endv)
            else:
                hit = hit | pref  # prefix-truncated: keep conservative
        if mode in ("gt", "ge"):
            hit = hit | (pref & ~endv)  # longer field, lit is a prefix
        if mode == "lt" and len(lit) > MAX_LEX:
            hit = hit | pref  # can't see past the cap: conservative
        return hit
    raise ValueError(f"unknown screen atom {atom!r}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def screen_chunk_plain(arr: torch.Tensor, *, fd: int, qc: int, atoms,
                       anchor: str, sci_guard: bool):
    """The plain version of ``screen_chunk``: one pass over the whole
    plane (the JAX package's cache windows give the same bits), the
    shifted views from one zero-padded word buffer (a zero word before
    the plane, zero words past its end)."""
    w = _words(arr)
    nw = w.shape[0]
    qmax = _max_shift(atoms, sci_guard) // 8 + 1
    wp = torch.cat([w.new_zeros(1), w, w.new_zeros(qmax + 1)])
    memo: dict = {}

    def W(k: int):
        got = memo.get(k)
        if got is None:
            q, r = divmod(k, 8)
            lo = wp[q + 1:q + 1 + nw]
            if r:
                hi = wp[q + 2:q + 2 + nw]
                got = _srl(lo, 8 * r) | (hi << (64 - 8 * r))
            else:
                got = lo
            memo[k] = got
        return got

    def term_at(k: int):
        got = memo.get(("t", k))
        if got is None:
            wk = W(k)
            got = _swar_eq(wk, 10) | _swar_eq(wk, fd)
            memo[("t", k)] = got
        return got

    def digit_at(k: int):
        got = memo.get(("d", k))
        if got is None:
            wk = W(k)
            got = _swar_ge(wk, 0x30) & ~_swar_ge(wk, 0x3A)
            memo[("d", k)] = got
        return got

    ww = W(0)
    nl = _swar_eq(ww, 10)
    base = nl if anchor == "row" else term_at(0)
    hit = torch.zeros_like(ww)
    for branch in atoms:
        bm = torch.full_like(ww, _SHI)
        for atom in branch:
            bm = bm & _atom_words(atom, W, term_at, digit_at)
        hit = hit | bm
    cand = base & hit
    hazflags = (
        _swar_eq(ww, qc)
        | (_swar_eq(ww, 13) & ~_swar_eq(W(1), 10))
        | _swar_eq(ww, 0)
    )
    if sci_guard:
        # a digit-prefixed exponent field ("1000e-8") coerces numeric
        # with a value no length/shape atom can bound: any digit
        # immediately followed by e/E sends the chunk to the host
        e = _swar_eq(ww, 0x65) | _swar_eq(ww, 0x45)
        hazflags = hazflags | (e & digit_at(-1))
    combo = (
        _popc(cand)
        | (_popc(nl) << 7)
        | ((hazflags != 0).to(torch.int64) << 14)
    )
    bs = combo.view(-1, POP_WORDS).sum(dim=1).to(torch.int32)
    return (
        cand,
        bs & 127,
        ((bs >> 7) & 127).sum(dtype=torch.int32),
        (bs >> 14).any(),
    )


def extract_positions_plain(cand: torch.Tensor, cum: torch.Tensor, *,
                            cap: int) -> torch.Tensor:
    """Byte positions of the first ``cap`` candidate flags.

    ``cum`` is the inclusive cumsum of the block popcounts; ranks
    beyond the true count return clamped garbage the caller slices
    off (it knows the count from ``cum[-1]``)."""
    dev = cand.device
    k = torch.arange(cap, dtype=torch.int32, device=dev)
    blk = torch.searchsorted(cum, k, right=True).to(torch.int64)
    blk = torch.clamp(blk, max=cum.shape[0] - 1)
    base = torch.where(
        blk > 0, cum[torch.clamp(blk - 1, min=0)], torch.zeros_like(k)
    )
    lr = (k - base).to(torch.int64)
    wrds = cand.view(-1, POP_WORDS)[blk]
    pcs = _popc(wrds)
    pref = torch.cumsum(pcs, dim=1) - pcs
    inw = (pref <= lr[:, None]) & (lr[:, None] < pref + pcs)
    wsel = torch.argmax(inw.to(torch.uint8), dim=1)
    word = torch.gather(wrds, 1, wsel[:, None])[:, 0]
    need = lr - torch.gather(pref, 1, wsel[:, None])[:, 0] + 1
    need = torch.clamp(need, min=1)
    p = torch.zeros(cap, dtype=torch.int64, device=dev)
    half = 32
    while half:
        c = _popc(word & ((1 << half) - 1))
        go = c < need
        need = torch.where(go, need - c, need)
        word = torch.where(go, _srl(word, half), word)
        p = torch.where(go, p + half, p)
        half //= 2
    return (((blk * POP_WORDS + wsel) << 3) + (p >> 3)).to(torch.int32)


def _window_bytes(arr, gidx):
    return arr[torch.clamp(gidx, 0, arr.shape[0] - 1)]


def row_spans_plain(arr: torch.Tensor, anchors: torch.Tensor, *,
                    window: int):
    """Length of the row starting at ``anchor + 1``: offset of the
    first newline in a forward window, and whether one was found
    (rows wider than the window are host-verified)."""
    start = anchors.to(torch.int64) + 1
    gidx = start[:, None] + torch.arange(window, device=arr.device)[None, :]
    isnl = _window_bytes(arr, gidx) == 10
    found = isnl.any(dim=1)
    return torch.argmax(isnl.to(torch.uint8), dim=1).to(torch.int32), found


def anchors_back_plain(arr: torch.Tensor, hits: torch.Tensor, *,
                       window: int):
    """Row anchor (position of the preceding newline, -1 for row 0)
    for mid-row field hits, via a backward window scan; ``found`` is
    False when the window ended before a newline or the chunk start."""
    h = hits.to(torch.int64)
    gidx = h[:, None] - torch.arange(window, device=arr.device)[None, :]
    isnl = (_window_bytes(arr, gidx) == 10) & (gidx >= 0)
    off = torch.argmax(isnl.to(torch.uint8), dim=1)
    anynl = isnl.any(dim=1)
    reach0 = (h - (window - 1)) <= 0
    anch = torch.where(anynl, h - off, torch.full_like(h, -1))
    return anch.to(torch.int32), anynl | reach0


def gather_rows_plain(arr: torch.Tensor, starts: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """(C, window) uint8 view of the rows at ``starts`` - the
    result-proportional buffer the drain seam copies to host."""
    gidx = starts.to(torch.int64)[:, None] + torch.arange(
        window, device=arr.device)[None, :]
    return _window_bytes(arr, gidx)


# ---------------------------------------------------------------------------
# the screen program (K8's encoding of the atoms)
# ---------------------------------------------------------------------------

# Constants shared with csrc/select.cu, which exports its own values
# (mts_constants); bind refuses a library that differs from these.
_SCREEN_THREADS = 256
_MAX_PROGRAM_SHIFT = 47  # kMaxShift: the largest byte offset a program reads
_MAX_Q = _MAX_PROGRAM_SHIFT // 8 + 1  # kMaxQ: screen_kernel<1> .. <6>
_PARAM_RECS = 128  # kParamRecs: records passed by value in the launch
_REC = np.dtype([("op", "<u4"), ("arg", "<u4"), ("m", "<u8")])  # struct Rec
_OP = {"terms": 1, "range": 2, "nd": 3, "lex": 4}  # kTerms .. kLex
_LAST = 16  # kLast: the last atom of its OR branch
_FLAG = 32  # kFlag: deep's inversion, byte0's lo == 0, lex's len > MAX_LEX
_MODE = {"lt": 0, "le": 1, "eq": 2, "ge": 3, "gt": 4}


@dataclasses.dataclass(frozen=True, eq=False)
class ScreenProgram:
    """The atoms as K8 runs them (``screen_program``)."""

    q: int  # lookahead words: the kernel's instantiation screen_kernel<q>
    vmask: int  # bit k: the program reads the view W(k) (1 <= k < 8q)
    tmask: int  # ... term_at(k)
    dmask: int  # ... digit_at(k)
    records: np.ndarray  # struct Rec (_REC), one per atom
    blob: ctypes.Array  # the records' bytes, for the entry to copy

    @property
    def nrec(self) -> int:
        return len(self.records)

    @property
    def addr(self) -> int:
        return ctypes.addressof(self.blob)


def _bits(ks) -> int:
    return sum(1 << k for k in set(ks))


@functools.lru_cache(maxsize=256)
def screen_program(atoms) -> ScreenProgram:
    """The atoms as K8's program, memoized as the reference memoizes
    them: the masks of the offsets whose view W(k), terminator flags
    term_at(k) and digit flags digit_at(k) the atoms read (each computed
    once a word), and one 16-byte record per atom over those offsets
    (``len``/``deep``: the offsets ORed, deep inverted; ``byte0``: the
    bytes of its two lane constants; ``nd``: the offsets of its chain;
    ``lex``: mode, n = min(len, MAX_LEX), len > MAX_LEX and the first n
    literal bytes), its last atom flagged in each OR branch.  A branch
    that repeats an earlier one, and an atom that repeats one of its
    branch, add nothing to an OR or an AND and are dropped; an empty
    branch is one record that holds every lane.  ``q`` is the lookahead
    in words, ``_max_shift // 8 + 1``.  Raises OverflowError for the
    atoms whose u64 constants the JAX package cannot form either (a
    ``byte0`` bound or an lt/le literal byte past 0x80), ValueError past
    the kernel's lookahead, for a field length below 0 and for an unknown
    atom."""
    shift = _max_shift(atoms, False)
    if shift > _MAX_PROGRAM_SHIFT:
        raise ValueError(
            f"screen reads past byte {_MAX_PROGRAM_SHIFT} of the field"
        )
    views, terms, digits = set(), set(), set()
    recs = []
    seen_branches = set()
    for branch in atoms:
        body = []
        for atom in branch:
            kind = atom[0]
            if kind not in ("len", "deep", "byte0", "nd", "lex"):
                raise ValueError(f"unknown screen atom {atom!r}")
            if kind == "len":
                lo, hi = atom[1], atom[2]
                if lo < 0:
                    raise ValueError(f"screen atom {atom!r}: a length below 0")
                ks = [ln + 1 for ln in range(lo, hi + 1)]
                terms.update(ks)
                rec = (_OP["terms"], 0, _bits(ks))
            elif kind == "deep":
                ks = list(range(1, atom[1] + 1))
                terms.update(ks)
                rec = (_OP["terms"] | _FLAG, 0, _bits(ks))
            elif kind == "byte0":
                lo, hi = atom[1], atom[2]
                b_lo = _s64((0x80 - lo) * _LO) & 0xFF
                b_hi = _s64((0x80 - hi - 1) * _LO) & 0xFF
                views.add(1)
                rec = (_OP["range"] | (_FLAG if lo == 0 else 0),
                       b_lo | b_hi << 8, 0)
            elif kind == "nd":
                ks = list(range(1, atom[1] + 1))
                terms.update(ks)
                digits.update(ks)
                rec = (_OP["nd"], 0, _bits(ks))
            else:
                lit, mode = bytes(atom[1]), atom[2]
                if mode not in _MODE:
                    raise ValueError(f"unknown screen atom {atom!r}")
                n = min(len(lit), MAX_LEX)
                if mode in ("lt", "le"):
                    for c in lit[:n]:
                        if c > 0:
                            _s64((0x80 - c) * _LO)
                views.update(range(1, n + 1))
                if mode != "eq":
                    terms.update(range(1, n + 1))
                terms.add(n + 1)
                rec = (_OP["lex"] | (_FLAG if len(lit) > MAX_LEX else 0),
                       _MODE[mode] | n << 8,
                       int.from_bytes(lit[:n], "little"))
            if rec not in body:
                body.append(rec)
        key = frozenset(body)
        if key in seen_branches:
            continue
        seen_branches.add(key)
        if not body:  # an empty AND holds every lane: deep over no offset
            body = [(_OP["terms"] | _FLAG, 0, 0)]
        body[-1] = (body[-1][0] | _LAST, *body[-1][1:])
        recs.extend(body)
    records = np.array(recs, dtype=_REC)
    records.flags.writeable = False
    blob = ctypes.create_string_buffer(records.tobytes(), max(1, records.nbytes))
    vmask = _bits(views | terms | digits)
    return ScreenProgram(shift // 8 + 1, vmask, _bits(terms), _bits(digits),
                         records, blob)


@functools.lru_cache(maxsize=256)
def _program_tensor(atoms, device: torch.device) -> torch.Tensor:
    """The bytes of the records of ``screen_program(atoms)`` past the
    ones a launch passes by value, on ``device`` (made once per
    statement shape and device)."""
    more = screen_program(atoms).records[_PARAM_RECS:]
    return torch.from_numpy(np.frombuffer(more.tobytes(), np.uint8).copy()).to(device)


# ---------------------------------------------------------------------------
# build + binding
# ---------------------------------------------------------------------------

LAUNCH_NAMES = ("select_screen", "select_positions", "select_spans[row]",
                "select_spans[back]", "select_gather")  # in kernels.LAUNCHES

# K8's and K11's calls, one packed struct each (struct ScreenCall and
# GatherCall in select.cu)
_SCREEN_CALL = struct.Struct("<7Qq3Q8i")
_GATHER_CALL = struct.Struct("<4Qq4i")


def _constants() -> dict:
    """The values select.cu must export (mts_constants)."""
    return {
        "screen_threads": (_SCREEN_THREADS,),
        "max_shift": (_MAX_PROGRAM_SHIFT,), "param_recs": (_PARAM_RECS,),
        "rec_bytes": (_REC.itemsize,),
        "max_lex": (MAX_LEX,), "pop_words": (POP_WORDS,),
        "ops": tuple(_OP[k] for k in ("terms", "range", "nd", "lex")),
        "last": (_LAST,), "flag": (_FLAG,),
        "modes": tuple(_MODE[m] for m in ("lt", "le", "eq", "ge", "gt")),
        "screen_call_bytes": (_SCREEN_CALL.size,),
        "gather_call_bytes": (_GATHER_CALL.size,),
    }


def bind(lib) -> None:
    """Declare select.cu's entries on the loaded kernel library and
    refuse it if its exported constants differ from this module's.  K8
    and K11 take one packed struct (_SCREEN_CALL, _GATHER_CALL): ctypes
    converts one argument, not 8-14."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mts_screen.argtypes = [ctypes.c_char_p]
    lib.mts_positions.argtypes = [I, P, P, I, I, P, P]
    lib.mts_spans.argtypes = [I, P, L, P, I, I, I, P, P, P]
    lib.mts_gather.argtypes = [ctypes.c_char_p]
    for fn in (lib.mts_screen, lib.mts_positions, lib.mts_spans,
               lib.mts_gather):
        fn.restype = ctypes.c_int
    lib.mts_constants.restype = ctypes.c_char_p
    kernels._check_constants(lib.mts_constants().decode(), _constants(),
                             "select.cu")


def _require_same_device(name: str, *ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: tensors on different devices")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def screen_chunk(arr: torch.Tensor, *, fd: int, qc: int, atoms, anchor: str,
                 sci_guard: bool):
    """The O(N) fused pass over a padded uint8 plane.

    Returns ``(cand, blk, nrows, hazard)``: candidate flag-words (u64
    bits in int64), per-64-byte (``POP_WORDS``-word) block candidate
    popcounts (int32), total row count (int32 scalar), and the hazard
    scalar (bool) - quote, bare CR, or NUL anywhere in the chunk (and,
    under ``sci_guard``, a digit followed by e/E) sends the whole chunk
    to the host engine.  ``atoms`` is a tuple of tuples of screen
    atoms: the outer level ORs (one entry per OR branch), the inner
    level ANDs.  On the card: one memset and one K8 launch."""
    if anchor not in ("row", "field"):
        raise ValueError(f"anchor {anchor!r}")
    if arr.device.type == "cpu":
        return screen_chunk_plain(arr, fd=fd, qc=qc, atoms=atoms,
                                  anchor=anchor, sci_guard=sci_guard)
    kernels._require_cuda(arr, "screen_chunk", 1, torch.uint8)
    n = arr.shape[0]
    if n == 0 or n % (POP_WORDS * 8):
        raise ValueError(f"screen_chunk: plane of {n} bytes is not a "
                         f"positive multiple of {POP_WORDS * 8}")
    if arr.data_ptr() % 8:
        raise ValueError("screen_chunk: expected an 8-byte aligned plane")
    prog = screen_program(atoms)
    dev = arr.device
    more = _program_tensor(atoms, dev) if prog.nrec > _PARAM_RECS else None
    nw = n // 8
    cand = torch.empty(nw, dtype=torch.int64, device=dev)
    blk = torch.empty(nw // POP_WORDS, dtype=torch.int32, device=dev)
    scal = torch.empty(2, dtype=torch.int32, device=dev)  # nrows, hazard
    rc = (kernels._lib or kernels._load()).mts_screen(_SCREEN_CALL.pack(
        arr.data_ptr(), cand.data_ptr(), blk.data_ptr(), scal.data_ptr(),
        0 if more is None else more.data_ptr(), kernels._stream(arr), prog.addr,
        nw, prog.vmask, prog.tmask, prog.dmask, dev.index, fd, qc,
        int(anchor == "field"), int(sci_guard), prog.q, prog.nrec, 0))
    kernels._check_rc(rc, "screen_chunk")
    kernels._count("select_screen")
    # the hazard word is 0 or 1: its low byte read as a bool (no launch)
    return cand, blk, scal[0], scal.view(torch.bool)[4]


def extract_positions(cand: torch.Tensor, cum: torch.Tensor, *,
                      cap: int) -> torch.Tensor:
    """Byte positions (int32) of the first ``cap`` candidate flags;
    ``cum`` is the inclusive cumsum of ``screen_chunk``'s block counts.
    On the card one K9 launch."""
    if cand.device.type == "cpu":
        return extract_positions_plain(cand, cum, cap=cap)
    kernels._require_cuda(cand, "extract_positions", 1, torch.int64)
    kernels._require_cuda(cum, "extract_positions", 1, torch.int32)
    _require_same_device("extract_positions", cand, cum)
    nblk = cum.shape[0]
    if nblk == 0 or cand.shape[0] != nblk * POP_WORDS:
        raise ValueError(
            f"extract_positions: {cand.shape[0]} words for {nblk} blocks"
        )
    dev = cand.device
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap == 0:
        return out
    rc = kernels._load().mts_positions(dev.index, cand.data_ptr(), cum.data_ptr(),
                               nblk, cap, out.data_ptr(), kernels._stream(cand))
    kernels._check_rc(rc, "extract_positions")
    kernels._count("select_positions")
    return out


def _require_rows(name: str, arr: torch.Tensor, idx: torch.Tensor) -> int:
    """A contiguous 1-d uint8 plane and 1-d int32 indices on one card,
    checked in one pass (K10 and K11, whose calls are mostly host time);
    the card's index."""
    if not (arr.is_cuda and idx.is_cuda):
        raise ValueError(f"{name}: expected CUDA tensors, got {arr.device} "
                         f"and {idx.device}")
    if arr.dtype != torch.uint8 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: expected uint8 and int32, got {arr.dtype} "
                        f"and {idx.dtype}")
    if arr.dim() != 1 or idx.dim() != 1:
        raise ValueError(f"{name}: expected 1 dim each, got {tuple(arr.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (arr.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous tensors")
    dev = arr.get_device()
    if idx.get_device() != dev:
        raise ValueError(f"{name}: tensors on different devices")
    return dev


def _spans(arr, anchors, window: int, back: bool):
    name = "anchors_back" if back else "row_spans"
    _require_rows(name, arr, anchors)
    if window <= 0 or arr.shape[0] == 0:
        raise ValueError(f"{name}: window {window} over {arr.shape[0]} bytes")
    dev = arr.device
    C = anchors.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=dev)
    found = torch.empty(C, dtype=torch.bool, device=dev)
    if C == 0:
        return out, found
    rc = kernels._load().mts_spans(dev.index, arr.data_ptr(), arr.shape[0],
                           anchors.data_ptr(), C, window, int(back),
                           out.data_ptr(), found.data_ptr(), kernels._stream(arr))
    kernels._check_rc(rc, name)
    kernels._count("select_spans[back]" if back else "select_spans[row]")
    return out, found


def row_spans(arr: torch.Tensor, anchors: torch.Tensor, *, window: int):
    """(offset of the first newline after ``anchor + 1`` within
    ``window``, found) per anchor.  On the card one K10 ``[row]``
    launch."""
    if arr.device.type == "cpu":
        return row_spans_plain(arr, anchors, window=window)
    return _spans(arr, anchors, window, back=False)


def anchors_back(arr: torch.Tensor, hits: torch.Tensor, *, window: int):
    """(preceding newline of each hit, or -1, found) within ``window``
    bytes back.  On the card one K10 ``[back]`` launch."""
    if arr.device.type == "cpu":
        return anchors_back_plain(arr, hits, window=window)
    return _spans(arr, hits, window, back=True)


def gather_rows(arr: torch.Tensor, starts: torch.Tensor, *,
                window: int) -> torch.Tensor:
    """(C, window) uint8 rows at ``starts`` (clamped to the plane).  On
    the card one K11 launch from one packed struct; ``window`` a
    multiple of 4.  The call is mostly host time at the path's shape,
    so it checks both tensors in one pass and makes one allocation."""
    if not arr.is_cuda and arr.device.type == "cpu":
        return gather_rows_plain(arr, starts, window=window)
    dev = _require_rows("gather_rows", arr, starts)
    n = arr.numel()
    if window <= 0 or window % 4 or n == 0:
        raise ValueError(f"gather_rows: window {window} over {n} bytes")
    C = starts.numel()
    out = arr.new_empty((C, window))
    if C == 0:
        return out
    rc = (kernels._lib or kernels._load()).mts_gather(_GATHER_CALL.pack(
        arr.data_ptr(), starts.data_ptr(), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev), n, C, window, dev, 0))
    kernels._check_rc(rc, "gather_rows")
    kernels._count("select_gather")
    return out
