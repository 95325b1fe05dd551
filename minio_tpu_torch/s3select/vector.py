"""Vectorized CSV scan for S3 Select (pkg/s3select/csv/reader.go).

The reference gets its CSV speed from a zero-copy splitter feeding a
worker pool of C-backed record parsers; the tpu-native equivalent is a
columnar batch scan: each ~1 MiB chunk is split into rows/fields with
numpy index arithmetic (no per-row Python), referenced columns are
materialized as fixed-width byte matrices (one ``astype`` parses a
whole numeric column in C), and the WHERE tree is compiled to boolean
mask algebra over those columns.  Matched rows of a ``SELECT *`` are
emitted as raw line slices of the input chunk - the scan never
round-trips bytes through row dicts at all.

Exactness over speed: any shape whose semantics the mask algebra
cannot reproduce bit-for-bit against the row engine - quoted fields,
ragged rows, mixed (non-numeric) columns under numeric comparison,
expressions beyond column/literal algebra - drops to the row engine,
per chunk when the stream allows it (quote-free prefix stays fast) or
statically via :func:`eligible`.
"""

from __future__ import annotations

import csv
import io
import re

import numpy as np

from . import sql
from .sql import MISSING, SQLError

# scan granularity (also the fallback spill unit): 1 MiB keeps the
# chunk plus its boolean/positional temporaries inside L2/L3 - larger
# chunks measurably thrash the cache (2x slower at 4 MiB on 1 core)
CHUNK = 1 << 20

# widest single field the matrix extractor will materialize; wider
# fields are legitimate CSV but force the chunk to the row engine
MAX_FIELD_WIDTH = 4096


class _Ineligible(Exception):
    """Internal: this statement/chunk shape needs the row engine."""


# ---------------------------------------------------------------------------
# static eligibility
# ---------------------------------------------------------------------------


def _supported_where(node) -> bool:
    if node is None:
        return True
    if isinstance(node, sql.Literal):
        return node.value is not None and node.value is not MISSING
    if isinstance(node, sql.Column):
        return True
    if isinstance(node, sql.Arith):
        return node.op != "||" and _supported_where(
            node.left
        ) and _supported_where(node.right)
    if isinstance(node, sql.Compare):
        return _supported_where(node.left) and _supported_where(node.right)
    if isinstance(node, sql.Between):
        return all(
            _supported_where(e) for e in (node.expr, node.lo, node.hi)
        )
    if isinstance(node, sql.In):
        return _supported_where(node.expr) and all(
            isinstance(o, sql.Literal) and _supported_where(o)
            for o in node.options
        )
    if isinstance(node, sql.Like):
        return (
            isinstance(node.expr, sql.Column)
            and node._compiled is not None
        )
    if isinstance(node, sql.IsNull):
        return isinstance(node.expr, sql.Column)
    if isinstance(node, sql.Logical):
        return _supported_where(node.left) and (
            node.right is None or _supported_where(node.right)
        )
    return False


def eligible(stmt, req) -> bool:
    """True when the statement + serialization shapes fit the
    vectorized scan; decided before any stream byte is consumed."""
    if req.input_format != "CSV":
        return False
    a = req.csv_args
    if a.record_delimiter not in ("\n", "\r\n"):
        return False
    if len(a.field_delimiter) != 1 or len(a.quote_character) != 1:
        return False
    if len(a.quote_escape_character) != 1:
        return False
    if a.comments:
        return False
    try:
        a.field_delimiter.encode("ascii")
        a.quote_character.encode("ascii")
        a.quote_escape_character.encode("ascii")
    except UnicodeEncodeError:
        return False
    if stmt.is_aggregate:
        # every aggregate must be COUNT(*) / COUNT(col) / SUM/MIN/
        # MAX/AVG(col)
        for agg in stmt.aggregates:
            if agg.arg is not None and not isinstance(
                agg.arg, sql.Column
            ):
                return False
        # projections must be bare aggregates (wrapping expressions
        # re-evaluate via _resolve_aggregates, which is fine, but the
        # accumulation itself is what we vectorize)
    elif stmt.projections is not None:
        for p in stmt.projections:
            if not isinstance(p.expr, sql.Column):
                return False
    return _supported_where(stmt.where)


# ---------------------------------------------------------------------------
# chunk scanner
# ---------------------------------------------------------------------------


_POW10 = 10.0 ** np.arange(0, 24)


def _parse_decimal_matrix(mat: np.ndarray) -> "np.ndarray | None":
    """Exact vectorized decimal parse of a (rows, W) NUL-padded byte
    matrix -> float64, or None if any row needs the general parser.

    Handles [+-]ddd[.ddd] with <= 15 total digits: the digit sums
    build the integer mantissa M exactly (< 2^53), and one float
    division M / 10^d is correctly rounded - so the result is
    bit-identical to Python's float()/strtod on the same text.
    Scientific notation, inf/nan, hex, and longer digit strings
    return None (caller falls back)."""
    rows, w = mat.shape
    if rows == 0:
        return np.zeros(0, dtype=np.float64)
    if w > 23:
        return None
    is_digit = (mat >= 48) & (mat <= 57)
    is_pad = mat == 0
    if w <= 15 and (is_digit | is_pad).all():
        # unsigned integer column: Horner over the (few) columns,
        # exact in float64 below 10^15
        m = np.zeros(rows, dtype=np.int64)
        for i in range(w):
            d = is_digit[:, i]
            m = np.where(d, m * 10 + (mat[:, i] - 48), m)
        if not is_digit[:, 0].all():
            return None  # empty fields
        return m.astype(np.float64)
    is_dot = mat == 46
    first = mat[:, 0]
    has_sign = (first == 45) | (first == 43)
    allowed = is_digit | is_dot | is_pad
    allowed[:, 0] |= has_sign
    if not allowed.all():
        return None
    ndots = is_dot.sum(axis=1)
    total = is_digit.sum(axis=1)
    if (ndots > 1).any() or (total == 0).any() or (total > 15).any():
        return None
    # digits after position i (within the row) give each digit its
    # place value in the mantissa
    cum = np.cumsum(is_digit, axis=1)
    place = total[:, None] - cum
    dig = (mat - 48) * is_digit
    mant = (dig * _POW10[place]).sum(axis=1)
    # count of digits right of the dot = mantissa scale
    dotpos = np.where(ndots > 0, is_dot.argmax(axis=1), w)
    digits_left = np.take_along_axis(
        cum, np.minimum(dotpos, w - 1)[:, None], axis=1
    ).ravel()
    digits_left = np.where(ndots > 0, digits_left, total)
    scale = total - digits_left
    out = mant / _POW10[scale]
    return np.where(first == 45, -out, out)


class _Chunk:
    """One newline-terminated slice of the stream, split columnarly."""

    def __init__(self, data: bytes, fd_byte: int):
        self.data = data
        arr = np.frombuffer(data, dtype=np.uint8)
        self.arr = arr
        # chunks are <= a few MiB: 32-bit offsets halve the memory
        # traffic of every index matrix built below
        nl = np.flatnonzero(arr == 10).astype(np.int32)
        row_start = np.empty(len(nl), dtype=np.int32)
        if len(nl):
            row_start[0] = 0
            row_start[1:] = nl[:-1] + 1
        row_end = nl.copy()
        # tolerate \r\n rows (strip the \r from every non-empty row)
        nonempty = row_end > row_start
        cr = np.zeros(len(nl), dtype=bool)
        if nonempty.any():
            cr[nonempty] = arr[row_end[nonempty] - 1] == 13
        row_end -= cr
        # drop blank rows (the csv module skips them too)
        keep = row_end > row_start
        self.row_start = row_start[keep]
        self.row_end = row_end[keep]
        self.rows = len(self.row_start)
        self.blank_dropped = self.rows != len(nl)
        self.trimmed = False  # header row dropped in place
        self._fd = fd_byte
        self._seps = None  # (rows, F-1) separator positions
        self._ncols = -1
        self._mat_cache: dict[int, np.ndarray] = {}
        self._str_cache: dict[int, np.ndarray] = {}
        self._num_cache: dict[int, "np.ndarray | None"] = {}

    def drop_first_row(self) -> None:
        """Consume the header row without re-parsing the chunk; call
        before uniform_fields (separator layout is row-relative)."""
        self.row_start = self.row_start[1:]
        self.row_end = self.row_end[1:]
        self.rows -= 1
        self.trimmed = True

    def uniform_fields(self) -> int:
        """Field count when every row has the same; -1 for ragged."""
        if self._ncols != -1:
            return self._ncols
        is_sep = self.arr == self._fd
        seps = np.flatnonzero(is_sep).astype(np.int32)
        # cumulative count beats two binary searches over the
        # separator list (O(n) sequential vs O(rows log seps))
        csum = np.cumsum(is_sep, dtype=np.int32)
        before = csum[self.row_start] - is_sep[self.row_start]
        per_row = csum[self.row_end - 1] - before
        if self.rows == 0:
            self._ncols = 0
            return 0
        first = int(per_row[0])
        if not (per_row == first).all():
            self._ncols = -2
            return -1
        self._ncols = first + 1
        if first:
            idx = before[:, None] + np.arange(
                first, dtype=np.int32
            )[None, :]
            self._seps = seps[idx]
        else:
            self._seps = np.empty((self.rows, 0), dtype=np.int32)
        return self._ncols

    def _bounds(self, j: int):
        F = self._ncols
        starts = (
            self.row_start if j == 0 else self._seps[:, j - 1] + 1
        )
        ends = self._seps[:, j] if j < F - 1 else self.row_end
        return starts, ends

    def _col_matrix(self, j: int) -> np.ndarray:
        """Column j as a (rows, W) uint8 matrix, NUL right-padded."""
        cached = self._mat_cache.get(j)
        if cached is not None:
            return cached
        starts, ends = self._bounds(j)
        widths = ends - starts
        w = int(widths.max()) if len(widths) else 1
        if w > MAX_FIELD_WIDTH:
            raise _Ineligible("oversized field")
        w = max(w, 1)
        idx = starts[:, None] + np.arange(w, dtype=np.int32)[None, :]
        valid = idx < ends[:, None]
        mat = np.where(valid, self.arr[np.where(valid, idx, 0)], 0)
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        self._mat_cache[j] = mat
        return mat

    def col_str(self, j: int) -> np.ndarray:
        """Column j as a fixed-width S array (NUL right-padded)."""
        cached = self._str_cache.get(j)
        if cached is not None:
            return cached
        mat = self._col_matrix(j)
        out = mat.view(f"S{mat.shape[1]}").ravel()
        self._str_cache[j] = out
        return out

    def col_num(self, j: int) -> "np.ndarray | None":
        """Column j parsed as float64, or None when any field fails
        to parse (mixed columns get exact row-engine semantics)."""
        if j in self._num_cache:
            return self._num_cache[j]
        mat = self._col_matrix(j)
        out = _parse_decimal_matrix(mat)
        if out is None:
            # scientific notation / long digits: numpy's (slower but
            # general) parser, still correctly rounded like float()
            try:
                out = self.col_str(j).astype(np.float64)
            except ValueError:
                out = None
        self._num_cache[j] = out
        return out

    def line(self, i: int) -> bytes:
        return self.data[self.row_start[i] : self.row_end[i]]

    def field(self, i: int, j: int) -> bytes:
        starts, ends = self._bounds(j)
        return self.data[starts[i] : ends[i]]


# ---------------------------------------------------------------------------
# WHERE compiler: AST -> (kind, value) over one chunk
#   kind 'num': float64 array or python float
#   kind 'str': S array or python bytes
#   kind 'bool': bool array (no nulls arise: columns are never null,
#                null literals are statically ineligible)
# ---------------------------------------------------------------------------


class _Cols:
    """Resolves Column names to indices for one header layout."""

    def __init__(self, header: "list[str] | None", ncols: int):
        self.ncols = ncols
        self.by_name: dict[str, int] = {}
        if header:
            for j, h in enumerate(header[:ncols]):
                self.by_name.setdefault(h, j)
                self.by_name.setdefault(h.lower(), j)

    def index(self, name: str) -> int:
        if name.startswith("_") and name[1:].isdigit():
            j = int(name[1:]) - 1
            if 0 <= j < self.ncols:
                return j
            raise _Ineligible(f"positional {name} out of range")
        j = self.by_name.get(name)
        if j is None:
            j = self.by_name.get(name.lower())
        if j is None:
            raise _Ineligible(f"unresolvable column {name}")
        return j


def _lit_value(v):
    if isinstance(v, bool):
        return ("str", sql._to_str(v).encode())
    if isinstance(v, (int, float)):
        return ("num", float(v))
    return ("str", str(v).encode())


def _eval_vec(node, chunk: _Chunk, cols: _Cols):
    if isinstance(node, sql.Literal):
        return _lit_value(node.value)
    if isinstance(node, sql.Column):
        return ("col", cols.index(node.name))
    if isinstance(node, sql.Arith):
        a = _as_num(_eval_vec(node.left, chunk, cols), chunk)
        b = _as_num(_eval_vec(node.right, chunk, cols), chunk)
        if node.op == "+":
            return ("num", a + b)
        if node.op == "-":
            return ("num", a - b)
        if node.op == "*":
            return ("num", a * b)
        if node.op == "/":
            if np.any(b == 0):
                raise SQLError("division by zero", "InvalidDataType")
            return ("num", a / b)
        if node.op == "%":
            if np.any(b == 0):
                raise SQLError("modulo by zero", "InvalidDataType")
            return ("num", np.mod(a, b))
        raise _Ineligible(node.op)
    if isinstance(node, sql.Compare):
        return (
            "bool",
            _vec_compare(
                node.op,
                _eval_vec(node.left, chunk, cols),
                _eval_vec(node.right, chunk, cols),
                chunk,
            ),
        )
    if isinstance(node, sql.Between):
        v = _eval_vec(node.expr, chunk, cols)
        lo = _vec_compare(
            ">=", v, _eval_vec(node.lo, chunk, cols), chunk
        )
        hi = _vec_compare(
            "<=", v, _eval_vec(node.hi, chunk, cols), chunk
        )
        m = lo & hi
        return ("bool", ~m if node.negate else m)
    if isinstance(node, sql.In):
        v = _eval_vec(node.expr, chunk, cols)
        m = np.zeros(chunk.rows, dtype=bool)
        for o in node.options:
            m |= _vec_compare("=", v, _eval_vec(o, chunk, cols), chunk)
        return ("bool", ~m if node.negate else m)
    if isinstance(node, sql.Like):
        j = cols.index(node.expr.name)
        vals = chunk.col_str(j)
        m = _vec_like(node, vals)
        return ("bool", ~m if node.negate else m)
    if isinstance(node, sql.IsNull):
        cols.index(node.expr.name)  # must resolve (else row engine)
        m = np.zeros(chunk.rows, dtype=bool)  # CSV fields never null
        return ("bool", ~m if node.negate else m)
    if isinstance(node, sql.Logical):
        a = _as_bool(_eval_vec(node.left, chunk, cols))
        if node.op == "not":
            return ("bool", ~a)
        b = _as_bool(_eval_vec(node.right, chunk, cols))
        return ("bool", a & b if node.op == "and" else a | b)
    raise _Ineligible(type(node).__name__)


def _vec_like(node, vals: np.ndarray) -> np.ndarray:
    """LIKE over an S column.  The four common wildcard shapes map to
    C-loop string kernels (np.char); anything else (inner '_', mixed
    wildcards, escapes) runs the compiled regex per value."""
    pat = node.pattern.value if isinstance(
        node.pattern, sql.Literal
    ) else None
    esc = node.escape
    if isinstance(pat, str) and esc is None and "_" not in pat:
        body = pat.strip("%")
        if "%" not in body and "_" not in body:
            b = body.encode()
            if pat.startswith("%") and pat.endswith("%") and len(pat) > 1:
                # NUL padding never matches real content
                return np.char.find(vals, b) >= 0
            if pat.endswith("%"):
                return np.char.startswith(vals, b)
            if pat.startswith("%"):
                # trailing NUL pad defeats np endswith: strip first
                return np.char.endswith(
                    np.char.rstrip(vals, b"\x00"), b
                )
            return vals == b
    rx = node._compiled
    return np.fromiter(
        (
            rx.match(x.decode("utf-8", "replace")) is not None
            for x in vals
        ),
        dtype=bool,
        count=len(vals),
    )


def _as_num(tv, chunk: _Chunk):
    kind, v = tv
    if kind == "num":
        return v
    if kind == "col":
        col = chunk.col_num(v)
        if col is None:
            raise _Ineligible("non-numeric column in arithmetic")
        return col
    raise _Ineligible("string operand in arithmetic")


def _as_bool(tv):
    kind, v = tv
    if kind != "bool":
        raise _Ineligible("non-boolean operand in logical")
    return v


def _vec_compare(op: str, a, b, chunk: _Chunk) -> np.ndarray:
    """Mirror sql._compare: numeric compare when both sides coerce
    and they are not both strings; else bytewise string compare."""
    ka, va = a
    kb, vb = b
    # column vs column: CSV fields are strings -> string compare
    if ka == "col" and kb == "col":
        va, vb = chunk.col_str(va), chunk.col_str(vb)
    elif ka == "col":
        if kb == "num":
            col = chunk.col_num(va)
            if col is None:
                # mixed column: per-row semantics flip between numeric
                # and string compare - row engine territory
                raise _Ineligible("mixed column vs numeric literal")
            va = col
        else:
            va = chunk.col_str(va)
    elif kb == "col":
        if ka == "num":
            col = chunk.col_num(vb)
            if col is None:
                raise _Ineligible("numeric literal vs mixed column")
            vb = col
        else:
            vb = chunk.col_str(vb)
    elif ka != kb:
        # literal num vs literal str: the row engine coerces; rare
        raise _Ineligible("cross-type literal compare")
    if op == "=":
        return va == vb
    if op in ("!=", "<>"):
        return va != vb
    if op == "<":
        return va < vb
    if op == "<=":
        return va <= vb
    if op == ">":
        return va > vb
    if op == ">=":
        return va >= vb
    raise _Ineligible(op)


# ---------------------------------------------------------------------------
# the scan driver
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# JSON-lines fast scan (aggregate/filter queries over flat objects)
# ---------------------------------------------------------------------------


def json_eligible(stmt, req) -> bool:
    """The JSON twin of :func:`eligible`, restricted to fully
    aggregate statements (no record output to serialize): the
    reference leans on simdjson here (pkg/s3select/simdj); the numpy
    equivalent extracts referenced scalar fields with one compiled
    regex pass per column and runs the same mask algebra."""
    if req.input_format != "JSON":
        return False
    if req.json_args.json_type != "LINES":
        return False
    if not stmt.is_aggregate:
        return False
    for agg in stmt.aggregates:
        if agg.arg is not None and not isinstance(agg.arg, sql.Column):
            return False
    return _supported_where(stmt.where)


class _JChunk:
    """Column provider over one chunk of flat JSON lines.  Extraction
    is regex-per-column over the raw bytes; any ambiguity (nesting,
    escapes, missing keys, null/bool tokens under numeric use) raises
    _Ineligible so the chunk re-runs on the row engine."""

    _NUM_RX: dict = {}
    _STR_RX: dict = {}

    def __init__(self, data: bytes, nlines: int):
        self.data = data
        self.rows = nlines
        self._num_cache: dict = {}
        self._str_cache: dict = {}
        self._kind: dict = {}  # name -> 'num' | 'str'

    def _extract(self, name: str):
        if name in self._kind:
            return
        key = re.escape(name.encode())
        nrx = _JChunk._NUM_RX.get(name)
        if nrx is None:
            nrx = re.compile(
                rb'"' + key + rb'"\s*:\s*(-?[0-9][^,}\s]*)'
            )
            srx = re.compile(rb'"' + key + rb'"\s*:\s*"([^"]*)"')
            _JChunk._NUM_RX[name] = nrx
            _JChunk._STR_RX[name] = srx
        srx = _JChunk._STR_RX[name]
        vals = nrx.findall(self.data)
        if len(vals) == self.rows:
            try:
                self._num_cache[name] = np.asarray(
                    vals, dtype="S"
                ).astype(np.float64)
                self._kind[name] = "num"
                return
            except ValueError:
                raise _Ineligible(f"non-numeric token for {name}")
        svals = srx.findall(self.data)
        if len(svals) == self.rows:
            self._str_cache[name] = np.asarray(svals, dtype="S")
            self._kind[name] = "str"
            return
        raise _Ineligible(f"irregular key {name}")

    def col_num(self, name: str):
        self._extract(name)
        if self._kind[name] == "num":
            return self._num_cache[name]
        # string-typed field under numeric use: same as CSV columns
        try:
            return self._str_cache[name].astype(np.float64)
        except ValueError:
            return None

    def col_str(self, name: str):
        self._extract(name)
        if self._kind[name] == "str":
            return self._str_cache[name]
        # a native JSON number compared as a string cannot reproduce
        # the row engine's numeric-coercion semantics cheaply
        raise _Ineligible(f"numeric field {name} in string context")


class _JCols:
    """Column resolver for JSON rows: names resolve to themselves;
    existence is validated at extraction time."""

    def index(self, name: str) -> str:
        if name.startswith("_") and name[1:].isdigit():
            raise _Ineligible("positional ref over JSON")
        return name


class FastJSONScan:
    """Aggregate-only scan over flat JSON lines."""

    def __init__(self, stmt, req):
        self.stmt = stmt
        self.req = req

    def run(self, stream) -> None:
        carry = b""
        while True:
            buf = stream.read(CHUNK)
            if not buf:
                break
            data = carry + buf
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            carry = data[cut + 1 :]
            self._chunk(data[: cut + 1])
        if carry:
            self._chunk(carry + b"\n")

    def _chunk(self, data: bytes) -> None:
        # structural guards: one flat object per line, no escapes, no
        # arrays, no nested objects, no strings containing braces
        nonblank = sum(
            1 for ln in data.splitlines() if ln and not ln.isspace()
        )
        if nonblank == 0:
            return
        if (
            b"\\" in data
            or b"[" in data
            or data.count(b"{") != nonblank
            or data.count(b"}") != nonblank
        ):
            self._slow_chunk(data)
            return
        chunk = _JChunk(data, nonblank)
        cols = _JCols()
        try:
            if self.stmt.where is None:
                mask = np.ones(chunk.rows, dtype=bool)
            else:
                mask = _as_bool(_eval_vec(self.stmt.where, chunk, cols))
                if np.ndim(mask) == 0:
                    mask = np.full(chunk.rows, bool(mask))
            self._accumulate(chunk, cols, mask)
        except _Ineligible:
            self._slow_chunk(data)

    def _accumulate(self, chunk: _JChunk, cols, mask) -> None:
        def exists(name):
            chunk._extract(cols.index(name))
            return True

        _vec_accumulate(
            self.stmt.aggregates,
            mask,
            lambda name: chunk.col_num(cols.index(name)),
            exists,
        )

    def _slow_chunk(self, data: bytes) -> None:
        from . import jsonio

        for row in jsonio.read_records(
            io.BytesIO(data), self.req.json_args
        ):
            if self.stmt.matches(row):
                self.stmt.accumulate(row)


def _vec_accumulate(aggregates, mask, col_num, col_exists) -> None:
    """Shared aggregate accumulator (CSV + JSON fast scans).

    Two-phase so a fallback replay never double-counts: every column
    is resolved and validated BEFORE any aggregate state mutates.
    SUM/AVG fold sequentially from the existing accumulator (numpy
    cumsum is a strict left fold) so results are bit-identical to the
    row engine's value-by-value float additions, independent of chunk
    boundaries."""
    nsel = int(mask.sum())
    plan = []
    for agg in aggregates:
        if agg.func == "count":
            if agg.arg is not None and not col_exists(agg.arg.name):
                raise _Ineligible("unresolvable COUNT column")
            plan.append((agg, None))
            continue
        col = col_num(agg.arg.name)
        if col is None:
            raise _Ineligible("aggregate over non-numeric column")
        vals = col[mask]
        if np.isnan(vals).any():
            # nan ordering in min/max diverges from the row engine
            raise _Ineligible("nan in aggregate column")
        plan.append((agg, vals))
    for agg, vals in plan:
        if agg.func == "count":
            # fields extracted here are never null, so COUNT(col)
            # counts every matched row, like COUNT(*)
            agg.count += nsel
            continue
        if nsel == 0:
            continue
        agg.count += nsel
        if agg.func in ("sum", "avg"):
            base = 0.0 if agg.acc is None else agg.acc
            agg.acc = float(
                np.cumsum(np.concatenate(([base], vals)))[-1]
            )
        elif agg.func == "min":
            v = float(vals.min())
            agg.acc = v if agg.acc is None else min(agg.acc, v)
        elif agg.func == "max":
            v = float(vals.max())
            agg.acc = v if agg.acc is None else max(agg.acc, v)


def _gather(arr: np.ndarray, starts, ends) -> np.ndarray:
    """Variable-width byte ranges -> (rows, Wmax) NUL-padded matrix."""
    widths = ends - starts
    w = max(int(widths.max()) if len(widths) else 1, 1)
    idx = starts[:, None] + np.arange(w)[None, :]
    valid = idx < ends[:, None]
    return np.ascontiguousarray(
        np.where(valid, arr[np.where(valid, idx, 0)], 0),
        dtype=np.uint8,
    )


def _matrix_payload(
    mats: "list[np.ndarray]", fd: bytes, rd: bytes, qc: bytes = b""
) -> bytes:
    """Serialize NUL-padded column matrices to delimited records in
    one pass: interleave constant delimiter/quote columns, flatten,
    and strip the padding NULs with bytes.translate (C speed).  Valid
    because field content never contains NUL (guarded upstream)."""
    rows = mats[0].shape[0]

    def const_col(b: bytes) -> np.ndarray:
        return np.tile(
            np.frombuffer(b, dtype=np.uint8), (rows, 1)
        )

    parts = []
    for i, m in enumerate(mats):
        if i:
            parts.append(const_col(fd))
        if qc:
            parts.append(const_col(qc))
            parts.append(m)
            parts.append(const_col(qc))
        else:
            parts.append(m)
    parts.append(const_col(rd))
    return np.hstack(parts).tobytes().translate(None, b"\x00")


class FastScan:
    """Drives one statement over one CSV byte stream, vectorized with
    exact row-engine fallback at chunk granularity."""

    def __init__(self, stmt, req, writer, clean, emit):
        self.stmt = stmt
        self.req = req
        self.writer = writer
        self.clean = clean
        self.emit = emit  # receives serialized record payload bytes
        a = req.csv_args
        self.fd_byte = ord(a.field_delimiter)
        self.qc_byte = ord(a.quote_character)
        self.qc = a.quote_character
        self.header: "list[str] | None" = None
        self.header_pending = a.file_header_info in ("USE", "IGNORE")
        self.matched = 0
        self.done = False
        # raw-line emit is valid when the output is CSV with the same
        # field delimiter and default ASNEEDED quoting (quote-free
        # chunks can never need quoting)
        w = req.csv_writer_args or {}
        self.raw_ok = (
            req.output_format == "CSV"
            and stmt.projections is None
            and not stmt.is_aggregate
            and (w.get("field_delimiter", ",") == a.field_delimiter)
            and (w.get("quote_fields", "ASNEEDED") == "ASNEEDED")
        )
        self.out_rd = (
            (w.get("record_delimiter") or "\n").encode()
            if req.output_format == "CSV"
            else b""
        )

    # -- stream pump ---------------------------------------------------

    def run(self, stream) -> int:
        a = self.req.csv_args
        esc_mode = a.quote_escape_character != a.quote_character
        esc_byte = ord(a.quote_escape_character)
        carry = b""
        size = getattr(self, "read_size", CHUNK)
        while not self.done:
            buf = stream.read(size)
            if not buf:
                break
            data = carry + buf
            if esc_mode and (
                self.qc_byte in data or esc_byte in data
            ):
                # escaped-quote grammar defeats the parity cut below:
                # hand the rest of the stream to the row engine
                self._slow_stream(data, stream)
                return self.matched
            cut = self._safe_cut(data)
            if cut < 0:
                if len(data) > 4 * size:
                    # a stray unbalanced quote would otherwise buffer
                    # the whole remaining object into carry
                    self._slow_stream(data, stream)
                    return self.matched
                carry = data
                continue
            carry = data[cut + 1 :]
            self._chunk(data[: cut + 1])
        if carry and not self.done:
            self._chunk(carry + b"\n")
        return self.matched

    def _safe_cut(self, data: bytes) -> int:
        """Last newline NOT inside a quoted field: with doubled-quote
        escaping, a newline is a record boundary iff the quote count
        to its left is even."""
        if self.qc_byte not in data:
            return data.rfind(b"\n")
        arr = np.frombuffer(data, dtype=np.uint8)
        nl = np.flatnonzero(arr == 10)
        if len(nl) == 0:
            return -1
        qpos = np.flatnonzero(arr == self.qc_byte)
        even = np.searchsorted(qpos, nl) % 2 == 0
        good = nl[even]
        return int(good[-1]) if len(good) else -1

    # -- per-chunk -----------------------------------------------------

    def _chunk(self, data: bytes) -> None:
        if self.qc_byte in data or 0 in data:
            # quoted grammar or embedded NULs (NUL is the padding
            # sentinel of the columnar matrices): exact row engine
            self._slow_chunk(data)
            return
        chunk = _Chunk(data, self.fd_byte)
        if chunk.blank_dropped:
            # the csv module yields [] for a blank line (an empty
            # record under SELECT *), which the columnar splitter
            # cannot represent - row engine for this chunk
            self._slow_chunk(data)
            return
        cr = np.flatnonzero(chunk.arr == 13)
        if len(cr) and (
            cr[-1] == len(data) - 1
            or not (chunk.arr[cr + 1] == 10).all()
        ):
            # a bare \r is a record boundary to the csv module but
            # field content to the splitter; only \r\n is fast
            self._slow_chunk(data)
            return
        if chunk.rows == 0:
            return
        # after the header row is consumed here, any fallback must
        # replay only the remaining rows, not the header line
        fallback = data
        if self.header_pending:
            if self.req.csv_args.file_header_info == "USE":
                self.header = [
                    f.decode("utf-8", "replace").strip()
                    for f in chunk.line(0).split(
                        self.req.csv_args.field_delimiter.encode()
                    )
                ]
            self.header_pending = False
            chunk.drop_first_row()
            if chunk.rows == 0:
                return
            fallback = data[chunk.row_start[0] :]
        F = chunk.uniform_fields()
        if F < 0:
            self._slow_chunk(fallback)
            return
        cols = _Cols(self.header, F)
        try:
            self._fast_rows(chunk, cols)
        except _Ineligible:
            self._slow_chunk(fallback)

    def _fast_rows(self, chunk: _Chunk, cols: _Cols) -> None:
        stmt = self.stmt
        if stmt.where is None:
            mask = np.ones(chunk.rows, dtype=bool)
        else:
            mask = _as_bool(_eval_vec(stmt.where, chunk, cols))
            if np.ndim(mask) == 0:  # literal-only predicate
                mask = np.full(chunk.rows, bool(mask))
        if stmt.is_aggregate:
            self._accumulate(chunk, cols, mask)
            return
        sel = np.flatnonzero(mask)
        limit_hit = False
        if stmt.limit is not None:
            room = stmt.limit - self.matched
            if len(sel) >= room:
                sel = sel[:room]
                limit_hit = True
        if len(sel) == 0:
            self.done = self.done or limit_hit
            return
        # NOTE every _Ineligible in the emit paths below fires before
        # the first emit() - so a fallback replay of this chunk never
        # double-emits, and matched/done only advance on success
        F = cols.ncols
        oqc = self._out_qc()
        if (
            self.raw_ok
            and self._star_is_whole_line(F)
            and (oqc == self.qc_byte or oqc not in chunk.data)
        ):
            if (
                len(sel) == chunk.rows
                and self.out_rd == b"\n"
                and not chunk.trimmed
                and not (chunk.arr[chunk.row_end] != 10).any()
            ):
                # everything matched, rows already \n-terminated:
                # the chunk IS the payload
                self.emit(chunk.data)
            else:
                self.emit(
                    _matrix_payload(
                        [
                            _gather(
                                chunk.arr,
                                chunk.row_start[sel],
                                chunk.row_end[sel],
                            )
                        ],
                        b"",
                        self.out_rd,
                    )
                )
        else:
            # projected columns / JSON output: records per matched row
            self._emit_records(chunk, cols, sel)
        self.matched += len(sel)
        self.done = self.done or limit_hit

    def _out_qc(self) -> int:
        w = self.req.csv_writer_args or {}
        qc = w.get("quote_character") or '"'
        return ord(qc) if len(qc) == 1 else -1

    def _star_is_whole_line(self, ncols: int) -> bool:
        """SELECT * equals the raw line only when the cleaned row keeps
        every field once, in order (no short or duplicate header)."""
        if self.header is None:
            return True
        return len(self.header) >= ncols and len(
            set(self.header)
        ) == len(self.header)

    def _emit_records(self, chunk: _Chunk, cols: _Cols, sel) -> None:
        stmt = self.stmt
        w = self.req.csv_writer_args or {}
        if self.req.output_format == "CSV":
            ofd = (w.get("field_delimiter") or ",").encode()
            ord_ = (w.get("record_delimiter") or "\n").encode()
            oqc = (w.get("quote_character") or '"').encode()
            always = (
                w.get("quote_fields", "ASNEEDED").upper() == "ALWAYS"
            )
            # field content is free of the INPUT delimiter/quote by
            # construction; a different OUTPUT delimiter/quote may
            # appear inside fields and would then need quoting that
            # the matrix serializer skips - guard on chunk content
            if (
                len(ofd) == 1
                and len(oqc) == 1
                and (
                    ofd[0] == self.fd_byte or ofd[0] not in chunk.data
                )
                and (
                    oqc[0] == self.qc_byte or oqc[0] not in chunk.data
                )
            ):
                js = self._out_columns(cols)
                if js is not None:
                    mats = [chunk._col_matrix(j)[sel] for j in js]
                    self.emit(
                        _matrix_payload(
                            mats, ofd, ord_, oqc if always else b""
                        )
                    )
                    return
        out = bytearray()
        if stmt.projections is None:
            fd = self.req.csv_args.field_delimiter.encode()
            for i in sel:
                fields = [
                    f.decode("utf-8", "replace")
                    for f in chunk.line(int(i)).split(fd)
                ]
                row: dict = {}
                for j, v in enumerate(fields):
                    row[f"_{j + 1}"] = v
                    if self.header and j < len(self.header):
                        row[self.header[j]] = v
                out += self.writer.serialize(self.clean(row))
        else:
            idxs = [
                (p.alias or f"_{k + 1}", cols.index(p.expr.name))
                for k, p in enumerate(stmt.projections)
            ]
            for i in sel:
                rec = {
                    alias: chunk.field(int(i), j).decode(
                        "utf-8", "replace"
                    )
                    for alias, j in idxs
                }
                out += self.writer.serialize(rec)
        self.emit(bytes(out))

    def _out_columns(self, cols: _Cols) -> "list[int] | None":
        """Output column indices for the vectorized CSV serializer, or
        None when the record shape needs the dict path."""
        stmt = self.stmt
        if stmt.projections is not None:
            try:
                return [
                    cols.index(p.expr.name) for p in stmt.projections
                ]
            except _Ineligible:
                return None
        # SELECT *: the cleaned row is the named fields in file order
        if self.header is None:
            return list(range(cols.ncols))
        if len(set(self.header)) != len(self.header):
            return None  # duplicate names collapse in the dict path
        return list(range(min(cols.ncols, len(self.header))))

    def _accumulate(self, chunk: _Chunk, cols: _Cols, mask) -> None:
        _vec_accumulate(
            self.stmt.aggregates,
            mask,
            lambda name: chunk.col_num(cols.index(name)),
            lambda name: cols.index(name) is not None,
        )

    # -- exact fallback (chunk granularity) ----------------------------

    def _slow_chunk(self, data: bytes) -> None:
        """Run one chunk through the row engine: exact semantics for
        quoted/ragged/mixed shapes.  The chunk boundary is safe for
        quoted newlines because _safe_cut only cuts at even quote
        parity; quote-free chunks before and after stay fast."""
        self._slow_rows(
            io.TextIOWrapper(
                io.BytesIO(data), encoding="utf-8", newline=""
            )
        )

    def _slow_stream(self, head: bytes, stream) -> None:
        """Row-engine the rest of the stream (escape-char grammar)."""

        class _Chain(io.RawIOBase):
            def __init__(self):
                self._head = memoryview(head)
                self._off = 0

            def readable(self):
                return True

            def readinto(self, b):
                if self._off < len(self._head):
                    n = min(len(b), len(self._head) - self._off)
                    b[:n] = self._head[self._off : self._off + n]
                    self._off += n
                    return n
                part = stream.read(len(b))
                if not part:
                    return 0
                b[: len(part)] = part
                return len(part)

        self._slow_rows(
            io.TextIOWrapper(
                io.BufferedReader(_Chain()),
                encoding="utf-8",
                newline="",
            )
        )

    def _slow_rows(self, text) -> None:
        a = self.req.csv_args
        opts = {
            "delimiter": a.field_delimiter,
            "quotechar": a.quote_character,
        }
        if a.quote_escape_character != a.quote_character:
            opts["doublequote"] = False
            opts["escapechar"] = a.quote_escape_character
        stmt = self.stmt
        for rec in csv.reader(text, **opts):
            if self.done:
                return
            if self.header_pending:
                if a.file_header_info == "USE":
                    self.header = [h.strip() for h in rec]
                self.header_pending = False
                continue
            row: dict = {}
            for j, v in enumerate(rec):
                row[f"_{j + 1}"] = v
                if self.header and j < len(self.header):
                    row[self.header[j]] = v
            if not stmt.matches(row):
                continue
            if stmt.is_aggregate:
                stmt.accumulate(row)
                continue
            out = stmt.project(row)
            if stmt.projections is None:
                out = self.clean(out)
            self.emit(self.writer.serialize(out))
            self.matched += 1
            if stmt.limit is not None and self.matched >= stmt.limit:
                self.done = True
