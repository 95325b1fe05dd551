"""Device pushdown for S3 Select: the device-side scan/filter as a
pre-filter.

The device engine never decides a match.  One fused SWAR pass
(ops/select_step.py, K8 on the card) runs a CONSERVATIVE candidate
screen compiled from the WHERE tree - it may flag rows that do not
match, never the reverse - and only the candidate row slices cross D2H
through the drain seam.  The candidate bytes are then re-fed to the
proven host engines (``vector.FastScan._chunk``, with its own
row-engine fallback), so exactness, projections, aggregates, LIMIT, and
every output-serialization rule are inherited rather than
re-implemented: the device's contribution is pure, result-proportional
filtering.

Fallback ladder (exactness-over-speed, mirroring vector.py); each step
is the statement's semantics, counted in ``STATS``, never a way round a
failed kernel:

* unsupported WHERE shape / unresolvable column -> host engine for
  the whole stream (``screen=None``);
* hazard chunk (quote, bare CR, NUL, digit-e exponent under any
  numeric screen), candidate ratio above the
  screen-usefulness cap, candidate overflow, or a row wider than the
  widest window -> host engine for that chunk;
* anything the host fast path then dislikes -> its row engine, as
  always.

The scan runs on the device it is given (the object layer's codec
device), or on the least-loaded submesh of that device's slots
(``_scan_router``: every visible CUDA device, as the codec backend's);
device buffers cross D2H only inside the ``_drain_*`` seam functions
below.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from . import sql, vector
from ..ops import select_step as ss
from ..parallel.rules import PlacementRouter

DEV_CHUNK = 32 << 20  # stream read size: amortize the fixed per-chunk cost
_RATIO_CAP = 0.25  # screen candidates / rows above this: host chunk
_MIN_RATIO_ROWS = 4096  # don't ratio-fallback tiny chunks
_MAX_CANDS = 1 << 20
_ROW_WINDOWS = (256, 1024, 4096)  # forward row-span ladder
_BACK_WINDOW = 1024  # backward anchor scan for mid-row field hits
# Longest literal integer-part the len/nd/deep atoms enumerate; a
# wider literal raises _Unscreenable (host engine) so query input
# cannot grow the screen without bound - this bounds _max_shift and
# the per-statement program.
_LEN_CAP = 30


class SelectStats:
    """Thread-safe counters behind miniotpu_select_* (server/metrics),
    and the screen's own totals (``screened``: chunks screened, their
    rows and their candidates), which no metric reads."""

    ENGINES = ("device", "host", "row")
    REASONS = (
        "unsupported", "hazard", "ratio", "overflow", "wide", "error",
    )

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self):
        with getattr(self, "_mu", threading.Lock()):
            self.requests = {e: 0 for e in self.ENGINES}
            self.fallbacks = {r: 0 for r in self.REASONS}
            self.scanned_bytes = 0
            self.returned_bytes = 0
            self.device_seconds = 0.0
            self.screened = {"chunks": 0, "rows": 0, "candidates": 0}

    def request(self, engine: str) -> None:
        with self._mu:
            self.requests[engine] = self.requests.get(engine, 0) + 1

    def fallback(self, reason: str) -> None:
        with self._mu:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def io(self, scanned: int, returned: int) -> None:
        with self._mu:
            self.scanned_bytes += scanned
            self.returned_bytes += returned

    def device_time(self, seconds: float) -> None:
        with self._mu:
            self.device_seconds += seconds

    def screen(self, rows: int, candidates: int) -> None:
        with self._mu:
            self.screened["chunks"] += 1
            self.screened["rows"] += rows
            self.screened["candidates"] += candidates

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "requests": dict(self.requests),
                "fallbacks": dict(self.fallbacks),
                "scanned_bytes": self.scanned_bytes,
                "returned_bytes": self.returned_bytes,
                "device_seconds": self.device_seconds,
                "screened": dict(self.screened),
            }


STATS = SelectStats()


def select_mode() -> str:
    """MINIO_TPU_SELECT: device | host | row | auto (default).

    ``row`` is the bisection oracle - the per-row engine, byte-for-byte
    the pre-device behavior; ``host`` pins the numpy columnar scan."""
    mode = os.environ.get("MINIO_TPU_SELECT", "auto").strip().lower()
    return mode if mode in ("device", "host", "row", "auto") else "auto"


# -- placement: scans ride the least-loaded submesh --------------------

_routers: "dict[str, PlacementRouter]" = {}
_router_mu = threading.Lock()


def scan_devices(device) -> tuple:
    """The slots a scan on ``device`` may take: every visible CUDA
    device, ``device`` first (the codec backend's set, codec/backend.py
    get_backend), or the CPU alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,)
    home = dev.index or 0
    return (torch.device("cuda", home),) + tuple(
        torch.device("cuda", i)
        for i in range(torch.cuda.device_count()) if i != home
    )


def _scan_router(device) -> PlacementRouter:
    """The process's router over ``device``'s scan slots.  With one slot
    there is one submesh and ``route`` returns None: the scan stays on
    ``device``."""
    key = str(torch.device(device))
    with _router_mu:
        router = _routers.get(key)
        if router is None:
            router = PlacementRouter(scan_devices(device))
            _routers[key] = router
        return router


# -- screen compilation ------------------------------------------------


class _Unscreenable(Exception):
    pass


def _lit_bytes(value) -> bytes:
    if isinstance(value, bool):
        raise _Unscreenable("bool literal")
    if isinstance(value, (int, float)):
        return sql._to_str(value).encode("utf-8", "replace")
    if isinstance(value, str):
        return value.encode("utf-8", "replace")
    raise _Unscreenable(f"literal {type(value).__name__}")


def _numeric_atoms(op: str, lit) -> tuple:
    """OR-branches for a numeric compare: the numeric coercion branch
    (length window + nonconforming first bytes) unioned with the exact
    lexicographic screen of the string-compare branch sql._compare
    takes when a field fails to coerce."""
    s = _lit_bytes(lit)
    digits = len(s.lstrip(b"+-").split(b".")[0])
    if digits > _LEN_CAP:
        raise _Unscreenable(f"literal width {digits} > {_LEN_CAP}")
    nonconf = ("byte0", 43, 48)  # '+' ',' '-' '.' '/' '0' first byte
    if op in ("<", "<="):
        return (
            (("len", 0, digits),),
            (("nd", digits + 2),),
            (nonconf,),
            (("lex", s, "le" if op == "<=" else "lt"),),
        )
    if op in (">", ">="):
        # deep(digits) == len(digits, inf): any field at least as long
        # as the literal's integer part may exceed it
        return (
            (("deep", digits),),
            (nonconf,),
            (("lex", s, "ge" if op == ">=" else "gt"),),
        )
    if op == "=":
        return (
            (("lex", s, "eq"),),
            (nonconf,),
            (("nd", digits + 2),),
        )
    raise _Unscreenable(f"numeric op {op}")


def _string_atoms(op: str, lit: str) -> tuple:
    s = _lit_bytes(lit)
    modes = {"<": "lt", "<=": "le", "=": "eq", ">=": "ge", ">": "gt"}
    if op not in modes:
        raise _Unscreenable(f"string op {op}")
    return ((("lex", s, modes[op]),),)


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}


class _Screen:
    __slots__ = ("atoms", "anchor", "sci_guard")

    def __init__(self, atoms, anchor, sci_guard=False):
        self.atoms = atoms
        self.anchor = anchor
        self.sci_guard = sci_guard


def _column_index(node, header) -> int:
    """0-based field index of a Column node; positional ``_N`` always
    resolves, named columns need the (lowercased) header row."""
    name = node.name
    if name.startswith("_") and name[1:].isdigit():
        n = int(name[1:])
        if n < 1:
            raise _Unscreenable(f"column {name}")
        return n - 1
    if header is None:
        raise _Unscreenable("named column without header")
    try:
        return header.index(name.lower())
    except ValueError:
        raise _Unscreenable(f"unknown column {name}") from None


def _compare_screen(node, header) -> _Screen:
    left, right = node.left, node.right
    op = node.op
    if isinstance(right, sql.Column) and isinstance(left, sql.Literal):
        left, right = right, left
        op = _FLIP.get(op) or _unscreen(f"op {node.op}")
    if not (
        isinstance(left, sql.Column) and isinstance(right, sql.Literal)
    ):
        raise _Unscreenable("compare shape")
    j = _column_index(left, header)
    val = right.value
    if isinstance(val, bool) or val is None:
        raise _Unscreenable("literal kind")
    sci = False
    if isinstance(val, (int, float)):
        atoms = _numeric_atoms(op, val)
        # any numeric compare can be matched by a digit-prefixed
        # exponent field no shape atom bounds ("1e6" > 99999 without
        # tripping deep/byte0/lex); the kernel's sci hazard covers
        # that gap for every op
        sci = True
    elif isinstance(val, str):
        atoms = _string_atoms(op, val)
    else:
        raise _Unscreenable("literal kind")
    return _Screen(atoms, "row" if j == 0 else "field", sci)


def _unscreen(msg):
    raise _Unscreenable(msg)


def compile_screen(node, header=None) -> _Screen:
    """WHERE tree -> conservative screen; raises _Unscreenable."""
    if isinstance(node, sql.Compare):
        return _compare_screen(node, header)
    if isinstance(node, sql.Between) and not node.negate:
        hi = sql.Compare("<=", node.expr, node.hi)
        return _compare_screen(hi, header)
    if isinstance(node, sql.In) and not node.negate:
        branches = []
        anchor = "row"
        for opt in node.options:
            scr = _compare_screen(
                sql.Compare("=", node.expr, opt), header
            )
            branches.extend(scr.atoms)
            if scr.anchor == "field":
                anchor = "field"
        return _Screen(tuple(branches), anchor, True)
    if isinstance(node, sql.Logical):
        if node.op == "and":
            err = None
            for term in (node.left, node.right):
                try:
                    return compile_screen(term, header)
                except _Unscreenable as e:
                    err = e
            raise err
        if node.op == "or" and node.right is not None:
            a = compile_screen(node.left, header)
            b = compile_screen(node.right, header)
            anchor = (
                "row"
                if a.anchor == b.anchor == "row"
                else "field"
            )
            return _Screen(
                a.atoms + b.atoms, anchor,
                a.sci_guard or b.sci_guard,
            )
    raise _Unscreenable(type(node).__name__)


def device_eligible(stmt, req) -> bool:
    """Static gate: the host fast path must be eligible (it is the
    exactness layer), there must be a WHERE to screen on, and the
    screen must compile - possibly deferred when it needs the header
    row (DeviceScan retries with the header, then pins host)."""
    if not vector.eligible(stmt, req):
        return False
    if stmt.where is None:
        return False
    try:
        compile_screen(stmt.where, None)
    except _Unscreenable:
        if req.csv_args.file_header_info != "USE":
            return False
    return True


# -- drain seam: the only D2H crossings in this module -----------------


def _drain_scalars(*vals):
    """One D2H copy for several 0-dim tensors -> Python ints."""
    both = torch.stack([v.reshape(()).to(torch.int64) for v in vals])
    return tuple(both.tolist())


def _drain_array(dev):
    return dev.cpu().numpy()


def _drain_fallback_chunk(dev_arr, nbytes: int) -> bytes:
    """Whole-chunk readback, used only when a device-ineligible chunk
    arrived device-resident (cache-tier source) and must fall back to
    the host engines."""
    return _drain_array(dev_arr[:nbytes]).tobytes()


def drain_plane(dev_arr, nbytes: int) -> bytes:
    """Full readback of a cache-tier byte plane for queries the device
    engine cannot take (no WHERE, JSON output of a row scan, mode
    pins) - the engine layer wraps this in a BytesIO and runs the host
    path it would have run over a spooled object."""
    return _drain_fallback_chunk(dev_arr, nbytes)


def host_plane(data: bytes, device) -> torch.Tensor:
    """``data`` padded with PAD_BYTE to a BLOCK_BYTES multiple, as a
    uint8 plane on ``device``."""
    pad = (-len(data)) % ss.BLOCK_BYTES
    buf = bytearray(data)
    buf += bytes([ss.PAD_BYTE]) * pad
    return torch.frombuffer(buf, dtype=torch.uint8).to(device)


# -- the scan ----------------------------------------------------------


class DeviceScan(vector.FastScan):
    """FastScan whose chunks are pre-filtered on ``device``.

    ``_chunk`` screens the chunk's word planes on the device, drains
    the candidate row spans, and hands ONLY those rows (plus the
    chunk's first row, which has no preceding anchor and covers the
    pending header) to the parent's exact machinery."""

    read_size = DEV_CHUNK

    def __init__(self, stmt, req, writer, clean, sink, device="cuda"):
        super().__init__(stmt, req, writer, clean, sink)
        self.device = torch.device(device)
        self._screen = None
        self._screen_failed = False
        self._header_seen = False
        try:
            self._screen = compile_screen(stmt.where, None)
        except _Unscreenable:
            pass  # retry once the header row is known

    # -- screen lifecycle ----------------------------------------------

    def _ensure_screen(self, data: bytes):
        if self._screen is not None or self._screen_failed:
            return self._screen
        a = self.req.csv_args
        if a.file_header_info != "USE" or self._header_seen:
            self._screen_failed = True
            STATS.fallback("unsupported")
            return None
        self._header_seen = True
        line = data.split(b"\n", 1)[0].rstrip(b"\r")
        header = [
            c.strip().strip(a.quote_character).lower()
            for c in line.decode("utf-8", "replace").split(
                a.field_delimiter
            )
        ]
        try:
            self._screen = compile_screen(self.stmt.where, header)
        except _Unscreenable:
            self._screen_failed = True
            STATS.fallback("unsupported")
        return self._screen

    # -- per-chunk device filter ---------------------------------------

    def _chunk(self, data: bytes) -> None:
        scr = self._ensure_screen(data)
        if scr is None:
            return super()._chunk(data)
        filtered = self._filter_host_bytes(data, scr)
        if filtered is None:
            return super()._chunk(data)
        if filtered:
            super()._chunk(filtered)

    def _filter_host_bytes(self, data: bytes, scr):
        """Screen host bytes on the device -> candidate-row bytes, or
        None for a whole-chunk host fallback."""
        t0 = time.perf_counter()
        router = _scan_router(self.device)
        sub = router.route(1)
        try:
            arr = host_plane(
                data, sub.devices[0] if sub is not None else self.device
            )
            spans = self._screen_spans(arr, len(data), scr)
            if spans is None:
                return None
            starts, ends = spans
            out = bytearray()
            for s, e in zip(starts.tolist(), ends.tolist()):
                out += data[s:e]
            return bytes(out)
        finally:
            if sub is not None:
                router.release(sub)
            STATS.device_time(time.perf_counter() - t0)

    def _screen_spans(self, arr, nbytes: int, scr):
        """Shared device phase: (starts, ends) numpy row spans of the
        candidate rows (newline included), or None -> chunk fallback."""
        cand, blk, nrows_d, haz_d = ss.screen_chunk(
            arr,
            fd=self.fd_byte,
            qc=self.qc_byte,
            atoms=scr.atoms,
            anchor=scr.anchor,
            sci_guard=scr.sci_guard,
        )
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        haz, nrows, count = _drain_scalars(haz_d, nrows_d, cum[-1])
        STATS.screen(nrows, count)
        if haz:
            STATS.fallback("hazard")
            return None
        if count > _MAX_CANDS:
            STATS.fallback("overflow")
            return None
        anchors = np.empty(0, dtype=np.int64)
        if count:
            if (
                nrows >= _MIN_RATIO_ROWS
                and count > nrows * _RATIO_CAP
            ):
                STATS.fallback("ratio")
                return None
            cap = 1 << max(6, (count - 1).bit_length())
            pos_d = ss.extract_positions(cand, cum, cap=cap)
            if scr.anchor == "field":
                anch_d, found_d = ss.anchors_back(
                    arr, pos_d, window=_BACK_WINDOW
                )
                anch = _drain_array(anch_d)[:count]
                found = _drain_array(found_d)[:count]
                if not found.all():
                    STATS.fallback("wide")
                    return None
                anchors = anch
            else:
                anchors = _drain_array(pos_d)[:count]
        # the chunk's first row always rides along: it has no
        # preceding-newline anchor, and it is the pending header row
        anchors = np.unique(np.concatenate([[-1], anchors]))
        anchors = anchors[anchors + 1 < nbytes]
        if not len(anchors):
            return np.empty(0, np.int64), np.empty(0, np.int64)
        starts = anchors + 1
        lens = None
        anchors_d = torch.from_numpy(anchors.astype(np.int32)).to(arr.device)
        for window in _ROW_WINDOWS:
            lens_d, found_d = ss.row_spans(arr, anchors_d, window=window)
            found = _drain_array(found_d)
            if found.all():
                lens = _drain_array(lens_d)
                break
        if lens is None:
            STATS.fallback("wide")
            return None
        return starts, starts + lens + 1  # keep the newline

    # -- device-resident source (cache-tier scans) ---------------------

    def run_device(self, dev_arr, nbytes: int) -> int:
        """Scan a device-resident byte plane (already padded with
        PAD_BYTE to a BLOCK_BYTES multiple, newline-terminated at
        ``nbytes - 1``); only candidate rows are gathered D2H."""
        scr = self._screen
        if scr is None and not self._screen_failed:
            # deferred screen: resolve the header row from a bounded
            # prefix readback, then screen device-side as usual
            head = _drain_fallback_chunk(dev_arr, min(nbytes, 65536))
            scr = self._ensure_screen(head)
        if scr is None:
            # unsupported screen: one full readback, then the host
            # engines own the stream
            data = _drain_fallback_chunk(dev_arr, nbytes)
            super()._chunk(data)
            return self.matched
        t0 = time.perf_counter()
        # the plane already lives on its device: the claim only keeps
        # the submesh's load count honest for concurrent host scans
        router = _scan_router(self.device)
        sub = router.route(1)
        try:
            spans = self._screen_spans(dev_arr, nbytes, scr)
            if spans is None:
                data = _drain_fallback_chunk(dev_arr, nbytes)
                super()._chunk(data)
                return self.matched
            starts, ends = spans
            if not len(starts):
                return self.matched
            lens = ends - starts
            wmax = int(lens.max())
            window = 1
            while window < wmax:
                window <<= 1
            window = max(window, 64)
            starts_d = torch.from_numpy(starts.astype(np.int32)).to(
                dev_arr.device
            )
            mat = _drain_array(
                ss.gather_rows(dev_arr, starts_d, window=window)
            )
            out = bytearray()
            for i, ln in enumerate(lens.tolist()):
                out += mat[i, :ln].tobytes()
            super()._chunk(bytes(out))
            return self.matched
        finally:
            if sub is not None:
                router.release(sub)
            STATS.device_time(time.perf_counter() - t0)


def as_device_plane(chunks, total: int, device="cuda"):
    """Assemble cache-tier group buffers into one padded byte plane on
    ``device`` (a concatenation there: no host round-trip for device
    chunks).  ``chunks`` are tensors (any dtype, viewed as bytes) or
    numpy arrays in stream order; returns (plane, nbytes) with nbytes
    covering ``total`` plus a terminating newline."""
    dev = torch.device(device)
    flat = []
    for c in chunks:
        t = c if isinstance(c, torch.Tensor) else torch.from_numpy(
            np.require(c, requirements="CW"))
        t = t.contiguous().reshape(-1)
        if t.dtype != torch.uint8:
            t = t.view(torch.uint8)
        flat.append(t.to(dev))
    plane = torch.cat(flat)[:total]
    # newline-terminate only when the object doesn't already (an
    # unconditional one would invent a trailing blank row)
    last = _drain_scalars(plane[total - 1])[0] if total else 10
    tail = b"" if last == 10 else b"\n"
    nbytes = total + len(tail)
    pad = (-nbytes) % ss.BLOCK_BYTES
    if tail or pad:
        suffix = torch.frombuffer(
            bytearray(tail + bytes([ss.PAD_BYTE]) * pad), dtype=torch.uint8
        ).to(dev)
        plane = torch.cat([plane, suffix])
    return plane, nbytes
