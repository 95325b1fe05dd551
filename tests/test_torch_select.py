"""The port's S3 Select engine (minio_tpu_torch.s3select) held against
minio_tpu.s3select.

The same request documents and object bytes go to the JAX package's
``S3Select`` and to the port's, over CSV, JSON lines and documents,
Parquet, gzip and bz2 input, projections, aggregates, LIMIT and errors.
The JAX side runs with ``MINIO_TPU_SELECT=host`` or ``row`` set (its
``auto`` mode reaches the device engine, which needs
``jax.experimental.enable_x64``, missing from this jax).  Under the same
mode the two packages' EventStream frames are byte-identical; the port's
device engine (``auto``, on the CPU: the plain versions of K8-K11) gives
the JAX host engine's Records, unframed, and the same Stats and End
frames.  Exact everywhere: these are bytes.

Also here: the port's fallback counters (``SelectStats``) for each
reason, ``run_device`` over ``as_device_plane`` (the cache-tier shape),
and the TPC-H lineitem queries of ``chip_smoke.py`` - their
device eligibility and screens against the JAX compiler's, and the
fallback each takes, screened by the JAX package's ``screen_chunk``.
"""

from __future__ import annotations

import bz2
import gzip
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from minio_tpu.ops import select_step as jss
from minio_tpu.s3select import device as jdev, engine as jeng, sql as jsql
from minio_tpu.s3select.parquetio import (
    T_BOOLEAN, T_BYTE_ARRAY, T_DOUBLE, T_INT64, write_parquet,
)
from minio_tpu_torch.s3select import (
    device as tdev, engine as teng, message as tmsg, sql as tsql,
)
from tests.test_torch_threads import torch_threads  # noqa: F401

CSV = (
    b"name,age,city,score\n"
    b"alice,30,paris,1.5\n"
    b"bob,25,london,2\n"
    b"carol,35,paris,-3.25\n"
    b"dave,28,berlin,10\n"
    b"erin,41,rome,0\n"
)
QUOTED = b'name,note\n"smith, j",ok\nbob,"say ""hi"""\n'
JSONL = (
    b'{"name":"alice","age":30,"nested":{"x":1}}\n'
    b'{"name":"bob","age":25,"nested":{"x":2}}\n'
    b'{"name":"carol","age":35}\n'
)
JSONDOC = b'[{"a":1,"b":"x"},{"a":2,"b":"y"},{"a":3}]'


def _parquet() -> bytes:
    return write_parquet([
        ("id", T_INT64, [1, 2, 3, 4, 5]),
        ("name", T_BYTE_ARRAY, ["a", "bb", "ccc", "dd", "e"]),
        ("score", T_DOUBLE, [1.5, 2.0, 2.5, 3.0, 9.75]),
        ("ok", T_BOOLEAN, [True, False, True, True, False]),
    ])


def _body(expr, inp="<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>",
          out="", comp="", progress=False):
    expr = expr.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    comp_xml = f"<CompressionType>{comp}</CompressionType>" if comp else ""
    prog = ("<RequestProgress><Enabled>true</Enabled></RequestProgress>"
            if progress else "")
    return (
        "<SelectObjectContentRequest>"
        f"<Expression>{expr}</Expression><ExpressionType>SQL</ExpressionType>"
        f"<InputSerialization>{comp_xml}{inp}</InputSerialization>"
        f"<OutputSerialization>{out}</OutputSerialization>{prog}"
        "</SelectObjectContentRequest>"
    ).encode()


def _run(eng, body, data, device=None):
    """(frames, error code or None)."""
    frames: list = []
    try:
        if device is None:
            eng.run_select(body, data, frames.append)
        else:
            eng.run_select(body, data, frames.append, device=device)
    except eng.SelectError as e:
        return frames, e.code
    return frames, None


def _split(frames):
    """(Records payload joined, the other frames' headers and payloads)."""
    msgs = tmsg.decode_all(b"".join(frames))
    recs = b"".join(m["payload"] for m in msgs
                    if m["headers"].get(":event-type") == "Records")
    rest = [(m["headers"], m["payload"]) for m in msgs
            if m["headers"].get(":event-type") != "Records"]
    return recs, rest


CSV_OUT = "<CSV/>"
JSON_OUT = "<JSON/>"
USE = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
CASES = {
    # CSV through the columnar and device engines
    "star": ("SELECT * FROM S3Object", CSV, USE, CSV_OUT, ""),
    "where_lt": ("SELECT * FROM S3Object s WHERE s.age < 30", CSV, USE, CSV_OUT, ""),
    "where_ge_proj": ("SELECT s.name, s.city FROM S3Object s WHERE s.age >= 30",
                      CSV, USE, CSV_OUT, ""),
    "where_str_eq": ("SELECT s.name FROM S3Object s WHERE s.city = 'paris'",
                     CSV, USE, CSV_OUT, ""),
    "where_float": ("SELECT * FROM S3Object s WHERE s.score > 1.5", CSV, USE,
                    CSV_OUT, ""),
    "where_in": ("SELECT s.name FROM S3Object s WHERE s.age IN (25, 35, 41)",
                 CSV, USE, CSV_OUT, ""),
    "where_between": ("SELECT * FROM S3Object s WHERE s.age BETWEEN 26 AND 36",
                      CSV, USE, CSV_OUT, ""),
    "where_or": ("SELECT * FROM S3Object s WHERE s.age < 26 OR s.city = 'rome'",
                 CSV, USE, CSV_OUT, ""),
    "where_and": ("SELECT * FROM S3Object s WHERE s.age > 26 AND s.city = 'paris'",
                  CSV, USE, CSV_OUT, ""),
    "where_like": ("SELECT s.name FROM S3Object s WHERE s.name LIKE '%a%'",
                   CSV, USE, CSV_OUT, ""),
    "limit": ("SELECT * FROM S3Object s WHERE s.age > 20 LIMIT 2", CSV, USE,
              CSV_OUT, ""),
    "count": ("SELECT COUNT(*) FROM S3Object s WHERE s.age > 26", CSV, USE,
              CSV_OUT, ""),
    "aggregates": ("SELECT SUM(s.age), AVG(s.score), MIN(s.age), MAX(s.name) "
                   "FROM S3Object s WHERE s.city = 'paris'", CSV, USE, CSV_OUT, ""),
    "cast_arith": ("SELECT CAST(s.age AS INT) * 2, UPPER(s.name) FROM S3Object s "
                   "WHERE s.age < 35", CSV, USE, CSV_OUT, ""),
    "positional": ("SELECT s._1 FROM S3Object s WHERE s._2 < 30",
                   CSV.split(b"\n", 1)[1],
                   "<CSV><FileHeaderInfo>NONE</FileHeaderInfo></CSV>", CSV_OUT, ""),
    "header_ignore": ("SELECT s._3 FROM S3Object s",
                      CSV, "<CSV><FileHeaderInfo>IGNORE</FileHeaderInfo></CSV>",
                      CSV_OUT, ""),
    "json_out": ("SELECT s.name, s.age FROM S3Object s WHERE s.age > 26", CSV,
                 USE, JSON_OUT, ""),
    "quoted": ("SELECT * FROM S3Object s WHERE s.name = 'bob'", QUOTED, USE,
               CSV_OUT, ""),
    "out_always_quoted": ("SELECT * FROM S3Object", CSV, USE,
                          "<CSV><QuoteFields>ALWAYS</QuoteFields></CSV>", ""),
    "pipe_delim": ("SELECT s.b FROM S3Object s WHERE s.a < 3",
                   b"a|b\n1|x\n2|y\n5|z\n",
                   "<CSV><FileHeaderInfo>USE</FileHeaderInfo>"
                   "<FieldDelimiter>|</FieldDelimiter></CSV>", CSV_OUT, ""),
    "gzip": ("SELECT * FROM S3Object s WHERE s.age < 30", gzip.compress(CSV),
             USE, CSV_OUT, "GZIP"),
    "bzip2": ("SELECT s.name FROM S3Object s WHERE s.city = 'paris'",
              bz2.compress(CSV), USE, CSV_OUT, "BZIP2"),
    # JSON and Parquet input
    "jsonl": ("SELECT s.name FROM S3Object s WHERE s.age > 26", JSONL,
              "<JSON><Type>LINES</Type></JSON>", JSON_OUT, ""),
    "jsonl_nested": ("SELECT s.nested.x FROM S3Object s", JSONL,
                     "<JSON><Type>LINES</Type></JSON>", JSON_OUT, ""),
    "jsonl_count": ("SELECT COUNT(*), SUM(s.age) FROM S3Object s WHERE s.age > 20",
                    JSONL, "<JSON><Type>LINES</Type></JSON>", JSON_OUT, ""),
    "jsondoc": ("SELECT s.a FROM S3Object[*] s WHERE s.a >= 2", JSONDOC,
                "<JSON><Type>DOCUMENT</Type></JSON>", JSON_OUT, ""),
    "parquet": ("SELECT s.name, s.score FROM S3Object s WHERE s.id > 2",
                _parquet(), "<Parquet/>", "", ""),
    "parquet_agg": ("SELECT COUNT(*), MAX(s.score) FROM S3Object s", _parquet(),
                    "<Parquet/>", "", ""),
    # errors
    "bad_sql": ("SELEKT nothing", CSV, USE, CSV_OUT, ""),
    "bad_column_fn": ("SELECT NOSUCHFN(s.age) FROM S3Object s", CSV, USE,
                      CSV_OUT, ""),
    "bad_cast": ("SELECT CAST(s.name AS INT) FROM S3Object s", CSV, USE,
                 CSV_OUT, ""),
    "gzip_not_gzip": ("SELECT * FROM S3Object", CSV, USE, CSV_OUT, "GZIP"),
}


@pytest.mark.parametrize("mode", ["host", "row"])
@pytest.mark.parametrize("case", list(CASES))
def test_same_mode_same_frames(monkeypatch, case, mode):
    expr, data, inp, out, comp = CASES[case]
    body = _body(expr, inp, out, comp)
    monkeypatch.setenv("MINIO_TPU_SELECT", mode)
    jf, jerr = _run(jeng, body, data)
    tf, terr = _run(teng, body, data, device="cpu")
    assert terr == jerr
    assert b"".join(tf) == b"".join(jf)


@pytest.mark.parametrize("case", list(CASES))
def test_device_engine_matches_the_host_engine(monkeypatch, case):
    """The port's default engine (the device pre-filter where the
    statement allows it) against the JAX host engine."""
    expr, data, inp, out, comp = CASES[case]
    body = _body(expr, inp, out, comp)
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, jerr = _run(jeng, body, data)
    monkeypatch.delenv("MINIO_TPU_SELECT")
    tf, terr = _run(teng, body, data, device="cpu")
    assert terr == jerr
    if jerr is None:
        assert _split(tf) == _split(jf)


def test_progress_frames_match(monkeypatch):
    body = _body("SELECT * FROM S3Object s WHERE s.age > 26", progress=True)
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, body, CSV)
    monkeypatch.setenv("MINIO_TPU_SELECT", "device")
    tf, _ = _run(teng, body, CSV, device="cpu")
    assert _split(tf) == _split(jf)
    assert any(h[":event-type"] == "Progress" for h, _p in _split(tf)[1])


@pytest.mark.parametrize("body", [
    b"",
    b"<not-xml",
    b"<Other/>",
    _body("SELECT * FROM S3Object").replace(b"SQL", b"XPATH"),
    _body("SELECT * FROM S3Object", comp="ZSTD"),
    _body("SELECT * FROM S3Object", inp="<CSV><FileHeaderInfo>MAYBE"
          "</FileHeaderInfo></CSV>"),
    _body("SELECT * FROM S3Object", inp="<Avro/>"),
    _body("SELECT * FROM S3Object", inp="<Parquet/>", comp="GZIP"),
    _body("SELECT * FROM S3Object", out="<CSV><QuoteFields>SOMETIMES"
          "</QuoteFields></CSV>"),
    _body("SELECT * FROM S3Object", inp="<JSON><Type>TREE</Type></JSON>"),
    _body(""),
])
def test_request_errors_match(body):
    def code(eng):
        try:
            eng.SelectRequest.from_xml(body)
        except eng.SelectError as e:
            return e.code
        return None

    assert code(teng) == code(jeng)
    assert code(teng) is not None


def _rows(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    lines = ["k,v,tag"] + [
        f"{int(k)},{int(v)},t{int(t)}" for k, v, t in zip(
            rng.integers(0, 100000, n), rng.integers(-500, 500, n),
            rng.integers(0, 9, n))]
    return ("\n".join(lines) + "\n").encode()


def _stats_run(monkeypatch, expr, data):
    tdev.STATS.reset()
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
    tf, err = _run(teng, _body(expr), data, device="cpu")
    assert err is None
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, _body(expr), data)
    assert _split(tf) == _split(jf)
    return tdev.STATS.snapshot()


def test_no_fallback_on_a_selective_screen(monkeypatch):
    snap = _stats_run(monkeypatch, "SELECT * FROM S3Object s WHERE s.k < 100",
                      _rows(6000))
    assert snap["requests"]["device"] == 1
    assert not any(snap["fallbacks"].values())
    assert snap["device_seconds"] > 0


@pytest.mark.parametrize("reason,expr,data,patch", [
    ("hazard", "SELECT * FROM S3Object s WHERE s.k < 100",
     _rows(300) + b'5,"q",t1\n', {}),
    ("hazard", "SELECT * FROM S3Object s WHERE s.k < 100",
     _rows(300) + b"5e3,1,t1\n", {}),
    ("ratio", "SELECT * FROM S3Object s WHERE s.v < 1000", _rows(6000), {}),
    ("overflow", "SELECT * FROM S3Object s WHERE s.tag = 't3'", _rows(3000),
     {"_MAX_CANDS": 64}),
    ("wide", "SELECT s.k FROM S3Object s WHERE s.k < 100",
     b"k,pad\n7," + b"p" * 5000 + b"\n9,x\n", {}),
    ("unsupported", "SELECT * FROM S3Object s WHERE s.nosuch < 3", _rows(50), {}),
])
def test_fallback_counted_by_reason(monkeypatch, reason, expr, data, patch):
    for name, value in patch.items():
        monkeypatch.setattr(tdev, name, value)
    snap = _stats_run(monkeypatch, expr, data)
    assert snap["requests"]["device"] == 1
    assert snap["fallbacks"][reason] == 1
    assert sum(snap["fallbacks"].values()) == 1


def test_host_and_row_modes_count_their_engines(monkeypatch):
    tdev.STATS.reset()
    for mode in ("host", "row"):
        monkeypatch.setenv("MINIO_TPU_SELECT", mode)
        _run(teng, _body("SELECT * FROM S3Object s WHERE s.age > 1"), CSV,
             device="cpu")
    snap = tdev.STATS.snapshot()
    assert snap["requests"] == {"device": 0, "host": 1, "row": 1}
    assert snap["scanned_bytes"] == 2 * len(CSV)


def _device_answer(monkeypatch, expr, chunks, total, data):
    plane, nbytes = tdev.as_device_plane(chunks, total, "cpu")
    assert plane.numel() % tdev.ss.BLOCK_BYTES == 0
    req = teng.SelectRequest.from_xml(_body(expr))
    frames: list = []
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
    teng.S3Select(req, "cpu").evaluate(None, total, frames.append,
                                       device_source=(plane, nbytes))
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, _body(expr), data)
    return frames, jf


@pytest.mark.parametrize("trailing_newline", [True, False])
@pytest.mark.parametrize("expr", [
    "SELECT * FROM S3Object s WHERE s.k < 500",
    "SELECT s.k FROM S3Object s WHERE s.tag = 't2'",
    "SELECT COUNT(*) FROM S3Object s WHERE s.v < 0",
    "SELECT * FROM S3Object",  # no WHERE: one full readback
])
def test_run_device_over_as_device_plane(monkeypatch, expr, trailing_newline):
    data = _rows(3000, 4)
    if not trailing_newline:
        data = data[:-1]
    raw = np.frombuffer(data + b"\0" * ((-len(data)) % 4), np.uint8)
    cut = (len(raw) // 3) & ~3
    # cache-tier groups: uint8 and int32 tensors, a numpy array
    chunks = [torch.from_numpy(raw[:cut].copy()),
              torch.from_numpy(raw[cut:2 * cut].copy()).view(torch.int32),
              raw[2 * cut:]]
    frames, jf = _device_answer(monkeypatch, expr, chunks, len(data), data)
    assert _split(frames) == _split(jf)


def test_run_device_gathers_only_candidate_rows(monkeypatch):
    data = _rows(3000, 5)
    calls = []
    gather = tdev.ss.gather_rows

    def spy(arr, starts, *, window):
        calls.append((starts.numel(), window))
        return gather(arr, starts, window=window)

    monkeypatch.setattr(tdev.ss, "gather_rows", spy)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    frames, jf = _device_answer(monkeypatch, "SELECT * FROM S3Object s WHERE s.k < 300",
                                [t], len(data), data)
    assert _split(frames) == _split(jf)
    # the screen's candidates (keys under 300, and lexicographically
    # under it) with the first row, not all 3,000 rows
    assert len(calls) == 1 and 0 < calls[0][0] < 1000 and calls[0][1] >= 64


# -- the TPC-H lineitem queries chip_smoke.py drives ---------------------


def _lineitem_req(q: str):
    body = chip_smoke.select_body(chip_smoke.SELECT_QUERIES[q])
    return jeng.SelectRequest.from_xml(body), teng.SelectRequest.from_xml(body)


@pytest.mark.parametrize("q", list(chip_smoke.SELECT_QUERIES))
def test_lineitem_queries_screen_as_the_reference_compiles(q):
    jreq, treq = _lineitem_req(q)
    jstmt = jsql.parse(jreq.expression)
    tstmt = tsql.parse(treq.expression)
    assert jdev.device_eligible(jstmt, jreq)
    assert tdev.device_eligible(tstmt, treq)
    header = chip_smoke.LI_HEADER.split("|")
    js = jdev.compile_screen(jstmt.where, header)
    ts = tdev.compile_screen(tstmt.where, header)
    assert (js.atoms, js.anchor, js.sci_guard) == (ts.atoms, ts.anchor, ts.sci_guard)
    assert ts.anchor == ("row" if q == "Q1" else "field")


def _reason(count, nrows, haz, max_cands):
    """The JAX DeviceScan's ladder (device.py:443-459) on one chunk."""
    if haz:
        return "hazard"
    if count > max_cands:
        return "overflow"
    if count and nrows >= jdev._MIN_RATIO_ROWS and count > nrows * jdev._RATIO_CAP:
        return "ratio"
    return None


def _jax_reasons(data: bytes, chunk: int, q: str, max_cands: int) -> list:
    """Each chunk's reason, cut as FastScan.run cuts the stream and
    screened by the JAX package's screen_chunk."""
    header = chip_smoke.LI_HEADER.split("|")
    scr = jdev.compile_screen(jsql.parse(chip_smoke.SELECT_QUERIES[q]).where,
                              header)
    reasons = []
    pos, carry = 0, b""
    while pos < len(data):
        buf = carry + data[pos:pos + chunk]
        pos += chunk
        cut = buf.rfind(b"\n") + 1
        part, carry = buf[:cut], buf[cut:]
        arr = np.frombuffer(
            part + bytes([jss.PAD_BYTE]) * ((-len(part)) % jss.BLOCK_BYTES),
            np.uint8)
        with jax.enable_x64(True):
            _c, blk, nrows, haz = jss.screen_chunk(
                jnp.asarray(arr), fd=ord("|"), qc=ord('"'), atoms=scr.atoms,
                anchor=scr.anchor, sci_guard=scr.sci_guard)
            reasons.append(_reason(int(np.asarray(blk).sum()), int(nrows),
                                   bool(haz), max_cands))
    return reasons


def test_lineitem_fallbacks_at_the_path_chunk():
    """One DEV_CHUNK (32 MiB) of the lineitem object, screened by the JAX
    package under each query: the JAX ladder gives chip_smoke's expected
    fallback (Q1 and Q2 none, Q3 overflow, Q4 ratio).  The first chunk
    decides Q1: its keys of up to 4 digits (about 4 % of its rows) are
    all in it."""
    data = chip_smoke.lineitem_csv(chip_smoke.SEED, tdev.DEV_CHUNK)
    for q in chip_smoke.SELECT_QUERIES:
        assert _jax_reasons(data, tdev.DEV_CHUNK, q, jdev._MAX_CANDS) == [
            chip_smoke.SELECT_FALLBACK[q]], q


def test_lineitem_fallbacks_counted_as_the_reference_decides(monkeypatch):
    """Q1-Q4 over 4 chunks of 1 MiB (the read size and _MAX_CANDS cut
    32x): the port's counted fallbacks equal the JAX ladder's on each
    chunk, and the answers the JAX host engine's."""
    scale = 32
    chunk = tdev.DEV_CHUNK // scale
    data = chip_smoke.lineitem_csv(chip_smoke.SEED, 4 * chunk)
    monkeypatch.setattr(tdev.DeviceScan, "read_size", chunk)
    monkeypatch.setattr(tdev, "_MAX_CANDS", tdev._MAX_CANDS // scale)
    for q, text in chip_smoke.SELECT_QUERIES.items():
        reasons = _jax_reasons(data, chunk, q, jdev._MAX_CANDS // scale)
        assert len(reasons) == 4
        body = chip_smoke.select_body(text)
        monkeypatch.setenv("MINIO_TPU_SELECT", "host")
        jf, _ = _run(jeng, body, data)
        monkeypatch.delenv("MINIO_TPU_SELECT")
        tdev.STATS.reset()
        tf, err = _run(teng, body, data, device="cpu")
        assert err is None
        assert _split(tf) == _split(jf)
        fb = {k: v for k, v in tdev.STATS.snapshot()["fallbacks"].items() if v}
        want = {r: reasons.count(r) for r in set(reasons) if r}
        assert fb == want, q


def test_lineitem_generator_shape():
    data = chip_smoke.lineitem_csv(3, 1 << 20)
    rows = data.split(b"\n")[:-1]
    assert rows[0].decode() == chip_smoke.LI_HEADER
    assert len(data) <= 1 << 20 and data.endswith(b"\n")
    widths = [len(r) + 1 for r in rows[1:]]
    assert 110 <= sum(widths) / len(widths) <= 140
    keys = [int(r.split(b"|", 1)[0]) for r in rows[1:]]
    assert keys == sorted(keys) and keys[0] == 1
    assert all(r.count(b"|") == 15 for r in rows)
    assert b'"' not in data
    # no digit followed by e/E (the sci guard's hazard)
    assert not any(a in b"0123456789" and b in b"eE"
                   for a, b in zip(data, data[1:]))
    assert json.dumps(chip_smoke.SELECT_FALLBACK)


def test_engine_stream_input(monkeypatch):
    """evaluate over a stream reads it chunk by chunk; the device engine
    screens each chunk (several with a small read size)."""
    data = _rows(4000, 8)
    monkeypatch.setattr(tdev.DeviceScan, "read_size", 8192)
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
    req = teng.SelectRequest.from_xml(_body("SELECT s.k FROM S3Object s WHERE s.k < 2000"))
    frames: list = []
    teng.S3Select(req, "cpu").evaluate(io.BytesIO(data), len(data), frames.append)
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, _body("SELECT s.k FROM S3Object s WHERE s.k < 2000"), data)
    assert _split(frames) == _split(jf)
