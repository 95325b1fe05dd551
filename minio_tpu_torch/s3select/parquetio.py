"""Parquet record reader for S3 Select
(pkg/s3select/parquet/reader.go + the minio/parquet-go internals).

A self-contained reader for the common analytics layout - flat
schemas, PLAIN or dictionary encoding, uncompressed pages - built
from the format spec up: a Thrift compact-protocol decoder for the
footer metadata, the RLE/bit-packed hybrid for definition levels and
dictionary indexes, and PLAIN decoders for the physical types.  No
external parquet/thrift dependency exists in this image, so the wire
format is implemented directly; unsupported shapes (nested schemas,
compressed pages, v2-only encodings) raise ParquetError with a
precise reason rather than misreading data.

A minimal writer lives at the bottom: the test suite uses it to
produce real files (single row group, PLAIN, uncompressed), and it
doubles as documentation of the subset the reader guarantees.
"""

from __future__ import annotations

import struct

from .sql import MISSING, SQLError

MAGIC = b"PAR1"


class ParquetError(SQLError):
    def __init__(self, message: str):
        super().__init__(message, "InvalidParquet")


# ---------------------------------------------------------------------------
# Thrift compact protocol (just enough for parquet metadata)
# ---------------------------------------------------------------------------

_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


# raw decoder faults a corrupt file can produce; every public entry
# point converts them to ParquetError so the select plane answers
# with a precise 4xx instead of a generic 500
_DECODE_FAULTS = (
    IndexError,
    struct.error,
    TypeError,
    AttributeError,
    UnicodeDecodeError,
    ValueError,
    KeyError,
    OverflowError,
    MemoryError,
)


class _Thrift:
    """Compact-protocol decoder producing {field_id: value} dicts."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ParquetError("truncated thrift metadata")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        out = shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def _zigzag(self) -> int:
        v = self._varint()
        return (v >> 1) ^ -(v & 1)

    def _value(self, ctype: int):
        if ctype == _CT_TRUE:
            return True
        if ctype == _CT_FALSE:
            return False
        if ctype in (_CT_BYTE, _CT_I16, _CT_I32, _CT_I64):
            return self._zigzag()
        if ctype == _CT_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == _CT_BINARY:
            n = self._varint()
            v = self.buf[self.pos : self.pos + n]
            self.pos += n
            return v
        if ctype in (_CT_LIST, _CT_SET):
            head = self._byte()
            n = head >> 4
            etype = head & 0x0F
            if n == 15:
                n = self._varint()
            return [self._value(etype) for _ in range(n)]
        if ctype == _CT_STRUCT:
            return self.struct()
        if ctype == _CT_MAP:
            n = self._varint()
            if n == 0:
                return {}
            kv = self._byte()
            kt, vt = kv >> 4, kv & 0x0F
            return {
                self._value(kt): self._value(vt) for _ in range(n)
            }
        raise ParquetError(f"thrift compact type {ctype}")

    def struct(self) -> dict:
        out: dict = {}
        fid = 0
        while True:
            head = self._byte()
            if head == _CT_STOP:
                return out
            delta = head >> 4
            ctype = head & 0x0F
            if delta:
                fid += delta
            else:
                fid = self._zigzag()
            if ctype in (_CT_TRUE, _CT_FALSE):
                out[fid] = ctype == _CT_TRUE
            else:
                out[fid] = self._value(ctype)


# physical types (parquet.thrift Type)
T_BOOLEAN, T_INT32, T_INT64, T_INT96 = 0, 1, 2, 3
T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FIXED = 4, 5, 6, 7

ENC_PLAIN = 0
ENC_PLAIN_DICT = 2
ENC_RLE = 3
ENC_RLE_DICT = 8

CODEC_UNCOMPRESSED = 0


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid (definition levels + dictionary indexes)
# ---------------------------------------------------------------------------


def _read_rle_hybrid(
    buf: bytes, pos: int, end: int, bit_width: int, count: int
) -> "list[int]":
    out: "list[int]" = []
    if bit_width == 0:
        return [0] * count
    while len(out) < count and pos < end:
        header = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:  # bit-packed run: (header>>1)*8 values
            groups = header >> 1
            nbytes = groups * bit_width
            bits = int.from_bytes(
                buf[pos : pos + nbytes], "little"
            )
            pos += nbytes
            mask = (1 << bit_width) - 1
            for i in range(groups * 8):
                out.append((bits >> (i * bit_width)) & mask)
        else:  # RLE run
            n = header >> 1
            w = (bit_width + 7) // 8
            v = int.from_bytes(buf[pos : pos + w], "little")
            pos += w
            out.extend([v] * n)
    return out[:count]


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class ParquetColumn:
    def __init__(self, name: str, ptype: int, required: bool):
        self.name = name
        self.ptype = ptype
        self.required = required


def _decode_plain(buf: bytes, pos: int, ptype: int, n: int):
    """n PLAIN-encoded values of one physical type."""
    vals: list = []
    if ptype == T_BOOLEAN:
        for i in range(n):
            vals.append(bool(buf[pos + i // 8] >> (i % 8) & 1))
        return vals, pos + (n + 7) // 8
    if ptype == T_INT32:
        vals = list(struct.unpack_from(f"<{n}i", buf, pos))
        return vals, pos + 4 * n
    if ptype == T_INT64:
        vals = list(struct.unpack_from(f"<{n}q", buf, pos))
        return vals, pos + 8 * n
    if ptype == T_FLOAT:
        vals = list(struct.unpack_from(f"<{n}f", buf, pos))
        return vals, pos + 4 * n
    if ptype == T_DOUBLE:
        vals = list(struct.unpack_from(f"<{n}d", buf, pos))
        return vals, pos + 8 * n
    if ptype == T_BYTE_ARRAY:
        for _ in range(n):
            ln = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            vals.append(
                buf[pos : pos + ln].decode("utf-8", "replace")
            )
            pos += ln
        return vals, pos
    raise ParquetError(f"unsupported physical type {ptype}")


class ParquetReader:
    """Reads a whole (small-to-medium) parquet object into columns;
    S3 Select payloads are bounded by the request, matching the
    reference reader's per-rowgroup materialization."""

    def __init__(self, data: bytes):
        if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
            raise ParquetError("not a parquet file (magic)")
        flen = struct.unpack_from("<I", data, len(data) - 8)[0]
        meta_start = len(data) - 8 - flen
        if meta_start < 4:
            raise ParquetError("corrupt footer length")
        try:
            md = _Thrift(data, meta_start).struct()
            # FileMetaData: 2=schema list, 3=num_rows, 4=row_groups
            self.num_rows = md.get(3, 0)
            schema = md.get(2) or []
            self.columns: "list[ParquetColumn]" = []
            for el in schema[1:]:  # [0] is the root
                # SchemaElement: 1=type 3=repetition 4=name
                # 5=num_children
                if el.get(5):
                    raise ParquetError(
                        "nested parquet schemas are not supported"
                    )
                rep = el.get(3, 0)  # 0=required 1=optional 2=repeated
                if rep == 2:
                    raise ParquetError(
                        "repeated parquet fields are not supported"
                    )
                self.columns.append(
                    ParquetColumn(
                        el.get(4, b"").decode(),
                        el.get(1, 0),
                        rep == 0,
                    )
                )
            self._row_groups = md.get(4) or []
        except _DECODE_FAULTS as e:
            raise ParquetError(
                f"corrupt parquet footer: {type(e).__name__}"
            ) from None
        self._data = data

    def _read_column_chunk(self, col_meta: dict, col: ParquetColumn):
        """All values of one column chunk, Nones for null slots."""
        # ColumnMetaData: 1=type 2=encodings 3=path 4=codec
        # 5=num_values 9=data_page_offset 11=dictionary_page_offset
        codec = col_meta.get(4, 0)
        if codec != CODEC_UNCOMPRESSED:
            raise ParquetError(
                f"compressed parquet pages (codec {codec}) are not "
                "supported"
            )
        num_values = col_meta.get(5, 0)
        pos = col_meta.get(11) or col_meta.get(9)
        buf = self._data
        dictionary = None
        out: list = []
        while len(out) < num_values:
            th = _Thrift(buf, pos)
            ph = th.struct()
            # PageHeader: 1=page_type 2=uncompressed_size
            # 3=compressed_size 5=data_page_header 7=dict_page_header
            ptype_page = ph.get(1)
            page_len = ph.get(3, 0)
            body = th.pos
            if ptype_page == 2:  # DICTIONARY_PAGE
                dph = ph.get(7) or {}
                n = dph.get(1, 0)
                dictionary, _ = _decode_plain(
                    buf, body, col.ptype, n
                )
            elif ptype_page == 0:  # DATA_PAGE v1
                dph = ph.get(5) or {}
                n = dph.get(1, 0)
                enc = dph.get(2, ENC_PLAIN)
                p = body
                end = body + page_len
                if col.required:
                    defs = [1] * n
                else:
                    # definition levels: RLE hybrid with a 4-byte
                    # length prefix, bit width 1 (max level 1)
                    ln = struct.unpack_from("<I", buf, p)[0]
                    p += 4
                    defs = _read_rle_hybrid(buf, p, p + ln, 1, n)
                    p += ln
                npresent = sum(defs)
                if enc == ENC_PLAIN:
                    vals, _ = _decode_plain(
                        buf, p, col.ptype, npresent
                    )
                elif enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
                    if dictionary is None:
                        raise ParquetError(
                            "dictionary-encoded page without a "
                            "dictionary page"
                        )
                    bw = buf[p]
                    p += 1
                    idxs = _read_rle_hybrid(
                        buf, p, end, bw, npresent
                    )
                    try:
                        vals = [dictionary[i] for i in idxs]
                    except IndexError:
                        raise ParquetError(
                            "dictionary index out of range"
                        ) from None
                else:
                    raise ParquetError(
                        f"page encoding {enc} is not supported"
                    )
                it = iter(vals)
                out.extend(
                    next(it) if d else None for d in defs
                )
            else:
                raise ParquetError(
                    f"page type {ptype_page} is not supported"
                )
            pos = body + page_len
        return out[:num_values]

    def rows(self):
        """Yield row dicts (column name -> value; None stays null).
        A file whose row groups do not add up to the footer's
        num_rows is corrupt - better a loud error than a silently
        truncated result set."""
        try:
            yield from self._rows_inner()
        except ParquetError:
            raise
        except _DECODE_FAULTS as e:
            raise ParquetError(
                f"corrupt parquet structure: {type(e).__name__}"
            ) from None

    def _rows_inner(self):
        yielded = 0
        for rg in self._row_groups:
            # RowGroup: 1=columns list, 2=total_byte_size, 3=num_rows
            cols: "list[list]" = []
            names: "list[str]" = []
            try:
                chunks = rg.get(1) or []
                for cc, col in zip(chunks, self.columns):
                    # ColumnChunk: 3=meta_data
                    meta = cc.get(3) or {}
                    names.append(col.name)
                    cols.append(
                        self._read_column_chunk(meta, col)
                    )
                nrows = rg.get(3, 0)
            except _DECODE_FAULTS as e:
                raise ParquetError(
                    f"corrupt parquet pages: {type(e).__name__}"
                ) from None
            if any(len(v) < nrows for v in cols):
                raise ParquetError(
                    "row group shorter than its declared num_rows"
                )
            for i in range(nrows):
                yield {
                    name: (MISSING if vals[i] is None else vals[i])
                    for name, vals in zip(names, cols)
                }
            yielded += nrows
        if yielded != self.num_rows:
            raise ParquetError(
                f"file declares {self.num_rows} rows but row groups "
                f"carry {yielded}"
            )


def read_records(stream):
    """S3 Select record source (select.go parquet branch): parquet
    needs random access to the footer, so the object is materialized
    (the reference's reader seeks the underlying object the same
    way; select payload sizes make this bounded)."""
    data = stream.read()
    yield from ParquetReader(data).rows()


def clean_raw_row(row: dict) -> dict:
    """SELECT * cleanup: drop null slots (JSON-style omission)."""
    return {k: v for k, v in row.items() if v is not MISSING}


# ---------------------------------------------------------------------------
# minimal writer (tests + subset documentation): flat schema, one row
# group, PLAIN encoding, uncompressed, v1 data pages
# ---------------------------------------------------------------------------


class _ThriftW:
    def __init__(self):
        self.out = bytearray()
        self._fid = [0]

    def _varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def _zigzag(self, v: int):
        self._varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, fid: int, ctype: int):
        delta = fid - self._fid[-1]
        self._fid[-1] = fid
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self._zigzag(fid)

    def i(self, fid: int, v: int):
        self.field(fid, _CT_I64)
        self._zigzag(v)

    def b(self, fid: int, v: bytes):
        self.field(fid, _CT_BINARY)
        self._varint(len(v))
        self.out += v

    def begin_struct(self, fid: int):
        self.field(fid, _CT_STRUCT)
        self._fid.append(0)

    def end_struct(self):
        self.out.append(_CT_STOP)
        self._fid.pop()

    def begin_list(self, fid: int, etype: int, n: int):
        self.field(fid, _CT_LIST)
        if n < 15:
            self.out.append((n << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self._varint(n)
        self._fid.append(0)  # list elements are structs here

    def end_list(self):
        self._fid.pop()


def _encode_plain(ptype: int, vals: list) -> bytes:
    if ptype == T_BOOLEAN:
        out = bytearray((len(vals) + 7) // 8)
        for i, v in enumerate(vals):
            if v:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)
    if ptype == T_INT64:
        return struct.pack(f"<{len(vals)}q", *vals)
    if ptype == T_DOUBLE:
        return struct.pack(f"<{len(vals)}d", *vals)
    if ptype == T_BYTE_ARRAY:
        out = bytearray()
        for v in vals:
            raw = str(v).encode()
            out += struct.pack("<I", len(raw)) + raw
        return bytes(out)
    raise ParquetError(f"writer: unsupported type {ptype}")


def write_parquet(columns: "list[tuple[str, int, list]]") -> bytes:
    """(name, physical_type, values) columns -> parquet bytes.
    None values mark nulls (the column becomes OPTIONAL)."""
    nrows = len(columns[0][2]) if columns else 0
    body = bytearray(MAGIC)
    chunk_meta = []
    for name, ptype, vals in columns:
        required = all(v is not None for v in vals)
        present = [v for v in vals if v is not None]
        payload = bytearray()
        if not required:
            # definition levels, RLE hybrid (one RLE run per value
            # would be wasteful; bit-pack in groups of 8)
            defs = [0 if v is None else 1 for v in vals]
            groups = (len(defs) + 7) // 8
            bits = bytearray(groups)
            for i, d in enumerate(defs):
                if d:
                    bits[i // 8] |= 1 << (i % 8)
            hybrid = bytes([(groups << 1) | 1]) + bytes(bits)
            payload += struct.pack("<I", len(hybrid)) + hybrid
        payload += _encode_plain(ptype, present)
        # PageHeader
        ph = _ThriftW()
        ph.field(1, _CT_I32)
        ph._zigzag(0)  # DATA_PAGE
        ph.field(2, _CT_I32)
        ph._zigzag(len(payload))
        ph.field(3, _CT_I32)
        ph._zigzag(len(payload))
        ph.begin_struct(5)  # DataPageHeader
        ph.field(1, _CT_I32)
        ph._zigzag(nrows)
        ph.field(2, _CT_I32)
        ph._zigzag(ENC_PLAIN)
        ph.field(3, _CT_I32)
        ph._zigzag(ENC_RLE)
        ph.field(4, _CT_I32)
        ph._zigzag(ENC_RLE)
        ph.end_struct()
        ph.out.append(_CT_STOP)
        offset = len(body)
        body += ph.out + payload
        chunk_meta.append(
            (name, ptype, required, offset, len(ph.out) + len(payload))
        )
    # FileMetaData
    fm = _ThriftW()
    fm.field(1, _CT_I32)
    fm._zigzag(1)  # version
    fm.begin_list(2, _CT_STRUCT, len(columns) + 1)  # schema
    fm._fid.append(0)  # root element struct
    fm.field(4, _CT_BINARY)
    fm._varint(len(b"schema"))
    fm.out += b"schema"
    fm.field(5, _CT_I32)
    fm._zigzag(len(columns))
    fm.out.append(_CT_STOP)
    fm._fid.pop()
    for name, ptype, required, _off, _ln in chunk_meta:
        fm._fid.append(0)
        fm.field(1, _CT_I32)
        fm._zigzag(ptype)
        fm.field(3, _CT_I32)
        fm._zigzag(0 if required else 1)
        fm.field(4, _CT_BINARY)
        fm._varint(len(name.encode()))
        fm.out += name.encode()
        fm.out.append(_CT_STOP)
        fm._fid.pop()
    fm.end_list()
    fm.i(3, nrows)
    fm.begin_list(4, _CT_STRUCT, 1)  # one row group
    fm._fid.append(0)
    fm.begin_list(1, _CT_STRUCT, len(chunk_meta))  # columns
    for name, ptype, required, off, ln in chunk_meta:
        fm._fid.append(0)
        fm.begin_struct(3)  # ColumnMetaData
        fm.field(1, _CT_I32)
        fm._zigzag(ptype)
        fm.begin_list(2, _CT_I32, 1)
        fm._zigzag(ENC_PLAIN)
        fm._fid.pop()
        fm.begin_list(3, _CT_BINARY, 1)
        fm._varint(len(name.encode()))
        fm.out += name.encode()
        fm._fid.pop()
        fm.field(4, _CT_I32)
        fm._zigzag(CODEC_UNCOMPRESSED)
        fm.i(5, nrows)
        fm.field(7, _CT_I64)
        fm._zigzag(ln)
        fm.field(8, _CT_I64)
        fm._zigzag(ln)
        fm.field(9, _CT_I64)
        fm._zigzag(off)
        fm.end_struct()
        fm.out.append(_CT_STOP)
        fm._fid.pop()
    fm.end_list()
    fm.i(2, len(body) - 4)  # total_byte_size
    fm.i(3, nrows)
    fm.out.append(_CT_STOP)
    fm._fid.pop()
    fm.end_list()
    fm.out.append(_CT_STOP)
    meta = bytes(fm.out)
    return bytes(body) + meta + struct.pack("<I", len(meta)) + MAGIC
