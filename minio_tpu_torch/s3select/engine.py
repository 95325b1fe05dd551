"""S3 Select orchestrator (pkg/s3select/select.go S3Select.Evaluate).

Parses the SelectObjectContentRequest document, streams object bytes
through the record reader, evaluates the statement row-by-row, and
emits EventStream frames (Records batches -> Stats -> End).  The device
engine (s3select/device.py) runs on the ``device`` the evaluation is
given: the object layer's codec device in the server, the card by
default.
"""

from __future__ import annotations

import bz2
import gzip
import io
import xml.etree.ElementTree as ET

from ..utils.xmlutil import child, child_text, strip_ns
from . import csvio, jsonio, message, sql, vector

# Records payloads batch up to this size before a frame is flushed
# (maxRecordSize/bufioWriterSize in the reference's message writer)
BATCH_BYTES = 128 << 10


class SelectError(Exception):
    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


class SelectRequest:
    """Parsed SelectObjectContentRequest."""

    def __init__(self):
        self.expression = ""
        self.expression_type = "SQL"
        self.compression = "NONE"
        self.input_format = ""  # CSV | JSON | PARQUET
        self.csv_args = csvio.CSVArgs()
        self.json_args = jsonio.JSONArgs()
        self.output_format = ""  # CSV | JSON (defaults to input)
        self.csv_writer_args: dict = {}
        self.json_writer_args: dict = {}
        self.progress = False

    @classmethod
    def from_xml(cls, body: bytes) -> "SelectRequest":
        if not body:
            raise SelectError("EmptyRequestBody", "request body is empty")
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise SelectError(
                "MalformedXML", "request XML is not well-formed"
            ) from None
        if strip_ns(root.tag) != "SelectObjectContentRequest":
            raise SelectError(
                "MalformedXML", "not a SelectObjectContentRequest"
            )
        req = cls()
        req.expression = child_text(root, "Expression")
        req.expression_type = (
            child_text(root, "ExpressionType") or "SQL"
        ).upper()
        if req.expression_type != "SQL":
            raise SelectError(
                "InvalidExpressionType", "only SQL expressions supported"
            )
        if not req.expression:
            raise SelectError("MissingRequiredParameter", "no Expression")

        inser = child(root, "InputSerialization")
        if inser is None:
            raise SelectError(
                "MissingRequiredParameter", "no InputSerialization"
            )
        req.compression = (
            child_text(inser, "CompressionType") or "NONE"
        ).upper()
        if req.compression not in ("NONE", "GZIP", "BZIP2"):
            raise SelectError(
                "InvalidCompressionFormat",
                f"unsupported compression {req.compression}",
            )
        csv_el = child(inser, "CSV")
        json_el = child(inser, "JSON")
        if csv_el is not None:
            req.input_format = "CSV"
            fhi = (child_text(csv_el, "FileHeaderInfo") or "NONE").upper()
            if fhi not in ("NONE", "USE", "IGNORE"):
                raise SelectError(
                    "InvalidFileHeaderInfo", f"bad FileHeaderInfo {fhi}"
                )
            req.csv_args = csvio.CSVArgs(
                file_header_info=fhi,
                record_delimiter=child_text(csv_el, "RecordDelimiter")
                or "\n",
                field_delimiter=child_text(csv_el, "FieldDelimiter") or ",",
                quote_character=child_text(csv_el, "QuoteCharacter")
                or '"',
                quote_escape_character=child_text(
                    csv_el, "QuoteEscapeCharacter"
                )
                or '"',
                comments=child_text(csv_el, "Comments"),
            )
        elif json_el is not None:
            req.input_format = "JSON"
            jt = (child_text(json_el, "Type") or "LINES").upper()
            if jt not in ("LINES", "DOCUMENT"):
                raise SelectError("InvalidJsonType", f"bad Type {jt}")
            req.json_args = jsonio.JSONArgs(jt)
        elif child(inser, "Parquet") is not None:
            req.input_format = "PARQUET"
            if req.compression != "NONE":
                # parquet compression lives inside the pages, not
                # around the stream (select.go parquet branch)
                raise SelectError(
                    "InvalidRequestParameter",
                    "CompressionType must be NONE for Parquet",
                )
        else:
            raise SelectError(
                "InvalidDataSource", "CSV or JSON input required"
            )

        outser = child(root, "OutputSerialization")
        if outser is not None:
            ocsv = child(outser, "CSV")
            ojson = child(outser, "JSON")
            if ocsv is not None:
                req.output_format = "CSV"
                qf = (child_text(ocsv, "QuoteFields") or "ASNEEDED").upper()
                if qf not in ("ASNEEDED", "ALWAYS"):
                    raise SelectError(
                        "InvalidQuoteFields", f"bad QuoteFields {qf}"
                    )
                req.csv_writer_args = {
                    "record_delimiter": child_text(ocsv, "RecordDelimiter")
                    or "\n",
                    "field_delimiter": child_text(ocsv, "FieldDelimiter")
                    or ",",
                    "quote_character": child_text(ocsv, "QuoteCharacter")
                    or '"',
                    "quote_fields": qf,
                }
            elif ojson is not None:
                req.output_format = "JSON"
                req.json_writer_args = {
                    "record_delimiter": child_text(ojson, "RecordDelimiter")
                    or "\n",
                }
        if not req.output_format:
            # parquet is input-only; its records default to JSON out
            req.output_format = (
                "JSON"
                if req.input_format == "PARQUET"
                else req.input_format
            )
        prog = child(root, "RequestProgress")
        if prog is not None:
            req.progress = (
                child_text(prog, "Enabled").lower() == "true"
            )
        return req


class S3Select:
    """One select evaluation over an object byte stream; the device
    engine's kernels run on ``device``."""

    def __init__(self, request: SelectRequest, device="cuda"):
        self.req = request
        self.device = device
        try:
            self.stmt = sql.parse(request.expression)
        except sql.SQLError as e:
            raise SelectError(e.code, str(e)) from None

    def _decompress(self, stream):
        if self.req.compression == "GZIP":
            return gzip.GzipFile(fileobj=stream, mode="rb")
        if self.req.compression == "BZIP2":
            return bz2.BZ2File(stream, mode="rb")
        return stream

    def _records(self, stream):
        if self.req.input_format == "CSV":
            return csvio.read_records(stream, self.req.csv_args)
        if self.req.input_format == "PARQUET":
            from . import parquetio

            return parquetio.read_records(stream)
        return jsonio.read_records(stream, self.req.json_args)

    def _writer(self):
        if self.req.output_format == "CSV":
            return csvio.CSVWriter(**self.req.csv_writer_args)
        return jsonio.JSONWriter(**self.req.json_writer_args)

    def device_capable(self) -> bool:
        """True when this statement could run on the device engine
        against a device-resident byte plane (the cache-tier scan
        source): CSV in, no decompression, mode allows, and both the
        host fast path and the screen compiler accept the shape."""
        from . import device

        return (
            device.select_mode() in ("auto", "device")
            and self.req.input_format == "CSV"
            and self.req.compression == "NONE"
            and vector.eligible(self.stmt, self.req)
            and device.device_eligible(self.stmt, self.req)
        )

    def evaluate(
        self, stream, scanned_bytes: int, emit, device_source=None
    ) -> None:
        """Run the query; ``emit(frame_bytes)`` receives EventStream
        frames ready for the wire.  ``scanned_bytes`` is the stored
        object size (BytesScanned in Stats)."""
        stmt = self.stmt
        writer = self._writer()
        returned = 0
        batch = bytearray()
        # SELECT * rows carry reader-internal aliases (_N shadows of
        # named CSV columns, dotted JSON child paths) that projected
        # records never have - clean them per input format
        if self.req.input_format == "CSV":
            clean = csvio.clean_raw_row
        elif self.req.input_format == "PARQUET":
            from . import parquetio

            clean = parquetio.clean_raw_row
        else:
            clean = jsonio.clean_raw_row

        def flush():
            nonlocal returned
            while batch:
                part = bytes(batch[:BATCH_BYTES])
                del batch[:BATCH_BYTES]
                emit(message.records_message(part))
                returned += len(part)

        def sink(payload: bytes):
            batch.extend(payload)
            if len(batch) >= BATCH_BYTES:
                flush()

        from . import device

        def _stream():
            # host engines read a byte stream; a device-resident plane
            # reaches them through the drain seam exactly once
            if stream is not None:
                return stream
            return io.BytesIO(device.drain_plane(*device_source))

        mode = device.select_mode()
        try:
            if mode != "row" and vector.json_eligible(stmt, self.req):
                # flat JSON-lines aggregates: regex column extraction
                # + the same mask algebra as the CSV columnar scan
                device.STATS.request("host")
                vector.FastJSONScan(stmt, self.req).run(
                    self._decompress(_stream())
                )
            elif mode != "row" and vector.eligible(stmt, self.req):
                if mode in ("auto", "device") and device.device_eligible(
                    stmt, self.req
                ):
                    # device pre-filter: conservative SWAR screen on
                    # the word planes, exact host re-filter of the
                    # candidate rows (s3select/device.py)
                    device.STATS.request("device")
                    scan = device.DeviceScan(
                        stmt, self.req, writer, clean, sink, self.device
                    )
                else:
                    # columnar scan: numpy masks instead of per-row
                    # eval, with exact row-engine fallback per chunk
                    device.STATS.request("host")
                    scan = vector.FastScan(
                        stmt, self.req, writer, clean, sink
                    )
                if device_source is not None and isinstance(
                    scan, device.DeviceScan
                ):
                    scan.run_device(*device_source)
                else:
                    scan.run(self._decompress(_stream()))
            else:
                device.STATS.request("row")
                records = self._records(self._decompress(_stream()))
                matched = 0
                for row in records:
                    if (
                        stmt.limit is not None
                        and not stmt.is_aggregate
                        and matched >= stmt.limit
                    ):
                        break
                    if not stmt.matches(row):
                        continue
                    if stmt.is_aggregate:
                        stmt.accumulate(row)
                        continue
                    out = stmt.project(row)
                    if stmt.projections is None:
                        out = clean(out)
                    batch.extend(writer.serialize(out))
                    if len(batch) >= BATCH_BYTES:
                        flush()
                    matched += 1
                    if stmt.limit is not None and matched >= stmt.limit:
                        break
            if stmt.is_aggregate:
                batch.extend(writer.serialize(stmt.aggregate_result()))
            flush()
        except sql.SQLError as e:
            raise SelectError(e.code, str(e)) from None
        except (OSError, EOFError) as e:
            raise SelectError(
                "InternalError", f"object read failed: {e}"
            ) from None
        if self.req.progress:
            emit(
                message.progress_message(
                    scanned_bytes, scanned_bytes, returned
                )
            )
        device.STATS.io(scanned_bytes, returned)
        emit(message.stats_message(scanned_bytes, scanned_bytes, returned))
        emit(message.end_message())


def run_select(body: bytes, data: bytes, emit, device="cuda") -> None:
    """Convenience: parse request, evaluate over in-memory bytes."""
    req = SelectRequest.from_xml(body)
    S3Select(req, device).evaluate(io.BytesIO(data), len(data), emit)
