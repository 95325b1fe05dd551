"""Streaming JSON record reader/writer for S3 Select
(pkg/s3select/json/reader.go; Type=DOCUMENT|LINES).

Nested objects flatten onto dotted paths (a.b.c) so the SQL column
model stays flat, mirroring how the reference's jstream record exposes
nested access.
"""

from __future__ import annotations

import json

from .sql import MISSING, SQLError, to_json_value


class JSONArgs:
    def __init__(self, json_type: str = "LINES"):
        self.json_type = (json_type or "LINES").upper()
        if self.json_type not in ("LINES", "DOCUMENT"):
            raise SQLError("bad Json Type", "InvalidJsonType")


def _flatten(obj, prefix: str, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            out[path] = _scalarize(v)
            _flatten(v, path, out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            path = f"{prefix}.{i}" if prefix else str(i)
            out[path] = _scalarize(v)
            _flatten(v, path, out)


def _scalarize(v):
    """Lists/dicts stay as structured values for output; scalars pass."""
    return v


def _record(obj) -> dict:
    if not isinstance(obj, dict):
        return {"_1": obj}
    out: dict = {}
    _flatten(obj, "", out)
    return out


def read_records(stream, args: JSONArgs):
    """Yield row dicts from a binary stream of JSON."""
    if args.json_type == "DOCUMENT":
        try:
            doc = json.load(stream)
        except ValueError as e:
            raise SQLError(f"bad JSON: {e}", "InvalidTextEncoding") from None
        if isinstance(doc, list):
            for item in doc:
                yield _record(item)
        else:
            yield _record(doc)
        return
    # LINES: one JSON value per line (blank lines skipped)
    for line in stream:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError as e:
            raise SQLError(
                f"bad JSON line: {e}", "InvalidTextEncoding"
            ) from None
        yield _record(obj)


class JSONWriter:
    """OutputSerialization.JSON serializer (one object per record)."""

    def __init__(self, record_delimiter: str = "\n"):
        self.rd = record_delimiter or "\n"

    def serialize(self, record: dict) -> bytes:
        """Emit every key as-is (projected records are intentional;
        SELECT * rows are cleaned by the engine first)."""
        clean = {
            k: to_json_value(v)
            for k, v in record.items()
            if v is not MISSING
        }
        return (json.dumps(clean, default=str) + self.rd).encode()


def clean_raw_row(row: dict) -> dict:
    """SELECT * cleanup for JSON rows: emit the document's top-level
    keys only (flattened dotted child paths are internal)."""
    return {k: v for k, v in row.items() if "." not in k}
