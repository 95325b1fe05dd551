"""Streaming CSV record reader/writer for S3 Select
(pkg/s3select/csv/reader.go + the RequestProgress CSV options).

Rows surface as dicts: header names when FileHeaderInfo=USE, positional
``_1.._N`` otherwise.
"""

from __future__ import annotations

import csv
import io

from .sql import to_output


class CSVArgs:
    """InputSerialization.CSV options (csv/args.go)."""

    def __init__(
        self,
        file_header_info: str = "NONE",  # NONE | USE | IGNORE
        record_delimiter: str = "\n",
        field_delimiter: str = ",",
        quote_character: str = '"',
        quote_escape_character: str = '"',
        comments: str = "",
    ):
        self.file_header_info = (file_header_info or "NONE").upper()
        self.record_delimiter = record_delimiter or "\n"
        self.field_delimiter = field_delimiter or ","
        self.quote_character = quote_character or '"'
        self.quote_escape_character = quote_escape_character or '"'
        self.comments = comments


def read_records(stream, args: CSVArgs):
    """Yield row dicts from a binary file-like object."""
    text = io.TextIOWrapper(stream, encoding="utf-8", newline="")
    rd = "\n" if args.record_delimiter in ("\n", "\r\n") else args.record_delimiter

    # quote-escape semantics: same char as the quote -> doubled quotes
    # (csv doublequote mode); a distinct char -> escapechar mode
    csv_opts = {
        "delimiter": args.field_delimiter,
        "quotechar": args.quote_character,
    }
    if args.quote_escape_character != args.quote_character:
        csv_opts["doublequote"] = False
        csv_opts["escapechar"] = args.quote_escape_character

    if rd != "\n":
        # uncommon delimiter: re-split manually, then parse each record
        data = text.read()
        lines = data.split(args.record_delimiter)
        if lines and lines[-1] == "":
            lines.pop()
        reader = csv.reader(lines, **csv_opts)
    else:
        reader = csv.reader(text, **csv_opts)

    header: "list[str] | None" = None
    mode = args.file_header_info
    # the header is the first NON-COMMENT record, not reader index 0
    header_pending = mode in ("USE", "IGNORE")
    for rec in reader:
        if args.comments and rec and rec[0].startswith(args.comments):
            continue
        if header_pending:
            if mode == "USE":
                header = [h.strip() for h in rec]
            header_pending = False
            continue
        row: dict = {}
        for j, v in enumerate(rec):
            row[f"_{j + 1}"] = v
            if header is not None and j < len(header):
                row[header[j]] = v
        yield row


class CSVWriter:
    """OutputSerialization.CSV record serializer."""

    def __init__(
        self,
        record_delimiter: str = "\n",
        field_delimiter: str = ",",
        quote_character: str = '"',
        quote_fields: str = "ASNEEDED",  # ASNEEDED | ALWAYS
    ):
        self.rd = record_delimiter or "\n"
        self.fd = field_delimiter or ","
        self.qc = quote_character or '"'
        self.always = (quote_fields or "ASNEEDED").upper() == "ALWAYS"

    def _field(self, s: str) -> str:
        needs = self.always or any(
            c in s for c in (self.fd, self.qc, "\n", "\r")
        )
        if needs:
            return self.qc + s.replace(self.qc, self.qc * 2) + self.qc
        return s

    def serialize(self, record: dict) -> bytes:
        """Emit every key as-is: projected records are fully
        intentional; SELECT * rows are cleaned by the engine first."""
        return (
            self.fd.join(
                self._field(to_output(v)) for v in record.values()
            )
            + self.rd
        ).encode()


def positional(k: str) -> bool:
    """Reader-minted positional alias (_1.._N)."""
    return k.startswith("_") and k[1:].isdigit()


def clean_raw_row(row: dict) -> dict:
    """SELECT * cleanup for CSV rows: when header names exist, emit
    them (file order) and drop the shadowing _N aliases."""
    named = {k: v for k, v in row.items() if not positional(k)}
    return named or row
