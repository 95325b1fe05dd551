"""AWS EventStream binary framing for SelectObjectContent responses
(pkg/s3select/message.go).

Frame layout:
  total_length  uint32 BE
  headers_len   uint32 BE
  prelude_crc   uint32 BE  (CRC32 of the first 8 bytes)
  headers       [name_len u8][name][type u8=7][value_len u16 BE][value]...
  payload
  message_crc   uint32 BE  (CRC32 of everything above)
"""

from __future__ import annotations

import struct
import zlib

_HDR_STRING = 7


def _headers(pairs: "list[tuple[str, str]]") -> bytes:
    out = bytearray()
    for name, value in pairs:
        nb, vb = name.encode(), value.encode()
        out.append(len(nb))
        out += nb
        out.append(_HDR_STRING)
        out += struct.pack(">H", len(vb))
        out += vb
    return bytes(out)


def frame(pairs: "list[tuple[str, str]]", payload: bytes = b"") -> bytes:
    headers = _headers(pairs)
    total = 12 + len(headers) + len(payload) + 4
    prelude = struct.pack(">II", total, len(headers))
    prelude += struct.pack(">I", zlib.crc32(prelude))
    body = prelude + headers + payload
    return body + struct.pack(">I", zlib.crc32(body))


def records_message(payload: bytes) -> bytes:
    return frame(
        [
            (":message-type", "event"),
            (":event-type", "Records"),
            (":content-type", "application/octet-stream"),
        ],
        payload,
    )


def continuation_message() -> bytes:
    return frame(
        [(":message-type", "event"), (":event-type", "Cont")]
    )


def _stats_xml(scanned: int, processed: int, returned: int) -> bytes:
    return (
        '<?xml version="1.0" encoding="UTF-8"?><Stats>'
        f"<BytesScanned>{scanned}</BytesScanned>"
        f"<BytesProcessed>{processed}</BytesProcessed>"
        f"<BytesReturned>{returned}</BytesReturned></Stats>"
    ).encode()


def progress_message(scanned: int, processed: int, returned: int) -> bytes:
    return frame(
        [
            (":message-type", "event"),
            (":event-type", "Progress"),
            (":content-type", "text/xml"),
        ],
        (
            '<?xml version="1.0" encoding="UTF-8"?><Progress>'
            f"<BytesScanned>{scanned}</BytesScanned>"
            f"<BytesProcessed>{processed}</BytesProcessed>"
            f"<BytesReturned>{returned}</BytesReturned></Progress>"
        ).encode(),
    )


def stats_message(scanned: int, processed: int, returned: int) -> bytes:
    return frame(
        [
            (":message-type", "event"),
            (":event-type", "Stats"),
            (":content-type", "text/xml"),
        ],
        _stats_xml(scanned, processed, returned),
    )


def end_message() -> bytes:
    return frame([(":message-type", "event"), (":event-type", "End")])


def error_message(code: str, message: str) -> bytes:
    return frame(
        [
            (":message-type", "error"),
            (":error-code", code),
            (":error-message", message),
        ]
    )


# -- decoding (for tests / client-side) ----------------------------------


def decode_all(data: bytes) -> "list[dict]":
    """Parse a concatenated EventStream byte string into messages:
    [{"headers": {..}, "payload": b".."}]."""
    out = []
    pos = 0
    while pos < len(data):
        if len(data) - pos < 16:
            raise ValueError("truncated prelude")
        total, hlen = struct.unpack_from(">II", data, pos)
        pcrc = struct.unpack_from(">I", data, pos + 8)[0]
        if zlib.crc32(data[pos:pos + 8]) != pcrc:
            raise ValueError("prelude CRC mismatch")
        frame_bytes = data[pos:pos + total]
        mcrc = struct.unpack_from(">I", data, pos + total - 4)[0]
        if zlib.crc32(frame_bytes[:-4]) != mcrc:
            raise ValueError("message CRC mismatch")
        hdrs = {}
        hpos = pos + 12
        hend = hpos + hlen
        while hpos < hend:
            nlen = data[hpos]
            hpos += 1
            name = data[hpos:hpos + nlen].decode()
            hpos += nlen
            vtype = data[hpos]
            hpos += 1
            if vtype != _HDR_STRING:
                raise ValueError(f"unsupported header type {vtype}")
            vlen = struct.unpack_from(">H", data, hpos)[0]
            hpos += 2
            hdrs[name] = data[hpos:hpos + vlen].decode()
            hpos += vlen
        payload = data[hend:pos + total - 4]
        out.append({"headers": hdrs, "payload": payload})
        pos += total
    return out
