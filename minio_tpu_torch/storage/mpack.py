"""A minimal MessagePack encoder/decoder for the xl.meta document.

Covers exactly the types xl.meta uses - dict, list/tuple, str, bytes,
int, float, bool and None - with the encoding choices of
``msgpack.packb(doc, use_bin_type=True)`` (smallest integer form,
str8 for 32..255-byte strings, bin family for bytes, float64 for
floats), so files stay byte-compatible with the JAX package without the
msgpack dependency.  ``unpackb`` mirrors ``msgpack.unpackb(raw=False)``:
str as str, bin as bytes, arrays as lists.
"""

from __future__ import annotations

import struct


class PackError(ValueError):
    pass


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        else:
            _pack_len(n, out, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, 0xC4, 0xC5, 0xC6)
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        else:
            _pack_len(n, out, None, 0xDC, 0xDD)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        else:
            _pack_len(n, out, None, 0xDE, 0xDF)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise PackError(f"cannot serialize {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, tag8, tag16, tag32) -> None:
    if tag8 is not None and n < 1 << 8:
        out.append(tag8)
        out.append(n)
    elif n < 1 << 16:
        out.append(tag16)
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(tag32)
        out += struct.pack(">I", n)
    else:
        raise PackError("object too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for tag, fmt, lim in (
            (0xCC, ">B", 1 << 8),
            (0xCD, ">H", 1 << 16),
            (0xCE, ">I", 1 << 32),
            (0xCF, ">Q", 1 << 64),
        ):
            if v < lim:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise PackError("integer too large")
    else:
        for tag, fmt, lim in (
            (0xD0, ">b", 1 << 7),
            (0xD1, ">h", 1 << 15),
            (0xD2, ">i", 1 << 31),
            (0xD3, ">q", 1 << 63),
        ):
            if v >= -lim:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise PackError("integer too small")


# fixed-width tags: tag -> (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def unpackb(raw: bytes):
    buf = memoryview(bytes(raw))
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise PackError(f"{len(buf) - pos} trailing bytes")
    return obj


def _take(buf, pos: int, n: int):
    end = pos + n
    if end > len(buf):
        raise PackError("truncated document")
    return buf[pos:end], end


def _length(buf, pos: int, size: int):
    chunk, pos = _take(buf, pos, size)
    return struct.unpack(_LEN[size], chunk)[0], pos


def _unpack(buf, pos: int):
    tag, pos = _take(buf, pos, 1)
    t = tag[0]
    if t < 0x80:
        return t, pos
    if t >= 0xE0:
        return t - 0x100, pos
    if 0xA0 <= t <= 0xBF:
        return _str(buf, pos, t & 0x1F)
    if 0x90 <= t <= 0x9F:
        return _array(buf, pos, t & 0x0F)
    if 0x80 <= t <= 0x8F:
        return _map(buf, pos, t & 0x0F)
    if t == 0xC0:
        return None, pos
    if t == 0xC2:
        return False, pos
    if t == 0xC3:
        return True, pos
    if t in _FIXED:
        fmt, size = _FIXED[t]
        chunk, pos = _take(buf, pos, size)
        return struct.unpack(fmt, chunk)[0], pos
    if t in (0xD9, 0xDA, 0xDB):
        n, pos = _length(buf, pos, {0xD9: 1, 0xDA: 2, 0xDB: 4}[t])
        return _str(buf, pos, n)
    if t in (0xC4, 0xC5, 0xC6):
        n, pos = _length(buf, pos, {0xC4: 1, 0xC5: 2, 0xC6: 4}[t])
        chunk, pos = _take(buf, pos, n)
        return bytes(chunk), pos
    if t in (0xDC, 0xDD):
        n, pos = _length(buf, pos, 2 if t == 0xDC else 4)
        return _array(buf, pos, n)
    if t in (0xDE, 0xDF):
        n, pos = _length(buf, pos, 2 if t == 0xDE else 4)
        return _map(buf, pos, n)
    raise PackError(f"unsupported msgpack tag 0x{t:02x}")


def _str(buf, pos: int, n: int):
    chunk, pos = _take(buf, pos, n)
    return bytes(chunk).decode("utf-8"), pos


def _array(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        value, pos = _unpack(buf, pos)
        if isinstance(key, (dict, list)):
            raise PackError("unhashable map key")
        out[key] = value
    return out, pos
