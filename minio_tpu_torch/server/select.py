"""SelectObjectContent glue (cmd/object-handlers.go:91
SelectObjectContentHandler -> pkg/s3select).

Scans are the server's second admitted traffic class
(MINIO_TPU_SELECT_MAX_INFLIGHT, shed reason ``select``).  A
device-capable statement over an object whose groups all sit in the
read cache's device tier scans that device-resident plane where it lies
- zero shard reads, candidate rows only across D2H.  Everything else is
spooled through the normal erasure-decode read path (decompression/SSE
seams included) and evaluated by the select engines; a device-capable
statement then screens each chunk on the object layer's codec device,
or on the server's device where the layer has no codec (the FS mode and
the gateways; s3select/device.py).  Either way the EventStream frames are written as
one response.
"""

from __future__ import annotations

import io
import tempfile

from ..s3select import S3Select, SelectError
from ..s3select.engine import SelectRequest
from .s3errors import S3Error

# spool to disk past this size; select sources are usually small-ish
SPOOL_MEM = 16 << 20


class _SpoolReader(io.RawIOBase):
    """Readable adapter over SpooledTemporaryFile.

    Until Python 3.11 SpooledTemporaryFile does not implement the io
    ABC probes (``readable()`` & co.), so handing the spool straight
    to the select engines blows up inside their TextIOWrapper."""

    def __init__(self, spool):
        self._spool = spool

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._spool.read(len(b))
        n = len(data)
        b[:n] = data
        return n


def _spool_reader(spool):
    return spool if hasattr(spool, "readable") else _SpoolReader(spool)


def scan_device(server):
    """Where the server's select scans run: the codec device of its
    object layer (zones -> sets -> one erasure set), or, for a layer
    without a codec (the FS mode, the gateways, which spool the object
    first), the server's own device."""
    ol = server.object_layer
    while not hasattr(ol, "backend"):
        if hasattr(ol, "zones"):
            ol = ol.zones[0]
        elif hasattr(ol, "sets"):
            ol = ol.sets[0]
        else:
            return server.device
    return ol.backend.device


def _device_source(handler, bucket, key, sel):
    """(plane, nbytes) when the object layer holds this object as a
    device-resident plane (a cache tier's ``device_scan_source``) and
    the statement can scan it there, else None.  It only decides
    whether such a source exists: the scan itself runs outside it."""
    if not sel.device_capable():
        return None
    fn = getattr(handler.s3.object_layer, "device_scan_source", None)
    if fn is None:
        return None
    return fn(bucket, key)


def handle_select(handler, bucket, key, info, body) -> None:
    try:
        req = SelectRequest.from_xml(body)
        sel = S3Select(req, scan_device(handler.s3))
    except SelectError as e:
        raise S3Error(
            e.code if e.code in _KNOWN else "InvalidRequestParameter",
            e.msg,
        ) from None
    adm = getattr(handler.s3, "admission", None)
    if adm is not None:
        if not adm.try_enter_select():
            adm.stats.shed_inc("select")
            raise S3Error("OperationMaxedOut", "scan capacity reached")
    try:
        _run_select(handler, bucket, key, info, sel)
    finally:
        if adm is not None:
            adm.leave_select()


def _run_select(handler, bucket, key, info, sel) -> None:
    with tempfile.SpooledTemporaryFile(max_size=SPOOL_MEM) as spool, \
            tempfile.SpooledTemporaryFile(max_size=SPOOL_MEM) as out:
        src = _device_source(handler, bucket, key, sel)
        try:
            if src is not None:
                # the scan runs where the plane lies (the cache tier's
                # device); result frames spool either way: a huge
                # SELECT * result must not live in RAM
                sel.device = src[0].device
                sel.evaluate(
                    None, info.size, out.write, device_source=src
                )
            else:
                # full-object read through the erasure/SSE/compression
                # stack.  SSE-C objects are selectable with their key
                # (the reference routes select reads through
                # getObjectNInfo, which decrypts)
                handler.s3.object_layer.get_object(
                    bucket, key, spool, sse=handler._read_sse(info)
                )
                spool.seek(0)
                sel.evaluate(_spool_reader(spool), info.size, out.write)
        except SelectError as e:
            raise S3Error(
                e.code if e.code in _KNOWN else "InvalidRequestParameter",
                e.msg,
            ) from None
        total = out.tell()
        out.seek(0)
        handler.send_response(200)
        handler.send_header("Server", "MinIO-TPU")
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(total))
        handler.end_headers()
        while True:
            chunk = out.read(1 << 20)
            if not chunk:
                break
            handler.wfile.write(chunk)
            handler._resp_bytes += len(chunk)


def _known_codes():
    from . import s3errors

    return frozenset(s3errors._E)


_KNOWN = _known_codes()
