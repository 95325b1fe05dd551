"""The port's transparent compression held against minio_tpu's, on the CPU.

``CompressReader`` (raw deflate, level 1, ``wbits=-15``, 1 MiB reads)
must emit the same stream as minio_tpu's; ``DecompressWriter`` must
inflate at most 1 MiB at a time, skip to a range and stop with
``RangeSatisfied`` as minio_tpu's does.  The codec's decode stops paying
I/O once a skipping writer downstream has its range, and keeps the heal
verdict seen so far.  Through the object layers (EC 4+2 and EC 8+4,
``device="cpu"``) compressed part files and ``xl.meta`` are
bit-identical to minio_tpu's - deflate is deterministic, so no random
source needs pinning - and the ``compression`` config subsystem takes
effect on the next PUT.
"""

from __future__ import annotations

import hashlib
import io
import shutil

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec import compress as jcompress
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import compress as tcompress
from minio_tpu_torch.codec import erasure as terasure
from minio_tpu_torch.config.sys import ConfigSys
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_sse import _files, _meta_doc, _pay, _text
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 64 << 10


def _zeros(size: int, _seed: int) -> bytes:
    return bytes(size)


KINDS = {"text": _text, "random": _pay, "zeros": _zeros}
SIZES = [0, 1, 4096, (1 << 20) + 3, 3 << 20]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_compress_reader_matches_reference(kind, size):
    data = KINDS[kind](size, size)
    got = tcompress.CompressReader(io.BytesIO(data)).read()
    assert got == jcompress.CompressReader(io.BytesIO(data)).read()
    # pulled in codec-sized reads the stream is the same
    r = tcompress.CompressReader(io.BytesIO(data), chunk=1 << 20)
    pieces = []
    while True:
        piece = r.read(BLOCK)
        if not piece:
            break
        pieces.append(piece)
    assert b"".join(pieces) == got
    import zlib

    assert zlib.decompress(got, -15) == data


def _inflate(mod, stored, offset, length, feed=30_000):
    out = []

    class Sink:
        def write(self, b):
            out.append(bytes(b))

    w = mod.DecompressWriter(Sink(), offset, length)
    stopped = False
    try:
        for i in range(0, len(stored), feed):
            w.write(stored[i:i + feed])
    except mod.RangeSatisfied:
        stopped = True
    w.finish()
    return b"".join(out), stopped, max((len(b) for b in out), default=0)


RANGES = [(0, -1), (0, 1), (100, 1000), ((1 << 20) - 10, 20),
          ((3 << 20) - 17, 17), (5, 0)]


@pytest.mark.parametrize("offset,length", RANGES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_decompress_writer_matches_reference(kind, offset, length):
    data = KINDS[kind](3 << 20, 9)
    stored = jcompress.CompressReader(io.BytesIO(data)).read()
    got = _inflate(tcompress, stored, offset, length)
    assert got == _inflate(jcompress, stored, offset, length)
    end = len(data) if length < 0 else offset + length
    assert got[0] == data[offset:end]
    # inflation is bounded: no write carries more than 1 MiB
    assert got[2] <= 1 << 20


def test_zero_bomb_range_is_bounded():
    """A tiny range of a thousandfold-inflating stream materializes
    nothing near the plaintext."""
    stored = tcompress.CompressReader(io.BytesIO(bytes(8 << 20))).read()
    assert len(stored) < 64 << 10  # level 1 deflates zeros ~230x
    got, stopped, largest = _inflate(tcompress, stored, 100, 1000,
                                     feed=len(stored))
    assert got == bytes(1000) and largest <= 1 << 20
    assert not stopped  # one write held the whole stream


def test_strip_internal_meta():
    meta = {"x-internal-compression": "deflate/v1",
            "x-internal-actual-size": "9", "content-type": "t"}
    assert tcompress.strip_internal_meta(dict(meta)) == {"content-type": "t"}
    assert tcompress.strip_internal_meta(dict(meta)) == \
        jcompress.strip_internal_meta(dict(meta))
    assert (tcompress.ALGORITHM, tcompress.META_COMPRESSION,
            tcompress.META_ACTUAL_SIZE) == (
        jcompress.ALGORITHM, jcompress.META_COMPRESSION,
        jcompress.META_ACTUAL_SIZE)


@pytest.mark.parametrize("key,ctype,size", [
    ("logs/app.log", "text/plain", 1 << 20), ("data.csv", "", 1 << 20),
    ("movie.mp4", "", 1 << 30), ("photo.JPG", "", 1 << 20),
    ("x.bin", "video/mp4", 1 << 20), ("x.bin", "application/zip", 1 << 20),
    ("tiny.txt", "text/plain", 100), ("stream.txt", "text/plain", -1),
])
def test_should_compress_matches_reference(monkeypatch, key, ctype, size):
    for on in ("on", "off"):
        monkeypatch.setenv("MINIO_TPU_COMPRESS", on)
        assert tcompress.should_compress(key, ctype, size) == \
            jcompress.should_compress(key, ctype, size)


# -- the object layers -------------------------------------------------------


def _layers(tmp_path, n=6, m=2, block=BLOCK, tag=""):
    troots = [str(tmp_path / f"port{tag}{i}") for i in range(n)]
    jroots = [str(tmp_path / f"jax{tag}{i}") for i in range(n)]
    port = ErasureObjects([XLStorage(r) for r in troots], parity_blocks=m,
                          block_size=block, device="cpu")
    ref = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=m,
                     block_size=block)
    for ol in (port, ref):
        ol.make_bucket("bkt")
    return port, ref, troots, jroots


@pytest.fixture()
def fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _get(ol, name, offset=0, length=-1):
    buf = io.BytesIO()
    info = ol.get_object("bkt", name, buf, offset, length)
    return buf.getvalue(), info


@pytest.mark.parametrize("geometry", ["4+2", "8+4"])
@pytest.mark.parametrize("kind", ["text", "zeros"])
def test_compressed_part_files_bit_identical(tmp_path, fresh, monkeypatch,
                                             kind, geometry):
    k, m = map(int, geometry.split("+"))
    port, ref, troots, jroots = _layers(tmp_path, k + m, m)
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    data = KINDS[kind]((1 << 20) + 77, 5)
    tinfo = port.put_object("bkt", "doc.txt", io.BytesIO(data), len(data))
    jinfo = ref.put_object("bkt", "doc.txt", io.BytesIO(data), len(data))
    assert tinfo.size == jinfo.size == len(data)
    assert tinfo.etag == jinfo.etag == hashlib.md5(data).hexdigest()
    for t, j in zip(troots, jroots):
        assert _files(t, "doc.txt") == _files(j, "doc.txt")
        assert _meta_doc(t, "doc.txt") == _meta_doc(j, "doc.txt")
    fi = XLStorage(troots[0]).read_version("bkt", "doc.txt")
    assert fi.metadata["x-internal-actual-size"] == str(len(data))
    assert fi.size < len(data)
    assert _get(port, "doc.txt")[0] == data
    # ListObjects shows the client-visible size
    listed = port.list_objects("bkt")
    assert [(o.name, o.size) for o in listed.objects] == [
        ("doc.txt", len(data))]


def test_decode_stops_early_and_keeps_the_heal_verdict(tmp_path, fresh,
                                                       monkeypatch):
    """A short range of a compressed object decodes the first batches
    only (RangeSatisfied), and a shard missing on the way still flags
    the object for heal."""
    port, ref, troots, jroots = _layers(tmp_path)
    data = _pay(3 << 20, 17)  # incompressible: the stored stream is long
    port.put_object("bkt", "big", io.BytesIO(data), len(data), compress=True)
    batches = []
    real = terasure.Erasure._decode_blocks

    def counted(self, be, readers, idx, *a, **kw):
        batches.append(len(idx))
        return real(self, be, readers, idx, *a, **kw)

    monkeypatch.setattr(terasure.Erasure, "_decode_blocks", counted)
    assert _get(port, "big")[0] == data
    full = sum(batches)
    batches.clear()
    assert _get(port, "big", 10, 100)[0] == data[10:110]
    assert 0 < sum(batches) < full
    # a shard lost: the range read still flags the object for heal
    healed = []
    port.heal_hook = lambda b, o: healed.append((b, o))
    dist = XLStorage(troots[0]).read_version("bkt", "big").erasure.distribution
    victim = troots[dist.index(1)]  # the disk holding data shard 1
    shutil.rmtree(f"{victim}/bkt/big")
    body, info = _get(port, "big", 10, 100)
    assert body == data[10:110]
    assert info.user_defined.get("x-internal-heal-required") == "true"
    assert healed == [("bkt", "big")]


def test_compressed_ranges_and_cross_reads(tmp_path, fresh):
    port, ref, troots, jroots = _layers(tmp_path)
    data = _text(3 << 20, 19)
    for ol in (port, ref):
        ol.put_object("bkt", "t", io.BytesIO(data), len(data), compress=True)
    cross_port = ErasureObjects([XLStorage(r) for r in jroots], parity_blocks=2,
                                block_size=BLOCK, device="cpu")
    cross_ref = JaxObjects([JaxStorage(r) for r in troots], parity_blocks=2,
                           block_size=BLOCK)
    for off, ln in ((0, -1), (BLOCK - 5, 10), ((1 << 20) - 3, 70_000),
                    (len(data) - 17, 17)):
        want = data[off:] if ln < 0 else data[off:off + ln]
        for ol in (port, ref, cross_port, cross_ref):
            assert _get(ol, "t", off, ln)[0] == want


def test_compression_config_takes_effect_on_next_put(tmp_path, fresh,
                                                     monkeypatch):
    """``compression enable=on`` set through the config subsystem
    reaches the object layer's per-PUT decision; deleting the edit turns
    it off again."""
    monkeypatch.delenv("MINIO_TPU_COMPRESS", raising=False)
    port, _ref, troots, _j = _layers(tmp_path)
    cfg = ConfigSys()
    data = _text(1 << 16, 3)
    port.put_object("bkt", "before.txt", io.BytesIO(data), len(data))
    try:
        cfg.set_kvs("compression", {"enable": "on"})
        port.put_object("bkt", "during.txt", io.BytesIO(data), len(data))
    finally:
        cfg.del_kvs("compression")
    port.put_object("bkt", "after.txt", io.BytesIO(data), len(data))
    marks = {
        name: XLStorage(troots[0]).read_version("bkt", name).metadata.get(
            "x-internal-compression")
        for name in ("before.txt", "during.txt", "after.txt")
    }
    assert marks == {"before.txt": None, "during.txt": "deflate/v1",
                     "after.txt": None}
    for name in marks:
        assert _get(port, name)[0] == data
