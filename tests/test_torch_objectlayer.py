"""The port's object layer held against minio_tpu's, end to end.

The same payloads are PUT through minio_tpu_torch's ErasureObjects
(device="cpu": the plain PyTorch versions of the kernels) and through
minio_tpu's, each over 12 temp-dir disks at EC 8+4.  The shard files
must be byte-identical and xl.meta equal up to mod time, data dir and
version ids; GETs must agree healthy, ranged and with 4 disks offline
(data-shard disks among them, so reconstruct runs).  The on-disk format
is this system's state, so each package also reads what the other
wrote.
"""

import io
import shutil

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer import api
from minio_tpu_torch.objectlayer.erasure_object import (
    ErasureObjects,
    from_reference_disks,
)
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 12, 4
BLOCK = 32 * 1024  # 1,024 words per shard: the pack leg runs
# 5.5 blocks span two decode batches of 4: the read-ahead path runs
SIZES = {
    "empty": 0, "byte": 1, "block": BLOCK, "blocks3_5": BLOCK * 7 // 2,
    "blocks5_5": BLOCK * 11 // 2,
}
# offline: the disks holding shards 1 and 3 (data) and 10, 12 (parity)
DEAD_SHARDS = (1, 3, 10, 12)


def _payload(size: int) -> bytes:
    return np.random.default_rng(size).bytes(size)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("sets")
        troots = [str(base / f"port{i}") for i in range(N)]
        jroots = [str(base / f"jax{i}") for i in range(N)]
        port = ErasureObjects(
            [XLStorage(r) for r in troots], parity_blocks=M,
            block_size=BLOCK, device="cpu",
        )
        ref = JaxObjects(
            [JaxStorage(r) for r in jroots], parity_blocks=M, block_size=BLOCK
        )
        port.make_bucket("bkt")
        ref.make_bucket("bkt")
        for name, size in SIZES.items():
            data = _payload(size)
            port.put_object("bkt", name, io.BytesIO(data), size)
            ref.put_object("bkt", name, io.BytesIO(data), size)
        yield port, ref, troots, jroots
        jbackend.reset_backend()
        tbackend.reset_backend()


def _get(ol, name, **kw) -> bytes:
    buf = io.BytesIO()
    ol.get_object("bkt", name, buf, **kw)
    return buf.getvalue()


def _part(root: str, name: str) -> bytes:
    fi = XLStorage(root).read_version("bkt", name)
    path = f"{root}/bkt/{name}/{fi.data_dir}/part.1"
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return b""


def _dead(roots, name) -> set:
    dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
    return {d for d in range(N) if dist[d] in DEAD_SHARDS}


def _meta_doc(root: str, name: str) -> list:
    raw = open(f"{root}/bkt/{name}/xl.meta", "rb").read()
    out = []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_shard_files_identical(sets, name):
    _port, _ref, troots, jroots = sets
    for t, j in zip(troots, jroots):
        assert _part(t, name) == _part(j, name)


@pytest.mark.parametrize("name", list(SIZES))
def test_xl_meta_equal(sets, name):
    _port, _ref, troots, jroots = sets
    for t, j in zip(troots, jroots):
        assert _meta_doc(t, name) == _meta_doc(j, name)


@pytest.mark.parametrize("name", list(SIZES))
def test_get_healthy(sets, name):
    port, ref, _t, _j = sets
    body = _get(port, name)
    assert body == _payload(SIZES[name]) == _get(ref, name)
    info = port.get_object_info("bkt", name)
    assert info.size == SIZES[name]
    assert info.etag == ref.get_object_info("bkt", name).etag


@pytest.mark.parametrize("offset,length", [(0, 1), (5, 100), (BLOCK - 3, 7000)])
def test_get_range(sets, offset, length):
    port, ref, _t, _j = sets
    want = _payload(SIZES["blocks3_5"])[offset : offset + length]
    got = _get(port, "blocks3_5", offset=offset, length=length)
    assert got == want == _get(ref, "blocks3_5", offset=offset, length=length)


@pytest.mark.parametrize("name", ["byte", "block", "blocks3_5", "blocks5_5"])
def test_get_degraded(sets, name):
    _port, ref, troots, _j = sets
    dead = _dead(troots, name)
    assert len(dead) == 4
    degraded = from_reference_disks(
        [None if d in dead else r for d, r in enumerate(troots)],
        parity_blocks=M, block_size=BLOCK, device="cpu",
    )
    KERNEL_STATS.reset()
    body = _get(degraded, name)
    assert body == _payload(SIZES[name]) == _get(ref, name)
    assert KERNEL_STATS.snapshot()["device_passes"]["reconstruct_words_batch"] >= 1


@pytest.mark.parametrize("degraded", [False, True])
def test_port_reads_reference_objects(sets, degraded):
    _port, _ref, _t, jroots = sets
    for name, size in SIZES.items():
        dead = _dead(jroots, name) if degraded and size else set()
        ol = from_reference_disks(
            [None if d in dead else r for d, r in enumerate(jroots)],
            parity_blocks=M, block_size=BLOCK, device="cpu",
        )
        assert _get(ol, name) == _payload(size)


@pytest.mark.parametrize("degraded", [False, True])
def test_reference_reads_port_objects(sets, degraded):
    _port, _ref, troots, _j = sets
    for name, size in SIZES.items():
        dead = _dead(troots, name) if degraded and size else set()
        ol = JaxObjects(
            [None if d in dead else JaxStorage(r) for d, r in enumerate(troots)],
            parity_blocks=M, block_size=BLOCK,
        )
        assert _get(ol, name) == _payload(size)


def test_parity_plane_off_writes_the_same_files(sets, tmp_path, monkeypatch):
    """MINIO_TPU_PARITY_PLANE=off: the eager encode readback instead of
    the device-resident plane, same shard files."""
    _port, _ref, troots, _j = sets
    monkeypatch.setenv("MINIO_TPU_PARITY_PLANE", "off")
    roots = [str(tmp_path / f"d{i}") for i in range(N)]
    ol = from_reference_disks(roots, parity_blocks=M, block_size=BLOCK, device="cpu")
    ol.make_bucket("bkt")
    data = _payload(SIZES["blocks3_5"])
    ol.put_object("bkt", "blocks3_5", io.BytesIO(data), len(data))
    for r, t in zip(roots, troots):
        assert _part(r, "blocks3_5") == _part(t, "blocks3_5")


def test_overwrite_and_delete(tmp_path):
    roots = [str(tmp_path / f"d{i}") for i in range(N)]
    ol = from_reference_disks(roots, parity_blocks=M, block_size=BLOCK, device="cpu")
    ol.make_bucket("bkt")
    ol.put_object("bkt", "k", io.BytesIO(b"first"), 5)
    ol.put_object("bkt", "k", io.BytesIO(b"second!"), 7)
    assert _get(ol, "k") == b"second!"
    ol.delete_object("bkt", "k")
    with pytest.raises(api.ObjectNotFound):
        ol.get_object_info("bkt", "k")
    with pytest.raises(api.BucketExists):
        ol.make_bucket("bkt")


def test_unported_features_raise(sets, tmp_path, monkeypatch):
    """Compression and SSE (slice 8) and the early parity ack (slice 11)
    are served as the JAX package serves them (the name is kept from
    when they raised)."""
    port, ref, troots, jroots = sets
    data = b"x" * 8192
    port.put_object("bkt", "z", io.BytesIO(data), 8192, compress=True)
    ref.put_object("bkt", "z", io.BytesIO(data), 8192, compress=True)
    for t, j in zip(troots, jroots):
        assert _part(t, "z") == _part(j, "z")
        assert _meta_doc(t, "z") == _meta_doc(j, "z")
    assert _get(port, "z") == data
    assert port.get_object_info("bkt", "z").size == 8192
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    # an object the JAX package stores uncompressed (under 4 KiB) is
    # stored plain; one it would compress is compressed
    assert port.put_object("bkt", "z", io.BytesIO(b"x"), 1).size == 1
    assert "x-internal-compression" not in _meta_doc(troots[0], "z")[0]["metadata"]
    port.put_object("bkt", "z.txt", io.BytesIO(data), 8192)
    assert _meta_doc(troots[0], "z.txt")[0]["metadata"][
        "x-internal-compression"] == "deflate/v1"
    assert _get(port, "z.txt") == data
    monkeypatch.delenv("MINIO_TPU_COMPRESS")
    # SSE-C: stored sealed, read back with the key only
    from minio_tpu_torch.codec import sse as tsse

    key = bytes(range(32))
    port.put_object("bkt", "enc", io.BytesIO(data), 8192,
                    sse=tsse.SSESpec("C", key))
    assert _get(port, "enc", sse=tsse.SSESpec("C", key)) == data
    with pytest.raises(tsse.SSEError):
        _get(port, "enc")
    # heal is ported: a shard lost on one disk comes back byte-identical
    d = sorted(_dead(troots, "block"))[0]
    before = _part(troots[d], "block")
    shard = XLStorage(troots[d]).read_version("bkt", "block").erasure.index - 1
    shutil.rmtree(f"{troots[d]}/bkt/block")
    assert port.heal_object("bkt", "block")["healed"] == [shard]
    assert _part(troots[d], "block") == before
    # the early parity ack is served: the PUT acks at data-shard quorum
    # and reads back; its band settles the parity shards behind the ack
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "early")
    port.put_object("bkt", "z", io.BytesIO(b"x"), 1)
    assert _get(port, "z") == b"x"
    monkeypatch.delenv("MINIO_TPU_PARITY_ACK")
    # an object the JAX package stored compressed is read, not refused
    jroots2 = [str(tmp_path / f"c{i}") for i in range(N)]
    ref2 = JaxObjects([JaxStorage(r) for r in jroots2], parity_blocks=M,
                      block_size=BLOCK)
    ref2.make_bucket("bkt")
    ref2.put_object("bkt", "c", io.BytesIO(b"a" * 8192), 8192, compress=True)
    ol = from_reference_disks(jroots2, parity_blocks=M, block_size=BLOCK,
                              device="cpu")
    assert _get(ol, "c") == b"a" * 8192
    assert _get(ol, "c", offset=4000, length=100) == b"a" * 100


# MINIO_TPU_COMPRESS=on: (name, content-type, size) the JAX package stores
# uncompressed - under MIN_COMPRESS_SIZE, an excluded extension, an
# excluded type - so the port stores them identically
UNCOMPRESSED = [
    ("small-1k", "", 1024), ("photo.jpg", "", 3 * BLOCK // 2),
    ("blob", "image/png", 3 * BLOCK // 2),
]


@pytest.mark.parametrize("name,ctype,size", UNCOMPRESSED,
                         ids=[u[0] for u in UNCOMPRESSED])
def test_compress_on_stores_what_the_reference_stores_plain(
    sets, monkeypatch, name, ctype, size
):
    port, ref, troots, jroots = sets
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    data = _payload(size)
    meta = {"content-type": ctype} if ctype else None
    port.put_object("bkt", name, io.BytesIO(data), size, metadata=meta)
    ref.put_object("bkt", name, io.BytesIO(data), size, metadata=meta)
    for t, j in zip(troots, jroots):
        assert _part(t, name) == _part(j, name)
        assert _meta_doc(t, name) == _meta_doc(j, name)
    assert "x-internal-compression" not in str(_meta_doc(jroots[0], name))
    assert _get(port, name) == data


def test_compress_on_refuses_what_the_reference_compresses(
    sets, monkeypatch
):
    """MINIO_TPU_COMPRESS=on: what the JAX package compresses, the port
    now compresses too (the test keeps the name of the refusal it
    replaced): the same deflate part files and xl.meta on every disk,
    the client-visible size and a range read through the decompressor."""
    port, ref, troots, jroots = sets
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    size = 64 * 1024
    data = b"compressible text " * (size // 18) + b"x" * (size % 18)
    ref.put_object("bkt", "notes.txt", io.BytesIO(data), size)
    port.put_object("bkt", "notes.txt", io.BytesIO(data), size)
    assert "x-internal-compression" in str(_meta_doc(jroots[0], "notes.txt"))
    for t, j in zip(troots, jroots):
        assert _part(t, "notes.txt") == _part(j, "notes.txt")
        assert _meta_doc(t, "notes.txt") == _meta_doc(j, "notes.txt")
    assert len(_part(troots[0], "notes.txt")) < size // (N - M)
    assert port.get_object_info("bkt", "notes.txt").size == size
    assert _get(port, "notes.txt") == data
    assert _get(port, "notes.txt", offset=5000, length=300) == data[5000:5300]


def test_healthy_get_verifies_each_data_shard_once(monkeypatch):
    """The number of verify passes of a healthy GET depends on how the
    shard reads' completions fall into settle rounds (so the digest
    kernel's launch count varies from run to run), but every block's k
    data shards are hashed exactly once and parity is never read.
    Hedging is off: under a loaded host a slow read may otherwise hedge
    to a parity shard, which is the hedge working, not a second hash."""
    from minio_tpu_torch.codec.erasure import Erasure
    from minio_tpu_torch.storage import health

    monkeypatch.setenv("MINIO_TPU_HEDGE", "0")
    health.reset_registry()
    monkeypatch.setattr(health, "_REGISTRY", None)  # dropped at teardown

    class Shard:
        def __init__(self):
            self.buf = bytearray()

        def write(self, b):
            self.buf += bytes(b)

        def read_at(self, off, length):
            return bytes(self.buf[off : off + length])

    class Counting(tbackend.TorchBackend):
        calls = 0
        cells: "list" = []

        def verify(self, shards, digests):
            Counting.calls += 1
            Counting.cells.append(shards.shape[0] * shards.shape[1])
            return super().verify(shards, digests)

    er = Erasure(N - M, M, BLOCK)
    size = BLOCK * 11 // 2  # 6 blocks: groups of 4 full, 1 full + 1 tail
    shards = [Shard() for _ in range(N)]
    er.encode(io.BytesIO(_payload(size)), list(shards), N - M + 1,
              backend=tbackend.TorchBackend("cpu"))
    be = Counting("cpu")
    for _ in range(5):
        Counting.cells = []
        out = io.BytesIO()
        er.decode(out, list(shards), 0, size, size, backend=be)
        assert out.getvalue() == _payload(size)
        assert sum(Counting.cells) == 6 * (N - M)
    assert Counting.calls >= 5 * 3  # at least one round per block group


def test_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    disks = [XLStorage(str(tmp_path / f"d{i}")) for i in range(N)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ErasureObjects(disks, parity_blocks=M)
