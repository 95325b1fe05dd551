"""CopyObject, metadata updates, version listing and the storage seams of
the port held against minio_tpu's, on the CPU.

The same objects, made from a numpy seed, go through minio_tpu_torch's
``ErasureObjects`` (``device="cpu"``) and minio_tpu's, each over its own
temp-dir disks at EC 4+2 with 4 KiB blocks.  Copies (streamed through
``utils.pipe`` from a multi-block, multi-part source, and the self-copy)
must leave the same part files and ``xl.meta`` up to volatile fields;
version listings must give the same pages once each package's own
random version ids are mapped to their place in the sequence; the
``XLStorage`` seams ``stat_file``, ``rename_file`` and
``update_metadata`` must act, and fail, alike on copies of one tree.
"""

from __future__ import annotations

import io
import os
import shutil
import threading
import time

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage import errors as jerrors
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu.utils import pipe as jpipe
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import api
from minio_tpu_torch.objectlayer.api import CompletePart
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage import errors as terrors
from minio_tpu_torch.storage.xl import XLStorage
from minio_tpu_torch.utils import pipe as tpipe
from tests.test_torch_multipart import _object, _pay
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 4096


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both object layers holding a single-part object of 5.5 blocks and
    a three-part object (parts of 3.x, 2 and a 17-byte tail)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("cv")
        troots = [str(base / f"port{i}") for i in range(N)]
        jroots = [str(base / f"jax{i}") for i in range(N)]
        port = ErasureObjects([XLStorage(r) for r in troots], parity_blocks=M,
                              block_size=BLOCK, device="cpu")
        ref = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=M,
                         block_size=BLOCK)
        single = _pay(BLOCK * 11 // 2, 7)
        parts = [_pay(3 * BLOCK + 5, 8), _pay(2 * BLOCK, 9), _pay(17, 10)]
        for ol, mod in ((port, api), (ref, japi)):
            ol.min_part_size = BLOCK
            ol.make_bucket("bkt")
            ol.make_bucket("dst")
            ol.put_object("bkt", "single", io.BytesIO(single), len(single),
                          {"content-type": "text/plain",
                           "x-amz-meta-a": "1"})
            uid = ol.new_multipart_upload(
                "bkt", "multi", {"x-amz-meta-b": "2"})
            done = [ol.put_object_part("bkt", "multi", uid, i + 1,
                                       io.BytesIO(p), len(p))
                    for i, p in enumerate(parts)]
            ol.complete_multipart_upload(
                "bkt", "multi", uid,
                [mod.CompletePart(p.part_number, p.etag) for p in done])
        yield port, ref, troots, jroots, single, b"".join(parts)
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.mark.parametrize("src,dst_bucket,dst,meta", [
    ("single", "dst", "copy-single", None),
    ("multi", "dst", "copy-multi", None),
    ("multi", "bkt", "copy-replace", {"content-type": "x/y",
                                      "x-amz-meta-c": "3"}),
    ("single", "bkt", "single", {"x-amz-meta-z": "self"}),
])
def test_copy_object(pair, src, dst_bucket, dst, meta):
    """Streamed copies and the self-copy leave the same files; the
    multi-part source becomes a single-part object."""
    port, ref, troots, jroots, single, multi = pair
    body = single if src == "single" else multi
    tinfo = port.copy_object("bkt", src, dst_bucket, dst, meta)
    jinfo = ref.copy_object("bkt", src, dst_bucket, dst, meta)
    assert tinfo.etag == jinfo.etag
    assert tinfo.user_defined == jinfo.user_defined
    for t, j in zip(troots, jroots):
        assert _object(t, dst, dst_bucket) == _object(j, dst, dst_bucket)
    buf = io.BytesIO()
    port.get_object(dst_bucket, dst, buf)
    assert buf.getvalue() == body


def test_copy_of_a_missing_source(pair):
    port, ref, *_ = pair
    with pytest.raises(api.ObjectNotFound):
        port.copy_object("bkt", "nope", "dst", "x")
    with pytest.raises(japi.ObjectNotFound):
        ref.copy_object("bkt", "nope", "dst", "x")


def test_copy_of_a_compressed_source_names_slice_8(tmp_path, monkeypatch):
    """A source the JAX package stored compressed is copied (slice 8;
    the test keeps the name of the refusal it replaced): the pipe
    carries the inflated bytes, the destination drops the source's
    transform markers, and the copy's files equal the JAX package's
    copy of the same source."""
    monkeypatch.setenv("MINIO_MESH", "0")
    roots = [str(tmp_path / f"d{i}") for i in range(N)]
    ref = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                     block_size=BLOCK)
    ref.make_bucket("bkt")
    ref.put_object("bkt", "c", io.BytesIO(b"a" * 8192), 8192, compress=True)
    port = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                          block_size=BLOCK, device="cpu")
    jroots = [str(tmp_path / f"j{i}") for i in range(N)]
    ref2 = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=M,
                      block_size=BLOCK)
    ref2.make_bucket("bkt")
    ref2.put_object("bkt", "c", io.BytesIO(b"a" * 8192), 8192, compress=True)
    tinfo = port.copy_object("bkt", "c", "bkt", "d")
    jinfo = ref2.copy_object("bkt", "c", "bkt", "d")
    assert tinfo.size == jinfo.size == 8192
    assert "x-internal-compression" not in tinfo.user_defined
    buf = io.BytesIO()
    port.get_object("bkt", "d", buf)
    assert buf.getvalue() == b"a" * 8192
    for r, j in zip(roots, jroots):
        assert _object(r, "d") == _object(j, "d")


def test_update_object_meta(pair):
    port, ref, troots, jroots, *_ = pair
    upd = {"x-amz-meta-a": None, "x-amz-meta-new": "v"}
    tinfo = port.update_object_meta("bkt", "single", upd)
    jinfo = ref.update_object_meta("bkt", "single", upd)
    assert tinfo.user_defined == jinfo.user_defined
    assert "x-amz-meta-a" not in tinfo.user_defined
    for t, j in zip(troots, jroots):
        assert _object(t, "single") == _object(j, "single")
    with pytest.raises(api.ObjectNotFound):
        port.update_object_meta("bkt", "nope", upd)
    with pytest.raises(japi.ObjectNotFound):
        ref.update_object_meta("bkt", "nope", upd)


def test_storage_info_and_has_versions(pair):
    port, ref, *_ = pair
    assert port.storage_info() == ref.storage_info() == {
        "disks": N, "online": N, "offline": 0, "data": N - M, "parity": M,
    }
    for ol in (port, ref):
        assert ol.has_object_versions("bkt", "single")
        assert not ol.has_object_versions("bkt", "nope")


# -- version listing --------------------------------------------------------


def _versioned_history(ol):
    """k1: two versions then a delete marker; k2: one version; k3: a
    null version; a/x under a prefix."""
    ol.make_bucket("ver")
    for key, body in (("k1", b"one"), ("k1", b"two!"), ("k2", b"x" * 5000),
                      ("a/x", b"ax")):
        ol.put_object("ver", key, io.BytesIO(body), len(body), versioned=True)
        time.sleep(0.002)  # distinct mod times order the journal
    ol.delete_object("ver", "k1", versioned=True)
    ol.put_object("ver", "k3", io.BytesIO(b"null"), 4)


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        base = tmp_path_factory.mktemp("ver")
        port = ErasureObjects(
            [XLStorage(str(base / f"p{i}")) for i in range(N)],
            parity_blocks=M, block_size=BLOCK, device="cpu")
        ref = JaxObjects([JaxStorage(str(base / f"j{i}")) for i in range(N)],
                         parity_blocks=M, block_size=BLOCK)
        for ol in (port, ref):
            _versioned_history(ol)
        yield port, ref


def _pages(ol, max_keys, delimiter="", prefix=""):
    """Every page to the end; each entry with its version id replaced by
    its place among the listing's ids (ids are random per package)."""
    pages, key_m, vid_m = [], "", ""
    ids: dict = {"null": "null"}
    while True:
        res = ol.list_object_versions("ver", prefix, key_m, vid_m,
                                      delimiter, max_keys)
        for v in res.versions:
            ids.setdefault(v.version_id, f"v{len(ids)}")
        pages.append((
            [(v.name, ids[v.version_id], v.is_latest, v.delete_marker,
              v.size, v.etag) for v in res.versions],
            list(res.prefixes), res.is_truncated,
            res.next_key_marker,
            ids.get(res.next_version_id_marker, res.next_version_id_marker),
        ))
        if not res.is_truncated or max_keys == 0:
            # max-keys 0 answers an empty, truncated page from any marker
            return pages
        key_m, vid_m = res.next_key_marker, res.next_version_id_marker
        assert len(pages) < 20


@pytest.mark.parametrize("max_keys,delimiter,prefix", [
    (1000, "", ""), (1, "", ""), (2, "", ""), (1, "/", ""), (3, "/", ""),
    (1000, "", "k"), (0, "", ""),
])
def test_list_object_versions_paged(versions, max_keys, delimiter, prefix):
    port, ref = versions
    got = _pages(port, max_keys, delimiter, prefix)
    assert got == _pages(ref, max_keys, delimiter, prefix)
    if max_keys == 1000 and not prefix:
        flat = got[0][0]
        # k1's delete marker is its latest entry, newest first
        k1 = [e for e in flat if e[0] == "k1"]
        assert [(e[2], e[3]) for e in k1] == [
            (True, True), (False, False), (False, False)]
        assert ("k3", "null", True, False, 4) == flat[-1][:5]


def test_version_marker_that_vanished(tmp_path, monkeypatch):
    """A page ends inside k1; k1's marker version is then deleted: the
    next page emits k1's remaining versions again, whole, in both."""
    monkeypatch.setenv("MINIO_MESH", "0")
    out = []
    for kind in ("port", "jax"):
        roots = [str(tmp_path / f"{kind}{i}") for i in range(N)]
        if kind == "port":
            ol = ErasureObjects([XLStorage(r) for r in roots],
                                parity_blocks=M, block_size=BLOCK,
                                device="cpu")
        else:
            ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                            block_size=BLOCK)
        _versioned_history(ol)
        first = ol.list_object_versions("ver", "", "", "", "", 2)
        assert first.is_truncated and first.next_key_marker == "k1"
        ol.delete_object("ver", "k1", first.next_version_id_marker)
        nxt = ol.list_object_versions(
            "ver", "", first.next_key_marker, first.next_version_id_marker,
            "", 1000)
        out.append([(v.name, v.delete_marker, v.size) for v in nxt.versions])
    assert out[0] == out[1]
    assert [e[0] for e in out[0]][:2] == ["k1", "k1"]


def test_list_object_versions_missing_bucket(versions):
    port, ref = versions
    with pytest.raises(api.BucketNotFound):
        port.list_object_versions("nobkt")
    with pytest.raises(japi.BucketNotFound):
        ref.list_object_versions("nobkt")


# -- storage seams ------------------------------------------------------------


@pytest.fixture
def trees(tmp_path):
    """One disk tree with an object, copied for each package."""
    src = tmp_path / "src"
    d = JaxStorage(str(src))
    d.make_vol("vol")
    d.write_all("vol", "dir/file", b"hello")
    ol = JaxObjects([JaxStorage(str(tmp_path / f"o{i}")) for i in range(N)],
                    parity_blocks=M, block_size=BLOCK)
    ol.make_bucket("vol")
    ol.put_object("vol", "obj", io.BytesIO(b"data"), 4)
    shutil.copytree(tmp_path / "o0" / "vol" / "obj", src / "vol" / "obj")
    shutil.copytree(src, tmp_path / "t")
    shutil.copytree(src, tmp_path / "j")
    return XLStorage(str(tmp_path / "t")), JaxStorage(str(tmp_path / "j"))


def _outcome(fn):
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("raise", type(e).__name__)
    return ("ok", r)


def _tree(root) -> list:
    out = []
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            out.append((os.path.relpath(p, root), open(p, "rb").read()))
    return out


@pytest.mark.parametrize("call", [
    lambda d: d.stat_file("vol", "dir/file"),
    lambda d: d.stat_file("vol", "dir"),
    lambda d: d.stat_file("vol", "missing"),
    lambda d: d.stat_file("novol", "dir/file"),
    lambda d: d.stat_file("vol", "../escape"),
    lambda d: d.rename_file("vol", "dir/file", "vol", "new/deep/file"),
    lambda d: d.rename_file("vol", "missing", "vol", "x"),
    lambda d: d.rename_file("vol", "dir/file", "novol", "x"),
    lambda d: d.rename_file("novol", "dir/file", "vol", "x"),
], ids=["stat_file", "stat_dir", "stat_missing", "stat_no_volume",
        "stat_escape", "rename", "rename_missing", "rename_no_dst_volume",
        "rename_no_src_volume"])
def test_storage_seams_alike(trees, call):
    tdisk, jdisk = trees
    tout, jout = _outcome(lambda: call(tdisk)), _outcome(lambda: call(jdisk))
    if tout[0] == "ok" and tout[1] is not None:
        # StatInfo: same size and kind; mod times belong to each copy
        assert (tout[1].size, tout[1].is_dir) == (jout[1].size, jout[1].is_dir)
    else:
        assert tout == jout
    assert _tree(tdisk.root) == _tree(jdisk.root)


def test_update_metadata_alike(trees):
    tdisk, jdisk = trees
    tfi = tdisk.read_version("vol", "obj")
    jfi = jdisk.read_version("vol", "obj")
    tfi.metadata = {**tfi.metadata, "x-amz-meta-q": "1"}
    jfi.metadata = {**jfi.metadata, "x-amz-meta-q": "1"}
    tdisk.update_metadata("vol", "obj", tfi)
    jdisk.update_metadata("vol", "obj", jfi)
    assert _tree(tdisk.root) == _tree(jdisk.root)
    # the object must exist: update never creates a journal
    assert _outcome(lambda: tdisk.update_metadata("vol", "none", tfi)) == (
        "raise", "FileNotFound")
    assert _outcome(lambda: jdisk.update_metadata("vol", "none", jfi)) == (
        "raise", "FileNotFound")
    assert terrors.FileNotFound.__name__ == jerrors.FileNotFound.__name__


def test_storage_seams_are_metered(tmp_path):
    """The new APIs are booked under the JAX package's ledger names."""
    port = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                          parity_blocks=M, block_size=BLOCK, device="cpu")
    port.make_bucket("bkt")
    uid = port.new_multipart_upload("bkt", "k")
    p = port.put_object_part("bkt", "k", uid, 1, io.BytesIO(b"x" * 100), 100)
    assert len(port.list_object_parts("bkt", "k", uid)) == 1
    port.complete_multipart_upload("bkt", "k", uid,
                                   [CompletePart(1, p.etag)])
    port.update_object_meta("bkt", "k", {"x-amz-meta-z": "1"})
    port.disks[0].stat_file("bkt", "k/xl.meta")
    stats = port.disks[0].api_stats()
    for name in ("rename_file", "stat_file", "update_metadata", "list_dir"):
        assert stats[name]["calls"] >= 1, name
    assert stats["rename_file"]["errors"] == 0


# -- streaming_copy -----------------------------------------------------------


@pytest.mark.parametrize("mod", [tpipe, jpipe], ids=["port", "jax"])
def test_streaming_copy_moves_every_byte(mod):
    data = _pay(3 * mod.CHUNK + 123, 3)

    def produce(sink):
        for off in range(0, len(data), 70_000):
            sink.write(data[off:off + 70_000])

    def consume(src):
        out = bytearray()
        while True:
            c = src.read(50_000)
            if not c:
                return bytes(out)
            out += c

    assert mod.streaming_copy(produce, consume) == data


@pytest.mark.parametrize("mod", [tpipe, jpipe], ids=["port", "jax"])
def test_streaming_copy_producer_error_reaches_the_consumer(mod):
    def produce(sink):
        sink.write(b"x" * 1000)
        raise RuntimeError("source vanished")

    def consume(src):
        while src.read(100):
            pass
        return "finished"

    with pytest.raises(OSError, match="pipe producer failed: source vanished"):
        mod.streaming_copy(produce, consume)


@pytest.mark.parametrize("mod", [tpipe, jpipe], ids=["port", "jax"])
def test_streaming_copy_consumer_error_cancels_the_producer(mod):
    """The consumer fails after one read: the producer, blocked on a
    full pipe, gets PipeClosed and its thread ends."""
    seen = {}
    done = threading.Event()

    def produce(sink):
        try:
            while True:
                sink.write(b"y" * mod.CHUNK)
        except mod.PipeClosed as e:
            seen["err"] = e
        finally:
            done.set()

    def consume(src):
        src.read(10)
        raise ValueError("disk full")

    with pytest.raises(ValueError, match="disk full"):
        mod.streaming_copy(produce, consume)
    assert done.wait(5)
    assert isinstance(seen["err"], mod.PipeClosed)


def test_copy_of_a_source_deleted_mid_copy(tmp_path, monkeypatch):
    """The reader thread's failure - the source gone after its info was
    read - becomes the same error of the copy in both packages, not a
    hang, and leaves no destination object."""
    monkeypatch.setenv("MINIO_MESH", "0")
    errs = []
    for kind in ("port", "jax"):
        roots = [str(tmp_path / f"{kind}{i}") for i in range(N)]
        if kind == "port":
            ol = ErasureObjects([XLStorage(r) for r in roots],
                                parity_blocks=M, block_size=BLOCK,
                                device="cpu")
            mod = api
        else:
            ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                            block_size=BLOCK)
            mod = japi
        ol.make_bucket("bkt")
        body = _pay(6 * BLOCK, 11)
        ol.put_object("bkt", "src", io.BytesIO(body), len(body))
        orig = ol.get_object_info

        def info_then_wipe(bucket, name, *a, _orig=orig, _roots=roots, **k):
            out = _orig(bucket, name, *a, **k)
            if name == "src":
                for r in _roots:
                    shutil.rmtree(f"{r}/bkt/src", ignore_errors=True)
            return out

        ol.get_object_info = info_then_wipe
        t0 = time.monotonic()
        with pytest.raises(Exception) as err:
            ol.copy_object("bkt", "src", "bkt", "dst")
        assert time.monotonic() - t0 < 30
        errs.append((type(err.value).__name__, str(err.value)))
        del ol.get_object_info
        with pytest.raises(mod.ObjectNotFound):
            ol.get_object_info("bkt", "dst")
    assert errs[0] == errs[1]
    assert "pipe producer failed" in errs[0][1]
