"""The port's multipart uploads held against minio_tpu's, on the CPU.

The same parts, made from a numpy seed, go through minio_tpu_torch's
``ErasureObjects`` (``device="cpu"``: the plain PyTorch versions of the
kernels) and through minio_tpu's, each over its own temp-dir disks at
EC 4+2 (and one EC 8+4 case) with small blocks and a lowered
``min_part_size``.  Both packages place shard i of an object on the
same disk (the distribution is a hash of bucket/object), so the staged
``part.N`` files, the completed object's part files and ``xl.meta`` are
compared disk by disk: bytes equal, ``xl.meta`` and ``part.N.meta`` up to
mod times, data dirs and version ids.  Reads - healthy, ranged across
part boundaries, with m disks offline - and heal of a multipart object
must agree as well, and every error of the JAX mixin must be raised the
same way.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import types

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import api
from minio_tpu_torch.objectlayer.api import CompletePart
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 4096
MIN_PART = 2 * BLOCK
# three blocks and a ragged end, two blocks exactly, a 17-byte tail
PART_SIZES = (3 * BLOCK + 5, 2 * BLOCK, 17)


def _pay(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8
    ).tobytes()


def _parts(seed: int = 0, sizes=PART_SIZES) -> list:
    return [_pay(s, seed * 100 + i) for i, s in enumerate(sizes)]


def _mp_etag(parts: list) -> str:
    md5s = b"".join(hashlib.md5(p).digest() for p in parts)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"


class Pair:
    """The two object layers over their own disks, with the same calls."""

    def __init__(self, base, n=N, m=M, block=BLOCK, min_part=MIN_PART):
        self.troots = [str(base / f"port{i}") for i in range(n)]
        self.jroots = [str(base / f"jax{i}") for i in range(n)]
        self.port = ErasureObjects(
            [XLStorage(r) for r in self.troots], parity_blocks=m,
            block_size=block, device="cpu",
        )
        self.ref = JaxObjects(
            [JaxStorage(r) for r in self.jroots], parity_blocks=m,
            block_size=block,
        )
        self.port.min_part_size = self.ref.min_part_size = min_part
        self.n = n
        for ol in (self.port, self.ref):
            ol.make_bucket("bkt")

    def both(self, fn):
        return fn(self.port), fn(self.ref)

    def upload(self, key, parts, numbers=None, meta=None):
        """Initiate and upload ``parts`` on both; (port id, ref id,
        port PartInfos, ref PartInfos)."""
        numbers = numbers or list(range(1, len(parts) + 1))
        tid, jid = self.both(
            lambda ol: ol.new_multipart_upload("bkt", key, dict(meta or {}))
        )
        tinfo = [
            self.port.put_object_part(
                "bkt", key, tid, n, io.BytesIO(p), len(p)
            )
            for n, p in zip(numbers, parts)
        ]
        jinfo = [
            self.ref.put_object_part(
                "bkt", key, jid, n, io.BytesIO(p), len(p)
            )
            for n, p in zip(numbers, parts)
        ]
        return tid, jid, tinfo, jinfo


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _staged(roots, uid, n) -> list:
    """Each disk's staged ``part.n`` (b"" where it is missing)."""
    out = []
    for r in roots:
        p = f"{r}/.sys/multipart/{uid}/part.{n}"
        out.append(_read(p) if os.path.exists(p) else b"")
    return out


def _part_meta(roots, uid, n) -> list:
    """``size:etag:mod:actual`` of each disk's ``part.n.meta``, with the
    mod time dropped."""
    out = []
    for r in roots:
        size, etag, _mod, actual = _read(
            f"{r}/.sys/multipart/{uid}/part.{n}.meta"
        ).decode().split(":")
        out.append((size, etag, actual))
    return out


def _object(root, key, bucket="bkt") -> tuple:
    """(xl.meta docs up to volatile fields, part files) on one disk."""
    raw = _read(f"{root}/{bucket}/{key}/xl.meta")
    docs, parts = [], []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        data_dir = d.pop("data_dir")
        for volatile in ("mod_time_ns", "version_id"):
            d.pop(volatile)
        docs.append(d)
        if data_dir:
            ddir = f"{root}/{bucket}/{key}/{data_dir}"
            for name in sorted(os.listdir(ddir)):
                parts.append((name, _read(f"{ddir}/{name}")))
    return docs, parts


def _upload_doc(root, uid) -> dict:
    d = XLMeta.from_bytes(
        _read(f"{root}/.sys/multipart/{uid}/xl.meta")
    ).versions[0].to_dict()
    d.pop("mod_time_ns")
    d.pop("name", None)
    return d


def _get(ol, key, offset=0, length=-1) -> bytes:
    buf = io.BytesIO()
    ol.get_object("bkt", key, buf, offset, length)
    return buf.getvalue()


def _completes(pair, key, tid, jid, tinfo, jinfo):
    tcp = [CompletePart(p.part_number, p.etag) for p in tinfo]
    jcp = [japi.CompletePart(p.part_number, p.etag) for p in jinfo]
    return (
        pair.port.complete_multipart_upload("bkt", key, tid, tcp),
        pair.ref.complete_multipart_upload("bkt", key, jid, jcp),
    )


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        pair = Pair(tmp_path_factory.mktemp("mp"))
        parts = _parts(1)
        tid, jid, tinfo, jinfo = pair.upload("obj", parts)
        staged = {
            n: (_staged(pair.troots, tid, n), _staged(pair.jroots, jid, n))
            for n in range(1, len(parts) + 1)
        }
        part_meta = {
            n: (_part_meta(pair.troots, tid, n), _part_meta(pair.jroots, jid, n))
            for n in range(1, len(parts) + 1)
        }
        lists = (
            pair.port.list_object_parts("bkt", "obj", tid),
            pair.ref.list_object_parts("bkt", "obj", jid),
            pair.port.list_multipart_uploads("bkt"),
            pair.ref.list_multipart_uploads("bkt"),
        )
        docs = [(_upload_doc(t, tid), _upload_doc(j, jid))
                for t, j in zip(pair.troots, pair.jroots)]
        done = _completes(pair, "obj", tid, jid, tinfo, jinfo)
        yield types.SimpleNamespace(
            pair=pair, parts=parts, tinfo=tinfo, jinfo=jinfo, tid=tid,
            jid=jid, staged=staged, part_meta=part_meta, lists=lists,
            docs=docs, done=done,
        )
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.mark.parametrize("n", range(1, len(PART_SIZES) + 1))
def test_staged_part_files_identical(env, n):
    tstaged, jstaged = env.staged[n]
    assert all(tstaged) and tstaged == jstaged
    assert env.part_meta[n][0] == env.part_meta[n][1]


def test_part_etags_equal(env):
    assert [p.etag for p in env.tinfo] == [p.etag for p in env.jinfo]
    assert [p.etag for p in env.tinfo] == [
        hashlib.md5(p).hexdigest() for p in env.parts
    ]
    assert [p.size for p in env.tinfo] == list(PART_SIZES)


def test_upload_meta_equal(env):
    for tdoc, jdoc in env.docs:
        assert tdoc == jdoc


def test_list_parts_and_uploads(env):
    tparts, jparts, tups, jups = env.lists
    strip = lambda ps: [(p.part_number, p.etag, p.size) for p in ps]  # noqa: E731
    assert strip(tparts) == strip(jparts) == [
        (i + 1, hashlib.md5(p).hexdigest(), len(p))
        for i, p in enumerate(env.parts)
    ]
    assert [(u.bucket, u.object) for u in tups] == [
        (u.bucket, u.object) for u in jups
    ] == [("bkt", "obj")]
    assert tups[0].upload_id == env.tid


def test_complete_equal(env):
    tinfo, jinfo = env.done
    assert tinfo.etag == jinfo.etag == _mp_etag(env.parts)
    assert tinfo.size == jinfo.size == sum(PART_SIZES)
    pair = env.pair
    for t, j in zip(pair.troots, pair.jroots):
        assert _object(t, "obj") == _object(j, "obj")
        assert not os.path.exists(f"{t}/.sys/multipart/{env.tid}")


def test_complete_renames_the_staged_files(env):
    """No re-encode: part.i of the object is the staged part.i."""
    for i, root in enumerate(env.pair.troots):
        _docs, parts = _object(root, "obj")
        assert [b for _name, b in parts] == [
            env.staged[n][0][i] for n in range(1, len(PART_SIZES) + 1)
        ]


@pytest.mark.parametrize("rng", [
    (0, -1),
    (3 * BLOCK + 5 - 100, 200),  # across the first part boundary
    (3 * BLOCK, 2 * BLOCK + 10),  # into the tail part
    (sum(PART_SIZES) - 17, 17),  # the tail alone
])
def test_get(env, rng):
    whole = b"".join(env.parts)
    off, ln = rng
    want = whole[off:] if ln < 0 else whole[off : off + ln]
    assert _get(env.pair.port, "obj", off, ln) == want
    assert _get(env.pair.ref, "obj", off, ln) == want


@pytest.mark.parametrize("rng", [(0, -1), (3 * BLOCK + 5 - 100, 200)])
def test_get_degraded(env, tmp_path, rng):
    """With m disks holding data shards offline, reconstruct runs per
    part: the port over a copy of its disks, the JAX package over a
    copy of its own."""
    pair = env.pair
    whole = b"".join(env.parts)
    off, ln = rng
    want = whole[off:] if ln < 0 else whole[off : off + ln]
    dist = XLStorage(pair.troots[0]).read_version("bkt", "obj").erasure.distribution
    dead = {d for d in range(N) if dist[d] in (1, 3)}
    troots = [None if i in dead else r for i, r in enumerate(pair.troots)]
    jroots = [None if i in dead else r for i, r in enumerate(pair.jroots)]
    port = ErasureObjects(
        [XLStorage(r) if r else None for r in troots], parity_blocks=M,
        block_size=BLOCK, device="cpu",
    )
    ref = JaxObjects(
        [JaxStorage(r) if r else None for r in jroots], parity_blocks=M,
        block_size=BLOCK,
    )
    assert _get(port, "obj", off, ln) == want == _get(ref, "obj", off, ln)


def test_heal_multipart_object(env, tmp_path):
    """The part files of two disks deleted: heal rebuilds every part in
    both packages, byte-identical to what was there."""
    pair = env.pair
    troots = [str(tmp_path / f"t{i}") for i in range(N)]
    jroots = [str(tmp_path / f"j{i}") for i in range(N)]
    for src, dst in zip(pair.troots + pair.jroots, troots + jroots):
        shutil.copytree(src, dst)
    dist = XLStorage(troots[0]).read_version("bkt", "obj").erasure.distribution
    dead = sorted(d for d in range(N) if dist[d] in (1, 6))
    before = [_object(troots[d], "obj") for d in dead]
    for roots in (troots, jroots):
        for d in dead:
            fi = XLStorage(roots[d]).read_version("bkt", "obj")
            shutil.rmtree(f"{roots[d]}/bkt/obj/{fi.data_dir}")
    port = ErasureObjects([XLStorage(r) for r in troots], parity_blocks=M,
                          block_size=BLOCK, device="cpu")
    ref = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=M,
                     block_size=BLOCK)
    tres = port.heal_object("bkt", "obj")
    jres = ref.heal_object("bkt", "obj")
    assert sorted(tres["healed"]) == sorted(jres["healed"]) == sorted(
        dist[d] - 1 for d in dead
    )
    for d, want in zip(dead, before):
        assert _object(troots[d], "obj") == want == _object(jroots[d], "obj")
    assert _get(port, "obj") == b"".join(env.parts)


def test_complete_leaving_a_part_out(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    pair = Pair(tmp_path)
    parts = _parts(2)
    tid, jid, tinfo, jinfo = pair.upload("skip", parts)
    keep = [0, 2]
    tdone = pair.port.complete_multipart_upload(
        "bkt", "skip", tid,
        [CompletePart(tinfo[i].part_number, tinfo[i].etag) for i in keep],
    )
    jdone = pair.ref.complete_multipart_upload(
        "bkt", "skip", jid,
        [japi.CompletePart(jinfo[i].part_number, jinfo[i].etag) for i in keep],
    )
    assert tdone.etag == jdone.etag == _mp_etag([parts[i] for i in keep])
    for t, j in zip(pair.troots, pair.jroots):
        assert _object(t, "skip") == _object(j, "skip")
    assert _get(pair.port, "skip") == parts[0] + parts[2]


def test_abort(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    pair = Pair(tmp_path)
    tid, jid, _t, _j = pair.upload("gone", _parts(3)[:1])
    pair.port.abort_multipart_upload("bkt", "gone", tid)
    pair.ref.abort_multipart_upload("bkt", "gone", jid)
    assert pair.port.list_multipart_uploads("bkt") == []
    assert pair.ref.list_multipart_uploads("bkt") == []
    for t in pair.troots:
        assert not os.path.exists(f"{t}/.sys/multipart/{tid}")
    with pytest.raises(api.InvalidUploadID):
        pair.port.abort_multipart_upload("bkt", "gone", tid)
    with pytest.raises(japi.InvalidUploadID):
        pair.ref.abort_multipart_upload("bkt", "gone", jid)


def _err_cases():
    """(name, call(ol, api_module, uid, infos, other_uid))."""
    def complete(parts_of):
        def call(ol, mod, uid, infos, _other):
            return ol.complete_multipart_upload(
                "bkt", "err", uid,
                [mod.CompletePart(n, e) for n, e in parts_of(infos)],
            )
        return call

    def put(n):
        def call(ol, _mod, uid, _infos, _other):
            return ol.put_object_part(
                "bkt", "err", uid, n, io.BytesIO(b"x"), 1
            )
        return call

    return [
        ("missing_part", complete(
            lambda i: [(i[0].part_number, i[0].etag), (7, "")])),
        ("etag_mismatch", complete(
            lambda i: [(i[0].part_number, "0" * 32)])),
        ("parts_out_of_order", complete(
            lambda i: [(2, i[1].etag), (1, i[0].etag)])),
        ("duplicate_part", complete(
            lambda i: [(1, i[0].etag), (1, i[0].etag)])),
        ("part_too_small", complete(
            lambda i: [(3, i[2].etag), (4, i[3].etag)])),
        ("no_parts", complete(lambda i: [])),
        ("upload_of_another_object", lambda ol, mod, _u, infos, other: (
            ol.complete_multipart_upload(
                "bkt", "err", other,
                [mod.CompletePart(1, infos[0].etag)]))),
        ("unknown_upload", lambda ol, mod, _u, infos, _o: (
            ol.complete_multipart_upload(
                "bkt", "err", "f" * 32,
                [mod.CompletePart(1, infos[0].etag)]))),
        ("part_number_0", put(0)),
        ("part_number_10001", put(10001)),
        ("put_part_unknown_upload", lambda ol, _m, _u, _i, _o: (
            ol.put_object_part(
                "bkt", "err", "f" * 32, 1, io.BytesIO(b"x"), 1))),
        ("list_parts_unknown_upload", lambda ol, _m, _u, _i, _o: (
            ol.list_object_parts("bkt", "err", "f" * 32))),
        ("complete_no_bucket", lambda ol, mod, uid, infos, _o: (
            ol.complete_multipart_upload(
                "nobkt", "err", uid, [mod.CompletePart(1, infos[0].etag)]))),
        ("initiate_no_bucket", lambda ol, _m, _u, _i, _o: (
            ol.new_multipart_upload("nobkt", "err"))),
        ("initiate_bad_name", lambda ol, _m, _u, _i, _o: (
            ol.new_multipart_upload("bkt", "../err"))),
    ]


ERR_CASES = _err_cases()


@pytest.fixture(scope="module")
def err_env(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        pair = Pair(tmp_path_factory.mktemp("err"))
        # parts 1, 2 at the minimum, 3 and 4 small: 3 may only be last
        parts = _parts(4, (MIN_PART, MIN_PART, 100, 100))
        tid, jid, tinfo, jinfo = pair.upload("err", parts)
        tother, jother = pair.both(
            lambda ol: ol.new_multipart_upload("bkt", "other")
        )
        yield pair, (tid, tinfo, tother), (jid, jinfo, jother)


@pytest.mark.parametrize("name,call", ERR_CASES, ids=[c[0] for c in ERR_CASES])
def test_errors_raised_alike(err_env, name, call):
    pair, (tid, tinfo, tother), (jid, jinfo, jother) = err_env
    with pytest.raises(Exception) as terr:
        call(pair.port, api, tid, tinfo, tother)
    with pytest.raises(Exception) as jerr:
        call(pair.ref, japi, jid, jinfo, jother)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value).replace(jid, tid).replace(
        jother, tother)
    # the upload survived every refused call
    assert len(pair.port.list_object_parts("bkt", "err", tid)) == 4


@pytest.mark.parametrize("failing_disks", [3, N])
def test_complete_rolls_back_when_write_quorum_is_lost(
    tmp_path, monkeypatch, failing_disks
):
    """rename_data fails on 3 or on all 6 disks (write quorum 4): both
    packages raise WriteQuorumError and move the parts of each disk whose
    commit failed back into the upload dir, leaving the same files.
    Where every commit failed, the same Complete succeeds once the disks
    recover."""
    monkeypatch.setenv("MINIO_MESH", "0")
    pair = Pair(tmp_path)
    parts = _parts(5)
    tid, jid, tinfo, jinfo = pair.upload("rb", parts)
    failing = set(
        pair.troots[:failing_disks] + pair.jroots[:failing_disks]
    )
    for cls in (XLStorage, JaxStorage):
        orig = cls.rename_data

        def flaky(self, *a, _orig=orig, **k):
            if self.root in failing:
                raise OSError("injected rename failure")
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, "rename_data", flaky)
    with pytest.raises(api.WriteQuorumError):
        pair.port.complete_multipart_upload(
            "bkt", "rb", tid,
            [CompletePart(p.part_number, p.etag) for p in tinfo],
        )
    with pytest.raises(japi.WriteQuorumError):
        pair.ref.complete_multipart_upload(
            "bkt", "rb", jid,
            [japi.CompletePart(p.part_number, p.etag) for p in jinfo],
        )
    for n in range(1, len(parts) + 1):
        staged = _staged(pair.troots, tid, n)
        assert staged == _staged(pair.jroots, jid, n)
        assert [bool(b) for b in staged] == [
            i < failing_disks for i in range(N)
        ]
    if failing_disks < N:
        return
    failing.clear()
    tdone, jdone = _completes(pair, "rb", tid, jid, tinfo, jinfo)
    assert tdone.etag == jdone.etag
    for t, j in zip(pair.troots, pair.jroots):
        assert _object(t, "rb") == _object(j, "rb")
    assert _get(pair.port, "rb") == b"".join(parts)


def test_ec_8_4(tmp_path, monkeypatch):
    """The measured geometry: EC 8+4 over 12 disks."""
    monkeypatch.setenv("MINIO_MESH", "0")
    block = 32 * 1024
    pair = Pair(tmp_path, n=12, m=4, block=block, min_part=block)
    parts = _parts(6, (block + 1000, block, 17))
    tid, jid, tinfo, jinfo = pair.upload("big", parts)
    for n in range(1, 4):
        assert _staged(pair.troots, tid, n) == _staged(pair.jroots, jid, n)
    tdone, jdone = _completes(pair, "big", tid, jid, tinfo, jinfo)
    assert tdone.etag == jdone.etag == _mp_etag(parts)
    for t, j in zip(pair.troots, pair.jroots):
        assert _object(t, "big") == _object(j, "big")
    whole = b"".join(parts)
    assert _get(pair.port, "big", block - 50, 2000) == whole[block - 50:block + 1950]


def test_unported_transforms_name_slice_8(tmp_path, monkeypatch):
    """Compression and SSE of an upload (slice 8) are served as the JAX
    package serves them (the test keeps the name of the refusal it
    replaced): an upload initiated compressed stores the same deflate
    part files, an excluded type is stored plain, and an upload the JAX
    package initiated compressed is completed by the port and read back
    by both."""
    from minio_tpu_torch.codec import sse as tsse

    monkeypatch.setenv("MINIO_MESH", "0")
    pair = Pair(tmp_path)
    parts = [bytes(48 + i % 16 for i in range(n)) for n in PART_SIZES]
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    tid = pair.port.new_multipart_upload("bkt", "log.txt")
    jid = pair.ref.new_multipart_upload("bkt", "log.txt")
    tinfo = [pair.port.put_object_part("bkt", "log.txt", tid, n,
                                       io.BytesIO(p), len(p))
             for n, p in enumerate(parts, 1)]
    jinfo = [pair.ref.put_object_part("bkt", "log.txt", jid, n,
                                      io.BytesIO(p), len(p))
             for n, p in enumerate(parts, 1)]
    assert [p.size for p in tinfo] == [p.size for p in jinfo] == list(
        PART_SIZES)
    _completes(pair, "log.txt", tid, jid, tinfo, jinfo)
    for t, j in zip(pair.troots, pair.jroots):
        assert _object(t, "log.txt") == _object(j, "log.txt")
    assert _get(pair.port, "log.txt") == b"".join(parts)
    # an excluded type is stored as the JAX package stores it: plain
    uid = pair.port.new_multipart_upload(
        "bkt", "clip.mp4", {"content-type": "video/mp4"})
    monkeypatch.delenv("MINIO_TPU_COMPRESS")
    # a customer key on a part of an upload not initiated with one
    with pytest.raises(tsse.SSEError, match="customer-key"):
        pair.port.put_object_part(
            "bkt", "clip.mp4", uid, 1, io.BytesIO(b"x"), 1,
            tsse.SSESpec("C", bytes(32)))
    # an upload the JAX package initiated compressed is continued by the
    # port: its parts are deflated as the JAX package deflates them
    monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
    ref = JaxObjects([JaxStorage(r) for r in pair.troots], parity_blocks=M,
                     block_size=BLOCK)
    ref.min_part_size = MIN_PART
    juid = ref.new_multipart_upload("bkt", "log2.txt")
    monkeypatch.delenv("MINIO_TPU_COMPRESS")
    done = [pair.port.put_object_part("bkt", "log2.txt", juid, n,
                                      io.BytesIO(p), len(p))
            for n, p in enumerate(parts, 1)]
    pair.port.complete_multipart_upload(
        "bkt", "log2.txt", juid,
        [CompletePart(p.part_number, p.etag) for p in done])
    for ol in (pair.port, ref):
        assert _get(ol, "log2.txt") == b"".join(parts)
        assert ol.get_object_info("bkt", "log2.txt").size == sum(PART_SIZES)