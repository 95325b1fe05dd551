"""The port's single-drive FS backend held against minio_tpu's.

Every case of ``tests/test_fs_backend.py`` runs on both packages'
``FSObjects`` (and, for the server case, both ``S3Server``s over them):
the answers, reduced to plain data, must be equal, and afterwards the
two drives must hold the same files byte for byte, the metadata
documents under ``.fs.sys`` included.  The clock and the uuids are
pinned in both ``objectlayer/fs.py`` modules (and the bucket documents'
clock in both ``bucket_meta``), reset before each package runs.
Compared apart:

* ``BucketInfo.created_ns``: the bucket directory's ctime;
* ``list_multipart_uploads``: the port answers ``MultipartInfo``
  records, the JAX copy dicts of the same three fields;
* ``PartInfo.mod_time_ns``: ``list_object_parts`` answers the part
  file's mtime.

Beyond the cases: each package's layer reads a drive the other wrote,
the path-escape guard holds in both for the same names, and a drive that
holds an erasure format is refused by both boots with one message.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import os
import types

import pytest

from minio_tpu.objectlayer import api as japi, bucket_meta as jbucket_meta
from minio_tpu.objectlayer import fs as jfs
from minio_tpu.server import __main__ as jmain
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu_torch.objectlayer import api as tapi, bucket_meta as tbucket_meta
from minio_tpu_torch.objectlayer import fs as tfs
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.server.http import S3Server
from tests.s3client import S3Client
from tests.test_torch_server import _normalize
from tests.test_torch_threads import torch_threads  # noqa: F401

T0 = 1_700_000_000_000_000_000


class _Pinned:
    """A clock that steps 1 ms a call and uuids from a counter, shared by
    both packages' FS modules and reset before each package runs."""

    def __init__(self):
        self.reset()
        self.time = types.SimpleNamespace(time_ns=self._time_ns)
        self.uuid = types.SimpleNamespace(uuid4=self._uuid4)

    def reset(self):
        self._t = itertools.count(T0, 1_000_000)
        self._u = itertools.count(1)

    def _time_ns(self):
        return next(self._t)

    def _uuid4(self):
        return types.SimpleNamespace(hex=f"{next(self._u):032x}")


@pytest.fixture()
def pinned(monkeypatch):
    p = _Pinned()
    for mod in (jfs, tfs):
        monkeypatch.setattr(mod, "time", p.time)
        monkeypatch.setattr(mod, "uuid", p.uuid)
    fixed = types.SimpleNamespace(time_ns=lambda: T0, monotonic=lambda: 0.0)
    monkeypatch.setattr(jbucket_meta, "time", fixed)
    monkeypatch.setattr(tbucket_meta, "time", fixed)
    return p


PKGS = {
    "jax": types.SimpleNamespace(fs=jfs, api=japi, Server=JaxServer,
                                 main=jmain, kw={}),
    "port": types.SimpleNamespace(fs=tfs, api=tapi, Server=S3Server,
                                  main=tmain, kw={"device": "cpu"}),
}


def _plain(x):
    """An answer as plain data, the same for either package's classes."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict) and "upload_id" in x:  # the JAX FS's uploads
        return ("upload", x["object"], x["upload_id"], x["initiated_ns"])
    if type(x).__name__ == "MultipartInfo":
        return ("upload", x.object, x.upload_id, x.initiated_ns)
    if dataclasses.is_dataclass(x):
        d = {f.name: _plain(getattr(x, f.name))
             for f in dataclasses.fields(x)}
        if type(x).__name__ == "BucketInfo":
            d["created_ns"] = None
        if type(x).__name__ == "PartInfo" and "mod_time_ns" in d:
            d["mod_time_ns"] = None
        return (type(x).__name__, d)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


class _Log:
    def __init__(self):
        self.rows = []

    def __call__(self, name, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
            self.rows.append((name, "ok", _plain(out)))
            return out
        except Exception as e:  # noqa: BLE001 - the answer under test
            self.rows.append((name, "raise", type(e).__name__))
            return None


def _tree(root: str) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- the cases of tests/test_fs_backend.py, written once for both ----------


def case_bucket_crud(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    log("make", fs.make_bucket, "bkt")
    log("info", fs.get_bucket_info, "bkt")
    log("list", fs.list_buckets)
    log("make_dup", fs.make_bucket, "bkt")
    log("put", fs.put_object, "bkt", "x", io.BytesIO(b"1"), 1)
    log("delete_full", fs.delete_bucket, "bkt")
    log("delete_obj", fs.delete_object, "bkt", "x")
    log("delete", fs.delete_bucket, "bkt")
    log("info_gone", fs.get_bucket_info, "bkt")


def case_object_roundtrip(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    data = b"fs-payload" * 1000
    log("put", fs.put_object, "bkt", "dir/obj.bin", io.BytesIO(data),
        len(data), {"content-type": "application/x-test",
                    "x-amz-meta-a": "1"})
    log("info", fs.get_object_info, "bkt", "dir/obj.bin")
    for off, length in ((0, -1), (5, 20)):
        buf = io.BytesIO()
        log(f"get_{off}", fs.get_object, "bkt", "dir/obj.bin", buf,
            offset=off, length=length)
        log(f"body_{off}", buf.getvalue)
    log("get_bad_range", fs.get_object, "bkt", "dir/obj.bin", io.BytesIO(),
        offset=9990, length=20)
    log("delete", fs.delete_object, "bkt", "dir/obj.bin")
    log("info_gone", fs.get_object_info, "bkt", "dir/obj.bin")
    log("pruned", os.path.exists, os.path.join(fs.root, "bkt", "dir"))


def case_listing_with_delimiter(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    for k in ("a/1", "a/2", "b/1", "top"):
        log(f"put_{k}", fs.put_object, "bkt", k, io.BytesIO(b"x"), 1)
    log("delim", fs.list_objects, "bkt", delimiter="/")
    log("prefix", fs.list_objects, "bkt", prefix="a/")
    log("marker", fs.list_objects, "bkt", marker="a/2", max_keys=1)


def case_copy_and_meta_update(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    log("put", fs.put_object, "bkt", "src", io.BytesIO(b"copy-me"), 7,
        {"x-amz-meta-k": "v"})
    log("copy", fs.copy_object, "bkt", "src", "bkt", "dst")
    log("info", fs.get_object_info, "bkt", "dst")
    log("update", fs.update_object_meta, "bkt", "dst",
        {"x-amz-tagging": "a=1"})
    log("info2", fs.get_object_info, "bkt", "dst")
    log("copy_sse", fs.copy_object, "bkt", "src", "bkt", "dst2",
        sse=object())


def case_multipart(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    uid = log("new", fs.new_multipart_upload, "bkt", "big",
              {"content-type": "x/y"})
    p1 = log("part1", fs.put_object_part, "bkt", "big", uid, 1,
             io.BytesIO(b"A" * 100), 100)
    p2 = log("part2", fs.put_object_part, "bkt", "big", uid, 2,
             io.BytesIO(b"B" * 50), 50)
    log("parts", fs.list_object_parts, "bkt", "big", uid)
    log("uploads", fs.list_multipart_uploads, "bkt")
    log("complete", fs.complete_multipart_upload, "bkt", "big", uid,
        [P.api.CompletePart(1, p1.etag), P.api.CompletePart(2, p2.etag)])
    buf = io.BytesIO()
    log("get", fs.get_object, "bkt", "big", buf)
    log("body", buf.getvalue)
    uid2 = log("new2", fs.new_multipart_upload, "bkt", "gone")
    log("abort", fs.abort_multipart_upload, "bkt", "gone", uid2)
    log("part_after_abort", fs.put_object_part, "bkt", "gone", uid2, 1,
        io.BytesIO(b"x"), 1)
    log("wrong_object", fs.list_object_parts, "bkt", "other", uid)


def case_relative_root_works(P, root, log):
    cwd = os.getcwd()
    os.makedirs(root)
    os.chdir(root)
    try:
        fs = P.fs.FSObjects("./reldrive", min_part_size=1)
        fs.make_bucket("bkt")
        log("put", fs.put_object, "bkt", "hello.txt", io.BytesIO(b"hi"), 2)
        buf = io.BytesIO()
        log("get", fs.get_object, "bkt", "hello.txt", buf)
        log("body", buf.getvalue)
    finally:
        os.chdir(cwd)


def case_path_escape_rejected(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    fs.make_bucket("bkt2")
    for name in ("../escape", "a/../../escape", "../bkt2/x", "a/../b"):
        log(f"put {name}", fs.put_object, "bkt", name, io.BytesIO(b"x"), 1)
        log(f"get {name}", fs.get_object_info, "bkt", name)


def case_delimiter_listing_truncates_prefixes(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    for i in range(8):
        fs.put_object("bkt", f"dir{i}/f", io.BytesIO(b"x"), 1)
    res = log("page1", fs.list_objects, "bkt", delimiter="/", max_keys=3)
    log("page2", fs.list_objects, "bkt", marker=res.next_marker,
        delimiter="/", max_keys=10)


def case_complete_validates_part_etags(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    uid = fs.new_multipart_upload("bkt", "obj")
    log("part", fs.put_object_part, "bkt", "obj", uid, 1,
        io.BytesIO(b"data"), 4)
    log("bogus_etag", fs.complete_multipart_upload, "bkt", "obj", uid,
        [P.api.CompletePart(1, "bogus-etag")])
    log("missing_part", fs.complete_multipart_upload, "bkt", "obj", uid,
        [P.api.CompletePart(2, "x")])
    log("order", fs.complete_multipart_upload, "bkt", "obj", uid,
        [P.api.CompletePart(2, "x"), P.api.CompletePart(1, "x")])


def case_versioning_not_implemented(P, root, log):
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    log("versions", fs.list_object_versions, "bkt")
    log("has_versions", fs.has_object_versions, "bkt", "none")
    log("version_info", fs.get_object_info, "bkt", "x", "v1")


def case_server_over_fs_backend(P, root, log):
    srv = P.Server(P.fs.FSObjects(root, min_part_size=1),
                   address="127.0.0.1:0", **P.kw).start()
    try:
        c = S3Client(srv.endpoint)
        steps = [
            lambda: c.make_bucket("fsbkt"),
            lambda: c.put_object("fsbkt", "k", b"over-http"),
            lambda: c.get_object("fsbkt", "k"),
            lambda: c.head_object("fsbkt", "k"),
            lambda: c.list_objects("fsbkt"),
            lambda: c.request(
                "PUT", "/fsbkt/k", query={"tagging": ""},
                body=b"<Tagging><TagSet><Tag><Key>a</Key>"
                b"<Value>1</Value></Tag></TagSet></Tagging>"),
            lambda: c.request("GET", "/fsbkt/k", query={"tagging": ""}),
            lambda: c.request("GET", "/fsbkt", query={"versions": ""}),
            lambda: c.get_object("fsbkt", "k",
                                 headers={"range": "bytes=2-5"}),
            lambda: c.request("POST", "/fsbkt/mp", query={"uploads": ""}),
            lambda: c.delete_object("fsbkt", "k"),
            lambda: c.get_object("fsbkt", "k"),
            lambda: c.request(
                "PUT", "/minio-tpu/admin/v1/add-user",
                query={"accessKey": "fsuser"},
                body=json.dumps({"secretKey": "fs-secret-123",
                                 "policy": ""}).encode()),
        ]
        for i, step in enumerate(steps):
            r = step()
            log.rows.append((f"step{i}", "ok",
                             _normalize((r.status, r.headers, r.body))))
    finally:
        srv.shutdown()


def case_fs_mode_selected_for_single_drive(P, root, log):
    ol, local = P.main.build_cluster([os.path.join(root, "onedrive")], 0, "")
    log.rows.append(("layer", "ok", (type(ol).__name__, local)))
    ol.make_bucket("bkt")
    log("put", ol.put_object, "bkt", "k", io.BytesIO(b"v"), 1)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_answers_and_files(tmp_path, pinned, case):
    rows, trees = {}, {}
    for kind, P in PKGS.items():
        pinned.reset()
        root = str(tmp_path / kind)
        log = _Log()
        CASES[case](P, root, log)
        rows[kind], trees[kind] = log.rows, _tree(root)
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) > 0
    assert sorted(trees["port"]) == sorted(trees["jax"])
    for path, data in trees["jax"].items():
        assert trees["port"][path] == data, path


def test_cases_cover_the_reference_suite():
    import tests.test_fs_backend as ref

    names = sorted(n[5:] for n in dir(ref) if n.startswith("test_"))
    assert len(names) == 12
    assert names == sorted(CASES)


def _write_drive(P, root: str) -> None:
    fs = P.fs.FSObjects(root, min_part_size=1)
    fs.make_bucket("bkt")
    fs.put_object("bkt", "a/plain.bin", io.BytesIO(os.urandom(5000)), 5000,
                  {"content-type": "application/octet-stream",
                   "x-amz-meta-who": "writer"})
    text = b"compressible text line\n" * 4000
    fs.put_object("bkt", "b/log.txt", io.BytesIO(text), len(text),
                  {"content-type": "text/plain"}, compress=True)
    uid = fs.new_multipart_upload("bkt", "mp")
    parts = [fs.put_object_part("bkt", "mp", uid, n, io.BytesIO(b"%d" % n * 64),
                                64) for n in (1, 2)]
    fs.complete_multipart_upload(
        "bkt", "mp", uid,
        [P.api.CompletePart(p.part_number, p.etag) for p in parts])
    pending = fs.new_multipart_upload("bkt", "pending", {"x-amz-meta-p": "1"})
    fs.put_object_part("bkt", "pending", pending, 1, io.BytesIO(b"z" * 10), 10)


def _read_drive(P, root: str) -> list:
    fs = P.fs.FSObjects(root, min_part_size=1)
    out = [_plain(fs.list_buckets()),
           _plain(fs.list_objects("bkt")),
           _plain(fs.list_objects("bkt", delimiter="/"))]
    for key in ("a/plain.bin", "b/log.txt", "mp"):
        buf = io.BytesIO()
        out.append(_plain(fs.get_object("bkt", key, buf)))
        out.append(buf.getvalue())
        buf = io.BytesIO()
        fs.get_object("bkt", key, buf, offset=7, length=100)
        out.append(buf.getvalue())
    ups = fs.list_multipart_uploads("bkt")
    out.append(_plain(ups))
    uid = ups[0]["upload_id"] if isinstance(ups[0], dict) else ups[0].upload_id
    out.append(_plain(fs.list_object_parts("bkt", "pending", uid)))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_reads_what_the_other_wrote(tmp_path, writer, reader):
    root = str(tmp_path / "drive")
    _write_drive(PKGS[writer], root)
    assert _read_drive(PKGS[reader], root) == _read_drive(PKGS[writer], root)


def test_erasure_formatted_drive_refused_alike(tmp_path):
    solo = tmp_path / "solo"
    (solo / ".sys").mkdir(parents=True)
    (solo / ".sys" / "format.json").write_text("{}")
    msgs = []
    for P in PKGS.values():
        with pytest.raises(SystemExit) as e:
            P.main.build_cluster([str(solo)], 0, "")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "holds an erasure format" in msgs[1]
