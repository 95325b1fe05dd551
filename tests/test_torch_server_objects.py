"""The port's object routes of slices 5c and 7 held against minio_tpu's
S3 server, over real HTTP.

Two threaded servers run side by side, as in ``tests/test_torch_server.py``:
minio_tpu's ``S3Server`` and minio_tpu_torch's (``device="cpu"``), each
over six temp-dir disks at EC 4+2 with 4 KiB blocks and
``min_part_size`` lowered to two blocks on both.  The same signed
requests go to both: the multipart routes (CreateMultipartUpload,
UploadPart, UploadPartCopy with ``x-amz-copy-source-range``, ListParts,
ListMultipartUploads, AbortMultipartUpload, CompleteMultipartUpload and
their errors), CopyObject (COPY, REPLACE, self-copy), multi-object
delete (quiet and verbose), POST-policy uploads and ListObjectVersions.
Statuses, headers and bodies must be equal once these fields are
normalized: what ``test_torch_server`` normalizes, ``<Initiated>``, the
upload ids and version ids (random per server; each is replaced by its
place in the run), and the server's own endpoint in ``<Location>``.  Afterwards the
part files and ``xl.meta`` on every disk, the request counters and the
event records must be equal too.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import io
import re
import time
import types

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer import bucket_meta as jbucket_meta
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import bucket_meta as tbucket_meta
from tests.s3client import S3Client
from tests.test_torch_server import (
    _counters,
    _normalize,
    _objects,
    _pay,
    _res,
    _settled,
    _start,
    _xl_disks,
)
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 4096
MIN_PART = 2 * BLOCK
CREATED_NS = 1_700_000_000_000_000_000

PARTS = [_pay(3 * BLOCK + 5, 21), _pay(2 * BLOCK, 22), _pay(17, 23)]
BIG = b"".join(PARTS)
SRC = _pay(5 * BLOCK + 11, 24)
# a range of the completed upload across its first part boundary, long
# enough to be a part other than the last
CROSS = (3 * BLOCK + 5 - 300, 3 * BLOCK + 5 + MIN_PART - 1)
TAIL4 = _pay(100, 25)  # a part 4 that Complete leaves out


def _xml(parts) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def _md5(b: bytes) -> str:
    return hashlib.md5(b).hexdigest()


def _uid(r) -> str:
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", r.body)
    return m.group(1).decode() if m else ""


def _steps():
    """(name, fn(client, ctx)) pairs, sent in this order to both
    servers; ``ctx`` carries the upload ids a server handed out."""
    def initiate(name, key, headers=None):
        def fn(c, ctx):
            r = c.request("POST", f"/mpu/{key}", query={"uploads": ""},
                          headers=headers)
            ctx[name] = _uid(r)
            return r
        return fn

    def part(upload, key, n, data, headers=None):
        return lambda c, ctx: c.request(
            "PUT", f"/mpu/{key}",
            query={"partNumber": str(n), "uploadId": ctx[upload]},
            body=data, headers=headers)

    def part_copy(upload, key, n, source, rng=None):
        def fn(c, ctx):
            h = {"x-amz-copy-source": source}
            if rng is not None:
                h["x-amz-copy-source-range"] = rng
            return c.request(
                "PUT", f"/mpu/{key}",
                query={"partNumber": str(n), "uploadId": ctx[upload]},
                headers=h)
        return fn

    def complete(upload, key, parts):
        return lambda c, ctx: c.request(
            "POST", f"/mpu/{key}", query={"uploadId": ctx[upload]},
            body=_xml(parts))

    def copy(key, source, headers=None):
        return lambda c, ctx: c.put_object(
            "mpu", key, b"", headers={"x-amz-copy-source": source,
                                     **(headers or {})})

    def multi_delete(keys, quiet=False):
        body = ("<Delete>" + ("<Quiet>true</Quiet>" if quiet else "") +
                "".join(f"<Object><Key>{k}</Key></Object>" for k in keys) +
                "</Delete>").encode()
        return lambda c, ctx: c.request(
            "POST", "/mpu", query={"delete": ""}, body=body)

    def versions_paged(max_keys, **q):
        def fn(c, ctx):
            bodies, km, vm = [], "", ""
            for _ in range(20):
                query = {"versions": "", "max-keys": str(max_keys), **q}
                if km:
                    query["key-marker"] = km
                if vm:
                    query["version-id-marker"] = vm
                r = c.request("GET", "/ver", query=query)
                bodies.append(r.body)
                if b"<IsTruncated>true</IsTruncated>" not in r.body:
                    break
                km = r.xml_text("NextKeyMarker")
                vm = r.xml_text("NextVersionIdMarker")
            return r.status, r.headers, b"\n".join(bodies)
        return fn

    e = [_md5(p) for p in PARTS]
    return [
        ("bucket_create", lambda c, ctx: c.make_bucket("mpu")),
        ("put_src", lambda c, ctx: c.put_object(
            "mpu", "src", SRC, headers={"content-type": "text/plain",
                                       "x-amz-meta-k": "v"})),
        ("initiate_big", initiate("big", "big", {
            "content-type": "application/x-big", "x-amz-meta-m": "1"})),
        ("initiate_no_bucket", lambda c, ctx: c.request(
            "POST", "/nobucket/k", query={"uploads": ""})),
        ("put_part_1", part("big", "big", 1, PARTS[0])),
        ("put_part_2", part("big", "big", 2, PARTS[1])),
        ("put_part_3", part("big", "big", 3, PARTS[2])),
        ("put_part_4", part("big", "big", 4, TAIL4)),
        ("put_part_bad_md5", part("big", "big", 5, b"abc", {
            "content-md5": "AAAAAAAAAAAAAAAAAAAAAA=="})),
        ("put_part_number_0", part("big", "big", 0, b"x")),
        ("put_part_number_10001", part("big", "big", 10001, b"x")),
        ("put_part_number_text", lambda c, ctx: c.request(
            "PUT", "/mpu/big", query={"partNumber": "x",
                                     "uploadId": ctx["big"]}, body=b"x")),
        ("put_part_unknown_upload", lambda c, ctx: c.request(
            "PUT", "/mpu/big", query={"partNumber": "1",
                                     "uploadId": "f" * 32}, body=b"x")),
        ("put_upload_id_without_part_number", lambda c, ctx: c.request(
            "PUT", "/mpu/big", query={"uploadId": ctx["big"]}, body=b"x")),
        ("list_parts", lambda c, ctx: c.request(
            "GET", "/mpu/big", query={"uploadId": ctx["big"]})),
        ("list_parts_unknown_upload", lambda c, ctx: c.request(
            "GET", "/mpu/big", query={"uploadId": "f" * 32})),
        ("list_uploads", lambda c, ctx: c.request(
            "GET", "/mpu", query={"uploads": ""})),
        ("list_uploads_prefix_miss", lambda c, ctx: c.request(
            "GET", "/mpu", query={"uploads": "", "prefix": "zz"})),
        ("complete_out_of_order", complete(
            "big", "big", [(2, e[1]), (1, e[0])])),
        ("complete_etag_mismatch", complete("big", "big", [(1, "0" * 32)])),
        ("complete_missing_part", complete("big", "big", [(1, e[0]), (9, "")])),
        ("complete_too_small", complete(
            "big", "big", [(1, e[0]), (3, e[2]), (4, _md5(TAIL4))])),
        ("complete_malformed", lambda c, ctx: c.request(
            "POST", "/mpu/big", query={"uploadId": ctx["big"]},
            body=b"<not-xml")),
        ("complete_other_key", complete("big", "other", [(1, e[0])])),
        ("complete_big", complete("big", "big", [(1, e[0]), (2, e[1]),
                                                 (3, e[2])])),
        ("complete_again", complete("big", "big", [(1, e[0])])),
        ("get_big", lambda c, ctx: c.get_object("mpu", "big")),
        ("get_big_cross_range", lambda c, ctx: c.get_object(
            "mpu", "big", headers={"range": "bytes=%d-%d" % CROSS})),
        ("head_big", lambda c, ctx: c.head_object("mpu", "big")),
        ("initiate_gone", initiate("gone", "gone")),
        ("put_part_gone", part("gone", "gone", 1, b"g" * 100)),
        ("list_uploads_two", lambda c, ctx: c.request(
            "GET", "/mpu", query={"uploads": ""})),
        ("abort_gone", lambda c, ctx: c.request(
            "DELETE", "/mpu/gone", query={"uploadId": ctx["gone"]})),
        ("abort_gone_again", lambda c, ctx: c.request(
            "DELETE", "/mpu/gone", query={"uploadId": ctx["gone"]})),
        ("list_uploads_after_abort", lambda c, ctx: c.request(
            "GET", "/mpu", query={"uploads": ""})),
        # UploadPartCopy: two ranges (one across big's part boundary),
        # a whole source, then the errors
        ("initiate_asm", initiate("asm", "asm")),
        ("part_copy_cross", part_copy(
            "asm", "asm", 1, "/mpu/big", "bytes=%d-%d" % CROSS)),
        ("part_copy_src_range", part_copy(
            "asm", "asm", 2, "/mpu/src", f"bytes=100-{100 + 2 * BLOCK}")),
        ("part_copy_whole", part_copy("asm", "asm", 3, "mpu/src")),
        ("put_part_asm_4", part("asm", "asm", 4, b"tail bytes")),
        ("part_copy_open_range", part_copy(
            "asm", "asm", 5, "/mpu/src", "bytes=5-")),
        ("part_copy_range_past_end", part_copy(
            "asm", "asm", 5, "/mpu/src", f"bytes=0-{len(SRC)}")),
        ("part_copy_missing_source", part_copy(
            "asm", "asm", 5, "/mpu/nothing")),
        ("part_copy_bad_source", part_copy("asm", "asm", 5, "noslash")),
        ("list_parts_asm", lambda c, ctx: c.request(
            "GET", "/mpu/asm", query={"uploadId": ctx["asm"]})),
        ("complete_asm", lambda c, ctx: c.request(
            "POST", "/mpu/asm", query={"uploadId": ctx["asm"]},
            body=_xml([(1, _md5(BIG[CROSS[0]:CROSS[1] + 1])),
                       (2, _md5(SRC[100:101 + 2 * BLOCK])),
                       (3, _md5(SRC)), (4, _md5(b"tail bytes"))]))),
        ("get_asm", lambda c, ctx: c.get_object("mpu", "asm")),
        # CopyObject
        ("copy_copy", copy("cp-copy", "/mpu/src")),
        ("copy_replace", copy("cp-replace", "/mpu/src", {
            "x-amz-metadata-directive": "REPLACE",
            "content-type": "x/new", "x-amz-meta-new": "n"})),
        ("head_copy_copy", lambda c, ctx: c.head_object("mpu", "cp-copy")),
        ("head_copy_replace", lambda c, ctx: c.head_object(
            "mpu", "cp-replace")),
        ("copy_multipart_source", copy("cp-big", "/mpu/big")),
        ("get_copy_big", lambda c, ctx: c.get_object("mpu", "cp-big")),
        ("copy_self_without_replace", copy("src", "/mpu/src")),
        ("copy_self_replace", copy("src", "/mpu/src", {
            "x-amz-metadata-directive": "REPLACE",
            "x-amz-meta-k": "changed"})),
        ("head_self_copy", lambda c, ctx: c.head_object("mpu", "src")),
        ("copy_missing_source", copy("cp-x", "/mpu/nothing")),
        ("copy_missing_source_bucket", copy("cp-x", "/nobkt/x")),
        ("copy_bad_source", copy("cp-x", "noslash")),
        ("copy_no_dest_bucket", lambda c, ctx: c.put_object(
            "nobkt", "x", b"", headers={"x-amz-copy-source": "/mpu/src"})),
        # multi-object delete
        ("multi_delete_verbose", multi_delete(["cp-copy", "nokey"])),
        ("multi_delete_quiet", multi_delete(["cp-replace", "nokey2"], True)),
        ("multi_delete_malformed", lambda c, ctx: c.request(
            "POST", "/mpu", query={"delete": ""}, body=b"<Delete")),
        ("get_after_multi_delete", lambda c, ctx: c.get_object(
            "mpu", "cp-copy")),
        # POST policy
        ("post_policy_ok", lambda c, ctx: _res(c.post_policy_upload(
            "mpu", "posted", b"form bytes", status="201"))),
        ("post_policy_default_status", lambda c, ctx: _res(
            c.post_policy_upload("mpu", "posted2", b"more form bytes"))),
        ("post_policy_bad_signature", lambda c, ctx: _res(
            c.post_policy_upload("mpu", "posted3", b"x", extra_fields={
                "x-amz-signature": "0" * 64}))),
        ("post_policy_expired", lambda c, ctx: _res(c.post_policy_upload(
            "mpu", "posted4", b"x", expires_in=-60))),
        ("get_posted", lambda c, ctx: c.get_object("mpu", "posted")),
        ("get_posted_missing", lambda c, ctx: c.get_object("mpu", "posted3")),
        # ListObjectVersions
        ("ver_bucket", lambda c, ctx: c.make_bucket("ver")),
        ("ver_enable", lambda c, ctx: c.request(
            "PUT", "/ver", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>")),
        ("ver_put_1", lambda c, ctx: c.put_object("ver", "k", b"one")),
        ("ver_put_2", lambda c, ctx: c.put_object("ver", "k", b"two!")),
        ("ver_delete", lambda c, ctx: c.delete_object("ver", "k")),
        ("ver_put_dir", lambda c, ctx: c.put_object("ver", "d/x", b"dx")),
        ("ver_put_z", lambda c, ctx: c.put_object("ver", "z", b"zz")),
        ("versions_all", lambda c, ctx: c.request(
            "GET", "/ver", query={"versions": ""})),
        ("versions_paged_1", versions_paged(1)),
        ("versions_paged_2_delim", versions_paged(2, delimiter="/")),
        ("versions_prefix_url", lambda c, ctx: c.request(
            "GET", "/ver", query={"versions": "", "prefix": "d/",
                                  "encoding-type": "url"})),
        ("versions_bad_max", lambda c, ctx: c.request(
            "GET", "/ver", query={"versions": "", "max-keys": "x"})),
        ("versions_unversioned_bucket", lambda c, ctx: c.request(
            "GET", "/mpu", query={"versions": ""})),
        ("versions_no_bucket", lambda c, ctx: c.request(
            "GET", "/nobkt", query={"versions": ""})),
        ("multi_delete_versioned", lambda c, ctx: c.request(
            "POST", "/ver", query={"delete": ""},
            body=b"<Delete><Object><Key>z</Key></Object></Delete>")),
        ("versions_after_multi_delete", lambda c, ctx: c.request(
            "GET", "/ver", query={"versions": ""})),
    ]


STEPS = _steps()
STEP_NAMES = [name for name, _ in STEPS]
assert len(set(STEP_NAMES)) == len(STEP_NAMES)

_VID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_INITIATED = re.compile(rb"<Initiated>[^<]*</Initiated>")


def _norm_run(results: dict, ctx: dict, endpoint: str) -> dict:
    """Each step's (status, headers, body) normalized: test_torch_server's
    fields, the run's upload ids and version ids by their order of
    appearance, and the server's endpoint."""
    vids: dict = {}
    out = {}
    for name in STEP_NAMES:
        status, headers, body = _normalize(results[name])
        for key, uid in sorted(ctx.items()):
            if uid:
                body = body.replace(uid.encode(), f"<upload:{key}>".encode())
        body = _VID.sub(
            lambda m: b"<vid:%d>" % vids.setdefault(m.group(0), len(vids)),
            body)
        body = body.replace(endpoint.encode(), b"<endpoint>")
        body = _INITIATED.sub(b"<Initiated/>", body)
        headers = {k: v.replace(endpoint, "<endpoint>")
                   for k, v in headers.items()}
        out[name] = (status, headers, body)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fixed = types.SimpleNamespace(time_ns=lambda: CREATED_NS,
                                  monotonic=time.monotonic)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        mp.setattr(jbucket_meta, "time", fixed)
        mp.setattr(tbucket_meta, "time", fixed)
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("objservers")
        out = {}
        for kind in ("jax", "port"):
            roots = [str(base / f"{kind}{i}") for i in range(N)]
            srv = _start(kind, roots)
            srv.object_layer.min_part_size = MIN_PART
            subs = [srv.events.subscribe_listener(b) for b in ("mpu", "ver")]
            try:
                client = S3Client(srv.endpoint)
                ctx: dict = {}
                results = {name: _res(fn(client, ctx)) for name, fn in STEPS}
                counters = _settled(lambda: _counters(client.request(
                    "GET", "/minio-tpu/prometheus/metrics").body))
                srv.events.flush()
                events = [ev for s in subs for ev in s.drain()]
            finally:
                srv.shutdown()
            out[kind] = types.SimpleNamespace(
                raw=results, results=_norm_run(results, ctx, srv.endpoint),
                counters=counters, roots=roots, ctx=ctx, events=events,
            )
        yield out
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.mark.parametrize("step", STEP_NAMES)
def test_same_response(runs, step):
    assert runs["port"].results[step] == runs["jax"].results[step]


def test_sequence_exercised_the_routes(runs):
    """The comparison is not vacuous: the ported routes succeeded, and
    none answers NotImplemented naming a slice."""
    res = runs["port"].raw
    want_etag = hashlib.md5(b"".join(
        hashlib.md5(p).digest() for p in PARTS)).hexdigest() + "-3"
    assert res["complete_big"][0] == 200
    assert f'"{want_etag}"'.encode() in res["complete_big"][2]
    assert res["get_big"][2] == BIG
    assert res["get_big_cross_range"][2] == BIG[CROSS[0]:CROSS[1] + 1]
    assert res["get_asm"][2] == (BIG[CROSS[0]:CROSS[1] + 1]
                                 + SRC[100:101 + 2 * BLOCK] + SRC
                                 + b"tail bytes")
    assert res["get_copy_big"][2] == BIG
    assert res["copy_replace"][0] == 200
    assert res["head_copy_replace"][1]["content-type"] == "x/new"
    assert res["head_self_copy"][1]["x-amz-meta-k"] == "changed"
    assert res["copy_self_without_replace"][0] == 400
    assert res["part_copy_open_range"][0] == 400
    assert b"<Deleted><Key>nokey</Key></Deleted>" in res[
        "multi_delete_verbose"][2]
    assert b"<Deleted>" not in res["multi_delete_quiet"][2]
    assert res["get_after_multi_delete"][0] == 404
    assert res["post_policy_ok"][0] == 201
    assert res["post_policy_default_status"][0] == 204
    assert res["post_policy_bad_signature"][0] == 403
    assert res["get_posted"][2] == b"form bytes"
    assert res["abort_gone"][0] == 204
    assert res["abort_gone_again"][0] == 404
    assert b"<DeleteMarker>" in res["versions_all"][2]
    assert res["versions_paged_1"][2].count(b"<ListVersionsResult") > 3
    for name in STEP_NAMES:
        # no route answers the port's "not ported yet" refusal
        assert b"(slice " not in res[name][2], name


def test_request_counters_equal(runs):
    assert runs["port"].counters and (
        runs["port"].counters == runs["jax"].counters)


def test_event_records_equal(runs):
    """ObjectCreated:Copy / CompleteMultipartUpload / Post and one
    ObjectRemoved per key of a multi-delete, the same in both."""
    def norm(events):
        return sorted((ev.name, ev.bucket, ev.object_key, ev.etag, ev.size,
                       bool(ev.version_id)) for ev in events)

    got = norm(runs["port"].events)
    assert got == norm(runs["jax"].events)
    names = {e[0] for e in got}
    for want in ("s3:ObjectCreated:Copy",
                 "s3:ObjectCreated:CompleteMultipartUpload",
                 "s3:ObjectCreated:Post", "s3:ObjectRemoved:Delete",
                 "s3:ObjectRemoved:DeleteMarkerCreated"):
        assert want in names, want
    removed = [e[2] for e in got if e[0] == "s3:ObjectRemoved:Delete"]
    assert {"cp-copy", "nokey", "cp-replace", "nokey2"} - set(removed) == {
        "nokey", "nokey2"}


def _norm_objects(run, disk):
    out = []
    for rel, docs, parts in _objects(run.roots[disk]):
        for key, uid in run.ctx.items():
            if uid:
                rel = rel.replace(uid, f"<upload:{key}>")
        out.append((rel, docs, parts))
    return out


@pytest.mark.parametrize("disk", range(N))
def test_disks_equal(runs, disk):
    jax_objs = _norm_objects(runs["jax"], disk)
    port_objs = _norm_objects(runs["port"], disk)
    assert [o[0] for o in port_objs] == [o[0] for o in jax_objs]
    assert any(o[0].startswith("mpu/big") for o in port_objs)
    for (rel, tdocs, tparts), (_rel, jdocs, jparts) in zip(
        port_objs, jax_objs
    ):
        assert tdocs == jdocs, rel
        assert tparts == jparts, rel


# -- the port alone: concurrency and the seams --------------------------------


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("port-objects")
        srv = _start("port", [str(base / f"d{i}") for i in range(N)])
        srv.object_layer.min_part_size = MIN_PART
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        yield srv, c
        srv.shutdown()
        tbackend.reset_backend()


def test_concurrent_copies_and_part_uploads(port_server, tmp_path):
    """Four clients at once on their own connections: two copy (one
    CopyObject, one UploadPartCopy: a decode feeding an encode inside the
    request) while two upload parts.  Nothing blocks, every body comes
    back, and the part files equal those the JAX package writes for the
    same operations one at a time."""
    srv, c = port_server
    srcs = {f"src{t}": _pay(6 * BLOCK + t, 40 + t) for t in range(2)}
    for k, v in srcs.items():
        assert c.put_object("bkt", k, v).status == 200
    parts = {t: [_pay(2 * BLOCK + t, 50 + t), _pay(BLOCK + 3, 60 + t)]
             for t in (2, 3)}

    def client(t):
        cl = S3Client(srv.endpoint)
        if t == 0:
            r = cl.put_object("bkt", "copied", b"", headers={
                "x-amz-copy-source": "/bkt/src0"})
            assert r.status == 200, r.body
            return
        key = f"mp{t}"
        uid = _uid(cl.request("POST", f"/bkt/{key}", query={"uploads": ""}))
        if t == 1:
            r = cl.request("PUT", f"/bkt/{key}",
                           query={"partNumber": "1", "uploadId": uid},
                           headers={"x-amz-copy-source": "/bkt/src1",
                                    "x-amz-copy-source-range":
                                        f"bytes=0-{3 * BLOCK - 1}"})
            assert r.status == 200, r.body
            etags = [(1, _md5(srcs["src1"][:3 * BLOCK]))]
        else:
            etags = []
            for n, p in enumerate(parts[t], 1):
                r = cl.request("PUT", f"/bkt/{key}",
                               query={"partNumber": str(n), "uploadId": uid},
                               body=p)
                assert r.status == 200, r.body
                etags.append((n, _md5(p)))
        r = cl.request("POST", f"/bkt/{key}", query={"uploadId": uid},
                       body=_xml(etags))
        assert r.status == 200, r.body

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(client, t) for t in range(4)]:
            f.result(timeout=120)
    want = {
        "copied": srcs["src0"], "mp1": srcs["src1"][:3 * BLOCK],
        "mp2": b"".join(parts[2]), "mp3": b"".join(parts[3]),
    }
    for k, v in want.items():
        assert c.get_object("bkt", k).body == v, k
        # a concurrent write can miss a disk when another request prunes
        # .sys/tmp under it (XLStorage, the same in both packages): heal
        # restores the shard a quorum-acknowledged write left out
        srv.object_layer.heal_object("bkt", k)
    roots = [str(tmp_path / f"j{i}") for i in range(N)]
    ref = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                     block_size=BLOCK)
    ref.min_part_size = MIN_PART
    ref.make_bucket("bkt")
    ref.put_object("bkt", "copied", io.BytesIO(want["copied"]),
                   len(want["copied"]))
    for k, ps in (("mp1", [want["mp1"]]), ("mp2", parts[2]),
                  ("mp3", parts[3])):
        uid = ref.new_multipart_upload("bkt", k)
        done = [ref.put_object_part("bkt", k, uid, n, io.BytesIO(p), len(p))
                for n, p in enumerate(ps, 1)]
        ref.complete_multipart_upload(
            "bkt", k, uid,
            [japi.CompletePart(p.part_number, p.etag) for p in done])
    port_roots = [d.root for d in _xl_disks(srv.object_layer)]
    for pr, jr in zip(port_roots, roots):
        have = {o[0]: o[2] for o in _objects(pr)}
        for rel, _docs, jparts in _objects(jr):
            if rel.startswith("bkt"):
                assert have[rel] == jparts, rel


# slice 8's seams, refused before: (name, expected status, request), sent
# to a JAX and a port server alike
SSE_SEAMS = [
    ("copy_sse_header", 200, lambda c: c.put_object(
        "bkt", "c", b"", headers={
            "x-amz-copy-source": "/bkt/obj",
            "x-amz-server-side-encryption": "AES256"})),
    ("copy_sse_header_get", 200, lambda c: c.get_object("bkt", "c")),
    ("copy_source_sse_c", 400, lambda c: c.put_object(
        "bkt", "c", b"", headers={
            "x-amz-copy-source": "/bkt/obj",
            "x-amz-copy-source-server-side-encryption-customer-algorithm":
                "AES256"})),
    ("initiate_sse", 200, lambda c: c.request(
        "POST", "/bkt/m", query={"uploads": ""},
        headers={"x-amz-server-side-encryption": "AES256"})),
    ("initiate_compressed", 200, lambda c: c.request(
        "POST", "/bkt/m.txt", query={"uploads": ""})),
]


@pytest.fixture(scope="module")
def sse_servers(tmp_path_factory):
    """A JAX and a port server over plain HTTP, one master key in both
    packages' KMS, MINIO_TPU_COMPRESS=on; ``bkt/obj`` stored in each."""
    from minio_tpu.codec import kms as jkms
    from minio_tpu_torch.codec import kms as tkms

    mk = bytes(range(32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        mp.setenv("MINIO_TPU_COMPRESS", "on")
        tkms.set_kms(tkms.MasterKeyKMS("mk1", mk))
        jkms.set_kms(jkms.MasterKeyKMS("mk1", mk))
        base = tmp_path_factory.mktemp("sse-seams")
        srvs = {
            kind: _start(kind, [str(base / f"{kind}{i}") for i in range(N)])
            for kind in ("jax", "port")
        }
        clients = {k: S3Client(v.endpoint) for k, v in srvs.items()}
        for c in clients.values():
            assert c.make_bucket("bkt").status == 200
            assert c.put_object("bkt", "obj", SRC).status == 200
        try:
            yield srvs, clients
        finally:
            for srv in srvs.values():
                srv.shutdown()
            for mod in (tkms, jkms):
                mod.set_kms(None)
                mod.reset_kms_cache()


@pytest.mark.parametrize("name,status,send", SSE_SEAMS,
                         ids=[u[0] for u in SSE_SEAMS])
def test_sse_seams_answer_as_the_reference(sse_servers, name, status, send):
    """CopyObject to an SSE-S3 destination, a copy source's SSE-C
    headers over plain HTTP, and an upload initiated encrypted or
    compressed answer as the JAX package's server answers them."""
    _srvs, clients = sse_servers
    got = {}
    for kind, c in clients.items():
        st, hdrs, body = _normalize(_res(send(c)))
        body = re.sub(rb"<UploadId>[^<]+</UploadId>", b"<UploadId/>", body)
        got[kind] = (st, hdrs, body)
    assert got["port"] == got["jax"]
    assert got["port"][0] == status, got["port"]
    if name == "copy_sse_header_get":
        assert got["port"][2] == SRC
        assert got["port"][1]["x-amz-server-side-encryption"] == "AES256"
    if name == "initiate_sse":
        assert got["port"][1]["x-amz-server-side-encryption"] == "AES256"


# slice 9c's seams on copies and uploads, refused before: (name,
# expected status, request), sent to a JAX and a port server alike
TAG_LOCK_SEAMS = [
    ("copy_tagging_directive", 200, lambda c: c.put_object(
        "bkt", "c", b"", headers={"x-amz-copy-source": "/bkt/obj",
                                  "x-amz-tagging-directive": "REPLACE"})),
    ("copy_tagging", 200, lambda c: c.put_object(
        "bkt", "c", b"", headers={"x-amz-copy-source": "/bkt/obj",
                                  "x-amz-tagging": "a=b"})),
    ("copy_legal_hold", 400, lambda c: c.put_object(
        "bkt", "c", b"", headers={"x-amz-copy-source": "/bkt/obj",
                                  "x-amz-object-lock-legal-hold": "ON"})),
    ("initiate_tagging", 200, lambda c: c.request(
        "POST", "/bkt/m", query={"uploads": ""},
        headers={"x-amz-tagging": "a=b"})),
    ("initiate_retention", 400, lambda c: c.request(
        "POST", "/bkt/m", query={"uploads": ""},
        headers={"x-amz-object-lock-mode": "GOVERNANCE"})),
]


@pytest.mark.parametrize("name,status,send", TAG_LOCK_SEAMS,
                         ids=[u[0] for u in TAG_LOCK_SEAMS])
def test_tag_and_lock_seams_answer_as_the_reference(sse_servers, name,
                                                    status, send):
    """Tags and lock headers on a copy or an initiated upload answer as
    the JAX package's server answers them: tags stamp the new version,
    lock headers on a bucket without object lock are refused."""
    _srvs, clients = sse_servers
    got = {}
    for kind, c in clients.items():
        st, hdrs, body = _normalize(_res(send(c)))
        body = re.sub(rb"<UploadId>[^<]+</UploadId>", b"<UploadId/>", body)
        got[kind] = (st, hdrs, body)
    assert got["port"] == got["jax"]
    assert got["port"][0] == status, got["port"]
    if name == "copy_tagging":
        tags = {k: c.request("GET", "/bkt/c", query={"tagging": ""}).body
                for k, c in clients.items()}
        assert tags["port"] == tags["jax"]
        assert b"<Key>a</Key><Value>b</Value>" in tags["port"]


_REPL_DOC = (
    "<ReplicationConfiguration><Rule><Status>Enabled</Status>"
    "<Priority>1</Priority><Prefix></Prefix><Destination><Bucket>"
    "arn:minio:replication:::mpcfg-dst</Bucket></Destination></Rule>"
    "</ReplicationConfiguration>"
)
_NOTIFY_DOC = (
    "<NotificationConfiguration><QueueConfiguration><Id>1</Id>"
    "<Queue>arn:minio:sqs::mem:memory</Queue>"
    "<Event>s3:ObjectCreated:*</Event><Event>s3:ObjectRemoved:*</Event>"
    "</QueueConfiguration></NotificationConfiguration>"
)


def _memory_target(kind: str, srv):
    """Register a MemoryTarget of the server's package on its notifier."""
    if kind == "jax":
        from minio_tpu.event import MemoryTarget
    else:
        from minio_tpu_torch.event import MemoryTarget
    mem = MemoryTarget("mem")
    srv.events.register_target(mem)
    return mem


def _records(srv, mem) -> list:
    assert srv.events.flush()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and srv.events._queue:
        time.sleep(0.02)
    time.sleep(0.1)
    return [(r["EventName"], r["Key"], r["Records"][0]["s3"]["object"]["size"])
            for r in mem.records]


@pytest.mark.parametrize("field", [
    "replication_xml", "notification_xml",
])
def test_copy_and_multipart_apply_replication_and_events(sse_servers, field):
    """A destination bucket whose document configures replication or
    event rules (once refused naming slice 9c) applies it to a copy and
    to a completed upload, as the JAX package does: both are stamped
    PENDING, queued and replicated to COMPLETED, or both fire their
    ObjectCreated records."""
    srvs, clients = sse_servers
    bucket = "mpcfg-" + field.split("_")[0]
    got = {}
    for kind, c in clients.items():
        srv = srvs[kind]
        assert c.make_bucket(bucket).status == 200
        mem = None
        if field == "replication_xml":
            assert c.make_bucket("mpcfg-dst").status == 200
            srv.bucket_meta.update(bucket, versioning="Enabled",
                                   replication_xml=_REPL_DOC)
        else:
            mem = _memory_target(kind, srv)
            srv.bucket_meta.update(bucket, notification_xml=_NOTIFY_DOC)
            srv.invalidate_event_rules(bucket)
        uid = _uid(c.request("POST", f"/{bucket}/m", query={"uploads": ""}))
        r = c.request("PUT", f"/{bucket}/m",
                      query={"partNumber": "1", "uploadId": uid}, body=b"p")
        assert r.status == 200
        copy = c.put_object(bucket, "c", b"", headers={
            "x-amz-copy-source": "/bkt/obj"})
        done = c.request("POST", f"/{bucket}/m", query={"uploadId": uid},
                         body=_xml([(1, _md5(b"p"))]))
        answers = [_normalize(_res(r))[:1] for r in (copy, done)]
        if field == "replication_xml":
            srv.replication.drain()
            heads = [srv.object_layer.get_object_info(bucket, k).user_defined.get(
                "x-amz-replication-status") for k in ("c", "m")]
            if kind == "port":
                # the port's HEAD shows the status, as the reference's does
                assert [c.request("HEAD", f"/{bucket}/{k}").headers.get(
                    "x-amz-replication-status") for k in ("c", "m")] == heads
            dst = [c.get_object("mpcfg-dst", k).body for k in ("c", "m")]
            got[kind] = (answers, heads, dst)
            srv.bucket_meta.update(bucket, replication_xml="")
        else:
            got[kind] = (answers, _records(srv, mem))
            srv.bucket_meta.update(bucket, notification_xml="")
            srv.invalidate_event_rules(bucket)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [(200,), (200,)]
    if field == "replication_xml":
        assert got["port"][1:] == (["COMPLETED"] * 2, [SRC, b"p"])
    else:
        assert [r[0] for r in got["port"][1]] == [
            "s3:ObjectCreated:Copy", "s3:ObjectCreated:CompleteMultipartUpload"]


@pytest.mark.parametrize("field,value", [
    ("quota_json", '{"quota": 3, "quotatype": "hard"}'),
    ("object_lock_xml",
     "<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
     "</ObjectLockEnabled><Rule><DefaultRetention><Mode>COMPLIANCE</Mode>"
     "<Years>1</Years></DefaultRetention></Rule></ObjectLockConfiguration>"),
])
def test_copy_and_multipart_apply_bucket_config(sse_servers, field, value):
    """A destination bucket that sets a quota or object lock applies it
    to a copy and to the multipart routes, as the JAX package does: the
    quota refuses the copy and the part, the lock default stamps the
    copy and the completed upload."""
    srvs, clients = sse_servers
    bucket = "mpcfg-" + field.split("_")[0]
    got = {}
    for kind, c in clients.items():
        assert c.make_bucket(bucket).status == 200
        uid = _uid(c.request("POST", f"/{bucket}/m", query={"uploads": ""}))
        srvs[kind].bucket_meta.update(bucket, **{field: value})
        copy = c.put_object(bucket, "c", b"", headers={
            "x-amz-copy-source": "/bkt/obj"})
        part = c.request("PUT", f"/{bucket}/m",
                         query={"partNumber": "1", "uploadId": uid},
                         body=b"part")
        uid2 = _uid(c.request("POST", f"/{bucket}/m2",
                              query={"uploads": ""}))
        ret = c.request("GET", f"/{bucket}/c", query={"retention": ""})
        got[kind] = [_normalize(_res(r))[:1] + (r.error_code,)
                     for r in (copy, part, ret)] + [bool(uid2)]
        srvs[kind].bucket_meta.update(bucket, **{field: ""})
    assert got["port"] == got["jax"]
    if field == "quota_json":
        assert got["port"][0] == (400, "XMinioAdminBucketQuotaExceeded")
        assert got["port"][1] == (400, "XMinioAdminBucketQuotaExceeded")
    else:
        assert got["port"][0][0] == 200 and got["port"][2][0] == 200


def test_multi_delete_and_post_policy_events_seam(sse_servers):
    """A bucket with event rules (once refused naming slice 9c) fires a
    record for a POST-policy upload and each key of a multi-delete, as
    the JAX package's server does."""
    srvs, clients = sse_servers
    got = {}
    for kind, c in clients.items():
        srv = srvs[kind]
        assert c.make_bucket("evt").status == 200
        assert c.put_object("evt", "k", b"v").status == 200
        mem = _memory_target(kind, srv)
        srv.bucket_meta.update("evt", notification_xml=_NOTIFY_DOC)
        srv.invalidate_event_rules("evt")
        status, _h, body = _res(c.post_policy_upload("evt", "p", b"x"))
        r = c.request("POST", "/evt", query={"delete": ""},
                      body=b"<Delete><Object><Key>k</Key></Object>"
                      b"<Object><Key>p</Key></Object></Delete>")
        got[kind] = (status, r.status, _records(srv, mem))
        srv.bucket_meta.update("evt", notification_xml="")
        srv.invalidate_event_rules("evt")
    assert got["port"] == got["jax"]
    assert [e[0] for e in got["port"][2]] == [
        "s3:ObjectCreated:Post", "s3:ObjectRemoved:Delete",
        "s3:ObjectRemoved:Delete"]


def test_counters_name_the_new_routes(runs):
    """The request counters book each new route under its API name (the
    IAM action it authorizes as), as the JAX package's do."""
    apis = {re.search(r'api="([^"]+)"', s).group(1)
            for s in runs["port"].counters}
    for name in ("PutObject", "ListMultipartUploadParts",
                 "ListBucketMultipartUploads", "AbortMultipartUpload",
                 "ListBucketVersions"):
        assert name in apis, (name, sorted(apis))
