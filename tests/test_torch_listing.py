"""Listing in the port held against minio_tpu's.

The same tree of keys is PUT through both packages' ErasureObjects
(EC 4+2, the port on ``device="cpu"``).  ``XLStorage.walk_sorted`` of
every disk and ``ErasureObjects.list_objects`` must then give the same
answers for nested prefixes, the "/" delimiter and others, markers and
``max_keys`` 0, 1 and 1000 - also with a disk offline and with pages
followed to the end.  Keys below another object's key ("a/b" under "a")
are not listed by either package: an object's directory holds data
dirs, not children.
"""

import io

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import api as tapi
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
KEYS = [
    "a", "a/b", "a/b/c", "a/b/c/d", "a/bb", "a/b-c", "a-b", "ab/c",
    "b/x.txt", "b/y.txt", "b/z/1", "b/z/2", "c.d.e", "c.d/f", "é/ü",
    "sp ace/k", "z",
]
# the deleted key leaves no entry behind
DELETED = "b/y.txt"


def _objs(kind, roots):
    if kind == "jax":
        return JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                          block_size=4096)
    return ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                          block_size=4096, device="cpu")


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("listing")
        out = {}
        for kind in ("jax", "port"):
            roots = [str(base / f"{kind}{i}") for i in range(N)]
            ol = _objs(kind, roots)
            ol.make_bucket("bkt")
            for i, k in enumerate(KEYS):
                data = bytes([i]) * (i * 13)
                ol.put_object("bkt", k, io.BytesIO(data), len(data))
            ol.delete_object("bkt", DELETED)
            out[kind] = (ol, roots)
        yield out
        jbackend.reset_backend()
        tbackend.reset_backend()


WALKS = [
    ("", "", True), ("a/", "", True), ("a/b", "", True), ("b/", "b/x.txt",
                                                          True),
    ("", "a/b/c", True), ("", "", False), ("a/", "", False),
    ("a/b/", "", False), ("b/z/", "", False), ("a", "a/b", False),
    ("c.d", "", False), ("zz", "", True), ("a/b/c", "", False),
]


@pytest.mark.parametrize("prefix,marker,recursive", WALKS)
@pytest.mark.parametrize("inclusive", [False, True])
def test_walk_sorted(layers, prefix, marker, recursive, inclusive):
    for jroot, troot in zip(layers["jax"][1], layers["port"][1]):
        want = list(JaxStorage(jroot).walk_sorted(
            "bkt", prefix, marker, recursive=recursive, inclusive=inclusive))
        got = list(XLStorage(troot).walk_sorted(
            "bkt", prefix, marker, recursive=recursive, inclusive=inclusive))
        assert got == want


@pytest.mark.parametrize("prefix", ["", "a/", "b"])
def test_walk_and_list_dir(layers, prefix):
    jroot, troot = layers["jax"][1][0], layers["port"][1][0]
    assert sorted(XLStorage(troot).walk("bkt", prefix)) == sorted(
        JaxStorage(jroot).walk("bkt", prefix))
    # plain directories only: an object's directory holds its data dirs,
    # whose names are random per PUT
    for d in ("", "b", "b/z"):
        assert XLStorage(troot).list_dir("bkt", d) == \
            JaxStorage(jroot).list_dir("bkt", d)


def _listing(res):
    return (
        res.is_truncated, res.next_marker, list(res.prefixes),
        [(o.name, o.size, o.etag, o.content_type, o.version_id)
         for o in res.objects],
    )


LISTS = [
    ("", "", "", 1000), ("", "", "/", 1000), ("a/", "", "/", 1000),
    ("a/", "", "", 1000), ("a/b", "", "/", 1000), ("", "a/b", "", 1000),
    ("", "a/b/", "/", 1000), ("", "", ".", 1000), ("c", "", ".", 1000),
    ("", "", "b", 1000), ("", "", "", 0), ("", "", "/", 0), ("", "", "", 1),
    ("", "", "/", 1), ("b/", "", "/", 1), ("", "z", "", 1000),
    ("q", "", "", 1000), ("", "", "", 5000), ("é", "", "/", 1000),
]


@pytest.mark.parametrize("prefix,marker,delimiter,max_keys", LISTS)
def test_list_objects(layers, prefix, marker, delimiter, max_keys):
    want = layers["jax"][0].list_objects("bkt", prefix, marker, delimiter,
                                         max_keys)
    got = layers["port"][0].list_objects("bkt", prefix, marker, delimiter,
                                         max_keys)
    assert _listing(got) == _listing(want)


@pytest.mark.parametrize("delimiter", ["", "/", "."])
@pytest.mark.parametrize("page", [1, 2, 3])
def test_paged_to_the_end(layers, delimiter, page):
    def pages(ol):
        out, marker = [], ""
        while True:
            res = ol.list_objects("bkt", "", marker, delimiter, page)
            out.append(_listing(res))
            if not res.is_truncated:
                return out
            marker = res.next_marker

    got = pages(layers["port"][0])
    assert got == pages(layers["jax"][0])
    names = [o[0] for p in got for o in p[3]] + [x for p in got for x in p[2]]
    assert DELETED not in names
    # both packages walk directory names in sorted order, so "c.d/f" comes
    # before "c.d.e" although "/" sorts after "."; a page whose marker
    # passes such a pair skips keys.  The port keeps the reference's
    # answer - the pages above equal the JAX package's - and paging
    # never lists an entry the unpaged listing lacks.
    whole = layers["port"][0].list_objects("bkt", "", "", delimiter, 1000)
    assert names and set(names) <= {o.name for o in whole.objects} | set(
        whole.prefixes)


def test_offline_disk(layers):
    jol, _ = layers["jax"]
    tol, _ = layers["port"]
    jdisks, tdisks = list(jol.disks), list(tol.disks)
    try:
        jol.disks[0] = None
        tol.disks[0] = None
        for args in [("", "", "", 1000), ("a/", "", "/", 1000),
                     ("", "", "/", 2)]:
            assert _listing(tol.list_objects("bkt", *args)) == _listing(
                jol.list_objects("bkt", *args))
        assert tol.list_objects("bkt").objects
    finally:
        jol.disks[:] = jdisks
        tol.disks[:] = tdisks


def test_missing_bucket(layers):
    with pytest.raises(tapi.BucketNotFound):
        layers["port"][0].list_objects("nope")
