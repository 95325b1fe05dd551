"""The port's ErasureSets and ErasureZones held against minio_tpu's.

Twin drive trees: the same operations go through the JAX package's
``ErasureSets`` / ``ErasureZones`` and through the port's (codec on the
CPU) - PUTs routed to both sets, GETs whole and ranged, a copy across
sets and one within a set, deletes, a multipart upload, listings paged
and by delimiter, version listings, uploads in progress and storage
info.  Every answer must be equal up to volatile fields (mod times,
version ids, upload ids mapped by position), and afterwards every
drive's shard files byte-equal and its ``xl.meta`` equal up to mod
time, data dir and version id.

Zones place new objects by free space; both packages read the same
fixed free-space figures here (``_zone_space`` patched), so placement
is a function of the key alone.  Concurrent PUTs to both sets share one
codec batcher: merged flushes must scatter each job's result back to
its own set (the shard files equal the JAX package's, written one at a
time).  ``crc_hash_mod`` is held to the JAX package's by hypothesis.
"""

import concurrent.futures
import io
import os
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import sets as jsets, zones as jzones
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer import sets as tsets, zones as tzones
from minio_tpu_torch.objectlayer.api import CompletePart
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096
PER_SET = 12
PARITY = 4


@settings(max_examples=300, deadline=None)
@given(st.text(max_size=64), st.integers(min_value=-2, max_value=64))
def test_crc_hash_mod_matches(key, cardinality):
    assert tsets.crc_hash_mod(key, cardinality) == jsets.crc_hash_mod(
        key, cardinality
    )


def _pay(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _tree(root: str) -> list:
    """(object path, xl.meta versions up to volatile fields, part files)
    for every object of every user bucket under one drive root."""
    out = []
    for bucket in sorted(os.listdir(root)):
        if bucket.startswith("."):
            continue
        base = os.path.join(root, bucket)
        for dirpath, dirnames, files in sorted(os.walk(base)):
            dirnames.sort()
            if "xl.meta" not in files:
                continue
            dirnames[:] = []
            with open(os.path.join(dirpath, "xl.meta"), "rb") as f:
                versions = XLMeta.from_bytes(f.read()).versions
            docs, parts = [], []
            for v in versions:
                d = v.to_dict()
                data_dir = d.get("data_dir", "")
                for volatile in ("mod_time_ns", "data_dir", "version_id"):
                    d.pop(volatile, None)
                docs.append(d)
                ddir = os.path.join(dirpath, data_dir) if data_dir else ""
                if ddir and os.path.isdir(ddir):
                    for name in sorted(os.listdir(ddir)):
                        with open(os.path.join(ddir, name), "rb") as f:
                            parts.append((name, f.read()))
            out.append((os.path.relpath(dirpath, root), docs, parts))
    return out


def _info(oi) -> tuple:
    return (oi.bucket, oi.name, oi.size, oi.etag, oi.is_dir,
            oi.delete_marker, bool(oi.version_id))


def _listing(res) -> tuple:
    return ([_info(o) for o in res.objects], list(res.prefixes),
            res.is_truncated, res.next_marker)


def _get(ol, bucket, key, **kw) -> bytes:
    buf = io.BytesIO()
    ol.get_object(bucket, key, buf, **kw)
    return buf.getvalue()


def _outcome(fn):
    try:
        return True, fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return False, type(e).__name__


# keys that crc_hash_mod spreads over both sets
KEYS = [f"dir/obj{i}" for i in range(6)] + ["top", "z/last"]


def _script(ol, upload_ids: list) -> dict:
    """The operation sequence, run against one object layer; answers by
    step name (upload ids collected in order for mapping)."""
    out = {}
    ol.make_bucket("bkt")
    out["make_dup"] = _outcome(lambda: ol.make_bucket("bkt"))
    sizes = {k: BLOCK * (i % 4) + 37 * i + 1 for i, k in enumerate(KEYS)}
    for i, k in enumerate(KEYS):
        data = _pay(sizes[k], i)
        out[f"put:{k}"] = _info(ol.put_object("bkt", k, io.BytesIO(data),
                                              len(data)))
    for k in KEYS:
        out[f"get:{k}"] = _get(ol, "bkt", k)
        out[f"info:{k}"] = _info(ol.get_object_info("bkt", k))
    out["range"] = _get(ol, "bkt", "dir/obj3", offset=BLOCK - 5, length=99)
    out["get_missing"] = _outcome(lambda: ol.get_object_info("bkt", "nope"))
    # copy across sets and within a set
    src, cross, same = "dir/obj1", None, None
    sets = getattr(ol, "sets", None) or ol.zones[0].sets
    route = ol.set_for if hasattr(ol, "set_for") else ol.zones[0].set_for
    for cand in (f"copy/{i}" for i in range(50)):
        if cross is None and route(cand) is not route(src):
            cross = cand
        if same is None and route(cand) is route(src):
            same = cand
    assert cross and same and len(sets) >= 2
    out["copy_cross"] = _info(ol.copy_object("bkt", src, "bkt", cross,
                                             {"x-amz-meta-k": "v"}))
    out["copy_same"] = _info(ol.copy_object("bkt", src, "bkt", same))
    out["get_copy"] = (_get(ol, "bkt", cross), _get(ol, "bkt", same))
    # multipart
    mp_key = "mp/object"
    uid = ol.new_multipart_upload("bkt", mp_key, {"content-type": "a/b"})
    upload_ids.append(uid)
    parts = [_pay(BLOCK + 11, 50), _pay(2 * BLOCK, 51), _pay(33, 52)]
    etags = []
    for n, p in enumerate(parts, 1):
        pi = ol.put_object_part("bkt", mp_key, uid, n, io.BytesIO(p), len(p))
        etags.append(pi.etag)
    out["list_parts"] = [
        (p.part_number, p.size, p.etag)
        for p in ol.list_object_parts("bkt", mp_key, uid)
    ]
    pending = ol.new_multipart_upload("bkt", "mp/pending")
    upload_ids.append(pending)
    out["uploads"] = [(u.object, upload_ids.index(u.upload_id))
                      for u in ol.list_multipart_uploads("bkt")]
    out["complete"] = _info(ol.complete_multipart_upload(
        "bkt", mp_key, uid,
        [CompletePart(n, e) for n, e in enumerate(etags, 1)]))
    out["get_mp"] = _get(ol, "bkt", mp_key)
    ol.abort_multipart_upload("bkt", "mp/pending", pending)
    out["uploads_after"] = len(ol.list_multipart_uploads("bkt"))
    out["bad_upload"] = _outcome(lambda: ol.put_object_part(
        "bkt", mp_key, "9.nope", 1, io.BytesIO(b"x"), 1))
    # listings
    out["list_all"] = _listing(ol.list_objects("bkt"))
    out["list_delim"] = _listing(ol.list_objects("bkt", delimiter="/"))
    out["list_prefix"] = _listing(ol.list_objects("bkt", prefix="dir/"))
    pages, marker = [], ""
    while True:
        res = ol.list_objects("bkt", marker=marker, max_keys=3)
        pages.append(_listing(res))
        if not res.is_truncated:
            break
        marker = res.next_marker
    out["list_paged"] = pages
    lv = ol.list_object_versions("bkt", max_keys=4)
    out["versions"] = ([_info(v) for v in lv.versions], lv.is_truncated,
                       lv.next_key_marker)
    # deletes
    out["delete"] = _outcome(lambda: ol.delete_object("bkt", "top").name)
    out["get_deleted"] = _outcome(lambda: _get(ol, "bkt", "top"))
    out["delete_bucket_full"] = _outcome(lambda: ol.delete_bucket("bkt"))
    out["heal_bucket"] = sorted(map(tuple, ol.heal_bucket("bkt")["healed"]))
    out["heal_object"] = ol.heal_object("bkt", "dir/obj2")["healed"]
    out["buckets"] = [b.name for b in ol.list_buckets()]
    out["storage"] = ol.storage_info()
    return out


def _sets(kind: str, roots: list, count: int):
    mod = jsets if kind == "jax" else tsets
    storage = JaxStorage if kind == "jax" else XLStorage
    kw = {} if kind == "jax" else {"device": "cpu"}
    per = len(roots) // count
    ol = mod.ErasureSets([storage(r) for r in roots], count, per,
                         parity_blocks=min(PARITY, per // 2),
                         block_size=BLOCK, **kw)
    for s in ol.sets:
        s.min_part_size = 1
    return ol


@pytest.fixture(scope="module")
def backends():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        yield mp
        jbackend.reset_backend()
        tbackend.reset_backend()


@pytest.fixture(scope="module")
def two_sets(tmp_path_factory, backends):
    base = tmp_path_factory.mktemp("sets")
    out = {}
    for kind in ("jax", "port"):
        roots = [str(base / f"{kind}{i}") for i in range(2 * PER_SET)]
        ids: list = []
        out[kind] = (_script(_sets(kind, roots, 2), ids), roots, ids)
    return out


def _zone_space(self, zone):
    """Fixed free space: zone with 8 drives 3 TB of 4, the other 1 of 2."""
    return ((3 << 40, 4 << 40) if len(zone.sets) * zone.drives_per_set == 8
            else (1 << 40, 2 << 40))


@pytest.fixture(scope="module")
def two_zones(tmp_path_factory, backends):
    backends.setattr(jzones.ErasureZones, "_zone_space", _zone_space)
    backends.setattr(tzones.ErasureZones, "_zone_space", _zone_space)
    base = tmp_path_factory.mktemp("zones")
    out = {}
    for kind in ("jax", "port"):
        roots = [str(base / f"{kind}{i}") for i in range(12)]
        mod = jzones if kind == "jax" else tzones
        layer = mod.ErasureZones([_sets(kind, roots[:8], 2),
                                  _sets(kind, roots[8:], 1)])
        ids: list = []
        out[kind] = (_script(layer, ids), roots, ids, layer)
    return out


def _map_ids(doc, jids, tids):
    if isinstance(doc, str):
        for j, t in zip(jids, tids):
            doc = doc.replace(t, j)
        return doc
    if isinstance(doc, (list, tuple)):
        return type(doc)(_map_ids(d, jids, tids) for d in doc)
    if isinstance(doc, dict):
        return {k: _map_ids(v, jids, tids) for k, v in doc.items()}
    return doc


def test_sets_answers_equal(two_sets):
    jres, _jr, jids = two_sets["jax"]
    tres, _tr, tids = two_sets["port"]
    assert sorted(tres) == sorted(jres)
    for step in jres:
        assert _map_ids(tres[step], jids, tids) == jres[step], step


def test_sets_used_both(two_sets):
    tres, _roots, _ids = two_sets["port"]
    keys = [k for k in KEYS]
    assert {tsets.crc_hash_mod(k, 2) for k in keys} == {0, 1}
    assert tres["delete_bucket_full"] == (False, "BucketNotEmpty")
    assert tres["storage"]["disks"] == 2 * PER_SET


@pytest.mark.parametrize("drive", range(2 * PER_SET))
def test_sets_drive_trees_equal(two_sets, drive):
    jroots, troots = two_sets["jax"][1], two_sets["port"][1]
    jt, tt = _tree(jroots[drive]), _tree(troots[drive])
    assert tt == jt
    assert tt  # every drive holds shards of some object


def test_zones_answers_equal(two_zones):
    jres, _jr, jids, _jl = two_zones["jax"]
    tres, _tr, tids, _tl = two_zones["port"]
    assert sorted(tres) == sorted(jres)
    for step in jres:
        assert _map_ids(tres[step], jids, tids) == jres[step], step
    # upload ids are pinned to their zone by their prefix
    assert [u.split(".", 1)[0] for u in tids] == [
        u.split(".", 1)[0] for u in jids]


def test_zones_placement_spread(two_zones):
    layer = two_zones["port"][3]
    held = {
        zi for k in KEYS if k != "top"
        for zi, z in enumerate(layer.zones)
        if _outcome(lambda z=z, k=k: z.get_object_info("bkt", k))[0]
    }
    assert held == {0, 1}


@pytest.mark.parametrize("drive", range(12))
def test_zones_drive_trees_equal(two_zones, drive):
    jroots, troots = two_zones["jax"][1], two_zones["port"][1]
    assert _tree(troots[drive]) == _tree(jroots[drive])


def test_concurrent_puts_share_one_batcher(tmp_path, backends, monkeypatch):
    """Four clients PUT to both sets at once: one backend (one batcher)
    serves both sets, at least one flush merges jobs of several
    clients, and every drive's files equal the JAX package's written
    one object at a time."""
    monkeypatch.setenv("MINIO_CODEC_BATCH_DEADLINE_MS", "200")
    tbackend.reset_backend()
    try:
        troots = [str(tmp_path / f"t{i}") for i in range(2 * PER_SET)]
        jroots = [str(tmp_path / f"j{i}") for i in range(2 * PER_SET)]
        port, ref = _sets("port", troots, 2), _sets("jax", jroots, 2)
        assert port.sets[0].backend is port.sets[1].backend
        for ol in (port, ref):
            ol.make_bucket("conc")
        objs = {f"c{c}/o{i}": _pay(BLOCK * 8 * (i + 1) + c, 10 * c + i)
                for c in range(4) for i in range(2)}
        assert {tsets.crc_hash_mod(k, 2) for k in objs} == {0, 1}
        for k, v in objs.items():
            ref.put_object("conc", k, io.BytesIO(v), len(v))
        KERNEL_STATS.reset()
        start = threading.Barrier(4)

        def client(c):
            start.wait()
            for i in range(2):
                k = f"c{c}/o{i}"
                port.put_object("conc", k, io.BytesIO(objs[k]), len(objs[k]))

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(client, range(4)))
        batch = KERNEL_STATS.snapshot()["batch"]
        assert batch["multi_client_flushes"] >= 1, batch
        for k, v in objs.items():
            assert _get(port, "conc", k) == v
        for t, j in zip(troots, jroots):
            assert _tree(t) == _tree(j)
    finally:
        tbackend.reset_backend()
