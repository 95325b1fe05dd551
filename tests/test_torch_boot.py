"""The port's boot path held against minio_tpu's: drive arguments,
endpoints, format.json and the guarded drive chain.

* ``ellipses.expand`` and ``ellipses.layout`` for every drive count from
  4 to 64 (a count with no valid set size raises the same class);
* bare paths resolve to local endpoints, URLs parse the same way;
* a fresh 2 x 12 ``format.json`` equals the JAX package's byte for byte
  once the ids are mapped by position (deployment id, then each set's
  drive uuids in order);
* reload (drive order shuffled), a foreign drive, the hole fill of a
  wiped drive and a layout mismatch behave alike, failures with the
  same error class name;
* drives formatted and written by the JAX package's ``build_cluster``
  boot in the port's and serve the same GET bodies, and the other way
  round;
* ``DiskIDCheck`` fails a swapped drive fast, and a guarded drive is
  metered exactly once.

Bytes are compared exactly.  The port runs its codec on the CPU.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest

from minio_tpu.cluster import endpoints as jendpoints
from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer import format as jformat
from minio_tpu.server import __main__ as jmain
from minio_tpu.storage import metered as jmetered
from minio_tpu.storage.diskcheck import DiskIDCheck as JaxDiskIDCheck
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu.utils import ellipses as jellipses
from minio_tpu_torch.cluster import endpoints as tendpoints
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer import format as tformat
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.storage import errors as terrors, metered as tmetered
from minio_tpu_torch.storage.diskcheck import DiskIDCheck
from minio_tpu_torch.storage.xl import XLStorage
from minio_tpu_torch.utils import ellipses as tellipses
from tests.test_torch_threads import torch_threads  # noqa: F401

PACKAGES = {
    "jax": (JaxStorage, jformat),
    "port": (XLStorage, tformat),
}


def _outcome(fn):
    """(True, value) or (False, error class name)."""
    try:
        return True, fn()
    except (Exception, SystemExit) as e:  # noqa: BLE001 - the class is the answer
        return False, type(e).__name__


# -- ellipses ----------------------------------------------------------------


@pytest.mark.parametrize("count", range(4, 65))
def test_ellipses_layout_matches(count):
    pattern = f"/data/disk{{1...{count}}}"
    assert tellipses.expand(pattern) == jellipses.expand(pattern)
    assert tellipses.has_ellipses(pattern) and jellipses.has_ellipses(pattern)
    assert _outcome(lambda: tellipses.layout(count)) == _outcome(
        lambda: jellipses.layout(count)
    )


@pytest.mark.parametrize("pattern", [
    "/plain", "d{01...03}", "http://h{1...2}:9000/d{1...3}",
    "/mnt/{a...b}", "d{5...2}", "/x{1...2}/y{07...09}",
])
def test_ellipses_patterns_match(pattern):
    assert _outcome(lambda: tellipses.expand(pattern)) == _outcome(
        lambda: jellipses.expand(pattern)
    )


@pytest.mark.parametrize("args", [
    ["/d{1...4}"], ["/a{1...4}", "/b{1...8}"], ["/d1", "/d2", "/d3", "/d4"],
    ["/a{1...4}", "/d5"],
])
def test_group_zone_args_match(args):
    assert _outcome(lambda: tmain.group_zone_args(args)) == _outcome(
        lambda: jmain.group_zone_args(args)
    )


# -- endpoints ---------------------------------------------------------------


@pytest.mark.parametrize("specs", [
    ["/data/d1", "/data/d2"],
    ["relative/d1"],
    ["http://127.0.0.1:9000/d1", "http://127.0.0.1:9000/d2"],
    ["http://127.0.0.1:9001/d1"],
    ["https://localhost/d1"],
    ["http://127.0.0.1:9000/"],
    ["ftp://127.0.0.1:9000/d1"],
    ["/data/d1", "http://127.0.0.1:9000/d2"],
])
def test_endpoint_resolution_matches(specs):
    def fields(mod):
        return [
            (e.raw, e.scheme, e.host, e.port, e.path, e.is_local, e.is_url)
            for e in mod.resolve_endpoints(specs, 9000)
        ]

    got = _outcome(lambda: fields(tendpoints))
    assert got == _outcome(lambda: fields(jendpoints))


def test_bare_paths_are_local():
    eps = tendpoints.resolve_endpoints(["/a/d1", "/a/d2"], 0)
    assert [(e.path, e.is_local, e.is_url) for e in eps] == [
        ("/a/d1", True, False), ("/a/d2", True, False)]


# -- format.json -------------------------------------------------------------


def _fresh(base, kind: str, n: int, sets: int, per: int):
    storage, fmt = PACKAGES[kind]
    disks = [storage(str(base / f"{kind}{i}")) for i in range(n)]
    ref, ordered = fmt.load_or_init_format(disks, sets, per)
    return disks, ref, ordered


def _id_map(jref, tref) -> dict:
    """JAX ids -> port ids, by position."""
    out = {jref.id: tref.id}
    for jset, tset in zip(jref.sets, tref.sets):
        out.update(zip(jset, tset))
    return out


def _mapped(raw: bytes, ids: dict) -> bytes:
    text = raw.decode()
    for j, t in ids.items():
        text = text.replace(j, t)
    return text.encode()


def _format_bytes(disk) -> bytes:
    with open(os.path.join(disk.root, ".sys", "format.json"), "rb") as f:
        return f.read()


def test_fresh_format_equal_by_position(tmp_path):
    jdisks, jref, jordered = _fresh(tmp_path, "jax", 24, 2, 12)
    tdisks, tref, tordered = _fresh(tmp_path, "port", 24, 2, 12)
    ids = _id_map(jref, tref)
    assert len(ids) == 1 + 24  # every id distinct
    for jd, td in zip(jdisks, tdisks):
        assert _mapped(_format_bytes(jd), ids) == _format_bytes(td)
        assert ids[jd.get_disk_id()] == td.get_disk_id()
        assert td.disk_info().disk_id == td.get_disk_id()
    doc = json.loads(_format_bytes(tdisks[0]))
    assert list(doc) == ["version", "format", "id", "erasure"]
    assert list(doc["erasure"]) == ["version", "this", "sets",
                                    "distributionAlgo"]
    assert [d.root for d in tordered] == [d.root for d in tdisks]


def test_reload_shuffled_keeps_order(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, ref, ordered = _fresh(tmp_path, kind, 8, 2, 4)
        fmt = PACKAGES[kind][1]
        ref2, ordered2 = fmt.load_or_init_format(list(reversed(disks)), 2, 4)
        res[kind] = (
            ref2.id == ref.id, ref2.sets == ref.sets,
            [disks.index(d) for d in ordered2],
        )
    assert res["port"] == res["jax"] == (True, True, list(range(8)))


def test_foreign_drive_refused(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, _ref, _o = _fresh(tmp_path, kind, 4, 1, 4)
        other, _r, _o = _fresh(tmp_path / "other", kind, 4, 1, 4)
        fmt = PACKAGES[kind][1]
        res[kind] = _outcome(
            lambda: fmt.load_or_init_format(disks[:3] + [other[0]], 1, 4)
        )
    assert res["port"] == res["jax"] == (False, "InconsistentDisk")


def test_hole_fill_stamps_slot_uuid(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, ref, _o = _fresh(tmp_path, kind, 4, 1, 4)
        shutil.rmtree(disks[2].root)
        os.makedirs(os.path.join(disks[2].root, ".sys", "tmp"))
        fmt = PACKAGES[kind][1]
        ref2, ordered2 = fmt.load_or_init_format(disks, 1, 4)
        res[kind] = (
            ref2.id == ref.id,
            fmt.read_format(disks[2]).this == ref.sets[0][2],
            getattr(ordered2[2], "_freshly_stamped", False),
            [getattr(d, "_freshly_stamped", False) for d in ordered2],
        )
    assert res["port"] == res["jax"] == (
        True, True, True, [False, False, True, False])


def test_layout_mismatch_refused(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, _ref, _o = _fresh(tmp_path, kind, 4, 1, 4)
        fmt = PACKAGES[kind][1]
        res[kind] = _outcome(lambda: fmt.load_or_init_format(disks, 2, 2))
    assert res["port"] == res["jax"] == (False, "CorruptedFormat")


def test_corrupt_format_refused(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, _ref, _o = _fresh(tmp_path, kind, 4, 1, 4)
        with open(os.path.join(disks[1].root, ".sys", "format.json"),
                  "wb") as f:
            f.write(b'{"format": "xl"}')
        fmt = PACKAGES[kind][1]
        res[kind] = _outcome(lambda: fmt.wait_for_format(disks, 1, 4,
                                                         timeout_s=0.1))
    assert res["port"] == res["jax"] == (False, "CorruptedFormat")


def test_no_quorum_times_out(tmp_path):
    """Two formatted drives of four are no quorum: the boot loop waits,
    then gives up with the same class."""
    res = {}
    for kind in PACKAGES:
        disks, _ref, _o = _fresh(tmp_path, kind, 4, 1, 4)
        for d in disks[2:]:
            os.remove(os.path.join(d.root, ".sys", "format.json"))
        fmt = PACKAGES[kind][1]
        res[kind] = _outcome(lambda: fmt.wait_for_format(
            disks, 1, 4, timeout_s=0.2, poll_s=0.05))
    assert res["port"] == res["jax"] == (False, "UnformattedDisk")


# -- drives written by one package boot in the other -------------------------


def _obj(i: int) -> bytes:
    return np.random.default_rng(100 + i).bytes(3000 * i + 17)


@pytest.fixture
def backends():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        yield
        jbackend.reset_backend()
        tbackend.reset_backend()


def _build(kind: str, pattern: str):
    if kind == "jax":
        ol, _ = jmain.build_cluster([pattern], 0, "", parity=4)
    else:
        ol = tmain.build_object_layer([pattern], parity=4, device="cpu")
    return ol


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_drives_boot_across_packages(tmp_path, backends, writer, reader):
    pattern = str(tmp_path / "disk{1...24}")
    ol = _build(writer, pattern)
    ol.make_bucket("cross")
    objs = {f"k{i}": _obj(i) for i in range(6)}
    for k, v in objs.items():
        ol.put_object("cross", k, io.BytesIO(v), len(v))
    sets_used = {s for k in objs
                 for s in [ol.zones[0].sets.index(ol.zones[0].set_for(k))]}
    assert sets_used == {0, 1}
    first = tformat.read_format(XLStorage(str(tmp_path / "disk1")))
    back = _build(reader, pattern)
    again = tformat.read_format(XLStorage(str(tmp_path / "disk1")))
    assert (again.id, again.this, again.sets) == (first.id, first.this,
                                                  first.sets)
    for k, v in objs.items():
        buf = io.BytesIO()
        back.get_object("cross", k, buf)
        assert buf.getvalue() == v, k
    assert [b.name for b in back.list_buckets()] == ["cross"]
    listed = back.list_objects("cross").objects
    assert [o.name for o in listed] == sorted(objs)


# -- the guarded drive chain -------------------------------------------------


def _guarded(tmp_path, kind: str):
    storage, fmt = PACKAGES[kind]
    check = {"jax": JaxDiskIDCheck, "port": DiskIDCheck}[kind]
    wrap = {"jax": jmetered.wrap, "port": tmetered.wrap}[kind]
    disks = [storage(str(tmp_path / f"{kind}{i}")) for i in range(4)]
    ref, ordered = fmt.load_or_init_format(disks, 1, 4)
    guards = [check(wrap(d), ref.sets[0][i]) for i, d in enumerate(ordered)]
    return disks, guards


def test_swapped_drive_fails_fast(tmp_path):
    res = {}
    for kind in PACKAGES:
        disks, guards = _guarded(tmp_path, kind)
        ok = guards[0].read_all(".sys", "format.json")
        # mount drive 1's contents in slot 0: a different formatted drive
        shutil.copy(os.path.join(disks[1].root, ".sys", "format.json"),
                    os.path.join(disks[0].root, ".sys", "format.json"))
        cached = _outcome(lambda: guards[0].list_vols())
        guards[0]._last_check = 0.0  # the 1 s re-read interval elapsed
        swapped = _outcome(lambda: guards[0].read_all(".sys", "format.json"))
        res[kind] = (bool(ok), cached[0], swapped, guards[0].is_online(),
                     guards[1].is_online())
    assert res["port"] == res["jax"] == (
        True, True, (False, "DiskNotFound"), False, True)


def test_recheck_reads_the_format_again(tmp_path):
    """The port's fresh-disk monitor drops a verdict cached while the
    drive was blank (``DiskIDCheck.recheck``)."""
    disks, guards = _guarded(tmp_path, "port")
    raw = open(os.path.join(disks[0].root, ".sys", "format.json"),
               "rb").read()
    os.remove(os.path.join(disks[0].root, ".sys", "format.json"))
    guards[0]._last_check = 0.0
    with pytest.raises(terrors.DiskNotFound):
        guards[0].list_vols()
    with open(os.path.join(disks[0].root, ".sys", "format.json"), "wb") as f:
        f.write(raw)
    with pytest.raises(terrors.DiskNotFound):  # still the cached verdict
        guards[0].list_vols()
    guards[0].recheck()
    assert guards[0].list_vols() == []


def test_guarded_drive_metered_once(tmp_path, backends):
    _disks, guards = _guarded(tmp_path, "port")
    ol = ErasureObjects(guards, parity_blocks=2, device="cpu")
    assert all(d is g for d, g in zip(ol.disks, guards))
    assert all(tmetered.is_metered(d) for d in ol.disks)
    inner = guards[0].__dict__["unwrapped"]
    assert isinstance(inner, tmetered.MeteredDisk)
    assert not isinstance(inner.__dict__["unwrapped"], tmetered.MeteredDisk)
    before = inner.api_stats().get("list_vols", {"calls": 0})["calls"]
    guards[0].list_vols()
    assert inner.api_stats()["list_vols"]["calls"] == before + 1
    ol.make_bucket("meter")
    assert inner.api_stats()["make_vol"]["calls"] == 1
