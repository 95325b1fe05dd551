"""The port's FreshDiskMonitor held against minio_tpu's.

Each package builds its own single-node cluster with its
``build_cluster`` (24 drives: two EC 8+4 sets of guarded drives,
``DiskIDCheck(MeteredDisk(XLStorage))``) on twin drive trees and PUTs
the same objects.  Then:

* a drive of set 0 is wiped while the cluster runs: ``scan_once``
  stamps it back with the uuid its slot records, sweeps the set into
  the heal queue, and the heal routine rebuilds it;
* a drive of set 1 is wiped while the cluster is down: the boot's hole
  fill stamps it, and the monitor's first pass sweeps its set.

Afterwards every drive's shard files must equal the JAX package's byte
for byte, and ``xl.meta`` up to mod time, data dir and version id.  The
port alone: a verdict its identity check cached while the drive was
blank does not hide the re-stamped drive from the heal.
"""

import io
import os
import shutil

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.heal import background as jheal
from minio_tpu.objectlayer import format as jformat
from minio_tpu.server import __main__ as jmain
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.heal import background as theal
from minio_tpu_torch.objectlayer import format as tformat
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_sets_zones import _tree
from tests.test_torch_threads import torch_threads  # noqa: F401

DRIVES = 24
PACKAGES = {"jax": (jmain, jheal, jformat), "port": (tmain, theal, tformat)}


def _objs() -> dict:
    rng = np.random.default_rng(5)
    return {f"obj{i}": rng.bytes(1500 * i + 3) for i in range(8)}


def _build(kind: str, base):
    pattern = str(base / kind / "d{1...24}")
    if kind == "jax":
        return jmain.build_object_layer([pattern], parity=4)
    return tmain.build_object_layer([pattern], parity=4, device="cpu")


def _wipe(root: str) -> None:
    for entry in os.listdir(root):
        shutil.rmtree(os.path.join(root, entry))


def _heal_all(kind: str, ol, queue) -> None:
    routine = PACKAGES[kind][1].HealRoutine(ol, queue).start()
    try:
        assert routine.drain(60)
    finally:
        routine.stop()


def _sets_of(ol, objs) -> dict:
    zone = ol.zones[0]
    return {k: zone.sets.index(zone.set_for(k)) for k in objs}


@pytest.fixture
def clusters(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        objs = _objs()
        out = {}
        for kind in PACKAGES:
            ol = _build(kind, tmp_path)
            ol.make_bucket("heal")
            for k, v in objs.items():
                ol.put_object("heal", k, io.BytesIO(v), len(v))
            out[kind] = ol
        assert set(_sets_of(out["port"], objs).values()) == {0, 1}
        yield tmp_path, objs, out
        jbackend.reset_backend()
        tbackend.reset_backend()


def _root(base, kind: str, drive: int) -> str:
    return str(base / kind / f"d{drive}")


def _trees_equal(base) -> None:
    for d in range(1, DRIVES + 1):
        assert _tree(_root(base, "port", d)) == _tree(_root(base, "jax", d)), d


def test_live_wipe_stamped_and_healed(clusters):
    base, objs, ols = clusters
    res = {}
    for kind, ol in ols.items():
        _main, heal, fmt = PACKAGES[kind]
        before = _tree(_root(base, kind, 5))
        _wipe(_root(base, kind, 5))
        queue = heal.HealQueue()
        monitor = heal.FreshDiskMonitor(ol, queue, interval_s=3600)
        stamped = monitor.scan_once()
        slot = ol.zones[0].format_ref.sets[0][4]
        this = fmt.read_format(XLStorage(_root(base, kind, 5))).this
        queued = len(queue)
        _heal_all(kind, ol, queue)
        res[kind] = (stamped, this == slot, queued, monitor.scan_once(),
                     _tree(_root(base, kind, 5)) == before)
    in_set0 = sum(1 for s in _sets_of(ols["port"], objs).values() if s == 0)
    assert res["port"] == res["jax"] == (1, True, 1 + in_set0, 0, True)
    _trees_equal(base)


def test_boot_stamped_drive_swept(clusters):
    base, objs, ols = clusters
    res = {}
    for kind in ols:
        _main, heal, fmt = PACKAGES[kind]
        before = _tree(_root(base, kind, 17))
        _wipe(_root(base, kind, 17))
        ol = _build(kind, base)  # the next boot: the hole fill stamps it
        queue = heal.HealQueue()
        monitor = heal.FreshDiskMonitor(ol, queue, interval_s=3600)
        stamped = monitor.scan_once()
        queued = len(queue)
        _heal_all(kind, ol, queue)
        slot = ol.zones[0].format_ref.sets[1][4]
        this = fmt.read_format(XLStorage(_root(base, kind, 17))).this
        res[kind] = (stamped, queued, this == slot,
                     _tree(_root(base, kind, 17)) == before)
        for k, v in objs.items():
            buf = io.BytesIO()
            ol.get_object("heal", k, buf)
            assert buf.getvalue() == v
    in_set1 = sum(1 for s in _sets_of(ols["port"], objs).values() if s == 1)
    assert res["port"] == res["jax"] == (0, 1 + in_set1, True, True)
    _trees_equal(base)


def test_cached_blank_verdict_does_not_hide_the_drive(clusters):
    """The wiped drive's identity check read the blank drive (and cached
    DiskNotFound) just before the monitor's pass: the port re-reads the
    format after stamping, so the sweep's heals still reach the drive."""
    base, objs, ols = clusters
    ol = ols["port"]
    before = _tree(_root(base, "port", 5))
    _wipe(_root(base, "port", 5))
    guard = ol.zones[0].sets[0].disks[4]
    guard._last_check = 0.0
    assert not guard.is_online()  # the blank verdict, cached for 1 s
    queue = theal.HealQueue()
    assert theal.FreshDiskMonitor(ol, queue, interval_s=3600).scan_once() == 1
    assert guard.is_online()
    _heal_all("port", ol, queue)
    assert _tree(_root(base, "port", 5)) == before
