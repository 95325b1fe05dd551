"""The port's resumable heal sequences held against minio_tpu's.

Each test of ``tests/test_heal_sequence.py`` runs here on both packages
at once: minio_tpu's ``HealSequence`` / ``AllHealState`` over its
``ErasureObjects`` and minio_tpu_torch's over its own (``device="cpu"``:
the plain PyTorch versions of the heal kernels), each on four temp-dir
disks at the default parity with 4 KiB blocks, holding the same objects
(payloads from one numpy seed) and the same damage (a drive's payload
wiped, its ``.sys`` kept).  Then:

* the ``pop_status`` documents and their items are equal once the
  client token and the start time are left out;
* the scanned, healed and failed counts are equal;
* after the heal the part files are byte-equal disk by disk, and equal
  to those before the wipe;
* the token, conflict, force-start, overlap and sibling-path cases
  answer alike (the same ``HealSequenceError`` codes);
* the admin ``heal-sequence`` route gives the same answers on a port
  ``S3Server`` and a JAX one.
"""

import io
import json
import os
import shutil
import time

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.heal import sequence as jseq
from minio_tpu.iam.sys import IAMSys as JaxIAM
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.heal import sequence as tseq
from minio_tpu_torch.iam.sys import IAMSys as PortIAM
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server.http import S3Server as PortServer
from minio_tpu_torch.storage import health
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

ADMIN = "/minio-tpu/admin/v1"
BLOCK = 4096
DISKS = 4
PKGS = ("jax", "port")
SEQ = {"jax": jseq, "port": tseq}


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    health.reset_registry()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()
    health.reset_registry()


def _pay(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _layer(tmp_path, pkg: str):
    root = tmp_path / pkg
    if pkg == "jax":
        ol = JaxObjects([JaxStorage(str(root / f"d{i}")) for i in range(DISKS)],
                        block_size=BLOCK)
    else:
        ol = ErasureObjects([XLStorage(str(root / f"d{i}"))
                             for i in range(DISKS)],
                            block_size=BLOCK, device="cpu")
    ol.make_bucket("healb")
    return ol


def _layers(tmp_path, objects: dict) -> dict:
    """Both packages' layers holding the same ``objects`` (key ->
    payload) in bucket ``healb``."""
    out = {}
    for pkg in PKGS:
        ol = _layer(tmp_path, pkg)
        for key, data in objects.items():
            ol.put_object("healb", key, io.BytesIO(data), len(data))
        out[pkg] = ol
    return out


def _wipe_disk(tmp_path, pkg: str, i: int) -> None:
    """Simulate a replaced drive: wipe its payload, keep the mount."""
    root = tmp_path / pkg / f"d{i}"
    for entry in os.listdir(root):
        if entry == ".sys":
            continue
        shutil.rmtree(root / entry, ignore_errors=True)


def _wait_ended(seq, timeout=30.0) -> None:
    deadline = time.time() + timeout
    while not seq.has_ended() and time.time() < deadline:
        time.sleep(0.05)
    assert seq.has_ended(), seq.status


def _parts(tmp_path, pkg: str, names) -> list:
    """Each disk's part.1 bytes of each object (None where absent)."""
    cls = JaxStorage if pkg == "jax" else XLStorage
    out = []
    for i in range(DISKS):
        disk = cls(str(tmp_path / pkg / f"d{i}"))
        for name in names:
            try:
                fi = disk.read_version("healb", name)
            except Exception:  # noqa: BLE001 - absent on this disk
                out.append(None)
                continue
            p = tmp_path / pkg / f"d{i}" / "healb" / name / fi.data_dir / "part.1"
            out.append(p.read_bytes())
    return out


def _strip(doc: dict) -> dict:
    """A pop_status document without its token and times."""
    return {k: v for k, v in doc.items()
            if k not in ("client_token", "start_time")}


def _slow(ol, delay: float) -> None:
    orig = ol.heal_object

    def slow(*a, **k):
        time.sleep(delay)
        return orig(*a, **k)

    ol.heal_object = slow


def test_sequence_walks_and_heals(tmp_path):
    objs = {f"k{i}": _pay(3000, i) for i in range(8)}
    layers = _layers(tmp_path, objs)
    before = {pkg: _parts(tmp_path, pkg, objs) for pkg in PKGS}
    docs, again, dry = {}, {}, {}
    for pkg in PKGS:
        _wipe_disk(tmp_path, pkg, 2)
        state = SEQ[pkg].AllHealState()
        seq = SEQ[pkg].HealSequence(layers[pkg], "healb")
        token = state.launch(seq)["client_token"]
        _wait_ended(seq)
        docs[pkg] = _strip(state.pop_status("healb", token))
        again[pkg] = state.pop_status("healb", token)["items"]
        dry[pkg] = [layers[pkg].heal_object("healb", f"k{i}", dry_run=True)
                    ["outdated"] for i in range(8)]
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    assert doc["status"] == "finished"
    assert (doc["scanned"], doc["healed"], doc["failed"]) == (8, 8, 0)
    assert [i["type"] for i in doc["items"]] == ["bucket"] + ["object"] * 8
    assert all(i["healed"] for i in doc["items"][1:])
    # the wiped disk is back in every object's quorum, byte for byte
    assert dry["port"] == dry["jax"] == [[]] * 8
    assert _parts(tmp_path, "port", objs) == _parts(tmp_path, "jax", objs)
    assert _parts(tmp_path, "port", objs) == before["port"] == before["jax"]
    # a second poll returns no duplicate items
    assert again["port"] == again["jax"] == []


def test_sequence_dry_run_reports_without_healing(tmp_path):
    objs = {"k": _pay(3000, 9)}
    layers = _layers(tmp_path, objs)
    docs, after = {}, {}
    for pkg in PKGS:
        _wipe_disk(tmp_path, pkg, 1)
        wiped = _parts(tmp_path, pkg, objs)
        state = SEQ[pkg].AllHealState()
        seq = SEQ[pkg].HealSequence(layers[pkg], "healb", dry_run=True)
        token = state.launch(seq)["client_token"]
        _wait_ended(seq)
        docs[pkg] = _strip(state.pop_status("healb", token))
        after[pkg] = layers[pkg].heal_object("healb", "k", dry_run=True)
        # nothing was written
        assert _parts(tmp_path, pkg, objs) == wiped
    assert docs["port"] == docs["jax"]
    assert docs["port"]["healed"] == 1  # reported...
    assert after["port"] == after["jax"]
    assert after["port"]["outdated"]  # ...not fixed


def _conflicts(tmp_path, pkg: str, ol) -> dict:
    """The token, conflict, stop and force-start answers of one package."""
    mod = SEQ[pkg]
    state = mod.AllHealState()
    _slow(ol, 0.2)  # the sequence is still running for the checks
    seq = mod.HealSequence(ol, "healb", "p/")
    token = state.launch(seq)["client_token"]
    codes = {}
    for case, call in (
        ("same_path", lambda: state.launch(mod.HealSequence(ol, "healb", "p/"))),
        ("parent_path", lambda: state.launch(mod.HealSequence(ol, "healb"))),
        ("child_path", lambda: state.launch(
            mod.HealSequence(ol, "healb", "p/q/"))),
        ("wrong_token", lambda: state.pop_status("healb/p", "bogus")),
        ("no_sequence", lambda: state.pop_status("healb/zz", token)),
        ("stop_unknown", lambda: state.stop("healb/zz")),
    ):
        with pytest.raises(mod.HealSequenceError) as ei:
            call()
        codes[case] = ei.value.code
    stopping = state.stop("healb/p")
    _wait_ended(seq)
    seq2 = mod.HealSequence(ol, "healb", "p/")
    token2 = state.launch(seq2, force_start=True)["client_token"]
    _wait_ended(seq2)
    final = state.pop_status("healb/p", token2)
    return {"codes": codes, "stopping": stopping["status"],
            "stop_token_ok": stopping["client_token"] == token,
            "first": seq.status in ("stopped", "finished"),
            "new_token": token2 != token, "final": final["status"],
            "final_scanned": final["scanned"]}


def test_sequence_token_and_conflict_semantics(tmp_path):
    objs = {f"p/k{i}": _pay(2000, 20 + i) for i in range(3)}
    layers = _layers(tmp_path, objs)
    got = {pkg: _conflicts(tmp_path, pkg, layers[pkg]) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"]["codes"] == {
        "same_path": "HealAlreadyRunning",
        "parent_path": "HealOverlappingPaths",
        "child_path": "HealOverlappingPaths",
        "wrong_token": "HealInvalidClientToken",
        "no_sequence": "HealNoSuchProcess",
        "stop_unknown": "HealNoSuchProcess",
    }
    assert got["port"]["stopping"] == "stopping"
    assert got["port"]["final"] == "finished"
    assert got["port"]["final_scanned"] == 3


def test_sequence_stop_mid_walk_then_force_start_heals_the_rest(tmp_path):
    objs = {f"k{i}": _pay(2500, 40 + i) for i in range(6)}
    layers = _layers(tmp_path, objs)
    before = {pkg: _parts(tmp_path, pkg, objs) for pkg in PKGS}
    got = {}
    for pkg in PKGS:
        mod, ol = SEQ[pkg], layers[pkg]
        _wipe_disk(tmp_path, pkg, 0)
        state = mod.AllHealState()
        orig = ol.heal_object
        seen = []

        def gated(*a, **k):
            seen.append(a[1])
            if len(seen) == 2:
                state.stop("healb")  # stop after the second object
            return orig(*a, **k)

        ol.heal_object = gated
        seq = mod.HealSequence(ol, "healb")
        token = state.launch(seq)["client_token"]
        _wait_ended(seq)
        first = _strip(state.pop_status("healb", token))
        ol.heal_object = orig
        seq2 = mod.HealSequence(ol, "healb")
        token2 = state.launch(seq2, force_start=True)["client_token"]
        _wait_ended(seq2)
        got[pkg] = (first, _strip(state.pop_status("healb", token2)))
    assert got["port"] == got["jax"]
    first, second = got["port"]
    assert first["status"] == "stopped" and first["scanned"] == 2
    assert second["status"] == "finished" and second["scanned"] == 6
    # the rest is healed: 4 objects the stopped walk never reached
    assert second["healed"] == 4
    assert _parts(tmp_path, "port", objs) == _parts(tmp_path, "jax", objs) \
        == before["port"]


def test_sibling_paths_do_not_overlap(tmp_path):
    got = {}
    for pkg in PKGS:
        ol = _layer(tmp_path, pkg)
        ol.make_bucket("healb2")
        ol.put_object("healb", "k", io.BytesIO(b"x" * 2000), 2000)
        ol.put_object("healb2", "k", io.BytesIO(b"y" * 2000), 2000)
        mod = SEQ[pkg]
        state = mod.AllHealState()
        _slow(ol, 0.3)
        seq1 = mod.HealSequence(ol, "healb")
        t1 = state.launch(seq1)["client_token"]
        # sibling bucket with a shared name prefix: NOT an overlap
        seq2 = mod.HealSequence(ol, "healb2")
        t2 = state.launch(seq2)["client_token"]
        _wait_ended(seq1)
        _wait_ended(seq2)
        got[pkg] = (t1 != t2, _strip(state.pop_status("healb", t1)),
                    _strip(state.pop_status("healb2", t2)))
    assert got["port"] == got["jax"]
    assert got["port"][0]


def test_max_unpopped_and_gc(tmp_path, monkeypatch):
    """Items past MAX_UNPOPPED are dropped, and an ended sequence is
    collected KEEP_ENDED_S after its end, in both packages."""
    objs = {f"k{i}": _pay(1000, 60 + i) for i in range(5)}
    layers = _layers(tmp_path, objs)
    got = {}
    for pkg in PKGS:
        mod = SEQ[pkg]
        monkeypatch.setattr(mod, "MAX_UNPOPPED", 3)
        _wipe_disk(tmp_path, pkg, 3)
        state = mod.AllHealState()
        seq = mod.HealSequence(layers[pkg], "healb")
        token = state.launch(seq)["client_token"]
        _wait_ended(seq)
        doc = _strip(state.pop_status("healb", token))
        # an ended sequence past its keep window is collected at the
        # next launch, and a new one takes the path
        seq.end_time -= mod.KEEP_ENDED_S + 1
        seq2 = mod.HealSequence(layers[pkg], "healb", "k1")
        state.launch(seq2)
        _wait_ended(seq2)
        with pytest.raises(mod.HealSequenceError) as ei:
            state.pop_status("healb", token)
        got[pkg] = (doc, ei.value.code)
    assert got["port"] == got["jax"]
    doc, code = got["port"]
    assert doc["healed"] == 5 and len(doc["items"]) == 3
    assert code == "HealNoSuchProcess"


def _admin_run(tmp_path, pkg: str, ol) -> dict:
    iam = (JaxIAM if pkg == "jax" else PortIAM)("minioadmin", "minioadmin", ol)
    srv = (JaxServer if pkg == "jax" else PortServer)(
        ol, address="127.0.0.1:0", iam=iam).start()
    out = {}
    try:
        c = S3Client(srv.endpoint)

        def call(query):
            r = c.request("POST", f"{ADMIN}/heal-sequence", query=query)
            return r.status, r.error_code if r.status != 200 else \
                json.loads(r.body)

        st, doc = call({"bucket": "healb"})
        assert st == 200, doc
        token = doc["client_token"]
        out["launch_keys"] = sorted(doc)
        items = []
        for _ in range(300):
            st, doc = call({"bucket": "healb", "clientToken": token})
            assert st == 200, doc
            items.extend(doc["items"])
            if doc["status"] != "running":
                break
            time.sleep(0.1)
        doc["items"] = items
        out["final"] = _strip(doc)
        out["bad_token"] = call({"bucket": "healb", "clientToken": "nope"})
        out["no_process"] = call({"bucket": "healb", "prefix": "zz/",
                                  "clientToken": "x"})
        out["no_bucket"] = call({})
        r = c.request("POST", f"{ADMIN}/heal-sequence/stop",
                      query={"bucket": "healb"})
        out["stop"] = (r.status, json.loads(r.body)["status"])
        r = c.request("POST", f"{ADMIN}/heal-sequence/stop",
                      query={"bucket": "nothing-here"})
        out["stop_unknown"] = (r.status, r.error_code)
    finally:
        srv.shutdown()
    return out


def test_admin_heal_sequence_e2e(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    objs = {f"o{i}": _pay(2500, 80 + i) for i in range(5)}
    layers = _layers(tmp_path, objs)
    got = {}
    for pkg in PKGS:
        _wipe_disk(tmp_path, pkg, 3)
        got[pkg] = _admin_run(tmp_path, pkg, layers[pkg])
    assert got["port"] == got["jax"]
    final = got["port"]["final"]
    assert final["status"] == "finished"
    assert (final["scanned"], final["healed"]) == (5, 5)
    assert sum(1 for i in final["items"] if i["type"] == "object") == 5
    assert got["port"]["launch_keys"] == ["client_address", "client_token",
                                          "start_time"]
    assert got["port"]["bad_token"] == (400, "XMinioHealInvalidClientToken")
    assert got["port"]["no_process"] == (400, "XMinioHealNoSuchProcess")
    assert got["port"]["no_bucket"] == (400, "InvalidArgument")
    assert got["port"]["stop"] == (200, "stopping")
    assert got["port"]["stop_unknown"] == (400, "XMinioHealNoSuchProcess")
    assert _parts(tmp_path, "port", objs) == _parts(tmp_path, "jax", objs)
