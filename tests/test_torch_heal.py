"""The port's heal path held against minio_tpu's.

Erasure.heal, ErasureObjects.heal_object / heal_bucket and the MRF heal
queue of minio_tpu_torch (device="cpu": the plain PyTorch versions of
the kernels) run on the same damage as minio_tpu's, at EC 8+4 with
32 KiB blocks: the rebuilt shard files and xl.meta must be
byte-identical, and each package heals what the other wrote.  Every
HealRoutine is stopped in a ``finally`` and every drain has a finite
timeout.
"""

import io
import os
import shutil

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.erasure import Erasure as JaxErasure
from minio_tpu.codec.erasure import QuorumError as JaxQuorumError
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.erasure import Erasure, QuorumError
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.heal.background import HealQueue, HealRoutine, HealTask
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage import errors as serrors, health, metered
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, K, M = 12, 8, 4
BLOCK = 32 * 1024
SIZES = {"byte": 1, "block": BLOCK, "blocks3_5": BLOCK * 7 // 2}
DRAIN_S = 60.0


def _payload(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(size + seed).bytes(size)


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


class MemShard:
    """In-memory shard file: writer + read_at reader."""

    def __init__(self, buf: bytes = b""):
        self.buf = bytearray(buf)

    def write(self, b) -> None:
        self.buf += bytes(b)

    def read_at(self, off: int, length: int) -> bytes:
        return bytes(self.buf[off : off + length])


def _encode(size: int):
    er = Erasure(K, M, BLOCK)
    shards = [MemShard() for _ in range(N)]
    data = _payload(size)
    er.encode(io.BytesIO(data), list(shards), K + 1,
              backend=tbackend.TorchBackend("cpu"))
    return [bytes(s.buf) for s in shards]


def _flip(buf: bytes, pos: int) -> bytes:
    b = bytearray(buf)
    b[pos] ^= 0x5A
    return bytes(b)


# ---------------------------------------------------------------------------
# Erasure.heal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize(
    "dead,rot",
    [((1, 3, 10, 11), None), ((8, 9, 10, 11), None), ((0, 5), 2)],
    ids=["data+parity", "parity-only", "bitrot-survivor"],
)
def test_erasure_heal_matches_jax(name, dead, rot):
    """Both packages rebuild the same frames; a bitrotted chosen
    survivor (shard ``rot``) takes the backend's escalation path."""
    size = SIZES[name]
    files = _encode(size)
    readers = []
    for s in range(N):
        if s in dead:
            readers.append(None)
        elif s == rot:
            readers.append(MemShard(_flip(files[s], 40)))  # block 0 payload
        else:
            readers.append(MemShard(files[s]))
    ours = {s: MemShard() for s in dead}
    theirs = {s: MemShard() for s in dead}
    Erasure(K, M, BLOCK).heal(
        readers, [ours.get(s) for s in range(N)], size,
        backend=tbackend.TorchBackend("cpu"),
    )
    JaxErasure(K, M, BLOCK).heal(
        readers, [theirs.get(s) for s in range(N)], size,
        backend=jbackend.TpuBackend(),
    )
    for s in dead:
        assert bytes(ours[s].buf) == bytes(theirs[s].buf) == files[s]


@pytest.mark.parametrize("live,intact", [(7, 6), (8, 7)])
def test_erasure_heal_below_quorum_raises(live, intact):
    """Below k present shards, and k present with one bitrotted (the
    backend's escalation finds k - 1 intact): both raise the same
    QuorumError."""
    size = SIZES["blocks3_5"]
    files = _encode(size)
    readers = [MemShard(f) if s < live else None for s, f in enumerate(files)]
    readers[0] = MemShard(_flip(files[0], 40))
    msg = f"heal: {intact}/12 shards intact, need 8"
    with pytest.raises(QuorumError, match=msg):
        Erasure(K, M, BLOCK).heal(
            readers, [None] * 11 + [MemShard()], size,
            backend=tbackend.TorchBackend("cpu"),
        )
    with pytest.raises(JaxQuorumError, match=msg):
        JaxErasure(K, M, BLOCK).heal(
            readers, [None] * 11 + [MemShard()], size,
            backend=jbackend.TpuBackend(),
        )


# ---------------------------------------------------------------------------
# heal_object / heal_bucket against minio_tpu on copies of the same disks
# ---------------------------------------------------------------------------


def _port(roots):
    return ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK,
        device="cpu",
    )


def _jax(roots):
    return JaxObjects(
        [JaxStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK
    )


def _object_files(root: str, name: str) -> dict:
    """Relative path -> bytes of everything under bkt/<name> on a disk."""
    base = os.path.join(root, "bkt", name)
    out = {}
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, base)] = fh.read()
    return out


def _disk_of_shard(roots, name, shard: int) -> int:
    dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
    return dist.index(shard + 1)


def _wipe(root: str) -> None:
    """A replaced drive: the disk root is there, everything in it gone."""
    for entry in os.listdir(root):
        shutil.rmtree(os.path.join(root, entry))


def _rot(roots, name, disk: int) -> None:
    """Flip a payload byte of block 0 in ``disk``'s part file."""
    fi = XLStorage(roots[disk]).read_version("bkt", name)
    part = os.path.join(roots[disk], "bkt", name, fi.data_dir, "part.1")
    with open(part, "rb") as f:
        raw = f.read()
    with open(part, "wb") as f:
        f.write(_flip(raw, 40))


@pytest.fixture
def written(tmp_path):
    """Each package writes the same payloads to its own 12 disks; the
    disks (and any copies made under tmp_path) go at teardown."""
    out = {}
    for pkg, make in (("port", _port), ("jax", _jax)):
        roots = [str(tmp_path / f"{pkg}{i}") for i in range(N)]
        ol = make(roots)
        ol.make_bucket("bkt")
        for name, size in SIZES.items():
            ol.put_object("bkt", name, io.BytesIO(_payload(size)), size)
        out[pkg] = roots
    yield out
    for entry in os.listdir(tmp_path):
        shutil.rmtree(tmp_path / entry, ignore_errors=True)


def _copy(roots, tmp_path, tag):
    dst = [str(tmp_path / f"{tag}{i}") for i in range(N)]
    for s, d in zip(roots, dst):
        shutil.copytree(s, d)
    return dst


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heal_object_matches_reference(written, tmp_path, writer):
    """The same damage on two copies of one set: the port's heal_object
    and minio_tpu's report the same outdated/healed disks and leave
    byte-identical object files (part.1 and xl.meta), equal to the
    files before the damage.  Each package heals what either wrote."""
    roots = written[writer]
    before = {n: [_object_files(r, n) for r in roots] for n in SIZES}
    ours = _copy(roots, tmp_path, "ours")
    theirs = _copy(roots, tmp_path, "theirs")
    wiped = 0  # physical disk
    want_healed = {}
    for name in SIZES:
        dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
        healed = {dist[wiped] - 1}
        if name != "byte":
            rot = 9 if dist.index(10) != wiped else 8
            healed.add(rot)
            for r in (ours, theirs):
                _rot(r, name, dist.index(rot + 1))
        want_healed[name] = sorted(healed)
    for r in (ours, theirs):
        _wipe(r[wiped])
    port, ref = _port(ours), _jax(theirs)
    for name in SIZES:
        got = port.heal_object("bkt", name)
        assert got == ref.heal_object("bkt", name)
        assert got["outdated"] == got["healed"] == want_healed[name]
        for d in range(N):
            assert _object_files(ours[d], name) == _object_files(theirs[d], name)
            assert _object_files(ours[d], name) == before[name][d]
    for name, size in SIZES.items():
        buf = io.BytesIO()
        port.get_object("bkt", name, buf)
        assert buf.getvalue() == _payload(size)


def test_heal_object_healthy_and_dry_run(written):
    port = _port(written["port"])
    assert port.heal_object("bkt", "block")["outdated"] == []
    d = _disk_of_shard(written["port"], "block", 4)
    shutil.rmtree(os.path.join(written["port"][d], "bkt", "block"))
    assert port.probe_object_health("bkt", "block")["outdated"] == [d]
    res = port.heal_object("bkt", "block", dry_run=True)
    assert res["outdated"] == [4] and res["healed"] == []
    assert not os.path.exists(os.path.join(written["port"][d], "bkt", "block"))
    assert port.heal_object("bkt", "block")["healed"] == [4]
    assert port.probe_object_health("bkt", "block")["outdated"] == []


def test_heal_bucket_recreates_missing_volume(written):
    roots = written["port"]
    for d in (2, 7):
        shutil.rmtree(os.path.join(roots[d], "bkt"))
    port = _port(roots)
    assert port.heal_bucket("bkt", dry_run=True)["healed"] == [2, 7]
    assert not os.path.isdir(os.path.join(roots[2], "bkt"))
    res = port.heal_bucket("bkt")
    assert res["healed"] == [2, 7] and len(res["present"]) == N - 2
    for d in (2, 7):
        assert XLStorage(roots[d]).stat_vol("bkt").name == "bkt"
    with pytest.raises(Exception, match="nobucket"):
        port.heal_bucket("nobucket")


def test_verify_file_detects_truncation_and_bitrot(written):
    root = written["port"][0]
    disk = XLStorage(root)
    fi = disk.read_version("bkt", "blocks3_5")
    disk.verify_file("bkt", "blocks3_5", fi)
    part = os.path.join(root, "bkt", "blocks3_5", fi.data_dir, "part.1")
    with open(part, "rb") as f:
        raw = f.read()
    with open(part, "wb") as f:
        f.write(_flip(raw, len(raw) - 5))  # the tail block's payload
    with pytest.raises(serrors.FileCorrupt, match="bitrot block 3"):
        disk.verify_file("bkt", "blocks3_5", fi)
    with open(part, "wb") as f:
        f.write(raw[:-1])
    with pytest.raises(serrors.FileCorrupt, match="truncated block 3"):
        disk.verify_file("bkt", "blocks3_5", fi)
    jfi = JaxStorage(root).read_version("bkt", "blocks3_5")
    with pytest.raises(Exception, match="truncated block 3"):
        JaxStorage(root).verify_file("bkt", "blocks3_5", jfi)


# ---------------------------------------------------------------------------
# MRF queue + routine
# ---------------------------------------------------------------------------


def test_heal_queue_dedup_and_order():
    q = HealQueue()
    q.push(HealTask("bkt", "o1"))
    q.push_object("bkt", "o2")
    q.push(HealTask("bkt", "o1"))  # dup dropped
    assert len(q) == 2
    assert q.pop(timeout=1.0) == HealTask("bkt", "o1")
    assert not q.idle()  # in flight until task_done
    q.task_done()
    assert q.pop(timeout=1.0) == HealTask("bkt", "o2")
    q.task_done()
    assert q.idle()
    assert q.pop(timeout=0.05) is None
    q.push(HealTask("bkt", "o1"))  # re-push after pop is allowed
    assert len(q) == 1


def test_degraded_get_feeds_the_heal_routine(written):
    roots = written["port"]
    port = _port(roots)
    queue = HealQueue()
    port.heal_hook = queue.push_object
    d = _disk_of_shard(roots, "blocks3_5", 2)
    before = _object_files(roots[d], "blocks3_5")
    shutil.rmtree(os.path.join(roots[d], "bkt", "blocks3_5"))
    routine = HealRoutine(port, queue).start()
    try:
        KERNEL_STATS.reset()
        buf = io.BytesIO()
        info = port.get_object("bkt", "blocks3_5", buf)
        assert buf.getvalue() == _payload(SIZES["blocks3_5"])
        assert info.user_defined["x-internal-heal-required"] == "true"
        assert routine.drain(timeout_s=DRAIN_S)
        assert (routine.healed, routine.failed) == (1, 0)
        passes = KERNEL_STATS.snapshot()["device_passes"]
        assert passes["verify_and_reconstruct_words"] == 4  # one per block
    finally:
        assert routine.stop()
    assert _object_files(roots[d], "blocks3_5") == before


def test_routine_counts_failures_and_heals_buckets(written):
    port = _port(written["port"])
    shutil.rmtree(os.path.join(written["port"][3], "bkt"))
    queue = HealQueue()
    routine = HealRoutine(port, queue).start()
    try:
        queue.push(HealTask("bkt"))
        queue.push_object("bkt", "missing")
        assert routine.drain(timeout_s=DRAIN_S)
        assert (routine.healed, routine.failed) == (1, 1)
    finally:
        assert routine.stop()
    assert os.path.isdir(os.path.join(written["port"][3], "bkt"))


# ---------------------------------------------------------------------------
# metered disks + breaker masking
# ---------------------------------------------------------------------------


def test_tripped_disk_is_masked_in_online_disks(written, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_BREAKER_BACKOFF_MS", "600000")
    health.reset_registry()
    port = _port(written["port"])
    assert all(metered.is_metered(d) for d in port.disks)
    assert metered.wrap(port.disks[0]) is port.disks[0]
    victim = port.disks[5]
    assert not health.should_skip(victim)
    for _ in range(10):
        victim.health.record_api("read_all", 0.001, ok=False)
    assert health.should_skip(victim)
    online = port._online_disks()
    assert online[5] is None
    assert sum(d is not None for d in online) == N - 1
    # the set still reads with the disk masked, and flags heal
    buf = io.BytesIO()
    info = port.get_object("bkt", "block", buf)
    assert buf.getvalue() == _payload(SIZES["block"])
    assert info.user_defined["x-internal-heal-required"] == "true"
    assert not health.should_skip(XLStorage(written["port"][5]))  # bare disk


def test_metered_disk_ledger(written):
    port = _port(written["port"])
    port.get_object_info("bkt", "byte")
    with pytest.raises(serrors.FileNotFound):
        port.disks[0].read_version("bkt", "nope")
    stats = port.disks[0].api_stats()
    assert stats["read_version"]["calls"] >= 2
    assert stats["read_version"]["errors"] == 1
    assert "p50_seconds" in stats["read_version"]
    # a "no such object" answer is not a fault: the breaker stays closed
    assert not health.should_skip(port.disks[0])
