"""The quorum-early parity ack (MINIO_TPU_PARITY_ACK=early) on the port.

The band itself (``parallel/iopool.py``: ``ParityBand``, the flusher's
per-slot counts, ``drain_slots`` and ``on_late_dead``) against the JAX
package's cases; ``Erasure.encode`` with a band against the settle path
and against the JAX package's; and the object layer: a PUT under
``early`` on both packages from one seed, whose part files and xl.meta
(once the band settled, polled under a deadline) equal each other's and
a ``settle`` PUT's, and a parity drive whose ``rename_data`` fails after
the ack, which both packages heal-flag once and ``heal_object`` repairs.
Everything runs in this process on the CPU (``device="cpu"``).
"""

import io
import threading
import time

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.erasure import Erasure as JaxErasure
from minio_tpu.codec.telemetry import KERNEL_STATS as JAX_STATS
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.parallel import iopool as jiopool
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.erasure import Erasure
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.objectlayer.metadata import hash_order
from minio_tpu_torch.parallel import iopool
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 12, 4
K = N - M
BLOCK = 32 * 1024  # 1,024 words a shard: the pack leg runs
SIZE = BLOCK * 11 // 2  # two encode batches of 4 blocks and a short tail
SETTLE_S = 30.0  # deadline of every poll for the band's settle


@pytest.fixture(autouse=True)
def _fresh_backends(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


# -- ParityBand and ShardFlusher (the JAX package's cases) ------------------


def _boom():
    raise OSError("boom")


def test_parity_band_flags_heal_on_failed_submitted_job():
    band = iopool.ParityBand()
    band.submit(5, "disk-5", _boom)
    band.submit(4, "disk-4", lambda: None)
    assert band.settle() is False
    assert band.heal_required and band.dead_slots == {5}


def test_parity_band_flag_heal_is_idempotent_per_slot():
    before = KERNEL_STATS.snapshot()["heal_required"]
    band = iopool.ParityBand()
    band.flag_heal(3, OSError("x"))
    band.flag_heal(3, OSError("y"))
    band.flag_heal(4, OSError("z"))
    assert band.dead_slots == {3, 4}
    assert KERNEL_STATS.snapshot()["heal_required"] - before == 2


def test_parity_band_adopts_flusher_stragglers():
    pool = iopool.get_pool()
    flusher = iopool.ShardFlusher(pool)
    band = iopool.ParityBand(pool)
    gate = threading.Event()

    def slow_fail():
        gate.wait(5.0)
        raise OSError("parity disk died behind the ack")

    jobs = [(s, f"tik-{s}", lambda: None, 0) for s in range(4)]
    jobs.append((4, "tik-4", slow_fail, 0))
    assert flusher.flush(jobs, quorum=4) == set()  # acked, straggler in flight
    band.adopt(flusher)
    assert band.adopted
    gate.set()
    assert band.settle() is False
    assert band.dead_slots == {4}


def test_parity_band_late_dead_callback_fires_behind_ack():
    flusher = iopool.ShardFlusher(iopool.get_pool())
    seen = []
    fired = threading.Event()

    def on_late(slot, err):
        seen.append((slot, str(err)))
        fired.set()

    flusher.on_late_dead = on_late
    gate = threading.Event()

    def slow_fail():
        gate.wait(5.0)
        raise OSError("late")

    jobs = [(s, f"tlk-{s}", lambda: None, 0) for s in range(3)]
    jobs.append((3, "tlk-3", slow_fail, 0))
    flusher.flush(jobs, quorum=3)
    gate.set()
    assert fired.wait(5.0)
    assert seen == [(3, "late")]
    flusher.drain()


def test_parity_band_finish_settles_in_background():
    band = iopool.ParityBand()
    band.submit(2, "tfin-2", lambda: None)
    verdicts = []
    fut = band.finish(on_done=lambda b: verdicts.append(b.heal_required))
    assert fut.wait(5.0)
    assert verdicts == [False]


def test_drain_slots_waits_only_for_its_slots():
    """drain_slots returns once the named slots finished, with their
    deaths, while another slot's job is still running."""
    flusher = iopool.ShardFlusher(iopool.get_pool())
    gate = threading.Event()
    jobs = [(0, "tds-0", lambda: None, 0), (1, "tds-1", _boom, 0),
            (2, "tds-2", lambda: gate.wait(5.0), 0)]
    dead = flusher.flush(jobs, quorum=1)
    dead |= flusher.drain_slots([0, 1])
    assert dead == {1}
    assert not gate.is_set()  # slot 2's job still runs
    gate.set()
    assert flusher.drain() == set()  # slot 1 was reported already


def test_finish_on_a_pool_of_one_queue_settles():
    """With one queue there is no aux band: the settle routes onto the
    one queue behind the jobs it waits on, and does not deadlock."""
    pool = iopool.IOPool(queues=1, name_prefix="iopool-one")
    try:
        band = iopool.ParityBand(pool)
        band.submit(0, "one-0", lambda: None)
        band.submit(1, "one-1", _boom)
        verdicts = []
        fut = band.finish(on_done=lambda b: verdicts.append(b.dead_slots))
        assert fut.wait(10.0)
        assert verdicts == [{1}]
    finally:
        pool.shutdown()


# -- Erasure.encode with a band ---------------------------------------------


class MemShard:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        self.buf += b


def _encode(erasure_cls, payload, band=None, backend=None):
    k, m, bs = 4, 2, 2048
    shards = [MemShard() for _ in range(k + m)]
    kw = {"backend": backend} if backend is not None else {}
    total = erasure_cls(k, m, bs).encode(
        io.BytesIO(payload), list(shards), write_quorum=k + 1,
        parity_band=band, **kw,
    )
    return total, shards


@pytest.mark.parametrize("compress", ["auto", "on"])
def test_quorum_early_shards_equal_settle_and_jax(monkeypatch, compress):
    """Shards written with a band equal the eager settle path's and the
    JAX package's (band and settle)."""
    monkeypatch.setenv("MINIO_TPU_DEVICE_COMPRESS", compress)
    payload = np.random.default_rng(21).integers(
        0, 256, 3 * 2048 + 123, dtype=np.uint8).tobytes()
    be = tbackend.get_backend("cpu")
    monkeypatch.setenv("MINIO_TPU_PARITY_PLANE", "off")
    total_settle, settle = _encode(Erasure, payload, backend=be)
    monkeypatch.setenv("MINIO_TPU_PARITY_PLANE", "on")
    band = iopool.ParityBand()
    total_early, early = _encode(Erasure, payload, band=band, backend=be)
    assert band.adopted
    assert band.settle() is True  # parity drains behind the return
    jband = jiopool.ParityBand()
    _jt, jearly = _encode(JaxErasure, payload, band=jband)
    assert jband.settle() is True
    want = [bytes(s.buf) for s in settle]
    assert total_early == total_settle == len(payload)
    assert [bytes(s.buf) for s in early] == want
    assert [bytes(s.buf) for s in jearly] == want


def test_band_dropped_without_the_digest_plane(monkeypatch):
    """MINIO_TPU_PARITY_PLANE=off: encode settles inline and the band
    adopts nothing (as in the JAX package)."""
    monkeypatch.setenv("MINIO_TPU_PARITY_PLANE", "off")
    band = iopool.ParityBand()
    payload = b"q" * (2 * 2048 + 77)
    total, shards = _encode(Erasure, payload, band=band,
                            backend=tbackend.get_backend("cpu"))
    assert total == len(payload) and not band.adopted
    assert len({len(s.buf) for s in shards}) == 1 and shards[-1].buf


# -- the object layer: early PUTs on both packages ---------------------------


def _payload(seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(SIZE)


def _layers(tmp_path, tag: str, jax_disk=JaxStorage, port_disk=XLStorage):
    """The port's and the JAX package's layers over N fresh drives each:
    (port, ref, port roots, jax roots, port drives, jax drives)."""
    troots = [str(tmp_path / f"{tag}-port{i}") for i in range(N)]
    jroots = [str(tmp_path / f"{tag}-jax{i}") for i in range(N)]
    tdisks = [port_disk(r) for r in troots]
    jdisks = [jax_disk(r) for r in jroots]
    port = ErasureObjects(tdisks, parity_blocks=M, block_size=BLOCK,
                          device="cpu")
    ref = JaxObjects(jdisks, parity_blocks=M, block_size=BLOCK)
    port.make_bucket("bkt")
    ref.make_bucket("bkt")
    return port, ref, troots, jroots, tdisks, jdisks


def _xl_meta(root: str, name: str) -> "list | None":
    """xl.meta's versions without the volatile fields, or None while the
    file is not there (or not whole) yet."""
    try:
        with open(f"{root}/bkt/{name}/xl.meta", "rb") as f:
            versions = XLMeta.from_bytes(f.read()).versions
    except Exception:  # noqa: BLE001 - not written yet
        return None
    out = []
    for v in versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _part(root: str, name: str) -> bytes:
    fi = XLStorage(root).read_version("bkt", name)
    with open(f"{root}/bkt/{name}/{fi.data_dir}/part.1", "rb") as f:
        return f.read()


def _files(roots: list, name: str) -> list:
    return [(_part(r, name), _xl_meta(r, name)) for r in roots]


def _await_settled(roots: list, name: str) -> None:
    """Poll every drive's xl.meta (written last by rename_data) until the
    band's parity renames have committed, under a deadline."""
    deadline = time.monotonic() + SETTLE_S
    while any(_xl_meta(r, name) is None for r in roots):
        if time.monotonic() > deadline:
            pytest.fail(f"{name}: the parity band did not settle in {SETTLE_S} s")
        time.sleep(0.01)


def _parity_drive(name: str, shard: int = N) -> int:
    """The drive holding erasure index ``shard`` of bkt/name."""
    return hash_order(f"bkt/{name}", N).index(shard)


def test_early_put_equals_settle_and_jax(tmp_path, monkeypatch):
    data = _payload(7)
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "settle")
    port, ref, troots, jroots, _t, _j = _layers(tmp_path, "settle")
    port.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    ref.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    settle = _files(troots, "obj")
    assert settle == _files(jroots, "obj")
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "early")
    port, ref, troots, jroots, _t, _j = _layers(tmp_path, "early")
    finished = []
    finish = iopool.ParityBand.finish
    monkeypatch.setattr(iopool.ParityBand, "finish",
                        lambda band, **kw: finished.append(band) or finish(band, **kw))
    port.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    assert len(finished) == 1 and finished[0].adopted  # the band took parity
    got = io.BytesIO()
    port.get_object("bkt", "obj", got)  # read right after the ack
    assert got.getvalue() == data
    ref.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    _await_settled(troots, "obj")
    _await_settled(jroots, "obj")
    assert _files(troots, "obj") == settle
    assert _files(jroots, "obj") == settle


def _failing_rename(base):
    class FailingRename(base):
        """A drive whose rename_data raises while ``fail`` is set."""

        fail = False

        def rename_data(self, *a, **k):
            if self.fail:
                raise OSError("injected rename_data failure")
            return super().rename_data(*a, **k)

    return FailingRename


def test_failed_parity_rename_past_the_ack_is_heal_flagged(tmp_path, monkeypatch):
    """A parity drive whose rename_data fails after the ack: each package
    calls heal_hook once and counts heal_required once; heal_object then
    restores part files and xl.meta equal to a settle PUT's."""
    data = _payload(8)
    port, _r, sroots, _jr, _t, _j = _layers(tmp_path, "want")
    port.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    want = _files(sroots, "obj")
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "early")
    port, ref, troots, jroots, tdisks, jdisks = _layers(
        tmp_path, "fail", _failing_rename(JaxStorage), _failing_rename(XLStorage))
    bad = _parity_drive("obj")
    tdisks[bad].fail = jdisks[bad].fail = True
    hooks = {"port": [], "jax": []}
    port.heal_hook = lambda b, o: hooks["port"].append((b, o))
    ref.heal_hook = lambda b, o: hooks["jax"].append((b, o))
    t0 = KERNEL_STATS.snapshot()["heal_required"]
    j0 = JAX_STATS.snapshot()["heal_required"]
    port.put_object("bkt", "obj", io.BytesIO(data), SIZE)  # acks
    ref.put_object("bkt", "obj", io.BytesIO(data), SIZE)
    deadline = time.monotonic() + SETTLE_S
    while not (hooks["port"] and hooks["jax"]):
        if time.monotonic() > deadline:
            pytest.fail(f"no heal flag within {SETTLE_S} s: {hooks}")
        time.sleep(0.01)
    assert hooks == {"port": [("bkt", "obj")], "jax": [("bkt", "obj")]}
    assert KERNEL_STATS.snapshot()["heal_required"] - t0 == 1
    assert JAX_STATS.snapshot()["heal_required"] - j0 == 1
    assert _xl_meta(troots[bad], "obj") is None  # the failed drive missed it
    tdisks[bad].fail = jdisks[bad].fail = False
    for ol in (port, ref):
        assert ol.heal_object("bkt", "obj")["healed"] == [N - 1]
    assert _files(troots, "obj") == want
    assert _files(jroots, "obj") == want
