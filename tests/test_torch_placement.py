"""Submesh placement on the port (minio_tpu_torch.parallel.rules, the
batcher's routing, telemetry and metrics, Select's scan router) held
against minio_tpu on the conftest's 8 virtual CPU devices.

The router's carving, least-loaded choice, ``span`` / ``auto``
thresholds and the thread scoping of ``placed`` choose what the JAX
package's choose; ``BatchingBackend(instrument(TorchBackend(devices=
("cpu",) * 8)))`` gives the JAX ``BatchingBackend(instrument(
TpuBackend()))``'s parity, digests, reconstructs, pass names and
placement counters under each policy; two merged batches run at once on
disjoint submeshes; ``auto`` routes only encode / encode_digest; the
Prometheus families render; the overlap fallback warns once; a PUT,
degraded GET and heal on a mesh backend write the JAX package's part
files; and a Select scan under a two-submesh router answers the host
engine's records and releases its submesh.
"""

import io
import shutil
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.backend import CpuBackend, TpuBackend
from minio_tpu.codec.batcher import BatchingBackend as JaxBatching
from minio_tpu.codec.telemetry import KERNEL_STATS as JAX_STATS
from minio_tpu.codec.telemetry import instrument as jinstrument
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.parallel import mesh as jm, rules as jr
from minio_tpu.s3select import engine as jeng
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.backend import TorchBackend
from minio_tpu_torch.codec.batcher import BatchingBackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS, instrument
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.parallel import mesh as tm, rules as tr
from minio_tpu_torch.s3select import device as tdev, engine as teng
from minio_tpu_torch.server.metrics import Metrics
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_select import _body, _rows, _run, _split
from tests.test_torch_threads import torch_threads  # noqa: F401

CPU8 = ("cpu",) * 8


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("MINIO_MESH", "MINIO_TPU_CODEC_OVERLAP", "MINIO_TPU_CODEC_KERNEL",
                 "MINIO_TPU_PLACEMENT", "MINIO_TPU_SUBMESH_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    KERNEL_STATS.reset()
    JAX_STATS.reset()
    yield
    tbackend.reset_backend()


def _jdevices(n):
    return tuple(jax.devices()[:n])


def _tdevices(n):
    return tuple(torch.device(f"cpu:{i}") for i in range(n))


def _carve(router) -> list:
    return [(s.name, len(s.devices)) for s in router.submeshes]


# -- the router ----------------------------------------------------------------


@pytest.mark.parametrize("n,width", [(5, 2), (8, 3), (4, 1), (4, 4), (3, 8),
                                     (8, 2)])
def test_router_carves_as_jax(n, width):
    r = tr.PlacementRouter(_tdevices(n), policy="route", submesh_devices=width)
    j = jr.PlacementRouter(_jdevices(n), policy="route", submesh_devices=width)
    assert _carve(r) == _carve(j)
    # contiguous, in order, every slot once; a remainder folds into the last
    assert tuple(d for s in r.submeshes for d in s.devices) == _tdevices(n)


@pytest.mark.parametrize("value", ["1", "2", "3", "0", "-4", "bad", "", "99"])
def test_submesh_width_knob_resolves_as_jax(monkeypatch, value):
    monkeypatch.setenv("MINIO_TPU_SUBMESH_DEVICES", value)
    assert _carve(tr.PlacementRouter(_tdevices(8))) == _carve(
        jr.PlacementRouter(_jdevices(8)))


@pytest.mark.parametrize("value", ["span", "route", "auto", "AUTO ", "bogus", ""])
def test_placement_policy_resolves_as_jax(monkeypatch, value):
    monkeypatch.setenv("MINIO_TPU_PLACEMENT", value)
    assert tr.placement_policy() == jr.placement_policy()
    assert tr.PlacementRouter(_tdevices(2)).policy == jr.PlacementRouter(
        _jdevices(2)).policy


def test_router_least_loaded_and_release():
    for lib, devs in ((tr, _tdevices(4)), (jr, _jdevices(4))):
        r = lib.PlacementRouter(devs, policy="route", submesh_devices=2)
        a = r.route(1)
        b = r.route(1)
        assert a is not None and b is not None and a is not b
        assert r.depths() == {"sub0": 1, "sub1": 1}
        r.release(a)
        assert r.route(1) is a  # freed submesh is least-loaded again
        r.release(a)
        r.release(b)
        r.release(b)  # never below zero
        assert r.depths() == {"sub0": 0, "sub1": 0}


@pytest.mark.parametrize("policy", ["span", "route", "auto"])
def test_router_thresholds_match_jax(policy):
    for n, width in ((4, 2), (8, 1), (2, 2), (8, 4)):
        r = tr.PlacementRouter(_tdevices(n), policy=policy, submesh_devices=width)
        j = jr.PlacementRouter(_jdevices(n), policy=policy, submesh_devices=width)
        for blocks in (1, 2, 3, 4, 7, 8, 16):
            got, want = r.route(blocks), j.route(blocks)
            assert (got is None) == (want is None), (n, width, blocks)
            if got is not None:
                assert got.name == want.name
                r.release(got)
                j.release(want)


def test_placed_scopes_devices_to_the_thread():
    assert tr.current_placement() is None
    seen = {}
    with tr.placed(_tdevices(2)):
        assert tr.current_placement() == _tdevices(2)
        with tr.placed(_tdevices(1)):
            assert tr.current_placement() == _tdevices(1)
        assert tr.current_placement() == _tdevices(2)

        def probe():
            seen["other"] = tr.current_placement()

        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen["other"] is None  # thread-local, not process-global
    assert tr.current_placement() is None


# -- policy bit-identity through the batcher ---------------------------------


def _data(batch, k=4, length=64, seed=0):
    return np.random.default_rng(seed + batch).integers(
        0, 256, (batch, k, length), dtype=np.uint8
    )


@pytest.mark.parametrize("policy", ["span", "route", "auto"])
@pytest.mark.parametrize("batch", [1, 3, 5, 16])
def test_policy_bit_identity_with_jax(monkeypatch, policy, batch):
    """encode / encode_digest / reconstruct / digest / verify are the JAX
    package's bits, pass names and placement counters whether a batch
    spans the mesh, routes to a submesh, or runs on one slot."""
    monkeypatch.setenv("MINIO_TPU_PLACEMENT", policy)
    monkeypatch.setenv("MINIO_TPU_SUBMESH_DEVICES", "2")
    t = BatchingBackend(instrument(TorchBackend(devices=CPU8)), deadline_s=0.01)
    j = JaxBatching(jinstrument(TpuBackend()), deadline_s=0.01)
    try:
        data = _data(batch)
        outs = {}
        for name, be in (("port", t), ("jax", j)):
            p, d = be.encode(data, 2)
            dd, ref = be.encode_digest_end(be.encode_digest_begin(data, 2))
            shards = np.concatenate([data, np.asarray(p)], axis=1)
            present = (False, True, True, True, True, False)
            r = be.reconstruct(shards, present, 4, 2)
            g = be.digest(shards)
            bad = shards.copy()
            bad[0, 2, 7] ^= 0x40
            v, ok = be.reconstruct_and_verify(bad, d, (True,) * 6, 4, 2)
            outs[name] = [np.asarray(x) for x in (p, d, dd, ref.drain(), r, g, v, ok)]
        for a, b in zip(outs["port"], outs["jax"]):
            assert np.array_equal(a, b)
        assert np.array_equal(outs["port"][4], data)
        assert np.array_equal(outs["port"][6], data)
    finally:
        t.shutdown()
        j.shutdown()
    snap, jsnap = KERNEL_STATS.snapshot(), JAX_STATS.snapshot()
    assert snap["device_passes"] == jsnap["device_passes"]
    assert snap["placement"] == jsnap["placement"]
    assert snap["submeshes"] == jsnap["submeshes"]
    if policy == "span":
        assert snap["placement"]["route"] == 0
    if policy == "route":
        assert snap["placement"]["span"] == 0


def test_single_slot_backend_has_nothing_to_route():
    t = TorchBackend(devices=("cpu",))
    assert t.placement_router() is None
    assert TpuBackend(devices=_jdevices(1)).placement_router() is None
    p, d = t.encode(_data(3), 2)
    jp, jd = CpuBackend().encode(_data(3), 2)
    assert np.array_equal(p, jp) and np.array_equal(d, jd)


# -- disjoint-submesh overlap -------------------------------------------------


class _BlockingBackend(TorchBackend):
    """Encode blocks until released so the test can observe two merged
    batches in flight on disjoint submeshes at the same time; each
    records the slots it was placed on."""

    def __init__(self, router):
        super().__init__("cpu")
        self._router = router
        self.started = threading.Semaphore(0)
        self.unblock = threading.Event()
        self.placements = []

    def placement_router(self):
        return self._router

    def encode(self, data, m):
        self.placements.append(tr.current_placement())
        self.started.release()
        if not self.unblock.wait(10):
            raise TimeoutError("test never released the encode")
        return super().encode(data, m)


def test_two_batches_overlap_on_disjoint_submeshes():
    router = tr.PlacementRouter(_tdevices(4), policy="route", submesh_devices=2)
    inner = _BlockingBackend(router)
    b = BatchingBackend(inner, deadline_s=0.01)
    results = {}
    try:
        # different lengths -> different merge keys -> two groups, each
        # routed to its own submesh worker
        def client(tag, length):
            data = _data(2, length=length, seed=len(tag) * 31 + length)
            results[tag] = (data, b.encode(data, 2))

        t1 = threading.Thread(target=client, args=("a", 64))
        t2 = threading.Thread(target=client, args=("b", 128))
        t1.start()
        t2.start()
        assert inner.started.acquire(timeout=10)
        assert inner.started.acquire(timeout=10)
        # both encodes are running right now: both submeshes occupied
        depths = router.depths()
        assert depths["sub0"] >= 1 and depths["sub1"] >= 1
        inner.unblock.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert not t1.is_alive() and not t2.is_alive()
    finally:
        inner.unblock.set()
        b.shutdown()
    assert len(inner.placements) == 2
    assert set(inner.placements) == {s.devices for s in router.submeshes}
    for data, (parity, digests) in results.values():
        p, d = CpuBackend().encode(data, 2)
        assert np.array_equal(parity, p) and np.array_equal(digests, d)
    snap = KERNEL_STATS.snapshot()
    assert snap["placement"]["route"] >= 2
    hwm = {s["submesh"]: s["depth_hwm"] for s in snap["submeshes"]}
    assert hwm.get("sub0", 0) > 0 and hwm.get("sub1", 0) > 0
    assert all(s["depth"] == 0 for s in snap["submeshes"])
    assert not b._workers  # shutdown stopped and joined the workers


def test_auto_policy_routes_only_throughput_ops():
    """Under "auto", reconstruct/digest stay on the span path; encode
    routes - in both packages, counter for counter."""
    counts = {}
    for name, lib, devs, base in (("port", tr, _tdevices(4), TorchBackend),
                                  ("jax", jr, _jdevices(4), CpuBackend)):

        class _Routed(base):
            def __init__(self, router):
                if base is TorchBackend:
                    super().__init__("cpu")
                self._router = router

            def placement_router(self):
                return self._router

        stats = KERNEL_STATS if name == "port" else JAX_STATS
        router = lib.PlacementRouter(devs, policy="auto", submesh_devices=2)
        b = (BatchingBackend if name == "port" else JaxBatching)(
            _Routed(router), deadline_s=0.01)
        try:
            data = _data(2)
            parity, _ = b.encode(data, 2)
            mid = dict(stats.snapshot()["placement"])
            shards = np.concatenate([data, np.asarray(parity)], axis=1)
            b.digest(shards)
            b.reconstruct(shards, (False, True, True, True, True, False), 4, 2)
            b.encode_digest_end(b.encode_digest_begin(data, 2))
        finally:
            b.shutdown()
        counts[name] = (mid, dict(stats.snapshot()["placement"]))
    assert counts["port"] == counts["jax"]
    mid, end = counts["port"]
    assert mid["route"] == 1 and end["route"] == 2
    assert end["span"] == mid["span"] + 2


def test_placement_families_render_in_prometheus_text():
    KERNEL_STATS.record_placement("route")
    KERNEL_STATS.record_submesh_depths({"sub0": 1, "sub1": 0})
    KERNEL_STATS.record_submesh_depths({"sub0": 0})
    text = Metrics().render().decode()
    assert 'miniotpu_codec_placement_total{policy="route"} 1' in text
    assert 'miniotpu_codec_placement_total{policy="span"} 0' in text
    assert 'miniotpu_codec_submesh_queue_depth{submesh="sub0"} 0' in text
    assert 'miniotpu_codec_submesh_queue_depth_peak{submesh="sub0"} 1' in text
    assert "# TYPE miniotpu_codec_submesh_queue_depth gauge" in text
    KERNEL_STATS.reset()
    snap = KERNEL_STATS.snapshot()
    assert snap["placement"] == {"span": 0, "route": 0}
    assert snap["submeshes"] == []


def test_instrumented_backend_delegates_placement_router():
    router = tr.PlacementRouter(_tdevices(4), policy="route", submesh_devices=2)
    inner = _BlockingBackend(router)
    assert instrument(inner).placement_router() is router
    assert instrument(TorchBackend("cpu")).placement_router() is None
    mesh_be = instrument(TorchBackend(devices=CPU8))
    assert len(mesh_be.placement_router().submeshes) == 8


def test_overlap_fallback_warns_once(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "pipeline")
    monkeypatch.setattr(tm, "_overlap_fallback_warned", False)
    monkeypatch.setattr(jm, "_overlap_fallback_warned", False)
    data = _data(3, k=8, length=256)
    texts = {}
    for name, be in (("port", TorchBackend(devices=CPU8)), ("jax", TpuBackend())):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for _ in range(3):
                digests, ref = be.encode_digest_end(be.encode_digest_begin(data, 4))
                ref.drain()
            shards = np.concatenate([data, ref.drain()], axis=1)
            be.reconstruct_and_verify(shards, digests, (True,) * 12, 8, 4)
        texts[name] = [str(w.message) for w in seen
                       if issubclass(w.category, RuntimeWarning)]
    assert len(texts["port"]) == 1
    assert texts["port"] == texts["jax"]


# -- the object layer on a mesh backend ---------------------------------------

N, M = 12, 4
BLOCK = 32 * 1024  # 1,024 words a shard
SIZE = BLOCK * 11 // 2
DEAD_SHARDS = (1, 3, 10, 12)


def _files(roots: list, name: str) -> list:
    out = []
    for r in roots:
        fi = XLStorage(r).read_version("bkt", name)
        with open(f"{r}/bkt/{name}/{fi.data_dir}/part.1", "rb") as f:
            part = f.read()
        with open(f"{r}/bkt/{name}/xl.meta", "rb") as f:
            docs = [v.to_dict() for v in XLMeta.from_bytes(f.read()).versions]
        for d in docs:
            for volatile in ("mod_time_ns", "data_dir", "version_id"):
                d.pop(volatile)
        out.append((part, docs))
    return out


@pytest.mark.parametrize("policy", ["span", "auto", "route"])
def test_erasure_put_degraded_get_heal_on_a_mesh(tmp_path, monkeypatch, policy):
    """A PUT, a GET with shards 1, 3, 10 and 12 offline, and heal_object
    on a mesh backend over 8 slots: part files and xl.meta equal the JAX
    package's on its 8-device mesh, and both ran the mesh passes."""
    monkeypatch.setenv("MINIO_TPU_PLACEMENT", policy)
    payload = np.random.default_rng(27).bytes(SIZE)
    tb = BatchingBackend(instrument(TorchBackend(devices=CPU8)))
    jb = JaxBatching(jinstrument(TpuBackend()))
    monkeypatch.setattr(jbackend, "_backend", jb)
    layers = {}
    try:
        for kind in ("port", "jax"):
            roots = [str(tmp_path / f"{kind}{i}") for i in range(N)]
            if kind == "port":
                ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                                    block_size=BLOCK, device="cpu")
                ol.backend = tb
            else:
                ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=M,
                                block_size=BLOCK)
            ol.make_bucket("bkt")
            ol.put_object("bkt", "obj", io.BytesIO(payload), SIZE)
            layers[kind] = (ol, roots)
        want = _files(layers["jax"][1], "obj")
        assert _files(layers["port"][1], "obj") == want
        for kind, (ol, roots) in layers.items():
            dist = XLStorage(roots[0]).read_version("bkt", "obj").erasure.distribution
            for d in range(N):
                if dist[d] in DEAD_SHARDS:
                    shutil.rmtree(f"{roots[d]}/bkt/obj")
            buf = io.BytesIO()
            ol.get_object("bkt", "obj", buf)  # rebuilt from the 8 survivors
            assert buf.getvalue() == payload
            assert ol.heal_object("bkt", "obj")["healed"] == [0, 2, 9, 11]
            assert _files(roots, "obj") == want
    finally:
        tb.shutdown()
        jb.shutdown()
    # a batch routed to a one-slot submesh (MINIO_TPU_SUBMESH_DEVICES=1)
    # takes the single-slot passes, whose names are the port's own
    mesh = {p for p in KERNEL_STATS.snapshot()["device_passes"]
            if p.startswith("mesh_")}
    assert mesh == {p for p in JAX_STATS.snapshot()["device_passes"]
                    if p.startswith("mesh_")}
    assert "mesh_verify_reconstruct" in mesh
    assert ("mesh_encode_hash" in mesh) == (policy == "span")
    assert (KERNEL_STATS.snapshot()["placement"]["route"] > 0) == (
        JAX_STATS.snapshot()["placement"]["route"] > 0)


# -- Select's scan router -----------------------------------------------------


class _CountingRouter(tr.PlacementRouter):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.claims = []
        self.releases = 0

    def route(self, batch_blocks):
        sub = super().route(batch_blocks)
        self.claims.append(None if sub is None else sub.name)
        return sub

    def release(self, sub):
        self.releases += 1
        super().release(sub)


def test_one_scan_slot_routes_nowhere():
    assert tdev.scan_devices("cpu") == (torch.device("cpu"),)
    assert tdev._scan_router("cpu").route(1) is None


def test_select_scan_under_a_two_submesh_router(monkeypatch):
    router = _CountingRouter((torch.device("cpu"),) * 2, policy="route")
    monkeypatch.setitem(tdev._routers, "cpu", router)
    monkeypatch.setattr(tdev.DeviceScan, "read_size", 8192)
    expr = "SELECT * FROM S3Object s WHERE s.k < 20000"
    data = _rows(2000, 6)
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)
    tdev.STATS.reset()
    tf, err = _run(teng, _body(expr), data, device="cpu")
    assert err is None
    assert tdev.STATS.snapshot()["requests"]["device"] == 1
    # every chunk claimed a submesh, least-loaded first, and released it
    assert len(router.claims) >= 3 and set(router.claims) == {"sub0"}
    assert router.releases == len(router.claims)
    assert router.depths() == {"sub0": 0, "sub1": 0}
    # the device-resident source claims and releases the same way
    plane, nbytes = tdev.as_device_plane([np.frombuffer(data, np.uint8)],
                                         len(data), "cpu")
    req = teng.SelectRequest.from_xml(_body(expr))
    frames: list = []
    teng.S3Select(req, "cpu").evaluate(None, len(data), frames.append,
                                       device_source=(plane, nbytes))
    assert router.releases == len(router.claims)
    assert router.depths() == {"sub0": 0, "sub1": 0}
    monkeypatch.setenv("MINIO_TPU_SELECT", "host")
    jf, _ = _run(jeng, _body(expr), data)
    assert _split(tf) == _split(jf)
    assert _split(frames)[0] == _split(jf)[0]


def test_select_scan_released_when_the_screen_raises(monkeypatch):
    router = _CountingRouter((torch.device("cpu"),) * 2, policy="route")
    monkeypatch.setitem(tdev._routers, "cpu", router)
    monkeypatch.delenv("MINIO_TPU_SELECT", raising=False)

    def boom(*a, **kw):
        raise RuntimeError("screen failed")

    monkeypatch.setattr(tdev.ss, "screen_chunk", boom)
    with pytest.raises(RuntimeError):
        teng.run_select(_body("SELECT * FROM S3Object s WHERE s.k < 9"),
                        _rows(50), [].append, device="cpu")
    assert router.claims and router.releases == len(router.claims)
    assert router.depths() == {"sub0": 0, "sub1": 0}


def test_scan_devices_take_every_visible_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert tdev.scan_devices("cuda") == tuple(cuda)
    assert tdev.scan_devices("cuda:2") == (cuda[2], cuda[0], cuda[1])
    assert tdev.scan_devices(torch.device("cpu")) == (torch.device("cpu"),)
