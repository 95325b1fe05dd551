"""The native CPU codec behind the port's object layer and server.

* ``ErasureObjects`` over 12 drives at EC 8+4 with the native
  ``CpuBackend`` (``codec.backend.native_backend()``) beside the JAX
  package's layer under ``MINIO_ERASURE_BACKEND=cpu`` (its own
  ``CpuBackend``): PUT, GET, GET with the drives of shards 1, 3, 10 and 12
  offline, and heal of those drives' shards.  Part files and xl.meta
  (up to mod time, data dir and version id) must be equal, the port's
  codec ops are booked under backend ``cpu``, and no kernel launches.
* An early-ack PUT (``MINIO_TPU_PARITY_ACK=early``) through the native
  codec: the band adopts the parity and settles to the files of a
  ``settle`` PUT and of the JAX package's early PUT.
* The server's seam: ``build_object_layer(..., backend=)`` gives every
  set the one backend; ``codec_backend`` is the native codec for
  ``cpu`` and raises at boot when its build fails; in-process
  ``device="cpu"`` stays TorchBackend's plain path; ``python -m
  minio_tpu_torch.server`` under ``cpu`` serves through ``CpuBackend``
  (admin ``kernel-stats``: backend ``cpu``, no launches).
"""

import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.ops import kernels
from minio_tpu_torch.parallel import iopool
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from minio_tpu_torch.utils import native
from tests.s3client import S3Client
from tests.test_torch_main import ROOT, _env, _free_port, _ready, _until
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 12, 4
BLOCK = 32 * 1024
SIZES = {"byte": 1, "block": BLOCK, "blocks5_5": BLOCK * 11 // 2}
DEAD_SHARDS = (1, 3, 10, 12)  # erasure indices whose drives go offline
SETTLE_S = 30.0


@pytest.fixture(autouse=True)
def _native_env(monkeypatch):
    """Both packages' process-wide backends under MINIO_ERASURE_BACKEND=cpu,
    two native stripe workers a batch."""
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_ERASURE_BACKEND", "cpu")
    monkeypatch.setenv("MINIO_TPU_NATIVE_THREADS", "2")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _payload(size: int) -> bytes:
    return np.random.default_rng(size + 30).bytes(size)


def _layers(tmp_path, tag: str):
    troots = [str(tmp_path / f"{tag}-port{i}") for i in range(N)]
    jroots = [str(tmp_path / f"{tag}-jax{i}") for i in range(N)]
    port = ErasureObjects([XLStorage(r) for r in troots], parity_blocks=M,
                          block_size=BLOCK, backend=tbackend.native_backend())
    ref = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=M,
                     block_size=BLOCK)
    port.make_bucket("bkt")
    ref.make_bucket("bkt")
    return port, ref, troots, jroots


def _xl_meta(root: str, name: str) -> "list | None":
    try:
        with open(f"{root}/bkt/{name}/xl.meta", "rb") as f:
            versions = XLMeta.from_bytes(f.read()).versions
    except Exception:  # noqa: BLE001 - not written (or not whole) yet
        return None
    out = []
    for v in versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _part(root: str, name: str) -> "bytes | None":
    try:
        fi = XLStorage(root).read_version("bkt", name)
        with open(f"{root}/bkt/{name}/{fi.data_dir}/part.1", "rb") as f:
            return f.read()
    except Exception:  # noqa: BLE001 - the drive lacks the object
        return None


def _files(roots: list, name: str) -> list:
    return [(_part(r, name), _xl_meta(r, name)) for r in roots]


def _get(ol, name: str) -> bytes:
    buf = io.BytesIO()
    ol.get_object("bkt", name, buf)
    return buf.getvalue()


def _dead(roots: list, name: str) -> list:
    dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
    return [d for d in range(N) if dist[d] in DEAD_SHARDS]


def test_the_jax_layer_runs_its_native_codec():
    be = jbackend.get_backend()
    while hasattr(be, "inner"):
        be = be.inner
    assert isinstance(be, jbackend.CpuBackend)


def test_put_get_degraded_heal_equal_the_jax_package(tmp_path):
    port, ref, troots, jroots = _layers(tmp_path, "io")
    KERNEL_STATS.reset()
    kernels.reset_launches()
    for name, size in SIZES.items():
        data = _payload(size)
        port.put_object("bkt", name, io.BytesIO(data), size)
        ref.put_object("bkt", name, io.BytesIO(data), size)
        assert _files(troots, name) == _files(jroots, name), name
        assert _get(port, name) == data == _get(ref, name)
        dead = _dead(troots, name)
        degraded = ErasureObjects(
            [None if i in dead else XLStorage(r) for i, r in enumerate(troots)],
            parity_blocks=M, block_size=BLOCK, backend=tbackend.native_backend())
        got = io.BytesIO()
        info = degraded.get_object("bkt", name, got)
        assert got.getvalue() == data, name
        assert info.user_defined.get("x-internal-heal-required") == "true"
    # heal: the shards of the dead drives deleted on both packages' drives
    for name in SIZES:
        want = _files(troots, name)
        for roots in (troots, jroots):
            for d in _dead(roots, name):
                os.remove(os.path.join(
                    roots[d], "bkt", name, XLStorage(roots[d]).read_version(
                        "bkt", name).data_dir, "part.1"))
        port.heal_object("bkt", name)
        ref.heal_object("bkt", name)
        assert _files(troots, name) == want, name
        assert _files(jroots, name) == want, name
    snap = KERNEL_STATS.snapshot()
    assert {r["backend"] for r in snap["ops"]} == {"cpu"}
    assert {"encode_digest", "reconstruct_and_verify"} <= {
        r["op"] for r in snap["ops"]}
    assert not any(kernels.LAUNCHES.values())
    assert not snap["device_passes"]  # no TorchBackend pass ran


def test_early_ack_put_settles_as_the_jax_package(tmp_path, monkeypatch):
    size = SIZES["blocks5_5"]
    data = _payload(size)
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "settle")
    port, ref, troots, jroots = _layers(tmp_path, "settle")
    port.put_object("bkt", "obj", io.BytesIO(data), size)
    ref.put_object("bkt", "obj", io.BytesIO(data), size)
    settle = _files(troots, "obj")
    assert settle == _files(jroots, "obj")
    monkeypatch.setenv("MINIO_TPU_PARITY_ACK", "early")
    port, ref, troots, jroots = _layers(tmp_path, "early")
    finished = []
    finish = iopool.ParityBand.finish
    monkeypatch.setattr(iopool.ParityBand, "finish",
                        lambda band, **kw: finished.append(band) or finish(band, **kw))
    port.put_object("bkt", "obj", io.BytesIO(data), size)
    # the eager parity ref of the native codec still goes to the band
    assert len(finished) == 1 and finished[0].adopted
    assert _get(port, "obj") == data  # read right after the ack
    ref.put_object("bkt", "obj", io.BytesIO(data), size)
    for roots in (troots, jroots):
        deadline = time.monotonic() + SETTLE_S
        while any(_xl_meta(r, "obj") is None for r in roots):
            if time.monotonic() > deadline:
                pytest.fail("the parity band did not settle")
            time.sleep(0.01)
    assert _files(troots, "obj") == settle
    assert _files(jroots, "obj") == settle


def test_every_set_shares_the_given_backend(tmp_path):
    be = tmain.codec_backend("cpu")
    assert be is tbackend.native_backend() and be.name in ("batched", "cpu")
    assert tmain.codec_backend("cuda") is None
    ol = tmain.build_object_layer([str(tmp_path / "d{1...32}")], parity=4,
                                  device="cpu", backend=be)
    sets = [s for z in ol.zones for s in z.sets]
    assert len(sets) == 2 and all(s.backend is be for s in sets)
    assert all(s.backend.device.type == "cpu" for s in sets)


def test_in_process_cpu_device_stays_the_plain_torch_path(tmp_path):
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(4)],
                        parity_blocks=2, device="cpu")
    be = ol.backend
    while hasattr(be, "inner"):
        be = be.inner
    assert isinstance(be, tbackend.TorchBackend) and be.name == "torch"
    assert ol.backend is not tbackend.native_backend()


def test_failed_native_build_raises_at_boot(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text('extern "C" int gf_has_avx2(void) { return nope_y; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(SystemExit, match="nope_y"):
        tmain.codec_backend("cpu")
    with tbackend._lock:
        assert "native" not in tbackend._backends


def test_server_under_cpu_serves_through_the_native_codec(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--parity", "4",
         "--address", f"127.0.0.1:{port}", str(tmp_path / "d{1...12}")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _until(lambda: _ready(port) == 200, 90, "readiness 200")
        c = S3Client(f"http://127.0.0.1:{port}")
        assert c.make_bucket("bkt").status == 200
        data = np.random.default_rng(5).bytes(3 * (1 << 20) + 17)
        assert c.put_object("bkt", "obj", data).status == 200
        r = c.get_object("bkt", "obj")
        assert (r.status, r.body) == (200, data)
        r = c.request("GET", "/minio-tpu/admin/v1/kernel-stats")
        doc = json.loads(r.body)
        assert r.status == 200
        assert {row["backend"] for row in doc["ops"]} == {"cpu"}
        assert "encode_digest" in {row["op"] for row in doc["ops"]}
        assert doc["launches"] and not any(doc["launches"].values())
        assert not doc["device_passes"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out
    assert out.splitlines()[-1] == "shutdown complete"
