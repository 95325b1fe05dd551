"""``MINIO_TPU_READ_CACHE`` in the port (minio_tpu_torch), on the CPU.

The JAX package serves PUT and GET through its read cache when the knob
resolves to ``host`` or ``device`` (``auto`` resolves to one of them);
every other value resolves to ``off``.  The port serves the same modes
(the test names come from the slice before the cache was ported, when
these modes were refused; each now checks the served behaviour):

* for ``host``, ``device`` and ``auto`` in any case and with any
  surrounding blanks, the object layer's PUT and GET serve through the
  read cache with the JAX package's bodies and stats, the server
  main builds its object layer with them set, ``python -m
  minio_tpu_torch.server`` boots and serves GETs from the cache, and
  the S3 front answers PUT and GET as the JAX package's does;
* unset, ``off``, ``0`` and an unknown word run PUT and GET as before,
  and the port's ``cache_mode()`` resolves every value as
  ``minio_tpu.cache.cache_mode()`` does.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys

import pytest

from minio_tpu import cache as jcache
from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_main import _env, _free_port, _ready, _until
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = ["host", "DEVICE", " auto ", "Host", "device\n"]
OFF = [None, "off", "0", "bogus", "", "OFF", "false", "no"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    for mod in (jcache, tcache):
        mod.reset_read_cache()
    yield
    for mod in (jcache, tcache):
        mod.reset_read_cache()


def _layer(tmp_path, tag="") -> ErasureObjects:
    ol = ErasureObjects(
        [XLStorage(str(tmp_path / f"d{tag}{i}")) for i in range(4)],
        parity_blocks=2, block_size=4096, device="cpu")
    ol.make_bucket("bkt")
    return ol


def _jax_layer(tmp_path) -> JaxObjects:
    ol = JaxObjects([JaxStorage(str(tmp_path / f"j{i}")) for i in range(4)],
                    parity_blocks=2, block_size=4096)
    ol.make_bucket("bkt")
    return ol


def _set(monkeypatch, value) -> None:
    if value is None:
        monkeypatch.delenv("MINIO_TPU_READ_CACHE", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_READ_CACHE", value)
    for mod in (jcache, tcache):
        mod.reset_read_cache()


@pytest.mark.parametrize("value", SERVED)
def test_served_modes_raise_naming_the_slice(tmp_path, monkeypatch, value):
    """Each served mode runs PUT and GET through the read cache, as the
    JAX package does: equal bodies, equal cache stats, nothing refused."""
    ol, ref = _layer(tmp_path), _jax_layer(tmp_path)
    for layer in (ol, ref):
        layer.put_object("bkt", "before", io.BytesIO(b"x" * 5000), 5000)
    _set(monkeypatch, value)
    body = bytes(range(256)) * 40
    for layer in (ol, ref):
        layer.put_object("bkt", "obj", io.BytesIO(body), len(body))
        for name, want in (("obj", body), ("before", b"x" * 5000),
                           ("before", b"x" * 5000)):
            out = io.BytesIO()
            layer.get_object("bkt", name, out)
            assert out.getvalue() == want
    st = tcache.read_cache_stats()
    assert st == jcache.read_cache_stats()
    mode = jcache.cache_mode()
    assert st["mode"] == mode != "off"
    assert st["tiers"][mode]["hits"] >= 2  # obj and the second "before"
    assert [o.name for o in ol.list_objects("bkt").objects] == ["before", "obj"]


@pytest.mark.parametrize("value", OFF)
def test_off_modes_run_as_before(tmp_path, monkeypatch, value):
    _set(monkeypatch, value)
    ol = _layer(tmp_path)
    body = bytes(range(256)) * 40
    assert ol.put_object("bkt", "obj", io.BytesIO(body), len(body)).size == len(body)
    out = io.BytesIO()
    ol.get_object("bkt", "obj", out)
    assert out.getvalue() == body


@pytest.mark.parametrize("value", SERVED + OFF)
def test_cache_mode_resolves_as_the_reference(monkeypatch, value):
    _set(monkeypatch, value)
    # the JAX side runs on the CPU here, and so does the port's: auto
    # resolves to host in both
    assert tcache.cache_mode() == jcache.cache_mode()
    assert (tcache.read_cache("cpu") is None) == (jcache.cache_mode() == "off")


@pytest.mark.parametrize("value", SERVED)
def test_refuse_unported_names_the_slice(tmp_path, monkeypatch, value):
    """A served mode is not refused at boot: the server main builds its
    object layer with the knob set (since the FS mode and the gateways
    were ported, the boot refuses no layout for being unported)."""
    _set(monkeypatch, value)
    ol = tmain.build_object_layer([str(tmp_path / "d{1...4}")], device="cpu")
    assert len(ol.zones[0].sets[0].disks) == 4


@pytest.mark.parametrize("value", OFF)
def test_refuse_unported_passes_off_modes(tmp_path, monkeypatch, value):
    _set(monkeypatch, value)
    ol = tmain.build_object_layer([str(tmp_path / "d{1...4}")], device="cpu")
    assert len(ol.zones[0].sets[0].disks) == 4


def test_boot_exits_naming_the_slice(tmp_path):
    """``python -m minio_tpu_torch.server`` with MINIO_TPU_READ_CACHE=auto
    boots (auto resolves to the host tier without a card, to the device
    tier - here the codec's CPU device - with one) and serves a GET from
    the cache; the admin route reports it."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--address",
         f"127.0.0.1:{port}", str(tmp_path / "d{1...4}")],
        cwd=ROOT, env=_env(MINIO_TPU_READ_CACHE="auto"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _until(lambda: _ready(port) == 200, 90, "readiness 200")
        c = S3Client(f"http://127.0.0.1:{port}")
        assert c.make_bucket("bkt").status == 200
        body = os.urandom(70_000)
        assert c.put_object("bkt", "obj", body).status == 200
        for _ in range(2):
            r = c.get_object("bkt", "obj")
            assert (r.status, r.body) == (200, body)
        r = c.request("GET", "/minio-tpu/admin/v1/read-cache-stats")
        doc = json.loads(r.body)
        assert r.status == 200 and doc["mode"] in ("host", "device")
        assert doc["tiers"][doc["mode"]]["hits"] >= 2
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out
    assert "slice 9a" not in out
    assert os.path.exists(tmp_path / "d1" / ".sys" / "format.json")


def test_s3_front_answers_not_implemented(tmp_path, monkeypatch):
    """The S3 front serves PUT and GET under a read-cache mode as the JAX
    package's does: the same statuses and bodies, the same cache stats."""
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    jbackend.reset_backend()
    tbackend.reset_backend()
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(4)],
                        parity_blocks=2, block_size=4096, device="cpu")
    ref = JaxObjects([JaxStorage(str(tmp_path / f"j{i}")) for i in range(4)],
                     parity_blocks=2, block_size=4096)
    srvs = [S3Server(ol, address="127.0.0.1:0").start(),
            JaxServer(ref, address="127.0.0.1:0").start()]
    got = []
    try:
        for srv in srvs:
            c = S3Client(srv.endpoint)
            assert c.make_bucket("bkt").status == 200
            assert c.put_object("bkt", "old", b"hello").status == 200
        _set(monkeypatch, "host")
        for srv in srvs:
            c = S3Client(srv.endpoint)
            rs = [c.put_object("bkt", "obj", b"world" * 3000),
                  c.get_object("bkt", "old"), c.get_object("bkt", "obj"),
                  c.get_object("bkt", "obj")]
            got.append([(r.status, r.body) for r in rs])
        assert got[0] == got[1]
        assert got[0][3] == (200, b"world" * 3000)
        st = tcache.read_cache_stats()
        assert st == jcache.read_cache_stats()
        assert st["mode"] == "host" and st["tiers"]["host"]["hits"] >= 2
    finally:
        for srv in srvs:
            srv.shutdown()
        jbackend.reset_backend()
        tbackend.reset_backend()
