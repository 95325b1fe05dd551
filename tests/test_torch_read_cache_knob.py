"""``MINIO_TPU_READ_CACHE`` in the port (minio_tpu_torch), on the CPU.

The JAX package serves PUT and GET through its read cache when the knob
resolves to ``host`` or ``device`` (``auto`` resolves to one of them);
every other value resolves to ``off``.  The port has no read cache yet
(slice 9a), so:

* for ``host``, ``device`` and ``auto`` in any case and with any
  surrounding blanks, the object layer's PUT and GET raise
  NotImplementedError naming slice 9a, ``refuse_unported`` exits naming
  it, ``python -m minio_tpu_torch.server`` exits before it listens, and
  the S3 front answers ``NotImplemented``;
* unset, ``off``, ``0`` and an unknown word run PUT and GET as before,
  and the port's ``cache_mode()`` resolves every value as
  ``minio_tpu.cache.cache_mode()`` does.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import pytest

from minio_tpu import cache as jcache
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = ["host", "DEVICE", " auto ", "Host", "device\n"]
OFF = [None, "off", "0", "bogus", "", "OFF", "false", "no"]


def _layer(tmp_path) -> ErasureObjects:
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(4)],
                        parity_blocks=2, block_size=4096, device="cpu")
    ol.make_bucket("bkt")
    return ol


def _set(monkeypatch, value) -> None:
    if value is None:
        monkeypatch.delenv("MINIO_TPU_READ_CACHE", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_READ_CACHE", value)


@pytest.mark.parametrize("value", SERVED)
def test_served_modes_raise_naming_the_slice(tmp_path, monkeypatch, value):
    ol = _layer(tmp_path)
    ol.put_object("bkt", "before", io.BytesIO(b"x" * 5000), 5000)
    _set(monkeypatch, value)
    with pytest.raises(NotImplementedError, match=r"read cache.*\(slice 9a\)"):
        ol.put_object("bkt", "obj", io.BytesIO(b"y" * 5000), 5000)
    with pytest.raises(NotImplementedError, match=r"read cache.*\(slice 9a\)"):
        ol.get_object("bkt", "before", io.BytesIO())
    # nothing was written by the refused PUT
    monkeypatch.delenv("MINIO_TPU_READ_CACHE")
    assert [o.name for o in ol.list_objects("bkt").objects] == ["before"]


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
    assert (tcache.refused_read_cache() is None) == (jcache.cache_mode() == "off")


@pytest.mark.parametrize("value", SERVED)
def test_refuse_unported_names_the_slice(tmp_path, monkeypatch, value):
    _set(monkeypatch, value)
    with pytest.raises(SystemExit, match=r"read cache.*\(slice 9a\)"):
        tmain.refuse_unported([str(tmp_path / "d{1...4}")])


@pytest.mark.parametrize("value", OFF)
def test_refuse_unported_passes_off_modes(tmp_path, monkeypatch, value):
    _set(monkeypatch, value)
    tmain.refuse_unported([str(tmp_path / "d{1...4}")])


def test_boot_exits_naming_the_slice(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MINIO_TPU_", "MINIO_ERASURE"))}
    env.update(MINIO_ERASURE_BACKEND="cpu", MINIO_TPU_READ_CACHE="auto")
    res = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.server", "--address",
         "127.0.0.1:0", str(tmp_path / "d{1...4}")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode != 0, res.stdout
    assert "(slice 9a)" in res.stderr and "MINIO_TPU_READ_CACHE=auto" in res.stderr
    assert "listening" not in res.stdout
    assert not os.path.exists(tmp_path / "d1" / ".sys" / "format.json")


def test_s3_front_answers_not_implemented(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(4)],
                        parity_blocks=2, block_size=4096, device="cpu")
    srv = S3Server(ol, address="127.0.0.1:0").start()
    try:
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        assert c.put_object("bkt", "old", b"hello").status == 200
        monkeypatch.setenv("MINIO_TPU_READ_CACHE", "host")
        r = c.put_object("bkt", "obj", b"world")
        assert r.status == 501, r.body
        assert b"<Code>NotImplemented</Code>" in r.body
        assert b"(slice 9a)" in r.body
        r = c.get_object("bkt", "old")
        assert r.status == 501 and b"(slice 9a)" in r.body
        monkeypatch.setenv("MINIO_TPU_READ_CACHE", "off")
        assert c.put_object("bkt", "obj", b"world").status == 200
        assert c.get_object("bkt", "obj").body == b"world"
    finally:
        srv.shutdown()
