"""The read cache's admin routes and Prometheus families in the port's
server, held against minio_tpu's, on the CPU.

Each package serves one erasure set (6 drives, 4 KiB blocks; the port's
codec on the CPU) on its threaded plane.  With the cache off and live
(``host``, and ``device`` - the port's tier on the CPU device), the same
signed requests go to both: ``GET read-cache-stats``, ``POST
read-cache-clear``, ``GET healthinfo`` (one node: its ``read_cache``
block, and the document's shape) and the ``miniotpu_cache_*`` families
of the Prometheus page must be equal, and they must agree with the
cache's own ``stats()``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from minio_tpu import cache as jcache
from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

ADMIN = "/minio-tpu/admin/v1"
ROUTES = [("GET", "read-cache-stats"), ("POST", "read-cache-clear"),
          ("GET", "healthinfo")]
MODES = ["off", "host", "device"]


@pytest.fixture()
def servers(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.delenv("MINIO_TPU_READ_CACHE", raising=False)
    jbackend.reset_backend()
    tbackend.reset_backend()
    for mod in (jcache, tcache):
        mod.reset_read_cache()
    port = ErasureObjects([XLStorage(str(tmp_path / f"p{i}")) for i in range(6)],
                          block_size=4096, device="cpu")
    ref = JaxObjects([JaxStorage(str(tmp_path / f"j{i}")) for i in range(6)],
                     block_size=4096)
    srvs = {"port": S3Server(port, address="127.0.0.1:0").start(),
            "jax": JaxServer(ref, address="127.0.0.1:0").start()}
    try:
        yield srvs
    finally:
        for srv in srvs.values():
            srv.shutdown()
        for mod in (jcache, tcache):
            mod.reset_read_cache()
        jbackend.reset_backend()
        tbackend.reset_backend()


def _traffic(srvs, monkeypatch, mode):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", mode)
    for mod in (jcache, tcache):
        mod.reset_read_cache()
    rng = np.random.default_rng(5)
    objs = {f"o{i}": rng.bytes(4096 * (i + 1) + 7) for i in range(3)}
    for srv in srvs.values():
        c = S3Client(srv.endpoint)
        assert c.make_bucket("bkt").status == 200
        for k, v in objs.items():
            assert c.put_object("bkt", k, v).status == 200
        for _ in range(2):
            for k, v in objs.items():
                r = c.get_object("bkt", k)
                assert (r.status, r.body) == (200, v)


def _call(srv, method, tail):
    r = S3Client(srv.endpoint).request(method, f"{ADMIN}/{tail}")
    return r.status, json.loads(r.body)


def _prom_cache(srv) -> list:
    r = S3Client(srv.endpoint).request("GET", "/minio-tpu/prometheus/metrics")
    assert r.status == 200
    return [line for line in r.body.decode().splitlines()
            if "miniotpu_cache_" in line]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]} {r[1]}")
def test_admin_route_served(servers, monkeypatch, route, mode):
    _traffic(servers, monkeypatch, mode)
    stats = tcache.read_cache_stats()
    assert stats == jcache.read_cache_stats()
    if mode != "off":
        assert stats["tiers"][mode]["hits"] > 0
    got = {kind: _call(srv, *route) for kind, srv in servers.items()}
    assert got["port"][0] == got["jax"][0] == 200
    doc = got["port"][1]
    if route[1] == "read-cache-stats":
        assert doc == got["jax"][1] == stats
    elif route[1] == "read-cache-clear":
        assert doc == got["jax"][1]
        entries = sum(t["entries"] for t in stats["tiers"].values())
        assert doc == {"cleared": entries}
        after = tcache.read_cache_stats()
        assert all(t["entries"] == t["occupancy_bytes"] == 0
                   for t in after["tiers"].values())
        assert after == jcache.read_cache_stats()
    else:
        jdoc = got["jax"][1]
        assert len(doc["nodes"]) == len(jdoc["nodes"]) == 1
        node, jnode = doc["nodes"][0], jdoc["nodes"][0]
        assert node["read_cache"] == jnode["read_cache"] == stats
        assert set(node) == set(jnode)
        # the port's Select stats add the screen's counts (``screened``)
        assert set(node["select"]) == set(jnode["select"]) | {"screened"}
        assert set(node["codec_overlap"]) == set(jnode["codec_overlap"])
        assert node["codec_overlap"]["mode"] == "off"  # the CPU codec
        assert node["state"] == "online" and len(node["drives"]) == 6
        assert all(d["state"] == "ok" for d in node["drives"])
        # every drive probe cleaned up its file
        root = os.path.dirname(servers["port"].object_layer.disks[0].unwrapped.root)
        assert not [f for _d, _s, files in os.walk(root) for f in files
                    if f.startswith("obd-probe")]


@pytest.mark.parametrize("mode", MODES)
def test_prometheus_cache_families(servers, monkeypatch, mode):
    _traffic(servers, monkeypatch, mode)
    lines = _prom_cache(servers["port"])
    assert lines == _prom_cache(servers["jax"])
    st = tcache.read_cache_stats()
    want = {
        f'miniotpu_cache_hits_total{{tier="{t}"}} {st["tiers"][t]["hits"]}'
        for t in tcache.TIERS
    } | {
        f'miniotpu_cache_occupancy_bytes{{tier="{t}"}} '
        f'{st["tiers"][t]["occupancy_bytes"]}' for t in tcache.TIERS
    } | {
        f"miniotpu_cache_invalidations_total {st['invalidations']}",
        f'miniotpu_cache_admission_events_total{{kind="recorded"}} '
        f'{st["admission"]["recorded"]}',
    }
    assert want <= set(lines)
    families = {line.split()[2] for line in lines if line.startswith("# TYPE")}
    assert families == {
        "miniotpu_cache_hits_total", "miniotpu_cache_misses_total",
        "miniotpu_cache_evictions_total", "miniotpu_cache_rejects_total",
        "miniotpu_cache_entries", "miniotpu_cache_occupancy_bytes",
        "miniotpu_cache_budget_bytes", "miniotpu_cache_demotions_total",
        "miniotpu_cache_invalidations_total",
        "miniotpu_cache_admission_events_total",
    }
