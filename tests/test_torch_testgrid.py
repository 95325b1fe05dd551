"""The port's chaos grid held against minio_tpu's, in process.

Fast tier (no server spawned):

* ``parse_prometheus`` gives the JAX parser's rows on the same texts:
  fixed cases and hypothesis over label values with escapes, quotes,
  commas and braces;
* ``merged_metrics`` labels every sample with its node and zero-fills
  the families a live node did not export (as the JAX
  ``tests/test_cluster_grid.py`` test does);
* ``GRID`` equals the JAX package's, scenario for scenario and field for
  field, faults included;
* ``check_no_torn_meta`` passes on a tree of ``xl.meta`` written by
  either package, counting as the JAX sweep does, and fails on a torn
  one;
* the replication verbs, the JAX package's and the port's, leave the
  same bucket documents on a port server and judge the same destination
  converged or lagging;
* ``test_chaos_grid[replication_lag_churn]``: that cell runs to its
  invariants on 3 port nodes x 2 drives on the CPU (the destination
  converges under churn with a write fault on one node).

Slow tier (``-m slow``, not in tier-1): each other scenario of the grid
on 3 port nodes x 2 drives spawned by the port's ``ClusterHarness`` with
``MINIO_ERASURE_BACKEND=cpu`` (the native codec, 2 threads a batch),
asserting the JAX grid's invariants.
"""

import dataclasses
import io
import os
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from minio_tpu.cluster import harness as jharness
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu.testgrid import engine as jengine, scenarios as jscenarios
from minio_tpu_torch.cluster import harness as tharness
from minio_tpu_torch.cluster.harness import ClusterHarness, parse_prometheus
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.xl import XLStorage
from minio_tpu_torch.testgrid import GRID, engine as tengine, run_scenario
from minio_tpu_torch.testgrid import scenario_by_name
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

TEXTS = [
    "# HELP x y\n# TYPE x counter\n"
    'x{a="1",b="two words"} 3.5\n'
    "plain 4\n"
    "garbage line\n",
    'miniotpu_disk_state{disk="http://127.0.0.1:1/d1"} 2\n'
    "miniotpu_hedge_launched_total 7\n",
    'm{api="read_at",disk="/x/y"} 1e3\nm{api="write"} +Inf\n'
    'n{a="x,y",b="}"} NaN\n',
    "",
    "   \n# only comments\n",
    'trailing{a="1",} 2\nspaced{a="1", b="2"} 3\n',
]


def _same(text: str) -> None:
    got, want = parse_prometheus(text), jharness.parse_prometheus(text)
    assert repr(got) == repr(want)  # NaN-safe equality


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_parse_prometheus_matches_reference(i):
    _same(TEXTS[i])


def test_parse_prometheus():
    rows = parse_prometheus(TEXTS[0])
    assert ("x", {"a": "1", "b": "two words"}, 3.5) in rows
    assert ("plain", {}, 4.0) in rows
    assert len(rows) == 2


# label values built from escape sequences and the characters the
# parser splits on
_label_value = st.lists(
    st.sampled_from(list('ab01 ,="{}\\') + ['\\"', "\\\\", "\\n"]),
    max_size=8,
).map("".join)


@settings(max_examples=200, deadline=None)
@given(
    values=st.lists(_label_value, min_size=1, max_size=3),
    value=st.one_of(st.floats(allow_nan=False), st.integers(-10**6, 10**6)),
)
def test_parse_prometheus_label_escapes(values, value):
    labels = ",".join(f'l{i}="{v}"' for i, v in enumerate(values))
    text = f"fam{{{labels}}} {value}\nother {value}\n"
    _same(text)


def test_metrics_merge_zero_fill(tmp_path):
    """merged_metrics labels every sample with its node and zero-fills
    families a live node did not export, so per-node queries can tell
    'zero' from 'absent'."""
    h = ClusterHarness(tmp_path, nodes=2, drives_per_node=1)

    class _Fake:
        def poll(self):
            return None

    for n in h.nodes:
        n.proc = _Fake()  # pretend both are alive; scrape is stubbed
    scrapes = {
        0: (
            'miniotpu_disk_state{disk="http://127.0.0.1:1/d1"} 2\n'
            "miniotpu_hedge_launched_total 7\n"
        ),
        1: "",  # node2 exports nothing
    }
    h.scrape = lambda i: scrapes[i]

    merged = h.merged_metrics()
    states = merged["miniotpu_disk_state"]
    assert ({"disk": "http://127.0.0.1:1/d1", "node": "n1"}, 2.0) in states
    assert ({"node": "n2"}, 0.0) in states  # zero-filled
    hedge = merged["miniotpu_hedge_launched_total"]
    assert ({"node": "n1"}, 7.0) in hedge
    assert ({"node": "n2"}, 0.0) in hedge
    assert merged["miniotpu_server_shed_total"] == [
        ({"node": "n1"}, 0.0), ({"node": "n2"}, 0.0)]
    # a chosen family: no zero-fill outside ZERO_FILL_FAMILIES
    only = h.merged_metrics(families=("miniotpu_hedge_launched_total",
                                      "absent_total"))
    assert only == {"miniotpu_hedge_launched_total": hedge,
                    "absent_total": []}
    assert h.disk_states(0) == {"http://127.0.0.1:1/d1": 2}
    assert h.disk_states(1) == {}
    assert tharness.ZERO_FILL_FAMILIES == jharness.ZERO_FILL_FAMILIES


def test_spawn_env_opens_the_scrape(tmp_path):
    """The nodes serve Prometheus without auth, as the JAX harness's do,
    so ``scrape`` needs no signature."""
    h = ClusterHarness(tmp_path, nodes=1, drives_per_node=1)
    env = h._spawn_env(h.nodes[0])
    assert env["MINIO_TPU_PROMETHEUS_AUTH_TYPE"] == "public"


def test_grid_equals_reference():
    assert len(GRID) == len(jscenarios.GRID) == 10
    for port_sc, jax_sc in zip(GRID, jscenarios.GRID):
        assert dataclasses.asdict(port_sc) == dataclasses.asdict(jax_sc)
        assert scenario_by_name(jax_sc.name) is port_sc
    assert dataclasses.asdict(tengine.Fault(node=1, api="x")) == \
        dataclasses.asdict(jengine.Fault(node=1, api="x"))
    with pytest.raises(KeyError):
        scenario_by_name("no_such_cell")


def test_every_step_verb_is_served():
    """Every verb a scenario uses, and every verb of the JAX engine, is
    in the port's table."""
    used = {step[0] for sc in GRID for step in sc.steps}
    assert used <= set(tengine._VERBS)
    assert set(tengine._VERBS) == set(jengine._VERBS)


def test_payloads_match_reference():
    assert tengine.payload(1000, 7) == jengine.payload(1000, 7)
    assert tengine.csv_payload(50, 17) == jengine.csv_payload(50, 17)


def _meta_tree(tmp_path):
    """Two 'nodes' of two drives: node 1's drives written by the port,
    node 2's by the JAX package, the same objects on both."""
    nodes = []
    rng = np.random.default_rng(11)
    data = {f"k{i}": rng.bytes(5000 + i) for i in range(3)}
    for idx, (kind, storage) in enumerate((("port", XLStorage),
                                           ("jax", JaxStorage))):
        dirs = [tmp_path / kind / f"d{j}" for j in range(2)]
        disks = [storage(str(d)) for d in dirs]
        if kind == "port":
            ol = ErasureObjects(disks, parity_blocks=1, block_size=4096,
                                device="cpu")
        else:
            ol = JaxObjects(disks, parity_blocks=1, block_size=4096)
        ol.make_bucket("grid")
        for k, v in data.items():
            ol.put_object("grid", k, io.BytesIO(v), len(v))
        nodes.append(types.SimpleNamespace(index=idx, drive_dirs=dirs))
    return types.SimpleNamespace(h=types.SimpleNamespace(nodes=nodes))


def test_check_no_torn_meta(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    ctx = _meta_tree(tmp_path)
    n = tengine.check_no_torn_meta(ctx)
    assert n == jengine.check_no_torn_meta(ctx) == 12
    # tear one journal on node 2 (the JAX package's drive)
    victim = ctx.h.nodes[1].drive_dirs[1] / "grid" / "k1" / "xl.meta"
    raw = victim.read_bytes()
    victim.write_bytes(raw[: len(raw) // 2])
    for mod in (tengine, jengine):
        with pytest.raises(AssertionError, match="torn xl.meta on n2") as ei:
            mod.check_no_torn_meta(ctx)
        assert os.path.join("grid", "k1", "xl.meta") in str(ei.value)


class _Client:
    """The harness client's shape over the tests' S3Client."""

    def __init__(self, endpoint):
        self._c = S3Client(endpoint)

    def request(self, method, path, query=None, body=b"", headers=None):
        r = self._c.request(method, path, query=query, body=body,
                            headers=headers)
        return r.status, r.headers, r.body

    def close(self):
        pass


def _verb_ctx(mod, srv):
    ctx = mod._Ctx(types.SimpleNamespace(
        client=lambda node: _Client(srv.endpoint)))
    return ctx


@pytest.fixture()
def verb_servers(tmp_path, monkeypatch):
    """One port server per package's verbs, buckets ``grid``, ``replica``."""
    from minio_tpu_torch.server.http import S3Server

    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    out = {}
    for kind in ("jax", "port"):
        ol = ErasureObjects([XLStorage(str(tmp_path / kind / f"d{i}"))
                             for i in range(4)], block_size=4096, device="cpu")
        srv = S3Server(ol, address="127.0.0.1:0").start()
        c = S3Client(srv.endpoint)
        for b in (tengine.BUCKET, "replica"):
            assert c.make_bucket(b).status == 200
        out[kind] = srv
    yield out
    for srv in out.values():
        srv.shutdown()


def test_enable_replication_verb_matches(verb_servers):
    """Each package's ``enable_replication`` (once refused naming slice
    9c) leaves the same versioning and replication documents, and a PUT
    into the grid bucket then replicates."""
    got = {}
    for kind, mod in (("jax", jengine), ("port", tengine)):
        srv = verb_servers[kind]
        mod._VERBS["enable_replication"](_verb_ctx(mod, srv), 0, "replica")
        bm = srv.bucket_meta.get(tengine.BUCKET)
        c = S3Client(srv.endpoint)
        assert c.put_object(tengine.BUCKET, "k", b"payload").status == 200
        srv.replication.drain()
        got[kind] = (bm.versioning, bm.replication_xml,
                     c.get_object("replica", "k").body)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "Enabled" and got["port"][2] == b"payload"


def test_await_replication_verb_matches(verb_servers):
    """Each package's ``await_replication`` passes once every key reads
    back an acceptable payload, and names the same lagging keys when
    one is stale or missing."""
    got = {}
    for kind, mod in (("jax", jengine), ("port", tengine)):
        srv = verb_servers[kind]
        ctx = _verb_ctx(mod, srv)
        c = S3Client(srv.endpoint)
        assert c.put_object("replica", "a", b"A1").status == 200
        assert c.put_object("replica", "b", b"old").status == 200
        ctx.objects = {"a": [b"A1"], "b": [b"new", b"newer"], "c": [b"C"]}
        verb = mod._VERBS["await_replication"]
        verb(ctx, 0, "replica", ("a",), timeout_s=2)
        with pytest.raises(AssertionError) as ei:
            verb(ctx, 0, "replica", ("a", "b", "c"), timeout_s=0.6)
        got[kind] = str(ei.value)
    assert got["port"] == got["jax"]
    assert "'b': 'stale body (3 bytes)'" in got["port"]
    assert "'c': 'HTTP 404'" in got["port"]


# -- the chaos grid (slow but one cell) ----------------------------------

# every cell is slow but ``replication_lag_churn`` (about 30 s on 3 CPU
# nodes), which runs in tier-1: the replica converges under churn with a
# write fault on one node, and the sweep holds
@pytest.mark.parametrize("scenario", [
    pytest.param(sc, id=sc.name, marks=(
        () if sc.name == "replication_lag_churn" else pytest.mark.slow))
    for sc in GRID])
def test_chaos_grid(scenario, tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_ERASURE_BACKEND", "cpu")
    # the native codec's stripe workers: 2 a batch, not a core each
    monkeypatch.setenv("MINIO_TPU_NATIVE_THREADS", "2")
    for name in ("MINIO_TPU_SERVER", "MINIO_TPU_READ_CACHE",
                 "MINIO_TPU_FEDERATION_DIR", "MINIO_TPU_CACHE_DRIVES"):
        monkeypatch.delenv(name, raising=False)
    report = run_scenario(scenario, tmp_path)
    assert report["objects"] >= scenario.seed_objects
    assert report["meta_files"] > 0
    if any(step[0] == "await_breaker" for step in scenario.steps):
        assert report["breaker_events"], "breaker cycle not observed"
