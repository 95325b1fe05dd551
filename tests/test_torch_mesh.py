"""The port's device mesh (minio_tpu_torch.parallel.mesh and .rules)
held against minio_tpu.parallel on the conftest's 8 virtual CPU devices.

The port's mesh is single-controller: one process drives a (stripe,
shard) grid of torch device slots, here ``("cpu",) * n`` - as the JAX
package's mesh runs in this process over its virtual CPU devices.  Every
entry point takes the same seeded inputs as the JAX one on a mesh of the
same shape and must give the same bits: the XOR all-reduce (power-of-two
axes and not, and a case that a step which XORs a partner in place
before every partner's pre-step value was taken gets wrong),
sharded_encode over every (stripe, shard) of 8 slots, the sequence
form, mesh_encode_hash (and its begin/end), mesh_reconstruct over
several survivor patterns, mesh_verify_reconstruct with a corrupt row,
mesh_digest at B = 1, 3, 8 and 13; pick_axes, the batch bucket and pad,
the rules table, its fingerprint, the registry and the lowering each
geometry takes; the plan cache across rebuilt meshes; both lowerings
forced on every kind; and TorchBackend over several slots.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.telemetry import KERNEL_STATS as JAX_STATS
from minio_tpu.ops import gf
from minio_tpu.parallel import mesh as jm, rules as jr
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.parallel import mesh as tm, rules as tr
from tests.test_torch_threads import torch_threads  # noqa: F401

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
BATCHES = [1, 3, 8, 13]
K, M = 8, 4
W = 64  # words a shard
# the JAX lowering names -> the port's
MODE_NAMES = {"shard_map": "local", "jit": "global"}


def _slots(n: int) -> tuple:
    return ("cpu",) * n


def _meshes(stripe: int, shard: int):
    return (tm.make_mesh(_slots(stripe * shard), stripe, shard),
            jm.make_mesh(stripe=stripe, shard=shard))


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


# -- the mesh and the XOR all-reduce ------------------------------------------


def test_make_mesh_shapes():
    m = tm.make_mesh(_slots(8))
    assert m.shape == dict(jm.make_mesh().shape) == {"stripe": 8, "shard": 1}
    m2 = tm.make_mesh(_slots(8), stripe=2, shard=4)
    assert m2.shape == dict(jm.make_mesh(stripe=2, shard=4).shape)
    assert m2.devices.size == 8 and m2.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m2.devices.flat)
    assert tm.make_mesh(_slots(8), shard=2).shape == {"stripe": 4, "shard": 2}
    with pytest.raises(ValueError):
        tm.make_mesh(_slots(8), stripe=3, shard=3)
    with pytest.raises(ValueError):
        jm.make_mesh(stripe=3, shard=3)


def _jax_allreduce(vals: np.ndarray) -> np.ndarray:
    n = vals.shape[0]
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("x",))
    fn = jm._shard_map(
        lambda v: jm.xor_allreduce(v, "x"),
        mesh=mesh, in_specs=P("x", None), out_specs=P("x", None),
        check_vma=False,
    )
    return np.asarray(fn(vals))


@pytest.mark.parametrize("axis_n", [1, 2, 3, 4, 6, 8])
def test_xor_allreduce_matches_jax(axis_n):
    vals = _words(np.random.default_rng(axis_n), (axis_n, 16))
    want = _jax_allreduce(vals)
    parts = [torch.from_numpy(v.view(np.int32).copy()) for v in vals]
    got = tm.xor_allreduce(parts)
    assert len(got) == axis_n
    for d in range(axis_n):
        assert np.array_equal(got[d].numpy().view(np.uint32), want[d])
    assert np.array_equal(want[0], np.bitwise_xor.reduce(vals, axis=0))


def _naive_allreduce(parts: list) -> list:
    """Recursive doubling that XORs each partner in place as it goes: on
    slots that share a device, ``.to`` hands back the partner itself, so
    a later slot reads a partner this step already updated."""
    out = list(parts)
    step = 1
    while step < len(out):
        for i in range(len(out)):
            out[i].bitwise_xor_(out[i ^ step].to(out[i].device))
        step <<= 1
    return out


@pytest.mark.parametrize("axis_n", [2, 4, 8])
def test_xor_allreduce_takes_every_partner_before_any_xor(axis_n):
    """Slots on one device, distinct values: the naive in-place loop
    gets this wrong; the port's all-reduce gives every slot the XOR."""
    vals = _words(np.random.default_rng(100 + axis_n), (axis_n, 32))
    want = np.bitwise_xor.reduce(vals, axis=0)

    def fresh():
        return [torch.from_numpy(v.view(np.int32).copy()) for v in vals]

    naive = [t.numpy().view(np.uint32) for t in _naive_allreduce(fresh())]
    assert not all(np.array_equal(t, want) for t in naive)
    got = tm.xor_allreduce(fresh())
    assert all(np.array_equal(t.numpy().view(np.uint32), want) for t in got)
    # each slot keeps its own tensor: no two slots alias one buffer
    assert len({t.data_ptr() for t in got}) == axis_n


# -- the entry points against the JAX mesh ----------------------------------


@pytest.mark.parametrize("stripe,shard", SHAPES)
def test_sharded_encode_all_mesh_shapes(stripe, shard):
    tmesh, jmesh = _meshes(stripe, shard)
    B, L = max(2, stripe), 512
    rng = np.random.default_rng(stripe * 10 + shard)
    data = rng.integers(0, 256, (B, K, L)).astype(np.uint8)
    jd = jm.put_sharded(jmesh, data, P("stripe", "shard", None))
    want = np.asarray(jm.sharded_encode(jmesh, jd, M))
    td = tm.put_sharded(tmesh, data, ("stripe", "shard", None))
    got = np.asarray(tm.sharded_encode(tmesh, td, M))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, np.stack([gf.encode_ref(d, M) for d in data]))
    # a host array is placed by the rules (stripe_bytes)
    assert np.array_equal(np.asarray(tm.sharded_encode(tmesh, data, M)), want)


def test_sharded_encode_rejects_k_not_dividing_shard():
    tmesh, _ = _meshes(2, 4)
    with pytest.raises(ValueError):
        tm.sharded_encode(tmesh, np.zeros((2, 6, 64), np.uint8), 2)


@pytest.mark.parametrize("stripe,shard", [(4, 2), (1, 8)])
def test_sharded_encode_seq_long_object(stripe, shard):
    tmesh, jmesh = _meshes(stripe, shard)
    k, m = 4, 2
    data = np.random.default_rng(7).integers(0, 256, (k, 8 * 1024)).astype(np.uint8)
    jd = jm.put_sharded(jmesh, data, P(None, ("stripe", "shard")))
    want = np.asarray(jm.sharded_encode_seq(jmesh, jd, m))
    got = np.asarray(tm.sharded_encode_seq(tmesh, data, m))
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf.encode_ref(data, m))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stripe,shard", SHAPES)
def test_mesh_encode_hash_matches_jax(stripe, shard, B):
    tmesh, jmesh = _meshes(stripe, shard)
    words = _words(np.random.default_rng(B * 100 + stripe), (B, K, W))
    parity, digests = tm.mesh_encode_hash(tmesh, words, M, 4 * W)
    jparity, jdigests = jm.mesh_encode_hash(jmesh, words, M, 4 * W)
    assert parity.dtype == np.uint32 and digests.dtype == np.uint32
    assert parity.shape == (B, M, W) and digests.shape == (B, K + M, 8)
    assert np.array_equal(parity, jparity)
    assert np.array_equal(digests, jdigests)
    # begin queues, end reads back: the same bits
    h = tm.mesh_encode_hash_begin(tmesh, words, M, 4 * W)
    assert h[-1] == B
    p2, d2 = tm.mesh_encode_hash_end(h)
    assert np.array_equal(p2, parity) and np.array_equal(d2, digests)


# survivors: data rows lost, parity rows lost, a mix; all 12 present
PATTERNS = [
    (False, True, False, True) + (True,) * 8,
    (True,) * 8 + (False,) * 4,
    (False,) * 4 + (True,) * 8,
    (True,) * 12,
]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stripe,shard", SHAPES)
def test_mesh_reconstruct_matches_jax(stripe, shard, B):
    tmesh, jmesh = _meshes(stripe, shard)
    rng = np.random.default_rng(B * 7 + shard)
    data = _words(rng, (B, K, W))
    parity, _ = jm.mesh_encode_hash(jmesh, data, M, 4 * W)
    shards = np.concatenate([data, parity], axis=1)
    present = PATTERNS[(B + stripe) % len(PATTERNS)]
    garbage = shards.copy()
    garbage[:, [i for i, p in enumerate(present) if not p]] = 0xDEADBEEF
    got = tm.mesh_reconstruct(tmesh, garbage, present, K, M)
    want = jm.mesh_reconstruct(jmesh, garbage, present, K, M)
    assert np.array_equal(got, want) and np.array_equal(got, data)


@pytest.mark.parametrize("present", PATTERNS)
def test_mesh_reconstruct_survivor_patterns(present):
    tmesh, jmesh = _meshes(2, 4)
    data = _words(np.random.default_rng(3), (3, K, W))
    parity, _ = jm.mesh_encode_hash(jmesh, data, M, 4 * W)
    shards = np.concatenate([data, parity], axis=1)
    got = tm.mesh_reconstruct(tmesh, shards, present, K, M)
    assert np.array_equal(got, jm.mesh_reconstruct(jmesh, shards, present, K, M))
    assert np.array_equal(got, data)
    with pytest.raises(ValueError):
        tm.mesh_reconstruct(tmesh, shards, (True,) * 7 + (False,) * 5, K, M)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stripe,shard", SHAPES)
def test_mesh_verify_reconstruct_matches_jax(stripe, shard, B):
    tmesh, jmesh = _meshes(stripe, shard)
    rng = np.random.default_rng(B * 13 + stripe)
    data = _words(rng, (B, K, W))
    parity, digests = jm.mesh_encode_hash(jmesh, data, M, 4 * W)
    shards = np.concatenate([data, parity], axis=1)
    shards[B - 1, 2, 5] ^= 1  # bitrot in a survivor of the last stripe
    present = (True,) * 10 + (False, True)
    got = tm.mesh_verify_reconstruct(tmesh, shards, digests, present, K, M, 4 * W)
    want = jm.mesh_verify_reconstruct(jmesh, shards, digests, present, K, M, 4 * W)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    ok = got[1]
    assert ok.dtype == np.bool_ and ok.shape == (B, K + M)
    assert not ok[B - 1, 2] and not ok[:, 10].any()
    assert ok.sum() == B * 11 - 1
    assert np.array_equal(got[0][: B - 1], data[: B - 1])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stripe,shard", SHAPES)
def test_mesh_digest_matches_jax(stripe, shard, B):
    tmesh, jmesh = _meshes(stripe, shard)
    rows = _words(np.random.default_rng(B + 50 * shard), (B, W))
    got = tm.mesh_digest(tmesh, rows, 4 * W)
    assert got.shape == (B, 8)
    assert np.array_equal(got, jm.mesh_digest(jmesh, rows, 4 * W))


# -- axes, buckets, padding ---------------------------------------------------


def test_pick_axes_matches_jax_over_a_grid():
    for n in (1, 2, 3, 4, 6, 8):
        for batch in (1, 2, 3, 4, 5, 8, 13, 16, 64):
            for k in (1, 2, 3, 4, 6, 8, 10, 12):
                assert tm.pick_axes(n, batch, k) == jm.pick_axes(n, batch, k)
    assert tm.pick_axes(8, 64, 8) == (8, 1)
    assert tm.pick_axes(8, 1, 8) == (1, 8)
    assert tm.pick_axes(8, 2, 8) == (2, 4)


def test_bucket_batch_matches_jax():
    for batch in range(1, 40):
        for stripe in (1, 2, 3, 4, 8):
            assert tm._bucket_batch(batch, stripe) == jm._bucket_batch(batch, stripe)


@pytest.mark.parametrize("rows", [2, 5, 8])
def test_pad_batch_matches_jax(rows):
    a = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    got, want = tm._pad_batch(a, rows), jm._pad_batch(a, rows)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got is a) == (rows == 2)


# -- the rules table, the registry, the lowerings -----------------------------

PLANES = (
    "stripe_words", "stripe_bytes", "stripe_batch", "data_batch",
    "data_words", "data_bytes", "survivor_words", "survivor_bytes",
    "data_digests", "parity_words", "parity_bytes", "parity_plane",
    "parity_digests", "recon_words", "quorum_words", "quorum_digests",
    "ok_mask", "digest_rows", "digest_out", "seq_bytes", "seq_parity",
)


@pytest.mark.parametrize("plane", PLANES)
def test_spec_for_matches_jax(plane):
    assert tr.spec_for(plane) == tuple(jr.spec_for(plane))


def test_rules_table_fingerprint_and_trees_match_jax():
    assert [p for p, _ in tr.PARTITION_RULES] == [p for p, _ in jr.PARTITION_RULES]
    assert tr.rules_fingerprint() == jr.rules_fingerprint()
    # content hash, not table identity
    assert tr.rules_fingerprint(tuple(tr.PARTITION_RULES)) == tr.rules_fingerprint()
    other = ((r"^x$", (None,)),)
    assert tr.rules_fingerprint(other) != tr.rules_fingerprint()
    assert tr.rules_fingerprint(other) == jr.rules_fingerprint(
        ((r"^x$", jr.PartitionSpec(None)),))
    names = ("stripe_words", ("parity_words", "data_digests"))
    want = jr.match_partition_rules(names)
    got = tr.match_partition_rules(names)
    assert got[0] == tuple(want[0])
    assert [tuple(s) for s in want[1]] == list(got[1])
    for lib in (tr, jr):
        with pytest.raises(KeyError):
            lib.spec_for("mystery_plane")


def test_registry_matches_jax():
    assert tr.registered_kernels() == jr.registered_kernels()
    for kind in tr.registered_kernels():
        t, j = tr.kernel_def(kind), jr.kernel_def(kind)
        assert t.in_names == j.in_names and t.out_names == j.out_names
        assert t.donate_argnums == j.donate_argnums
        assert (t.build_local is None) == (j.build_local is None)
        assert (t.build_global is None) == (j.build_global is None)
        assert t.in_specs() == tuple(tuple(s) for s in j.in_specs())
        assert t.out_specs() == tuple(tuple(s) for s in j.out_specs())
    with pytest.raises(ValueError):
        tr.register_kernel("nothing", in_names=(), out_names=())


def _raw_meshes(stripe, shard):
    """Fresh mesh objects each call, so the plan cache's key, not object
    identity, is what's under test."""
    devs = np.asarray(jax.devices()[: stripe * shard]).reshape(stripe, shard)
    return (tm.make_mesh(_slots(stripe * shard), stripe, shard),
            JaxMesh(devs, ("stripe", "shard")))


@pytest.mark.parametrize("stripe,shard", [(8, 1), (4, 2), (2, 4), (1, 8),
                                          (2, 2), (1, 1), (3, 2)])
def test_kernel_mode_matches_jax(stripe, shard):
    tmesh, jmesh = _raw_meshes(stripe, shard)
    for kind in tr.registered_kernels():
        got = tr.kernel_mode(kind, tmesh)
        assert got == MODE_NAMES[jr.kernel_mode(kind, jmesh)], kind
    want = "local" if shard > 1 else "global"
    assert tr.kernel_mode("mesh_encode_hash", tmesh) == want
    assert tr.kernel_mode("mesh_digest", tmesh) == "global"


def test_plan_cache_hits_across_a_rebuilt_mesh():
    m1, _ = _raw_meshes(4, 2)
    m2, _ = _raw_meshes(4, 2)
    assert m1 is not m2
    fn1 = tr.compile_kernel("sharded_encode", m1, k=8, m=4)
    before = tr.cache_info()
    fn2 = tr.compile_kernel("sharded_encode", m2, k=8, m=4)
    after = tr.cache_info()
    assert fn1 is fn2
    assert after["misses"] == before["misses"]
    assert after["hits"] == before["hits"] + 1
    assert tr.mesh_cache_key(m1) == tr.mesh_cache_key(m2)


def test_plan_cache_misses_on_a_new_geometry():
    tr.clear_compile_cache()
    assert tr.cache_info() == {"entries": 0, "hits": 0, "misses": 0}
    tr.compile_kernel("sharded_encode", _raw_meshes(4, 2)[0], k=8, m=4)
    before = tr.cache_info()
    tr.compile_kernel("sharded_encode", _raw_meshes(2, 4)[0], k=8, m=4)
    tr.compile_kernel("sharded_encode", _raw_meshes(4, 2)[0], k=8, m=2)
    tr.compile_kernel("sharded_encode", _raw_meshes(4, 2)[0], k=8, m=4,
                      force_mode="local")
    assert tr.cache_info()["misses"] == before["misses"] + 3
    # another slot's device is another key: cuda:0 vs the CPU
    other = tm.make_mesh(("cpu",) * 7 + ("cuda:0",), 4, 2)
    assert tr.mesh_cache_key(other) != tr.mesh_cache_key(_raw_meshes(4, 2)[0])
    with pytest.raises(ValueError):
        tr.compile_kernel("sharded_encode", _raw_meshes(4, 2)[0], k=8, m=4,
                          force_mode="jit")


def _kind_runs(tmesh, force, rng):
    """The kinds with both builders through one lowering: host results."""
    data = rng.integers(0, 256, (8, K, 4 * W), dtype=np.uint8)
    words = _words(rng, (8, K, W))
    parity = np.stack([gf.encode_ref(x.view(np.uint8), M).view(np.uint32)
                       for x in words])
    idx = tuple(range(2, 10))
    surv = np.ascontiguousarray(np.concatenate([words, parity], axis=1)[:, idx])

    def run(kind, plane, array, **statics):
        fn = tr.compile_kernel(kind, tmesh, force_mode=force, **statics)
        out = fn(tm.put_sharded(tmesh, array, tr.spec_for(plane)))
        return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]

    return {
        "sharded_encode": run("sharded_encode", "stripe_bytes", data, k=K, m=M),
        "mesh_encode_hash": run("mesh_encode_hash", "stripe_words", words,
                                k=K, m=M, shard_len=4 * W),
        "mesh_reconstruct": run("mesh_reconstruct", "survivor_words", surv,
                                k=K, m=M, idx=idx),
    }, data, words


@pytest.mark.parametrize("stripe,shard", [(4, 2), (2, 4), (8, 1)])
def test_both_lowerings_give_the_same_bits(stripe, shard):
    """Each kind with both builders runs forced ``local`` and forced
    ``global`` on every geometry (a global body on a shard axis > 1
    gathers each stripe group's rows onto its first slot, and splits a
    shard-laid output back); the outputs are equal, and equal to the JAX
    package's."""
    tmesh, jmesh = _meshes(stripe, shard)
    loc, data, words = _kind_runs(tmesh, "local", np.random.default_rng(9))
    glo, _d, _w = _kind_runs(tmesh, "global", np.random.default_rng(9))
    for kind, outs in loc.items():
        assert len(outs) == len(glo[kind])
        assert all(np.array_equal(a, b) for a, b in zip(outs, glo[kind])), kind
    jfn = jr.compile_kernel("mesh_encode_hash", jmesh, k=K, m=M, shard_len=4 * W)
    jouts = jfn(jm.put_sharded(jmesh, words, jr.spec_for("stripe_words")))
    assert all(np.array_equal(np.asarray(a), b)
               for a, b in zip(jouts, glo["mesh_encode_hash"]))
    assert np.array_equal(glo["sharded_encode"][0],
                          np.stack([gf.encode_ref(x, M) for x in data]))
    assert np.array_equal(glo["mesh_reconstruct"][0], words)


def test_sharded_plane_layout_round_trips():
    """put_sharded then np.asarray is the identity for every rule's
    layout; planes replicated over shard sit on each group's first slot
    only."""
    tmesh, _ = _meshes(2, 4)
    rng = np.random.default_rng(1)
    shapes = {"stripe_words": (4, 8, 16), "parity_words": (4, 4, 16),
              "ok_mask": (4, 12), "digest_rows": (16, 8), "seq_bytes": (4, 64)}
    for plane, shape in shapes.items():
        x = (rng.integers(0, 2, shape).astype(bool) if plane == "ok_mask"
             else _words(rng, shape))
        s = tm.put_sharded(tmesh, x, tr.spec_for(plane))
        back = np.asarray(s)
        assert back.dtype == x.dtype and np.array_equal(back, x), plane
        held = {(i, j) for i, j, _t in s.held()}
        if "shard" in tr._spec_axes(tr.spec_for(plane)):
            assert len(held) == 8
        else:
            assert held == {(0, 0), (1, 0)}
    with pytest.raises(ValueError):
        tm.put_sharded(tmesh, _words(rng, (3, 8, 16)), tr.spec_for("stripe_words"))


# -- the backend over several slots ------------------------------------------


@pytest.fixture
def _fresh(monkeypatch):
    monkeypatch.delenv("MINIO_MESH", raising=False)
    monkeypatch.delenv("MINIO_TPU_CODEC_OVERLAP", raising=False)
    monkeypatch.delenv("MINIO_TPU_CODEC_KERNEL", raising=False)
    KERNEL_STATS.reset()
    JAX_STATS.reset()
    yield
    tbackend.reset_backend()


def test_backend_runs_the_mesh_path_as_jax(_fresh):
    tb, jb = tbackend.TorchBackend(devices=_slots(8)), jbackend.TpuBackend()
    assert tb.device == torch.device("cpu")
    rng = np.random.default_rng(11)
    L = 256
    for B in (1, 3, 16):
        data = rng.integers(0, 256, (B, K, L), dtype=np.uint8)
        parity, digests = tb.encode(data, M)
        jparity, jdigests = jb.encode(data, M)
        assert np.array_equal(parity, jparity)
        assert np.array_equal(digests, jdigests)
        dd, ref = tb.encode_digest_end(tb.encode_digest_begin(data, M))
        assert np.array_equal(dd, digests) and np.array_equal(ref.drain(), parity)
        shards = np.concatenate([data, parity], axis=1)
        present = (False,) * M + (True,) * K
        assert np.array_equal(tb.reconstruct(shards, present, K, M), data)
        jb.reconstruct(shards, present, K, M)
        assert np.array_equal(tb.digest(shards), jb.digest(shards))
        bad = shards.copy()
        bad[0, 1, 0] ^= 0xFF
        got, ok = tb.reconstruct_and_verify(bad, digests, (True,) * 12, K, M)
        jgot, jok = jb.reconstruct_and_verify(bad, digests, (True,) * 12, K, M)
        assert np.array_equal(got, data) and np.array_equal(got, jgot)
        assert np.array_equal(ok, jok) and not ok[0, 1]
        jb.encode_digest_end(jb.encode_digest_begin(data, M))
    assert tb._meshes, "TorchBackend never built a mesh on 8 slots"
    passes = KERNEL_STATS.snapshot()["device_passes"]
    assert passes == JAX_STATS.snapshot()["device_passes"]
    assert set(passes) == {"mesh_encode_hash", "mesh_reconstruct",
                           "mesh_digest", "mesh_verify_reconstruct"}


def test_mesh_zero_forces_one_slot(_fresh, monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    tb = tbackend.TorchBackend(devices=_slots(4))
    data = np.random.default_rng(2).integers(0, 256, (3, K, 128), dtype=np.uint8)
    parity, _ = tb.encode(data, M)
    assert np.array_equal(parity, np.stack([gf.encode_ref(d, M) for d in data]))
    assert not tb._meshes
    assert set(KERNEL_STATS.snapshot()["device_passes"]) == {"encode_words_fused1"}


def test_one_slot_backend_has_no_mesh_and_no_router(_fresh):
    be = tbackend.get_backend("cpu")
    assert be.placement_router() is None
    inner = tbackend.TorchBackend("cpu")
    assert inner._base_devices() == (torch.device("cpu"),)
    assert tbackend.TorchBackend(devices=_slots(1)).placement_router() is None
    assert tbackend.TorchBackend(devices=_slots(4)).placement_router() is not None
    with pytest.raises(ValueError):
        tbackend.TorchBackend(devices=())


def test_cuda_slots_need_a_card():
    if torch.cuda.is_available():
        assert tbackend.TorchBackend(devices=("cuda:0",) * 2).placement_router()
        return
    with pytest.raises(RuntimeError):
        tbackend.TorchBackend(devices=("cuda:0",) * 2)
    with pytest.raises(ValueError):
        tbackend.TorchBackend(devices=("cpu", "cuda:0"))
    with pytest.raises(RuntimeError):
        tm.make_mesh()  # no CUDA device visible: no CPU default


def test_get_backend_on_the_card_takes_every_visible_gpu(_fresh, monkeypatch):
    """The card's backend holds every visible GPU, the asked one first
    (TpuBackend takes jax.devices()); the CPU's keeps one slot."""
    made = []
    real = tbackend.TorchBackend

    def fake(device="cuda", devices=None):
        made.append((torch.device(device), devices))
        return real("cpu")

    monkeypatch.setattr(tbackend, "TorchBackend", fake)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    tbackend.get_backend("cuda")
    tbackend.get_backend("cuda:1")
    tbackend.get_backend("cpu")
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert made == [
        (cuda[0], (cuda[0], cuda[1], cuda[2])),
        (cuda[1], (cuda[1], cuda[0], cuda[2])),
        (torch.device("cpu"), None),
    ]
