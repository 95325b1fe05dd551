"""The port's tiered read cache units (minio_tpu_torch.cache) held against
minio_tpu.cache, on the CPU.

* ``FrequencySketch`` and ``AdmissionFilter`` are pure Python over
  blake2b: for the same key sequences the port's counters, estimates,
  ages and stats equal the JAX package's bit for bit.
* ``DeviceBudget``: headroom under the parity plane's and the codec
  staging's accounts, the capacity knob, and the port's backend posting
  its staging bytes to the ledger the read cache reads.
* ``TieredReadCache`` in ``host`` and ``device`` modes (the port's device
  tier on ``cpu`` tensors, the JAX package's on its CPU device): the same
  put / lookup / evict / demote / invalidate / clear / rot sequences give
  equal ``stats()`` after every step and equal rows, with real digest
  words and each package's own backend verifying.
* Pins under concurrent put / lookup keep both tiers bounded.
* ``device`` mode never puts a group on the host tier when the copy onto
  the device fails: the put raises (the JAX package falls back there).
* The module singleton: knobs, reset, broadcast, seed, clear, stats.
"""

from __future__ import annotations

import random
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from minio_tpu import cache as jcache
from minio_tpu.cache import admission as jadm, allocator as jalloc, tiered as jtiered
from minio_tpu.codec import backend as jbackend
from minio_tpu_torch import cache as tcache
from minio_tpu_torch.cache import admission as tadm, allocator as talloc, tiered as ttiered
from minio_tpu_torch.codec import backend as tbackend
from tests.test_torch_threads import torch_threads  # noqa: F401

SEEDS = [0, 1, 2, 3, 4, 5]
_CACHE_ENV = ("MINIO_TPU_READ_CACHE", "MINIO_TPU_READ_CACHE_MB",
              "MINIO_TPU_READ_CACHE_DEVICE_MB", "MINIO_TPU_DEVICE_BUDGET_MB")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    for name in _CACHE_ENV:
        monkeypatch.delenv(name, raising=False)
    for mod in (jcache, tcache):
        mod.reset_read_cache()
        mod.reset_device_budget()
        mod.set_broadcast(None)
    yield
    for mod in (jcache, tcache):
        mod.reset_read_cache()
        mod.reset_device_budget()
        mod.set_broadcast(None)


def _keys(seed: int, n: int = 400) -> list:
    rng = random.Random(seed)
    pool = [f"bucket/obj{i}" for i in range(rng.randint(8, 64))]
    return [rng.choice(pool) for _ in range(n)]


# -- admission -------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_sketch_bit_equal(seed):
    rng = random.Random(seed)
    width = rng.choice([16, 64, 256])
    sf = rng.choice([1, 2, 8])
    j = jadm.FrequencySketch(width=width, depth=4, sample_factor=sf)
    t = tadm.FrequencySketch(width=width, depth=4, sample_factor=sf)
    for key in _keys(seed):
        hits = rng.choice([1, 1, 1, 2, 5])
        assert t.touch(key, hits) == j.touch(key, hits)
        assert t.estimate(key) == j.estimate(key)
        assert t._indexes(key) == j._indexes(key)
    assert [bytes(r) for r in t._rows] == [bytes(r) for r in j._rows]
    assert (t.ages, t._ops) == (j.ages, j._ops)
    assert t.ages >= 1  # the sequence reached the halving decay


@pytest.mark.parametrize("seed", SEEDS)
def test_admission_filter_bit_equal(seed):
    rng = random.Random(seed + 100)
    j = jadm.AdmissionFilter(jadm.FrequencySketch(width=64, sample_factor=2))
    t = tadm.AdmissionFilter(tadm.FrequencySketch(width=64, sample_factor=2))
    keys = _keys(seed)
    for key in keys:
        op = rng.random()
        if op < 0.5:
            j.record(key), t.record(key)
        elif op < 0.6:
            hits = rng.randint(1, 4)
            j.seed(key, hits), t.seed(key, hits)
        else:
            victim = rng.choice(keys + [None])
            assert t.contest(key, victim) == j.contest(key, victim)
        assert t.estimate(key) == j.estimate(key)
        assert t.stats() == j.stats()
    st = t.stats()
    assert st["admitted"] and st["rejected"] and st["sketch_ages"]


def test_sketch_rejects_non_power_of_two_width():
    for mod in (jadm, tadm):
        with pytest.raises(ValueError, match="power of two"):
            mod.FrequencySketch(width=100)


# -- device budget ---------------------------------------------------------


def test_device_budget_ledger_matches():
    seq = [("parity_plane", 60), ("read_cache", 25), ("codec_staging", 10),
           ("parity_plane", 0), ("codec_staging", 200), ("codec_staging", -1)]
    j, t = jalloc.DeviceBudget(100), talloc.DeviceBudget(100)
    assert t.headroom() == 100
    for account, nbytes in seq:
        j.set_usage(account, nbytes)
        t.set_usage(account, nbytes)
        assert t.snapshot() == j.snapshot()
        assert (t.headroom(), t.usage(), t.usage(account)) == (
            j.headroom(), j.usage(), j.usage(account))


@pytest.mark.parametrize("value,mb", [(None, 192), ("7", 7), ("0", 1),
                                      ("bogus", 192)])
def test_device_budget_capacity_knob(monkeypatch, value, mb):
    if value is not None:
        monkeypatch.setenv("MINIO_TPU_DEVICE_BUDGET_MB", value)
    for mod in (jalloc, talloc):
        mod.reset_device_budget()
    assert talloc.device_budget().capacity_bytes == mb << 20
    assert talloc.device_budget().snapshot() == jalloc.device_budget().snapshot()
    assert talloc.device_budget() is talloc.device_budget()


def _group(seed=0, g=2, k=3, n=64):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (g, k, n), dtype=np.uint8)
    return data, _digest(data)


def _digest(data):
    return tbackend.get_backend("cpu").inner.digest(data)


def _key(obj, first_block=0, g=2, n=64, data_dir="dd0"):
    return ("bucket", obj, data_dir, 1, first_block, g, n)


@pytest.mark.parametrize("account", ["parity_plane", "codec_staging"])
def test_device_tier_yields_to_the_other_accounts(account):
    """With another account holding the budget, device admissions land on
    the host tier (the cache yields; the account is never a victim); once
    it drains the device tier reopens and reports its usage."""
    data, digests = _group()
    per_entry = data.nbytes + digests.nbytes
    caches = {}
    for name, alloc, tiered, kw in (
        ("jax", jalloc, jtiered, {}), ("port", talloc, ttiered, {"device": "cpu"}),
    ):
        budget = alloc.DeviceBudget(per_entry * 2)
        budget.set_usage(account, per_entry * 2)
        c = tiered.TieredReadCache("device", host_capacity=1 << 20,
                                   device_capacity=1 << 20, budget=budget, **kw)
        assert c.put(_key("o"), "bucket/o", data, digests)
        assert budget.usage(account) == per_entry * 2
        budget.set_usage(account, 0)
        assert c.put(_key("o2"), "bucket/o2", data, digests)
        assert budget.usage("read_cache") == per_entry
        caches[name] = c
    st = caches["port"].stats()
    assert st == caches["jax"].stats()
    assert (st["tiers"]["host"]["entries"], st["tiers"]["device"]["entries"]) == (1, 1)


def test_port_backend_staging_posts_to_the_cache_ledger(monkeypatch):
    """The port's codec staging reserve/release posts ``codec_staging`` to
    the one ledger the read cache's device tier sizes itself against."""
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "device")
    monkeypatch.setenv("MINIO_TPU_DEVICE_BUDGET_MB", "1")
    tcache.reset_device_budget()
    c = tcache.read_cache("cpu")
    data, digests = _group(n=1024)
    held = tbackend._stage_reserve(1 << 20)
    try:
        assert talloc.device_budget().usage("codec_staging") >= 1 << 20
        assert talloc.device_budget().headroom() == 0
        assert c.put(_key("o", n=1024), "bucket/o", data, digests)
        assert c.stats()["tiers"]["host"]["entries"] == 1
    finally:
        tbackend._stage_release(held)
    assert c.put(_key("o2", n=1024), "bucket/o2", data, digests)
    assert c.stats()["tiers"]["device"]["entries"] == 1
    assert talloc.device_budget().usage("read_cache") == data.nbytes + digests.nbytes


# -- tier mechanics against the JAX package ---------------------------------


class _Pair:
    """One JAX and one port TieredReadCache driven through one sequence."""

    def __init__(self, mode, host_cap, dev_cap, budget_cap=1 << 30):
        self.jb = jalloc.DeviceBudget(budget_cap)
        self.tb = talloc.DeviceBudget(budget_cap)
        dev = mode == "device"
        self.j = jtiered.TieredReadCache(mode, host_cap, dev_cap,
                                         budget=self.jb if dev else None)
        self.t = ttiered.TieredReadCache(mode, host_cap, dev_cap,
                                         budget=self.tb if dev else None,
                                         device="cpu")
        self.jbe = jbackend.get_backend("cpu")
        self.tbe = tbackend.get_backend("cpu")

    def check(self):
        st = self.t.stats()
        assert st == self.j.stats()
        # the port posts its device bytes after every change (the JAX
        # package skips a rejected replacement and a verify drop, which
        # leaves its ledger stale until the next admit)
        assert self.tb.usage("read_cache") == st["tiers"]["device"]["occupancy_bytes"]

    def rot(self, key) -> bool:
        """Flip one byte of the group in both caches; False if absent."""
        found = 0
        for c, put in ((self.j, jax.device_put), (self.t, None)):
            for tier in ttiered.TIERS:
                ent = c._tiers[tier].get(key)
                if ent is None:
                    continue
                found += 1
                if isinstance(ent.data, torch.Tensor):
                    ent.data[0, 0, 5] ^= 0xFF  # rot in place on the device
                else:
                    bad = np.array(ent.data, copy=True)
                    bad[0, 0, 5] ^= 0xFF
                    ent.data = put(bad) if tier == "device" and put else bad
        assert found in (0, 2)
        return bool(found)


def _run_sequence(p: _Pair, seed: int, steps: int = 120) -> dict:
    rng = random.Random(seed)
    objs = [f"o{i}" for i in range(7)]
    groups = {o: _group(seed * 31 + i) for i, o in enumerate(objs)}
    seen = {"hit": 0, "miss": 0, "rot": 0, "admitted": 0, "rejected": 0}
    for _ in range(steps):
        o = rng.choice(objs)
        fb = rng.choice([0, 4])
        key, heat = _key(o, fb), f"bucket/{o}"
        op = rng.random()
        if op < 0.35:
            data, digests = groups[o]
            src = rng.choice(["put", "get"])
            got = p.t.put(key, heat, data, digests, source=src)
            assert got == p.j.put(key, heat, data, digests, source=src)
            seen["admitted" if got else "rejected"] += 1
        elif op < 0.75:
            got = p.t.lookup(p.tbe, key, heat)
            want = p.j.lookup(p.jbe, key, heat)
            assert (got is None) == (want is None)
            if got is not None:
                assert np.array_equal(got, np.asarray(want))
                assert np.array_equal(got, groups[o][0])
            seen["miss" if got is None else "hit"] += 1
        elif op < 0.85:
            for _ in range(rng.randint(1, 6)):
                p.j.admission.record(heat), p.t.admission.record(heat)
        elif op < 0.92:
            seen["rot"] += p.rot(key)
        elif op < 0.98:
            assert p.t.invalidate("bucket", o) == p.j.invalidate("bucket", o)
        else:
            assert p.t.clear() == p.j.clear()
        p.check()
    return seen


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["host", "device"])
def test_tier_sequence_matches_reference(mode, seed):
    data, digests = _group()
    assert np.array_equal(digests, jbackend.get_backend("cpu").digest(data))
    per_entry = data.nbytes + digests.nbytes
    p = _Pair(mode, host_cap=4 * per_entry, dev_cap=3 * per_entry)
    seen = _run_sequence(p, seed)
    st = p.t.stats()
    assert seen["hit"] and seen["miss"] and seen["admitted"]
    assert st["tiers"]["host"]["evictions"] + st["tiers"]["host"]["rejects"] > 0
    if mode == "device":
        assert st["tiers"]["device"]["evictions"] > 0


def test_device_eviction_demotes_to_host():
    data, digests = _group()
    per_entry = data.nbytes + digests.nbytes
    p = _Pair("device", host_cap=1 << 20, dev_cap=per_entry)
    for c in (p.j, p.t):
        c.admission.record("bucket/o0")
        for _ in range(8):  # strict >: the newcomer must be hotter to evict
            c.admission.record("bucket/o1")
        assert c.put(_key("o0"), "bucket/o0", data, digests)
        assert c.put(_key("o1"), "bucket/o1", data, digests)
    p.check()
    st = p.t.stats()
    assert st["demotions"] == 1
    assert st["tiers"]["device"]["entries"] == st["tiers"]["host"]["entries"] == 1
    # the demoted group lies on the host as numpy and still serves
    assert isinstance(p.t._tiers["host"][_key("o0")].data, np.ndarray)
    assert isinstance(p.t._tiers["device"][_key("o1")].data, torch.Tensor)
    out = p.t.lookup(p.tbe, _key("o0"), "bucket/o0")
    assert np.array_equal(out, data)
    assert np.array_equal(p.j.lookup(p.jbe, _key("o0"), "bucket/o0"), data)
    p.check()


@pytest.mark.parametrize("mode", ["host", "device"])
def test_rot_is_dropped_counted_and_missed(mode):
    data, digests = _group(3)
    p = _Pair(mode, host_cap=1 << 20, dev_cap=1 << 20)
    for c in (p.j, p.t):
        assert c.put(_key("o"), "bucket/o", data, digests)
    assert p.rot(_key("o"))
    assert p.t.lookup(p.tbe, _key("o"), "bucket/o") is None
    assert p.j.lookup(p.jbe, _key("o"), "bucket/o") is None
    p.check()
    st = p.t.stats()
    assert st["verify_drops"] == 1 and st["tiers"][mode]["entries"] == 0
    # a later lookup is a plain miss, not another drop
    assert p.t.lookup(p.tbe, _key("o"), "bucket/o") is None
    assert p.t.stats()["verify_drops"] == 1
    if mode == "device":
        assert p.tb.usage("read_cache") == 0


def test_meta_sidecar_matches():
    p = _Pair("host", 1 << 20, 0)
    for c in (p.j, p.t):
        p.t._meta_cap = p.j._meta_cap = 3
        fi = {"size": 1, "parts": [1, 2]}
        c.meta_store("bucket", "a", fi)
        fi["parts"].append(3)  # the store deep-copied it
        assert c.meta_lookup("bucket", "a") == {"size": 1, "parts": [1, 2]}
        for name in "bcd":
            c.meta_store("bucket", name, {"size": 2})
        assert c.meta_lookup("bucket", "a") is None  # LRU by count
        assert c.invalidate("bucket", "d") == 0
        assert c.meta_lookup("bucket", "d") is None
    assert p.t._meta == p.j._meta
    assert ttiered.TieredReadCache("host", 1, 0)._meta_cap == 4096


@pytest.mark.parametrize("mode", ["host", "device"])
def test_concurrent_put_lookup_stays_bounded(mode):
    data, digests = _group(g=1, k=2, n=256)
    per_entry = data.nbytes + digests.nbytes
    cap = 8 * per_entry
    budget = talloc.DeviceBudget(1 << 30)
    c = ttiered.TieredReadCache(mode, host_capacity=cap, device_capacity=cap // 2,
                                budget=budget, device="cpu")
    be = tbackend.get_backend("cpu")
    errors = []

    def worker(tid):
        try:
            for i in range(40):
                name = f"o{tid}-{i % 12}"
                c.put(_key(name, g=1, n=256), f"bucket/{name}", data, digests)
                out = c.lookup(be, _key(name, g=1, n=256), f"bucket/{name}")
                if out is not None and not np.array_equal(out, data):
                    errors.append(AssertionError("served wrong rows"))
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    st = c.stats()["tiers"]
    for tier in ttiered.TIERS:
        assert st[tier]["occupancy_bytes"] <= st[tier]["capacity_bytes"]
        assert st[tier]["entries"] * per_entry == st[tier]["occupancy_bytes"]
        assert all(e.pins == 0 for e in c._tiers[tier].values())
    if mode == "device":
        assert budget.usage("read_cache") == st["device"]["occupancy_bytes"]


def test_device_entries_are_the_cache_tensors_unverified():
    data, digests = _group(4)
    p = _Pair("device", 1 << 20, 1 << 20)
    for c in (p.j, p.t):
        assert c.put(_key("o"), "bucket/o", data, digests)
        assert c.put(_key("o", 4), "bucket/o", data, digests)
    got, want = p.t.device_entries("bucket", "o"), p.j.device_entries("bucket", "o")
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t is p.t._tiers["device"][key].data
        assert np.array_equal(t.numpy(), np.asarray(want[key]))
    p.check()
    assert p.t.stats()["tiers"]["device"]["hits"] == 2
    assert p.t.device_entries("bucket", "absent") == {}


# -- no fallback that hides the device ---------------------------------------


def test_device_copy_failure_raises_not_host():
    """``device`` mode on a device that cannot take the copy (a card
    ordinal no host has) raises; nothing lands on the host tier."""
    data, digests = _group()
    c = ttiered.TieredReadCache("device", 1 << 20, 1 << 20,
                                budget=talloc.DeviceBudget(1 << 30),
                                device="cuda:99")
    with pytest.raises((RuntimeError, AssertionError)):
        c.put(_key("o"), "bucket/o", data, digests)
    st = c.stats()["tiers"]
    assert st["host"]["entries"] == st["device"]["entries"] == 0
    # the JAX package, by contrast, keeps the group on its host tier when
    # its device copy fails
    j = jtiered.TieredReadCache("device", 1 << 20, 1 << 20,
                                budget=jalloc.DeviceBudget(1 << 30))
    orig = jtiered._to_device
    jtiered._to_device = lambda arr: None
    try:
        assert j.put(_key("o"), "bucket/o", data, digests)
    finally:
        jtiered._to_device = orig
    assert j.stats()["tiers"]["host"]["entries"] == 1


def test_auto_resolves_to_host_without_a_card(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcache.cache_mode() == "host"
    c = tcache.read_cache()
    assert c.mode == "host" and c.stats()["tiers"]["device"]["capacity_bytes"] == 0


# -- the module singleton ----------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "host", "device"])
@pytest.mark.parametrize("host_mb,dev_mb", [(None, None), ("3", "5"), ("0", "x")])
def test_singleton_knobs_match(monkeypatch, mode, host_mb, dev_mb):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", mode)
    for name, v in (("MINIO_TPU_READ_CACHE_MB", host_mb),
                    ("MINIO_TPU_READ_CACHE_DEVICE_MB", dev_mb)):
        if v is not None:
            monkeypatch.setenv(name, v)
    t, j = tcache.read_cache("cpu"), jcache.read_cache()
    assert (t is None) == (j is None) == (mode == "off")
    assert tcache.read_cache_stats() == jcache.read_cache_stats()
    if t is not None:
        assert t is tcache.read_cache() and t.device == torch.device("cpu")
        assert t._budget is (talloc.device_budget() if mode == "device" else None)
        assert tcache.context_for("b", "o", "dd", 2).heat_key == "b/o"
    else:
        assert tcache.context_for("b", "o", "dd", 2) is None
    tcache.reset_read_cache()
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "off")
    assert tcache.read_cache() is None


def test_invalidate_broadcasts_once_and_local_never(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_READ_CACHE", "host")
    data, digests = _group()
    got = {}
    for name, mod in (("jax", jcache), ("port", tcache)):
        calls = []
        mod.set_broadcast(lambda b, o: calls.append((b, o)))
        c = mod.read_cache()
        c.put(_key("o"), "bucket/o", data, digests)
        dropped = [mod.invalidate_object("bucket", "o")]
        c.put(_key("o"), "bucket/o", data, digests)
        dropped.append(mod.invalidate_local("bucket", "o"))
        mod.set_broadcast(lambda b, o: 1 / 0)  # a failing fan-out is logged
        c.put(_key("o"), "bucket/o", data, digests)
        dropped.append(mod.invalidate_object("bucket", "o"))
        c.put(_key("a"), "bucket/a", data, digests)
        c.put(_key("b"), "bucket/b", data, digests)
        mod.seed_heat("bucket", "crawled", hits=4)
        dropped.append(mod.clear_read_cache())
        got[name] = (dropped, calls, mod.read_cache_stats())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [1, 1, 1, 2]
    assert got["port"][1] == [("bucket", "o")]
    assert got["port"][2]["admission"]["seeded"] == 1


def test_off_functions_are_inert():
    assert tcache.read_cache() is None
    assert tcache.invalidate_object("b", "o") == 0
    assert tcache.clear_read_cache() == 0
    tcache.seed_heat("b", "o")
    assert tcache.read_cache_stats() == jcache.read_cache_stats()
    assert tcache.read_cache_stats()["mode"] == "off"
    assert tcache.TIERS == jcache.TIERS
