"""The Hopper design of K12 group_flags and K13 pack_nonzero_groups,
emulated on the CPU.

The kernels cannot run here, so these tests hold their decomposition
against the plain versions and the JAX package without a card:

* K12's runs (``kernels.group_plan``): warp v of a grid of groups / (8 *
  run) blocks walks groups v * run .. v * run + run - 1 in batches of
  ``kFlagsBatch``, lane i storing the flag of the run's group i in stores
  of up to 32 flags; every group loaded and every flag stored exactly
  once, the plan's run one batch within four waves.
* K13's cluster and segment split (``kernels.pack_plan``, ``pack_split``):
  16 blocks a row where the rows fit the card at 16, else 8, and the
  fewest passes at which the card holds every row's cluster at once (an
  H100's residency modelled from its measured cluster counts); every
  group of a row in exactly one block's segment of one pass, no segment
  past ``PACK_SEG_MAX`` groups, which fit a block's shared memory.
* K13's slot assignment as the kernel computes it - flags from the
  staged segment, a ballot prefix a warp, the block counts met through
  the cluster, a running prefix over passes, the zero tail in cluster
  shares - with every slot of the packed row written exactly once, equal
  to ``pack_nonzero_groups_plain`` on random flags and to the JAX
  package's ``codec_step`` at the shapes on the split's edges.
* The packed argument struct and the constants against codec.cu, the
  plans made once per shape, the wrapper's checks and its CPU path.

Everything is integer arithmetic: the tolerance is zero.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import codec_step as jcs
from minio_tpu_torch.ops import kernels
from tests.test_torch_threads import torch_threads  # noqa: F401

G = kernels.TILE  # 256 words a group
SRC = (Path(kernels.__file__).parent.parent / "csrc" / "codec.cu").read_text()
CONSTS = {k: int(v) for k, v in re.findall(
    r"constexpr int (k(?:Flag|Pack)\w+) = (\d+);", SRC)}
WARPS = G // 32  # warps a block (kThreads / 32)
SMEM_MAX = 232448  # bytes of shared memory an H100 block can use


def _plane(kind: str, rows: int, g: int, seed: int) -> np.ndarray:
    """(rows, g * 256) u32 words: random; random on a third of the groups;
    all zero; no zero word; one nonzero word in each row's first or last
    group."""
    rng = np.random.default_rng(seed)
    w = g * G
    if kind in ("zeros", "first", "last"):
        words = np.zeros((rows, w), np.uint32)
        if kind != "zeros":
            base = 0 if kind == "first" else w - G
            at = base + rng.integers(0, G, rows)
            words[np.arange(rows), at] = rng.integers(1, 2**32, rows, dtype=np.uint32)
        return words
    words = rng.integers(0, 2**32, (rows, w), dtype=np.uint32)
    if kind == "full":
        words |= np.uint32(1)
    elif kind == "sparse":
        keep = rng.random((rows, g)) < 1 / 3
        words *= np.repeat(keep, G, axis=-1).astype(np.uint32)
    return words


# ---------------------------------------------------------------------------
# K12: the runs of the persistent grid
# ---------------------------------------------------------------------------


def _k12_stores(groups: int, run: int) -> "list[tuple[int, int, int]]":
    """group_flags_kernel's index arithmetic over a flattened plane of
    ``groups`` groups: (warp, batch, group) for every group a warp loads
    in a batch of its run, in the order of its stores of up to 32 flags -
    the grid, the early return of a warp past the last group, the run
    clipped at the end, the 32-flag chunks and the kFlagsBatch batches."""
    batch = CONSTS["kFlagsBatch"]
    warps = -(-groups // run)
    blocks = -(-warps // WARPS)
    out = []
    for v in range(blocks * WARPS):
        first = v * run
        if first >= groups:
            continue
        n = min(run, groups - first)
        for c in range(0, n, 32):
            cn = min(32, n - c)
            for b in range(0, cn, batch):
                for i in range(batch):
                    if b + i < cn:
                        out.append((v, (c, b), first + c + b + i))
    return out


def _k12_flags(words: np.ndarray, run: int) -> np.ndarray:
    """The flags K12 stores at ``run``: each group's vote written where
    _k12_stores puts it, each flag once."""
    q = words.size // G
    nonzero = (words.reshape(q, G) != 0).any(axis=-1)
    flags = np.full(q, -1, np.int64)
    for _v, _b, at in _k12_stores(q, run):
        assert flags[at] == -1, "a flag stored twice"
        flags[at] = int(nonzero[at])
    return flags.reshape(*words.shape[:-1], -1)


@pytest.mark.parametrize("groups", [1, 7, 8, 9, 255, 1280, 5120, 20480, 20481])
@pytest.mark.parametrize("run", [1, 2, 3, 4, 5, 33, None], ids=lambda r: f"run{r}")
def test_k12_runs_cover_each_group_once(groups, run):
    """Every group of the plane is loaded, voted and its flag stored by
    exactly one lane of one warp, whatever the run, and a batch holds at
    most kFlagsBatch groups; the plan's run (on an H100's 132 SMs) is one
    batch, and below kFlagsBatch keeps the grid within four waves of
    kFlagsBlocksPerSM blocks an SM."""
    plan = kernels.group_plan(groups, 132)
    run = run or plan
    stores = _k12_stores(groups, run)
    assert sorted(q for _v, _b, q in stores) == list(range(groups))
    per_batch = {}
    for v, b, _q in stores:
        per_batch[v, b] = per_batch.get((v, b), 0) + 1
    assert max(per_batch.values()) <= CONSTS["kFlagsBatch"]
    assert plan <= CONSTS["kFlagsBatch"]
    if run == plan < CONSTS["kFlagsBatch"]:
        blocks = -(-(-(-groups // run)) // WARPS)
        assert blocks <= 4 * 132 * CONSTS["kFlagsBlocksPerSM"]


@pytest.mark.parametrize("groups,sms,run", [
    (20480, 132, 2),   # the main path's (4, 4, 327,680): 1,280 blocks
    (5120, 132, 1),    # heal's (1, 4, 327,680): 640 blocks
    (16896, 132, 1), (16897, 132, 2), (1, 132, 1), (20480, 1, 4), (10**7, 132, 4),
])
def test_k12_plan(groups, sms, run):
    assert kernels.group_plan(groups, sms) == run


# ---------------------------------------------------------------------------
# K13: the cluster split and the slot assignment
# ---------------------------------------------------------------------------


def h100(cluster: int, seg: int) -> int:
    """Clusters of ``cluster`` blocks of ``seg`` groups an H100 holds at
    once, as mtt_pack_clusters measured them there: 120 SMs take clusters
    of 8 (15 at 160 KiB), 112 clusters of 16 (14 at 80 KiB), and an SM as
    many blocks as its 227 KiB of shared memory holds (8 at most)."""
    per_sm = min(8, 227 // (seg + 2))
    return (120 if cluster <= 8 else 112) * per_sm // cluster


@pytest.mark.parametrize("rows,sms,resident,plan", [
    (16, 132, h100, (8, 80, 2)),    # the main path's plane: 15 of 16 at 160 KiB
    (4, 132, h100, (16, 80, 1)),    # heal's: 64 SMs, not 32
    (8, 132, h100, (16, 80, 1)),
    (9, 132, h100, (8, 160, 1)),
    (1, 132, h100, (16, 80, 1)),
    (16, 132, lambda c, seg: 99, (8, 160, 1)),
    (4, 132, lambda c, seg: -1, (8, 160, 1)),  # the query failed: waves
    (1, 8, h100, (8, 160, 1)),
])
def test_k13_plan_choice(rows, sms, resident, plan):
    assert kernels.pack_plan(rows, 1280, sms, resident) == plan


@pytest.mark.parametrize("g", [1, 3, 7, 8, 9, 21, 160, 1280, 1536, 1537, 3072, 3077, 9001])
@pytest.mark.parametrize("cluster", [8, 16])
def test_k13_split_covers_each_row_once(g, cluster):
    """pack_split: every group of the row in exactly one block's segment
    of one pass, in order (pass by pass, block by block), each segment at
    most PACK_SEG_MAX groups, which fit a block's shared memory beside its
    static arrays, and the fewest passes that do."""
    seg, passes = kernels.pack_split(g, cluster)
    assert 1 <= seg <= kernels.PACK_SEG_MAX
    assert passes == -(-g // (cluster * kernels.PACK_SEG_MAX))
    seg, passes = kernels.pack_split(g, cluster, passes + 1)  # a split for residency
    assert 1 <= seg <= kernels.PACK_SEG_MAX
    # full[], s_flag[], s_src[], s_wsum[], s_count[]
    seg_max = CONSTS["kPackSegMax"]
    static = 8 * (seg_max // CONSTS["kPackChunk"]) + 8 * seg_max + 4 * WARPS + 8
    assert seg_max * G * 4 + static <= SMEM_MAX
    order = []
    for p in range(passes):
        for r in range(cluster):
            start = p * cluster * seg + r * seg
            order.extend(range(start, min(start + seg, g)))
    assert order == list(range(g))


def test_k13_main_and_heal_plans():
    """On an H100: the main path's 16 rows of 1,280 groups, 8 blocks a row
    and two passes of 80 groups (80 KiB) each; heal's 4 rows, 16 blocks
    of 80 groups in one pass; a row past one cluster's shared memory, two
    passes."""
    assert kernels.pack_plan(16, 1280, 132, h100) == (8, 80, 2)
    assert kernels.pack_plan(4, 1280, 132, h100) == (16, 80, 1)
    assert kernels.pack_plan(1, 3077, 132, h100) == (16, 97, 2)


def _k13_emulated(words: np.ndarray, cluster: int, seg: int):
    """pack_groups_kernel row by row: each block's segment of each pass
    flagged (one vote a group), its nonzero groups numbered by a ballot
    prefix within each warp of 32 groups plus the earlier warps' counts,
    the block's prefix and the pass total from the cluster's counts, the
    groups stored at run + prefix + i; then the zero tail in cluster
    shares.  Every flag and every slot must be written exactly once."""
    rows, w = words.shape
    g = w // G
    grouped = words.reshape(rows, g, G)
    nonzero = grouped.any(axis=-1)
    flags = np.full((rows, g), -1, np.int64)
    packed = np.full((rows, g, G), 0xDEADBEEF, np.uint32)
    writes = np.zeros((rows, g), np.int64)
    span = cluster * seg
    passes = -(-g // span)
    for row in range(rows):
        run = 0
        for p in range(passes):
            counts, lists = [], []
            for rank in range(cluster):
                start = p * span + rank * seg
                n = max(0, min(seg, g - start))
                f = [int(nonzero[row, start + t]) for t in range(n)]
                f += [0] * (WARPS * 32 - n)  # tid >= n votes 0
                wsum = [sum(f[32 * i:32 * i + 32]) for i in range(WARPS)]
                src = {}
                for tid in range(WARPS * 32):
                    warp, lane = divmod(tid, 32)
                    vote = f[32 * warp:32 * warp + 32]
                    pre = sum(vote[:lane]) + sum(wsum[:warp])
                    if f[tid]:
                        assert pre not in src
                        src[pre] = tid
                    if tid < n:
                        assert flags[row, start + tid] == -1, "a flag stored twice"
                        flags[row, start + tid] = f[tid]
                counts.append(sum(wsum))
                lists.append((start, [src[i] for i in range(sum(wsum))]))
            total = sum(counts)
            for rank, (start, src) in enumerate(lists):
                before = sum(counts[:rank])
                for i, tid in enumerate(src):
                    slot = run + before + i
                    packed[row, slot] = grouped[row, start + tid]
                    writes[row, slot] += 1
            run += total
        share = -(-(g - run) // cluster)
        for rank in range(cluster):
            z0 = min(g, run + rank * share)
            z1 = min(g, z0 + share)
            packed[row, z0:z1] = 0
            writes[row, z0:z1] += 1
    assert (flags >= 0).all(), "a flag never stored"
    assert (writes == 1).all(), "a slot written twice or never"
    return flags, packed.reshape(rows, w)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 0.95, 1.0])
@pytest.mark.parametrize("rows,g,cluster,seg", [
    (2, 40, 8, 5), (3, 21, 16, 2), (2, 5, 8, 1), (1, 3, 16, 1),
    (1, 100, 4, 7), (2, 300, 8, 30), (1, 64, 1, 64), (1, 97, 2, 48),
])
def test_k13_slots_equal_plain_on_random_flags(density, rows, g, cluster, seg):
    """The kernel's slot assignment, over several passes where cluster *
    seg < g, equals pack_nonzero_groups_plain on planes whose groups are
    nonzero at random (one random word of each kept group set)."""
    rng = np.random.default_rng(int(density * 100) + rows * g)
    keep = rng.random((rows, g)) < density
    words = np.zeros((rows, g, G), np.uint32)
    at = rng.integers(0, G, (rows, g))
    vals = rng.integers(1, 2**32, (rows, g), dtype=np.uint32) * keep
    np.put_along_axis(words, at[..., None], vals[..., None].astype(np.uint32), axis=-1)
    words = words.reshape(rows, g * G)
    flags, packed = _k13_emulated(words, cluster, seg)
    pflags, ppacked = kernels.pack_nonzero_groups_plain(
        torch.from_numpy(words.view(np.int32)), G)
    assert np.array_equal(flags, pflags.numpy())
    assert np.array_equal(packed, ppacked.numpy().view(np.uint32))


# the split's edges, each against the JAX package: g not a multiple of the
# cluster and g below it, a row past one cluster's shared memory (16 x 192
# and 8 x 192 groups), at the main path's plane and heal's
EDGE_SHAPES = {
    "g21_cluster16": (6, 21),
    "g13_cluster8": (16, 13),
    "g5_below_cluster8": (12, 5),
    "g3_below_cluster16": (1, 3),
    "row_past_cluster16": (1, 3077),
    "row_past_cluster8": (9, 1541),
}


@pytest.mark.parametrize("kind", ["sparse", "zeros", "full", "first", "last"])
@pytest.mark.parametrize("shape", sorted(EDGE_SHAPES))
def test_k13_emulation_equals_jax_on_edges(kind, shape):
    """K13's plan on an H100 and its emulated launch, and K12's, against
    minio_tpu's codec_step.pack_nonzero_groups and group_flags."""
    rows, g = EDGE_SHAPES[shape]
    words = _plane(kind, rows, g, seed=rows + g)
    cluster, seg, passes = kernels.pack_plan(rows, g, 132, h100)
    if shape.startswith("row_past"):
        assert passes == 2 and g > cluster * kernels.PACK_SEG_MAX
    else:
        assert passes == 1
    flags, packed = _k13_emulated(words, cluster, seg)
    jflags, jpacked = jcs.pack_nonzero_groups(jnp.asarray(words), G)
    assert np.array_equal(flags, np.asarray(jflags).astype(np.int64))
    assert np.array_equal(packed, np.asarray(jpacked))
    got = _k12_flags(words, kernels.group_plan(rows * g, 132))
    assert np.array_equal(got, np.asarray(jcs.group_flags(jnp.asarray(words), G)))


# ---------------------------------------------------------------------------
# struct, constants, plans, wrapper
# ---------------------------------------------------------------------------


def test_group_args_match_codec_cu():
    """_GROUP_ARGS packs GroupArgs as codec.cu declares it: words, flags,
    packed, stream; rows; device, w, cluster, seg (56 bytes, no padding),
    and mtt_constants exports its size."""
    body = re.search(r"struct GroupArgs \{(.*?)\};", SRC, re.S).group(1)
    fields = []
    for line in body.strip().splitlines():
        ctype, names = line.strip().rstrip(";").split(None, 1)
        fields.append((ctype, [n.strip() for n in names.split(",")]))
    assert fields == [("uint64_t", ["words", "flags", "packed", "stream"]),
                      ("int64_t", ["rows"]),
                      ("int32_t", ["device", "w", "cluster", "seg"])]
    size = int(re.search(r"static_assert\(sizeof\(GroupArgs\) == (\d+)", SRC).group(1))
    assert kernels._GROUP_ARGS.format == "<4Qq4i" and kernels._GROUP_ARGS.size == size == 56
    assert kernels._constants()["group_args_bytes"] == (56,)
    assert "@ctypes mtt_group_flags(c_char_p) -> c_int" in SRC


def test_constants_match_codec_cu():
    assert CONSTS["kFlagsBatch"] == kernels._FLAGS_BATCH
    assert CONSTS["kFlagsBlocksPerSM"] == kernels._FLAGS_BLOCKS_PER_SM
    assert CONSTS["kPackSegMax"] == kernels.PACK_SEG_MAX
    assert CONSTS["kPackClusterMax"] == kernels._PACK_CLUSTER_MAX == 16
    assert CONSTS["kPackSegMax"] % CONSTS["kPackChunk"] == 0
    assert kernels.PACK_SEG_MAX <= G  # one thread a group in the block scan
    for name in ("group_args_bytes", "pack_seg_max", "pack_cluster_max", "flags_batch",
                 "flags_blocks_per_sm"):
        assert name in kernels._constants() and f"{name}=" in SRC


def test_plan_is_made_once_per_shape(monkeypatch):
    """_pack_plan asks the card for its residency once per (rows, w,
    device), _group_plan its SMs once per (groups, device): later calls
    at that shape take the cached plan."""
    asked = []
    lib = types.SimpleNamespace(
        mtt_pack_clusters=lambda index, c, seg: asked.append((c, seg)) or h100(c, seg))
    monkeypatch.setattr(kernels, "_load", lambda: lib)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    kernels._pack_plan.cache_clear()
    try:
        assert kernels._pack_plan(16, 327680, 0) == (8, 80, 2)
        n = len(asked)
        assert kernels._pack_plan(16, 327680, 0) == (8, 80, 2) and len(asked) == n
        kernels._group_plan.cache_clear()
        counted = []
        monkeypatch.setattr(kernels, "sm_count", lambda dev: counted.append(dev) or 132)
        assert kernels._group_plan(20480, 0) == kernels._group_plan(20480, 0) == 2
        assert len(counted) == 1
    finally:
        kernels._pack_plan.cache_clear()
        kernels._group_plan.cache_clear()


def _fake(dtype=torch.int32, shape=(4, 512), device="cuda", contiguous=True):
    """A stand-in for a tensor: what the wrapper's checks read, no storage."""
    return types.SimpleNamespace(
        dtype=dtype, shape=torch.Size(shape), is_cuda=device == "cuda",
        device=types.SimpleNamespace(type=device, index=0),
        dim=lambda: len(shape), is_contiguous=lambda: contiguous, data_ptr=lambda: 256)


@pytest.mark.parametrize("fn", ["group_flags", "pack_nonzero_groups"])
def test_wrapper_checks_and_cpu_plain(monkeypatch, fn):
    """On the CPU the wrappers run the plain versions and count no launch;
    a CUDA tensor of the wrong dtype, layout or group, a tensor on another
    device and a last dim that is not whole groups raise before anything
    is built or launched."""
    monkeypatch.setattr(kernels, "_lib", None)
    kernels.reset_launches()
    wrap = getattr(kernels, fn)
    x = torch.from_numpy(_plane("sparse", 3, 4, seed=1).view(np.int32))
    got = wrap(x, G)
    if fn == "group_flags":
        assert torch.equal(got, kernels.group_flags_plain(x, G))
    else:
        want = kernels.pack_nonzero_groups_plain(x, G)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrap(_fake(device="meta"))
    with pytest.raises(TypeError, match="int32"):
        wrap(_fake(dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        wrap(_fake(contiguous=False))
    with pytest.raises(ValueError, match="group 256"):
        wrap(_fake(shape=(4, 256)), 128)
    with pytest.raises(ValueError, match="multiple of group"):
        wrap(_fake(shape=(4, 300)))
    assert kernels._lib is None
