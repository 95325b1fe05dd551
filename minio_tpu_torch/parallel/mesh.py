"""Device-mesh parallelism for the erasure data plane.

The reference scales by fanning shard I/O across disks/nodes with
goroutines + REST (SURVEY.md section 2.4 "parallelism strategies").  The
port maps those strategies onto a single-controller mesh: one process
drives a (stripe, shard) grid of slots, each slot a torch device.
Repeated devices are allowed - one slot is one virtual device, as the
JAX package's virtual CPU devices are - so ``("cpu",) * 8`` and
``(cuda:0,) * 4`` run the same code as a mesh of distinct GPUs.

* axis "stripe" (data-parallel analogue of erasure *sets*,
  cmd/erasure-sets.go:543-580): independent stripes of a batch are placed
  on different slots; no collectives.
* axis "seq" (sequence-parallel analogue of the 10 MiB block streaming,
  cmd/object-api-common.go:31): the byte stream of one object is sharded
  along its length; RS is column-local so each slot encodes its slice
  independently.
* axis "shard" (tensor-parallel analogue of the per-disk shard fan-out in
  cmd/erasure-encode.go:39-54): the k data shards are split across the
  slots of a stripe group; each slot computes a partial parity (XOR of its
  terms) and the partials are combined with a recursive-doubling XOR
  all-reduce.

Layouts are not written here: every entry point declares its operand
planes by name and ``parallel.rules`` resolves them (PARTITION_RULES) and
picks the lowering (``local`` when the shard axis needs the XOR
all-reduce, ``global`` for collective-free geometries) behind one plan
cache keyed on the slots' devices rather than Mesh identity.

Every product, digest and fused pass is a kernel wrapper of
``ops/kernels.py``: K1 encode_pack, K2 phash256_batched, K3
gf_matmul_words and K4 verify_reconstruct on a ``cuda`` slot (a shape
one of them refuses raises), their plain versions on a CPU slot.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops import codec_step, gf, kernels
from . import rules


class Mesh:
    """A (stripe, shard) grid of torch device slots.

    ``devices`` is an object array of shape (stripe, shard) holding each
    slot's ``torch.device`` (``devices.size`` slots; a device may fill
    several); ``shape`` maps each axis name to its size."""

    axis_names = ("stripe", "shard")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def visible_devices() -> tuple:
    """Every CUDA device this process sees (none raises: there is no CPU
    default)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass devices="
        )
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(devices=None, stripe: "int | None" = None,
              shard: "int | None" = None) -> Mesh:
    """Build a ("stripe", "shard") mesh over ``devices`` (default: every
    visible CUDA device).

    Defaults to putting all slots on the stripe axis (pure
    set-parallelism) since XOR all-reduce traffic is then zero, mirroring
    the reference's default of independent sets per object.
    """
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if stripe is None and shard is None:
        stripe, shard = n, 1
    elif stripe is None:
        stripe = n // shard
    elif shard is None:
        shard = n // stripe
    if stripe * shard != n:
        raise ValueError(f"mesh {stripe}x{shard} != {n} devices")
    grid = np.empty((stripe, shard), dtype=object)
    for pos, d in enumerate(devices):
        grid[pos // shard, pos % shard] = d
    return Mesh(grid)


_overlap_fallback_warned = False


def warn_overlap_fallback() -> None:
    """Warn once that MINIO_TPU_CODEC_OVERLAP degrades to "off" on mesh.

    The overlap modes split a stripe batch along its length (the
    sub-chunk chain) or stage it through a pipelined kernel; the mesh
    entry points shard one whole stripe batch across slots with a
    collective parity accumulation, so splitting the stripe-length axis
    again underneath them would fight the "seq" axis for the same
    dimension.  Mesh callers get the serialized (bit-identical) path;
    this warning surfaces that the overlap knob is being ignored so
    operators do not chase missing overlap_windows counters on
    multi-device runs.
    """
    global _overlap_fallback_warned
    if _overlap_fallback_warned:
        return
    _overlap_fallback_warned = True
    warnings.warn(
        "MINIO_TPU_CODEC_OVERLAP is not supported on the device-mesh "
        "codec path; falling back to the serialized (off) pipeline",
        RuntimeWarning,
        stacklevel=3,
    )


def xor_allreduce(parts: list) -> list:
    """All-reduce with XOR over one mesh axis: ``parts[i]`` is slot i's
    tensor; returns each slot's copy of the XOR of all of them, on its
    own device.  ``parts`` are updated in place.

    GF(2^8) addition is XOR, which a sum cannot express; this is the
    collective backing shard-parallel parity accumulation.  Recursive
    doubling (log2(n) exchange steps) for a power-of-two axis, a gather
    and fold otherwise.  A step first takes every partner's pre-step
    value (a copy onto the slot's device, a real copy even where two
    slots share one device) and only then XORs in place, so no slot reads
    a partner that this step already updated.
    """
    n = len(parts)
    if n == 1:
        return list(parts)
    out = list(parts)
    if n & (n - 1) == 0:
        step = 1
        while step < n:
            # partner = i XOR step
            others = [
                out[i ^ step].to(out[i].device, non_blocking=True, copy=True)
                for i in range(n)
            ]
            for i in range(n):
                out[i].bitwise_xor_(others[i])
            step <<= 1
        return out
    total = out[0]
    for t in out[1:]:
        total.bitwise_xor_(t.to(total.device, non_blocking=True))
    return [total] + [
        total.to(t.device, non_blocking=True, copy=True) for t in out[1:]
    ]


def _col_blocks(matrix: np.ndarray, shard_n: int) -> list:
    """Split a generator/reconstruction matrix into per-shard-slot columns."""
    k = matrix.shape[1]
    k_local = k // shard_n
    return [
        np.ascontiguousarray(matrix[:, s * k_local:(s + 1) * k_local])
        for s in range(shard_n)
    ]


def _to_slot(host: np.ndarray, device) -> torch.Tensor:
    """One block's H2D: u32 words travel as int32 lanes."""
    host = np.ascontiguousarray(host)
    if host.dtype == np.uint32:
        host = host.view(np.int32)
    return torch.from_numpy(host).to(device)


def put_sharded(mesh: Mesh, x: np.ndarray, spec) -> rules.Sharded:
    """Place a host array onto the mesh with the given spec: one H2D per
    slot that holds a block of it."""
    x = np.asarray(x)
    return rules.shard_blocks(
        mesh, spec, x.shape,
        lambda i, j, sl: _to_slot(x[sl], mesh.devices[i, j]),
    )


def _pad_batch(arr: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad the leading axis to ``rows`` with a single allocation.

    (np.concatenate would reallocate AND copy the batch through a
    temporary; here the only traffic is one memcpy into fresh zeros, and
    the unpadded case returns the input untouched.)
    """
    if arr.shape[0] == rows:
        return arr
    out = np.zeros((rows,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


# ---------------------------------------------------------------------------
# Kernel bodies, registered with the rules.py plan cache
# ---------------------------------------------------------------------------
#
# Each kernel kind has up to two builders: ``build_local`` (a body over
# the grid of slot blocks; runs the XOR all-reduce over each stripe
# group's "shard" slots) and ``build_global`` (a whole-array body the
# plan runs once a stripe group, or once a slot for planes spread over
# every slot).  A plane the rules replicate over "shard" is computed
# once a stripe group, on the group's first slot.


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def _partial_products(cols: list, blocks) -> list:
    """Each shard slot's partial product of its column block with its
    (B, k_local, w) rows (K3), for one stripe group's row of blocks."""
    return [
        kernels.gf_matmul_words(c, b, tuple(range(c.shape[1])))
        for c, b in zip(cols, blocks)
    ]


def _group_grid(mesh: Mesh) -> np.ndarray:
    return np.empty(mesh.devices.shape, dtype=object)


def _encode_local(mesh: Mesh, k: int, m: int):
    cols = _col_blocks(gf.parity_matrix(k, m), mesh.shape["shard"])

    def step(local):
        # local[i, j]: (B_local, k_local, L) uint8 on slot (i, j)
        out = _group_grid(mesh)
        for i in range(local.shape[0]):
            partials = _partial_products(cols, [_words(b) for b in local[i]])
            out[i, 0] = _bytes(xor_allreduce(partials)[0])
        return out

    return step


def _encode_global(mesh: Mesh, k: int, m: int):
    matrix = gf.parity_matrix(k, m)

    def step(data: torch.Tensor) -> torch.Tensor:
        # data: (B, k, L) uint8
        return _bytes(kernels.gf_matmul_words(matrix, _words(data),
                                              tuple(range(k))))

    return step


def _encode_seq_global(mesh: Mesh, k: int, m: int):
    matrix = gf.parity_matrix(k, m)

    def step(data: torch.Tensor) -> torch.Tensor:
        # data: (k, L_slot) uint8, this slot's slice of the length; RS is
        # column-local
        words = _words(data.contiguous())[None]
        return _bytes(kernels.gf_matmul_words(matrix, words,
                                              tuple(range(k)))[0])

    return step


def _encode_hash_local(mesh: Mesh, k: int, m: int, shard_len: int):
    cols = _col_blocks(gf.parity_matrix(k, m), mesh.shape["shard"])

    def step(local):
        # local[i, j]: (B_local, k_local, w) int32 words
        parity, ddig, pdig = (_group_grid(mesh) for _ in range(3))
        for i in range(local.shape[0]):
            reduced = xor_allreduce(_partial_products(cols, local[i]))
            parity[i, 0] = reduced[0]
            for j, b in enumerate(local[i]):
                ddig[i, j] = kernels.phash256_batched(b, shard_len)
            pdig[i, 0] = kernels.phash256_batched(reduced[0], shard_len)
        return parity, ddig, pdig

    return step


def _encode_hash_global(mesh: Mesh, k: int, m: int, shard_len: int):
    def step(words: torch.Tensor):
        # whole stripes are slot-local on a stripe-only mesh: run the
        # fused single-device pass (K1) instead of the partial products
        parity, digests, _f, _p = codec_step.encode_words_fused1(
            words, m, shard_len
        )
        return parity, digests[:, :k], digests[:, k:]

    return step


def _reconstruct_local(mesh: Mesh, k: int, m: int, idx: "tuple[int, ...]"):
    rm = gf.reconstruction_matrix(k, m, idx)  # (k, k) survivors -> data
    cols = _col_blocks(rm, mesh.shape["shard"])

    def step(local):
        # local[i, j]: (B_local, k_local, w) compacted survivor rows
        out = _group_grid(mesh)
        for i in range(local.shape[0]):
            out[i, 0] = xor_allreduce(_partial_products(cols, local[i]))[0]
        return out

    return step


def _reconstruct_global(mesh: Mesh, k: int, m: int, idx: "tuple[int, ...]"):
    rm = gf.reconstruction_matrix(k, m, idx)

    def step(surv: torch.Tensor) -> torch.Tensor:
        # surv: (B, k, w) compacted survivor rows
        return kernels.gf_matmul_words(rm, surv, tuple(range(k)))

    return step


def _digest_global(mesh: Mesh, shard_len: int):
    def step(rows: torch.Tensor) -> torch.Tensor:
        # rows: (R_slot, w) flattened shard rows; embarrassingly parallel
        return kernels.phash256_batched(rows, shard_len)

    return step


def _verify_reconstruct_global(mesh: Mesh, k: int, m: int,
                               present: "tuple[bool, ...]", shard_len: int):
    def step(words: torch.Tensor, digests: torch.Tensor):
        # words: (B, n, w) quorum rows; stripes are slot-local on the
        # stripe axis, so the fused GET pass (K4: verify + reconstruct in
        # one kernel) runs once a stripe group with no collective
        return codec_step.verify_and_reconstruct_words(
            words, digests, present, k, m, shard_len
        )

    return step


rules.register_kernel(
    "sharded_encode",
    in_names=("stripe_bytes",),
    out_names=("parity_bytes",),
    build_local=_encode_local,
    build_global=_encode_global,
)
rules.register_kernel(
    "sharded_encode_seq",
    in_names=("seq_bytes",),
    out_names=("seq_parity",),
    build_global=_encode_seq_global,
)
rules.register_kernel(
    "mesh_encode_hash",
    in_names=("stripe_words",),
    out_names=("parity_words", "data_digests", "parity_digests"),
    build_local=_encode_hash_local,
    build_global=_encode_hash_global,
    # the JAX package donates the fresh device copy of the words; the
    # plan never copies it, so there is nothing to donate
    donate_argnums=(0,),
)
rules.register_kernel(
    "mesh_reconstruct",
    in_names=("survivor_words",),
    out_names=("recon_words",),
    build_local=_reconstruct_local,
    build_global=_reconstruct_global,
)
rules.register_kernel(
    "mesh_digest",
    in_names=("digest_rows",),
    out_names=("digest_out",),
    build_global=_digest_global,
)
rules.register_kernel(
    "mesh_verify_reconstruct",
    in_names=("quorum_words", "quorum_digests"),
    out_names=("recon_words", "ok_mask"),
    build_global=_verify_reconstruct_global,
)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _placed(mesh: Mesh, data, plane: str) -> rules.Sharded:
    if isinstance(data, rules.Sharded):
        return data
    return put_sharded(mesh, data, rules.spec_for(plane))


def sharded_encode(mesh: Mesh, data, parity_shards: int) -> rules.Sharded:
    """Encode a batch of stripes across the mesh.

    data: (batch, k, length) uint8 - a host array, or a plane from
    ``put_sharded`` - batch over "stripe", the k data shards over
    "shard".  Returns the (batch, m, length) parity plane, kept once a
    stripe group (``np.asarray`` gathers it).
    """
    data = _placed(mesh, data, "stripe_bytes")
    _, k, _ = data.shape
    shard_n = mesh.shape["shard"]
    if k % shard_n:
        raise ValueError(f"k={k} not divisible by shard axis {shard_n}")
    fn = rules.compile_kernel("sharded_encode", mesh, k=k, m=parity_shards)
    return fn(data)


def sharded_encode_seq(mesh: Mesh, data, parity_shards: int) -> rules.Sharded:
    """Sequence-parallel encode: one long object sharded along its length.

    data: (k, length) with length split over every slot (both axes
    flattened); RS columns are independent so there is no collective -
    this is the long-object scaling path (SURVEY.md section 5
    "long-context / sequence parallelism").
    """
    data = _placed(mesh, data, "seq_bytes")
    k, _ = data.shape
    fn = rules.compile_kernel("sharded_encode_seq", mesh, k=k, m=parity_shards)
    return fn(data)


# ---------------------------------------------------------------------------
# Production mesh paths (the backend seam's multi-device implementation)
# ---------------------------------------------------------------------------
#
# These are what codec.backend.TorchBackend dispatches to when it holds
# more than one slot: the "stripe" axis carries independent stripes (the
# erasure-sets data-parallel analogue) and the "shard" axis splits the k
# data shards of each stripe (the per-disk fan-out analogue,
# cmd/erasure-encode.go:39-54) with partial parities combined by the XOR
# all-reduce.


def pick_axes(n_devices: int, batch: int, data_shards: int) -> "tuple[int, int]":
    """Choose (stripe, shard) axis sizes for a batch of stripes.

    Minimize rounds of work (ceil(batch/stripe)), then maximize slot
    utilization, then prefer the smaller shard axis (less collective
    traffic).  Large batches therefore get pure stripe parallelism; small
    batches of wide stripes soak leftover slots on the shard axis.
    """
    best_key, best = None, (n_devices, 1)
    for shard in range(1, n_devices + 1):
        if n_devices % shard or data_shards % shard:
            continue
        stripe = n_devices // shard
        rounds = -(-batch // stripe)
        util = min(batch, stripe) * shard
        key = (rounds, -util, shard)
        if best_key is None or key < best_key:
            best_key, best = key, (stripe, shard)
    return best


def _bucket_batch(batch: int, stripe: int) -> int:
    """Pad batch to stripe * next_pow2(rounds): bounds plan cache entries
    to O(log B) per geometry while wasting <2x compute on odd sizes."""
    rounds = -(-batch // stripe)
    p = 1
    while p < rounds:
        p <<= 1
    return stripe * p


def mesh_encode_hash(mesh: Mesh, words: np.ndarray, parity_shards: int,
                     shard_len: int):
    """Mesh-parallel fused encode+digest over a batch of stripes.

    words: (B, k, w) uint32 host array.  Returns (parity (B, m, w),
    digests (B, k+m, 8)) as numpy, digest rows in data-then-parity order
    (the contract of ops.codec_step.encode_words_fused1).
    """
    return mesh_encode_hash_end(
        mesh_encode_hash_begin(mesh, words, parity_shards, shard_len)
    )


def mesh_encode_hash_begin(mesh: Mesh, words: np.ndarray, parity_shards: int,
                           shard_len: int):
    """Queue the mesh encode+digest WITHOUT synchronizing.

    The H2D copies and the launches are queued on each slot's stream;
    the returned tuple holds the output planes plus the unpadded batch
    size.  ``mesh_encode_hash_end`` reads them back (the sync point), so
    the erasure layer's double-buffered pipeline (encode_begin /
    encode_end) overlaps this batch's mesh pass with the previous
    batch's disk writes on the mesh path too.
    """
    B, k, _ = words.shape
    stripe = mesh.shape["stripe"]
    words = _pad_batch(words, _bucket_batch(B, stripe))
    fn = rules.compile_kernel(
        "mesh_encode_hash", mesh, k=k, m=parity_shards, shard_len=shard_len
    )
    dd = put_sharded(mesh, words, rules.spec_for("stripe_words"))
    parity, ddig, pdig = fn(dd)
    return parity, ddig, pdig, B


def mesh_encode_hash_end(handle):
    """Materialize a ``mesh_encode_hash_begin`` handle (the sync point)."""
    parity, ddig, pdig, B = handle
    digests = np.concatenate(
        [np.asarray(ddig)[:B], np.asarray(pdig)[:B]], axis=1
    )
    return np.asarray(parity)[:B], digests


def mesh_reconstruct(mesh: Mesh, words: np.ndarray,
                     present: "tuple[bool, ...]", data_shards: int,
                     parity_shards: int) -> np.ndarray:
    """Mesh-parallel batched reconstruct: (B, n, w) + mask -> (B, k, w).

    Survivor rows are compacted host-side so the device work is one
    partial product (K3) + XOR all-reduce per slot.
    """
    k, m = data_shards, parity_shards
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    if len(idx) < k:
        raise ValueError(f"need {k} shards, have {len(idx)}")
    surv = np.ascontiguousarray(words[:, idx, :])  # (B, k, w)
    B = surv.shape[0]
    stripe = mesh.shape["stripe"]
    surv = _pad_batch(surv, _bucket_batch(B, stripe))
    fn = rules.compile_kernel("mesh_reconstruct", mesh, k=k, m=m, idx=idx)
    dd = put_sharded(mesh, surv, rules.spec_for("survivor_words"))
    return np.asarray(fn(dd))[:B]


def mesh_verify_reconstruct(mesh: Mesh, words: np.ndarray,
                            digests: np.ndarray, present: "tuple[bool, ...]",
                            data_shards: int, parity_shards: int,
                            shard_len: int) -> "tuple[np.ndarray, np.ndarray]":
    """Mesh-parallel fused GET step: verify digests + reconstruct, one pass.

    words: (B, n, w) quorum rows, digests: (B, n, 8) expected phash256 -
    both over "stripe".  Returns ((B, k, w) data, (B, n) ok mask).
    Padded stripes hash to garbage and come back ok=False; the [:B] slice
    drops them before anyone looks.
    """
    k, m = data_shards, parity_shards
    B = words.shape[0]
    stripe = mesh.shape["stripe"]
    rows = _bucket_batch(B, stripe)
    words = _pad_batch(words, rows)
    digests = _pad_batch(np.asarray(digests, dtype=np.uint32), rows)
    fn = rules.compile_kernel(
        "mesh_verify_reconstruct",
        mesh,
        k=k,
        m=m,
        present=tuple(bool(p) for p in present),
        shard_len=shard_len,
    )
    dw = put_sharded(mesh, words, rules.spec_for("quorum_words"))
    dg = put_sharded(mesh, digests, rules.spec_for("quorum_digests"))
    data, ok = fn(dw, dg)
    return np.asarray(data)[:B], np.asarray(ok)[:B]


def mesh_digest(mesh: Mesh, words: np.ndarray, shard_len: int) -> np.ndarray:
    """Mesh-parallel phash256: (R, w) uint32 rows -> (R, 8) digests.

    Rows (any flattened batch of shards) are spread over every slot on
    both axes - digesting is embarrassingly parallel.
    """
    R = words.shape[0]
    n_dev = mesh.devices.size
    words = _pad_batch(words, _bucket_batch(R, n_dev))
    fn = rules.compile_kernel("mesh_digest", mesh, shard_len=shard_len)
    dd = put_sharded(mesh, words, rules.spec_for("digest_rows"))
    return np.asarray(fn(dd))[:R]
