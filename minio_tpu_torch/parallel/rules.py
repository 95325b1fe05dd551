"""Partition rules, the mesh plan cache, and submesh placement.

This module is the single source of truth for how the codec's logical
planes map onto mesh axes.  Three layers live here:

* **Partition rules** (``PARTITION_RULES``/``spec_for``): a declarative
  pattern -> spec table.  A spec is a tuple with one entry a dimension:
  ``None`` (not split), an axis name, or a tuple of axis names (split
  over their product, the first axis major).  Kernels name their operand
  planes ("stripe_words", "parity_words", ...) and the rules resolve the
  layout; the table is the JAX package's, entry for entry.

* **Plan cache** (``register_kernel``/``compile_kernel``): a memoized
  factory that picks the cheaper lowering per geometry.  Kernels that
  need the XOR all-reduce register a ``build_local`` (per-slot bodies,
  the ``local`` lowering); collective-free geometries (shard axis == 1,
  or kernels that are embarrassingly parallel) run a ``build_global``
  whole-array body per stripe group instead (the ``global`` lowering).
  The memo is keyed on the rules fingerprint, the mesh's slot devices
  and axis shape, and the static geometry - so a rebuilt ``Mesh`` over
  the same slots hits the cache.

* **Placement** (``PlacementRouter``/``placed``): carve the device set
  into submeshes and route independent merged batches to the
  least-loaded one instead of always spanning the mesh.  Policy comes
  from ``MINIO_TPU_PLACEMENT``:

  - ``span``:  always use every slot;
  - ``route``: always place each batch on one submesh;
  - ``auto``  (default): route small batches, span once a batch is big
    enough to keep every slot busy on the stripe axis.

  ``MINIO_TPU_SUBMESH_DEVICES`` sets the submesh width (default 1 slot).
  The routed device set travels to ``TorchBackend._mesh_for`` through a
  thread-local (``placed()``/``current_placement()``), so the batcher's
  per-submesh workers don't need to thread devices through the backend
  API.

There is no tracer here: a "lowering" is the loop that runs a builder's
body over the mesh's slots, and every launch inside it is the kernel
wrapper's own (the hand-written kernel on ``cuda``, its plain version on
the CPU).
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from contextlib import contextmanager

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Partition rules: logical plane name -> spec
# ---------------------------------------------------------------------------
#
# Batched planes are (B, rows, width): batch over "stripe", rows over
# "shard" when the k data shards are split across slots.  Parity and
# reconstructed outputs are replicated over "shard": every slot of a
# stripe group would hold the same plane, so it is kept once, on the
# group's first slot.

PARTITION_RULES: "tuple[tuple[str, tuple], ...]" = (
    # (B, k, w|L) data planes: batch over stripe, shards over shard
    (r"^(stripe|data|survivor)_(batch|words|bytes)$", ("stripe", "shard", None)),
    # (B, k, 8) per-data-shard digests follow their data rows
    (r"^data_digests$", ("stripe", "shard", None)),
    # (B, m, w|L) parity planes: replicated over shard after all-reduce
    (r"^parity_(words|bytes|plane)$", ("stripe", None, None)),
    (r"^parity_digests$", ("stripe", None, None)),
    # (B, k, w) reconstructed data: whole stripes, replicated over shard
    (r"^recon_words$", ("stripe", None, None)),
    # (B, n, w|8) quorum-read planes (fused verify+reconstruct): all n
    # shard rows of a stripe stay together - the bitrot check is
    # row-local but the decode needs every survivor row
    (r"^quorum_(words|digests)$", ("stripe", None, None)),
    # (B, n) per-shard verify verdicts
    (r"^ok_mask$", ("stripe", None)),
    # (R, w) flattened digest rows: spread over every slot on both axes
    (r"^digest_(rows|out)$", (("stripe", "shard"), None)),
    # (k, L) sequence-parallel stream: length over every slot
    (r"^seq_", (None, ("stripe", "shard"))),
)


def spec_for(name: str, rules=PARTITION_RULES) -> tuple:
    """Resolve one logical plane name to its spec.

    Raises ``KeyError`` on no match - a kernel naming a plane the rules
    don't cover is a bug, not a replicate-by-default.
    """
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    raise KeyError(f"no partition rule matches plane {name!r}")


def match_partition_rules(names, rules=PARTITION_RULES):
    """Resolve a tree of plane names to a matching tree of specs."""
    if isinstance(names, str):
        return spec_for(names, rules)
    return tuple(match_partition_rules(n, rules) for n in names)


_FINGERPRINT: "list[str | None]" = [None]


def rules_fingerprint(rules=PARTITION_RULES) -> str:
    """Stable digest of the rule table (part of the plan-cache key).  It
    hashes the same text as the JAX package's (``tuple(spec)`` of each
    rule), so the two tables fingerprint alike."""
    if rules is PARTITION_RULES and _FINGERPRINT[0] is not None:
        return _FINGERPRINT[0]
    h = hashlib.sha256()
    for pattern, spec in rules:
        h.update(f"{pattern}->{tuple(spec)}\n".encode())
    fp = h.hexdigest()[:16]
    if rules is PARTITION_RULES:
        _FINGERPRINT[0] = fp
    return fp


# ---------------------------------------------------------------------------
# Sharded planes: a global array laid out over a mesh's slots
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_axes(spec) -> set:
    return {a for e in spec for a in _entry_axes(e)}


def _holds(spec, i: int, j: int) -> bool:
    """Whether slot (i, j) holds a block of a plane laid out by ``spec``:
    a plane replicated over an axis is kept on that axis's index 0."""
    axes = _spec_axes(spec)
    return ("stripe" in axes or i == 0) and ("shard" in axes or j == 0)


def _block_slices(spec, shape, mesh_shape, i: int, j: int) -> tuple:
    """Slot (i, j)'s block of a global ``shape`` laid out by ``spec``."""
    pos = {"stripe": (i, mesh_shape[0]), "shard": (j, mesh_shape[1])}
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, parts = 0, 1
        for axis in _entry_axes(entry):
            a_idx, a_n = pos[axis]
            idx, parts = idx * a_n + a_idx, parts * a_n
        if size % parts:
            raise ValueError(
                f"dimension {d} of {tuple(shape)} does not split into"
                f" {parts} blocks (spec {spec})"
            )
        step = size // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class Sharded:
    """A global plane on a mesh: ``blocks[i, j]`` is slot (i, j)'s
    tensor on that slot's device, None where ``spec`` replicates the
    plane over an axis and the slot is not that axis's first.

    ``np.asarray(x)`` gathers the blocks to one host array (int32 word
    blocks come back as uint32, the port's host words)."""

    __slots__ = ("mesh", "spec", "shape", "blocks")

    def __init__(self, mesh, spec, shape, blocks):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.blocks = blocks

    def held(self):
        """(i, j, tensor) for every slot that holds a block."""
        S, H = self.blocks.shape
        for i in range(S):
            for j in range(H):
                if self.blocks[i, j] is not None:
                    yield i, j, self.blocks[i, j]

    def __array__(self, dtype=None, copy=None):
        out = None
        for i, j, t in self.held():
            host = t.cpu().numpy()
            if t.dtype == torch.int32:
                host = host.view(np.uint32)
            if out is None:
                out = np.empty(self.shape, dtype=host.dtype)
            out[_block_slices(self.spec, self.shape,
                              self.blocks.shape, i, j)] = host
        if out is None:
            raise ValueError("sharded plane holds no block")
        return out if dtype is None else out.astype(dtype, copy=False)


def shard_blocks(mesh, spec, shape, block_of):
    """Build a Sharded plane whose slot (i, j) block is ``block_of(i, j,
    slices)`` for every slot that holds one."""
    S, H = mesh.devices.shape
    blocks = np.empty((S, H), dtype=object)
    for i in range(S):
        for j in range(H):
            if _holds(spec, i, j):
                blocks[i, j] = block_of(
                    i, j, _block_slices(spec, shape, (S, H), i, j)
                )
    return Sharded(mesh, spec, shape, blocks)


def _split_dim(spec) -> "int | None":
    """The dimension a plane splits over the shard axis (None: none)."""
    for d, e in enumerate(spec):
        if "shard" in _entry_axes(e):
            return d
    return None


def _per_slot(spec) -> bool:
    """Planes the rules spread over every slot jointly (a tuple entry
    that holds "shard"): row- or column-local work, run slot by slot."""
    return any(
        isinstance(e, tuple) and "shard" in e for e in spec
    )


# ---------------------------------------------------------------------------
# Plan cache: one memoized factory, two lowerings
# ---------------------------------------------------------------------------


class KernelDef:
    """One registered mesh kernel: plane names + geometry-specialized builders.

    ``build_local(mesh, **statics)`` returns the mesh body of the
    ``local`` lowering: it takes each input as an object array (stripe,
    shard) of slot blocks and returns each output the same way (it may
    run the XOR all-reduce over a stripe group's slots).
    ``build_global(mesh, **statics)`` returns a whole-array body for the
    ``global`` lowering, which the plan runs once a stripe group (or
    once a slot, for planes the rules spread over every slot) on that
    unit's device.  Either may be None, but not both.  ``donate_argnums``
    is kept for the registry's shape: the plans never copy an input.
    """

    __slots__ = (
        "kind",
        "in_names",
        "out_names",
        "build_local",
        "build_global",
        "donate_argnums",
    )

    def __init__(self, kind, in_names, out_names, build_local, build_global,
                 donate_argnums):
        self.kind = kind
        self.in_names = tuple(in_names)
        self.out_names = tuple(out_names)
        self.build_local = build_local
        self.build_global = build_global
        self.donate_argnums = tuple(donate_argnums)

    def in_specs(self, rules=PARTITION_RULES):
        return tuple(spec_for(n, rules) for n in self.in_names)

    def out_specs(self, rules=PARTITION_RULES):
        return tuple(spec_for(n, rules) for n in self.out_names)


_KERNELS: "dict[str, KernelDef]" = {}


def register_kernel(kind: str, *, in_names, out_names, build_local=None,
                    build_global=None, donate_argnums=()) -> KernelDef:
    """Register a mesh kernel with the plan cache (idempotent by kind)."""
    if build_local is None and build_global is None:
        raise ValueError(f"kernel {kind!r} registered with no builder")
    kd = KernelDef(kind, in_names, out_names, build_local, build_global,
                   donate_argnums)
    _KERNELS[kind] = kd
    return kd


def registered_kernels() -> "tuple[str, ...]":
    """Kinds known to the plan cache."""
    return tuple(sorted(_KERNELS))


def kernel_def(kind: str) -> KernelDef:
    return _KERNELS[kind]


def mesh_cache_key(mesh) -> tuple:
    """Identity-free mesh key: each slot's device by position + axis
    shape + axis names."""
    return (
        tuple((pos, str(d)) for pos, d in enumerate(mesh.devices.flat)),
        tuple(mesh.devices.shape),
        tuple(mesh.axis_names),
    )


_compile_mu = threading.Lock()
_compiled: "dict[tuple, tuple[object, str]]" = {}
_cache_stats = {"hits": 0, "misses": 0}

MODES = ("local", "global")


def _pick_mode(kd: KernelDef, mesh) -> str:
    if kd.build_global is None:
        return "local"
    if kd.build_local is None:
        return "global"
    # both lowerings available: the local one only pays off when the
    # shard axis actually needs the XOR all-reduce
    return "local" if mesh.shape["shard"] > 1 else "global"


def _plan_local(kd: KernelDef, mesh, step):
    out_specs = kd.out_specs()

    def run(*args: Sharded):
        outs = step(*(a.blocks for a in args))
        if not isinstance(outs, tuple):
            outs = (outs,)
        shape_of = [_global_shape(spec, grid) for spec, grid in
                    zip(out_specs, outs)]
        res = tuple(Sharded(mesh, spec, shape, grid) for spec, shape, grid
                    in zip(out_specs, shape_of, outs))
        return res[0] if len(res) == 1 else res

    return run


def _global_shape(spec, grid) -> tuple:
    """A plane's global shape from its slot blocks (block shape times the
    number of blocks along each split dimension)."""
    S, H = grid.shape
    for i in range(S):
        for j in range(H):
            t = grid[i, j]
            if t is not None:
                n = {"stripe": S, "shard": H}
                shape = list(t.shape)
                for d, e in enumerate(spec):
                    for axis in _entry_axes(e):
                        shape[d] *= n[axis]
                return tuple(shape)
    raise ValueError("a mesh body returned no block")


def _plan_global(kd: KernelDef, mesh, step):
    in_specs, out_specs = kd.in_specs(), kd.out_specs()
    per_slot = all(_per_slot(s) for s in in_specs)
    S, H = mesh.devices.shape

    def gather(arg: Sharded, i: int, dev) -> torch.Tensor:
        d = _split_dim(arg.spec)
        if d is None or H == 1:
            return arg.blocks[i, 0]
        return torch.cat([arg.blocks[i, j].to(dev) for j in range(H)], dim=d)

    def run(*args: Sharded):
        grids = [np.empty((S, H), dtype=object) for _ in out_specs]
        for i in range(S):
            if per_slot:
                for j in range(H):
                    outs = step(*(a.blocks[i, j] for a in args))
                    if not isinstance(outs, tuple):
                        outs = (outs,)
                    for g, o in zip(grids, outs):
                        g[i, j] = o
                continue
            dev = mesh.devices[i, 0]
            outs = step(*(gather(a, i, dev) for a in args))
            if not isinstance(outs, tuple):
                outs = (outs,)
            for g, spec, o in zip(grids, out_specs, outs):
                d = _split_dim(spec)
                if d is None:
                    g[i, 0] = o
                    continue
                for j, part in enumerate(o.chunk(H, dim=d)):
                    g[i, j] = part.to(mesh.devices[i, j])
        res = tuple(
            Sharded(mesh, spec, _global_shape(spec, g), g)
            for spec, g in zip(out_specs, grids)
        )
        return res[0] if len(res) == 1 else res

    return run


def compile_kernel(kind: str, mesh, *, force_mode: "str | None" = None,
                   **statics):
    """Build (or fetch) one kernel's plan for one geometry.

    Cache key: (kind, rules fingerprint, slot devices + axis shape,
    force_mode, sorted statics) - NOT the Mesh object, so a rebuilt mesh
    over the same slots reuses the plan.  The plan takes and returns
    ``Sharded`` planes.
    """
    kd = _KERNELS[kind]
    key = (
        kind,
        rules_fingerprint(),
        mesh_cache_key(mesh),
        force_mode,
        tuple(sorted(statics.items())),
    )
    with _compile_mu:
        hit = _compiled.get(key)
        if hit is not None:
            _cache_stats["hits"] += 1
            return hit[0]
    mode = force_mode or _pick_mode(kd, mesh)
    if mode == "global":
        fn = _plan_global(kd, mesh, kd.build_global(mesh, **statics))
    elif mode == "local":
        fn = _plan_local(kd, mesh, kd.build_local(mesh, **statics))
    else:
        raise ValueError(f"unknown lowering mode {mode!r}")
    with _compile_mu:
        prior = _compiled.get(key)
        if prior is not None:
            # lost a build race; keep the first plan
            _cache_stats["hits"] += 1
            return prior[0]
        _compiled[key] = (fn, mode)
        _cache_stats["misses"] += 1
    return fn


def kernel_mode(kind: str, mesh, **statics) -> str:
    """The lowering the plan cache would pick for this geometry."""
    return _pick_mode(_KERNELS[kind], mesh)


def cache_info() -> dict:
    with _compile_mu:
        return {
            "entries": len(_compiled),
            "hits": _cache_stats["hits"],
            "misses": _cache_stats["misses"],
        }


def clear_compile_cache() -> None:
    with _compile_mu:
        _compiled.clear()
        _cache_stats["hits"] = 0
        _cache_stats["misses"] = 0


# ---------------------------------------------------------------------------
# Placement: submesh carving + least-loaded routing
# ---------------------------------------------------------------------------

PLACEMENT_POLICIES = ("span", "route", "auto")


def placement_policy() -> str:
    pol = os.environ.get("MINIO_TPU_PLACEMENT", "auto").strip().lower()
    return pol if pol in PLACEMENT_POLICIES else "auto"


class Submesh:
    """One carved slice of the device set with a live queue-depth count."""

    __slots__ = ("name", "devices", "depth")

    def __init__(self, name: str, devices: tuple):
        self.name = name
        self.devices = devices
        self.depth = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Submesh({self.name}, n={len(self.devices)}, depth={self.depth})"


class PlacementRouter:
    """Route independent merged batches to the least-loaded submesh.

    The device set is carved into contiguous submeshes of
    ``submesh_devices`` slots (``MINIO_TPU_SUBMESH_DEVICES``, default 1);
    a remainder that can't fill a submesh folds into the last one.
    ``route`` returns None when the batch should span the full mesh
    (policy ``span``, a single submesh, or ``auto`` with a batch big
    enough to occupy every slot on the stripe axis).
    """

    def __init__(self, devices, policy: "str | None" = None,
                 submesh_devices: "int | None" = None):
        self.devices = tuple(devices)
        if policy is None:
            policy = placement_policy()
        self.policy = policy if policy in PLACEMENT_POLICIES else "auto"
        if submesh_devices is None:
            try:
                submesh_devices = int(
                    os.environ.get("MINIO_TPU_SUBMESH_DEVICES", "1") or "1"
                )
            except ValueError:
                submesh_devices = 1
        width = max(1, min(submesh_devices, len(self.devices)))
        subs = []
        full = (len(self.devices) // width) * width
        for lo in range(0, full, width):
            subs.append(Submesh(f"sub{len(subs)}", self.devices[lo:lo + width]))
        if full < len(self.devices):
            # width is clamped to len(devices), so subs is never empty
            last = subs[-1]
            subs[-1] = Submesh(last.name, last.devices + self.devices[full:])
        self._subs = tuple(subs)
        self._mu = threading.Lock()

    @property
    def submeshes(self) -> "tuple[Submesh, ...]":
        return self._subs

    def route(self, batch_blocks: int) -> "Submesh | None":
        """Claim a submesh for a batch (None -> span the full mesh)."""
        if self.policy == "span" or len(self._subs) <= 1:
            return None
        if self.policy == "auto" and batch_blocks >= len(self.devices):
            # enough stripes to occupy every slot data-parallel: the
            # span path's stripe axis beats any single submesh
            return None
        with self._mu:
            sub = min(self._subs, key=lambda s: s.depth)
            sub.depth += 1
            return sub

    def release(self, sub: Submesh) -> None:
        with self._mu:
            sub.depth = max(0, sub.depth - 1)

    def depths(self) -> "dict[str, int]":
        with self._mu:
            return {s.name: s.depth for s in self._subs}


_placement_tls = threading.local()


def current_placement():
    """The device set routed to this thread, or None (span)."""
    return getattr(_placement_tls, "devices", None)


@contextmanager
def placed(devices):
    """Scope mesh construction on this thread to a routed device set."""
    prev = getattr(_placement_tls, "devices", None)
    _placement_tls.devices = tuple(devices)
    try:
        yield
    finally:
        _placement_tls.devices = prev
