"""Hot-path lint: AST rules encoding the port's device invariants.

The JAX package's rules, retargeted to the port's constructs:

* MTPU101 - host-device syncs (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, ``Event.synchronize()``,
  and ``np.asarray``/``np.array`` of a tensor) anywhere in the
  device-only modules (``minio_tpu_torch/ops/``, ``codec/``) outside
  host-boundary functions: names with ``host`` at either end, the
  staging transfers (``h2d``/``d2h`` in the name), the drain seams
  (``*_end``, ``drain``) and the functions kernel_contracts.DRAIN_SEAMS
  registers for the file.  The plain versions (``*_plain``) are NOT
  boundaries: they are the kernels' CPU path and the card's comparison
  reference, and a sync in one would be a sync on the CPU main path's
  every call too; none has one.
* MTPU102 - JAX-only (jit retrace); the port has no jax.jit and the
  rule never fires.
* MTPU103 - ``except Exception/BaseException``/bare ``except`` whose body
  is only ``pass``.
* MTPU104/105 - Prometheus registration conventions at the
  ``server/metrics.py`` emit sites.
* MTPU107 - eager parity readback outside the drain seams
  (``_drain_raw``, ``_drain_screened``, ``_drain_precomputed``,
  ``_drain_chunks`` in codec/backend.py, and ``*_end``).
* MTPU108 - loop-blocking calls inside ``async def`` in server/.
* MTPU109 - a hand-written axis-name spec tuple (``("stripe", "shard",
  None)``) in parallel/ or ops/ outside parallel/rules.py.
* MTPU110 - object-data mutation outside the read-cache invalidation
  seam.
* MTPU111 - eager readback in s3select/device.py outside its drains.

Suppress a deliberate exception with ``# noqa: MTPU###`` and its reason
on the offending line (see analysis/findings.py).
"""

from __future__ import annotations

import ast
import re

from .findings import Finding

# modules whose whole body is device-kernel territory: any host sync is
# a hot-path stall
DEVICE_ONLY_PREFIXES = ("minio_tpu_torch/ops/", "minio_tpu_torch/codec/")

# host-boundary functions exempt from the device-module sweep: "host" at
# either end of the name, or a staging transfer (h2d / d2h)
_HOST_BOUNDARY_RE = re.compile(r"^(host_|_host)|_host$|(^|_)(h2d|d2h)(_|$)")

# zero-argument methods that wait for the card (or copy to the host)
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_NP_MATERIALIZE = {"asarray", "array", "ascontiguousarray"}
# names that mark a value as a tensor for the np.asarray check
_TENSOR_ANNOTATIONS = {"torch.Tensor", "Tensor"}

# MTPU107: eager readback of device parity outputs.  Parity produced on
# the card must cross D2H only through the sanctioned seams (encode_end /
# the parity ref's drain) - a .cpu()/.numpy()/.tolist()/np.asarray of a
# parity value anywhere else in the kernel modules or the backend
# re-introduces the eager round-trip the digest-only PUT removed.
_PARITY_SCOPE_PREFIXES = ("minio_tpu_torch/ops/",)
_PARITY_SCOPE_FILES = ("minio_tpu_torch/codec/backend.py",)
_PARITY_SEAM_RE = re.compile(r"(_end$|drain)")
_READBACK_ATTRS = {"cpu", "numpy", "tolist"}

# MTPU110: object-data mutations must flow through the read-cache
# invalidation seam.  Any function in the erasure object layer that
# renames a generation in, deletes a version, or deletes object data
# files leaves stale digest-verified groups in the tiered read cache
# (local AND on peers) unless it also calls the invalidation seam.
# Staging mutations on SYS_VOL (tmp uploads, probe files) touch no
# committed object data and are exempt.
_MUTATION_SCOPE_FILES = (
    "minio_tpu_torch/objectlayer/erasure_object.py",
    "minio_tpu_torch/objectlayer/erasure_multipart.py",
)
_MUTATION_ATTRS = {"rename_data", "delete_version"}
# mutations whose first argument names the volume: staging writes to
# SYS_VOL are exempt, anything on a real bucket is a mutation
_MUTATION_VOL_ATTRS = {"delete_file", "write_metadata", "update_metadata"}

# MTPU109: hand-written axis-name spec tuples.  parallel/rules.py is the
# single source of truth for placements (pattern -> spec, fingerprinted
# into the plan cache's key); a spec literal anywhere else in the mesh
# or ops layers silently forks that truth.  A spec is a tuple whose
# entries are None, a mesh axis name or a tuple of axis names, with at
# least one axis name; the mesh's own ``axis_names`` is not a spec.
_SPEC_SCOPE_PREFIXES = ("minio_tpu_torch/parallel/", "minio_tpu_torch/ops/")
_SPEC_EXEMPT_FILES = ("minio_tpu_torch/parallel/rules.py",)
_MESH_AXES = {"stripe", "shard"}
_SPEC_EXEMPT_TARGETS = {"axis_names"}

_METRIC_NAME_RE = re.compile(r"^miniotpu_[a-z0-9_]+$")
_LABEL_KEY_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_METRIC_TYPES = {"counter", "gauge", "histogram"}

# MTPU111: S3-Select result drain.  The device scan keeps the object
# plane and every flag/count word on the card; candidate row bytes are
# the ONLY payload that crosses D2H, and only through the drain seam
# functions in s3select/device.py (``_drain_scalars`` / ``_drain_array``
# / ``_drain_fallback_chunk`` / ``drain_plane`` - any function whose
# name contains "drain").  An eager .cpu()/.numpy()/.item()/np.asarray
# anywhere else in that module re-introduces a whole-plane readback.
# ``.tolist()`` is left to MTPU502, whose taint tells a drained numpy
# array from a tensor; np.frombuffer is exempt (host bytes).
_SELECT_SCOPE_FILES = ("minio_tpu_torch/s3select/device.py",)
_SELECT_SEAM_RE = re.compile(r"drain")
_SELECT_READBACK_ATTRS = {"cpu", "numpy", "item"}

# MTPU108: event-loop-blocking calls inside ``async def`` bodies of the
# server plane.  One stalled coroutine stalls every connection on the
# loop; blocking work belongs on the worker-pool bridge (server/aio.py
# _LoopReader/_LoopWriter run blocking calls in *sync* defs on worker
# threads, which this rule deliberately does not see).  Awaited calls
# are exempt - ``await ev.wait()`` on an asyncio primitive is the
# non-blocking form - as are coroutine factories passed directly to an
# awaited ``asyncio.*`` wrapper (``await asyncio.wait_for(ev.wait(),``).
_LOOP_SCOPE_PREFIXES = ("minio_tpu_torch/server/",)
_LOOP_BLOCK_SLEEPS = {"time.sleep", "_time.sleep"}
_LOOP_SOCKET_ATTRS = {"recv", "recv_into", "sendall", "sendto", "recvfrom"}


def _drain_seams(rel_path: str) -> "tuple[str, ...]":
    """The drain seams kernel_contracts registers for ``rel_path``."""
    from .kernel_contracts import DRAIN_SEAMS

    return DRAIN_SEAMS.get(rel_path, ())


def _dotted(node: ast.AST) -> "str | None":
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.AST) -> "str | None":
    """The base Name of an expression like ``x``, ``x[i]``, ``x.attr``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _only_pass(body: "list[ast.stmt]") -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis
        ):
            continue
        return False
    return True


def _axis_entry(node: ast.AST) -> "bool | None":
    """True for an axis name (or a tuple of them), False for None, and
    None for anything a spec cannot hold."""
    if isinstance(node, ast.Constant):
        if node.value is None:
            return False
        if node.value in _MESH_AXES:
            return True
        return None
    if isinstance(node, ast.Tuple) and node.elts:
        if all(
            isinstance(e, ast.Constant) and e.value in _MESH_AXES
            for e in node.elts
        ):
            return True
    return None


def _is_spec_literal(node: ast.Tuple) -> bool:
    kinds = [_axis_entry(e) for e in node.elts]
    return bool(kinds) and None not in kinds and any(kinds)


def _annotation_text(ann: "ast.AST | None") -> str:
    if ann is None:
        return ""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip()
    return ast.unparse(ann)


def _tensor_names(func) -> "set[str]":
    """Names that hold a tensor in ``func``'s own body: parameters
    annotated as one, and names bound from a ``torch.*`` call."""
    out: "set[str]" = set()
    a = func.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if _annotation_text(p.annotation) in _TENSOR_ANNOTATIONS:
            out.add(p.arg)
    for n in ast.walk(func):
        if (
            isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Call)
            and (_dotted(n.value.func) or "").startswith("torch.")
        ):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.device_module = rel_path.startswith(DEVICE_ONLY_PREFIXES)
        self.parity_scope = (
            rel_path.startswith(_PARITY_SCOPE_PREFIXES)
            or rel_path in _PARITY_SCOPE_FILES
        )
        self.loop_scope = rel_path.startswith(_LOOP_SCOPE_PREFIXES)
        self.select_scope = rel_path in _SELECT_SCOPE_FILES
        self.spec_scope = (
            rel_path.startswith(_SPEC_SCOPE_PREFIXES)
            and rel_path not in _SPEC_EXEMPT_FILES
        )
        self.mutation_scope = rel_path in _MUTATION_SCOPE_FILES
        self.drain_seams = set(_drain_seams(rel_path))
        self.findings: "list[Finding]" = []
        # stack of (func_name, def node)
        self._funcs: "list[tuple[str, ast.AST]]" = []
        # id(def node) -> its tensor names, computed on first need
        self._tensors: "dict[int, set[str]]" = {}
        # parallel stack: is the enclosing def async? (MTPU108 keys on
        # the INNERMOST def - a sync closure inside an async def runs
        # on whatever thread calls it, not on the loop)
        self._async_stack: "list[bool]" = []
        # Call nodes that are awaited (directly, or as a coroutine
        # argument to an awaited asyncio.* wrapper)
        self._awaited: "set[int]" = set()
        # Tuple nodes that are the value of an exempt assignment
        self._exempt_tuples: "set[int]" = set()

    # -- helpers ----------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(rule, self.rel_path, getattr(node, "lineno", 1), message)
        )

    def _in_host_boundary(self) -> bool:
        return any(
            _HOST_BOUNDARY_RE.search(name)
            or _PARITY_SEAM_RE.search(name)
            or name in self.drain_seams
            for name, _ in self._funcs
        )

    # -- function defs ----------------------------------------------------

    def _visit_func(self, node):
        if self.mutation_scope:
            self._check_mutation_invalidate(node)
        self._funcs.append((node.name, node))
        self._async_stack.append(isinstance(node, ast.AsyncFunctionDef))
        self.generic_visit(node)
        self._async_stack.pop()
        self._funcs.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Await(self, node: ast.Await) -> None:
        v = node.value
        if isinstance(v, ast.Call):
            self._awaited.add(id(v))
            if (_dotted(v.func) or "").startswith("asyncio."):
                for a in list(v.args) + [kw.value for kw in v.keywords]:
                    if isinstance(a, ast.Call):
                        self._awaited.add(id(a))
        self.generic_visit(node)

    def _check_mutation_invalidate(self, node) -> None:
        """MTPU110: object-data mutation outside the invalidation seam.

        Each def is analyzed on its OWN body: nested defs are skipped
        (they are visited - and judged - separately), while lambdas
        stay attached to the enclosing def.  A mutation is rename_data/
        delete_version anywhere, or delete_file/write_metadata/
        update_metadata on a volume that is not the SYS_VOL staging
        area; the seam is any call whose name contains "invalidate".
        """
        mutations: "list[tuple[str, ast.Call]]" = []
        has_seam = False
        stack = list(ast.iter_child_nodes(node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(n, ast.Call):
                fn = n.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else ""
                )
                if "invalidate" in name.lower():
                    has_seam = True
                elif name in _MUTATION_ATTRS:
                    mutations.append((name, n))
                elif name in _MUTATION_VOL_ATTRS and n.args:
                    first = n.args[0]
                    if not (
                        isinstance(first, ast.Name)
                        and first.id == "SYS_VOL"
                    ):
                        mutations.append((name, n))
            stack.extend(ast.iter_child_nodes(n))
        if has_seam:
            return
        for name, call in mutations:
            self._emit(
                "MTPU110",
                call,
                f"{name}(...) mutates committed object data but "
                f"{node.name!r} never calls the read-cache invalidation "
                "seam; call self._invalidate_read_cache(bucket, object) "
                "(cache.invalidate_object) so local and peer cached "
                "groups are dropped before the mutation is acked",
            )

    # -- MTPU109: spec literals -------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Tuple) and any(
            (isinstance(t, ast.Name) and t.id in _SPEC_EXEMPT_TARGETS)
            or (
                isinstance(t, ast.Attribute)
                and t.attr in _SPEC_EXEMPT_TARGETS
            )
            for t in node.targets
        ):
            self._exempt_tuples.add(id(node.value))
        self.generic_visit(node)

    def visit_Tuple(self, node: ast.Tuple) -> None:
        if (
            self.spec_scope
            and id(node) not in self._exempt_tuples
            and _is_spec_literal(node)
        ):
            self._emit(
                "MTPU109",
                node,
                f"hand-written spec {ast.unparse(node)} outside "
                "parallel/rules.py; name the plane and resolve it "
                "through rules.spec_for so the partition-rule table "
                "stays the single source of truth",
            )
            return  # the nested axis tuples are part of this spec
        self.generic_visit(node)

    # -- calls ------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        self._check_sync(node)
        self._check_parity_readback(node)
        self._check_select_readback(node)
        self._check_metric_emit(node)
        self._check_loop_block(node)
        self.generic_visit(node)

    def _check_loop_block(self, node: ast.Call) -> None:
        """MTPU108: blocking call on the event-loop thread."""
        if not self.loop_scope:
            return
        if not self._async_stack or not self._async_stack[-1]:
            return
        if id(node) in self._awaited:
            return
        dotted = _dotted(node.func) or ""
        if dotted in _LOOP_BLOCK_SLEEPS:
            self._emit(
                "MTPU108",
                node,
                f"{dotted}() blocks the event loop inside an async def; "
                "use `await asyncio.sleep(...)` or move the work to the "
                "worker-pool bridge",
            )
            return
        if not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        if attr in _LOOP_SOCKET_ATTRS:
            self._emit(
                "MTPU108",
                node,
                f".{attr}() is a raw blocking socket call inside an "
                "async def; use the connection's StreamReader/"
                "StreamWriter on the loop",
            )
        elif attr == "result":
            self._emit(
                "MTPU108",
                node,
                ".result() blocks the event loop waiting on a future "
                "inside an async def; await it (or bridge through "
                "loop.run_in_executor)",
            )
        elif attr == "wait" and not dotted.startswith("asyncio."):
            self._emit(
                "MTPU108",
                node,
                f"{dotted or '.' + attr}() without await blocks the "
                "event loop inside an async def (a threading.Event-"
                "style wait, or an asyncio coroutine that never runs); "
                "await an asyncio primitive instead",
            )

    @staticmethod
    def _readback(node: ast.Call, attrs) -> "tuple[str, ast.AST] | None":
        """(what, read value) for ``x.<attr>()`` with attr in ``attrs``
        or ``np.asarray(x)`` / ``np.array(x)``, else None."""
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in attrs and not (
            node.args or node.keywords
        ):
            return f".{fn.attr}()", fn.value
        dotted = _dotted(fn) or ""
        if node.args and dotted in (
            "np.asarray", "np.array", "numpy.asarray", "numpy.array"
        ):
            return f"{dotted}()", node.args[0]
        return None

    def _check_parity_readback(self, node: ast.Call) -> None:
        """MTPU107: eager parity D2H outside the *_end/drain seams."""
        if not self.parity_scope:
            return
        if self._in_host_boundary():
            return
        hit = self._readback(node, _READBACK_ATTRS)
        if hit is None:
            return
        what, value = hit
        root = _root_name(value)
        if root is None or not (root == "par" or "parity" in root):
            return
        self._emit(
            "MTPU107",
            node,
            f"{what} of {root} eagerly reads device parity back to "
            "host outside the *_end/drain seams; keep the plane on the "
            "card and route readback through the backend's "
            "digest-only drain",
        )

    def _check_select_readback(self, node: ast.Call) -> None:
        """MTPU111: eager D2H outside the select result-drain seam."""
        if not self.select_scope:
            return
        if any(_SELECT_SEAM_RE.search(name) for name, _ in self._funcs):
            return
        hit = self._readback(node, _SELECT_READBACK_ATTRS)
        if hit is None:
            return
        what, value = hit
        root = _root_name(value) or "<expr>"
        self._emit(
            "MTPU111",
            node,
            f"{what} of {root} reads device data back to host outside "
            "the result-drain seam; only candidate row bytes may cross "
            "D2H, through the drain functions in s3select/device.py",
        )

    def _check_sync(self, node: ast.Call) -> None:
        """MTPU101: a host-device sync in a device-only module."""
        if not self.device_module or self._in_host_boundary():
            return
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _SYNC_ATTRS
            and not node.args
            and not node.keywords
        ):
            self._emit(
                "MTPU101",
                node,
                f"{_dotted(fn) or '.' + fn.attr}() is a host-device sync "
                "in a device-only module; move it to the host boundary "
                "(a host_*/drain function)",
            )
            return
        dotted = _dotted(fn) or ""
        if (
            node.args
            and dotted.startswith(("np.", "numpy."))
            and dotted.rsplit(".", 1)[-1] in _NP_MATERIALIZE
        ):
            root = _root_name(node.args[0])
            tensors: "set[str]" = set()
            if self._funcs:
                func = self._funcs[-1][1]
                tensors = self._tensors.get(id(func))
                if tensors is None:
                    tensors = self._tensors[id(func)] = _tensor_names(func)
            if root is not None and root in tensors:
                self._emit(
                    "MTPU101",
                    node,
                    f"{dotted}({root}...) materializes a tensor on the "
                    "host (a sync on the card) in a device-only module; "
                    "move it to the host boundary",
                )

    def _check_metric_emit(self, node: ast.Call) -> None:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if name not in ("emit", "emit_histogram"):
            return
        if not node.args or not (
            isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return
        metric = node.args[0].value
        if name == "emit":
            if len(node.args) < 2 or not (
                isinstance(node.args[1], ast.Constant)
                and node.args[1].value in _METRIC_TYPES
            ):
                return  # not a registration-shaped call
            mtype = node.args[1].value
        else:
            mtype = "histogram"
        if not _METRIC_NAME_RE.match(metric):
            self._emit(
                "MTPU104",
                node,
                f"metric {metric!r} violates naming: must match "
                "miniotpu_[a-z0-9_]+",
            )
        elif mtype == "counter" and not metric.endswith("_total"):
            self._emit(
                "MTPU104",
                node,
                f"counter {metric!r} must end in _total "
                "(prometheus counter convention)",
            )
        elif mtype == "histogram" and metric.endswith(
            ("_total", "_count", "_sum", "_bucket")
        ):
            self._emit(
                "MTPU104",
                node,
                f"histogram {metric!r} must not end in a reserved "
                "series suffix (_total/_count/_sum/_bucket)",
            )
        # label-key hygiene: every dict literal key in the sample args
        for arg in node.args[2:] + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Dict):
                    continue
                for k in sub.keys:
                    if (
                        isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and not _LABEL_KEY_RE.match(k.value)
                    ):
                        self._emit(
                            "MTPU105",
                            k,
                            f"label key {k.value!r} of {metric!r} must "
                            "match [a-z_][a-z0-9_]*",
                        )
        if name == "emit_histogram" and len(node.args) >= 4:
            lab = node.args[3]
            if (
                isinstance(lab, ast.Constant)
                and isinstance(lab.value, str)
                and not _LABEL_KEY_RE.match(lab.value)
            ):
                self._emit(
                    "MTPU105",
                    lab,
                    f"label key {lab.value!r} of {metric!r} must match "
                    "[a-z_][a-z0-9_]*",
                )

    # -- MTPU103 ----------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self._swallows_broadly(node.type) and _only_pass(node.body):
            caught = (
                "bare except" if node.type is None
                else f"except {_dotted(node.type) or '...'}"
            )
            self._emit(
                "MTPU103",
                node,
                f"{caught}: pass silently swallows failures; narrow the "
                "exception, log it, or count it",
            )
        self.generic_visit(node)

    @staticmethod
    def _swallows_broadly(t: "ast.AST | None") -> bool:
        if t is None:
            return True
        if isinstance(t, ast.Tuple):
            return any(_Linter._swallows_broadly(e) for e in t.elts)
        return _dotted(t) in ("Exception", "BaseException")


def lint_source(
    rel_path: str, text: str, tree: "ast.Module | None" = None
) -> "list[Finding]":
    """Lint one file's source; returns findings BEFORE noqa filtering.

    ``tree`` lets callers hand in an already-parsed module (the shared
    AST cache) so a five-pass run parses each file exactly once.
    """
    if tree is None:
        try:
            tree = ast.parse(text, filename=rel_path)
        except SyntaxError as e:
            return [
                Finding(
                    "MTPU100",
                    rel_path,
                    e.lineno or 1,
                    f"syntax error: {e.msg}",
                )
            ]
    linter = _Linter(rel_path)
    linter.visit(tree)
    return linter.findings
