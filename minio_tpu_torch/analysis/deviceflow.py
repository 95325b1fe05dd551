"""MTPU5xx: interprocedural device-value provenance over the call graph.

The JAX package's dataflow rules, retargeted to the port's tensors:

* **MTPU501 - use-after-mutate.**  A value passed at an in-place
  position of a registered kernel wrapper (the hash accumulator of the
  sub-chunk steps, ``kernel_contracts.IN_PLACE_ENTRY_POINTS``) must be
  re-bound from the wrapper's return before it is read again: the name
  then refers to a buffer the call changed under it (the JAX package's
  use-after-donate).
* **MTPU502 - interprocedural D2H escape.**  A device-provenance value
  (return of a registered kernel wrapper, a torch factory given a CUDA
  device, ``.cuda()``, or anything derived from one) reaching
  ``.cpu()`` / ``.numpy()`` / ``.item()`` / ``.tolist()`` /
  ``np.asarray`` / ``bytes()`` / ``codec_step.tensor_to_words`` outside
  a registered drain seam - anywhere in the tree, through calls.
* **MTPU503 - device value across a thread boundary.**  A closure (or
  argument) crossing a `submit`/`run_coroutine_threadsafe`/`Thread`
  boundary while capturing a device value: the D2H then happens as a
  hidden sync on an arbitrary worker thread, outside every seam.
* **MTPU504 - call-graph-deep blocking-under-async.**  Walks the call
  graph from every ``server/`` async def through plain (non-boundary)
  edges and flags blocking calls in the sync callees that therefore run
  ON the loop.  Pool/executor/thread boundary edges cut the traversal;
  ``call_soon_threadsafe`` / ``run_coroutine_threadsafe`` closures
  remain loop-resident and are traversed.
* **MTPU505 - registry drift.**  The ``kernel_contracts`` dataflow
  registry (wrappers, in-place positions, drain seams) is cross-checked
  against the tree in both directions.

The value-tracking is deliberately locals-only and conservative:
attributes and containers are untracked, unresolvable calls produce no
taint, and control flow is approximated by source order.  It
under-approximates - every finding it does emit survives triage or gets
a reasoned ``# noqa``.
"""

from __future__ import annotations

import ast
import dataclasses
import time
from collections import deque

from . import callgraph as cg
from .astcache import ParsedModule
from .findings import Finding

# canonical dotted names (after import-alias resolution) -------------------

# producers: torch factories whose ``device=`` is a CUDA device, and
# ``.cuda()`` / ``.to(<cuda>)`` on anything
_TORCH_FACTORIES = {
    "empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
    "empty_like", "zeros_like", "ones_like", "full_like", "randint",
    "rand", "randn", "frombuffer", "empty_strided",
}

# D2H sinks (the MTPU502 escape set); ``bytes`` is matched as a bare
# builtin name, the methods as zero-arg calls on a device value
_SINK_CALLS = {"numpy.asarray", "numpy.array"}
_SINK_FUNCS = {"tensor_to_words"}
_SINK_METHODS = {"item", "tolist", "cpu", "numpy"}

# attribute loads on a device value that yield HOST metadata
_HOST_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout", "nbytes",
    "itemsize",
}
# methods on a device value that return host values
_HOST_METHODS = {
    "numel", "size", "dim", "data_ptr", "is_contiguous", "element_size",
    "stride", "get_device", "nelement", "storage_offset",
}

# blocking-call shapes for MTPU504 (mirrors MTPU108, which owns the
# lexically-async case; 504 owns the reachable-sync-callee case)
_BLOCK_SLEEPS = {"time.sleep", "_time.sleep"}
_BLOCK_SOCKET_ATTRS = {"recv", "recv_into", "sendall", "sendto", "recvfrom"}

_SERVER_PREFIX = "minio_tpu_torch/server/"


def _is_cuda_device(node: "ast.AST | None") -> bool:
    """A literal CUDA device: ``"cuda"``/``"cuda:0"`` or
    ``torch.device("cuda", ...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and node.args:
        name = ".".join(cg._dotted_parts(node.func) or [])
        return name.endswith("device") and _is_cuda_device(node.args[0])
    return False


def _mutated_params(info: "cg.FuncInfo") -> "dict[str, int]":
    """Parameters ``info``'s own body writes in place (augmented
    assignment, subscript store, or an ``x.op_()`` method) -> their
    caller-side positions."""
    pos = {n: i for i, n in enumerate(_param_names(info))}
    out: "dict[str, int]" = {}
    for n in ast.walk(info.node):
        tgt = None
        if isinstance(n, ast.AugAssign):
            tgt = n.target
        elif isinstance(n, ast.Assign):
            tgt = next((t.value for t in n.targets
                        if isinstance(t, ast.Subscript)), None)
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr.endswith("_")
              and not n.func.attr.startswith("_")):
            tgt = n.func.value
        if isinstance(tgt, ast.Name) and tgt.id in pos:
            out[tgt.id] = pos[tgt.id]
    return out


@dataclasses.dataclass
class Registry:
    """The dataflow fact tables, resolved to qname form.

    Defaults come from ``kernel_contracts``; tests inject synthetic
    registries to exercise fixture files in isolation.
    """

    # "rel/path.py::name" of every device-producing kernel wrapper
    entry_qnames: "frozenset[str]"
    # "rel/path.py::name" -> positional indices it writes in place
    donating_qnames: "dict[str, tuple[int, ...]]"
    # mesh kernel kind -> positions its plan writes in place
    mesh_donating: "dict[str, tuple[int, ...]]"
    # rel path -> bare function names that are sanctioned drain seams
    drain_seams: "dict[str, tuple[str, ...]]"
    # short module -> rel path (for the MTPU505 existence checks)
    entry_point_paths: "dict[str, str]"
    # (short module, name) pairs, as registered
    known_entry_points: "frozenset[tuple[str, str]]"
    donating_entry_points: "dict[tuple[str, str], tuple[int, ...]]"

    @classmethod
    def default(cls) -> "Registry":
        from . import kernel_contracts as kc

        paths = kc.ENTRY_POINT_PATHS
        return cls(
            entry_qnames=frozenset(
                f"{paths[m]}::{n}" for m, n in kc.KNOWN_ENTRY_POINTS
            ),
            donating_qnames={
                f"{paths[m]}::{n}": pos
                for (m, n), pos in kc.IN_PLACE_ENTRY_POINTS.items()
            },
            mesh_donating=dict(kc.MESH_DONATING_KERNELS),
            drain_seams=dict(kc.DRAIN_SEAMS),
            entry_point_paths=dict(paths),
            known_entry_points=frozenset(kc.KNOWN_ENTRY_POINTS),
            donating_entry_points=dict(kc.IN_PLACE_ENTRY_POINTS),
        )

    def is_drain(self, qname: str) -> bool:
        rel, _, qual = qname.partition("::")
        name = qual.rsplit(".", 1)[-1]
        return name in self.drain_seams.get(rel, ())


def _canonical(facts, func: ast.AST) -> "str | None":
    """Import-alias-resolved dotted name of a call target expression."""
    parts = cg._dotted_parts(func)
    if parts is None:
        return None
    head = facts.imports.get(parts[0], parts[0]) if facts else parts[0]
    return ".".join([head] + parts[1:])


def _param_names(info: cg.FuncInfo) -> "list[str]":
    """Positional parameter names as seen by a caller (self/cls elided
    for methods, since every resolved method edge is a bound call)."""
    a = info.node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if info.cls is not None and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def _collect_awaited(func_node: ast.AST) -> "set[int]":
    """ids of Call nodes that are awaited (directly or as coroutine
    args of an awaited asyncio.* wrapper) — the MTPU108 exemption."""
    out: "set[int]" = set()
    for node in ast.walk(func_node):
        if not isinstance(node, ast.Await):
            continue
        v = node.value
        if isinstance(v, ast.Call):
            out.add(id(v))
            dotted = ".".join(cg._dotted_parts(v.func) or [])
            if dotted.startswith("asyncio."):
                for a in list(v.args) + [kw.value for kw in v.keywords]:
                    if isinstance(a, ast.Call):
                        out.add(id(a))
    return out


# ---------------------------------------------------------------------------
# per-function taint interpretation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FuncResult:
    returns_device: bool = False
    # callee qname -> tainted parameter names discovered at call sites
    param_out: "dict[str, set[str]]" = dataclasses.field(
        default_factory=dict
    )


class _Interp:
    """One forward pass over a function body, locals-only taint.

    Source order approximates control flow: a donation "happens before"
    any read on a later line of the same body, branches share one
    environment.  Nested def/class bodies are skipped — they are their
    own call-graph nodes (and MTPU503 owns the capture case).
    """

    def __init__(
        self,
        pass_: "_DeviceflowPass",
        qname: str,
        facts,
        body: "list[ast.stmt]",
        seeded_params: "set[str]",
        emit: bool,
    ):
        self.p = pass_
        self.qname = qname
        self.rel_path = qname.partition("::")[0]
        self.facts = facts
        self.body = body
        self.emit = emit
        self.in_drain = pass_.registry.is_drain(qname)
        self.is_entry = qname in pass_.registry.entry_qnames
        self.env: "set[str]" = set(seeded_params)
        # name -> (line, callee label) of an outstanding donation
        self.donated: "dict[str, tuple[int, str]]" = {}
        # local var -> donated positions of a compiled donating kernel
        self.donating_fns: "dict[str, tuple[int, ...]]" = {}
        self.result = _FuncResult()

    # -- findings ---------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if self.emit:
            self.p.findings.append(
                Finding(
                    rule, self.rel_path, getattr(node, "lineno", 1), msg
                )
            )

    # -- statements -------------------------------------------------------

    def run(self) -> _FuncResult:
        for stmt in self.body:
            self._stmt(stmt)
        return self.result

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(
            s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return  # own graph node
        if isinstance(s, ast.Assign):
            t = self._eval(s.value)
            for tgt in s.targets:
                self._assign(tgt, s.value, t)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._assign(s.target, s.value, self._eval(s.value))
        elif isinstance(s, ast.AugAssign):
            t = self._eval(s.value)
            if isinstance(s.target, ast.Name):
                self._read(s.target)
                if t:
                    self.env.add(s.target.id)
        elif isinstance(s, ast.Return):
            if s.value is not None and self._eval(s.value):
                self.result.returns_device = True
        elif isinstance(s, ast.Expr):
            self._eval(s.value)
        elif isinstance(s, ast.If):
            self._eval(s.test)
            for b in (s.body, s.orelse):
                saved = dict(self.donated)
                for st in b:
                    self._stmt(st)
                if b and isinstance(
                    b[-1],
                    (ast.Return, ast.Raise, ast.Break, ast.Continue),
                ):
                    # a branch that cannot fall through takes its
                    # donation records (and kills) with it
                    self.donated = saved
        elif isinstance(s, ast.While):
            self._eval(s.test)
            for b in (s.body, s.orelse):
                for st in b:
                    self._stmt(st)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            t = self._eval(s.iter)
            self._assign(s.target, s.iter, t)
            for b in (s.body, s.orelse):
                for st in b:
                    self._stmt(st)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                t = self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, item.context_expr, t)
            for st in s.body:
                self._stmt(st)
        elif isinstance(s, ast.Try):
            for st in s.body:
                self._stmt(st)
            for h in s.handlers:
                for st in h.body:
                    self._stmt(st)
            for b in (s.orelse, s.finalbody):
                for st in b:
                    self._stmt(st)
        elif isinstance(s, ast.Delete):
            for tgt in s.targets:
                if isinstance(tgt, ast.Name):
                    self.env.discard(tgt.id)
                    self.donated.pop(tgt.id, None)
        elif isinstance(s, (ast.Raise, ast.Assert)):
            for v in (getattr(s, "exc", None), getattr(s, "test", None),
                      getattr(s, "msg", None)):
                if v is not None:
                    self._eval(v)

    def _assign(self, tgt: ast.AST, value: ast.AST, tainted: bool) -> None:
        if isinstance(tgt, ast.Name):
            # rebinding kills both taint and any outstanding donation:
            # the NAME now refers to a fresh value
            self.donated.pop(tgt.id, None)
            if tainted:
                self.env.add(tgt.id)
            else:
                self.env.discard(tgt.id)
            # track `fn = rules.compile_kernel("kind", ...)` donating
            # callables so the later fn(dd) call donates dd
            if isinstance(value, ast.Call):
                kind = self._compiled_kernel_kind(value)
                if kind is not None:
                    pos = self.p.registry.mesh_donating.get(kind)
                    if pos:
                        self.donating_fns[tgt.id] = pos
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elems = tgt.elts
            src = (
                value.elts
                if isinstance(value, (ast.Tuple, ast.List))
                and len(value.elts) == len(elems)
                else None
            )
            for i, e in enumerate(elems):
                et = self._eval(src[i]) if src is not None else tainted
                self._assign(e, src[i] if src else value, et)
        elif isinstance(tgt, ast.Starred):
            self._assign(tgt.value, value, tainted)
        # attribute/subscript targets: untracked (locals-only)

    # -- expressions ------------------------------------------------------

    def _read(self, node: ast.Name) -> None:
        """MTPU501: a load of a name with an outstanding in-place write."""
        rec = self.donated.get(node.id)
        if rec is not None:
            line, label = rec
            self._emit(
                "MTPU501",
                node,
                f"'{node.id}' is read after {label} wrote it in place "
                f"(line {line}); re-bind it from the wrapper's return "
                "(the updated buffer), or pass a copy if the input must "
                "survive",
            )

    def _eval(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            self._read(e)
            return e.id in self.env
        if isinstance(e, ast.Call):
            return self._eval_call(e)
        if isinstance(e, ast.Attribute):
            t = self._eval(e.value)
            return t and e.attr not in _HOST_ATTRS
        if isinstance(e, ast.Subscript):
            t = self._eval(e.value)
            self._eval(e.slice)
            return t
        if isinstance(e, ast.BinOp):
            left = self._eval(e.left)
            right = self._eval(e.right)
            return left or right
        if isinstance(e, ast.UnaryOp):
            return self._eval(e.operand)
        if isinstance(e, ast.BoolOp):
            return any([self._eval(v) for v in e.values])
        if isinstance(e, ast.Compare):
            self._eval(e.left)
            for c in e.comparators:
                self._eval(c)
            return False  # comparisons yield bools (device bools: rare)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any([self._eval(v) for v in e.elts])
        if isinstance(e, ast.Dict):
            vals = [v for v in e.values if v is not None]
            return any([self._eval(v) for v in vals])
        if isinstance(e, ast.IfExp):
            self._eval(e.test)
            a = self._eval(e.body)
            b = self._eval(e.orelse)
            return a or b
        if isinstance(e, ast.Await):
            return self._eval(e.value)
        if isinstance(e, ast.NamedExpr):
            t = self._eval(e.value)
            self._assign(e.target, e.value, t)
            return t
        if isinstance(e, ast.Starred):
            return self._eval(e.value)
        if isinstance(e, (ast.JoinedStr, ast.FormattedValue)):
            for v in ast.iter_child_nodes(e):
                if isinstance(v, ast.expr):
                    self._eval(v)
            return False
        if isinstance(e, ast.Lambda):
            return False  # body analyzed at boundary sites (MTPU503)
        if isinstance(
            e, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
        ):
            # comprehensions: evaluate iterables for reads; element
            # taint is untracked (locals-only discipline)
            for gen in e.generators:
                self._eval(gen.iter)
            return False
        return False

    def _compiled_kernel_kind(self, call: ast.Call) -> "str | None":
        dotted = _canonical(self.facts, call.func) or ""
        if not dotted.endswith("compile_kernel"):
            return None
        if call.args and isinstance(call.args[0], ast.Constant):
            v = call.args[0].value
            if isinstance(v, str):
                return v
        return None

    def _eval_call(self, call: ast.Call) -> bool:
        # receiver / function expression first (it is read)
        recv_taint = False
        if isinstance(call.func, ast.Attribute):
            recv_taint = self._eval(call.func.value)
        elif isinstance(call.func, ast.Name):
            self._read(call.func)

        arg_taints = [self._eval(a) for a in call.args]
        kw_taints = {
            kw.arg: self._eval(kw.value)
            for kw in call.keywords
            if kw.arg is not None
        }
        for kw in call.keywords:
            if kw.arg is None:
                self._eval(kw.value)

        dotted = _canonical(self.facts, call.func) or ""
        edge = self.p.graph.call_info.get(id(call))
        callee = edge.callee if edge is not None else None

        # MTPU503: boundary crossings are handled here so the closure
        # sees the env at the crossing point
        if edge is not None and edge.boundary is not None:
            self._check_boundary(call, edge)

        # MTPU502 sinks
        fname = dotted.rsplit(".", 1)[-1]
        if dotted in _SINK_CALLS or fname in _SINK_FUNCS or (
            isinstance(call.func, ast.Name) and call.func.id == "bytes"
        ):
            if arg_taints and arg_taints[0]:
                self._sink(call, dotted or "bytes")
            return False
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _SINK_METHODS
            and recv_taint
            and not call.args
        ):
            self._sink(call, f".{call.func.attr}()")
            return False
        if isinstance(call.func, ast.Attribute) and (
            call.func.attr in _HOST_METHODS
        ):
            return False

        # donation: registered donating entry point, or a local var
        # bound to a compiled donating mesh kernel
        donate_pos: "tuple[int, ...]" = ()
        label = ""
        if callee is not None and callee in self.p.registry.donating_qnames:
            donate_pos = self.p.registry.donating_qnames[callee]
            label = callee.rsplit("::", 1)[-1]
        elif (
            isinstance(call.func, ast.Name)
            and call.func.id in self.donating_fns
        ):
            donate_pos = self.donating_fns[call.func.id]
            label = f"compiled kernel '{call.func.id}'"
        for pos in donate_pos:
            if pos < len(call.args) and isinstance(
                call.args[pos], ast.Name
            ):
                self.donated[call.args[pos].id] = (call.lineno, label)

        # interprocedural parameter taint
        if (
            callee is not None
            and edge.boundary is None
            and callee in self.p.graph.funcs
        ):
            info = self.p.graph.funcs[callee]
            pnames = _param_names(info)
            hit = {
                pnames[i]
                for i, t in enumerate(arg_taints)
                if t and i < len(pnames)
            }
            hit |= {k for k, t in kw_taints.items() if t and k in pnames}
            if hit:
                self.result.param_out.setdefault(callee, set()).update(hit)

        # producer classification
        if callee is not None:
            if callee in self.p.registry.entry_qnames:
                return True
            if self.p.registry.is_drain(callee):
                return False  # drained: the return is a host fact
            if self.p.summaries.get(callee):
                return True
        if dotted.startswith("torch.") and fname in _TORCH_FACTORIES and any(
            kw.arg == "device" and _is_cuda_device(kw.value)
            for kw in call.keywords
        ):
            return True
        if isinstance(call.func, ast.Attribute) and (
            call.func.attr == "cuda"
            or (call.func.attr == "to" and call.args
                and _is_cuda_device(call.args[0]))
        ):
            return True
        # method on a device value stays device (astype/reshape/...)
        if isinstance(call.func, ast.Attribute) and recv_taint:
            return True
        return False

    def _sink(self, call: ast.Call, what: str) -> None:
        if self.in_drain or self.is_entry:
            return
        self._emit(
            "MTPU502",
            call,
            f"device-provenance value reaches {what} outside a "
            "registered drain seam: this D2H sync belongs in a "
            "*_end/drain function from kernel_contracts.DRAIN_SEAMS "
            "(or register this one)",
        )

    # -- MTPU503 ----------------------------------------------------------

    def _free_loads(self, node: ast.AST) -> "set[str]":
        """Names a closure body loads that it does not itself bind."""
        bound: "set[str]" = set()
        loads: "set[str]" = set()
        if isinstance(node, ast.Lambda):
            a = node.args
            bound |= {
                p.arg
                for p in a.posonlyargs + a.args + a.kwonlyargs
            }
            if a.vararg:
                bound.add(a.vararg.arg)
            if a.kwarg:
                bound.add(a.kwarg.arg)
            walk_root: "ast.AST" = node.body
        else:  # FunctionDef / AsyncFunctionDef
            a = node.args
            bound |= {
                p.arg
                for p in a.posonlyargs + a.args + a.kwonlyargs
            }
            if a.vararg:
                bound.add(a.vararg.arg)
            if a.kwarg:
                bound.add(a.kwarg.arg)
            walk_root = ast.Module(body=node.body, type_ignores=[])
        for n in ast.walk(walk_root):
            if isinstance(n, ast.Name):
                if isinstance(n.ctx, ast.Store):
                    bound.add(n.id)
                else:
                    loads.add(n.id)
        return loads - bound

    def _check_boundary(self, call: ast.Call, edge: cg.Edge) -> None:
        captured: "set[str]" = set()
        local_defs = self.p.graph.locals_of.get(self.qname, {})
        for arg in cg.closure_args(call, edge.boundary):
            if isinstance(arg, ast.Lambda):
                captured |= self._free_loads(arg) & self.env
            elif isinstance(arg, ast.Name):
                target = local_defs.get(arg.id)
                info = (
                    self.p.graph.funcs.get(target)
                    if target is not None
                    else None
                )
                if info is not None:
                    captured |= self._free_loads(info.node) & self.env
                elif arg.id in self.env:
                    captured.add(arg.id)  # device value passed as data
        # device values passed as plain data args (run_in_executor
        # style) also cross the boundary
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Name) and a.id in self.env:
                captured.add(a.id)
        if captured:
            names = ", ".join(f"'{n}'" for n in sorted(captured))
            self._emit(
                "MTPU503",
                call,
                f"device value {names} crosses a {edge.boundary} "
                "thread-boundary without materialization; the D2H then "
                "happens as a hidden sync on an arbitrary thread — "
                "materialize through a drain seam first, or ship host "
                "data",
            )


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


class _DeviceflowPass:
    def __init__(
        self,
        sources: "dict[str, ParsedModule]",
        graph: cg.CallGraph,
        registry: Registry,
    ):
        self.sources = sources
        self.graph = graph
        self.registry = registry
        self.findings: "list[Finding]" = []
        self.summaries: "dict[str, bool]" = {}
        self.tainted_params: "dict[str, set[str]]" = {}

    # -- driver -----------------------------------------------------------

    def run(self) -> "list[Finding]":
        self._fixpoint()
        for qname in sorted(self.graph.funcs):
            self._analyze(qname, emit=True)
        self._check_loop_reachable()
        self._check_registry_drift()
        self.findings.sort(key=lambda f: f.sort_key())
        return self.findings

    def _analyze(self, qname: str, emit: bool) -> _FuncResult:
        info = self.graph.funcs[qname]
        facts = self.graph.modules.get(info.rel_path)
        seeded = self.tainted_params.get(qname, set())
        body = info.node.body
        if isinstance(info.node, ast.Lambda):
            # a lambda body is one expression: analyze it as a return
            ret = ast.Return(value=body)
            ast.copy_location(ret, body)
            body = [ret]
        interp = _Interp(
            self, qname, facts, body, set(seeded), emit
        )
        res = interp.run()
        if qname in self.registry.entry_qnames:
            res.returns_device = True
        if self.registry.is_drain(qname):
            res.returns_device = False
        return res

    def _fixpoint(self) -> None:
        callers: "dict[str, set[str]]" = {}
        for e in self.graph.edges:
            if e.callee is not None and e.boundary is None:
                callers.setdefault(e.callee, set()).add(e.caller)
        work = deque(sorted(self.graph.funcs))
        queued = set(work)
        while work:
            qname = work.popleft()
            queued.discard(qname)
            res = self._analyze(qname, emit=False)
            if res.returns_device != self.summaries.get(qname, False):
                self.summaries[qname] = res.returns_device
                for caller in callers.get(qname, ()):
                    if caller in self.graph.funcs and caller not in queued:
                        work.append(caller)
                        queued.add(caller)
            for callee, pnames in res.param_out.items():
                cur = self.tainted_params.setdefault(callee, set())
                if pnames - cur:
                    cur |= pnames
                    if callee in self.graph.funcs and callee not in queued:
                        work.append(callee)
                        queued.add(callee)

    # -- MTPU504 ----------------------------------------------------------

    def _check_loop_reachable(self) -> None:
        """Blocking calls in sync functions that run on the event loop
        because a server async def (or a loop-resident closure) calls
        them through plain edges."""
        edges_from = self.graph.edges_from()
        roots = [
            q
            for q, info in self.graph.funcs.items()
            if info.is_async and info.rel_path.startswith(_SERVER_PREFIX)
        ]
        for e in self.graph.boundary_edges():
            if (
                e.boundary in cg.LOOP_RESIDENT_KINDS
                and e.callee in self.graph.funcs
            ):
                roots.append(e.callee)
        first_root: "dict[str, str]" = {}
        work = deque()
        for r in sorted(set(roots)):
            if r not in first_root:
                first_root[r] = r
                work.append(r)
        while work:
            q = work.popleft()
            for e in edges_from.get(q, ()):
                if e.boundary is not None and (
                    e.boundary not in cg.LOOP_RESIDENT_KINDS
                ):
                    continue  # worker-pool bridge: blocking is legal
                callee = e.callee
                if callee in self.graph.funcs and callee not in first_root:
                    first_root[callee] = first_root[q]
                    work.append(callee)
        for qname in sorted(first_root):
            info = self.graph.funcs[qname]
            if info.is_async and info.rel_path.startswith(_SERVER_PREFIX):
                continue  # MTPU108's lexical turf
            root = first_root[qname]
            self._scan_blocking(info, root)

    def _scan_blocking(self, info: cg.FuncInfo, root: str) -> None:
        facts = self.graph.modules.get(info.rel_path)
        awaited = _collect_awaited(info.node) if info.is_async else set()
        nested = self._nested_def_calls(info.node)
        for node in ast.walk(info.node):
            if (
                isinstance(node, ast.Call)
                and id(node) not in awaited
                and id(node) not in nested
            ):
                desc = self._blocking_desc(facts, node)
                if desc is not None:
                    root_name = root.split("::", 1)[-1]
                    self.findings.append(
                        Finding(
                            "MTPU504",
                            info.rel_path,
                            node.lineno,
                            f"{desc} blocks the event loop: "
                            f"{info.name}() runs on the loop (reachable "
                            f"from async {root_name} through plain "
                            "calls) — move the call behind a worker-"
                            "pool boundary or await an async "
                            "equivalent",
                        )
                    )

    @staticmethod
    def _nested_def_calls(func_node: ast.AST) -> "set[int]":
        """ids of Call nodes inside defs nested under ``func_node`` —
        those bodies are their own call-graph nodes and are reached (or
        not) through their own edges."""
        out: "set[int]" = set()
        for node in ast.walk(func_node):
            if node is func_node:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Call):
                        out.add(id(inner))
        return out

    def _blocking_desc(self, facts, call: ast.Call) -> "str | None":
        dotted = _canonical(facts, call.func) or ""
        if dotted in _BLOCK_SLEEPS or dotted == "time.sleep":
            return f"{dotted}()"
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        if attr in _BLOCK_SOCKET_ATTRS:
            return f"raw socket .{attr}()"
        if attr == "result":
            return "Future.result()"
        if attr == "wait" and not dotted.startswith("asyncio."):
            return ".wait()"
        return None

    # -- MTPU505 ----------------------------------------------------------

    def _drift(self, path: str, line: int, msg: str) -> None:
        self.findings.append(Finding("MTPU505", path, line, msg))

    def _check_registry_drift(self) -> None:
        reg = self.registry
        rel_to_short = {v: k for k, v in reg.entry_point_paths.items()}

        # 1. every registered entry point must resolve to a def
        for mod, name in sorted(reg.known_entry_points):
            rel = reg.entry_point_paths.get(mod)
            if rel is None or rel not in self.sources:
                continue  # can't check what we didn't parse
            if self.graph.lookup(rel, name) is None:
                self._drift(
                    rel,
                    1,
                    f"registry drift: KNOWN_ENTRY_POINTS declares "
                    f"{mod}.{name} but no such def exists in {rel}",
                )

        # 2./3. in-place writes: the wrappers' bodies vs
        # IN_PLACE_ENTRY_POINTS, both ways
        mutated = self._in_place_positions()
        registered = {
            (reg.entry_point_paths[m], n): tuple(p)
            for (m, n), p in reg.donating_entry_points.items()
            if reg.entry_point_paths.get(m)
        }
        for mod, name in sorted(reg.known_entry_points):
            rel = reg.entry_point_paths.get(mod)
            if rel is None or rel not in self.sources:
                continue
            info = self.graph.lookup(rel, name)
            if info is None:
                continue
            have = tuple(sorted(mutated.get(info.qname, ())))
            want = registered.get((rel, name), ())
            if have and not want:
                self._drift(
                    rel,
                    info.lineno,
                    f"registry drift: {name} writes argument(s) {have} "
                    "in place but is not in "
                    "kernel_contracts.IN_PLACE_ENTRY_POINTS",
                )
            elif want and have != want:
                self._drift(
                    rel,
                    info.lineno,
                    f"registry drift: IN_PLACE_ENTRY_POINTS registers "
                    f"{name} writing {want} in place but its body writes "
                    f"{have or 'none'}",
                )
        for (rel, name), want in sorted(registered.items()):
            if rel in self.sources and (
                rel_to_short.get(rel), name
            ) not in reg.known_entry_points:
                self._drift(
                    rel,
                    1,
                    f"registry drift: IN_PLACE_ENTRY_POINTS registers "
                    f"{name}, which KNOWN_ENTRY_POINTS does not",
                )

        # 4. mesh kernels: every kind the registry names must be
        # registered with the plan cache (the port's plans write no
        # input in place, and register_kernel's donate_argnums, kept to
        # mirror the JAX table, has no effect, so it is not read)
        seen_kernels: "set[str]" = set()
        for rel, mod in self.sources.items():
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                dotted = _canonical(
                    self.graph.modules.get(rel), node.func
                ) or ""
                if (
                    dotted.endswith("register_kernel")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    seen_kernels.add(node.args[0].value)
        if any(
            rel.startswith("minio_tpu_torch/parallel/")
            for rel in self.sources
        ):
            for kind, want in sorted(reg.mesh_donating.items()):
                if kind not in seen_kernels:
                    self._drift(
                        "minio_tpu_torch/parallel/rules.py",
                        1,
                        f"registry drift: MESH_DONATING_KERNELS registers "
                        f"'{kind}' ({tuple(want)}) but no register_kernel "
                        "call declares it",
                    )

        # 5./6. drain seams: registered names must exist; *_end/drain
        # defs in registered files must be registered
        by_file: "dict[str, set[str]]" = {}
        for qname, info in self.graph.funcs.items():
            by_file.setdefault(info.rel_path, set()).add(info.name)
        for rel, names in sorted(reg.drain_seams.items()):
            if rel not in self.sources:
                continue
            have = by_file.get(rel, set())
            for name in names:
                if name not in have:
                    self._drift(
                        rel,
                        1,
                        f"registry drift: DRAIN_SEAMS registers "
                        f"{name}() in {rel} but no such def exists",
                    )
            registered_names = set(names)
            for qname, info in self.graph.funcs.items():
                if info.rel_path != rel:
                    continue
                n = info.name
                if (
                    n.endswith("_end") or "drain" in n.lower()
                ) and n not in registered_names:
                    self._drift(
                        rel,
                        info.lineno,
                        f"registry drift: {n}() matches the drain-seam "
                        "naming pattern in a DRAIN_SEAMS file but is "
                        "not registered in kernel_contracts.DRAIN_SEAMS",
                    )

    def _in_place_positions(self) -> "dict[str, set[int]]":
        """qname -> caller-side positions each def writes in place: its
        own body's writes, plus arguments it passes on at a position its
        (resolved) callee writes, to a fixpoint."""
        out: "dict[str, set[int]]" = {}
        sites: "list[tuple[str, str, ast.Call]]" = []
        for rel, mod in self.sources.items():
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    e = self.graph.call_info.get(id(node))
                    if (e is not None and e.boundary is None
                            and e.callee is not None):
                        sites.append((e.caller, e.callee, node))
        for qname, info in self.graph.funcs.items():
            if not isinstance(info.node, ast.Lambda):
                own = set(_mutated_params(info).values())
                if own:
                    out[qname] = own
        changed = True
        while changed:
            changed = False
            for caller, callee, call in sites:
                info = self.graph.funcs.get(caller)
                if callee not in out or info is None or isinstance(
                    info.node, ast.Lambda
                ):
                    continue
                mine = {n: i for i, n in enumerate(_param_names(info))}
                for pos in out[callee]:
                    arg = call.args[pos] if pos < len(call.args) else None
                    at = mine.get(arg.id) if isinstance(arg, ast.Name) else None
                    if at is not None and at not in out.get(caller, ()):
                        out.setdefault(caller, set()).add(at)
                        changed = True
        return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceflowReport:
    findings: "list[Finding]"  # pre-suppression
    graph: cg.CallGraph
    seconds: float


def analyze_sources(
    sources: "dict[str, ParsedModule]",
    *,
    registry: "Registry | None" = None,
    graph: "cg.CallGraph | None" = None,
) -> DeviceflowReport:
    """Run the deviceflow pass over parsed modules.

    ``registry`` defaults to the kernel_contracts tables; tests inject
    synthetic registries to drive fixture files.  ``graph`` lets the
    CLI reuse a call graph it already built for --changed-only.
    """
    t0 = time.monotonic()
    if graph is None:
        graph = cg.build(sources)
    reg = registry if registry is not None else Registry.default()
    findings = _DeviceflowPass(sources, graph, reg).run()
    return DeviceflowReport(
        findings=findings,
        graph=graph,
        seconds=time.monotonic() - t0,
    )
