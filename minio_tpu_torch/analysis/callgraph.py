"""Module-qualified interprocedural call graph over the tree.

Every MTPU5xx rule is a whole-program fact ("this device value reaches
a D2H sink *through calls*"), so the deviceflow pass needs one shared
structure the per-file linters never had: who calls whom, across
modules, classes and thread boundaries.  This module builds it from
the shared AST cache:

* **nodes** — every ``def``/``async def`` (and named lambda) in the
  analyzed file set, qualified as ``rel/path.py::Class.method``
  (nested defs become ``outer.<locals>.inner``, the runtime
  ``__qualname__`` convention);
* **edges** — resolved call sites.  Resolution is deliberately
  conservative: module-qualified calls through the import table
  (absolute and relative imports), local and nested names,
  ``self.``/``cls.`` methods through the class index including bases
  defined in the tree, and a last-resort unique-method-name match that
  refuses common stdlib-shaped names.  An unresolvable call produces
  no edge — the dataflow rules under-approximate rather than guess;
* **boundary edges** — calls that move work onto another thread or
  onto the event loop: ``iopool.submit``/``submit_hedged``/
  ``ParityBand.submit``, the worker pool's ``try_submit``/
  ``spawn_stream``, executor ``submit``,
  ``asyncio.run_coroutine_threadsafe``, ``loop.run_in_executor``,
  ``loop.call_soon_threadsafe`` and ``threading.Thread(target=...)``.
  Each records which closure / function object crosses, so deviceflow
  can ask "does a device value ride along?" (MTPU503) and "does
  loop-reachability stop here?" (MTPU504).

Calls that resolve into a project module OUTSIDE the analyzed file set
(fixtures and canaries analyze one file, yet must still see the
``minio_tpu_torch.ops`` entry points) resolve to a synthetic
``path::name`` callee with no node — exactly what the provenance
rules key on.
"""

from __future__ import annotations

import ast
import dataclasses
import time

from .astcache import ParsedModule

# thread/loop boundary call shapes; attr name -> boundary kind.
# "pool"/"executor"/"thread" move the closure OFF the calling thread
# onto a worker; "loop-bridge"/"loop-call" move it ONTO the event loop.
BOUNDARY_SUBMIT_ATTRS = {
    "submit": "pool",
    "submit_hedged": "pool",
    "try_submit": "pool",
    "spawn_stream": "pool",
    "run_in_executor": "executor",
    "call_soon_threadsafe": "loop-call",
}
_LOOP_BRIDGE_NAMES = {"run_coroutine_threadsafe"}

# boundary kinds whose closure still runs ON the event loop (MTPU504
# traverses these; the rest stop loop-reachability)
LOOP_RESIDENT_KINDS = frozenset({"loop-bridge", "loop-call"})

# unique-method-name resolution refuses these: too stdlib-shaped to
# trust a single tree definition (queue.get, fut.result, sock.send...)
_AMBIENT_METHOD_NAMES = frozenset(
    {
        "get", "put", "put_nowait", "get_nowait", "read", "write",
        "close", "open", "flush", "send", "recv", "result", "wait",
        "notify", "notify_all", "acquire", "release", "start", "stop",
        "join", "run", "submit", "cancel", "clear", "set", "add",
        "pop", "append", "extend", "remove", "discard", "update",
        "copy", "keys", "values", "items", "split", "strip", "encode",
        "decode", "format", "count", "index", "sort", "reverse",
        "readline", "seek", "tell", "drain", "connect", "bind",
        "listen", "accept", "shutdown", "item", "sum", "reshape",
        "render", "snapshot", "reset", "name", "loop", "fileno",
    }
)


@dataclasses.dataclass
class FuncInfo:
    """One graph node: a def somewhere in the analyzed file set."""

    qname: str
    rel_path: str
    name: str
    node: "ast.AST"
    is_async: bool
    cls: "str | None"
    lineno: int


@dataclasses.dataclass
class Edge:
    """One resolved (or boundary-recorded) call site."""

    caller: str
    callee: "str | None"
    rel_path: str
    line: int
    boundary: "str | None" = None
    text: str = ""


def module_dotted(rel_path: str) -> str:
    """'minio_tpu_torch/ops/rs.py' -> 'minio_tpu_torch.ops.rs'."""
    p = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def dotted_to_rel(dotted: str) -> str:
    """'minio_tpu_torch.ops.rs' -> 'minio_tpu_torch/ops/rs.py' (module form)."""
    return dotted.replace(".", "/") + ".py"


def _dotted_parts(node: ast.AST) -> "list[str] | None":
    parts: "list[str]" = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


class _ModuleFacts:
    """Per-module symbol tables the resolver consults."""

    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.dotted = module_dotted(rel_path)
        self.is_package = rel_path.endswith("/__init__.py")
        # alias -> dotted target (module or module.symbol)
        self.imports: "dict[str, str]" = {}
        # top-level def name -> qname
        self.functions: "dict[str, str]" = {}
        # class name -> (base names, {method name -> qname})
        self.classes: "dict[str, tuple[list[str], dict[str, str]]]" = {}


# statement kinds whose nested blocks may hold defs worth indexing
_BLOCK_FIELDS = ("body", "orelse", "finalbody", "handlers")


def _child_blocks(stmt: ast.stmt) -> "list[list[ast.stmt]]":
    out = []
    for field in _BLOCK_FIELDS:
        val = getattr(stmt, field, None)
        if not val:
            continue
        if field == "handlers":
            out.extend(h.body for h in val)
        else:
            out.append(val)
    return out


class CallGraph:
    def __init__(self):
        self.funcs: "dict[str, FuncInfo]" = {}
        self.edges: "list[Edge]" = []
        # id(ast.Call) -> Edge, for the dataflow pass walking the same
        # cached trees
        self.call_info: "dict[int, Edge]" = {}
        self.modules: "dict[str, _ModuleFacts]" = {}
        # enclosing qname -> {nested def name -> qname}
        self.locals_of: "dict[str, dict[str, str]]" = {}
        # method name -> [qname, ...] across every class in the tree
        self._methods_by_name: "dict[str, list[str]]" = {}
        # class name -> [(rel_path, class name), ...]
        self._classes_by_name: "dict[str, list[tuple[str, str]]]" = {}
        self.build_seconds = 0.0

    # -- queries ----------------------------------------------------------

    def lookup(self, rel_path: str, name: str) -> "FuncInfo | None":
        """A def node by file + qualified name."""
        return self.funcs.get(f"{rel_path}::{name}")

    def resolve_short(self, short_mod: str, name: str) -> "FuncInfo | None":
        """Registry-style lookup via kernel_contracts short module name."""
        from .kernel_contracts import ENTRY_POINT_PATHS

        rel = ENTRY_POINT_PATHS.get(short_mod)
        if rel is None:
            return None
        return self.lookup(rel, name)

    def boundary_edges(self) -> "list[Edge]":
        return [e for e in self.edges if e.boundary is not None]

    def stats(self) -> dict:
        return {
            "nodes": len(self.funcs),
            "edges": len(self.edges),
            "boundary_edges": len(self.boundary_edges()),
            "seconds": round(self.build_seconds, 3),
        }

    def edges_from(self) -> "dict[str, list[Edge]]":
        out: "dict[str, list[Edge]]" = {}
        for e in self.edges:
            out.setdefault(e.caller, []).append(e)
        return out

    def reverse_file_closure(self, changed: "set[str]") -> "set[str]":
        """Changed files plus every file that (transitively) calls into
        them — the sound trigger set for --changed-only: a deep finding
        in a CALLER can appear or vanish when its callee is edited."""
        rev: "dict[str, set[str]]" = {}
        for e in self.edges:
            if e.callee is None or e.callee == "<multi>":
                continue
            callee_file = e.callee.split("::", 1)[0]
            if callee_file != e.rel_path:
                rev.setdefault(callee_file, set()).add(e.rel_path)
        out = set(changed)
        work = list(changed)
        while work:
            f = work.pop()
            for caller_file in rev.get(f, ()):
                if caller_file not in out:
                    out.add(caller_file)
                    work.append(caller_file)
        return out


# ---------------------------------------------------------------------------
# pass 1: symbol tables
# ---------------------------------------------------------------------------


def _collect_module_facts(graph: CallGraph, mod: ParsedModule) -> None:
    facts = _ModuleFacts(mod.rel_path)
    graph.modules[mod.rel_path] = facts
    if mod.tree is None:
        return
    pkg_parts = facts.dotted.split(".")

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    facts.imports[alias.asname] = alias.name
                else:
                    head = alias.name.split(".", 1)[0]
                    facts.imports[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: level 1 is the containing package
                # (the package itself for an __init__), each extra
                # level walks one parent up
                drop = node.level - (1 if facts.is_package else 0)
                base = pkg_parts[: len(pkg_parts) - drop]
                prefix = ".".join(
                    base + ([node.module] if node.module else [])
                )
            else:
                prefix = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                facts.imports[name] = (
                    f"{prefix}.{alias.name}" if prefix else alias.name
                )

    def add_func(node, qual, cls):
        qname = f"{mod.rel_path}::{qual}"
        graph.funcs[qname] = FuncInfo(
            qname=qname,
            rel_path=mod.rel_path,
            name=qual.rsplit(".", 1)[-1],
            node=node,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            cls=cls,
            lineno=node.lineno,
        )
        return qname

    def register(node, name, func_qual, cls):
        """Index one def/lambda found in the current scope."""
        if func_qual is not None:
            qual = f"{func_qual}.<locals>.{name}"
            qname = add_func(node, qual, None)
            graph.locals_of.setdefault(
                f"{mod.rel_path}::{func_qual}", {}
            )[name] = qname
        elif cls is not None:
            qual = f"{cls}.{name}"
            qname = add_func(node, qual, cls)
            facts.classes[cls][1][name] = qname
            graph._methods_by_name.setdefault(name, []).append(qname)
        else:
            qual = name
            qname = add_func(node, qual, None)
            facts.functions[name] = qname
        return qual

    def walk_block(body, func_qual, cls):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = register(node, node.name, func_qual, cls)
                walk_block(node.body, qual, None)
            elif isinstance(node, ast.ClassDef):
                bases = []
                for b in node.bases:
                    parts = _dotted_parts(b)
                    if parts:
                        bases.append(parts[-1])
                facts.classes.setdefault(node.name, (bases, {}))
                graph._classes_by_name.setdefault(node.name, []).append(
                    (mod.rel_path, node.name)
                )
                walk_block(node.body, None, node.name)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Lambda
            ):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        register(node.value, tgt.id, func_qual, cls)
            else:
                for block in _child_blocks(node):
                    walk_block(block, func_qual, cls)

    walk_block(mod.tree.body, None, None)


# ---------------------------------------------------------------------------
# pass 2: edges
# ---------------------------------------------------------------------------


class _Resolver:
    """Resolves call expressions inside one module."""

    def __init__(self, graph: CallGraph, facts: _ModuleFacts):
        self.graph = graph
        self.facts = facts

    def _resolve_symbol(self, dotted: str) -> "str | None":
        """'minio_tpu_torch.ops.kernels.encode_pack' -> qname; synthetic when the
        module lives outside the analyzed file set."""
        if "." not in dotted or not dotted.startswith("minio_tpu_torch"):
            return None
        mod_dotted, sym = dotted.rsplit(".", 1)
        rel = dotted_to_rel(mod_dotted)
        mod_facts = self.graph.modules.get(rel)
        if mod_facts is None:
            pkg_rel = mod_dotted.replace(".", "/") + "/__init__.py"
            mod_facts = self.graph.modules.get(pkg_rel)
        if mod_facts is not None:
            return mod_facts.functions.get(sym)
        return f"{rel}::{sym}"

    def _resolve_in_class(self, cls_name, attr, seen=None) -> "str | None":
        seen = set() if seen is None else seen
        if cls_name in seen:
            return None
        seen.add(cls_name)
        for rel, cname in self.graph._classes_by_name.get(cls_name, []):
            facts = self.graph.modules.get(rel)
            if facts is None:
                continue
            bases, methods = facts.classes.get(cname, ([], {}))
            qn = methods.get(attr)
            if qn is not None:
                return qn
            for b in bases:
                qn = self._resolve_in_class(b, attr, seen)
                if qn is not None:
                    return qn
        return None

    def _resolve_unique_method(self, attr: str) -> "str | None":
        if attr in _AMBIENT_METHOD_NAMES:
            return None
        hits = self.graph._methods_by_name.get(attr, [])
        if len(hits) == 1:
            return hits[0]
        return None

    def resolve(
        self,
        call_func: ast.AST,
        enclosing_cls: "str | None",
        local_defs: "dict[str, str]",
    ) -> "str | None":
        if isinstance(call_func, ast.Name):
            name = call_func.id
            if name in local_defs:
                return local_defs[name]
            if name in self.facts.functions:
                return self.facts.functions[name]
            target = self.facts.imports.get(name)
            if target is not None:
                return self._resolve_symbol(target)
            return None
        parts = _dotted_parts(call_func)
        if parts is None:
            return None
        attr = parts[-1]
        head = parts[0]
        if head in ("self", "cls"):
            if enclosing_cls is not None and len(parts) == 2:
                qn = self._resolve_in_class(enclosing_cls, attr)
                if qn is not None:
                    return qn
            if len(parts) == 2:
                return self._resolve_unique_method(attr)
            return None
        target = self.facts.imports.get(head)
        if target is not None:
            dotted = ".".join([target] + parts[1:])
            qn = self._resolve_symbol(dotted)
            if qn is not None:
                return qn
        if len(parts) == 2:
            return self._resolve_unique_method(attr)
        return None


def boundary_kind(call: ast.Call) -> "str | None":
    """The boundary class of a call node, or None for a plain call."""
    fn = call.func
    parts = _dotted_parts(fn)
    last = parts[-1] if parts else None
    if last in _LOOP_BRIDGE_NAMES:
        return "loop-bridge"
    if isinstance(fn, ast.Attribute) and fn.attr in BOUNDARY_SUBMIT_ATTRS:
        return BOUNDARY_SUBMIT_ATTRS[fn.attr]
    if last == "Thread" and any(
        kw.arg == "target" for kw in call.keywords
    ):
        return "thread"
    return None


def closure_args(call: ast.Call, kind: str) -> "list[ast.AST]":
    """The argument expressions that cross the boundary as code: every
    lambda, name, 2-part attribute ref (bound method) or nested call
    among the args, plus the ``target=`` kwarg of a Thread."""
    out: "list[ast.AST]" = []
    for a in call.args:
        if isinstance(a, (ast.Lambda, ast.Name, ast.Call)):
            out.append(a)
        elif isinstance(a, ast.Attribute) and isinstance(
            a.value, ast.Name
        ):
            out.append(a)
    for kw in call.keywords:
        if kw.arg == "target" and kind == "thread":
            out.append(kw.value)
    return out


class _EdgeCollector(ast.NodeVisitor):
    def __init__(self, graph: CallGraph, facts: _ModuleFacts):
        self.graph = graph
        self.facts = facts
        self.resolver = _Resolver(graph, facts)
        self._module_qname = f"{facts.rel_path}::<module>"
        self._func_stack: "list[str]" = []  # qual (no rel prefix)
        self._cls_stack: "list[str]" = []

    def _caller(self) -> str:
        if self._func_stack:
            return f"{self.facts.rel_path}::{self._func_stack[-1]}"
        return self._module_qname

    def _local_defs(self) -> "dict[str, str]":
        return self.graph.locals_of.get(self._caller(), {})

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_func(self, node) -> None:
        if self._func_stack:
            qual = f"{self._func_stack[-1]}.<locals>.{node.name}"
        elif self._cls_stack:
            qual = f"{self._cls_stack[-1]}.{node.name}"
        else:
            qual = node.name
        self._func_stack.append(qual)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        caller = self._caller()
        cls = self._cls_stack[-1] if self._cls_stack else None
        local_defs = self._local_defs()
        kind = boundary_kind(node)
        text = ast.unparse(node.func) if hasattr(ast, "unparse") else ""
        if kind is None:
            callee = self.resolver.resolve(node.func, cls, local_defs)
            if callee is not None:
                edge = Edge(
                    caller, callee, self.facts.rel_path, node.lineno,
                    None, text,
                )
                self.graph.edges.append(edge)
                self.graph.call_info[id(node)] = edge
        else:
            resolved = []
            for arg in closure_args(node, kind):
                if isinstance(arg, ast.Call):
                    target = self.resolver.resolve(
                        arg.func, cls, local_defs
                    )
                elif isinstance(arg, ast.Lambda):
                    target = None  # analyzed in place at the call site
                else:
                    target = self.resolver.resolve(arg, cls, local_defs)
                if target is not None:
                    resolved.append(target)
            for target in resolved:
                self.graph.edges.append(
                    Edge(
                        caller, target, self.facts.rel_path,
                        node.lineno, kind, text,
                    )
                )
            # always record the boundary site itself, resolved or not:
            # MTPU503 keys on the call node, and the coverage test
            # asserts no submit site goes unrecorded
            edge = Edge(
                caller,
                resolved[0] if resolved else None,
                self.facts.rel_path,
                node.lineno,
                kind,
                text,
            )
            if not resolved:
                self.graph.edges.append(edge)
            self.graph.call_info[id(node)] = edge
        self.generic_visit(node)


def build(sources: "dict[str, ParsedModule]") -> CallGraph:
    """Build the call graph for a set of parsed modules."""
    t0 = time.monotonic()
    graph = CallGraph()
    for mod in sources.values():
        _collect_module_facts(graph, mod)
    for mod in sources.values():
        if mod.tree is None:
            continue
        _EdgeCollector(graph, graph.modules[mod.rel_path]).visit(mod.tree)
    graph.build_seconds = time.monotonic() - t0
    return graph
