"""ABI contract checker: the port's two ctypes seams (MTPU4xx).

The port's kernels are hand-written CUDA C++ (``csrc/codec.cu``,
``csrc/select.cu``) built into one library and reached through ctypes
bindings in ``ops/kernels.py`` (``_load``) and ``ops/select_step.py``
(``bind``); the native CPU codec (``csrc/gf_cpu.cc``) is a library of
its own, bound in ``utils/native.py`` (``lib``).  Each seam is checked
on its own (``SEAMS``).  None of the other passes can see across that
boundary: an
argtypes list that drifts from the C signature corrupts memory
silently, and a length computed from the wrong tensor is an
out-of-bounds access the type system never sees.  This pass
cross-checks the two sides statically:

* MTPU401 - arity drift: the ctypes ``argtypes`` list has a different
  length than the export's C parameter list (or than its ``@ctypes``
  annotation);
* MTPU402 - argtypes/restype drift: the binding's ctypes signature, or
  the export's ``// @ctypes`` annotation, differs from the ctypes that
  the C prototype's own types map to (``C_TO_CTYPES``);
* MTPU403 - orphan: an exported symbol with no ctypes binding, or a
  binding for a symbol the library does not export;
* MTPU404 - length/pointer mismatch: a tensor's ``.data_ptr()`` passed
  to a launch - directly, or packed into its argument struct by a
  ``struct.Struct(...).pack`` call - alongside a length whose value
  provably derives from a *different* tensor's ``.shape``/``.numel()``;
* MTPU405 - unchecked buffer: a tensor reaches ``.data_ptr()`` without
  contiguity evidence on its def-use chain: ``.contiguous()``, a fresh
  allocation, a ``_require_*`` check (they raise on a non-contiguous
  tensor) or an ``is_contiguous()`` test.  A private helper's parameter
  counts as checked when every call to it in its module passes a
  checked tensor there.

The C side is parsed from the ``extern "C"`` blocks: each parameter's C
type maps to the ctypes that may carry it (a pointer to a struct is the
packed argument bytes, ``c_char_p``; any other pointer an address,
``c_void_p``).  Each export also carries a ``// @ctypes name(argtypes...)
-> restype`` annotation comment, the signature a reader of the source
sees; it is held against the prototype too, so it cannot drift with the
binding.  The Python side is parsed from
the AST: any ``<lib>.<symbol>.argtypes / .restype`` assignment is a
binding, as is one made in a ``for fn in (lib.a, lib.b): fn.argtypes =
...`` loop, with local aliases (``P = ctypes.c_void_p``) resolved.

Both sides are pure text/AST analysis - the pass never compiles or
loads the library, so it runs anywhere the lint pass runs.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from .findings import Finding, filter_suppressed

# the kernel library's seam: two binding modules and the two sources that
# build into the one library; fixtures route through analyze() instead
PY_RELS = (
    "minio_tpu_torch/ops/kernels.py",
    "minio_tpu_torch/ops/select_step.py",
)
CC_RELS = (
    "minio_tpu_torch/csrc/codec.cu",
    "minio_tpu_torch/csrc/select.cu",
)
# the native CPU codec's seam: its loader and its one source
NATIVE_PY_RELS = ("minio_tpu_torch/utils/native.py",)
NATIVE_CC_RELS = ("minio_tpu_torch/csrc/gf_cpu.cc",)
# (binding modules, sources) of each library: exports and bindings are
# matched within a seam, never across two
SEAMS = ((PY_RELS, CC_RELS), (NATIVE_PY_RELS, NATIVE_CC_RELS))

# ---------------------------------------------------------------------------
# C side: extern "C" export table + @ctypes annotations
# ---------------------------------------------------------------------------

# args capture is greedy: nested parens (POINTER(c_void_p)) end before
# the final `) ->`, and annotations are single-line comments.
_ANNOT_RE = re.compile(
    r"//\s*@ctypes\s+(?P<name>[A-Za-z_]\w*)\s*\((?P<args>.*)\)"
    r"\s*->\s*(?P<restype>[\w()]+)"
)

# a definition inside the extern block: `<type words> <name>(<params>) {`
# anchored at line start so control flow (`for (...) {`) cannot match —
# those have a single identifier before the paren, this needs two.
_FUNC_RE = re.compile(
    r"^[ \t]*(?!//)(?P<ret>[A-Za-z_][A-Za-z0-9_ \t*]*?)\b"
    r"(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^)]*)\)\s*\{",
    re.M | re.S,
)


# C scalar types -> the ctypes names that carry them (aliases included:
# c_int64 is c_long on LP64, c_longlong by name)
_INT = frozenset({"c_int", "c_int32"})
_UINT = frozenset({"c_uint", "c_uint32"})
_I64 = frozenset({"c_int64", "c_longlong"})
_U64 = frozenset({"c_uint64", "c_ulonglong"})
_U8 = frozenset({"c_uint8", "c_ubyte"})
C_TO_CTYPES: "dict[str, frozenset[str]]" = {
    "uint8_t": _U8, "unsigned char": _U8,
    "int": _INT, "int32_t": _INT, "unsigned": _UINT, "unsigned int": _UINT,
    "uint32_t": _UINT, "long long": _I64, "int64_t": _I64,
    "unsigned long long": _U64, "uint64_t": _U64,
    "size_t": frozenset({"c_size_t"}), "float": frozenset({"c_float"}),
    "double": frozenset({"c_double"}), "void": frozenset({"None"}),
}
# pointees that make a pointer a plain address; any other named type is
# a struct, passed as its packed bytes
_ADDRESS_POINTEES = frozenset(C_TO_CTYPES) | {
    "uint8_t", "int8_t", "uint16_t", "int16_t", "unsigned char"}
_QUALIFIERS = frozenset({"const", "volatile", "restrict", "__restrict__",
                         "struct"})


def c_type_ctypes(decl: str, named: bool = True) -> "frozenset[str] | None":
    """The ctypes names that may carry a C declaration (``const uint32_t*
    words``; with ``named`` False a bare type, a return type), or None
    when its type is not in the table."""
    words = [w for w in re.findall(r"[A-Za-z_]\w*", decl)
             if w not in _QUALIFIERS]
    if named and len(words) > 1:
        words = words[:-1]
    base = " ".join(words)
    if decl.count("*") > 1:
        # an array of row addresses (``const uint8_t* const* in``)
        return (frozenset({"POINTER(c_void_p)"})
                if base in _ADDRESS_POINTEES else None)
    if "*" in decl:
        if base == "char":
            return frozenset({"c_char_p"})
        return frozenset({"c_void_p"} if base in _ADDRESS_POINTEES
                         else {"c_char_p"})
    return C_TO_CTYPES.get(base)


@dataclasses.dataclass
class Export:
    """One ``extern "C"`` function, the ctypes its C types map to, and
    its ``@ctypes`` annotation."""

    name: str
    line: int  # def line in the source file
    c_arity: int
    c_args: "list[frozenset[str] | None]" = dataclasses.field(
        default_factory=list)
    c_restype: "frozenset[str] | None" = None
    annot_args: "list[str] | None" = None
    annot_restype: "str | None" = None
    annot_line: int = 0
    path: str = ""


def _split_args(text: str) -> "list[str]":
    """Split an arg list on top-level commas (POINTER(...) stays whole)."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _extern_c_block(text: str) -> "tuple[str, int]":
    """The extern "C" { ... } body and the line offset of its start."""
    m = re.search(r'extern\s+"C"\s*\{', text)
    if m is None:
        return "", 0
    start = m.end()
    depth = 1
    i = start
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[start:i], text[:start].count("\n")


def parse_exports(cc_text: str, cc_rel: str = "") -> "dict[str, Export]":
    """Name -> Export for every function in the extern "C" block."""
    block, line0 = _extern_c_block(cc_text)
    annots: "dict[str, tuple[list[str], str, int]]" = {}
    for m in _ANNOT_RE.finditer(block):
        annots[m.group("name")] = (
            _split_args(m.group("args")),
            m.group("restype").strip(),
            line0 + block[: m.start()].count("\n") + 1,
        )
    exports: "dict[str, Export]" = {}
    for m in _FUNC_RE.finditer(block):
        name = m.group("name")
        params = m.group("params").strip()
        decls = [] if params in ("", "void") else _split_args(params)
        exp = Export(
            name=name,
            line=line0 + block[: m.start()].count("\n") + 1,
            c_arity=len(decls),
            c_args=[c_type_ctypes(d) for d in decls],
            c_restype=c_type_ctypes(m.group("ret"), named=False),
            path=cc_rel,
        )
        if name in annots:
            exp.annot_args, exp.annot_restype, exp.annot_line = annots[name]
        exports[name] = exp
    return exports


# ---------------------------------------------------------------------------
# Python side: ctypes binding assignments
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Binding:
    """ctypes signature assignments for one symbol in a loader."""

    name: str
    argtypes: "list[str] | None" = None
    argtypes_line: int = 0
    restype: "str | None" = None
    restype_line: int = 0
    path: str = ""

    @property
    def anchor(self) -> int:
        return self.argtypes_line or self.restype_line or 1


def _canon(node: ast.AST, aliases: "dict[str, str]") -> str:
    """A ctypes expression as annotation-comparable text, with local
    aliases (``P = ctypes.c_void_p``) resolved."""
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    return ast.unparse(node).replace("ctypes.", "").replace(" ", "")


def _ctypes_aliases(tree: ast.AST) -> "dict[str, str]":
    """Names bound to a ``ctypes.X`` attribute, one by one or by tuple
    (``P, I = ctypes.c_void_p, ctypes.c_int``)."""
    out: "dict[str, str]" = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs = []
        if isinstance(tgt, ast.Name):
            pairs = [(tgt, val)]
        elif isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) and (
                len(tgt.elts) == len(val.elts)):
            pairs = list(zip(tgt.elts, val.elts))
        for t, v in pairs:
            if (isinstance(t, ast.Name) and isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name)
                    and v.value.id == "ctypes"):
                out[t.id] = v.attr
    return out


def parse_bindings(py_tree: ast.AST, py_rel: str = "") -> "dict[str, Binding]":
    """Every ``<obj>.<symbol>.argtypes / .restype`` assignment, and the
    ones a ``for fn in (<obj>.a, <obj>.b): fn.argtypes = ...`` loop
    makes for each symbol it walks."""
    aliases = _ctypes_aliases(py_tree)
    bindings: "dict[str, Binding]" = {}

    def bind(sym: str, attr: str, value: ast.AST, line: int) -> None:
        b = bindings.setdefault(sym, Binding(name=sym, path=py_rel))
        if attr == "argtypes":
            b.argtypes_line = line
            if isinstance(value, (ast.List, ast.Tuple)):
                b.argtypes = [_canon(e, aliases) for e in value.elts]
        else:
            b.restype_line = line
            b.restype = _canon(value, aliases)

    loops: "dict[int, tuple[str, list[str]]]" = {}
    for node in ast.walk(py_tree):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and isinstance(node.iter, (ast.Tuple, ast.List))
                and all(isinstance(e, ast.Attribute) for e in node.iter.elts)):
            syms = [e.attr for e in node.iter.elts]
            for sub in ast.walk(node):
                loops[id(sub)] = (node.target.id, syms)
    for node in ast.walk(py_tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and tgt.attr in ("argtypes", "restype")):
            continue
        if isinstance(tgt.value, ast.Attribute):
            bind(tgt.value.attr, tgt.attr, node.value, node.lineno)
        elif isinstance(tgt.value, ast.Name) and id(node) in loops:
            var, syms = loops[id(node)]
            if tgt.value.id == var:
                for sym in syms:
                    bind(sym, tgt.attr, node.value, node.lineno)
    return bindings


# ---------------------------------------------------------------------------
# MTPU404 / MTPU405: tensor pointer/length data-flow over the callers
# ---------------------------------------------------------------------------

# methods that hand back a fresh (contiguous) allocation whatever the
# receiver's layout
_ALLOCATING_METHODS = ("contiguous", "new_empty", "new_zeros", "new_ones",
                       "new_full")
# shape reads whose value is a length of the receiver
_SHAPE_ATTRS = ("shape",)
_SHAPE_METHODS = ("numel", "size", "dim")


def _data_ptr_base(node: ast.AST) -> "ast.AST | None":
    """The tensor expression X of an ``X.data_ptr()`` call."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "data_ptr"
        and not node.args
    ):
        return node.func.value
    return None


def _call_name(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")


class _BufferFlow:
    """Per-function provenance walk behind MTPU404/405.

    Deliberately sequential (loop/branch bodies visited once, in order)
    - the launch wrappers it audits are straight-line code, and a
    heuristic that over-approximates provenance only ever *misses* a
    mismatch, it cannot invent one.  ``safe_params`` are parameters
    every in-module call site passes a checked tensor at; ``sites``
    collects, for each call to a module function, which positions this
    body passes checked.
    """

    def __init__(self, rel_path: str, findings: "list[Finding]",
                 local_funcs: "dict[str, ast.FunctionDef]",
                 safe_params: "dict[str, set[str]]",
                 sites: "dict[str, list[set[str]]]"):
        self.rel = rel_path
        self.findings = findings
        self.local_funcs = local_funcs
        self.safe_params = safe_params
        self.sites = sites
        # var -> the original tensor names its value derives from
        self.roots: "dict[str, set[str]]" = {}
        # var -> tensor names whose shape its value derives from
        self.shape_src: "dict[str, set[str]]" = {}
        # var -> tensor names whose data_ptr its value holds
        self.ptr_src: "dict[str, set[str]]" = {}
        # parameter-rooted names with no contiguity evidence yet
        self.unsafe: "set[str]" = set()

    # -- provenance helpers --------------------------------------------

    def _name_roots(self, node: ast.AST) -> "set[str]":
        out: "set[str]" = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                out |= self.roots.get(n.id, {n.id})
        return out

    def _shape_roots(self, node: ast.AST) -> "set[str]":
        out: "set[str]" = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr in _SHAPE_ATTRS:
                out |= self._name_roots(n.value)
            elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                  and n.func.attr in _SHAPE_METHODS):
                out |= self._name_roots(n.func.value)
            elif isinstance(n, ast.Name):
                out |= self.shape_src.get(n.id, set())
        return out

    def _ptr_roots(self, node: ast.AST) -> "set[str]":
        out: "set[str]" = set()
        for n in ast.walk(node):
            base = _data_ptr_base(n)
            if base is not None:
                out |= self._name_roots(base)
            elif isinstance(n, ast.Name):
                out |= self.ptr_src.get(n.id, set())
        return out

    def _expr_unsafe(self, node: ast.AST) -> bool:
        """Does this tensor's layout trace back to an unchecked
        parameter?"""
        if isinstance(node, ast.Name):
            return node.id in self.unsafe
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self._expr_unsafe(node.value)
        if isinstance(node, ast.Call):
            # a method call inherits its receiver's layout (a reshape or
            # slice of a raw parameter can be non-contiguous), except the
            # allocating ones; plain calls (torch.empty, helpers)
            # allocate fresh tensors
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _ALLOCATING_METHODS:
                    return False
                return self._expr_unsafe(node.func.value)
            return False
        if isinstance(node, ast.IfExp):
            return self._expr_unsafe(node.body) or self._expr_unsafe(
                node.orelse)
        return False

    def _discharge(self, node: "ast.AST | None") -> None:
        """Contiguity evidence inside ``node``: a ``_require_*`` check of
        named tensors, or an ``is_contiguous()`` test of one."""
        if node is None:
            return
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if name.startswith("_require"):
                for a in n.args:
                    if isinstance(a, ast.Name):
                        self.unsafe.discard(a.id)
            elif (name == "is_contiguous"
                  and isinstance(n.func, ast.Attribute)
                  and isinstance(n.func.value, ast.Name)):
                self.unsafe.discard(n.func.value.id)

    # -- statement walk ------------------------------------------------

    def run(self, fn: ast.FunctionDef) -> None:
        args = fn.args
        params = [
            a.arg
            for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            )
        ]
        safe = self.safe_params.get(fn.name, set())
        self.roots = {p: {p} for p in params}
        self.shape_src = {}
        self.ptr_src = {}
        self.unsafe = set(params) - safe
        self._body(fn.body)

    def _assign(self, targets: "list[ast.AST]", value: ast.AST) -> None:
        pairs: "list[tuple[ast.AST, ast.AST]]" = []
        for t in targets:
            if (isinstance(t, ast.Tuple) and isinstance(value, ast.Tuple)
                    and len(t.elts) == len(value.elts)):
                pairs.extend(zip(t.elts, value.elts))
            else:
                pairs.append((t, value))
        for t, v in pairs:
            roots = self._name_roots(v)
            shape = self._shape_roots(v)
            ptrs = self._ptr_roots(v)
            unsafe = self._expr_unsafe(v)
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    self.roots[n.id] = roots
                    self.shape_src[n.id] = shape
                    self.ptr_src[n.id] = ptrs
                    if unsafe:
                        self.unsafe.add(n.id)
                    else:
                        self.unsafe.discard(n.id)

    def _record_site(self, call: ast.Call) -> None:
        callee = self.local_funcs.get(
            call.func.id if isinstance(call.func, ast.Name) else "")
        if callee is None:
            return
        a = callee.args
        names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
        safe = set()
        for i, arg in enumerate(call.args):
            if i < len(names) and not self._expr_unsafe(arg):
                safe.add(names[i])
        for kw in call.keywords:
            if kw.arg is not None and not self._expr_unsafe(kw.value):
                safe.add(kw.arg)
        self.sites.setdefault(callee.name, []).append(safe)

    def _check_calls(self, node: "ast.AST | None") -> None:
        if node is None:
            return
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            self._record_site(call)
            base = _data_ptr_base(call)
            if base is not None:
                if self._expr_unsafe(base):
                    self.findings.append(
                        Finding(
                            "MTPU405",
                            self.rel,
                            call.lineno,
                            f"tensor {ast.unparse(base)} reaches "
                            ".data_ptr() with no contiguity evidence "
                            "(.contiguous() / a fresh allocation / a "
                            "_require_* check / is_contiguous())",
                        )
                    )
                continue
            ptr_roots: "set[str]" = set()
            ptr_args: "set[int]" = set()
            for i, a in enumerate(call.args):
                r = self._ptr_roots(a)
                if r:
                    ptr_roots |= r
                    ptr_args.add(i)
            if not ptr_roots:
                continue
            for i, arg in enumerate(call.args):
                if i in ptr_args:
                    continue
                sroots = self._shape_roots(arg)
                if sroots and sroots.isdisjoint(ptr_roots):
                    self.findings.append(
                        Finding(
                            "MTPU404",
                            self.rel,
                            call.lineno,
                            f"length argument #{i + 1} "
                            f"({ast.unparse(arg)}) derives from "
                            f"{sorted(sroots)} but the tensor pointers "
                            f"come from {sorted(ptr_roots)}",
                        )
                    )

    def _body(self, stmts: "list[ast.stmt]") -> None:
        for st in stmts:
            if isinstance(st, ast.Assign):
                self._check_calls(st.value)
                self._assign(st.targets, st.value)
                self._discharge(st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._check_calls(st.value)
                self._assign([st.target], st.value)
                self._discharge(st.value)
            elif isinstance(st, ast.AugAssign):
                self._check_calls(st.value)
            elif isinstance(st, ast.Assert):
                self._discharge(st.test)
            elif isinstance(st, ast.For):
                self._check_calls(st.iter)
                self._assign([st.target], st.iter)
                self._body(st.body)
                self._body(st.orelse)
            elif isinstance(st, (ast.If, ast.While)):
                self._check_calls(st.test)
                self._discharge(st.test)
                self._body(st.body)
                self._body(st.orelse)
            elif isinstance(st, ast.With):
                self._body(st.body)
            elif isinstance(st, ast.Try):
                self._body(st.body)
                for h in st.handlers:
                    self._body(h.body)
                self._body(st.orelse)
                self._body(st.finalbody)
            elif isinstance(st, ast.Expr):
                self._check_calls(st.value)
                self._discharge(st.value)
            elif isinstance(st, ast.Return):
                self._check_calls(st.value)
            elif isinstance(st, ast.FunctionDef):
                _BufferFlow(self.rel, self.findings, self.local_funcs,
                            {}, {}).run(st)
            else:
                self._check_calls(st)


def _buffer_findings(tree: ast.Module, rel: str) -> "list[Finding]":
    """MTPU404/405 over one module's functions.  A private function's
    parameter is checked when every call to it in the module passes a
    checked tensor there; the sites are gathered to a fixpoint first."""
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    safe: "dict[str, set[str]]" = {}
    for _ in range(4):
        sites: "dict[str, list[set[str]]]" = {}
        for fn in funcs.values():
            _BufferFlow(rel, [], funcs, safe, sites).run(fn)
        new = {
            name: set.intersection(*got)
            for name, got in sites.items()
            if name.startswith("_") and got
        }
        if new == safe:
            break
        safe = new
    findings: "list[Finding]" = []
    for fn in funcs.values():
        _BufferFlow(rel, findings, funcs, safe, {}).run(fn)
    return findings


# ---------------------------------------------------------------------------
# cross-checks + entry points
# ---------------------------------------------------------------------------


def _check_cross(
    exports: "dict[str, Export]",
    bindings: "dict[str, Binding]",
    findings: "list[Finding]",
) -> None:
    py_rels = sorted({b.path for b in bindings.values()}) or ["?"]
    cc_rels = sorted({e.path for e in exports.values()}) or ["?"]
    for name, exp in sorted(exports.items()):
        unmapped = [f"#{i + 1}" for i, t in enumerate(exp.c_args)
                    if t is None] + ([] if exp.c_restype else ["the return"])
        if unmapped:
            findings.append(
                Finding(
                    "MTPU402",
                    exp.path,
                    exp.line,
                    f"{name}: no ctypes mapping for the C type of "
                    f"{', '.join(unmapped)} (add it to C_TO_CTYPES)",
                )
            )
        b = bindings.get(name)
        if b is None:
            findings.append(
                Finding(
                    "MTPU403",
                    exp.path,
                    exp.line,
                    f"exported symbol {name} has no ctypes binding in "
                    f"{' or '.join(py_rels)}",
                )
            )
            continue
        if exp.annot_args is not None and len(exp.annot_args) != exp.c_arity:
            findings.append(
                Finding(
                    "MTPU401",
                    exp.path,
                    exp.line,
                    f"@ctypes annotation for {name} declares "
                    f"{len(exp.annot_args)} argument(s) but the C "
                    f"signature has {exp.c_arity}",
                )
            )
        bound_arity = len(b.argtypes) if b.argtypes is not None else 0
        if bound_arity != exp.c_arity:
            findings.append(
                Finding(
                    "MTPU401",
                    b.path,
                    b.anchor,
                    f"binding for {name} declares {bound_arity} "
                    f"argtypes but the export takes {exp.c_arity} "
                    "parameter(s)",
                )
            )
        elif b.argtypes is not None:
            bad = _drift(b.argtypes, exp.c_args)
            if bad:
                findings.append(
                    Finding(
                        "MTPU402",
                        b.path,
                        b.argtypes_line,
                        f"argtypes drift for {name} vs its C prototype "
                        f"({bad})",
                    )
                )
        got = b.restype if b.restype is not None else "c_int"
        if exp.c_restype is not None and got not in exp.c_restype:
            findings.append(
                Finding(
                    "MTPU402",
                    b.path,
                    b.restype_line or b.anchor,
                    f"restype drift for {name}: bound {got}, the C "
                    f"prototype returns {'/'.join(sorted(exp.c_restype))} "
                    "(unset restype defaults to c_int)",
                )
            )
        annot = []
        if (exp.annot_args is not None
                and len(exp.annot_args) == exp.c_arity):
            annot.append(_drift(exp.annot_args, exp.c_args))
        if (exp.annot_restype is not None and exp.c_restype is not None
                and exp.annot_restype not in exp.c_restype):
            annot.append(f"returns {exp.annot_restype}")
        if any(annot):
            findings.append(
                Finding(
                    "MTPU402",
                    exp.path,
                    exp.annot_line or exp.line,
                    f"@ctypes annotation for {name} drifts from its C "
                    f"prototype ({'; '.join(a for a in annot if a)})",
                )
            )
    for name, b in sorted(bindings.items()):
        if name not in exports:
            findings.append(
                Finding(
                    "MTPU403",
                    b.path,
                    b.anchor,
                    f"ctypes binding for {name} has no exported symbol "
                    f"in {' or '.join(cc_rels)}",
                )
            )


def _drift(got: "list[str]", want: "list[frozenset[str] | None]") -> str:
    """The arguments whose ctypes the C types do not allow ("" if none;
    a C type outside the table is its own finding)."""
    return "; ".join(
        f"#{i + 1}: {g}, the C type takes {'/'.join(sorted(w))}"
        for i, (g, w) in enumerate(zip(got, want))
        if w is not None and g not in w
    )


def analyze_seam(
    py_sources: "dict[str, str]",
    cc_sources: "dict[str, str] | None" = None,
) -> "list[Finding]":
    """All MTPU4xx findings for a set of binding modules (pre-noqa).

    With ``cc_sources`` the export cross-checks (MTPU401-403) run over
    the union of the sources' exports and the modules' bindings (they
    build into one library); without it only the caller-side data-flow
    rules (MTPU404/405).
    """
    findings: "list[Finding]" = []
    bindings: "dict[str, Binding]" = {}
    for rel, text in py_sources.items():
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            findings.append(Finding(
                "MTPU401", rel, e.lineno or 1,
                f"binding file does not parse: {e.msg}"))
            continue
        bindings.update(parse_bindings(tree, rel))
        findings.extend(_buffer_findings(tree, rel))
    if cc_sources is not None:
        exports: "dict[str, Export]" = {}
        for rel, text in cc_sources.items():
            exports.update(parse_exports(text, rel))
        _check_cross(exports, bindings, findings)
    return findings


def analyze(
    py_text: str,
    py_rel: str,
    cc_text: "str | None" = None,
    cc_rel: "str | None" = None,
) -> "list[Finding]":
    """One binding file against (optionally) one source: the JAX
    package's signature, for fixtures."""
    return analyze_seam(
        {py_rel: py_text},
        None if cc_text is None else {cc_rel or CC_RELS[0]: cc_text},
    )


def _read(rel: str) -> str:
    from . import REPO_ROOT

    with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as fh:
        return fh.read()


def seam_sources(
    seam: "tuple[tuple, tuple]" = SEAMS[0],
) -> "tuple[dict[str, str], dict[str, str]]":
    """One real seam's texts (the kernel library's by default): (binding
    modules, sources)."""
    py_rels, cc_rels = seam
    return ({rel: _read(rel) for rel in py_rels},
            {rel: _read(rel) for rel in cc_rels})


def exports(seam: "tuple[tuple, tuple]" = SEAMS[0]) -> "dict[str, Export]":
    """Every export one seam's sources declare (the symbols its built
    library must resolve; the kernel library's by default)."""
    out: "dict[str, Export]" = {}
    for rel in seam[1]:
        out.update(parse_exports(_read(rel), rel))
    return out


def binding_rels() -> "tuple[str, ...]":
    """The binding modules of every seam."""
    return tuple(rel for py_rels, _cc in SEAMS for rel in py_rels)


def raw_run() -> "list[Finding]":
    """Every seam's findings BEFORE noqa filtering (MTPU106 input)."""
    found: "list[Finding]" = []
    for seam in SEAMS:
        found.extend(analyze_seam(*seam_sources(seam)))
    return found


def run() -> "list[Finding]":
    """ABI pass over the real seams, noqa-filtered."""
    lines = {rel: _read(rel).splitlines() for rel in binding_rels()}
    return filter_suppressed(raw_run(), lines)
