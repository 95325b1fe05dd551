"""Interprocedural resource-lifecycle analysis (MTPU601-606).

Proves, over the whole-tree call graph, that every acquire of a registered
resource (``resource_registry.py``) has a release or a sanctioned
ownership transfer on every path — the static stand-in for Go's defer
discipline that the reference MinIO leans on:

* MTPU601 — a path reaches function exit still holding an acquisition;
* MTPU602 — the same acquisition is released twice on one path;
* MTPU603 — an unprotected hold across a raisable call (no try/finally
  or ``with`` guarantees the release if that call throws);
* MTPU604 — a handle is used again after a registered ownership
  transfer;
* MTPU605 — registry drift: a registered function the call graph does
  not have, or an acquire-shaped API in a registered module that the
  registry misses;
* MTPU606 — config-knob drift: a ``MINIO_TPU_*`` env read without a
  ``config/knobs.py`` registry entry, a registered knob missing from
  README.md's table of the port's knobs, or a registry entry nothing
  reads.  An env read through a module-level string constant
  (``ENV_CONFIG_URL = "MINIO_TPU_..."``; ``os.environ.get(ENV_...)``)
  counts as a read of that knob.

The local dataflow is path-condition aware: try-style acquires
(``if not adm.try_enter_tenant(t): return``) hold only on the truthy
refinement, try/finally and ``with`` protect and discharge, and
release credit flows interprocedurally — a helper (or a closure handed
to a worker pool) that releases on behalf of its caller discharges the
caller's obligation through the call-graph edge, which is what makes
``--changed-only`` need the reverse-dependency closure.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import time

from . import callgraph
from .astcache import ParsedModule
from .findings import Finding
from .resource_registry import (
    ACQUIRE_SHAPED_NAMES,
    ACQUIRE_SHAPED_PREFIXES,
    Registry,
    ResourceClass,
    registered_call_names,
)

KNOBS_REL = "minio_tpu_torch/config/knobs.py"

# MTPU606's README leg reads only the port's knob table: the section of
# README.md under this heading, up to the next heading of its level or
# above (the JAX package's own table is elsewhere in the same file)
README_KNOB_HEADING = "### Configuration knobs of the port"

# Calls that cannot meaningfully throw for MTPU603 purposes: clock
# reads, size probes, logger/metric verbs, and the container ops the
# counters themselves are built from.  Everything else is raisable.
_SAFE_CALLS = frozenset(
    {
        "monotonic",
        "perf_counter",
        "time",
        "len",
        "id",
        "str",
        "bool",
        "isinstance",
        "getattr",
        "hasattr",
        "min",
        "max",
        "append",
        "pop",
        "popleft",
        "get",
        "debug",
        "info",
        "warning",
        "error",
        "exception",
        "observe",
        "inc",
        "dec",
        "set",
        "labels",
        "shed_inc",
        "value",
        "snapshot",
        "tenant_of",
        "field",
        "kv",
        "log_success",
        "log_failure",
        # the port's trace spans (utils/spans.span): a clock read, then
        # a dict update after the body has run
        "span",
    }
)

_TRUTHY_CONSTS = (True,)
_FALSY_CONSTS = (False, None, 0)


@dataclasses.dataclass
class LifecycleReport:
    findings: "list[Finding]"
    graph: "callgraph.CallGraph"
    seconds: float


# ---------------------------------------------------------------------------
# local state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ob:
    """One tracked acquisition within a function body."""

    uid: int
    res: ResourceClass
    line: int
    var: "str | None" = None  # handle variable name
    # held | pending | pending_transfer | released | transferred | maybe
    state: str = "held"
    cond_var: "str | None" = None
    transfer_line: int = 0
    warned603: bool = False
    from_with: bool = False

    def clone(self) -> "_Ob":
        return dataclasses.replace(self)


class _State:
    """Per-path obligation set (branch-cloneable, mergeable by uid)."""

    def __init__(self):
        self.obs: "list[_Ob]" = []
        self.aliases: "dict[str, str]" = {}  # local name -> self attr

    def clone(self) -> "_State":
        s = _State()
        s.obs = [ob.clone() for ob in self.obs]
        s.aliases = dict(self.aliases)
        return s

    def live(self, res_name: "str | None" = None) -> "list[_Ob]":
        return [
            ob
            for ob in self.obs
            if ob.state in ("held", "pending", "pending_transfer")
            and (res_name is None or ob.res.name == res_name)
        ]


def _merge(a: "_State", b: "_State") -> "_State":
    """Join two fallthrough branches; disagreements become 'maybe'
    (no further findings — the conservative, quiet direction)."""
    out = _State()
    out.aliases = dict(a.aliases)
    bmap = {ob.uid: ob for ob in b.obs}
    seen = set()
    for ob in a.obs:
        other = bmap.get(ob.uid)
        seen.add(ob.uid)
        if other is None:
            merged = ob.clone()
            if merged.state in ("held", "pending", "pending_transfer"):
                merged.state = "maybe"
            out.obs.append(merged)
            continue
        merged = ob.clone()
        if other.state != ob.state:
            merged.state = "maybe"
        out.obs.append(merged)
    for ob in b.obs:
        if ob.uid not in seen:
            merged = ob.clone()
            if merged.state in ("held", "pending", "pending_transfer"):
                merged.state = "maybe"
            out.obs.append(merged)
    return out


# ---------------------------------------------------------------------------
# syntactic matchers
# ---------------------------------------------------------------------------


def _call_name(call: ast.Call) -> "str | None":
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _recv_tail(call: ast.Call) -> "str | None":
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    base = fn.value
    if isinstance(base, ast.Name):
        return base.id
    if isinstance(base, ast.Attribute):
        return base.attr
    return None


def _name_matches(spec: str, call: ast.Call) -> bool:
    if "." in spec:
        recv, name = spec.rsplit(".", 1)
        return _call_name(call) == name and _recv_tail(call) == recv
    return _call_name(call) == spec


def _attr_op(call: ast.Call, state: "_State") -> "tuple[str, str] | None":
    """``(attr, method)`` for ``self._res.append(...)`` or an aliased
    ``res.append(...)`` where ``res = self._res``."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    base = fn.value
    if isinstance(base, ast.Attribute):
        return (base.attr, fn.attr)
    if isinstance(base, ast.Name) and base.id in state.aliases:
        return (state.aliases[base.id], fn.attr)
    return None


def _has_kwarg(call: ast.Call, kwarg: str) -> bool:
    return any(kw.arg == kwarg for kw in call.keywords)


def _arg_names(call: ast.Call) -> "set[str]":
    out: "set[str]" = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for node in ast.walk(arg):
            if isinstance(node, ast.Name):
                out.add(node.id)
    return out


def _const_value(node: "ast.AST | None"):
    if node is None:
        return None
    if isinstance(node, ast.Constant):
        return node.value
    return _MISSING


_MISSING = object()


# ---------------------------------------------------------------------------
# the per-function interpreter
# ---------------------------------------------------------------------------


class _Interp:
    def __init__(
        self,
        pass_,
        info: "callgraph.FuncInfo",
        resources: "tuple[ResourceClass, ...]",
    ):
        self.p = pass_
        self.info = info
        self.rel = info.rel_path
        self.resources = resources
        self.findings: "list[Finding]" = []
        self.credit: "dict[str, int]" = {}
        self.ever_acquired: "set[str]" = set()
        self._uid = 0
        # (protect_keys, effects): keys protect obligations for
        # MTPU603, effects are replayed on early exits (finally runs)
        self.frames: "list[tuple[set, list]]" = []
        self.local_defs = pass_.graph.locals_of.get(info.qname, {})
        # resources this function is a registered acquire seam for
        self.seam_res: "set[str]" = set()
        name = info.qname.split("::", 1)[1]
        for res in resources:
            for drel, dq in res.defs:
                if drel == self.rel and dq == name:
                    bare = name.rsplit(".", 1)[-1]
                    if any(
                        bare == s.rsplit(".", 1)[-1]
                        for s in res.acquire_calls
                    ):
                        self.seam_res.add(res.name)

    # -- driving ----------------------------------------------------------

    def run(self) -> None:
        body = list(self.info.node.body)
        state = _State()
        status = self._walk(body, state)
        if status == "fall":
            self._check_exit(state, None, None)

    def emit(self, rule: str, line: int, msg: str) -> None:
        self.findings.append(Finding(rule, self.rel, line, msg))

    def _new_ob(self, res: ResourceClass, line: int, **kw) -> _Ob:
        self._uid += 1
        return _Ob(uid=self._uid, res=res, line=line, **kw)

    # -- statement walk ---------------------------------------------------

    def _walk(self, stmts, state: "_State") -> str:
        """Returns "fall" when control can reach past ``stmts``."""
        for stmt in stmts:
            self._check_transferred_use(stmt, state)
            status = self._stmt(stmt, state)
            if status == "exit":
                return "exit"
        return "fall"

    def _stmt(self, stmt, state: "_State") -> str:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            bind = tgt.id if isinstance(tgt, ast.Name) else None
            # alias: res = self._res
            if (
                bind
                and isinstance(stmt.value, ast.Attribute)
                and isinstance(stmt.value.value, ast.Name)
            ):
                state.aliases[bind] = stmt.value.attr
            self._expr(stmt.value, state, bind_var=bind)
            if bind is None:
                # storing a handle into an attribute/element transfers
                # ownership to the heap
                self._escape_stores(stmt.targets[0], stmt.value, state)
            return "fall"
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            bind = (
                stmt.target.id
                if isinstance(stmt.target, ast.Name)
                else None
            )
            self._expr(stmt.value, state, bind_var=bind)
            return "fall"
        if isinstance(stmt, (ast.Expr, ast.AugAssign)):
            val = stmt.value if isinstance(stmt, ast.Expr) else stmt.value
            self._expr(val, state, bind_var=None)
            return "fall"
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value, state, bind_var=None, in_return=True)
            self._check_exit(state, stmt, stmt.value)
            return "exit"
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._expr(stmt.exc, state, bind_var=None)
            self._check_exit(state, stmt, None, raising=True)
            return "exit"
        if isinstance(stmt, ast.If):
            return self._if(stmt, state)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, state)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, state)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, state, bind_var=None)
            self._walk(stmt.body, state)
            if stmt.orelse:
                self._walk(stmt.orelse, state)
            return "fall"
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, state, bind_var=None)
            self._walk(stmt.body, state)
            if stmt.orelse:
                self._walk(stmt.orelse, state)
            # ``while True`` with no break never falls through
            if (
                isinstance(stmt.test, ast.Constant)
                and stmt.test.value
                and not any(
                    isinstance(n, ast.Break) for n in ast.walk(stmt)
                )
            ):
                return "exit"
            return "fall"
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return "fall"
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return "fall"
        if isinstance(stmt, (ast.Assert, ast.Delete)):
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    self._call(node, state, bind_var=None)
            return "fall"
        # anything else: process calls generically
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._call(node, state, bind_var=None)
        return "fall"

    # -- branches ---------------------------------------------------------

    def _if(self, stmt: ast.If, state: "_State") -> str:
        before = {ob.uid for ob in state.obs}
        before_states = {ob.uid: ob.state for ob in state.obs}
        self._expr(stmt.test, state, bind_var=None)
        test_obs = [ob for ob in state.obs if ob.uid not in before]
        # obligations the test itself turned into pending transfers
        # (``if not pool.try_submit(closure):``) are gated by it too
        test_obs.extend(
            ob
            for ob in state.obs
            if ob.uid in before
            and ob.state == "pending_transfer"
            and before_states.get(ob.uid) != "pending_transfer"
        )
        gate, negated = self._gate(stmt.test, state, test_obs)

        then_state = state.clone()
        else_state = state.clone()
        if gate is not None:
            self._refine(then_state, gate, truthy=not negated)
            self._refine(else_state, gate, truthy=negated)
        then_status = self._walk(stmt.body, then_state)
        else_status = (
            self._walk(stmt.orelse, else_state) if stmt.orelse else "fall"
        )
        if then_status == "exit" and else_status == "exit":
            return "exit"
        if then_status == "exit":
            state.obs = else_state.obs
            state.aliases = else_state.aliases
            return "fall"
        if else_status == "exit":
            state.obs = then_state.obs
            state.aliases = then_state.aliases
            return "fall"
        merged = _merge(then_state, else_state)
        state.obs = merged.obs
        state.aliases = merged.aliases
        return "fall"

    def _gate(self, test, state, test_obs):
        """(gate, negated): gate identifies pending obligations this
        test decides — the uid list of obligations created in the test
        itself, or a cond_var name."""
        negated = False
        node = test
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            negated = True
            node = node.operand
        if test_obs:
            return [ob.uid for ob in test_obs], negated
        if isinstance(node, ast.Name):
            uids = [
                ob.uid
                for ob in state.obs
                if ob.cond_var == node.id
                and ob.state in ("pending", "pending_transfer")
            ]
            if uids:
                return uids, negated
        return None, negated

    def _refine(self, state: "_State", uids, *, truthy: bool) -> None:
        for ob in state.obs:
            if ob.uid not in uids:
                continue
            if ob.state == "pending":
                ob.state = "held" if truthy else "released"
            elif ob.state == "pending_transfer":
                ob.state = "transferred" if truthy else "held"

    # -- try / with -------------------------------------------------------

    def _try(self, stmt: ast.Try, state: "_State") -> str:
        effects = self._release_effects(stmt.finalbody)
        protect = set()
        for res_name, var in effects:
            protect.add(("res", res_name))
            if var:
                protect.add(("var", var))
        # a handler that releases and re-raises protects the same way
        for handler in stmt.handlers:
            if any(isinstance(n, ast.Raise) for n in handler.body):
                for res_name, var in self._release_effects(handler.body):
                    protect.add(("res", res_name))
                    if var:
                        protect.add(("var", var))
        self.frames.append((protect, effects))
        entry = state.clone()
        body_status = self._walk(stmt.body, state)
        if body_status == "fall" and stmt.orelse:
            body_status = self._walk(stmt.orelse, state)
        handler_states = []
        for handler in stmt.handlers:
            hs = entry.clone()
            if self._walk(handler.body, hs) == "fall":
                handler_states.append(hs)
        self.frames.pop()
        if body_status == "fall":
            merged = state
            for hs in handler_states:
                merged = _merge(merged, hs)
        elif handler_states:
            merged = handler_states[0]
            for hs in handler_states[1:]:
                merged = _merge(merged, hs)
        else:
            # neither body nor any handler falls through, but finally
            # still runs on the way out
            if stmt.finalbody:
                fs = entry.clone()
                self._walk(stmt.finalbody, fs)
            return "exit"
        state.obs = merged.obs
        state.aliases = merged.aliases
        if stmt.finalbody:
            return (
                "exit"
                if self._walk(stmt.finalbody, state) == "exit"
                else "fall"
            )
        return "fall"

    def _with(self, stmt, state: "_State") -> str:
        with_obs: "list[_Ob]" = []
        for item in stmt.items:
            before = {ob.uid for ob in state.obs}
            bind = (
                item.optional_vars.id
                if isinstance(item.optional_vars, ast.Name)
                else None
            )
            self._expr(item.context_expr, state, bind_var=bind)
            for ob in state.obs:
                if ob.uid not in before and ob.state in (
                    "held",
                    "pending",
                ):
                    ob.state = "held"
                    ob.from_with = True
                    with_obs.append(ob)
        protect = set()
        for ob in with_obs:
            protect.add(("res", ob.res.name))
            if ob.var:
                protect.add(("var", ob.var))
        effects = [(ob.res.name, ob.var) for ob in with_obs]
        self.frames.append((protect, effects))
        status = self._walk(stmt.body, state)
        self.frames.pop()
        for ob in with_obs:
            if ob.state in ("held", "maybe"):
                ob.state = "released"
        return status

    def _release_effects(self, stmts) -> "list[tuple[str, str | None]]":
        """(resource, handle-var|None) releases a block performs —
        used to replay enclosing ``finally`` bodies on early exits."""
        out: "list[tuple[str, str | None]]" = []
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                for res in self.resources:
                    for spec in res.release_calls:
                        if _name_matches(spec, node):
                            var = None
                            if res.handle and node.args and isinstance(
                                node.args[0], ast.Name
                            ):
                                var = node.args[0].id
                            out.append((res.name, var))
                    if res.handle and isinstance(node.func, ast.Attribute):
                        if node.func.attr in res.release_methods and (
                            isinstance(node.func.value, ast.Name)
                        ):
                            out.append((res.name, node.func.value.id))
                credit = self._callee_credit(node)
                for res_name, count in credit.items():
                    out.extend([(res_name, None)] * count)
        return out

    # -- exits ------------------------------------------------------------

    def _check_exit(self, state, stmt, ret_value, raising=False) -> None:
        line = stmt.lineno if stmt is not None else None
        temp = state.clone()
        # finally blocks on the way out still run their releases
        for _, effects in reversed(self.frames):
            for res_name, var in effects:
                self._discharge(temp, res_name, var, None, quiet=True)
        ret_names: "set[str]" = set()
        # bare `return` is a falsy (None) result for seam purposes
        ret_const = (
            _const_value(ret_value) if ret_value is not None else None
        )
        if ret_value is not None:
            for node in ast.walk(ret_value):
                if isinstance(node, ast.Name):
                    ret_names.add(node.id)
        for ob in temp.live():
            res = ob.res
            # a pending transfer nobody refuted is a transfer
            if ob.state == "pending_transfer":
                continue
            # returning the handle / the gating var hands it to the
            # caller
            if ob.var and ob.var in ret_names:
                continue
            if ob.cond_var and ob.cond_var in ret_names:
                continue
            # acquire seams: a truthy return hands held tokens to the
            # caller by contract; unconditional seams do so on every
            # non-raising exit
            if res.name in self.seam_res:
                if not res.conditional and not raising:
                    continue
                if res.conditional:
                    if ret_const is _MISSING:
                        # non-constant return: the result decides
                        # ownership dynamically; trust the seam
                        continue
                    if ret_const not in _FALSY_CONSTS:
                        continue  # truthy constant: caller owns
                    # falsy constant return while holding: a leak
            if raising and self._protected(ob):
                continue
            anchor = line if line is not None else ob.line
            self.emit(
                "MTPU601",
                anchor,
                f"{res.name} acquired at line {ob.line} leaks on this "
                "exit path: no release or registered ownership "
                "transfer before "
                + ("raise" if raising else "function exit"),
            )
            ob.state = "maybe"

    def _protected(self, ob: "_Ob") -> bool:
        for protect, _ in self.frames:
            if ("res", ob.res.name) in protect:
                return True
            if ob.var and ("var", ob.var) in protect:
                return True
        return False

    def _check_transferred_use(self, stmt, state: "_State") -> None:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return
        for ob in state.obs:
            if ob.state != "transferred" or not ob.var:
                continue
            for node in ast.walk(stmt):
                if (
                    isinstance(node, ast.Name)
                    and node.id == ob.var
                    and isinstance(node.ctx, ast.Load)
                    and node.lineno > ob.transfer_line
                ):
                    self.emit(
                        "MTPU604",
                        node.lineno,
                        f"{ob.res.name} handle '{ob.var}' used after "
                        f"ownership transfer at line {ob.transfer_line}",
                    )
                    ob.state = "maybe"
                    break

    # -- expressions ------------------------------------------------------

    def _expr(self, expr, state, *, bind_var, in_return=False) -> None:
        # lambda bodies do not run when the expression does
        deferred: "set[int]" = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Lambda):
                for sub in ast.walk(node.body):
                    if isinstance(sub, ast.Call):
                        deferred.add(id(sub))
        calls = [
            n
            for n in ast.walk(expr)
            if isinstance(n, ast.Call) and id(n) not in deferred
        ]
        outer = expr
        while isinstance(outer, ast.Await):
            outer = outer.value
        # reversed pre-order puts every argument call before the call
        # that consumes it — evaluation order, which is what MTPU603's
        # "held across" means
        for call in reversed(calls):
            self._call(
                call,
                state,
                bind_var=bind_var if call is outer else None,
                nested=call is not outer,
                in_return=in_return,
            )

    def _escape_stores(self, target, value, state: "_State") -> None:
        names: "set[str]" = set()
        for node in ast.walk(value):
            if isinstance(node, ast.Name):
                names.add(node.id)
        if not names:
            return
        for ob in state.obs:
            if (
                ob.var
                and ob.var in names
                and ob.state in ("held", "pending")
            ):
                # heap escape: ownership leaves the frame silently
                ob.state = "released"

    # -- the call classifier ---------------------------------------------

    def _call(
        self,
        call: ast.Call,
        state: "_State",
        *,
        bind_var,
        nested: bool = False,
        in_return: bool = False,
    ) -> None:
        name = _call_name(call)
        handled = False
        for res in self.resources:
            # releases first: `release(acquire())` shapes are not in
            # this tree, and release-before-acquire keeps `x = f(x)`
            # stable
            for spec in res.release_calls:
                if _name_matches(spec, call):
                    var = None
                    if res.handle and call.args and isinstance(
                        call.args[0], ast.Name
                    ):
                        var = call.args[0].id
                    self._discharge(state, res.name, var, call)
                    handled = True
            if res.handle and isinstance(call.func, ast.Attribute):
                recv = call.func.value
                if (
                    call.func.attr in res.release_methods
                    and isinstance(recv, ast.Name)
                ):
                    for ob in state.obs:
                        if ob.var == recv.id and ob.res is res:
                            self._discharge(
                                state, res.name, recv.id, call
                            )
                            handled = True
                            break
            for spec in res.transfer_calls:
                if _name_matches(spec, call):
                    args = _arg_names(call)
                    recv = (
                        call.func.value.id
                        if isinstance(call.func, ast.Attribute)
                        and isinstance(call.func.value, ast.Name)
                        else None
                    )
                    for ob in state.obs:
                        if ob.state in ("held", "pending") and (
                            ob.var in args or ob.var == recv
                            if ob.var
                            else False
                        ):
                            ob.state = "transferred"
                            ob.transfer_line = call.lineno
                            handled = True
            op = _attr_op(call, state)
            if op is not None:
                if op in res.acquire_attr_ops:
                    self.ever_acquired.add(res.name)
                    state.obs.append(
                        self._new_ob(res, call.lineno)
                    )
                    handled = True
                elif op in res.release_attr_ops:
                    self._discharge(state, res.name, None, call)
                    handled = True
            for spec in res.acquire_calls:
                if not _name_matches(spec, call):
                    continue
                if res.acquire_kwarg and not _has_kwarg(
                    call, res.acquire_kwarg
                ):
                    continue
                if res.handle and (nested or in_return):
                    # a handle constructed inside a larger expression
                    # (tuple, comprehension, argument) or returned
                    # directly escapes to whoever consumes it —
                    # ownership never rests in this frame
                    handled = True
                    continue
                self.ever_acquired.add(res.name)
                ob = self._new_ob(res, call.lineno)
                if res.handle:
                    ob.var = bind_var
                if res.conditional:
                    ob.state = "pending"
                    ob.cond_var = bind_var
                state.obs.append(ob)
                handled = True
        if not handled:
            # interprocedural credit: callee (or a closure argument)
            # releases on the caller's behalf
            credit = self._callee_credit(call)
            closure_credit = self._closure_arg_credit(call)
            for res_name, count in credit.items():
                for _ in range(count):
                    self._discharge(state, res_name, None, call)
            if closure_credit:
                for res_name, count in closure_credit.items():
                    for _ in range(count):
                        self._transfer_token(
                            state, res_name, call, bind_var
                        )
                handled = True
            elif credit:
                handled = True
        if not handled:
            # passing a live handle to an unregistered call lets it
            # escape the frame: ownership moves, tracking stops
            args = _arg_names(call)
            if args:
                for ob in state.obs:
                    if (
                        ob.var
                        and ob.var in args
                        and ob.state in ("held", "pending")
                    ):
                        ob.state = "released"
        if not handled and name not in _SAFE_CALLS:
            self._raisable(call, state)

    def _transfer_token(self, state, res_name, call, bind_var) -> None:
        """A closure that releases R was handed off: the obligation
        becomes a pending transfer — the hand-off result (bound, or the
        enclosing ``if`` test) decides whether the pool took it; a
        pending transfer nobody tests is trusted at exit."""
        for ob in reversed(state.obs):
            if ob.res.name == res_name and ob.state == "held":
                ob.state = "pending_transfer"
                ob.cond_var = bind_var
                ob.transfer_line = call.lineno
                return

    def _discharge(
        self, state, res_name, var, call, *, quiet=False
    ) -> None:
        line = call.lineno if call is not None else 0
        # prefer the exact handle, then the most recent live holding
        candidates = [
            ob
            for ob in reversed(state.obs)
            if ob.res.name == res_name
            and (var is None or ob.var == var)
        ]
        for ob in candidates:
            if ob.state in ("held", "pending"):
                ob.state = "released"
                return
        for ob in candidates:
            if ob.state in ("maybe", "pending_transfer"):
                ob.state = "released"
                return
        if quiet:
            return
        for ob in candidates:
            if ob.state == "released":
                self.emit(
                    "MTPU602",
                    line,
                    f"{res_name} already released (acquired at line "
                    f"{ob.line}) is released again",
                )
                return
            if ob.state == "transferred":
                self.emit(
                    "MTPU604",
                    line,
                    f"{res_name} released after ownership transfer at "
                    f"line {ob.transfer_line}",
                )
                return
        if res_name in self.ever_acquired:
            self.emit(
                "MTPU602",
                line,
                f"{res_name} released more times than acquired on "
                "this path",
            )
            return
        # releasing a resource this frame never acquired: credit the
        # caller (the helper-releases-for-caller pattern)
        self.credit[res_name] = self.credit.get(res_name, 0) + 1

    def _callee_credit(self, call: ast.Call) -> "dict[str, int]":
        edge = self.p.graph.call_info.get(id(call))
        if edge is None or edge.callee in (None, "<multi>"):
            return {}
        if edge.boundary is not None:
            # the callee runs later on another thread/loop (or not at
            # all, if the pool sheds) — its releases are a transfer,
            # not synchronous credit; _closure_arg_credit handles it
            return {}
        return self.p.summaries.get(edge.callee, {})

    def _closure_arg_credit(self, call: ast.Call) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Name) and arg.id in self.local_defs:
                child = self.local_defs[arg.id]
                for res_name, count in self.p.summaries.get(
                    child, {}
                ).items():
                    out[res_name] = out.get(res_name, 0) + count
        return out

    def _raisable(self, call: ast.Call, state: "_State") -> None:
        for ob in state.live():
            if ob.state != "held" or ob.warned603 or ob.from_with:
                continue
            if ob.line >= call.lineno:
                continue
            if self._protected(ob):
                continue
            ob.warned603 = True
            self.emit(
                "MTPU603",
                call.lineno,
                f"{ob.res.name} acquired at line {ob.line} is held "
                f"across raisable call "
                f"'{_call_name(call) or '<expr>'}' with no try/finally "
                "protecting its release",
            )


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


class _LifecyclePass:
    def __init__(self, sources, registry, graph):
        self.sources: "dict[str, ParsedModule]" = sources
        self.registry = registry
        self.graph = graph
        self.summaries: "dict[str, dict[str, int]]" = {}
        self.findings: "list[Finding]" = []

    def run(self) -> None:
        scoped_funcs = [
            info
            for qname, info in sorted(self.graph.funcs.items())
            if self.registry.scoped(info.rel_path)
        ]
        # fixpoint the release-credit summaries (a helper's credit can
        # come from its own callees), then one reporting pass
        for _ in range(4):
            changed = False
            for info in scoped_funcs:
                interp = _Interp(
                    self, info, self.registry.scoped(info.rel_path)
                )
                interp.run()
                if interp.credit != self.summaries.get(
                    info.qname, {}
                ):
                    self.summaries[info.qname] = dict(interp.credit)
                    changed = True
            if not changed:
                break
        for info in scoped_funcs:
            interp = _Interp(
                self, info, self.registry.scoped(info.rel_path)
            )
            interp.run()
            self.findings.extend(interp.findings)
        self._check_registry_drift()
        self.findings.extend(
            check_knobs(self.sources, repo_root=_repo_root())
        )

    def _check_registry_drift(self) -> None:
        # direction 1: every registered def resolves in the call graph
        for res in self.registry.resources:
            for rel, qname in res.defs:
                if self.graph.lookup(rel, qname) is None:
                    if rel not in self.sources:
                        continue  # file outside the analyzed set
                    self.emit_drift(
                        rel,
                        1,
                        f"resource_registry names {qname} for "
                        f"{res.name} but the call graph has no such "
                        "def in this module",
                    )
        # direction 2: acquire-shaped defs in registered scopes must
        # be registered
        known = registered_call_names(self.registry)
        for qname, info in sorted(self.graph.funcs.items()):
            if not self.registry.scoped(info.rel_path):
                continue
            bare = info.name
            shaped = bare.startswith(
                ACQUIRE_SHAPED_PREFIXES
            ) or bare in ACQUIRE_SHAPED_NAMES
            if shaped and bare not in known:
                self.emit_drift(
                    info.rel_path,
                    info.lineno,
                    f"acquire-shaped def '{bare}' in a registered "
                    "resource module has no resource_registry entry",
                )

    def emit_drift(self, rel, line, msg) -> None:
        self.findings.append(Finding("MTPU605", rel, line, msg))


# ---------------------------------------------------------------------------
# MTPU606: config-knob drift
# ---------------------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _env_read_sites(mod: ParsedModule):
    """(line, knob, is_prefix) for every MINIO_TPU_* env read —
    direct environ/getenv calls, subscripts, membership tests, and
    calls through local first-arg-is-the-key wrapper helpers."""
    tree = mod.tree
    if tree is None:
        return
    # module-level string constants: ENV_X = "MINIO_TPU_X"
    consts: "dict[str, str]" = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            consts[node.targets[0].id] = node.value.value
    wrappers: "set[str]" = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) and node.args.args:
            first = node.args.args[0].arg
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    nm = _call_name(sub)
                    if (
                        nm in ("get", "getenv")
                        and sub.args
                        and isinstance(sub.args[0], ast.Name)
                        and sub.args[0].id == first
                    ):
                        wrappers.add(node.name)

    def _env_recv(expr) -> bool:
        try:
            text = ast.unparse(expr)
        except Exception:
            return False
        return "environ" in text or text == "env"

    def _knob_of(arg):
        if isinstance(arg, ast.Name) and arg.id in consts:
            arg = ast.Constant(consts[arg.id])
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value.startswith("MINIO_TPU_"):
                return arg.value, False
        if isinstance(arg, ast.JoinedStr) and arg.values:
            head = arg.values[0]
            if isinstance(head, ast.Constant) and isinstance(
                head.value, str
            ) and head.value.startswith("MINIO_TPU_"):
                return head.value, True
        return None, False

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            nm = _call_name(node)
            base = (
                node.func.value
                if isinstance(node.func, ast.Attribute)
                else None
            )
            is_env = nm == "getenv" or (
                nm in ("get", "setdefault", "pop")
                and base is not None
                and _env_recv(base)
            )
            if is_env and node.args:
                knob, pref = _knob_of(node.args[0])
                if knob:
                    yield node.lineno, knob, pref
            elif nm in wrappers and node.args:
                knob, pref = _knob_of(node.args[0])
                if knob:
                    yield node.lineno, knob, pref
        elif isinstance(node, ast.Subscript) and _env_recv(node.value):
            knob, pref = _knob_of(node.slice)
            if knob:
                yield node.lineno, knob, pref
        elif isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
        ):
            if node.comparators and _env_recv(node.comparators[0]):
                knob, pref = _knob_of(node.left)
                if knob:
                    yield node.lineno, knob, pref


def readme_knob_table(text: str) -> str:
    """The port's knob table of README.md: the lines under
    ``README_KNOB_HEADING`` up to the next heading of its level or above
    ("" when the heading is missing)."""
    level = len(README_KNOB_HEADING) - len(README_KNOB_HEADING.lstrip("#"))
    out: "list[str]" = []
    inside = False
    for line in text.splitlines():
        if line.strip() == README_KNOB_HEADING:
            inside = True
            continue
        if inside and line.startswith("#"):
            hashes = len(line) - len(line.lstrip("#"))
            if hashes <= level and line[hashes:hashes + 1] == " ":
                break
        if inside:
            out.append(line)
    return "\n".join(out)


def _parse_knob_registry(mod: ParsedModule):
    """(exact: {name: line}, prefixes: {prefix: line}) from the
    KNOBS/PREFIX_KNOBS dict literals in config/knobs.py."""
    exact: "dict[str, int]" = {}
    prefixes: "dict[str, int]" = {}
    if mod.tree is None:
        return exact, prefixes
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            tgt, value = node.target, node.value
        else:
            continue
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id not in ("KNOBS", "PREFIX_KNOBS"):
            continue
        if not isinstance(value, ast.Dict):
            continue
        table = exact if tgt.id == "KNOBS" else prefixes
        for key in value.keys:
            if isinstance(key, ast.Constant) and isinstance(
                key.value, str
            ):
                table[key.value] = key.lineno
    return exact, prefixes


def check_knobs(
    sources: "dict[str, ParsedModule]",
    *,
    repo_root: "str | None" = None,
    readme_text: "str | None" = None,
) -> "list[Finding]":
    """MTPU606 over an analyzed source set.

    Read-site checks always run; the registry-side checks (README
    mention, dead entries) run only when the registry module itself is
    part of the set — a --paths run over a fixture cannot audit the
    whole tree's docs.
    """
    findings: "list[Finding]" = []
    reg_mod = sources.get(KNOBS_REL)
    exact, prefixes = (
        _parse_knob_registry(reg_mod) if reg_mod else ({}, {})
    )

    reads: "dict[str, list[tuple[str, int]]]" = {}
    prefix_reads: "list[tuple[str, int, str]]" = []
    for rel, mod in sorted(sources.items()):
        if rel == KNOBS_REL:
            continue
        for line, knob, is_pref in _env_read_sites(mod):
            if is_pref:
                prefix_reads.append((rel, line, knob))
            else:
                reads.setdefault(knob, []).append((rel, line))

    def _registered(knob: str) -> bool:
        if knob in exact:
            return True
        return any(knob.startswith(p) for p in prefixes)

    if reg_mod is not None:
        for knob, sites in sorted(reads.items()):
            if not _registered(knob):
                rel, line = sites[0]
                findings.append(
                    Finding(
                        "MTPU606",
                        rel,
                        line,
                        f"env knob {knob} is read here but has no "
                        "entry in minio_tpu_torch/config/knobs.py (register "
                        "a default + README row)",
                    )
                )
        for rel, line, head in sorted(prefix_reads):
            if not any(
                head.startswith(p) or p.startswith(head)
                for p in prefixes
            ) and not _registered(head):
                findings.append(
                    Finding(
                        "MTPU606",
                        rel,
                        line,
                        f"dynamic env knob '{head}*' is read here but "
                        "no PREFIX_KNOBS family covers it in "
                        "minio_tpu_torch/config/knobs.py",
                    )
                )
        if readme_text is None:
            root = repo_root or _repo_root()
            try:
                with open(
                    os.path.join(root, "README.md"), encoding="utf-8"
                ) as fh:
                    readme_text = readme_knob_table(fh.read())
            except OSError:
                readme_text = ""
        for knob, line in sorted(exact.items()):
            if knob not in readme_text:
                findings.append(
                    Finding(
                        "MTPU606",
                        KNOBS_REL,
                        line,
                        f"registered knob {knob} is missing from "
                        "README.md's table of the port's knobs",
                    )
                )
            if knob not in reads:
                findings.append(
                    Finding(
                        "MTPU606",
                        KNOBS_REL,
                        line,
                        f"registered knob {knob} is read nowhere in "
                        "the tree (dead registry entry)",
                    )
                )
        for prefix, line in sorted(prefixes.items()):
            if prefix not in readme_text:
                findings.append(
                    Finding(
                        "MTPU606",
                        KNOBS_REL,
                        line,
                        f"registered knob family {prefix}* is missing "
                        "from README.md's table of the port's knobs",
                    )
                )
            if not any(
                head.startswith(prefix) or prefix.startswith(head)
                for _, _, head in prefix_reads
            ) and not any(k.startswith(prefix) for k in reads):
                findings.append(
                    Finding(
                        "MTPU606",
                        KNOBS_REL,
                        line,
                        f"registered knob family {prefix}* is read "
                        "nowhere in the tree (dead registry entry)",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def analyze_sources(
    sources: "dict[str, ParsedModule]",
    *,
    registry: "Registry | None" = None,
    graph: "callgraph.CallGraph | None" = None,
) -> LifecycleReport:
    """Run the lifecycle pass over parsed sources.

    ``registry`` defaults to the shipped resource table; tests inject
    synthetic ones.  ``graph`` lets the CLI share one call-graph build
    with the deviceflow pass.
    """
    t0 = time.monotonic()
    registry = registry or Registry.default()
    if graph is None:
        graph = callgraph.build(sources)
    p = _LifecyclePass(sources, registry, graph)
    p.run()
    findings = sorted(set(p.findings), key=Finding.sort_key)
    return LifecycleReport(
        findings=findings,
        graph=graph,
        seconds=round(time.monotonic() - t0, 3),
    )
