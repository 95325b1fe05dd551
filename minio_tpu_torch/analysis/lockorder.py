"""Lock-order auditor: the race detector's little brother.

Go's race detector watches the reference MinIO's 47 lock sites at test
time; Python has nothing equivalent, so this shim instruments
``threading.Lock/RLock/Condition`` *as used by the lock-plane modules*
(dsync + storage) and records the runtime lock-acquisition graph while
the test suite (or the built-in CLI scenario) exercises them:

* MTPU301 — a cycle in the acquisition graph: thread T1 took A then B
  while T2 takes B then A.  Never deadlocks in the run that finds it —
  that is the point: the *order* is the bug, observable on any
  interleaving.
* MTPU302 — a blocking call (``time.sleep``, ``socket.create_connection``,
  ``subprocess.run``) while holding an audited lock: a hot-path mutex
  pinned for wall-clock time serializes every peer behind a timer or a
  remote node.

Mechanics: the target modules do ``import threading`` and call
``threading.Lock()`` etc. through their module-global, so swapping that
one attribute for a proxy is enough — no global monkey-patching of the
``threading`` module, and unrelated subsystems (torch, the batcher pool)
stay untouched.  Graph nodes are (creation-site, instance) pairs, so
many short-lived locks minted at one site (per-object namespace locks,
per-attempt dsync mutexes) do not fold into a single node and
self-alias into false cycles.

Usage::

    aud = LockOrderAuditor()
    with aud.installed():
        ... exercise lock paths ...
    findings = aud.report()   # [] means acyclic and sleep-clean
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading as _real_threading
import time

from .findings import Finding

# modules whose lock usage is on the lock-plane hot path
DEFAULT_TARGETS = (
    "minio_tpu_torch.dsync.drwmutex",
    "minio_tpu_torch.dsync.local_locker",
    "minio_tpu_torch.dsync.namespace",
    "minio_tpu_torch.storage.metered",
    "minio_tpu_torch.storage.diskcheck",
    "minio_tpu_torch.storage.health",
    "minio_tpu_torch.storage.faults",
    "minio_tpu_torch.parallel.iopool",
    # the port's persistent internode fan-out workers: their counter
    # mutex must stay a leaf of the graph
    "minio_tpu_torch.parallel.fanout",
    # cluster harness + chaos grid: lock-free today, audited so any
    # future lock added to the multi-process driver enters the graph
    "minio_tpu_torch.cluster.harness",
    "minio_tpu_torch.testgrid.engine",
    # multi-loop request plane: the SharedBudget/TokenCounter admit
    # path must stay lock-free (any mutex minted there would serialise
    # every loop's admission), and the per-loop plane code must keep
    # its remaining locks (PlaneStats aggregate, worker-pool stream
    # registry) acyclic against the rest of the graph
    "minio_tpu_torch.server.admission",
    "minio_tpu_torch.server.aio",
)

_THIS_FILE = os.path.abspath(__file__)


def _caller_site() -> "tuple[str, int]":
    """(repo-relative path, line) of the nearest frame outside this file."""
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _THIS_FILE:
        f = f.f_back
    if f is None:  # pragma: no cover
        return "<unknown>", 0
    path = f.f_code.co_filename
    marker = os.sep + "minio_tpu_torch" + os.sep
    if marker in path:
        path = "minio_tpu_torch" + os.sep + path.rsplit(marker, 1)[1]
    return path.replace(os.sep, "/"), f.f_lineno


class _Node:
    """One audited lock instance: identity + where it was minted."""

    __slots__ = ("site", "line", "serial")

    def __init__(self, site: str, line: int, serial: int):
        self.site = site
        self.line = line
        self.serial = serial

    def label(self) -> str:
        return f"{self.site}:{self.line}#{self.serial}"


class AuditedLock:
    """Wraps a real lock; reports acquire/release to the auditor."""

    def __init__(self, auditor: "LockOrderAuditor", inner, node: _Node):
        self._auditor = auditor
        self._inner = inner
        self.node = node

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._auditor._on_acquired(self)
        return ok

    def release(self) -> None:
        self._auditor._on_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AuditedCondition:
    """Real Condition over an audited lock's graph node.

    ``wait`` releases the lock for its duration, so the held-stack entry
    is popped and re-pushed around it — blocking in ``wait`` is the
    *intended* use of a condition variable, not an MTPU302 smell.
    """

    def __init__(self, auditor, node: _Node, lock=None):
        if isinstance(lock, AuditedLock):
            self.node = lock.node
            inner = lock._inner
        else:
            self.node = node
            inner = lock if lock is not None else _real_threading.RLock()
        self._auditor = auditor
        self._cond = _real_threading.Condition(inner)

    def acquire(self, *args) -> bool:
        ok = self._cond.acquire(*args)
        if ok:
            self._auditor._on_acquired(self)
        return ok

    def release(self) -> None:
        self._auditor._on_released(self)
        self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: "float | None" = None) -> bool:
        self._auditor._on_released(self)
        try:
            return self._cond.wait(timeout)
        finally:
            self._auditor._on_acquired(self)

    def wait_for(self, predicate, timeout: "float | None" = None):
        self._auditor._on_released(self)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            self._auditor._on_acquired(self)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


class _ThreadingProxy:
    """Stand-in for a module's ``threading`` global: Lock/RLock/Condition
    come back audited, everything else passes through."""

    def __init__(self, auditor: "LockOrderAuditor"):
        self._auditor = auditor

    def Lock(self):
        return self._auditor._make(_real_threading.Lock(), "Lock")

    def RLock(self):
        return self._auditor._make(_real_threading.RLock(), "RLock")

    def Condition(self, lock=None):
        aud = self._auditor
        node = aud._new_node("Condition")
        return AuditedCondition(aud, node, lock)

    def __getattr__(self, name):
        return getattr(_real_threading, name)


class LockOrderAuditor:
    def __init__(self, targets: "tuple[str, ...]" = DEFAULT_TARGETS):
        self.targets = targets
        self._mu = _real_threading.Lock()  # guards graph + findings
        self._serial = 0
        # adjacency: node -> {node}; edge A->B == "B acquired while A held"
        self._edges: "dict[_Node, set[_Node]]" = {}
        self._blocking: "list[Finding]" = []
        self._tls = _real_threading.local()
        self._saved_modules: "list[tuple[object, object]]" = []
        self._saved_globals: "list[tuple[object, str, object]]" = []
        self._saved_class_attrs: "list[tuple[type, str, object]]" = []
        self._installed = False

    # -- bookkeeping ------------------------------------------------------

    def _new_node(self, kind: str) -> _Node:
        site, line = _caller_site()
        with self._mu:
            self._serial += 1
            return _Node(site, line, self._serial)

    def _make(self, inner, kind: str) -> AuditedLock:
        return AuditedLock(self, inner, self._new_node(kind))

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _on_acquired(self, lock) -> None:
        st = self._stack()
        node = lock.node
        if any(h.node is node for h in st):
            st.append(lock)  # RLock reentry: no new edges
            return
        if st:
            with self._mu:
                for held in st:
                    if held.node is not node:
                        self._edges.setdefault(held.node, set()).add(node)
        st.append(lock)

    def _on_released(self, lock) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock or st[i].node is lock.node:
                del st[i]
                return

    def held_count(self) -> int:
        return len(self._stack())

    # -- logical-lock patches (namespace RW locks) ------------------------

    def _patch_logical(self) -> None:
        """Audit ``namespace._RWLock``'s LOGICAL read/write holds.

        The RW lock is built from a condition variable: the primitive is
        held only around counter updates, while the logical read/write
        hold spans the caller's critical section with NO primitive held.
        The primitive graph alone therefore cannot order the namespace
        lock against anything — patch the four acquire/release methods
        so the logical span sits on the held stack like a plain mutex.
        """
        from minio_tpu_torch.dsync import namespace

        aud = self
        cls = namespace._RWLock

        class _Handle:  # what _on_acquired/_on_released key on
            __slots__ = ("node",)

            def __init__(self, node):
                self.node = node

        def node_of(rw) -> _Node:
            node = rw.__dict__.get("_audit_node")
            if node is None:
                node = rw._audit_node = aud._new_node("RWLock")
            return node

        def make_acquire(original):
            def wrapper(rw, timeout=None):
                ok = original(rw, timeout)
                if ok:
                    aud._on_acquired(_Handle(node_of(rw)))
                return ok

            return wrapper

        def make_release(original):
            def wrapper(rw):
                aud._on_released(_Handle(node_of(rw)))
                return original(rw)

            return wrapper

        for name, wrap in (
            ("acquire_read", make_acquire),
            ("acquire_write", make_acquire),
            ("release_read", make_release),
            ("release_write", make_release),
        ):
            original = getattr(cls, name)
            self._saved_class_attrs.append((cls, name, original))
            setattr(cls, name, wrap(original))

    # -- blocking-call patches (MTPU302) ----------------------------------

    def _patch_blocking(self) -> None:
        aud = self

        def make(original, what):
            def wrapper(*args, **kwargs):
                st = getattr(aud._tls, "stack", None)
                if st:
                    site, line = _caller_site()
                    held = ", ".join(
                        h.node.site + ":" + str(h.node.line) for h in st
                    )
                    with aud._mu:
                        aud._blocking.append(
                            Finding(
                                "MTPU302",
                                site,
                                line,
                                f"{what} while holding lock(s) created at "
                                f"[{held}]",
                            )
                        )
                return original(*args, **kwargs)

            return wrapper

        for holder, name, what in (
            (time, "sleep", "time.sleep"),
            (socket, "create_connection", "socket.create_connection"),
            (subprocess, "run", "subprocess.run"),
        ):
            original = getattr(holder, name)
            self._saved_globals.append((holder, name, original))
            setattr(holder, name, make(original, what))

    # -- install / uninstall ----------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        import importlib

        proxy = _ThreadingProxy(self)
        for name in self.targets:
            mod = importlib.import_module(name)
            if getattr(mod, "threading", None) is _real_threading:
                self._saved_modules.append((mod, mod.threading))
                mod.threading = proxy
        self._patch_blocking()
        self._patch_logical()
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for mod, original in self._saved_modules:
            mod.threading = original
        self._saved_modules.clear()
        for holder, name, original in self._saved_globals:
            setattr(holder, name, original)
        self._saved_globals.clear()
        for cls, name, original in self._saved_class_attrs:
            setattr(cls, name, original)
        self._saved_class_attrs.clear()
        self._installed = False

    def installed(self):
        import contextlib

        @contextlib.contextmanager
        def cm():
            self.install()
            try:
                yield self
            finally:
                self.uninstall()

        return cm()

    # -- reporting --------------------------------------------------------

    def edge_labels(self) -> "list[tuple[str, str]]":
        """Observed (held -> acquired) creation-site pairs, sorted."""
        with self._mu:
            out = {
                (a.site + ":" + str(a.line), b.site + ":" + str(b.line))
                for a, succs in self._edges.items()
                for b in succs
            }
        return sorted(out)

    def cycles(self) -> "list[list[_Node]]":
        """Elementary cycles via iterative three-color DFS (dedup by set)."""
        with self._mu:
            edges = {a: set(b) for a, b in self._edges.items()}
        WHITE, GREY, BLACK = 0, 1, 2
        color: "dict[_Node, int]" = {}
        nodes = set(edges)
        for succs in edges.values():
            nodes |= succs
        found: "list[list[_Node]]" = []
        seen_sets: "set[frozenset]" = set()
        for root in sorted(nodes, key=lambda n: n.serial):
            if color.get(root, WHITE) != WHITE:
                continue
            stack = [(root, iter(sorted(edges.get(root, ()),
                                        key=lambda n: n.serial)))]
            path = [root]
            color[root] = GREY
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()
                    continue
                c = color.get(nxt, WHITE)
                if c == GREY:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(n.serial for n in cyc)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        found.append(cyc)
                elif c == WHITE:
                    color[nxt] = GREY
                    path.append(nxt)
                    stack.append(
                        (nxt, iter(sorted(edges.get(nxt, ()),
                                          key=lambda n: n.serial)))
                    )
            color[root] = BLACK
        return found

    def report(self) -> "list[Finding]":
        findings: "list[Finding]" = []
        for cyc in self.cycles():
            chain = " -> ".join(n.label() for n in cyc)
            first = cyc[0]
            findings.append(
                Finding(
                    "MTPU301",
                    first.site,
                    first.line,
                    f"lock-order cycle: {chain}",
                )
            )
        with self._mu:
            findings.extend(self._blocking)
        # dedupe (stress loops hit the same blocking site repeatedly)
        out, seen = [], set()
        for f in findings:
            k = (f.rule, f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                out.append(f)
        return out


def run_builtin_scenario() -> "list[Finding]":
    """The CLI's lock pass: a short deterministic stress of the local
    lock plane (namespace RW locks + LocalLocker grants) under audit.

    Small on purpose — the heavyweight concurrency coverage lives in
    tests/test_race.py, which reuses this auditor under its existing
    dsync stress helpers.
    """
    aud = LockOrderAuditor()
    with aud.installed():
        from minio_tpu_torch.dsync.drwmutex import LockArgs
        from minio_tpu_torch.dsync.local_locker import LocalLocker
        from minio_tpu_torch.dsync.namespace import NamespaceLock

        ns = NamespaceLock()
        ll = LocalLocker()
        errors: "list[BaseException]" = []

        def worker(tid: int) -> None:
            try:
                for i in range(25):
                    key = f"obj-{(tid + i) % 4}"
                    if (tid + i) % 3 == 0:
                        with ns.write("bucket", key, timeout=5.0):
                            pass
                    else:
                        with ns.read("bucket", key, timeout=5.0):
                            pass
                    args = LockArgs(
                        uid=f"u{tid}-{i}", resources=(key,), source="analysis"
                    )
                    if ll.lock(args):
                        ll.unlock(args)
                    else:
                        rargs = LockArgs(
                            uid=f"r{tid}-{i}",
                            resources=(key,),
                            source="analysis",
                        )
                        if ll.rlock(rargs):
                            ll.runlock(rargs)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [
            _real_threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        if errors:
            raise errors[0]

        # the per-disk I/O fan-out plane (parallel/iopool.py): a
        # private pool so the audited locks are created, exercised and
        # torn down entirely inside the audit window — queue cv's,
        # future locks, flusher cv, backpressure waits, quorum waits
        from minio_tpu_torch.parallel.iopool import IOPool, ShardFlusher

        pool = IOPool(queues=4, depth=2, name_prefix="iopool-audit")
        try:
            futs = [
                pool.submit(f"disk-{i % 6}", (lambda i=i: i * i))
                for i in range(24)
            ]
            for i, f in enumerate(futs):
                if f.result_or_raise(timeout=30) != i * i:
                    raise RuntimeError("iopool scenario result mismatch")
            fl = ShardFlusher(pool, quorum_exc=RuntimeError)
            jobs = [
                (s, f"disk-{s}", (lambda s=s: None), 64)
                for s in range(4)
            ]
            fl.flush(jobs, quorum=3)
            fl.drain()
        finally:
            pool.shutdown()

        # the internode fan-out workers (parallel/fanout.py): jobs on
        # two pools at once plus one on the calling thread, each taking
        # a namespace lock the way a lock-plane ask does
        from minio_tpu_torch.parallel.fanout import Fanout, run_all

        pools = [Fanout("fanout-audit-a", cap=2), Fanout("fanout-audit-b")]
        try:
            for r in range(3):
                hits: "list[int]" = []

                def job(i: int, r: int = r) -> None:
                    with ns.write("bucket", f"fan-{(i + r) % 3}", timeout=5.0):
                        hits.append(i)

                run_all(
                    [(pools[i % 2], (lambda i=i: job(i))) for i in range(6)]
                    + [(None, lambda: job(6))]
                )
                if sorted(hits) != list(range(7)):
                    raise RuntimeError("fanout scenario lost a job")
        finally:
            for p in pools:
                p.close()
    return aud.report()
