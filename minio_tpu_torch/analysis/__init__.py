"""minio_tpu_torch.analysis: the port's project-native static analysis.

The JAX package's six passes, retargeted to the port's seams:

* ``hotpath_lint``    - AST rules MTPU101-111 (host-device syncs in
  ops/ and codec/, swallowed exceptions, metric conventions, parity and
  Select readbacks outside their drains, hand-written placement specs,
  loop-blocking calls, read-cache invalidation, stale suppressions);
* ``abi_contracts``   - ctypes/ABI rules MTPU401-405 across the
  Python/CUDA seam (ops/kernels.py and ops/select_step.py against the
  ``extern "C"`` blocks of csrc/codec.cu and csrc/select.cu) and the
  native codec's (utils/native.py against csrc/gf_cpu.cc);
* ``kernel_contracts``- contracts MTPU201-204 for every kernel wrapper:
  the wrappers run on real tensors (the plain versions on the CPU, the
  kernels when the run asks for the card);
* ``lockorder``       - runtime lock-graph audit MTPU301-302;
* ``deviceflow``      - interprocedural device-dataflow rules
  MTPU501-505 (use-after-mutate, D2H escapes, thread-boundary captures,
  call-graph-deep blocking-under-async, registry drift) over the
  ``callgraph`` module's whole-tree call graph;
* ``lifecycle``       - interprocedural resource-lifecycle rules
  MTPU601-606 (leaked/double/unprotected acquires, use-after-transfer,
  resource-registry drift, config-knob drift) over the same call graph
  and the ``resource_registry`` table.

The rule ids are the JAX package's, so the two reports diff rule by
rule; MTPU102 (jit retrace) has no counterpart here and never fires.
The file-walking passes share one mtime-keyed AST cache
(``astcache.CACHE``) so a six-pass run parses each file exactly once,
and the deviceflow/lifecycle passes share one call-graph build.

Run ``python -m minio_tpu_torch.analysis`` (tier-1 runs the same
passes via tests/test_torch_analysis.py).  Suppress a deliberate
violation with ``# noqa: MTPU###`` and its reason on the offending
line - MTPU106 flags the noqa itself once the rule stops firing there,
so suppressions cannot rot.
"""

from __future__ import annotations

import os

from .findings import (  # noqa: F401
    JAX_ONLY_RULES,
    RULES,
    Finding,
    filter_suppressed,
    unused_suppressions,
)

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# the analyzers do not lint themselves (fixture-ish rule text and the
# deliberately-broad exception guards around abstract eval would need a
# noqa forest) — mirrors how linters ship their own excludes.
_EXCLUDE_PREFIXES = ("minio_tpu_torch/analysis/",)


def _excluded_dir_names() -> "tuple[str, ...]":
    # canonical list lives with the CLI (module-level constants only,
    # so the import cannot recurse)
    from .__main__ import EXCLUDED_DIR_NAMES

    return EXCLUDED_DIR_NAMES


def is_excluded(rel_path: str) -> bool:
    """True when a repo-relative path must not be analyzed."""
    parts = rel_path.replace(os.sep, "/").split("/")
    if any(p in _excluded_dir_names() for p in parts[:-1]):
        return True
    return rel_path.startswith(_EXCLUDE_PREFIXES)


def iter_py_files(paths: "list[str] | None" = None) -> "list[str]":
    """Repo-relative .py files under ``paths`` (default: minio_tpu_torch/).

    Honors the canonical directory exclusions even for explicitly
    passed paths: ``--paths minio_tpu_torch/build`` (or a file inside it) yields
    nothing rather than analyzing build artifacts.
    """
    roots = paths or ["minio_tpu_torch"]
    excluded = _excluded_dir_names()
    out: "list[str]" = []
    for root in roots:
        abs_root = os.path.join(REPO_ROOT, root)
        if os.path.isfile(abs_root):
            out.append(os.path.relpath(abs_root, REPO_ROOT))
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = [d for d in dirnames if d not in excluded]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(
                        os.path.relpath(
                            os.path.join(dirpath, fn), REPO_ROOT
                        )
                    )
    out = [p.replace(os.sep, "/") for p in out]
    return sorted(p for p in out if not is_excluded(p))


def _read_lines(rel_path: str) -> "list[str]":
    with open(
        os.path.join(REPO_ROOT, rel_path), encoding="utf-8"
    ) as fh:
        return fh.read().splitlines()


def run_lint(paths: "list[str] | None" = None) -> "list[Finding]":
    """Hot-path lint over the tree, noqa-filtered and stable-sorted.

    Includes MTPU106: every MTPU-coded noqa is audited against the
    PRE-filter findings of the file-anchored passes (lint, plus the
    ABI pass for the two binding modules), so a suppression whose rule no
    longer fires is itself a finding.
    """
    from . import abi_contracts
    from .astcache import CACHE
    from .hotpath_lint import lint_source

    findings: "list[Finding]" = []
    sources: "dict[str, list[str]]" = {}
    for rel in iter_py_files(paths):
        mod = CACHE.get(rel)
        sources[rel] = mod.lines
        if mod.tree is None:
            findings.append(
                Finding(
                    "MTPU100",
                    rel,
                    (mod.error.lineno or 1) if mod.error else 1,
                    "syntax error: "
                    + (mod.error.msg if mod.error else "unparseable"),
                )
            )
            continue
        raw = lint_source(rel, mod.text, tree=mod.tree)
        findings.extend(raw)
        raw_for_audit = list(raw)
        if rel in abi_contracts.binding_rels():
            raw_for_audit.extend(
                f for f in abi_contracts.raw_run() if f.path == rel
            )
        findings.extend(unused_suppressions(rel, mod.text, raw_for_audit))
    return sorted(
        filter_suppressed(findings, sources), key=Finding.sort_key
    )


def run_deviceflow_report(
    paths: "list[str] | None" = None,
    restrict: "set[str] | None" = None,
):
    """Deviceflow pass (MTPU501-505) with its callgraph report.

    Returns ``(findings, report)`` where findings are noqa-filtered
    (with the pass's own MTPU5xx staleness audit folded in) and
    ``report`` carries the call graph + timings for ``--json``.  The
    analysis is always whole-set — provenance is an interprocedural
    fact — but ``restrict`` (a repo-relative path set, e.g. the
    reverse-dependency closure of changed files) limits which files'
    findings are REPORTED, which is the sound form of --changed-only.
    """
    from .astcache import CACHE
    from .deviceflow import analyze_sources

    sources = CACHE.load(iter_py_files(paths))
    report = analyze_sources(sources)
    by_path: "dict[str, list[Finding]]" = {}
    for f in report.findings:
        by_path.setdefault(f.path, []).append(f)
    findings = list(report.findings)
    for rel, mod in sources.items():
        findings.extend(
            unused_suppressions(
                rel, mod.text, by_path.get(rel, []), prefixes=("MTPU5",)
            )
        )
    lines = {rel: mod.lines for rel, mod in sources.items()}
    findings = filter_suppressed(findings, lines)
    if restrict is not None:
        findings = [f for f in findings if f.path in restrict]
    return sorted(findings, key=Finding.sort_key), report


def run_deviceflow(
    paths: "list[str] | None" = None,
    restrict: "set[str] | None" = None,
) -> "list[Finding]":
    """Interprocedural device-dataflow checks (MTPU501-505)."""
    findings, _ = run_deviceflow_report(paths, restrict)
    return findings


def run_lifecycle_report(
    paths: "list[str] | None" = None,
    restrict: "set[str] | None" = None,
    graph=None,
):
    """Lifecycle pass (MTPU601-606) with its callgraph report.

    Mirrors ``run_deviceflow_report``: whole-set analysis (release
    credit is an interprocedural fact), ``restrict`` limits which
    files' findings are REPORTED for sound --changed-only, and
    ``graph`` lets a caller share the deviceflow pass's call-graph
    build.
    """
    from .astcache import CACHE
    from .lifecycle import analyze_sources

    sources = CACHE.load(iter_py_files(paths))
    report = analyze_sources(sources, graph=graph)
    by_path: "dict[str, list[Finding]]" = {}
    for f in report.findings:
        by_path.setdefault(f.path, []).append(f)
    findings = list(report.findings)
    for rel, mod in sources.items():
        findings.extend(
            unused_suppressions(
                rel, mod.text, by_path.get(rel, []), prefixes=("MTPU6",)
            )
        )
    lines = {rel: mod.lines for rel, mod in sources.items()}
    findings = filter_suppressed(findings, lines)
    if restrict is not None:
        findings = [f for f in findings if f.path in restrict]
    return sorted(findings, key=Finding.sort_key), report


def run_lifecycle(
    paths: "list[str] | None" = None,
    restrict: "set[str] | None" = None,
) -> "list[Finding]":
    """Interprocedural resource-lifecycle checks (MTPU601-606)."""
    findings, _ = run_lifecycle_report(paths, restrict)
    return findings


def run_abi() -> "list[Finding]":
    """ctypes/ABI contract checks over the CUDA library's seam."""
    from . import abi_contracts

    return sorted(abi_contracts.run(), key=Finding.sort_key)


def run_locks() -> "list[Finding]":
    """Lock-order audit over the built-in CLI scenario."""
    from .lockorder import run_builtin_scenario

    return sorted(run_builtin_scenario(), key=Finding.sort_key)


def run_all(
    paths: "list[str] | None" = None,
    skip: "set[str] | None" = None,
) -> "list[Finding]":
    findings, _, _, _ = run_all_timed(paths, skip)
    return findings


def run_all_timed(
    paths: "list[str] | None" = None,
    skip: "set[str] | None" = None,
    deviceflow_restrict: "set[str] | None" = None,
    device: "str | None" = None,
):
    """All passes, with per-pass wall time (``device``: where the
    contracts pass runs the kernel wrappers; by default the card when
    there is one, else the CPU).

    Returns ``(findings, pass_seconds, callgraph_stats,
    contract_stats)`` - ``contract_stats`` is the contracts pass's
    device, checks made and kernel launches per name (None when
    skipped);
    ``pass_seconds`` maps each pass that ran to its wall time (the
    analyzer's cost is tracked like a benchmark), ``callgraph_stats``
    is the deviceflow pass's graph summary (or None when skipped).
    """
    import time

    skip = skip or set()
    findings: "list[Finding]" = []
    pass_seconds: "dict[str, float]" = {}
    callgraph_stats = None

    def timed(name, fn):
        t0 = time.monotonic()
        findings.extend(fn())
        pass_seconds[name] = round(time.monotonic() - t0, 3)

    if "lint" not in skip:
        timed("lint", lambda: run_lint(paths))
    if "abi" not in skip:
        timed("abi", run_abi)
    contract_stats = None
    if "contracts" not in skip:
        from . import kernel_contracts

        t0 = time.monotonic()
        rep = kernel_contracts.run_report(device)
        findings.extend(rep.findings)
        pass_seconds["contracts"] = round(time.monotonic() - t0, 3)
        contract_stats = {"device": rep.device, "checked": rep.checked,
                          "launches": rep.launches}
    if "locks" not in skip:
        timed("locks", run_locks)
    shared_graph = None
    if "deviceflow" not in skip:
        t0 = time.monotonic()
        # a restrict set implies whole-tree analysis (the closure was
        # computed over the whole graph); otherwise honor --paths
        df, report = run_deviceflow_report(
            None if deviceflow_restrict is not None else paths,
            restrict=deviceflow_restrict,
        )
        findings.extend(df)
        pass_seconds["deviceflow"] = round(time.monotonic() - t0, 3)
        callgraph_stats = report.graph.stats()
        shared_graph = report.graph
    if "lifecycle" not in skip:
        t0 = time.monotonic()
        lc, lc_report = run_lifecycle_report(
            None if deviceflow_restrict is not None else paths,
            restrict=deviceflow_restrict,
            graph=shared_graph,
        )
        findings.extend(lc)
        pass_seconds["lifecycle"] = round(time.monotonic() - t0, 3)
        if callgraph_stats is None:
            callgraph_stats = lc_report.graph.stats()
    return (
        sorted(findings, key=Finding.sort_key),
        pass_seconds,
        callgraph_stats,
        contract_stats,
    )
