"""CLI: ``python -m minio_tpu_torch.analysis [--paths ...] [--json] [--skip ...]``.

Exit status 0 when the port's tree is clean, 1 when any finding
survives noqa filtering - the same contract tier-1 enforces through
tests/test_torch_analysis.py.  The flags are the JAX package's CLI's.

``--changed-only`` narrows the run to what the working tree actually
touches (vs HEAD, plus untracked files): lint runs over just the
changed .py files, and the tree-global passes (contracts, abi, locks)
run only when a file they audit changed.  The deviceflow and lifecycle
passes are interprocedural, so prefix gating would be UNSOUND for them
— editing a callee can create or remove a finding in a caller —
instead they always analyze the whole tree and report findings for the
reverse-dependency closure of the changed files over the call graph.
This keeps the gate fast as the tree grows without weakening a full
run.

``--json`` emits ``{"findings": [...], "passes": {pass: seconds},
"callgraph": {nodes, edges, boundary_edges, seconds}, "contracts":
{device, checked, launches}}`` so analyzer cost is tracked like a
benchmark.  The contracts pass runs the kernels on the card when there
is one, each output held against its plain version, and the JSON counts
their launches; without a card it runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# Canonical directory exclusions for every file-walking pass.  These are
# names, matched against any path component: build artifacts
# (minio_tpu_torch/build/ holds the kernel library and the generated
# header) and bytecode caches must never be analyzed, even when a
# user passes them explicitly via --paths.
EXCLUDED_DIR_NAMES = ("__pycache__", "build", ".git", ".claude")

# What each tree-global pass actually audits, for --changed-only: the
# pass runs iff a changed path matches one of its prefixes.
PASS_TRIGGER_PREFIXES = {
    "contracts": (
        "minio_tpu_torch/ops/",
        "minio_tpu_torch/csrc/",
        "minio_tpu_torch/parallel/",
        "minio_tpu_torch/analysis/kernel_contracts.py",
    ),
    "abi": (
        "minio_tpu_torch/ops/kernels.py",
        "minio_tpu_torch/ops/select_step.py",
        "minio_tpu_torch/utils/native.py",
        "minio_tpu_torch/csrc/",
        "minio_tpu_torch/analysis/abi_contracts.py",
    ),
    "locks": (
        "minio_tpu_torch/dsync/",
        "minio_tpu_torch/storage/metered.py",
        "minio_tpu_torch/storage/diskcheck.py",
        "minio_tpu_torch/parallel/iopool.py",
        "minio_tpu_torch/parallel/fanout.py",
        "minio_tpu_torch/analysis/lockorder.py",
    ),
}

PASSES = ("lint", "abi", "contracts", "locks", "deviceflow", "lifecycle")


def _changed_files(repo_root: str) -> "set[str]":
    """Repo-relative paths changed vs HEAD, plus untracked files."""
    out: "set[str]" = set()
    for args in (
        ["diff", "--name-only", "HEAD"],
        ["ls-files", "--others", "--exclude-standard"],
    ):
        r = subprocess.run(
            ["git", "-C", repo_root, *args],
            capture_output=True,
            text=True,
        )
        if r.returncode == 0:
            out.update(
                ln.strip() for ln in r.stdout.splitlines() if ln.strip()
            )
    return out


def main(argv: "list[str] | None" = None) -> int:
    from . import JAX_ONLY_RULES, REPO_ROOT, RULES, run_all_timed

    ap = argparse.ArgumentParser(
        prog="python -m minio_tpu_torch.analysis",
        description="the PyTorch/CUDA port's project-native static "
        "analysis "
        "(hot-path lint, ABI contracts, kernel contracts, lock-order "
        "audit, interprocedural device-dataflow, resource-lifecycle "
        "must-release)",
        epilog="directories named "
        + ", ".join(EXCLUDED_DIR_NAMES)
        + " are always excluded from file-walking passes",
    )
    ap.add_argument(
        "--paths",
        nargs="*",
        default=None,
        help="repo-relative files/dirs to lint (default: "
        "minio_tpu_torch/); "
        "contract, abi and lock passes are tree-global regardless",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="emit a JSON object: stable-sorted findings, per-pass "
        "wall-time seconds, and call-graph stats (diffable)",
    )
    ap.add_argument(
        "--skip",
        nargs="*",
        default=[],
        choices=list(PASSES),
        help="passes to skip",
    )
    ap.add_argument(
        "--changed-only",
        action="store_true",
        help="analyze only what the working tree changes vs HEAD "
        "(lint: changed .py files; tree-global passes: run only when "
        "a file they audit changed)",
    )
    ap.add_argument(
        "--list-rules",
        action="store_true",
        help="print the MTPU rule catalog and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            tag = " [JAX-only; never fires]" if rule in JAX_ONLY_RULES else ""
            print(f"{rule}{tag}  {desc}")
        return 0

    skip = set(args.skip)
    paths = args.paths
    deviceflow_restrict = None
    suffix = ""
    if args.changed_only:
        suffix = ", changed-only"
        changed = _changed_files(REPO_ROOT)
        lint_paths = sorted(
            p
            for p in changed
            if p.endswith(".py") and p.startswith("minio_tpu_torch/")
        )
        if lint_paths:
            paths = lint_paths
        else:
            skip.add("lint")
        for pass_name, prefixes in PASS_TRIGGER_PREFIXES.items():
            if not any(p.startswith(prefixes) for p in changed):
                skip.add(pass_name)
        if lint_paths:
            # deviceflow/lifecycle findings are interprocedural:
            # analyze the whole tree, report for the changed files PLUS
            # everything that transitively calls into them (prefix
            # gating would silently skip a caller whose callee just
            # changed); both passes share this one closure
            deviceflow_restrict = _reverse_closure(set(lint_paths))
        else:
            skip.add("deviceflow")
            skip.add("lifecycle")

    findings, pass_seconds, callgraph_stats, contract_stats = run_all_timed(
        paths=paths,
        skip=skip,
        deviceflow_restrict=deviceflow_restrict,
    )

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.to_dict() for f in findings],
                    "passes": pass_seconds,
                    "callgraph": callgraph_stats,
                    "contracts": contract_stats,
                },
                indent=2,
                sort_keys=True,
            )
        )
    else:
        for f in findings:
            print(f.render())
    # the summary goes to stderr in both modes (stdout stays one JSON
    # object under --json)
    ran = [p for p in PASSES if p not in skip]
    print(
        f"minio_tpu_torch.analysis: {len(findings)} finding(s) "
        f"[{', '.join(ran) or 'nothing to run'}{suffix}]",
        file=sys.stderr,
    )
    return 1 if findings else 0


def _reverse_closure(changed: "set[str]") -> "set[str]":
    """Changed files plus every file that transitively calls into them,
    over the whole-tree call graph (the sound --changed-only set for
    the interprocedural pass)."""
    from . import iter_py_files
    from .astcache import CACHE
    from .callgraph import build

    graph = build(CACHE.load(iter_py_files()))
    return graph.reverse_file_closure(changed)


if __name__ == "__main__":
    sys.exit(main())
