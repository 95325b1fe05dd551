"""Findings, the rule catalog, and inline suppression.

The project-native analogue of Go's vet/staticcheck diagnostics: every
analyzer pass (hot-path lint, ABI and kernel contract checkers,
lock-order auditor, dataflow and lifecycle passes) emits ``Finding`` records carrying a stable ``MTPU###`` rule id
so future PRs can diff reports, gate CI on exact rule sets, and suppress
individual sites with ``# noqa: MTPU###`` where a violation is a
documented, deliberate exception.
"""

from __future__ import annotations

import dataclasses
import re

# Rule catalog.  1xx = hot-path lint (AST), 2xx = kernel contract
# checker (the wrappers run on real tensors), 3xx = lock-order auditor
# (runtime shim), 4xx = ctypes/ABI contract checker (the CUDA library's
# seam), 5xx = device dataflow, 6xx = resource lifecycle and knobs.  The
# ids are the JAX package's, so the two packages' reports diff rule by
# rule.
RULES: "dict[str, str]" = {
    "MTPU101": (
        "host-device sync (.item() / .tolist() / .cpu() / .numpy() / "
        "torch.cuda.synchronize() / Event.synchronize() / np.asarray of "
        "a tensor) in a device-only module (minio_tpu_torch/ops/, "
        "codec/) outside a host-boundary function"
    ),
    "MTPU102": (
        "retrace bomb: a jax.jit function's plain-Python parameter "
        "outside static_argnames. The port has no jax.jit (its kernels "
        "are instantiated per geometry), so the rule never fires here"
    ),
    "MTPU103": (
        "silently swallowed failure: `except Exception/BaseException/"
        "bare except` whose body is only pass/..."
    ),
    "MTPU104": (
        "prometheus metric-name convention: family must be "
        "miniotpu_-prefixed lowercase, counters must end in _total"
    ),
    "MTPU105": (
        "prometheus label-key hygiene: label keys must match "
        "[a-z_][a-z0-9_]*"
    ),
    "MTPU106": (
        "unused suppression: a `# noqa: MTPU###` whose rule does not "
        "fire on that line (stale suppressions rot; silence MTPU106 "
        "itself on the line to keep one deliberately)"
    ),
    "MTPU107": (
        "eager parity readback: .cpu()/.numpy()/.tolist()/np.asarray of a "
        "device parity tensor outside the drain seams (_drain_* / *_end "
        "/ drain) in minio_tpu_torch/ops or codec/backend.py "
        "(re-introduces the D2H round-trip the digest-only PUT path "
        "removed)"
    ),
    "MTPU108": (
        "event-loop-blocking call inside an async def under "
        "minio_tpu_torch/server/: time.sleep, raw socket send/recv, or a "
        "Future.result()/Event.wait() that is not awaited (one stalled "
        "coroutine stalls every connection; route blocking work through "
        "the worker-pool bridge)"
    ),
    "MTPU109": (
        "hand-written axis-name spec tuple in minio_tpu_torch/parallel "
        "or minio_tpu_torch/ops outside parallel/rules.py: a plane's "
        "placement must come from the partition-rule table "
        "(rules.spec_for), the single source of truth the mesh's "
        "placement cache fingerprints"
    ),
    "MTPU110": (
        "object-data mutation outside the read-cache invalidation seam: "
        "a function in objectlayer/erasure_object.py or "
        "erasure_multipart.py that calls rename_data/delete_version (or "
        "delete_file/write_metadata/update_metadata on a non-SYS_VOL "
        "volume) must also call the invalidation seam "
        "(_invalidate_read_cache / cache.invalidate_object), or peers "
        "serve stale cached groups and FileInfo"
    ),
    "MTPU111": (
        "eager S3-Select readback: .cpu()/.numpy()/.tolist()/.item()/"
        "np.asarray in s3select/device.py outside the result-drain seam "
        "(functions whose name contains 'drain'); only candidate row "
        "bytes may cross D2H, or the pushdown degenerates into a "
        "whole-plane host scan"
    ),
    "MTPU201": (
        "kernel contract: wrong output dtype from a kernel wrapper"
    ),
    "MTPU202": (
        "kernel contract: wrong output shape from a kernel wrapper (or "
        "the wrapper raised, or a CUDA output differs from its plain "
        "version)"
    ),
    "MTPU203": (
        "kernel contract: encode->reconstruct round trip broken (shape "
        "or value)"
    ),
    "MTPU204": (
        "kernel contract: a function that launches a kernel (bumps "
        "kernels.LAUNCHES or calls the ctypes library) has no "
        "registered contract check"
    ),
    "MTPU301": "lock-order cycle in the observed acquisition graph",
    "MTPU302": (
        "blocking call (sleep / socket connect / subprocess) while "
        "holding a registered hot-path lock"
    ),
    "MTPU401": (
        "ABI contract: ctypes binding arity differs from the CUDA "
        "export's C parameter count (or annotation disagrees with the "
        "C signature)"
    ),
    "MTPU402": (
        "ABI contract: argtypes/restype of a ctypes binding, or of the "
        "export's `// @ctypes` annotation, drift from the ctypes its C "
        "prototype's types map to (or a C type has no mapping)"
    ),
    "MTPU403": (
        "ABI contract: exported symbol with no ctypes binding, or a "
        "binding for a symbol the library does not export"
    ),
    "MTPU404": (
        "ABI contract: a tensor's .data_ptr() passed to a launch (or "
        "packed into its argument struct) with a length argument "
        "computed from a different tensor's shape"
    ),
    "MTPU405": (
        "ABI contract: a tensor reaches .data_ptr() without contiguity "
        "evidence (.contiguous() / a fresh allocation / an is_contiguous "
        "check)"
    ),
    "MTPU501": (
        "device dataflow: use-after-mutate - a value passed at an "
        "in-place position of a registered kernel wrapper (the "
        "accumulator of a sub-chunk step) is read again afterwards "
        "instead of the wrapper's returned value (the JAX package's "
        "use-after-donate)"
    ),
    "MTPU502": (
        "device dataflow: interprocedural D2H escape - a "
        "device-provenance value (return of a registered kernel "
        "wrapper, through any chain of calls) reaches .cpu() / "
        ".numpy() / .item() / .tolist() / np.asarray / bytes() / "
        "tensor_to_words outside a registered drain seam"
    ),
    "MTPU503": (
        "device dataflow: device value captured across a thread/loop "
        "boundary (iopool.submit*, worker-pool submit/spawn_stream, "
        "run_coroutine_threadsafe, run_in_executor, Thread(target=)) "
        "without materialization - the D2H becomes a hidden sync on an "
        "arbitrary thread"
    ),
    "MTPU504": (
        "device dataflow: call-graph-deep blocking-under-async - a "
        "blocking call (time.sleep, raw socket I/O, Future.result(), "
        "non-asyncio .wait()) in a sync function reachable from a "
        "minio_tpu_torch/server async def through plain calls, so it "
        "runs on the event loop (worker-pool boundary edges exempt the "
        "sanctioned sync-def bridges)"
    ),
    "MTPU505": (
        "device dataflow: registry drift - kernel_contracts declares a "
        "kernel wrapper, in-place position, or drain seam the tree "
        "does not have, or the tree has one the registry misses"
    ),
    "MTPU601": (
        "resource lifecycle: leaked acquire - a registered resource "
        "(staging-ledger reservation, admission token, parity ref, "
        "io-pool future, rw-lock, fault hang) is acquired and a path "
        "reaches function exit without a matching release or a "
        "registered ownership transfer"
    ),
    "MTPU602": (
        "resource lifecycle: double release - the same acquisition is "
        "released twice on one path"
    ),
    "MTPU603": (
        "resource lifecycle: unprotected hold - an acquired resource is "
        "held across a raisable call without a try/finally (or `with`) "
        "guaranteeing its release"
    ),
    "MTPU604": (
        "resource lifecycle: use after ownership transfer - a resource "
        "handed to a registered transfer seam (async handle, band "
        "adopt, caller-owned return) is released or re-used afterwards "
        "by the original holder"
    ),
    "MTPU605": (
        "resource lifecycle: registry drift - resource_registry names "
        "an acquire/release/transfer function the call graph does not "
        "have, or an acquire-shaped API in a registered resource module "
        "has no registry entry"
    ),
    "MTPU606": (
        "config-knob drift: a MINIO_TPU_* environment knob is read "
        "without a minio_tpu_torch/config/knobs.py registry entry, or a "
        "registered knob is missing from README.md's table of the "
        "port's knobs, or a registry entry names a knob nothing reads"
    ),
}

# Rules of the JAX package that have no counterpart in the port: they
# stay in the catalog (the ids line up across packages) and never fire.
JAX_ONLY_RULES = frozenset({"MTPU102"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id + location + message.

    ``path`` is repo-relative where the finding is file-anchored;
    runtime passes anchor at the closest code object they can name.
    """

    rule: str
    path: str
    line: int
    message: str

    def sort_key(self):
        return (self.path, self.line, self.rule, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+[0-9]+(?:\s*,\s*[A-Z]+[0-9]+)*))?",
)


def noqa_codes_for_line(line: str) -> "set[str] | None":
    """Suppression codes on a source line.

    Returns None when the line carries no noqa directive, the empty set
    for a bare ``# noqa`` (suppress everything), else the specific codes.
    """
    m = _NOQA_RE.search(line)
    if m is None:
        return None
    codes = m.group("codes")
    if not codes:
        return set()
    return {c.strip() for c in codes.split(",")}


def filter_suppressed(
    findings: "list[Finding]", source_lines: "dict[str, list[str]]"
) -> "list[Finding]":
    """Drop findings whose source line carries a matching noqa.

    ``source_lines`` maps finding paths to their file's lines; findings
    for paths not in the map (runtime findings) pass through untouched.
    """
    out = []
    for f in findings:
        lines = source_lines.get(f.path)
        if lines is not None and 1 <= f.line <= len(lines):
            codes = noqa_codes_for_line(lines[f.line - 1])
            if codes is not None and (not codes or f.rule in codes):
                continue
        out.append(f)
    return out


# Only codes of the file-anchored passes are audited for staleness: 1xx
# (lint) and 4xx (ABI) anchor at source lines, so "does it fire here"
# is well-defined — the deviceflow pass audits its own 5xx codes the
# same way, passing its prefix explicitly.  Foreign codes (BLE001,
# F401, ...) belong to other tools; MTPU106 on a line is the sanctioned
# keep-this-suppression escape hatch and MTPU100 is the syntax-error
# sentinel.
_AUDITED_PREFIXES = ("MTPU1", "MTPU4")
_AUDIT_EXEMPT = ("MTPU100", "MTPU106")


def unused_suppressions(
    rel_path: str,
    text: str,
    raw_findings: "list[Finding]",
    prefixes: "tuple[str, ...]" = _AUDITED_PREFIXES,
) -> "list[Finding]":
    """MTPU106: noqa'd MTPU rules that do not fire on their line.

    ``raw_findings`` must be PRE-noqa-filter findings for this file
    from every file-anchored pass whose codes ``prefixes`` covers —
    otherwise a working suppression looks unused.  Comments are found
    with tokenize, so a ``# noqa:`` inside a docstring is ignored.
    """
    import io
    import tokenize

    fired: "dict[int, set[str]]" = {}
    for f in raw_findings:
        fired.setdefault(f.line, set()).add(f.rule)
    out: "list[Finding]" = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out  # broken files are MTPU100's problem, not ours
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        codes = noqa_codes_for_line(tok.string)
        if not codes:
            continue  # no noqa, or a bare one (out of audit scope)
        line = tok.start[0]
        for code in sorted(codes):
            if not code.startswith(prefixes):
                continue
            if code in _AUDIT_EXEMPT:
                continue
            if code not in fired.get(line, ()):
                out.append(
                    Finding(
                        "MTPU106",
                        rel_path,
                        line,
                        f"unused suppression: {code} does not fire on "
                        "this line; drop the noqa (or add MTPU106 to "
                        "it to keep deliberately)",
                    )
                )
    return out
