"""Tier-1 gate of the port's static analysis (``minio_tpu_torch.analysis``).

* The gate: ``python -m minio_tpu_torch.analysis --json`` over the
  port's tree exits 0 with no finding, and its summary names the six
  passes (one run for the module).
* Every rule that can fire in the port fires on its bad fixture at the
  exact line (``# VIOLATION: MTPU###`` markers) and is silent on its good
  one.  Fixtures are source strings here, or the JAX package's fixtures
  under tests/data/analysis/ read as they are.
* The rules that carry over (103-106, 108, 110, 301-302, 503-504,
  601-604) give the same (rule, line) findings through both packages on
  the same sources, each under its own path prefix.
* The ABI seam, the contract registry's closure (MTPU204), the lock
  shim and the CLI's flags.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from minio_tpu.analysis import deviceflow as jdeviceflow
from minio_tpu.analysis import hotpath_lint as jlint
from minio_tpu.analysis import lifecycle as jlifecycle
from minio_tpu.analysis import lockorder as jlockorder
from minio_tpu.analysis.astcache import parse_source as jparse
from minio_tpu.analysis.findings import unused_suppressions as junused
from minio_tpu_torch import analysis
from minio_tpu_torch.analysis import (
    __main__ as cli,
    abi_contracts,
    deviceflow,
    kernel_contracts,
    lifecycle,
    lockorder,
)
from minio_tpu_torch.analysis.astcache import parse_source
from minio_tpu_torch.analysis.findings import (
    JAX_ONLY_RULES,
    RULES,
    filter_suppressed,
    noqa_codes_for_line,
    unused_suppressions,
)
from minio_tpu_torch.analysis.hotpath_lint import lint_source
from minio_tpu_torch.ops import kernels, select_step
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = analysis.REPO_ROOT
FIXTURES = os.path.join(ROOT, "tests", "data", "analysis")
_MARKER_RE = re.compile(r"(?:#|//)\s*VIOLATION:\s*(MTPU\d{3})")
PASSES = ("lint", "abi", "contracts", "locks", "deviceflow", "lifecycle")
PASS_PREFIXES = {
    "lint": ("MTPU1",), "abi": ("MTPU4",), "contracts": ("MTPU2",),
    "locks": ("MTPU3",), "deviceflow": ("MTPU5",), "lifecycle": ("MTPU6",),
}


def _markers(text: str) -> set:
    return {
        (m.group(1), i)
        for i, line in enumerate(text.splitlines(), 1)
        for m in _MARKER_RE.finditer(line)
    }


def _fixture(name: str) -> str:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read()


def _port_text(text: str) -> str:
    """A JAX fixture's source as the port would write it: the package
    and the entry points renamed, line for line."""
    return (
        text.replace("minio_tpu.", "minio_tpu_torch.")
        .replace("encode_and_hash_words_digest", "encode_words_fused1")
        .replace("codec_step.encode_and_hash(", "codec_step.tensor_to_words(")
    )


def _lint(rel: str, text: str) -> list:
    """Lint + unused-suppression audit, noqa-filtered, as run_lint."""
    raw = lint_source(rel, text)
    found = raw + unused_suppressions(rel, text, raw)
    return filter_suppressed(found, {rel: text.splitlines()})


def _jlint(rel: str, text: str) -> list:
    raw = jlint.lint_source(rel, text)
    found = raw + junused(rel, text, raw)
    return filter_suppressed(found, {rel: text.splitlines()})


def _rl(findings) -> set:
    return {(f.rule, f.line) for f in findings}


# ---------------------------------------------------------------------------
# The gate: the CLI over the port's tree, once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gate():
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.analysis", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    return {"rc": r.returncode, "out": r.stdout, "err": r.stderr,
            "doc": json.loads(r.stdout) if r.stdout.strip() else None,
            "seconds": time.monotonic() - t0}


def test_gate_cli_exits_zero_with_no_findings(gate):
    assert gate["doc"] is not None, gate["err"]
    assert gate["doc"]["findings"] == [], json.dumps(
        gate["doc"]["findings"], indent=1)
    assert gate["rc"] == 0, gate["err"]


def test_gate_summary_names_the_six_passes(gate):
    summary = gate["err"].strip().splitlines()[-1]
    assert summary == (
        "minio_tpu_torch.analysis: 0 finding(s) "
        "[lint, abi, contracts, locks, deviceflow, lifecycle]"
    )


@pytest.mark.parametrize("name", PASSES)
def test_gate_pass_ran_clean(gate, name):
    doc = gate["doc"]
    assert name in doc["passes"] and doc["passes"][name] >= 0
    assert not [f for f in doc["findings"]
                if f["rule"].startswith(PASS_PREFIXES[name])]


def test_gate_json_reports_the_contract_run(gate):
    doc = gate["doc"]["contracts"]
    assert doc["device"] == "cpu" and doc["checked"] > 150
    assert doc["launches"] == {}  # the plain versions launch nothing


def test_gate_json_reports_the_call_graph(gate):
    cgs = gate["doc"]["callgraph"]
    assert set(cgs) == {"nodes", "edges", "boundary_edges", "seconds"}
    assert cgs["nodes"] > 1000 and cgs["boundary_edges"] > 10


# ---------------------------------------------------------------------------
# MTPU1xx: the port's own lint fixtures (path-scoped rules)
# ---------------------------------------------------------------------------

LINT_FIXTURES = {
    # MTPU101: syncs in a device-only module outside host boundaries
    "bad_101": ("minio_tpu_torch/ops/fixture.py", '''
import numpy as np
import torch


def step(words: torch.Tensor):
    n = words.sum().item()  # VIOLATION: MTPU101
    rows = words.tolist()  # VIOLATION: MTPU101
    torch.cuda.synchronize()  # VIOLATION: MTPU101
    host = words.cpu()  # VIOLATION: MTPU101
    return np.asarray(words), n, rows, host  # VIOLATION: MTPU101


def made(k):
    t = torch.zeros(k)
    ev = torch.cuda.Event()
    ev.synchronize()  # VIOLATION: MTPU101
    return np.array(t)  # VIOLATION: MTPU101
'''),
    "good_101": ("minio_tpu_torch/ops/fixture.py", '''
import numpy as np
import torch


def host_readback(words: torch.Tensor):
    return words.cpu().numpy(), words.sum().item()


def d2h_finish(ev, pinned):
    ev.synchronize()
    return pinned.numpy()


def _drain_rows(t):
    return t.tolist()


def step(words: torch.Tensor, table):
    return np.asarray(table), words.shape[0]
'''),
    # MTPU107: parity readback outside the drain seams
    "bad_107": ("minio_tpu_torch/codec/backend.py", '''
import numpy as np


def encode_begin(words, m):
    parity, digests = run(words, m)
    # a readback in the backend is a sync there too (MTPU101)
    eager = parity.cpu()  # VIOLATION: MTPU107  # VIOLATION: MTPU101
    rows = np.asarray(parity_w)  # VIOLATION: MTPU107
    return digests, eager, rows, par.tolist()  # VIOLATION: MTPU107  # VIOLATION: MTPU101
'''),
    "good_107": ("minio_tpu_torch/codec/backend.py", '''
import numpy as np


def encode_end(handle):
    return handle.parity.cpu().numpy()


def _drain_raw(parity_w):
    return np.asarray(parity_w.cpu())


def encode_begin(words, m):
    parity, digests = run(words, m)
    return digests, parity
'''),
    # MTPU109: spec tuples outside parallel/rules.py
    "bad_109": ("minio_tpu_torch/parallel/fixture.py", '''
def place(mesh, x):
    spec = ("stripe", "shard", None)  # VIOLATION: MTPU109
    return put(mesh, x, spec), put(mesh, x, (("stripe", "shard"), None))  # VIOLATION: MTPU109
'''),
    "good_109": ("minio_tpu_torch/parallel/fixture.py", '''
class Mesh:
    axis_names = ("stripe", "shard")


def place(mesh, x):
    sizes = (mesh.shape["stripe"], mesh.shape["shard"])
    return put(mesh, x, rules.spec_for("stripe_words")), sizes, ("a", None)
'''),
    # MTPU111: select readbacks outside the drains
    "bad_111": ("minio_tpu_torch/s3select/device.py", '''
import numpy as np


def scan(arr, cand):
    rows = cand.cpu()  # VIOLATION: MTPU111
    flags = np.asarray(cand)  # VIOLATION: MTPU111
    return rows, flags, arr.sum().item()  # VIOLATION: MTPU111
'''),
    "good_111": ("minio_tpu_torch/s3select/device.py", '''
import numpy as np


def _drain_array(dev):
    return dev.cpu().numpy()


def drain_plane(dev, n):
    return np.asarray(dev.cpu())[:n].tobytes()


def scan(arr, cand, starts):
    return [s for s in starts.tolist()], np.frombuffer(b"x", np.uint8)
'''),
}


@pytest.mark.parametrize("name", sorted(LINT_FIXTURES))
def test_port_lint_fixture(name):
    rel, text = LINT_FIXTURES[name]
    text = textwrap.dedent(text)
    want = _markers(text)
    assert bool(want) == name.startswith("bad_")
    assert _rl(_lint(rel, text)) == want


@pytest.mark.parametrize("name,rel", [
    ("bad_101", "minio_tpu_torch/server/fixture.py"),
    ("bad_107", "minio_tpu_torch/server/fixture.py"),
    ("bad_109", "minio_tpu_torch/parallel/rules.py"),
    ("bad_109", "minio_tpu_torch/server/fixture.py"),
    ("bad_111", "minio_tpu_torch/s3select/engine.py"),
])
def test_port_lint_rules_are_path_scoped(name, rel):
    _rel, text = LINT_FIXTURES[name]
    assert _lint(rel, textwrap.dedent(text)) == []


def test_mtpu101_drain_seams_of_the_registry_are_boundaries():
    text = "def tensor_to_words(t):\n    return t.cpu().numpy()\n"
    assert _lint("minio_tpu_torch/ops/codec_step.py", text) == []
    assert _rl(_lint("minio_tpu_torch/ops/other.py", text)) == {
        ("MTPU101", 2)}


def test_mtpu102_never_fires_in_the_port():
    text = _fixture("bad_mtpu102.py")
    assert not [f for f in _lint("minio_tpu_torch/ops/x.py", text)
                if f.rule == "MTPU102"]
    assert "MTPU102" in JAX_ONLY_RULES and "MTPU102" in RULES


def test_syntax_error_becomes_mtpu100():
    found = lint_source("minio_tpu_torch/ops/broken.py", "def f(:\n")
    assert [f.rule for f in found] == ["MTPU100"]


def test_mtpu108_fires_on_the_shipped_aio_module_if_seeded():
    with open(os.path.join(ROOT, "minio_tpu_torch/server/aio.py")) as fh:
        src = fh.read()
    seeded = re.sub(r"(\n    async def \w+\(self[^\n]*\n)",
                    r"\n    async def _seeded(self):\n        time.sleep(1)\n\1",
                    src, count=1)
    assert seeded != src
    assert any(f.rule == "MTPU108"
               for f in lint_source("minio_tpu_torch/server/aio.py", seeded))


# ---------------------------------------------------------------------------
# MTPU1xx that carry over: the JAX fixtures through both packages
# ---------------------------------------------------------------------------

CARRY_LINT = [
    ("bad_mtpu103.py", "tests/data/analysis/"),
    ("good_mtpu103.py", "tests/data/analysis/"),
    ("bad_mtpu104.py", "tests/data/analysis/"),
    ("good_mtpu104.py", "tests/data/analysis/"),
    ("bad_mtpu105.py", "tests/data/analysis/"),
    ("good_mtpu105.py", "tests/data/analysis/"),
    ("bad_mtpu106.py", "tests/data/analysis/"),
    ("good_mtpu106.py", "tests/data/analysis/"),
    ("noqa_suppressed.py", "tests/data/analysis/"),
    ("noqa_wrong_code.py", "tests/data/analysis/"),
    ("bad_mtpu108.py", "{pkg}/server/"),
    ("good_mtpu108.py", "{pkg}/server/"),
    ("bad_mtpu110.py", "{pkg}/objectlayer/erasure_object.py"),
    ("bad_mtpu110.py", "{pkg}/objectlayer/erasure_multipart.py"),
    ("good_mtpu110.py", "{pkg}/objectlayer/erasure_object.py"),
]


def _carry_rel(where: str, pkg: str, name: str) -> str:
    rel = where.format(pkg=pkg)
    return rel + name if rel.endswith("/") else rel


@pytest.mark.parametrize("name,where", CARRY_LINT)
def test_carried_lint_rule_matches_the_jax_package(name, where):
    text = _fixture(name)
    port = _rl(_lint(_carry_rel(where, "minio_tpu_torch", name), text))
    jax = _rl(_jlint(_carry_rel(where, "minio_tpu", name), text))
    assert port == jax
    if name.startswith("bad_"):
        assert port == _markers(text) and port


# ---------------------------------------------------------------------------
# noqa
# ---------------------------------------------------------------------------


def test_noqa_parsing():
    assert noqa_codes_for_line("x = 1") is None
    assert noqa_codes_for_line("x  # noqa") == set()
    assert noqa_codes_for_line(
        "x  # noqa: MTPU601,MTPU603 - by design") == {"MTPU601", "MTPU603"}


def test_every_port_suppression_carries_a_reason():
    """A ``# noqa: MTPU###`` in the port must say why on its line."""
    bare = []
    for rel in analysis.iter_py_files():
        with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                m = re.search(r"#\s*noqa:\s*(MTPU\d{3}(?:\s*,\s*MTPU\d{3})*)(.*)$",
                              line)
                if m and not re.search(r"\w", m.group(2)):
                    bare.append(f"{rel}:{i}")
    assert bare == []


# ---------------------------------------------------------------------------
# MTPU4xx: the ABI seam
# ---------------------------------------------------------------------------

ABI_CU = """
extern "C" {
// @ctypes mtt_demo(c_int, c_void_p, c_int64) -> c_int
int mtt_demo(int device, const uint32_t* words, long long n) {
  return 0;
}
// @ctypes mtt_args(c_char_p) -> c_int
int mtt_args(const DemoArgs* a) {
  return 0;
}
}
"""

ABI_GOOD = '''
import ctypes
import struct

_ARGS = struct.Struct("<2Qq")


def _load():
    lib = ctypes.CDLL("libdemo.so")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mtt_demo.argtypes = [I, P, ctypes.c_int64]
    for fn in (lib.mtt_demo, lib.mtt_args):
        fn.restype = ctypes.c_int
    lib.mtt_args.argtypes = [ctypes.c_char_p]
    return lib


def _launch(words, out, n):
    _load().mtt_args(_ARGS.pack(words.data_ptr(), out.data_ptr(), n))


def demo(words, out):
    _require_cuda(words, "demo", 2)
    out = torch.empty_like(words)
    n = words.numel()
    _load().mtt_demo(0, words.data_ptr(), n)
    _launch(words, out, words.shape[0])
    if not out.is_contiguous():
        raise ValueError("demo")
    return out
'''

ABI_BAD = {
    # arity: the binding declares two argtypes for a three-parameter export
    "bad_401": ('''
import ctypes


def _load():
    lib = ctypes.CDLL("libdemo.so")
    lib.mtt_demo.argtypes = [ctypes.c_int, ctypes.c_void_p]  # VIOLATION: MTPU401
    lib.mtt_args.argtypes = [ctypes.c_char_p]
    return lib
''', ABI_CU),
    # type drift against the @ctypes annotation, argtypes and restype
    "bad_402": ('''
import ctypes


def _load():
    lib = ctypes.CDLL("libdemo.so")
    P = ctypes.c_char_p
    lib.mtt_demo.argtypes = [ctypes.c_int, P, ctypes.c_int64]  # VIOLATION: MTPU402
    lib.mtt_args.argtypes = [ctypes.c_char_p]
    lib.mtt_args.restype = ctypes.c_void_p  # VIOLATION: MTPU402
    return lib
''', ABI_CU),
    # a binding for a symbol the library does not export (and, in the
    # .cu, an export with no binding: checked below)
    "bad_403": ('''
import ctypes


def _load():
    lib = ctypes.CDLL("libdemo.so")
    lib.mtt_demo.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    lib.mtt_args.argtypes = [ctypes.c_char_p]
    lib.mtt_gone.argtypes = [ctypes.c_int]  # VIOLATION: MTPU403
    return lib
''', ABI_CU),
    # a pointer from one tensor beside a length from another, directly
    # and through the packed launch struct
    "bad_404": ('''
def demo(words, other):
    _require_cuda(words, "demo", 2)
    _require_cuda(other, "demo", 2)
    n = other.shape[0]
    _load().mtt_demo(0, words.data_ptr(), n)  # VIOLATION: MTPU404
    p = words.data_ptr()
    _load().mtt_args(_ARGS.pack(p, 0, other.numel()))  # VIOLATION: MTPU404
''', None),
    # a raw parameter (or a view of one) reaches data_ptr unchecked,
    # also through a private helper whose caller passes a raw one
    "bad_405": ('''
def demo(words):
    n = words.shape[0]
    _load().mtt_demo(0, words.data_ptr(), n)  # VIOLATION: MTPU405
    t = words.t()
    return t.data_ptr()  # VIOLATION: MTPU405


def _launch(x):
    return x.data_ptr()  # VIOLATION: MTPU405


def caller(words):
    return _launch(words)
''', None),
}


def test_abi_good_pair_clean():
    assert abi_contracts.analyze(ABI_GOOD, "minio_tpu_torch/ops/demo.py",
                                 ABI_CU, "minio_tpu_torch/csrc/demo.cu") == []


@pytest.mark.parametrize("name", sorted(ABI_BAD))
def test_abi_bad_fixture_exact_findings(name):
    py, cu = ABI_BAD[name]
    found = abi_contracts.analyze(py, "minio_tpu_torch/ops/demo.py", cu,
                                  "minio_tpu_torch/csrc/demo.cu")
    on_py = {(f.rule, f.line) for f in found
             if f.path == "minio_tpu_torch/ops/demo.py"}
    assert on_py == _markers(py)


def test_abi_export_without_binding_is_mtpu403_on_the_cu_side():
    py = ABI_BAD["bad_403"][0]
    found = abi_contracts.analyze(py.replace("lib.mtt_args.argtypes", "#"),
                                  "minio_tpu_torch/ops/demo.py", ABI_CU,
                                  "minio_tpu_torch/csrc/demo.cu")
    cu_line = ABI_CU.splitlines().index(
        "int mtt_args(const DemoArgs* a) {") + 1
    assert ("MTPU403", cu_line) in {
        (f.rule, f.line) for f in found
        if f.path == "minio_tpu_torch/csrc/demo.cu"}


def test_abi_unmapped_c_type_is_mtpu402_on_the_cu_side():
    cu = ABI_CU.replace("long long n", "__int128 n")
    found = abi_contracts.analyze(ABI_GOOD, "minio_tpu_torch/ops/demo.py",
                                  cu, "minio_tpu_torch/csrc/demo.cu")
    line = cu.splitlines().index(
        "int mtt_demo(int device, const uint32_t* words, __int128 n) {") + 1
    assert [(f.rule, f.path, f.line) for f in found] == [
        ("MTPU402", "minio_tpu_torch/csrc/demo.cu", line)]


def test_abi_annotation_arity_mismatch_is_mtpu401_on_the_cu_side():
    cu = ABI_CU.replace("mtt_demo(c_int, c_void_p, c_int64)",
                        "mtt_demo(c_int, c_void_p)")
    py = ABI_BAD["bad_402"][0].replace("P, ctypes.c_int64", "P")
    found = abi_contracts.analyze(py, "minio_tpu_torch/ops/demo.py", cu,
                                  "minio_tpu_torch/csrc/demo.cu")
    assert "MTPU401" in {f.rule for f in found
                         if f.path == "minio_tpu_torch/csrc/demo.cu"}


def test_abi_real_seam_clean_and_fully_annotated():
    assert abi_contracts.raw_run() == []
    exports = abi_contracts.exports()
    assert set(exports) == {
        "mtt_encode_pack", "mtt_encode_pack_pipelined", "mtt_phash256",
        "mtt_gf_matmul", "mtt_verify_reconstruct",
        "mtt_verify_reconstruct_pipelined", "mtt_gf_matmul_mxu",
        "mtt_group_flags", "mtt_pack_clusters", "mtt_constants", "mts_screen",
        "mts_positions",
        "mts_spans", "mts_gather", "mts_constants",
    }
    assert all(e.annot_args is not None for e in exports.values())
    # every C type of the seam maps to ctypes, so MTPU402 checks them all
    assert all(t is not None for e in exports.values()
               for t in (*e.c_args, e.c_restype))
    assert {e.path for e in exports.values()} == set(abi_contracts.CC_RELS)


KERNELS_REL = "minio_tpu_torch/ops/kernels.py"
CODEC_REL = "minio_tpu_torch/csrc/codec.cu"


@pytest.mark.parametrize("cu_edit,py_edit,paths", [
    # the C prototype drifts: the binding and the comment both disagree
    (("uint32_t* acc, int R,", "uint32_t* acc, long long R,"), None,
     [CODEC_REL, KERNELS_REL]),
    # the comment alone drifts
    (("// @ctypes mtt_phash256(c_int, c_void_p,",
      "// @ctypes mtt_phash256(c_int, c_char_p,"), None, [CODEC_REL]),
    # the comment and the binding drift together: the prototype holds
    (("// @ctypes mtt_phash256(c_int, c_void_p, c_void_p, c_int,",
      "// @ctypes mtt_phash256(c_int, c_void_p, c_void_p, c_int64,"),
     ("lib.mtt_phash256.argtypes = [I, P, P, I,",
      "lib.mtt_phash256.argtypes = [I, P, P, ctypes.c_int64,"),
     [CODEC_REL, KERNELS_REL]),
], ids=["prototype", "comment", "comment_and_binding"])
def test_seeded_argtypes_drift_fails_with_exactly_mtpu402(cu_edit, py_edit,
                                                          paths):
    py, cc = (dict(d) for d in abi_contracts.seam_sources())
    for src, rel, edit in ((cc, CODEC_REL, cu_edit), (py, KERNELS_REL,
                                                      py_edit)):
        if edit:
            seeded = src[rel].replace(*edit, 1)
            assert seeded != src[rel]
            src[rel] = seeded
    found = abi_contracts.analyze_seam(py, cc)
    assert [f.rule for f in found] == ["MTPU402"] * len(paths)
    assert sorted(f.path for f in found) == paths
    assert all("mtt_phash256" in f.message for f in found)


def test_abi_loop_bindings_of_select_step_are_seen():
    import ast

    with open(os.path.join(ROOT, "minio_tpu_torch/ops/select_step.py")) as fh:
        b = abi_contracts.parse_bindings(ast.parse(fh.read()))
    for sym in ("mts_screen", "mts_positions", "mts_spans", "mts_gather"):
        assert b[sym].argtypes == ["c_char_p"] and b[sym].restype == "c_int"
    assert b["mts_constants"].restype == "c_char_p"


# ---------------------------------------------------------------------------
# MTPU2xx: contracts
# ---------------------------------------------------------------------------

HERE = os.path.abspath(__file__)


def _line_of(fn) -> int:
    return fn.__code__.co_firstlineno


def _contract_findings_here(monkeypatch, mod, name, bad):
    monkeypatch.setattr(mod, name, bad)
    rep = kernel_contracts.run_report("cpu")
    here = {(f.rule, f.line) for f in rep.findings
            if os.path.abspath(f.path) == HERE}
    return here, rep


def test_contract_wrong_dtype_is_mtpu201(monkeypatch):
    real = select_step.row_spans

    def bad_row_spans(arr, anchors, *, window):
        lens, found = real(arr, anchors, window=window)
        return lens, found.to(torch.uint8)

    here, _ = _contract_findings_here(monkeypatch, select_step, "row_spans",
                                      bad_row_spans)
    assert here == {("MTPU201", _line_of(bad_row_spans))}


def test_contract_wrong_shape_is_mtpu202(monkeypatch):
    real = select_step.gather_rows

    def bad_gather_rows(arr, starts, *, window):
        return real(arr, starts, window=window)[:, : window // 2]

    here, _ = _contract_findings_here(monkeypatch, select_step, "gather_rows",
                                      bad_gather_rows)
    assert here == {("MTPU202", _line_of(bad_gather_rows))}


def test_contract_broken_round_trip_is_mtpu203(monkeypatch):
    real = kernels.gf_matmul_words

    def bad_gf_matmul_words(matrix, words, rows):
        return real(matrix, words, rows) ^ 1

    here, rep = _contract_findings_here(monkeypatch, kernels,
                                        "gf_matmul_words", bad_gf_matmul_words)
    assert here == {("MTPU203", _line_of(bad_gf_matmul_words))}
    # the steps above it fail their own round trips at their own defs
    assert any(f.rule == "MTPU203" and f.path.endswith("codec_step.py")
               for f in rep.findings)


def test_launching_functions_equal_the_registry():
    got = set(kernel_contracts.launching_functions())
    assert got == set(kernel_contracts.KNOWN_ENTRY_POINTS)


def test_wrapper_without_contract_is_mtpu204(tmp_path):
    src = tmp_path / "fake_kernels.py"
    src.write_text(textwrap.dedent('''
        def _count(name):
            pass


        def new_wrapper(x):
            _count("new")
            return x


        def covered(x):
            return _lib().mtt_covered(x)


        def calls_it(x):
            return new_wrapper(x)


        def _helper(x):
            return _lib().mtt_helper(x)


        def plain(x):
            return x
    '''))
    spec = importlib.util.spec_from_file_location("fake_kernels", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    found = kernel_contracts.coverage_findings(
        {("kernels", "covered")}, modules={"kernels": mod})
    assert [(f.rule, f.line) for f in found] == [
        ("MTPU204", mod.calls_it.__code__.co_firstlineno),
        ("MTPU204", mod.new_wrapper.__code__.co_firstlineno),
    ]


def test_every_launch_counter_has_a_counting_site():
    """Each kernels.LAUNCHES name is counted by a ``_count`` call in the
    ops modules (the card's contract run reads these counters)."""
    import ast
    import inspect

    counted = set()
    for mod in (kernels, select_step):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr",
                                getattr(node.func, "id", "")) == "_count"):
                for a in node.args:
                    if isinstance(a, ast.Constant):
                        counted.add(a.value)
                    elif isinstance(a, ast.IfExp):
                        counted |= {a.body.value, a.orelse.value}
    assert counted == set(kernels.LAUNCHES)


# ---------------------------------------------------------------------------
# MTPU3xx: the lock shim, both packages on the same scripts
# ---------------------------------------------------------------------------


def _cycle(aud_cls, proxy_cls):
    aud = aud_cls(targets=())
    proxy = proxy_cls(aud)
    a, b = proxy.Lock(), proxy.Lock()
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join()
    return aud.report()


def _sleep_under_lock(aud_cls, proxy_cls):
    aud = aud_cls(targets=())
    lk = proxy_cls(aud).Lock()
    with aud.installed():
        with lk:
            time.sleep(0)
        time.sleep(0)
    return aud.report()


@pytest.mark.parametrize("script,rule", [(_cycle, "MTPU301"),
                                         (_sleep_under_lock, "MTPU302")])
def test_lock_shim_matches_the_jax_package(script, rule):
    port = script(lockorder.LockOrderAuditor, lockorder._ThreadingProxy)
    jax = script(jlockorder.LockOrderAuditor, jlockorder._ThreadingProxy)
    assert [f.rule for f in port] == [rule]
    assert _rl(port) == _rl(jax)


def test_lock_shim_consistent_order_is_clean():
    aud = lockorder.LockOrderAuditor(targets=())
    proxy = lockorder._ThreadingProxy(aud)
    a, b = proxy.Lock(), proxy.Lock()
    for _ in range(2):
        with a:
            with b:
                pass
    assert aud.report() == []


def test_lock_targets_are_port_modules_with_fanout():
    assert all(t.startswith("minio_tpu_torch.")
               for t in lockorder.DEFAULT_TARGETS)
    assert "minio_tpu_torch.parallel.fanout" in lockorder.DEFAULT_TARGETS


# ---------------------------------------------------------------------------
# MTPU5xx: deviceflow
# ---------------------------------------------------------------------------

DF_FIXTURES = {
    "bad_501": ("minio_tpu_torch/codec/fixture.py", '''
from minio_tpu_torch.ops import codec_step


def chain(chunk, acc, digests, present):
    data, acc2, ok = codec_step.verify_reconstruct_subchunk_words(
        chunk, acc, digests, 0, present, 8, 4, 1024)
    return acc.sum(), acc2  # VIOLATION: MTPU501
'''),
    "good_501": ("minio_tpu_torch/codec/fixture.py", '''
from minio_tpu_torch.ops import codec_step


def chain(chunks, acc, m, L):
    for c in chunks:
        p, acc, f, pk = codec_step.encode_subchunk_words(c, acc, 0, m, L)
    return acc.sum()
'''),
    "bad_502": ("minio_tpu_torch/codec/fixture.py", '''
import numpy as np
import torch

from minio_tpu_torch.ops import codec_step, kernels


def leak(words, L):
    dig = kernels.phash256_batched(words, L)
    return np.asarray(dig)  # VIOLATION: MTPU502


def leak_item(words, L):
    dig = kernels.phash256_batched(words, L)
    return dig.sum().item()  # VIOLATION: MTPU502


def made_on_card(n):
    t = torch.zeros(n, device="cuda")
    return t.cpu()  # VIOLATION: MTPU502


def through_helper(words, m, L):
    parity = _helper(words, m, L)
    return codec_step.tensor_to_words(parity)  # VIOLATION: MTPU502


def _helper(words, m, L):
    parity, digests, flags, packed = codec_step.encode_words_fused1(
        words, m, L)
    return parity
'''),
    "good_502": ("minio_tpu_torch/codec/fixture.py", '''
import numpy as np
import torch

from minio_tpu_torch.ops import kernels


def sizes(words, L):
    dig = kernels.phash256_batched(words, L)
    return dig.shape[0], dig.numel(), dig.data_ptr()


def host_only(rows):
    t = torch.zeros(rows)
    return t.cpu().numpy(), np.asarray(rows)


def drain_digests(words, L):
    return kernels.phash256_batched(words, L).cpu()
'''),
}


def _df(rel, text, registry=None):
    rep = deviceflow.analyze_sources({rel: parse_source(rel, text)},
                                     registry=registry)
    return filter_suppressed(rep.findings, {rel: text.splitlines()})


@pytest.mark.parametrize("name", sorted(DF_FIXTURES))
def test_port_deviceflow_fixture(name):
    rel, text = DF_FIXTURES[name]
    text = textwrap.dedent(text)
    reg = deviceflow.Registry.default()
    if name == "good_502":
        reg = _with_drain(reg, rel, "drain_digests")
    assert _rl(_df(rel, text, reg)) == _markers(text)


def _with_drain(reg, rel, name):
    import dataclasses

    seams = dict(reg.drain_seams)
    seams[rel] = seams.get(rel, ()) + (name,)
    return dataclasses.replace(reg, drain_seams=seams)


MTPU505_TEXT = '''# VIOLATION: MTPU505 - registered seam gone_end and wrapper gone
def wrap(x, acc):  # VIOLATION: MTPU505
    x += 1
    return x


def flush_drain(x):  # VIOLATION: MTPU505
    return x


def kept(acc):
    return acc
'''


def test_mtpu505_registry_drift_both_ways():
    rel = "minio_tpu_torch/ops/fixture.py"
    reg = deviceflow.Registry(
        entry_qnames=frozenset({f"{rel}::wrap", f"{rel}::kept",
                                f"{rel}::gone"}),
        donating_qnames={f"{rel}::kept": (0,)},
        mesh_donating={},
        drain_seams={rel: ("gone_end",)},
        entry_point_paths={"fx": rel},
        known_entry_points=frozenset({("fx", "wrap"), ("fx", "kept"),
                                      ("fx", "gone")}),
        donating_entry_points={("fx", "kept"): (0,)},
    )
    found = _df(rel, MTPU505_TEXT, reg)
    got = {(f.rule, f.line) for f in found}
    # line 1 holds the two missing-def findings, 2 the unregistered
    # in-place write, 7 the unregistered drain, 11 the registered in-place
    # position its body does not write
    assert got == _markers(MTPU505_TEXT) | {("MTPU505", 11)}
    assert sum(1 for f in found if f.line == 1) == 2


def test_in_place_registry_matches_the_wrappers_bodies():
    """The sub-chunk steps' accumulators are the only in-place positions
    (the gate's deviceflow pass holds the table against the bodies:
    MTPU505), and no mesh plan writes an input."""
    assert {name for (_m, name) in kernel_contracts.IN_PLACE_ENTRY_POINTS} == {
        "encode_pack_subchunk", "verify_reconstruct_subchunk",
        "encode_subchunk_words", "verify_reconstruct_subchunk_words"}
    assert kernel_contracts.MESH_DONATING_KERNELS == {}
    assert set(kernel_contracts.IN_PLACE_ENTRY_POINTS) <= (
        kernel_contracts.KNOWN_ENTRY_POINTS)


CARRY_DF = [
    ("bad_mtpu503.py", "tests/data/analysis/bad_mtpu503.py"),
    ("good_mtpu503.py", "tests/data/analysis/good_mtpu503.py"),
    ("bad_mtpu504.py", "{pkg}/server/bad_mtpu504.py"),
    ("good_mtpu504.py", "{pkg}/server/good_mtpu504.py"),
]


@pytest.mark.parametrize("name,where", CARRY_DF)
def test_carried_deviceflow_rule_matches_the_jax_package(name, where):
    text = _fixture(name)
    prel = where.format(pkg="minio_tpu_torch")
    jrel = where.format(pkg="minio_tpu")
    ptext = _port_text(text)
    port = _rl(_df(prel, ptext))
    jrep = jdeviceflow.analyze_sources({jrel: jparse(jrel, text)})
    jax = _rl(filter_suppressed(jrep.findings, {jrel: text.splitlines()}))
    assert port == jax
    if name.startswith("bad_"):
        assert port == _markers(text) and port


def test_deviceflow_producers_cover_the_wrappers_and_cuda_factories():
    text = textwrap.dedent('''
        import torch

        def f(n, dev):
            a = torch.empty(n, device=torch.device("cuda", 0))
            b = torch.ones(n).cuda()
            c = torch.zeros(n).to("cuda:0")
            d = torch.zeros(n, device=dev)
            return a.item(), b.tolist(), c.numpy(), d.item()
    ''')
    rel = "minio_tpu_torch/codec/fixture.py"
    assert _rl(_df(rel, text)) == {("MTPU502", 9)}
    assert len(_df(rel, text)) == 3


# ---------------------------------------------------------------------------
# MTPU6xx: lifecycle
# ---------------------------------------------------------------------------

LIFECYCLE_WHERE = {
    "601": "{pkg}/server/", "602": "{pkg}/dsync/", "603": "{pkg}/dsync/",
    "604": "{pkg}/parallel/", "605": "{pkg}/dsync/",
}


def _lc(rel, text, mod=lifecycle, parse=parse_source):
    rep = mod.analyze_sources({rel: parse(rel, text)})
    return filter_suppressed(rep.findings, {rel: text.splitlines()})


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", ["601", "602", "603", "604"])
def test_carried_lifecycle_rule_matches_the_jax_package(rule, kind):
    name = f"{kind}_mtpu{rule}.py"
    text = _fixture(name)
    where = LIFECYCLE_WHERE[rule]
    # the port scopes io-futures to the pool and its caller
    prel = ("minio_tpu_torch/codec/erasure.py" if rule == "604"
            else where.format(pkg="minio_tpu_torch") + name)
    port = _rl(_lc(prel, text))
    jax = _rl(_lc(where.format(pkg="minio_tpu") + name, text, jlifecycle,
                  jparse))
    assert port == jax
    assert port == _markers(text)


@pytest.mark.parametrize("kind", ["bad", "good"])
def test_mtpu605_acquire_shaped_def_needs_a_registry_entry(kind):
    name = f"{kind}_mtpu605.py"
    text = _fixture(name)
    rel = "minio_tpu_torch/dsync/" + name
    assert _rl(_lc(rel, text)) == _markers(text)


def test_mtpu605_flags_a_registered_def_missing_from_its_module():
    rel = "minio_tpu_torch/server/admission.py"
    text = "class TokenCounter:\n    def release(self):\n        pass\n"
    found = _lc(rel, text)
    assert {f.rule for f in found} == {"MTPU605"}
    assert any("try_acquire" in f.message for f in found)


def test_spans_around_a_release_are_not_a_raisable_hold():
    """The port's trace spans wrap lock releases (dsync/namespace.py)."""
    rel = "minio_tpu_torch/dsync/fixture.py"
    text = textwrap.dedent('''
        from ..utils import spans

        def read(lk, timeout):
            with spans.span("lock"):
                got = lk.acquire_read(timeout)
            if not got:
                raise TimeoutError()
            try:
                return 1
            finally:
                with spans.span("unlock"):
                    lk.release_read()
    ''')
    assert _lc(rel, text) == []


def _knobs_source(family: bool) -> str:
    lines = ["KNOBS = {",
             '    "MINIO_TPU_FIXTURE_REGISTERED": ("1", "fixture knob"),',
             "}", "PREFIX_KNOBS = {"]
    if family:
        lines.append('    "MINIO_TPU_FIXTURE_FAM_": ("", "fixture family"),')
    lines.append("}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("kind,family", [("bad", False), ("good", True)])
def test_mtpu606_knob_fixture(kind, family):
    name = f"{kind}_mtpu606.py"
    text = _fixture(name)
    rel = "minio_tpu_torch/fixture/" + name
    sources = {
        rel: parse_source(rel, text),
        lifecycle.KNOBS_REL: parse_source(lifecycle.KNOBS_REL,
                                          _knobs_source(family)),
    }
    found = lifecycle.check_knobs(
        sources, readme_text="MINIO_TPU_FIXTURE_REGISTERED MINIO_TPU_FIXTURE_FAM_")
    found = filter_suppressed(found, {rel: text.splitlines()})
    assert _rl(found) == _markers(text)


def test_mtpu606_resolves_module_constant_reads():
    rel = "minio_tpu_torch/iam/fixture.py"
    text = textwrap.dedent('''
        import os

        ENV_URL = "MINIO_TPU_FIXTURE_REGISTERED"
        ENV_GONE = "MINIO_TPU_FIXTURE_UNREGISTERED"

        def url():
            return os.environ.get(ENV_URL, "")

        def gone():
            return os.environ.get(ENV_GONE, "")  # VIOLATION: MTPU606
    ''')
    sources = {
        rel: parse_source(rel, text),
        lifecycle.KNOBS_REL: parse_source(lifecycle.KNOBS_REL,
                                          _knobs_source(False)),
    }
    found = lifecycle.check_knobs(
        sources, readme_text="MINIO_TPU_FIXTURE_REGISTERED")
    assert _rl(found) == _markers(text)


def test_mtpu606_reads_only_the_ports_readme_table():
    text = ("# x\n\n" + lifecycle.README_KNOB_HEADING + "\n\n| `A` |\n\n"
            "### Next\n\n| `B` |\n")
    table = lifecycle.readme_knob_table(text)
    assert "`A`" in table and "`B`" not in table
    assert lifecycle.readme_knob_table("no heading") == ""


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_list_rules_marks_the_jax_only_rule(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(RULES)
    tagged = [ln for ln in out if "[JAX-only; never fires]" in ln]
    assert [ln.split()[0] for ln in tagged] == ["MTPU102"]


def test_cli_skip_runs_only_the_rest(capsys):
    rc = cli.main(["--paths", "minio_tpu_torch/utils/spans.py", "--skip",
                   "abi", "contracts", "locks", "deviceflow", "lifecycle"])
    assert rc == 0
    assert capsys.readouterr().err.strip().endswith("0 finding(s) [lint]")


def test_cli_exits_one_on_a_bad_path(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "minio_tpu_torch" / "ops"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("def f(t):\n    return t.item()\n")
    monkeypatch.setattr(analysis, "REPO_ROOT", str(tmp_path))
    rc = cli.main(["--json", "--paths", "minio_tpu_torch/ops/x.py",
                   "--skip", "abi", "contracts", "locks", "deviceflow",
                   "lifecycle"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert [(f["rule"], f["path"], f["line"]) for f in doc["findings"]] == [
        ("MTPU101", "minio_tpu_torch/ops/x.py", 2)]
    assert set(doc["passes"]) == {"lint"}


@pytest.mark.parametrize("changed,ran", [
    (set(), "nothing to run, changed-only"),
    ({"README.md"}, "nothing to run, changed-only"),
    ({"minio_tpu_torch/csrc/select.cu"}, "abi, contracts, changed-only"),
    ({"minio_tpu_torch/parallel/fanout.py"},
     "lint, contracts, locks, deviceflow, lifecycle, changed-only"),
    ({"minio_tpu_torch/server/aio.py"},
     "lint, deviceflow, lifecycle, changed-only"),
])
def test_cli_changed_only_gates_the_passes(monkeypatch, capsys, changed, ran):
    monkeypatch.setattr(cli, "_changed_files", lambda root: set(changed))
    calls = []
    monkeypatch.setattr(
        kernel_contracts, "run_report",
        lambda device=None: calls.append(device) or kernel_contracts.
        ContractReport([], 0, {}, 0.0, str(device)))
    rc = cli.main(["--changed-only"])
    assert rc == 0
    assert capsys.readouterr().err.strip().endswith(f"[{ran}]")
    # the CLI leaves the device to run_report: the card when there is one
    assert calls == ([None] if "contracts" in ran else [])


@pytest.mark.parametrize("cuda,want", [(True, "cuda"), (False, "cpu")])
def test_contracts_default_to_the_card_when_there_is_one(monkeypatch, cuda,
                                                         want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    assert kernel_contracts.default_device() == want


def test_reverse_closure_adds_the_callers_of_a_changed_file():
    closure = cli._reverse_closure({"minio_tpu_torch/ops/kernels.py"})
    assert "minio_tpu_torch/ops/codec_step.py" in closure
    assert "minio_tpu_torch/codec/backend.py" in closure
    assert "minio_tpu_torch/cache/tiered.py" not in cli._reverse_closure(
        {"minio_tpu_torch/server/aio.py"})


def test_iter_py_files_excludes_the_analysis_package_and_build_dirs():
    files = analysis.iter_py_files()
    assert files and all(f.startswith("minio_tpu_torch/") for f in files)
    assert not [f for f in files if f.startswith("minio_tpu_torch/analysis/")]
    assert analysis.iter_py_files(["minio_tpu_torch/build"]) == []
