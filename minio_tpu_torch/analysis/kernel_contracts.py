"""Kernel contract checker: every kernel wrapper, run on real tensors.

The JAX package abstract-evaluates its jitted entry points with
``jax.eval_shape``.  The port has no tracer: its "entry points" are the
wrappers that reach a CUDA launch (``ops/kernels.py``), the
``ops/codec_step.py`` steps above them, the S3 Select wrappers
(``ops/select_step.py``) and the mesh kernels registered with
``parallel/rules.py``'s plan cache.  Contracts run each of them over the
JAX package's ``CONFIG_GRID`` and ``FUSED_GRID`` on real tensors: on the
CPU by default (the wrappers' plain versions), or on CUDA tensors when
the run asks for the card (the hand-written kernels).  Over each
(data_shards, parity_shards, shard_len) config they check:

* MTPU201 - output dtypes (words int32, byte shards uint8, masks bool);
* MTPU202 - output shapes; a wrapper that raises; and, on the card, a
  kernel output that differs from its plain version on the same inputs
  (the wrapper called on CPU copies of them);
* MTPU203 - the encode -> reconstruct round trip, by value: the parity
  and digests of an encode rebuild the data and verify;
* MTPU204 - a function that launches a kernel (bumps
  ``kernels.LAUNCHES`` or calls an ``mtt_*``/``mts_*`` export, itself or
  through an ops helper) with no registered contract.  The net is closed
  over module introspection, so a new wrapper without a contract fails
  the gate rather than silently shrinking coverage.

Findings anchor at the wrapper's ``def`` line and name the config, e.g.
``(data_shards=8, parity_shards=4, shard_len=256)``.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import os
import re
import textwrap
import time

from .findings import Finding

# (data_shards, parity_shards, shard_len_bytes), the JAX package's grids
CONFIG_GRID = [
    (2, 1, 64),
    (4, 2, 128),
    (8, 4, 256),
    (16, 4, 512),
]

# the pack leg's granule is 256 words, so the grouped forms (K1/K5 with
# group 256, K12, K13) run on 16 KiB shards
FUSED_GRID = [
    (2, 1, 16384),
    (4, 2, 16384),
    (8, 4, 16384),
]

_BATCH = 3  # leading batch dim for the batched kernels
_MESH_BATCH = 4  # the mesh's stripe axis splits the batch in two
_GROUP = 256  # compress.PARITY_GROUP_WORDS, the pack leg's granule
_SEED = 20240

# ---------------------------------------------------------------------------
# Device-dataflow registry (consumed by analysis/callgraph.py and
# analysis/deviceflow.py).
#
# These tables are the single source of truth for the whole-program
# MTPU5xx dataflow rules: which calls *produce* device tensors, which
# argument positions a wrapper *writes in place*, and which functions are
# the sanctioned *drain seams* where device values may legally reach the
# host.  MTPU505 cross-checks every table against the tree (a declared
# fact absent in code, or a code fact absent here, is a finding).
# ---------------------------------------------------------------------------

# short module name -> repo-relative path of the module that defines it
ENTRY_POINT_PATHS = {
    "kernels": "minio_tpu_torch/ops/kernels.py",
    "codec_step": "minio_tpu_torch/ops/codec_step.py",
    "select_step": "minio_tpu_torch/ops/select_step.py",
    "backend": "minio_tpu_torch/codec/backend.py",
    "mesh": "minio_tpu_torch/parallel/mesh.py",
    "rules": "minio_tpu_torch/parallel/rules.py",
}

# Every kernel wrapper the tree ships, (module_short_name, attr): calls
# to these return tensors on the card when their inputs are there.
KNOWN_ENTRY_POINTS = {
    ("kernels", "encode_pack"),
    ("kernels", "encode_pack_subchunk"),
    ("kernels", "encode_pack_pipelined"),
    ("kernels", "phash256_batched"),
    ("kernels", "gf_matmul_words"),
    ("kernels", "verify_reconstruct"),
    ("kernels", "verify_reconstruct_subchunk"),
    ("kernels", "verify_reconstruct_pipelined"),
    ("kernels", "gf_matmul_mxu"),
    ("kernels", "group_flags"),
    ("kernels", "pack_nonzero_groups"),
    ("codec_step", "encode_words_fused1"),
    ("codec_step", "group_flags"),
    ("codec_step", "pack_nonzero_groups"),
    ("codec_step", "reconstruct_words_batch"),
    ("codec_step", "verify_and_reconstruct_words"),
    ("codec_step", "encode_subchunk_words"),
    ("codec_step", "verify_reconstruct_subchunk_words"),
    ("codec_step", "digest_words_batched"),
    ("select_step", "screen_chunk"),
    ("select_step", "extract_positions"),
    ("select_step", "row_spans"),
    ("select_step", "anchors_back"),
    ("select_step", "gather_rows"),
}

# (module_short_name, attr) -> positional arguments the wrapper writes IN
# PLACE: the hash accumulator of the sub-chunk steps (the JAX package
# donates it; here each step XORs its partials into it).  A value passed
# there must be re-bound from the wrapper's return before it is read
# again (MTPU501, use-after-mutate).  MTPU505 cross-checks this table
# against the wrappers' bodies: an augmented assignment, an in-place
# method (``x.copy_``) or a pass to another in-place position.
IN_PLACE_ENTRY_POINTS = {
    ("kernels", "encode_pack_subchunk"): (1,),
    ("kernels", "verify_reconstruct_subchunk"): (1,),
    ("codec_step", "encode_subchunk_words"): (1,),
    ("codec_step", "verify_reconstruct_subchunk_words"): (1,),
}

# Mesh kernel kinds whose plan writes an input in place.  None does: the
# plans never copy an input, so nothing is given up (the
# ``donate_argnums`` that register_kernel keeps mirrors the JAX table and
# has no effect).
MESH_DONATING_KERNELS: "dict[str, tuple[int, ...]]" = {}

# repo-relative path -> function names that are sanctioned drain seams:
# inside these, device values may reach the host (.cpu() / .numpy() /
# .item() / .tolist() / np.asarray / bytes()), and their RETURN values
# are host facts, not device facts.  Names ending in ``_end`` or holding
# ``drain`` in these files MUST be registered here (MTPU505).
DRAIN_SEAMS = {
    "minio_tpu_torch/codec/backend.py": (
        # PUT side: the begin/end split and the lazy parity-plane drain
        "encode_end",
        "encode_digest_end",
        "drain",
        "_drain_raw",
        "_drain_screened",
        "_drain_precomputed",
        "_drain_chunks",
        # GET side: decode IS the sanctioned D2H - reconstructed rows
        # leave the card here and nowhere else
        "reconstruct",
        "reconstruct_and_verify",
        "verify",
        "digest",
        "_drain_vr_subchunks",
        # the pinned staging's D2H sync points (the sub-chunk chain's
        # rows come back through them)
        "d2h_finish",
        "_chain_d2h_finish",
    ),
    "minio_tpu_torch/cache/tiered.py": (
        # a device entry's rows back to the host, and the digest check
        # of resident rows (eight words a row, then a bool)
        "_to_host",
        "_verify_resident",
    ),
    "minio_tpu_torch/s3select/device.py": (
        # candidate row bytes are the only payload that crosses D2H,
        # through exactly these functions (MTPU111 enforces locally)
        "_drain_scalars",
        "_drain_array",
        "_drain_fallback_chunk",
        "drain_plane",
    ),
    "minio_tpu_torch/ops/codec_step.py": (
        # the one tensor -> host words conversion
        "tensor_to_words",
    ),
    "minio_tpu_torch/parallel/mesh.py": (
        # begin queues the mesh pass, _end reads it back
        "mesh_encode_hash_end",
    ),
}

# modules whose public functions must have a contract when they reach a
# launch through ops code; the others are watched for direct launches
_OPS_MODULES = ("kernels", "codec_step", "select_step")
_LIB_EXPORT_RE = re.compile(r"^mt[ts]_(?!constants$)\w+$")


def _watched_modules() -> dict:
    from ..codec import backend
    from ..ops import codec_step, kernels, select_step
    from ..parallel import mesh, rules

    return {
        "kernels": kernels,
        "codec_step": codec_step,
        "select_step": select_step,
        "backend": backend,
        "mesh": mesh,
        "rules": rules,
    }


def _functions(mod) -> "dict[str, object]":
    """Qualified name -> function for every def of ``mod``: module-level
    functions and the methods of its classes."""
    out = {}
    for name, val in vars(mod).items():
        if inspect.isfunction(val) and val.__module__ == mod.__name__:
            out[name] = val
        elif inspect.isclass(val) and val.__module__ == mod.__name__:
            for attr, sub in vars(val).items():
                fn = sub.__func__ if isinstance(
                    sub, (staticmethod, classmethod)) else sub
                if inspect.isfunction(fn):
                    out[f"{name}.{attr}"] = fn
    return out


def _nodes(fn) -> "list[ast.AST]":
    """The calls and the name/attribute references of ``fn``'s body."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return []
    return [n for n in ast.walk(ast.parse(src))
            if isinstance(n, (ast.Call, ast.Name, ast.Attribute))]


def _launches_directly(nodes) -> bool:
    for c in nodes:
        if not isinstance(c, ast.Call):
            continue
        f = c.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if name == "_count" or _LIB_EXPORT_RE.match(name):
            return True
    return False


def launching_functions(modules: "dict | None" = None) -> "dict[tuple[str, str], object]":
    """(module_short_name, qualified name) -> function for every function
    that must have a contract (the MTPU204 net, by introspection): a
    public function of an ops module that launches, itself or through
    ops functions it calls by name; and any function of the other watched
    modules that launches itself."""
    modules = _watched_modules() if modules is None else modules
    funcs = {(m, q): f for m, mod in modules.items()
             for q, f in _functions(mod).items()}
    calls = {key: _nodes(f) for key, f in funcs.items()}
    launching = {key for key, cs in calls.items() if _launches_directly(cs)}
    short_of = {id(mod): m for m, mod in modules.items()}

    def target(m, f):
        """The (module, name) a reference in an ops function names: a
        bare name of its own module, or ``alias.name`` through a module
        global (called or not: ``fn = kernels.encode_pack`` counts)."""
        if isinstance(f, ast.Name):
            return (m, f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            alias = vars(modules[m]).get(f.value.id)
            if id(alias) in short_of:
                return (short_of[id(alias)], f.attr)
        return None

    changed = True
    while changed:
        changed = False
        for key, cs in calls.items():
            if key in launching or key[0] not in _OPS_MODULES:
                continue
            if any(target(key[0], c) in launching for c in cs):
                launching.add(key)
                changed = True
    out = {}
    for key in sorted(launching):
        m, q = key
        if m in _OPS_MODULES and (q.startswith("_") or "." in q):
            continue  # an ops helper: its public callers carry the contract
        out[key] = funcs[key]
    return out


def _anchor(fn, default_path: str) -> "tuple[str, int]":
    """Repo-relative path + def line of a function."""
    code = getattr(getattr(fn, "__wrapped__", fn), "__code__", None)
    if code is None:
        return default_path, 1
    path = code.co_filename
    marker = os.sep + "minio_tpu_torch" + os.sep
    if marker in path:
        path = "minio_tpu_torch" + os.sep + path.rsplit(marker, 1)[1]
    return path.replace(os.sep, "/"), code.co_firstlineno


def coverage_findings(checked, modules: "dict | None" = None) -> "list[Finding]":
    """MTPU204 for every launching function not in ``checked``."""
    out = []
    for (mod, name), fn in launching_functions(modules).items():
        if (mod, name) in checked:
            continue
        path, line = _anchor(fn, ENTRY_POINT_PATHS.get(mod, "?"))
        out.append(Finding(
            "MTPU204", path, line,
            f"kernel wrapper {mod}.{name} launches a kernel but has no "
            "registered contract; add a check in "
            "minio_tpu_torch/analysis/kernel_contracts.py",
        ))
    return out


@dataclasses.dataclass
class ContractReport:
    """A contract run: its findings, the (config, wrapper) checks it
    made, the kernel launches they took, and its seconds."""

    findings: "list[Finding]"
    checked: int
    launches: "dict[str, int]"
    seconds: float
    device: str


class _Ctx:
    """Collects findings for one wrapper, tagging the config."""

    def __init__(self, report, fn, default_path):
        self.report = report
        self.path, self.line = _anchor(fn, default_path)
        self.config = ""

    def _add(self, rule: str, msg: str) -> None:
        self.report.findings.append(Finding(rule, self.path, self.line, msg))

    def expect(self, rule: str, got, want, what: str) -> None:
        if got != want:
            self._add(rule, f"{what}: got {got}, want {want} at {self.config}")

    def shape(self, got, want, what: str) -> None:
        self.expect("MTPU202", tuple(got.shape), tuple(want), what + " shape")

    def dtype(self, got, want, what: str) -> None:
        self.expect("MTPU201", str(got.dtype).replace("torch.", ""),
                    str(want), what + " dtype")

    def same(self, rule: str, got, want, what: str) -> None:
        import torch

        if tuple(got.shape) != tuple(want.shape) or not torch.equal(
                got.cpu(), want.cpu()):
            self._add(rule, f"{what} differs at {self.config}")

    def fail(self, exc: BaseException) -> None:
        self._add("MTPU202", f"call raised {type(exc).__name__}: {exc} "
                  f"at {self.config}")


def _cfg(k, m, L, extra=""):
    return f"(data_shards={k}, parity_shards={m}, shard_len={L}{extra})"


def _worst(k: int, m: int) -> "tuple[bool, ...]":
    """The worst admissible erasure: all m losses on data shards."""
    return (False,) * m + (True,) * k


def default_device() -> str:
    """Where the contracts run unless asked: the card when there is one."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def run_report(device: "str | None" = None) -> ContractReport:
    """Check every registered contract on tensors of ``device``: by
    default the card when there is one (the kernels, each output held
    against its plain version), else the CPU (the plain versions)."""
    import numpy as np
    import torch

    from ..ops import codec_step, gf, kernels, select_step
    from ..parallel import mesh as pmesh, rules as prules

    t0 = time.monotonic()
    dev = torch.device(device or default_device())
    on_card = dev.type == "cuda"
    report = ContractReport([], 0, {}, 0.0, str(dev))
    before = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(_SEED)
    checked: "set[tuple[str, str]]" = set()

    def words(shape):
        a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(dev)

    def sparse(shape):
        """Words whose 256-word groups are zero one time in two."""
        t = words(shape)
        *lead, w = shape
        keep = torch.from_numpy(
            rng.integers(0, 2, (*lead, w // _GROUP, 1)).astype(np.int32)
        ).to(dev)
        return (t.view(*lead, w // _GROUP, _GROUP) * keep).view(shape)

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def call(c, fn, args, plain_args=None, rows=None):
        """fn(*args) on the device; on the card also fn on CPU copies
        (the plain version on the same inputs), each output compared
        (output ``i`` only over the dim-1 rows ``rows[i]`` when given:
        an absent row's digest is not the row's)."""
        report.checked += 1
        got = fn(*args)
        if on_card:
            want = fn(*(plain_args or [host(a) for a in args]))
            gt = got if isinstance(got, tuple) else (got,)
            wt = want if isinstance(want, tuple) else (want,)
            for i, (a, b) in enumerate(zip(gt, wt)):
                if isinstance(a, torch.Tensor):
                    sel = (rows or {}).get(i)
                    if sel is not None:
                        a, b = a[:, sel], b[:, sel.cpu()]
                    c.same("MTPU202", a, b,
                           f"output {i} of the kernel against its plain version")
        return got

    def ctx(mod, name):
        checked.add((mod, name))
        fn = getattr({"kernels": kernels, "codec_step": codec_step,
                      "select_step": select_step}[mod], name)
        return _Ctx(report, fn, ENTRY_POINT_PATHS[mod]), fn

    i32, u8, b8, i64 = "int32", "uint8", "bool", "int64"

    def refused(c, n, fn, args) -> bool:
        """K4 and K6 take at most kernels.MAX_ROWS shard rows: past that
        the contract is that the wrapper refuses (ValueError) on either
        device.  True when ``n`` is past it (and the refusal checked)."""
        if n <= kernels._MAX_ROWS:
            return False
        report.checked += 1
        try:
            fn(*args)
        except ValueError:
            return True
        except Exception as e:
            c.fail(e)
            return True
        c._add("MTPU202", f"{n} shard rows accepted past the kernels' "
               f"{kernels._MAX_ROWS} at {c.config}")
        return True

    # ---- the PUT kernels: K1, K5 and the fused1 step --------------------

    def grids():
        for k, m, L in CONFIG_GRID:
            yield k, m, L, 0
        for k, m, L in FUSED_GRID:
            yield k, m, L, _GROUP

    encoded = {}  # (k, m, L) -> (words, parity, digests) of K1 swar
    for name in ("encode_pack", "encode_pack_pipelined"):
        c, fn = ctx("kernels", name)
        for k, m, L, group in grids():
            w, n = L // 4, k + m
            g = w // group if group else 0
            x = words((_BATCH, k, w))
            for form in ("swar", "mxu"):
                c.config = _cfg(k, m, L, f", group={group}, {form}")
                try:
                    parity, dig, flags, packed = call(
                        c, fn, (x, m, L, group, form))
                    for t, shp, what in ((parity, (_BATCH, m, w), "parity"),
                                         (dig, (_BATCH, n, 8), "digests"),
                                         (flags, (_BATCH, m, g), "flags"),
                                         (packed, (_BATCH, m, w), "packed")):
                        c.shape(t, shp, what)
                        c.dtype(t, i32, what)
                    if name == "encode_pack" and form == "swar" and not group:
                        encoded[(k, m, L)] = (x, parity, dig)
                except Exception as e:
                    c.fail(e)

    c, fn = ctx("codec_step", "encode_words_fused1")
    for k, m, L, group in grids():
        w, n = L // 4, k + m
        g = w // group if group else 0
        x = words((_BATCH, k, w))
        for pipe in (False, True):
            c.config = _cfg(k, m, L, f", group={group}, pipeline={pipe}")
            try:
                parity, dig, flags, packed = call(
                    c, fn, (x, m, L, group, pipe, "swar"))
                c.shape(parity, (_BATCH, m, w), "fused1 parity")
                c.dtype(parity, i32, "fused1 parity")
                c.shape(dig, (_BATCH, n, 8), "fused1 digests")
                c.dtype(dig, i32, "fused1 digests")
                c.shape(flags, (_BATCH, m, g), "fused1 flags")
                c.dtype(flags, b8, "fused1 flags")
                c.shape(packed, (_BATCH, m, w), "fused1 packed")
                c.dtype(packed, i32, "fused1 packed")
            except Exception as e:
                c.fail(e)

    # ---- K2 and the digest step: digests close over the encode ----------

    for mod, name in (("kernels", "phash256_batched"),
                      ("codec_step", "digest_words_batched")):
        c, fn = ctx(mod, name)
        for (k, m, L), (x, parity, dig) in encoded.items():
            c.config = _cfg(k, m, L)
            try:
                rows = torch.cat([x, parity], dim=1)
                got = call(c, fn, (rows, L))
                c.shape(got, (_BATCH, k + m, 8), "digests")
                c.dtype(got, i32, "digests")
                c.same("MTPU203", got, dig, "digests of the encoded rows "
                       "against encode_pack's")
            except Exception as e:
                c.fail(e)

    # ---- the GET kernels: K3, K4, K6, K7 and their steps ----------------

    for (k, m, L), (x, parity, dig) in encoded.items():
        n, w = k + m, L // 4
        present = _worst(k, m)
        idx = tuple(i for i, p in enumerate(present) if p)[:k]
        shards = torch.cat([x, parity], dim=1)

        c, fn = ctx("kernels", "gf_matmul_words")
        c.config = _cfg(k, m, L)
        try:
            rm = gf.reconstruction_matrix(k, m, idx)
            got = call(c, fn, (rm, shards, idx))
            c.shape(got, (_BATCH, k, w), "rebuilt data words")
            c.dtype(got, i32, "rebuilt data words")
            c.same("MTPU203", got, x, "encode->reconstruct round trip (K3)")
        except Exception as e:
            c.fail(e)

        c, fn = ctx("codec_step", "reconstruct_words_batch")
        c.config = _cfg(k, m, L)
        try:
            got = call(c, fn, (shards, present, k, m))
            c.shape(got, (_BATCH, k, w), "data words")
            c.dtype(got, i32, "data words")
            c.same("MTPU203", got, x, "encode->reconstruct round trip")
        except Exception as e:
            c.fail(e)

        pres = torch.tensor(present, device=dev)
        for name in ("verify_reconstruct", "verify_reconstruct_pipelined"):
            c, fn = ctx("kernels", name)
            for form in ("swar", "mxu"):
                c.config = _cfg(k, m, L, f", {form}")
                if refused(c, n, fn, (shards, present, k, L, form)):
                    continue
                try:
                    data, got = call(c, fn, (shards, present, k, L, form),
                                     rows={1: pres})
                    c.shape(data, (_BATCH, k, w), "rebuilt data")
                    c.dtype(data, i32, "rebuilt data")
                    c.shape(got, (_BATCH, n, 8), "digests")
                    c.dtype(got, i32, "digests")
                    c.same("MTPU203", data, x, "encode->verify+reconstruct "
                           "round trip")
                    c.same("MTPU203", got[:, pres], dig[:, pres],
                           "digests of the present rows")
                except Exception as e:
                    c.fail(e)

        c, fn = ctx("codec_step", "verify_and_reconstruct_words")
        for pipe in (False, True):
            c.config = _cfg(k, m, L, f", pipeline={pipe}")
            if refused(c, n, fn, (shards, dig, present, k, m, L, pipe)):
                continue
            try:
                data, ok = call(c, fn, (shards, dig, present, k, m, L, pipe))
                c.shape(data, (_BATCH, k, w), "fused GET data words")
                c.dtype(data, i32, "fused GET data words")
                c.shape(ok, (_BATCH, n), "fused GET ok mask")
                c.dtype(ok, b8, "fused GET ok mask")
                c.same("MTPU203", data, x, "fused encode->verify+reconstruct")
                c.same("MTPU203", ok, pres.expand(_BATCH, n),
                       "ok mask of an intact object")
            except Exception as e:
                c.fail(e)

        c, fn = ctx("kernels", "gf_matmul_mxu")
        c.config = _cfg(k, m, L)
        try:
            data_b = x[0].contiguous().view(torch.uint8)
            got = call(c, fn, (gf.parity_matrix(k, m), data_b))
            c.shape(got, (m, L), "mxu parity bytes")
            c.dtype(got, u8, "mxu parity bytes")
            c.same("MTPU203", got, parity[0].contiguous().view(torch.uint8),
                   "K7 parity against encode_pack's")
        except Exception as e:
            c.fail(e)

    # ---- the sub-chunk chains: the accumulator closes over the row ------

    def chunks(w, group):
        half = w // 2
        step = max(group, 8)
        return (w,) if half % step else (half, w - half)

    sub_grid = [(k, m, L, 0) for k, m, L in CONFIG_GRID[:2]] + [
        (k, m, L, _GROUP) for k, m, L in FUSED_GRID[:1]]
    for mod, name in (("kernels", "encode_pack_subchunk"),
                      ("codec_step", "encode_subchunk_words")):
        c, fn = ctx(mod, name)
        for k, m, L, group in sub_grid:
            w, n = L // 4, k + m
            x = words((_BATCH, k, w))
            want = kernels.encode_pack(x, m, L)
            c.config = _cfg(k, m, L, f", group={group}")
            try:
                acc = torch.zeros((_BATCH, n, 8), dtype=torch.int32, device=dev)
                acc_h = acc.cpu()
                off, parts = 0, []
                for cw in chunks(w, group):
                    fin = off + cw == w
                    args = (x[:, :, off:off + cw].contiguous(), acc, off, m, L,
                            group, fin)
                    plain = (args[0].cpu(), acc_h, off, m, L, group, fin)
                    p, acc, f, pk = call(c, fn, args, plain)
                    acc_h = plain[1]  # the plain version's acc, in place
                    c.shape(p, (_BATCH, m, cw), "chunk parity")
                    c.dtype(p, i32, "chunk parity")
                    c.shape(f, (_BATCH, m, cw // group if group else 0),
                            "chunk flags")
                    c.shape(pk, (_BATCH, m, cw), "chunk packed")
                    parts.append(p)
                    off += cw
                c.shape(acc, (_BATCH, n, 8), "chunk partials")
                c.dtype(acc, i32, "chunk partials")
                c.same("MTPU203", torch.cat(parts, dim=2), want[0],
                       "sub-chunk parity against the whole row's")
                c.same("MTPU203", acc, want[1],
                       "finalized accumulator against the whole row's digests")
            except Exception as e:
                c.fail(e)

    for mod, name in (("kernels", "verify_reconstruct_subchunk"),
                      ("codec_step", "verify_reconstruct_subchunk_words")):
        c, fn = ctx(mod, name)
        for k, m, L, group in sub_grid:
            w, n = L // 4, k + m
            present = _worst(k, m)
            x = words((_BATCH, k, w))
            parity, dig, _f, _p = kernels.encode_pack(x, m, L)
            shards = torch.cat([x, parity], dim=1)
            pres = torch.tensor(present, device=dev)
            c.config = _cfg(k, m, L)
            try:
                acc = torch.zeros((_BATCH, n, 8), dtype=torch.int32, device=dev)
                acc_h, off, parts, ok = acc.cpu(), 0, [], None
                for cw in chunks(w, 0):
                    fin = off + cw == w
                    ch = shards[:, :, off:off + cw].contiguous()
                    if mod == "kernels":
                        args = (ch, acc, off, present, k, L, fin)
                        plain = (ch.cpu(), acc_h, off, present, k, L, fin)
                        d, acc = call(c, fn, args, plain)
                    else:
                        args = (ch, acc, dig, off, present, k, m, L, fin)
                        plain = (ch.cpu(), acc_h, dig.cpu(), off, present, k,
                                 m, L, fin)
                        d, acc, ok = call(c, fn, args, plain)
                        c.shape(ok, (_BATCH, n), "chunk ok mask")
                        c.dtype(ok, b8, "chunk ok mask")
                    acc_h = plain[1]
                    c.shape(d, (_BATCH, k, cw), "chunk data words")
                    c.dtype(d, i32, "chunk data words")
                    parts.append(d)
                    off += cw
                c.shape(acc, (_BATCH, n, 8), "chunk partials")
                c.same("MTPU203", torch.cat(parts, dim=2), x,
                       "sub-chunk reconstruct round trip")
                c.same("MTPU203", acc[:, pres], dig[:, pres],
                       "finalized accumulator of the present rows")
                if ok is not None:
                    c.same("MTPU203", ok, pres.expand(_BATCH, n),
                           "ok mask of an intact object")
            except Exception as e:
                c.fail(e)

    # ---- K12, K13 and their steps (group 256) ---------------------------

    for mod in ("kernels", "codec_step"):
        c, fn = ctx(mod, "group_flags")
        for k, m, L in FUSED_GRID:
            w = L // 4
            plane = sparse((_BATCH, m, w))
            c.config = _cfg(k, m, L, f", group={_GROUP}")
            try:
                flags = call(c, fn, (plane, _GROUP))
                c.shape(flags, (_BATCH, m, w // _GROUP), "group flags")
                c.dtype(flags, i32, "group flags")
            except Exception as e:
                c.fail(e)
        c, fn = ctx(mod, "pack_nonzero_groups")
        for k, m, L in FUSED_GRID:
            w = L // 4
            plane = sparse((_BATCH, m, w))
            c.config = _cfg(k, m, L, f", group={_GROUP}")
            try:
                flags, packed = call(c, fn, (plane, _GROUP))
                c.shape(flags, (_BATCH, m, w // _GROUP), "pack flags")
                c.dtype(flags, i32, "pack flags")
                c.shape(packed, (_BATCH, m, w), "packed words")
                c.dtype(packed, i32, "packed words")
                nz = int((flags != 0).sum())
                c.expect("MTPU203", int((packed != 0).view(
                    _BATCH, m, -1, _GROUP).any(-1).sum()), nz,
                    "nonzero groups kept by the pack")
            except Exception as e:
                c.fail(e)

    # ---- S3 Select: K8-K11 ----------------------------------------------

    _SELECT_PLANES = (4096, 16384)  # bytes; multiples of BLOCK_BYTES
    _SELECT_ATOMS = (
        (("len", 0, 3),),
        (("deep", 2),),
        (("byte0", 43, 48),),
        (("nd", 4),),
        (("lex", b"42", "lt"),),
        (("lex", b"42", "ge"),),
        (("lex", b"name", "eq"),),
    )
    wpb = select_step.POP_WORDS
    for nbytes in _SELECT_PLANES:
        body = bytearray()
        while len(body) < nbytes - 64:
            fields = [str(int(v)) for v in rng.integers(0, 10 ** 5, 4)]
            body += (",".join(fields) + "\n").encode()
        body = body[: body.rfind(b"\n") + 1]
        body += bytes([select_step.PAD_BYTE]) * (nbytes - len(body))
        arr = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
        c, fn = ctx("select_step", "screen_chunk")
        screened = None
        for anchor in ("row", "field"):
            for sci in (False, True):
                c.config = f"(plane_bytes={nbytes}, anchor={anchor}, sci_guard={sci})"
                try:
                    def screen(a, _anchor=anchor, _sci=sci):
                        return fn(a, fd=44, qc=34, atoms=_SELECT_ATOMS,
                                  anchor=_anchor, sci_guard=_sci)
                    cand, blk, nrows, haz = call(c, screen, (arr,))
                    c.shape(cand, (nbytes // 8,), "candidate flag words")
                    c.dtype(cand, i64, "candidate flag words")
                    c.shape(blk, (nbytes // (8 * wpb),), "block popcounts")
                    c.dtype(blk, i32, "block popcounts")
                    c.shape(nrows, (), "row count")
                    c.dtype(nrows, i32, "row count")
                    c.shape(haz, (), "hazard scalar")
                    c.dtype(haz, b8, "hazard scalar")
                    if anchor == "row" and not sci:
                        screened = (cand, blk)
                except Exception as e:
                    c.fail(e)
        if screened is None:
            continue
        cand, blk = screened
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        c, fn = ctx("select_step", "extract_positions")
        pos = None
        for cap in (64, 1024):
            c.config = f"(plane_bytes={nbytes}, cap={cap})"
            try:
                def positions(a, b, _cap=cap):
                    return fn(a, b, cap=_cap)
                got = call(c, positions, (cand, cum))
                c.shape(got, (cap,), "candidate byte positions")
                c.dtype(got, i32, "candidate byte positions")
                pos = got
            except Exception as e:
                c.fail(e)
        nl = torch.nonzero(arr == 10).flatten().to(torch.int32)
        hits = (nl[:7] if pos is None else pos[:7]).clamp(0, nbytes - 1)
        starts = (nl[:7] + 1).clamp(max=nbytes - 1).contiguous()
        for name, idx, windows in (("row_spans", nl[:7].contiguous(), (256, 4096)),
                                   ("anchors_back", hits.contiguous(), (256, 1024))):
            c, fn = ctx("select_step", name)
            for window in windows:
                c.config = f"(plane_bytes={nbytes}, window={window})"
                try:
                    def spans(a, b, _window=window, _fn=fn):
                        return _fn(a, b, window=_window)
                    lens, found = call(c, spans, (arr, idx))
                    c.shape(lens, (idx.numel(),), "row offsets")
                    c.dtype(lens, i32, "row offsets")
                    c.shape(found, (idx.numel(),), "found mask")
                    c.dtype(found, b8, "found mask")
                except Exception as e:
                    c.fail(e)
        c, fn = ctx("select_step", "gather_rows")
        for window in (64, 1024):
            c.config = f"(plane_bytes={nbytes}, window={window})"
            try:
                def gather(a, b, _window=window):
                    return fn(a, b, window=_window)
                mat = call(c, gather, (arr, starts))
                c.shape(mat, (starts.numel(), window), "gathered row matrix")
                c.dtype(mat, u8, "gathered row matrix")
            except Exception as e:
                c.fail(e)

    # ---- parallel/mesh.py: the plan cache's kernels ---------------------
    #
    # Each registered kind runs through both lowerings where it has both
    # builders, on a 2 x 2 mesh whose four slots repeat ``device``, and
    # must equal the single-device steps on the same inputs.

    mesh = pmesh.make_mesh((dev,) * 4, 2, 2)
    mesh_checked: "set[str]" = set()
    B = _MESH_BATCH

    def modes(kind):
        kd = prules.kernel_def(kind)
        return [mode for mode, b in (("global", kd.build_global),
                                     ("local", kd.build_local)) if b is not None]

    def mesh_ctx(kind):
        mesh_checked.add(kind)
        kd = prules.kernel_def(kind)
        return _Ctx(report, kd.build_local or kd.build_global,
                    ENTRY_POINT_PATHS["mesh"])

    def run_kind(kind, mode, planes, statics):
        report.checked += 1
        fn = prules.compile_kernel(kind, mesh, force_mode=mode, **statics)
        args = [pmesh.put_sharded(mesh, a, prules.spec_for(p)) for a, p in planes]
        out = fn(*args)
        out = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o) for o in out]

    def np_same(c, got, want, what):
        if got.shape != want.shape or not np.array_equal(got, want):
            c._add("MTPU203", f"{what} differs from the single-device "
                   f"steps at {c.config}")

    for k, m, L in CONFIG_GRID:
        w, n = L // 4, k + m
        xw = rng.integers(0, 1 << 32, (B, k, w), dtype=np.uint64).astype(np.uint32)
        xd = torch.from_numpy(xw.view(np.int32)).to(dev)
        par_d, dig_d, _f, _p = codec_step.encode_words_fused1(xd, m, L)
        par = codec_step.tensor_to_words(par_d)
        dig = codec_step.tensor_to_words(dig_d)
        shards = np.concatenate([xw, par], axis=1)
        present = _worst(k, m)
        idx = tuple(i for i, p in enumerate(present) if p)[:k]
        seq_L = L - L % 16

        cases = [
            ("sharded_encode", [(xw.view(np.uint8), "stripe_bytes")],
             dict(k=k, m=m), [par.view(np.uint8)], [np.uint8]),
            ("sharded_encode_seq",
             [(np.ascontiguousarray(xw[0].view(np.uint8)[:, :seq_L]), "seq_bytes")],
             dict(k=k, m=m),
             [np.ascontiguousarray(par[0].view(np.uint8)[:, :seq_L])], [np.uint8]),
            ("mesh_encode_hash", [(xw, "stripe_words")],
             dict(k=k, m=m, shard_len=L),
             [par, dig[:, :k], dig[:, k:]], [np.uint32] * 3),
            ("mesh_reconstruct",
             [(np.ascontiguousarray(shards[:, idx, :]), "survivor_words")],
             dict(k=k, m=m, idx=idx), [xw], [np.uint32]),
            ("mesh_digest", [(shards.reshape(B * n, w), "digest_rows")],
             dict(shard_len=L), [dig.reshape(B * n, 8)], [np.uint32]),
            ("mesh_verify_reconstruct",
             [(shards, "quorum_words"), (dig, "quorum_digests")],
             dict(k=k, m=m, present=present, shard_len=L),
             [xw, np.broadcast_to(np.array(present), (B, n))],
             [np.uint32, np.bool_]),
        ]
        for kind, planes, statics, wants, dtypes in cases:
            c = mesh_ctx(kind)
            for mode in modes(kind):
                c.config = _cfg(k, m, L, f", {mode}")
                if kind == "mesh_verify_reconstruct" and refused(
                        c, n, run_kind, (kind, mode, planes, statics)):
                    continue
                try:
                    outs = run_kind(kind, mode, planes, statics)
                    c.expect("MTPU202", len(outs), len(wants), "output count")
                    for i, (o, want, dt) in enumerate(zip(outs, wants, dtypes)):
                        c.shape(o, want.shape, f"{kind} output {i}")
                        c.expect("MTPU201", str(o.dtype), str(np.dtype(dt)),
                                 f"{kind} output {i} dtype")
                        np_same(c, o, want, f"{kind} output {i}")
                except Exception as e:
                    c.fail(e)

    # seam-registry closure: a kernel registered with the plan cache but
    # missing a contract block above fails MTPU204
    for kind in prules.registered_kernels():
        if kind not in mesh_checked:
            kd = prules.kernel_def(kind)
            path, line = _anchor(kd.build_local or kd.build_global,
                                 ENTRY_POINT_PATHS["mesh"])
            report.findings.append(Finding(
                "MTPU204", path, line,
                f"mesh kernel {kind!r} registered with the plan cache has "
                "no contract check; add one in "
                "minio_tpu_torch/analysis/kernel_contracts.py",
            ))

    # ---- coverage closure (MTPU204) -------------------------------------

    report.findings.extend(coverage_findings(checked))
    if on_card:
        torch.cuda.synchronize(dev)
    report.launches = {name: n - before.get(name, 0)
                       for name, n in kernels.LAUNCHES.items()
                       if n != before.get(name, 0)}
    report.seconds = time.monotonic() - t0
    return report
