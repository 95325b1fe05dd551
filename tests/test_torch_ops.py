"""The port's codec ops (minio_tpu_torch.ops) held against minio_tpu.

The same numpy inputs go through the JAX package's functions - the
portable XLA path, the Pallas kernels in interpret mode, and the numpy
references - and through the port's kernel wrappers, which run their
plain PyTorch versions for CPU tensors.  All comparisons are bit-exact:
this is integer arithmetic, so the tolerance is zero.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import codec_step as jcs, gf as jgf, hash as jhash, rs_pallas
from minio_tpu_torch.ops import codec_step as tcs, gf as tgf, hash as thash, kernels
from tests.test_torch_threads import torch_threads  # noqa: F401

GEOMS = [(1, 1), (4, 2), (8, 4), (12, 4)]
WIDTHS = [8, 264, 4096, 8192 + 8]
KINDS = ["random", "zeros", "one_group", "ff", "x80"]


def _stripes(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    out = np.zeros(shape, dtype=np.uint32)
    if kind == "one_group":
        w = shape[-1]
        lo = 256 if w >= 512 else 0
        out[..., 0, lo : lo + min(256, w)] = rng.integers(
            1, 1 << 32, min(256, w), dtype=np.uint64
        ).astype(np.uint32)
    elif kind == "ff":
        out[:] = 0xFFFFFFFF
    elif kind == "x80":
        out[:] = 0x80808080
    return out


def _t(words: np.ndarray) -> torch.Tensor:
    return tcs.words_to_tensor(words, "cpu")


def _n(t: torch.Tensor) -> np.ndarray:
    return tcs.tensor_to_words(t)


def _group(w: int) -> int:
    return 256 if w % 256 == 0 and w // 256 >= 2 else 0


def _check_fused1(words, m, group, ref):
    parity, digests, flags, packed = tcs.encode_words_fused1(
        _t(words), m, 4 * words.shape[-1], group
    )
    rp, rd, rf, rpk = ref
    assert np.array_equal(_n(parity), np.asarray(rp))
    assert np.array_equal(_n(digests), np.asarray(rd))
    assert np.array_equal(flags.numpy(), np.asarray(rf) != 0)
    assert np.array_equal(_n(packed), np.asarray(rpk))


@pytest.mark.parametrize("k,m", GEOMS)
@pytest.mark.parametrize("w", WIDTHS)
def test_encode_fused1_matches_portable(k, m, w):
    words = _stripes("random", (2, k, w), seed=k * 1000 + w)
    words[0, :, :8] = 0xFFFFFFFF
    words[1, :, :8] = 0x80808080
    group = _group(w)
    ref = jcs.encode_words_fused1(
        jnp.asarray(words), m, 4 * w, group=group, use_pallas=False
    )
    _check_fused1(words, m, group, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_encode_fused1_stripe_kinds(kind):
    words = _stripes(kind, (3, 8, 4096), seed=7)
    ref = jcs.encode_words_fused1(
        jnp.asarray(words), 4, 4 * 4096, group=256, use_pallas=False
    )
    _check_fused1(words, 4, 256, ref)


@pytest.mark.parametrize(
    "k,m,w,group",
    [(8, 4, 4096, 256), (8, 4, 8192, 0), (12, 4, 4096, 256), (4, 2, 8192, 256)],
)
def test_encode_matches_pallas_interpret(k, m, w, group):
    words = _stripes("random", (2, k, w), seed=w + k)
    words[1, :, 1024:4096] = 0  # zero groups for the pack leg
    parity, partials, flags, packed = rs_pallas.encode_pack_fused(
        jnp.asarray(words), m, group=group, interpret=True
    )
    digests = jhash.finalize_partials(partials, 4 * w)
    _check_fused1(words, m, group, (parity, digests, flags, packed))


def test_encode_matches_numpy_reference():
    words = _stripes("random", (1, 8, 264), seed=3)
    parity, digests, _f, _p = tcs.encode_words_fused1(_t(words), 4, 4 * 264)
    data_b = words[0].view(np.uint8)
    assert np.array_equal(
        _n(parity)[0].view(np.uint8), jgf.encode_ref(data_b, 4)
    )
    allw = np.concatenate([words[0], _n(parity)[0]])
    assert np.array_equal(
        _n(digests)[0], jhash.phash256_host_batched(allw, 4 * 264)
    )


PATTERNS = [
    (8, 4, (False, True, False, True) + (True,) * 8),
    (8, 4, (True,) * 4 + (False,) * 4 + (True,) * 4),
    (4, 2, (False, False, True, True, True, True)),
    (12, 4, (True,) * 11 + (False,) + (True,) * 4),
]


@pytest.mark.parametrize("k,m,present", PATTERNS)
@pytest.mark.parametrize("w", [8, 264, 4096])
def test_reconstruct_matches_jax(k, m, present, w):
    shards = _stripes("random", (3, k + m, w), seed=w + k)
    shards[0, :, :8] = 0xFFFFFFFF
    ref = jcs.reconstruct_words_batch(jnp.asarray(shards), present, k, m)
    got = tcs.reconstruct_words_batch(_t(shards), present, k, m)
    assert np.array_equal(_n(got), np.asarray(ref))


@pytest.mark.parametrize("k,m,present", PATTERNS[:2])
def test_gf_matmul_matches_pallas_interpret(k, m, present):
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    rm = jgf.reconstruction_matrix(k, m, idx)
    shards = _stripes("random", (1, k + m, 4096), seed=11)
    ref = rs_pallas.matmul_words(
        rm, jnp.asarray(shards[0, list(idx)]), interpret=True
    )
    got = kernels.gf_matmul_words(rm, _t(shards), idx)
    assert np.array_equal(_n(got)[0], np.asarray(ref))


def _vr_inputs(k, m, present, w, seed):
    """Clean shards with their stored digests, then the damage heal
    sees: absent rows hold garbage and, in stripe 1, one present row
    has a flipped word."""
    n = k + m
    data = _stripes("random", (3, k, w), seed=seed)
    data[0, :, :8] = 0xFFFFFFFF
    parity = jcs.encode_and_hash_words(jnp.asarray(data), m, 4 * w)[0]
    shards = np.concatenate([data, np.asarray(parity)], axis=1)
    digests = jhash.phash256_host_batched(shards, 4 * w)
    shards[:, [i for i, p in enumerate(present) if not p]] = 0xA5A5A5A5
    bad = [i for i, p in enumerate(present) if p][n % 3 % len(present)]
    shards[1, bad, w // 2] ^= 0x00010000
    return shards, digests


VR_PATTERNS = PATTERNS + [
    (8, 4, (True,) * 12),
    (8, 4, (True,) * 8 + (False,) * 4),
    (6, 3, (True, True, False, True, False, True, True, True, True)),
]


@pytest.mark.parametrize("k,m,present", VR_PATTERNS)
@pytest.mark.parametrize("w", [8, 264, 4096])
def test_verify_and_reconstruct_matches_jax(k, m, present, w):
    shards, digests = _vr_inputs(k, m, present, w, seed=w + k)
    ref_data, ref_ok = jcs.verify_and_reconstruct_words(
        jnp.asarray(shards), jnp.asarray(digests), present, k, m, 4 * w,
        use_pallas=False,
    )
    data, ok = tcs.verify_and_reconstruct_words(
        _t(shards), _t(digests), present, k, m, 4 * w
    )
    assert np.array_equal(_n(data), np.asarray(ref_data))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert not ok[1].all() and ok.sum() > 0


@pytest.mark.parametrize("k,m,present", VR_PATTERNS[:2] + VR_PATTERNS[-3:])
def test_verify_reconstruct_matches_pallas_interpret(k, m, present):
    """K4's plain version against P5 in interpret mode: the same data
    rows, and the same digests for every present row (the kernel leaves
    absent rows unhashed)."""
    w = 4096
    shards, _d = _vr_inputs(k, m, present, w, seed=k * 7)
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    ref_data, partials = rs_pallas.verify_reconstruct_fused(
        jnp.asarray(shards), idx, k, m, interpret=True
    )
    ref_dig = np.asarray(jhash.finalize_partials(partials, 4 * w))
    data, digests = kernels.verify_reconstruct(_t(shards), present, k, 4 * w)
    pres = np.asarray(present)
    assert np.array_equal(_n(data), np.asarray(ref_data))
    assert np.array_equal(_n(digests)[:, pres], ref_dig[:, pres])
    assert np.array_equal(
        _n(digests)[:, pres], jhash.phash256_host_batched(shards[:, pres], 4 * w)
    )


def test_verify_reconstruct_rejects_short_patterns():
    words = _t(_stripes("random", (1, 12, 64), seed=2))
    with pytest.raises(ValueError, match="need 8 shards, have 7"):
        kernels.verify_reconstruct(words, (True,) * 7 + (False,) * 5, 8, 256)
    with pytest.raises(ValueError, match="present"):
        kernels.verify_reconstruct(words, (True,) * 11, 8, 256)
    with pytest.raises(ValueError, match="shard_len"):
        tcs.verify_and_reconstruct_words(
            words, torch.zeros((1, 12, 8), dtype=torch.int32),
            (True,) * 12, 8, 4, 255,
        )


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (12, 4)])
def test_encode_group0_matches_encode_hash_fused(k, m):
    """K1 without the pack leg computes P2 (heal's re-encode)."""
    w = 8192
    words = _stripes("random", (2, k, w), seed=k + m)
    parity, partials = rs_pallas.encode_hash_fused(
        jnp.asarray(words), m, interpret=True
    )
    got_p, got_d, flags, packed = kernels.encode_pack(_t(words), m, 4 * w, 0)
    assert np.array_equal(_n(got_p), np.asarray(parity))
    assert np.array_equal(
        _n(got_d), np.asarray(jhash.finalize_partials(partials, 4 * w))
    )
    assert flags.shape == (2, m, 0) and packed is got_p


def test_reconstruct_inverts_encode():
    data = _stripes("random", (2, 8, 264), seed=5)
    parity, _d, _f, _p = tcs.encode_words_fused1(_t(data), 4, 4 * 264)
    full = np.concatenate([data, _n(parity)], axis=1)
    present = tuple(i not in (0, 3, 5, 9) for i in range(12))
    got = tcs.reconstruct_words_batch(_t(full), present, 8, 4)
    assert np.array_equal(_n(got), data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 264), (4, 8200)])
def test_digest_matches_jax(kind, shape):
    words = _stripes(kind, shape, seed=len(shape))
    nbytes = 4 * shape[-1]
    got = _n(tcs.digest_words_batched(_t(words), nbytes))
    assert np.array_equal(
        got, np.asarray(jhash.phash256_words_batched(jnp.asarray(words), nbytes))
    )
    assert np.array_equal(got, jhash.phash256_host_batched(words, nbytes))


def test_tile_partials_compose_across_chunks():
    words = _stripes("random", (2, 1024), seed=9)
    whole = thash.phash256_words_batched(_t(words), 4096)
    acc = thash.tile_partials(_t(words[:, :512]), 0) ^ thash.tile_partials(
        _t(words[:, 512:]), 512
    )
    assert torch.equal(thash.finalize_partials(acc, 4096), whole)


def test_host_twins_are_copies():
    words = _stripes("random", (3, 40), seed=2)
    assert np.array_equal(
        thash.phash256_host_batched(words, 160),
        jhash.phash256_host_batched(words, 160),
    )
    data = np.random.default_rng(4).bytes(101)
    assert thash.phash256_host(data) == jhash.phash256_host(data)
    for k, m in GEOMS:
        assert np.array_equal(tgf.parity_matrix(k, m), jgf.parity_matrix(k, m))


def test_cpu_wrappers_run_plain_and_count_nothing():
    kernels.reset_launches()
    words = _t(_stripes("random", (1, 8, 512), seed=1))
    kernels.encode_pack(words, 4, 2048, 256)
    kernels.encode_pack(words, 4, 2048, 0)
    kernels.phash256_batched(words, 2048)
    kernels.gf_matmul_words(tgf.parity_matrix(8, 4), words, tuple(range(8)))
    kernels.verify_reconstruct(words, (True,) * 8, 6, 2048)
    acc = torch.zeros((1, 12, 8), dtype=torch.int32)
    kernels.encode_pack_subchunk(words, acc, 0, 4, 2048)
    kernels.encode_pack_pipelined(words, 4, 2048, 256)
    kernels.verify_reconstruct_subchunk(words, acc[:, :8], 0, (True,) * 8, 6, 2048)
    kernels.verify_reconstruct_pipelined(words, (True,) * 8, 6, 2048)
    kernels.encode_pack(words, 4, 2048, 256, formulation="mxu")
    kernels.verify_reconstruct_pipelined(words, (True,) * 8, 6, 2048, "mxu")
    kernels.gf_matmul_mxu(tgf.parity_matrix(8, 4), torch.zeros((8, 9), dtype=torch.uint8))
    kernels.group_flags(words, 256)
    kernels.pack_nonzero_groups(words, 256)
    assert set(kernels.LAUNCHES) == {
        "encode_pack", "encode_pack[group=0]", "encode_pack[subchunk]",
        "phash256_batched", "gf_matmul_words", "verify_reconstruct",
        "verify_reconstruct[subchunk]", "encode_pack_pipelined",
        "verify_reconstruct_pipelined", "gf_matmul_mxu", "encode_pack[mxu]",
        "verify_reconstruct[mxu]", "encode_pack_pipelined[mxu]",
        "verify_reconstruct_pipelined[mxu]", "group_flags",
        "pack_nonzero_groups", "select_screen",
        "select_positions", "select_spans[row]", "select_spans[back]",
        "select_gather",
    }
    assert not any(kernels.LAUNCHES.values())


def test_wrappers_reject_bad_groups():
    words = _t(_stripes("random", (1, 8, 264), seed=1))
    with pytest.raises(ValueError):
        kernels.encode_pack(words, 4, 4 * 264, 256)  # 264 % 256 != 0
    with pytest.raises(ValueError):
        kernels.encode_pack(words, 4, 4 * 264, 8)


def test_kernel_module_builds_nothing_on_import():
    src = pathlib.Path(kernels.__file__).read_text()
    tree = ast.parse(src)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names}
    assert "triton" not in names
    assert kernels._lib is None  # no CUDA tensor was handed to a wrapper
    assert not any(
        isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
        for n in tree.body
    )


_FAKE_NVCC = """#!/usr/bin/env python3
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
out = args[args.index("-o") + 1]
if os.environ.get("FAKE_NVCC_FAIL") and os.environ["FAKE_NVCC_FAIL"] in args[-1]:
    sys.stderr.write("error in " + args[-1])
    sys.exit(2)
with open(out, "w") as f:
    f.write(" ".join(args))
"""


@pytest.mark.parametrize("fail", [None, "select.cu"])
def test_library_builds_one_nvcc_per_source_then_links(
        monkeypatch, tmp_path, fail):
    """Both sources build into one library: one ``nvcc -c`` each, then
    one link of their objects; a failed compile raises with the
    compiler's output and leaves no library and no object behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "log"
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
    out = tmp_path / "build" / "libmtt_codec-0.so"
    info: dict = {}
    assert [s.name for s in kernels.SOURCES] == ["codec.cu", "select.cu"]
    if fail:
        with pytest.raises(RuntimeError, match="error in .*select.cu"):
            kernels.compile_library(out, kernels.SOURCES, info)
        assert sorted(p.name for p in out.parent.iterdir()) == []
        return
    assert kernels.compile_library(out, kernels.SOURCES, info, ("-I", "g")) == out
    import json

    calls = [json.loads(line) for line in log.read_text().splitlines()]
    compiles, link = calls[:-1], calls[-1]
    assert sorted(c[-1] for c in compiles) == sorted(map(str, kernels.SOURCES))
    for c in compiles:
        assert "-c" in c and "-shared" not in c and c[c.index("-I") + 1] == "g"
        assert "arch=compute_90a,code=sm_90a" in c
    objs = [c[c.index("-o") + 1] for c in compiles]
    assert link[0] == "-shared" and sorted(link[3:]) == sorted(objs)
    assert out.exists() and [p.name for p in out.parent.iterdir()] == [out.name]
    assert set(info["sources"]) == {"codec.cu", "select.cu"}
    assert info["seconds"] >= max(info["sources"].values())
    log.unlink()
    assert kernels.compile_library(out, kernels.SOURCES, {}) == out
    assert not log.exists()  # found by its name: nothing runs


@pytest.mark.parametrize(
    "env,value",
    [
        ("MINIO_TPU_CODEC_KERNEL", "legacy"),
        ("MINIO_TPU_CODEC_FORMULATION", "mxu"),
        ("MINIO_TPU_CODEC_OVERLAP", "pipeline"),
        ("MINIO_TPU_CODEC_OVERLAP", "async"),
    ],
)
def test_unported_codec_knobs_raise(monkeypatch, env, value):
    """Every codec knob of the JAX package is served now (the name is
    kept from when legacy raised): the legacy pass structure, the
    overlap modes and the mxu formulation each resolve, and the PUT and
    heal passes under each equal the default's."""
    monkeypatch.setenv(env, value)
    if env == "MINIO_TPU_CODEC_KERNEL":
        assert tcs.codec_kernel_mode() == "legacy"
        assert tcs.codec_formulation() == "swar"
    elif env == "MINIO_TPU_CODEC_FORMULATION":
        assert tcs.codec_formulation() == "mxu"
        assert tcs.codec_kernel_mode() == "fused1"
    else:
        assert tcs.codec_overlap_mode("cpu") == value
        assert tcs.codec_overlap_mode("cuda") == value
    from minio_tpu_torch.codec.backend import TorchBackend

    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    data = np.random.default_rng(6).integers(0, 256, (2, 4, 4096), np.uint8)
    present = (False, True, True, True, True, False)

    def run():
        be = TorchBackend("cpu")
        digests, ref = be.encode_digest_end(be.encode_digest_begin(data, 2))
        shards = np.concatenate([data, ref.drain()], axis=1)
        shards[:, [0, 5]] = 0
        return digests, shards, be.reconstruct_and_verify(
            shards, digests, present, 4, 2
        )

    got = run()
    monkeypatch.setenv("MINIO_TPU_CODEC_KERNEL", "fused1")
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "swar")
    want = run()
    for a, b in zip(got[:2] + got[2], want[:2] + want[2]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[2][0], data)


def test_default_codec_knobs(monkeypatch):
    """Unset, the overlap mode follows the codec's device as the JAX
    package follows its backend: pipeline on the card, off on the CPU.
    An unknown formulation resolves to swar."""
    for env in (
        "MINIO_TPU_CODEC_KERNEL",
        "MINIO_TPU_CODEC_FORMULATION",
        "MINIO_TPU_CODEC_OVERLAP",
    ):
        monkeypatch.delenv(env, raising=False)
    assert tcs.codec_kernel_mode() == "fused1"
    assert tcs.codec_formulation() == "swar"
    assert tcs.codec_overlap_mode("cpu") == "off"
    assert tcs.codec_overlap_mode(torch.device("cuda", 0)) == "pipeline"
    assert tcs.codec_overlap_mode() == "off"
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "bogus")
    assert tcs.codec_overlap_mode("cuda") == "pipeline"
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
    assert tcs.codec_overlap_mode("cuda") == "off"
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "bogus")
    assert tcs.codec_formulation() == "swar"  # as the JAX package resolves it
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", " MXU ")
    assert tcs.codec_formulation() == "mxu"
