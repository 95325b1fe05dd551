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
    kernels.phash256_batched(words, 2048)
    kernels.gf_matmul_words(tgf.parity_matrix(8, 4), words, tuple(range(8)))
    assert kernels.LAUNCHES == {
        "encode_pack": 0, "phash256_batched": 0, "gf_matmul_words": 0
    }


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
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match="slice"):
        tcs.codec_kernel_mode()
        tcs.codec_formulation()
        tcs.codec_overlap_mode()


def test_default_codec_knobs(monkeypatch):
    for env in (
        "MINIO_TPU_CODEC_KERNEL",
        "MINIO_TPU_CODEC_FORMULATION",
        "MINIO_TPU_CODEC_OVERLAP",
    ):
        monkeypatch.delenv(env, raising=False)
    assert tcs.codec_kernel_mode() == "fused1"
    assert tcs.codec_formulation() == "swar"
    assert tcs.codec_overlap_mode() == "off"
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
    assert tcs.codec_overlap_mode() == "off"
