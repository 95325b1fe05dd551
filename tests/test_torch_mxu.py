"""MINIO_TPU_CODEC_FORMULATION=mxu in the port, held against minio_tpu.

The ``mxu`` formulation computes the GF(2^8) product as a product of the
lifted (8o, 8s) GF(2) bit matrix with the input bits, mod 2.  Here the
same numpy inputs go through the JAX package (``rs_pallas._bit_matrix``,
``_mxu_rows`` outside a kernel, P3-P7 with ``formulation="mxu"`` in
interpret mode, TpuBackend and the object layer under
MINIO_TPU_CODEC_INTERPRET=1) and through the port's plain versions
(``device="cpu"``).  Everything is integer arithmetic: the tolerance is
zero.  Also covered: the operand order of the card's 1-bit tensor-core
product (``kernels.mxu_fragments``), emulated lane by lane, and which
passes the formulation reaches - only the PUT pass and heal's read pass,
as in the JAX package.
"""

import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.ops import gf as jgf, rs_pallas
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.ops import codec_step as tcs, gf as tgf, hash as thash
from minio_tpu_torch.ops import kernels, rs
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    for env in ("MINIO_TPU_CODEC_OVERLAP", "MINIO_TPU_CODEC_FORMULATION",
                "MINIO_TPU_CODEC_INTERPRET"):
        monkeypatch.delenv(env, raising=False)
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return tcs.words_to_tensor(words, "cpu")


def _n(t: torch.Tensor) -> np.ndarray:
    return tcs.tensor_to_words(t)


def _recon(k, m, lost):
    idx = tuple(i for i in range(k + m) if i not in lost)[:k]
    return tgf.reconstruction_matrix(k, m, idx)


# (o, s) matrices: the EC 4+2 / 8+4 parity matrices, (8, 8) reconstruction
# matrices of three survivor patterns, a dense 16 x 16 and a 1 x 1
MATRICES = {
    "parity 4x8": tgf.parity_matrix(8, 4),
    "recon 8+4 lost 0,2,9,11": _recon(8, 4, (0, 2, 9, 11)),
    "recon 8+4 lost 0-3": _recon(8, 4, (0, 1, 2, 3)),
    "recon 8+4 lost 7": _recon(8, 4, (7,)),
    "dense 16x16": np.random.default_rng(16).integers(0, 256, (16, 16)).astype(np.uint8),
    "1x1": np.array([[0x8E]], dtype=np.uint8),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_bit_matrix_and_mxu_rows_match_jax(name):
    matrix = MATRICES[name]
    o, s = matrix.shape
    assert np.array_equal(
        rs.bit_matrix(matrix), rs_pallas._bit_matrix(matrix.tobytes(), o, s)
    )
    words = _words((s, 520), seed=o * 31 + s)
    words[:, :8] = 0xFFFFFFFF
    words[:, 8:16] = 0x80808080
    ref = np.stack([np.asarray(r) for r in rs_pallas._mxu_rows(matrix, jnp.asarray(words))])
    got = _n(rs.mxu_rows(matrix, _t(words)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _n(rs.matmul_static(_t(words), matrix, "swar")))


@pytest.mark.parametrize("length", [8192, 8192 + 17])
@pytest.mark.parametrize("name", ["parity 4x8", "recon 8+4 lost 0,2,9,11"])
def test_gf_matmul_mxu_plain_matches_p3_interpret(name, length):
    matrix = MATRICES[name]
    s = matrix.shape[1]
    shards = np.random.default_rng(length).integers(0, 256, (s, length), np.uint8)
    ref = np.asarray(rs_pallas.gf_matmul_mxu(matrix, jnp.asarray(shards), interpret=True))
    got = kernels.gf_matmul_mxu(matrix, torch.from_numpy(shards))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)


def test_gf_matmul_mxu_plain_matches_encode_ref():
    data = np.random.default_rng(3).integers(0, 256, (8, 4099), np.uint8)
    got = kernels.gf_matmul_mxu(tgf.parity_matrix(8, 4), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), jgf.encode_ref(data, 4))
    with pytest.raises(ValueError):
        kernels.gf_matmul_mxu(tgf.parity_matrix(8, 4), torch.from_numpy(data[:7]))


def _emulate_mxu_tile(frags: np.ndarray, tile: np.ndarray, o: int) -> np.ndarray:
    """csrc/codec.cu mxu_tile, lane by lane, for one warp's 32 word
    columns: the B words by byte permutes, mma.m16n8k128 .b1 .and.popc
    on the fragment layout of the PTX ISA, the shuffles and the store."""
    s = tile.shape[0]
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    q, h = g & 3, g >> 2
    out = np.zeros((o, 32), dtype=np.uint32)
    for nt in range(16):
        base = nt * 2
        b = np.zeros(32, dtype=np.uint64)
        for i in range(4):
            r = 4 * tig + i
            x = np.where(r < s, tile[np.minimum(r, s - 1), base + h], 0).astype(np.uint64)
            b |= ((x >> (8 * q).astype(np.uint64)) & 0xFF) << np.uint64(8 * i)
        # B[k][n]: bit k % 32 of lane (n, k // 32)'s word
        bmat = np.array([[(int(b[4 * n + k // 32]) >> (k % 32)) & 1 for n in range(8)]
                         for k in range(128)])
        for mt in range((o + 1) // 2):
            amat = np.zeros((16, 128), dtype=np.int64)
            for ln in range(32):
                for half in range(2):
                    word = int(frags[mt, ln, half])
                    row = (ln >> 2) + 8 * half
                    for i in range(32):
                        amat[row, 32 * (ln & 3) + i] = (word >> i) & 1
            d = amat @ bmat  # (16, 8) popcounts
            c0, c1 = d[g, 2 * tig], d[g, 2 * tig + 1]
            c2, c3 = d[g + 8, 2 * tig], d[g + 8, 2 * tig + 1]
            v = ((c0 & 1) << q) | ((c2 & 1) << (q + 4)) | ((c1 & 1) << (8 + q)) | (
                (c3 & 1) << (12 + q)
            )
            v = v | v[lane ^ 4]
            v = v | v[lane ^ 8]
            word = v | (v[lane ^ 1] << 16)
            for ln in range(32):
                r = 2 * mt + h[ln]
                if q[ln] == 0 and (tig[ln] & 1) == 0 and r < o:
                    out[r, base + (tig[ln] >> 1)] = word[ln]
    return out


@pytest.mark.parametrize("name", ["parity 4x8", "recon 8+4 lost 0,2,9,11", "1x1"])
def test_mxu_fragments_drive_the_tile_product(name):
    """The kernels' operand order, emulated: mxu_fragments(matrix) and the
    mxu_tile data flow give the GF(2^8) product."""
    matrix = MATRICES[name]
    o, s = matrix.shape
    frags = kernels.mxu_fragments(matrix)
    assert frags.shape == (8, 32, 2) and frags.dtype == np.uint32
    tile = _words((s, 32), seed=o + s)
    got = _emulate_mxu_tile(frags, tile, o)
    assert np.array_equal(got, _n(rs.matmul_static(_t(tile), matrix)))


def test_mxu_fragments_pad_with_zeros():
    frags = kernels.mxu_fragments(tgf.parity_matrix(8, 4))
    assert not frags[2:].any()  # m-tiles past output row 3
    lane = np.arange(32)
    assert not frags[:, lane & 3 >= 2].any()  # bits past input row 7


W = 4096  # one P4-P7 tile: the JAX kernels take w % 4096 == 0


def test_encode_pack_mxu_matches_p4_p6_interpret():
    """K1's and K5's plain mxu forms against P4 and P6 under mxu, with
    the pack leg: parity, digests, flags and the packed rows (P6
    promises only the packed prefix)."""
    words = _words((2, 4, W), seed=41)
    words[1, :, 512:2048] = 0  # zero groups for the pack leg
    t = _t(words)
    for enc, pallas in [
        (kernels.encode_pack, rs_pallas.encode_pack_fused),
        (kernels.encode_pack_pipelined, rs_pallas.encode_pack_pipelined),
    ]:
        parity, partials, flags, packed = pallas(
            jnp.asarray(words), 2, group=256, formulation="mxu", interpret=True
        )
        digests = thash.finalize_partials(_t(np.asarray(partials)), 4 * W)
        gp, gd, gfl, gpk = enc(t, 2, 4 * W, 256, formulation="mxu")
        assert np.array_equal(_n(gp), np.asarray(parity))
        assert torch.equal(gd, digests)
        assert np.array_equal(gfl.numpy(), np.asarray(flags).astype(np.int32))
        kept = np.asarray(flags).sum(axis=-1) * 256
        port, ref = _n(gpk), np.asarray(packed)
        for b in range(2):
            for r in range(2):
                n = int(kept[b, r])
                assert np.array_equal(port[b, r, :n], ref[b, r, :n])
                assert not port[b, r, n:].any()
        swar = enc(t, 2, 4 * W, 256)
        assert all(torch.equal(a, b) for a, b in zip((gp, gd, gfl, gpk), swar))


@pytest.mark.parametrize(
    "present",
    [(False, True, True, True, True, False), (True, True, False, True, True, True)],
)
def test_verify_reconstruct_mxu_matches_p5_p7_interpret(present):
    """K4's and K6's plain mxu forms against P5 and P7 under mxu: the
    same data rows and, for every present row, the same digests."""
    k, m = 4, 2
    shards = _words((2, k + m, W), seed=sum(present))
    idx = tuple(i for i, p in enumerate(present) if p)[:k]
    pres = np.asarray(present)
    t = _t(shards)
    for vr, pallas in [
        (kernels.verify_reconstruct, rs_pallas.verify_reconstruct_fused),
        (kernels.verify_reconstruct_pipelined, rs_pallas.verify_reconstruct_pipelined),
    ]:
        data, partials = pallas(
            jnp.asarray(shards), idx, k, m, formulation="mxu", interpret=True
        )
        digests = thash.finalize_partials(_t(np.asarray(partials)), 4 * W)
        got_d, got_dig = vr(t, present, k, 4 * W, formulation="mxu")
        assert np.array_equal(_n(got_d), np.asarray(data))
        assert torch.equal(got_dig[:, pres], digests[:, pres])
        swar = vr(t, present, k, 4 * W)
        assert torch.equal(got_d, swar[0]) and torch.equal(got_dig, swar[1])


def test_wrappers_reject_unknown_formulation():
    t = _t(_words((1, 4, 512), seed=1))
    with pytest.raises(ValueError, match="formulation"):
        kernels.encode_pack(t, 2, 2048, formulation="bf16")
    with pytest.raises(ValueError, match="formulation"):
        kernels.verify_reconstruct_pipelined(t, (True,) * 4, 2, 2048, formulation="x")
    with pytest.raises(ValueError, match="formulation"):
        rs.matmul_static(t[0], tgf.parity_matrix(4, 2), "x")


def _roundtrip(be, data, m, drop=()):
    """PUT digest seam + drain, then heal's reconstruct_and_verify with
    ``drop`` shards absent (garbage in their rows)."""
    B, k, L = data.shape
    digests, ref = be.encode_digest_end(be.encode_digest_begin(data, m))
    parity = np.asarray(ref.drain())
    shards = np.concatenate([data, parity.reshape(B, m, L)], axis=1).copy()
    present = [i not in drop for i in range(k + m)]
    shards[:, list(drop), :] = 0x5A
    out, ok = be.reconstruct_and_verify(shards, digests, present, k, m)
    return np.asarray(digests), parity, np.asarray(out), np.asarray(ok)


def test_backend_mxu_matches_tpu_backend_interpret(monkeypatch):
    """TorchBackend("cpu") against TpuBackend under mxu with the Pallas
    kernels interpreted (the JAX side's only route to _mxu_rows), and
    against the port's own swar run."""
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "mxu")
    data = np.random.default_rng(9).integers(0, 256, (2, 4, 4 * W), dtype=np.uint8)
    monkeypatch.setenv("MINIO_TPU_CODEC_INTERPRET", "1")
    want = _roundtrip(jbackend.TpuBackend(), data, 2, drop=(1, 4))
    monkeypatch.delenv("MINIO_TPU_CODEC_INTERPRET")
    got = _roundtrip(tbackend.TorchBackend("cpu"), data, 2, drop=(1, 4))
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "swar")
    swar = _roundtrip(tbackend.TorchBackend("cpu"), data, 2, drop=(1, 4))
    for a, b, c in zip(want, got, swar):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    assert np.array_equal(got[2], data)


@pytest.fixture
def mxu_calls(monkeypatch):
    """Counts calls of rs.mxu_rows, the plain mxu product."""
    calls = []
    real = rs.mxu_rows
    monkeypatch.setattr(
        rs, "mxu_rows", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    )
    return calls


def test_only_put_and_heal_read_take_mxu(monkeypatch, mxu_calls):
    """Under mxu the PUT pass and heal's read pass run the mxu product;
    heal's re-encode, the degraded-GET reconstruct, the healthy-GET
    digest and the async sub-chunk chain stay swar, as in the JAX
    package.  A batch too small for S >= 3 sub-chunks takes the
    serialized path under async, and with it mxu."""
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "mxu")
    be = tbackend.TorchBackend("cpu")
    data = np.random.default_rng(2).integers(0, 256, (2, 4, 4096), dtype=np.uint8)
    digests, ref = be.encode_digest_end(be.encode_digest_begin(data, 2))
    assert mxu_calls == [(2, 4)]  # PUT: the (m, k) parity matrix
    shards = np.concatenate([data, ref.drain()], axis=1)
    present = (False, True, True, True, True, False)
    del mxu_calls[:]
    out, _ok = be.reconstruct_and_verify(shards, digests, present, 4, 2)
    assert np.array_equal(out, data)
    assert mxu_calls == [(4, 4)]  # heal's read: the (k, k) reconstruction
    del mxu_calls[:]
    be.encode_end(be.encode_begin(data, 2))  # heal's re-encode
    assert np.array_equal(be.reconstruct(shards, present, 4, 2), data)
    be.digest(shards)
    assert mxu_calls == []
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "async")
    monkeypatch.setenv("MINIO_TPU_CODEC_SUBCHUNK_KB", "1")
    digests2, ref2 = be.encode_digest_end(be.encode_digest_begin(data, 2))
    assert np.array_equal(digests2, digests) and np.array_equal(ref2.drain(), shards[:, 4:])
    out, _ok = be.reconstruct_and_verify(shards, digests, present, 4, 2)
    assert np.array_equal(out, data) and mxu_calls == []
    small = data[:, :, :1024]  # 256 words: under 3 chunks of 1 KiB
    be.encode_digest_end(be.encode_digest_begin(small, 2))
    assert mxu_calls == [(2, 4)]


# ---------------------------------------------------------------------------
# The object layer under mxu, against minio_tpu's under the same settings
# ---------------------------------------------------------------------------

K, M, BLOCK = 4, 2, 64 * 1024  # 16 KiB shards: one P4/P5 tile per block
SIZE = BLOCK + 17


def _part(root, name):
    fi = XLStorage(root).read_version("bkt", name)
    with open(os.path.join(root, "bkt", name, fi.data_dir, "part.1"), "rb") as f:
        return f.read()


def _meta_doc(root, name):
    with open(os.path.join(root, "bkt", name, "xl.meta"), "rb") as f:
        raw = f.read()
    out = []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


def _files(roots):
    return [(_part(r, "obj"), _meta_doc(r, "obj")) for r in roots]


def _damage(roots, shards):
    dist = XLStorage(roots[0]).read_version("bkt", "obj").erasure.distribution
    for s in shards:
        shutil.rmtree(os.path.join(roots[dist.index(s)], "bkt", "obj"))


def test_object_layer_mxu_matches_jax(tmp_path, monkeypatch, mxu_calls):
    """PUT, then heal after losing shards 1 (data) and 6 (parity), under
    mxu in both packages: the same part files and xl.meta."""
    monkeypatch.setenv("MINIO_TPU_CODEC_FORMULATION", "mxu")
    monkeypatch.setenv("MINIO_TPU_CODEC_OVERLAP", "off")
    payload = np.random.default_rng(12).bytes(SIZE)

    monkeypatch.setenv("MINIO_TPU_CODEC_INTERPRET", "1")
    jroots = [str(tmp_path / f"j{i}") for i in range(K + M)]
    ref = JaxObjects([JaxStorage(r) for r in jroots], parity_blocks=M, block_size=BLOCK)
    ref.make_bucket("bkt")
    ref.put_object("bkt", "obj", io.BytesIO(payload), SIZE)
    written = _files(jroots)
    _damage(jroots, (1, 6))
    healed = ref.heal_object("bkt", "obj")
    after = _files(jroots)
    monkeypatch.delenv("MINIO_TPU_CODEC_INTERPRET")

    roots = [str(tmp_path / f"t{i}") for i in range(K + M)]
    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK, device="cpu"
    )
    ol.make_bucket("bkt")
    ol.put_object("bkt", "obj", io.BytesIO(payload), SIZE)
    assert _files(roots) == written
    assert mxu_calls  # the PUT ran the mxu product
    _damage(roots, (1, 6))
    del mxu_calls[:]
    assert ol.heal_object("bkt", "obj") == healed
    assert _files(roots) == after
    assert mxu_calls  # and so did heal's read pass
    sink = io.BytesIO()
    ol.get_object("bkt", "obj", sink)
    assert sink.getvalue() == payload
