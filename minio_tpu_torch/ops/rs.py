"""GF(2^8) Reed-Solomon products on packed words: the plain PyTorch forms.

Two formulations of the same product, as in the JAX package
(MINIO_TPU_CODEC_FORMULATION):

* ``swar`` (the default).  Bytes are packed 4 per uint32 word (SWAR):
  multiplying by a constant uses the xtime-powers decomposition - for
  each input row materialize x, 2x, 4x, ..., 128x (seven SWAR
  doublings), and each output word is an XOR of the powers selected by
  the bits of its matrix constants.
* ``mxu``.  Multiplying by a constant is an 8x8 linear map over GF(2),
  so the (o, s) matrix lifts to an (8o, 8s) 0/1 matrix (bit_matrix) and
  the product is one matrix product of bit counts taken mod 2
  (mxu_rows; gf_matmul_mxu_plain on bytes).

This module is the plain version the CPU runs and the card's kernels
(``encode_pack`` / ``gf_matmul_words`` / ``gf_matmul_mxu`` and the
``mxu`` instantiations in csrc/codec.cu) are held against, bit for bit.

Words cross into the port as int32 tensors that reinterpret the
little-endian u32 words.  The arithmetic runs in int64 lanes holding the
u32 values so every right shift is logical (``>>`` on int32 is
arithmetic), then returns int32 with the same bits.

Shard layout convention matches cmd/erasure-coding.go: shard i of n sits
in row i; rows [0,k) are data, rows [k,n) are parity.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf
from .hash import from_u32, to_u32

# SWAR constants for 4 packed GF(2^8) elements per uint32 lane.
_LOW7 = 0x7F7F7F7F
_HIGH1 = 0x80808080
_POLY_LOW = gf.POLY & 0xFF  # 0x1d, replicated into each byte by the multiply

FORMULATIONS = ("swar", "mxu")  # the module doc's two products


def check_formulation(formulation: str) -> None:
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown codec formulation: {formulation!r}")


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """Multiply 4 packed field elements by x (i.e. 2): int64 u32 lanes."""
    carries = (x & _HIGH1) >> 7  # 0x01 in each byte that overflows
    return ((x & _LOW7) << 1) ^ (carries * _POLY_LOW)


def need_bits(matrix: np.ndarray) -> list[int]:
    """Per input column, the highest coefficient bit any row uses: the
    length of that column's xtime chain."""
    o, s = matrix.shape
    return [
        max((int(matrix[r, c]).bit_length() for r in range(o)), default=0)
        for c in range(s)
    ]


def _swar_rows(matrix: np.ndarray, rows: list) -> list:
    """Output rows of ``matrix`` GF@ ``rows`` (each an int64 u32 tensor)."""
    o, s = matrix.shape
    nb = need_bits(matrix)
    acc: list = [None] * o
    for c in range(s):
        p = rows[c]
        for b in range(nb[c]):
            for r in range(o):
                if (int(matrix[r, c]) >> b) & 1:
                    acc[r] = p if acc[r] is None else acc[r] ^ p
            if b + 1 < nb[c]:
                p = _xtime(p)
    ref = rows[0] if s else None
    return [
        a if a is not None else torch.zeros_like(ref) for a in acc
    ]


@functools.lru_cache(maxsize=None)
def _bit_matrix(matrix_key: bytes, o: int, s: int) -> np.ndarray:
    matrix = np.frombuffer(matrix_key, dtype=np.uint8).reshape(o, s)
    out = np.zeros((8 * o, 8 * s), dtype=np.uint8)
    for r in range(o):
        for c in range(s):
            v = int(matrix[r, c])
            for b in range(8):
                prod = gf.gf_mul(v, 1 << b)
                for t in range(8):
                    out[8 * r + t, 8 * c + b] = (prod >> t) & 1
    out.setflags(write=False)
    return out


def bit_matrix(matrix: np.ndarray) -> np.ndarray:
    """Lift an (o, s) GF(2^8) matrix to its (8o, 8s) GF(2) form (uint8
    0/1, read-only, cached per matrix): row 8r+t, column 8c+b holds bit t
    of matrix[r, c] * x^b, the contribution of bit b of input byte c to
    bit t of output byte r."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _bit_matrix(m.tobytes(), m.shape[0], m.shape[1])


def _mxu_bytes(matrix: np.ndarray, bts: torch.Tensor) -> torch.Tensor:
    """(s, N) byte values (any integer dtype) -> (o, N) int64 bytes of
    the GF(2^8) product, as one float32 matrix product of bit counts mod
    2.  Exact: every count is at most 8s <= 128 < 2^24, and the 0/1
    operands are exact in TF32 as well."""
    o, s = matrix.shape
    n = bts.shape[-1]
    x = bts.to(torch.int64)
    bits = torch.stack([(x >> b) & 1 for b in range(8)], dim=1)  # (s, 8, N)
    bits = bits.reshape(8 * s, n).to(torch.float32)  # row 8c+b
    mat = torch.from_numpy(bit_matrix(matrix).astype(np.float32)).to(bts.device)
    counts = torch.matmul(mat, bits)  # (8o, N)
    pbits = (counts.to(torch.int64) & 1).reshape(o, 8, n)
    out = pbits[:, 0]
    for t in range(1, 8):
        out = out | (pbits[:, t] << t)
    return out


def mxu_rows(matrix: np.ndarray, words: torch.Tensor) -> torch.Tensor:
    """The ``mxu`` formulation of the product: (s, W) int32 words x
    (o, s) GF matrix -> (o, W) int32.  The four byte planes of the words
    stand side by side on the column axis, so all of them go through ONE
    bit-matrix product; the bytes are then repacked into words."""
    o, _s = matrix.shape
    W = words.shape[-1]
    x = to_u32(words)
    bts = torch.cat([(x >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
    acc8 = _mxu_bytes(matrix, bts)  # (o, 4W)
    out = acc8[:, :W]
    for j in range(1, 4):
        out = out | (acc8[:, j * W:(j + 1) * W] << (8 * j))
    return from_u32(out)


def gf_matmul_mxu_plain(matrix: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """Plain version of the gf_matmul_mxu kernel: (o, s) GF matrix @ (s,
    length) uint8 shards -> (o, length) uint8, any length."""
    o, s = matrix.shape
    if shards.dim() != 2 or shards.shape[0] != s:
        raise ValueError(f"matrix wants ({s}, length) shards, got {tuple(shards.shape)}")
    return _mxu_bytes(matrix, shards).to(torch.uint8)


def matmul_static(words: torch.Tensor, matrix: np.ndarray,
                  formulation: str = "swar") -> torch.Tensor:
    """(s, W) int32 words x (o, s) GF matrix -> (o, W) int32, by the
    ``swar`` or the ``mxu`` formulation (bit-identical)."""
    o, s = matrix.shape
    if words.shape[0] != s:
        raise ValueError(f"matrix wants {s} input rows, got {words.shape[0]}")
    check_formulation(formulation)
    if o == 0:
        return torch.zeros(
            (0,) + tuple(words.shape[1:]), dtype=torch.int32,
            device=words.device,
        )
    if formulation == "mxu":
        return mxu_rows(matrix, words)
    x = to_u32(words)
    out = _swar_rows(matrix, [x[c] for c in range(s)])
    return from_u32(torch.stack(out))


def gf_matmul_words(
    matrix: np.ndarray, words: torch.Tensor, rows: "tuple[int, ...]",
    formulation: str = "swar",
) -> torch.Tensor:
    """Batched product over selected rows: (B, R, w) int32 words, the
    (o, s) matrix applied to rows ``rows`` (s of them, in order) ->
    (B, o, w) int32.  The plain twin of the gf_matmul_words kernel."""
    o, s = matrix.shape
    if len(rows) != s:
        raise ValueError(f"matrix wants {s} input rows, got {len(rows)}")
    B, _R, w = words.shape
    # RS is column-local: the batch is ONE flat (s, B*w) product
    flat = words[:, list(rows), :].transpose(0, 1).reshape(s, B * w)
    out = matmul_static(flat, matrix, formulation)  # (o, B*w)
    return out.reshape(o, B, w).transpose(0, 1).contiguous()


def encode_words(data_words: torch.Tensor, parity_shards: int,
                 formulation: str = "swar") -> torch.Tensor:
    """(B, k, w) int32 data words -> (B, m, w) int32 parity words."""
    k = data_words.shape[1]
    return gf_matmul_words(
        gf.parity_matrix(k, parity_shards), data_words, tuple(range(k)),
        formulation,
    )
