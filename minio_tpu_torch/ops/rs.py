"""GF(2^8) Reed-Solomon products on packed words: the plain PyTorch forms.

Bytes are packed 4 per uint32 word (SWAR): multiplying by a constant uses
the xtime-powers decomposition - for each input row materialize x, 2x,
4x, ..., 128x (seven SWAR doublings), and each output word is an XOR of
the powers selected by the bits of its matrix constants.  This module is
the plain version the CPU runs and the card's kernels
(``encode_pack`` / ``gf_matmul_words`` in csrc/codec.cu) are held
against, bit for bit.

Words cross into the port as int32 tensors that reinterpret the
little-endian u32 words.  The arithmetic runs in int64 lanes holding the
u32 values so every right shift is logical (``>>`` on int32 is
arithmetic), then returns int32 with the same bits.

Shard layout convention matches cmd/erasure-coding.go: shard i of n sits
in row i; rows [0,k) are data, rows [k,n) are parity.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf
from .hash import from_u32, to_u32

# SWAR constants for 4 packed GF(2^8) elements per uint32 lane.
_LOW7 = 0x7F7F7F7F
_HIGH1 = 0x80808080
_POLY_LOW = gf.POLY & 0xFF  # 0x1d, replicated into each byte by the multiply


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


def matmul_static(words: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
    """(s, W) int32 words x (o, s) GF matrix -> (o, W) int32."""
    o, s = matrix.shape
    if words.shape[0] != s:
        raise ValueError(f"matrix wants {s} input rows, got {words.shape[0]}")
    if o == 0:
        return torch.zeros(
            (0,) + tuple(words.shape[1:]), dtype=torch.int32,
            device=words.device,
        )
    x = to_u32(words)
    out = _swar_rows(matrix, [x[c] for c in range(s)])
    return from_u32(torch.stack(out))


def gf_matmul_words(
    matrix: np.ndarray, words: torch.Tensor, rows: "tuple[int, ...]"
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
    out = matmul_static(flat, matrix)  # (o, B*w)
    return out.reshape(o, B, w).transpose(0, 1).contiguous()


def encode_words(data_words: torch.Tensor, parity_shards: int) -> torch.Tensor:
    """(B, k, w) int32 data words -> (B, m, w) int32 parity words."""
    k = data_words.shape[1]
    return gf_matmul_words(
        gf.parity_matrix(k, parity_shards), data_words, tuple(range(k))
    )
