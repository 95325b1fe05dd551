#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --parent DIR   # and K1-K6 beside an older copy

1. Builds the CUDA kernels from ``minio_tpu_torch/csrc`` with nvcc (and
   those of ``--parent``'s copy at the same time), and prints each
   kernel's registers and spills and the static SASS of K1, K4 and K5
   (EC 8+4, swar and mxu), K2, K3 and K6 (``sass_loops``).
2. Holds each kernel bit-exactly against its plain PyTorch version on the
   card, at the main path's shapes (EC 8+4, 10 MiB blocks: 327,680 words
   per shard) and at ragged ones, and times kernel, plain version and the
   bound (bytes or operations at the card's published peaks).
   Heal's kernels get the same: verify_reconstruct (K4) at heal's batch
   of one block and at B = 4 over three survivor patterns, also against
   gf_matmul_words, phash256_host_batched and data that encode_pack
   encoded, with a bitrotted survivor that the backend must re-solve;
   and encode_pack without the pack leg (the P2 function, heal's
   re-encode) at heal's shape.  The overlap kernels too: the pipelined
   K5 and K6 against their plain versions and against K1 and K4, and the
   sub-chunk forms of K1 and K4 chained over S chunks against the
   whole-row pass and against their plain chains.  The mxu formulation
   too: K7 gf_matmul_mxu and the ``mxu`` instantiations of K1, K4, K5
   and K6 against their plain versions and their swar twins, at the main
   path's and heal's shapes and at ragged ones; K1 ``mxu`` also at every
   geometry of ``encode_geometry_sweep`` and on an unaligned view, K4
   ``mxu`` and K6 ``mxu`` also at 1 to 8 rebuilt rows and other row
   buckets, K4 ``mxu`` also on an unaligned view (``vr_mxu_sweep``), K4
   swar on an unaligned view too.  K2 also at row counts
   off its 4-row group, widths off its 1,024-word tile and an unaligned
   view; K6 and K6 ``mxu`` also against their plain versions and K4 for
   every EC 8+4 survivor pattern with 0-4 rows absent.  K1 also at one
   (k, m) of each row bucket and at EC 8+4, 12+4 and 4+2, against its
   plain version, K5 and K5 ``mxu`` (``encode_geometry_sweep``); K3 for
   every EC 8+4 and 4+2 survivor pattern, edge matrices, a width off the
   4-word quad and an unaligned view (``gf_pattern_sweep``).  Beside each kernel's
   back-to-back event time (``ms``): its device time from a replayed
   CUDA graph, the host's time per wrapper call and its L2-cold time
   (``device_times``), and for K1, K3 and K6 a one-tile launch (the
   fixed chain).  With ``--parent``, K1-K6 of both
   copies at the main path's shapes in turns parent, new, new, parent
   (``compare_copies``).
3. Drives the main path through the object layer under the default
   MINIO_TPU_CODEC_OVERLAP (unset: ``pipeline`` on the card): 12 temp-dir
   disks, EC 8+4, 10 MiB blocks; PUT four 64 MiB objects and one of
   10 MiB + 17 bytes, GET each healthy and again with 4 disks offline
   (data-shard disks among them), compares every body with its source,
   compares the part files of the 10 MiB + 17 object with those the same
   port writes on the CPU, and checks that every kernel of that path
   launched (K5 on PUT, and K1 not at all).
4. Heals the same 5 objects on the same disks: 4 shards deleted from each
   64 MiB object and healed with heal_object; on the last object one
   shard bitrotted and 3 deleted, healed by the MRF HealRoutine after a
   GET flags it.  Every rebuilt part file must equal the one it replaces;
   then each object is read with 4 other disks offline, so the healed
   shards carry the read.  K6 and K1 without the pack leg must launch,
   and K4 must not.
5. Every mode against every other: on fresh disks, under ``pipeline``,
   ``off`` and ``async`` in turn and then in reverse order, PUT one
   64 MiB object and the 10 MiB + 17 B one, GET both with 4 disks offline, delete 4 shards of each and
   heal_object them.  Part files must be byte-identical to the main
   path's, and xl.meta equal up to its mod time, data dir and version id
   (fresh for every PUT); each mode's own kernels must launch and
   ``async`` must count overlap windows both ways.
6. MINIO_TPU_CODEC_FORMULATION=mxu beside swar, on fresh disks: swar
   and mxu under ``pipeline``, mxu and swar under ``off``, then in
   reverse order, the same two objects PUT, read with 4 disks offline
   and healed.  Part files must equal the main path's; under mxu the
   ``[mxu]`` kernels must launch and the swar PUT and heal-read kernels
   must not, while heal's re-encode stays on swar K1.
7. The S3 front: the port's S3Server (threaded plane, unset
   MINIO_TPU_SERVER) over a fresh ErasureObjects on the card (12 disks,
   EC 8+4, 10 MiB blocks), driven through SigV4 over HTTP by this
   script's own signer (``S3Signer``, on minio_tpu_torch.server.auth):
   bucket create and policy (a bucket document, erasure-coded in
   ``.sys``), a 1 KiB object read back anonymously under the policy, the
   10 MiB + 17 B object (its part files must equal the main path's), 4
   clients PUTting two 64 MiB objects each at once (one aws-chunked),
   every object read back by 4 clients healthy and again with the disks
   of shards 1, 3, 10 and 12 offline, a ranged GET across a block
   boundary, HEAD of each, ListObjectsV2 paged by 3, then DELETE of
   each, a 404 and the bucket's delete.  K5, K2 and K3 must launch and
   K1 must not; at least one batcher flush must merge jobs of more than
   one client.  Prints the ``s3:`` line.
8. Multipart and copies, on a fresh S3Server and disks of the same
   deployment: 4 clients upload a 64 MiB object each as 8 x 8 MiB parts
   at once, then the 10 MiB + 17 B object goes up as 5 MiB, 5 MiB and
   17 B parts; ListParts, and each CompleteMultipartUpload alone (no
   launch; the object's shard files are the staged ``part.N`` files,
   hashed per disk; the ETag is md5 of the part md5s, "-N"); one 8 MiB
   part against a single PUT of it by erasure index; an upload listed
   by ListMultipartUploads, aborted, gone from every disk; GETs by 4
   clients healthy and with shards 1, 3, 10, 12 offline, and a ranged
   GET across a part boundary; an UploadPartCopy upload from two
   ranges plus a part, a 64 MiB CopyObject and a REPLACE self-copy;
   heal of a multipart object's deleted part files on 4 disks (K6, K1
   without the pack leg), read through the healed shards;
   ListObjectVersions paged by one, a POST-policy upload and a quiet
   multi-delete after which every GET answers 404.  K5 (with merged
   jobs) covers every part, K3 runs on the degraded GETs, K2 and K5 on
   the copies.  Prints the ``s3_mp:`` line.
9. Prints the kernels JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the result lines, when there is no CUDA device or
when any phase fails.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The integer XOR/shift/multiply/permute work of these kernels runs on
# the integer pipe: 64 lanes per SM per clock, half the float32 lanes.
# Set in main() from the card: SMs x 64 x the SM clock's maximum.
INT_LANES_PER_SM = 64
INT_OPS_PER_S = 132 * INT_LANES_PER_SM * 1.98e9
# int8 tensor cores, dense (H100 SXM data sheet).  The mxu product's bit
# pairs are held to it: the data sheet gives no rate for the 1-bit MMA the
# kernels issue, so this is an assumption (a faster b1 rate would lower
# the bound).
TC_INT8_OPS_PER_S = 1979e12

K, M, N = 8, 4, 12
BLOCK = 10 * 1024 * 1024
W = BLOCK // K // 4  # 327,680 words per shard
OBJECT_SIZES = [64 << 20] * 4 + [BLOCK + 17]
SEED = 20261016


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fn, reps: int = 20) -> dict:
    """Three times of a wrapper call beside cuda_ms's back-to-back events
    (which measure the host when it enqueues slower than the device runs):

    * ``device_ms``: ``reps`` calls captured in one CUDA graph and
      replayed, per call (device time only, the zeroing memsets included;
      a capture the wrapper does not allow fails the run);
    * ``host_us``: the host's time per call (time.perf_counter around it,
      no synchronisation; median of 100);
    * ``cold_ms``: one call replayed from a graph right after 512 MiB were
      written, so the 50 MB L2 holds none of its input (median of 9)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, one = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    with torch.cuda.graph(one):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / reps)
    host = []
    for i in range(100):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    cold = []
    for _ in range(9):
        flush.fill_(1)
        e0.record()
        one.replay()
        e1.record()
        torch.cuda.synchronize()
        cold.append(e0.elapsed_time(e1))
    return {"device_ms": statistics.median(runs),
            "host_us": statistics.median(host) * 1e6,
            "cold_ms": statistics.median(cold)}


def bound(nbytes: float, ops: float, mma_ops: float = 0.0) -> "tuple[float, str]":
    """(ms, what binds): the larger of the bytes over the memory rate and
    the operations over their pipes' rates (integer ops, plus MMA ops at
    the int8 tensor-core rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S + mma_ops / TC_INT8_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def int_rate() -> dict:
    """The integer pipe's rate on this card: SMs x 64 lanes x the maximum
    SM clock that nvidia-smi reports."""
    import torch

    global INT_OPS_PER_S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    INT_OPS_PER_S = sms * INT_LANES_PER_SM * mhz * 1e6
    return {"sms": sms, "sm_clock_max_mhz": mhz, "int_ops_per_s": INT_OPS_PER_S,
            "tc_int8_ops_per_s": TC_INT8_OPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S}


# Operation counts per element, as integer-pipe instructions (one a lane
# a cycle): LOP3 takes any logic of three inputs, so XORing v values
# together takes ceil((v - 1) / 2); IMAD is a multiply and an add.
# mix32 is 3 shifts, 3 xors and 2 multiplies (8); the key is an IMAD and
# a mix32, plus key * kM2 once a column (10); one hashed word is
# LOP3 + IMAD for (w ^ key) * kM1 and one IMAD for w * kM2 + key * kM2,
# then a mix32 each whose last LOP3 also folds into h1 / h2 (19); one
# xtime, ((x & 0x7F7F7F7F) << 1) ^ (sign-spread bytes of x & 0x1D1D1D1D),
# is a LOP3, a shift, a PRMT and a LOP3 (4).
_MIX, _KEY, _HASH, _XTIME = 8, 10, 19, 4


def _xors(v: int) -> int:
    """LOP3s that XOR v values into one."""
    return max(v - 1, 0) // 2 + max(v - 1, 0) % 2


def product_rows(matrix):
    """The rows of a GF product that take operations: a unit row (one
    coefficient, 1) copies its input, whose bytes the bound counts."""
    import numpy as np

    m = np.asarray(matrix)
    unit = (np.count_nonzero(m, axis=1) == 1) & (m.max(axis=1, initial=0) == 1)
    return m[~unit]


def gf_ops(matrix) -> int:
    """Instructions of one column of a GF product as the function needs
    them: none for the rows that are copies (``product_rows``); for the
    others the cheaper of two forms.  Horner's form per output row: from
    its top coefficient bit down, an xtime then the XOR of that bit's
    terms (ceil(c / 2) LOP3s), the top bit's terms XORed together.  A
    chain per input: an xtime per bit below its top one, then per output
    row the XOR of its terms."""
    import numpy as np

    m = np.asarray(product_rows(matrix), dtype=np.int64)
    if m.size == 0:
        return 0
    bits = (m[..., None] >> np.arange(8)) & 1  # (rows, inputs, bit)
    horner = 0
    for row in bits:
        per_bit = row.sum(axis=0)  # terms at each bit
        set_bits = np.flatnonzero(per_bit)
        if set_bits.size == 0:
            continue
        top = int(set_bits[-1])
        horner += _xors(int(per_bit[top]))
        horner += sum(_XTIME + -(-int(per_bit[b]) // 2) for b in range(top))
    tops = [int(np.flatnonzero(col.any(axis=0))[-1]) for col in bits.transpose(1, 0, 2)
            if col.any()]
    chain = _XTIME * sum(tops) + sum(_xors(int(row.sum())) for row in bits)
    return min(horner, chain)


def mxu_ops(o: int, s: int) -> int:
    """MMA ops of one word column (4 byte columns) of the mxu product of an
    (o, s) matrix: the (8o x 8s) bit pairs that matter, counted as
    multiply + add, with no padding of the tile."""
    return 2 * (8 * o) * (8 * s) * 4


# The design's own integer work (csrc/codec.cu mxu_tile) per 8 byte
# columns, per lane of a warp: 3 byte permutes build its B word, and per
# m-tile (2 output rows) 19 ops turn its 4 accumulators into the output
# word (4 ands, 4 shifts, 3 ors, 3 shuffles, 3 ors, a shift and an or, the
# store's predicate).  Printed beside the bound, never part of it: the
# function does not need them.
_PERM, _REPACK = 3, 19


def mxu_design_ops(o: int, s: int) -> int:
    """The mxu_tile lanes' permutes and repack per word column."""
    return 32 * (_PERM + _REPACK * -(-o // 2)) // 2


# K5 [mxu]'s product (csrc/codec.cu mxu_ring_tile) repacks two m-tiles
# at once: per n-tile and pair of m-tiles, 6 shift-adds gather the 8
# accumulators into two words of bytes, 4 ops (two masks, a multiply-add,
# the multiply by 1 << q) place their bits, 2 shuffles and 2 adds join the
# 4 lanes of a byte, 1 shuffle and 2 permutes the half words of both
# rows, and 2 for the stores' predicates.
_RING_REPACK = 19


def mxu_ring_design_ops(o: int, s: int) -> int:
    """The mxu_ring_tile lanes' permutes and repack per word column; none
    without output rows (K4 [mxu] runs no product then)."""
    if o == 0:
        return 0
    mtiles = -(-o // 2)
    return 32 * (_PERM + _RING_REPACK * -(-mtiles // 2)) // 2


def mxu_bound(nbytes: float, int_ops: float, mma_ops: float,
              swar: "tuple[float, str]") -> "tuple[float, str]":
    """Bound of an mxu kernel: the bytes, or the integer ops the function
    needs besides its product (hash, flags) plus the product's bit pairs
    at the tensor-core rate - never above the swar twin's bound for the
    same function."""
    return min(bound(nbytes, int_ops, mma_ops), swar)


def rand_words(rng, shape, device):
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def max_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def same(got, *wants) -> int:
    """max_abs_err of the tuple ``got`` against each of ``wants``, at
    least 1 where any tensor differs."""
    import torch

    e = max(max_err(a, b) for want in wants for a, b in zip(got, want))
    if e or not all(torch.equal(a, b) for want in wants
                    for a, b in zip(got, want)):
        return max(e, 1)
    return 0


# heal's loss (shards 1, 3 of data and 10, 12 of parity) and the other
# survivor patterns the heal kernels are checked over
LOST = (0, 2, 9, 11)
PATTERNS = {
    "data+parity missing": tuple(i not in LOST for i in range(N)),
    "parity missing": tuple(i < K for i in range(N)),
    "all present": (True,) * N,
}


def survivor_patterns(n: int, m: int):
    """Every present mask of n rows with 0 .. m rows absent."""
    import itertools

    for lost in range(m + 1):
        for gone in itertools.combinations(range(n), lost):
            yield tuple(i not in gone for i in range(n))


def vr_pattern_sweep(dev, rng, formulation: str) -> int:
    """K6 (of ``formulation``) against its plain version and K4 (the same
    formulation) for every EC 8+4 survivor pattern with 0-4 rows absent,
    three of EC 12+4 and every one of EC 4+2, at w = 4,104 and B = 1, 2;
    returns the max_abs_err (0)."""
    import torch

    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4104
    # every EC 8+4 pattern, then the other row buckets: EC 12+4 (16 rows
    # staged, the widest ring) and EC 4+2
    sets = [(K, N, list(survivor_patterns(N, M)))]
    sets.append((12, 16, [(True,) * 16, tuple(i != 0 for i in range(16)),
                          tuple(i not in (0, 5, 13, 15) for i in range(16))]))
    sets.append((4, 6, list(survivor_patterns(6, 2))))
    for k, n, patterns in sets:
        for B in (1, 2):
            x = rand_words(rng, (B, n, w), dev)
            for pres in patterns:
                got = kernels.verify_reconstruct_pipelined(x, pres, k, 4 * w, formulation)
                k4 = kernels.verify_reconstruct(x, pres, k, 4 * w, formulation)
                want = kernels.verify_reconstruct_pipelined_plain(x, pres, k, 4 * w)
                e = same(got, want, k4)
                if e:
                    fail(f"verify_reconstruct_pipelined ({formulation}) differs from "
                         f"its plain version or K4 at k={k}, B={B}, present={pres}")
                err = max(err, e)
    return err


# K4 [mxu] and K6 [mxu] off EC 8+4's buckets: (k, n, absent rows) with 1 to
# 8 rebuilt rows (the 8-row bucket of the product from 5 on), 4 tile slots,
# k = 1 and k = 12
VR_MXU_GEOMETRIES = [(8, 16, (0, 1, 2, 3, 4)), (8, 16, tuple(range(8))),
                     (5, 10, (0, 2, 4)), (2, 4, (0,)), (1, 2, (0,)),
                     (12, 16, (1, 2, 3, 4))]


def vr_mxu_sweep(dev, rng, fn) -> int:
    """K4 [mxu] or K6 [mxu] (``fn``: verify_reconstruct or
    verify_reconstruct_pipelined) against its plain version, K4 swar and
    (K6) K4 [mxu] at every geometry of VR_MXU_GEOMETRIES, at w = 4,104 and
    B = 1, 2, and (K4, whose staging loads take it) on a view off 16-byte
    alignment (4-byte loads); returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4104
    k4 = fn is kernels.verify_reconstruct
    for k, n, gone in VR_MXU_GEOMETRIES:
        pres = tuple(i not in gone for i in range(n))
        xs = [rand_words(rng, (1, n, w), dev), rand_words(rng, (2, n, w), dev)]
        if k4:
            xs.append(rand_words(rng, (2 * n * w + 1,), dev)[1:].view(2, n, w))
        for x in xs:
            got = fn(x, pres, k, 4 * w, "mxu")
            wants = [kernels.verify_reconstruct_plain(x, pres, k, 4 * w, "mxu"),
                     kernels.verify_reconstruct(x, pres, k, 4 * w)]
            if not k4:
                wants.append(kernels.verify_reconstruct(x, pres, k, 4 * w, "mxu"))
            e = same(got, *wants)
            if e:
                fail(f"{fn.__name__}[mxu] differs from its plain version, K4 or K4 [mxu] "
                     f"at k={k}, n={n}, absent {gone}, B={x.shape[0]}, "
                     f"offset {x.storage_offset()}")
            err = max(err, e)
    return err


# one (k, m) in each (k, m) row bucket K1's entry takes (the masked
# Horner form), m = 0, EC 8+4 (the fixed product), EC 12+4 and 4+2
K1_GEOMETRIES = [(3, 2), (4, 6), (2, 12), (6, 3), (8, 8), (5, 11), (13, 3),
                 (10, 6), (16, 16), (4, 0), (8, 4), (12, 4), (4, 2)]


def encode_geometry_sweep(dev, rng) -> int:
    """K1 and K1 [mxu] at every geometry of K1_GEOMETRIES, with and without
    the pack leg, against its plain version and (m >= 1) K5 and K5 [mxu];
    returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4096
    for k, m in K1_GEOMETRIES:
        x = rand_words(rng, (2, k, w), dev)
        x[1, :, 256:1024] = 0  # zero groups for the pack leg
        for group in ((0, 256) if m else (0,)):
            got = kernels.encode_pack(x, m, 4 * w, group)
            wants = [kernels.encode_pack_plain(x, m, 4 * w, group)]
            if m:
                wants.append(kernels.encode_pack_pipelined(x, m, 4 * w, group))
                wants.append(kernels.encode_pack_pipelined(x, m, 4 * w, group, "mxu"))
            e = max(same(got, *wants),
                    same(kernels.encode_pack(x, m, 4 * w, group, "mxu"), *wants))
            if e:
                fail(f"encode_pack or encode_pack[mxu] differs from its plain version, "
                     f"K5 or K5 [mxu] at k={k}, m={m}, group={group}")
            err = max(err, e)
    return err


def gf_cases(rng):
    """K3's matrices: every EC 8+4 survivor pattern with 0-4 rows absent
    and every EC 4+2 one (the reconstruction matrix over the first k
    present rows), then non-square and edge ones: one output row, 16
    outputs over 16 inputs, input rows picked out of order, an output row
    that repeats another's unit row, a zero row.  Yields (label, matrix,
    rows, R)."""
    import numpy as np

    from minio_tpu_torch.ops import gf

    for k, m in ((K, M), (4, 2)):
        for pres in survivor_patterns(k + m, m):
            idx = tuple(i for i, p in enumerate(pres) if p)[:k]
            yield f"EC {k}+{m} {pres}", gf.reconstruction_matrix(k, m, idx), idx, k + m
    pm = gf.parity_matrix(K, M)
    yield "o=1", pm[:1], tuple(range(K)), N
    yield "o=16, s=16", gf.parity_matrix(16, 16), tuple(range(16)), 16
    yield "rows out of order", pm, (11, 3, 0, 7, 5, 9, 1, 4), N
    dup = np.zeros((5, 3), dtype=np.uint8)
    dup[0, 1] = dup[2, 1] = dup[3, 0] = 1  # rows 0 and 2 copy input 1
    dup[1] = rng.integers(1, 256, 3)  # row 4 stays zero
    yield "repeated unit row, zero row", dup, (2, 0, 1), 3


def gf_pattern_sweep(dev, rng) -> int:
    """K3 against its plain version for every matrix of gf_cases at w =
    4,104 and B = 1, 2, and at a width off the 4-word quad and on a view
    off 16-byte alignment (4-byte loads); returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels, rs

    err = 0
    for label, mat, rows, R in gf_cases(rng):
        for B, w in ((1, 4104), (2, 4104), (2, 4101)):
            x = rand_words(rng, (B, R, w), dev)
            got = kernels.gf_matmul_words(mat, x, rows)
            e = same((got,), (rs.gf_matmul_words(mat, x, rows),))
            if e:
                fail(f"gf_matmul_words differs from its plain version at {label}, B={B}, w={w}")
            err = max(err, e)
        x = rand_words(rng, (2 * R * 4104 + 1,), dev)[1:].view(2, R, 4104)
        got = kernels.gf_matmul_words(mat, x, rows)
        e = same((got,), (rs.gf_matmul_words(mat, x, rows),))
        if e:
            fail(f"gf_matmul_words differs from its plain version on an unaligned view at {label}")
        err = max(err, e)
    return err


def check_kernels(dev, rng) -> dict:
    """Phase 2: each kernel against its plain version, then timings."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, hash as phash, kernels, rs

    results = {}
    pm = gf.parity_matrix(K, M)
    # --- K1 encode_pack -------------------------------------------------
    err = 0
    # main-path shards; the 4 MiB tail block of a 64 MiB object
    # (131,072 words); the 17-byte tail of the 10 MiB + 17 object (8
    # words, no pack leg); a ragged width off the 256-word tile
    shapes = [(1, W, 256), (4, W, 256), (8, W, 256), (2, 131072, 256),
              (1, 8, 0), (2, 4104, 0)]
    for B, w, group in shapes:
        x = rand_words(rng, (B, K, w), dev)
        x[0, :, : min(w, 64)] = -1  # 0xFFFFFFFF words
        if w >= 4096:
            x[-1, :, 256:2048] = 0  # zero groups for the pack leg
        got = kernels.encode_pack(x, M, 4 * w, group)
        torch.cuda.synchronize()
        want = kernels.encode_pack_plain(x, M, 4 * w, group)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"encode_pack differs from its plain version at {B, w, group}")
        err = max(err, e)
    # the repo's numpy references on a small input
    x = rand_words(rng, (1, K, 1024), dev)
    par, dig, _f, _p = kernels.encode_pack(x, M, 4096, 256)
    xn = x.cpu().numpy().view(np.uint32)[0]
    ref_par = gf.encode_ref(xn.view(np.uint8).reshape(K, -1), M)
    if not np.array_equal(par.cpu().numpy().view(np.uint8)[0].reshape(M, -1), ref_par):
        fail("encode_pack parity differs from gf.encode_ref")
    allw = np.concatenate([xn, ref_par.view(np.uint32).reshape(M, -1)])
    if not np.array_equal(
        dig.cpu().numpy().view(np.uint32)[0],
        phash.phash256_host_batched(allw, 4096),
    ):
        fail("encode_pack digests differ from phash256_host_batched")
    err = max(err, encode_geometry_sweep(dev, rng))
    B = 4
    x = rand_words(rng, (B, K, W), dev)
    ms = cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, 256), 20)
    plain_ms = cuda_ms(lambda: kernels.encode_pack_plain(x, M, 4 * W, 256), 3, 1)
    g = W // 256
    nbytes = 4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8)
    ops = B * W * (_KEY + N * _HASH + gf_ops(pm) + M)
    bms, by = bound(nbytes, ops)
    results["encode_pack"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[B, K, W],
        **device_times(lambda: kernels.encode_pack(x, M, 4 * W, 256)),
    )
    # one stripe of one tile without the pack leg: the launch's fixed chain
    # (memset, launch, fold, atomics, ticket, finalize)
    x = rand_words(rng, (1, K, 256), dev)
    results["encode_pack"]["one_tile"] = device_times(
        lambda: kernels.encode_pack(x, M, 1024, 0))

    # --- K2 phash256_batched ---------------------------------------------
    err = 0
    # the main path's shapes, then row counts off the 4-row group and
    # widths off the 1,024-word tile (and a view off 16-byte alignment)
    cases = [(32, W), (8, W), (3, 8), (12, 4104), (16, 131072)] + [
        (R, w) for R in (1, 3, 33) for w in (4, 8, 4104, 131076)
    ]
    for R, w in cases:
        x = rand_words(rng, (R, w), dev)
        got = kernels.phash256_batched(x, 4 * w)
        torch.cuda.synchronize()
        want = phash.phash256_words_batched(x, 4 * w)
        e = max_err(got, want)
        if e or not torch.equal(got, want):
            fail(f"phash256_batched differs from its plain version at {R, w}")
        err = max(err, e)
    x = rand_words(rng, (3 * 4104 + 1,), dev)[1:].view(3, 4104)  # 4-byte aligned
    got = kernels.phash256_batched(x, 4 * 4104)
    e = same((got,), (phash.phash256_words_batched(x, 4 * 4104),))
    if e:
        fail("phash256_batched differs from its plain version on an unaligned view")
    x = rand_words(rng, (5, 1000), dev)
    if not np.array_equal(
        kernels.phash256_batched(x, 4000).cpu().numpy().view(np.uint32),
        phash.phash256_host_batched(x.cpu().numpy().view(np.uint32), 4000),
    ):
        fail("phash256_batched differs from phash256_host_batched")
    R = 4 * K  # a healthy GET verifies k shards of 4 blocks per batch
    x = rand_words(rng, (R, W), dev)
    ms = cuda_ms(lambda: kernels.phash256_batched(x, 4 * W), 20)
    plain_ms = cuda_ms(lambda: phash.phash256_words_batched(x, 4 * W), 3, 1)
    # the key depends only on the column: the function needs it once per
    # column, not once per row (W * _KEY + R * W * _HASH)
    bms, by = bound(4 * (R * W + R * 8), W * _KEY + R * W * _HASH)
    results["phash256_batched"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[R, W],
        **device_times(lambda: kernels.phash256_batched(x, 4 * W)),
    )
    # one row of 4 words: the launch's fixed chain
    x = rand_words(rng, (1, 4), dev)
    results["phash256_batched"]["one_quad"] = device_times(
        lambda: kernels.phash256_batched(x, 16))

    # --- K3 gf_matmul_words ---------------------------------------------
    present = tuple(i not in (0, 2, 9, 11) for i in range(N))
    rows = tuple(i for i, p in enumerate(present) if p)[:K]
    rm = gf.reconstruction_matrix(K, M, rows)
    err = 0
    for B, w in [(1, W), (4, W), (8, W), (1, 8), (2, 4104), (2, 131072)]:
        x = rand_words(rng, (B, N, w), dev)
        got = kernels.gf_matmul_words(rm, x, rows)
        torch.cuda.synchronize()
        want = rs.gf_matmul_words(rm, x, rows)
        e = max_err(got, want)
        if e or not torch.equal(got, want):
            fail(f"gf_matmul_words differs from its plain version at {B, w}")
        err = max(err, e)
    # reconstruct really inverts the encode: rebuild the data rows
    data = rand_words(rng, (2, K, 4104), dev)
    par = kernels.encode_pack(data, M, 4 * 4104, 0)[0]
    full = torch.cat([data, par], dim=1).contiguous()
    if not torch.equal(kernels.gf_matmul_words(rm, full, rows), data):
        fail("gf_matmul_words does not rebuild the data rows")
    err = max(err, gf_pattern_sweep(dev, rng))
    B = 4
    x = rand_words(rng, (B, N, W), dev)
    ms = cuda_ms(lambda: kernels.gf_matmul_words(rm, x, rows), 20)
    plain_ms = cuda_ms(lambda: rs.gf_matmul_words(rm, x, rows), 3, 1)
    bms, by = bound(4 * (B * K * W + B * K * W), B * W * gf_ops(rm))
    results["gf_matmul_words"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[B, N, W],
        **device_times(lambda: kernels.gf_matmul_words(rm, x, rows)),
    )
    x = rand_words(rng, (1, N, 256), dev)
    results["gf_matmul_words"]["one_tile"] = device_times(
        lambda: kernels.gf_matmul_words(rm, x, rows))
    return results


def check_heal_kernels(dev, rng) -> dict:
    """Phase 2, heal: verify_reconstruct (K4) and encode_pack without
    the pack leg (the P2 function) against their plain versions, then
    timings at heal's shapes."""
    import numpy as np
    import torch

    from minio_tpu_torch.codec.backend import TorchBackend
    from minio_tpu_torch.ops import codec_step, gf, hash as phash, kernels

    results = {}
    # --- K4 verify_reconstruct ------------------------------------------
    err = 0
    for B, w in [(1, W), (4, W), (1, 131072), (1, 8), (2, 4104)]:
        x = rand_words(rng, (B, N, w), dev)
        host = x.cpu().numpy().view(np.uint32)
        for pname, pres in PATTERNS.items():
            got = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            want = kernels.verify_reconstruct_plain(x, pres, K, 4 * w)
            e = max(max_err(a, b) for a, b in zip(got, want))
            if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"verify_reconstruct differs from its plain version at {B, w}, {pname}")
            err = max(err, e)
            rows = tuple(i for i, p in enumerate(pres) if p)[:K]
            rm = gf.reconstruction_matrix(K, M, rows)
            if not torch.equal(got[0], kernels.gf_matmul_words(rm, x, rows)):
                fail(f"verify_reconstruct data differs from gf_matmul_words at {B, w}, {pname}")
            live = [i for i, p in enumerate(pres) if p]
            if not np.array_equal(
                got[1].cpu().numpy().view(np.uint32)[:, live],
                phash.phash256_host_batched(host[:, live], 4 * w),
            ):
                fail(f"verify_reconstruct digests differ from phash256_host_batched at {B, w}, {pname}")
    # the staging's 4-byte loads: a view off 16-byte alignment
    x = rand_words(rng, (2 * N * 4104 + 1,), dev)[1:].view(2, N, 4104)
    for pname, pres in PATTERNS.items():
        e = same(kernels.verify_reconstruct(x, pres, K, 4 * 4104),
                 kernels.verify_reconstruct_plain(x, pres, K, 4 * 4104))
        if e:
            fail(f"verify_reconstruct differs from its plain version on an unaligned view, {pname}")
        err = max(err, e)
    # it rebuilds what encode_pack encoded (absent rows hold garbage);
    # with all rows present and a chosen survivor bitrotted, ok flags it
    # and the backend's escalation still returns the data
    be = TorchBackend(dev)
    for B, w in [(1, W), (2, 4104)]:
        data = rand_words(rng, (B, K, w), dev)
        par, dig, _f, _p = kernels.encode_pack(data, M, 4 * w, 0)
        full = torch.cat([data, par], dim=1)
        pres = PATTERNS["data+parity missing"]
        damaged = full.clone()
        damaged[:, list(LOST)] = rand_words(rng, (B, len(LOST), w), dev)
        got, ok = codec_step.verify_and_reconstruct_words(
            damaged, dig, pres, K, M, 4 * w
        )
        want_ok = torch.tensor(pres, device=dev).expand(B, N)
        if not torch.equal(got, data) or not torch.equal(ok, want_ok):
            fail(f"verify_reconstruct does not rebuild encoded data at {B, w}")
        pres = PATTERNS["all present"]
        full[B - 1, 4, w // 3] ^= 1 << 20  # row 4 is a chosen survivor
        _d, ok = codec_step.verify_and_reconstruct_words(
            full, dig, pres, K, M, 4 * w
        )
        if bool(ok[B - 1, 4]) or int(ok.sum()) != B * N - 1:
            fail(f"verify_reconstruct does not flag the bitrotted survivor at {B, w}")
        out, _ok = be.reconstruct_and_verify(
            full.cpu().numpy().view(np.uint8), dig.cpu().numpy().view(np.uint32),
            pres, K, M,
        )
        if not np.array_equal(out, data.cpu().numpy().view(np.uint8)):
            fail(f"reconstruct_and_verify escalation returned wrong data at {B, w}")
    timings = {}
    for pname, B in [("data+parity missing", 1), ("data+parity missing", 4),
                     ("all present", 1)]:
        pres = PATTERNS[pname]
        x = rand_words(rng, (B, N, W), dev)
        rows = tuple(i for i, p in enumerate(pres) if p)[:K]
        live = sum(pres)
        ms = cuda_ms(lambda: kernels.verify_reconstruct(x, pres, K, 4 * W), 20)
        plain_ms = cuda_ms(
            lambda: kernels.verify_reconstruct_plain(x, pres, K, 4 * W), 3, 1
        )
        nbytes = 4 * (B * live * W + B * K * W + B * N * 8)
        ops = B * W * (
            _KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))
        )
        bms, by = bound(nbytes, ops)
        timings[f"{pname}, B={B}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            shape=[B, N, W], present=live,
        )
        if (pname, B) == ("data+parity missing", 1):
            timings[f"{pname}, B={B}"].update(device_times(
                lambda: kernels.verify_reconstruct(x, pres, K, 4 * W)))
    main = timings["data+parity missing, B=1"]
    results["verify_reconstruct"] = dict(max_abs_err=err, **main, timings=timings)

    # --- K1 without the pack leg: the P2 function -------------------------
    err = 0
    for B, w in [(1, W), (1, 131072), (1, 8), (2, 4104)]:
        x = rand_words(rng, (B, K, w), dev)
        got = kernels.encode_pack(x, M, 4 * w, 0)
        torch.cuda.synchronize()
        want = kernels.encode_pack_plain(x, M, 4 * w, 0)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"encode_pack(group=0) differs from its plain version at {B, w}")
        err = max(err, e)
    x = rand_words(rng, (1, K, W), dev)
    ms = cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, 0), 20)
    plain_ms = cuda_ms(lambda: kernels.encode_pack_plain(x, M, 4 * W, 0), 3, 1)
    bms, by = bound(
        4 * (K * W + M * W + N * 8),
        W * (_KEY + N * _HASH + gf_ops(gf.parity_matrix(K, M)) + M),
    )
    results["encode_pack[group=0]"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[1, K, W],
        **device_times(lambda: kernels.encode_pack(x, M, 4 * W, 0)),
    )
    return results


def _chain(fn, x, acc_rows: int, cw: int, *args):
    """Run a sub-chunk form over x's last axis in chunks of cw words at
    their offsets; returns (concatenated first outputs, accumulator)."""
    import torch

    B, _r, w = x.shape
    acc = torch.zeros((B, acc_rows, 8), dtype=torch.int32, device=x.device)
    offs = list(range(0, w, cw))
    outs = []
    for i, off in enumerate(offs):
        chunk = x[:, :, off:off + cw].contiguous()
        outs.append(fn(chunk, acc, off, *args, i == len(offs) - 1)[0])
    return torch.cat(outs, dim=-1), acc


def check_overlap_kernels(dev, rng) -> dict:
    """Phase 2, overlap: K5 and K6 against their plain versions and
    against K1 and K4; the sub-chunk forms of K1 and K4 chained over S
    chunks against the whole-row pass and their plain chains; timings."""
    import torch

    from minio_tpu_torch.ops import gf, kernels

    results = {}

    # --- K5 encode_pack_pipelined ----------------------------------------
    err = 0
    for B, w, group in [(4, W, 256), (1, W, 0), (1, W, 256), (2, 131072, 256),
                        (2, 4104, 0), (1, 8, 0)]:
        x = rand_words(rng, (B, K, w), dev)
        x[0, :, : min(w, 64)] = -1
        if w >= 4096:
            x[-1, :, 256:2048] = 0  # zero groups for the pack leg
        got = kernels.encode_pack_pipelined(x, M, 4 * w, group)
        k1 = kernels.encode_pack(x, M, 4 * w, group)
        torch.cuda.synchronize()
        e = same(got, kernels.encode_pack_pipelined_plain(x, M, 4 * w, group), k1)
        if e:
            fail(f"encode_pack_pipelined differs from its plain version or K1 at {B, w, group}")
        err = max(err, e)
    pm = gf.parity_matrix(K, M)
    timings = {}
    for B, group in [(4, 256), (1, 0)]:
        x = rand_words(rng, (B, K, W), dev)
        g = W // 256 if group else 0
        nbytes = 4 * (B * K * W + (2 if group else 1) * B * M * W + B * M * g + B * N * 8)
        bms, by = bound(nbytes, B * W * (_KEY + N * _HASH + gf_ops(pm) + M))
        timings[f"B={B}, group={group}"] = dict(
            ms=cuda_ms(lambda: kernels.encode_pack_pipelined(x, M, 4 * W, group), 20),
            k1_ms=cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, group), 20),
            plain_ms=cuda_ms(lambda: kernels.encode_pack_pipelined_plain(x, M, 4 * W, group), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, K, W],
        )
        if (B, group) == (4, 256):
            timings[f"B={B}, group={group}"].update(device_times(
                lambda: kernels.encode_pack_pipelined(x, M, 4 * W, group)))
    results["encode_pack_pipelined"] = dict(
        max_abs_err=err, **timings["B=4, group=256"], timings=timings
    )

    # --- K6 verify_reconstruct_pipelined ------------------------------------
    err = 0
    for B, w in [(1, W), (4, W), (1, 131072), (2, 4104), (1, 8)]:
        x = rand_words(rng, (B, N, w), dev)
        for pname, pres in PATTERNS.items():
            got = kernels.verify_reconstruct_pipelined(x, pres, K, 4 * w)
            k4 = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            e = same(got, kernels.verify_reconstruct_pipelined_plain(x, pres, K, 4 * w), k4)
            if e:
                fail(f"verify_reconstruct_pipelined differs from its plain version or K4 at {B, w}, {pname}")
            err = max(err, e)
    err = max(err, vr_pattern_sweep(dev, rng, "swar"))
    timings = {}
    for pname, B in [("data+parity missing", 1), ("data+parity missing", 4),
                     ("all present", 1)]:
        pres = PATTERNS[pname]
        x = rand_words(rng, (B, N, W), dev)
        rows = tuple(i for i, p in enumerate(pres) if p)[:K]
        live = sum(pres)
        bms, by = bound(
            4 * (B * live * W + B * K * W + B * N * 8),
            B * W * (_KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))),
        )
        timings[f"{pname}, B={B}"] = dict(
            ms=cuda_ms(lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 4 * W), 20),
            k4_ms=cuda_ms(lambda: kernels.verify_reconstruct(x, pres, K, 4 * W), 20),
            plain_ms=cuda_ms(lambda: kernels.verify_reconstruct_pipelined_plain(x, pres, K, 4 * W), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, N, W], present=live,
            **device_times(lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 4 * W)),
        )
    # one block of one tile: the launch's fixed chain (memset, staging,
    # fold, atomics, ticket, finalize) with next to no columns
    x = rand_words(rng, (1, N, 4), dev)
    pres = PATTERNS["data+parity missing"]
    timings["data+parity missing, B=1, w=4"] = device_times(
        lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 16))
    results["verify_reconstruct_pipelined"] = dict(
        max_abs_err=err, **timings["data+parity missing, B=1"], timings=timings
    )

    # --- the sub-chunk forms of K1 and K4 -----------------------------------
    CW = 65536  # 256 KiB of shard bytes, the default MINIO_TPU_CODEC_SUBCHUNK_KB
    err = 0
    for B, w, cw, group in [(4, W, CW, 256), (1, W, CW - 768, 256),
                            (2, 4104, 1000, 0)]:
        x = rand_words(rng, (B, K, w), dev)
        if w >= 4096:
            x[-1, :, 256:2048] = 0
        par, acc = _chain(kernels.encode_pack_subchunk, x, N, cw, M, 4 * w, group)
        whole = kernels.encode_pack(x, M, 4 * w, 0)
        torch.cuda.synchronize()
        plain = _chain(kernels.encode_pack_subchunk_plain, x, N, cw, M, 4 * w, group)
        e = same((par, acc), whole[:2], plain)
        if e:
            fail(f"encode_pack_subchunk chain differs from the whole row or its plain chain at {B, w, cw}")
        err = max(err, e)
    B = 4
    x = rand_words(rng, (B, K, W), dev)
    chunks = [(o, x[:, :, o:o + CW].contiguous()) for o in range(0, W, CW)]

    def enc_chain(fn):
        acc = torch.zeros((B, N, 8), dtype=torch.int32, device=dev)
        for i, (o, c) in enumerate(chunks):
            fn(c, acc, o, M, 4 * W, 256, i == len(chunks) - 1)

    g = W // 256
    bms, by = bound(
        4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8),
        B * W * (_KEY + N * _HASH + gf_ops(pm) + M),
    )
    results["encode_pack[subchunk]"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: enc_chain(kernels.encode_pack_subchunk), 20),
        plain_ms=cuda_ms(lambda: enc_chain(kernels.encode_pack_subchunk_plain), 3, 1),
        bound_ms=bms, bound_by=by, shape=[B, K, W], chunks=len(chunks),
        **device_times(lambda: enc_chain(kernels.encode_pack_subchunk)),
    )
    err = 0
    for B, w, cw in [(1, W, CW), (4, W, CW), (1, W, CW - 768), (2, 4104, 1000)]:
        x = rand_words(rng, (B, N, w), dev)
        for pname, pres in PATTERNS.items():
            data, acc = _chain(kernels.verify_reconstruct_subchunk, x, N, cw, pres, K, 4 * w)
            whole = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            plain = _chain(kernels.verify_reconstruct_subchunk_plain, x, N, cw, pres, K, 4 * w)
            e = same((data, acc), whole, plain)
            if e:
                fail(f"verify_reconstruct_subchunk chain differs from the whole row or its plain chain at {B, w, cw}, {pname}")
            err = max(err, e)
    B = 1
    pres = PATTERNS["data+parity missing"]
    x = rand_words(rng, (B, N, W), dev)
    chunks = [(o, x[:, :, o:o + CW].contiguous()) for o in range(0, W, CW)]

    def vr_chain(fn):
        acc = torch.zeros((B, N, 8), dtype=torch.int32, device=dev)
        for i, (o, c) in enumerate(chunks):
            fn(c, acc, o, pres, K, 4 * W, i == len(chunks) - 1)

    rows = tuple(i for i, p in enumerate(pres) if p)[:K]
    live = sum(pres)
    bms, by = bound(
        4 * (B * live * W + B * K * W + B * N * 8),
        B * W * (_KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))),
    )
    results["verify_reconstruct[subchunk]"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: vr_chain(kernels.verify_reconstruct_subchunk), 20),
        plain_ms=cuda_ms(lambda: vr_chain(kernels.verify_reconstruct_subchunk_plain), 3, 1),
        bound_ms=bms, bound_by=by, shape=[B, N, W], present=live, chunks=len(chunks),
        **device_times(lambda: vr_chain(kernels.verify_reconstruct_subchunk)),
    )
    return results


def check_mxu_kernels(dev, rng) -> dict:
    """Phase 2, mxu: K7 gf_matmul_mxu and the mxu instantiations of K1,
    K4, K5 and K6 against their plain versions (rs.mxu_rows) and their
    swar twins (K3 for K7), then timings beside the twins'."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, kernels, rs

    results = {}

    # --- K7 gf_matmul_mxu -------------------------------------------------
    pm = gf.parity_matrix(K, M)
    rows = tuple(i for i, p in enumerate(PATTERNS["data+parity missing"]) if p)[:K]
    rm = gf.reconstruction_matrix(K, M, rows)
    L = BLOCK // K  # one shard of a 10 MiB block: 10 MiB over the 8 rows
    err = 0
    for mat, length in [(pm, L), (rm, L), (pm, 8192 + 17), (rm, 4104 * 4 + 3),
                        (gf.parity_matrix(16, 16), 4096), (pm[:1, :1], 5)]:
        o, s_ = mat.shape
        sh = torch.from_numpy(rng.integers(0, 256, (s_, length), dtype=np.uint8)).to(dev)
        got = kernels.gf_matmul_mxu(mat, sh)
        torch.cuda.synchronize()
        e = same((got,), (rs.gf_matmul_mxu_plain(mat, sh),))
        if length % 4 == 0:  # the swar twin: K3 on the same bytes as words
            words = sh.view(torch.int32)[None]
            twin = kernels.gf_matmul_words(mat, words, tuple(range(s_)))
            e = max(e, same((got,), (twin[0].contiguous().view(torch.uint8),)))
        if e:
            fail(f"gf_matmul_mxu differs from its plain version or K3 at {o, s_, length}")
        err = max(err, e)
    x = torch.from_numpy(rng.integers(0, 256, (8, 64), dtype=np.uint8)).to(dev)
    if not np.array_equal(kernels.gf_matmul_mxu(pm, x).cpu().numpy(),
                          gf.encode_ref(x.cpu().numpy(), M)):
        fail("gf_matmul_mxu differs from gf.encode_ref")
    sh = torch.from_numpy(rng.integers(0, 256, (K, L), dtype=np.uint8)).to(dev)
    words = sh.view(torch.int32)[None]
    bms, by = mxu_bound((K + M) * L, 0, L // 4 * mxu_ops(M, K),
                        bound((K + M) * L, L // 4 * gf_ops(pm)))
    results["gf_matmul_mxu"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: kernels.gf_matmul_mxu(pm, sh), 20),
        swar_ms=cuda_ms(lambda: kernels.gf_matmul_words(pm, words, tuple(range(K))), 20),
        plain_ms=cuda_ms(lambda: rs.gf_matmul_mxu_plain(pm, sh), 3, 1),
        bound_ms=bms, bound_by=by, shape=[M, K, L],
        design_int_ops=L // 4 * mxu_design_ops(M, K),
        **device_times(lambda: kernels.gf_matmul_mxu(pm, sh)),
    )

    # --- K1 and K5 [mxu] ----------------------------------------------------
    for name, fn, plain in [
        ("encode_pack", kernels.encode_pack, kernels.encode_pack_plain),
        ("encode_pack_pipelined", kernels.encode_pack_pipelined,
         kernels.encode_pack_pipelined_plain),
    ]:
        err = 0
        for B, w, group in [(4, W, 256), (1, W, 0), (2, 131072, 256),
                            (2, 4104, 0), (1, 8, 0)]:
            x = rand_words(rng, (B, K, w), dev)
            x[0, :, : min(w, 64)] = -1
            if w >= 4096:
                x[-1, :, 256:2048] = 0  # zero groups for the pack leg
            got = fn(x, M, 4 * w, group, formulation="mxu")
            twin = fn(x, M, 4 * w, group)
            torch.cuda.synchronize()
            wants = [plain(x, M, 4 * w, group, "mxu"), twin]
            if name == "encode_pack_pipelined":
                wants.append(kernels.encode_pack(x, M, 4 * w, group))  # K1
            e = same(got, *wants)
            if e:
                fail(f"{name}[mxu] differs from its plain version, swar twin or K1 "
                     f"at {B, w, group}")
            err = max(err, e)
        if name == "encode_pack":
            # K1 [mxu] off its 16-byte staging loads: a view off 16-byte
            # alignment
            x = rand_words(rng, (2 * K * 4104 + 1,), dev)[1:].view(2, K, 4104)
            e = same(fn(x, M, 4 * 4104, 0, formulation="mxu"),
                     plain(x, M, 4 * 4104, 0, "mxu"), fn(x, M, 4 * 4104, 0))
            if e:
                fail("encode_pack[mxu] differs from its plain version or swar twin "
                     "on an unaligned view")
            err = max(err, e)
        B = 4
        x = rand_words(rng, (B, K, W), dev)
        g = W // 256
        nbytes = 4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8)
        hash_ops = B * W * (_KEY + N * _HASH + M)
        bms, by = mxu_bound(nbytes, hash_ops, B * W * mxu_ops(M, K),
                            bound(nbytes, hash_ops + B * W * gf_ops(pm)))
        results[f"{name}[mxu]"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(x, M, 4 * W, 256, formulation="mxu"), 20),
            swar_ms=cuda_ms(lambda: fn(x, M, 4 * W, 256), 20),
            plain_ms=cuda_ms(lambda: plain(x, M, 4 * W, 256, "mxu"), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, K, W],
            # K5 [mxu] has its own product (mxu_ring_tile)
            # K1 and K5 [mxu] run mxu_ring_tile
            design_int_ops=B * W * mxu_ring_design_ops(M, K),
            **device_times(lambda: fn(x, M, 4 * W, 256, formulation="mxu")),
        )

    # --- K4 and K6 [mxu] ----------------------------------------------------
    for name, fn, plain in [
        ("verify_reconstruct", kernels.verify_reconstruct,
         kernels.verify_reconstruct_plain),
        ("verify_reconstruct_pipelined", kernels.verify_reconstruct_pipelined,
         kernels.verify_reconstruct_pipelined_plain),
    ]:
        err = 0
        for B, w in [(1, W), (4, W), (2, 4104), (1, 8)]:
            x = rand_words(rng, (B, N, w), dev)
            for pname, pres in PATTERNS.items():
                got = fn(x, pres, K, 4 * w, formulation="mxu")
                twin = fn(x, pres, K, 4 * w)
                torch.cuda.synchronize()
                e = same(got, plain(x, pres, K, 4 * w, "mxu"), twin)
                if e:
                    fail(f"{name}[mxu] differs from its plain version or swar twin at {B, w}, {pname}")
                err = max(err, e)
        if name == "verify_reconstruct_pipelined":
            err = max(err, vr_pattern_sweep(dev, rng, "mxu"))
        err = max(err, vr_mxu_sweep(dev, rng, fn))
        timings = {}
        for pname, B in [("data+parity missing", 1), ("data+parity missing", 4)]:
            pres = PATTERNS[pname]
            x = rand_words(rng, (B, N, W), dev)
            rows = tuple(i for i, p in enumerate(pres) if p)[:K]
            live = sum(pres)
            nbytes = 4 * (B * live * W + B * K * W + B * N * 8)
            hash_ops = B * W * (_KEY + live * _HASH)
            rm = gf.reconstruction_matrix(K, M, rows)
            # the product the function needs: the rebuilt rows only
            rb = len(product_rows(rm))
            mma = B * W * mxu_ops(rb, K)
            bms, by = mxu_bound(nbytes, hash_ops, mma,
                                bound(nbytes, hash_ops + B * W * gf_ops(rm)))
            timings[f"{pname}, B={B}"] = dict(
                ms=cuda_ms(lambda: fn(x, pres, K, 4 * W, formulation="mxu"), 20),
                swar_ms=cuda_ms(lambda: fn(x, pres, K, 4 * W), 20),
                plain_ms=cuda_ms(lambda: plain(x, pres, K, 4 * W, "mxu"), 3, 1),
                bound_ms=bms, bound_by=by, shape=[B, N, W], present=live,
                # K4 and K6 [mxu] multiply the rebuilt rows in mxu_ring_tile
                design_int_ops=B * W * mxu_ring_design_ops(rb, K),
            )
            if B == 1:
                timings[f"{pname}, B={B}"].update(device_times(
                    lambda: fn(x, pres, K, 4 * W, formulation="mxu")))
        results[f"{name}[mxu]"] = dict(
            max_abs_err=err, **timings["data+parity missing, B=1"], timings=timings
        )
    return results


def transfer_ms(dev) -> dict:
    """Host<->device copies of one main-path batch: 4 blocks of data in,
    4 parity planes out, from pageable memory as the serialized paths
    copy and from pinned memory as the async chain's staging does."""
    import numpy as np
    import torch

    host = np.random.default_rng(SEED).integers(
        0, 1 << 31, (4, K, W), dtype=np.int32
    )
    t = torch.from_numpy(host)
    out = {}
    out["h2d_ms"] = cuda_ms(lambda: t.to(dev), 5, 1)
    pinned = t.pin_memory()  # the async chain's staging is pinned
    out["h2d_pinned_ms"] = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5, 1)
    out["h2d_bytes"] = host.nbytes
    par = torch.zeros((4, M, W), dtype=torch.int32, device=dev)
    out["d2h_ms"] = cuda_ms(lambda: par.cpu(), 5, 1)
    back = torch.empty(par.shape, dtype=torch.int32, pin_memory=True)
    out["d2h_pinned_ms"] = cuda_ms(lambda: back.copy_(par, non_blocking=True), 5, 1)
    out["d2h_bytes"] = par.numel() * 4
    return out


def part_path(root: str, bucket: str, name: str) -> str:
    from minio_tpu_torch.storage.xl import XLStorage

    fi = XLStorage(root).read_version(bucket, name)
    return os.path.join(root, bucket, name, fi.data_dir, "part.1")


def part_files(root: str, bucket: str, name: str) -> "bytes | None":
    try:
        path = part_path(root, bucket, name)
    except Exception:  # noqa: BLE001 - disk lacks the object
        return None
    with open(path, "rb") as f:
        return f.read()


def object_files(roots: list, name: str) -> list:
    """Per disk: (part.1 bytes, xl.meta without its mod time, data dir
    and version id), or None where the disk lacks the object."""
    from minio_tpu_torch.storage.meta import XLMeta

    out = []
    for r in roots:
        part = part_files(r, "bench", name)
        if part is None:
            out.append(None)
            continue
        with open(os.path.join(r, "bench", name, "xl.meta"), "rb") as f:
            docs = [v.to_dict() for v in XLMeta.from_bytes(f.read()).versions]
        for d in docs:
            for volatile in ("mod_time_ns", "data_dir", "version_id"):
                d.pop(volatile)
        out.append((part, docs))
    return out


def main_path(dev, work: str) -> dict:
    """Phase 3: PUT, healthy GET and degraded GET through the object
    layer under the default overlap mode, with the kernel launch
    counters read around the run."""
    import numpy as np

    from minio_tpu_torch.codec.backend import get_backend
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.ops.codec_step import codec_overlap_mode
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    rng = np.random.default_rng(SEED)
    sizes = OBJECT_SIZES
    payloads = [rng.bytes(s) for s in sizes]
    roots = [os.path.join(work, f"disk{i}") for i in range(N)]
    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK,
        device=dev,
    )
    ol.make_bucket("bench")
    mode = codec_overlap_mode(get_backend(dev).device)
    if mode != "pipeline":
        fail(f"the default overlap mode on the card is {mode}, not pipeline")

    kernels.reset_launches()
    KERNEL_STATS.reset()
    t_put = t_get = t_deg = 0.0
    put_each, get_each = [], []
    for i, data in enumerate(payloads):
        t0 = time.monotonic()
        ol.put_object("bench", f"obj{i}", io.BytesIO(data), len(data))
        put_each.append(time.monotonic() - t0)
        t_put += put_each[-1]
    for i, data in enumerate(payloads):
        sink = io.BytesIO()
        t0 = time.monotonic()
        ol.get_object("bench", f"obj{i}", sink)
        get_each.append(time.monotonic() - t0)
        t_get += get_each[-1]
        if sink.getvalue() != data:
            fail(f"healthy GET of obj{i} differs from its source")
    # what every mode must write (phase 5), taken before heal damages it
    written = {name: object_files(roots, name) for name in MODE_OBJECTS}
    for i, data in enumerate(payloads):
        dist = XLStorage(roots[0]).read_version("bench", f"obj{i}").erasure.distribution
        # offline: the disks holding shards 1 and 3 (data) and 10, 12
        dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
        degraded = from_reference_disks(
            [None if d in dead else r for d, r in enumerate(roots)],
            parity_blocks=M, block_size=BLOCK, device=dev,
        )
        sink = io.BytesIO()
        t0 = time.monotonic()
        info = degraded.get_object("bench", f"obj{i}", sink)
        t_deg += time.monotonic() - t0
        if sink.getvalue() != data:
            fail(f"degraded GET of obj{i} differs from its source")
        if info.user_defined.get("x-internal-heal-required") != "true":
            fail(f"degraded GET of obj{i} did not flag heal")
    launches = dict(kernels.LAUNCHES)
    stats = KERNEL_STATS.snapshot()
    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the main path")
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail("K1 with the pack leg launched on the main path under pipeline")
    if stats["overlap_windows"]["put"] <= 0:
        fail("the main path's PUT counted no pipelined overlap windows")

    # the same port on the CPU writes the same shard files
    cpu_roots = [os.path.join(work, f"cpu{i}") for i in range(N)]
    cpu_ol = ErasureObjects(
        [XLStorage(r) for r in cpu_roots], parity_blocks=M, block_size=BLOCK,
        device="cpu",
    )
    cpu_ol.make_bucket("bench")
    cpu_ol.put_object("bench", "obj4", io.BytesIO(payloads[4]), sizes[4])
    for r_dev, r_cpu in zip(roots, cpu_roots):
        a = part_files(r_dev, "bench", "obj4")
        if a is None or a != part_files(r_cpu, "bench", "obj4"):
            fail("obj4 part files differ between device=cuda and device=cpu")

    total = sum(sizes)
    return payloads, written, {
        "overlap_mode": mode,
        "objects": len(sizes),
        "bytes": total,
        "put_s": t_put,
        "get_s": t_get,
        "get_degraded_s": t_deg,
        "put_each_s": put_each,
        "get_each_s": get_each,
        "put_MBps": total / t_put / 1e6,
        "get_MBps": total / t_get / 1e6,
        "get_degraded_MBps": total / t_deg / 1e6,
        "launches": launches,
        "device_passes": stats["device_passes"],
        "hedge": stats["hedge"],
        "h2d": stats["h2d"],
        "d2h": stats["d2h"],
        "overlap_windows": stats["overlap_windows"],
        "stages": stats["stages"],
    }


def heal_phase(dev, work: str, payloads: list) -> dict:
    """Phase 4: heal the main path's 5 objects on its 12 disks, with the
    kernel launch counters read around the phase."""
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.heal.background import HealQueue, HealRoutine
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"disk{i}") for i in range(N)]
    names = [f"obj{i}" for i in range(len(payloads))]
    dists, lost, saved = {}, {}, {}
    for i, name in enumerate(names):
        dists[name] = XLStorage(roots[0]).read_version("bench", name).erasure.distribution
        # shards (1-based) to rebuild: 1, 3, 10, 12 deleted; on the last
        # object shard 2 bitrotted and 5, 9, 11 deleted
        lost[name] = (1, 3, 10, 12) if i < len(names) - 1 else (2, 5, 9, 11)
        for d in range(N):
            if dists[name][d] in lost[name]:
                with open(part_path(roots[d], "bench", name), "rb") as f:
                    saved[(name, d)] = f.read()
    for name in names:
        for d in range(N):
            shard = dists[name][d]
            if shard not in lost[name]:
                continue
            if shard == 2:
                with open(part_path(roots[d], "bench", name), "r+b") as f:
                    f.seek(32 + 1000)  # block 0 payload
                    byte = f.read(1)
                    f.seek(32 + 1000)
                    f.write(bytes([byte[0] ^ 0x5A]))
            else:
                shutil.rmtree(os.path.join(roots[d], "bench", name))

    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK,
        device=dev,
    )
    kernels.reset_launches()
    KERNEL_STATS.reset()
    t0 = time.monotonic()
    for name in names[:-1]:
        res = ol.heal_object("bench", name)
        want = sorted(s - 1 for s in lost[name])
        if res["outdated"] != want or res["healed"] != want:
            fail(f"heal_object({name}) healed {res['healed']}, want {want}")
    t_heal = time.monotonic() - t0
    # the last object through MRF: a GET flags it, the routine heals it
    queue = HealQueue()
    ol.heal_hook = queue.push_object
    routine = HealRoutine(ol, queue).start()
    try:
        sink = io.BytesIO()
        t0 = time.monotonic()
        info = ol.get_object("bench", names[-1], sink)
        if sink.getvalue() != payloads[-1]:
            fail(f"GET of damaged {names[-1]} differs from its source")
        if info.user_defined.get("x-internal-heal-required") != "true":
            fail(f"GET of damaged {names[-1]} did not flag heal")
        if not routine.drain(timeout_s=300):
            fail("the heal routine did not drain within 300 s")
        t_mrf = time.monotonic() - t0
        if (routine.healed, routine.failed) != (1, 0):
            fail(f"heal routine healed {routine.healed}, failed {routine.failed}")
    finally:
        if not routine.stop():
            fail("the heal routine did not stop")
    heal_stats = KERNEL_STATS.snapshot()
    # seconds per disk API over the phase, from the metered disks' ledgers
    disk_api_s: dict = {}
    for d in ol.disks:
        for api, row in d.api_stats().items():
            disk_api_s[api] = disk_api_s.get(api, 0.0) + row["seconds"]
    for name in names:
        for d in range(N):
            shard = dists[name][d]
            if shard not in lost[name]:
                continue
            with open(part_path(roots[d], "bench", name), "rb") as f:
                if f.read() != saved[(name, d)]:
                    fail(f"healed part.1 of {name} on disk {d} differs")
            if XLStorage(roots[d]).read_version("bench", name).erasure.index != shard:
                fail(f"healed xl.meta of {name} on disk {d} has a wrong index")
    # read each object with 4 disks offline that were not healed: the
    # healed shards carry the read
    for name, data in zip(names, payloads):
        offline = [d for d in range(N) if dists[name][d] not in lost[name]][:4]
        degraded = from_reference_disks(
            [None if d in offline else r for d, r in enumerate(roots)],
            parity_blocks=M, block_size=BLOCK, device=dev,
        )
        sink = io.BytesIO()
        degraded.get_object("bench", name, sink)
        if sink.getvalue() != data:
            fail(f"GET of {name} through its healed shards differs from its source")
    launches = dict(kernels.LAUNCHES)
    for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the heal path")
    # under pipeline, K1 runs only as heal's re-encode (the overlap knob
    # leaves encode alone) and escalation re-solves through K3, not K4
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail("K1 with the pack leg launched on the heal path under pipeline")
    if launches["verify_reconstruct"]:
        fail("K4 launched on the heal path under pipeline")
    if heal_stats["overlap_windows"]["get"] <= 0:
        fail("heal counted no pipelined overlap windows")
    healed_bytes = sum(len(p) for p in payloads[:-1])
    return {
        "objects": len(names),
        "heal_object_s": t_heal,
        "heal_object_bytes": healed_bytes,
        "heal_object_MBps": healed_bytes / t_heal / 1e6,
        "mrf_get_and_heal_s": t_mrf,
        "mrf_bytes": len(payloads[-1]),
        "launches": launches,
        "device_passes": heal_stats["device_passes"],
        "h2d": heal_stats["h2d"],
        "d2h": heal_stats["d2h"],
        "overlap_windows": heal_stats["overlap_windows"],
        "stages": heal_stats["stages"],
        "disk_api_s": disk_api_s,
    }


# phases 5 and 6: one 64 MiB object and the 10 MiB + 17 B one, under an
# overlap mode and a formulation per run; the kernels each run must
# launch, and those it must not
MODE_OBJECTS = ("obj0", "obj4")
_MXU_NAMES = ("encode_pack[mxu]", "verify_reconstruct[mxu]",
              "encode_pack_pipelined[mxu]", "verify_reconstruct_pipelined[mxu]")
RUN_KERNELS = {
    ("swar", "pipeline"): (
        ("encode_pack_pipelined", "verify_reconstruct_pipelined"),
        ("verify_reconstruct", "encode_pack[subchunk]",
         "verify_reconstruct[subchunk]", *_MXU_NAMES)),
    ("swar", "off"): (
        ("encode_pack", "verify_reconstruct"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "encode_pack[subchunk]", "verify_reconstruct[subchunk]", *_MXU_NAMES)),
    ("swar", "async"): (
        ("encode_pack[subchunk]", "verify_reconstruct[subchunk]"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined", *_MXU_NAMES)),
    # under mxu only the PUT pass and heal's read pass change kernels:
    # heal's re-encode stays swar K1 without the pack leg, the degraded
    # GET K3
    ("mxu", "pipeline"): (
        ("encode_pack_pipelined[mxu]", "verify_reconstruct_pipelined[mxu]",
         "encode_pack[group=0]", "gf_matmul_words"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "verify_reconstruct", "encode_pack[mxu]", "verify_reconstruct[mxu]",
         "encode_pack[subchunk]", "verify_reconstruct[subchunk]")),
    ("mxu", "off"): (
        ("encode_pack[mxu]", "verify_reconstruct[mxu]", "encode_pack[group=0]",
         "gf_matmul_words"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "verify_reconstruct", "encode_pack_pipelined[mxu]",
         "verify_reconstruct_pipelined[mxu]", "encode_pack[subchunk]",
         "verify_reconstruct[subchunk]")),
}
# phase 5: every overlap mode; phase 6: each formulation beside the other
# under the same mode
MODE_RUNS = [("swar", "pipeline"), ("swar", "off"), ("swar", "async")]
MXU_RUNS = [("swar", "pipeline"), ("mxu", "pipeline"), ("mxu", "off"),
            ("swar", "off")]


def modes_phase(dev, work: str, payloads: list, written: dict,
                runs: list) -> dict:
    """Phases 5 and 6: PUT, GET with 4 disks offline and heal_object of
    the MODE_OBJECTS on fresh disks for each (formulation, overlap mode)
    of ``runs``; part files and xl.meta against the main path's, launch
    counters per run."""
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    data = {f"obj{i}": p for i, p in enumerate(payloads)}
    out: dict = {run: [] for run in runs}
    try:
        # each run twice, in turns (ABC then CBA), so host-clock drift
        # over the phase does not favour one run
        for formulation, mode in [*runs, *reversed(runs)]:
            os.environ["MINIO_TPU_CODEC_FORMULATION"] = formulation
            os.environ["MINIO_TPU_CODEC_OVERLAP"] = mode
            roots = [os.path.join(work, f"{formulation}-{mode}{i}") for i in range(N)]
            ol = ErasureObjects(
                [XLStorage(r) for r in roots], parity_blocks=M,
                block_size=BLOCK, device=dev,
            )
            ol.make_bucket("bench")
            kernels.reset_launches()
            KERNEL_STATS.reset()
            t0 = time.monotonic()
            for name in MODE_OBJECTS:
                ol.put_object("bench", name, io.BytesIO(data[name]), len(data[name]))
            t_put = time.monotonic() - t0
            for name in MODE_OBJECTS:
                if object_files(roots, name) != written[name]:
                    fail(f"{formulation} {mode}: {name} part files or xl.meta differ from the main path's")
            t_get = 0.0
            for name in MODE_OBJECTS:
                dist = XLStorage(roots[0]).read_version("bench", name).erasure.distribution
                dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
                degraded = from_reference_disks(
                    [None if d in dead else r for d, r in enumerate(roots)],
                    parity_blocks=M, block_size=BLOCK, device=dev,
                )
                sink = io.BytesIO()
                t0 = time.monotonic()
                degraded.get_object("bench", name, sink)
                t_get += time.monotonic() - t0
                if sink.getvalue() != data[name]:
                    fail(f"{formulation} {mode}: degraded GET of {name} differs from its source")
                for d in dead:
                    shutil.rmtree(os.path.join(roots[d], "bench", name))
            t0 = time.monotonic()
            for name in MODE_OBJECTS:
                res = ol.heal_object("bench", name)
                if res["healed"] != [0, 2, 9, 11]:
                    fail(f"{formulation} {mode}: heal_object({name}) healed {res['healed']}")
            t_heal = time.monotonic() - t0
            for name in MODE_OBJECTS:
                if object_files(roots, name) != written[name]:
                    fail(f"{formulation} {mode}: healed {name} differs from the main path's")
            launches = dict(kernels.LAUNCHES)
            stats = KERNEL_STATS.snapshot()
            must, must_not = RUN_KERNELS[(formulation, mode)]
            label = f"{formulation} {mode}"
            for name in must:
                if launches[name] <= 0:
                    fail(f"{label}: kernel {name} never launched")
            for name in must_not:
                if launches[name]:
                    fail(f"{label}: kernel {name} launched")
            if (mode == "pipeline" or formulation == "mxu") and (
                launches["encode_pack"] != launches["encode_pack[group=0]"]
            ):
                fail(f"{label}: swar K1 with the pack leg launched")
            windows = stats["overlap_windows"]
            if mode != "off" and min(windows.values()) <= 0:
                fail(f"{label}: overlap windows {windows}")
            if mode == "off" and any(windows.values()):
                fail(f"{label}: overlap windows {windows}")
            nbytes = sum(len(data[n]) for n in MODE_OBJECTS)
            out[(formulation, mode)].append({
                "bytes": nbytes, "put_s": t_put, "get_degraded_s": t_get,
                "heal_s": t_heal, "launches": launches,
                "device_passes": stats["device_passes"],
                "overlap_windows": windows, "h2d": stats["h2d"],
                "d2h": stats["d2h"],
            })
            for r in roots:
                shutil.rmtree(r, ignore_errors=True)
    finally:
        os.environ.pop("MINIO_TPU_CODEC_OVERLAP", None)
        os.environ.pop("MINIO_TPU_CODEC_FORMULATION", None)
    return out


# -- phase 7: the S3 front -------------------------------------------------

S3_CLIENTS = 4
S3_BIG = 64 << 20
S3_POLICY = (
    b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
    b'"Principal":{"AWS":["*"]},"Action":["s3:GetObject"],'
    b'"Resource":["arn:aws:s3:::bench/public/*"]}]}'
)


class S3Signer:
    """A small SigV4 client over http.client, signing with the port's
    own server/auth.py: one keep-alive connection per instance."""

    def __init__(self, host: str, port: int, access_key="minioadmin",
                 secret_key="minioadmin", region="us-east-1"):
        import http.client

        self.host, self.port = host, port
        self.ak, self.sk, self.region = access_key, secret_key, region
        self.conn = http.client.HTTPConnection(host, port, timeout=600)

    def _now(self) -> str:
        import datetime

        return datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")

    def _sign(self, method, path, query, headers, payload_hash):
        from minio_tpu_torch.server import auth

        amz_date = headers["x-amz-date"]
        signed = sorted(headers)
        qmap = {k: [v] for k, v in (query or {}).items()}
        sig = auth.sign_v4(method, path, qmap, headers, signed, payload_hash,
                           self.ak, self.sk, amz_date, self.region)
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["authorization"] = (
            f"{auth.SIGN_V4_ALGORITHM} Credential={self.ak}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return sig

    def _send(self, method, path, query, headers, body):
        import urllib.parse

        qs = urllib.parse.urlencode(query or {})
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        self.conn.request(method, url, body=body or None, headers=headers)
        r = self.conn.getresponse()
        data = r.read()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def request(self, method, path, query=None, body=b"", headers=None,
                unsigned_payload=False, anonymous=False, payload_hash=None):
        """(status, headers, body); the payload is signed by its sha256
        (``payload_hash`` when the caller computed it) unless
        ``unsigned_payload`` (x-amz-content-sha256: UNSIGNED-PAYLOAD)."""
        import hashlib

        from minio_tpu_torch.server import auth

        headers = {k.lower(): v for k, v in (headers or {}).items()}
        headers["host"] = f"{self.host}:{self.port}"
        if not anonymous:
            phash = (auth.UNSIGNED_PAYLOAD if unsigned_payload
                     else payload_hash or hashlib.sha256(body).hexdigest())
            headers["x-amz-date"] = self._now()
            headers["x-amz-content-sha256"] = phash
            self._sign(method, path, query, headers, phash)
        return self._send(method, path, query, headers, body)

    def put_chunked(self, path, data: bytes, chunk: int = 1 << 20):
        """PUT with STREAMING-AWS4-HMAC-SHA256-PAYLOAD framing: every
        chunk signed, chained from the seed signature."""
        import hashlib
        import hmac

        from minio_tpu_torch.server import auth

        headers = {
            "host": f"{self.host}:{self.port}",
            "x-amz-date": self._now(),
            "x-amz-content-sha256": auth.STREAMING_PAYLOAD,
            "x-amz-decoded-content-length": str(len(data)),
            "content-encoding": "aws-chunked",
        }
        prev = self._sign("PUT", path, None, headers, auth.STREAMING_PAYLOAD)
        amz_date = headers["x-amz-date"]
        key = auth._signing_key(self.sk, amz_date[:8], self.region, "s3")
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        body = bytearray()
        pieces = [data[i:i + chunk] for i in range(0, len(data), chunk)]
        for c in [*pieces, b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope,
                             prev, auth.EMPTY_SHA256,
                             hashlib.sha256(c).hexdigest()])
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            body += f"{len(c):x};chunk-signature={prev}\r\n".encode()
            if c:
                body += c + b"\r\n"
        body += b"\r\n"
        return self._send("PUT", path, None, headers, bytes(body))

    def close(self) -> None:
        self.conn.close()


def _in_clients(host, port, jobs_per_client, fn) -> "tuple[float, list]":
    """Run ``fn(signer, job)`` for each client's jobs, S3_CLIENTS clients
    at once on their own connections; (wall seconds, results)."""
    import threading

    results: list = [None] * len(jobs_per_client)
    errors: list = []
    start = threading.Barrier(len(jobs_per_client) + 1)

    def run(ix):
        signer = S3Signer(host, port)
        try:
            start.wait()
            results[ix] = [fn(signer, job) for job in jobs_per_client[ix]]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            signer.close()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs_per_client))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        fail(f"S3 phase: a client failed: {errors[0]!r}")
    return wall, [r for rs in results for r in rs]


def s3_phase(dev, work: str, payloads: list, written: dict, mp: dict) -> dict:
    """Phase 7: the main path through the S3 front.  The port's S3Server
    (threaded plane) over a fresh ErasureObjects on the card (12 disks,
    EC 8+4, 10 MiB blocks), driven by 4 concurrent SigV4 clients."""
    import hashlib
    import xml.etree.ElementTree as ET

    import numpy as np

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"s3disk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"S3 phase: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 7)
    big = {f"c{c}/big{j}": rng.bytes(S3_BIG)
           for c in range(S3_CLIENTS) for j in range(2)}
    small = {"public/small": rng.bytes(1024)}
    objects = {**small, "obj4": payloads[4], **big}
    sha = {k: hashlib.sha256(v).digest() for k, v in objects.items()}

    # bucket documents: every read that finds one is an erasure GET on
    # the card; count them (this script's own instrumentation)
    bms = srv.bucket_meta
    doc = {"loads": 0, "found": 0}
    load = bms._load

    def counted_load(bucket):
        bm = load(bucket)
        doc["loads"] += 1
        doc["found"] += bool(bm.created_ns)
        return bm

    bms._load = counted_load
    one = S3Signer(host, port)
    out: dict = {}
    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        st, _h, body = one.request("PUT", "/bench")
        if st != 200:
            fail(f"S3 phase: bucket create {st} {body[:200]!r}")
        before = dict(kernels.LAUNCHES)
        st, _h, body = one.request("PUT", "/bench", {"policy": ""}, S3_POLICY)
        if st != 204:
            fail(f"S3 phase: bucket policy {st} {body[:200]!r}")
        doc_write = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
        # one bucket-document read on a quiet card: its launches
        bms.invalidate("bench")
        before = dict(kernels.LAUNCHES)
        if bms.get("bench").policy() is None:
            fail("S3 phase: the bucket policy did not read back")
        doc_read = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        doc["loads"] = doc["found"] = 0

        st, _h, body = one.request("PUT", "/bench/public/small",
                                   body=small["public/small"])
        if st != 200:
            fail(f"S3 phase: PUT public/small {st} {body[:200]!r}")
        # the 10 MiB + 17 B object alone: PUT signed by its sha256 (the
        # server verifies it) and again UNSIGNED-PAYLOAD, each read back
        single = {"put_signed_s": [], "put_unsigned_s": [], "get_s": []}
        for unsigned in (False, True):
            t0 = time.monotonic()
            st, _h, body = one.request(
                "PUT", "/bench/obj4", body=objects["obj4"],
                unsigned_payload=unsigned, payload_hash=sha["obj4"].hex())
            single["put_unsigned_s" if unsigned else "put_signed_s"].append(
                time.monotonic() - t0)
            if st != 200:
                fail(f"S3 phase: PUT obj4 {st} {body[:200]!r}")
            t0 = time.monotonic()
            st, _h, got = one.request("GET", "/bench/obj4")
            single["get_s"].append(time.monotonic() - t0)
            if st != 200 or hashlib.sha256(got).digest() != sha["obj4"]:
                fail("S3 phase: single-client GET of obj4 differs from its source")
        st, _h, got = one.request("GET", "/bench/public/small", anonymous=True)
        if st != 200 or got != small["public/small"]:
            fail(f"S3 phase: anonymous GET under the bucket policy: {st}")
        for d, r in enumerate(roots):
            part = part_files(r, "bench", "obj4")
            want = written["obj4"][d]
            if part is None or want is None or part != want[0]:
                fail(f"S3 phase: obj4 part file on disk {d} differs from the main path's")

        # concurrent PUT: each client two 64 MiB objects; client 0's
        # second one aws-chunked, the others UNSIGNED-PAYLOAD
        def put(signer, key):
            if key == "c0/big1":
                st, _h, body = signer.put_chunked(f"/bench/{key}", big[key])
            else:
                st, _h, body = signer.request(
                    "PUT", f"/bench/{key}", body=big[key],
                    unsigned_payload=True)
            if st != 200:
                fail(f"S3 phase: PUT {key}: {st} {body[:200]!r}")
            return key

        jobs = [[f"c{c}/big{j}" for j in range(2)] for c in range(S3_CLIENTS)]
        b0 = KERNEL_STATS.snapshot()["batch"]
        put_wall, _ = _in_clients(host, port, jobs, put)
        b1 = KERNEL_STATS.snapshot()["batch"]

        def get(signer, key):
            st, _h, body = signer.request("GET", f"/bench/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"S3 phase: GET {key}: {st}, body differs from its source")
            return len(body)

        all_keys = sorted(objects)
        get_jobs = [all_keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)]
        get_wall, sizes = _in_clients(host, port, get_jobs, get)
        b2 = KERNEL_STATS.snapshot()["batch"]
        lo = BLOCK - 60
        st, h, got = one.request("GET", "/bench/c1/big0",
                                 headers={"range": f"bytes={lo}-{lo + 200}"})
        if st != 206 or got != big["c1/big0"][lo:lo + 201]:
            fail(f"S3 phase: ranged GET across a block boundary: {st}")
        for key in all_keys:
            st, h, _b = one.request("HEAD", f"/bench/{key}")
            if (st != 200 or int(h["content-length"]) != len(objects[key])
                    or h["etag"] != f'"{hashlib.md5(objects[key]).hexdigest()}"'):
                fail(f"S3 phase: HEAD {key}: {st} {h}")
        listed, token, pages = [], "", 0
        while True:
            q = {"list-type": "2", "max-keys": "3"}
            if token:
                q["continuation-token"] = token
            st, _h, body = one.request("GET", "/bench", q)
            if st != 200:
                fail(f"S3 phase: ListObjectsV2 {st}")
            root = ET.fromstring(body)
            ns = root.tag[: root.tag.index("}") + 1]
            listed += [e.text for e in root.iter(f"{ns}Key")]
            pages += 1
            if root.findtext(f"{ns}IsTruncated") != "true":
                break
            token = root.findtext(f"{ns}NextContinuationToken")
        if listed != all_keys:
            fail(f"S3 phase: ListObjectsV2 paged {listed} != {all_keys}")

        # degraded: the disks of obj4's shards 1, 3, 10 and 12 offline
        dist = XLStorage(roots[0]).read_version("bench", "obj4").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            k3 = kernels.LAUNCHES["gf_matmul_words"]
            deg_wall, _ = _in_clients(host, port, get_jobs, get)
            if kernels.LAUNCHES["gf_matmul_words"] <= k3:
                fail("S3 phase: the degraded GETs reconstructed nothing")
        finally:
            ol.disks[:] = live
        b3 = KERNEL_STATS.snapshot()["batch"]

        for key in all_keys:
            st, _h, body = one.request("DELETE", f"/bench/{key}")
            if st != 204:
                fail(f"S3 phase: DELETE {key}: {st} {body[:200]!r}")
        st, _h, _b = one.request("GET", "/bench/obj4")
        if st != 404:
            fail(f"S3 phase: GET after DELETE answered {st}")
        st, _h, body = one.request("DELETE", "/bench")
        if st != 204:
            fail(f"S3 phase: bucket delete {st} {body[:200]!r}")
        phase_s = time.monotonic() - t_phase
        launches = dict(kernels.LAUNCHES)
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        bms._load = load
        srv.shutdown()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)

    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words"):
        if launches[name] <= 0:
            fail(f"S3 phase: kernel {name} never launched")
    for name in ("encode_pack", "encode_pack[mxu]", "encode_pack_pipelined[mxu]"):
        if launches[name]:
            fail(f"S3 phase: kernel {name} launched")

    def merged(a, b):
        return {k: b[k] - a[k] for k in ("flushes", "jobs", "multi_client_flushes")}

    put_batch, get_batch, deg_batch = merged(b0, b1), merged(b1, b2), merged(b2, b3)
    cross = sum(x["multi_client_flushes"] for x in (put_batch, get_batch, deg_batch))
    if cross <= 0:
        fail("S3 phase: no batcher flush merged jobs of more than one client")
    nbig = sum(len(v) for v in big.values())
    nall = sum(sizes)
    obj4 = len(payloads[4])
    out = {
        "clients": S3_CLIENTS,
        "objects": len(objects),
        "server_mode": "threaded",
        "phase_s": phase_s,
        "put_concurrent": {"bytes": nbig, "s": put_wall,
                           "MBps": nbig / put_wall / 1e6},
        "get_concurrent": {"bytes": nall, "s": get_wall,
                           "MBps": nall / get_wall / 1e6},
        "get_degraded_concurrent": {"bytes": nall, "s": deg_wall,
                                    "MBps": nall / deg_wall / 1e6,
                                    "offline_disks": dead},
        "obj4_single_client": {
            "bytes": obj4, **single,
            **{k[:-2] + "_MBps": [obj4 / t / 1e6 for t in v]
               for k, v in single.items()},
            "main_path_put_s": mp["put_each_s"][4],
            "main_path_get_s": mp["get_each_s"][4],
            "main_path_put_MBps": obj4 / mp["put_each_s"][4] / 1e6,
            "main_path_get_MBps": obj4 / mp["get_each_s"][4] / 1e6,
        },
        "list_pages": pages,
        "launches": {k: v for k, v in launches.items() if v},
        "batch": {"put": put_batch, "get": get_batch, "get_degraded": deg_batch,
                  "jobs_per_flush": {
                      name: (x["jobs"] / x["flushes"] if x["flushes"] else None)
                      for name, x in (("put", put_batch), ("get", get_batch),
                                      ("get_degraded", deg_batch))}},
        "bucket_doc": {
            "write_launches": doc_write,
            "read_launches_each": doc_read,
            "reads_in_phase": doc["found"],
            "loads_in_phase": doc["loads"],
            "read_launches_in_phase": {
                k: v * doc["found"] for k, v in doc_read.items()},
        },
        "stages": stats["stages"],
    }
    return out


# -- phase 8: multipart, copies, versions, multi-delete, POST policy ----------

MP_PART = 8 << 20  # the AWS CLI's multipart chunk
MP_MIN_PART = 5 << 20  # S3's minimum part (the object layer's default)
MP_SHARDS_OFF = (1, 3, 10, 12)


def _mp_etag(parts: list) -> str:
    import hashlib

    md5s = b"".join(hashlib.md5(p).digest() for p in parts)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"


def _xml_text(body: bytes, tag: str) -> list:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(body)
    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    return [e.text or "" for e in root.iter(f"{ns}{tag}")]


def _complete_body(etags: list) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f'<Part><PartNumber>{n}</PartNumber><ETag>"{e}"</ETag></Part>'
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>").encode()


def _post_policy_form(signer, bucket: str, key: str, data: bytes):
    """(body, content type) of a browser form upload whose policy is
    signed with the signer's key (SigV4 POST policy)."""
    import base64
    import datetime
    import hashlib
    import hmac

    from minio_tpu_torch.server import auth

    amz_date = signer._now()
    scope = f"{amz_date[:8]}/{signer.region}/s3/aws4_request"
    credential = f"{signer.ak}/{scope}"
    exp = (datetime.datetime.now(datetime.timezone.utc)
           + datetime.timedelta(seconds=600)).strftime("%Y-%m-%dT%H:%M:%S.000Z")
    policy = base64.b64encode(json.dumps({"expiration": exp, "conditions": [
        {"bucket": bucket}, ["eq", "$key", key],
        {"x-amz-credential": credential}, {"x-amz-date": amz_date},
        {"x-amz-algorithm": auth.SIGN_V4_ALGORITHM},
    ]}).encode()).decode()
    skey = auth._signing_key(signer.sk, amz_date[:8], signer.region, "s3")
    fields = {
        "key": key, "policy": policy,
        "x-amz-algorithm": auth.SIGN_V4_ALGORITHM,
        "x-amz-credential": credential, "x-amz-date": amz_date,
        "x-amz-signature": hmac.new(skey, policy.encode(),
                                    hashlib.sha256).hexdigest(),
    }
    boundary = "----chipsmoke"
    body = bytearray()
    for k, v in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n{v}\r\n').encode()
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="file"; filename="f.bin"\r\n'
             f"Content-Type: application/octet-stream\r\n\r\n").encode()
    body += data + f"\r\n--{boundary}--\r\n".encode()
    return bytes(body), f"multipart/form-data; boundary={boundary}"


def _staged_hashes(roots: list, upload_id: str, nparts: int) -> list:
    """Per disk: the sha256 of each staged ``part.N`` (None if absent)."""
    import hashlib

    out = []
    for r in roots:
        row = []
        for n in range(1, nparts + 1):
            p = os.path.join(r, ".sys", "multipart", upload_id, f"part.{n}")
            try:
                with open(p, "rb") as f:
                    row.append(hashlib.sha256(f.read()).hexdigest())
            except OSError:
                row.append(None)
        out.append(row)
    return out


def _object_hashes(roots: list, bucket: str, key: str) -> list:
    """Per disk: the sha256 of each of the object's ``part.N`` files
    (None where the disk lacks the object)."""
    import hashlib

    from minio_tpu_torch.storage import errors as serrors
    from minio_tpu_torch.storage.xl import XLStorage

    out = []
    for r in roots:
        try:
            fi = XLStorage(r).read_version(bucket, key)
        except serrors.FileNotFound:
            out.append(None)
            continue
        row = []
        for part in fi.parts:
            with open(os.path.join(r, bucket, key, fi.data_dir,
                                   f"part.{part.number}"), "rb") as f:
                row.append(hashlib.sha256(f.read()).hexdigest())
        out.append(row)
    return out


def _by_index(roots: list, bucket: str, key: str, part: int) -> dict:
    """Erasure index -> bytes of the object's ``part.<part>`` on that
    index's disk."""
    from minio_tpu_torch.storage.xl import XLStorage

    out = {}
    for r in roots:
        fi = XLStorage(r).read_version(bucket, key)
        with open(os.path.join(r, bucket, key, fi.data_dir, f"part.{part}"),
                  "rb") as f:
            out[fi.erasure.index] = f.read()
    return out


def s3_mp_phase(dev, work: str, payloads: list) -> dict:
    """Phase 8: multipart uploads, uploads in progress, multipart reads
    (healthy, degraded, ranged across a part boundary), UploadPartCopy,
    CopyObject and the self-copy, heal of a multipart object, then
    ListObjectVersions, a POST-policy upload and a quiet multi-delete -
    through the port's S3Server (threaded plane) over a fresh
    ErasureObjects on the card (12 disks, EC 8+4, 10 MiB blocks), by 4
    SigV4 clients on keep-alive connections."""
    import hashlib
    import xml.etree.ElementTree as ET

    import numpy as np

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"s3mpdisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    if getattr(ol, "min_part_size", MP_MIN_PART) != MP_MIN_PART:
        fail("S3 mp phase: the object layer's minimum part is not 5 MiB")
    srv = S3Server(ol, address="127.0.0.1:0").start()
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 8)
    objs = {f"mp{c}": rng.bytes(S3_BIG) for c in range(S3_CLIENTS)}
    objs["mp-small"] = payloads[4]  # the 10 MiB + 17 B object
    splits = {k: [v[i:i + MP_PART] for i in range(0, len(v), MP_PART)]
              for k, v in objs.items() if k != "mp-small"}
    small = objs["mp-small"]
    splits["mp-small"] = [small[:MP_MIN_PART],
                          small[MP_MIN_PART:2 * MP_MIN_PART],
                          small[2 * MP_MIN_PART:]]
    if [len(p) for p in splits["mp-small"]] != [MP_MIN_PART, MP_MIN_PART, 17]:
        fail("S3 mp phase: the 10 MiB + 17 B object did not split 5/5/17")
    one = S3Signer(host, port)
    out: dict = {}

    def req(method, path, query=None, body=b"", headers=None, want=200,
            what="", **kw):
        st, h, b = one.request(method, path, query, body, headers, **kw)
        if st != want:
            fail(f"S3 mp phase: {what or method + ' ' + path}: {st} {b[:300]!r}")
        return h, b

    def launched() -> dict:
        return dict(kernels.LAUNCHES)

    def delta(a: dict, b: dict) -> dict:
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        req("PUT", "/mpb", what="bucket create")

        # -- 1. multipart upload: 4 clients, 8 x 8 MiB parts each, at once
        uploads: dict = {}

        def upload_parts(signer, key):
            st, _h, b = signer.request("POST", f"/mpb/{key}", {"uploads": ""})
            if st != 200:
                fail(f"S3 mp phase: initiate {key}: {st} {b[:200]!r}")
            uid = _xml_text(b, "UploadId")[0]
            etags = []
            for n, part in enumerate(splits[key], 1):
                st, h, b = signer.request(
                    "PUT", f"/mpb/{key}",
                    {"partNumber": str(n), "uploadId": uid}, part,
                    unsigned_payload=True)
                if st != 200:
                    fail(f"S3 mp phase: part {n} of {key}: {st} {b[:200]!r}")
                etags.append(h["etag"].strip('"'))
            uploads[key] = (uid, etags)
            return key

        l0, b0 = launched(), KERNEL_STATS.snapshot()["batch"]
        put_wall, _ = _in_clients(
            host, port, [[f"mp{c}"] for c in range(S3_CLIENTS)], upload_parts)
        l1, b1 = launched(), KERNEL_STATS.snapshot()["batch"]
        nparts = sum(len(splits[f"mp{c}"]) for c in range(S3_CLIENTS))
        put_launch = delta(l0, l1)
        put_batch = {k: b1[k] - b0[k]
                     for k in ("flushes", "jobs", "multi_client_flushes")}
        # each part is one encode job; a flush that merges jobs of
        # several clients encodes them in one K5 launch
        merged = put_batch["jobs"] - put_batch["flushes"]
        k5 = put_launch.get("encode_pack_pipelined", 0)
        if k5 <= 0 or k5 + merged < nparts:
            fail(f"S3 mp phase: {k5} K5 launches (+{merged} merged jobs) for "
                 f"{nparts} parts")
        for name in ("encode_pack", "encode_pack[mxu]"):
            if put_launch.get(name):
                fail(f"S3 mp phase: kernel {name} launched on the part PUTs")
        # the small object alone: one K5 launch per part
        lsm = launched()
        upload_parts(one, "mp-small")
        small_launch = delta(lsm, launched())
        if small_launch.get("encode_pack_pipelined", 0) < 3:
            fail(f"S3 mp phase: the 3-part upload launched {small_launch}")

        # a disk whose staged part is missing - a write that lost a race
        # with another request's pruning of .sys/tmp (XLStorage, in both
        # packages) - must lack the completed object; the others must
        # hold exactly the staged files
        complete_s, staged, short = {}, {}, {}
        for key in sorted(uploads):
            uid, etags = uploads[key]
            _h, b = req("GET", f"/mpb/{key}", {"uploadId": uid},
                        what=f"ListParts {key}")
            want = [hashlib.md5(p).hexdigest() for p in splits[key]]
            if [e.strip('"') for e in _xml_text(b, "ETag")] != want or etags != want:
                fail(f"S3 mp phase: ListParts of {key} disagrees with the parts")
            staged[key] = _staged_hashes(roots, uid, len(etags))
            lc = launched()
            t0 = time.monotonic()
            _h, b = req("POST", f"/mpb/{key}", {"uploadId": uid},
                        _complete_body(etags), what=f"Complete {key}")
            complete_s[key] = time.monotonic() - t0
            if delta(lc, launched()):
                fail(f"S3 mp phase: CompleteMultipartUpload of {key} launched "
                     f"{delta(lc, launched())}")
            etag = _xml_text(b, "ETag")[0].strip('"')
            if etag != _mp_etag(splits[key]):
                fail(f"S3 mp phase: ETag of {key} {etag} != {_mp_etag(splits[key])}")
            for d, (got, want) in enumerate(zip(
                    _object_hashes(roots, "mpb", key), staged[key])):
                if None in want:
                    short.setdefault(key, []).append(d)
                    if got is not None:
                        fail(f"S3 mp phase: {key} completed on disk {d}, "
                             "which lacks staged parts")
                elif got != want:
                    fail(f"S3 mp phase: {key}'s shard files on disk {d} are "
                         "not the staged ones")
        # the set's own repair for a write that missed disks: heal them
        # before anything reads with disks offline
        lr = launched()
        for key, disks in short.items():
            dist_k = XLStorage(roots[0]).read_version("mpb", key).erasure.distribution
            res = ol.heal_object("mpb", key)
            if sorted(res["healed"]) != sorted(dist_k[d] - 1 for d in disks):
                fail(f"S3 mp phase: repair of {key} healed {res['healed']}")
        repair_launch = delta(lr, launched())
        # one 8 MiB part against a single put_object of the same bytes
        ol.put_object("mpb", "single8", io.BytesIO(splits["mp0"][0]), MP_PART)
        if _by_index(roots, "mpb", "mp0", 1) != _by_index(roots, "mpb",
                                                          "single8", 1):
            fail("S3 mp phase: part 1 of mp0 differs from a single PUT of it")
        ol.delete_object("mpb", "single8")

        # -- 2. uploads in progress
        _h, b = req("POST", "/mpb/pending", {"uploads": ""})
        pending = _xml_text(b, "UploadId")[0]
        req("PUT", "/mpb/pending", {"partNumber": "1", "uploadId": pending},
            b"p" * 1024)
        _h, b = req("GET", "/mpb", {"uploads": ""})
        if _xml_text(b, "UploadId") != [pending]:
            fail(f"S3 mp phase: ListMultipartUploads {_xml_text(b, 'UploadId')}")
        req("DELETE", "/mpb/pending", {"uploadId": pending}, want=204)
        _h, b = req("GET", "/mpb", {"uploads": ""})
        if _xml_text(b, "UploadId"):
            fail("S3 mp phase: the aborted upload is still listed")
        for r in roots:
            if os.path.exists(os.path.join(r, ".sys", "multipart", pending)):
                fail(f"S3 mp phase: the aborted upload's dir remains on {r}")

        # -- 3. reading multipart objects, healthy and degraded
        sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}

        def get(signer, key):
            st, _h, body = signer.request("GET", f"/mpb/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"S3 mp phase: GET {key}: {st}, body differs from its source")
            return len(body)

        keys = sorted(objs)
        get_jobs = [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)]
        lo = MP_PART - 100
        rng_hdr = {"range": f"bytes={lo}-{MP_PART + 99}"}

        def ranged(what):
            st, _h, got = one.request("GET", "/mpb/mp1", headers=rng_hdr)
            if st != 206 or got != objs["mp1"][lo:MP_PART + 100]:
                fail(f"S3 mp phase: {what} ranged GET across a part boundary: {st}")

        get_wall, sizes = _in_clients(host, port, get_jobs, get)
        ranged("healthy")
        dist = XLStorage(roots[0]).read_version("mpb", "mp-small").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in MP_SHARDS_OFF)
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            ld = launched()
            deg_wall, _ = _in_clients(host, port, get_jobs, get)
            ranged("degraded")
            deg_launch = delta(ld, launched())
            if deg_launch.get("gf_matmul_words", 0) <= 0:
                fail("S3 mp phase: the degraded GETs reconstructed nothing")
        finally:
            ol.disks[:] = live
        nget = sum(sizes)

        # -- 4. copies: UploadPartCopy, CopyObject, self-copy
        lcp = launched()
        t0 = time.monotonic()
        _h, b = req("POST", "/mpb/assembled", {"uploads": ""})
        asm = _xml_text(b, "UploadId")[0]
        # 7 MiB across mp2's first part boundary, mp-small's first 5 MiB
        r1 = (MP_PART // 2, MP_PART // 2 + MP_MIN_PART + MP_PART // 4 - 1)
        r2 = (0, MP_MIN_PART - 1)
        tail = rng.bytes(MP_PART // 8)
        asm_parts = [objs["mp2"][r1[0]:r1[1] + 1],
                     objs["mp-small"][r2[0]:r2[1] + 1], tail]
        for n, (src, r) in enumerate((("mp2", r1), ("mp-small", r2)), 1):
            _h, b = req("PUT", "/mpb/assembled",
                        {"partNumber": str(n), "uploadId": asm},
                        headers={"x-amz-copy-source": f"/mpb/{src}",
                                 "x-amz-copy-source-range": f"bytes={r[0]}-{r[1]}"},
                        what=f"UploadPartCopy {n}")
            if _xml_text(b, "ETag")[0].strip('"') != hashlib.md5(
                    asm_parts[n - 1]).hexdigest():
                fail(f"S3 mp phase: UploadPartCopy {n} ETag")
        req("PUT", "/mpb/assembled", {"partNumber": "3", "uploadId": asm}, tail)
        _h, b = req("POST", "/mpb/assembled", {"uploadId": asm},
                    _complete_body([hashlib.md5(p).hexdigest()
                                    for p in asm_parts]))
        upc_wall = time.monotonic() - t0
        asm_body = b"".join(asm_parts)
        _h, got = req("GET", "/mpb/assembled")
        if got != asm_body:
            fail("S3 mp phase: the UploadPartCopy object differs from its ranges")
        t0 = time.monotonic()
        _h, b = req("PUT", "/mpb/copy-mp3",
                    headers={"x-amz-copy-source": "/mpb/mp3"},
                    what="CopyObject")
        copy_wall = time.monotonic() - t0
        _h, got = req("GET", "/mpb/copy-mp3")
        if hashlib.sha256(got).digest() != sha["mp3"]:
            fail("S3 mp phase: the CopyObject copy differs from its source")
        kib = rng.bytes(1024)
        req("PUT", "/mpb/kib", body=kib, headers={"x-amz-meta-v": "1"})
        req("PUT", "/mpb/kib", headers={
            "x-amz-copy-source": "/mpb/kib",
            "x-amz-metadata-directive": "REPLACE", "x-amz-meta-v": "2"},
            what="self-copy")
        h, got = req("GET", "/mpb/kib")
        if got != kib or h.get("x-amz-meta-v") != "2":
            fail(f"S3 mp phase: self-copy gave {h.get('x-amz-meta-v')!r}")
        copy_launch = delta(lcp, launched())
        for name in ("phash256_batched", "encode_pack_pipelined"):
            if copy_launch.get(name, 0) <= 0:
                fail(f"S3 mp phase: the copies never launched {name}")

        # -- 5. heal a multipart object
        hdist = XLStorage(roots[0]).read_version("mpb", "mp0").erasure.distribution
        hurt = sorted(d for d in range(N) if hdist[d] in MP_SHARDS_OFF)
        saved = {}
        for d in hurt:
            fi = XLStorage(roots[d]).read_version("mpb", "mp0")
            ddir = os.path.join(roots[d], "mpb", "mp0", fi.data_dir)
            for name in sorted(os.listdir(ddir)):
                with open(os.path.join(ddir, name), "rb") as f:
                    saved[(d, name)] = f.read()
                os.remove(os.path.join(ddir, name))
        lh = launched()
        t0 = time.monotonic()
        res = ol.heal_object("mpb", "mp0")
        heal_s = time.monotonic() - t0
        heal_launch = delta(lh, launched())
        want = sorted(s - 1 for s in MP_SHARDS_OFF)
        if res["healed"] != want:
            fail(f"S3 mp phase: heal_object healed {res['healed']}, want {want}")
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if heal_launch.get(name, 0) <= 0:
                fail(f"S3 mp phase: heal never launched {name}")
        for (d, name), data in saved.items():
            fi = XLStorage(roots[d]).read_version("mpb", "mp0")
            with open(os.path.join(roots[d], "mpb", "mp0", fi.data_dir, name),
                      "rb") as f:
                if f.read() != data:
                    fail(f"S3 mp phase: healed {name} on disk {d} differs")
        others = [d for d in range(N) if d not in hurt][:4]
        for d in others:
            ol.disks[d] = None
        try:
            get(one, "mp0")
        finally:
            ol.disks[:] = live

        # -- 6. versions, POST policy, multi-delete
        req("PUT", "/mpver", what="versioned bucket create")
        req("PUT", "/mpver", {"versioning": ""},
            b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")
        req("PUT", "/mpver/k", body=b"v1")
        req("PUT", "/mpver/k", body=b"v2-longer")
        req("DELETE", "/mpver/k", want=204)
        seen, km, vm = [], "", ""
        for _ in range(10):
            q = {"versions": "", "max-keys": "1"}
            if km:
                q.update({"key-marker": km, "version-id-marker": vm})
            _h, b = req("GET", "/mpver", q)
            root = ET.fromstring(b)
            ns = root.tag[: root.tag.index("}") + 1]
            for e in root:
                if e.tag in (f"{ns}Version", f"{ns}DeleteMarker"):
                    seen.append((e.tag[len(ns):], e.findtext(f"{ns}IsLatest"),
                                 e.findtext(f"{ns}Size")))
            if root.findtext(f"{ns}IsTruncated") != "true":
                break
            km = root.findtext(f"{ns}NextKeyMarker")
            vm = root.findtext(f"{ns}NextVersionIdMarker")
        want_v = [("DeleteMarker", "true", None), ("Version", "false", "9"),
                  ("Version", "false", "2")]
        if seen != want_v:
            fail(f"S3 mp phase: ListObjectVersions paged {seen} != {want_v}")
        form_data = rng.bytes(3000)
        body, ctype = _post_policy_form(one, "mpb", "posted", form_data)
        req("POST", "/mpb", body=body, headers={"content-type": ctype},
            anonymous=True, want=204, what="POST policy upload")
        _h, got = req("GET", "/mpb/posted")
        if got != form_data:
            fail("S3 mp phase: the POST-policy object differs from the form's")
        _h, b = req("GET", "/mpb", {"list-type": "2"})
        all_keys = _xml_text(b, "Key")
        dbody = ("<Delete><Quiet>true</Quiet>" + "".join(
            f"<Object><Key>{k}</Key></Object>" for k in all_keys)
            + "</Delete>").encode()
        _h, b = req("POST", "/mpb", {"delete": ""}, dbody, what="multi-delete")
        if _xml_text(b, "Key"):
            fail(f"S3 mp phase: quiet multi-delete answered {b[:300]!r}")
        for k in all_keys:
            req("GET", f"/mpb/{k}", want=404, what=f"GET {k} after multi-delete")
        phase_s = time.monotonic() - t_phase
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        srv.shutdown()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)

    nput = sum(len(objs[f"mp{c}"]) for c in range(S3_CLIENTS))
    batch = stats["batch"]
    out = {
        "clients": S3_CLIENTS,
        "objects": len(objs),
        "parts": nparts + 3,
        "phase_s": phase_s,
        "mp_put_concurrent": {"bytes": nput, "s": put_wall,
                              "MBps": nput / put_wall / 1e6,
                              "parts": nparts, "k5_launches": k5,
                              "batch": put_batch},
        "complete_s": complete_s,
        "get_concurrent": {"bytes": nget, "s": get_wall,
                           "MBps": nget / get_wall / 1e6},
        "get_degraded_concurrent": {"bytes": nget, "s": deg_wall,
                                    "MBps": nget / deg_wall / 1e6,
                                    "offline_disks": dead},
        "copy_object": {"bytes": len(objs["mp3"]), "s": copy_wall,
                        "MBps": len(objs["mp3"]) / copy_wall / 1e6},
        "upload_part_copy": {"bytes": len(asm_body), "s": upc_wall,
                             "MBps": len(asm_body) / upc_wall / 1e6},
        "heal_object_s": heal_s,
        "short_writes": short,
        "launches": launches,
        "launches_by_step": {"part_puts": put_launch, "small_upload": small_launch,
                             "repair": repair_launch,
                             "get_degraded": deg_launch, "copies": copy_launch,
                             "heal": heal_launch},
        "flushes": {"multi_client": batch["multi_client_flushes"],
                    "total": batch["flushes"], "jobs": batch["jobs"]},
        "stages": stats["stages"],
    }
    return out


# the TPU function each kernel replaces: encode_pack_fused (P4),
# encode_hash_fused (P2, which encode_pack computes without the pack
# leg), phash256_words_batched (left to XLA), matmul_words (P1),
# verify_reconstruct_fused (P5), the pipelined P6 and P7, the XLA
# sub-chunk steps of the async overlap chain (X2, X3), gf_matmul_mxu (P3)
# and P4-P7 under the mxu formulation; and the phase whose counters each
# kernel's launches are read from.  P3 has no runtime caller in the JAX
# package, so K7 has no path of its own: its count is read from the main
# path's counters, where it is 0.
REPLACES = {
    "encode_pack": ("minio_tpu/ops/rs_pallas.py:472", "off"),
    "encode_pack[group=0]": ("minio_tpu/ops/rs_pallas.py:193", "heal"),
    "phash256_batched": ("minio_tpu/ops/hash.py:162", "main"),
    "gf_matmul_words": ("minio_tpu/ops/rs_pallas.py:84", "main"),
    "verify_reconstruct": ("minio_tpu/ops/rs_pallas.py:595", "off"),
    "encode_pack_pipelined": ("minio_tpu/ops/rs_pallas.py:802", "main"),
    "verify_reconstruct_pipelined": ("minio_tpu/ops/rs_pallas.py:970", "heal"),
    "encode_pack[subchunk]": ("minio_tpu/ops/codec_step.py:422", "async"),
    "verify_reconstruct[subchunk]": ("minio_tpu/ops/codec_step.py:486", "async"),
    "gf_matmul_mxu": ("minio_tpu/ops/rs_pallas.py:296", "main"),
    "encode_pack[mxu]": ("minio_tpu/ops/rs_pallas.py:472", "mxu off"),
    "verify_reconstruct[mxu]": ("minio_tpu/ops/rs_pallas.py:595", "mxu off"),
    "encode_pack_pipelined[mxu]": ("minio_tpu/ops/rs_pallas.py:802", "mxu pipeline"),
    "verify_reconstruct_pipelined[mxu]": ("minio_tpu/ops/rs_pallas.py:970", "mxu pipeline"),
}


_KERNEL_NAME = re.compile(
    r"(encode_pipelined_mxu_kernel|encode_pipelined_kernel|"
    r"verify_reconstruct_pipelined_kernel|"
    r"encode_kernel|encode_mxu_kernel|pack_kernel|phash_kernel|"
    r"gf_matmul_mxu_kernel|gf_matmul_kernel|verify_reconstruct_mxu_kernel|"
    r"verify_reconstruct_kernel)"
    r"(?:I((?:L[ib]\d+E)+)E)?"
)


def kernel_label(mangled: str) -> str:
    """A kernel's name with its template buckets in <> (swar or mxu for
    the formulation), from its mangled name."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return mangled
    name = m.group(1)
    if m.group(2):
        args = re.findall(r"L([ib])(\d+)E", m.group(2))
        name += "<" + ",".join(
            ("mxu" if v == "1" else "swar") if t == "b" else v for t, v in args
        ) + ">"
    return name


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel (template buckets in <>): registers,
    shared memory and spills from nvcc's -Xptxas -v output."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


_SASS_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(\S.*?)\s*;")
_MMA_OPS = ("BMMA", "IMMA", "HMMA")  # the tensor-core instructions
# the instantiations sass_loops reads: K2, K6, K1 and K5 at EC 8+4 (swar
# and mxu), K3, and K4 at EC 8+4: swar and mxu at heal's pattern (<8,8,swar>,
# <8,4,mxu>) and with every row present (<16,8,swar>, <16,4,mxu>).  An older
# copy's K4 is verify_reconstruct_kernel<16,8> (swar) and
# verify_reconstruct_mxu_kernel<PB,RB>.
SASS_KERNELS = ("phash_kernel", "verify_reconstruct_pipelined",
                "encode_kernel<8,4,", "encode_mxu_kernel<8,4", "gf_matmul_kernel",
                "encode_pipelined_kernel<8,4,", "encode_pipelined_mxu_kernel<8,4,",
                "verify_reconstruct_kernel<16,8", "verify_reconstruct_kernel<8,8,swar>",
                "verify_reconstruct_kernel<8,4,mxu>", "verify_reconstruct_kernel<16,4,mxu>",
                "verify_reconstruct_mxu_kernel<8,4>", "verify_reconstruct_mxu_kernel<16,4>")


def sass_loops(lib, kernels_mod) -> dict:
    """Static SASS of K1, K2, K4, K5 and K6 at EC 8+4 and K3
    (``SASS_KERNELS``; ``cuobjdump -sass`` of the built library), per
    instantiation: its instruction count and, for each loop (the span of a
    backward branch), its size, the sizes of the pieces that the branches
    inside it cut it into, and its block barriers (``bars``) and
    tensor-core instructions (``mmas``).  A thread walks one column (K1, K4-K6) or column quad (K2,
    and K3 where it loads quads) per pass of the tile loop, so its size is the
    static instruction count per column or quad; a piece that a uniform
    branch skips (a rebuilt row past the pattern's) does not run."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(kernels_mod._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump failed: {proc.stderr.strip()}")
    out = {}
    for body in proc.stdout.split("Function : ")[1:]:
        name = kernel_label(body.split("\n", 1)[0].strip())
        if not name.startswith(SASS_KERNELS):
            continue
        insns = []
        for line in body.splitlines():
            m = _SASS_INSN.match(line)
            if m:
                text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
                insns.append((int(m.group(1), 16), text))
        loops = []
        for addr, text in insns:
            to = re.search(r"\b0x([0-9a-f]+)\b", text)
            if text.startswith("BRA") and to and int(to.group(1), 16) <= addr:
                span = [t for a, t in insns if int(to.group(1), 16) <= a <= addr]
                pieces, n = [], 0
                for t in span:
                    n += 1
                    if t.startswith("BRA"):
                        pieces.append(n)
                        n = 0
                loops.append({"insns": len(span), "pieces": pieces + [n] * (n > 0),
                              "bars": sum(t.startswith("BAR") for t in span),
                              "mmas": sum(t.startswith(_MMA_OPS) for t in span)})
        out[name] = {"insns": len(insns), "loops": loops}
    return out


def load_copy(path: str):
    """The kernels module of another copy of the port: PATH holds an
    ``__init__.py``, its ``ops/`` and its ``csrc/``, and builds its own
    library into PATH/build."""
    import importlib

    parent, pkg = os.path.split(os.path.abspath(path))
    sys.path.insert(0, parent)
    try:
        return importlib.import_module(f"{pkg}.ops.kernels")
    finally:
        sys.path.remove(parent)


def compare_copies(dev, mods: dict, order: list) -> list:
    """K1-K6 of several copies of the port (``mods``: name -> kernels
    module) in turns (``order``), at the main path's shapes: K1 and K5
    with the pack leg at (4, 8, 327,680) swar and mxu, without it at
    heal's (1, 8, 327,680) (K1 swar and mxu, K5 swar), K1 also at one
    tile, and K1's sub-chunk chain (X2) at (4, 8, 327,680); K2 at (32,
    327,680); K3 at the degraded GET's (4, 12, 327,680) and (1, 12,
    327,680) and one tile, shards 1, 3, 10, 12 absent; K4 and K6 at
    heal's (1, 12, 327,680) swar and mxu, with those shards absent and
    with all rows present, K4 swar also at one tile (1, 12, 256); K4's
    sub-chunk chain (X3) over heal's row in 5 chunks of 65,536 words, and
    one such chunk at word offset 65,536 (not the last: no finalize).
    Every result is first held bit for bit against the plain version
    (the X3 chain's digests against the whole row's, its data once per
    copy); then cuda_ms and device_times of each."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, hash as phash, rs

    heal, every = PATTERNS["data+parity missing"], PATTERNS["all present"]
    idx = tuple(i for i, p in enumerate(heal) if p)[:K]
    rmat = gf.reconstruction_matrix(K, M, idx)
    rows = []
    for turn, name in enumerate(order):
        kern = mods[name]
        rng = np.random.default_rng(SEED)
        x2 = rand_words(rng, (4 * K, W), dev)
        x6 = rand_words(rng, (1, N, W), dev)
        x1 = rand_words(rng, (4, K, W), dev)
        x1[-1, :, 256:2048] = 0  # zero groups for the pack leg
        x3 = rand_words(rng, (4, N, W), dev)
        cases = {}
        for label, x, group, form in (
                ("K1 group=256 (4, 8, 327680)", x1, 256, "swar"),
                ("K1 group=0 (1, 8, 327680)", x1[:1], 0, "swar"),
                ("K1 group=0 one tile (1, 8, 256)", x1[:1, :, :256].contiguous(), 0, "swar"),
                ("K1 mxu group=256 (4, 8, 327680)", x1, 256, "mxu"),
                ("K1 mxu group=0 (1, 8, 327680)", x1[:1], 0, "mxu")):
            cases[label] = (
                lambda x=x, group=group, form=form: kern.encode_pack(
                    x, M, 4 * x.shape[-1], group, form),
                lambda x=x, group=group: kern.encode_pack_plain(x, M, 4 * x.shape[-1], group))
        # K5 at the PUT's shape (swar and mxu) and at B = 1 without the
        # pack leg, beside K1 at the same shapes above
        for label, x, group, form in (
                ("K5 group=256 (4, 8, 327680)", x1, 256, "swar"),
                ("K5 group=0 (1, 8, 327680)", x1[:1], 0, "swar"),
                ("K5 mxu group=256 (4, 8, 327680)", x1, 256, "mxu")):
            cases[label] = (
                lambda x=x, group=group, form=form: kern.encode_pack_pipelined(
                    x, M, 4 * x.shape[-1], group, form),
                lambda x=x, group=group: kern.encode_pack_pipelined_plain(
                    x, M, 4 * x.shape[-1], group))
        chunks = [(o, x1[:, :, o:o + 65536].contiguous()) for o in range(0, W, 65536)]

        def x2_chain(kern=kern, chunks=chunks):
            acc = torch.zeros((4, N, 8), dtype=torch.int32, device=dev)
            for i, (o, c) in enumerate(chunks):
                kern.encode_pack_subchunk(c, acc, o, M, 4 * W, 256, i == len(chunks) - 1)
            return (acc,)

        # X2: K1's sub-chunk form chained over the row (5 chunks of 65,536
        # words, as the async overlap mode cuts it), against the whole
        # row's digests
        cases["X2 chain of 5 (4, 8, 327680)"] = (
            x2_chain, lambda: (kern.encode_pack_plain(x1, M, 4 * W, 0)[1],))
        cases["K2 (32, 327680)"] = (
            lambda: kern.phash256_batched(x2, 4 * W),
            lambda: (phash.phash256_words_batched(x2, 4 * W),))
        for label, x in (("K3 (4, 12, 327680)", x3), ("K3 (1, 12, 327680)", x3[:1]),
                         ("K3 one tile (1, 12, 256)", x3[:1, :, :256].contiguous())):
            cases[label] = (lambda x=x: kern.gf_matmul_words(rmat, x, idx),
                            lambda x=x: (rs.gf_matmul_words(rmat, x, idx),))
        # K4 at heal's shape, swar and mxu, at heal's pattern and with every
        # row present (no rebuilt row)
        for label, pres, form in (("heal swar", heal, "swar"), ("heal mxu", heal, "mxu"),
                                  ("all present swar", every, "swar"),
                                  ("all present mxu", every, "mxu")):
            cases[f"K4 {label} (1, 12, 327680)"] = (
                lambda pres=pres, form=form: kern.verify_reconstruct(
                    x6, pres, K, 4 * W, formulation=form),
                lambda pres=pres: kern.verify_reconstruct_plain(x6, pres, K, 4 * W))
        x4t = x6[:, :, :256].contiguous()
        cases["K4 heal swar one tile (1, 12, 256)"] = (
            lambda: kern.verify_reconstruct(x4t, heal, K, 1024),
            lambda: kern.verify_reconstruct_plain(x4t, heal, K, 1024))
        for label, pres, form in (("heal swar", heal, "swar"), ("heal mxu", heal, "mxu"),
                                  ("all present swar", every, "swar"),
                                  ("all present mxu", every, "mxu")):
            cases[f"K6 {label} (1, 12, 327680)"] = (
                lambda pres=pres, form=form: kern.verify_reconstruct_pipelined(
                    x6, pres, K, 4 * W, formulation=form),
                lambda pres=pres: kern.verify_reconstruct_pipelined_plain(
                    x6, pres, K, 4 * W))
        # X3: K4's sub-chunk form chained over heal's row (5 chunks of
        # 65,536 words, as the async overlap mode cuts it), against the
        # whole row; and one chunk at a nonzero word offset, not the last
        vr_chunks = [(o, x6[:, :, o:o + 65536].contiguous()) for o in range(0, W, 65536)]

        def x3_chain(kern=kern, chunks=vr_chunks, outs=None):
            acc = torch.zeros((1, N, 8), dtype=torch.int32, device=dev)
            for i, (o, c) in enumerate(chunks):
                data = kern.verify_reconstruct_subchunk(c, acc, o, heal, K, 4 * W,
                                                        i == len(chunks) - 1)[0]
                if outs is not None:
                    outs.append(data)
            return (acc,)

        outs = []
        x3_chain(outs=outs)
        if not torch.equal(torch.cat(outs, dim=-1),
                           kern.verify_reconstruct_plain(x6, heal, K, 4 * W)[0]):
            fail(f"X3 chain of copy {name} does not rebuild the whole row's data")
        cases["X3 chain of 5 heal (1, 12, 327680)"] = (
            x3_chain, lambda: (kern.verify_reconstruct_plain(x6, heal, K, 4 * W)[1],))
        off, chunk = vr_chunks[1]
        acc1 = torch.zeros((1, N, 8), dtype=torch.int32, device=dev)
        cases["X3 one chunk heal (1, 12, 65536) at 65536"] = (
            lambda kern=kern: kern.verify_reconstruct_subchunk(
                chunk, acc1, off, heal, K, 4 * W),
            lambda: kern.verify_reconstruct_subchunk_plain(
                chunk, torch.zeros_like(acc1), off, heal, K, 4 * W))
        for label, (fn, plain) in cases.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            if same(got, plain()):
                fail(f"{label} of copy {name} differs from its plain version")
            rows.append({"turn": turn, "copy": name, "case": label,
                         "events_ms": cuda_ms(fn, 20, 3), **device_times(fn)})
        torch.cuda.synchronize()
    return rows


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "--parent", metavar="DIR",
        help="another copy of the port (DIR/__init__.py, DIR/ops, DIR/csrc): "
             "build it too and time its K1-K6 beside this "
             "checkout's, in turns parent, new, new, parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from concurrent.futures import ThreadPoolExecutor

    from minio_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    # the plain mxu product is a float32 matmul of 0/1 values: keep it in
    # full float32 (exact either way: counts <= 128, 0/1 exact in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"rates: {json.dumps(int_rate())}", flush=True)
    copies = {"new": kernels}
    if args.parent:
        copies["parent"] = load_copy(args.parent)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(copies)) as pool:  # one nvcc per copy, at once
        libs = dict(zip(copies, pool.map(lambda m: m.build(), copies.values())))
    build_s = time.monotonic() - t0
    for name, lib in libs.items():
        print(f"build {name}: {build_s:.2f} s -> {os.path.relpath(lib, here)}",
              flush=True)
        for line in ptxas_summary(copies[name].BUILD_INFO.get("log", "")):
            print("  ptxas:", line)
        print(f"  sass: {json.dumps(sass_loops(lib, kernels))}", flush=True)

    import numpy as np

    rng = np.random.default_rng(SEED)
    kres = check_kernels(dev, rng)
    kres.update(check_heal_kernels(dev, rng))
    kres.update(check_overlap_kernels(dev, rng))
    kres.update(check_mxu_kernels(dev, rng))
    for name, r in kres.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    if args.parent:
        for row in compare_copies(dev, copies, ["parent", "new", "new", "parent"]):
            print(f"compare: {json.dumps(row)}", flush=True)
    xfer = transfer_ms(dev)
    print(f"transfers: {json.dumps(xfer)}", flush=True)

    # the main path and heal run under the default mode
    os.environ.pop("MINIO_TPU_CODEC_OVERLAP", None)
    work = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        payloads, written, mp = main_path(dev, work)
        print(f"main path: {json.dumps(mp)}", flush=True)
        hp = heal_phase(dev, work, payloads)
        print(f"heal: {json.dumps(hp)}", flush=True)
        mo = modes_phase(dev, work, payloads, written, MODE_RUNS)
        mx = modes_phase(dev, work, payloads, written, MXU_RUNS)
        s3 = s3_phase(dev, work, payloads, written, mp)
        s3mp = s3_mp_phase(dev, work, payloads)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, by_run in (("mode", mo), ("mxu phase", mx)):
        for (formulation, mode), runs in by_run.items():
            for i, r in enumerate(runs):
                print(f"{label} {formulation} {mode} run {i + 1}: {json.dumps(r)}",
                      flush=True)
    print(f"s3: {json.dumps(s3)}", flush=True)
    print(f"s3_mp: {json.dumps(s3mp)}", flush=True)
    phase_launches = {
        "main": mp["launches"], "heal": hp["launches"],
        "off": mo[("swar", "off")][0]["launches"],
        "async": mo[("swar", "async")][0]["launches"],
        "mxu off": mx[("mxu", "off")][0]["launches"],
        "mxu pipeline": mx[("mxu", "pipeline")][0]["launches"],
    }

    line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "minio_tpu_torch/csrc/codec.cu",
                "replaces": replaces,
                "launches": phase_launches[phase][name],
                "max_abs_err": kres[name]["max_abs_err"],
                "ms": kres[name]["ms"],
                "plain_ms": kres[name]["plain_ms"],
                "bound_ms": kres[name]["bound_ms"],
                "bound_by": kres[name]["bound_by"],
                "library_ms": None,
                **{key: kres[name][key] for key in ("device_ms", "host_us", "cold_ms")
                   if key in kres[name]},
            }
            for name, (replaces, phase) in REPLACES.items()
        ]
    }
    print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
