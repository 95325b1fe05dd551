#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --parent DIR   # and K1-K11 beside an older copy

1. Builds the CUDA kernels from ``minio_tpu_torch/csrc`` with nvcc into
   one library (and ``--parent``'s copy into its own), one ``nvcc -c``
   per source (codec.cu, select.cu, the copy's codec.cu) all at once,
   prints each library's and each source's build seconds and each
   kernel's registers and spills and the static SASS of K1, K4 and K5
   (EC 8+4, swar and mxu), K2, K3, K6, K7 (4 x 8), K8 (each lookahead), K9, K10
   (both forms) and K11 (``sass_loops``).
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
   4-word quad and an unaligned view (``gf_pattern_sweep``).  S3 Select's
   K8-K11 (``csrc/select.cu``, in the same library as the codec's)
   against their plain versions on a 32 MiB TPC-H lineitem chunk (one
   DEV_CHUNK): K8 under the screens of Q1-Q4, of an IN list of 16 options
   (row and field anchored), of one of 150 (past the records a launch
   passes by value), of every atom kind (both anchors, sci guard on and
   off) and of one program for each lookahead of 1-6 words, on a hazard
   chunk and on the SWAR-borrow planes (the borrow within a word's half
   and from lane 3 into lane 4); K9 at every program's candidates (the
   whole output, ranks past the count included), beside
   ``torch.nonzero`` of the candidate bytes; K10
   at the three row windows and backwards, also over rows 10-6,000 bytes
   wide; K11 at 4-4,096-byte windows, at every start alignment and plane
   offset, clamped at both ends of the plane (``check_select_kernels``).  Beside each kernel's
   back-to-back event time (``ms``): its device time from a replayed
   CUDA graph, the host's time per wrapper call and its L2-cold time
   (``device_times``), and for K1, K3, K6 and K7 a one-tile launch (the
   fixed chain); K7 also every (output, row) bucket, ragged, sub-tile and
   unaligned shapes against K3, and its ``clock64`` phases per block
   (``check_k7``, ``k7_phases``).  With ``--parent``, K1-K7 of both
   copies at the main path's shapes in turns parent, new, new, parent
   (``compare_copies``), then K8 under Q1, Q2, the IN list's field
   screen and two long lookaheads on the lineitem chunk, K9 at Q1's and
   Q2's candidates, K10 at Q1's anchors and backwards at Q2's hits, and
   K11 at Q1's gather and at one row, in the same turns (``compare_select_copies``), the card's name and
   power limit printed before them.
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
7. The S3 front: the port's S3Server (threaded plane,
   MINIO_TPU_SERVER=threaded) over a fresh ErasureObjects on the card (12 disks,
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
8b. Server-side encryption and compression (``sse_phase``): a fresh
   S3Server over TLS (a self-signed certificate for 127.0.0.1 from the
   openssl CLI) and disks of the same deployment, SSE-S3 keys from
   MINIO_TPU_KMS_MASTER_KEY (a key made from SEED).  First 4 x 64 MiB
   without SSE over the same TLS (the baseline).  SSE-C: 4 clients
   PUT and GET 8 x 64 MiB, range GETs at 65,436+200, 10,485,660+200 and
   the last 17 B of each, one GET with the disks of shards 1, 3, 10 and
   12 offline, a wrong key answered 403 AccessDenied; SSE-S3: a bucket
   default set by ``PUT ?encryption``, 4 x 64 MiB PUT without a header and
   read back with ``x-amz-server-side-encryption: AES256``, the admin
   ``kms/key/status`` round trip; compression (MINIO_TPU_COMPRESS=on): 4
   x 64 MiB of lineitem text and one compressed+SSE-C copy of it, the
   stored/actual ratio, a GET and a range GET, Select Q1 over the
   compressed and the SSE-C object against the host engine's Records over
   the plain text; an SSE-C multipart upload of 4 x 8 MiB and a GET across
   a part boundary; CopyObject SSE-C -> SSE-S3 of 64 MiB; one shard of an
   SSE-C object deleted and healed.  Every body must equal its source;
   K5, K2, K3, K6, K1 without the pack leg and K8-K10 must launch.  Also
   times EncryptReader/DecryptWriter and CompressReader/DecompressWriter
   alone over 64 MiB in memory.  Prints the ``sse:`` line.
9. S3 Select (``select_phase``): on a fresh S3Server and disks of the
   same deployment, a 256 MiB TPC-H lineitem CSV (``lineitem_csv``, 8
   DEV_CHUNKs) is PUT and queried through ``POST ?select`` by Q1-Q4
   (``SELECT_QUERIES``) under the default engine and under
   MINIO_TPU_SELECT=host (Records byte-identical), Q1 on 16 MiB against
   the ``row`` engine, Q1 with 4 disks offline, Q1 and Q2 by 4 clients at
   once; the fallbacks must be SELECT_FALLBACK's on every chunk, the
   ``miniotpu_select_*`` families must move, ``run_device`` over
   ``as_device_plane`` of the object on the card must answer Q1 (K11),
   and K8-K11, K2 and K3 must launch.  Prints the ``select:`` line.
10. The server as users start it (``boot_phase``): ``python -m
   minio_tpu_torch.server --parity 4`` over 24 temp-dir drives in a
   process of its own, on the async plane and the card (neither
   MINIO_TPU_SERVER nor MINIO_ERASURE_BACKEND set), the fresh-disk
   monitor every second.  Boot until readiness answers 200 (each
   drive's format.json: 2 sets x 12, one deployment id; loops/status
   async; 24 drives online); 4 SigV4 clients PUT 8 x 64 MiB and the
   10 MiB + 17 B object at once (both sets hold objects), GET every one;
   drive 5 (set 0) wiped while the server runs: stamped back with its
   uuid and every set-0 object healed onto it, its files equal to those
   before the wipe; one part file of a set-1 object deleted and healed
   through the admin API; SIGTERM (exit 0, ``shutdown complete``); drive
   17 (set 1) wiped while the server is down, then a restart over the
   same drives: the same deployment id, drive 17 stamped by the hole
   fill and healed by the sweep, every GET equal to its source, SIGTERM.
   The admin ``kernel-stats`` is read around each step (device passes,
   batcher flushes, merges, wait seconds).  Last, one Q1 select over a
   16 MiB lineitem object on the restarted server, against the host
   engine's answer, with ``miniotpu_select_requests_total{engine="device"}``
   at least 1.  Prints the ``boot:`` line.
11. Prints the kernels JSON line, the card's name and power limit, and as
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


# The mxu kernels' own integer work, printed beside the bound as
# ``design_int_ops``, never part of it: the function does not need it.
# 3 byte permutes build a lane's B word per 8 byte columns.
_PERM = 3


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


# K7's own product (csrc/codec.cu k7_operands, k7_product) per lane and
# 16-byte chunk, which is per word column (4 lanes share a chunk of 4
# word columns): the A words' byte permutes (3 a word quad with up to 4
# input rows - byte 0 needs none - 1 a word with 8, 2 with 16: a 4 x 4
# byte transpose) and one funnel shift a count (8 m-tiles x bucket(o)
# n-tiles x 4 counts a lane).
_K7_PERMS = {4: 12, 8: 16, 16: 32}


def _row_bucket(v: int) -> int:
    """The kernels' row bucket of v rows (codec.cu bucket)."""
    return 4 if v <= 4 else (8 if v <= 8 else 16)


def k7_design_ops(o: int, s: int) -> int:
    """K7's permutes and funnel shifts per word column."""
    return _K7_PERMS[_row_bucket(s)] + 32 * _row_bucket(o)


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


def k7_recon_matrix():
    """The rows of EC 8+4's reconstruction matrix that rebuild data shards
    0-3 when those four are lost: a dense (4, 8) matrix, K7's second
    shape beside the parity matrix."""
    from minio_tpu_torch.ops import gf

    present = tuple(i for i in range(N) if i >= 4)
    return gf.reconstruction_matrix(K, M, present)[:4]


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


def check_k7(dev, rng) -> dict:
    """K7 gf_matmul_mxu against its plain version and K3 on the same bytes
    as words (where the bytes are whole aligned words): EC 8+4's parity,
    the reconstruction matrices of heal's pattern and of 4 lost data
    shards at the codec's (4 or 8, 8, 1,310,720), ragged and sub-tile
    lengths, views 1 and 16 bytes off alignment, a length that leaves
    blocks without a tile, and one matrix for each (output, row) bucket
    pair; then gf.encode_ref.  Times at the codec's shape beside K3's,
    one tile, and the phases (``k7_phases``)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, kernels, rs

    pm = gf.parity_matrix(K, M)
    rows = tuple(i for i, p in enumerate(PATTERNS["data+parity missing"]) if p)[:K]
    rm = gf.reconstruction_matrix(K, M, rows)
    r4 = k7_recon_matrix()
    L = BLOCK // K  # one shard of a 10 MiB block: 10 MiB over the 8 rows
    sms = kernels.sm_count(dev)
    # an (o, s) matrix for every (output, row) bucket pair of the entry
    buckets = [(o, s_) for o in (1, 5, 16) for s_ in (3, 8, 13)]
    edge = np.random.default_rng(SEED + 7)
    cases = [(pm, L, 0), (rm, L, 0), (r4, L, 0), (pm, 8192 + 17, 0), (rm, 4104 * 4 + 3, 0),
             (gf.parity_matrix(16, 16), 4096, 0), (pm[:1, :1], 5, 0), (pm, 1000, 0),
             (pm, 1024, 0), (pm, 1040, 0), (r4, 64 * 1024 + 8, 0),
             # a view 1 and 16 bytes into its storage
             (pm, 8192, 1), (r4, 65536 + 48, 16),
             # blocks past the last tile: 1,281 tiles on 264 blocks of 5
             (pm, L + 1024, 0)]
    cases += [(edge.integers(0, 256, (o, s_)).astype(np.uint8), 3 * 1024 + 80, 0)
              for o, s_ in buckets]
    err = 0
    for mat, length, off in cases:
        o, s_ = mat.shape
        base = torch.from_numpy(rng.integers(0, 256, (s_ * length + off,), dtype=np.uint8)).to(dev)
        sh = base[off:].view(s_, length)
        blocks, tpb = kernels.k7_grid(length, sms, o, s_)
        if (length, off) == (L + 1024, 0) and blocks * tpb - -(-length // 1024) < tpb:
            fail("gf_matmul_mxu sweep: the idle-block case leaves no block idle")
        got = kernels.gf_matmul_mxu(mat, sh)
        torch.cuda.synchronize()
        e = same((got,), (rs.gf_matmul_mxu_plain(mat, sh),))
        if length % 4 == 0 and off % 4 == 0:  # the swar twin: K3 on the same bytes as words
            words = sh.view(torch.int32)[None]
            twin = kernels.gf_matmul_words(mat, words, tuple(range(s_)))
            e = max(e, same((got,), (twin[0].contiguous().view(torch.uint8),)))
        if e:
            fail(f"gf_matmul_mxu differs from its plain version or K3 at "
                 f"{o, s_, length} offset {off}")
        err = max(err, e)
    x = torch.from_numpy(rng.integers(0, 256, (8, 64), dtype=np.uint8)).to(dev)
    if not np.array_equal(kernels.gf_matmul_mxu(pm, x).cpu().numpy(),
                          gf.encode_ref(x.cpu().numpy(), M)):
        fail("gf_matmul_mxu differs from gf.encode_ref")
    sh = torch.from_numpy(rng.integers(0, 256, (K, L), dtype=np.uint8)).to(dev)
    if not np.array_equal(kernels.gf_matmul_mxu(pm, sh).cpu().numpy(),
                          gf.encode_ref(sh.cpu().numpy(), M)):
        fail("gf_matmul_mxu differs from gf.encode_ref at the main shape")
    words = sh.view(torch.int32)[None]
    bms, by = mxu_bound((K + M) * L, 0, L // 4 * mxu_ops(M, K),
                        bound((K + M) * L, L // 4 * gf_ops(pm)))
    one = sh[:, :1024].contiguous()
    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: kernels.gf_matmul_mxu(pm, sh), 20),
        swar_ms=cuda_ms(lambda: kernels.gf_matmul_words(pm, words, tuple(range(K))), 20),
        plain_ms=cuda_ms(lambda: rs.gf_matmul_mxu_plain(pm, sh), 3, 1),
        bound_ms=bms, bound_by=by, shape=[M, K, L],
        design_int_ops=L // 4 * k7_design_ops(M, K),
        one_tile_device_ms=device_times(lambda: kernels.gf_matmul_mxu(pm, one))["device_ms"],
        phases=k7_phases(kernels, pm, sh),
        **device_times(lambda: kernels.gf_matmul_mxu(pm, sh)),
    )


def check_mxu_kernels(dev, rng) -> dict:
    """Phase 2, mxu: K7 gf_matmul_mxu and the mxu instantiations of K1,
    K4, K5 and K6 against their plain versions (rs.mxu_rows) and their
    swar twins (K3 for K7), then timings beside the twins'."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, kernels, rs

    results = {}

    results["gf_matmul_mxu"] = check_k7(dev, rng)
    pm = gf.parity_matrix(K, M)

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


def k7_phases(kern, matrix, shards) -> "dict | None":
    """K7's clock64 phases per block, from one call of a copy whose
    ``gf_matmul_mxu`` takes ``stamps``: each block's thread 0 writes its
    cycles before its first tile (setup), waiting for input (load), in
    the product and in the stores, its %globaltimer at start and end and
    its SM.  Returns the median and the
    largest of each phase over the blocks that ran a tile, the launch's
    span (first start to last end) and the spread of the blocks' starts,
    in ns; None for a copy without stamps."""
    import inspect
    import statistics

    import torch

    if "stamps" not in inspect.signature(kern.gf_matmul_mxu).parameters:
        return None
    rows = -(-shards.shape[1] // 1024)  # at most one block a 1,024-byte tile
    stamps = torch.zeros((rows, 7), dtype=torch.int64, device=shards.device)
    kern.gf_matmul_mxu(matrix, shards)  # warm
    kern.gf_matmul_mxu(matrix, shards, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()
    st = st[st[:, 4] > 0]
    out = {"blocks": int(st.shape[0]), "sms": int(len(set(st[:, 6].tolist())))}
    for i, name in enumerate(("setup", "load", "product", "store")):
        out[f"{name}_cycles_median"] = float(statistics.median(st[:, i].tolist()))
        out[f"{name}_cycles_max"] = int(st[:, i].max())
    out["span_ns"] = int(st[:, 5].max() - st[:, 4].min())
    out["start_spread_ns"] = int(st[:, 4].max() - st[:, 4].min())
    out["block_ns_median"] = float(statistics.median((st[:, 5] - st[:, 4]).tolist()))
    return out


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
    own server/auth.py: one keep-alive connection per instance, over TLS
    verified against ``cafile`` when it is given."""

    def __init__(self, host: str, port: int, access_key="minioadmin",
                 secret_key="minioadmin", region="us-east-1",
                 cafile: "str | None" = None):
        import http.client
        import ssl

        self.host, self.port = host, port
        self.ak, self.sk, self.region = access_key, secret_key, region
        if cafile:
            self.conn = http.client.HTTPSConnection(
                host, port, timeout=600,
                context=ssl.create_default_context(cafile=cafile))
        else:
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


def _in_clients(host, port, jobs_per_client, fn,
                cafile: "str | None" = None) -> "tuple[float, list]":
    """Run ``fn(signer, job)`` for each client's jobs, S3_CLIENTS clients
    at once on their own connections (TLS against ``cafile`` when it is
    given); (wall seconds, results)."""
    import threading

    results: list = [None] * len(jobs_per_client)
    errors: list = []
    start = threading.Barrier(len(jobs_per_client) + 1)

    def run(ix):
        signer = S3Signer(host, port, cafile=cafile)
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
        return {k: b[k] - a[k] for k in ("flushes", "jobs", "multi_client_flushes",
                                         "wait_seconds")}

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
            # the distribution from a disk that holds the completed object
            src = next(d for d in range(N) if d not in disks)
            dist_k = XLStorage(roots[src]).read_version("mpb", key).erasure.distribution
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


# -- phase 8b: server-side encryption and compression ------------------------

SSE_RANGES = ((65_436, 200), (10_485_660, 200))  # and each object's last 17 B
SSE_S3_OBJECTS = 4
SSE_MP_PARTS = 4  # x MP_PART
SSE_CONFIG = (
    b"<ServerSideEncryptionConfiguration><Rule>"
    b"<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256</SSEAlgorithm>"
    b"</ApplyServerSideEncryptionByDefault></Rule>"
    b"</ServerSideEncryptionConfiguration>")


def tls_cert(work: str) -> "tuple[str, str]":
    """(certificate, key) PEM files of a self-signed certificate for
    127.0.0.1 (CN and IP SAN), from the openssl CLI."""
    cert, key = os.path.join(work, "tls-cert.pem"), os.path.join(work, "tls-key.pem")
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"sse: openssl req failed: {r.stderr[-300:]}")
    return cert, key


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    """The SSE-C header triplet (or its copy-source form) for ``key``."""
    import base64
    import hashlib

    p = ("x-amz-copy-source-server-side-encryption-customer" if copy_source
         else "x-amz-server-side-encryption-customer")
    return {f"{p}-algorithm": "AES256",
            f"{p}-key": base64.b64encode(key).decode(),
            f"{p}-key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


def host_transform_rates(plain: bytes, text: bytes) -> dict:
    """MB/s of EncryptReader, DecryptWriter, CompressReader and
    DecompressWriter alone, each over its 64 MiB input in memory, pulled
    and pushed in 10 MiB steps as the codec moves blocks."""
    from minio_tpu_torch.codec import compress as compmod, sse as ssemod

    class Sink:
        n = 0

        def write(self, b):
            Sink.n += len(b)

    def pull(reader) -> bytes:
        out = []
        while True:
            got = reader.read(BLOCK)
            if not got:
                return b"".join(out)
            out.append(got)

    def push(writer, data) -> None:
        for i in range(0, len(data), BLOCK):
            writer.write(data[i:i + BLOCK])
        writer.finish()

    key, nb = bytes(range(32)), bytes(8)
    out = {}
    t = time.monotonic()
    sealed = pull(ssemod.EncryptReader(io.BytesIO(plain), key, nb))
    out["encrypt_MBps"] = len(plain) / (time.monotonic() - t) / 1e6
    Sink.n = 0
    t = time.monotonic()
    push(ssemod.DecryptWriter(Sink(), key, nb), sealed)
    out["decrypt_MBps"] = len(plain) / (time.monotonic() - t) / 1e6
    if Sink.n != len(plain):
        fail(f"sse: DecryptWriter gave {Sink.n} of {len(plain)} bytes")
    t = time.monotonic()
    deflated = pull(compmod.CompressReader(io.BytesIO(text)))
    out["compress_MBps"] = len(text) / (time.monotonic() - t) / 1e6
    Sink.n = 0
    t = time.monotonic()
    push(compmod.DecompressWriter(Sink()), deflated)
    out["decompress_MBps"] = len(text) / (time.monotonic() - t) / 1e6
    if Sink.n != len(text):
        fail(f"sse: DecompressWriter gave {Sink.n} of {len(text)} bytes")
    out["text_ratio"] = len(deflated) / len(text)
    return out


def sse_phase(dev, work: str, s3: dict) -> dict:
    """Phase 8b (slice 8): SSE-C, SSE-S3 and compression through the
    port's S3Server (threaded plane, TLS) over a fresh ErasureObjects on
    the card (12 disks, EC 8+4, 10 MiB blocks), 4 SigV4 clients."""
    import hashlib
    import json as _json

    import numpy as np

    from minio_tpu_torch.codec import kms as kmsmod, sse as ssemod
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3select.engine import S3Select, SelectRequest
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    # the AEAD route: cryptography's AES-256-GCM, or SSE cannot run here
    if ssemod._CRYPTO_IMPORT_ERROR is not None:
        fail(f"sse: no AEAD: {ssemod._CRYPTO_IMPORT_ERROR}")
    import cryptography

    route = f"cryptography {cryptography.__version__} AESGCM"
    rng = np.random.default_rng(SEED + 8)
    master = rng.bytes(32)
    ckey, wrong = rng.bytes(32), rng.bytes(32)
    cert, tkey = tls_cert(work)
    env = {"MINIO_TPU_TLS": "on", "MINIO_TPU_CERT_FILE": cert,
           "MINIO_TPU_KEY_FILE": tkey,
           "MINIO_TPU_KMS_MASTER_KEY": "chip-smoke:" + master.hex()}
    saved = {k: os.environ.get(k) for k in (*env, "MINIO_TPU_COMPRESS")}
    os.environ.update(env)
    os.environ.pop("MINIO_TPU_COMPRESS", None)
    kmsmod.reset_kms_cache()
    roots = [os.path.join(work, f"ssedisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    host, port = srv.host, srv.port
    if srv.server_mode != "threaded" or not srv.tls:
        fail(f"sse: server plane {srv.server_mode}, tls {srv.tls}")
    t0 = time.monotonic()
    objs = {f"c{c}/o{j}": rng.bytes(S3_BIG)
            for c in range(S3_CLIENTS) for j in range(2)}
    sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}
    text = lineitem_csv(SEED + 8, S3_BIG)
    rows = text.split(b"\n")[1:-1]
    # four 64 MiB lineitem objects: the same rows, rotated by a quarter
    texts = [b"\n".join([LI_HEADER.encode()] + rows[i * len(rows) // 4:]
                        + rows[:i * len(rows) // 4]) + b"\n" for i in range(4)]
    make_s = time.monotonic() - t0
    hdr = ssec_headers(ckey)
    one = S3Signer(host, port, cafile=cert)
    out: dict = {"aead": route, "tls": True, "make_s": make_s}

    def check(st, body, want, what):
        if st != want:
            fail(f"sse: {what}: {st} {body[:300]!r}")

    def launched_since(before: dict) -> dict:
        return {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}

    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        # 0. the same server's TLS without SSE: one plain 64 MiB object
        # a client, PUT then GET, the baseline the SSE sub-phases stand by
        st, _h, body = one.request("PUT", "/plain")
        check(st, body, 200, "bucket create")
        pjobs = [[f"c{c}/o0"] for c in range(S3_CLIENTS)]

        def put_p(signer, key):
            st, _h, body = signer.request("PUT", f"/plain/{key}", body=objs[key],
                                          payload_hash=sha[key].hex())
            check(st, body, 200, f"TLS PUT {key}")
            return key

        def get_p(signer, key):
            st, _h, body = signer.request("GET", f"/plain/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"sse: TLS GET {key}: {st}, body differs from its source")
            return key

        nplain = S3_BIG * len(pjobs)
        pput_wall, _ = _in_clients(host, port, pjobs, put_p, cert)
        pget_wall, _ = _in_clients(host, port, pjobs, get_p, cert)
        out["tls_plain"] = {
            "objects": len(pjobs), "bytes": nplain,
            "put": {"s": pput_wall, "MBps": nplain / pput_wall / 1e6},
            "get": {"s": pget_wall, "MBps": nplain / pget_wall / 1e6},
        }
        # a. SSE-C: 4 clients, two 64 MiB objects each, PUT then GET
        st, _h, body = one.request("PUT", "/ssec")
        check(st, body, 200, "bucket create")
        jobs = [[f"c{c}/o{j}" for j in range(2)] for c in range(S3_CLIENTS)]

        def put_c(signer, key):
            st, h, body = signer.request("PUT", f"/ssec/{key}", body=objs[key],
                                         headers=hdr, payload_hash=sha[key].hex())
            check(st, body, 200, f"SSE-C PUT {key}")
            if h.get("x-amz-server-side-encryption-customer-algorithm") != "AES256":
                fail(f"sse: SSE-C PUT {key} answered headers {h}")
            return key

        def get_c(signer, key):
            st, _h, body = signer.request("GET", f"/ssec/{key}", headers=hdr)
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"sse: SSE-C GET {key}: {st}, body differs from its source")
            return len(body)

        def ranges_c(signer, key):
            size = len(objs[key])
            for lo, n in (*SSE_RANGES, (size - 17, 17)):
                st, _h, body = signer.request("GET", f"/ssec/{key}", headers={
                    **hdr, "range": f"bytes={lo}-{lo + n - 1}"})
                if st != 206 or body != objs[key][lo:lo + n]:
                    fail(f"sse: SSE-C range {lo}+{n} of {key}: {st}")
            return key

        nobj = sum(map(len, objs.values()))
        put_wall, _ = _in_clients(host, port, jobs, put_c, cert)
        get_wall, _ = _in_clients(host, port, jobs, get_c, cert)
        range_wall, _ = _in_clients(host, port, jobs, ranges_c, cert)
        fi = XLStorage(roots[0]).read_version("ssec", "c0/o0")
        if (fi.metadata.get(ssemod.META_SSE) != "C"
                or fi.size != ssemod.stored_size(S3_BIG)):
            fail(f"sse: c0/o0 stored {fi.size} B with {fi.metadata}")
        dist = fi.erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        before = dict(kernels.LAUNCHES)
        for d in dead:
            ol.disks[d] = None
        try:
            t = time.monotonic()
            get_c(one, "c0/o0")
            deg_s = time.monotonic() - t
        finally:
            ol.disks[:] = live
        deg_launch = launched_since(before)
        if not deg_launch.get("gf_matmul_words"):
            fail(f"sse: the degraded SSE-C GET reconstructed nothing: {deg_launch}")
        st, _h, body = one.request("GET", "/ssec/c0/o0", headers=ssec_headers(wrong))
        check(st, body, 403, "GET with a wrong key")
        if b"<Code>AccessDenied</Code>" not in body:
            fail(f"sse: a wrong key answered {body[:200]!r}")
        st, _h, body = one.request("GET", "/ssec/c0/o0")
        check(st, body, 400, "GET without the key")
        out["ssec"] = {
            "objects": len(objs), "bytes": nobj,
            "put": {"s": put_wall, "MBps": nobj / put_wall / 1e6},
            "get": {"s": get_wall, "MBps": nobj / get_wall / 1e6},
            "ranges": {"s": range_wall, "count": 3 * len(objs)},
            "get_degraded_one": {"s": deg_s, "MBps": S3_BIG / deg_s / 1e6,
                                 "offline_disks": dead, "launches": deg_launch},
            "stored_over_actual": fi.size / S3_BIG,
        }

        # b. SSE-S3 by the bucket's default rule: no header on the PUTs
        st, _h, body = one.request("PUT", "/sses3")
        check(st, body, 200, "bucket create")
        st, _h, body = one.request("PUT", "/sses3", {"encryption": ""}, SSE_CONFIG)
        check(st, body, 200, "PUT ?encryption")
        st, _h, body = one.request("GET", "/sses3", {"encryption": ""})
        check(st, body, 200, "GET ?encryption")
        keys3 = sorted(objs)[:SSE_S3_OBJECTS]
        jobs3 = [[k] for k in keys3]

        def put_s3(signer, key):
            st, h, body = signer.request("PUT", f"/sses3/{key}", body=objs[key],
                                         payload_hash=sha[key].hex())
            check(st, body, 200, f"SSE-S3 PUT {key}")
            if h.get("x-amz-server-side-encryption") != "AES256":
                fail(f"sse: SSE-S3 PUT {key} answered headers {h}")
            return key

        def get_s3(signer, key):
            st, h, body = signer.request("GET", f"/sses3/{key}")
            if (st != 200 or hashlib.sha256(body).digest() != sha[key]
                    or h.get("x-amz-server-side-encryption") != "AES256"):
                fail(f"sse: SSE-S3 GET {key}: {st} {h}")
            return key

        n3 = S3_BIG * len(keys3)
        put3_wall, _ = _in_clients(host, port, jobs3, put_s3, cert)
        get3_wall, _ = _in_clients(host, port, jobs3, get_s3, cert)
        st, _h, body = one.request("GET", f"{ADMIN}/kms/key/status")
        check(st, body, 200, "admin kms/key/status")
        status = _json.loads(body)
        if (status.get("encryption"), status.get("decryption")) != ("success", "success"):
            fail(f"sse: kms/key/status {status}")
        meta3 = XLStorage(roots[0]).read_version("sses3", keys3[0]).metadata
        if meta3.get(ssemod.META_SSE) != "S3" or meta3.get(ssemod.META_SSE_KMS_ID) != "chip-smoke":
            fail(f"sse: the bucket default stored {meta3}")
        out["sses3"] = {
            "objects": len(keys3), "bytes": n3,
            "put": {"s": put3_wall, "MBps": n3 / put3_wall / 1e6},
            "get": {"s": get3_wall, "MBps": n3 / get3_wall / 1e6},
            "kms_key_status": status,
        }

        # c. compression: 4 x 64 MiB of lineitem text, one more sealed too
        os.environ["MINIO_TPU_COMPRESS"] = "on"
        st, _h, body = one.request("PUT", "/zip")
        check(st, body, 200, "bucket create")
        zjobs = [[(f"li{i}.csv", i)] for i in range(4)]

        def put_z(signer, job):
            key, i = job
            st, _h, body = signer.request("PUT", f"/zip/{key}", body=texts[i])
            check(st, body, 200, f"compressed PUT {key}")
            return key

        def get_z(signer, job):
            key, i = job
            st, _h, body = signer.request("GET", f"/zip/{key}")
            if st != 200 or body != texts[i]:
                fail(f"sse: compressed GET {key}: {st}, body differs")
            return key

        nz = sum(map(len, texts))
        zput_wall, _ = _in_clients(host, port, zjobs, put_z, cert)
        zget_wall, _ = _in_clients(host, port, zjobs, get_z, cert)
        t = time.monotonic()
        st, _h, body = one.request("PUT", "/zip/li_ssec.csv", body=texts[0],
                                   headers=hdr)
        zc_put_s = time.monotonic() - t
        check(st, body, 200, "compressed+SSE-C PUT")
        stored = {k: XLStorage(roots[0]).read_version("zip", k)
                  for k in ("li0.csv", "li_ssec.csv")}
        for k, f in stored.items():
            if (f.metadata.get("x-internal-compression") != "deflate/v1"
                    or int(f.metadata["x-internal-actual-size"]) != len(texts[0])):
                fail(f"sse: {k} stored with {f.metadata}")
        if stored["li_ssec.csv"].metadata.get(ssemod.META_SSE) != "C":
            fail("sse: li_ssec.csv was not sealed")
        lo = BLOCK + 12_345
        for key, h in (("li0.csv", {}), ("li_ssec.csv", hdr)):
            st, _h, body = one.request("GET", f"/zip/{key}", headers={
                **h, "range": f"bytes={lo}-{lo + 99_999}"})
            if st != 206 or body != texts[0][lo:lo + 100_000]:
                fail(f"sse: compressed range GET of {key}: {st}")
        os.environ.pop("MINIO_TPU_COMPRESS", None)
        # Select Q1 over the compressed and the sealed object, against
        # the host engine's Records over the plain text
        qbody = select_body(SELECT_QUERIES["Q1"])
        os.environ["MINIO_TPU_SELECT"] = "host"
        try:
            spool = io.BytesIO()
            t = time.monotonic()
            S3Select(SelectRequest.from_xml(qbody), dev).evaluate(
                io.BytesIO(texts[0]), len(texts[0]), spool.write)
            host_q1_s = time.monotonic() - t
        finally:
            os.environ.pop("MINIO_TPU_SELECT", None)
        want, _k = select_records(spool.getvalue())
        sel = {"host_plain_s": host_q1_s, "rows": want.count(b"\n")}
        for key, h in (("li0.csv", {}), ("li_ssec.csv", hdr)):
            before = dict(kernels.LAUNCHES)
            t = time.monotonic()
            st, _h, body = one.request("POST", f"/zip/{key}",
                                       {"select": "", "select-type": "2"}, qbody,
                                       headers=h)
            took = time.monotonic() - t
            check(st, body, 200, f"Select Q1 over {key}")
            recs, _k = select_records(body)
            if recs != want or not recs:
                fail(f"sse: Q1 over {key} answered {len(recs)} B, the host "
                     f"engine {len(want)} B")
            sel[key] = {"s": took, "launches": launched_since(before)}
            if not sel[key]["launches"].get("select_screen"):
                fail(f"sse: Q1 over {key} launched {sel[key]['launches']}")
        sizes = {k: (f.size, len(texts[0])) for k, f in stored.items()}
        out["compress"] = {
            "objects": 4, "bytes": nz,
            "put": {"s": zput_wall, "MBps": nz / zput_wall / 1e6},
            "get": {"s": zget_wall, "MBps": nz / zget_wall / 1e6},
            "ssec_put_one": {"s": zc_put_s, "MBps": len(texts[0]) / zc_put_s / 1e6},
            "stored_over_actual": {k: a / b for k, (a, b) in sizes.items()},
            "select_Q1": sel,
        }

        # d. SSE-C multipart: 4 x 8 MiB parts, Complete, a GET across parts
        parts = [objs["c1/o1"][i * MP_PART:(i + 1) * MP_PART]
                 for i in range(SSE_MP_PARTS)]
        whole = b"".join(parts)
        t = time.monotonic()
        st, _h, body = one.request("POST", "/ssec/mp", {"uploads": ""}, headers=hdr)
        check(st, body, 200, "initiate SSE-C upload")
        uid = _xml_text(body, "UploadId")[0]
        etags = []
        for n, data in enumerate(parts, 1):
            st, h, body = one.request("PUT", "/ssec/mp",
                                      {"partNumber": str(n), "uploadId": uid},
                                      body=data, headers=hdr)
            check(st, body, 200, f"SSE-C part {n}")
            etags.append(h["etag"].strip('"'))
        st, _h, body = one.request("POST", "/ssec/mp", {"uploadId": uid},
                                   _complete_body(etags))
        check(st, body, 200, "Complete of the SSE-C upload")
        mp_s = time.monotonic() - t
        lo = MP_PART - 100
        st, _h, body = one.request("GET", "/ssec/mp", headers={
            **hdr, "range": f"bytes={lo}-{lo + 199}"})
        if st != 206 or body != whole[lo:lo + 200]:
            fail(f"sse: GET across the SSE-C upload's part boundary: {st}")
        st, _h, body = one.request("GET", "/ssec/mp", headers=hdr)
        if st != 200 or body != whole:
            fail(f"sse: GET of the SSE-C upload: {st}")
        mpmeta = XLStorage(roots[0]).read_version("ssec", "mp").metadata
        if mpmeta.get(ssemod.META_SSE_PARTS) != "1,2,3,4":
            fail(f"sse: the upload stored {mpmeta}")
        out["multipart"] = {"parts": len(parts), "bytes": len(whole),
                            "s": mp_s, "MBps": len(whole) / mp_s / 1e6}

        # e. CopyObject SSE-C -> SSE-S3, then heal of an SSE-C object
        t = time.monotonic()
        st, _h, body = one.request("PUT", "/sses3/copied", headers={
            "x-amz-copy-source": "/ssec/c2/o0", **ssec_headers(ckey, True),
            "x-amz-server-side-encryption": "AES256"})
        copy_s = time.monotonic() - t
        check(st, body, 200, "CopyObject SSE-C -> SSE-S3")
        st, h, body = one.request("GET", "/sses3/copied")
        if (st != 200 or hashlib.sha256(body).digest() != sha["c2/o0"]
                or h.get("x-amz-server-side-encryption") != "AES256"):
            fail(f"sse: GET of the copy: {st} {h}")
        hfi = XLStorage(roots[0]).read_version("ssec", "c3/o1")
        victim = hfi.erasure.distribution.index(1)  # the disk of shard 1
        before_files = part_files(roots[victim], "ssec", "c3/o1")
        shutil.rmtree(os.path.join(roots[victim], "ssec", "c3", "o1"))
        before = dict(kernels.LAUNCHES)
        t = time.monotonic()
        healed = ol.heal_object("ssec", "c3/o1")
        heal_s = time.monotonic() - t
        heal_launch = launched_since(before)
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if not heal_launch.get(name):
                fail(f"sse: heal launched {heal_launch}, no {name}")
        if healed.get("healed") != [0] or part_files(
                roots[victim], "ssec", "c3/o1") != before_files:
            fail(f"sse: heal of c3/o1 {healed}: the part file differs")
        get_c(one, "c3/o1")
        out["copy"] = {"bytes": S3_BIG, "s": copy_s, "MBps": S3_BIG / copy_s / 1e6}
        out["heal"] = {"s": heal_s, "launches": heal_launch}
        out["phase_s"] = time.monotonic() - t_phase
        launches = dict(kernels.LAUNCHES)
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        srv.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        kmsmod.reset_kms_cache()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words",
                 "verify_reconstruct_pipelined", "encode_pack[group=0]",
                 "select_screen", "select_positions", "select_spans[row]"):
        if launches[name] <= 0:
            fail(f"sse: kernel {name} never launched")
    # K1 runs only as heal's re-encode (group=0; its launches count
    # under both names), and no mxu kernel runs
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail(f"sse: K1 launched with the pack leg: {launches}")
    if launches["encode_pack_pipelined[mxu]"]:
        fail("sse: kernel encode_pack_pipelined[mxu] launched")
    out["plain_s3_MBps"] = {"put": s3["put_concurrent"]["MBps"],
                            "get": s3["get_concurrent"]["MBps"]}
    out["host_alone"] = host_transform_rates(objs["c0/o0"], texts[0])
    out["stages"] = stats["stages"]
    out["launches"] = {k: v for k, v in launches.items() if v}
    return out


# -- phase 10: the server as users start it -----------------------------------

BOOT_DRIVES = 24  # two EC 8+4 sets
BOOT_SPEC = "disk{1...24}"
BOOT_WIPE_LIVE = 5  # drive of set 0, wiped while the server runs
BOOT_WIPE_DOWN = 17  # drive of set 1, wiped while it is down
BOOT_READY_S = 300.0  # spawn to ready, CUDA start and library load included
BOOT_HEAL_S = 180.0
ADMIN = "/minio-tpu/admin/v1"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drive_files(root: str, bucket: str) -> dict:
    """{path under the bucket: sha256} of every file one drive holds for
    the bucket (xl.meta and part files), read straight from the disk."""
    import hashlib

    out = {}
    base = os.path.join(root, bucket)
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                with open(path, "rb") as f:
                    out[os.path.relpath(path, base)] = hashlib.sha256(
                        f.read()).hexdigest()
            except OSError:
                continue
    return out


def _wipe_drive(root: str) -> None:
    """A replaced drive: the mount point stays, its contents are gone."""
    for entry in os.listdir(root):
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)


class _BootedServer:
    """``python -m minio_tpu_torch.server`` in a process of its own (never
    a fork of this one, which holds a CUDA context); its output goes to a
    log file read back at the end."""

    def __init__(self, work: str, port: int, env: dict, tag: str):
        self.port = port
        self.log_path = os.path.join(work, f"server-{tag}.log")
        self._log = open(self.log_path, "w")
        here = os.path.dirname(os.path.abspath(__file__))
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", "--parity",
             str(M), "--address", f"127.0.0.1:{port}",
             os.path.join(work, "boot", BOOT_SPEC)],
            cwd=here, env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def wait_ready(self) -> float:
        """Seconds from spawn until /minio/health/ready answers 200."""
        import http.client

        deadline = self.t_spawn + BOOT_READY_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                fail(f"boot phase: the server exited {self.proc.returncode}: "
                     f"{self.output()[-2000:]}")
            try:
                conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                  timeout=5)
                conn.request("GET", "/minio/health/ready")
                status = conn.getresponse().status
                conn.close()
                if status == 200:
                    return time.monotonic() - self.t_spawn
            except OSError:
                pass
            time.sleep(0.05)
        fail(f"boot phase: not ready within {BOOT_READY_S} s")

    def output(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()

    def sigterm(self) -> float:
        """SIGTERM; seconds until the process exits (0 expected)."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.kill()
            fail("boot phase: the server did not exit on SIGTERM")
        took = time.monotonic() - t0
        out = self.output()
        if rc != 0 or "shutdown complete" not in out.splitlines()[-1:]:
            fail(f"boot phase: SIGTERM exit {rc}: {out[-2000:]}")
        return took

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._log.close()


def boot_phase(work: str, payloads: list, backend: "str | None" = None) -> dict:
    """Phase 10: the port's real entry point.  ``python -m
    minio_tpu_torch.server --parity 4`` over 24 temp-dir drives (two EC
    8+4 sets, 10 MiB blocks) on the async plane and the card (neither
    MINIO_TPU_SERVER nor MINIO_ERASURE_BACKEND set; ``backend`` sets the
    latter for a rehearsal on the CPU), the fresh-disk monitor every
    second.  Boot, traffic of 4 SigV4 clients, a drive wiped while the
    server runs and healed back, an admin heal, SIGTERM, then a restart
    over the same drives with another drive wiped while it was down."""
    import hashlib
    import json as _json

    import numpy as np

    from minio_tpu_torch.objectlayer.sets import crc_hash_mod

    roots = [os.path.join(work, "boot", f"disk{i}")
             for i in range(1, BOOT_DRIVES + 1)]
    per_set = BOOT_DRIVES // 2
    env = {k: v for k, v in os.environ.items()
           if k not in ("MINIO_TPU_SERVER", "MINIO_ERASURE_BACKEND")}
    env["MINIO_TPU_FRESH_DISK_INTERVAL_S"] = "1"
    env["MINIO_TPU_LOG_LEVEL"] = "warning"
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    rng = np.random.default_rng(SEED + 9)
    objs = {f"c{c}/big{j}": rng.bytes(S3_BIG)
            for c in range(S3_CLIENTS) for j in range(2)}
    objs["obj4"] = payloads[4]  # the 10 MiB + 17 B object
    sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}
    set_of = {k: crc_hash_mod(k, 2) for k in objs}
    if set(set_of.values()) != {0, 1}:
        fail(f"boot phase: the objects do not cover both sets: {set_of}")
    out: dict = {"drives": BOOT_DRIVES, "sets": 2, "objects": len(objs)}
    servers: list = []

    def admin(signer, method, tail, query=None, want=200):
        st, _h, body = signer.request(method, f"{ADMIN}/{tail}", query)
        if st != want:
            fail(f"boot phase: admin {method} {tail}: {st} {body[:300]!r}")
        return _json.loads(body) if body else {}

    def stats(signer) -> dict:
        return admin(signer, "GET", "kernel-stats")

    def step_delta(a: dict, b: dict) -> dict:
        pa, pb = a["device_passes"], b["device_passes"]
        return {
            "device_passes": {k: pb[k] - pa.get(k, 0) for k in pb
                              if pb[k] != pa.get(k, 0)},
            "flushes": b["batch"]["flushes"] - a["batch"]["flushes"],
            "jobs": b["batch"]["jobs"] - a["batch"]["jobs"],
            "multi_client_flushes": (b["batch"]["multi_client_flushes"]
                                     - a["batch"]["multi_client_flushes"]),
            "wait_seconds": b["batch"]["wait_seconds"]
            - a["batch"]["wait_seconds"],
        }

    def boot(tag: str) -> "tuple[_BootedServer, float]":
        srv = _BootedServer(work, _free_port(), env, tag)
        servers.append(srv)
        return srv, srv.wait_ready()

    def wait_files(root: str, want: dict, t0: float, what: str) -> float:
        """Seconds from ``t0`` until ``root`` holds exactly ``want``."""
        while time.monotonic() - t0 < BOOT_HEAL_S:
            if _drive_files(root, "boot") == want:
                return time.monotonic() - t0
            time.sleep(0.1)
        got = _drive_files(root, "boot")
        fail(f"boot phase: {what}: {len(got)} of {len(want)} files back, "
             f"{sum(got.get(k) == v for k, v in want.items())} equal")

    def get_all(host, port) -> "tuple[float, int]":
        def get(signer, key):
            st, _h, body = signer.request("GET", f"/boot/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"boot phase: GET {key}: {st}, body differs from its source")
            return len(body)

        keys = sorted(objs)
        wall, sizes = _in_clients(host, port,
                                  [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)],
                                  get)
        return wall, sum(sizes)

    t_phase = time.monotonic()
    try:
        os.makedirs(os.path.join(work, "boot"), exist_ok=True)
        # -- 1. boot -------------------------------------------------------
        srv, out["ready_s"] = boot("first")
        host, port = "127.0.0.1", srv.port
        fmts = []
        for r in roots:
            with open(os.path.join(r, ".sys", "format.json")) as f:
                fmts.append(_json.load(f))
        dep = {f["id"] for f in fmts}
        layout = {(len(f["erasure"]["sets"]), len(f["erasure"]["sets"][0]))
                  for f in fmts}
        if len(dep) != 1 or layout != {(2, per_set)}:
            fail(f"boot phase: format.json ids {dep}, layouts {layout}")
        for i, f in enumerate(fmts):
            if f["erasure"]["this"] != f["erasure"]["sets"][i // per_set][i % per_set]:
                fail(f"boot phase: drive {i + 1} is not in its slot")
        deployment = dep.pop()
        one = S3Signer(host, port)
        loops = admin(one, "GET", "loops/status")
        if loops["mode"] != "async" or not loops["count"]:
            fail(f"boot phase: loops/status {loops}")
        si = admin(one, "GET", "storageinfo")["zones"][0]
        if (si["disks"], si["online"]) != (BOOT_DRIVES, BOOT_DRIVES):
            fail(f"boot phase: storageinfo {si}")
        out["loops"] = loops["count"]
        out["reuseport"] = loops["reuseport"]
        st, _h, body = one.request("PUT", "/boot")
        if st != 200:
            fail(f"boot phase: bucket create {st} {body[:200]!r}")

        # -- 2. traffic: 4 clients PUT 8 x 64 MiB + the 10 MiB + 17 B at once
        def put(signer, key):
            st, _h, body = signer.request("PUT", f"/boot/{key}", body=objs[key],
                                          payload_hash=sha[key].hex())
            if st != 200:
                fail(f"boot phase: PUT {key}: {st} {body[:200]!r}")
            return len(objs[key])

        keys = sorted(objs)
        s0 = stats(one)
        put_wall, put_sizes = _in_clients(
            host, port, [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)], put)
        s1 = stats(one)
        # a write that missed drives queued its object for MRF heal: let
        # the heal routine finish, then every drive of the object's set
        # must hold it
        t0 = time.monotonic()
        while admin(one, "GET", "background-heal/status")["nodes"][0]["queued"]:
            if time.monotonic() - t0 > BOOT_HEAL_S:
                fail("boot phase: the MRF queue did not drain")
            time.sleep(0.1)
        short = {}
        for k, s in set_of.items():
            lacking = [d for d in range(s * per_set, (s + 1) * per_set)
                       if not os.path.exists(os.path.join(roots[d], "boot", k,
                                                          "xl.meta"))]
            if lacking:
                short[k] = lacking
                admin(one, "POST", "heal", {"bucket": "boot", "object": k})
        held = {s: sum(1 for d in range(s * per_set, (s + 1) * per_set)
                       for k in objs if os.path.exists(
                           os.path.join(roots[d], "boot", k, "xl.meta")))
                for s in (0, 1)}
        want_held = {s: per_set * sum(1 for v in set_of.values() if v == s)
                     for s in (0, 1)}
        if held != want_held:
            fail(f"boot phase: shards by set {held}, want {want_held}")
        get_wall, get_bytes = get_all(host, port)
        s2 = stats(one)

        # -- 3. a drive of set 0 replaced while the server runs ------------
        live = roots[BOOT_WIPE_LIVE - 1]
        before_live = _drive_files(live, "boot")
        set0 = sorted(k for k, s in set_of.items() if s == 0)
        if {p.split("/xl.meta")[0] for p in before_live if p.endswith("xl.meta")} != set(set0):
            fail("boot phase: drive 5 does not hold every set-0 object")
        t0 = time.monotonic()
        _wipe_drive(live)
        live_heal_s = wait_files(live, before_live, t0,
                                 f"drive {BOOT_WIPE_LIVE} healed back")
        with open(os.path.join(live, ".sys", "format.json")) as f:
            doc = _json.load(f)
        if (doc["id"], doc["erasure"]["this"]) != (
                deployment, fmts[BOOT_WIPE_LIVE - 1]["erasure"]["this"]):
            fail("boot phase: the wiped drive was stamped with another identity")
        s3 = stats(one)

        # -- 4. admin heal of one deleted shard file of a set-1 object -----
        victim = sorted(k for k, s in set_of.items() if s == 1)[0]
        vroot = roots[per_set + 3]
        vfiles = {p: h for p, h in _drive_files(vroot, "boot").items()
                  if p.startswith(victim + "/") and "part." in p}
        if not vfiles:
            fail(f"boot phase: drive {per_set + 4} lacks {victim}'s part file")
        vpath = sorted(vfiles)[0]
        os.remove(os.path.join(vroot, "boot", vpath))
        t0 = time.monotonic()
        res = admin(one, "POST", "heal", {"bucket": "boot", "object": victim})
        admin_heal_s = time.monotonic() - t0
        if _drive_files(vroot, "boot").get(vpath) != vfiles[vpath]:
            fail(f"boot phase: admin heal of {victim} left {vpath} {res}")
        s4 = stats(one)
        one.close()

        # -- 5. SIGTERM ------------------------------------------------------
        out["sigterm_s"] = [srv.sigterm()]
        first_out = srv.output()

        # -- 6. a drive of set 1 replaced while the server is down ---------
        down = roots[BOOT_WIPE_DOWN - 1]
        before_down = _drive_files(down, "boot")
        _wipe_drive(down)
        srv, ready2 = boot("restart")
        t_ready = time.monotonic()
        port = srv.port
        with open(os.path.join(down, ".sys", "format.json")) as f:
            doc = _json.load(f)
        if (doc["id"], doc["erasure"]["this"]) != (
                deployment, fmts[BOOT_WIPE_DOWN - 1]["erasure"]["this"]):
            fail("boot phase: the restart did not stamp drive 17 into its slot")
        one = S3Signer(host, port)
        r0 = stats(one)
        down_heal_s = wait_files(down, before_down, t_ready,
                                 f"drive {BOOT_WIPE_DOWN} healed back")
        r1 = stats(one)
        get2_wall, _ = get_all(host, port)
        r2 = stats(one)

        # -- 7. one S3 Select (Q1) on the restarted server -----------------
        sel_data = lineitem_csv(SEED + 16, SELECT_ROW_OBJECT)
        for method, path, body in (("PUT", "/bootsel", b""),
                                   ("PUT", "/bootsel/lineitem.csv", sel_data)):
            st, _h, got = one.request(method, path, body=body)
            if st != 200:
                fail(f"boot phase: {method} {path}: {st} {got[:200]!r}")
        t0 = time.monotonic()
        st, _h, got = one.request("POST", "/bootsel/lineitem.csv",
                                  {"select": "", "select-type": "2"},
                                  select_body(SELECT_QUERIES["Q1"]))
        sel_s = time.monotonic() - t0
        if st != 200:
            fail(f"boot phase: select Q1: {st} {got[:300]!r}")
        recs = select_records(got)[0]
        from minio_tpu_torch.s3select.engine import run_select

        frames: list = []
        os.environ["MINIO_TPU_SELECT"] = "host"
        try:
            run_select(select_body(SELECT_QUERIES["Q1"]), sel_data, frames.append,
                       device="cpu")
        finally:
            os.environ.pop("MINIO_TPU_SELECT", None)
        if not recs or recs != select_records(b"".join(frames))[0]:
            fail("boot phase: select Q1 differs from the host engine's answer")
        prom = _prom_select(one)
        if prom.get('miniotpu_select_requests_total{engine="device"}', 0) < 1:
            fail(f"boot phase: select Q1 ran on no device engine: {prom}")
        out["select_Q1"] = {"bytes": len(sel_data), "records_bytes": len(recs),
                            "s": sel_s, "prometheus": prom}
        one.close()
        out["sigterm_s"].append(srv.sigterm())
        restart_out = srv.output()
    finally:
        for s in servers:
            s.kill()
    for name, text in (("first", first_out), ("restart", restart_out)):
        lines = text.splitlines()
        if not any("(bootstrapping)" in ln for ln in lines) or not any(
                ln.startswith("minio-tpu serving 1 zone(s) [24] drives") for ln in lines):
            fail(f"boot phase: the {name} boot's lines: {lines[:6]}")
    nput = sum(put_sizes)
    out.update({
        "phase_s": time.monotonic() - t_phase,
        "ready_s": [out["ready_s"], ready2],
        "deployment_kept": True,
        "put_concurrent": {"bytes": nput, "s": put_wall,
                           "MBps": nput / put_wall / 1e6},
        "get_concurrent": {"bytes": get_bytes, "s": get_wall,
                           "MBps": get_bytes / get_wall / 1e6},
        "get_after_restart": {"bytes": get_bytes, "s": get2_wall,
                              "MBps": get_bytes / get2_wall / 1e6},
        "heal_live": {"drive": BOOT_WIPE_LIVE, "files": len(before_live),
                      "objects": len(set0), "s": live_heal_s},
        "heal_down": {"drive": BOOT_WIPE_DOWN, "files": len(before_down),
                      "s_after_ready": down_heal_s},
        "admin_heal": {"object": victim, "file": vpath, "s": admin_heal_s,
                       "healed": res.get("healed")},
        "short_writes": short,
        "steps": {
            "put": step_delta(s0, s1), "get": step_delta(s1, s2),
            "heal_live": step_delta(s2, s3), "admin_heal": step_delta(s3, s4),
            "heal_down": step_delta(r0, r1), "get_after_restart": step_delta(r1, r2),
        },
    })
    return out


# ---------------------------------------------------------------------------
# slice 6: S3 Select (K8-K11 and the select sub-phase)
# ---------------------------------------------------------------------------

# TPC-H lineitem (TPC-H specification 4.2.3): 16 fields, "|" delimiter,
# a header row, no trailing delimiter, rows in l_orderkey order as dbgen
# writes them (sparse keys 1-7, 32-39, ...; 1-7 lines an order).  Text
# fields hold words only, as TPC-H's text grammar does: no quote and no
# digit, so no chunk is a hazard under a numeric compare's sci guard.
_LI_WORDS = (
    "furiously carefully quickly slyly blithely fluffily ironic regular "
    "express final pending special even bold silent unusual idle close "
    "ruthless permanent daring busy deposits packages accounts requests "
    "instructions theodolites pinto beans foxes ideas dependencies excuses "
    "platelets asymptotes courts dolphins multipliers sauternes warhorses "
    "frets dinos attainments somas tithes sheaves decoys across above "
    "against along among around after at before behind beneath beside "
    "besides between beyond by during inside into near of on outside over "
    "past since through throughout to toward under until up upon via with "
    "within without haggle nag wake sleep detect integrate cajole use "
    "boost affix engage grow sublate are").split()
_LI_INSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
_LI_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
LI_HEADER = (
    "l_orderkey|l_partkey|l_suppkey|l_linenumber|l_quantity|"
    "l_extendedprice|l_discount|l_tax|l_returnflag|l_linestatus|"
    "l_shipdate|l_commitdate|l_receiptdate|l_shipinstruct|l_shipmode|"
    "l_comment")
SELECT_OBJECT = 256 << 20  # 8 DEV_CHUNKs, about 2.1 M rows
SELECT_ROW_OBJECT = 16 << 20  # the `row` engine's comparison object
# Q1 row-anchored and selective (K8, K9, K10 [row]); Q2 field-anchored,
# about 1/7 of rows (K10 [back]); Q3 a numeric compare the screen cannot
# discriminate (13-14 candidates a row: past _MAX_CANDS in a 32 MiB
# chunk, so `overflow` on every chunk); Q4 a string compare half the rows
# match (`ratio` on every chunk)
SELECT_QUERIES = {
    "Q1": "SELECT * FROM S3Object s WHERE s.l_orderkey < 1000",
    "Q2": ("SELECT s.l_orderkey, s.l_extendedprice FROM S3Object s "
           "WHERE s.l_shipmode = 'AIR'"),
    "Q3": "SELECT s.l_orderkey FROM S3Object s WHERE s.l_quantity < 24",
    "Q4": "SELECT s.l_orderkey FROM S3Object s WHERE s.l_linestatus = 'O'",
}
SELECT_FALLBACK = {"Q1": None, "Q2": None, "Q3": "overflow", "Q4": "ratio"}


def lineitem_csv(seed: int, nbytes: int) -> bytes:
    """About ``nbytes`` (whole rows, at most nbytes) of lineitem rows from
    ``seed``: keys, part, supplier and line numbers per row; the other
    twelve fields of each row drawn from 65,536 rows made from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.datetime64("1992-01-02")
    cutoff = int((np.datetime64("1995-06-17") - base).astype(int))
    T = 1 << 16
    qty = rng.integers(1, 51, T)
    price = (90000 + rng.integers(0, 20001, T)) * qty  # cents
    disc = rng.integers(0, 11, T)
    tax = rng.integers(0, 9, T)
    ship = rng.integers(1, 2526, T)
    commit = ship + rng.integers(-60, 61, T)
    receipt = ship + rng.integers(1, 31, T)
    rflag = np.where(receipt <= cutoff,
                     np.where(rng.integers(0, 2, T) == 1, "R", "A"), "N")
    lstat = np.where(ship > cutoff, "O", "F")

    def day(x):
        return np.datetime_as_string(base + x.astype("timedelta64[D]")).tolist()

    ins = np.array(_LI_INSTRUCT)[rng.integers(0, 4, T)]
    mode = np.array(_LI_MODES)[rng.integers(0, 7, T)]
    comments = []
    for _ in range(T):
        n = int(rng.integers(10, 44))
        words: list = []
        while sum(map(len, words)) + len(words) < n:
            words.append(_LI_WORDS[int(rng.integers(len(_LI_WORDS)))])
        comments.append(" ".join(words)[:n].rstrip())
    tails = [
        f"{q}|{g // 100}.{g % 100:02d}|0.{h:02d}|0.{t:02d}|{rf}|{ls}|{s1}|{s2}"
        f"|{s3}|{si}|{sm}|{cm}\n"
        for q, g, h, t, rf, ls, s1, s2, s3, si, sm, cm in zip(
            qty.tolist(), price.tolist(), disc.tolist(), tax.tolist(),
            rflag.tolist(), lstat.tolist(), day(ship), day(commit),
            day(receipt), ins.tolist(), mode.tolist(), comments)
    ]
    avg = sum(map(len, tails)) / T + 22
    R = int(nbytes / avg * 1.02) + 16
    lines = rng.integers(1, 8, R // 4 + 8)
    lines = lines[:int(np.searchsorted(np.cumsum(lines), R)) + 1]
    i = np.arange(1, len(lines) + 1)
    okey = np.repeat(((i >> 3) << 5) + (i & 7), lines)  # dbgen's mk_sparse
    lnum = np.arange(len(okey)) - np.repeat(np.cumsum(lines) - lines, lines) + 1
    part = rng.integers(1, 200001, len(okey))
    supp = rng.integers(1, 10001, len(okey))
    pick = rng.integers(0, T, len(okey)).tolist()
    body = "".join([LI_HEADER, "\n"] + [
        f"{a}|{b}|{c}|{e}|{tails[p]}" for a, b, c, e, p in zip(
            okey.tolist(), part.tolist(), supp.tolist(), lnum.tolist(), pick)
    ]).encode()
    return body[:body.rfind(b"\n", 0, nbytes) + 1]


def select_body(expr: str, fd: str = "|") -> bytes:
    """A SelectObjectContentRequest over CSV with a header row."""
    from xml.sax.saxutils import escape

    return (
        "<SelectObjectContentRequest>"
        f"<Expression>{escape(expr)}</Expression>"
        "<ExpressionType>SQL</ExpressionType><InputSerialization><CSV>"
        f"<FileHeaderInfo>USE</FileHeaderInfo><FieldDelimiter>{fd}"
        "</FieldDelimiter></CSV></InputSerialization>"
        f"<OutputSerialization><CSV><FieldDelimiter>{fd}</FieldDelimiter>"
        "</CSV></OutputSerialization></SelectObjectContentRequest>"
    ).encode()


def select_records(body: bytes) -> "tuple[bytes, list]":
    """(the Records payloads joined, the event types) of an EventStream
    response."""
    from minio_tpu_torch.s3select.message import decode_all

    msgs = decode_all(body)
    kinds = [m["headers"].get(":event-type") for m in msgs]
    if not kinds or kinds[-1] != "End" or "Stats" not in kinds:
        fail(f"select: the response's events are {kinds[-4:]}")
    return b"".join(m["payload"] for m, k in zip(msgs, kinds)
                    if k == "Records"), kinds


def screen_ops(atoms, anchor: str, sci_guard: bool) -> int:
    """Integer instructions per word of the screen: the JAX package's
    expression, each distinct shifted view W(k) and terminator / digit
    flag set counted once (memoized there too), every u64 operator (and,
    or, xor, not, add, sub, shift; a three-input and-not-and is one)
    two 32-bit instructions, a view W(k) with k % 8 != 0 two (two funnel
    shifts build its two halves), a popcount two; the block sums'
    shuffles and the scalars' reductions are left out."""
    seen: set = set()
    u64 = 0
    views = 0

    def view(k):
        nonlocal views
        if ("w", k) not in seen:
            seen.add(("w", k))
            views += 2 if k % 8 else 0

    def term(k):
        nonlocal u64
        if ("t", k) not in seen:
            seen.add(("t", k))
            view(k)
            u64 += 3 + 3 + 1  # two swar_eq, or

    def digit(k):
        nonlocal u64
        if ("d", k) not in seen:
            seen.add(("d", k))
            view(k)
            u64 += 3 + 3 + 1  # two swar_ge, and-not

    for branch in atoms:
        for atom in branch:
            kind = atom[0]
            if kind == "len":
                for ln in range(atom[1], atom[2] + 1):
                    term(ln + 1)
                    u64 += 1
            elif kind == "deep":
                for i in range(1, atom[1] + 1):
                    term(i)
                    u64 += 1
                u64 += 1
            elif kind == "byte0":
                view(1)
                u64 += 3 + 3 + 1 + (2 if atom[1] == 0 else 0)
            elif kind == "nd":
                for i in range(1, atom[1] + 1):
                    term(i)
                    digit(i)
                    u64 += 4
            else:
                lit, mode = atom[1], atom[2]
                n = min(len(lit), 8)
                for i in range(n):
                    view(i + 1)
                    if mode in ("lt", "le"):
                        term(i + 1)
                        u64 += 8
                    elif mode in ("gt", "ge"):
                        term(i + 1)
                        u64 += 7
                    u64 += 4  # pref &= swar_eq
                term(n + 1)
                u64 += 2
            u64 += 1  # the branch's and
        u64 += 1  # the or of branches
    view(0)
    u64 += 3  # newline flags
    if anchor == "field":
        term(0)
    view(1)
    u64 += 3 + 3 + 4 + 3 + 3  # base and, quote, bare CR, NUL, ors
    if sci_guard:
        digit(-1)
        u64 += 3 + 3 + 3
    return 2 * u64 + views + 2 * 2 + 4  # the two popcounts and the packing


def _positions_bytes(cum, cap: int) -> int:
    """Bytes extract_positions must read for ranks 0..cap-1: the 32-byte
    sectors of ``cum`` that the binary searches (searchsorted, side
    right) and the base reads touch, and the 64-byte candidate block of
    each rank, each counted once; the positions written out besides."""
    import numpy as np

    cum = cum.cpu().numpy()
    nblk = len(cum)
    k = np.arange(cap)
    lo, hi = np.zeros(cap, np.int64), np.full(cap, nblk, np.int64)
    read = []
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        read.append(mid[act])
        right = act & (cum[np.minimum(mid, nblk - 1)] <= k)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)
    b = np.minimum(lo, nblk - 1)
    read.append(b[b > 0] - 1)
    sectors = len(np.unique(np.concatenate(read) // 8))
    return 32 * sectors + 64 * len(np.unique(b)) + 4 * cap


def _span_scanned(arr, anchors, window: int, back: bool) -> int:
    """Bytes the span function must look at for these anchors: up to and
    including the newline it finds, the whole window where none."""
    from minio_tpu_torch.ops import select_step as ss

    fn = ss.anchors_back_plain if back else ss.row_spans_plain
    off, found = fn(arr, anchors, window=window)
    if back:
        off = anchors.long() - off.long()
    n = (off.long() + 1).clamp(max=window)
    return int(n.masked_fill(~found, window).sum().item())


def select_programs(rng) -> dict:
    """The screens check_select_kernels holds K8 to, by label: Q1-Q4, an
    IN list of 16 options field and row anchored, one of 150 (more records
    than a launch passes by value), every atom kind under both anchors
    (sci guard off and on), and one program for each lookahead of 1-6
    words."""
    from minio_tpu_torch.s3select import device as sdev, sql

    header = LI_HEADER.split("|")

    def screen(where: str):
        return sdev.compile_screen(sql.parse(
            f"SELECT * FROM S3Object s WHERE {where}").where, header)

    progs = {q: sdev.compile_screen(sql.parse(t).where, header)
             for q, t in SELECT_QUERIES.items()}
    keys = ", ".join(str(int(k)) for k in rng.integers(1, 200000, 16))
    progs["IN16 field"] = screen(f"s.l_partkey IN ({keys})")
    progs["IN16 row"] = screen(f"s.l_orderkey IN ({keys})")
    many = ", ".join(str(int(k)) for k in rng.integers(1, 200000, 150))
    progs["IN150 field"] = screen(f"s.l_partkey IN ({many})")
    kinds = ((("len", 1, 3), ("byte0", 48, 57)), (("deep", 5), ("nd", 7)),
             (("lex", b"1000", "lt"),), (("lex", b"TAKE BACK RETURN", "le"),),
             (("lex", b"MAIL", "eq"),), (("lex", b"1997-09", "ge"),),
             (("lex", b"SHIP", "gt"),), (("byte0", 0, 50), ("len", 0, 0)))
    progs["kinds row"] = sdev._Screen(kinds, "row", False)
    progs["kinds field sci"] = sdev._Screen(kinds, "field", True)
    for q in range(1, 7):  # q words read offsets up to 8q - 1
        progs[f"lookahead {q}"] = sdev._Screen(
            ((("len", 0, 8 * q - 2),), (("nd", 8 * q - 1),),
             (("deep", 8 * q - 3), ("lex", b"12", "ge"))), "field", q % 2 == 0)
    return progs


def check_select_kernels(dev, rng) -> dict:
    """K8-K11 against their plain versions on the card, at the select
    path's shapes: a 32 MiB lineitem chunk (one DEV_CHUNK) under the
    programs of ``select_programs``; a hazard chunk (a quote, a bare CR);
    the SWAR-borrow planes (within a word's half, and from lane 3 into
    lane 4); positions of every program's candidates; row spans at the
    three windows and backward anchors over the lineitem chunk and over a
    plane of rows 10-6,000 bytes wide (found and not found, the chunk
    start); gathers at 4-4,096-byte windows, at every start alignment and
    plane offset, clamped at both ends of the plane.  Times each at the
    path's shape beside its bound and its plain version (K8 under Q1, Q2
    and the IN list's field screen; K11 also at one row, the launch's
    fixed chain); K9 and K11 also beside the PyTorch calls that compute
    the same function (K9: ``torch.nonzero`` of the candidate bytes)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import select_step as ss
    from minio_tpu_torch.s3select import device as sdev, sql

    fd, qc = ord("|"), ord('"')
    data = lineitem_csv(SEED + 14, sdev.DEV_CHUNK)
    header = LI_HEADER.split("|")
    plane = sdev.host_plane(data, dev)
    nbytes = plane.numel()
    progs = select_programs(rng)
    if {ss.screen_program(p.atoms).q for p in progs.values()} != set(range(1, 7)):
        fail("select kernels: the programs miss a lookahead of 1-6 words")
    if ss.screen_program(progs["IN150 field"].atoms).nrec <= ss._PARAM_RECS:
        fail("select kernels: the IN150 program fits the launch's parameters")
    for kind in ("len", "deep", "byte0", "nd", "lex"):
        if not any(a[0] == kind for p in progs.values() for b in p.atoms
                   for a in b):
            fail(f"select kernels: no program holds a {kind} atom")
    if len(progs["IN16 field"].atoms) < 16:
        fail("select kernels: the IN program has fewer than 16 branches")
    # a hazard chunk: a quote in one row, a bare CR in another
    hz = bytearray(data[:4 << 20])
    hz[1000] = qc
    hz[2_000_001] = 13
    hazard = sdev.host_plane(bytes(hz), dev)
    borrow = sdev.host_plane(b"a,b\n1,-5\n22,7\n", dev)
    # a ``,`` at byte 3 of a word, ``-`` (``,`` ^ 1) at byte 4: the borrow
    # from lane 3 into lane 4, across the word's 32-bit halves
    borrow34 = sdev.host_plane(b"xyz,-a,b\n,-1,22\n" * 8, dev)

    def screen(arr, scr, fdb=fd, fn=ss.screen_chunk):
        return fn(arr, fd=fdb, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                  sci_guard=scr.sci_guard)

    def screen_plain(arr, scr, fdb=fd):
        return screen(arr, scr, fdb, ss.screen_chunk_plain)

    err = 0
    counts = {}
    outs = {}
    for label, scr in progs.items():
        got = screen(plane, scr)
        want = screen_plain(plane, scr)
        e = same(got, want)
        if e:
            fail(f"select_screen differs from its plain version under {label}")
        err = max(err, e)
        outs[label] = got
        counts[label] = {"rows": int(got[2].item()), "cands": int(got[1].sum().item()),
                         "hazard": bool(got[3].item())}
        if counts[label]["hazard"]:
            fail(f"select_screen: the lineitem chunk is a hazard under {label}")
        for hlabel, arr in (("hazard", hazard),):
            g, w = screen(arr, scr), screen_plain(arr, scr)
            if same(g, w) or not bool(g[3].item()):
                fail(f"select_screen on the hazard chunk under {label}: "
                     f"hazard {bool(g[3].item())}")
    bscr = sdev._Screen(((("deep", 2),),), "field", False)
    g = screen(borrow, bscr, ord(","))
    if same(g, screen_plain(borrow, bscr, ord(","))):
        fail("select_screen differs from its plain version on the borrow plane")
    flags = np.unpackbits(g[0].cpu().numpy().view(np.uint8), bitorder="little")
    if (np.flatnonzero(flags) // 8).tolist() != [8, 13]:
        fail(f"select_screen: borrow plane flags {np.flatnonzero(flags) // 8}")
    g = screen(borrow34, bscr, ord(","))
    if same(g, screen_plain(borrow34, bscr, ord(","))):
        fail("select_screen differs from its plain version across a word's halves")
    flags = np.flatnonzero(np.unpackbits(g[0].cpu().numpy().view(np.uint8),
                                         bitorder="little")) // 8
    if 3 in flags.tolist() or 16 + 3 in flags.tolist():
        fail(f"select_screen: the lane 3 -> 4 borrow lost, flags {flags[:8]}")
    # the reference's own numbers on the chunk: Q1 flags keys of up to 4
    # digits, Q2 the AIR rows, Q3 past _MAX_CANDS, Q4 past the ratio cap
    nrows = data.count(b"\n")
    if counts["Q1"]["rows"] != nrows:
        fail(f"select_screen: {counts['Q1']['rows']} rows, the chunk has {nrows}")
    if counts["Q3"]["cands"] <= sdev._MAX_CANDS or not (
            nrows * sdev._RATIO_CAP < counts["Q4"]["cands"] <= sdev._MAX_CANDS):
        fail(f"select_screen: Q3/Q4 candidate counts {counts}")
    res: dict = {}

    # K8 timed under Q1 (the selective row screen) and Q2
    def k8_row(label):
        scr = progs[label]
        nw = nbytes // 8
        bms, by = bound(2 * nbytes + nbytes // 16,
                        nw * screen_ops(scr.atoms, scr.anchor, scr.sci_guard))
        return dict(
            ms=cuda_ms(lambda: screen(plane, scr), 20),
            plain_ms=cuda_ms(lambda: screen_plain(plane, scr), 3, 1),
            bound_ms=bms, bound_by=by, shape=[nbytes], program=label,
            records=ss.screen_program(scr.atoms).nrec, lookahead=ss.screen_program(scr.atoms).q,
            int_ops_per_word=screen_ops(scr.atoms, scr.anchor, scr.sci_guard),
            **device_times(lambda: screen(plane, scr)))

    res["select_screen"] = dict(max_abs_err=err, **k8_row("Q1"))
    res["select_screen"]["Q2"] = k8_row("Q2")
    res["select_screen"]["IN16 field"] = k8_row("IN16 field")

    # --- K9 positions -------------------------------------------------------
    err = 0
    pos = {}
    for label, (cand, blk, _n, _h) in outs.items():
        count = counts[label]["cands"]
        if not count or count > sdev._MAX_CANDS:
            continue
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        cap = 1 << max(6, (count - 1).bit_length())
        # the whole output: the ranks past the count go on to K10 [back]
        got = ss.extract_positions(cand, cum, cap=cap)
        want = ss.extract_positions_plain(cand, cum, cap=cap)
        e = same((got,), (want,))
        if e:
            fail(f"select_positions differs from its plain version under {label}")
        err = max(err, e)
        pos[label] = got[:count]
    if "Q1" not in pos or "Q2" not in pos:
        fail("select_positions: Q1 or Q2 has no candidates")
    cand, blk = outs["Q1"][0], outs["Q1"][1]
    cum = torch.cumsum(blk, 0, dtype=torch.int32)
    count = counts["Q1"]["cands"]
    cap = 1 << max(6, (count - 1).bit_length())
    nblk = cum.numel()
    steps = max(1, nblk.bit_length())
    bms, by = bound(_positions_bytes(cum, cap), cap * (4 * steps + 8 * 6 + 6 * 11))

    # the one PyTorch call that computes the same positions: every
    # candidate byte is 0x80 (_HI's lanes), so its nonzero bytes are the
    # positions in rank order (the call syncs: it sizes its output)
    def nonzero():
        return torch.nonzero(cand.view(torch.uint8)).flatten()[:count]

    flagged = cand.view(torch.uint8)
    if not bool(((flagged == 0) | (flagged == 0x80)).all().item()):
        fail("select_positions: a candidate byte other than 0x80")
    if not torch.equal(nonzero().to(torch.int32), pos["Q1"]):
        fail("select_positions: torch.nonzero's positions differ from K9's")
    res["select_positions"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ss.extract_positions(cand, cum, cap=cap), 20),
        plain_ms=cuda_ms(lambda: ss.extract_positions_plain(cand, cum, cap=cap), 3, 1),
        library_ms=cuda_ms(nonzero, 20),
        bound_ms=bms, bound_by=by, shape=[cap, nblk], program="Q1",
        **device_times(lambda: ss.extract_positions(cand, cum, cap=cap)))

    # --- K10 spans ------------------------------------------------------------
    wide_rows = []
    for n in rng.integers(10, 6000, 1500):
        wide_rows.append(b"w" * int(n) + b"\n")
    wide = sdev.host_plane(b"".join(wide_rows), dev)
    nl = torch.nonzero(plane[:len(data)] == 10).flatten().to(torch.int32)
    wnl = torch.nonzero(wide == 10).flatten().to(torch.int32)
    mids = torch.from_numpy(rng.integers(0, wide.numel(), 4096).astype(np.int32)).to(dev)
    err_row = err_back = 0
    for window in (256, 1024, 4096):
        for label, arr, anchors in (
                ("Q1", plane, torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                                         pos["Q1"]])),
                ("every row", plane, torch.cat([torch.tensor([-1], dtype=torch.int32,
                                                             device=dev), nl])),
                ("wide rows", wide, torch.cat([torch.tensor([-1], dtype=torch.int32,
                                                            device=dev), wnl])),
                ("wide mid-row", wide, mids)):
            e = same(ss.row_spans(arr, anchors, window=window),
                     ss.row_spans_plain(arr, anchors, window=window))
            if e:
                fail(f"select_spans[row] differs from its plain version: {label}, "
                     f"window {window}")
            err_row = max(err_row, e)
    for label, arr, hits in (("Q2", plane, pos["Q2"]), ("wide mid-row", wide, mids),
                             ("chunk start", plane,
                              torch.arange(0, 2048, 7, dtype=torch.int32, device=dev))):
        for window in (1024, 256):
            got = ss.anchors_back(arr, hits, window=window)
            e = same(got, ss.anchors_back_plain(arr, hits, window=window))
            if e:
                fail(f"select_spans[back] differs from its plain version: {label}")
            err_back = max(err_back, e)
    wf = ss.row_spans(wide, torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                                       wnl]), window=256)[1]
    if bool(wf.all().item()) or not bool(wf.any().item()):
        fail("select_spans[row]: the wide plane found every row or none at 256")
    q1a = torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev), pos["Q1"]])
    C = q1a.numel()
    bms, by = bound(9 * C + _span_scanned(plane, q1a, 256, False),
                    2 * _span_scanned(plane, q1a, 256, False))
    res["select_spans[row]"] = dict(
        max_abs_err=err_row, ms=cuda_ms(lambda: ss.row_spans(plane, q1a, window=256), 20),
        plain_ms=cuda_ms(lambda: ss.row_spans_plain(plane, q1a, window=256), 3, 1),
        bound_ms=bms, bound_by=by, shape=[C, 256], program="Q1",
        **device_times(lambda: ss.row_spans(plane, q1a, window=256)))
    q2h = pos["Q2"]
    C = q2h.numel()
    scanned = _span_scanned(plane, q2h, sdev._BACK_WINDOW, True)
    bms, by = bound(9 * C + scanned, 2 * scanned)
    res["select_spans[back]"] = dict(
        max_abs_err=err_back,
        ms=cuda_ms(lambda: ss.anchors_back(plane, q2h, window=sdev._BACK_WINDOW), 20),
        plain_ms=cuda_ms(lambda: ss.anchors_back_plain(plane, q2h,
                                                       window=sdev._BACK_WINDOW), 3, 1),
        bound_ms=bms, bound_by=by, shape=[C, sdev._BACK_WINDOW], program="Q2",
        **device_times(lambda: ss.anchors_back(plane, q2h, window=sdev._BACK_WINDOW)))

    # --- K11 gather -------------------------------------------------------------
    err = 0
    ends = torch.from_numpy(np.concatenate([
        rng.integers(nbytes - 300, nbytes, 64), rng.integers(-300, 0, 16),
        [0, -1, nbytes - 1, nbytes]]).astype(np.int32)).to(dev)
    cases = [(256, plane, q1a + 1), (64, plane, ends), (4096, wide, mids[:512]),
             (64, plane, torch.zeros(0, dtype=torch.int32, device=dev))]
    # every start alignment and plane offset, windows off the 16-byte chunk
    for off in (1, 3, 8, 13):
        for window in (4, 12, 36, 64, 256):
            cases.append((window, plane[off:], torch.cat([ends, q1a[:512] + 1])))
    for window, arr, starts in cases:
        e = same((ss.gather_rows(arr, starts, window=window),),
                 (ss.gather_rows_plain(arr, starts, window=window),))
        if e:
            fail(f"select_gather differs from its plain version at window {window}")
        err = max(err, e)
    starts = q1a + 1
    C = starts.numel()
    idx = (starts.long()[:, None] + torch.arange(256, device=dev)[None, :]).clamp(
        0, nbytes - 1)
    bms, by = bound(4 * C + 2 * C * 256, 3 * C * 256)
    res["select_gather"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ss.gather_rows(plane, starts, window=256), 20),
        plain_ms=cuda_ms(lambda: ss.gather_rows_plain(plane, starts, window=256), 3, 1),
        library_ms=cuda_ms(lambda: plane[idx], 20),
        bound_ms=bms, bound_by=by, shape=[C, 256], program="Q1",
        **device_times(lambda: ss.gather_rows(plane, starts, window=256)))
    one = starts[:1].clone()
    res["select_gather"]["one_row"] = dict(
        ms=cuda_ms(lambda: ss.gather_rows(plane, one, window=256), 20),
        **device_times(lambda: ss.gather_rows(plane, one, window=256)))
    res["select_screen"]["counts"] = counts
    torch.cuda.synchronize()
    return res


def _prom_select(signer) -> dict:
    """The miniotpu_select_* samples of the server's Prometheus page."""
    st, _h, body = signer.request("GET", "/minio-tpu/prometheus/metrics")
    if st != 200:
        fail(f"select: Prometheus answered {st}")
    out = {}
    for line in body.decode().splitlines():
        if line.startswith("miniotpu_select_"):
            name, _sp, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def select_phase(dev, work: str) -> dict:
    """Phase 9 (slice 6): S3 Select pushdown on the port's S3Server
    (threaded plane) over a fresh ErasureObjects on the card (12 disks,
    EC 8+4, 10 MiB blocks).  A 256 MiB TPC-H lineitem CSV (about 2.1 M
    rows, 8 DEV_CHUNKs) PUT with SigV4, then Q1-Q4 through POST
    ?select&select-type=2 under the default engine (auto: the device
    screen) and under MINIO_TPU_SELECT=host, whose Records must be byte
    identical; Q1 on a 16 MiB object of the same shape against the
    ``row`` engine; Q1 with the disks of shards 1, 3, 10 and 12 offline;
    Q1 and Q2 from 4 clients at once; the Select families in Prometheus;
    ``DeviceScan.run_device`` over ``as_device_plane`` of the object's
    10 MiB blocks on the card.  K8-K11 must launch, the fallbacks match
    SELECT_FALLBACK, and the counters move."""
    import torch

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels, select_step as ss
    from minio_tpu_torch.s3select import device as sdev
    from minio_tpu_torch.s3select.engine import S3Select, SelectRequest
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"seldisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"select: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    t0 = time.monotonic()
    big = lineitem_csv(SEED + 6, SELECT_OBJECT)
    small = lineitem_csv(SEED + 16, SELECT_ROW_OBJECT)
    out: dict = {"object_bytes": len(big), "rows": big.count(b"\n") - 1,
                 "row_object_bytes": len(small), "make_s": time.monotonic() - t0}
    one = S3Signer(host, port)
    os.environ.pop("MINIO_TPU_SELECT", None)
    try:
        st, _h, body = one.request("PUT", "/sel")
        if st != 200:
            fail(f"select: bucket create {st} {body[:200]!r}")
        for key, data in (("lineitem.csv", big), ("lineitem16.csv", small)):
            t0 = time.monotonic()
            st, _h, body = one.request("PUT", f"/sel/{key}", body=data)
            if st != 200:
                fail(f"select: PUT {key}: {st} {body[:200]!r}")
            out.setdefault("put_s", {})[key] = time.monotonic() - t0
        kernels.reset_launches()
        KERNEL_STATS.reset()
        sdev.STATS.reset()
        t_phase = time.monotonic()

        def post(signer, key, q, mode=None):
            """(records, seconds, STATS delta) of one request."""
            if mode:
                os.environ["MINIO_TPU_SELECT"] = mode
            try:
                s0 = sdev.STATS.snapshot()
                t = time.monotonic()
                st, _h, body = signer.request(
                    "POST", f"/sel/{key}", {"select": "", "select-type": "2"},
                    select_body(SELECT_QUERIES[q]))
                took = time.monotonic() - t
                s1 = sdev.STATS.snapshot()
            finally:
                os.environ.pop("MINIO_TPU_SELECT", None)
            if st != 200:
                fail(f"select: {q} on {key} ({mode or 'auto'}): {st} {body[:300]!r}")
            recs, _kinds = select_records(body)
            delta = {
                "requests": {k: v - s0["requests"][k] for k, v in s1["requests"].items()
                             if v != s0["requests"][k]},
                "fallbacks": {k: v - s0["fallbacks"][k] for k, v in s1["fallbacks"].items()
                              if v != s0["fallbacks"][k]},
                "device_seconds": s1["device_seconds"] - s0["device_seconds"],
                "screened": {k: v - s0["screened"][k]
                             for k, v in s1["screened"].items()},
            }
            return recs, took, delta

        queries: dict = {}
        answers: dict = {}
        chunks = -(-len(big) // sdev.DEV_CHUNK)
        for q in SELECT_QUERIES:
            before = dict(kernels.LAUNCHES)
            recs, took, delta = post(one, "lineitem.csv", q)
            launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                        if v != before[k]}
            hrecs, htook, hdelta = post(one, "lineitem.csv", q, "host")
            if recs != hrecs:
                fail(f"select: {q}'s device answer differs from the host engine's "
                     f"({len(recs)} and {len(hrecs)} bytes)")
            if not recs:
                fail(f"select: {q} answered no rows")
            want = SELECT_FALLBACK[q]
            want_fb = {want: chunks} if want else {}
            if (delta["requests"] != {"device": 1} or delta["fallbacks"] != want_fb
                    or delta["screened"]["chunks"] != chunks):
                fail(f"select: {q}'s engines, fallbacks and screened chunks {delta}, "
                     f"want {want_fb} and {chunks} chunks")
            if hdelta["requests"] != {"host": 1}:
                fail(f"select: {q} under host ran {hdelta}")
            answers[q] = recs
            queries[q] = {
                "records_bytes": len(recs), "rows": recs.count(b"\n"),
                "device": {"s": took, "MBps": len(big) / took / 1e6,
                           "device_seconds": delta["device_seconds"],
                           "screened": delta["screened"],
                           "fallbacks": delta["fallbacks"], "launches": launched},
                "host": {"s": htook, "MBps": len(big) / htook / 1e6},
            }
        for q, k in (("Q1", ("select_screen", "select_positions", "select_spans[row]")),
                     ("Q2", ("select_screen", "select_positions", "select_spans[back]",
                             "select_spans[row]"))):
            if any(not queries[q]["device"]["launches"].get(n) for n in k):
                fail(f"select: {q} launched {queries[q]['device']['launches']}")
        # Q1 against the row engine, on 16 MiB
        recs, took, _d = post(one, "lineitem16.csv", "Q1")
        rrecs, rtook, rdelta = post(one, "lineitem16.csv", "Q1", "row")
        if recs != rrecs or rdelta["requests"] != {"row": 1}:
            fail(f"select: Q1 on 16 MiB differs from the row engine ({rdelta})")
        out["row_check"] = {"bytes": len(small), "records_bytes": len(recs),
                            "device_s": took, "row_s": rtook,
                            "row_MBps": len(small) / rtook / 1e6}
        # Q1 with 4 disks offline: the GET reconstructs (K3)
        dist = XLStorage(roots[0]).read_version("sel", "lineitem.csv").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            k3 = kernels.LAUNCHES["gf_matmul_words"]
            recs, took, _d = post(one, "lineitem.csv", "Q1")
            if kernels.LAUNCHES["gf_matmul_words"] <= k3 or recs != answers["Q1"]:
                fail("select: Q1 with 4 disks offline reconstructed nothing or differs")
        finally:
            ol.disks[:] = live
        out["degraded_Q1"] = {"s": took, "MBps": len(big) / took / 1e6,
                              "offline_disks": dead}
        # Q1 and Q2 from 4 clients at once
        jobs = [[("Q1",), ("Q2",)] for _ in range(S3_CLIENTS)]

        def job(signer, j):
            recs, took, _d = post(signer, "lineitem.csv", j[0])
            if recs != answers[j[0]]:
                fail(f"select: a concurrent {j[0]} differs from its single answer")
            return took

        wall, tooks = _in_clients(host, port, jobs, job)
        out["concurrent"] = {"clients": S3_CLIENTS, "requests": len(tooks),
                             "wall_s": wall,
                             "MBps": len(tooks) * len(big) / wall / 1e6,
                             "max_request_s": max(tooks)}
        # the Select families
        prom = _prom_select(one)
        snap = sdev.STATS.snapshot()
        want_dev = len(SELECT_QUERIES) + 1 + 1 + 2 * S3_CLIENTS
        if (prom.get('miniotpu_select_requests_total{engine="device"}') != want_dev
                or prom.get('miniotpu_select_fallback_total{reason="ratio"}')
                != chunks
                or prom.get("miniotpu_select_scanned_bytes_total", 0)
                < want_dev * len(big) // 2
                or prom.get("miniotpu_select_device_seconds_total", 0) <= 0):
            fail(f"select: Prometheus {prom}, want {want_dev} device requests")
        out["prometheus"] = prom
        # the device-resident plane: run_device over as_device_plane of the
        # object's 10 MiB blocks on the card (K11)
        buf = torch.frombuffer(bytearray(big), dtype=torch.uint8).to(dev)
        blocks = [buf[i:i + BLOCK] for i in range(0, len(big), BLOCK)]
        before = dict(kernels.LAUNCHES)
        t = time.monotonic()
        plane, nbytes = sdev.as_device_plane(blocks, len(big), dev)
        frames: list = []
        sel = S3Select(SelectRequest.from_xml(select_body(SELECT_QUERIES["Q1"])), dev)
        sel.evaluate(None, len(big), frames.append, device_source=(plane, nbytes))
        took = time.monotonic() - t
        recs, _k = select_records(b"".join(frames))
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        if recs != answers["Q1"] or not launched.get("select_gather"):
            fail(f"select: run_device over the resident plane: {len(recs)} bytes, "
                 f"launches {launched}")
        out["run_device_Q1"] = {"s": took, "MBps": len(big) / took / 1e6,
                                "launches": launched}
        del plane, buf, blocks
        out["phase_s"] = time.monotonic() - t_phase
        out["launches"] = dict(kernels.LAUNCHES)
        out["stats"] = sdev.STATS.snapshot()
        out["queries"] = queries
        out["batch"] = KERNEL_STATS.snapshot()["batch"]
        for name in (*ss.LAUNCH_NAMES, "phash256_batched", "gf_matmul_words"):
            if not out["launches"].get(name):
                fail(f"select: {name} never launched in the select sub-phase")
    finally:
        one.close()
        srv.shutdown()
    return out


# the TPU function each kernel replaces: encode_pack_fused (P4),
# encode_hash_fused (P2, which encode_pack computes without the pack
# leg), phash256_words_batched (left to XLA), matmul_words (P1),
# verify_reconstruct_fused (P5), the pipelined P6 and P7, the XLA
# sub-chunk steps of the async overlap chain (X2, X3), gf_matmul_mxu (P3),
# P4-P7 under the mxu formulation, and the XLA functions of S3 Select's
# device scan (X4-X7, select_step.py); and the phase whose counters each
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
    "select_screen": ("minio_tpu/ops/select_step.py:184", "select"),
    "select_positions": ("minio_tpu/ops/select_step.py:323", "select"),
    "select_spans[row]": ("minio_tpu/ops/select_step.py:358", "select"),
    "select_spans[back]": ("minio_tpu/ops/select_step.py:371", "select"),
    "select_gather": ("minio_tpu/ops/select_step.py:387", "select"),
}


_KERNEL_NAME = re.compile(
    r"(encode_pipelined_mxu_kernel|encode_pipelined_kernel|"
    r"verify_reconstruct_pipelined_kernel|"
    r"encode_kernel|encode_mxu_kernel|pack_kernel|phash_kernel|"
    r"gf_matmul_mxu_kernel|gf_matmul_kernel|verify_reconstruct_mxu_kernel|"
    r"verify_reconstruct_kernel|screen_kernel|positions_kernel|spans_kernel|"
    r"gather_kernel)"
    r"(?:I((?:L[ib]\d+E)+)E)?"
)


def kernel_label(mangled: str) -> str:
    """A kernel's name with its template buckets in <> (swar or mxu for
    the formulation), from its mangled name."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return mangled
    name = m.group(1)
    if name == "spans_kernel" and m.group(2):  # <BACK>
        return name + ("<back>" if m.group(2) == "Lb1E" else "<row>")
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
# <8,4,mxu>) and with every row present (<16,8,swar>, <16,4,mxu>), K8 at
# each lookahead (screen_kernel<Q>; an older copy's is one screen_kernel),
# K9, both K10 forms (spans_kernel<row>, <back>), K11 and K7 at (o, s) =
# (4, 8) (gf_matmul_mxu_kernel<8,4>, <SB,OB>; an older copy's is
# gf_matmul_mxu_kernel<4>, <MB>).  An older copy's
# K4 is verify_reconstruct_kernel<16,8> (swar) and
# verify_reconstruct_mxu_kernel<PB,RB>.
SASS_KERNELS = ("phash_kernel", "verify_reconstruct_pipelined",
                "encode_kernel<8,4,", "encode_mxu_kernel<8,4", "gf_matmul_kernel",
                "gf_matmul_mxu_kernel<4>", "gf_matmul_mxu_kernel<8,4>",
                "encode_pipelined_kernel<8,4,", "encode_pipelined_mxu_kernel<8,4,",
                "verify_reconstruct_kernel<16,8", "verify_reconstruct_kernel<8,8,swar>",
                "verify_reconstruct_kernel<8,4,mxu>", "verify_reconstruct_kernel<16,4,mxu>",
                "verify_reconstruct_mxu_kernel<8,4>", "verify_reconstruct_mxu_kernel<16,4>",
                "screen_kernel", "positions_kernel", "spans_kernel", "gather_kernel")


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
    one such chunk at word offset 65,536 (not the last: no finalize); K7
    at (4, 8, 1,310,720) bytes under the parity matrix and the 4 x 8
    reconstruction rows (``k7_recon_matrix``) and at one tile, K3 on the
    same bytes as words, and K7's phases (``k7_phases``) where the copy
    records them.  Every result is first held bit for bit against the
    plain version
    (the X3 chain's digests against the whole row's, its data once per
    copy); then cuda_ms and device_times of each."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, hash as phash, rs

    heal, every = PATTERNS["data+parity missing"], PATTERNS["all present"]
    idx = tuple(i for i, p in enumerate(heal) if p)[:K]
    rmat = gf.reconstruction_matrix(K, M, idx)
    pm, r4 = gf.parity_matrix(K, M), k7_recon_matrix()
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
        # K7 at the codec's shape under the parity matrix and the 4 x 8
        # reconstruction rows, at one tile (its fixed chain), and K3 on the
        # same bytes as words (its swar twin)
        x7 = torch.from_numpy(rng.integers(0, 256, (K, BLOCK // K), dtype=np.uint8)).to(dev)
        w7 = x7.view(torch.int32)[None]
        t7 = x7[:, :1024].contiguous()
        for label, mat, x in (("K7 parity (4, 8, 1310720)", pm, x7),
                              ("K7 recon (4, 8, 1310720)", r4, x7),
                              ("K7 one tile (4, 8, 1024)", pm, t7)):
            cases[label] = (lambda kern=kern, mat=mat, x=x: kern.gf_matmul_mxu(mat, x),
                            lambda mat=mat, x=x: (rs.gf_matmul_mxu_plain(mat, x),))
        cases["K3 parity (1, 8, 327680) on K7's bytes"] = (
            lambda kern=kern: kern.gf_matmul_words(pm, w7, tuple(range(K))),
            lambda: (rs.gf_matmul_words(pm, w7, tuple(range(K))),))
        for label, (fn, plain) in cases.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            if same(got, plain()):
                fail(f"{label} of copy {name} differs from its plain version")
            rows.append({"turn": turn, "copy": name, "case": label,
                         "events_ms": cuda_ms(fn, 20, 3), **device_times(fn)})
        phases = k7_phases(kern, pm, x7)
        if phases is not None:
            rows.append({"turn": turn, "copy": name, "case": "K7 parity phases", **phases})
        torch.cuda.synchronize()
    return rows


def compare_select_copies(dev, mods: dict, order: list) -> list:
    """K8-K11 of several copies of the port (``mods``: name -> kernels
    module; each copy's ``ops.select_step``) in turns (``order``), at the
    select path's shapes: K8 on the 32 MiB lineitem chunk under Q1, Q2,
    the IN list's field screen and the programs of lookahead 3 and 6
    (``select_programs``; the latter two past the register memo); K9 at
    Q1's cap (the whole output) and Q2's; K10 ``[row]`` at Q1's anchors
    (256-byte windows) and ``[back]`` at Q2's hits (1,024); K11 at Q1's
    gather (the chunk's Q1 rows, 256-byte windows) and at one row (the
    fixed chain).  Every result is first held bit for bit against the
    plain version; then cuda_ms and device_times of each."""
    import importlib

    import numpy as np
    import torch

    from minio_tpu_torch.ops import select_step as ss
    from minio_tpu_torch.s3select import device as sdev

    rng = np.random.default_rng(SEED)
    progs = select_programs(rng)
    data = lineitem_csv(SEED + 14, sdev.DEV_CHUNK)
    plane = sdev.host_plane(data, dev)
    fd, qc = ord("|"), ord('"')
    # Q1's and Q2's candidates and positions, from the plain versions: K9's
    # inputs, the anchors and hits K10 scans from and the starts K11 gathers
    cands = {}
    for q in ("Q1", "Q2"):
        scr = progs[q]
        cand, blk, _n, _h = ss.screen_chunk_plain(
            plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
            sci_guard=scr.sci_guard)
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        count = int(cum[-1].item())
        cap = 1 << max(6, (count - 1).bit_length())
        cands[q] = (cand, cum, cap, ss.extract_positions_plain(cand, cum, cap=cap)[:count])
    pos, hits = cands["Q1"][3], cands["Q2"][3]
    anchors = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), pos])
    starts = anchors + 1
    one = starts[:1].clone()
    rows = []
    for turn, name in enumerate(order):
        sel = importlib.import_module(mods[name].__package__ + ".select_step")
        cases = {}
        for label in ("Q1", "Q2", "IN16 field", "lookahead 3", "lookahead 6"):
            scr = progs[label]
            cases[f"K8 {label} (32 MiB)"] = (
                lambda sel=sel, scr=scr: sel.screen_chunk(
                    plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                    sci_guard=scr.sci_guard),
                lambda scr=scr: ss.screen_chunk_plain(
                    plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                    sci_guard=scr.sci_guard))
        for q, (cand, cum, cap, _p) in cands.items():
            cases[f"K9 {q} ({cap}, {cum.numel()})"] = (
                lambda sel=sel, cand=cand, cum=cum, cap=cap: (
                    sel.extract_positions(cand, cum, cap=cap),),
                lambda cand=cand, cum=cum, cap=cap: (
                    ss.extract_positions_plain(cand, cum, cap=cap),))
        cases[f"K10 row Q1 ({anchors.numel()}, 256)"] = (
            lambda sel=sel: sel.row_spans(plane, anchors, window=256),
            lambda: ss.row_spans_plain(plane, anchors, window=256))
        cases[f"K10 back Q2 ({hits.numel()}, {sdev._BACK_WINDOW})"] = (
            lambda sel=sel: sel.anchors_back(plane, hits, window=sdev._BACK_WINDOW),
            lambda: ss.anchors_back_plain(plane, hits, window=sdev._BACK_WINDOW))
        for label, st in ((f"K11 Q1 ({starts.numel()}, 256)", starts),
                          ("K11 one row (1, 256)", one)):
            cases[label] = (
                lambda sel=sel, st=st: (sel.gather_rows(plane, st, window=256),),
                lambda st=st: (ss.gather_rows_plain(plane, st, window=256),))
        for label, (fn, plain) in cases.items():
            if same(fn(), plain()):
                fail(f"{label} of copy {name} differs from its plain version")
            rows.append({"turn": turn, "copy": name, "case": label,
                         "events_ms": cuda_ms(fn, 20, 3), **device_times(fn)})
        idx = (starts.long()[:, None] + torch.arange(256, device=dev)[None, :]).clamp(
            0, plane.numel() - 1)
        rows.append({"turn": turn, "copy": "library", "case": "plane[idx] Q1",
                     "events_ms": cuda_ms(lambda: plane[idx], 20, 3)})
        torch.cuda.synchronize()
    return rows


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "--parent", metavar="DIR",
        help="another copy of the port (DIR/__init__.py, DIR/ops, DIR/csrc): "
             "build it too and time its K1-K7 and K8-K11 beside this "
             "checkout's, in turns parent, new, new, parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from concurrent.futures import ThreadPoolExecutor

    from minio_tpu_torch.ops import kernels, select_step

    dev = torch.device("cuda", 0)
    # the plain mxu product is a float32 matmul of 0/1 values: keep it in
    # full float32 (exact either way: counts <= 128, 0/1 exact in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"rates: {json.dumps(int_rate())}", flush=True)
    copies = {"new": kernels}
    if args.parent:
        copies["parent"] = load_copy(args.parent)
    t0 = time.monotonic()
    # every copy's library at once, each with one nvcc per source
    with ThreadPoolExecutor(len(copies)) as pool:
        libs = dict(zip(copies, pool.map(lambda m: m.build(), copies.values())))
    build_s = time.monotonic() - t0
    for name, lib in libs.items():
        info = copies[name].BUILD_INFO
        print(f"build {name}: {build_s:.2f} s (this library "
              f"{info.get('seconds', 0.0):.2f} s; nvcc per source "
              f"{json.dumps(info.get('sources', {}))}) -> "
              f"{os.path.relpath(lib, here)}", flush=True)
        for line in ptxas_summary(info.get("log", "")):
            print("  ptxas:", line)
        print(f"  sass: {json.dumps(sass_loops(lib, kernels))}", flush=True)

    import numpy as np

    # wall seconds of each phase of this run (the script's own clock)
    phases_s = {"build": build_s}
    mark = time.monotonic()

    def lap(name: str) -> None:
        nonlocal mark
        now = time.monotonic()
        phases_s[name] = now - mark
        mark = now

    rng = np.random.default_rng(SEED)
    kres = check_kernels(dev, rng)
    kres.update(check_heal_kernels(dev, rng))
    kres.update(check_overlap_kernels(dev, rng))
    kres.update(check_mxu_kernels(dev, rng))
    kres.update(check_select_kernels(dev, rng))
    lap("kernel_checks")
    for name, r in kres.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    if args.parent:
        print(f"compare card: {card_name()}", flush=True)
        order = ["parent", "new", "new", "parent"]
        for row in compare_copies(dev, copies, order):
            print(f"compare: {json.dumps(row)}", flush=True)
        for row in compare_select_copies(dev, copies, order):
            print(f"compare: {json.dumps(row)}", flush=True)
    lap("compare")
    xfer = transfer_ms(dev)
    print(f"transfers: {json.dumps(xfer)}", flush=True)
    lap("transfers")

    # the main path and heal run under the default mode
    os.environ.pop("MINIO_TPU_CODEC_OVERLAP", None)
    work = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        payloads, written, mp = main_path(dev, work)
        print(f"main path: {json.dumps(mp)}", flush=True)
        lap("main_path")
        hp = heal_phase(dev, work, payloads)
        print(f"heal: {json.dumps(hp)}", flush=True)
        lap("heal")
        mo = modes_phase(dev, work, payloads, written, MODE_RUNS)
        lap("modes")
        mx = modes_phase(dev, work, payloads, written, MXU_RUNS)
        lap("mxu")
        # phases 7, 8, 8b and 9 serve in this process on the threaded plane;
        # the boot phase's server takes the default (async)
        os.environ["MINIO_TPU_SERVER"] = "threaded"
        s3 = s3_phase(dev, work, payloads, written, mp)
        lap("s3")
        s3mp = s3_mp_phase(dev, work, payloads)
        lap("s3_mp")
        sse = sse_phase(dev, work, s3)
        lap("sse")
        sel = select_phase(dev, work)
        lap("select")
        os.environ.pop("MINIO_TPU_SERVER", None)
        bt = boot_phase(work, payloads)
        lap("boot")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, by_run in (("mode", mo), ("mxu phase", mx)):
        for (formulation, mode), runs in by_run.items():
            for i, r in enumerate(runs):
                print(f"{label} {formulation} {mode} run {i + 1}: {json.dumps(r)}",
                      flush=True)
    print(f"s3: {json.dumps(s3)}", flush=True)
    print(f"s3_mp: {json.dumps(s3mp)}", flush=True)
    print(f"sse: {json.dumps(sse)}", flush=True)
    print(f"select: {json.dumps(sel)}", flush=True)
    print(f"boot: {json.dumps(bt)}", flush=True)
    print(f"phases_s: {json.dumps(phases_s)}", flush=True)
    phase_launches = {
        "main": mp["launches"], "heal": hp["launches"],
        "off": mo[("swar", "off")][0]["launches"],
        "async": mo[("swar", "async")][0]["launches"],
        "mxu off": mx[("mxu", "off")][0]["launches"],
        "mxu pipeline": mx[("mxu", "pipeline")][0]["launches"],
        "select": sel["launches"],
    }

    line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "minio_tpu_torch/csrc/" + (
                    "select.cu" if name in select_step.LAUNCH_NAMES else "codec.cu"),
                "replaces": replaces,
                "launches": phase_launches[phase].get(name, 0),
                "max_abs_err": kres[name]["max_abs_err"],
                "ms": kres[name]["ms"],
                "plain_ms": kres[name]["plain_ms"],
                "bound_ms": kres[name]["bound_ms"],
                "bound_by": kres[name]["bound_by"],
                "library_ms": kres[name].get("library_ms"),
                **{key: kres[name][key] for key in ("device_ms", "host_us", "cold_ms")
                   if key in kres[name]},
            }
            for name, (replaces, phase) in REPLACES.items()
        ]
    }
    print(json.dumps(line), flush=True)
    print(card_name(), flush=True)
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
