#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. Builds the CUDA kernels from ``minio_tpu_torch/csrc`` with nvcc.
2. Holds each kernel bit-exactly against its plain PyTorch version on the
   card, at the main path's shapes (EC 8+4, 10 MiB blocks: 327,680 words
   per shard) and at ragged ones, and times kernel, plain version and the
   bound (bytes or operations at the card's published peaks).
3. Drives the main path through the object layer: 12 temp-dir disks, EC
   8+4, 10 MiB blocks; PUT four 64 MiB objects and one of 10 MiB + 17
   bytes, GET each healthy and again with 4 disks offline (data-shard
   disks among them), compares every body with its source, compares the
   part files of the 10 MiB + 17 object with those the same port writes
   on the CPU, and checks that every kernel launched during that run.
4. Prints the kernels JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the result lines, when there is no CUDA device or
when any phase fails.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# 32-bit arithmetic outside the tensor cores: the float32 rate of the
# H100 data sheet, the ceiling used for the integer XOR/shift/multiply
# chains these kernels run
PEAK_OPS_PER_S = 67e12

K, M, N = 8, 4, 12
BLOCK = 10 * 1024 * 1024
W = BLOCK // K // 4  # 327,680 words per shard
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


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# operation counts per element (32-bit integer ops): mix32 is 3 shifts,
# 3 xors and 2 multiplies; the key adds a multiply and an add; one
# hashed word is two (op + multiply + mix32) plus the two folding xors;
# one xtime is 2 ands, 2 shifts, a multiply and an xor
_MIX, _KEY, _HASH, _XTIME = 8, 10, 22, 6


def gf_ops(matrix) -> int:
    """Ops of one column of a GF product: the xtime chains plus one xor
    per selected power."""
    from minio_tpu_torch.ops import rs

    chain = sum(max(b - 1, 0) for b in rs.need_bits(matrix))
    terms = sum(bin(int(v)).count("1") for v in matrix.reshape(-1))
    return _XTIME * chain + terms


def rand_words(rng, shape, device):
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def max_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


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
    )

    # --- K2 phash256_batched ---------------------------------------------
    err = 0
    for R, w in [(32, W), (8, W), (3, 8), (12, 4104), (16, 131072)]:
        x = rand_words(rng, (R, w), dev)
        got = kernels.phash256_batched(x, 4 * w)
        torch.cuda.synchronize()
        want = phash.phash256_words_batched(x, 4 * w)
        e = max_err(got, want)
        if e or not torch.equal(got, want):
            fail(f"phash256_batched differs from its plain version at {R, w}")
        err = max(err, e)
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
    bms, by = bound(4 * (R * W + R * 8), R * W * (_KEY + _HASH))
    results["phash256_batched"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[R, W],
    )

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
    B = 4
    x = rand_words(rng, (B, N, W), dev)
    ms = cuda_ms(lambda: kernels.gf_matmul_words(rm, x, rows), 20)
    plain_ms = cuda_ms(lambda: rs.gf_matmul_words(rm, x, rows), 3, 1)
    bms, by = bound(4 * (B * K * W + B * K * W), B * W * gf_ops(rm))
    results["gf_matmul_words"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[B, N, W],
    )
    return results


def transfer_ms(dev) -> dict:
    """Host<->device copies of one main-path batch, as the backend does
    them (pageable numpy memory): 4 blocks of data in, 4 parity planes
    out."""
    import numpy as np
    import torch

    host = np.random.default_rng(SEED).integers(
        0, 1 << 31, (4, K, W), dtype=np.int32
    )
    t = torch.from_numpy(host)
    out = {}
    out["h2d_ms"] = cuda_ms(lambda: t.to(dev), 5, 1)
    out["h2d_bytes"] = host.nbytes
    par = torch.zeros((4, M, W), dtype=torch.int32, device=dev)
    out["d2h_ms"] = cuda_ms(lambda: par.cpu(), 5, 1)
    out["d2h_bytes"] = par.numel() * 4
    return out


def part_files(root: str, bucket: str, name: str) -> "bytes | None":
    from minio_tpu_torch.storage.xl import XLStorage

    try:
        fi = XLStorage(root).read_version(bucket, name)
    except Exception:  # noqa: BLE001 - disk lacks the object
        return None
    with open(os.path.join(root, bucket, name, fi.data_dir, "part.1"), "rb") as f:
        return f.read()


def main_path(dev, work: str) -> dict:
    """Phase 3: PUT, healthy GET and degraded GET through the object
    layer, with the kernel launch counters read around the run."""
    import numpy as np

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    rng = np.random.default_rng(SEED)
    sizes = [64 << 20] * 4 + [BLOCK + 17]
    payloads = [rng.bytes(s) for s in sizes]
    roots = [os.path.join(work, f"disk{i}") for i in range(N)]
    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, device=dev
    )
    ol.make_bucket("bench")

    kernels.reset_launches()
    KERNEL_STATS.reset()
    t_put = t_get = t_deg = 0.0
    for i, data in enumerate(payloads):
        t0 = time.monotonic()
        ol.put_object("bench", f"obj{i}", io.BytesIO(data), len(data))
        t_put += time.monotonic() - t0
    for i, data in enumerate(payloads):
        sink = io.BytesIO()
        t0 = time.monotonic()
        ol.get_object("bench", f"obj{i}", sink)
        t_get += time.monotonic() - t0
        if sink.getvalue() != data:
            fail(f"healthy GET of obj{i} differs from its source")
    for i, data in enumerate(payloads):
        dist = XLStorage(roots[0]).read_version("bench", f"obj{i}").erasure.distribution
        # offline: the disks holding shards 1 and 3 (data) and 10, 12
        dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
        degraded = from_reference_disks(
            [None if d in dead else r for d, r in enumerate(roots)],
            parity_blocks=M, device=dev,
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
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} never launched on the main path")

    # the same port on the CPU writes the same shard files
    cpu_roots = [os.path.join(work, f"cpu{i}") for i in range(N)]
    cpu_ol = ErasureObjects(
        [XLStorage(r) for r in cpu_roots], parity_blocks=M, device="cpu"
    )
    cpu_ol.make_bucket("bench")
    cpu_ol.put_object("bench", "obj4", io.BytesIO(payloads[4]), sizes[4])
    for r_dev, r_cpu in zip(roots, cpu_roots):
        a = part_files(r_dev, "bench", "obj4")
        if a is None or a != part_files(r_cpu, "bench", "obj4"):
            fail("obj4 part files differ between device=cuda and device=cpu")

    total = sum(sizes)
    return {
        "objects": len(sizes),
        "bytes": total,
        "put_s": t_put,
        "get_s": t_get,
        "get_degraded_s": t_deg,
        "put_MBps": total / t_put / 1e6,
        "get_MBps": total / t_get / 1e6,
        "get_degraded_MBps": total / t_deg / 1e6,
        "launches": launches,
        "device_passes": stats["device_passes"],
        "h2d": stats["h2d"],
        "d2h": stats["d2h"],
        "stages": stats["stages"],
    }


# the TPU function each kernel replaces: encode_pack_fused (P4; the
# pipelined P6 computes the same), phash256_words_batched (left to XLA),
# matmul_words (P1)
REPLACES = {
    "encode_pack": "minio_tpu/ops/rs_pallas.py:472",
    "phash256_batched": "minio_tpu/ops/hash.py:162",
    "gf_matmul_words": "minio_tpu/ops/rs_pallas.py:84",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from minio_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    lib = kernels.build()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s -> {os.path.relpath(lib, here)}", flush=True)
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    import numpy as np

    rng = np.random.default_rng(SEED)
    kres = check_kernels(dev, rng)
    for name, r in kres.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    xfer = transfer_ms(dev)
    print(f"transfers: {json.dumps(xfer)}", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        mp = main_path(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"main path: {json.dumps(mp)}", flush=True)

    line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "minio_tpu_torch/csrc/codec.cu",
                "replaces": REPLACES[name],
                "launches": mp["launches"][name],
                "max_abs_err": kres[name]["max_abs_err"],
                "ms": kres[name]["ms"],
                "plain_ms": kres[name]["plain_ms"],
                "bound_ms": kres[name]["bound_ms"],
                "bound_by": kres[name]["bound_by"],
                "library_ms": None,
            }
            for name in ("encode_pack", "phash256_batched", "gf_matmul_words")
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
