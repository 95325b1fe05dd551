"""CLI entry: ``python -m minio_tpu_torch.server [--address host:port] args...``

The `minio server` analogue (cmd/server-main.go) for one node: each
positional arg is one zone, and an ellipses pattern expands to that
zone's drives (``/data/disk{1...24}``), split into erasure sets of 2-16
drives (utils/ellipses.py).  ``format.json`` is minted on fresh drives
or quorum-loaded per zone (objectlayer/format.py), every local drive is
guarded as ``DiskIDCheck(MeteredDisk(XLStorage))``, and the object layer
is Zones(Sets(Objects)) exactly like newObjectLayer
(server-main.go:559-567).  HTTP serving starts before the object layer
is ready (503 ServerNotInitialized, readiness 503, until then), on the
async plane unless ``MINIO_TPU_SERVER=threaded``.  Then the persisted
KV config is applied, the store-backed IAM attached, and the MRF heal
routine and the fresh-disk monitor started; SIGINT or SIGTERM drains
and exits 0.

The erasure codec runs on the card: ``MINIO_ERASURE_BACKEND`` unset or
``cuda``, and the server exits when there is none.  ``cpu`` runs the
plain PyTorch codec on the CPU, and only when asked; any other value
exits.  A persisted ``codec backend`` edit (admin set-config-kv) takes
effect here, at boot.

What this package has not ported exits at boot with a message naming
its slice, instead of being ignored: URL drive endpoints and so a
second node, fault injection and federation (9b); the gateway, a
single drive (FS mode) and the disk cache (9c).  The data crawler and
the update tracker (slice 9b) are not started.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

# env knobs of features this package has not ported: name -> (what,
# slice).  A non-empty value exits at boot.
UNPORTED_ENV = {
    "MINIO_TPU_FAULT_INJECTION": ("fault injection (storage/faults.py)", "9b"),
    "MINIO_TPU_FEDERATION_DIR": ("bucket federation", "9b"),
    "MINIO_TPU_CACHE_DRIVES": ("the disk cache (objectlayer/cache.py)", "9c"),
}

CODEC_DEVICES = ("cuda", "cpu")


def _refuse(what: str, slice_name: str) -> "SystemExit":
    return SystemExit(
        f"{what} is not ported to minio_tpu_torch yet (slice {slice_name})"
    )


def group_zone_args(zone_args: list[str]) -> list[list[str]]:
    """Group CLI drive args into zones (createServerEndpoints,
    endpoint-ellipses.go:331): args WITHOUT ellipses all join one zone
    (verify-healing.sh lists endpoints individually); each arg WITH an
    ellipses pattern is its own zone (server-pool syntax).  Mixing the
    two styles is rejected, like the reference."""
    from ..utils import ellipses

    with_e = [a for a in zone_args if ellipses.has_ellipses(a)]
    if not with_e:
        return [list(zone_args)]
    if len(with_e) != len(zone_args):
        raise SystemExit(
            "all drive args must use ellipses patterns, or none"
        )
    return [ellipses.expand(a) for a in zone_args]


def codec_device(value: "str | None" = None) -> str:
    """The codec's device from ``value`` or MINIO_ERASURE_BACKEND:
    ``cuda`` (the default) needs a card; ``cpu`` only when asked."""
    if value is None:
        value = os.environ.get("MINIO_ERASURE_BACKEND") or "cuda"
    dev = value.strip().lower()
    if dev not in CODEC_DEVICES:
        raise SystemExit(
            f"MINIO_ERASURE_BACKEND={value!r}: the codec runs on the card "
            "(cuda, the default) or on the CPU (cpu)"
        )
    if dev == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "no CUDA device: this server runs its codec on the card "
                "(set MINIO_ERASURE_BACKEND=cpu to run it on the CPU)"
            )
    return dev


def refuse_unported(zone_args: list[str]) -> None:
    """Exit, naming the slice, for what this package does not serve."""
    if zone_args and zone_args[0] == "gateway":
        raise _refuse("gateway mode (server gateway nas|s3)", "9c")
    for name, (what, slice_name) in UNPORTED_ENV.items():
        val = (os.environ.get(name) or "").strip()
        if val and val.lower() not in ("0", "off", "false", "no"):
            raise _refuse(f"{what} ({name})", slice_name)
    flat = [a for g in group_zone_args(zone_args) for a in g]
    if any("://" in a for a in flat):
        raise _refuse(
            "distributed mode (URL drive endpoints, a second node)", "9b"
        )
    if len(flat) == 1:
        raise _refuse("the single-drive FS mode (objectlayer/fs.py)", "9c")


def build_object_layer(zone_args: list[str], parity: "int | None" = None,
                       device="cuda"):
    """Single-node convenience: expand bare-path args -> zones layer."""
    ol, _ = build_cluster(zone_args, local_port=0, parity=parity,
                          device=device)
    return ol


def build_cluster(
    zone_args: list[str],
    local_port: int,
    parity: "int | None" = None,
    format_timeout_s: float = 120.0,
    device="cuda",
):
    """Expand args -> local XLStorage drives -> zones layer on ``device``.

    Returns (object_layer, local_disks) where local_disks is every
    XLStorage this node owns.  A remote (URL) drive raises: its storage
    REST client is slice 9b, and with it the JAX signature's secret,
    pre-opened drive map and namespace lock; so does a single drive (FS
    mode, 9c).
    """
    from ..cluster.endpoints import resolve_endpoints
    from ..objectlayer.format import wait_for_format
    from ..objectlayer.sets import ErasureSets
    from ..objectlayer.zones import ErasureZones
    from ..storage import metered
    from ..storage.diskcheck import DiskIDCheck
    from ..storage.xl import XLStorage
    from ..utils import ellipses

    if sum(map(len, group_zone_args(zone_args))) == 1:
        raise _refuse("the single-drive FS mode (objectlayer/fs.py)", "9c")

    zones = []
    local_disks: list = []
    for specs in group_zone_args(zone_args):
        eps = resolve_endpoints(specs, local_port)
        if len(eps) < 2:
            raise SystemExit(
                f"zone {specs!r} expands to {len(eps)} drives; need >= 2"
            )
        set_count, drives_per_set = ellipses.layout(len(eps))
        disks = []
        for ep in eps:
            if not ep.is_local:
                raise _refuse(
                    f"the remote drive {ep.raw} (storage REST client)", "9b"
                )
            d = XLStorage(ep.path, endpoint=ep.raw)
            local_disks.append(d)
            disks.append(d)
        ref_fmt, ordered = wait_for_format(
            disks,
            set_count,
            drives_per_set,
            init_allowed=True,
            timeout_s=format_timeout_s,
        )
        # per-op disk identity validation (xl-storage-disk-id-check.go):
        # a swapped drive fails fast.  Metering sits INSIDE the identity
        # check; the fresh-disk monitor walks the chain to the raw drive
        guarded = []
        for i, d in enumerate(ordered):
            if d is not None and d.is_local():
                s_idx, d_idx = divmod(i, drives_per_set)
                guarded.append(
                    DiskIDCheck(
                        metered.wrap(d), ref_fmt.sets[s_idx][d_idx]
                    )
                )
            else:
                guarded.append(d)
        zones.append(
            ErasureSets(
                guarded,
                set_count,
                drives_per_set,
                parity_blocks=parity,
                format_ref=ref_fmt,
                device=device,
            )
        )
    return ErasureZones(zones), local_disks


def start_background_heal(ol):
    """MRF queue + heal routine + fresh-disk monitor over the object
    layer (startBackgroundOps analogue, server-main.go:524).  Returns
    (routine, monitor); both are daemon threads."""
    from ..heal.background import FreshDiskMonitor, HealQueue, HealRoutine

    queue = HealQueue()
    routine = HealRoutine(
        ol,
        queue,
        throttle_s=float(
            os.environ.get("MINIO_TPU_HEAL_THROTTLE_S") or 0.0
        ),
    ).start()
    monitor = FreshDiskMonitor(
        ol,
        queue,
        interval_s=float(
            os.environ.get("MINIO_TPU_FRESH_DISK_INTERVAL_S") or 10.0
        ),
    ).start()
    for zone in ol.zones:
        for eset in zone.sets:
            eset.heal_hook = queue.push_object
    return routine, monitor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="minio-tpu server")
    p.add_argument(
        "zones",
        nargs="+",
        help="one arg per zone; ellipses expand: /data/disk{1...8}",
    )
    p.add_argument("--address", default="0.0.0.0:9000")
    p.add_argument(
        "--access-key",
        default=os.environ.get("MINIO_ACCESS_KEY", "minioadmin"),
    )
    p.add_argument(
        "--secret-key",
        default=os.environ.get("MINIO_SECRET_KEY", "minioadmin"),
    )
    p.add_argument("--region", default="us-east-1")
    p.add_argument(
        "--parity", type=int, default=None,
        help="parity drives per set (default: half)",
    )
    p.add_argument(
        "--format-timeout", type=float, default=120.0,
        help="seconds to wait for the drives during format bootstrap",
    )
    args = p.parse_args(argv)

    # sigwait only *claims* a signal that is blocked; an unblocked
    # SIGTERM races the default disposition (immediate termination) and
    # usually loses, skipping the graceful drain below.  Block both
    # before any thread spawns so every thread inherits the mask.
    signal.pthread_sigmask(
        signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM}
    )

    from ..utils import log

    log.setup(os.environ.get("MINIO_TPU_LOG_LEVEL", "info"))
    refuse_unported(args.zones)
    device = codec_device()

    from .http import S3Server

    local_port = int(args.address.rsplit(":", 1)[1])
    srv = S3Server(
        None,  # object layer attaches after bootstrap
        address=args.address,
        access_key=args.access_key,
        secret_key=args.secret_key,
        region=args.region,
    )
    # readiness gate: /minio/health/ready stays 503 until every
    # subsystem flips its flag, so a harness polls instead of sleeping.
    # One node: the namespace lock is in-process, up from the start.
    srv.boot_status = {
        "lock_plane": True,
        "boot": False,
        "server_loops": False,
    }
    srv.start()
    srv.boot_status["server_loops"] = (
        srv._plane is None or srv._plane.loops_ready()
    )
    print(f"minio-tpu listening at {srv.endpoint} (bootstrapping)")
    sys.stdout.flush()

    def build(dev):
        ol, _ = build_cluster(
            args.zones,
            local_port,
            args.parity,
            format_timeout_s=args.format_timeout,
            device=dev,
        )
        return ol

    ol = build(device)
    srv.object_layer = ol
    # persisted KV config: load + apply before subsystems read their
    # env seams (initSafeMode config load, server-main.go:526).  A
    # persisted codec device differing from the env's rebuilds the sets
    # on it, before anything was served.
    srv.config.apply()
    want = codec_device(srv.config.get("codec", "backend"))
    if want != device:
        device = want
        ol = build(device)
        srv.object_layer = ol
    if device == "cuda":
        # the kernel library (found by its source fingerprint, built
        # when missing) loads now, not at the first request
        from ..ops import kernels

        kernels.load()
    # store-backed IAM after the object layer is up (iam.go:419 Init)
    from ..iam.sys import IAMSys

    srv.attach_iam(IAMSys(args.access_key, args.secret_key, ol))
    routine, monitor = start_background_heal(ol)
    srv.heal_routine = routine
    srv.heal_queue = routine.queue
    srv.disk_monitor = monitor
    si = ol.storage_info()
    srv.boot_status["boot"] = True
    print(
        f"minio-tpu serving {len(ol.zones)} zone(s) "
        f"{[z['disks'] for z in si['zones']]} drives at {srv.endpoint}"
    )
    sys.stdout.flush()
    log.logger("server").info(
        "online",
        extra=log.kv(endpoint=srv.endpoint, zones=len(ol.zones),
                     device=device),
    )
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    print(f"signal {stop}, shutting down")
    # graceful teardown: drain in-flight requests first, then the
    # fresh-disk monitor and the heal routine (inside srv.shutdown)
    srv.shutdown()
    print("shutdown complete")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
