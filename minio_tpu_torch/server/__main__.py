"""CLI entry: ``python -m minio_tpu_torch.server [--address host:port] args...``

The `minio server` analogue (cmd/server-main.go): each positional arg is
one zone, and an ellipses pattern expands to that zone's drives - bare
paths (``/data/disk{1...24}``) for one node or URLs
(``http://host{1...4}:9000/data/disk{1...4}``) for distributed mode -
split into erasure sets of 2-16 drives (utils/ellipses.py).  Every node
of a cluster is started with the same arguments; a URL drive is local
when its host is this machine and its port this server's.  Local drives
are served to the peers over the storage REST plane, remote drives are
reached through ``StorageRESTClient``, and object locks go through dsync
quorum locks on the lock REST plane when the layout spans more than one
node; the peer plane verifies the cluster's fingerprint with every peer
before the format bootstrap and then fans out cache invalidations.
``format.json`` is minted on fresh drives (by the owner of the first
endpoint only) or quorum-loaded per zone (objectlayer/format.py), every
local drive is guarded as ``DiskIDCheck(MeteredDisk(XLStorage))``
(``FaultDisk`` at the bottom of the chain under
``MINIO_TPU_FAULT_INJECTION``), and the object layer is
Zones(Sets(Objects)) exactly like newObjectLayer
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

The data-update tracker (its bloom journal on the first local drive,
saved at shutdown) and the data crawler start with the heal routine:
the crawler sweeps every ``MINIO_TPU_CRAWL_INTERVAL_S`` (60 s by default,
or the ``crawler interval_s`` config key), and in a cluster one node
sweeps a cycle, elected on the dsync lock plane.

``MINIO_TPU_FEDERATION_DIR`` federates this deployment with every
other one sharing that record directory (cluster/dns.py): each bucket
name is unique across them, and a bucket another deployment owns
answers 307 to it, at ``MINIO_TPU_FEDERATION_HOST`` (this listener's
host by default) and this listener's scheme (``MINIO_TPU_TLS=on``:
https).

``MINIO_TPU_CACHE_DRIVES`` (comma-separated directories) puts the disk
cache (objectlayer/cache.py) in front of the object layer, each drive
holding up to ``MINIO_TPU_CACHE_QUOTA_MB``; the crawler re-queues
replication that is still PENDING or FAILED (bucket replication,
replication/replicate.py), and ``MINIO_TPU_NOTIFY_*`` configures the
event targets (event/targets.py).

One local drive with no ``://`` is the standalone FS mode
(objectlayer/fs.py, server-main.go:561-564): objects are plain files
under ``<drive>/<bucket>/<object>``, with the same wrappers around the
layer as an erasure one (the disk cache, IAM on the layer, the crawler);
a drive that holds an erasure format exits instead.  ``server gateway
nas <path>`` serves a shared directory through the same FS layer and
``server gateway s3 <url>`` an upstream S3 store (gateway/s3.py,
credentials ``MINIO_TPU_GATEWAY_ACCESS_KEY`` and
``MINIO_TPU_GATEWAY_SECRET_KEY``, ``MINIO_TPU_GATEWAY_INSECURE=1`` for an
upstream's self-signed certificate), with no storage, lock or peer
planes.  These layers have no codec: S3 Select scans their objects on
the device ``MINIO_ERASURE_BACKEND`` names, which is the card by
default, so they need one as an erasure server does.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

CODEC_DEVICES = ("cuda", "cpu")


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


def build_object_layer(zone_args: list[str], parity: "int | None" = None,
                       device="cuda"):
    """Single-node convenience: expand bare-path args -> zones layer."""
    ol, _ = build_cluster(zone_args, local_port=0, secret="", parity=parity,
                          device=device)
    return ol


def build_cluster(
    zone_args: list[str],
    local_port: int,
    secret: str = "",
    parity: "int | None" = None,
    format_timeout_s: float = 120.0,
    local_disk_map: "dict | None" = None,
    nslock=None,
    device="cuda",
):
    """Expand args -> local XLStorage + remote REST disks -> zones layer
    with its codec on ``device``.

    Returns (object_layer, local_disks) where local_disks is every
    XLStorage this node owns (to be served on the storage REST plane).
    ``local_disk_map`` maps a local drive path to a drive opened before
    (the server main opens them first, so the storage plane serves the
    peers during the format bootstrap); ``nslock`` is the namespace lock
    every set shares (dsync quorum locks in a cluster).  A single local
    drive is the standalone FS mode: ``FSObjects`` and no drives to
    serve.
    """
    from ..cluster.endpoints import resolve_endpoints
    from ..objectlayer.format import wait_for_format
    from ..objectlayer.sets import ErasureSets
    from ..objectlayer.zones import ErasureZones
    from ..storage import metered
    from ..storage.diskcheck import DiskIDCheck
    from ..storage.rest_client import StorageRESTClient
    from ..storage.xl import XLStorage
    from ..utils import ellipses

    # standalone FS mode: exactly one local drive and no cluster
    # topology (newObjectLayer FS selection, server-main.go:561-564).
    # A drive already carrying an erasure format must never be
    # reinterpreted as FS (that would misread xl-layout data).
    flat = [a for g in group_zone_args(zone_args) for a in g]
    if len(flat) == 1 and "://" not in flat[0]:
        if os.path.exists(os.path.join(flat[0], ".sys", "format.json")):
            raise SystemExit(
                f"{flat[0]} holds an erasure format; a single-drive FS "
                "server cannot serve it (add the original drives)"
            )
        from ..objectlayer.fs import FSObjects

        return FSObjects(flat[0]), []

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
            if ep.is_local:
                d = (local_disk_map or {}).get(ep.path)
                if d is None:
                    d = XLStorage(ep.path, endpoint=ep.raw)
                local_disks.append(d)
                disks.append(d)
            else:
                disks.append(
                    StorageRESTClient(ep.host, ep.port, ep.path, secret)
                )
        # only the owner of the first endpoint may mint a fresh cluster
        ref_fmt, ordered = wait_for_format(
            disks,
            set_count,
            drives_per_set,
            init_allowed=eps[0].is_local,
            timeout_s=format_timeout_s,
        )
        # per-op disk identity validation on local drives
        # (xl-storage-disk-id-check.go): a swapped drive fails fast.
        # Metering sits INSIDE the identity check; the fresh-disk
        # monitor walks the chain to the raw drive
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
                nslock=nslock,
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


def cluster_nodes(zone_args: list[str], local_port: int):
    """Sorted unique (host, port, is_local) across every URL endpoint -
    the lock-plane topology (one locker per node, like newLockAPI per
    endpoint host)."""
    from ..cluster.endpoints import resolve_endpoints

    nodes: dict = {}
    for specs in group_zone_args(zone_args):
        for ep in resolve_endpoints(specs, local_port):
            if ep.is_url:
                nodes[(ep.host, ep.port)] = (
                    nodes.get((ep.host, ep.port), False) or ep.is_local
                )
    return [
        (h, p, nodes[(h, p)]) for h, p in sorted(nodes)
    ]


def build_lock_plane(
    zone_args: list[str], local_port: int, secret: str
):
    """(nslock, lock_rest_server, maintenance) for this topology.

    Single-node (or bare-path) layouts use the in-process NamespaceLock;
    multi-node layouts get dsync quorum locks over the lock REST plane
    with refresh + expiry recovery (see dsync/drwmutex.py).
    """
    from ..dsync import drwmutex
    from ..dsync.local_locker import LocalLocker, LockMaintenance
    from ..dsync.lock_rest import LockRESTClient, LockRESTServer
    from ..dsync.namespace import DistNamespaceLock, NamespaceLock

    nodes = cluster_nodes(zone_args, local_port)
    if len(nodes) <= 1:
        return NamespaceLock(), None, None
    refresh_s = float(
        os.environ.get("MINIO_TPU_LOCK_REFRESH_S")
        or drwmutex.REFRESH_INTERVAL_S
    )
    expiry_s = float(
        os.environ.get("MINIO_TPU_LOCK_EXPIRY_S") or drwmutex.EXPIRY_S
    )
    local = LocalLocker(endpoint=f"local:{local_port}")
    lockers = [
        local
        if is_local
        else LockRESTClient(host, port, secret)
        for host, port, is_local in nodes
    ]
    ds = drwmutex.Dsync(lockers, refresh_interval_s=refresh_s)
    maint = LockMaintenance(
        local, interval_s=max(1.0, expiry_s / 3), expiry_s=expiry_s
    ).start()
    return (
        DistNamespaceLock(ds),
        LockRESTServer(local, secret),
        maint,
    )


def start_crawler(srv, ol, nslock, tracker_root, distributed: bool):
    """Install the data-update tracker (its file on the first local
    drive) and start the data crawler: usage accounting, lifecycle
    expiry, FIFO quota eviction and heal-on-crawl (runDataCrawler,
    server-main.go:524 startBackgroundOps).  Returns the tracker."""
    from ..crawler import DataCrawler, updatetracker as ut_mod
    from ..objectlayer.api import META_BUCKET

    tracker = ut_mod.DataUpdateTracker(
        path=os.path.join(tracker_root, ".sys", "update-tracker.bin")
        if tracker_root
        else None
    )
    ut_mod.install_tracker(tracker)
    srv.update_tracker = tracker
    notifier = srv.peer_notifier

    def cluster_bloom(oldest: int, current: int):
        """Union of this node's filter and every peer's; any
        unreachable/trackerless peer poisons completeness so the
        crawler falls back to a full sweep."""
        resp = tracker.cycle_filter(oldest, current)
        if notifier is not None:
            for wire in notifier.cycle_blooms(oldest, current):
                if wire is None:
                    resp.complete = False
                    continue
                peer_resp = ut_mod.BloomResponse.from_wire(wire)
                resp.complete = resp.complete and peer_resp.complete
                try:
                    resp.filter.union_into(peer_resp.filter)
                except ValueError:
                    resp.complete = False
        return resp

    srv.crawler = DataCrawler(
        ol,
        srv.bucket_meta,
        interval_s=float(
            os.environ.get("MINIO_TPU_CRAWL_INTERVAL_S") or 60.0
        ),
        events=srv.events,
        ensure_event_rules=srv.ensure_event_rules,
        replication=srv.replication,
        cycle_bloom=cluster_bloom,
        # heal-on-crawl: full sweeps probe shard health and feed the
        # MRF heal queue (data scanner healObject path)
        heal_hook=(
            srv.heal_queue.push_object
            if srv.heal_queue is not None
            else None
        ),
        # distributed: elect one sweeping node per cycle on the dsync
        # lock plane (single node: the local sweep lock serializes)
        leader_lock=(
            (
                lambda: nslock.write(
                    META_BUCKET, "data-crawler/leader", timeout=2.0
                )
            )
            if distributed
            else None
        ),
    ).start()
    return tracker


def run_gateway(args) -> int:
    """Serve the S3 API over a non-erasure backend
    (cmd/gateway/gateway-main.go).  No storage/lock planes, no heal,
    no crawler - the backend owns durability.  Select scans on the
    device ``MINIO_ERASURE_BACKEND`` names (the card by default)."""
    from .http import S3Server

    if len(args.zones) != 3:
        raise SystemExit(
            "usage: server gateway {nas <path> | s3 <endpoint-url>}"
        )
    kind, target = args.zones[1], args.zones[2]
    if kind == "nas":
        from ..objectlayer.fs import FSObjects

        ol = FSObjects(target)
        desc = f"NAS gateway over {target}"
    elif kind == "s3":
        from ..gateway.s3 import S3Objects

        ol = S3Objects(
            target,
            os.environ.get("MINIO_TPU_GATEWAY_ACCESS_KEY")
            or args.access_key,
            os.environ.get("MINIO_TPU_GATEWAY_SECRET_KEY")
            or args.secret_key,
            region=args.region,
        )
        desc = f"S3 gateway to {target}"
    else:
        raise SystemExit(f"unknown gateway backend {kind!r}")
    device = codec_device()
    srv = S3Server(
        ol,
        address=args.address,
        access_key=args.access_key,
        secret_key=args.secret_key,
        region=args.region,
        device=device,
    )
    if device == "cuda":
        from ..ops import kernels

        kernels.load()
    from ..iam.sys import IAMSys

    # IAM rides the backend for nas (persistent), memory for s3 (the
    # upstream bucket namespace is not ours to write into)
    iam = IAMSys(
        args.access_key,
        args.secret_key,
        ol if kind == "nas" else None,
    )
    srv.attach_iam(iam)
    srv.start()
    print(f"minio-tpu serving {desc} at {srv.endpoint}")
    sys.stdout.flush()
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    print(f"signal {stop}, shutting down")
    srv.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="minio-tpu server")
    p.add_argument(
        "zones",
        nargs="+",
        help=(
            "one arg per zone; ellipses expand: /data/disk{1...8} or "
            "http://host{1...4}:9000/data/disk{1...4}"
        ),
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
        help="seconds to wait for peers and drives during bootstrap",
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

    # gateway mode (cmd/gateway/): `server gateway nas /path` or
    # `server gateway s3 http://upstream:9000`
    if args.zones and args.zones[0] == "gateway":
        return run_gateway(args)
    device = codec_device()

    from .. import cache as rcache
    from ..cluster import peer as peer_mod
    from ..crawler import updatetracker as ut_mod
    from ..cluster.endpoints import resolve_endpoints
    from ..storage.rest_common import PREFIX as STORAGE_PREFIX
    from ..storage.rest_server import StorageRESTServer
    from ..storage.xl import XLStorage
    from .http import S3Server

    local_port = int(args.address.rsplit(":", 1)[1])

    # Discover local drives first so the storage plane can serve peers
    # BEFORE the format bootstrap (the reference starts HTTP at
    # server-main.go:477, then waits for disks).  With
    # MINIO_TPU_FAULT_INJECTION=1 each local drive is wrapped in a
    # FaultDisk at the bottom of the wrap chain
    # (DiskIDCheck(Metered(Fault(XL)))), and the admin fault routes
    # schedule delay/error/corrupt/hang rules on it from another process
    fault_on = (os.environ.get("MINIO_TPU_FAULT_INJECTION") or "") in (
        "1", "on", "true",
    )
    fault_seed = int(os.environ.get("MINIO_TPU_FAULT_SEED") or 0)
    fault_disks: dict = {}
    pre_local: list = []
    local_map: dict = {}
    for specs in group_zone_args(args.zones):
        for ep in resolve_endpoints(specs, local_port):
            if ep.is_local:
                d = XLStorage(ep.path, endpoint=ep.raw)
                if fault_on:
                    from ..storage.faults import FaultDisk

                    d = FaultDisk(d, seed=fault_seed + len(fault_disks))
                    fault_disks[str(d.unwrapped.root)] = d
                pre_local.append(d)
                local_map[ep.path] = d

    srv = S3Server(
        None,  # object layer attaches after bootstrap
        address=args.address,
        access_key=args.access_key,
        secret_key=args.secret_key,
        region=args.region,
        internode_secret=args.secret_key,
        device=device,
    )
    if fault_disks:
        srv.fault_disks = fault_disks
    # readiness gate: /minio/health/ready stays 503 until every
    # subsystem flips its flag, so a harness polls instead of sleeping
    srv.boot_status = {
        "lock_plane": False,
        "boot": False,
        "server_loops": False,
    }
    storage_rest = StorageRESTServer(pre_local, args.secret_key)
    srv.register_internode(STORAGE_PREFIX, storage_rest.handle)
    nslock, lock_rest, lock_maint = build_lock_plane(
        args.zones, local_port, args.secret_key
    )
    if lock_rest is not None:
        from ..dsync.lock_rest import PREFIX as LOCK_PREFIX

        srv.register_internode(LOCK_PREFIX, lock_rest.handle)
        srv.local_locker = lock_rest.locker
    srv.boot_status["lock_plane"] = True

    # peer control plane + bootstrap handshake: every node serves
    # /minio-tpu/peer/v1 and verifies the cluster fingerprint against
    # every peer before joining
    fingerprint = peer_mod.cluster_fingerprint(
        args.zones, args.access_key, args.secret_key
    )
    peers = [
        peer_mod.PeerRESTClient(host, port, args.secret_key)
        for host, port, is_local in cluster_nodes(args.zones, local_port)
        if not is_local
    ]
    srv.peer_rest = peer_mod.PeerRESTServer(
        srv,
        args.secret_key,
        fingerprint=fingerprint,
        local_locker=srv.local_locker,
    )
    srv.register_internode(peer_mod.PREFIX, srv.peer_rest.handle)
    if peers:
        srv.peer_notifier = peer_mod.PeerNotifier(peers)
        # object mutations on this node drop every peer's cached read
        # groups; from here on GETs skip the cache's FileInfo side-car
        rcache.set_broadcast(srv.peer_notifier.read_cache_invalidated)

    srv.start()
    srv.boot_status["server_loops"] = (
        srv._plane is None or srv._plane.loops_ready()
    )
    print(f"minio-tpu listening at {srv.endpoint} (bootstrapping)")
    sys.stdout.flush()
    if peers:
        try:
            peer_mod.verify_cluster(
                peers, fingerprint, timeout_s=args.format_timeout
            )
        except RuntimeError as e:
            srv.shutdown(drain_s=0.0)
            raise SystemExit(f"bootstrap handshake failed: {e}") from None
        print(f"bootstrap handshake ok with {len(peers)} peer(s)")
        sys.stdout.flush()

    def build(dev):
        ol, _ = build_cluster(
            args.zones,
            local_port,
            args.secret_key,
            args.parity,
            format_timeout_s=args.format_timeout,
            local_disk_map=local_map,
            nslock=nslock,
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
        srv.device = device
    # optional SSD read cache in front of the object layer
    # (disk-cache.go CacheObjectLayer, server-main.go:531-540); the
    # subsystems below keep the bare layer
    from ..objectlayer.cache import cache_from_env

    ol_front = cache_from_env(ol)
    if ol_front is not ol:
        print("disk cache enabled")
    srv.object_layer = ol_front
    # federation: a shared record dir plays etcd's role for bucket
    # DNS (cmd/config/etcd/dns); every cluster pointing at the same
    # dir shares one global bucket namespace
    fed_dir = os.environ.get("MINIO_TPU_FEDERATION_DIR", "")
    if fed_dir:
        from ..cluster.dns import BucketDNS, FileDNSStore
        from ..utils import tlsconf

        adv_host = (
            os.environ.get("MINIO_TPU_FEDERATION_HOST")
            or args.address.rsplit(":", 1)[0]
        )
        if adv_host in ("0.0.0.0", ""):
            adv_host = "127.0.0.1"
        # the record carries the scheme this listener serves
        srv.bucket_dns = BucketDNS(
            FileDNSStore(fed_dir),
            adv_host,
            local_port,
            scheme="https" if tlsconf.enabled() else "http",
        )
        print(f"federation: bucket DNS at {fed_dir} as "
              f"{adv_host}:{local_port}")
    # once formats are known, the storage REST plane serves the
    # DiskIDCheck-wrapped disks too: peer I/O must not write onto a
    # swapped drive either (xl-storage-disk-id-check.go applies to the
    # server side of the plane)
    from ..storage.diskcheck import DiskIDCheck

    guarded_map = {
        d.unwrapped.root: d
        for zone in getattr(ol, "zones", [])
        for eset in zone.sets
        for d in eset.disks
        if isinstance(d, DiskIDCheck)
    }
    storage_rest.guard_disks(guarded_map)
    if device == "cuda":
        # the kernel library (found by its source fingerprint, built
        # when missing) loads now, not at the first request
        from ..ops import kernels

        kernels.load()
    # store-backed IAM after the object layer is up (iam.go:419 Init);
    # in a cluster a periodic reload catches a notification a down node
    # missed
    from ..iam.sys import IAMSys

    iam = IAMSys(args.access_key, args.secret_key, ol)
    srv.attach_iam(iam)
    if peers:
        srv.iam_refresher = iam.start_refresher(
            float(os.environ.get("MINIO_TPU_IAM_REFRESH_S") or 120.0)
        )
    if getattr(ol, "zones", None):
        routine, monitor = start_background_heal(ol)
        srv.heal_routine = routine
        srv.heal_queue = routine.queue
        srv.disk_monitor = monitor  # also the reloadformat peer RPC
    tracker = start_crawler(
        srv, ol, nslock,
        next(iter(guarded_map), None) or getattr(ol, "root", None),
        bool(peers),
    )
    si = ol.storage_info()
    if "zones" in si:
        desc = (
            f"{len(ol.zones)} zone(s) "
            f"{[z['disks'] for z in si['zones']]} drives"
        )
        zcount = len(ol.zones)
    else:
        desc = "standalone FS backend (1 drive)"
        zcount = 0
    srv.boot_status["boot"] = True
    print(f"minio-tpu serving {desc} at {srv.endpoint}")
    sys.stdout.flush()
    log.logger("server").info(
        "online",
        extra=log.kv(endpoint=srv.endpoint, zones=zcount,
                     device=device, peers=len(peers)),
    )
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    print(f"signal {stop}, shutting down")
    # graceful teardown order: drain in-flight requests first (their
    # handlers release their own locks), stop the heal threads and the
    # peer plane (inside srv.shutdown), THEN unwind whatever dsync
    # grants remain so peers see clean releases instead of waiting out
    # the expiry window on orphaned entries
    tracker.save()  # flush marks recorded since the last rotation
    srv.shutdown()
    ut_mod.install_tracker(None)
    rcache.set_broadcast(None)
    if lock_maint is not None:
        lock_maint.stop()
    if hasattr(nslock, "release_all"):
        released = nslock.release_all()
        if released:
            print(f"released {released} held lock(s)")
    print("shutdown complete")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
