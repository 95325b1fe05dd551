"""Peer REST control plane + bootstrap handshake.

The cross-node control channel the reference runs next to the storage
and lock planes (cmd/peer-rest-server.go:1035 registers ~28 methods;
cmd/peer-rest-client.go; cmd/bootstrap-peer-server.go:109 verifies the
cluster config at boot).  Mounted on each node's single internode
listener under ``/minio-tpu/peer/v1/<method>``: MessagePack request and
response documents (storage/mpack.py, byte-equal to msgpack's), the
internode JWT on every call.

Three jobs:
- **invalidation**: bucket-metadata and IAM edits made on one node are
  pushed to every peer so their caches reload immediately instead of
  waiting out a TTL (LoadBucketMetadata / LoadUser / LoadPolicy RPCs in
  the reference);
- **introspection**: per-node server info and the node's local lock
  table, aggregated by the admin API (ServerInfo / GetLocks);
- **bootstrap**: before joining, a node compares its config fingerprint
  (version + endpoint topology + credential hash) against every peer and
  refuses to proceed on mismatch (verifyServerSystemConfig,
  bootstrap-peer-server.go:109 - catches the classic "one node started
  with different creds/drive order" operator error).

Notifications are fire-and-forget fan-out: a dead peer misses the push
but converges via its cache TTL - the same weak consistency the
reference accepts (peer-rest-client.go swallows notification errors).
The read cache's invalidation rides the same fan-out, and does not need
to arrive for reads to stay right: with a peer plane the object layer
reads ``xl.meta`` by quorum on every GET (it skips the cache's FileInfo
side-car, cache/__init__.py ``sidecar_enabled``), and cached groups are
keyed by the ``data_dir`` that quorum read names.

Every method of ``_METHODS`` is ported.  The remote
ListenBucketNotification subscriptions (``listenon``/``listenbuf``/
``listenoff``) let a watcher on one node see the events of every node:
each subscription is a queue here, drained by the watcher's polls and
reaped after ``_LISTEN_TTL_S`` without one.  ``cyclebloom`` rotates
this node's data-update tracker for the crawling node, which unions
every peer's filter (``PeerNotifier.cycle_blooms``).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import http.client
import os
import threading
import time

from ..storage import mpack
from ..utils import jwt

from ..utils.log import kv, logger

_log = logger("peer")

PREFIX = "/minio-tpu/peer/v1"
_TOKEN_TTL_S = 900
VERSION = "minio-tpu/1"  # bumped on wire-format changes


class PeerAuthError(ConnectionError):
    """Peer rejected our internode JWT (mismatched secret key)."""


def _q1(q: dict, key: str) -> str:
    """First query value (the internode router hands parse_qs lists)."""
    v = q.get(key, "")
    if isinstance(v, (list, tuple)):
        v = v[0] if v else ""
    return v


def _pack(obj) -> bytes:
    return mpack.packb(obj)


def _unpack(raw: bytes):
    return mpack.unpackb(raw) if raw else None


def cluster_fingerprint(
    zone_args: "list[str]", access_key: str, secret_key: str
) -> dict:
    """What every node must agree on to form one cluster
    (getServerSystemCfg: endpoints + credentials + platform).

    Credentials are compared as a salted hash so the handshake never
    moves secrets; the topology is the sorted raw endpoint args, which
    all nodes share verbatim in distributed mode.
    """
    cred = hashlib.sha256(
        f"{access_key}\x00{secret_key}".encode()
    ).hexdigest()[:32]
    return {
        "version": VERSION,
        "endpoints": sorted(zone_args),
        "cred_hash": cred,
    }


class PeerRESTServer:
    """Serves this node's control RPCs (peer-rest-server.go)."""

    def __init__(
        self,
        s3server,
        secret: str,
        fingerprint: "dict | None" = None,
        local_locker=None,
    ):
        self.s3 = s3server
        self._secret = secret
        self.fingerprint = fingerprint or {}
        self.local_locker = local_locker
        self.started = time.time()
        # remote ListenBucketNotification subscriptions (listenon/
        # listenbuf/listenoff); GC'd when a watcher stops polling -
        # on every listen RPC and by a background sweeper, so an
        # orphaned subscription dies even if listen traffic stops
        self._listeners: "dict[str, dict]" = {}
        self._listen_mu = threading.Lock()
        self._listen_gc_thread: "threading.Thread | None" = None
        self._listen_stop = threading.Event()
        self._obd_mu = threading.Lock()

    def close(self) -> None:
        """Release remote-listener state (sweeper + subscriptions)."""
        self._listen_stop.set()
        with self._listen_mu:
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for rec in listeners:
            self.s3.events.unsubscribe_listener(
                rec["bucket"], rec["sub"]
            )

    # -- RPC implementations ---------------------------------------------

    def _health(self, q, body) -> dict:
        return {
            "ok": True,
            "initialized": self.s3.object_layer is not None,
        }

    def _server_info(self, q, body) -> dict:
        """Per-node info (madmin ServerProperties shape, trimmed)."""
        info = {
            "endpoint": self.s3.endpoint,
            "version": VERSION,
            "uptime_s": round(time.time() - self.started, 1),
            "state": (
                "online" if self.s3.object_layer is not None
                else "initializing"
            ),
            "pid": os.getpid(),
        }
        ol = self.s3.object_layer
        if ol is not None:
            try:
                si = ol.storage_info()
                # zones layer nests per-zone dicts; a bare set is flat
                zones = si.get("zones", [si])
                info["drives_online"] = sum(z.get("online", 0) for z in zones)
                info["drives"] = sum(z.get("disks", 0) for z in zones)
            except Exception as exc:
                _log.debug("server-info drive count probe failed", extra=kv(err=str(exc)))
        return info

    def _load_bucket_metadata(self, q, body) -> dict:
        bucket = _q1(q, "bucket")
        if bucket and self.s3.object_layer is not None:
            self.s3.bucket_meta.invalidate(bucket)
            self.s3.invalidate_event_rules(bucket)
        return {"ok": True}

    def _delete_bucket_metadata(self, q, body) -> dict:
        bucket = _q1(q, "bucket")
        if bucket and self.s3.object_layer is not None:
            self.s3.bucket_meta.invalidate(bucket)
            self.s3.invalidate_event_rules(bucket)
        return {"ok": True}

    def _load_iam(self, q, body) -> dict:
        iam = getattr(self.s3, "iam", None)
        if iam is not None:
            iam.refresh()
        return {"ok": True}

    def _load_config(self, q, body) -> dict:
        """Re-read + apply the persisted KV config (the set-config-kv
        cluster-wide reload, notification.go LoadConfig analogue)."""
        if self.s3.object_layer is not None:
            cfg = self.s3.config
            cfg.reload()
            cfg.apply()
        return {"ok": True}

    def _get_locks(self, q, body) -> dict:
        if self.local_locker is None:
            return {"locks": []}
        return {"locks": self.local_locker.dump()}

    def _trace_buf(self, q, body) -> dict:
        """Drain this node's trace ring past `since` (the Trace peer
        RPC, peer-rest-client.go:774, poll-based)."""
        since = int(_q1(q, "since") or 0)
        seq, items = self.s3.tracer.poll(since)
        return {"seq": seq, "items": items}

    def _console_buf(self, q, body) -> dict:
        since = int(_q1(q, "since") or 0)
        seq, items = self.s3.console.ring.since(since)
        return {"seq": seq, "items": items}

    def _start_profiling(self, q, body) -> dict:
        self.s3.profiler.start(_q1(q, "type") or "cpu")
        return {"ok": True}

    def _download_profiling(self, q, body) -> dict:
        data = self.s3.profiler.stop(_q1(q, "type") or "cpu")
        return {"profile": data}

    def _bg_heal_status(self, q, body) -> dict:
        """This node's background-heal counters (the
        BackgroundHealStatus peer RPC)."""
        from ..server.admin import AdminAPI

        return AdminAPI(self.s3)._bg_heal_local()

    def _signal_service(self, q, body) -> dict:
        """Stop/restart THIS node (the SignalService peer RPC,
        peer-rest-client.go SignalService)."""
        from ..server.admin import AdminAPI

        action = _q1(q, "action")
        if action not in ("stop", "restart"):
            return {"ok": False, "error": f"bad action {action!r}"}
        AdminAPI(self.s3)._signal_self(action)
        return {"ok": True}

    def _health_info(self, q, body) -> dict:
        """This node's OBD document (the ServerOBDInfo peer RPC)."""
        from ..server.admin import AdminAPI

        ol = self.s3.object_layer
        if ol is None:
            return {"endpoint": "", "state": "initializing"}
        return AdminAPI(self.s3)._health_info_local(ol)

    def _cycle_bloom(self, q, body) -> dict:
        """Rotate this node's data-update tracker and return its
        filter for [oldest, current) (the CycleServerBloomFilter peer
        RPC, peer-rest-client.go cycleServerBloomFilter)."""
        tracker = getattr(self.s3, "update_tracker", None)
        if tracker is None:
            return {"ok": False}
        req = _unpack(body) or {}
        resp = tracker.cycle_filter(
            int(req.get("oldest", 0)), int(req.get("current", 0))
        )
        return {"ok": True, **resp.to_wire()}

    def _verify_config(self, q, body) -> dict:
        """Bootstrap handshake: peer sends ITS fingerprint; we diff
        against ours field by field (bootstrap-peer-server.go:78-107)."""
        theirs = _unpack(body) or {}
        mism = [
            k
            for k in ("version", "endpoints", "cred_hash")
            if theirs.get(k) != self.fingerprint.get(k)
        ]
        if mism:
            return {"ok": False, "mismatch": mism}
        return {"ok": True}

    # -- granular IAM invalidation (LoadUser/LoadPolicy/... peer RPCs,
    #    peer-rest-server.go LoadUserHandler etc.) -------------------------

    def _iam(self):
        return getattr(self.s3, "iam", None)

    def _load_user(self, q, body) -> dict:
        iam = self._iam()
        if iam is not None:
            iam.load_user(_q1(q, "name"))
        return {"ok": True}

    def _delete_user(self, q, body) -> dict:
        iam = self._iam()
        if iam is not None:
            iam.drop_user(_q1(q, "name"))
        return {"ok": True}

    def _load_policy(self, q, body) -> dict:
        iam = self._iam()
        if iam is not None:
            iam.load_policy(_q1(q, "name"))
        return {"ok": True}

    def _delete_policy(self, q, body) -> dict:
        iam = self._iam()
        if iam is not None:
            iam.drop_policy(_q1(q, "name"))
        return {"ok": True}

    def _load_group(self, q, body) -> dict:
        iam = self._iam()
        if iam is not None:
            iam.load_group(_q1(q, "name"))
        return {"ok": True}

    def _load_policy_mapping(self, q, body) -> dict:
        """The user/group -> policy mapping rides the entity doc in
        this design, so reloading the entity reloads the mapping."""
        iam = self._iam()
        if iam is not None:
            if _q1(q, "isGroup") in ("1", "true"):
                iam.load_group(_q1(q, "name"))
            else:
                iam.load_user(_q1(q, "name"))
        return {"ok": True}

    # -- misc parity RPCs --------------------------------------------------

    def _get_local_disk_ids(self, q, body) -> dict:
        """IDs of this node's LOCAL drives (GetLocalDiskIDs)."""
        from ..server.metrics import _iter_disks
        from ..storage.rest_client import StorageRESTClient

        ids = []
        ol = self.s3.object_layer
        if ol is not None:
            for d in _iter_disks(ol):
                if d is None:
                    continue
                inner = getattr(d, "disk", d)
                if isinstance(inner, StorageRESTClient):
                    continue
                try:
                    ids.append(d.get_disk_id())
                except Exception:  # noqa: BLE001
                    continue
        return {"ids": ids}

    def _reload_format(self, q, body) -> dict:
        """Re-probe local drives against the reference format and
        re-admit healed/replaced ones (ReloadFormat after heal)."""
        monitor = getattr(self.s3, "disk_monitor", None)
        if monitor is None:
            return {"ok": False, "error": "no disk monitor"}
        return {"ok": True, "stamped": monitor.scan_once()}

    def _server_update(self, q, body) -> dict:
        """ServerUpdate parity endpoint: in-place binary updates are
        not a thing in this build (deploys replace the image), so the
        RPC answers like mc admin update against a source build."""
        return {
            "ok": False,
            "error": "server updates are disabled in this build",
        }

    def _log(self, q, body) -> dict:
        """Append a remote node's console line into this node's ring
        (the console-target fan-in the reference's /log carries)."""
        entry = _unpack(body) or {}
        self.s3.console.ring.append(dict(entry))
        return {"ok": True}

    # -- granular OBD slices (the reference's per-subsystem OBD RPCs;
    #    one local doc, sliced per method) ---------------------------------

    _OBD_CACHE_S = 5.0

    def _obd_slice(self, keys) -> dict:
        ol = self.s3.object_layer
        if ol is None:
            return {"state": "initializing"}
        # one OBD collection fans out to every per-subsystem RPC; a
        # short-lived cache keeps that from re-running the full drive
        # probe six times per burst
        with self._obd_mu:  # one probe per burst, not one per RPC
            cached = getattr(self, "_obd_doc", None)
            if cached is None or time.monotonic() - cached[0] > (
                self._OBD_CACHE_S
            ):
                from ..server.admin import AdminAPI

                cached = (
                    time.monotonic(),
                    AdminAPI(self.s3)._health_info_local(ol),
                )
                self._obd_doc = cached
            doc = cached[1]
        return {k: doc.get(k) for k in ("endpoint", *keys)}

    def _drive_obd(self, q, body) -> dict:
        return self._obd_slice(("drives",))

    def _mem_obd(self, q, body) -> dict:
        return self._obd_slice(
            ("mem_total_bytes", "mem_available_bytes")
        )

    def _cpu_obd(self, q, body) -> dict:
        return self._obd_slice(("cpus", "platform"))

    def _os_obd(self, q, body) -> dict:
        return self._obd_slice(("platform", "python", "version"))

    def _proc_obd(self, q, body) -> dict:
        return self._obd_slice(("uptime_seconds", "state"))

    def _net_obd(self, q, body) -> dict:
        """This node's view of the internode network: health RTT to
        every peer (NetOBDInfo's latency matrix, one row).  Probes run
        concurrently with no retry so one blackholed peer costs ONE
        timeout, not a serial walk past the caller's deadline."""
        peers = getattr(self.s3, "peer_notifier", None)

        def probe(c) -> dict:
            t0 = time.monotonic()
            try:
                ok = bool(c.call("health", retry=False).get("ok"))
            except Exception:  # noqa: BLE001
                ok = False
            return {
                "peer": f"{c.host}:{c.port}",
                "ok": ok,
                "rtt_ms": round((time.monotonic() - t0) * 1e3, 2),
            }

        out = []
        if peers is not None and peers.clients:
            out = peers._gather(
                probe,
                lambda c: {
                    "peer": f"{c.host}:{c.port}",
                    "ok": False,
                    "rtt_ms": -1.0,
                },
            )
        return {"endpoint": self.s3.endpoint, "net": out}

    def _dispatch_net_obd(self, q, body) -> dict:
        """Ask every peer for ITS net row (DispatchNetOBDInfo)."""
        peers = getattr(self.s3, "peer_notifier", None)
        rows = [self._net_obd(q, body)]
        if peers is not None:
            rows.extend(
                peers._gather(
                    lambda c: c.call("netobdinfo", retry=False),
                    lambda c: {
                        "endpoint": f"{c.host}:{c.port}",
                        "net": [],
                    },
                )
            )
        return {"rows": rows}

    # -- cluster-wide event listen (the Listen peer RPC,
    #    cmd/notification.go:440 remote listen targets; poll-delivered
    #    like tracebuf, matching this design's internode idiom) -----------

    _LISTEN_TTL_S = 60.0

    def _listen_gc_locked(self) -> None:
        now = time.monotonic()
        for lid in [
            lid
            for lid, rec in self._listeners.items()
            if now - rec["polled"] > self._LISTEN_TTL_S
        ]:
            rec = self._listeners.pop(lid)
            self.s3.events.unsubscribe_listener(
                rec["bucket"], rec["sub"]
            )

    def _listen_on(self, q, body) -> dict:
        """Register a remote listener: events this node generates for
        the bucket start flowing into a pollable queue."""
        doc = _unpack(body) or {}
        bucket = doc.get("bucket", "")
        lid = doc.get("id", "")
        if not bucket or not lid:
            return {"ok": False, "error": "bucket and id required"}
        with self._listen_mu:
            self._listen_gc_locked()
            if lid in self._listeners:
                return {"ok": True}
            sub = self.s3.events.subscribe_listener(bucket)
            self._listeners[lid] = {
                "bucket": bucket,
                "sub": sub,
                "prefix": doc.get("prefix", ""),
                "suffix": doc.get("suffix", ""),
                "names": set(doc.get("names") or []),
                "polled": time.monotonic(),
            }
            self._ensure_listen_gc_thread()
        return {"ok": True}

    def _ensure_listen_gc_thread(self) -> None:
        """Background sweeper (held under _listen_mu): reaps orphaned
        subscriptions even when listen traffic stops entirely (a
        crashed watcher node never sends another RPC); exits once the
        table is empty."""
        t = self._listen_gc_thread
        if t is not None and t.is_alive():
            return

        def sweep():
            while not self._listen_stop.wait(self._LISTEN_TTL_S / 2):
                with self._listen_mu:
                    self._listen_gc_locked()
                    if not self._listeners:
                        self._listen_gc_thread = None
                        return

        t = threading.Thread(
            target=sweep, daemon=True, name="peer-listen-gc"
        )
        self._listen_gc_thread = t
        t.start()

    def _listen_buf(self, q, body) -> dict:
        """Drain a remote listener's queue: wire-ready notification
        records, filtered server-side like the local stream."""
        from ..event.event import matches_filter, to_listen_record

        lid = _q1(q, "id")
        with self._listen_mu:
            # GC here too: a watcher that died without listenoff must
            # not leak its subscription until the next listenon
            self._listen_gc_locked()
            rec = self._listeners.get(lid)
            if rec is None:
                return {"ok": False, "records": []}
            rec["polled"] = time.monotonic()
        out = [
            to_listen_record(ev)
            for ev in rec["sub"].drain()
            if matches_filter(
                ev, rec["bucket"], rec["names"],
                rec["prefix"], rec["suffix"],
            )
        ]
        return {"ok": True, "records": out}

    def listeners(self) -> "dict[str, str]":
        """Live remote listeners: id -> bucket (admin ``listen-stats``)."""
        with self._listen_mu:
            return {lid: rec["bucket"] for lid, rec in self._listeners.items()}

    def _listen_off(self, q, body) -> dict:
        lid = _q1(q, "id")
        with self._listen_mu:
            rec = self._listeners.pop(lid, None)
        if rec is not None:
            self.s3.events.unsubscribe_listener(
                rec["bucket"], rec["sub"]
            )
        return {"ok": True}

    def _invalidate_read_cache(self, q, body) -> dict:
        """Drop this node's tiered-read-cache entries for one object
        (the cross-node half of the mutation seam).  Local-only by
        construction: re-broadcasting here would ping-pong the
        invalidation around the cluster forever."""
        from .. import cache as rcache

        bucket = _q1(q, "bucket")
        obj = _q1(q, "object")
        if not bucket or not obj:
            return {"ok": False, "error": "bucket and object required"}
        return {
            "ok": True,
            "dropped": rcache.invalidate_local(bucket, obj),
        }

    _METHODS = {
        "health": _health,
        "serverinfo": _server_info,
        "loadbucketmetadata": _load_bucket_metadata,
        "deletebucketmetadata": _delete_bucket_metadata,
        "loadiam": _load_iam,
        "loadconfig": _load_config,
        "getlocks": _get_locks,
        "tracebuf": _trace_buf,
        "trace": _trace_buf,  # reference-parity alias
        "consolebuf": _console_buf,
        "startprofiling": _start_profiling,
        "downloadprofiling": _download_profiling,
        "downloadprofilingdata": _download_profiling,  # parity alias
        "healthinfo": _health_info,
        "bghealstatus": _bg_heal_status,
        "backgroundhealstatus": _bg_heal_status,  # parity alias
        "signalservice": _signal_service,
        "cyclebloom": _cycle_bloom,
        "verifyconfig": _verify_config,
        # granular IAM
        "loaduser": _load_user,
        "loadserviceaccount": _load_user,  # same store kind
        "deleteuser": _delete_user,
        "deleteserviceaccount": _delete_user,
        "loadpolicy": _load_policy,
        "deletepolicy": _delete_policy,
        "loadgroup": _load_group,
        "loadpolicymapping": _load_policy_mapping,
        # misc parity
        "getlocaldiskids": _get_local_disk_ids,
        "reloadformat": _reload_format,
        "serverupdate": _server_update,
        "log": _log,
        # granular OBD
        "driveobdinfo": _drive_obd,
        "memobdinfo": _mem_obd,
        "cpuobdinfo": _cpu_obd,
        "osinfoobdinfo": _os_obd,
        "procobdinfo": _proc_obd,
        "diskhwobdinfo": _drive_obd,  # same slice, alias not copy
        "netobdinfo": _net_obd,
        "dispatchnetobdinfo": _dispatch_net_obd,
        # cluster-wide event listen
        "listenon": _listen_on,
        "listenbuf": _listen_buf,
        "listenoff": _listen_off,
        # tiered read cache coherence
        "invalidatereadcache": _invalidate_read_cache,
    }

    # -- dispatch (internode-plane calling convention) --------------------

    def handle(
        self,
        method_name: str,
        query: dict,
        body: bytes,
        headers: "dict | None" = None,
    ) -> tuple[int, bytes, dict]:
        try:
            authz = {
                k.lower(): v for k, v in (headers or {}).items()
            }.get("authorization", "")
            if not authz.startswith("Bearer "):
                raise jwt.JWTError("missing bearer token")
            jwt.verify(authz[len("Bearer ") :], self._secret)
        except Exception as e:  # noqa: BLE001
            return 401, _pack(str(e)), {}
        fn = self._METHODS.get(method_name)
        if fn is None:
            return 400, _pack(f"unknown method {method_name}"), {}
        try:
            return 200, _pack(fn(self, query, body)), {}
        except Exception as e:  # noqa: BLE001
            return 500, _pack(str(e)), {}


class PeerRESTClient:
    """Control-plane client for one peer node (peer-rest-client.go)."""

    def __init__(
        self, host: str, port: int, secret: str, timeout: float = 5.0
    ):
        self.host = host
        self.port = port
        self._secret = secret
        self._timeout = timeout
        self._local = threading.local()
        self._token = ""
        self._token_exp = 0.0

    def _bearer(self) -> str:
        now = time.time()
        if now > self._token_exp - 60:
            self._token = jwt.sign(
                {"sub": "minio-tpu-peer"}, self._secret, _TOKEN_TTL_S
            )
            self._token_exp = now + _TOKEN_TTL_S
        return self._token

    def _conn(self) -> http.client.HTTPConnection:
        from ..utils import tlsconf

        return tlsconf.pooled_connection(
            self._local, self.host, self.port, self._timeout
        )

    def _drop_conn(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception as exc:
                _log.debug("peer connection close failed", extra=kv(err=str(exc)))
            self._local.conn = None

    def call(
        self,
        method: str,
        query: "dict | None" = None,
        doc=None,
        retry: bool = True,
    ):
        """One RPC; raises ConnectionError on transport failure and
        PeerAuthError on a 401.  Peer methods are idempotent so a retry
        on a fresh connection is safe - but fire-and-forget callers pass
        retry=False so a down peer costs one timeout, not two."""
        import urllib.parse

        body = _pack(doc) if doc is not None else b""
        headers = {
            "Authorization": f"Bearer {self._bearer()}",
            "Content-Length": str(len(body)),
        }
        url = f"{PREFIX}/{method}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        attempts = (0, 1) if retry else (0,)
        for attempt in attempts:
            conn = self._conn()
            try:
                conn.request("POST", url, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                break
            except (OSError, http.client.HTTPException):
                self._drop_conn()
                if attempt == attempts[-1]:
                    raise ConnectionError(
                        f"peer {self.host}:{self.port} unreachable"
                    ) from None
        if resp.status == 401:
            # credential mismatch, NOT a transport problem: the
            # bootstrap handshake must treat this as fatal, not retry
            raise PeerAuthError(
                f"peer {self.host}:{self.port} rejected the internode "
                "token - differing credentials?"
            )
        if resp.status != 200:
            raise ConnectionError(
                f"peer {self.host}:{self.port}: HTTP {resp.status} "
                f"{_unpack(payload)!r}"
            )
        return _unpack(payload)

    # -- typed wrappers ---------------------------------------------------

    def health(self) -> dict:
        return self.call("health")

    def server_info(self) -> dict:
        return self.call("serverinfo")

    def load_config(self) -> None:
        self.call("loadconfig", retry=False)

    def load_bucket_metadata(self, bucket: str) -> None:
        self.call("loadbucketmetadata", {"bucket": bucket}, retry=False)

    def delete_bucket_metadata(self, bucket: str) -> None:
        self.call("deletebucketmetadata", {"bucket": bucket}, retry=False)

    def load_iam(self) -> None:
        self.call("loadiam", retry=False)

    def get_locks(self) -> list:
        return self.call("getlocks").get("locks", [])

    def cycle_bloom(self, oldest: int, current: int) -> "dict | None":
        """Peer's data-update filter for [oldest, current); None when
        the peer has no tracker."""
        resp = self.call(
            "cyclebloom", doc={"oldest": oldest, "current": current}
        )
        return resp if resp.get("ok") else None

    def verify_config(self, fingerprint: dict) -> dict:
        return self.call("verifyconfig", doc=fingerprint)

    def get_local_disk_ids(self) -> list:
        return self.call("getlocaldiskids").get("ids", [])

    def reload_format(self) -> dict:
        return self.call("reloadformat", retry=False)

    def listen_on(
        self, lid: str, bucket: str,
        prefix: str = "", suffix: str = "", names=None,
    ) -> None:
        self.call(
            "listenon",
            doc={
                "id": lid, "bucket": bucket, "prefix": prefix,
                "suffix": suffix, "names": sorted(names or []),
            },
            retry=False,
        )

    def listen_buf(self, lid: str) -> "list[dict]":
        resp = self.call("listenbuf", {"id": lid}, retry=False)
        if not resp.get("ok"):
            # the peer GC'd this listener (stalled poller): the caller
            # must re-register, exactly like after a transport error
            raise ConnectionError("listener expired on peer")
        return resp.get("records", [])

    def listen_off(self, lid: str) -> None:
        self.call("listenoff", {"id": lid}, retry=False)

    def invalidate_read_cache(self, bucket: str, obj: str) -> None:
        self.call(
            "invalidatereadcache",
            {"bucket": bucket, "object": obj},
            retry=False,
        )

    def is_online(self) -> bool:
        try:
            return bool(self.health().get("ok"))
        except Exception:  # noqa: BLE001
            return False

    def close(self) -> None:
        self._drop_conn()


class PeerNotifier:
    """Fire-and-forget fan-out to every peer (the NotificationSys
    front half, cmd/notification.go: load/delete broadcasts).

    Pushes run on a small pool so a hung peer cannot stall the S3
    request that triggered the notification; failures are dropped - the
    peer's cache TTL is the convergence backstop.
    """

    def __init__(self, clients: "list[PeerRESTClient]"):
        self.clients = clients
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(8, len(clients) or 1)),
            thread_name_prefix="peer-notify",
        )

    def _fanout(self, fn) -> None:
        for c in self.clients:
            self._pool.submit(self._quiet, fn, c)

    @staticmethod
    def _quiet(fn, client) -> None:
        try:
            fn(client)
        except Exception as exc:
            _log.debug("peer fan-out call failed", extra=kv(err=str(exc)))

    def bucket_meta_changed(self, bucket: str) -> None:
        self._fanout(lambda c: c.load_bucket_metadata(bucket))

    def bucket_meta_deleted(self, bucket: str) -> None:
        self._fanout(lambda c: c.delete_bucket_metadata(bucket))

    def iam_changed(self) -> None:
        self._fanout(lambda c: c.load_iam())

    # granular IAM invalidation: one entity reload instead of a full
    # store re-scan on every peer (LoadUser/LoadPolicy/... RPCs)
    _IAM_METHOD = {
        ("users", False): "loaduser",
        ("users", True): "deleteuser",
        ("sts", False): "loaduser",
        ("sts", True): "deleteuser",
        ("policies", False): "loadpolicy",
        ("policies", True): "deletepolicy",
        ("groups", False): "loadgroup",
        ("groups", True): "loadgroup",  # reload observes the delete
    }

    def iam_entity(
        self, kind: str, name: str, deleted: bool = False
    ) -> None:
        method = self._IAM_METHOD.get((kind, deleted))
        if method is None:
            self.iam_changed()
            return
        self._fanout(
            lambda c: c.call(method, {"name": name}, retry=False)
        )

    def config_changed(self) -> None:
        self._fanout(lambda c: c.load_config())

    def read_cache_invalidated(self, bucket: str, obj: str) -> None:
        """Cross-node mutation seam: peers drop their cached groups of
        (bucket, obj).  Fire-and-forget: a missed invalidation only
        strands entries keyed by a dead data_dir, which the lookup path
        can never reach, because with a peer plane every GET resolves
        the data_dir by a quorum read of xl.meta (the FileInfo side-car
        is off, cache/__init__.py ``sidecar_enabled``)."""
        self._fanout(lambda c: c.invalidate_read_cache(bucket, obj))

    def _gather(self, fn, fallback):
        """Query every peer concurrently on the pool: the wall time for
        an admin aggregation is ONE peer's timeout, not the sum over
        every down node."""
        futs = [self._pool.submit(fn, c) for c in self.clients]
        out = []
        for c, f in zip(self.clients, futs):
            try:
                out.append(f.result())
            except Exception:  # noqa: BLE001
                out.append(fallback(c))
        return out

    def server_infos(self) -> "list[dict]":
        """Concurrent gather (admin ServerInfo aggregation)."""
        return self._gather(
            lambda c: c.server_info(),
            lambda c: {"endpoint": f"{c.host}:{c.port}", "state": "offline"},
        )

    def all_locks(self) -> "list[list]":
        return self._gather(lambda c: c.get_locks(), lambda c: [])

    def cycle_blooms(self, oldest: int, current: int) -> "list[dict | None]":
        """Every peer's update filter; None marks an unreachable or
        trackerless peer (the caller must then treat the union as
        incomplete)."""
        return self._gather(
            lambda c: c.cycle_bloom(oldest, current), lambda c: None
        )

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for c in self.clients:
            c.close()


def verify_cluster(
    clients: "list[PeerRESTClient]",
    fingerprint: dict,
    timeout_s: float = 60.0,
    interval_s: float = 0.5,
) -> None:
    """Boot-time handshake: block until every peer answers verifyconfig
    with ok, raising on fingerprint mismatch (waitForInitConfigs /
    verifyServerSystemConfig semantics: unreachable peers are retried -
    they may simply not be up yet - but a REACHABLE disagreeing peer is
    a fatal operator error)."""
    deadline = time.monotonic() + timeout_s
    pending = list(clients)
    while pending:
        still = []
        for c in pending:
            try:
                res = c.verify_config(fingerprint)
            except PeerAuthError as e:
                # a REACHABLE peer rejecting our token means the nodes
                # were started with different secret keys - fatal now,
                # not after a full timeout of retries
                raise RuntimeError(
                    f"{e} - check that every node was started with "
                    "identical credentials"
                ) from None
            except ConnectionError:
                still.append(c)  # not up yet
                continue
            if not res.get("ok"):
                raise RuntimeError(
                    f"peer {c.host}:{c.port} disagrees on cluster config "
                    f"(mismatched: {res.get('mismatch')}) - check that "
                    "every node was started with identical credentials "
                    "and endpoint arguments"
                )
        pending = still
        if pending and time.monotonic() > deadline:
            names = [f"{c.host}:{c.port}" for c in pending]
            raise RuntimeError(
                f"bootstrap handshake timed out waiting for {names}"
            )
        if pending:
            time.sleep(interval_s)
