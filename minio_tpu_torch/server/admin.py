"""Admin API (cmd/admin-router.go:40-230 + admin-handlers.go subset).

Mounted at ``/minio-tpu/admin/v1`` behind SigV4 auth; only the owner
(root credential) may call it, mirroring the reference's adminAPI
privilege default.  The routes answer as the JAX package's do, for
this node: server and storage info, heal and the background-heal
status, service stop/restart, codec kernel telemetry, profiling, the
runtime KV config, IAM management (users, groups, service accounts,
canned policies), the KMS key status, the server-loop status and
wedge, the read cache's stats and clear, the disk cache's stats,
remote fault injection, healthinfo, bucket quotas, the replication
remote targets, and the data crawler's usage snapshot and forced
crawl.  ``listen-stats`` (the live ListenBucketNotification streams and
the peers' remote listeners held here) and ``request-stages`` (the
stage spans of the requests served since the last call, utils/spans.py)
are this package's own, like the launch counts in ``kernel-stats``.  In a cluster, info, healthinfo, the background-heal status,
top-locks and profiling gather every peer's answer over the peer plane
(cluster/peer.py), and service stop/restart is sent to the peers first.

An unknown route answers ``MethodNotAllowed``, so no admin call is
silently ignored.
"""

from __future__ import annotations

import json
import threading
import time

from .. import cache as rcache
from ..codec import kms as kmsmod
from ..crawler import DataUsage
from ..heal.sequence import AllHealState, HealSequence, HealSequenceError
from ..iam.policy import Policy, PolicyError
from ..iam.sys import IAMError, PolicyNotFound, UserNotFound
from ..objectlayer.quota import QuotaConfig, QuotaError
from .s3errors import S3Error

from ..utils.log import kv, logger

_log = logger("admin")

# guards lazy creation of the per-server heal-sequence registry
_heal_state_lock = threading.Lock()

PREFIX = "/minio-tpu/admin/v1"
VERSION = "0.3.0"
_START = time.time()


class AdminAPI:
    """Routes one admin request; constructed per server."""

    def __init__(self, server):
        self.s3 = server

    # -- dispatch ---------------------------------------------------------

    def handle(
        self, method: str, tail: str, q: "dict[str, str]", body: bytes
    ) -> "tuple[int, bytes]":
        ol = self.s3.object_layer
        if ol is None:
            raise S3Error("ServerNotInitialized")
        route = (method, tail)
        if route == ("GET", "info"):
            return 200, self._info(ol)
        if route == ("GET", "storageinfo"):
            return 200, _json(ol.storage_info())
        if route == ("POST", "heal"):
            return 200, self._heal(ol, q)
        # resumable heal sequences with client tokens
        # (admin-heal-ops.go LaunchNewHealSequence/PopHealStatusJSON)
        if route == ("POST", "heal-sequence"):
            return 200, self._heal_sequence(ol, q)
        if route == ("POST", "heal-sequence/stop"):
            state = self._heal_state()
            try:
                return 200, _json(state.stop(self._heal_path(q)))
            except HealSequenceError as e:
                raise S3Error(e.code, str(e)) from None
        # aggregate MRF/background-heal state, every node
        # (getAggregatedBackgroundHealState, admin-heal-ops.go)
        if route == ("GET", "background-heal/status"):
            doc = {"nodes": [self._bg_heal_local()]}
            peers = getattr(self.s3, "peer_notifier", None)
            if peers is not None:
                doc["nodes"].extend(
                    peers._gather(
                        lambda c: c.call(
                            "bghealstatus", retry=False
                        ),
                        lambda c: {
                            "endpoint": f"{c.host}:{c.port}",
                            "state": "offline",
                        },
                    )
                )
            return 200, _json(doc)
        if route == ("GET", "top-locks"):
            return 200, self._top_locks()
        if route == ("GET", "listen-stats"):
            # this package's own instrumentation (the JAX package has no
            # such route): every subscription on this node's notifier
            # (local streams and peers' remote listeners), and the latter
            plane = self.s3.peer_rest
            remote = plane.listeners() if plane is not None else {}
            return 200, _json({
                "subscriptions": self.s3.events.listeners.num_subscribers,
                "remote": len(remote),
                "remote_buckets": sorted(remote.values()),
            })
        if route == ("GET", "cache-stats"):
            # the disk cache (objectlayer/cache.py) when it fronts the layer
            stats_fn = getattr(ol, "cache_stats", None)
            if stats_fn is None:
                return 200, _json({"enabled": False})
            return 200, _json({"enabled": True, **stats_fn()})
        if route == ("GET", "datausage"):
            crawler = self.s3.crawler
            if crawler is None:
                return 200, _json(DataUsage().to_dict())
            return 200, _json(crawler.usage().to_dict())
        if route == ("POST", "crawl"):
            crawler = self.s3.crawler
            if crawler is None:
                raise S3Error("ServerNotInitialized")
            # an explicit admin crawl bypasses the freshness gate
            return 200, _json(crawler.crawl_once(force=True).to_dict())
        # bucket quota (admin SetBucketQuota / GetBucketQuotaConfig)
        if route == ("GET", "get-bucket-quota"):
            ol.get_bucket_info(_req(q, "bucket"))
            raw = self.s3.bucket_meta.get(_req(q, "bucket")).quota_json
            return 200, (raw.encode() if raw else b"{}")
        if route == ("PUT", "set-bucket-quota"):
            bucket = _req(q, "bucket")
            ol.get_bucket_info(bucket)
            if body.strip() in (b"", b"{}"):
                self.s3.bucket_meta.update(bucket, quota_json="")
                return 200, b"{}"
            try:
                cfg = QuotaConfig.from_json(body)
            except QuotaError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            self.s3.bucket_meta.update(
                bucket, quota_json=cfg.to_json()
            )
            return 200, b"{}"
        # replication remote targets (admin SetRemoteTarget)
        if route == ("GET", "list-remote-targets"):
            bucket = _req(q, "bucket")
            ol.get_bucket_info(bucket)
            raw = self.s3.bucket_meta.get(bucket).replication_targets_json
            return 200, (raw.encode() if raw else b"[]")
        if route == ("PUT", "set-remote-target"):
            bucket = _req(q, "bucket")
            ol.get_bucket_info(bucket)
            doc = _body_json(body)
            for field in ("endpoint", "access_key", "secret_key",
                          "target_bucket"):
                if not doc.get(field):
                    raise S3Error(
                        "InvalidArgument", f"missing {field}"
                    )
            raw = self.s3.bucket_meta.get(
                bucket
            ).replication_targets_json
            try:
                docs = json.loads(raw) if raw else []
            except ValueError:
                docs = []
            docs = [
                d
                for d in docs
                if d.get("target_bucket") != doc["target_bucket"]
            ] + [doc]
            self.s3.bucket_meta.update(
                bucket, replication_targets_json=json.dumps(docs)
            )
            return 200, _json(
                {
                    "arn": (
                        "arn:minio:replication:::"
                        + doc["target_bucket"]
                    )
                }
            )
        if tail.startswith("fault/"):
            return self._fault(method, tail, body)
        # tiered read cache (cache/tiered.py): device+host tiers of
        # digest-verified encoded groups in front of the quorum reader
        if route == ("GET", "read-cache-stats"):
            return 200, _json(rcache.read_cache_stats())
        if route == ("POST", "read-cache-clear"):
            return 200, _json({"cleared": rcache.clear_read_cache()})
        # cluster health diagnostics (admin-handlers.go:1007
        # OBDInfoHandler): system + per-drive microbenchmarks, every
        # node, one JSON document
        if route == ("GET", "healthinfo"):
            doc = {"nodes": [self._health_info_local(ol)]}
            peers = getattr(self.s3, "peer_notifier", None)
            if peers is not None:
                # concurrent gather, no retry: wall time is ONE
                # node's probe, and a dead peer costs one timeout
                doc["nodes"].extend(
                    peers._gather(
                        lambda c: c.call("healthinfo", retry=False),
                        lambda c: {
                            "endpoint": f"{c.host}:{c.port}",
                            "state": "offline",
                        },
                    )
                )
            return 200, _json(doc)
        # KMS key status (admin-handlers.go KMSKeyStatusHandler): a full
        # generate->unseal roundtrip proves the configured KMS can both
        # mint and open data keys for this key id
        if route == ("GET", "kms/key/status"):
            return 200, _json(_kms_key_status(q))
        # service control (ServiceHandler, admin-handlers.go:192):
        # stop/restart THIS node, fanned out to peers first
        if route == ("POST", "service"):
            action = q.get("action", "")
            if action not in ("stop", "restart"):
                raise S3Error(
                    "InvalidArgument",
                    "action must be stop or restart",
                )
            peers = getattr(self.s3, "peer_notifier", None)
            signalled = []
            if peers is not None:
                for c in peers.clients:
                    try:
                        c.call(
                            "signalservice", {"action": action},
                            retry=False,
                        )
                        signalled.append(f"{c.host}:{c.port}")
                    except Exception as exc:
                        _log.debug("peer signal failed", extra=kv(err=str(exc)))
            self._signal_self(action)
            return 200, _json(
                {"action": action, "peers_signalled": signalled}
            )
        # codec kernel telemetry dump (codec/telemetry.py): per-op
        # calls/bytes/device-seconds, batcher occupancy, device passes
        if route == ("GET", "kernel-stats"):
            from ..codec.telemetry import KERNEL_STATS
            from ..ops import kernels

            doc = KERNEL_STATS.snapshot()
            # this process's kernel launches by wrapper (ops/kernels.py
            # LAUNCHES; all zero on the CPU codec's plain versions): how
            # a cluster run reads each node's launches
            doc["launches"] = dict(kernels.LAUNCHES)
            return 200, _json(doc)
        # this process's request stage spans since the last call
        # (utils/spans.py), oldest first; reading clears them
        if route == ("GET", "request-stages"):
            from ..utils import spans

            return 200, _json({"records": spans.drain(),
                               "threads": spans.thread_cpu()})
        # profiling (admin-router.go:82): start on every node, download
        # collects per-node artifacts in one JSON document
        if route == ("POST", "profiling/start"):
            kind = q.get("type", "cpu")
            try:
                self.s3.profiler.start(kind)
            except (ValueError, RuntimeError) as e:
                raise S3Error("InvalidArgument", str(e)) from None
            peers = getattr(self.s3, "peer_notifier", None)
            started = [self.s3.tracer.node]
            if peers is not None:
                for c in peers.clients:
                    try:
                        c.call("startprofiling", {"type": kind})
                        started.append(f"{c.host}:{c.port}")
                    except Exception as exc:
                        _log.debug("peer profiling start failed", extra=kv(err=str(exc)))
            return 200, _json({"started": started, "type": kind})
        if route == ("GET", "profiling/download"):
            import base64

            kind = q.get("type", "cpu")
            profiles: dict = {}
            local_err = ""
            try:
                profiles[self.s3.tracer.node] = base64.b64encode(
                    self.s3.profiler.stop(kind)
                ).decode()
            except RuntimeError as e:
                # still stop the PEERS: bailing here would leave
                # cProfile running on every other node forever
                local_err = str(e)
            peers = getattr(self.s3, "peer_notifier", None)
            if peers is not None:
                for c in peers.clients:
                    try:
                        res = c.call("downloadprofiling", {"type": kind})
                        profiles[f"{c.host}:{c.port}"] = (
                            base64.b64encode(
                                res.get("profile", b"")
                            ).decode()
                        )
                    except Exception:  # noqa: BLE001
                        profiles[f"{c.host}:{c.port}"] = ""
            if local_err and not any(profiles.values()):
                raise S3Error("InvalidArgument", local_err)
            return 200, _json(
                {
                    "type": kind,
                    "profiles": profiles,
                    **({"local_error": local_err} if local_err else {}),
                }
            )
        # server-loop observability + wedge
        if tail in ("loops/status", "loops/wedge"):
            return self._loops(method, tail, body)
        # runtime KV config (admin-router.go:89 set-config-kv family)
        if route == ("GET", "get-config"):
            return 200, _json(self.s3.config.dump())
        if route == ("GET", "config-help"):
            from ..config import ConfigError

            try:
                return 200, _json(
                    self.s3.config.help(_req(q, "subsys"))
                )
            except ConfigError as e:
                raise S3Error("InvalidArgument", str(e)) from None
        if route == ("PUT", "set-config-kv"):
            from ..config import ConfigError

            try:
                self.s3.config.set_kvs(
                    _req(q, "subsys"),
                    _body_json(body),
                    q.get("target", "_"),
                )
            except ConfigError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return 200, b"{}"
        if route == ("DELETE", "del-config-kv"):
            from ..config import ConfigError

            try:
                self.s3.config.del_kvs(
                    _req(q, "subsys"), q.get("target", "_")
                )
            except ConfigError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return 200, b"{}"
        # IAM management
        iam = self.s3.iam
        if route == ("GET", "list-users"):
            return 200, _json(iam.list_users())
        if route == ("PUT", "add-user"):
            doc = _body_json(body)
            iam.add_user(
                _req(q, "accessKey"),
                doc.get("secretKey", ""),
                doc.get("policy", ""),
            )
            return 200, b"{}"
        if route == ("DELETE", "remove-user"):
            iam.remove_user(_req(q, "accessKey"))
            return 200, b"{}"
        if route == ("PUT", "set-user-policy"):
            iam.set_user_policy(_req(q, "accessKey"), q.get("name", ""))
            return 200, b"{}"
        if route == ("PUT", "set-user-status"):
            iam.set_user_status(
                _req(q, "accessKey"), q.get("status") == "enabled"
            )
            return 200, b"{}"
        if route == ("POST", "service-account"):
            ak, sk = iam.add_service_account(_req(q, "parent"))
            return 200, _json({"accessKey": ak, "secretKey": sk})
        # groups (admin-router.go update-group-members / group status)
        if route == ("GET", "groups"):
            return 200, _json(iam.list_groups())
        if route == ("GET", "group"):
            return 200, _json(iam.group_info(_req(q, "group")))
        if route == ("PUT", "update-group-members"):
            doc = _body_json(body)
            members = doc.get("members", [])
            if doc.get("isRemove"):
                iam.remove_group_members(_req(q, "group"), members)
            else:
                iam.add_group_members(_req(q, "group"), members)
            return 200, b"{}"
        if route == ("PUT", "set-group-policy"):
            iam.set_group_policy(_req(q, "group"), q.get("name", ""))
            return 200, b"{}"
        if route == ("PUT", "set-group-status"):
            iam.set_group_status(
                _req(q, "group"), q.get("status") == "enabled"
            )
            return 200, b"{}"
        if route == ("GET", "list-canned-policies"):
            return 200, _json(
                {
                    name: iam.get_policy(name).to_dict()
                    for name in iam.list_policies()
                }
            )
        if route == ("PUT", "add-canned-policy"):
            try:
                pol = Policy.from_json(body)
            except PolicyError as e:
                raise S3Error("MalformedPolicy", str(e)) from None
            iam.set_policy(_req(q, "name"), pol)
            return 200, b"{}"
        if route == ("DELETE", "remove-canned-policy"):
            iam.remove_policy(_req(q, "name"))
            return 200, b"{}"
        raise S3Error("MethodNotAllowed", f"admin {method} /{tail}")

    # -- handlers ---------------------------------------------------------

    def _loops(
        self, method: str, tail: str, body: bytes
    ) -> "tuple[int, bytes]":
        """Server-loop control plane.

        GET  loops/status  per-loop state/connections/inflight/sheds
                           (available in every mode; threaded reports
                           zero loops).
        POST loops/wedge   {loop, seconds} - busy-spin one loop's
                           thread so a chaos run can prove a wedged
                           loop degrades only its own shard.  Gated on
                           MINIO_TPU_FAULT_INJECTION=1 like disk faults
                           (a server whose ``fault_disks`` is set).
        """
        plane = getattr(self.s3, "_plane", None)
        if (method, tail) == ("GET", "loops/status"):
            doc = {
                "mode": getattr(self.s3, "server_mode", "threaded"),
            }
            if plane is not None:
                doc.update(plane.describe())
            else:
                doc.update(count=0, reuseport=False, per_loop=[])
            return 200, _json(doc)
        if (method, tail) != ("POST", "loops/wedge"):
            raise S3Error("MethodNotAllowed", f"admin {method} /{tail}")
        if not getattr(self.s3, "fault_disks", None):
            raise S3Error(
                "InvalidArgument",
                "fault injection disabled: start the server with "
                "MINIO_TPU_FAULT_INJECTION=1",
            )
        if plane is None:
            raise S3Error(
                "InvalidArgument",
                "no async plane to wedge (MINIO_TPU_SERVER=threaded)",
            )
        doc = _body_json(body) if body.strip() else {}
        try:
            index = int(doc.get("loop", -1))
            seconds = float(doc.get("seconds", 0.0))
        except (TypeError, ValueError):
            raise S3Error(
                "InvalidArgument", "loop/seconds must be numeric"
            ) from None
        if seconds <= 0 or seconds > 300:
            raise S3Error(
                "InvalidArgument", "seconds must be in (0, 300]"
            )
        if not plane.wedge_loop(index, seconds):
            raise S3Error(
                "InvalidArgument",
                f"no such loop {index} (have {len(plane.loops)})",
            )
        _log.info(
            "server loop wedged",
            extra=kv(loop=index, seconds=seconds),
        )
        return 200, _json({"wedged": index, "seconds": seconds})

    def _fault(
        self, method: str, tail: str, body: bytes
    ) -> "tuple[int, bytes]":
        """Remote fault control for the cluster harness.

        POST fault/inject  {disk, api, delay_s, hang_s, error, corrupt,
                            prob, calls} - add one schedule rule; "disk"
                            matches a local drive root by suffix ("*"
                            or absent = every local drive).
        POST fault/clear   {disk} - lift rules + release parked hangs.
        GET  fault/status  per-drive rule count + injected-action tally.
        """
        fault_disks = getattr(self.s3, "fault_disks", None)
        if not fault_disks:
            raise S3Error(
                "InvalidArgument",
                "fault injection disabled: start the server with "
                "MINIO_TPU_FAULT_INJECTION=1",
            )
        if (method, tail) == ("GET", "fault/status"):
            return 200, _json(
                {
                    root: {
                        "rules": fd.rule_count(),
                        "injected": fd.injected(),
                    }
                    for root, fd in sorted(fault_disks.items())
                }
            )
        doc = _body_json(body) if body.strip() else {}
        sel = str(doc.get("disk", "*"))
        matched = {
            root: fd
            for root, fd in fault_disks.items()
            if sel in ("", "*") or root.endswith(sel)
        }
        if not matched:
            raise S3Error(
                "InvalidArgument", f"no local drive matches {sel!r}"
            )
        if (method, tail) == ("POST", "fault/clear"):
            for fd in matched.values():
                fd.clear()
            return 200, _json({"cleared": sorted(matched)})
        if (method, tail) != ("POST", "fault/inject"):
            raise S3Error("MethodNotAllowed", f"admin {method} /{tail}")
        api = doc.get("api")
        if not api:
            raise S3Error("InvalidArgument", "missing api")
        calls = doc.get("calls")
        if calls is not None and not isinstance(calls, list):
            raise S3Error("InvalidArgument", "calls must be a list")
        for fd in matched.values():
            fd.inject(
                str(api),
                delay_s=float(doc.get("delay_s", 0.0)),
                hang_s=float(doc.get("hang_s", 0.0)),
                error=bool(doc.get("error", False)),
                corrupt=bool(doc.get("corrupt", False)),
                prob=float(doc.get("prob", 1.0)),
                calls=calls,
            )
        _log.info(
            "fault schedule injected",
            extra=kv(api=str(api), disks=len(matched)),
        )
        # the parked hang is the product here: an injected fault
        # schedule deliberately outlives this request and is released
        # by a later POST fault/clear, never by this frame
        return 200, _json({"injected": sorted(matched)})  # noqa: MTPU601,MTPU603 - the hang outlives the request by design

    def _info(self, ol) -> bytes:
        si = ol.storage_info()
        disks = []
        from .metrics import _iter_disks

        for d in _iter_disks(ol):
            if d is None:
                disks.append({"state": "offline"})
                continue
            try:
                info = d.disk_info()
                disks.append(
                    {
                        "endpoint": info.endpoint,
                        "state": "ok" if d.is_online() else "offline",
                        "total": info.total,
                        "used": info.used,
                        "free": info.free,
                    }
                )
            except Exception:  # noqa: BLE001
                disks.append({"state": "offline"})
        doc = {
            "version": VERSION,
            "uptime_seconds": round(time.time() - _START, 1),
            "mode": "erasure",
            "storage": si,
            "disks": disks,
        }
        # distributed mode: one entry per peer via the control plane
        # (madmin ServerInfo aggregates every node)
        notifier = getattr(self.s3, "peer_notifier", None)
        if notifier is not None:
            doc["mode"] = "distributed"
            doc["nodes"] = notifier.server_infos()
        return _json(doc)

    def _top_locks(self) -> bytes:
        """Held locks across the cluster (madmin TopLocks): this
        node's local locker plus every peer's via the control plane."""
        locks: list = []
        local = getattr(self.s3, "local_locker", None)
        if local is not None:
            locks.extend(local.dump())
        notifier = getattr(self.s3, "peer_notifier", None)
        if notifier is not None:
            for node_locks in notifier.all_locks():
                locks.extend(node_locks)
        return _json({"locks": locks})


    def _health_info_local(self, ol) -> dict:
        """This node's OBD document: platform + memory + per-local-drive
        latency/throughput microprobe (the reference's getLocalDrivesOBD
        probe, obdinfo.go), with the read-cache, Select and codec-overlap
        blocks the JAX package reports."""
        import os as _os
        import platform
        from concurrent.futures import ThreadPoolExecutor

        from ..codec.telemetry import KERNEL_STATS
        from ..ops import codec_step
        from ..s3select import device as seldev
        from .metrics import _iter_disks
        from .select import scan_device

        doc = {
            "endpoint": getattr(self.s3, "endpoint", ""),
            "state": "online",
            "version": VERSION,
            "uptime_seconds": round(time.time() - _START, 1),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "cpus": _os.cpu_count(),
            # request-plane mode + admission/backpressure counters
            "server_plane": dict(
                self.s3.plane_stats.snapshot(),
                mode=getattr(self.s3, "server_mode", "threaded"),
            )
            if getattr(self.s3, "plane_stats", None) is not None
            else {},
        }
        plane = getattr(self.s3, "_plane", None)
        doc["server_loops"] = (
            plane.describe()
            if plane is not None
            else {"count": 0, "reuseport": False, "per_loop": []}
        )
        admission = getattr(self.s3, "admission", None)
        if admission is not None:
            doc["admission"] = {
                "tenant_inflight": admission.tenant_inflight(),
                "tenant_hwm": admission.budget.tenant_hwm(),
                "select_inflight": admission.budget.select.value(),
                "select_hwm": admission.budget.select.hwm,
            }
        # zero-filled when off, so the shape is stable across modes
        doc["read_cache"] = rcache.read_cache_stats()
        doc["select"] = dict(
            seldev.STATS.snapshot(), mode=seldev.select_mode()
        )
        ksnap = KERNEL_STATS.snapshot()
        doc["codec_overlap"] = {
            "mode": codec_step.codec_overlap_mode(scan_device(self.s3)),
            "overlap_windows": ksnap["overlap_windows"],
            "h2d": ksnap["h2d"],
            "d2h": ksnap["d2h"],
        }
        try:
            page = _os.sysconf("SC_PAGE_SIZE")
            doc["mem_total_bytes"] = page * _os.sysconf("SC_PHYS_PAGES")
            doc["mem_available_bytes"] = page * _os.sysconf(
                "SC_AVPHYS_PAGES"
            )
        except (ValueError, OSError, AttributeError):
            pass
        probe = b"\0" * (1 << 20)

        def probe_drive(d) -> dict:
            import uuid as _uuid

            # unique path per request (concurrent OBD calls must not
            # race each other's probe files) + guaranteed cleanup
            path = f"tmp/obd-probe-{_uuid.uuid4().hex}"
            entry = {"endpoint": ""}
            try:
                info = d.disk_info()
                entry.update(
                    endpoint=info.endpoint, total=info.total, free=info.free
                )
                t0 = time.monotonic()
                d.write_all(".sys", path, probe)
                t1 = time.monotonic()
                try:
                    d.read_all(".sys", path)
                    t2 = time.monotonic()
                finally:
                    try:
                        d.delete_file(".sys", path)
                    except Exception as exc:  # noqa: BLE001 - best effort
                        _log.debug("obd probe file cleanup failed", extra=kv(err=str(exc)))
                entry["write_mibps"] = round(1 / max(t1 - t0, 1e-9), 1)
                entry["read_mibps"] = round(1 / max(t2 - t1, 1e-9), 1)
                entry["latency_ms"] = round((t1 - t0) * 1e3, 2)
                entry["state"] = "ok"
            except Exception as e:  # noqa: BLE001 - reported in the entry
                entry["state"] = f"error: {type(e).__name__}"
            stats_fn = getattr(d, "api_stats", None)
            if callable(stats_fn):
                try:
                    entry["api_stats"] = stats_fn()
                except Exception as exc:  # noqa: BLE001
                    _log.debug("disk api_stats read failed", extra=kv(err=str(exc)))
            h = getattr(d, "health", None)
            if h is not None:
                try:
                    entry["health"] = h.snapshot()
                except Exception as exc:  # noqa: BLE001
                    _log.debug("disk health read failed", extra=kv(err=str(exc)))
            return entry

        local = [
            d
            for d in _iter_disks(ol)
            if d is not None and getattr(d, "is_local", lambda: False)()
        ]
        # concurrent probes: wall time is one drive's probe
        if local:
            with ThreadPoolExecutor(max_workers=min(8, len(local))) as pool:
                doc["drives"] = list(pool.map(probe_drive, local))
        else:
            doc["drives"] = []
        return doc

    def _bg_heal_local(self) -> dict:
        routine = getattr(self.s3, "heal_routine", None)
        queue = getattr(self.s3, "heal_queue", None)
        return {
            "endpoint": getattr(self.s3, "endpoint", ""),
            "state": "online",
            "enabled": routine is not None,
            "queued": len(queue) if queue is not None else 0,
            "healed": getattr(routine, "healed", 0),
            "failed": getattr(routine, "failed", 0),
        }

    @staticmethod
    def _signal_self(action: str) -> None:
        """Deliver the service signal to this process AFTER the HTTP
        response flushes (a small delay thread, like the reference's
        deferred serviceSignalCh send)."""
        import os as _os
        import signal as _signal
        import sys as _sys
        import threading as _threading
        import time as _time

        def fire():
            _time.sleep(0.5)
            if action == "stop":
                _os.kill(_os.getpid(), _signal.SIGTERM)
            else:  # restart: re-exec the same argv in place
                try:
                    _os.execv(_sys.executable, [_sys.executable] + _sys.argv)
                except OSError:
                    _os.kill(_os.getpid(), _signal.SIGTERM)

        _threading.Thread(target=fire, daemon=True).start()

    def _heal_state(self) -> AllHealState:
        # double-checked under a module lock: two concurrent launches
        # must share ONE registry or tokens and overlap guards split
        with _heal_state_lock:
            state = getattr(self.s3, "heal_state", None)
            if state is None:
                state = self.s3.heal_state = AllHealState()
        return state

    @staticmethod
    def _heal_path(q: "dict[str, str]") -> str:
        bucket = q.get("bucket", "")
        if not bucket:
            raise S3Error("InvalidArgument", "heal requires bucket")
        prefix = q.get("prefix", "")
        return f"{bucket}/{prefix}".rstrip("/")

    def _heal_sequence(self, ol, q: "dict[str, str]") -> bytes:
        """Launch (no clientToken) or poll (clientToken) a heal
        sequence; maps HealSequenceError onto admin API errors."""
        state = self._heal_state()
        path = self._heal_path(q)
        token = q.get("clientToken", "")
        try:
            if token:
                return _json(state.pop_status(path, token))
            seq = HealSequence(
                ol,
                q.get("bucket", ""),
                q.get("prefix", ""),
                dry_run=q.get("dryRun") == "true",
                client_address=q.get("clientAddress", ""),
            )
            return _json(
                state.launch(seq, q.get("forceStart") == "true")
            )
        except HealSequenceError as e:
            raise S3Error(e.code, str(e)) from None

    def _heal(self, ol, q: "dict[str, str]") -> bytes:
        bucket = q.get("bucket", "")
        obj = q.get("object", "")
        dry = q.get("dryRun") == "true"
        if not bucket:
            raise S3Error("InvalidArgument", "heal requires bucket")
        if obj:
            res = ol.heal_object(
                bucket, obj, q.get("versionId", ""), dry_run=dry
            )
        else:
            res = ol.heal_bucket(bucket, dry_run=dry)
        return _json(res)


def _json(doc) -> bytes:
    return json.dumps(doc).encode()


def _body_json(body: bytes) -> dict:
    try:
        doc = json.loads(body or b"{}")
    except ValueError:
        raise S3Error("InvalidArgument", "malformed JSON body") from None
    if not isinstance(doc, dict):
        raise S3Error("InvalidArgument", "JSON object expected")
    return doc


def _req(q: "dict[str, str]", key: str) -> str:
    v = q.get(key, "")
    if not v:
        raise S3Error("InvalidArgument", f"missing {key}")
    return v


def map_admin_error(e: Exception) -> "S3Error | None":
    from ..iam.sys import GroupNotFound

    if isinstance(e, UserNotFound):
        return S3Error("InvalidArgument", f"no such user: {e}")
    if isinstance(e, PolicyNotFound):
        return S3Error("InvalidArgument", f"no such policy: {e}")
    if isinstance(e, GroupNotFound):
        return S3Error("InvalidArgument", f"no such group: {e}")
    if isinstance(e, IAMError):
        return S3Error("InvalidArgument", str(e))
    return None


def _kms_key_status(q: "dict[str, str]") -> dict:
    """The ``kms/key/status`` document: the key id, the KMS's info and
    the verdicts of one generate->unseal round trip."""
    kms = kmsmod.get_kms()
    if kms is None:
        raise S3Error("InvalidArgument", "KMS is not configured")
    key_id = q.get("key-id") or kms.default_key_id()
    status = {"key-id": key_id, **kms.info()}
    ctx = {"path": "admin/kms-status-check"}
    try:
        dk, sealed = kms.generate_key(key_id, ctx)
        status["encryption"] = "success"
    except kmsmod.KMSError as e:
        status["encryption"] = f"failed: {e}"
        return status
    try:
        if kms.unseal_key(key_id, sealed, ctx) == dk:
            status["decryption"] = "success"
        else:
            status["decryption"] = "failed: key mismatch"
    except kmsmod.KMSError as e:
        status["decryption"] = f"failed: {e}"
    return status
