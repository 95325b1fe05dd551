"""Admin API (cmd/admin-router.go:40-230 + admin-handlers.go subset).

Mounted at ``/minio-tpu/admin/v1`` behind SigV4 auth; only the owner
(root credential) may call it, mirroring the reference's adminAPI
privilege default.  The routes answer as the JAX package's do, for
this node: server and storage info, heal and the background-heal
status, service stop/restart, codec kernel telemetry, profiling, the
runtime KV config, IAM management (users, groups, service accounts,
canned policies), the KMS key status and the server-loop status and
wedge.

A route of a feature this package has not ported answers S3
``NotImplemented`` naming the slice that ports it (``UNPORTED``), so
no admin call is silently ignored.
"""

from __future__ import annotations

import json
import time

from ..codec import kms as kmsmod
from ..iam.policy import Policy, PolicyError
from ..iam.sys import IAMError, PolicyNotFound, UserNotFound
from ..objectlayer.api import unported
from .s3errors import S3Error

from ..utils.log import kv, logger

_log = logger("admin")

PREFIX = "/minio-tpu/admin/v1"
VERSION = "0.3.0"
_START = time.time()

# admin routes of features not ported yet: route -> (what, slice).  The
# distributed planes, heal sequences, the crawler and the lock plane are
# slice 9b; the read cache (and healthinfo, which reports it and the
# Select device) 9a; the disk cache, bucket quota and the replication
# targets 9c.
UNPORTED = {
    ("POST", "heal-sequence"): ("admin heal sequences", "9b"),
    ("POST", "heal-sequence/stop"): ("admin heal sequences", "9b"),
    ("GET", "datausage"): ("the data crawler's usage", "9b"),
    ("POST", "crawl"): ("the data crawler", "9b"),
    ("GET", "top-locks"): ("the lock plane's top-locks", "9b"),
    ("POST", "fault/inject"): ("remote fault injection", "9b"),
    ("POST", "fault/clear"): ("remote fault injection", "9b"),
    ("GET", "fault/status"): ("remote fault injection", "9b"),
    ("GET", "read-cache-stats"): ("the tiered read cache", "9a"),
    ("POST", "read-cache-clear"): ("the tiered read cache", "9a"),
    ("GET", "healthinfo"): ("admin healthinfo", "9a"),
    ("GET", "cache-stats"): ("the disk cache", "9c"),
    ("GET", "get-bucket-quota"): ("bucket quota", "9c"),
    ("PUT", "set-bucket-quota"): ("bucket quota", "9c"),
    ("GET", "list-remote-targets"): ("bucket replication targets", "9c"),
    ("PUT", "set-remote-target"): ("bucket replication targets", "9c"),
}


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
        if route in UNPORTED:
            what, slice_name = UNPORTED[route]
            raise unported(what, slice_name)
        if route == ("GET", "info"):
            return 200, self._info(ol)
        if route == ("GET", "storageinfo"):
            return 200, _json(ol.storage_info())
        if route == ("POST", "heal"):
            return 200, self._heal(ol, q)
        # MRF/background-heal state of this node (the peers' rows come
        # with the peer plane, slice 9b)
        if route == ("GET", "background-heal/status"):
            return 200, _json({"nodes": [self._bg_heal_local()]})
        # KMS key status (admin-handlers.go KMSKeyStatusHandler): a full
        # generate->unseal roundtrip proves the configured KMS can both
        # mint and open data keys for this key id
        if route == ("GET", "kms/key/status"):
            return 200, _json(_kms_key_status(q))
        # service control (ServiceHandler, admin-handlers.go:192):
        # stop/restart THIS node
        if route == ("POST", "service"):
            action = q.get("action", "")
            if action not in ("stop", "restart"):
                raise S3Error(
                    "InvalidArgument",
                    "action must be stop or restart",
                )
            self._signal_self(action)
            return 200, _json({"action": action, "peers_signalled": []})
        # codec kernel telemetry dump (codec/telemetry.py): per-op
        # calls/bytes/device-seconds, batcher occupancy, device passes
        if route == ("GET", "kernel-stats"):
            from ..codec.telemetry import KERNEL_STATS

            return 200, _json(KERNEL_STATS.snapshot())
        # profiling (admin-router.go:82) on this node
        if route == ("POST", "profiling/start"):
            kind = q.get("type", "cpu")
            try:
                self.s3.profiler.start(kind)
            except (ValueError, RuntimeError) as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return 200, _json({"started": [self.s3.tracer.node], "type": kind})
        if route == ("GET", "profiling/download"):
            import base64

            kind = q.get("type", "cpu")
            try:
                profile = self.s3.profiler.stop(kind)
            except RuntimeError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return 200, _json(
                {
                    "type": kind,
                    "profiles": {
                        self.s3.tracer.node: base64.b64encode(
                            profile
                        ).decode()
                    },
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
                           loop degrades only its own shard.  Gated like
                           the JAX package's: only a server whose
                           embedder set ``fault_disks`` accepts it (the
                           server CLI refuses MINIO_TPU_FAULT_INJECTION
                           until slice 9b).
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
        return _json(
            {
                "version": VERSION,
                "uptime_seconds": round(time.time() - _START, 1),
                "mode": "erasure",
                "storage": si,
                "disks": disks,
            }
        )

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
