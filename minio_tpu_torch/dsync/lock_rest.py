"""Lock REST plane: the NetLocker service each node exposes to peers
(cmd/lock-rest-server.go:87, lock-rest-client.go).

Mounted on the node's single internode listener under
/minio-tpu/lock/v1/<method> next to the storage plane (routers.go:25-38):
POST bodies are MessagePack {uid, resources, source} (storage/mpack.py,
byte-equal to msgpack's), responses are MessagePack booleans, and every
request carries the internode JWT.  Connection failures surface as False grants on lock/rlock (the requesting DRWMutex
counts them against tolerance) and are swallowed on release/refresh
(the entry ages out server-side).
"""

from __future__ import annotations

import http.client
import random
import threading
import time

from ..storage import mpack
from ..utils import jwt
from .drwmutex import LockArgs, NetLocker
from .local_locker import LocalLocker

from ..utils.log import kv, logger

_log = logger("dsync")

PREFIX = "/minio-tpu/lock/v1"
_TOKEN_TTL_S = 900

_METHODS = ("lock", "unlock", "rlock", "runlock", "refresh", "forceunlock")


def _never_sent(e: Exception) -> bool:
    """True when the transport failure provably happened before the
    request reached the peer, making a retry safe even for
    non-idempotent grant methods.  ECONNREFUSED means the TCP connect
    itself failed — no byte of the request was transmitted."""
    return isinstance(e, ConnectionRefusedError)


def _pack_args(args: LockArgs) -> bytes:
    return mpack.packb(
        {
            "uid": args.uid,
            "resources": list(args.resources),
            "source": args.source,
        }
    )


def _unpack_args(body: bytes) -> LockArgs:
    d = mpack.unpackb(body)
    return LockArgs(
        uid=d["uid"],
        resources=tuple(d["resources"]),
        source=d.get("source", ""),
    )


class LockRESTServer:
    """Dispatches lock-plane requests onto this node's LocalLocker."""

    def __init__(self, locker: LocalLocker, secret: str):
        self.locker = locker
        self._secret = secret

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
            return 401, mpack.packb(str(e)), {}
        if method_name not in _METHODS:
            return 400, mpack.packb(f"unknown method {method_name}"), {}
        try:
            args = _unpack_args(body)
            fn = {
                "lock": self.locker.lock,
                "unlock": self.locker.unlock,
                "rlock": self.locker.rlock,
                "runlock": self.locker.runlock,
                "refresh": self.locker.refresh,
                "forceunlock": self.locker.force_unlock,
            }[method_name]
            return 200, mpack.packb(bool(fn(args))), {}
        except Exception as e:  # noqa: BLE001
            return 400, mpack.packb(str(e)), {}


class LockRESTClient(NetLocker):
    """NetLocker for a peer node's lock plane."""

    def __init__(
        self,
        host: str,
        port: int,
        secret: str,
        timeout: float = 5.0,
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
                {"sub": "minio-tpu-lock"}, self._secret, _TOKEN_TTL_S
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
                _log.debug("lock REST connection close failed", extra=kv(err=str(exc)))
            self._local.conn = None

    def _call(self, method: str, args: LockArgs) -> bool:
        body = _pack_args(args)
        headers = {
            "Authorization": f"Bearer {self._bearer()}",
            "Content-Length": str(len(body)),
        }
        url = f"{PREFIX}/{method}"
        # lock/rlock are normally NOT retried: a lost response may mean
        # the grant was applied server-side, and re-sending the same uid
        # would turn it into an unowned phantom grant.  The one safe
        # exception is a refused/never-established connection (a peer
        # mid-restart rebinding its listener): nothing reached the
        # server, so one retry after a jittered backoff converts the
        # restart window into latency instead of a transient quorum
        # error.  Releases and refreshes are idempotent and retry once
        # on any transport failure.
        idempotent = method not in ("lock", "rlock")
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request("POST", url, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                break
            except (OSError, http.client.HTTPException) as e:
                self._drop_conn()
                if attempt or not (
                    idempotent or _never_sent(e)
                ):
                    raise ConnectionError(
                        f"lock plane {self.host}:{self.port} unreachable"
                    ) from None
                # jittered backoff: give a restarting peer a beat to
                # finish rebinding before the single retry
                time.sleep(0.02 + random.random() * 0.08)
        if resp.status != 200:
            raise ConnectionError(
                f"lock plane {self.host}:{self.port}: "
                f"HTTP {resp.status} {mpack.unpackb(payload)!r}"
            )
        return bool(mpack.unpackb(payload))

    # -- NetLocker --------------------------------------------------------

    def lock(self, args: LockArgs) -> bool:
        return self._call("lock", args)

    def unlock(self, args: LockArgs) -> bool:
        return self._call("unlock", args)

    def rlock(self, args: LockArgs) -> bool:
        return self._call("rlock", args)

    def runlock(self, args: LockArgs) -> bool:
        return self._call("runlock", args)

    def refresh(self, args: LockArgs) -> bool:
        return self._call("refresh", args)

    def force_unlock(self, args: LockArgs) -> bool:
        return self._call("forceunlock", args)

    def is_online(self) -> bool:
        try:
            self._call(
                "refresh", LockArgs(uid="probe", resources=("probe",))
            )
            return True
        except Exception:  # noqa: BLE001
            return False

    def close(self) -> None:
        self._drop_conn()
