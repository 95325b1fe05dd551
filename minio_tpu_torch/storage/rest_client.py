"""Remote StorageAPI over the storage REST plane
(cmd/storage-rest-client.go:671, cmd/rest/client.go).

Every method is one HTTP POST to the peer's
``/minio-tpu/storage/v1/<method>`` with query args and a MessagePack or raw
body, authenticated by a short-lived internode JWT.  Typed errors travel
in a MessagePack envelope and are re-raised as the same exception classes a
local disk raises, so quorum accounting (reduce_errs) cannot tell local
and remote disks apart.

Connection failures mark the disk offline; is_online() re-probes after a
backoff, mirroring the lazy reconnect of storage-rest-client.go:677.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.parse

from ..utils import jwt
from . import rest_common as wire
from .api import (
    DiskInfo,
    ShardReader,
    ShardWriter,
    StatInfo,
    StorageAPI,
    VolInfo,
)
from .errors import DiskNotFound
from .meta import FileInfo, XLMeta

from ..utils.log import kv, logger

_log = logger("storage")

_RECONNECT_S = 3.0  # defaultRetryUnit-ish probe backoff
_TOKEN_TTL_S = 900


class RemoteShardWriter(ShardWriter):
    """One streaming chunked POST per shard file: write() feeds a
    bounded StreamPipe drained by a sender thread, so shard bytes flow
    to the peer as they are produced - no per-shard buffering and no
    per-flush round trips (storage-rest-client.go CreateFile)."""

    def __init__(self, client: "StorageRESTClient", volume: str, path: str):
        from ..utils.pipe import StreamPipe

        self._c = client
        # respect the shared offline tracking: a dead peer fast-fails
        # instead of stalling a socket timeout per shard stream
        if not client._online and not client._should_probe():
            raise DiskNotFound(f"{client._endpoint} offline")
        self._pipe = StreamPipe(depth=8)
        self._err: "Exception | None" = None
        q = {"disk": client.disk_path, "vol": volume, "path": path}
        self._url = (
            f"{wire.PREFIX}/createfile?" + urllib.parse.urlencode(q)
        )
        self._thread = threading.Thread(
            target=self._run, name="shard-stream", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        from ..utils import tlsconf

        conn = None
        try:
            conn = tlsconf.client_connection(
                self._c.host, self._c.port, self._c._timeout
            )
            conn.putrequest("POST", self._url)
            conn.putheader("Authorization", f"Bearer {self._c._bearer()}")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            while True:
                chunk = self._pipe.read(1 << 20)
                if not chunk:
                    break
                conn.send(f"{len(chunk):x}\r\n".encode())
                conn.send(chunk)
                conn.send(b"\r\n")
            conn.send(b"0\r\n\r\n")
            resp = conn.getresponse()
            payload = resp.read()
            self._c._mark_online()
            if resp.status != 200:
                try:
                    env = wire.unpack(payload)
                    self._err = wire.decode_error(
                        env["error"], env["message"]
                    )
                except Exception:  # noqa: BLE001
                    self._err = OSError(
                        f"createfile: HTTP {resp.status}"
                    )
        except Exception as e:  # noqa: BLE001
            self._err = e if isinstance(e, OSError) else OSError(str(e))
            # transport failure: mark the disk offline like _call does
            self._c._mark_offline(f"createfile stream: {e!r}")
        finally:
            if self._err is not None:
                # unblock a producer stuck on the full pipe
                self._pipe.close_read()
            if conn is not None:
                try:
                    conn.close()
                except Exception as exc:
                    _log.debug("storage REST connection close failed", extra=kv(err=str(exc)))

    def _raise_err(self) -> None:
        # shard-writer callers tolerate OSError (quorum accounting);
        # wrap typed server errors so they are not silently fatal
        e = self._err or OSError("shard stream failed")
        if isinstance(e, OSError):
            raise e
        raise OSError(f"{type(e).__name__}: {e}") from e

    def write(self, data: bytes) -> None:
        from ..utils.pipe import PipeClosed

        try:
            self._pipe.write(data)
        except PipeClosed:
            self._raise_err()

    def close(self) -> None:
        self._pipe.close_write()
        self._thread.join(timeout=self._c._timeout + 5)
        if self._thread.is_alive():
            # the server never acknowledged the stream: reporting
            # success here would commit an unconfirmed shard
            self._err = self._err or OSError(
                "createfile response timed out"
            )
        if self._err is not None:
            self._raise_err()


class RemoteShardReader(ShardReader):
    is_local = False

    def __init__(self, client: "StorageRESTClient", volume: str, path: str):
        self._c = client
        self._vol = volume
        self._path = path
        # fail fast like the local open() does
        self._c._call(
            "statfile", {"vol": volume, "path": path}
        )

    def read_at(self, offset: int, length: int) -> bytes:
        return self._c._call(
            "readfilestream",
            {
                "vol": self._vol,
                "path": self._path,
                "offset": str(offset),
                "length": str(length),
            },
        )

    def close(self) -> None:
        pass


class StorageRESTClient(StorageAPI):
    """StorageAPI for one remote drive served by a peer node."""

    def __init__(
        self,
        host: str,
        port: int,
        disk_path: str,
        secret: str,
        access_key: str = "minio-tpu-node",
        timeout: float = 30.0,
    ):
        self.host = host
        self.port = port
        self.disk_path = disk_path
        self.root = disk_path  # REST server keys disks by root path
        self._secret = secret
        self._access_key = access_key
        self._timeout = timeout
        self._endpoint = f"http://{host}:{port}{disk_path}"
        self._local = threading.local()
        self._token = ""
        self._token_exp = 0.0
        self._online = True
        self._down_logged = False
        self._last_probe = 0.0
        self._disk_id = ""
        # storage-op deadlines self-tune from observed durations, the
        # same adaptation the namespace locks use (dynamic-timeouts.go
        # applied to storage RPCs, not just locking).  One budget PER
        # OPERATION CLASS: cheap metadata ops must not shrink the
        # deadline under a large shard stream (the reference keeps
        # separate dynamic timeouts for the same reason)
        from ..utils.dyntimeout import DynamicTimeout

        self._dyn_meta = DynamicTimeout(timeout, max(1.0, timeout / 10))
        self._dyn_bulk = DynamicTimeout(timeout, max(5.0, timeout / 4))

    # data-bearing RPCs whose duration scales with payload/namespace
    _BULK_METHODS = frozenset(
        {
            "createfile", "appendfile", "readfilestream", "readall",
            "writeall", "walk", "listdir", "deletevol", "renamefile",
        }
    )

    # ---- transport ------------------------------------------------------

    def _bearer(self) -> str:
        now = time.time()
        if now > self._token_exp - 60:
            self._token = jwt.sign(
                {"sub": self._access_key}, self._secret, _TOKEN_TTL_S
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
                _log.debug("storage REST connection close failed", extra=kv(err=str(exc)))
            self._local.conn = None

    def _call(
        self, method: str, q: "dict | None" = None, body: bytes = b""
    ) -> bytes:
        if not self._online and not self._should_probe():
            raise DiskNotFound(f"{self._endpoint} offline")
        query = {"disk": self.disk_path}
        query.update(q or {})
        url = f"{wire.PREFIX}/{method}?" + urllib.parse.urlencode(query)
        headers = {
            "Authorization": f"Bearer {self._bearer()}",
            "Content-Length": str(len(body)),
        }
        dyn = (
            self._dyn_bulk
            if method in self._BULK_METHODS
            else self._dyn_meta
        )
        op_deadline = dyn.timeout
        t0 = time.monotonic()
        for attempt in (0, 1):
            conn = self._conn()
            conn.timeout = op_deadline
            if getattr(conn, "sock", None) is not None:
                conn.sock.settimeout(op_deadline)
            try:
                conn.request("POST", url, body=body or None, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                break
            except TimeoutError:
                # the adaptive deadline fired: grow the budget
                dyn.log_failure()
                self._drop_conn()
                if attempt:
                    self._mark_offline(f"{method} timed out")
                    raise DiskNotFound(
                        f"{self._endpoint} timed out"
                    ) from None
            except (OSError, http.client.HTTPException) as e:
                # one retry on a fresh connection (stale keep-alive)
                self._drop_conn()
                if attempt:
                    self._mark_offline(f"{method}: {e!r}")
                    raise DiskNotFound(
                        f"{self._endpoint} unreachable"
                    ) from None
                if isinstance(
                    e,
                    (
                        ConnectionRefusedError,
                        ConnectionResetError,
                        BrokenPipeError,
                    ),
                ):
                    # refused/reset is the peer-restart signature: a
                    # jittered backoff before the single retry bridges
                    # the listener-rebind window instead of surfacing a
                    # transient DiskNotFound to the quorum path
                    time.sleep(0.05 + random.random() * 0.15)
        dyn.log_success(time.monotonic() - t0)
        self._mark_online()
        if resp.status == 200:
            return payload
        if resp.status in (400, 401):
            try:
                env = wire.unpack(payload)
                raise wire.decode_error(env["error"], env["message"])
            except (ValueError, KeyError, TypeError):
                raise DiskNotFound(
                    f"{self._endpoint}: bad error envelope"
                ) from None
        raise DiskNotFound(f"{self._endpoint}: HTTP {resp.status}")

    def _mark_offline(self, why: str) -> None:
        """Fail fast until the next probe; logged once until the drive
        answers again (failed probes do not repeat it)."""
        if not self._down_logged:
            self._down_logged = True
            _log.warning(
                "storage REST disk offline",
                extra=kv(disk=self._endpoint, why=why),
            )
        self._online = False
        self._last_probe = time.time()

    def _mark_online(self) -> None:
        self._online = True
        if self._down_logged:
            self._down_logged = False
            _log.info("storage REST disk online", extra=kv(disk=self._endpoint))

    def _should_probe(self) -> bool:
        if time.time() - self._last_probe >= _RECONNECT_S:
            self._online = True  # optimistic; next _call settles it
            return True
        return False

    # ---- identity / health ----------------------------------------------

    def is_online(self) -> bool:
        if self._online:
            return True
        if not self._should_probe():
            return False
        try:
            self._call("diskinfo")
            return True
        except Exception:  # noqa: BLE001
            return False

    def endpoint(self) -> str:
        return self._endpoint

    def is_local(self) -> bool:
        return False

    def disk_info(self) -> DiskInfo:
        d = wire.unpack(self._call("diskinfo"))
        return DiskInfo(**d)

    def get_disk_id(self) -> str:
        return wire.unpack(self._call("getdiskid"))

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id
        self._call("setdiskid", body=wire.pack(disk_id))

    def close(self) -> None:
        self._drop_conn()

    # ---- volumes --------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        self._call("makevol", {"vol": volume})

    def list_vols(self) -> list[VolInfo]:
        return [
            VolInfo(n, c)
            for n, c in wire.unpack(self._call("listvols"))
        ]

    def stat_vol(self, volume: str) -> VolInfo:
        n, c = wire.unpack(self._call("statvol", {"vol": volume}))
        return VolInfo(n, c)

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._call(
            "deletevol", {"vol": volume, "force": "1" if force else "0"}
        )

    # ---- raw files ------------------------------------------------------

    def list_dir(self, volume: str, dir_path: str, count: int = -1) -> list[str]:
        return wire.unpack(
            self._call(
                "listdir",
                {"vol": volume, "path": dir_path, "count": str(count)},
            )
        )

    def read_all(self, volume: str, path: str) -> bytes:
        return self._call("readall", {"vol": volume, "path": path})

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._call("writeall", {"vol": volume, "path": path}, data)

    def delete_file(self, volume: str, path: str, recursive: bool = False) -> None:
        self._call(
            "deletefile",
            {
                "vol": volume,
                "path": path,
                "recursive": "1" if recursive else "0",
            },
        )

    def rename_file(
        self, src_volume: str, src_path: str, dst_volume: str, dst_path: str
    ) -> None:
        self._call(
            "renamefile",
            {
                "vol": src_volume,
                "path": src_path,
                "dstvol": dst_volume,
                "dstpath": dst_path,
            },
        )

    def stat_file(self, volume: str, path: str) -> StatInfo:
        size, mt, is_dir = wire.unpack(
            self._call("statfile", {"vol": volume, "path": path})
        )
        return StatInfo(size, mt, is_dir)

    # ---- shard streams --------------------------------------------------

    def create_file(self, volume: str, path: str) -> ShardWriter:
        return RemoteShardWriter(self, volume, path)

    def read_file_stream(self, volume: str, path: str) -> ShardReader:
        return RemoteShardReader(self, volume, path)

    def append_file(
        self,
        volume: str,
        path: str,
        data: bytes,
        truncate: bool = False,
        offset: "int | None" = None,
    ) -> None:
        """One bounded chunk of a shard file.  With ``offset`` the peer
        writes at that declared place (truncating past it), so the
        transport's one retry on a fresh connection - or a caller's own
        after a lost response - converges instead of appending twice."""
        q = {"vol": volume, "path": path, "truncate": "1" if truncate else "0"}
        if offset is not None:
            q["off"] = str(offset)
        self._call("appendfile", q, bytes(data))

    # ---- object metadata ------------------------------------------------

    def read_version(
        self, volume: str, path: str, version_id: str = ""
    ) -> FileInfo:
        raw = self._call(
            "readversion",
            {"vol": volume, "path": path, "versionid": version_id},
        )
        return wire.fileinfo_from_wire(wire.unpack(raw))

    def read_xl(self, volume: str, path: str) -> XLMeta:
        raw = self._call("readxl", {"vol": volume, "path": path})
        xl = XLMeta()
        for d in wire.unpack(raw):
            xl.versions.append(wire.fileinfo_from_wire(d))
        return xl

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call(
            "writemetadata",
            {"vol": volume, "path": path},
            wire.pack(wire.fileinfo_to_wire(fi)),
        )

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call(
            "updatemetadata",
            {"vol": volume, "path": path},
            wire.pack(wire.fileinfo_to_wire(fi)),
        )

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call(
            "deleteversion",
            {"vol": volume, "path": path},
            wire.pack(wire.fileinfo_to_wire(fi)),
        )

    def rename_data(
        self,
        src_volume: str,
        src_path: str,
        fi: FileInfo,
        dst_volume: str,
        dst_path: str,
    ) -> None:
        self._call(
            "renamedata",
            {
                "vol": src_volume,
                "path": src_path,
                "dstvol": dst_volume,
                "dstpath": dst_path,
            },
            wire.pack(wire.fileinfo_to_wire(fi)),
        )

    # ---- maintenance ----------------------------------------------------

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call(
            "verifyfile",
            {"vol": volume, "path": path},
            wire.pack(wire.fileinfo_to_wire(fi)),
        )

    def walk(self, volume: str, prefix: str = ""):
        yield from wire.unpack(
            self._call("walk", {"vol": volume, "path": prefix})
        )

    def walk_sorted(
        self,
        volume: str,
        prefix: str = "",
        marker: str = "",
        recursive: bool = True,
        inclusive: bool = False,
        batch: int = 1000,
    ):
        """Ordered walk over the wire: bounded batches, marker-advanced
        continuation (the remote half of tree-walk)."""
        while True:
            rows = wire.unpack(
                self._call(
                    "walksorted",
                    {
                        "vol": volume,
                        "prefix": prefix,
                        "marker": marker,
                        "recursive": "1" if recursive else "0",
                        "inclusive": "1" if inclusive else "0",
                        "count": str(batch),
                    },
                )
            )
            for name, is_prefix in rows:
                yield (name, is_prefix)
            if len(rows) < batch:
                return
            marker = rows[-1][0]
            inclusive = False  # continuation is strictly after marker
