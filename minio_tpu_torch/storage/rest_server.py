"""Storage REST server: exposes local disks to peers (storage-rest-server.go).

Mounted inside the node's single HTTP listener (like registerDistErasure-
Routers, routers.go:25-38): requests under /minio-tpu/storage/v1/ carry an
internode JWT and name a local disk by its endpoint path.  Method handlers
are thin translations onto the local XLStorage instances.
"""

from __future__ import annotations

from ..utils import jwt
from . import rest_common as wire


class StorageRESTServer:
    """Dispatches storage-plane requests for a set of local disks."""

    def __init__(self, disks: list, secret: str):
        # key disks by their root path (the 'disk' query arg)
        self._disks = {d.root: d for d in disks}
        self._secret = secret

    def guard_disks(self, guarded: dict) -> None:
        """Swap served disks for their DiskIDCheck wrappers once the
        format is known (peer I/O must not bypass the per-op identity
        validation).  ``guarded`` maps root -> wrapper."""
        for root, wrapper in guarded.items():
            if root in self._disks:
                self._disks[root] = wrapper

    def authenticate(self, headers: dict) -> None:
        authz = headers.get("authorization", "")
        if not authz.startswith("Bearer "):
            raise jwt.JWTError("missing bearer token")
        jwt.verify(authz[len("Bearer "):], self._secret)

    def _preamble(self, query: dict, headers: "dict | None"):
        """Shared auth + disk-lookup front half for both dispatch
        paths.  Returns (disk, q, error_response_or_None)."""
        try:
            self.authenticate(
                {k.lower(): v for k, v in (headers or {}).items()}
            )
        except Exception as e:  # noqa: BLE001
            name, msg = wire.encode_error(e)
            return None, {}, (
                401, wire.pack({"error": name, "message": msg}), {}
            )
        q = {k: v[0] for k, v in query.items()}
        disk = self._disks.get(q.get("disk", ""))
        if disk is None:
            from .errors import DiskNotFound

            name, msg = wire.encode_error(DiskNotFound(q.get("disk", "")))
            return None, q, (
                400, wire.pack({"error": name, "message": msg}), {}
            )
        return disk, q, None

    def handle(
        self,
        method_name: str,
        query: dict,
        body: bytes,
        headers: "dict | None" = None,
    ) -> tuple[int, bytes, dict]:
        """Returns (status, body, headers).  Errors use a typed envelope.

        Authentication happens HERE, on the dispatch path, so no wiring
        can mount the storage plane unauthenticated.
        """
        disk, q, err = self._preamble(query, headers)
        if err is not None:
            return err
        try:
            out = self._dispatch(disk, method_name, q, body)
            return 200, out, {}
        except Exception as e:  # noqa: BLE001 - typed envelope
            name, msg = wire.encode_error(e)
            return 400, wire.pack({"error": name, "message": msg}), {}

    def handle_stream(
        self,
        method_name: str,
        query: dict,
        reader,
        headers: "dict | None" = None,
    ) -> tuple[int, bytes, dict]:
        """Streaming-body dispatch (chunked TE): CreateFile shard bytes
        flow straight from the socket into the disk writer in bounded
        chunks - neither side holds a whole shard
        (storage-rest-server.go CreateFileHandler)."""
        disk, q, err = self._preamble(query, headers)
        if err is not None:
            return err
        if method_name != "createfile":
            return 400, wire.pack(
                {"error": "ValueError", "message": "not streamable"}
            ), {}
        try:
            w = disk.create_file(q.get("vol", ""), q.get("path", ""))
            try:
                while True:
                    chunk = reader.read(1 << 20)
                    if not chunk:
                        break
                    w.write(chunk)
            finally:
                w.close()
            return 200, b"", {}
        except Exception as e:  # noqa: BLE001
            name, msg = wire.encode_error(e)
            return 400, wire.pack({"error": name, "message": msg}), {}

    def _dispatch(self, disk, m: str, q: dict, body: bytes) -> bytes:
        vol = q.get("vol", "")
        path = q.get("path", "")
        if m == "diskinfo":
            info = disk.disk_info()
            return wire.pack(info.__dict__)
        if m == "getdiskid":
            return wire.pack(disk.get_disk_id())
        if m == "setdiskid":
            disk.set_disk_id(wire.unpack(body))
            return b""
        if m == "makevol":
            disk.make_vol(vol)
            return b""
        if m == "listvols":
            return wire.pack(
                [[v.name, v.created_ns] for v in disk.list_vols()]
            )
        if m == "statvol":
            v = disk.stat_vol(vol)
            return wire.pack([v.name, v.created_ns])
        if m == "deletevol":
            disk.delete_vol(vol, force=q.get("force") == "1")
            return b""
        if m == "listdir":
            return wire.pack(
                disk.list_dir(vol, path, int(q.get("count", -1)))
            )
        if m == "readall":
            return disk.read_all(vol, path)
        if m == "writeall":
            disk.write_all(vol, path, body)
            return b""
        if m == "deletefile":
            disk.delete_file(vol, path, recursive=q.get("recursive") == "1")
            return b""
        if m == "renamefile":
            disk.rename_file(vol, path, q["dstvol"], q["dstpath"])
            return b""
        if m == "statfile":
            st = disk.stat_file(vol, path)
            return wire.pack([st.size, st.mod_time_ns, st.is_dir])
        if m == "appendfile":
            disk.append_file(
                vol,
                path,
                body,
                truncate=q.get("truncate") == "1",
                offset=int(q["off"]) if "off" in q else None,
            )
            return b""
        if m == "createfile":
            # whole shard body in one request (streamed chunked client-side)
            w = disk.create_file(vol, path)
            try:
                w.write(body)
            finally:
                w.close()
            return b""
        if m == "readfilestream":
            r = disk.read_file_stream(vol, path)
            try:
                return r.read_at(
                    int(q.get("offset", 0)), int(q.get("length", -1))
                )
            finally:
                r.close()
        if m == "readversion":
            fi = disk.read_version(vol, path, q.get("versionid", ""))
            return wire.pack(wire.fileinfo_to_wire(fi))
        if m == "readxl":
            xl = disk.read_xl(vol, path)
            return wire.pack(
                [wire.fileinfo_to_wire(v) for v in xl.versions]
            )
        if m == "writemetadata":
            disk.write_metadata(
                vol, path, wire.fileinfo_from_wire(wire.unpack(body))
            )
            return b""
        if m == "updatemetadata":
            disk.update_metadata(
                vol, path, wire.fileinfo_from_wire(wire.unpack(body))
            )
            return b""
        if m == "deleteversion":
            disk.delete_version(
                vol, path, wire.fileinfo_from_wire(wire.unpack(body))
            )
            return b""
        if m == "renamedata":
            disk.rename_data(
                vol,
                path,
                wire.fileinfo_from_wire(wire.unpack(body)),
                q["dstvol"],
                q["dstpath"],
            )
            return b""
        if m == "verifyfile":
            disk.verify_file(
                vol, path, wire.fileinfo_from_wire(wire.unpack(body))
            )
            return b""
        if m == "walk":
            return wire.pack(list(disk.walk(vol, path)))
        if m == "walksorted":
            # bounded batch of the ordered walk; the client re-requests
            # with an advanced marker (tree-walk continuation)
            count = int(q.get("count", 1000))
            out = []
            it = disk.walk_sorted(
                vol,
                q.get("prefix", ""),
                q.get("marker", ""),
                recursive=q.get("recursive", "1") == "1",
                inclusive=q.get("inclusive") == "1",
            )
            for name, is_prefix in it:
                out.append([name, is_prefix])
                if len(out) >= count:
                    break
            return wire.pack(out)
        raise ValueError(f"unknown storage method {m!r}")
