"""Endpoint topology: URL/path drive specs + local/remote resolution
(cmd/endpoint.go:503 CreateEndpoints, endpoint.go:60 Endpoint).

A drive is either a bare path (``/data/disk1``, always local) or a URL
(``http://host:9000/data/disk1``); a URL is local when its host resolves
to this machine AND its port is this server's port - the same rule the
reference applies so one arg list can be passed to every node.
"""

from __future__ import annotations

import dataclasses
import functools
import socket
import urllib.parse


@dataclasses.dataclass
class Endpoint:
    raw: str
    scheme: str  # "" for a bare path
    host: str
    port: int
    path: str
    is_local: bool

    @property
    def is_url(self) -> bool:
        return bool(self.scheme)

    def __str__(self) -> str:
        return self.raw


@functools.lru_cache(maxsize=1)
def _local_addrs() -> frozenset:
    addrs = {"127.0.0.1", "::1", "localhost", "0.0.0.0"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return frozenset(addrs)


def is_local_host(host: str) -> bool:
    if host in _local_addrs():
        return True
    try:
        for info in socket.getaddrinfo(host, None):
            if info[4][0] in _local_addrs():
                return True
    except OSError:
        pass
    return False


def parse_endpoint(arg: str, local_port: int) -> Endpoint:
    if "://" not in arg:
        return Endpoint(
            raw=arg, scheme="", host="", port=0, path=arg, is_local=True
        )
    u = urllib.parse.urlsplit(arg)
    if u.scheme not in ("http", "https"):
        raise ValueError(f"unsupported endpoint scheme {u.scheme!r}")
    if not u.path or u.path == "/":
        raise ValueError(f"endpoint {arg!r} has no drive path")
    port = u.port or (443 if u.scheme == "https" else 80)
    local = is_local_host(u.hostname or "") and port == local_port
    return Endpoint(
        raw=arg,
        scheme=u.scheme,
        host=u.hostname or "",
        port=port,
        path=u.path,
        is_local=local,
    )


def resolve_endpoints(
    drive_args: list[str], local_port: int
) -> list[Endpoint]:
    eps = [parse_endpoint(a, local_port) for a in drive_args]
    kinds = {e.is_url for e in eps}
    if len(kinds) > 1:
        raise ValueError("cannot mix URL and path drive specs in a zone")
    return eps
