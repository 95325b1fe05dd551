"""The port's storage REST plane against the JAX package's, in-process.

A ``StorageRESTServer`` serving one drive is mounted on an
``S3Server`` (the internode route of server/http.py, on the async plane
and on the threaded one), and a ``StorageRESTClient`` drives it, in
three pairings: the port's client and server, the port's client against
the JAX server, and the JAX client against the port's server.

* One script of every ``StorageAPI`` method - volumes, raw files, shard
  streams, appends, renames, xl.meta versions, walks, verify, disk ids,
  and the error cases - gives through the remote drive what it gives on
  a local ``XLStorage`` of the client's package, errors by type.
* A CreateFile streamed as chunked transfer encoding lands byte for
  byte; a retried append at its declared offset converges instead of
  duplicating bytes, and an append past the end is refused.
* A request with a bad or missing JWT is answered 401 before its body
  is read, and a body over the cap 413.
* A drive whose server went away is reported offline, fast-fails, and
  is found online again after the probe backoff once it is back.
* A keep-alive connection the server closed while idle is not read as
  an answer: the next call succeeds, against either package's server.
"""

import os
import socket
import time

import pytest

from minio_tpu.server.http import S3Server as JS3Server
from minio_tpu.storage import meta as jmeta
from minio_tpu.storage import rest_client as jrest_client
from minio_tpu.storage import rest_server as jrest_server
from minio_tpu.storage.xl import XLStorage as JXLStorage
from minio_tpu_torch.server.http import S3Server as TS3Server
from minio_tpu_torch.storage import meta as tmeta
from minio_tpu_torch.storage import rest_client as trest_client
from minio_tpu_torch.storage import rest_common as twire
from minio_tpu_torch.storage import rest_server as trest_server
from minio_tpu_torch.storage.errors import DiskNotFound
from minio_tpu_torch.storage.xl import XLStorage as TXLStorage
from minio_tpu_torch.utils import jwt as tjwt
from tests.test_torch_threads import torch_threads  # noqa: F401

SECRET = "internode-secret"
PKG = {
    "port": (TXLStorage, trest_server, trest_client, TS3Server, tmeta),
    "jax": (JXLStorage, jrest_server, jrest_client, JS3Server, jmeta),
}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _serve(kind: str, root: str, monkeypatch, plane="async", port=0):
    xl, rest_server, _rc, server_cls, _m = PKG[kind]
    monkeypatch.setenv("MINIO_TPU_SERVER", plane)
    disk = xl(root)
    srv = server_cls(None, address=f"127.0.0.1:{port}", secret_key=SECRET,
                     internode_secret=SECRET)
    srv.register_internode(
        rest_server.PREFIX if hasattr(rest_server, "PREFIX")
        else twire.PREFIX,
        rest_server.StorageRESTServer([disk], SECRET).handle)
    srv.start()
    return srv, disk


def _client(kind: str, port: int, root: str, secret=SECRET, timeout=10.0):
    return PKG[kind][2].StorageRESTClient("127.0.0.1", port, root, secret,
                                         timeout=timeout)


@pytest.fixture(params=[(c, s, p) for c, s in PAIRS
                        for p in ("async", "threaded")],
                ids=lambda p: f"{p[0]}-client-{p[1]}-server-{p[2]}")
def remote(request, tmp_path, monkeypatch):
    ckind, skind, plane = request.param
    root = str(tmp_path / "remote")
    srv, _disk = _serve(skind, root, monkeypatch, plane)
    client = _client(ckind, srv.port, root)
    local = PKG[ckind][0](str(tmp_path / "local"))
    yield ckind, client, local
    client.close()
    srv.shutdown()


def _fi(mod, data_dir: str, size: int, version_id: str = "", parts=1):
    return mod.FileInfo(
        volume="bkt", name="dir/obj", version_id=version_id,
        data_dir=data_dir, size=size,
        mod_time_ns=1_700_000_000_000_000_000 + size,
        metadata={"etag": "x" * 32, "x-amz-meta-a": "b"},
        parts=[mod.ObjectPartInfo(i + 1, size, size) for i in range(parts)],
        erasure=mod.ErasureInfo(data_blocks=2, parity_blocks=2,
                                block_size=1 << 16, index=1,
                                distribution=[1, 2, 3, 4]),
    )


def _norm(v):
    """Comparable form of an answer: FileInfo/XLMeta as dicts, VolInfo
    without its creation time (the two drives were made apart)."""
    name = type(v).__name__
    if name == "FileInfo":
        return ("fi", v.to_dict(), v.volume, v.name)
    if name == "XLMeta":
        return ("xl", [_norm(x) for x in v.versions])
    if name == "VolInfo":
        return ("vol", v.name)
    if name == "StatInfo":
        return ("stat", v.size, v.is_dir)
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


BODY = bytes(range(256)) * 781 + b"tail"  # 200,000 bytes


APPENDS = ("append_first", "append", "append_at", "append_past_end",
           "read_app", "rename_file", "stat_renamed", "delete_file",
           "stat_deleted")


def _script(disk, meta, appends=True):
    """Every StorageAPI method, in an order that leaves each one
    something to find; returns the answers (exceptions by type).  The
    JAX package's client has no ``append_file`` (its server has the
    route), so its runs leave the append steps out."""
    body = BODY
    steps = [
        ("make_vol", lambda: disk.make_vol("bkt")),
        ("make_vol_again", lambda: disk.make_vol("bkt")),
        ("list_vols", lambda: sorted(disk.list_vols(), key=lambda v: v.name)),
        ("stat_vol", lambda: disk.stat_vol("bkt")),
        ("stat_vol_missing", lambda: disk.stat_vol("nope")),
        ("write_all", lambda: disk.write_all("bkt", "cfg/a.json", b"{}")),
        ("read_all", lambda: disk.read_all("bkt", "cfg/a.json")),
        ("read_all_missing", lambda: disk.read_all("bkt", "cfg/none")),
        ("read_all_novol", lambda: disk.read_all("nope", "x")),
        ("stat_file", lambda: disk.stat_file("bkt", "cfg/a.json")),
        ("list_dir", lambda: sorted(disk.list_dir("bkt", "", -1))),
        ("create_file", lambda: _write(disk, "bkt", "tmp/part.1", body)),
        ("read_stream", lambda: _read(disk, "bkt", "tmp/part.1", 17, 90_000)),
        ("read_stream_tail", lambda: _read(disk, "bkt", "tmp/part.1",
                                           199_000, -1)),
        ("read_stream_missing", lambda: _read(disk, "bkt", "tmp/none", 0, 1)),
        ("append_first", lambda: disk.append_file(
            "bkt", "tmp/app", b"abc", truncate=True)),
        ("append", lambda: disk.append_file("bkt", "tmp/app", b"defg")),
        ("append_at", lambda: disk.append_file("bkt", "tmp/app", b"XY",
                                               offset=5)),
        ("append_past_end", lambda: disk.append_file("bkt", "tmp/app", b"Q",
                                                     offset=99)),
        ("read_app", lambda: disk.read_all("bkt", "tmp/app")),
        ("rename_file", lambda: disk.rename_file("bkt", "tmp/app", "bkt",
                                                 "tmp/app2")),
        ("stat_renamed", lambda: disk.stat_file("bkt", "tmp/app2")),
        ("delete_file", lambda: disk.delete_file("bkt", "tmp/app2")),
        ("stat_deleted", lambda: disk.stat_file("bkt", "tmp/app2")),
        ("write_metadata", lambda: disk.write_metadata(
            "bkt", "dir/obj", _fi(meta, "d" * 32, 11))),
        ("read_version", lambda: disk.read_version("bkt", "dir/obj")),
        ("update_metadata", lambda: disk.update_metadata(
            "bkt", "dir/obj", _fi(meta, "d" * 32, 11))),
        ("read_xl", lambda: disk.read_xl("bkt", "dir/obj")),
        ("stage", lambda: _write(disk, "bkt", "tmp/stage/" + "e" * 32
                                 + "/part.1", b"shard")),
        ("rename_data", lambda: disk.rename_data(
            "bkt", "tmp/stage", _fi(meta, "e" * 32, 5, "v2"), "bkt",
            "dir/obj")),
        ("read_version_v2", lambda: disk.read_version("bkt", "dir/obj",
                                                      "v2")),
        ("read_xl_two", lambda: disk.read_xl("bkt", "dir/obj")),
        ("verify_file", lambda: disk.verify_file(
            "bkt", "dir/obj", _fi(meta, "e" * 32, 5, "v2"))),
        ("delete_version", lambda: disk.delete_version(
            "bkt", "dir/obj", _fi(meta, "e" * 32, 5, "v2"))),
        ("read_version_gone", lambda: disk.read_version("bkt", "dir/obj",
                                                        "v2")),
        ("walk", lambda: sorted(disk.walk("bkt", ""))),
        ("walk_sorted", lambda: list(disk.walk_sorted("bkt", "", ""))),
        ("walk_sorted_flat", lambda: list(disk.walk_sorted(
            "bkt", "", "", recursive=False))),
        ("set_disk_id", lambda: disk.set_disk_id("0123-id")),
        ("delete_file_rec", lambda: disk.delete_file("bkt", "tmp",
                                                     recursive=True)),
        ("delete_vol_full", lambda: disk.delete_vol("bkt")),
        ("delete_vol_force", lambda: disk.delete_vol("bkt", force=True)),
        ("list_vols_after", lambda: sorted(v.name for v in disk.list_vols())),
    ]
    out = []
    for name, fn in steps:
        if not appends and name in APPENDS:
            continue
        try:
            out.append((name, _norm(fn())))
        except Exception as e:  # noqa: BLE001 - compared by type
            out.append((name, "raises", type(e).__name__))
    return out


def _write(disk, vol, path, data, chunk=65_536):
    w = disk.create_file(vol, path)
    for i in range(0, len(data), chunk):
        w.write(data[i:i + chunk])
    w.close()


def _read(disk, vol, path, off, n):
    r = disk.read_file_stream(vol, path)
    try:
        return r.read_at(off, n)
    finally:
        r.close()


def test_every_method_answers_as_local_drive(remote):
    kind, client, local = remote
    meta = PKG[kind][4]
    want = _script(local, meta, appends=kind == "port")
    got = _script(client, meta, appends=kind == "port")
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert client.is_online() and not client.is_local()


def test_walk_sorted_pages_past_the_batch(remote):
    _kind, client, local = remote
    for disk in (client, local):
        disk.make_vol("bkt")
        for i in range(23):
            disk.write_all("bkt", f"o{i:03d}/xl.meta", b"x")
    got = list(client.walk_sorted("bkt", "", "", batch=5))
    assert got == list(local.walk_sorted("bkt", "", "")) and len(got) == 23
    assert list(client.walk_sorted("bkt", "", "o010", inclusive=True,
                                   batch=4)) == \
        list(local.walk_sorted("bkt", "", "o010", inclusive=True))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_streamed_create_and_retried_append(pair, tmp_path, monkeypatch):
    """The JAX client streams the CreateFile; the appends always go
    through the port's client (the JAX one has no append_file)."""
    ckind, skind = pair
    root = str(tmp_path / "r")
    srv, disk = _serve(skind, root, monkeypatch)
    c = _client(ckind, srv.port, root)
    try:
        c.make_vol("bkt")
        data = os.urandom((3 << 20) + 11)  # several 1 MiB wire chunks
        w = c.create_file("bkt", "big/part.1")
        for i in range(0, len(data), 300_001):
            w.write(data[i:i + 300_001])
        w.close()
        with open(os.path.join(root, "bkt", "big", "part.1"), "rb") as f:
            assert f.read() == data
        c.close()
        c = _client("port", srv.port, root)
        # a chunked stream of appends whose second response was "lost":
        # the writer resends it at its declared offset
        c.append_file("bkt", "big/part.2", data[:1000], truncate=True)
        c.append_file("bkt", "big/part.2", data[1000:5000], offset=1000)
        c.append_file("bkt", "big/part.2", data[1000:5000], offset=1000)
        c.append_file("bkt", "big/part.2", data[5000:9000], offset=5000)
        assert c.read_all("bkt", "big/part.2") == data[:9000]
        with pytest.raises(Exception) as ei:
            c.append_file("bkt", "big/part.2", b"z", offset=12_000)
        assert type(ei.value).__name__ == "FileCorrupt"
        assert c.read_all("bkt", "big/part.2") == data[:9000]
    finally:
        c.close()
        srv.shutdown()


def _raw_head(port: int, path: str, headers: dict, send_body=b"") -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        head = f"POST {path} HTTP/1.1\r\nHost: x\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
        s.sendall(head.encode() + send_body)
        return s.recv(4096)
    finally:
        s.close()


@pytest.mark.parametrize("plane", ["async", "threaded"])
@pytest.mark.parametrize("auth", ["missing", "wrong-secret", "garbage"])
def test_bad_jwt_refused_before_the_body(plane, auth, tmp_path, monkeypatch):
    root = str(tmp_path / "r")
    srv, disk = _serve("port", root, monkeypatch, plane)
    try:
        hdr = {"Content-Length": str(50 << 20)}  # never sent
        if auth == "wrong-secret":
            hdr["Authorization"] = "Bearer " + tjwt.sign({"sub": "x"}, "no")
        elif auth == "garbage":
            hdr["Authorization"] = "Bearer a.b.c"
        t0 = time.monotonic()
        resp = _raw_head(srv.port,
                         f"{twire.PREFIX}/makevol?disk={root}&vol=bkt", hdr)
        assert resp.startswith(b"HTTP/1.1 401"), resp[:80]
        assert time.monotonic() - t0 < 4  # answered without the body
        token = tjwt.sign({"sub": "n"}, SECRET)
        resp = _raw_head(srv.port, f"{twire.PREFIX}/makevol?disk={root}",
                         {"Content-Length": str(65 << 20),
                          "Authorization": f"Bearer {token}"})
        assert resp.startswith(b"HTTP/1.1 413"), resp[:80]
        assert disk.list_vols() == []
    finally:
        srv.shutdown()


@pytest.mark.parametrize("ckind", ["port", "jax"])
def test_offline_detection_and_recovery(ckind, tmp_path, monkeypatch):
    mod = PKG[ckind][2]
    monkeypatch.setattr(mod, "_RECONNECT_S", 0.3)
    root = str(tmp_path / "r")
    srv, _disk = _serve("port", root, monkeypatch)
    port = srv.port
    c = _client(ckind, port, root, timeout=5.0)
    c.make_vol("bkt")
    srv.shutdown()
    time.sleep(0.2)
    with pytest.raises(Exception) as ei:
        c.stat_vol("bkt")
    assert type(ei.value).__name__ == "DiskNotFound"
    assert not c.is_online()
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:  # fast-fails while offline
        c.create_file("bkt", "x")
    assert type(ei.value).__name__ == "DiskNotFound"
    assert time.monotonic() - t0 < 0.2
    srv2, _ = _serve("port", root, monkeypatch, port=port)
    try:
        time.sleep(0.35)
        assert c.is_online()
        assert c.stat_vol("bkt").name == "bkt"
    finally:
        c.close()
        srv2.shutdown()


@pytest.mark.parametrize("ckind,skind", [("port", "port"), ("jax", "port"),
                                         ("port", "jax")])
def test_idle_keepalive_reused_after_server_idle_close(ckind, skind, tmp_path,
                                                       monkeypatch):
    """A keep-alive connection the server's async plane closed after
    MINIO_TPU_IDLE_TIMEOUT_S leaves no stale answer behind: the next
    call succeeds and the drive stays online.  The port's plane closes
    such a connection without a word; the JAX plane writes a 408 into
    it, which the port's client never reads because it replaces a
    connection idle past ``tlsconf.KEEPALIVE_REUSE_S``."""
    from minio_tpu_torch.utils import tlsconf

    monkeypatch.setenv("MINIO_TPU_IDLE_TIMEOUT_S", "0.3")
    if skind == "jax":
        monkeypatch.setattr(tlsconf, "KEEPALIVE_REUSE_S", 0.1)
    root = str(tmp_path / "r")
    srv, _disk = _serve(skind, root, monkeypatch)
    c = _client(ckind, srv.port, root)
    try:
        c.make_vol("bkt")
        for _ in range(2):
            time.sleep(0.8)
            assert c.stat_vol("bkt").name == "bkt"
        assert c.is_online()
    finally:
        c.close()
        srv.shutdown()


def test_guarded_disks_served_after_format(tmp_path):
    """guard_disks swaps a served drive for its wrapper; other roots are
    ignored."""
    d = TXLStorage(str(tmp_path / "a"))
    srv = trest_server.StorageRESTServer([d], SECRET)

    class Wrapper:
        root = d.root

        def stat_vol(self, vol):
            raise DiskNotFound("swapped")

    srv.guard_disks({d.root: Wrapper(), "/elsewhere": Wrapper()})
    token = tjwt.sign({"sub": "n"}, SECRET)
    status, body, _ = srv.handle("statvol", {"disk": [d.root], "vol": ["x"]},
                                 b"", {"Authorization": f"Bearer {token}"})
    assert status == 400
    assert twire.unpack(body)["error"] == "DiskNotFound"
    status, body, _ = srv.handle("statvol", {"disk": ["/elsewhere"]}, b"",
                                 {"Authorization": f"Bearer {token}"})
    assert status == 400 and twire.unpack(body)["error"] == "DiskNotFound"
