"""``python -m minio_tpu_torch.server`` as users start it, on the CPU.

The server runs as a subprocess with ``MINIO_ERASURE_BACKEND=cpu``:

* it boots over four drives of which only two carry ``format.json`` - no
  quorum - so it listens and answers 503 (readiness, and S3 requests
  with XMinioServerNotInitialized) while its boot loop waits; once a
  third drive's format is back the boot completes, the fourth drive is
  stamped into its hole, and readiness answers 200;
* a signed PUT and GET, the admin API on the async plane;
* a drive wiped while the server runs is stamped back and healed by the
  fresh-disk monitor and the heal routine;
* SIGTERM drains and exits 0, printing ``shutdown complete``;
* URL drive endpoints (one node, and two nodes sharing one endpoint
  list), fault injection, federation (``MINIO_TPU_FEDERATION_DIR``:
  a new bucket's record lands in the shared directory) and the disk
  cache (``MINIO_TPU_CACHE_DRIVES``: a second GET is a hit in the admin
  ``cache-stats``) boot and serve (``SERVED``);
* the standalone FS mode (one drive) and the NAS gateway are spawned
  beside the JAX package's server in the same mode: the same signed
  requests get the same answers, Select included, and the object files
  are byte-equal; a single drive that holds an erasure format exits;
* a codec device other than ``cuda`` or ``cpu`` exits non-zero, and so
  does ``cuda`` on a host without a card, for the erasure layouts, the
  FS mode and both gateways.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from minio_tpu_torch.objectlayer import format as tformat
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRUB = ("MINIO_TPU_SERVER", "MINIO_TPU_SERVER_LOOPS", "MINIO_ERASURE_BACKEND",
          "MINIO_TPU_FAULT_INJECTION", "MINIO_TPU_FEDERATION_DIR",
          "MINIO_TPU_CACHE_DRIVES", "MINIO_TPU_TLS")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _SCRUB}
    env.update({"MINIO_ERASURE_BACKEND": "cpu", "MINIO_TPU_SERVER_LOOPS": "2",
                "MINIO_TPU_FRESH_DISK_INTERVAL_S": "1",
                "MINIO_TPU_LOG_LEVEL": "warning", "PYTHONUNBUFFERED": "1"})
    env.update(extra)
    return {k: v for k, v in env.items() if v is not None}


# sockets that keep the ports _free_port handed out bound, for the life of
# the worker process
_RESERVED: "list[socket.socket]" = []


def _free_port() -> int:
    """A free port that stays reserved for the server that will listen on
    it.  A port released at once can be handed to another process's
    port-0 bind before the server binds it - and the server's listeners
    take SO_REUSEPORT, so the two would share it, each taking some of
    the other's connections.  The reserving socket stays bound, so no
    port-0 bind returns the port; it carries SO_REUSEADDR and
    SO_REUSEPORT, so the server's listeners bind beside it, and it never
    listens, so it takes no connection."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hasattr(socket, "SO_REUSEPORT"):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    _RESERVED.append(s)
    return s.getsockname()[1]


def _ready(port: int) -> "int | None":
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/minio/health/ready", timeout=2) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return None


def _until(cond, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)


def _run(args, env, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.server", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _part_files(root: str, bucket: str) -> dict:
    out = {}
    base = os.path.join(root, bucket)
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, base)] = f.read()
    return out


def test_boot_serve_heal_and_sigterm(tmp_path):
    drives = [str(tmp_path / f"d{i}") for i in range(1, 5)]
    tformat.load_or_init_format([XLStorage(d) for d in drives], 1, 4)
    fmt3 = os.path.join(drives[2], ".sys", "format.json")
    saved = open(fmt3, "rb").read()
    for d in drives[2:]:
        os.remove(os.path.join(d, ".sys", "format.json"))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--address",
         f"127.0.0.1:{port}", str(tmp_path / "d{1...4}")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # listening, but the format has no quorum: 503 everywhere
        assert _until(lambda: _ready(port), 60, "the listener") == 503
        c = S3Client(f"http://127.0.0.1:{port}")
        r = c.make_bucket("early")
        assert r.status == 503 and r.error_code == "XMinioServerNotInitialized"
        with open(fmt3, "wb") as f:
            f.write(saved)
        _until(lambda: _ready(port) == 200, 60, "readiness 200")
        stamped = tformat.read_format(XLStorage(drives[3]))
        ref = tformat.read_format(XLStorage(drives[0]))
        assert stamped.id == ref.id and stamped.this == ref.sets[0][3]

        assert c.make_bucket("bkt").status == 200
        objs = {f"k{i}": os.urandom(70_000 * i + 5) for i in range(4)}
        for k, v in objs.items():
            assert c.put_object("bkt", k, v).status == 200
        for k, v in objs.items():
            r = c.get_object("bkt", k)
            assert (r.status, r.body) == (200, v)
        r = c.request("GET", "/minio-tpu/admin/v1/loops/status")
        doc = json.loads(r.body)
        assert (r.status, doc["mode"], doc["count"]) == (200, "async", 2)
        r = c.request("GET", "/minio-tpu/admin/v1/storageinfo")
        assert json.loads(r.body)["zones"][0]["online"] == 4
        # the data crawler runs in the server: a forced sweep counts the
        # bucket, and datausage serves the snapshot it published
        r = c.request("POST", "/minio-tpu/admin/v1/crawl")
        usage = json.loads(r.body)
        assert r.status == 200 and usage["buckets"]["bkt"]["objects"] == 4
        assert usage["size_total"] == sum(len(v) for v in objs.values())
        r = c.request("GET", "/minio-tpu/admin/v1/datausage")
        assert json.loads(r.body) == usage

        # a drive replaced while the server runs: stamped back, healed
        before = _part_files(drives[1], "bkt")
        assert len(before) >= 2 * len(objs)
        for entry in os.listdir(drives[1]):
            path = os.path.join(drives[1], entry)
            if os.path.isdir(path):
                shutil.rmtree(path)
        _until(lambda: _part_files(drives[1], "bkt") == before, 60,
               "the wiped drive's shard files")
        assert tformat.read_format(XLStorage(drives[1])).this == \
            ref.sets[0][1]
        for k, v in objs.items():
            assert c.get_object("bkt", k).body == v
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out
    # the update tracker saved its journal at shutdown
    assert any(os.path.exists(os.path.join(d, ".sys", "update-tracker.bin"))
               for d in drives)
    lines = out.splitlines()
    assert f"minio-tpu listening at http://127.0.0.1:{port} (bootstrapping)" \
        in lines
    assert (f"minio-tpu serving 1 zone(s) [4] drives at "
            f"http://127.0.0.1:{port}") in lines
    assert lines[-1] == "shutdown complete"


REFUSED = [
    # (id, args, env, text the message must hold)
    ("gateway_usage", ["gateway", "nas"], {}, "usage: server gateway"),
    ("gateway_kind", ["gateway", "azure", "x"], {}, "unknown gateway"),
    ("backend_tpu", ["{base}/d{{1...4}}"], {"MINIO_ERASURE_BACKEND": "tpu"},
     "cuda"),
    ("backend_auto", ["{base}/d{{1...4}}"], {"MINIO_ERASURE_BACKEND": "auto"},
     "cuda"),
    ("mixed_args", ["{base}/d{{1...4}}", "{base}/e1"], {}, "ellipses"),
]


@pytest.mark.parametrize("args,env,text", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_refused_layouts_name_their_slice(tmp_path, args, env, text):
    base = str(tmp_path)
    args = [a.format(base=base) for a in args]
    env = {k: v.format(base=base) for k, v in env.items()}
    res = _run(["--address", "127.0.0.1:0", *args], _env(**env))
    assert res.returncode != 0, res.stdout
    assert text in res.stderr, res.stderr
    assert "listening" not in res.stdout
    assert not os.path.exists(os.path.join(base, "d1", ".sys", "format.json"))


def _boot(port: int, args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--address",
         f"127.0.0.1:{port}", "--format-timeout", "30", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _stop(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    assert proc.returncode == 0, out
    assert out.splitlines()[-1] == "shutdown complete", out
    return out


def _served_url_endpoints(base: str):
    port = _free_port()
    procs = [_boot(port, [f"http://127.0.0.1:{port}{base}/d{{1...4}}"],
                   _env())]
    return procs, [port], {}


def _served_second_node(base: str):
    ports = [_free_port(), _free_port()]
    eps = [f"http://127.0.0.1:{p}{base}/n{i}/d{j}"
           for i, p in enumerate(ports) for j in (1, 2)]
    return [_boot(p, eps, _env()) for p in ports], ports, {}


def _served_fault_injection(base: str):
    port = _free_port()
    env = _env(MINIO_TPU_FAULT_INJECTION="1", MINIO_TPU_FAULT_SEED="7")
    return [_boot(port, [f"{base}/d{{1...4}}"], env)], [port], {"faults": 4}


def _served_federation(base: str):
    port = _free_port()
    env = _env(MINIO_TPU_FEDERATION_DIR=f"{base}/fed")
    return [_boot(port, [f"{base}/d{{1...4}}"], env)], [port], {
        "federation": f"{base}/fed"}


def _served_disk_cache(base: str):
    port = _free_port()
    env = _env(MINIO_TPU_CACHE_DRIVES=f"{base}/cache0,{base}/cache1",
               MINIO_TPU_CACHE_QUOTA_MB="64")
    return [_boot(port, [f"{base}/d{{1...4}}"], env)], [port], {
        "disk_cache": [f"{base}/cache0", f"{base}/cache1"]}


# layouts and env that once exited at boot and are served now
SERVED = {
    "disk_cache": _served_disk_cache,
    "url_endpoints": _served_url_endpoints,
    "second_node": _served_second_node,
    "fault_injection": _served_fault_injection,
    "federation": _served_federation,
}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_served_layouts_boot(tmp_path, case):
    """Each boots, answers a signed PUT on its first node and a GET on its
    last, and exits 0 on SIGTERM; a second node verifies the cluster
    handshake, and fault injection lists its drives in fault/status."""
    procs, ports, want = SERVED[case](str(tmp_path))
    try:
        for port in ports:
            _until(lambda port=port: _ready(port) == 200, 90, "readiness")
        first = S3Client(f"http://127.0.0.1:{ports[0]}")
        last = S3Client(f"http://127.0.0.1:{ports[-1]}")
        data = os.urandom(300_017)
        assert first.make_bucket("bkt").status == 200
        assert first.put_object("bkt", "obj", data).status == 200
        r = last.get_object("bkt", "obj")
        assert (r.status, r.body) == (200, data)
        r = first.request("GET", "/minio-tpu/admin/v1/info")
        doc = json.loads(r.body)
        assert doc["mode"] == ("distributed" if len(ports) > 1 else "erasure")
        assert len(doc.get("nodes", [])) == len(ports) - 1
        if "faults" in want:
            r = first.request("GET", "/minio-tpu/admin/v1/fault/status")
            assert r.status == 200 and len(json.loads(r.body)) == 4
        if "disk_cache" in want:
            # the GET above was a miss that filled the cache; the next
            # is a hit, and the entry's data file holds the object
            r = last.get_object("bkt", "obj")
            assert (r.status, r.body) == (200, data)
            r = first.request("GET", "/minio-tpu/admin/v1/cache-stats")
            doc = json.loads(r.body)
            assert (doc["enabled"], doc["hits"], doc["misses"]) == (True, 1, 1)
            assert [d["root"] for d in doc["drives"]] == want["disk_cache"]
            assert sum(d["used"] for d in doc["drives"]) == len(data)
            assert all(d["quota"] == 64 << 20 for d in doc["drives"])
        if "federation" in want:
            # the bucket is registered in the shared record directory
            # under this server's address
            with open(os.path.join(want["federation"], "bkt.json")) as f:
                recs = json.load(f)
            assert [(r["host"], r["port"], r["key"], r["scheme"])
                    for r in recs] == [("127.0.0.1", ports[0], "bkt", "http")]
    finally:
        outs = [_stop(p) for p in procs]
    if "disk_cache" in want:
        assert "disk cache enabled" in outs[0].splitlines()
    if "federation" in want:
        assert (f"federation: bucket DNS at {want['federation']} as "
                f"127.0.0.1:{ports[0]}") in outs[0]
    if len(ports) > 1:
        assert all("bootstrap handshake ok with 1 peer(s)" in o for o in outs)
    assert not any("Traceback" in o for o in outs), outs


def test_no_card_and_cuda_asked_exits(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would boot on it")
    res = _run(["--address", "127.0.0.1:0", str(tmp_path / "d{1...4}")],
               _env(MINIO_ERASURE_BACKEND=None))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "MINIO_ERASURE_BACKEND=cpu" in res.stderr


@pytest.mark.parametrize("args", [
    ["{base}/solo"], ["gateway", "nas", "{base}/nas"],
    ["gateway", "s3", "http://127.0.0.1:9"],
], ids=["fs", "nas", "s3"])
def test_no_card_fs_and_gateways_exit(tmp_path, args):
    """These layers scan Select on the card: without one, and without
    MINIO_ERASURE_BACKEND=cpu, they exit before listening."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would boot on it")
    args = [a.format(base=tmp_path) for a in args]
    res = _run(["--address", "127.0.0.1:0", *args],
               _env(MINIO_ERASURE_BACKEND=None))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "listening" not in res.stdout and "serving" not in res.stdout


def test_single_drive_holding_an_erasure_format_exits(tmp_path):
    solo = tmp_path / "solo"
    (solo / ".sys").mkdir(parents=True)
    (solo / ".sys" / "format.json").write_text("{}")
    res = _run(["--address", "127.0.0.1:0", str(solo)], _env())
    assert res.returncode != 0
    assert (f"{solo} holds an erasure format; a single-drive FS server "
            "cannot serve it (add the original drives)") in res.stderr
    assert not (solo / "bkt").exists()


_FS_CSV = b"id,name,qty\n" + b"".join(
    b"%d,item%d,%d\n" % (i, i, i % 11) for i in range(2000))
_FS_SELECT = (
    b"<SelectObjectContentRequest><Expression>SELECT s.id, s.name FROM "
    b"S3Object s WHERE s.qty &gt; 6</Expression><ExpressionType>SQL"
    b"</ExpressionType><InputSerialization><CSV><FileHeaderInfo>USE"
    b"</FileHeaderInfo></CSV></InputSerialization><OutputSerialization>"
    b"<CSV/></OutputSerialization></SelectObjectContentRequest>")


def _stop_gateway(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert out.splitlines()[-1] == "signal 15, shutting down", out
    return out


def _fs_requests(c: S3Client) -> list:
    """The same signed requests to an FS or NAS server of either package;
    answers normalized as tests/test_torch_server.py does, upload ids
    and Select's frames apart."""
    import re

    from minio_tpu_torch.s3select import message
    from tests.test_torch_server import _normalize

    out = []

    def rec(r):
        st, h, body = _normalize((r.status, r.headers, r.body))
        body = re.sub(rb"<UploadId>[^<]*</UploadId>", b"<UploadId/>", body)
        body = re.sub(rb"<Location>[^<]*</Location>", b"<Location/>", body)
        out.append((st, h, body))
        return r

    data = bytes(range(256)) * 300
    rec(c.make_bucket("fsb"))
    rec(c.put_object("fsb", "dir/a.bin", data,
                     headers={"x-amz-meta-k": "v", "content-type": "x/y"}))
    rec(c.get_object("fsb", "dir/a.bin"))
    rec(c.head_object("fsb", "dir/a.bin"))
    rec(c.get_object("fsb", "dir/a.bin", headers={"range": "bytes=10-99"}))
    rec(c.put_object("fsb", "top.txt", b"top"))
    rec(c.request("GET", "/fsb", query={"delimiter": "/"}))
    rec(c.request("PUT", "/fsb/top.txt", query={"tagging": ""},
                  body=b"<Tagging><TagSet><Tag><Key>a</Key><Value>1</Value>"
                  b"</Tag></TagSet></Tagging>"))
    rec(c.request("GET", "/fsb/top.txt", query={"tagging": ""}))
    r = rec(c.request("POST", "/fsb/mp", query={"uploads": ""}))
    uid = r.xml_text("UploadId")
    r = rec(c.request("PUT", "/fsb/mp", query={"uploadId": uid,
                                                "partNumber": "1"},
                      body=data))
    etag = r.headers["etag"]
    rec(c.request("POST", "/fsb/mp", query={"uploadId": uid},
                  body=(f"<CompleteMultipartUpload><Part><PartNumber>1"
                        f"</PartNumber><ETag>{etag}</ETag></Part>"
                        f"</CompleteMultipartUpload>").encode()))
    rec(c.get_object("fsb", "mp"))
    rec(c.request("PUT", "/fsb/copy", headers={
        "x-amz-copy-source": "/fsb/dir/a.bin"}))
    rec(c.get_object("fsb", "copy"))
    rec(c.request("GET", "/fsb", query={"versions": ""}))
    rec(c.put_object("fsb", "t.csv", _FS_CSV))
    r = c.request("POST", "/fsb/t.csv", query={"select": "",
                                               "select-type": "2"},
                  body=_FS_SELECT)
    out.append((r.status, b"".join(
        m["payload"] for m in message.decode_all(r.body)
        if m["headers"].get(":event-type") == "Records")))
    rec(c.delete_object("fsb", "top.txt"))
    rec(c.get_object("fsb", "top.txt"))
    return out


@pytest.mark.parametrize("mode", ["fs", "nas"])
def test_fs_mode_and_nas_gateway_serve_as_the_jax_server(tmp_path, mode):
    """``server /dir`` and ``server gateway nas /dir`` of both packages,
    spawned side by side: equal answers and byte-equal object files.  The
    JAX server's Select runs its host engine (its device engine needs
    jax.experimental.enable_x64), the port's the default engine on the
    CPU.  ListMultipartUploads is held on the port alone: the JAX FS
    layer's records fail there with a 500."""
    procs, outs, roots = {}, {}, {}
    for pkg in ("minio_tpu", "minio_tpu_torch"):
        roots[pkg] = str(tmp_path / pkg / "drive")
        port = _free_port()
        args = ([roots[pkg]] if mode == "fs"
                else ["gateway", "nas", roots[pkg]])
        env = _env(MINIO_TPU_SELECT="host" if pkg == "minio_tpu" else None)
        procs[pkg] = (subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.server", "--address",
             f"127.0.0.1:{port}", *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), port)
    try:
        for pkg, (proc, port) in procs.items():
            _until(lambda port=port: _ready(port) == 200, 90, "readiness")
            outs[pkg] = _fs_requests(S3Client(f"http://127.0.0.1:{port}"))
        port_c = S3Client(f"http://127.0.0.1:{procs['minio_tpu_torch'][1]}")
        r = port_c.request("POST", "/fsb/pending", query={"uploads": ""})
        r = port_c.request("GET", "/fsb", query={"uploads": ""})
        assert r.status == 200 and r.xml_all("Key") == ["pending"]
    finally:
        # a gateway's last line is the signal's: it has no planes to drain
        logs, errors = {}, []
        for pkg, (proc, _) in procs.items():
            try:
                logs[pkg] = (_stop(proc) if mode == "fs"
                             else _stop_gateway(proc))
            except AssertionError as e:
                errors.append(e)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise errors[0]
    assert len(outs["minio_tpu_torch"]) == len(outs["minio_tpu"])
    for got, want in zip(outs["minio_tpu_torch"], outs["minio_tpu"]):
        assert got == want
    for bucket_file in ("dir/a.bin", "mp", "copy", "t.csv"):
        with open(os.path.join(roots["minio_tpu"], "fsb", bucket_file),
                  "rb") as f:
            want = f.read()
        with open(os.path.join(roots["minio_tpu_torch"], "fsb",
                               bucket_file), "rb") as f:
            assert f.read() == want, bucket_file
    serving = [line.split(" at ")[0] for line in
               logs["minio_tpu_torch"].splitlines() if "serving" in line]
    want_line = ("minio-tpu serving standalone FS backend (1 drive)"
                 if mode == "fs" else
                 f"minio-tpu serving NAS gateway over "
                 f"{roots['minio_tpu_torch']}")
    assert serving == [want_line]
    assert not any("Traceback" in o for o in logs.values()), logs
