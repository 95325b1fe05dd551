"""Multi-process cluster harness: N real ``python -m minio_tpu_torch.server``
nodes over loopback, one shared endpoint list (verify-healing.sh style).

Each node is a genuine OS process running the full stack - async
request plane, storage/lock/peer REST planes, heal threads - so
scenarios exercise the same wire paths a production pool does.  The
codec's device comes from ``MINIO_ERASURE_BACKEND`` in the caller's
environment (or ``env``), passed through to every node: ``cpu`` in the
tests, unset (the card) in chip_smoke.py, where all nodes share one
card.  The harness owns:

- drive layout + port allocation + spawn env (fast heal/lock cadences,
  fault injection armed),
- per-node log capture (``<base>/node<i>.log``, appended across
  restarts),
- readiness polling against /minio/health/ready (no sleeps),
- lifecycle: SIGTERM drain, SIGKILL, restart with the same identity,
- programmatic fault control: the admin ``fault/*`` endpoint schedules
  FaultDisk delay/error/corrupt/hang rules inside a REMOTE node,
- per-node Prometheus scrapes merged under a ``node`` label with
  zero-fill, so breaker/hedge/shed counters are node-attributable.

The chaos-scenario DSL that drives this lives in minio_tpu_torch/testgrid/.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

from ..utils.log import kv, logger

_log = logger("harness")

_REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[2])

# counter families every node must report even when idle: a merged
# scrape that silently omits a node reads as "nothing happened there"
# when the truth may be "the node never exported the family"
ZERO_FILL_FAMILIES = (
    "miniotpu_disk_state",
    "miniotpu_hedge_launched_total",
    "miniotpu_server_shed_total",
)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parse_prometheus(text: str) -> "list[tuple[str, dict, float]]":
    """Minimal exposition-format parser: (family, labels, value) rows."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        labels: dict = {}
        name = name_part
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            body = rest.rsplit("}", 1)[0]
            for item in body.split('",'):
                if not item:
                    continue
                k, _, v = item.partition('="')
                labels[k.strip().strip(",")] = v.rstrip('"')
        try:
            rows.append((name, labels, float(value_part)))
        except ValueError:
            _log.debug(
                "unparseable metric line", extra=kv(line=line[:120])
            )
    return rows


class NodeClient:
    """A small SigV4 client over one keep-alive ``http.client``
    connection, signing with server/auth.py (the S3 gateway's client,
    which the JAX harness borrows, is slice 9c)."""

    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 timeout: float = 120.0):
        self.host, self.port = host, port
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self._timeout = timeout
        self._conn: "http.client.HTTPConnection | None" = None

    def request(
        self,
        method: str,
        path: str,
        query: "dict[str, str] | None" = None,
        body: "bytes | None" = b"",
        headers: "dict[str, str] | None" = None,
    ) -> "tuple[int, dict, bytes]":
        """(status, lower-cased headers, body) of one signed request;
        one retry on a fresh connection when a kept-alive one died."""
        from ..server import auth

        body = body or b""
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        hdrs["host"] = f"{self.host}:{self.port}"
        hdrs["x-amz-date"] = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        phash = hashlib.sha256(body).hexdigest()
        hdrs["x-amz-content-sha256"] = phash
        signed = sorted(hdrs)
        qmap = {k: [v] for k, v in (query or {}).items()}
        sig = auth.sign_v4(method, path, qmap, hdrs, signed, phash,
                           self.access_key, self.secret_key,
                           hdrs["x-amz-date"], self.region)
        scope = f"{hdrs['x-amz-date'][:8]}/{self.region}/s3/aws4_request"
        hdrs["authorization"] = (
            f"{auth.SIGN_V4_ALGORITHM} Credential={self.access_key}/"
            f"{scope}, SignedHeaders={';'.join(signed)}, Signature={sig}"
        )
        qs = urllib.parse.urlencode(query or {})
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self._timeout
                )
            try:
                self._conn.request(method, url, body=body or None,
                                   headers=hdrs)
                resp = self._conn.getresponse()
                data = resp.read()
                return (
                    resp.status,
                    {k.lower(): v for k, v in resp.getheaders()},
                    data,
                )
            except (OSError, http.client.HTTPException):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class NodeHandle:
    """One cluster member: identity survives restarts, the process
    object is replaced."""

    def __init__(self, index: int, port: int, drive_dirs: list,
                 log_path: str):
        self.index = index
        self.port = port
        self.drive_dirs = list(drive_dirs)
        self.log_path = log_path
        self.proc: "subprocess.Popen | None" = None

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def log_tail(self, max_bytes: int = 8192) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - max_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""


class ClusterHarness:
    """Spawn and drive an N-node loopback cluster of real processes."""

    def __init__(
        self,
        base_dir,
        nodes: int = 3,
        drives_per_node: int = 2,
        access_key: str = "minioadmin",
        secret_key: str = "minioadmin",
        env: "dict[str, str] | None" = None,
        fast: bool = True,
        fault_injection: bool = True,
        format_timeout_s: float = 60.0,
    ):
        self.base = pathlib.Path(base_dir)
        self.access_key = access_key
        self.secret_key = secret_key
        self.fault_injection = fault_injection
        self.format_timeout_s = format_timeout_s
        self._extra_env = dict(env or {})
        self._fast = fast
        self.nodes: list[NodeHandle] = []
        for i in range(nodes):
            node_dir = self.base / f"n{i + 1}"
            dirs = []
            for j in range(drives_per_node):
                d = node_dir / f"d{j + 1}"
                d.mkdir(parents=True, exist_ok=True)
                dirs.append(d)
            self.nodes.append(
                NodeHandle(
                    i,
                    free_port(),
                    dirs,
                    str(self.base / f"node{i + 1}.log"),
                )
            )
        # one endpoint list shared verbatim by every node: the set
        # spans all drives of all nodes (single zone, no ellipses)
        self.endpoints = [
            f"http://127.0.0.1:{n.port}{d}"
            for n in self.nodes
            for d in n.drive_dirs
        ]

    # -- lifecycle --------------------------------------------------------

    def _spawn_env(self, node: NodeHandle) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT
        if self.fault_injection:
            env["MINIO_TPU_FAULT_INJECTION"] = "1"
            env["MINIO_TPU_FAULT_SEED"] = str(1000 * (node.index + 1))
        env["MINIO_TPU_PROMETHEUS_AUTH_TYPE"] = "public"
        if self._fast:
            # tighten heal/lock cadences so scenarios converge in
            # seconds instead of the production-default minutes
            env.setdefault("MINIO_TPU_FRESH_DISK_INTERVAL_S", "1")
            env.setdefault("MINIO_TPU_LOCK_REFRESH_S", "1")
            env.setdefault("MINIO_TPU_LOCK_EXPIRY_S", "4")
            # a write below lock quorum should 503 well inside the
            # client's socket budget, not after the 30s default
            env.setdefault("MINIO_TPU_WRITE_LOCK_ACQUIRE_S", "5")
        env.update(self._extra_env)
        return env

    def spawn(self, i: int, extra_env: "dict | None" = None) -> None:
        node = self.nodes[i]
        env = self._spawn_env(node)
        env.update(extra_env or {})
        log_f = open(node.log_path, "ab")  # noqa: SIM115 (child owns fd)
        log_f.write(
            f"--- spawn node{i + 1} port={node.port} ---\n".encode()
        )
        node.proc = subprocess.Popen(
            [
                sys.executable, "-m", "minio_tpu_torch.server",
                "--address", f"127.0.0.1:{node.port}",
                "--format-timeout", str(self.format_timeout_s),
                *self.endpoints,
            ],
            env=env,
            stdout=log_f,
            stderr=subprocess.STDOUT,
        )
        log_f.close()  # child inherited the fd

    def start(self, timeout_s: float = 90.0) -> "ClusterHarness":
        for i in range(len(self.nodes)):
            self.spawn(i)
        for i in range(len(self.nodes)):
            self.wait_ready(i, timeout_s=timeout_s)
        return self

    def wait_ready(self, i: int, timeout_s: float = 90.0) -> None:
        """Poll /minio/health/ready until the node reports every
        subsystem up; a dead process fails fast with its log tail."""
        node = self.nodes[i]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if node.proc is not None and node.proc.poll() is not None:
                raise RuntimeError(
                    f"node{i + 1} died rc={node.proc.returncode}:\n"
                    + node.log_tail()
                )
            try:
                req = urllib.request.Request(
                    f"{node.endpoint}/minio/health/ready", method="GET"
                )
                with urllib.request.urlopen(req, timeout=2) as r:
                    if r.status == 200:
                        return
            except (urllib.error.HTTPError, OSError):
                pass
            time.sleep(0.1)
        raise RuntimeError(
            f"node{i + 1} :{node.port} never became ready:\n"
            + node.log_tail()
        )

    def terminate(self, i: int, timeout_s: float = 30.0) -> int:
        """Graceful stop: SIGTERM, wait for the drain + lock unwind."""
        node = self.nodes[i]
        if node.proc is None or node.proc.poll() is not None:
            return node.proc.returncode if node.proc else 0
        node.proc.send_signal(signal.SIGTERM)
        return node.proc.wait(timeout=timeout_s)

    def kill(self, i: int) -> None:
        """Hard stop (crash simulation): SIGKILL, no drain."""
        node = self.nodes[i]
        if node.proc is not None and node.proc.poll() is None:
            node.proc.kill()
            node.proc.wait(timeout=10)

    def restart(
        self,
        i: int,
        graceful: bool = False,
        wait: bool = True,
        timeout_s: float = 90.0,
        extra_env: "dict | None" = None,
    ) -> None:
        if graceful:
            self.terminate(i)
        else:
            self.kill(i)
        self.spawn(i, extra_env=extra_env)
        if wait:
            self.wait_ready(i, timeout_s=timeout_s)

    def stop(self) -> None:
        for i in range(len(self.nodes)):
            try:
                self.kill(i)
            except Exception as exc:
                _log.debug(
                    "node kill failed", extra=kv(node=i, err=str(exc))
                )

    def __enter__(self) -> "ClusterHarness":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- clients ----------------------------------------------------------

    def client(self, i: int) -> "NodeClient":
        """Signed S3 client against node i (owner credentials)."""
        return NodeClient(
            "127.0.0.1", self.nodes[i].port, self.access_key,
            self.secret_key,
        )

    def admin(
        self,
        i: int,
        method: str,
        tail: str,
        query: "dict[str, str] | None" = None,
        body: "bytes | None" = b"",
    ) -> "tuple[int, dict]":
        """One signed admin call against node i; JSON-decoded body."""
        c = self.client(i)
        try:
            status, _hdrs, raw = c.request(
                method, f"/minio-tpu/admin/v1/{tail}", query=query,
                body=body,
            )
        finally:
            c.close()
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            doc = {"raw": raw.decode(errors="replace")}
        return status, doc

    # -- remote fault control ---------------------------------------------

    def inject_fault(
        self,
        i: int,
        api: str,
        disk: str = "*",
        delay_s: float = 0.0,
        hang_s: float = 0.0,
        error: bool = False,
        corrupt: bool = False,
        prob: float = 1.0,
        calls: "list[int] | None" = None,
    ) -> dict:
        """Schedule one FaultDisk rule on node i's local drives."""
        doc = {
            "disk": disk,
            "api": api,
            "delay_s": delay_s,
            "hang_s": hang_s,
            "error": error,
            "corrupt": corrupt,
            "prob": prob,
        }
        if calls is not None:
            doc["calls"] = list(calls)
        status, out = self.admin(
            i, "POST", "fault/inject", body=json.dumps(doc).encode()
        )
        if status != 200:
            raise RuntimeError(f"fault/inject on node{i + 1}: {out}")
        return out

    def clear_faults(self, i: int, disk: str = "*") -> dict:
        status, out = self.admin(
            i,
            "POST",
            "fault/clear",
            body=json.dumps({"disk": disk}).encode(),
        )
        if status != 200:
            raise RuntimeError(f"fault/clear on node{i + 1}: {out}")
        return out

    def fault_status(self, i: int) -> dict:
        status, out = self.admin(i, "GET", "fault/status")
        if status != 200:
            raise RuntimeError(f"fault/status on node{i + 1}: {out}")
        return out

    # -- metrics ----------------------------------------------------------

    def scrape(self, i: int) -> str:
        """Raw Prometheus exposition from node i (public auth mode)."""
        req = urllib.request.Request(
            f"{self.nodes[i].endpoint}/minio-tpu/prometheus/metrics",
            method="GET",
        )
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.read().decode(errors="replace")

    def merged_metrics(
        self, families: "tuple | None" = None
    ) -> "dict[str, list[tuple[dict, float]]]":
        """Union of every live node's scrape, each sample labelled with
        node="n<i>".  Families in ZERO_FILL_FAMILIES get an explicit
        0-valued sample for nodes that did not export them, so a
        per-node query can always tell "zero" from "absent"."""
        want = families or ZERO_FILL_FAMILIES
        merged: dict[str, list] = {f: [] for f in want}
        for n in self.nodes:
            if not n.alive():
                continue
            tag = f"n{n.index + 1}"
            seen: set[str] = set()
            try:
                rows = parse_prometheus(self.scrape(n.index))
            except OSError:
                rows = []
            for name, labels, value in rows:
                if families is not None and name not in families:
                    continue
                labels = dict(labels, node=tag)
                merged.setdefault(name, []).append((labels, value))
                seen.add(name)
            for fam in want:
                if fam in ZERO_FILL_FAMILIES and fam not in seen:
                    merged[fam].append(({"node": tag}, 0.0))
        return merged

    def disk_states(self, i: int) -> "dict[str, int]":
        """endpoint -> breaker state (0/1/2) as node i observes it."""
        return {
            labels.get("disk", ""): int(value)
            for name, labels, value in parse_prometheus(self.scrape(i))
            if name == "miniotpu_disk_state"
        }
