"""The port's admin API and runtime config held against minio_tpu's.

Each package builds its single-node cluster with its own
``build_cluster`` (24 drives, two EC 8+4 sets) with the codec its server
runs under ``MINIO_ERASURE_BACKEND=cpu`` - each package's native
``CpuBackend``, two stripe workers a batch - attaches a store-backed
IAMSys and a heal routine, and serves it on its async plane.  The same signed admin requests go to both;
statuses and JSON documents must be equal once the volatile fields are
normalized: uptime, drive roots and sizes (two trees on one
filesystem), the node endpoint, service-account keys, profile bytes and
the loop's open connections (keep-alive connections of earlier calls
close on the client's schedule).  Deliberate differences are held on
their own:

* ``kernel-stats`` has the JAX package's keys less its mesh placement
  (``placement``, ``submeshes``) plus the port's kernel launch counts
  (``launches``, none under ``cpu``), and the port's batcher counts
  ``multi_client_flushes``; both book the same codec ops under backend
  ``cpu``;
* the ``codec backend`` key defaults to ``cuda`` and takes ``cuda`` or
  ``cpu`` only (``tpu`` and ``auto`` are refused); its help differs;
* every route of a feature not ported answers ``NotImplemented``
  naming its slice.

The persisted config document (``.sys/config/config.json``, read back
through each object layer) must be equal.
"""

import io
import json
import time
import os
import re

import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec.telemetry import KERNEL_STATS as JAX_STATS
from minio_tpu.crawler import crawler as jcrawler
from minio_tpu.heal.background import HealQueue as JaxQueue
from minio_tpu.heal.background import HealRoutine as JaxRoutine
from minio_tpu.iam.sys import IAMSys as JaxIAM
from minio_tpu.server import __main__ as jmain
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.config import ConfigError, ConfigSys
from minio_tpu_torch.crawler import crawler as tcrawler
from minio_tpu_torch.heal.background import HealQueue, HealRoutine
from minio_tpu_torch.iam.sys import IAMSys
from minio_tpu_torch.server import __main__ as tmain
from minio_tpu_torch.server import admin as tadmin
from minio_tpu_torch.server.http import S3Server
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

ADMIN = "/minio-tpu/admin/v1"
POLICY = {
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"],
                   "Resource": ["arn:aws:s3:::adm/*"]}],
}
ENV_SEAMS = ("MINIO_TPU_HEAL_THROTTLE_S", "MINIO_TPU_REQUESTS_MAX",
             "MINIO_TPU_COMPRESS", "MINIO_ERASURE_BACKEND",
             "MINIO_CODEC_BATCH_DEADLINE_MS", "MINIO_TPU_LOG_LEVEL")


def _boot(kind: str, base):
    pattern = str(base / kind / "d{1...24}")
    if kind == "jax":
        ol, _ = jmain.build_cluster([pattern], 0, "", parity=4)
        srv = JaxServer(ol, address="127.0.0.1:0")
        srv.attach_iam(JaxIAM("minioadmin", "minioadmin", ol))
        queue, routine_cls = JaxQueue(), JaxRoutine
    else:
        ol, _ = tmain.build_cluster([pattern], 0, parity=4, device="cpu",
                                    backend=tmain.codec_backend("cpu"))
        srv = S3Server(ol, address="127.0.0.1:0")
        srv.attach_iam(IAMSys("minioadmin", "minioadmin", ol))
        queue, routine_cls = HealQueue(), HealRoutine
    srv.heal_routine = routine_cls(ol, queue).start()
    srv.heal_queue = queue
    return srv.start()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_MESH", "0")
        mp.setenv("MINIO_TPU_SERVER", "async")
        mp.setenv("MINIO_TPU_SERVER_LOOPS", "1")
        for env in ENV_SEAMS:
            mp.delenv(env, raising=False)
        mp.setenv("MINIO_TPU_NATIVE_THREADS", "2")
        jbackend.reset_backend()
        tbackend.reset_backend()
        # the JAX server's codec under MINIO_ERASURE_BACKEND=cpu
        mp.setattr(jbackend, "_backend", jbackend._make("cpu"))
        # each package's codec ops are process-wide: book only this module's
        JAX_STATS.reset()
        KERNEL_STATS.reset()
        base = tmp_path_factory.mktemp("admin")
        srvs = {kind: _boot(kind, base) for kind in ("jax", "port")}
        for srv in srvs.values():
            c = S3Client(srv.endpoint)
            assert c.make_bucket("adm").status == 200
            for i in range(3):
                assert c.put_object("adm", f"o{i}",
                                    b"x" * (100 * i + 1)).status == 200
        try:
            yield srvs
        finally:
            for srv in srvs.values():
                srv.shutdown()
            for env in ENV_SEAMS:  # ConfigSys.apply wrote the env seams
                os.environ.pop(env, None)
            jbackend.reset_backend()
            tbackend.reset_backend()


def _norm_doc(doc, srv):
    root = os.path.commonpath(
        [d.root for z in srv.object_layer.zones for s in z.sets
         for d in (x.unwrapped.unwrapped for x in s.disks)])

    def walk(v, key=""):
        if key == "profiles":
            return {k: bool(x) for k, x in v.items()}
        if isinstance(v, dict):
            return {k: walk(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x, key) for x in v]
        if key in ("uptime_seconds", "total", "used", "free",
                   "connections", "inflight"):
            return "<volatile>"
        if key in ("accessKey", "secretKey") and isinstance(v, str):
            return "<key>"
        if isinstance(v, str):
            v = v.replace(root, "<root>").replace(srv.endpoint, "<endpoint>")
            v = v.replace(srv.tracer.node, "<node>")
        return v

    return walk(doc)


def _call(srv, method, tail, query=None, body=b""):
    r = S3Client(srv.endpoint).request(method, f"{ADMIN}/{tail}",
                                       query=query, body=body)
    if r.headers.get("Content-Type", r.headers.get("content-type", "")
                     ).startswith("application/json"):
        payload = _norm_doc(json.loads(r.body), srv)
    else:
        payload = re.sub(rb"<RequestId>[^<]*</RequestId>", b"", r.body)
    return r.status, payload


def _pol() -> bytes:
    return json.dumps(POLICY).encode()


# (name, method, tail, query, body): sent in this order to both
STEPS = [
    ("info", "GET", "info", None, b""),
    ("storageinfo", "GET", "storageinfo", None, b""),
    ("heal_object", "POST", "heal", {"bucket": "adm", "object": "o1"}, b""),
    ("heal_bucket", "POST", "heal", {"bucket": "adm"}, b""),
    ("heal_dry", "POST", "heal", {"bucket": "adm", "object": "o2",
                                  "dryRun": "true"}, b""),
    ("heal_no_bucket", "POST", "heal", None, b""),
    ("heal_missing", "POST", "heal", {"bucket": "adm", "object": "nope"},
     b""),
    ("bg_heal", "GET", "background-heal/status", None, b""),
    ("service_bad", "POST", "service", {"action": "reboot"}, b""),
    ("profiling_bad", "POST", "profiling/start", {"type": "gpu"}, b""),
    ("profiling_start", "POST", "profiling/start", {"type": "cpu"}, b""),
    ("profiling_twice", "POST", "profiling/start", {"type": "cpu"}, b""),
    ("profiling_download", "GET", "profiling/download", {"type": "cpu"},
     b""),
    ("profiling_download_idle", "GET", "profiling/download",
     {"type": "cpu"}, b""),
    ("config_help", "GET", "config-help", {"subsys": "heal"}, b""),
    ("config_help_unknown", "GET", "config-help", {"subsys": "nope"}, b""),
    ("config_help_missing", "GET", "config-help", None, b""),
    ("config_set", "PUT", "set-config-kv", {"subsys": "heal"},
     b'{"throttle_s": "0.5"}'),
    ("config_set_api", "PUT", "set-config-kv", {"subsys": "api"},
     b'{"requests_max": "64"}'),
    ("config_set_bad_num", "PUT", "set-config-kv", {"subsys": "heal"},
     b'{"throttle_s": "soon"}'),
    ("config_set_below_floor", "PUT", "set-config-kv", {"subsys": "heal"},
     b'{"fresh_disk_interval_s": "0.1"}'),
    ("config_set_unknown_key", "PUT", "set-config-kv", {"subsys": "heal"},
     b'{"nope": "1"}'),
    ("config_set_bad_json", "PUT", "set-config-kv", {"subsys": "heal"},
     b"{nope"),
    ("config_set_target", "PUT", "set-config-kv",
     {"subsys": "logger", "target": "audit"}, b'{"level": "debug"}'),
    ("config_del", "DELETE", "del-config-kv", {"subsys": "api"}, b""),
    ("config_del_unknown", "DELETE", "del-config-kv", {"subsys": "x"}, b""),
    ("loops_status", "GET", "loops/status", None, b""),
    ("loops_wedge_off", "POST", "loops/wedge", None,
     b'{"loop": 0, "seconds": 0.1}'),
    ("loops_bad_method", "GET", "loops/wedge", None, b""),
    ("policy_add", "PUT", "add-canned-policy", {"name": "adm-ro"}, _pol()),
    ("policy_bad", "PUT", "add-canned-policy", {"name": "bad"}, b"{x"),
    ("policies", "GET", "list-canned-policies", None, b""),
    ("user_add", "PUT", "add-user", {"accessKey": "alice123"},
     b'{"secretKey": "alicesecret123", "policy": "adm-ro"}'),
    ("user_policy", "PUT", "set-user-policy",
     {"accessKey": "alice123", "name": "readwrite"}, b""),
    ("user_status", "PUT", "set-user-status",
     {"accessKey": "alice123", "status": "disabled"}, b""),
    ("users", "GET", "list-users", None, b""),
    ("service_account", "POST", "service-account", {"parent": "alice123"},
     b""),
    ("group_add", "PUT", "update-group-members", {"group": "devs"},
     b'{"members": ["alice123"]}'),
    ("group_policy", "PUT", "set-group-policy",
     {"group": "devs", "name": "adm-ro"}, b""),
    ("group_status", "PUT", "set-group-status",
     {"group": "devs", "status": "disabled"}, b""),
    ("groups", "GET", "groups", None, b""),
    ("group", "GET", "group", {"group": "devs"}, b""),
    ("group_missing", "GET", "group", {"group": "ghosts"}, b""),
    ("group_remove", "PUT", "update-group-members", {"group": "devs"},
     b'{"members": ["alice123"], "isRemove": true}'),
    ("user_remove", "DELETE", "remove-user", {"accessKey": "alice123"}, b""),
    ("user_remove_missing", "DELETE", "remove-user",
     {"accessKey": "ghost9"}, b""),
    ("policy_remove", "DELETE", "remove-canned-policy", {"name": "adm-ro"},
     b""),
    ("policy_remove_missing", "DELETE", "remove-canned-policy",
     {"name": "adm-ro"}, b""),
    ("unknown_route", "GET", "no-such-route", None, b""),
]
assert len({s[0] for s in STEPS}) == len(STEPS)


@pytest.fixture(scope="module")
def answers(servers):
    out = {}
    for kind, srv in servers.items():
        out[kind] = {name: _call(srv, m, tail, q, body)
                     for name, m, tail, q, body in STEPS}
        r = S3Client(srv.endpoint, "alice123", "alicesecret123").request(
            "GET", f"{ADMIN}/info")
        out[kind]["not_owner"] = r.status
    return out


@pytest.mark.parametrize("step", [s[0] for s in STEPS] + ["not_owner"])
def test_admin_route_matches(answers, step):
    assert answers["port"][step] == answers["jax"][step]


def test_admin_routes_did_work(answers):
    a = answers["port"]
    assert a["info"][0] == 200 and a["info"][1]["storage"]["zones"][0][
        "disks"] == 24
    assert a["storageinfo"][1]["zones"][0]["online"] == 24
    assert a["heal_object"][0] == 200 and a["bg_heal"][1]["nodes"][0][
        "enabled"] is True
    assert a["profiling_download"][0] == 200
    assert a["config_set"] == (200, {})
    assert a["loops_status"][1]["mode"] == "async"
    assert a["not_owner"] == 403
    assert a["user_remove_missing"][0] == 400


def test_kernel_stats_shape(servers):
    got = {}
    for kind, srv in servers.items():
        status, doc = _call(srv, "GET", "kernel-stats")
        assert status == 200
        got[kind] = doc
    # the port adds its kernel wrappers' launch counts (none under cpu)
    assert set(got["port"]) == set(got["jax"]) | {"launches"}
    assert set(got["port"]["placement"]) == set(got["jax"]["placement"])
    assert isinstance(got["port"]["submeshes"], list)
    assert got["port"]["launches"] and not any(got["port"]["launches"].values())
    assert set(got["port"]["batch"]) == set(got["jax"]["batch"]) | {
        "multi_client_flushes"}
    # both native codecs booked the PUTs and heals above under ``cpu``,
    # op for op; neither ran a device pass
    ops = {kind: {(r["op"], r["backend"]) for r in doc["ops"]}
           for kind, doc in got.items()}
    assert ops["port"] == ops["jax"]
    assert ("encode_digest", "cpu") in ops["port"]
    assert {be for _op, be in ops["port"]} == {"cpu"}
    assert not got["port"]["device_passes"] and not got["jax"]["device_passes"]


def test_get_config_matches(servers):
    """Equal but for the codec device's default and help text."""
    docs = {}
    for kind, srv in servers.items():
        status, doc = _call(srv, "GET", "get-config")
        assert status == 200
        docs[kind] = doc
    assert docs["port"]["codec"]["_"].pop("backend") == "cuda"
    assert docs["jax"]["codec"]["_"].pop("backend") == "auto"
    assert docs["port"] == docs["jax"]
    assert _call(servers["port"], "GET", "config-help",
                 {"subsys": "codec"})[1]["backend"].startswith("cuda|cpu")


def test_loops_wedge_with_faults_enabled(servers):
    got = {}
    for kind, srv in servers.items():
        srv.fault_disks = {"stub": None}
        try:
            got[kind] = _call(srv, "POST", "loops/wedge", None,
                              b'{"loop": 0, "seconds": 0.1}')
            got[kind + "_bad"] = _call(srv, "POST", "loops/wedge", None,
                                       b'{"loop": 7, "seconds": 0.1}')
        finally:
            srv.fault_disks = None
    assert got["port"] == got["jax"] == (200, {"wedged": 0, "seconds": 0.1})
    assert got["port_bad"] == got["jax_bad"]


def test_persisted_config_document_matches(servers, answers):
    docs = {}
    for kind, srv in servers.items():
        buf = io.BytesIO()
        srv.object_layer.get_object(".sys", "config/config.json", buf)
        docs[kind] = json.loads(buf.getvalue())
    assert docs["port"] == docs["jax"]
    assert docs["port"]["heal"]["_"] == {"throttle_s": "0.5"}
    assert docs["port"]["logger"]["audit"] == {"level": "debug"}


def _heal_sequence_answers(srv, route) -> list:
    """A heal sequence over bucket ``adm``: launched, polled by its token
    until it ends (or stopped, then stopped again on a path with no
    sequence), and the answers with tokens and times left out."""
    def call(tail, query):
        status, doc = _call(srv, "POST", tail, query)
        if isinstance(doc, dict):
            doc = {k: v for k, v in doc.items()
                   if k not in ("client_token", "start_time")}
        return status, doc

    st, doc = _call(srv, "POST", "heal-sequence",
                    {"bucket": "adm", "forceStart": "true"})
    assert st == 200, doc
    token = doc["client_token"]
    out = [(st, sorted(doc))]
    if route == ("POST", "heal-sequence"):
        items = []
        for _ in range(300):
            st, doc = call("heal-sequence", {"bucket": "adm",
                                             "clientToken": token})
            items.extend(doc["items"])
            if doc["status"] != "running":
                break
            time.sleep(0.05)
        doc["items"] = items
        out.append((st, doc))
        out.append(call("heal-sequence", {"bucket": "adm",
                                          "clientToken": "bogus"}))
    else:
        out.append(call("heal-sequence/stop", {"bucket": "adm"}))
        out.append(call("heal-sequence/stop", {"bucket": "adm",
                                               "prefix": "none/"}))
    return out


@pytest.mark.parametrize(
    "route", [("POST", "heal-sequence"), ("POST", "heal-sequence/stop")],
    ids=lambda r: f"{r[0]} {r[1]}")
def test_heal_sequence_route_matches(servers, route):
    """The heal-sequence routes (once refused, slice 9d) answer as the
    JAX package's server does; tests/test_torch_heal_sequence.py holds
    the sequences in depth."""
    got = {kind: _heal_sequence_answers(srv, route)
           for kind, srv in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == (200, ["client_address", "client_token",
                                    "start_time"])
    if route == ("POST", "heal-sequence"):
        assert got["port"][1][1]["status"] == "finished"
        assert got["port"][1][1]["scanned"] == 3
        assert got["port"][2][0] == 400
    else:
        assert got["port"][1] == (200, {"status": "stopping"})
        assert got["port"][2][0] == 400


# the routes slice 9c and 9d's crawler serve, once refused: (route,
# query, body), sent to both servers in this order with a data crawler
# attached to each
SERVED = [
    (("GET", "get-bucket-quota"), {"bucket": "adm"}, b""),
    (("PUT", "set-bucket-quota"), {"bucket": "adm"},
     b'{"quota": 100000, "quotatype": "hard"}'),
    (("GET", "datausage"), None, b""),
    (("POST", "crawl"), None, b""),
    (("GET", "cache-stats"), None, b""),
    (("PUT", "set-remote-target"), {"bucket": "adm"},
     b'{"endpoint": "http://127.0.0.1:1", "access_key": "ak",'
     b' "secret_key": "sk", "target_bucket": "far"}'),
    (("GET", "list-remote-targets"), {"bucket": "adm"}, b""),
]


@pytest.fixture(scope="module")
def served(servers):
    """Each served route's answer, then the quota read back, on both."""
    out = {}
    for kind, srv in servers.items():
        cls = (jcrawler if kind == "jax" else tcrawler).DataCrawler
        srv.crawler = cls(srv.object_layer, srv.bucket_meta, sleep_every=0)
        try:
            got = {r: _call(srv, *r, q, body) for r, q, body in SERVED}
            got["quota_after"] = _call(srv, "GET", "get-bucket-quota",
                                       {"bucket": "adm"})
            got["usage_after"] = _call(srv, "GET", "datausage")
        finally:
            srv.crawler = None
            _call(srv, "PUT", "set-bucket-quota", {"bucket": "adm"}, b"{}")
            srv.bucket_meta.update("adm", replication_targets_json="")
        for key, (status, doc) in got.items():
            if isinstance(doc, dict):
                doc.pop("last_update_ns", None)
        out[kind] = got
    return out


@pytest.mark.parametrize(
    "route", [r for r, _q, _b in SERVED], ids=lambda r: f"{r[0]} {r[1]}")
def test_served_admin_route_matches(served, route):
    """Each route that answered NotImplemented before this slice now
    answers as the JAX package's server does."""
    assert served["port"][route] == served["jax"][route]
    assert served["port"][route][0] == 200
    if route == ("POST", "crawl"):
        doc = served["port"][route][1]
        assert doc["buckets"]["adm"]["objects"] == 3
        assert served["port"]["usage_after"] == served["jax"]["usage_after"]
        assert served["port"]["usage_after"][1] == doc
    if route == ("PUT", "set-bucket-quota"):
        assert served["port"]["quota_after"] == served["jax"][
            "quota_after"] == (200, {"quota": 100000, "quotatype": "hard"})
    if route == ("GET", "cache-stats"):
        assert served["port"][route][1] == {"enabled": False}
    if route == ("PUT", "set-remote-target"):
        assert served["port"][route][1] == {
            "arn": "arn:minio:replication:::far"}
    if route == ("GET", "list-remote-targets"):
        assert [d["target_bucket"] for d in served["port"][route][1]] == ["far"]


@pytest.mark.parametrize("value,ok", [
    ("cuda", True), ("cpu", True), ("tpu", False), ("auto", False),
    ("gpu", False), ("", False),
])
def test_codec_backend_values(servers, value, ok):
    srv = servers["port"]
    body = json.dumps({"backend": value}).encode()
    status, doc = _call(srv, "PUT", "set-config-kv", {"subsys": "codec"}, body)
    try:
        if ok:
            assert status == 200
            assert srv.config.get("codec", "backend") == value
            # persisted for the next boot; the running sets keep theirs
            assert srv.object_layer.zones[0].sets[0].backend.device.type \
                == "cpu"
        else:
            assert status == 400 and b"InvalidArgument" in doc
            assert b"cuda|cpu" in doc
    finally:
        assert _call(srv, "DELETE", "del-config-kv",
                     {"subsys": "codec"})[0] == 200


def test_config_sys_refuses_tpu_directly(tmp_path):
    cfg = ConfigSys()
    for bad in ("tpu", "auto"):
        with pytest.raises(ConfigError, match="cuda|cpu"):
            cfg.set_kvs("codec", {"backend": bad})
    cfg.set_kvs("codec", {"backend": "cpu"})
    assert cfg.get("codec", "backend") == "cpu"
    cfg.del_kvs("codec")
    os.environ.pop("MINIO_ERASURE_BACKEND", None)
