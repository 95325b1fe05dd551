"""Bucket replication in the port (replication/config.py,
replication/replicate.py, the ``?replication`` routes, the PUT-path
stamps, the admin remote targets and the crawler's catch-up) against
the JAX package's.

* ``ReplicationConfig`` parses the same documents (rule-level, Filter
  and Filter/And prefixes, priorities, ARNs and plain bucket names) and
  re-serializes them byte-equal to the JAX package's ``to_xml``; it
  refuses the same malformed ones with the same message, and picks the
  same rule for a key - over fixed documents and a hypothesis strategy.
* A JAX and a port ``S3Server`` (threaded plane, EC 4+2 over six
  temp-dir disks, the port on ``device="cpu"``) take the same signed
  requests: the ``?replication`` documents and the
  ``ReplicationSourceNotVersionedError``; a PUT stamped PENDING (the
  pool held), then COMPLETED on a local target; a missing target gives
  FAILED, and the crawler's catch-up pass brings it to COMPLETED; copy
  and multipart uploads are stamped and replicated; a prefix rule
  filters; the admin remote-target documents (``set-remote-target``,
  ``list-remote-targets``) are equal.
* Across packages over the wire: a port source replicates to a JAX
  target bucket and a JAX source to a port target (``HTTPTarget``,
  SigV4-signed streamed PUTs), user metadata included.
"""

from __future__ import annotations

import json
import re
import xml.sax.saxutils as sx

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from minio_tpu.codec import backend as jbackend
from minio_tpu.crawler import crawler as jcrawler
from minio_tpu.replication import config as jconfig
from minio_tpu.replication import replicate as jreplicate
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.crawler import crawler as tcrawler
from minio_tpu_torch.replication import config as tconfig
from minio_tpu_torch.replication import replicate as treplicate
from tests.s3client import S3Client
from tests.test_torch_server import _normalize, _pay, _res, _start
from tests.test_torch_threads import torch_threads  # noqa: F401

N = 6
KINDS = ("jax", "port")
ADMIN = "/minio-tpu/admin/v1"
STATUS = "x-amz-replication-status"
CFG = {"jax": jconfig, "port": tconfig}
REPL = {"jax": jreplicate, "port": treplicate}
CRAWLER = {"jax": jcrawler, "port": tcrawler}

REPL_XML = (
    "<ReplicationConfiguration>"
    "<Rule><Status>Enabled</Status><Priority>1</Priority>"
    "<Prefix>{prefix}</Prefix>"
    "<Destination><Bucket>arn:minio:replication:::{dst}</Bucket>"
    "</Destination></Rule>"
    "</ReplicationConfiguration>"
)

DOCS = [
    REPL_XML.format(prefix="", dst="dst"),
    # namespaced, Role, two rules, IDs that need escaping
    '<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
    "<Role>arn:aws:iam::1:role/r&amp;</Role>"
    "<Rule><ID>low</ID><Status>Enabled</Status><Priority>1</Priority>"
    "<Filter><Prefix>logs/</Prefix></Filter>"
    "<Destination><Bucket>arn:aws:s3:::plain</Bucket></Destination></Rule>"
    "<Rule><ID>a&lt;b</ID><Status>Disabled</Status><Priority>9</Priority>"
    "<Filter><And><Prefix>logs/x</Prefix></And></Filter>"
    "<DeleteMarkerReplication><Status>Disabled</Status>"
    "</DeleteMarkerReplication>"
    "<Destination><Bucket>named</Bucket></Destination></Rule>"
    "</ReplicationConfiguration>",
    # no Status (Enabled), no Priority, the ARN with a region and id
    "<ReplicationConfiguration><Rule><Prefix>p/</Prefix>"
    "<Destination><Bucket>arn:minio:replication:us-east-1:abc:far"
    "</Bucket></Destination></Rule></ReplicationConfiguration>",
]
BAD_DOCS = [
    "<ReplicationConfiguration><Rule>",
    "<Other/>",
    "<ReplicationConfiguration></ReplicationConfiguration>",
    "<ReplicationConfiguration><Rule><Status>On</Status>"
    "<Destination><Bucket>b</Bucket></Destination></Rule>"
    "</ReplicationConfiguration>",
    "<ReplicationConfiguration><Rule><Status>Enabled</Status>"
    "</Rule></ReplicationConfiguration>",
    "<ReplicationConfiguration><Rule><Priority>x</Priority>"
    "<Destination><Bucket>b</Bucket></Destination></Rule>"
    "</ReplicationConfiguration>",
]
KEYS = ["", "logs/", "logs/x1", "logs/y", "p/q", "other"]


def _parse(kind, doc: str):
    try:
        cfg = CFG[kind].ReplicationConfig.from_xml(doc.encode())
    except CFG[kind].ReplicationError as e:
        return ("error", str(e))
    rules = []
    for key in KEYS:
        r = cfg.rule_for(key)
        rules.append(None if r is None else (r.rule_id, r.target_bucket))
    return ("ok", cfg.to_xml(), rules)


@pytest.mark.parametrize("doc", DOCS + BAD_DOCS)
def test_config_round_trip_byte_equal(doc):
    got = {k: _parse(k, doc) for k in KINDS}
    assert got["port"] == got["jax"]


_TEXT = st.text(alphabet="ab/&<>'\"- _ü1", max_size=8)


@st.composite
def _documents(draw):
    rules = []
    for _ in range(draw(st.integers(1, 4))):
        where = draw(st.sampled_from(["rule", "filter", "and", "none"]))
        prefix = sx.escape(draw(_TEXT))
        pfx = {"rule": f"<Prefix>{prefix}</Prefix>",
               "filter": f"<Filter><Prefix>{prefix}</Prefix></Filter>",
               "and": f"<Filter><And><Prefix>{prefix}</Prefix></And></Filter>",
               "none": ""}[where]
        rid = draw(st.one_of(st.just(""), _TEXT))
        status = draw(st.sampled_from(["Enabled", "Disabled", ""]))
        prio = draw(st.one_of(st.just(""), st.integers(-3, 20).map(str)))
        dest = draw(st.sampled_from([
            "arn:minio:replication:::", "arn:aws:s3:::", ""])) + draw(
                st.text(alphabet="abc-1", min_size=1, max_size=6))
        rules.append(
            "<Rule>" + (f"<ID>{sx.escape(rid)}</ID>" if rid else "")
            + (f"<Status>{status}</Status>" if status else "")
            + (f"<Priority>{prio}</Priority>" if prio else "") + pfx
            + f"<Destination><Bucket>{dest}</Bucket></Destination></Rule>")
    role = draw(st.one_of(st.just(""), _TEXT))
    return ("<ReplicationConfiguration>"
            + (f"<Role>{sx.escape(role)}</Role>" if role else "")
            + "".join(rules) + "</ReplicationConfiguration>")


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_documents())
def test_config_hypothesis_byte_equal(doc):
    got = {k: _parse(k, doc) for k in KINDS}
    assert got["port"] == got["jax"]
    if got["port"][0] == "ok":
        # the serialized form parses back to itself
        again = _parse("port", got["port"][1].decode())
        assert again[1] == got["port"][1]


# -- both servers ----------------------------------------------------------


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_SERVER", "threaded")
        mp.setenv("MINIO_MESH", "0")
        jbackend.reset_backend()
        tbackend.reset_backend()
        base = tmp_path_factory.mktemp("replication")
        srvs = {k: _start(k, [str(base / f"{k}{i}") for i in range(N)])
                for k in KINDS}
        try:
            yield {k: (s, S3Client(s.endpoint)) for k, s in srvs.items()}
        finally:
            for s in srvs.values():
                s.shutdown()
            jbackend.reset_backend()
            tbackend.reset_backend()


def _versioned(c, bucket):
    assert c.make_bucket(bucket).status == 200
    r = c.request("PUT", f"/{bucket}", query={"versioning": ""},
                  body=b"<VersioningConfiguration><Status>Enabled</Status>"
                  b"</VersioningConfiguration>")
    assert r.status == 200


def _enable(c, src, dst, prefix=""):
    _versioned(c, src)
    assert c.make_bucket(dst).status == 200
    r = c.request("PUT", f"/{src}", query={"replication": ""},
                  body=REPL_XML.format(prefix=prefix, dst=dst).encode())
    assert r.status == 200, r.body


def _status(srv, bucket, key):
    return srv.object_layer.get_object_info(bucket, key).user_defined.get(STATUS)


def test_replication_documents_and_versioning_error(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        assert c.make_bucket("noversrc").status == 200
        _versioned(c, "docsrc")
        doc = REPL_XML.format(prefix="a/", dst="docdst").encode()
        steps = [
            c.request("PUT", "/noversrc", query={"replication": ""}, body=doc),
            c.request("GET", "/docsrc", query={"replication": ""}),
            c.request("PUT", "/docsrc", query={"replication": ""},
                      body=b"<ReplicationConfiguration/>"),
            c.request("PUT", "/docsrc", query={"replication": ""},
                      body=b"<ReplicationConfiguration><Rule>"),
            c.request("PUT", "/docsrc", query={"replication": ""}, body=doc),
            c.request("GET", "/docsrc", query={"replication": ""}),
            c.request("PUT", "/nosuch", query={"replication": ""}, body=doc),
            c.request("DELETE", "/docsrc", query={"replication": ""}),
            c.request("GET", "/docsrc", query={"replication": ""}),
        ]
        got[kind] = [_normalize(_res(r)) for r in steps]
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == [400, 404, 400, 400, 200, 200, 404,
                                          204, 404]
    assert b"ReplicationSourceNotVersionedError" in got["port"][0][2]
    assert got["port"][5][2].startswith(
        b'<?xml version="1.0" encoding="UTF-8"?>\n<ReplicationConfiguration')


def test_put_pending_then_completed_on_local_target(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        _enable(c, "replsrc", "repldst")
        live = srv.replication
        # hold the pool: the stamp is PENDING until a worker copies it
        srv._replication_pool = REPL[kind].ReplicationPool(srv)
        r = c.put_object("replsrc", "doc.txt", b"replicate me",
                         headers={"x-amz-meta-color": "blue"})
        assert r.status == 200
        pending = _status(srv, "replsrc", "doc.txt")
        srv._replication_pool = live
        live.queue("replsrc", "doc.txt", r.headers["x-amz-version-id"])
        live.drain()
        dst = c.get_object("repldst", "doc.txt")
        got[kind] = (pending, _status(srv, "replsrc", "doc.txt"),
                     dst.status, dst.body, dst.headers.get("x-amz-meta-color"),
                     STATUS in {k.lower() for k in dst.headers},
                     _status(srv, "repldst", "doc.txt"))
    assert got["port"] == got["jax"]
    assert got["port"] == ("PENDING", "COMPLETED", 200, b"replicate me",
                           "blue", False, None)
    # the port's HEAD shows the status, as the reference's does
    srv, c = servers["port"]
    assert c.request("HEAD", "/replsrc/doc.txt").headers[STATUS] == "COMPLETED"


def test_failed_replication_caught_up_by_crawler(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        _enable(c, "replsrc2", "repldst2")
        srv.object_layer.delete_bucket("repldst2", force=True)
        assert c.put_object("replsrc2", "x.bin", b"payload").status == 200
        srv.replication.drain()
        failed = _status(srv, "replsrc2", "x.bin")
        assert c.make_bucket("repldst2").status == 200
        crawler = CRAWLER[kind].DataCrawler(
            srv.object_layer, srv.bucket_meta, sleep_s=0,
            replication=srv.replication)
        crawler.crawl_once()
        srv.replication.drain()
        r = c.get_object("repldst2", "x.bin")
        got[kind] = (failed, r.status, r.body,
                     _status(srv, "replsrc2", "x.bin"))
        if kind == "port":
            assert crawler.stats_snapshot()["replication_requeued"] == 1
            # nothing left to re-queue
            crawler.crawl_once(force=True)
            assert crawler.stats_snapshot()["replication_requeued"] == 1
    assert got["port"] == got["jax"]
    assert got["port"] == ("FAILED", 200, b"payload", "COMPLETED")


def test_copy_and_multipart_are_stamped_and_replicated(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        _enable(c, "cpsrc", "cpdst")
        assert c.make_bucket("cporigin").status == 200
        assert c.put_object("cporigin", "big", _pay(3000, 4)).status == 200
        held = srv.replication
        srv._replication_pool = REPL[kind].ReplicationPool(srv)
        r1 = c.request("PUT", "/cpsrc/copied",
                       headers={"x-amz-copy-source": "/cporigin/big"})
        r2 = c.request("PUT", "/cpsrc/replaced",
                       headers={"x-amz-copy-source": "/cporigin/big",
                                "x-amz-metadata-directive": "REPLACE",
                                "x-amz-meta-k": "v"})
        up = c.request("POST", "/cpsrc/mp", query={"uploads": ""})
        uid = re.search(rb"<UploadId>([^<]+)</UploadId>", up.body).group(1).decode()
        part = c.request("PUT", "/cpsrc/mp",
                         query={"partNumber": "1", "uploadId": uid},
                         body=_pay(5000, 5))
        done = c.request(
            "POST", "/cpsrc/mp", query={"uploadId": uid},
            body=(f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
                  f"<ETag>{part.headers['etag']}</ETag></Part>"
                  "</CompleteMultipartUpload>").encode())
        keys = ("copied", "replaced", "mp")
        pending = [_status(srv, "cpsrc", k) for k in keys]
        srv._replication_pool = held
        for k in keys:
            held.queue("cpsrc", k, srv.object_layer.get_object_info(
                "cpsrc", k).version_id)
        held.drain()
        got[kind] = ([_normalize(_res(r))[0] for r in (r1, r2, done)], pending,
                     [_status(srv, "cpsrc", k) for k in keys],
                     [c.get_object("cpdst", k).body for k in keys],
                     c.get_object("cpdst", "replaced").headers.get("x-amz-meta-k"))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ([200] * 3, ["PENDING"] * 3, ["COMPLETED"] * 3)
    assert got["port"][3] == [_pay(3000, 4)] * 2 + [_pay(5000, 5)]
    assert got["port"][4] == "v"


def test_prefix_rule_filters(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        _enable(c, "prefsrc", "prefdst", prefix="logs/")
        c.put_object("prefsrc", "logs/a.log", b"in scope")
        c.put_object("prefsrc", "data/b.bin", b"out of scope")
        srv.replication.drain()
        got[kind] = (c.get_object("prefdst", "logs/a.log").status,
                     c.get_object("prefdst", "data/b.bin").status,
                     _status(srv, "prefsrc", "logs/a.log"),
                     _status(srv, "prefsrc", "data/b.bin"))
    assert got["port"] == got["jax"]
    assert got["port"] == (200, 404, "COMPLETED", None)


def _set_target(c, bucket, endpoint, target_bucket):
    return c.request(
        "PUT", f"{ADMIN}/set-remote-target", query={"bucket": bucket},
        body=json.dumps({"endpoint": endpoint, "access_key": "minioadmin",
                         "secret_key": "minioadmin",
                         "target_bucket": target_bucket}).encode())


def test_admin_remote_target_documents(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        assert c.make_bucket("tgtdocs").status == 200
        steps = [
            c.request("GET", f"{ADMIN}/list-remote-targets",
                      query={"bucket": "tgtdocs"}),
            _set_target(c, "tgtdocs", "http://127.0.0.1:1", "far"),
            _set_target(c, "tgtdocs", "http://127.0.0.1:2", "far"),
            _set_target(c, "tgtdocs", "http://127.0.0.1:3", "other"),
            c.request("PUT", f"{ADMIN}/set-remote-target",
                      query={"bucket": "tgtdocs"},
                      body=b'{"endpoint": "http://x"}'),
            c.request("GET", f"{ADMIN}/list-remote-targets",
                      query={"bucket": "tgtdocs"}),
            c.request("GET", f"{ADMIN}/list-remote-targets",
                      query={"bucket": "nosuch"}),
        ]
        got[kind] = [_normalize(_res(r)) for r in steps]
    assert got["port"] == got["jax"]
    docs = json.loads(got["port"][5][2])
    assert [(d["endpoint"], d["target_bucket"]) for d in docs] == [
        ("http://127.0.0.1:2", "far"), ("http://127.0.0.1:3", "other")]
    assert got["port"][1][2] == b'{"arn": "arn:minio:replication:::far"}'


@pytest.mark.parametrize("source,target", [("port", "jax"), ("jax", "port")])
def test_remote_target_across_packages(servers, source, target):
    """One package's source replicates to the other's server over
    SigV4-signed HTTP; the target's object equals the source's."""
    ssrv, sc = servers[source]
    tsrv, tc = servers[target]
    src, dst = f"x{source}src", f"x{source}dst"
    assert tc.make_bucket(dst).status == 200
    _enable(sc, src, f"{dst}-unused")
    assert _set_target(sc, src, tsrv.endpoint, dst).status == 200
    body = _pay(9000, 6)
    r = sc.put_object(src, "cross.txt", body,
                      headers={"x-amz-meta-color": "blue",
                               "content-type": "text/plain"})
    assert r.status == 200
    ssrv.replication.drain()
    got = tc.get_object(dst, "cross.txt")
    assert (got.status, got.body) == (200, body)
    assert got.headers.get("x-amz-meta-color") == "blue"
    assert _status(ssrv, src, "cross.txt") == "COMPLETED"
    assert tsrv.object_layer.get_object_info(dst, "cross.txt").etag == \
        ssrv.object_layer.get_object_info(src, "cross.txt").etag
    # the destination's answer to a source GET matches the source's
    assert _normalize(_res(sc.get_object(src, "cross.txt")))[2] == body


def test_remote_target_down_marks_failed(servers):
    got = {}
    for kind, (srv, c) in servers.items():
        _enable(c, "downsrc", "downdst-unused")
        assert _set_target(c, "downsrc", "http://127.0.0.1:1", "gone").status == 200
        assert c.put_object("downsrc", "k", b"v").status == 200
        srv.replication.drain()
        got[kind] = _status(srv, "downsrc", "k")
    assert got["port"] == got["jax"] == "FAILED"
