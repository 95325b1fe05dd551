"""The port's federation held against minio_tpu's.

* The bucket DNS stores (``cluster/dns.py``): each test of
  ``tests/test_federation.py`` on the port's ``MemoryDNSStore`` and
  ``FileDNSStore``; the record files the two packages write are
  byte-equal, and each package reads the other's.
* Federated servers: each of that file's server tests on two port
  ``S3Server``s (``device="cpu"``, threaded plane) sharing one
  ``FileDNSStore`` directory: names unique across the federation, a
  bucket owned by the other server answered 307 to its owner with the
  owner's scheme, ListBuckets the union, a DELETE freeing the name.
* A mixed federation: one port ``S3Server`` and one JAX ``S3Server``
  sharing one directory.  A bucket owned by either server gets the same
  307 ``Location`` from the other, names are unique across both
  packages, and both list the union.
* The web plane's DeleteBucket (``web.DeleteBucket`` over the JSON-RPC
  plane) frees the federated name, in a port federation and in the
  mixed one.
"""

import http.client
import json
import os
import threading

import numpy as np
import pytest

from minio_tpu.cluster import dns as jdns
from minio_tpu.codec import backend as jbackend
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.server.http import S3Server as JaxServer
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.cluster import dns as tdns
from minio_tpu_torch.cluster.dns import (
    FileDNSStore,
    MemoryDNSStore,
    NoEntriesFound,
    RecordExists,
    SrvRecord,
)
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.server.http import S3Server
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

BLOCK = 4096


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mk", [MemoryDNSStore, None],
                         ids=["memory", "file"])
def test_dns_store_crud(mk, tmp_path):
    store = mk() if mk else FileDNSStore(str(tmp_path / "dns"))
    with pytest.raises(NoEntriesFound):
        store.get("bkt")
    recs = [SrvRecord(host="10.0.0.1", port=9000, key="bkt")]
    store.put("bkt", recs)
    got = store.get("bkt")
    assert got[0].host == "10.0.0.1" and got[0].port == 9000
    assert "bkt" in store.list()
    store.delete("bkt")
    with pytest.raises(NoEntriesFound):
        store.get("bkt")
    store.delete("bkt")  # idempotent


def test_file_store_shared_between_instances(tmp_path):
    a = FileDNSStore(str(tmp_path / "shared"))
    b = FileDNSStore(str(tmp_path / "shared"))
    a.put("common", [SrvRecord(host="h1", port=1)])
    assert b.get("common")[0].host == "h1"


def test_dns_exclusive_create(tmp_path):
    """Two clusters racing a CreateBucket: exactly one wins the record
    (a hard link is the compare-and-create), on both stores."""
    store = FileDNSStore(str(tmp_path / "cas"))
    store.create("race", [SrvRecord(host="a", port=1)])
    with pytest.raises(RecordExists):
        store.create("race", [SrvRecord(host="b", port=2)])
    assert store.get("race")[0].host == "a"
    assert sorted(os.listdir(tmp_path / "cas")) == ["race.json"]
    mem = MemoryDNSStore()
    mem.create("race", [SrvRecord(host="a", port=1)])
    with pytest.raises(RecordExists):
        mem.create("race", [SrvRecord(host="b", port=2)])


def test_file_store_concurrent_creates_in_one_process(tmp_path):
    """Threads of one process racing to create one name: each round one
    create wins and every other gets RecordExists - nothing else, and no
    staging file is left behind (each create stages under its own name)."""
    store = FileDNSStore(str(tmp_path / "cas"))
    for r in range(40):
        name = f"race-{r}"
        start = threading.Barrier(4)
        results = []

        def create(i, name=name, start=start, results=results):
            start.wait()
            try:
                store.create(name, [SrvRecord(host=f"h{i}", port=i)])
                results.append("won")
            except RecordExists:
                results.append("lost")
            except Exception as e:  # noqa: BLE001 - the failure under test
                results.append(repr(e))

        ts = [threading.Thread(target=create, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sorted(results) == ["lost"] * 3 + ["won"], results
    assert sorted(os.listdir(tmp_path / "cas")) == sorted(
        f"race-{r}.json" for r in range(40))


def test_dns_store_rejects_bad_names_and_corrupt_records(tmp_path):
    got = {}
    for name, mod in (("port", tdns), ("jax", jdns)):
        store = mod.FileDNSStore(str(tmp_path / name))
        errs = []
        for bad in ("a/b", ".hidden"):
            with pytest.raises(mod.DNSError) as ei:
                store.get(bad)
            errs.append(str(ei.value))
        with open(tmp_path / name / "torn.json", "wb") as f:
            f.write(b"[{")
        with pytest.raises(mod.DNSError) as ei:
            store.get("torn")
        errs.append(str(ei.value))
        store.put("ok", [mod.SrvRecord(host="h", port=1, key="ok")])
        got[name] = (errs, sorted(store.list()))
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["ok"]  # a corrupt record is skipped


def test_records_byte_equal_and_read_across_packages(tmp_path, monkeypatch):
    """The same registration writes the same record file in both
    packages, and each package reads the other's."""
    monkeypatch.setattr("time.time_ns", lambda: 1_700_000_000_123_456_789)
    shared = str(tmp_path / "shared")
    blobs = {}
    for name, mod in (("port", tdns), ("jax", jdns)):
        d = str(tmp_path / name)
        mod.BucketDNS(mod.FileDNSStore(d), "10.1.2.3", 9000,
                      scheme="https").register("bkt")
        with open(os.path.join(d, "bkt.json"), "rb") as f:
            blobs[name] = f.read()
    assert blobs["port"] == blobs["jax"]
    tdns.BucketDNS(tdns.FileDNSStore(shared), "h1", 1).register("from-port")
    jdns.BucketDNS(jdns.FileDNSStore(shared), "h2", 2).register("from-jax")
    port_view = tdns.FileDNSStore(shared).list()
    jax_view = jdns.FileDNSStore(shared).list()
    assert {b: [r.to_dict() for r in rs] for b, rs in port_view.items()} == \
        {b: [r.to_dict() for r in rs] for b, rs in jax_view.items()}
    assert port_view["from-jax"][0].host == "h2"
    assert jax_view["from-port"][0].port == 1
    # ownership is decided the same way on both sides
    t_me = tdns.BucketDNS(tdns.FileDNSStore(shared), "h2", 2)
    j_me = jdns.BucketDNS(jdns.FileDNSStore(shared), "h2", 2)
    for b in ("from-port", "from-jax"):
        assert t_me.owned_by_us(t_me.lookup(b)) == \
            j_me.owned_by_us(j_me.lookup(b)) == (b == "from-jax")


# ---------------------------------------------------------------------------
# federated servers
# ---------------------------------------------------------------------------


def _start(tmp_path, name: str, kind: str, store_dir: str):
    if kind == "port":
        disks = [XLStorage(str(tmp_path / f"{name}-d{i}")) for i in range(4)]
        srv = S3Server(ErasureObjects(disks, block_size=BLOCK, device="cpu"),
                       address="127.0.0.1:0").start()
        mod = tdns
    else:
        disks = [JaxStorage(str(tmp_path / f"{name}-d{i}")) for i in range(4)]
        srv = JaxServer(JaxObjects(disks, block_size=BLOCK),
                        address="127.0.0.1:0").start()
        mod = jdns
    host, port = srv.endpoint.split("//")[1].rsplit(":", 1)
    srv.bucket_dns = mod.BucketDNS(mod.FileDNSStore(store_dir), host, int(port))
    return srv


@pytest.fixture()
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_MESH", "0")
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield
    jbackend.reset_backend()
    tbackend.reset_backend()


def _pair(tmp_path, kinds):
    store = str(tmp_path / "fed-dns")
    a = _start(tmp_path, "a", kinds[0], store)
    b = _start(tmp_path, "b", kinds[1], store)
    return a, b


@pytest.fixture()
def federation(tmp_path, _env):
    a, b = _pair(tmp_path, ("port", "port"))
    yield a, b
    a.shutdown()
    b.shutdown()


@pytest.fixture(params=[("port", "jax"), ("jax", "port")],
                ids=["port_owner", "jax_owner"])
def mixed(tmp_path, _env, request):
    a, b = _pair(tmp_path, request.param)
    yield a, b
    a.shutdown()
    b.shutdown()


def test_bucket_names_globally_unique(federation):
    a, b = federation
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("fedbkt").status == 200
    # same name on the other cluster: taken by a different deployment
    r = cb.make_bucket("fedbkt")
    assert r.status == 409
    assert r.error_code == "BucketAlreadyExists"
    # re-create on the owner: already owned by you
    r = ca.make_bucket("fedbkt")
    assert r.status == 409
    assert r.error_code == "BucketAlreadyOwnedByYou"
    # the loser made nothing on its own drives
    assert cb.request("HEAD", "/fedbkt").status == 307


def test_remote_bucket_redirects_to_owner(federation):
    a, b = federation
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("abkt").status == 200
    assert ca.put_object("abkt", "k", b"fed-data").status == 200
    # cluster B does not hold the bucket: 307 to the owner
    r = cb.get_object("abkt", "k")
    assert r.status == 307, (r.status, r.body)
    loc = r.headers.get("location", "")
    assert a.endpoint in loc and loc.endswith("/abkt/k")
    # a PUT and a bucket listing are sent to the owner the same way
    assert cb.put_object("abkt", "k2", b"x").status == 307
    r = cb.request("GET", "/abkt", query={"list-type": "2"})
    assert r.status == 307 and r.headers["location"] == f"{a.endpoint}/abkt?list-type=2"
    # following the redirect (signed against the owner) serves the data
    assert ca.get_object("abkt", "k").body == b"fed-data"
    # a bucket in NO cluster still 404s
    assert cb.get_object("missing-bkt", "k").status == 404


def test_federated_list_buckets_union(federation):
    a, b = federation
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("from-a").status == 200
    assert cb.make_bucket("from-b").status == 200
    for c in (ca, cb):
        r = c.request("GET", "/")
        assert r.status == 200
        assert b"from-a" in r.body and b"from-b" in r.body
        assert r.body.index(b"from-a") < r.body.index(b"from-b")


def test_delete_unregisters(federation):
    a, b = federation
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("gone").status == 200
    assert ca.request("DELETE", "/gone").status == 204
    # the name is free for the other cluster now
    assert cb.make_bucket("gone").status == 200
    assert b.bucket_dns.owned_by_us(a.bucket_dns.lookup("gone"))


def test_object_ops_via_owner_untouched(federation):
    """Local buckets never consult the DNS on the hot path result."""
    a, _b = federation
    ca = S3Client(a.endpoint)
    assert ca.make_bucket("local").status == 200
    assert ca.put_object("local", "x", b"1").status == 200
    assert ca.get_object("local", "x").body == b"1"
    assert ca.request("DELETE", "/local/x").status == 204


def test_redirect_uses_owner_scheme(federation):
    a, b = federation
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("schemed").status == 200
    # rewrite A's record to claim https: B's redirect must honor it
    rec = a.bucket_dns.lookup("schemed")[0]
    rec.scheme = "https"
    a.bucket_dns.store.put("schemed", [rec])
    r = cb.get_object("schemed", "k")
    assert r.status == 307
    assert r.headers.get("location", "").startswith("https://")


def test_concurrent_create_one_winner(federation):
    """Both servers create the same name at once, many times: each time
    exactly one 200, the other BucketAlreadyExists, and the loser's drives
    hold no such bucket (the rollback after a lost exclusive create)."""
    a, b = federation
    for r in range(8):
        name = f"race-{r}"
        answers = {}

        def create(srv, key):
            answers[key] = S3Client(srv.endpoint).make_bucket(name)

        ts = [threading.Thread(target=create, args=(s, k))
              for s, k in ((a, "a"), (b, "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        got = sorted((v.status, v.error_code if v.status != 200 else "")
                     for v in answers.values())
        assert got == [(200, ""), (409, "BucketAlreadyExists")], got
        winner = a if answers["a"].status == 200 else b
        loser = b if winner is a else a
        assert winner.bucket_dns.owned_by_us(winner.bucket_dns.lookup(name))
        assert name not in [x.name for x in
                            loser.object_layer.list_buckets()]


def test_mixed_federation_redirects_alike(mixed):
    """One port and one JAX server on one record directory: a bucket of
    either gets the same 307 from the other."""
    a, b = mixed
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("owned-by-a").status == 200
    assert cb.make_bucket("owned-by-b").status == 200
    data = np.random.default_rng(5).bytes(3 * BLOCK + 11)
    assert ca.put_object("owned-by-a", "obj", data).status == 200
    r = cb.get_object("owned-by-a", "obj")
    assert (r.status, r.headers["location"]) == (
        307, f"{a.endpoint}/owned-by-a/obj")
    r = ca.get_object("owned-by-b", "obj")
    assert (r.status, r.headers["location"]) == (
        307, f"{b.endpoint}/owned-by-b/obj")
    assert ca.get_object("owned-by-a", "obj").body == data
    # names are unique across both packages, in either direction
    assert (cb.make_bucket("owned-by-a").error_code,
            ca.make_bucket("owned-by-b").error_code) == (
        "BucketAlreadyExists", "BucketAlreadyExists")
    assert (ca.make_bucket("owned-by-a").error_code,
            cb.make_bucket("owned-by-b").error_code) == (
        "BucketAlreadyOwnedByYou", "BucketAlreadyOwnedByYou")
    # both list the union, in the same order
    lists = [c.request("GET", "/") for c in (ca, cb)]
    names = [[n for n in (b"owned-by-a", b"owned-by-b") if n in r.body]
             for r in lists]
    assert names == [[b"owned-by-a", b"owned-by-b"]] * 2
    # each record reads the same in both packages
    d = os.path.dirname(a.bucket_dns.store._path("x"))
    for bucket in ("owned-by-a", "owned-by-b"):
        with open(os.path.join(d, f"{bucket}.json")) as f:
            doc = json.load(f)
        assert [r.to_dict() for r in tdns.FileDNSStore(d).get(bucket)] == \
            [r.to_dict() for r in jdns.FileDNSStore(d).get(bucket)] == doc


def test_mixed_federation_delete_frees_the_name(mixed):
    a, b = mixed
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("handover").status == 200
    assert ca.request("DELETE", "/handover").status == 204
    assert cb.make_bucket("handover").status == 200
    r = ca.get_object("handover", "k")
    assert (r.status, r.headers["location"]) == (
        307, f"{b.endpoint}/handover/k")


def _web_rpc(srv, method, params, token=None) -> dict:
    host, port = srv.endpoint.split("//")[1].rsplit(":", 1)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/minio-tpu/webrpc", json.dumps(
            {"id": 1, "jsonrpc": "2.0", "method": method,
             "params": params}).encode(), headers)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _web_delete_frees_the_name(a, b) -> None:
    ca, cb = S3Client(a.endpoint), S3Client(b.endpoint)
    assert ca.make_bucket("webfed").status == 200
    assert cb.make_bucket("webfed").error_code == "BucketAlreadyExists"
    token = _web_rpc(a, "web.Login", {
        "username": "minioadmin", "password": "minioadmin"})["result"]["token"]
    assert "result" in _web_rpc(
        a, "web.DeleteBucket", {"bucketName": "webfed"}, token)
    # the name is free across the federation again
    assert cb.make_bucket("webfed").status == 200
    r = ca.get_object("webfed", "k")
    assert (r.status, r.headers["location"]) == (
        307, f"{b.endpoint}/webfed/k")


def test_web_delete_unregisters_dns(federation):
    """web.DeleteBucket frees the federated name, as a DELETE does."""
    _web_delete_frees_the_name(*federation)


def test_mixed_federation_web_delete_frees_the_name(mixed):
    _web_delete_frees_the_name(*mixed)
