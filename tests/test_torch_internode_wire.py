"""The internode wire of the port against the JAX package's.

* Every payload shape the storage, lock and peer planes send - typed
  error envelopes, DiskInfo/VolInfo/StatInfo documents, FileInfo wire
  dicts and xl.meta version lists, name lists, walk rows, lock
  arguments, node and lock documents with floats, negative and 64-bit
  ints - packs through ``storage/mpack.py`` to the bytes
  ``msgpack.packb(..., use_bin_type=True)`` gives, and unpacks as
  ``msgpack.unpackb(raw=False)`` does (hypothesis over nested
  documents too).
* The storage plane's error envelope round-trips into the same
  exception types in either package.
* Internode JWTs minted by either package verify in the other; a wrong
  secret, an expired token and another algorithm are refused by both.
* ``DynamicTimeout`` gives the JAX package's timeout after every
  logged outcome.
"""

import base64
import json
import time

import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from minio_tpu.storage import errors as jerrors
from minio_tpu.storage import meta as jmeta
from minio_tpu.storage import rest_common as jwire
from minio_tpu.utils import dyntimeout as jdyn
from minio_tpu.utils import jwt as jjwt
from minio_tpu_torch.cluster import peer as tpeer
from minio_tpu_torch.storage import errors as terrors
from minio_tpu_torch.storage import meta as tmeta
from minio_tpu_torch.storage import mpack
from minio_tpu_torch.storage import rest_common as twire
from minio_tpu_torch.utils import dyntimeout as tdyn
from minio_tpu_torch.utils import jwt as tjwt
from tests.test_torch_threads import torch_threads  # noqa: F401


def _msgpack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _fileinfo(mod, n: int):
    return mod.FileInfo(
        volume="bkt",
        name=f"dir/obj{n}",
        version_id="" if n % 2 else f"{n:08x}-0000-4000-8000-000000000000",
        deleted=n == 3,
        data_dir=f"{n:032x}",
        size=(1 << 33) + n,
        mod_time_ns=1_700_000_000_123_456_789 + n,
        metadata={"etag": "d41d8cd98f00b204e9800998ecf8427e",
                  "content-type": "application/octet-stream",
                  "x-amz-meta-k": "v" * (40 * n)},
        parts=[mod.ObjectPartInfo(i + 1, (5 << 20) + i, (5 << 20) + 2 * i)
               for i in range(n)],
        erasure=mod.ErasureInfo(
            data_blocks=8, parity_blocks=8, block_size=1 << 20,
            index=n + 1, distribution=list(range(1, 17))),
    )


# every payload the three planes send, as (name, document)
PAYLOADS = [
    ("disk_info", {"total": 1 << 41, "free": (1 << 40) + 7, "used": 12345,
                   "root_disk": False, "endpoint": "http://h1:9000/d1",
                   "mount_path": "/d1", "disk_id": "a" * 36, "error": ""}),
    ("disk_id", "0f1e2d3c-4b5a-6978-8796-a5b4c3d2e1f0"),
    ("vols", [[".sys", 1_700_000_000_000_000_000], ["bkt", 5]]),
    ("vol", ["bkt", 1_700_000_000_000_000_000]),
    ("stat", [123_456_789_012, 1_700_000_000_000_000_001, False]),
    ("list_dir", [f"k{i}/" for i in range(40)]),
    ("walk", [f"prefix/obj{i:05d}" for i in range(300)]),
    ("walk_sorted", [["a/", True], ["a/b", False], ["c" * 200, False]]),
    ("error", {"error": "FileNotFound", "message": "bkt/obj/xl.meta"}),
    ("lock_args", {"uid": "u" * 32, "resources": ["b/o", "b/p"],
                   "source": "n1"}),
    ("grant", True),
    ("denied", False),
    ("lock_error", "signature mismatch"),
    ("server_info", {"endpoint": "http://127.0.0.1:9001",
                     "version": "minio-tpu/1", "uptime_s": 12.5,
                     "state": "online", "pid": 4242, "drives_online": 16,
                     "drives": 16}),
    ("locks", {"locks": [{"endpoint": "local:9001", "resource": "b/o",
                          "uid": "u1", "writer": True, "source": "",
                          "age_s": 0.125, "acquired_at": 1.7e9}]}),
    ("fingerprint", tpeer.cluster_fingerprint(
        ["http://127.0.0.1:{9001...9004}/d{1...4}"], "ak", "sk")),
    ("verify", {"ok": False, "mismatch": ["endpoints", "cred_hash"]}),
    ("trace", {"seq": 1 << 40, "items": [
        {"time": 1.7e9, "api": "PutObject", "status": 200, "bytes": -1,
         "duration_s": 0.0042}]}),
    ("invalidate", {"ok": True, "dropped": 3}),
    ("ints", [0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1,
              1 << 32, (1 << 64) - 1, -1, -32, -33, -128, -129, -32768,
              -32769, -(1 << 31), -(1 << 31) - 1, -(1 << 63)]),
    ("strings", ["", "x" * 31, "x" * 32, "x" * 255, "x" * 256,
                 "x" * 65536, "été \U0001f600"]),
    ("bins", [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536]),
    ("profile", {"profile": bytes(range(256)) * 40}),
    ("none", None),
    ("floats", [0.0, -0.0, 1.5, 1e300, -2.5e-300]),
    ("maps", {f"k{i}": i for i in range(17)}),
    ("arrays", list(range(16))),
]


@pytest.mark.parametrize("name,doc", PAYLOADS, ids=[p[0] for p in PAYLOADS])
def test_payload_bytes_equal_msgpack(name, doc):
    raw = twire.pack(doc)
    assert raw == _msgpack(doc) == jwire.pack(doc)
    assert twire.unpack(raw) == msgpack.unpackb(raw, raw=False)
    assert tpeer._pack(doc) == raw
    assert tpeer._unpack(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("n", range(5))
def test_fileinfo_wire_bytes_equal(n):
    tfi, jfi = _fileinfo(tmeta, n), _fileinfo(jmeta, n)
    raw = twire.pack(twire.fileinfo_to_wire(tfi))
    assert raw == jwire.pack(jwire.fileinfo_to_wire(jfi))
    back = twire.fileinfo_from_wire(twire.unpack(raw))
    assert back == tfi
    # the xl.meta version list (readxl) of all five
    assert twire.pack([twire.fileinfo_to_wire(_fileinfo(tmeta, i))
                       for i in range(n + 1)]) == \
        jwire.pack([jwire.fileinfo_to_wire(_fileinfo(jmeta, i))
                    for i in range(n + 1)])


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
         | st.floats(allow_nan=False) | st.text(max_size=300)
         | st.binary(max_size=300))
_doc = st.recursive(
    _leaf,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=40), kids, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(_doc)
def test_random_documents_bytes_equal(doc):
    raw = mpack.packb(doc)
    assert raw == _msgpack(doc)
    assert mpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("name", sorted(jwire._ERRORS))
def test_error_envelope_round_trips(name):
    jexc = getattr(jerrors, name)("bkt/obj: detail")
    texc = getattr(terrors, name)("bkt/obj: detail")
    assert twire.encode_error(texc) == jwire.encode_error(jexc)
    env = jwire.pack(dict(zip(("error", "message"), jwire.encode_error(jexc))))
    d = twire.unpack(env)
    back = twire.decode_error(d["error"], d["message"])
    assert type(back) is getattr(terrors, name) and str(back) == str(texc)
    d = jwire.unpack(twire.pack(dict(zip(("error", "message"),
                                         twire.encode_error(texc)))))
    jback = jwire.decode_error(d["error"], d["message"])
    assert type(jback) is getattr(jerrors, name)


def test_unknown_error_maps_to_faulty_disk():
    assert twire.encode_error(ValueError("x")) == ("FaultyDisk", "x")
    assert jwire.encode_error(ValueError("x")) == ("FaultyDisk", "x")
    assert type(twire.decode_error("Nope", "y")) is terrors.FaultyDisk


@pytest.mark.parametrize("minted_by", ["port", "jax"])
def test_jwt_verifies_across_packages(minted_by):
    sign = (tjwt if minted_by == "port" else jjwt).sign
    token = sign({"sub": "minio-tpu-node"}, "s3cret", 900)
    assert tjwt.verify(token, "s3cret") == jjwt.verify(token, "s3cret")
    assert tjwt.verify(token, "s3cret")["sub"] == "minio-tpu-node"
    for mod in (tjwt, jjwt):
        with pytest.raises(mod.JWTError, match="signature"):
            mod.verify(token, "other")


def test_jwt_equal_tokens_for_equal_claims():
    claims = {"sub": "n", "iat": 1_700_000_000, "exp": 4_000_000_000}
    assert tjwt.sign(claims, "k") == jjwt.sign(claims, "k")


def test_jwt_refusals_match():
    expired = tjwt.sign({"sub": "n", "iat": 1, "exp": int(time.time()) - 5},
                        "k")
    h, p, _s = tjwt.sign({"sub": "n"}, "k").split(".")
    none_hdr = base64.urlsafe_b64encode(
        json.dumps({"alg": "none"}).encode()).rstrip(b"=").decode()
    for token, why in ((expired, "expired"), (f"{none_hdr}.{p}.", "none"),
                       ("a.b", "malformed")):
        for mod in (tjwt, jjwt):
            with pytest.raises(mod.JWTError) as ei:
                mod.verify(token, "k")
            assert why in str(ei.value)


@pytest.mark.parametrize("seed", range(4))
def test_dynamic_timeout_sequences_equal(seed):
    import random

    rng = random.Random(seed)
    t = tdyn.DynamicTimeout(30.0, 1.0)
    j = jdyn.DynamicTimeout(30.0, 1.0)
    for _ in range(400):
        if rng.random() < (0.05, 0.2, 0.4, 0.6)[seed]:
            t.log_failure()
            j.log_failure()
        else:
            d = rng.random() * 3
            t.log_success(d)
            j.log_success(d)
        assert t.timeout == j.timeout


def test_dynamic_timeout_validation():
    for mod in (tdyn, jdyn):
        with pytest.raises(ValueError):
            mod.DynamicTimeout(1.0, 2.0)
        with pytest.raises(ValueError):
            mod.DynamicTimeout(1.0, 0.0)
