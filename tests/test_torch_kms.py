"""The port's KMS held against minio_tpu's, on the CPU.

``MasterKeyKMS`` data keys sealed by one package unseal in the other
under the same master key and context (the context is the AEAD's AAD, so
a key lifted onto another object fails); ``KESClientKMS`` speaks the KES
``/v1/key`` API to an in-process fake key server this module writes
(plain HTTP and HTTPS, ``MINIO_TPU_KMS_KES_INSECURE``); ``get_kms``
resolves ``MINIO_TPU_KMS_MASTER_KEY`` and ``MINIO_TPU_KMS_KES_*`` as
minio_tpu's does; the admin route ``kms/key/status`` answers as the JAX
package's server answers, and an SSE-S3 object sealed through KES reads
back.
"""

from __future__ import annotations

import base64
import http.server
import io
import json
import ssl
import subprocess
import threading

import numpy as np
import pytest

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec import kms as jkms
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import kms as tkms
from minio_tpu_torch.codec import sse as tsse
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.xl import XLStorage
from tests.s3client import S3Client
from tests.test_torch_threads import torch_threads  # noqa: F401

MK = bytes(range(32))
KES_MK = np.random.default_rng(8).bytes(32)


@pytest.fixture(autouse=True)
def _no_kms_left():
    """Every test starts and ends with both packages' KMS unset."""
    for mod in (tkms, jkms):
        mod.set_kms(None)
        mod.reset_kms_cache()
    yield
    for mod in (tkms, jkms):
        mod.set_kms(None)
        mod.reset_kms_cache()


def test_context_aad_matches_reference():
    for ctx in ({}, None, {"path": "b/o"}, {"z": "1", "a": "2"}):
        assert tkms.context_aad(ctx) == jkms.context_aad(ctx)
    assert tkms.context_aad({"z": "1", "a": "2"}) == b'{"a":"2","z":"1"}'


def test_master_key_data_keys_cross_unseal():
    port = tkms.MasterKeyKMS("mk1", MK)
    ref = jkms.MasterKeyKMS("mk1", MK)
    for seal, unseal, err in ((port, ref, jkms.KMSError),
                              (ref, port, tkms.KMSError)):
        dk, sealed = seal.generate_key("mk1", {"path": "b/o"})
        assert len(dk) == 32 and len(sealed) == 12 + 32 + 16
        assert unseal.unseal_key("mk1", sealed, {"path": "b/o"}) == dk
        with pytest.raises(err):
            unseal.unseal_key("mk1", sealed, {"path": "b/other"})
        with pytest.raises(err):
            unseal.unseal_key("nope", sealed, {"path": "b/o"})
    with pytest.raises(tkms.KMSError):
        port.generate_key("nope", {})
    with pytest.raises(tkms.KMSError, match="cannot create"):
        port.create_key("k2")
    with pytest.raises(tkms.KMSError, match="32 bytes"):
        tkms.MasterKeyKMS("x", b"short")
    assert port.info() == ref.info() == {
        "endpoint": "local", "name": "mk1", "auth": "master-key"}
    assert port.default_key_id() == "mk1"


class FakeKES(threading.Thread):
    """An in-process key server speaking the KES ``/v1/key`` API
    (generate, decrypt, create) with a bearer token, backed by the
    port's own MasterKeyKMS; optionally over TLS."""

    def __init__(self, token: str = "tok", cert=None):
        super().__init__(daemon=True)
        self.token = token
        self.calls: list = []
        backing = tkms.MasterKeyKMS("kes-key", KES_MK)
        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, status: int, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"{}")
                fake.calls.append(self.path)
                if fake.token and self.headers.get(
                        "Authorization") != f"Bearer {fake.token}":
                    return self._reply(401, b"not authorized")
                _v1, _key, op, name = self.path.strip("/").split("/")
                ctx = {"kes": base64.b64decode(doc.get("context", "")).decode()}
                if name == "nobody":  # a well-formed answer without keys
                    return self._reply(200, b'{"unexpected": 1}')
                try:
                    if op == "generate":
                        dk, sealed = backing.generate_key("kes-key", ctx)
                        out = {"plaintext": base64.b64encode(dk).decode(),
                               "ciphertext": base64.b64encode(sealed).decode()}
                    elif op == "decrypt":
                        dk = backing.unseal_key(
                            "kes-key", base64.b64decode(doc["ciphertext"]), ctx)
                        out = {"plaintext": base64.b64encode(dk).decode()}
                    elif op == "create":
                        out = {}
                    elif op == "garbled":
                        return self._reply(200, b"{not json")
                    else:
                        return self._reply(404, b"no such operation")
                except tkms.KMSError as e:
                    return self._reply(400, str(e).encode())
                self._reply(200, json.dumps(out).encode())

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        if cert is not None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*cert)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True)
        self.scheme = "https" if cert is not None else "http"
        self.port = self.httpd.server_port

    @property
    def endpoint(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}"

    def run(self):
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def self_signed(tmp_path) -> "tuple[str, str]":
    """(cert, key) PEM files for CN=127.0.0.1 from the openssl CLI."""
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True,
    )
    return cert, key


@pytest.fixture()
def kes():
    srv = FakeKES()
    srv.start()
    yield srv
    srv.stop()


def test_kes_round_trip_as_reference(kes):
    port = tkms.KESClientKMS(kes.endpoint, "kes-key", kes.token)
    ref = jkms.KESClientKMS(kes.endpoint, "kes-key", kes.token)
    for a, b in ((port, ref), (ref, port)):
        dk, sealed = a.generate_key("kes-key", {"path": "b/o"})
        assert b.unseal_key("kes-key", sealed, {"path": "b/o"}) == dk
    with pytest.raises(tkms.KMSError, match="HTTP 400"):
        port.unseal_key("kes-key", sealed, {"path": "b/x"})
    port.create_key("fresh")
    assert kes.calls[-1] == "/v1/key/create/fresh"
    assert port.info() == ref.info() == {
        "endpoint": kes.endpoint, "name": "kes-key", "auth": "token"}


def test_kes_errors_as_reference(kes):
    for mod in (tkms, jkms):
        bad = mod.KESClientKMS(kes.endpoint, "kes-key", "wrong")
        with pytest.raises(mod.KMSError, match="401"):
            bad.generate_key("kes-key", {})
        client = mod.KESClientKMS(kes.endpoint, "kes-key", kes.token)
        with pytest.raises(mod.KMSError, match="bad response body"):
            client.generate_key("nobody", {})
        with pytest.raises(mod.KMSError, match="malformed JSON"):
            client._call("/v1/key/garbled/x", {})
        with pytest.raises(mod.KMSError, match="bad KES endpoint"):
            mod.KESClientKMS("ftp://x", "k")
    dead = tkms.KESClientKMS("http://127.0.0.1:9", "kes-key", "", 0.5)
    with pytest.raises(tkms.KMSError, match="unreachable"):
        dead.generate_key("kes-key", {})


def test_kes_over_tls_honours_insecure(tmp_path, monkeypatch):
    srv = FakeKES(cert=self_signed(tmp_path))
    srv.start()
    try:
        strict = tkms.KESClientKMS(srv.endpoint, "kes-key", srv.token)
        with pytest.raises(tkms.KMSError, match="unreachable"):
            strict.generate_key("kes-key", {})
        monkeypatch.setenv("MINIO_TPU_KMS_KES_INSECURE", "1")
        loose = tkms.KESClientKMS(srv.endpoint, "kes-key", srv.token)
        dk, sealed = loose.generate_key("kes-key", {"path": "b/o"})
        assert loose.unseal_key("kes-key", sealed, {"path": "b/o"}) == dk
    finally:
        srv.stop()


ENVS = {
    "none": {},
    "master": {"MINIO_TPU_KMS_MASTER_KEY": "envkey:" + MK.hex()},
    "master_no_colon": {"MINIO_TPU_KMS_MASTER_KEY": MK.hex()},
    "master_not_hex": {"MINIO_TPU_KMS_MASTER_KEY": "id:zz"},
    "master_short": {"MINIO_TPU_KMS_MASTER_KEY": "id:abcd"},
    "kes": {"MINIO_TPU_KMS_KES_ENDPOINT": "http://127.0.0.1:1",
            "MINIO_TPU_KMS_KES_KEY_ID": "k1",
            "MINIO_TPU_KMS_KES_TOKEN": "t",
            "MINIO_TPU_KMS_MASTER_KEY": "ignored:" + MK.hex()},
    "kes_default_id": {"MINIO_TPU_KMS_KES_ENDPOINT": "http://127.0.0.1:1"},
}


def _resolve(mod):
    try:
        kms = mod.get_kms()
    except (mod.KMSError, ValueError) as e:
        return ("error", type(e).__name__)
    if kms is None:
        return None
    return (type(kms).__name__, kms.default_key_id(), kms.info())


@pytest.mark.parametrize("name", list(ENVS))
def test_get_kms_resolves_env_as_reference(monkeypatch, name):
    for var in ("MINIO_TPU_KMS_MASTER_KEY", "MINIO_TPU_KMS_KES_ENDPOINT",
                "MINIO_TPU_KMS_KES_KEY_ID", "MINIO_TPU_KMS_KES_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    for var, val in ENVS[name].items():
        monkeypatch.setenv(var, val)
    got = _resolve(tkms)
    assert got == _resolve(jkms)
    # cached until reset; set_kms overrides, None re-enables the env
    assert _resolve(tkms) == got
    tkms.set_kms(tkms.MasterKeyKMS("explicit", MK))
    assert tkms.get_kms().default_key_id() == "explicit"
    tkms.set_kms(None)
    assert _resolve(tkms) == got
    assert tsse.sse_s3_available() == (got is not None and got[0] != "error")


def _server(tmp_path, tls=False):
    from minio_tpu_torch.server.http import S3Server

    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(6)],
                        parity_blocks=2, block_size=4096, device="cpu")
    return S3Server(ol, address="127.0.0.1:0").start()


def _jax_server(tmp_path):
    from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
    from minio_tpu.server.http import S3Server as JaxServer
    from minio_tpu.storage.xl import XLStorage as JaxStorage

    ol = JaxObjects([JaxStorage(str(tmp_path / f"j{i}")) for i in range(6)],
                    parity_blocks=2, block_size=4096)
    return JaxServer(ol, address="127.0.0.1:0").start()


STATUS_PATH = "/minio-tpu/admin/v1/kms/key/status"


@pytest.mark.parametrize("setup", ["none", "master", "kes", "kes_down",
                                   "key_id"])
def test_admin_kms_key_status_as_reference(tmp_path, monkeypatch, kes, setup):
    """The route runs one generate->unseal round trip and reports both
    verdicts; without a KMS it is InvalidArgument."""
    monkeypatch.setenv("MINIO_TPU_SERVER", "threaded")
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    query = {"key-id": "other"} if setup == "key_id" else None
    if setup in ("master", "key_id"):
        tkms.set_kms(tkms.MasterKeyKMS("mk1", MK))
        jkms.set_kms(jkms.MasterKeyKMS("mk1", MK))
    elif setup in ("kes", "kes_down"):
        ep = kes.endpoint if setup == "kes" else "http://127.0.0.1:9"
        tkms.set_kms(tkms.KESClientKMS(ep, "kes-key", kes.token, 0.5))
        jkms.set_kms(jkms.KESClientKMS(ep, "kes-key", kes.token, 0.5))
    got = {}
    for kind, start in (("port", _server), ("jax", _jax_server)):
        srv = start(tmp_path)
        try:
            r = S3Client(srv.endpoint).request("GET", STATUS_PATH, query=query)
            got[kind] = (r.status, r.error_code if r.status != 200
                         else json.loads(r.body))
        finally:
            srv.shutdown()
    assert got["port"] == got["jax"]
    if setup == "master":
        assert got["port"][1]["encryption"] == "success"
        assert got["port"][1]["decryption"] == "success"
    if setup == "none":
        assert got["port"] == (400, "InvalidArgument")
    if setup == "kes_down":
        assert got["port"][1]["encryption"].startswith("failed:")


def test_sse_s3_object_through_kes(tmp_path, kes):
    """SSE-S3 with KES as the KMS: the server never holds the data key
    at rest, only KES's sealed form, and the object reads back."""
    tkms.set_kms(tkms.KESClientKMS(kes.endpoint, "kes-key", kes.token))
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(6)],
                        parity_blocks=2, block_size=4096, device="cpu")
    ol.make_bucket("bkt")
    data = np.random.default_rng(4).bytes(20_000)
    ol.put_object("bkt", "enc", io.BytesIO(data), len(data),
                  sse=tsse.SSESpec("S3"))
    meta = ol.get_object_info("bkt", "enc").user_defined
    assert meta[tsse.META_SSE] == "S3"
    assert meta[tsse.META_SSE_KMS_ID] == "kes-key"
    assert "/v1/key/generate/kes-key" in kes.calls
    buf = io.BytesIO()
    ol.get_object("bkt", "enc", buf)
    assert buf.getvalue() == data
    assert kes.calls[-1] == "/v1/key/decrypt/kes-key"
    # a KES that cannot open the data key fails the read with SSEError
    kes.token = "rotated"
    with pytest.raises(tsse.SSEError, match="401"):
        ol.get_object("bkt", "enc", io.BytesIO())
