"""The port's server-side encryption held against minio_tpu's, on the CPU.

Both packages seal with AES-256-GCM from the ``cryptography`` package,
gated the same way (a missing package raises ``SSEError`` at use time).
The DARE packages (``[nonce(12)][ct][tag(16)]`` per 64 KiB of plaintext)
of ``EncryptReader`` must be byte-identical to minio_tpu's and open under
``cryptography``'s ``AESGCM`` directly; ``DecryptWriter`` must skip and
stop (``RangeSatisfied``) as minio_tpu's does; sealed keys bind the
``bucket/object`` AAD.

Through the object layers (EC 4+2, 1 MiB blocks, ``device="cpu"``):
with the random sources pinned (``secrets.token_bytes``, which draws the
object key, the nonce base, the sealing nonces and the KMS data key in
both packages) the part files and ``xl.meta`` of SSE-C, SSE-S3,
compressed and compressed+SSE-C objects, single-part and multipart, are
bit-identical to minio_tpu's.  Unpinned, each package reads what the
other wrote, healthy and with m disks offline, and range reads that
cross a 64 KiB package, a 1 MiB block and a part boundary agree.
"""

from __future__ import annotations

import base64
import hashlib
import importlib.util
import io
import os
import secrets
import shutil
import struct
import sys

import numpy as np
import pytest
from cryptography.exceptions import InvalidTag
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from minio_tpu.codec import backend as jbackend
from minio_tpu.codec import compress as jcompress
from minio_tpu.codec import kms as jkms
from minio_tpu.codec import sse as jsse
from minio_tpu.objectlayer import api as japi
from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.codec import backend as tbackend
from minio_tpu_torch.codec import compress as tcompress
from minio_tpu_torch.codec import kms as tkms
from minio_tpu_torch.codec import sse as tsse
from minio_tpu_torch.codec.telemetry import KERNEL_STATS
from minio_tpu_torch.objectlayer import api
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.storage.meta import XLMeta
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_threads import torch_threads  # noqa: F401

N, M = 6, 2
BLOCK = 1 << 20
CHUNK = tsse.CHUNK
MK = bytes(range(32))  # the KMS master key both packages share here
CKEY = bytes(range(100, 132))  # an SSE-C customer key
WRONG = bytes(range(1, 33))
MIN_PART = 64 << 10
# a package edge, a block edge and a ragged tail; the last part 17 B
SIZE = BLOCK + 3 * CHUNK + 1234
PART_SIZES = (BLOCK + 5, 2 * CHUNK + 9, 17)


def _pay(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8
    ).tobytes()


def _text(size: int, seed: int) -> bytes:
    """Compressible bytes (16 symbols): deflate roughly halves them."""
    return (
        np.random.default_rng(seed).integers(0, 16, size, dtype=np.uint8)
        + 48
    ).tobytes()


class _Pinned:
    """``secrets.token_bytes`` drawn from a numpy seed."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def __call__(self, n: int = 32) -> bytes:
        return self._rng.bytes(n)


@pytest.fixture()
def kms_pair():
    """The same master key installed in both packages' KMS."""
    tkms.set_kms(tkms.MasterKeyKMS("mk1", MK))
    jkms.set_kms(jkms.MasterKeyKMS("mk1", MK))
    yield
    for mod in (tkms, jkms):
        mod.set_kms(None)
        mod.reset_kms_cache()


# -- the AEAD route and the DARE packages ----------------------------------


def test_aead_route_is_cryptography():
    """One AEAD for the whole port: cryptography's AES-256-GCM, imported
    by sse.py and kms.py as the JAX package imports it."""
    assert tsse._CRYPTO_IMPORT_ERROR is None
    assert tkms._CRYPTO_IMPORT_ERROR is None
    assert tsse.AESGCM is AESGCM and tkms.AESGCM is AESGCM
    assert tsse.InvalidTag is InvalidTag


def _load_without_cryptography(monkeypatch, name: str):
    """The port's module ``codec/<name>.py`` loaded afresh while the
    cryptography package cannot be imported."""
    for mod in ("cryptography.exceptions",
                "cryptography.hazmat.primitives.ciphers.aead"):
        monkeypatch.setitem(sys.modules, mod, None)
    path = os.path.join(os.path.dirname(tsse.__file__), f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"minio_tpu_torch.codec._{name}_probe", path
    )
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_missing_cryptography_fails_at_use_time(tmp_path, monkeypatch):
    """Without the package the modules still import; sealing raises
    SSEError / KMSError, and a PUT asking for SSE stores nothing."""
    sse_probe = _load_without_cryptography(monkeypatch, "sse")
    kms_probe = _load_without_cryptography(monkeypatch, "kms")
    assert sse_probe._CRYPTO_IMPORT_ERROR is not None
    with pytest.raises(sse_probe.SSEError, match="cryptography"):
        sse_probe.EncryptReader(io.BytesIO(b"x"), CKEY, b"\0" * 8)
    with pytest.raises(kms_probe.KMSError, match="cryptography"):
        kms_probe.MasterKeyKMS("k", MK).generate_key("k", {})
    monkeypatch.setattr(tsse, "AESGCM", sse_probe.AESGCM)
    monkeypatch.setattr(tsse, "SSEError", sse_probe.SSEError)
    ol = ErasureObjects([XLStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                        parity_blocks=M, block_size=BLOCK, device="cpu")
    ol.make_bucket("bkt")
    with pytest.raises(sse_probe.SSEError):
        ol.put_object("bkt", "k", io.BytesIO(b"secret"), 6,
                      sse=tsse.SSESpec("C", CKEY))
    with pytest.raises(api.ObjectNotFound):
        ol.get_object_info("bkt", "k")


LENGTHS = [0, 1, 65_535, 65_536, 65_553, 3 * CHUNK + 5]


@pytest.mark.parametrize("length", LENGTHS)
def test_encrypt_reader_matches_reference(length):
    rng = np.random.default_rng(length)
    key, nb = rng.bytes(32), rng.bytes(8)
    plain = _pay(length, length + 1)
    got = tsse.EncryptReader(io.BytesIO(plain), key, nb).read()
    want = jsse.EncryptReader(io.BytesIO(plain), key, nb).read()
    assert got == want
    assert len(got) == tsse.stored_size(length) == jsse.stored_size(length)
    # each package is [nonce(12)][ct][tag(16)], nonce = base || BE counter,
    # and opens under cryptography's AESGCM directly
    aead, opened, pos, seq = AESGCM(key), b"", 0, 0
    while pos < len(got):
        pkg = got[pos:pos + CHUNK + tsse.OVERHEAD]
        assert pkg[:12] == nb + struct.pack(">I", seq)
        opened += aead.decrypt(pkg[:12], pkg[12:], None)
        pos += len(pkg)
        seq += 1
    assert opened == plain


def test_encrypt_reader_small_reads_match():
    """Pulled in odd-sized reads (as the codec pulls blocks) the stream
    is the same as one read."""
    key, nb = CKEY, b"\x01" * 8
    plain = _pay(2 * CHUNK + 77, 3)
    whole = tsse.EncryptReader(io.BytesIO(plain), key, nb).read()
    r = tsse.EncryptReader(io.BytesIO(plain), key, nb)
    parts = []
    while True:
        got = r.read(10_007)
        if not got:
            break
        parts.append(got)
    assert b"".join(parts) == whole


def _decrypt(mod, stored, key, nb, offset, length, feed=40_000):
    out = io.BytesIO()
    w = mod.DecryptWriter(out, key, nb, offset, length)
    stopped = False
    try:
        for i in range(0, len(stored), feed):
            w.write(stored[i:i + feed])
    except mod.RangeSatisfied:
        stopped = True
    w.finish()
    return out.getvalue(), stopped


RANGES = [
    (0, -1), (0, 1), (CHUNK - 100, 200), (CHUNK, CHUNK),
    (2 * CHUNK - 1, 3), (3 * CHUNK, 5),
]


@pytest.mark.parametrize("offset,length", RANGES)
def test_decrypt_writer_range_matches_reference(offset, length):
    key, nb = CKEY, b"\x02" * 8
    plain = _pay(3 * CHUNK + 5, 4)
    stored = jsse.EncryptReader(io.BytesIO(plain), key, nb).read()
    got = _decrypt(tsse, stored, key, nb, offset, length)
    want = _decrypt(jsse, stored, key, nb, offset, length)
    assert got == want
    end = len(plain) if length < 0 else offset + length
    assert got[0] == plain[offset:end]


def test_decrypt_writer_rejects_tampering():
    key, nb = CKEY, b"\x03" * 8
    stored = bytearray(tsse.EncryptReader(
        io.BytesIO(_pay(2 * CHUNK + 3, 5)), key, nb).read())
    full = CHUNK + tsse.OVERHEAD
    tag = bytearray(stored)
    tag[full - 1] ^= 1  # the first package's tag
    swapped = stored[full:2 * full] + stored[:full] + stored[2 * full:]
    for bad, msg in ((tag, "verification"), (swapped, "sequence"),
                     (stored[:-20], "truncated")):
        for mod in (tsse, jsse):
            with pytest.raises(mod.SSEError, match=msg):
                _decrypt(mod, bytes(bad), key, nb, 0, -1)
    with pytest.raises(tsse.SSEError, match="verification"):
        _decrypt(tsse, bytes(stored), WRONG, nb, 0, -1)


def test_seal_key_binds_the_object_path():
    oek = _pay(32, 6)
    for seal, unseal in ((tsse, jsse), (jsse, tsse)):
        sealed = seal.seal_key(CKEY, oek, "bkt/obj")
        assert len(sealed) == 12 + 32 + 16
        assert unseal.unseal_key(CKEY, sealed, "bkt/obj") == oek
        with pytest.raises(unseal.SSEError, match="does not match"):
            unseal.unseal_key(CKEY, sealed, "bkt/other")
        with pytest.raises(unseal.SSEError):
            unseal.unseal_key(WRONG, sealed, "bkt/obj")


def test_helpers_match_reference(monkeypatch):
    base = b"\x07" * 8
    for pn in (1, 2, 3, 10_000):
        assert tsse.part_nonce_base(base, pn) == jsse.part_nonce_base(base, pn)
    assert tsse.part_nonce_base(base, 1) == base
    assert tsse.part_nonce_base(base, 2) == hashlib.sha256(
        base + struct.pack(">I", 2)).digest()[:8]
    assert tsse.key_md5_b64(CKEY) == base64.b64encode(
        hashlib.md5(CKEY).digest()).decode()
    for n in (0, 1, CHUNK, CHUNK + 1, 10 * CHUNK):
        assert tsse.stored_size(n) == jsse.stored_size(n)
    assert tsse.stored_size(CHUNK + 1) == CHUNK + 1 + 2 * 28
    monkeypatch.setattr(secrets, "token_bytes", _Pinned(1))
    a = (tsse.new_object_key(), tsse.new_nonce_base())
    monkeypatch.setattr(secrets, "token_bytes", _Pinned(1))
    assert a == (jsse.new_object_key(), jsse.new_nonce_base())
    assert (len(a[0]), len(a[1])) == (32, 8)
    monkeypatch.setenv("MINIO_TPU_KMS_MASTER_KEY", "id:" + MK.hex())
    assert tsse.master_key() == jsse.master_key() == ("id", MK)
    for bad in ("nocolon", "id:zz", "id:" + MK.hex()[:-2]):
        monkeypatch.setenv("MINIO_TPU_KMS_MASTER_KEY", bad)
        with pytest.raises(tsse.SSEError):
            tsse.master_key()


# -- the object layers -------------------------------------------------------


class Pair:
    """The two object layers over their own disks."""

    def __init__(self, base, tag=""):
        self.troots = [str(base / f"port{tag}{i}") for i in range(N)]
        self.jroots = [str(base / f"jax{tag}{i}") for i in range(N)]
        self.port = self.open_port(self.troots)
        self.ref = self.open_ref(self.jroots)
        for ol in (self.port, self.ref):
            ol.make_bucket("bkt")

    @staticmethod
    def open_port(roots):
        ol = ErasureObjects(
            [None if r is None else XLStorage(r) for r in roots],
            parity_blocks=M, block_size=BLOCK, device="cpu",
        )
        ol.min_part_size = MIN_PART
        return ol

    @staticmethod
    def open_ref(roots):
        return JaxObjects(
            [None if r is None else JaxStorage(r) for r in roots],
            parity_blocks=M, block_size=BLOCK, min_part_size=MIN_PART,
        )


def _spec(mod, case: str):
    if "ssec" in case:
        return mod.SSESpec("C", CKEY)
    if "sses3" in case:
        return mod.SSESpec("S3")
    return None


def _read_spec(mod, case: str):
    return mod.SSESpec("C", CKEY) if "ssec" in case else None


def _data(case: str, size: int, seed: int) -> bytes:
    return _text(size, seed) if "compressed" in case else _pay(size, seed)


def _put(ol, sse_mod, case, name, data):
    return ol.put_object(
        "bkt", name, io.BytesIO(data), len(data),
        compress="compressed" in case, sse=_spec(sse_mod, case),
    )


def _put_mp(ol, api_mod, sse_mod, case, name, parts, numbers=None):
    spec = _spec(sse_mod, case)
    uid = ol.new_multipart_upload("bkt", name, None, spec)
    numbers = numbers or list(range(1, len(parts) + 1))
    done = [
        ol.put_object_part("bkt", name, uid, n, io.BytesIO(p), len(p),
                           _read_spec(sse_mod, case))
        for n, p in zip(numbers, parts)
    ]
    return ol.complete_multipart_upload(
        "bkt", name, uid,
        [api_mod.CompletePart(p.part_number, p.etag) for p in done],
    )


def _get(ol, sse_mod, case, name, offset=0, length=-1) -> bytes:
    buf = io.BytesIO()
    ol.get_object("bkt", name, buf, offset, length, "",
                  _read_spec(sse_mod, case))
    return buf.getvalue()


def _files(root: str, name: str) -> dict:
    """Every part file of the object's data dir, by file name."""
    fi = XLStorage(root).read_version("bkt", name)
    d = f"{root}/bkt/{name}/{fi.data_dir}"
    if not os.path.isdir(d):
        return {}
    return {f: open(f"{d}/{f}", "rb").read() for f in sorted(os.listdir(d))}


def _meta_doc(root: str, name: str) -> list:
    raw = open(f"{root}/bkt/{name}/xl.meta", "rb").read()
    out = []
    for v in XLMeta.from_bytes(raw).versions:
        d = v.to_dict()
        for volatile in ("mod_time_ns", "data_dir", "version_id"):
            d.pop(volatile)
        out.append(d)
    return out


CASES = ["ssec", "sses3", "compressed", "compressed_ssec"]
LAYOUTS = ["single", "multipart"]


@pytest.fixture()
def pair(tmp_path, monkeypatch, kms_pair):
    monkeypatch.setenv("MINIO_MESH", "0")
    jbackend.reset_backend()
    tbackend.reset_backend()
    yield Pair(tmp_path)
    jbackend.reset_backend()
    tbackend.reset_backend()


def _store(p: Pair, case: str, layout: str, name: str, seed: int,
           monkeypatch=None, pin: "int | None" = None):
    """Store one object of ``case`` in both packages, the random sources
    pinned to ``pin`` (reset before each package) when it is given."""
    if layout == "single":
        data = _data(case, SIZE, seed)
        runs = ((p.port, api, tsse, lambda ol, a, s: _put(ol, s, case, name, data)),
                (p.ref, japi, jsse, lambda ol, a, s: _put(ol, s, case, name, data)))
    else:
        parts = [_data(case, n, seed + i) for i, n in enumerate(PART_SIZES)]
        data = b"".join(parts)
        runs = ((p.port, api, tsse,
                 lambda ol, a, s: _put_mp(ol, a, s, case, name, parts)),
                (p.ref, japi, jsse,
                 lambda ol, a, s: _put_mp(ol, a, s, case, name, parts)))
        if "compressed" in case:
            monkeypatch.setenv("MINIO_TPU_COMPRESS", "on")
            name_ok = tcompress.should_compress(name, "", -1)
            assert name_ok == jcompress.should_compress(name, "", -1) is True
    infos = []
    for ol, api_mod, sse_mod, run in runs:
        if pin is not None:
            monkeypatch.setattr(secrets, "token_bytes", _Pinned(pin))
        infos.append(run(ol, api_mod, sse_mod))
    if monkeypatch is not None:
        monkeypatch.delenv("MINIO_TPU_COMPRESS", raising=False)
    return data, infos


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_pinned_objects_bit_identical(pair, monkeypatch, case, layout):
    data, (tinfo, jinfo) = _store(pair, case, layout, f"obj.{case}", 11,
                                  monkeypatch, pin=7)
    assert tinfo.etag == jinfo.etag and tinfo.size == jinfo.size == len(data)
    for t, j in zip(pair.troots, pair.jroots):
        assert _files(t, f"obj.{case}") == _files(j, f"obj.{case}")
        assert _meta_doc(t, f"obj.{case}") == _meta_doc(j, f"obj.{case}")
    meta = _meta_doc(pair.troots[0], f"obj.{case}")[0]["metadata"]
    if "compressed" in case:
        assert meta["x-internal-compression"] == "deflate/v1"
    if "ssec" in case:
        assert meta["x-internal-sse"] == "C"
        assert meta["x-internal-sse-key-md5"] == tsse.key_md5_b64(CKEY)
    if "sses3" in case:
        assert meta["x-internal-sse"] == "S3"
        assert meta["x-internal-sse-kms-id"] == "mk1"
        assert meta["x-internal-sse-kms-sealed-dk"]
    assert meta["x-internal-actual-size"] == str(len(data))
    parts = "1,2,3" if layout == "multipart" else "1"
    assert meta.get("x-internal-sse-parts") == (
        parts if "compressed" != case else None)
    assert _get(pair.port, tsse, case, f"obj.{case}") == data


def test_stored_size_of_an_encrypted_object(pair):
    data, (tinfo, _j) = _store(pair, "ssec", "single", "sz", 3)
    fi = XLStorage(pair.troots[0]).read_version("bkt", "sz")
    assert fi.size == tsse.stored_size(len(data))
    assert fi.size - len(data) == 28 * -(-len(data) // CHUNK)
    assert tinfo.size == len(data)
    assert pair.port.get_object_info("bkt", "sz").size == len(data)
    # ciphertext at rest: no part file carries a run of the plaintext
    probe = data[500:600]
    for root in pair.troots:
        for blob in _files(root, "sz").values():
            assert probe not in blob


@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_each_package_reads_the_other(pair, monkeypatch, case, layout,
                                      degraded):
    name = f"x.{case}"
    data, _ = _store(pair, case, layout, name, 21, monkeypatch)
    for roots, opener, sse_mod in ((pair.jroots, Pair.open_port, tsse),
                                   (pair.troots, Pair.open_ref, jsse)):
        dist = XLStorage(roots[0]).read_version("bkt", name).erasure.distribution
        dead = {d for d in range(N) if degraded and dist[d] in (1, 5)}
        ol = opener([None if d in dead else r for d, r in enumerate(roots)])
        KERNEL_STATS.reset()
        assert _get(ol, sse_mod, case, name) == data
        assert ol.get_object_info("bkt", name).size == len(data)
        if degraded and sse_mod is tsse:
            passes = KERNEL_STATS.snapshot()["device_passes"]
            assert passes.get("reconstruct_words_batch", 0) >= 1


MP_EDGE = PART_SIZES[0]
GET_RANGES = [
    ("package", CHUNK - 100, 200),
    ("block", BLOCK - 1000, 3000),
    ("tail17", SIZE - 17, 17),
    ("part", MP_EDGE - 50, 100),
    ("parts_all", MP_EDGE - 3, PART_SIZES[1] + 4),
    ("first_byte", 0, 1),
]


@pytest.mark.parametrize("label,offset,length", GET_RANGES,
                         ids=[r[0] for r in GET_RANGES])
@pytest.mark.parametrize("case", CASES)
def test_range_reads_match_reference(pair, monkeypatch, case, label, offset,
                                     length):
    layout = "multipart" if label.startswith("part") else "single"
    name = f"r.{case}"
    data, _ = _store(pair, case, layout, name, 31, monkeypatch)
    if label == "tail17" and layout == "single":
        offset = len(data) - 17
    got = _get(pair.port, tsse, case, name, offset, length)
    assert got == _get(pair.ref, jsse, case, name, offset, length)
    assert got == data[offset:offset + length]


def test_ssec_key_errors_match_reference(pair):
    _store(pair, "ssec", "single", "k", 41)
    for ol, mod in ((pair.port, tsse), (pair.ref, jsse)):
        errs = []
        for spec in (None, mod.SSESpec("C", WRONG)):
            with pytest.raises(mod.SSEError) as e:
                ol.get_object("bkt", "k", io.BytesIO(), sse=spec)
            errs.append(str(e.value))
        with pytest.raises(mod.SSEError, match="32 bytes"):
            ol.put_object("bkt", "short", io.BytesIO(b"x"), 1,
                          sse=mod.SSESpec("C", b"short"))
        if mod is tsse:
            port_errs = errs
    assert port_errs == errs
    assert "must be provided" in errs[0] and "does not match" in errs[1]


def test_sse_s3_needs_a_kms(pair):
    for mod in (tkms, jkms):
        mod.set_kms(None)
    _store(pair, "ssec", "single", "c", 43)  # SSE-C needs no KMS
    for ol, mod in ((pair.port, tsse), (pair.ref, jsse)):
        with pytest.raises(mod.SSEError, match="KMS"):
            ol.put_object("bkt", "s3", io.BytesIO(b"data"), 4,
                          sse=mod.SSESpec("S3"))
    with pytest.raises(api.ObjectNotFound):
        pair.port.get_object_info("bkt", "s3")


def test_sse_s3_under_another_master_key_fails(pair):
    data, _ = _store(pair, "sses3", "single", "s3", 45)
    tkms.set_kms(tkms.MasterKeyKMS("mk1", WRONG))
    with pytest.raises(tsse.SSEError):
        pair.port.get_object("bkt", "s3", io.BytesIO())
    tkms.set_kms(tkms.MasterKeyKMS("mk1", MK))
    assert _get(pair.port, tsse, "sses3", "s3") == data


def test_heal_of_an_encrypted_object(pair):
    data, _ = _store(pair, "compressed_ssec", "single", "h", 47)
    before = {r: _files(r, "h") for r in pair.troots}
    victim = pair.troots[2]
    shard = XLStorage(victim).read_version("bkt", "h").erasure.index - 1
    shutil.rmtree(f"{victim}/bkt/h")
    jvictim = pair.jroots[2]
    shutil.rmtree(f"{jvictim}/bkt/h")
    assert pair.port.heal_object("bkt", "h")["healed"] == [shard]
    assert pair.ref.heal_object("bkt", "h")["healed"] == [shard]
    assert _files(victim, "h") == before[victim]
    assert _get(pair.port, tsse, "compressed_ssec", "h") == data


def test_copy_ssec_to_sses3(pair):
    data, _ = _store(pair, "ssec", "single", "src", 49)
    for ol, mod in ((pair.port, tsse), (pair.ref, jsse)):
        info = ol.copy_object("bkt", "src", "bkt", "dst",
                              sse_src=mod.SSESpec("C", CKEY),
                              sse=mod.SSESpec("S3"))
        assert info.size == len(data)
        meta = ol.get_object_info("bkt", "dst").user_defined
        assert meta[mod.META_SSE] == "S3"
        assert mod.META_SSE_KEY_MD5 not in meta
        # without the source key the copy's reader fails and the pipe
        # hands the failure to the writer, as in the JAX package
        with pytest.raises(OSError, match="the key must be provided"):
            ol.copy_object("bkt", "src", "bkt", "dst2")
        with pytest.raises((api.ObjectNotFound, japi.ObjectNotFound)):
            ol.get_object_info("bkt", "dst2")
    # each package reads the other's copy
    assert _get(Pair.open_port(pair.jroots), tsse, "sses3", "dst") == data
    assert _get(Pair.open_ref(pair.troots), jsse, "sses3", "dst") == data
    # a plain self-copy of an SSE-C object with REPLACE-style metadata
    pair.port.copy_object("bkt", "src", "bkt", "src", {"x-amz-meta-a": "b"},
                          sse_src=tsse.SSESpec("C", CKEY))
    info = pair.port.get_object_info("bkt", "src")
    assert tsse.META_SSE not in info.user_defined
    assert _get(pair.port, tsse, "plain", "src") == data


def test_multipart_skipped_numbers_and_list_parts(pair, monkeypatch):
    """Parts uploaded as 2 and 5 keep their nonces past Complete's
    renumbering (x-internal-sse-parts); ListParts shows actual sizes."""
    parts = [_pay(n, 50 + i) for i, n in enumerate(PART_SIZES[:2])]
    for ol, api_mod, mod in ((pair.port, api, tsse), (pair.ref, japi, jsse)):
        uid = ol.new_multipart_upload("bkt", "skip", None,
                                      mod.SSESpec("C", CKEY))
        done = [ol.put_object_part("bkt", "skip", uid, n, io.BytesIO(p),
                                   len(p), mod.SSESpec("C", CKEY))
                for n, p in zip((2, 5), parts)]
        listed = ol.list_object_parts("bkt", "skip", uid)
        assert [(p.part_number, p.size) for p in listed] == [
            (2, len(parts[0])), (5, len(parts[1]))]
        ol.complete_multipart_upload(
            "bkt", "skip", uid,
            [api_mod.CompletePart(p.part_number, p.etag) for p in done])
        meta = ol.get_object_info("bkt", "skip").user_defined
        assert meta[mod.META_SSE_PARTS] == "2,5"
        assert _get(ol, mod, "ssec", "skip") == b"".join(parts)
        whole = b"".join(parts)
        edge = len(parts[0])
        assert _get(ol, mod, "ssec", "skip", edge - 9, 20) == whole[edge - 9:edge + 11]


def test_multipart_key_mismatches(pair):
    """A customer key on a part of an unencrypted or SSE-S3 upload, and a
    missing or wrong key on an SSE-C upload's part, raise SSEError."""
    for ol, mod in ((pair.port, tsse), (pair.ref, jsse)):
        plain = ol.new_multipart_upload("bkt", "p")
        s3 = ol.new_multipart_upload("bkt", "p3", None, mod.SSESpec("S3"))
        c = ol.new_multipart_upload("bkt", "pc", None, mod.SSESpec("C", CKEY))
        for name, uid, spec, msg in (
            ("p", plain, mod.SSESpec("C", CKEY), "customer-key"),
            ("p3", s3, mod.SSESpec("C", CKEY), "customer-key"),
            ("pc", c, None, "must be provided"),
            ("pc", c, mod.SSESpec("C", WRONG), "does not match"),
        ):
            with pytest.raises(mod.SSEError, match=msg):
                ol.put_object_part("bkt", name, uid, 1, io.BytesIO(b"x"), 1,
                                   spec)
        # the SSE-S3 upload takes parts without a key
        ol.put_object_part("bkt", "p3", s3, 1, io.BytesIO(b"x"), 1)
