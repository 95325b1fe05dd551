"""Rules of the port that hold for the whole package.

* minio_tpu_torch and chip_smoke.py import neither jax, jaxlib, msgpack
  nor minio_tpu: the port carries its own copies.
* xl.meta stays byte-compatible without msgpack: the port's MessagePack
  codec must equal msgpack.packb(doc, use_bin_type=True) and round-trip.
"""

import ast
import io
import pathlib

import msgpack
import numpy as np
import pytest

from minio_tpu.objectlayer.erasure_object import ErasureObjects as JaxObjects
from minio_tpu.storage import meta as jmeta
from minio_tpu.storage.xl import XLStorage as JaxStorage
from minio_tpu_torch.storage import meta as tmeta, mpack

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "msgpack", "minio_tpu"}


def _port_files() -> list:
    files = sorted((ROOT / "minio_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_found():
    files = _port_files()
    assert len(files) > 20
    assert all(f.exists() for f in files)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_forbidden_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN)


_INTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
    (1 << 63), (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -(1 << 31), -(1 << 31) - 1, -(1 << 63),
]


@pytest.mark.parametrize(
    "doc",
    [
        None, True, False, 1.5, -0.0, 1e300,
        *_INTS,
        "", "x" * 31, "x" * 32, "é" * 200, "y" * 256, "z" * 70000,
        b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000,
        list(range(15)), list(range(16)), list(range(70000)),
        {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
        {"a": [1, {"b": None, "c": b"\xff"}], "d": {"e": [True, 2.25]}},
    ],
    ids=lambda d: f"{type(d).__name__}-"
    + (str(len(d)) if hasattr(d, "__len__") else repr(d)),
)
def test_mpack_matches_msgpack(doc):
    want = msgpack.packb(doc, use_bin_type=True)
    assert mpack.packb(doc) == want
    assert mpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_mpack_rejects_garbage():
    with pytest.raises(mpack.PackError):
        mpack.unpackb(b"\x92\x01")  # truncated array
    with pytest.raises(mpack.PackError):
        mpack.unpackb(b"\x01\x02")  # trailing bytes
    with pytest.raises(mpack.PackError):
        mpack.packb({"k": object()})


def test_real_xl_meta_byte_identical(tmp_path):
    roots = [str(tmp_path / f"d{i}") for i in range(6)]
    ol = JaxObjects([JaxStorage(r) for r in roots], parity_blocks=2,
                    block_size=4096)
    ol.make_bucket("bkt")
    for i, size in enumerate([0, 10, 9000]):
        ol.put_object(
            "bkt", f"o{i}", io.BytesIO(np.random.default_rng(i).bytes(size)),
            size, metadata={"content-type": "text/plain", "x-amz-meta-k": "v"},
            versioned=bool(i % 2),
        )
    ol.put_object("bkt", "o1", io.BytesIO(b"again"), 5, versioned=True)
    raws = [
        (pathlib.Path(r) / "bkt" / f"o{i}" / "xl.meta").read_bytes()
        for r in roots for i in range(3)
    ]
    assert raws
    for raw in raws:
        doc = msgpack.unpackb(raw[len(jmeta.XL_MAGIC):], raw=False)
        assert mpack.packb(doc) == raw[len(jmeta.XL_MAGIC):]
        ported = tmeta.XLMeta.from_bytes(raw)
        assert ported.to_bytes() == raw
        assert ported.to_bytes() == jmeta.XLMeta.from_bytes(raw).to_bytes()
