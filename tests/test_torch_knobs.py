"""The port's knob registry (``minio_tpu_torch/config/knobs.py``).

* It equals the JAX package's registry, name by name and default by
  default, apart from ``JAX_ONLY`` (the one knob of a construct the port
  has no counterpart of, with its reason) and the three OpenID rows.
* Every MINIO_TPU_* knob the port reads is registered, and every
  registered knob is read (the lifecycle pass's read sites, module-level
  constants included).
* MTPU606 is green over the port's tree, and README.md's table of the
  port's knobs lists every row.
"""

import os

import pytest

from minio_tpu.config import knobs as jknobs
from minio_tpu_torch import analysis
from minio_tpu_torch.analysis import lifecycle
from minio_tpu_torch.analysis.astcache import CACHE
from minio_tpu_torch.config import knobs
from tests.test_torch_threads import torch_threads  # noqa: F401

OPENID = {
    "MINIO_TPU_IDENTITY_OPENID_CONFIG_URL",
    "MINIO_TPU_IDENTITY_OPENID_CLIENT_ID",
    "MINIO_TPU_IDENTITY_OPENID_CLAIM_NAME",
}


@pytest.fixture(scope="module")
def reads():
    """knob -> [(path, line)] over the port's tree, and the prefix reads."""
    exact, prefix = {}, []
    for rel, mod in CACHE.load(analysis.iter_py_files()).items():
        if rel == lifecycle.KNOBS_REL:
            continue
        for line, knob, is_pref in lifecycle._env_read_sites(mod):
            if is_pref:
                prefix.append((rel, line, knob))
            else:
                exact.setdefault(knob, []).append((rel, line))
    return exact, prefix


def test_registry_covers_every_jax_knob():
    assert set(jknobs.KNOBS) == (set(knobs.KNOBS) - OPENID) | set(knobs.JAX_ONLY)
    assert not set(knobs.JAX_ONLY) & set(knobs.KNOBS)
    assert len(jknobs.KNOBS) + len(jknobs.PREFIX_KNOBS) == 77
    assert len(knobs.KNOBS) - len(OPENID) + len(knobs.PREFIX_KNOBS) == 76


@pytest.mark.parametrize("name", sorted(set(jknobs.KNOBS) - set(knobs.JAX_ONLY)))
def test_default_equals_the_jax_registry(name):
    assert knobs.KNOBS[name].default == jknobs.KNOBS[name].default


def test_prefix_families_equal_the_jax_registry():
    assert {k: v.default for k, v in knobs.PREFIX_KNOBS.items()} == {
        k: v.default for k, v in jknobs.PREFIX_KNOBS.items()}


@pytest.mark.parametrize("name", sorted(knobs.JAX_ONLY))
def test_jax_only_knob_has_a_reason_and_no_reader(name, reads):
    kb = knobs.JAX_ONLY[name]
    assert kb.default == jknobs.KNOBS[name].default
    assert len(kb.description) > 30
    assert name not in reads[0]


def test_openid_knobs_are_read_through_module_constants(reads):
    for name in OPENID:
        assert [p for p, _ in reads[0].get(name, [])] == [
            "minio_tpu_torch/iam/openid.py"], name
    assert knobs.KNOBS["MINIO_TPU_IDENTITY_OPENID_CLAIM_NAME"].default == (
        "policy")


def test_every_knob_the_port_reads_is_registered(reads):
    exact, prefix = reads
    assert set(exact) - set(knobs.KNOBS) == set()
    for rel, line, head in prefix:
        assert any(head.startswith(p) or p.startswith(head)
                   for p in knobs.PREFIX_KNOBS), (rel, line, head)


def test_every_registered_knob_is_read(reads):
    assert set(knobs.KNOBS) - set(reads[0]) == set()


def test_mtpu606_green_over_the_port():
    sources = CACHE.load(analysis.iter_py_files())
    found = lifecycle.check_knobs(sources, repo_root=analysis.REPO_ROOT)
    assert found == [], "\n".join(f.render() for f in found)


def test_readme_table_lists_every_row():
    with open(os.path.join(analysis.REPO_ROOT, "README.md"),
              encoding="utf-8") as fh:
        table = lifecycle.readme_knob_table(fh.read())
    for name, kb in knobs.KNOBS.items():
        # the registry's row, its pipes escaped so the table keeps 3 columns
        row = (f"| `{name}` | `{kb.default or '(empty)'}` | "
               f"{kb.description.replace('|', chr(92) + '|')} |")
        assert row in table.splitlines(), row
    for name in knobs.JAX_ONLY:
        assert f"| `{name}` |" in table, name
    for prefix in knobs.PREFIX_KNOBS:
        assert f"`{prefix}*`" in table


def test_registry_module_is_data_only():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(knobs))
    calls = {getattr(n.func, "attr", getattr(n.func, "id", None))
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert calls <= {"namedtuple", "Knob"}
