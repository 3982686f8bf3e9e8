"""Import guard: the port and `chip_smoke.py` stand alone.

`openembedding_tpu_torch` and `chip_smoke.py` must run on a GPU machine with
no JAX: they import neither `jax` nor `openembedding_tpu` (not even its
pure-numpy modules). Checked two ways: every module of the port imports in a
fresh interpreter that then holds neither package, and a scan of the sources
finds no such import.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import openembedding_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(openembedding_tpu_torch.__file__)


def _modules():
    names = ["chip_smoke", openembedding_tpu_torch.__name__]
    for info in pkgutil.walk_packages([PKG_DIR],
                                      openembedding_tpu_torch.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"openembedding_tpu_torch.serving", "openembedding_tpu_torch.ops.gather",
            "openembedding_tpu_torch.models.ctr",
            "openembedding_tpu_torch.optimizers",
            "openembedding_tpu_torch.ops.apply",
            "openembedding_tpu_torch.ops.dedup",
            "openembedding_tpu_torch.ops.wire",
            "openembedding_tpu_torch.parallel",
            "openembedding_tpu_torch.parallel.mesh",
            "openembedding_tpu_torch.parallel.collectives",
            "openembedding_tpu_torch.parallel.multihost",
            "openembedding_tpu_torch.parallel.sharded",
            "openembedding_tpu_torch.parallel.trainer",
            "openembedding_tpu_torch.parallel.checkpoint",
            "openembedding_tpu_torch.parallel.serving",
            "openembedding_tpu_torch.config",
            "openembedding_tpu_torch.data.ingest",
            "openembedding_tpu_torch.ingest_soak",
            "openembedding_tpu_torch.utils.fs",
            "openembedding_tpu_torch.utils.guards"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') or "
        "m == 'openembedding_tpu' or m.startswith('openembedding_tpu.'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", (
        f"the port pulled in: {proc.stdout.strip()}")


def _is_forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "flax", "jaxlib", "openembedding_tpu")


def _imported_names(tree):
    """Every module an import statement, `importlib.import_module` or
    `__import__` call names (relative imports stay inside the port)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    hits = sorted(n for n in _imported_names(tree) if _is_forbidden(n))
    assert not hits, f"{os.path.relpath(path, REPO)} imports {hits}"


def test_scan_catches_planted_imports():
    planted = ("import jax.numpy as jnp\nfrom flax import linen\n"
               "from openembedding_tpu.meta import ModelMeta\n"
               "import openembedding_tpu_torch.meta\n"
               "importlib.import_module('openembedding_tpu.data')\n")
    hits = sorted(n for n in _imported_names(ast.parse(planted))
                  if _is_forbidden(n))
    assert hits == ["flax", "jax.numpy", "openembedding_tpu.data",
                    "openembedding_tpu.meta"]
