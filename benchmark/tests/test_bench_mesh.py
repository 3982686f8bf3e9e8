"""The harness's path for a cell on several cards, on the CPU: four gloo
ranks at a tiny size, over the configuration `deepfm_d9_hashed_1tb` (no
cell uses it yet: its limits wait for a calibration on the card, so the
test gives it the one-card hashed cell's). The sound program is correct;
with the exchange of the dense gradients left out underneath (planted in
every rank's interpreter through a `sitecustomize` module), it is not."""

import json
import os

import pytest

from benchmark import run, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 91

PLANT = """
from openembedding_tpu_torch.parallel import trainer as _t
_t.MeshTrainer.reduce_dense_grads = lambda self, grads: grads
"""


CELL = "deepfm_d9_hashed.mesh4"
CONFIG = "deepfm_d9_hashed_1tb"


@pytest.fixture
def mesh_root(tiny):
    """The tiny copy with a four-card cell over `CONFIG`."""
    path = os.path.join(tiny, "benchmark", "configs", f"{CONFIG}.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(tiny, "benchmark", "configs",
                           "deepfm_d9_hashed.json")) as f:
        cfg["limits"] = json.load(f)["limits"]
    cfg.update(hidden=[16, 16], capacity=1 << 12)
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench = spec.load(tiny)
    bench["configs"].append({"name": CONFIG, "source": "x",
                             "file": f"benchmark/configs/{CONFIG}.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": "criteo_zipf", "chips": 4,
                               "why": "x"})
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tiny


def _run(root):
    return run.run(spec.load(root), CELL, SEED, 0.2, False, device="cpu",
                   root=root, bench_dir=f"{root}/benchmark")


def test_mesh_sound_program_is_correct(mesh_root):
    out = _run(mesh_root)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4


def test_mesh_without_the_exchange_is_not_correct(mesh_root, tmp_path,
                                                  monkeypatch):
    plant = tmp_path / "plant"
    plant.mkdir()
    (plant / "sitecustomize.py").write_text(PLANT)
    monkeypatch.setenv("PYTHONPATH", f"{plant}{os.pathsep}{ROOT}")
    out = _run(mesh_root)
    assert not out["correct"], out["checks"]
