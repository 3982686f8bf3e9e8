"""The pipelined window at S = 1: `MeshTrainer(pipeline_steps=True)` is
inert there (the window and its metrics are the serial ones, bit for
bit), and `grouped_prefetch` refuses one rank, as the JAX package's does
(the model and data of `test_torch_pipeline.py`)."""

import pytest
import torch

from openembedding_tpu_torch.parallel import sharded
from openembedding_tpu_torch.parallel.mesh import Mesh
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks
from test_torch_pipeline import VOCAB, batches_for


def test_pipeline_steps_inert_at_one_rank(tmp_path):
    cfg = {"vocab": VOCAB, "hashed": False, "wire": "int8",
           "conflict_factor": 0.05, "batches": batches_for(overlap=True)}
    out, = run_local(ranks.pipelined_windows, 1, args=([cfg],),
                     timeout_s=60, tmp_dir=str(tmp_path))
    out = out[0]
    assert out["differ"] == [] and out["same_losses"]
    assert out["pipelined_keys"] == out["serial_keys"] == ["loss",
                                                            "overflow"]


def test_prefetch_refuses_one_rank():
    """As the JAX package's: the split exchange has nothing to overlap on
    one rank (MeshTrainer runs the serial window there)."""
    spec = ranks.deepfm(VOCAB).specs["categorical"]
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="needs S >= 2"):
        sharded.grouped_prefetch([spec], [None], [torch.zeros(4).long()],
                                 mesh=mesh)
