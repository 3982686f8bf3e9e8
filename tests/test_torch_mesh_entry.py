"""The Criteo entry point's `--mesh` on the CPU.

At one rank and at two gloo ranks (spawned by
`parallel.multihost.run_local`, which brings the group up before `main`
runs, as torchrun does), `main([... "--mesh"])` gives, on every rank, the
losses of the same run through `parallel.MeshTrainer` directly on the
rank's rows of the same TSV batches, bit for bit (the same computation).
The flags still refused raise with their ROADMAP.md items under `--mesh`
too.
"""

import os

import pytest

from openembedding_tpu_torch.examples import criteo_deepctr
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

TRAIN100 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "train100.tsv")
STEPS = 5
ARGV = ["--device", "cpu", "--data", TRAIN100, "--batch-size", "32",
        "--vocabulary", "1000", "--mesh", "--steps", str(STEPS)]


@pytest.mark.parametrize("S", [1, 2])
def test_mesh_entry_point_matches_the_mesh_trainer(S, tmp_path):
    out = run_local(ranks.entry_and_direct, S, args=(ARGV, STEPS),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in out:
        assert r["mesh_size"] == S
        assert r["main"] == r["direct"]
        assert len(r["main"]) == STEPS
    assert out[0]["main"] == out[-1]["main"]  # the loss is the ranks' mean


@pytest.mark.parametrize("flag", [
    ["--offload", "64"], ["--persist", "/tmp/p"], ["--persist-steps", "5"],
    ["--persist-incremental"]], ids=lambda f: f[0])
def test_refused_flags_still_raise_under_mesh(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        criteo_deepctr.main(ARGV + flag)


def test_mesh_export_needs_the_sharded_checkpoint():
    with pytest.raises(SystemExit):
        criteo_deepctr.main(ARGV + ["--export", "/tmp/never"])
