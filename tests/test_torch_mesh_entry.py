"""The Criteo entry point's `--mesh` on the CPU.

At one rank and at two gloo ranks (spawned by
`parallel.multihost.run_local`, which brings the group up before `main`
runs, as torchrun does), `main([... "--mesh"])` gives, on every rank, the
losses of the same run through `parallel.MeshTrainer` directly on the
rank's rows of the same TSV batches, bit for bit (the same computation),
with a host-cached table (`--offload`) too.
"""

import os

import pytest

from openembedding_tpu_torch.examples import criteo_deepctr
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks
import torch_offload_ranks as offload_ranks
import torch_persist_ranks as persist_ranks

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


def test_mesh_entry_point_persists_and_restores(tmp_path):
    """`--mesh --persist ROOT --persist-incremental` at two ranks: every
    rank writes its own delta files, and a restore of the root into a
    fresh MeshTrainer state equals the state `main` returned on the rank,
    bit for bit."""
    root = str(tmp_path / "persist")
    argv = ARGV + ["--steps", "4", "--persist", root, "--persist-steps",
                   "2", "--persist-incremental"]
    out = run_local(persist_ranks.entry_persist, 2, args=(argv,),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in out:
        assert r["unequal"] == [], r["rank"]
        assert r["kinds"] == ["full", "delta"]
        assert r["step"] == 4
    assert sorted(n for n in os.listdir(os.path.join(
        root, "delta_000000000004")) if n.startswith("table")) == [
        "table_categorical.p0.npz", "table_categorical.p1.npz"]


def test_mesh_entry_point_offload(tmp_path):
    """`--mesh --offload SLOTS` at two ranks: each rank's `main` equals the
    same prepared steps through MeshTrainer directly, bit for bit; the
    sharded save holds each rank's store as its shard, and the export
    (rank 0, from the checkpoint) holds every stored id."""
    import numpy as np
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "export")
    argv = ARGV + ["--offload", "1024", "--save", ckpt, "--export", export]
    out = run_local(offload_ranks.entry_offload, 2, args=(argv, STEPS),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in out:
        assert r["main"] == r["direct"]
        assert r["evicted"]
    stored = np.unique(np.concatenate([r["store_ids"] for r in out]))
    exported = np.load(os.path.join(export, "variable_0", "ids.npy"))
    assert exported.tobytes() == stored.tobytes()


def test_mesh_export_needs_the_sharded_checkpoint():
    with pytest.raises(SystemExit):
        criteo_deepctr.main(ARGV + ["--export", "/tmp/never"])
