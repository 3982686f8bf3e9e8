"""`MeshTrainer.train_stream` of the port against the JAX package's: the
same synthetic files through `ingest.feed(..., window=2)` (the port's ranks
each keep their block of the node's rows, `multihost.window_batch`; JAX
shards the batch over its CPU devices), from the same state (`convert`),
at S = 1 and S = 4 (gloo ranks spawned by `multihost.run_local` against
4 JAX CPU devices). Also the JAX test's attribution pin: fed at line rate
the stream reads compute-bound, behind a throttled producer input-bound.

Tolerances are the mesh trajectories' (`tests/test_torch_mesh_train.py`:
the dense sums' order and XLA's contracted multiply-adds; ROADMAP.md's
optimizer bound against jitted JAX): loss 1e-6, table rows 1e-6, Adagrad
accumulators 1e-6, dense params 1e-6, dense slots 2e-6, over 6 windows of
2 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.data import ingest as jax_ingest
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_fs_ranks as ranks
from test_torch_mesh_train import numpy_state

VOCAB, BATCH, WINDOW = 512, 32, 2
FILES = [f"synthetic://steps=4&seed={s}&id_space={VOCAB}" for s in range(3)]
TOL = {"loss": 1e-6, "table": 1e-6, "accum": 1e-6, "dense_params": 1e-6,
       "dense_slots": 2e-6}


def _jax_stream(S):
    jax_metrics._REGISTRY.clear()
    model = jax_make_deepfm(VOCAB, 4, hidden=(8,),
                            compute_dtype=jnp.float32)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:S]), seed=1,
                             wire="fp32")
    mesh = trainer.mesh
    first = next(jax_ingest.sharded_reader(FILES, BATCH, source="synthetic",
                                           host_id=0, num_hosts=1))
    state = trainer.init(first)
    start = numpy_state(state)
    ring = jax_ingest.feed(FILES, BATCH, mesh=mesh, source="synthetic",
                           window=WINDOW, workers=2, depth=3, label="stream")
    state, rep = trainer.train_stream(state, ring)
    return start, rep, numpy_state(state)


@pytest.mark.parametrize("S", [1, 4])
def test_train_stream_matches_the_jax_mesh_trainer(S, tmp_path):
    start, want_rep, want = _jax_stream(S)
    cfg = {"vocab": VOCAB, "state": start, "files": FILES, "batch": BATCH,
           "window": WINDOW}
    port = run_local(ranks.stream, S, args=(cfg,), timeout_s=120,
                     tmp_dir=str(tmp_path))
    assert want_rep["windows"] == 6
    for r in range(S):
        rep = port[r]["report"]
        assert rep["windows"] == want_rep["windows"]
        assert port[r]["windows_ms"] == 6
        assert port[r]["losses"].shape == (6, WINDOW)
        assert rep["loss"] == port[r]["losses"][-1, -1]
        assert abs(rep["loss"] - want_rep["loss"]) <= TOL["loss"]
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    assert got["step"] == want["step"] == 6 * WINDOW
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    np.testing.assert_allclose(g["weights"], t["weights"], rtol=0,
                               atol=TOL["table"])
    for k, v in t["slots"].items():
        np.testing.assert_allclose(g["slots"][k], v, rtol=0,
                                   atol=TOL["accum"], err_msg=k)
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k], v, rtol=0,
                                       atol=TOL[key], err_msg=k)


def test_train_stream_compute_bound_vs_throttled(tmp_path):
    """Fed at line rate the stream is compute-bound (input-wait share under
    0.5); behind a producer paced at 4x the measured window time (the JAX
    test's fixed 50 ms a batch suits jitted steps, not the port's eager CPU
    ones, whose pace varies with the machine's load) the same loop reads
    input-bound (over 0.5), on each of two ranks."""
    out = run_local(ranks.bound_vs_throttled, 2,
                    args=({"vocab": VOCAB, "factor": 4.0},),
                    timeout_s=120, tmp_dir=str(tmp_path))
    for r in range(2):
        fast, slow = out[r]["fast"], out[r]["slow"]
        assert fast["report"]["windows"] == slow["report"]["windows"] == 3
        assert np.isfinite(fast["report"]["loss"])
        assert fast["share"] is not None and fast["share"] < 0.5
        assert slow["share"] is not None and slow["share"] > 0.5, \
            f"throttled producer not attributed input-bound: {slow}"
