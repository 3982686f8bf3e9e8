"""The numerics sentinel on the mesh: four gloo ranks on the CPU against
the JAX MeshTrainer on four CPU devices, both with the int8 wire (error
feedback on) and `halt_on_nonfinite=True`, from the JAX init carried across
(`convert.mesh_state_from_jax`), on the same batches of 64.

The sentinel's stats ride the step's one sum over the ranks, so every
rank's `health.*` gauges are equal. Against JAX, measured over the 3 clean
steps: at step 0 (the same state) every gauge within 9.2e-7 relative (the
float32 sums run in other orders; the port's sum over the ranks runs in
float64); later steps inherit the int8 trajectory's drift
(`test_torch_mesh_train_int8.py`: an ulp moves a dithered code):
`grad_norm` 4.2e-6, `dense_grad_norm` 8.9e-7, `quant_err_rel` 5.8e-4,
`ef_abs_mean` 1.0e-2. Held to 1e-5 at step 0, then 1e-4, 1e-4, 5e-3 and
3e-2. A NaN label in one sample of step K = 2 (in the last rank's rows)
makes every rank raise `NonFiniteError` at step K, with the sources JAX
names and their counts.
"""

import jax
import jax.numpy as jnp
import numpy as np

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu_torch import data
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_obs_ranks
from test_torch_mesh_train_int8 import numpy_state

S, VOCAB, BATCH, K = 4, 1000, 64, 2
TOL0 = 1e-5
TOL = {"grad_norm": 1e-4, "dense_grad_norm": 1e-4, "quant_err_rel": 5e-3,
       "ef_abs_mean": 3e-2}


def _batches():
    batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB, steps=K + 1,
                                         seed=7))
    batches[K] = dict(batches[K])
    batches[K]["label"] = batches[K]["label"].copy()
    batches[K]["label"][BATCH - 3] = np.nan  # the last rank's rows
    return batches


def _jax_run(batches):
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:S]),
                             wire="int8", halt_on_nonfinite=True)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    step = trainer.jit_train_step(batches[0], state)
    health, halt = [], None
    for k, b in enumerate(batches):
        with jax_metrics._LOCK:  # only this step's series
            jax_metrics._REGISTRY.clear()
        state, m = step(state, b)
        try:
            trainer.record_step_stats(m)
        except jax_metrics.NonFiniteError as e:
            halt = (k, dict(e.sources))
            break
        health.append({key: v for key, v in jax_metrics.report().items()
                       if key.startswith("health.")})
    return start, health, halt


def test_sentinel_and_halt_on_four_ranks_match_jax(tmp_path):
    batches = _batches()
    start, want, want_halt = _jax_run(batches)
    out = run_local(torch_obs_ranks.health_trajectory, S,
                    args=({"vocab": VOCAB, "state": start,
                           "batches": batches},),
                    timeout_s=120, tmp_dir=str(tmp_path))
    assert want_halt is not None and want_halt[0] == K
    for r in out:
        # every rank saw the same psum'd health and halted at step K
        assert r["health"] == out[0]["health"]
        assert r["halt"] is not None and r["halt"][0] == K
        assert r["halt"][1] == want_halt[1]
    got = out[0]["health"]
    assert len(got) == len(want) == K
    for k in range(K):
        assert set(got[k]) == set(want[k])
        for key, v in want[k].items():
            field = key.split("{")[0].split(".", 1)[1]
            if "nonfinite" in key:
                assert got[k][key] == v == 0.0, key
            else:
                tol = TOL0 if k == 0 else TOL[field]
                np.testing.assert_allclose(got[k][key], v, rtol=tol,
                                           err_msg=f"step {k} {key}")
    assert any(k.startswith("health.quant_err_rel") for k in got[0])
    assert any(k.startswith("health.ef_abs_mean") for k in got[1])
