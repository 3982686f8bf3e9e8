"""The port's MeshTrainer against the JAX package's: 10-step trajectories.

A small DeepFM (dim 9 folded into one 10-wide table, hidden (16, 16),
float32 tower, Adagrad(0.05)) on `synthetic_criteo` batches of 64, global:
the JAX MeshTrainer runs on `make_mesh(jax.devices()[:S])`, the port on S
gloo ranks spawned by `parallel.multihost.run_local`, each from the JAX
init carried across by `convert.mesh_state_from_jax` and stepping on its
rows of every batch; the ranks' final states come back together through
`convert.mesh_state_to_jax`. Configurations: array and hash (2^40 id
space) tables, fp32 and bf16 wire, the fused (grouped) and the per-table
exchange, at S = 2 and 4.

Tolerances (float32 tower): the pulls and pushes are the protocol's
(`test_torch_mesh.py`); what differs is the order of the dense sums (the
port adds the ranks' partials in rank order, XLA's all-reduce its own) and
XLA's contracted multiply-adds, which the steps carry on. Measured after 10
steps over the four configurations at S = 2 and 4: loss 1.2e-7, tables
3.7e-8 on the fp32 wire and 2.4e-6 on the bf16 one (a gradient one float32
ulp apart can round to the neighbouring bfloat16 value, and Adagrad moves
the row by lr times the ratio), accumulators 1.5e-7, dense params 8.9e-8,
dense slots 2.4e-7. Held to 1e-6 (loss), 1e-6 (fp32-wire tables), 2e-5
(bf16-wire tables), 1e-6 (accumulators and dense params) and 2e-6 (dense
slots). The hash tables' keys are bit-exact, and their overflow counters
equal: the 2^40 id space brings 12,537 ids to 4,096 slots.

This file runs the array configurations at S = 2;
`test_torch_mesh_train_hash.py` the hash ones, `test_torch_mesh_train_s4.py`
and `test_torch_mesh_train_s4_hash.py` both at S = 4 (a file each keeps a
file's run well under 40 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import data
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

VOCAB, BATCH, STEPS, CAPACITY = 1000, 64, 10, 4096
CONFIGS = [("array", "fp32", True), ("array", "bf16", False),
           ("hash", "fp32", False), ("hash", "bf16", True)]
TOL = {"loss": 1e-6, "table": {"fp32": 1e-6, "bf16": 2e-5}, "accum": 1e-6,
       "dense_params": 1e-6, "dense_slots": 2e-6}


def numpy_state(js):
    """A JAX TrainState as numpy (`train_state_from_jax`'s arguments)."""
    tables = {}
    for n, t in js.tables.items():
        tables[n] = {"weights": np.array(t.weights),
                     "slots": {k: np.array(v) for k, v in t.slots.items()}}
        if t.keys is not None:
            tables[n]["keys"] = np.array(t.keys)
            tables[n]["overflow"] = int(t.overflow)
    return dict(
        tables=tables,
        dense_params={k: np.array(v) for k, v in
                      _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v) for k, v in
                     _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _batches(hashed):
    return list(data.synthetic_criteo(
        BATCH, id_space=(1 << 40) if hashed else VOCAB, steps=STEPS, seed=7))


def _jax_run(S, kind, wire, grouped):
    hashed = kind == "hash"
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32, hashed=hashed,
                            capacity=CAPACITY if hashed else 0)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:S]),
                             wire=wire, group_exchange=grouped)
    batches = _batches(hashed)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    step = trainer.jit_train_step(batches[0], state)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    cfg = {"vocab": VOCAB, "hashed": hashed, "capacity": CAPACITY,
           "wire": wire, "grouped": grouped, "state": start,
           "batches": batches}
    return cfg, losses, numpy_state(state)


def trajectory_tests(S, kind):
    """(the module fixture, the test) of the `kind` configurations at S
    ranks: the JAX runs, then every configuration on S port ranks (one
    launch), compared."""
    configs = [c for c in CONFIGS if c[0] == kind]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        jax_runs = [_jax_run(S, *c) for c in configs]
        port = run_local(ranks.trajectories, S,
                         args=([cfg for cfg, _, _ in jax_runs],),
                         timeout_s=90,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return jax_runs, port

    @pytest.mark.parametrize("config", configs, ids=lambda c: "-".join(
        [c[0], c[1], "grouped" if c[2] else "per_table"]))
    def test_ten_steps_match_the_jax_mesh_trainer(runs, config):
        jax_runs, port = runs
        _check(S, config, jax_runs[configs.index(config)],
               [port[r][configs.index(config)] for r in range(S)])

    return runs, test_ten_steps_match_the_jax_mesh_trainer


def _check(S, config, jax_run, port):
    _, want_losses, want = jax_run
    for r in range(S):
        np.testing.assert_allclose(port[r]["losses"], want_losses, rtol=0,
                                   atol=TOL["loss"])
        assert port[r]["overflow"] == 0
    assert want_losses[-1] < want_losses[0]
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    assert got["step"] == want["step"] == STEPS
    for name, t in want["tables"].items():
        g = got["tables"][name]
        np.testing.assert_allclose(g["weights"], t["weights"], rtol=0,
                                   atol=TOL["table"][config[1]])
        for k, v in t["slots"].items():
            np.testing.assert_allclose(g["slots"][k], v, rtol=0,
                                       atol=TOL["accum"], err_msg=k)
        if "keys" in t:
            np.testing.assert_array_equal(g["keys"], t["keys"])
            assert g["overflow"] == t["overflow"] > 0
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k], v, rtol=0,
                                       atol=TOL[key], err_msg=k)


runs, test_ten_steps_match_the_jax_mesh_trainer = trajectory_tests(2,
                                                                   "array")
