"""The port's dense wires (`MeshTrainer(dense_shard=True, dense_wire=...)`)
against the JAX MeshTrainer's, on two gloo ranks (`multihost.run_local`).

The model and data of `test_torch_zero.py`: a DeepFM with one 10-wide
table on Adagrad 0.05, a 16-16 float32 tower on Adam 0.01, global batches
of 64. Each format runs 10 steps from the JAX init carried across in its
flat form (masters and, for int8 and sparse_topk, the zero residual
included), with `dense_stats=True`; the JAX MeshTrainer runs the same
steps through `jit_train_step`. sparse_topk takes the default k (160 of a
chunk of 2,144 here).

Tolerances. Both sides encode the same local gradients up to their last
bits (the matmuls' order differs, XLA contracts multiply-adds), so a code
can move by one step of its block's scale and a master by its share of
it; the params the forward pass reads are the masters rounded to
bfloat16, so one master a float32 ulp apart can put a param one bfloat16
ulp off (about 2e-3 at 0.5). Measured over the three formats (10 steps):
loss 1.8e-7 (step 0: equal), table 6.6e-7, accumulator 6e-8, dense params
4.9e-4, masters 6.8e-5, m 3.7e-6, v 3.2e-10, residual 3.0e-5, beta powers
equal. Held to loss 1e-6 (step 0: 1e-7), table 5e-6, accumulator 5e-7,
dense params 2e-3, masters 3e-4, m 2e-5, v 1e-8, residual 2e-4.

`dense/grad_density` (the nonzero share of each rank's dense gradients
before the reduce, a rank's share divided by S and summed over the
ranks): JAX sums the ranks' float32 shares in float32, the port's
`psum_stats` in float64 rounded once, so they may differ by an ulp; held
to a relative 2.4e-7 (two float32 ulps; measured equal).

The int8 residual is the gradient less its decoded code, rounded once:
jitted JAX contracts `flat_g - decode_flat(enc)` into a fused
multiply-add (measured on XLA:CPU: the jitted expression equals the
float64 difference rounded to float32 on all 2,048 elements of a seeded
vector, and differs from the two-rounding one on 1,605), so the port uses
`wire.residual`. The sparse_topk residual `x - decode_flat_topk(enc)` is
not contracted (the scatter sits between the product and the
difference): equal to the two-rounding form on every element, 147
elements away from the fused one.

Then the lifecycle: an int8 and a sparse_topk run's checkpoints load into
a trainer without ZeRO and into one of their own format, the externalized
state bit-equal to the saved one and the residual re-seeded to zeros;
`set_dense_wire` moves an fp32 ZeRO state to int8 and back in place (one
`graph_epoch` step, the residual zero, the chunk aligned to the codec
block) with its externalized state bit-equal throughout. About 25 s
alone.
"""

import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_zero_ranks as zr
from test_torch_mesh_train import numpy_state
from test_torch_zero import S, _close, _jax_trainer

STEPS = 10
FORMATS = ("bf16", "int8", "sparse_topk")
TOL = {"loss": 1e-6, "step0": 1e-7, "table": 5e-6, "accum": 5e-7,
       "dense_params": 2e-3, "__zero__/__dense_master__": 3e-4,
       "__zero__/m": 2e-5, "__zero__/v": 1e-8,
       "__zero__/__dense_ef__": 2e-4, "__zero__/beta_1_t": 0,
       "__zero__/beta_2_t": 0}


def jax_run(fmt, batches, shards=S):
    """The JAX MeshTrainer's run of one dense wire -> (the port ranks'
    config, its losses, its `dense/grad_density`, its state as numpy)."""
    trainer = _jax_trainer(jax_embed.Adagrad(learning_rate=0.05),
                           shards=shards, dense_shard=True, dense_wire=fmt,
                           dense_stats=True)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    step = trainer.jit_train_step(batches[0], state)
    losses, density = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        density.append(np.asarray(m["stats"]["dense/grad_density"]))
    cfg = {"vocab": 1000, "optimizer": optimizers.Adam(learning_rate=0.01),
           "table_optimizer": optimizers.Adagrad(learning_rate=0.05),
           "state": start, "batches": batches, "dense_wire": fmt,
           "dense_stats": True}
    return cfg, losses, density, numpy_state(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = zr.batches(STEPS)
    jax_runs = [jax_run(fmt, batches) for fmt in FORMATS]
    port = run_local(zr.trajectories, S,
                     args=([cfg for cfg, *_ in jax_runs],), timeout_s=120,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return jax_runs, port


@pytest.mark.parametrize("fmt", FORMATS)
def test_ten_steps_match_the_jax_dense_wire(runs, fmt):
    jax_runs, port = runs
    i = FORMATS.index(fmt)
    check(fmt, jax_runs[i], [port[r][i] for r in range(S)], TOL)


def check(fmt, jax_run, port, tol):
    """One format's port ranks' runs against the JAX run, within `tol`."""
    cfg, want_losses, want_density, want = jax_run
    keys = {"__zero__/m", "__zero__/v", "__zero__/beta_1_t",
            "__zero__/beta_2_t", "__zero__/__dense_master__"}
    if fmt != "bf16":
        keys.add("__zero__/__dense_ef__")
    assert set(cfg["state"]["dense_slots"]) == keys
    for run in port:
        _close(run["losses"], want_losses, tol["loss"], "loss")
        _close(run["losses"][0], want_losses[0], tol["step0"], "step 0")
        got_density = [s["dense/grad_density"] for s in run["stats"]]
        np.testing.assert_allclose(got_density, want_density, rtol=2.4e-7,
                                   atol=0)
    assert want_losses[-1] < want_losses[0]
    got = mesh_state_to_jax([run["state"] for run in port])
    assert set(got["dense_slots"]) == keys
    for k, v in want["dense_slots"].items():
        assert got["dense_slots"][k].shape == v.shape, k
        _close(got["dense_slots"][k], v, tol[k], k)
    for k, v in want["dense_params"].items():
        _close(got["dense_params"][k], v, tol["dense_params"], k)
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    _close(g["weights"], t["weights"], tol["table"], "weights")
    _close(g["slots"]["accum"], t["slots"]["accum"], tol["accum"], "accum")
    # the external form holds the masters and no wire slot
    ext = port[0]["external"]
    assert not any(k.startswith("__zero__") for k in ext["dense_slots"])
    for k, v in ext["dense_params"].items():
        _close(v, got["dense_params"][k], tol["dense_params"], k)


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    return run_local(zr.wire_lifecycle, S, args=(
        {"root": str(tmp_path_factory.mktemp("ckpt"))},), timeout_s=120,
        tmp_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("fmt", ["int8", "sparse_topk"])
def test_dense_wire_checkpoints_load_either_way(lifecycle, fmt):
    for r in range(S):
        rec = lifecycle[r][fmt]
        assert rec["replicated_differ"] == []
        assert rec["same_differ"] == []
        assert rec["ef_zero"]
        assert rec["master_chunk"][0] == 1
        assert np.isfinite(rec["replicated_loss"])
        assert np.isfinite(rec["same_loss"])


def test_set_dense_wire_round_trip(lifecycle):
    for r in range(S):
        rec = lifecycle[r]["switch"]
        assert rec["in_place"] and rec["noop"]
        assert rec["epoch"] == 1
        assert rec["ef_zero"] and rec["aligned"]
        assert rec["to_int8_differ"] == []
        assert rec["back_differ"] == []
        assert rec["flat_keys"] == ["beta_1_t", "beta_2_t", "m", "v"]
        assert np.isfinite(rec["loss"])
