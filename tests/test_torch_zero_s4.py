"""The port's ZeRO MeshTrainer on four gloo ranks (`multihost.run_local`).

- fp32 ZeRO against the port's replicated MeshTrainer from one init, for
  Adagrad and Adam (two `train_step`s and a `train_many` window of two):
  losses and externalized state bit-equal (the reduce_scatter adds the
  four partials in rank order, as `dense_sum` does).
- The int8 dense wire against the JAX MeshTrainer's, 10 steps from the
  JAX init (the set-up of `test_torch_zero_wire.py`). At four ranks a rank
  steps on 16 rows, its int8 codes carry more of each gradient's last
  bits, and a code one step away moves the sum of four decoded partials
  (both sides add them in rank order: XLA:CPU's sum over the leading axis
  is sequential, measured equal to ((p0 + p1) + p2) + p3 on a seeded
  (4, 4096) array). Measured (10 steps): loss 4.6e-6 (step 0: 6e-8),
  table 9.9e-6, accumulator 8.0e-6, dense params 1.95e-3 (one bfloat16
  ulp of a param in [0.25, 0.5)), masters 1.7e-3, m 1.9e-4, v 4.9e-6,
  residual 1.4e-3, beta powers equal, `dense/grad_density` one float32
  ulp. Held to loss 2e-5 (step 0: 1e-7), table 5e-5, accumulator 5e-5,
  dense params 4e-3, masters 5e-3, m 1e-3, v 2e-5, residual 5e-3.
- The pipelined window (`pipeline_steps=True`, K = 3) with fp32 ZeRO
  equals the serial window bit for bit: losses and the whole state, the
  flat slots included.

About 30 s alone.
"""

import pytest

from openembedding_tpu_torch.parallel.multihost import run_local

import torch_zero_ranks as zr
from test_torch_zero_wire import check, jax_run

S, STEPS = 4, 10
TOL = {"loss": 2e-5, "step0": 1e-7, "table": 5e-5, "accum": 5e-5,
       "dense_params": 4e-3, "__zero__/__dense_master__": 5e-3,
       "__zero__/m": 1e-3, "__zero__/v": 2e-5,
       "__zero__/__dense_ef__": 5e-3, "__zero__/beta_1_t": 0,
       "__zero__/beta_2_t": 0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = jax_run("int8", zr.batches(STEPS), shards=S)
    tmp = str(tmp_path_factory.mktemp("ranks"))
    port = run_local(zr.s4_runs, S, args=(
        {"optimizers": ["adagrad", "adam"], "steps": 2, "window": 2},
        want[0], {"k": 3}), timeout_s=120, tmp_dir=tmp)
    return want, port


@pytest.mark.parametrize("name", ["adagrad", "adam"])
def test_fp32_zero_is_bit_equal_to_the_replicated_run(runs, name):
    _, port = runs
    for r in range(S):
        got = port[r]["replicated"][name]
        assert got["flat"] and got["same_losses"]
        assert got["differ"] == []
        total, chunk, padded = got["plan"]
        assert padded == S * chunk >= total > 0


def test_int8_ten_steps_match_the_jax_dense_wire(runs):
    want, port = runs
    check("int8", want, [port[r]["int8"] for r in range(S)], TOL)


def test_pipelined_zero_window_is_bit_equal_to_serial(runs):
    _, port = runs
    for r in range(S):
        got = port[r]["pipelined"]
        assert got["differ"] == []
        assert got["same_losses"]
        assert got["conflict"] > 0
