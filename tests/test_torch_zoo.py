"""The rest of the CTR zoo (LR, Wide&Deep, xDeepFM, DCN, DLRM) in the port
against the JAX package's flax modules, at small widths (vocabulary 1000,
latent width 4, towers of 16), on `synthetic_criteo` batches of 64.

For each family (this file: float32 towers; `test_torch_zoo_bf16.py`: the
default bfloat16 ones; `test_torch_zoo_serving.py`: exports):

- the forward pass and the loss from the JAX `Trainer.init` parameters
  carried across by `convert.train_state_from_jax`: in float32 within 1e-5
  (matrix-product summation order); in bfloat16 within 2e-2 on the logits
  and 2e-3 on the loss, the bf16 bound of `tests/test_torch_trainer.py`
  (the frameworks round a bf16 tower at other places, one bf16 ulp is
  2^-8 relative, and CIN and DLRM's dot products sum 100-odd bf16
  products);
- a 10-step trajectory and the final state against the JAX `Trainer`, with
  `test_torch_trainer.py`'s tolerances for the tower's dtype;
- a JAX `export_standalone` served by the port's `StandaloneModel`, and
  the port's export served by the JAX package's, logits within 1e-5;
- the flax parameter names of every layer (raw params too: LR's `bias`,
  xDeepFM's `cin_<i>`, DCN's `cross_<i>`, DLRM's `MLP_0`/`MLP_1`), with and
  without dense features.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu import models as jax_zoo
from openembedding_tpu_torch import convert, data, models, optimizers
from openembedding_tpu_torch.model import Trainer

from test_torch_trainer import TOL, _assert_states_close, _numpy_state

VOCAB, DIM, BATCH = 1000, 4, 64
FAMILIES = ["lr", "wdl", "xdeepfm", "dcn", "dlrm"]
WIDTHS = {"lr": {}, "wdl": {"hidden": (16, 16)},
          "xdeepfm": {"hidden": (16, 16), "cin_layers": (8, 8)},
          "dcn": {"hidden": (16, 16), "num_cross": 2},
          "dlrm": {"bottom": (16,), "top": (16, 16)}}


def _batches(steps, seed=3):
    return list(data.synthetic_criteo(BATCH, id_space=VOCAB, steps=steps,
                                      seed=seed))


def _pair(family, compute="float32"):
    kw = dict(WIDTHS[family])
    if family != "lr":
        kw["dim"] = DIM
    jm = jax_zoo._FAMILIES[family](VOCAB, compute_dtype=getattr(jnp, compute),
                                   **kw)
    tm = models._FAMILIES[family](VOCAB, compute_dtype=getattr(torch, compute),
                                  **kw)
    assert tm.config == jm.config
    assert models.from_config(jm.config).config == jm.config
    for name, spec in tm.specs.items():
        assert spec.to_config() == jm.specs[name].to_config()
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    return jm, jt, tm, tt


@pytest.mark.parametrize("compute", ["float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_loss_match_jax(family, compute):
    jm, jt, tm, tt = _pair(family, compute)
    batches = _batches(2)
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    # every flax param has its counterpart, and the port's own init makes
    # the same names and shapes
    flat = {k: np.asarray(v) for k, v in _flatten_params(
        js.dense_params).items()}
    own = convert.dense_to_flax(_pair(family, compute)[3].init(
        batches[0]).dense)
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in flat.items()}
    want = jax.jit(jt.eval_step)(js, batches[1])
    got = tt.eval_step(ts, batches[1])
    tol = (1e-5, 1e-5) if compute == "float32" else (2e-2, 2e-3)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0,
                               atol=tol[0])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=tol[1])


@pytest.mark.parametrize("compute", ["float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_ten_steps_match_the_jax_trainer(family, compute):
    jm, jt, tm, tt = _pair(family, compute)
    batches = _batches(10, seed=5)
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    step = jax.jit(jt.train_step)
    jl, tl = [], []
    for b in batches:
        js, m = step(js, b)
        jl.append(float(m["loss"]))
        ts, m = tt.train_step(ts, b)
        tl.append(float(m["loss"]))
    tol = TOL[compute]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol["loss"])
    assert np.isfinite(tl).all()
    _assert_states_close(ts, js, tol)
