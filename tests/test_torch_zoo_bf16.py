"""The CTR zoo's bfloat16 towers (the default compute dtype) against the
JAX package's: `tests/test_torch_zoo.py`'s forward and 10-step checks,
with the bfloat16 tolerances stated there."""

import numpy as np
import pytest

import jax

from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu_torch import convert

from test_torch_trainer import TOL, _assert_states_close, _numpy_state
from test_torch_zoo import FAMILIES, _batches, _pair


@pytest.mark.parametrize("compute", ["bfloat16"])
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


@pytest.mark.parametrize("compute", ["bfloat16"])
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
