"""The port's optimizer rules against the JAX package's.

The same numpy rows go through each rule of `openembedding_tpu_torch.optimizers`
(on CPU tensors) and of `openembedding_tpu.optimizers`:

- against the JAX rule run op by op (`jax.disable_jit()`): bit-exact. Each
  operation rounds once on both sides, in the same order, and the square
  root is correctly rounded on both (`optimizers.sqrt`; `torch.sqrt` on
  float32 CPU tensors is not). The one exception is Ftrl with
  learning_rate_power != -0.5, whose `pow` is not correctly rounded on
  either side: the powers differ by an ulp here and there, and
  `linear - sigma * w` can cancel, so a weight moves by up to 1.35e-6
  relative (measured, on 5,000 values); held to rtol 4e-6;
- against the jitted JAX rule: XLA:CPU contracts multiply-adds into fused
  ones, so the results differ by a rounding here and there: measured up to
  9.5e-7 absolute on unit-scale rows, and 2.3e-5 for Ftrl, whose weights
  are (l1 - linear) / quadratic with quadratic near sqrt(accum)/lr, so a
  one-ulp change in linear or the accumulator moves a weight of size ~10 by
  ~1e-6 relative. Held to rtol 2e-6, atol 2e-6.

Rows with counts == 0 are part of every batch and must come back
bit-identical on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu import optimizers as jax_opt
from openembedding_tpu_torch import optimizers

# tests/test_pallas.py's ALL_OPTS, as config dicts both packages build from
ALL_OPTS = [
    {"category": "default", "learning_rate": 0.1},
    {"category": "sgd", "learning_rate": 0.05, "momentum": 0.9,
     "nesterov": True},
    {"category": "adagrad", "learning_rate": 0.1},
    {"category": "adadelta", "learning_rate": 0.5},
    {"category": "adam", "learning_rate": 0.01},
    {"category": "adamax", "learning_rate": 0.01},
    {"category": "ftrl", "learning_rate": 0.05,
     "l1_regularization_strength": 0.01, "l2_regularization_strength": 0.01},
    {"category": "rmsprop", "learning_rate": 0.05, "momentum": 0.5},
    {"category": "test"},
]
FTRL_POW = {"category": "ftrl", "learning_rate": 0.05,
            "learning_rate_power": -0.7, "beta": 0.3,
            "l1_regularization_strength": 0.01,
            "l2_shrinkage_regularization_strength": 0.02}
JIT_TOL = dict(rtol=2e-6, atol=2e-6)


def _inputs(cfg, seed, n=500, dim=10):
    """Rows, slots away from their initial values, grads, counts with 0s."""
    rng = np.random.default_rng(seed)
    opt = jax_opt.make_optimizer(dict(cfg))
    w = rng.standard_normal((n, dim)).astype(np.float32)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    counts = rng.integers(0, 3, n).astype(np.int32)
    slots = {}
    for name, width in opt.slot_shapes(dim).items():
        if name in ("beta_1_t", "beta_2_t"):  # powers of beta in (0, 1)
            v = rng.uniform(0.05, 0.95, (n, width))
        else:
            v = opt.slot_init(name) + 0.5 * np.abs(
                rng.standard_normal((n, width)))
        slots[name] = v.astype(np.float32)
    return w, slots, g, counts


def _run_both(cfg, w, slots, g, counts, jit):
    jo = jax_opt.make_optimizer(dict(cfg))
    to = optimizers.make_optimizer(dict(cfg))
    args = (jnp.asarray(w), {k: jnp.asarray(v) for k, v in slots.items()},
            jnp.asarray(g), jnp.asarray(counts))
    if jit:
        jw, js = jax.jit(jo.apply)(*args)
    else:
        with jax.disable_jit():
            jw, js = jo.apply(*args)
    tw, ts = to.apply(torch.from_numpy(w),
                      {k: torch.from_numpy(v) for k, v in slots.items()},
                      torch.from_numpy(g), torch.from_numpy(counts))
    want = {"weights": np.asarray(jw), **{k: np.asarray(v)
                                          for k, v in js.items()}}
    got = {"weights": tw.numpy(), **{k: v.numpy() for k, v in ts.items()}}
    assert set(got) == set(want)
    return got, want


@pytest.mark.parametrize("cfg", ALL_OPTS, ids=lambda c: c["category"])
def test_rule_bit_exact_against_jax_op_by_op(cfg):
    w, slots, g, counts = _inputs(cfg, seed=1)
    got, want = _run_both(cfg, w, slots, g, counts, jit=False)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    idle = counts == 0
    assert idle.any() and (~idle).any()
    np.testing.assert_array_equal(got["weights"][idle], w[idle])
    for k, v in slots.items():
        np.testing.assert_array_equal(got[k][idle], v[idle])


@pytest.mark.parametrize("cfg", ALL_OPTS, ids=lambda c: c["category"])
def test_rule_against_jitted_jax(cfg):
    w, slots, g, counts = _inputs(cfg, seed=2)
    got, want = _run_both(cfg, w, slots, g, counts, jit=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **JIT_TOL)


def test_ftrl_pow_branch_within_measured_bound():
    w, slots, g, counts = _inputs(FTRL_POW, seed=3)
    got, want = _run_both(FTRL_POW, w, slots, g, counts, jit=False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=4e-6, atol=1e-6,
                                   err_msg=k)


def test_sqrt_is_correctly_rounded():
    """Bit for bit against numpy's float32 sqrt, over 60 binades."""
    rng = np.random.default_rng(4)
    x = (rng.random(1 << 18) + 0.5) * np.exp2(
        rng.integers(-30, 30, 1 << 18))
    x = np.concatenate([x.astype(np.float32),
                        np.array([0.0, 1.0, 2.0, 1e-38, 3.4e38], np.float32)])
    got = optimizers.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))


@pytest.mark.parametrize("cfg", ALL_OPTS + [FTRL_POW],
                         ids=lambda c: c["category"])
def test_config_round_trip_matches_jax(cfg):
    to = optimizers.make_optimizer(dict(cfg))
    jo = jax_opt.make_optimizer(dict(cfg))
    assert to.to_config() == jo.to_config()
    assert optimizers.make_optimizer(to.to_config()) == to
    assert to.category == jo.category and to.slot_shapes(9) == \
        jo.slot_shapes(9)
    assert [f.name for f in dataclasses.fields(to)] == [
        f.name for f in dataclasses.fields(jo)]


def test_make_optimizer_rejects_unknown_category():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.make_optimizer({"category": "lamb"})
    assert optimizers.Momentum() == optimizers.SGD(learning_rate=0.01,
                                                   momentum=0.9)


@pytest.mark.parametrize("cfg", ALL_OPTS, ids=lambda c: c["category"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_slots_match_jax(cfg, dtype):
    """Shapes and values as in the JAX package; float32 even for a
    bfloat16 table."""
    to = optimizers.make_optimizer(dict(cfg))
    jo = jax_opt.make_optimizer(dict(cfg))
    got = to.init_slots(7, 5, getattr(torch, dtype))
    want = jo.init_slots(7, 5, getattr(jnp, dtype))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
