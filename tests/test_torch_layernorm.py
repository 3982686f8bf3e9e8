"""The port's `layers.LayerNorm` against flax 0.12's `nn.LayerNorm`.

flax's defaults are not torch's: epsilon 1e-6 (torch 1e-5), the variance
as E[x^2] - E[x]^2 clamped at 0 (torch two-pass), float32 statistics and
normalization whatever the input dtype, the output cast to `dtype`. Same
inputs from a seed, the flax params (scale, bias) loaded into the port's
layer. Tolerances: float32 output within 2e-6 absolute for centred
inputs (a reduction's order of adds); for inputs at mean 40 and std 3 the
fast variance cancels (E[x^2] ~ 1600 against a variance of 9: one ulp of
the sum moves the variance by 1.3e-5 relative), held to 4e-4; bfloat16
output within
one bfloat16 ulp of the flax value (the same float32 value a few ulps
apart can round to neighbouring bfloat16 values); measured 0 and 1 ulp.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu_torch.layers import LayerNorm, materialize

SHAPES = [(4, 16), (3, 5, 50), (2, 7, 64)]


def _inputs(shape, seed, offset):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0 + offset).astype(np.float32)
    scale = rng.normal(1.0, 0.2, size=shape[-1]).astype(np.float32)
    bias = rng.normal(0.0, 0.2, size=shape[-1]).astype(np.float32)
    return x, scale, bias


def _flax(x, scale, bias, dtype):
    ln = fnn.LayerNorm(dtype=dtype)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    return np.asarray(ln.apply(params, jnp.asarray(x).astype(dtype))
                      .astype(jnp.float32))


def _port(x, scale, bias, dtype):
    ln = LayerNorm(dtype)
    ln.set_parameters(torch.tensor(scale), torch.tensor(bias))
    return ln(torch.tensor(x).to(dtype)).detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset,atol", [(0.0, 2e-6), (40.0, 4e-4)])
def test_float32_matches_flax(shape, offset, atol):
    x, scale, bias = _inputs(shape, 0, offset)
    want = _flax(x, scale, bias, jnp.float32)
    got = _port(x, scale, bias, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_within_one_ulp(shape):
    x, scale, bias = _inputs(shape, 1, 0.5)
    want = _flax(x, scale, bias, jnp.bfloat16)
    got = _port(x, scale, bias, torch.bfloat16)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
    # most elements are equal, bit for bit
    assert np.mean(got == want) > 0.9


def test_flax_defaults_not_torch_layer_norm():
    """A constant row: variance 0, the output is the bias (flax's eps 1e-6
    and the fast variance clamp); and the formula is not torch's."""
    x = np.full((2, 8), 3.25, np.float32)
    scale = np.ones(8, np.float32)
    bias = np.linspace(-1, 1, 8).astype(np.float32)
    np.testing.assert_array_equal(_port(x, scale, bias, torch.float32),
                                  _flax(x, scale, bias, jnp.float32))
    xr, s, b = _inputs((4, 16), 2, 0.0)
    torch_ln = torch.nn.functional.layer_norm(
        torch.tensor(xr), (16,), torch.tensor(s), torch.tensor(b))
    assert not np.array_equal(torch_ln.numpy(),
                              _port(xr, s, b, torch.float32))


def test_materialize_makes_ones_and_zeros():
    ln = LayerNorm(torch.float32)
    materialize(ln, torch.zeros((2, 6)), generator=torch.Generator())
    np.testing.assert_array_equal(ln.weight.detach().numpy(), np.ones(6))
    np.testing.assert_array_equal(ln.bias.detach().numpy(), np.zeros(6))
    fresh = LayerNorm(torch.float32)
    with pytest.raises(RuntimeError, match="no parameters"):
        fresh(torch.zeros((2, 6)))
    flax_params = fnn.LayerNorm().init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 6)))["params"]
    np.testing.assert_array_equal(np.asarray(flax_params["scale"]),
                                  np.ones(6))
