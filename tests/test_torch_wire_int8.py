"""The port's int8 wire (`ops/wire.py`) against the JAX package's.

- The codec, rounding to nearest: `pack_inband` / `unpack_inband` and
  `encode_grads` / `decode_grads` bit-exact against the JAX functions as a
  compiled step runs them (`jax.jit`), at dims 1, 9, 10, 32, 33 and 64,
  with zero rows and all-zero blocks. XLA turns the division of the block's
  max by 127 into a multiply by the float32 reciprocal; the port does the
  same, so the JAX functions run eagerly (which divide) are not the
  reference here. The numpy codec is bit-exact against the JAX package's
  numpy codec (both divide).
- The dither of stochastic rounding: bit-exact.
- Stochastic codes: measured 0 codes one apart from the compiled JAX
  function over these inputs (XLA:CPU may contract `x * inv + dither`
  into a fused multiply-add, which could move a code at a floor boundary
  by one; it does not here). Pinned at 0.
- The cost models `exchange_cost` and `hot_reduce_cost`: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.ops import wire as jax_wire
from openembedding_tpu_torch.ops import wire

DIMS = [1, 9, 10, 32, 33, 64]


def _rows(seed, dim, n=97):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, dim)) * 10.0 ** rng.integers(-6, 6, (n, 1))
         ).astype(np.float32)
    x[3] = 0.0                      # a zero row
    x[5, :min(dim, 32)] = 0.0       # a zero block
    x[7, 0] = -0.0
    return x


def _jit_pack(x, stochastic=False):
    return np.asarray(jax.jit(lambda v: jax_wire.pack_inband(
        v, "int8", stochastic=stochastic))(jnp.asarray(x)))


@pytest.mark.parametrize("dim", DIMS)
def test_round_to_nearest_codec_is_bit_exact(dim):
    x = _rows(dim, dim)
    enc = wire.pack_inband(torch.tensor(x), "int8")
    want = _jit_pack(x)
    assert enc.dtype == torch.int8 == wire.wire_carrier_dtype("int8")
    assert enc.shape == (x.shape[0], wire.rows_wire_width(dim, "int8")) \
        == want.shape
    np.testing.assert_array_equal(enc.numpy(), want)
    dec = wire.unpack_inband(enc, dim, "int8").numpy()
    jdec = np.asarray(jax.jit(lambda w: jax_wire.unpack_inband(
        w, dim, "int8"))(jnp.asarray(want)))
    np.testing.assert_array_equal(dec.view(np.uint32), jdec.view(np.uint32))
    # zero rows and blocks carry scale 0 and decode to zeros
    assert not dec[3].any() and not dec[5, :min(dim, 32)].any()
    np.testing.assert_array_equal(wire.np_encode_rows(x, "int8"),
                                  jax_wire.np_encode_rows(x, "int8"))
    np.testing.assert_array_equal(
        wire.np_decode_rows(want, dim, "int8").view(np.uint32),
        jax_wire.np_decode_rows(want, dim, "int8").view(np.uint32))


@pytest.mark.parametrize("dim", DIMS)
def test_grad_payloads_are_bit_exact(dim):
    g = _rows(100 + dim, dim)
    counts = np.arange(g.shape[0], dtype=np.int32) * 40503
    for stochastic in (False, True):
        enc = wire.encode_grads(torch.tensor(g), torch.tensor(counts),
                                "int8", stochastic=stochastic)
        want = np.asarray(jax.jit(lambda a, c: jax_wire.encode_grads(
            a, c, "int8", stochastic=stochastic))(jnp.asarray(g),
                                                  jnp.asarray(counts)))
        assert enc.shape[1] == wire.grads_wire_width(dim, "int8") \
            == jax_wire.grads_wire_width(dim, "int8")
        np.testing.assert_array_equal(enc.numpy(), want)
        rg, rc = wire.decode_grads(enc, dim, "int8")
        jg, jc = jax_wire.decode_grads(jnp.asarray(want), dim, "int8")
        np.testing.assert_array_equal(rg.numpy().view(np.uint32),
                                      np.asarray(jg).view(np.uint32))
        np.testing.assert_array_equal(rc.numpy(), counts)


def test_dither_is_bit_exact():
    x = np.concatenate([_rows(1, 32), _rows(2, 32) * 1e30,
                        np.array([[np.inf, -np.inf, np.nan] + [0.0] * 29],
                                 np.float32)])
    got = wire._dither(torch.tensor(x)).numpy()
    want = np.asarray(jax_wire._dither(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("dim", [10, 33])
def test_stochastic_codes_match_with_the_pinned_off_by_one_count(dim):
    x = _rows(7 + dim, dim, n=2000)
    got = wire.pack_inband(torch.tensor(x), "int8", stochastic=True).numpy()
    want = _jit_pack(x, stochastic=True)
    codes = np.abs(got[:, :dim].astype(np.int32)
                   - want[:, :dim].astype(np.int32))
    assert codes.max() <= 1
    assert int((codes == 1).sum()) == 0  # measured
    np.testing.assert_array_equal(got[:, dim:], want[:, dim:])  # scales


def test_empty_slots_decode_to_zero_grads_and_counts():
    z = torch.zeros((3, wire.grads_wire_width(10, "int8")), dtype=torch.int8)
    g, c = wire.decode_grads(z, 10, "int8")
    assert not g.any() and not c.any()
    assert wire.count_lanes("int8") == jax_wire.count_lanes("int8") == 4


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_cost_models_equal_the_jax_package(fmt, S):
    tables = [{"dim": 10, "cap": 512, "pair": False, "id_itemsize": 8},
              {"dim": 10, "cap": 64, "pair": False, "id_itemsize": 4},
              {"dim": 33, "cap": 100, "pair": True, "id_itemsize": 8,
               "fmt": "int8"}]
    for fused in (True, False):
        assert wire.exchange_cost(tables, S, fmt, fused) \
            == jax_wire.exchange_cost(tables, S, fmt, fused)
    hot = [{"dim": 10, "hot": 1024}, {"dim": 33, "hot": 7}]
    assert wire.hot_reduce_cost(hot, S, fmt) \
        == jax_wire.hot_reduce_cost(hot, S, fmt)
