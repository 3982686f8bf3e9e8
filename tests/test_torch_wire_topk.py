"""The sparse top-k payload of the ZeRO dense wire (`ops/wire.pack_topk`,
`unpack_topk`, `topk_wire_width`) against the JAX package's.

`pack_topk` is byte-equal to JAX's jitted `pack_topk` (the trainer runs it
inside a jitted step: XLA turns the codec's division by 127 into a
multiply by its reciprocal, as `test_torch_wire_int8.py` pins), and
`unpack_topk` bit-equal to JAX's, for k in (1, 8, 32, 40, 96) on rows of
96: k = 8 and 40 leave a partial codec block, k = 96 = m ships every
element. The rows plant the cases where the order decides the bytes: ties
in |x| (a value and its negation, repeated values, whole rows of equal
magnitude), rows with fewer nonzeros than k (zeros tie) and an all-zero
row. The values of a payload sit in `lax.top_k`'s order, descending |x|
with ties to the lower index, which the codec's scale blocks group by;
the index lanes are the int32 indices' little-endian bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.ops import wire as jax_wire
from openembedding_tpu_torch.ops import wire

M = 96
KS = (1, 8, 32, 40, 96)


def _rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, M)).astype(np.float32)
    x[0, 10], x[0, 50], x[0, 70] = -x[0, 3], x[0, 3], -x[0, 3]  # +-a ties
    x[1] = np.round(x[1] * 2) / 2                       # many repeats
    x[2, 5:] = 0                                        # 5 nonzeros < k
    x[3] = 0                                            # all zero
    x[4] = np.where(np.arange(M) % 2, 1.5, -1.5)        # one magnitude
    x[5, :40] = 0.25                                    # a tied prefix
    x[6] = np.float32(1e-30) * rng.standard_normal(M).astype(np.float32)
    x[7, ::3] = -0.0
    return x


_pack = jax.jit(jax_wire.pack_topk, static_argnums=1)
_unpack = jax.jit(jax_wire.unpack_topk, static_argnums=(1, 2))


@pytest.mark.parametrize("k", KS)
def test_pack_topk_is_byte_equal_to_jax(k):
    x = _rows()
    want = np.asarray(_pack(jnp.asarray(x), k))
    got = wire.pack_topk(torch.from_numpy(x.copy()), k)
    assert got.dtype == torch.int8
    assert got.shape == want.shape == (x.shape[0], wire.topk_wire_width(k))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", KS)
def test_unpack_topk_is_bit_equal_to_jax(k):
    x = _rows()
    enc = np.asarray(_pack(jnp.asarray(x), k))
    want = np.asarray(_unpack(jnp.asarray(enc), k, M))
    got = wire.unpack_topk(torch.from_numpy(enc.copy()), k, M)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # untransmitted elements are exact zeros, at most k nonzeros a row
    assert ((got != 0).sum(1) <= k).all()


@pytest.mark.parametrize("k", KS)
def test_topk_order_is_lax_top_k(k):
    x = _rows()
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    got = wire.topk_indices(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_wire_width():
    for k in (1, 8, 32, 40, 96, 160):
        assert wire.topk_wire_width(k) == jax_wire.topk_wire_width(k) \
            == wire.rows_wire_width(k, "int8") + 4 * k
    assert wire.topk_wire_width(32) == 164


def test_k_outside_the_row_is_refused():
    x = torch.zeros((2, 8))
    for k in (0, 9):
        with pytest.raises(ValueError, match=f"k={k} outside"):
            wire.pack_topk(x, k)
