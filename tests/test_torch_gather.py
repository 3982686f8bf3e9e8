"""The port's row gather against the JAX package's, bit for bit.

The same numpy inputs go through `openembedding_tpu_torch.ops.gather.gather_rows`
(on CPU tensors, so its plain version runs) and through the JAX package's
Pallas `gather_rows` in interpret mode and its XLA `lookup_rows`. The gather
is a copy, so every case must be bit-equal (bfloat16 compared as int16 bits).
The cases mirror `tests/test_pallas.py`'s gather tests across the widths,
table dtypes and id dtypes the port takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu.ops import pallas_sparse
from openembedding_tpu.ops.sparse import _dedup_routed as jax_dedup_routed
from openembedding_tpu.ops.sparse import lookup_rows as jax_lookup_rows
from openembedding_tpu_torch.ops import gather
from openembedding_tpu_torch.ops.sparse import _dedup_routed, lookup_rows

DTYPES = {"float32": (torch.float32, jnp.float32, np.int32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, np.int16)}
ID_DTYPES = {"int32": (torch.int32, np.int32),
             "int64": (torch.int64, np.int64)}


def _tables(rng, n_rows, dim, dtype):
    """The same table for both frameworks, bfloat16 built from shared bits."""
    tdt, jdt, _ = DTYPES[dtype]
    w = torch.from_numpy(rng.standard_normal((n_rows, dim)).astype(
        np.float32)).to(tdt)
    if dtype == "bfloat16":
        bits = w.view(torch.int16).numpy()
        jw = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    else:
        jw = jnp.asarray(w.numpy())
    return w, jw


def _bits_torch(t):
    return t.view(torch.int32 if t.dtype == torch.float32
                  else torch.int16).numpy()


def _bits_jax(a, dtype):
    a = np.asarray(a)
    return a.view(DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dim", [9, 10, 12, 64])
def test_gather_matches_pallas_and_xla(dim, id_dtype, dtype):
    """Ids out of range at both ends (test_gather_rows_matches_xla)."""
    rng = np.random.default_rng(dim)
    w, jw = _tables(rng, 64, dim, dtype)
    ids = rng.integers(-5, 80, size=50).astype(ID_DTYPES[id_dtype][1])
    got = gather.gather_rows(w, torch.from_numpy(ids))
    pallas = pallas_sparse.gather_rows(jw, jnp.asarray(ids), interpret=True)
    xla = jax_lookup_rows(jw, jnp.asarray(ids))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(pallas, dtype))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(xla, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8])
def test_gather_valid_mask(mask_dtype, dtype):
    """test_gather_rows_valid_mask, with both mask dtypes the kernel takes."""
    rng = np.random.default_rng(1)
    w, jw = _tables(rng, 32, 8, dtype)
    ids = rng.integers(0, 32, size=20).astype(np.int32)
    valid = rng.integers(0, 2, size=20).astype(bool)
    got = gather.gather_rows(w, torch.from_numpy(ids),
                             torch.from_numpy(valid).to(mask_dtype))
    pallas = pallas_sparse.gather_rows(jw, jnp.asarray(ids),
                                       jnp.asarray(valid), interpret=True)
    xla = jax_lookup_rows(jw, jnp.asarray(ids), jnp.asarray(valid))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(pallas, dtype))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(xla, dtype))
    assert not got.float()[~valid].any()


@pytest.mark.parametrize("n", [1, 37, 256, 300])
def test_gather_non_divisible_block(n):
    """test_gather_rows_non_divisible_block: n not a multiple of the
    Pallas block (dim 9, the reference benchmark width)."""
    rng = np.random.default_rng(2)
    w, jw = _tables(rng, 300, 9, "float32")
    ids = rng.integers(0, 300, size=n).astype(np.int32)
    got = gather.gather_rows(w, torch.from_numpy(ids))
    pallas = pallas_sparse.gather_rows(jw, jnp.asarray(ids), block=16,
                                       interpret=True)
    np.testing.assert_array_equal(_bits_torch(got),
                                  _bits_jax(pallas, "float32"))


def test_gather_int64_ids_past_int32():
    """int64 ids of 2^31 and beyond are out of range, never wrapped (the
    Pallas kernel casts ids to int32, so XLA's lookup is the oracle)."""
    rng = np.random.default_rng(3)
    w, jw = _tables(rng, 40, 10, "float32")
    ids = np.array([0, 39, 40, -1, 1 << 31, (1 << 32) + 3, 1 << 40,
                    -(1 << 40), 7], np.int64)
    got = gather.gather_rows(w, torch.from_numpy(ids))
    xla = jax_lookup_rows(jw, jnp.asarray(ids))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(xla, "float32"))
    assert not got[2:8].any() and got[[0, 1, 8]].any()


def test_gather_keeps_signed_zero_and_nan_bits():
    """A copy, not arithmetic: -0.0 and NaN payload rows survive bitwise."""
    w = torch.tensor([[-0.0, 1.0], [float("nan"), -2.5]])
    got = gather.gather_rows(w, torch.tensor([0, 1, 5]))
    np.testing.assert_array_equal(_bits_torch(got[:2]), _bits_torch(w))
    assert _bits_torch(got[2]).tolist() == [0, 0]  # +0.0, not -0.0


def test_lookup_rows_any_id_shape_matches_jax():
    rng = np.random.default_rng(4)
    w, jw = _tables(rng, 50, 10, "float32")
    ids = rng.integers(-3, 60, size=(6, 26)).astype(np.int64)
    got = lookup_rows(w, torch.from_numpy(ids))
    want = jax_lookup_rows(jw, jnp.asarray(ids))
    assert tuple(got.shape) == (6, 26, 10)
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want,
                                                              "float32"))


def test_gather_of_routed_training_rows_matches_jax():
    """The training side: rows routed by `_dedup_routed`, whose invalid
    unique slots i carry the distinct out-of-range rows n_rows + i; those
    must gather zero rows, the valid ones their table rows."""
    rng = np.random.default_rng(5)
    n_rows, n = 40, 120
    w, jw = _tables(rng, n_rows, 10, "float32")
    ids = rng.integers(-1, n_rows + 6, n).astype(np.int64)
    grads = np.zeros((n, 10), np.float32)
    _, counts, idx = _dedup_routed(n_rows, torch.from_numpy(ids),
                                   torch.from_numpy(grads), None)
    _, _, jidx = jax_dedup_routed(n_rows, jnp.asarray(ids),
                                  jnp.asarray(grads), None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    invalid = idx >= n_rows
    assert invalid.any() and (idx[invalid] >= n_rows).all()
    got = gather.gather_rows(w, idx)
    want = jax_lookup_rows(jw, jidx, sorted_unique=True)
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want,
                                                              "float32"))
    assert not got[invalid].any()
    np.testing.assert_array_equal(got[~invalid].numpy(),
                                  w[idx[~invalid]].numpy())


def test_gather_cpu_runs_plain_version_and_counts_no_launch():
    before = gather.LAUNCHES["gather_rows"]
    w = torch.randn(10, 4)
    ids = torch.tensor([3, -1, 11])
    out = gather.gather_rows(w, ids)
    assert gather.LAUNCHES["gather_rows"] == before
    torch.testing.assert_close(out, gather.gather_rows_reference(w, ids),
                               rtol=0, atol=0)
    empty = gather.gather_rows(torch.zeros((0, 4)), ids)
    assert tuple(empty.shape) == (3, 4) and not empty.any()


@pytest.mark.parametrize("case", [
    "weights_3d", "weights_f64", "ids_2d", "ids_int16", "mask_shape",
    "mask_float", "noncontiguous", "meta_device"])
def test_gather_rejects_what_the_kernel_does_not_take(case):
    w = torch.randn(10, 4)
    ids = torch.tensor([1, 2, 3])
    valid = None
    if case == "weights_3d":
        w = torch.randn(2, 10, 4)
    elif case == "weights_f64":
        w = w.double()
    elif case == "ids_2d":
        ids = ids[None]
    elif case == "ids_int16":
        ids = ids.to(torch.int16)
    elif case == "mask_shape":
        valid = torch.ones(4, dtype=torch.bool)
    elif case == "mask_float":
        valid = torch.ones(3)
    elif case == "noncontiguous":
        w = torch.randn(4, 10).t()
    elif case == "meta_device":
        w, ids = w.to("meta"), ids.to("meta")
    with pytest.raises((TypeError, ValueError)):
        gather.gather_rows(w, ids, valid)
