"""The port's dedup, segment sums and fused sparse apply against the JAX
package's.

- `unique_with_counts` / `segment_reduce` against `openembedding_tpu.ops.dedup`
  (jitted): ids, counts, inverse, order and sums bit-exact. Both sort stably
  and sum each segment left to right in sorted order.
- `fused_sparse_apply` (on CPU tensors, so its plain version runs) against
  the JAX `pallas_sparse.fused_sparse_apply(..., interpret=True)`, the way
  `tests/test_pallas.py` runs it, for all of its `ALL_OPTS`. The interpreter
  runs jitted, and XLA:CPU contracts multiply-adds, so the bar is the
  jitted-rule tolerance of `test_torch_optimizers.py` (rtol 2e-6,
  atol 2e-6).
- `sparse_apply_dense_table` against the JAX function (its XLA path) with
  duplicates, -1 pads and out-of-range ids, at the same tolerance: the
  last row must not train, untouched rows stay bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu import optimizers as jax_opt
from openembedding_tpu.ops import dedup as jax_dedup
from openembedding_tpu.ops import pallas_sparse
from openembedding_tpu.ops.sparse import (
    sparse_apply_dense_table as jax_sparse_apply)
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.ops import apply, dedup, sparse

from test_torch_optimizers import ALL_OPTS, JIT_TOL


@pytest.fixture(autouse=True)
def _pallas_off():
    pallas_sparse.set_mode("off")
    yield
    pallas_sparse.set_mode("off")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", ["zipf", "all_equal", "all_distinct",
                                  "with_sentinels"])
def test_unique_and_segment_reduce_match_jax(case):
    rng = np.random.default_rng(0)
    n = 700
    if case == "zipf":
        ids = (rng.zipf(1.3, n) % 300).astype(np.int64)
    elif case == "all_equal":
        ids = np.full(n, 42, np.int64)
    elif case == "all_distinct":
        ids = rng.permutation(5 * n)[:n].astype(np.int64)
    else:  # the routed keys of _dedup_routed: n_rows as a sentinel
        ids = rng.integers(0, 50, n).astype(np.int64)
        ids[rng.random(n) < 0.3] = 50
    payload = rng.standard_normal((n, 9)).astype(np.float32)
    ints = rng.integers(0, 4, n).astype(np.int32)

    want = jax.jit(jax_dedup.unique_with_counts)(jnp.asarray(ids))
    got = dedup.unique_with_counts(torch.from_numpy(ids))
    for field in ("unique_ids", "inverse", "counts", "order", "seg"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.num_unique) == int(want.num_unique)
    assert got.counts.dtype == torch.int32

    sums = jax.jit(lambda u, p: u.segment_reduce(p))
    np.testing.assert_array_equal(
        _bits(got.segment_reduce(torch.from_numpy(payload)).numpy()),
        _bits(sums(want, jnp.asarray(payload))))
    np.testing.assert_array_equal(
        got.segment_reduce(torch.from_numpy(ints)).numpy(),
        np.asarray(sums(want, jnp.asarray(ints))))


def test_dedup_rejects_pair_ids():
    with pytest.raises(ValueError, match=r"\(n,\) ids"):
        dedup.unique_with_counts(torch.zeros((4, 2), dtype=torch.int64))


def _table(rng, n_rows, dim, cfg, dtype="float32"):
    """Both packages' table and slots, from one numpy draw (the slots
    moved off their initial values). The torch tensors own copies: the port
    updates in place, and `jnp.asarray` may share a numpy buffer."""
    w = rng.standard_normal((n_rows, dim)).astype(np.float32)
    jo = jax_opt.make_optimizer(dict(cfg))
    slots = {k: np.asarray(v) for k, v in jo.init_slots(n_rows, dim).items()}
    for k, v in slots.items():
        if k not in ("beta_1_t", "beta_2_t"):
            slots[k] = (v + 0.3 * np.abs(rng.standard_normal(v.shape))
                        ).astype(np.float32)
    tw = torch.from_numpy(w.copy()).to(getattr(torch, dtype))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    if dtype == "bfloat16":  # both from the same bits
        jw = jax.lax.bitcast_convert_type(
            jnp.asarray(tw.view(torch.int16).numpy()), jnp.bfloat16)
    return (tw, {k: torch.from_numpy(v.copy()) for k, v in slots.items()},
            jw, {k: jnp.asarray(v) for k, v in slots.items()})


def _assert_close(tw, ts, jw, js, tol):
    np.testing.assert_allclose(tw.float().numpy(),
                               np.asarray(jw, np.float32), **tol)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("cfg", ALL_OPTS, ids=lambda c: c["category"])
def test_fused_apply_matches_pallas_interpret(cfg):
    """Deduplicated rows as the fused apply receives them: unique where
    counts > 0, with count-0 padding and out-of-range rows mixed in."""
    rng = np.random.default_rng(3)
    n_rows, dim, n = 64, 12, 40
    tw, ts, jw, js = _table(rng, n_rows, dim, cfg)
    rows = rng.permutation(n_rows)[:n].astype(np.int64)
    rows[:3] = [n_rows, n_rows + 5, -1]
    counts = rng.integers(0, 3, n).astype(np.int32)
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    before_w, before_s = tw.clone(), {k: v.clone() for k, v in ts.items()}

    launches = apply.LAUNCHES["fused_sparse_apply"]
    out_w, out_s = apply.fused_sparse_apply(
        optimizers.make_optimizer(dict(cfg)), tw, ts, torch.from_numpy(rows),
        torch.from_numpy(grads), torch.from_numpy(counts))
    assert out_w is tw and out_s is ts  # in place
    assert apply.LAUNCHES["fused_sparse_apply"] == launches
    want_w, want_s = pallas_sparse.fused_sparse_apply(
        jax_opt.make_optimizer(dict(cfg)), jw, js, jnp.asarray(rows),
        jnp.asarray(grads), jnp.asarray(counts), interpret=True)
    _assert_close(tw, ts, want_w, want_s, JIT_TOL)

    touched = set(rows[(counts > 0) & (rows >= 0) & (rows < n_rows)])
    idle = np.array([r not in touched for r in range(n_rows)])
    np.testing.assert_array_equal(tw.numpy()[idle], before_w.numpy()[idle])
    for k in ts:
        np.testing.assert_array_equal(ts[k].numpy()[idle],
                                      before_s[k].numpy()[idle])


def test_fused_apply_bf16_table_rounds_like_jax():
    """bf16 weights: float32 update math, round-to-nearest-even store, f32
    slots (test_fused_apply_bf16_table)."""
    cfg = {"category": "adam", "learning_rate": 0.05}
    rng = np.random.default_rng(5)
    n_rows, dim, n = 48, 16, 24
    tw, ts, jw, js = _table(rng, n_rows, dim, cfg, "bfloat16")
    rows = rng.permutation(n_rows)[:n].astype(np.int64)
    counts = np.ones(n, np.int32)
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    apply.fused_sparse_apply(optimizers.make_optimizer(dict(cfg)), tw, ts,
                             torch.from_numpy(rows), torch.from_numpy(grads),
                             torch.from_numpy(counts))
    want_w, want_s = pallas_sparse.fused_sparse_apply(
        jax_opt.make_optimizer(dict(cfg)), jw, js, jnp.asarray(rows),
        jnp.asarray(grads), jnp.asarray(counts), interpret=True)
    assert tw.dtype == torch.bfloat16
    # one bf16 rounding of a float32 value within JIT_TOL of JAX's: the two
    # round to the same bf16 value unless it lies on a rounding boundary
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(want_w, np.float32))
    for k in want_s:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(want_s[k]),
                                   **JIT_TOL)


@pytest.mark.parametrize("cfg", [ALL_OPTS[2], ALL_OPTS[4], ALL_OPTS[8]],
                         ids=lambda c: c["category"])
@pytest.mark.parametrize("dim", [4, 9])
def test_sparse_apply_dense_table_matches_jax(cfg, dim):
    """Duplicates, -1 pads and out-of-range ids; the last row must not
    train from id -1."""
    rng = np.random.default_rng(dim)
    n_rows, n = 1000, 64
    tw, ts, jw, js = _table(rng, n_rows, dim, cfg)
    before = tw.clone()
    ids = rng.integers(0, n_rows, n).astype(np.int64)
    ids[:10] = ids[10:20]                      # duplicates
    ids[20:25] = -1                            # pads
    ids[25:28] = [n_rows, n_rows + 3, 1 << 40]  # out of range
    ids[ids == n_rows - 1] = 0
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    sparse.sparse_apply_dense_table(
        optimizers.make_optimizer(dict(cfg)), tw, ts, torch.from_numpy(ids),
        torch.from_numpy(grads))
    want_w, want_s = jax_sparse_apply(
        jax_opt.make_optimizer(dict(cfg)), jw, js, jnp.asarray(ids),
        jnp.asarray(grads))
    _assert_close(tw, ts, want_w, want_s, JIT_TOL)
    np.testing.assert_array_equal(tw[-1].numpy(), before[-1].numpy())
    idle = np.setdiff1d(np.arange(n_rows), ids)
    np.testing.assert_array_equal(tw.numpy()[idle], before.numpy()[idle])


def test_dedup_routed_matches_jax_bit_exact():
    """Routed rows, counts and summed grads, pre_counts included."""
    from openembedding_tpu.ops.sparse import _dedup_routed as jax_routed
    rng = np.random.default_rng(11)
    n_rows, n = 50, 300
    ids = rng.integers(-2, n_rows + 10, n).astype(np.int64)
    pre = rng.integers(0, 3, n).astype(np.int32)
    grads = rng.standard_normal((n, 6)).astype(np.float32)
    got = sparse._dedup_routed(n_rows, torch.from_numpy(ids),
                               torch.from_numpy(grads), torch.from_numpy(pre))
    want = jax.jit(jax_routed, static_argnums=0)(
        n_rows, jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(pre))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    idx = got[2].numpy()
    assert (np.diff(idx) > 0).all()  # ascending, duplicate-free
    assert ((got[1].numpy() > 0) == (idx < n_rows)).all()


@pytest.mark.parametrize("case", [
    "weights_1d", "weights_f64", "slot_missing", "slot_f64", "slot_shape",
    "rows_2d", "rows_int16", "grads_bf16", "counts_int64", "noncontiguous",
    "meta_device"])
def test_fused_apply_rejects_what_the_kernel_does_not_take(case):
    opt = optimizers.Adagrad()
    w = torch.randn(10, 4)
    slots = opt.init_slots(10, 4)
    rows = torch.tensor([1, 2, 3])
    grads = torch.randn(3, 4)
    counts = torch.ones(3, dtype=torch.int32)
    if case == "weights_1d":
        w = torch.randn(10)
    elif case == "weights_f64":
        w = w.double()
    elif case == "slot_missing":
        slots = {}
    elif case == "slot_f64":
        slots = {"accum": slots["accum"].double()}
    elif case == "slot_shape":
        slots = {"accum": torch.zeros(10, 5)}
    elif case == "rows_2d":
        rows = rows[None]
    elif case == "rows_int16":
        rows = rows.to(torch.int16)
    elif case == "grads_bf16":
        grads = grads.bfloat16()
    elif case == "counts_int64":
        counts = counts.long()
    elif case == "noncontiguous":
        w = torch.randn(4, 10).t()
    elif case == "meta_device":
        w = w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        apply.fused_sparse_apply(opt, w, slots, rows, grads, counts)
