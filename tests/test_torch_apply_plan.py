"""The fused apply's launch plan (`ops/apply.launch_plan`), and the plain
path on the array views that change it, against the JAX package.

`launch_plan` mirrors on the host how `csrc/fused_sparse_apply.cu` picks a
launch's word (E = 4, 2 or 1 elements: the most that divides the width and,
in bytes, the address and row stride of the weights, of each wide slot and
of the gradients), how many words of each array a lane loads in a round,
and how many slots a warp's tile holds. `chip_smoke.py` holds the mirror
against the built kernel's `oe_fused_sparse_apply_plan` on the card; here
the cases are the shapes the kernel must get right: width 10 (8-byte
words), 64 and 128 (16-byte words), 9 and 11 (4-byte words), a bfloat16
table, the packed weights+slots layout, column views 4 and 8 bytes off a
16-byte boundary, and `w[1:]`.

The views then go through `fused_sparse_apply` on CPU tensors (its plain
version) and through the JAX `pallas_sparse.fused_sparse_apply(...,
interpret=True)` on the same numbers in arrays of their own: the view must
not change the update, and columns between the views stay untouched.
Tolerance as in `tests/test_torch_apply.py` (the jitted-rule `JIT_TOL`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu import optimizers as jax_opt
from openembedding_tpu.ops import pallas_sparse
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.ops import apply, sparse

from test_torch_optimizers import JIT_TOL


def _plan(opt, w, slots, g):
    return apply.launch_plan(opt.rule, w.shape[1],
                             apply.plan_arrays(opt, w, slots, g))


def _split(opt, n_rows, dim, dtype=torch.float32, n=8):
    w = torch.zeros((n_rows, dim), dtype=dtype)
    return w, opt.init_slots(n_rows, dim), torch.zeros((n, dim))


@pytest.mark.parametrize("dim,e,unroll,tile", [
    (10, 2, 5, 32),   # the flagship: 8-byte words, 5 a lane, 32 rows
    (64, 4, 2, 4),    # 16-byte words
    (128, 4, 2, 2),
    (16, 4, 2, 16),
    (9, 1, 8, 28),    # 4-byte words
    (11, 1, 8, 23),
    (1, 1, 8, 32),
])
def test_plan_of_split_float32_adagrad(dim, e, unroll, tile):
    opt = optimizers.Adagrad()
    assert _plan(opt, *_split(opt, 100, dim)) == (e, unroll, tile)


@pytest.mark.parametrize("name,e,unroll,tile", [
    ("default", 2, 7, 32),   # gradient and weights only
    ("sgd", 2, 5, 32),
    ("adagrad", 2, 5, 32),
    ("adadelta", 2, 3, 19),  # two wide slots: fewer words a round
    ("adam", 2, 3, 19),      # beta powers are per-row state, not words
    ("adamax", 2, 3, 19),
    ("ftrl", 2, 3, 19),
    ("rmsprop", 2, 3, 19),
    ("test", 2, 7, 32),      # flip_state is per-row state
])
def test_plan_follows_the_rules_wide_slots(name, e, unroll, tile):
    opt = optimizers.make_optimizer({"category": name})
    assert _plan(opt, *_split(opt, 100, 10)) == (e, unroll, tile)


@pytest.mark.parametrize("dim,e", [(10, 2), (16, 4), (9, 1), (64, 4)])
def test_plan_of_a_bfloat16_table_counts_its_two_byte_elements(dim, e):
    """The weights move in E-element words of 2E bytes, the slots and
    gradients in words of 4E bytes: at width 10, 4-byte and 8-byte words."""
    opt = optimizers.Adagrad()
    w, slots, g = _split(opt, 100, dim, torch.bfloat16)
    assert _plan(opt, w, slots, g).word_elems == e
    # a bfloat16 view 2 bytes off a word boundary moves in 2-byte words
    wide = torch.zeros((100, dim + 4), dtype=torch.bfloat16)
    assert _plan(opt, wide[:, 1:1 + dim], slots, g).word_elems == 1


@pytest.mark.parametrize("dim,e", [(10, 2), (64, 4), (9, 1)])
def test_plan_of_the_packed_layout(dim, e):
    """`sparse.pack_table`'s column views: the slot starts dim * 4 bytes
    into each row, the row stride is dim + width."""
    opt = optimizers.Adagrad()
    w, slots, g = _split(opt, 100, dim)
    lay = (("accum", dim),)
    packed = sparse.pack_table(w, slots, lay)
    pw, ps = sparse.unpack_table(packed, lay, dim, torch.float32)
    assert ps["accum"].data_ptr() - pw.data_ptr() == dim * 4
    assert _plan(opt, pw, ps, g).word_elems == e


def _offset_views(arr, dim, offsets):
    """Column views of `arr`: the weights at column 0, then one slot at each
    of `offsets` (columns)."""
    return arr[:, :dim], [arr[:, o:o + dim] for o in offsets]


@pytest.mark.parametrize("offsets,e", [
    ((17, 34), 1),   # slot columns 68 and 136 bytes in: 4 and 8 bytes off
    ((18, 36), 2),   # 72 and 144 bytes in: 8 bytes off, then aligned
    ((20, 36), 4),   # 80 and 144 bytes in: both 16-byte aligned
])
def test_plan_of_slot_views_off_a_16_byte_boundary(offsets, e):
    opt = optimizers.RMSprop()
    dim = 16
    arr = torch.zeros((50, 52))  # row stride 208 bytes: a multiple of 16
    assert arr.data_ptr() % 16 == 0
    w, (s0, s1) = _offset_views(arr, dim, offsets)
    g = torch.zeros((8, dim))
    plan = _plan(opt, w, {"accum": s0, "moment": s1}, g)
    assert plan.word_elems == e


@pytest.mark.parametrize("dim,e", [(10, 2), (16, 4), (18, 2), (12, 4)])
def test_plan_of_a_table_view_w1(dim, e):
    """`w[1:]` starts one row (dim * 4 bytes) into the table: 8-byte
    aligned at widths 10 and 18, 16-byte aligned at 12 and 16."""
    opt = optimizers.Adagrad()
    w, slots, g = _split(opt, 100, dim)
    assert _plan(opt, w[1:], {"accum": slots["accum"][1:]}, g).word_elems == e


def test_plan_of_raw_addresses_and_strides():
    """The rule in numbers: every address and stride must allow the word."""
    adagrad = 2
    f32 = lambda addr, stride: (addr, stride, 4)
    assert apply.launch_plan(adagrad, 64, [f32(0, 64), f32(256, 64),
                                           f32(512, 64)]).word_elems == 4
    assert apply.launch_plan(adagrad, 64, [f32(0, 64), f32(264, 64),
                                           f32(512, 64)]).word_elems == 2
    assert apply.launch_plan(adagrad, 64, [f32(0, 64), f32(256, 66),
                                           f32(512, 64)]).word_elems == 2
    assert apply.launch_plan(adagrad, 64, [f32(0, 64), f32(256, 64),
                                           f32(516, 64)]).word_elems == 1
    assert apply.launch_plan(adagrad, 64, [f32(0, 64), f32(256, 64),
                                           f32(512, 65)]).word_elems == 1
    # bfloat16 weights: 4 elements are 8 bytes
    assert apply.launch_plan(adagrad, 64, [(8, 64, 2), f32(256, 64),
                                           f32(512, 64)]).word_elems == 4
    # rows wider than a round: one slot a tile
    assert apply.launch_plan(adagrad, 1024, [f32(0, 1024)] * 3) == (4, 2, 1)


def _jax_table(rng, n_rows, dim, cfg):
    w = rng.standard_normal((n_rows, dim)).astype(np.float32)
    jo = jax_opt.make_optimizer(dict(cfg))
    slots = {k: (np.asarray(v) + 0.3 * np.abs(rng.standard_normal(v.shape))
                 ).astype(np.float32)
             for k, v in jo.init_slots(n_rows, dim).items()}
    return w, slots


@pytest.mark.parametrize("offsets", [(17, 34), (18, 36)],
                         ids=["4_bytes_off", "8_bytes_off"])
def test_apply_on_packed_column_views_matches_jax(offsets):
    """RMSprop on weight and slot columns of one array, slots 4 or 8
    bytes off a 16-byte boundary, against the JAX kernel (interpret mode)
    on arrays of their own; the columns between the views keep their
    values."""
    cfg = {"category": "rmsprop", "learning_rate": 0.05, "momentum": 0.5}
    rng = np.random.default_rng(sum(offsets))
    n_rows, dim, n = 64, 16, 40
    w, slots = _jax_table(rng, n_rows, dim, cfg)
    arr = torch.from_numpy(rng.standard_normal((n_rows, 52)).astype(
        np.float32))
    tw, (s0, s1) = _offset_views(arr, dim, offsets)
    tw.copy_(torch.from_numpy(w))
    s0.copy_(torch.from_numpy(slots["accum"]))
    s1.copy_(torch.from_numpy(slots["moment"]))
    before = arr.clone()
    rows = rng.permutation(n_rows)[:n].astype(np.int64)
    rows[:2] = [n_rows + 1, -1]
    counts = rng.integers(0, 3, n).astype(np.int32)
    grads = rng.standard_normal((n, dim)).astype(np.float32)

    ts = {"accum": s0, "moment": s1}
    apply.fused_sparse_apply(optimizers.make_optimizer(dict(cfg)), tw, ts,
                             torch.from_numpy(rows), torch.from_numpy(grads),
                             torch.from_numpy(counts))
    want_w, want_s = pallas_sparse.fused_sparse_apply(
        jax_opt.make_optimizer(dict(cfg)), jnp.asarray(w),
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(rows),
        jnp.asarray(grads), jnp.asarray(counts), interpret=True)
    np.testing.assert_allclose(tw.numpy(), np.asarray(want_w), **JIT_TOL)
    for k in want_s:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(want_s[k]),
                                   err_msg=k, **JIT_TOL)
    # the columns no view covers
    cols = np.ones(52, bool)
    for o in (0, *offsets):
        cols[o:o + dim] = False
    np.testing.assert_array_equal(arr.numpy()[:, cols],
                                  before.numpy()[:, cols])
