"""The port's ZeRO flat layout (`parallel/zero.py`) against the JAX
package's, on the same params.

A DeepFM tower (hidden (16, 8), float32) initialized by the JAX package,
plus a sparse_as_dense table under `__embeddings__` (so its place in the
flatten order is covered), carried into the port's module with
`convert.dense_from_flax` (the kernels transposed to the port's (out, in)
weights). Against JAX's `zero.py` on the JAX tree:

- the plan's `total`, `chunk`, `padded`, `offsets`, `sizes` and slot
  classes, for S in (2, 3, 4) and `align` 1 and 32;
- `flatten_tree` bit-equal (the flax layout, the padding zero) and
  `unflatten_tree` back to the port's tensors bit-equal;
- `shard_slots` of per-leaf Adam slots (seeded, equal scalar slots)
  bit-equal to JAX's, and `unshard_slots` back to the port's per-leaf
  slots byte-identical;
- `dense_wire_cost` for each format (equal dicts), `plan_device_bytes`
  and `params_device_bytes`;
- the scalar-slot guard and the refusal of a 64-bit leaf, with JAX's
  messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import zero as jax_zero
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.convert import (dense_from_flax,
                                             dense_slots_from_flax)
from openembedding_tpu_torch.layers import unmaterialized_copy
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import zero

from test_torch_mesh_train import _batches

SAD = (40, 3)  # the sparse_as_dense table's shape


@pytest.fixture(scope="module")
def params():
    """(the JAX trainable tree, the port's module, its embeddings)."""
    model = jax_make_deepfm(1000, 9, hidden=(16, 8),
                            compute_dtype=jnp.float32)
    state = jax_embed.Trainer(model, jax_embed.Adam(learning_rate=0.01)) \
        .init(_batches(False)[0])
    rng = np.random.default_rng(3)
    tree = dict(jax.tree_util.tree_map(np.asarray, state.dense_params))
    sad = rng.standard_normal(SAD).astype(np.float32)
    tree["__embeddings__"] = {"cat": sad}
    module = unmaterialized_copy(make_deepfm(
        1000, 9, hidden=(16, 8), compute_dtype=torch.float32).module)
    dense_from_flax(_flatten_params(tree), module)
    return tree, module, {"cat": torch.tensor(sad)}


def _leaves(params):
    _, module, emb = params
    return zero.trainable_leaves(module, emb)


def test_leaf_order_is_jax_flatten_order(params):
    tree, _, _ = params
    paths = ["/".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [leaf.name for leaf, _ in _leaves(params)] == paths
    assert "__embeddings__/cat" in paths


@pytest.mark.parametrize("num_shards", [2, 3, 4])
@pytest.mark.parametrize("align", [1, 32])
def test_plan_matches_jax(params, num_shards, align):
    tree = params[0]
    opt = optimizers.Adam(learning_rate=0.01)
    want = jax_zero.build_plan(tree, jax_embed.Adam(learning_rate=0.01),
                               num_shards, align=align)
    got = zero.build_plan(_leaves(params), opt, num_shards, align=align)
    for field in ("total", "chunk", "padded", "offsets", "sizes",
                  "num_shards", "vector_slots", "scalar_slots", "slot_init"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.shapes == want.shapes


def test_flatten_is_bit_equal_to_jax(params):
    tree = params[0]
    opt = optimizers.Adagrad(learning_rate=0.1)
    want_plan = jax_zero.build_plan(tree, jax_embed.Adagrad(0.1), 4,
                                    align=32)
    plan = zero.build_plan(_leaves(params), opt, 4, align=32)
    want = np.asarray(jax_zero.flatten_tree(want_plan, tree))
    tensors = {leaf.key: t for leaf, t in _leaves(params)}
    got = zero.flatten_tree(plan, tensors)
    assert got.dtype == torch.float32 and got.shape == (plan.padded,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert not got[plan.total:].any()
    back = zero.unflatten_tree(plan, got)
    for key, t in tensors.items():
        assert back[key].shape == t.shape
        assert torch.equal(back[key], t), key


def _jax_leaf_slots(tree, opt, rng):
    """Seeded per-leaf slots, as the JAX package lays them out: vector
    slots (1, size) in the flax layout, scalar slots (1, 1) equal on every
    leaf."""
    scalars = {n: np.float32(rng.random()) for n, w in
               opt.slot_shapes(2).items() if w == 1}

    def leaf_slots(p):
        return {n: (np.full((1, 1), scalars[n], np.float32) if w == 1 else
                    rng.standard_normal((1, p.size)).astype(np.float32))
                for n, w in opt.slot_shapes(2).items()}
    return jax.tree_util.tree_map(leaf_slots, tree)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_shard_unshard_slots_match_jax(params, num_shards):
    tree, module, _ = params
    jopt = jax_embed.Adam(learning_rate=0.01)
    opt = optimizers.Adam(learning_rate=0.01)
    jslots = _jax_leaf_slots(tree, jopt, np.random.default_rng(7))
    want_plan = jax_zero.build_plan(tree, jopt, num_shards, align=32)
    want = jax_zero.shard_slots(want_plan, jslots)
    plan = zero.build_plan(_leaves(params), opt, num_shards, align=32)
    # the port's per-leaf slots: the same rows, kernels' in the port's
    # (out, in) layout
    slots = dense_slots_from_flax(_flatten_params(jslots), module,
                                  device="cpu")
    slots.update({f"__embeddings__/{n}": {
        k: torch.tensor(np.asarray(v)) for k, v in d.items()}
        for n, d in jslots["__embeddings__"].items()})
    zero.check_scalar_slots_equal(plan, slots)
    got = zero.shard_slots(plan, slots)
    assert set(got) == set(want)
    for name, v in want.items():
        v = np.asarray(v)
        assert tuple(got[name].shape) == v.shape, name
        np.testing.assert_array_equal(got[name].numpy().view(np.int32),
                                      v.view(np.int32), err_msg=name)
    back = zero.unshard_slots(plan, got)
    assert set(back) == set(slots)
    for key, d in slots.items():
        for name, v in d.items():
            assert back[key][name].numpy().tobytes() == v.numpy().tobytes()


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_wire_costs_and_bytes_match_jax(params, num_shards):
    tree = params[0]
    for align in (1, 32):
        want_plan = jax_zero.build_plan(tree, jax_embed.Adam(0.01),
                                        num_shards, align=align)
        plan = zero.build_plan(_leaves(params), optimizers.Adam(0.01),
                               num_shards, align=align)
        for fmt in (None, "fp32", "bf16", "int8"):
            assert zero.dense_wire_cost(plan, fmt) == \
                jax_zero.dense_wire_cost(want_plan, fmt), fmt
        for k in (1, 32, 160):
            assert zero.dense_wire_cost(plan, "sparse_topk", topk=k) == \
                jax_zero.dense_wire_cost(want_plan, "sparse_topk", topk=k)
        for ef in (False, True):
            for master in (False, True):
                assert zero.plan_device_bytes(plan, ef=ef, master=master) \
                    == jax_zero.plan_device_bytes(want_plan, ef=ef,
                                                  master=master)
        assert zero.params_device_bytes(plan) == \
            jax_zero.params_device_bytes(want_plan)
    if num_shards > 1:
        with pytest.raises(ValueError, match="topk"):
            zero.dense_wire_cost(plan, "sparse_topk")


def test_scalar_slot_guard_and_wide_leaves(params):
    opt = optimizers.Adam(learning_rate=0.01)
    leaves = _leaves(params)
    plan = zero.build_plan(leaves, opt, 2)
    slots = {leaf.key: opt.init_slots(1, t.numel()) for leaf, t in leaves}
    zero.check_scalar_slots_equal(plan, slots)
    slots[leaves[-1][0].key]["beta_2_t"].fill_(2.0)
    with pytest.raises(ValueError, match="scalar optimizer slot "
                       "'beta_2_t' differs across dense leaves"):
        zero.check_scalar_slots_equal(plan, slots)
    wide = [(zero.Leaf("a", "a"), torch.zeros(3, dtype=torch.float64))]
    with pytest.raises(ValueError, match="got a float64 leaf") as err:
        zero.build_plan(wide, optimizers.Adagrad(0.1), 4)
    with pytest.raises(ValueError) as want:
        jax_zero.build_plan({"a": np.zeros(3, np.float64)},
                            jax_embed.Adagrad(0.1), 4)
    assert str(err.value) == str(want.value)
