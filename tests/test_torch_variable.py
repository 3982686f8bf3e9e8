"""The port's `EmbeddingVariable` against the JAX package's.

The JAX tests of the facade (`tests/test_embedding.py`,
`tests/test_combiner.py`) ported, and parity on the same numpy inputs: a
port variable starts from the JAX variable's table (array and hash, keys
single-lane int64), both read and update the same ids (duplicates, -1
pads, ragged lists). Tolerances: reads are bit-exact (a gather is a copy);
row updates are bit-exact against the JAX update run under
`jax.disable_jit()` (the port's rules do the JAX package's float32 ops in
its order; jitted XLA may contract a multiply-add).
"""

import jax
import numpy as np
import pytest
import torch

import openembedding_tpu as jembed
from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.embedding import EmbeddingSpec
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.variable import EmbeddingVariable

VOCAB, DIM = 64, 4

JAX_OPT = {"sgd": lambda: jembed.SGD(learning_rate=0.1),
           "adagrad": lambda: jembed.Adagrad(learning_rate=0.1),
           "adam": lambda: jembed.Adam(learning_rate=0.05)}
PORT_OPT = {"sgd": lambda: optimizers.SGD(learning_rate=0.1),
            "adagrad": lambda: optimizers.Adagrad(learning_rate=0.1),
            "adam": lambda: optimizers.Adam(learning_rate=0.05)}


def _pair(opt, hashed):
    kw = dict(name="v", input_dim=-1 if hashed else VOCAB, output_dim=DIM,
              capacity=256 if hashed else 0, variable_id=0)
    jvar = jembed.EmbeddingVariable(JaxSpec(**kw), JAX_OPT[opt]())
    pvar = EmbeddingVariable(EmbeddingSpec(**kw), PORT_OPT[opt](),
                             device="cpu")
    js = jvar.state
    pvar.state.weights.copy_(torch.tensor(np.array(js.weights)))
    for k, v in pvar.state.slots.items():
        v.copy_(torch.tensor(np.array(js.slots[k])))
    if hashed:
        pvar.state.keys.copy_(torch.tensor(np.array(js.keys)))
    return jvar, pvar


def _same(port, jax_arr):
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(jax_arr))


@pytest.mark.parametrize("hashed", [False, True], ids=["array", "hash"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_read_push_update_bit_exact(opt, hashed):
    jvar, pvar = _pair(opt, hashed)
    rng = np.random.default_rng(3)
    space = 1 << 40 if hashed else VOCAB
    for step in range(3):
        ids = rng.integers(0, space, size=(6, 5)).astype(np.int64)
        ids[ids % 5 == 0] = -1
        ids[0, :2] = ids[1, :2]                     # duplicates
        with jax.disable_jit():
            jrows = jvar.sparse_read(ids)
            prows = pvar.sparse_read(ids)
            _same(prows, jrows)
            grads = rng.normal(size=(6, 5, DIM)).astype(np.float32)
            jvar.push_gradients(ids, grads)
            pvar.push_gradients(ids, grads)
            jvar.update_weights()
            pvar.update_weights()
        _same(pvar.state.weights, jvar.state.weights)
        for k, v in pvar.state.slots.items():
            _same(v, jvar.state.slots[k])
        if hashed:
            _same(pvar.state.keys, jvar.state.keys)
        _same(pvar.read_only_pull(ids), jvar.read_only_pull(ids))


def test_facade_test_optimizer():
    """`test_embedding.py::test_embedding_variable_facade`."""
    var = EmbeddingVariable(
        EmbeddingSpec(name="v", input_dim=20, output_dim=4,
                      initializer=Constant(1.0), variable_id=0),
        optimizer=optimizers.TestOptimizer(learning_rate=1.0, flip=10.0),
        device="cpu")
    rows = var.sparse_read(torch.tensor([3, 3, 5]))
    np.testing.assert_allclose(rows.numpy(), 1.0)
    grads = torch.tensor([[1.0] * 4, [1.0] * 4, [2.0] * 4])
    var.push_gradients(torch.tensor([3, 3, 5]), grads)
    var.update_weights()
    after = var.sparse_read(torch.tensor([3, 5, 7])).numpy()
    np.testing.assert_allclose(after[0], 12.0, rtol=1e-6)
    np.testing.assert_allclose(after[1], 13.0, rtol=1e-6)
    np.testing.assert_allclose(after[2], 1.0, rtol=1e-6)


def test_prefetch_warms_hash_keys():
    """`test_embedding.py::test_variable_prefetch_warms_hash_keys`."""
    spec = EmbeddingSpec(name="v", input_dim=-1, output_dim=4, capacity=64,
                         variable_id=0)
    var = EmbeddingVariable(spec, optimizers.Adagrad(learning_rate=0.1),
                            device="cpu")
    ids = np.asarray([3, 99, 12345], np.int64)
    before = int((var.state.keys >= 0).sum())
    var.prefetch(ids)
    assert int((var.state.keys >= 0).sum()) == before + 3
    rows = var.sparse_read(ids).numpy()
    assert rows.shape == (3, 4) and np.isfinite(rows).all()
    aspec = EmbeddingSpec(name="a", input_dim=32, output_dim=4,
                          variable_id=1)
    avar = EmbeddingVariable(aspec, optimizers.Adagrad(learning_rate=0.1),
                             device="cpu")
    w0 = avar.state.weights.clone()
    avar.prefetch(np.asarray([1, 2]))
    assert torch.equal(w0, avar.state.weights)


def test_ragged_reads_pad_with_minus_one():
    """`test_combiner.py`: ragged lists pad to the longest with -1; pad
    slots pull zero rows."""
    spec = EmbeddingSpec(name="v", input_dim=VOCAB, output_dim=DIM)
    var = EmbeddingVariable(spec, optimizers.SGD(learning_rate=0.1),
                            device="cpu")
    rows = var.sparse_read([[1, 2, 3], [5], [7, 8]]).numpy()
    assert rows.shape == (3, 3, DIM)
    np.testing.assert_array_equal(
        rows, var.read_only_pull([[1, 2, 3], [5], [7, 8]]).numpy())
    assert np.all(rows[1, 1:] == 0.0) and np.all(rows[2, 2:] == 0.0)
    np.testing.assert_array_equal(rows[0, :3],
                                  var.read_only_pull([1, 2, 3]).numpy())
    jvar = jembed.EmbeddingVariable(JaxSpec(name="v", input_dim=VOCAB,
                                            output_dim=DIM),
                                    jembed.SGD(learning_rate=0.1))
    var.state.weights.copy_(torch.tensor(np.array(jvar.state.weights)))
    _same(var.sparse_read([[1, 2, 3], [5], [7, 8]]),
          jvar.sparse_read([[1, 2, 3], [5], [7, 8]]))


def test_ragged_pull_push_roundtrip():
    """`test_combiner.py::test_variable_ragged_pull_push_roundtrip`."""
    spec = EmbeddingSpec(name="v", input_dim=VOCAB, output_dim=DIM)
    var = EmbeddingVariable(spec, optimizers.SGD(learning_rate=1.0),
                            device="cpu")
    seqs = [[1, 2, 3], [5]]
    rows = var.sparse_read(seqs)
    w0 = var.state.weights.clone().numpy()
    var.push_gradients(seqs, np.ones(tuple(rows.shape), np.float32))
    var.update_weights()
    w1 = var.state.weights.numpy()
    for r in (1, 2, 3, 5):
        np.testing.assert_allclose(w1[r], w0[r] - 1.0, rtol=1e-6)
    touched = np.zeros(VOCAB, bool)
    touched[[1, 2, 3, 5]] = True
    np.testing.assert_array_equal(w1[~touched], w0[~touched])


def test_ragged_63_bit_ids_do_not_collide():
    """`test_combiner.py`: 63-bit ragged ids keep their high bits (the
    port's ids are int64 throughout)."""
    big = (1 << 40) + (1 << 31) + 5
    spec = EmbeddingSpec(name="v", input_dim=-1, output_dim=4, capacity=64)
    var = EmbeddingVariable(spec, optimizers.SGD(learning_rate=0.1),
                            device="cpu")
    rows = var.sparse_read([[big, big + (1 << 32)], [7]]).numpy()
    assert rows.shape == (2, 2, 4) and (rows[1, 1:] == 0).all()
    assert not np.allclose(rows[0, 0], rows[0, 1])
    np.testing.assert_array_equal(var.read_only_pull([[big]]).numpy()[0, 0],
                                  rows[0, 0])


def test_set_optimizer_carries_shared_slots():
    spec = EmbeddingSpec(name="v", input_dim=VOCAB, output_dim=DIM)
    var = EmbeddingVariable(spec, optimizers.Adagrad(learning_rate=0.1),
                            device="cpu")
    ids = np.asarray([1, 2, 2], np.int64)
    var.sparse_read(ids)
    var.push_gradients(ids, np.ones((3, DIM), np.float32))
    var.update_weights()
    accum = var.state.slots["accum"].clone()
    var.set_optimizer(optimizers.Adagrad(learning_rate=0.5))
    assert torch.equal(var.state.slots["accum"], accum)
    var.set_optimizer(optimizers.Adam(learning_rate=0.01))
    assert "accum" not in var.state.slots
    assert set(var.state.slots) == set(
        optimizers.Adam().slot_shapes(DIM))
    jvar = jembed.EmbeddingVariable(JaxSpec(name="v", input_dim=VOCAB,
                                            output_dim=DIM),
                                    jembed.Adagrad(learning_rate=0.1))
    jvar.set_optimizer(jembed.Adam(learning_rate=0.01))
    assert set(jvar.state.slots) == set(var.state.slots)


def test_default_device_is_the_card():
    spec = EmbeddingSpec(name="v", input_dim=VOCAB, output_dim=DIM)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingVariable(spec)
