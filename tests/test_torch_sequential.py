"""The port's sequential recommenders (SASRec, BERT4Rec) against the JAX
package's, on one device.

`make_sasrec` / `make_bert4rec` at VOCAB 512, DIM 16, SEQ 32, 2 blocks, on
the generators of both packages (byte-identical batches); the port starts
from the JAX init (`convert.train_state_from_jax`, which carries `pos_emb`
and the LayerNorms' scale and bias). Tolerances: float32 logits within
2e-6 and loss within 1e-6 (einsum, LayerNorm and softmax orders of adds);
bfloat16 logits within 5e-2 and loss within 5e-3 (XLA:CPU keeps some
bfloat16 intermediates in float32 where the flax module rounds them; the
port rounds where the module says); an 8-step Adagrad(0.1) trajectory in
float32 within 2e-5 (loss) and 2e-5 (tables and dense params), hash keys
bit-exact. The exports between the packages and `from_config` are in
`test_torch_sequential_io.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jembed
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_bert4rec as jax_make_bert4rec
from openembedding_tpu.models import make_sasrec as jax_make_sasrec
from openembedding_tpu.models import synthetic_masked_sequences as jax_masked
from openembedding_tpu.models import synthetic_sequences as jax_sequences
from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.model import IDS_KEY, Trainer
from openembedding_tpu_torch.models import (SASRec, bert4rec_mask_id,
                                            make_bert4rec, make_sasrec,
                                            synthetic_masked_sequences,
                                            synthetic_sequences)

from test_torch_mesh_train import numpy_state

VOCAB, DIM, SEQ, CAPACITY = 512, 16, 32, 2048
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batches(family, n, batch=8, seed=0):
    if family == "bert4rec":
        return list(synthetic_masked_sequences(batch, SEQ, VOCAB, seed=seed,
                                               steps=n))
    return list(synthetic_sequences(batch, SEQ, VOCAB, seed=seed, steps=n))


def _pair(family, dtype="float32", hashed=False, heads=2):
    jd, td = DTYPES[dtype]
    jmake = jax_make_bert4rec if family == "bert4rec" else jax_make_sasrec
    tmake = make_bert4rec if family == "bert4rec" else make_sasrec
    kw = dict(num_heads=heads, hashed=hashed,
              capacity=CAPACITY if hashed else 0)
    jm = jmake(VOCAB, DIM, compute_dtype=jd, **kw)
    tm = tmake(VOCAB, DIM, compute_dtype=td, **kw)
    return (jm, JaxTrainer(jm, jembed.Adagrad(learning_rate=0.1)), tm,
            Trainer(tm, optimizers.Adagrad(learning_rate=0.1), device="cpu"))


def _hashed(batches, family):
    """The mask id of a hashed BERT4Rec table (2^62 - 1) in place of the
    array table's extra row."""
    if family != "bert4rec":
        return batches
    out = []
    for b in batches:
        ids = b["sparse"]["item"].copy()
        ids[ids == bert4rec_mask_id(VOCAB)] = bert4rec_mask_id(VOCAB, True)
        out.append({"sparse": {"item": ids}, "label": b["label"]})
    return out


def test_generators_are_the_jax_ones():
    for mine, theirs in ((synthetic_sequences(4, SEQ, VOCAB, seed=3, steps=3),
                          jax_sequences(4, SEQ, VOCAB, seed=3, steps=3)),
                         (synthetic_masked_sequences(4, SEQ, VOCAB, seed=3,
                                                     steps=3),
                          jax_masked(4, SEQ, VOCAB, seed=3, steps=3))):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a["sparse"]["item"],
                                          b["sparse"]["item"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("dtype,tol", [("float32", (2e-6, 1e-6)),
                                       ("bfloat16", (5e-2, 5e-3))])
@pytest.mark.parametrize("family", ["sasrec", "bert4rec"])
def test_forward_matches_jax(family, dtype, tol):
    jm, jt, tm, tt = _pair(family, dtype)
    batches = _batches(family, 2)
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    # the port's own init makes every flax name, at the flax shape
    own = convert.dense_to_flax(tt.init(batches[0]).dense)
    from openembedding_tpu.checkpoint import _flatten_params
    assert {k: v.shape for k, v in own.items()} == {
        k: np.asarray(v).shape
        for k, v in _flatten_params(js.dense_params).items()}
    want = jax.jit(jt.eval_step)(js, batches[1])
    got = tt.eval_step(ts, batches[1])
    assert tuple(got["logits"].shape) == (8, SEQ, 2)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0,
                               atol=tol[0])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=tol[1])


@pytest.mark.parametrize("family,hashed", [("sasrec", False),
                                           ("bert4rec", False),
                                           ("bert4rec", True)])
def test_trajectory_matches_the_jax_trainer(family, hashed):
    jm, jt, tm, tt = _pair(family, hashed=hashed)
    batches = _batches(family, 8, seed=4)
    if hashed:
        batches = _hashed(batches, family)
    js = jt.init(batches[0])
    start = numpy_state(js)
    if hashed:
        for n, t in js.tables.items():
            start["tables"][n]["keys"] = np.array(t.keys)
            start["tables"][n]["overflow"] = int(t.overflow)
    ts = convert.train_state_from_jax(tm, **start, device="cpu")
    step = jt.jit_train_step()
    jl, tl = [], []
    for b in batches:
        js, m = step(js, b)
        ts, n = tt.train_step(ts, b)
        jl.append(float(m["loss"]))
        tl.append(float(n["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    got = convert.train_state_to_jax(ts)
    want = numpy_state(js)
    np.testing.assert_allclose(got["tables"]["item"]["weights"],
                               want["tables"]["item"]["weights"], rtol=0,
                               atol=2e-5)
    if hashed:
        np.testing.assert_array_equal(got["tables"]["item"]["keys"],
                                      np.array(js.tables["item"].keys))
    for k, v in want["dense_params"].items():
        np.testing.assert_allclose(got["dense_params"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)


def test_rejects_overlong_sequences():
    model = make_sasrec(VOCAB, DIM, max_len=16, compute_dtype=torch.float32)
    tr = Trainer(model, optimizers.Adagrad(), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tr.init(_batches("sasrec", 1, batch=2)[0])


def test_padding_rows_do_not_train():
    """An id only at masked (label 0) positions never trains."""
    model = make_sasrec(VOCAB, DIM, compute_dtype=torch.float32)
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.1), device="cpu")
    base = _batches("sasrec", 1, batch=2)[0]
    ids = base["sparse"]["item"].copy()
    label = base["label"].copy()
    label[:, -1] = 0.0
    used = set(np.unique(ids).tolist())
    probe = next(i for i in range(VOCAB - 1, -1, -1) if i not in used)
    ids[:, 1:, -1] = probe
    batch = {"sparse": {"item": ids}, "label": label}
    state = tr.init(batch)
    before = state.tables["item"].weights[probe].clone()
    state, _ = tr.jit_train_step()(state, batch)
    assert torch.equal(before, state.tables["item"].weights[probe])


def test_bert4rec_mask_row_trains():
    model = make_bert4rec(VOCAB, DIM, compute_dtype=torch.float32)
    assert model.specs["item"].input_dim == VOCAB + 1
    mask_id = bert4rec_mask_id(VOCAB)
    assert mask_id == VOCAB and bert4rec_mask_id(VOCAB, True) == 2**62 - 1
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.3), device="cpu")
    batch = _batches("bert4rec", 1)[0]
    assert (batch["sparse"]["item"][:, 0] == mask_id).any()
    state = tr.init(batch)
    before = state.tables["item"].weights[mask_id].clone()
    state, _ = tr.train_step(state, batch)
    assert not torch.allclose(before, state.tables["item"].weights[mask_id])


def test_bert4rec_logits_invariant_to_pad_width():
    model = make_bert4rec(VOCAB, DIM, compute_dtype=torch.float32)
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.3), device="cpu")
    batch = _batches("bert4rec", 1)[0]
    ids, label = batch["sparse"]["item"], batch["label"]
    state = tr.init(batch)
    for _ in range(3):
        state, _ = tr.train_step(state, batch)
    wide = {"sparse": {"item": np.concatenate(
                [ids, np.full(ids.shape[:2] + (8,), -1, ids.dtype)], -1)},
            "label": np.concatenate(
                [label, np.zeros((label.shape[0], 8), label.dtype)], -1)}
    narrow = tr.eval_step(state, batch)["logits"].numpy()
    widened = tr.eval_step(state, wide)["logits"].numpy()
    np.testing.assert_allclose(widened[:, :SEQ], narrow, rtol=1e-5,
                               atol=1e-6)


def test_key_padding_mask_from_ids_not_zero_rows():
    model = make_sasrec(VOCAB, DIM, compute_dtype=torch.float32)
    model.specs["item"] = dataclasses.replace(model.specs["item"],
                                              initializer=Constant(0.0))
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.1), device="cpu")
    batch = _batches("sasrec", 1)[0]
    state = tr.init(batch)
    out = tr.eval_step(state, batch)
    assert np.isfinite(out["logits"].numpy()).all()
    assert np.isfinite(float(out["loss"]))
    ids = batch["sparse"]["item"]
    zero_rows = torch.zeros((ids.shape[0], SEQ, DIM))
    mod = SASRec(dim=DIM)
    got = mod._kv_valid({IDS_KEY: {"item": torch.tensor(ids)}}, zero_rows)
    np.testing.assert_array_equal(got.numpy(), ids[:, 0] >= 0)
    assert not mod._kv_valid({}, zero_rows).any()
