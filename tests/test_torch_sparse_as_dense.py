"""sparse_as_dense tables and `batch_transform` in the port, against the JAX
package on the same numpy inputs.

A sparse_as_dense ('Cache' mode) table is a dense leaf: the JAX package keeps
it in the dense params under `__embeddings__`, pulls it with `sad_rows`
(differentiated through `lookup_rows`) and updates the whole table with the
dense optimizer every step. The port pulls it through the gather kernel's
wrapper with a gradient (`ops/sparse.lookup_rows_trainable`, the plain
version here on the CPU) and updates it in `dense_apply`.

Tolerances, each measured:

- The pull and its gradient: bit-exact against `jax.vjp(sad_rows)` (the
  gather is a copy; the backward sums each row's gradients in occurrence
  order, which is also XLA:CPU's scatter-add order).
- Training, compute_dtype=float32, 20 steps with -1 pads and out-of-range
  ids: only the matrix products' summation order and XLA's multiply-add
  contraction in the jitted optimizer rules differ, as in
  `tests/test_torch_trainer.py`, whose float32 bounds hold here too (loss
  1e-6, tables and accumulators 1e-7, dense params and slots 1e-6).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.checkpoint import load_server_model as jax_load
from openembedding_tpu.checkpoint import save_server_model as jax_save
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.model import sad_rows as jax_sad_rows
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu_torch import checkpoint, convert, data, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import (Trainer, init_weights, sad_rows,
                                           EmbeddingModel)
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.embedding import Embedding

VOCAB, DIM, BATCH, STEPS = 1000, 9, 64, 20
TOL = {"loss": 1e-6, "table": 1e-7, "accum": 1e-7, "dense": 1e-6,
       "dense_slots": 1e-6}


def _sad(model):
    spec = model.specs["categorical"]
    model.specs["categorical"] = dataclasses.replace(spec,
                                                     sparse_as_dense=True)
    return model


def _batches(steps=STEPS, seed=7):
    """synthetic_criteo batches with -1 pads and out-of-range ids."""
    out = list(data.synthetic_criteo(BATCH, id_space=VOCAB, steps=steps,
                                     seed=seed))
    rng = np.random.default_rng(seed)
    for b in out:
        ids = b["sparse"]["categorical"]
        u = rng.random(ids.shape)
        ids[u < 0.03] = -1
        ids[(u >= 0.03) & (u < 0.05)] = VOCAB + 17
    return out


def _pair():
    jm = _sad(jax_make_deepfm(VOCAB, DIM, hidden=(16, 16),
                              compute_dtype=jnp.float32))
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    tm = _sad(make_deepfm(VOCAB, DIM, hidden=(16, 16),
                          compute_dtype=torch.float32))
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    return jm, jt, tm, tt


def _numpy_state(js):
    return dict(
        tables={n: {"weights": np.array(t.weights),
                    "slots": {k: np.array(v) for k, v in t.slots.items()}}
                for n, t in js.tables.items()},
        dense_params={k: np.array(v)
                      for k, v in _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v)
                     for k, v in _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _assert_states_close(ts, js, tol=TOL):
    got = convert.train_state_to_jax(ts)
    want = _numpy_state(js)
    assert got["tables"].keys() == want["tables"].keys()
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key]), key
        for k, v in want[key].items():
            assert got[key][k].shape == v.shape, k
            if k.startswith("__embeddings__/"):
                atol = tol["table"] if key == "dense_params" else tol["accum"]
            else:
                atol = tol["dense" if key == "dense_params" else
                           "dense_slots"]
            np.testing.assert_allclose(got[key][k], v, rtol=0, atol=atol,
                                       err_msg=k)
    assert (got["step"], got["model_version"]) == (want["step"],
                                                   want["model_version"])


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", [(300,), (40, 26)])
def test_sad_pull_and_gradient_bit_exact_against_jax_vjp(id_dtype, shape):
    rng = np.random.default_rng(0)
    n_rows, dim = 50, 10
    table = rng.standard_normal((n_rows, dim)).astype(np.float32)
    ids = rng.integers(0, n_rows, shape).astype(id_dtype)
    u = rng.random(shape)
    ids[u < 0.3] = 7                      # a hot row, many duplicates
    ids[(u >= 0.3) & (u < 0.4)] = -1
    ids[(u >= 0.4) & (u < 0.45)] = n_rows
    ids[(u >= 0.45) & (u < 0.5)] = n_rows + 1000
    g = rng.standard_normal(shape + (dim,)).astype(np.float32)

    rows, vjp = jax.vjp(lambda t: jax_sad_rows(t, jnp.asarray(ids)),
                        jnp.asarray(table))
    want_grad, = vjp(jnp.asarray(g))
    t = torch.tensor(table, requires_grad=True)
    got = sad_rows(t, torch.from_numpy(ids))
    got.backward(torch.from_numpy(g))
    assert got.shape == shape + (dim,)
    assert got.detach().numpy().tobytes() == np.asarray(rows).tobytes()
    assert t.grad.numpy().tobytes() == np.asarray(want_grad).tobytes()
    # invalid ids pull zeros and train nothing
    bad = (ids < 0) | (ids >= n_rows)
    assert not got.detach().numpy()[bad].any()
    untouched = np.setdiff1d(np.arange(n_rows), ids[~bad])
    assert not t.grad.numpy()[untouched].any()


def test_twenty_sad_steps_match_jax():
    jm, jt, tm, tt = _pair()
    batches = _batches()
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    assert ts.tables == {} and list(ts.embeddings) == ["categorical"]
    assert "__embeddings__/categorical" in ts.dense_slots
    step = jax.jit(jt.train_step)
    jax_losses, port_losses = [], []
    for b in batches:
        js, m = step(js, b)
        jax_losses.append(float(m["loss"]))
        ts, m = tt.train_step(ts, b)
        assert m["stats"] == {}
        port_losses.append(float(m["loss"]))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0,
                               atol=TOL["loss"])
    assert port_losses[-1] < port_losses[0]
    _assert_states_close(ts, js)


def test_sad_train_many_equals_train_steps_and_fresh_init_trains():
    _, _, tm, tt = _pair()
    batches = _batches(steps=4)
    a = tt.init(batches[0])
    assert a.embeddings["categorical"].shape == (VOCAB, DIM + 1)
    assert a.dense_slots["__embeddings__/categorical"]["accum"].shape == (
        1, VOCAB * (DIM + 1))
    b = a.clone()
    losses = []
    for batch in batches:
        a, m = tt.train_step(a, batch)
        losses.append(m["loss"])
    stacked = {k: (np.stack([x[k] for x in batches]) if k != "sparse" else
                   {"categorical": np.stack([x["sparse"]["categorical"]
                                             for x in batches])})
               for k in ("sparse", "dense", "label")}
    b, m = tt.jit_train_many()(b, stacked)
    assert torch.equal(m["loss"], torch.stack(losses))
    got, want = convert.train_state_to_jax(b), convert.train_state_to_jax(a)
    for key in ("dense_params", "dense_slots"):
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])


def _transform_pair():
    """The same batch_transform in each framework: the model reads
    "categorical", the batch carries its 26 fields as "left" (13) and
    "right" (13), and the transform concatenates them."""
    def jax_fn(b):
        s = b["sparse"]
        return {**b, "sparse": {"categorical": jnp.concatenate(
            [jnp.asarray(s["left"]), jnp.asarray(s["right"])], axis=1)}}

    def torch_fn(b):
        s = b["sparse"]
        return {**b, "sparse": {"categorical": torch.cat(
            [s["left"], s["right"]], dim=1)}}
    return jax_fn, torch_fn


def _split(batch):
    ids = batch["sparse"]["categorical"]
    return {**batch, "sparse": {"left": ids[:, :13], "right": ids[:, 13:]}}


@pytest.mark.parametrize("sad", [False, True])
def test_batch_transform_on_every_path_matches_jax(sad):
    jax_fn, torch_fn = _transform_pair()
    jm, jt, tm, tt = _pair()
    if not sad:
        jm.specs["categorical"] = dataclasses.replace(
            jm.specs["categorical"], sparse_as_dense=False)
        tm.specs["categorical"] = dataclasses.replace(
            tm.specs["categorical"], sparse_as_dense=False)
    jm.batch_transform, tm.batch_transform = jax_fn, torch_fn
    batches = [_split(b) for b in _batches(steps=6)]
    js = jt.init(batches[0])                       # init path
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    assert tt.init(batches[0]).step == 0
    step = jax.jit(jt.train_step)
    for b in batches[:3]:                          # train_step path
        js, jm_out = step(js, b)
        ts, tm_out = tt.train_step(ts, b)
        np.testing.assert_allclose(float(tm_out["loss"]),
                                   float(jm_out["loss"]), rtol=0,
                                   atol=TOL["loss"])
    window = batches[3:5]
    stacked = {"sparse": {k: np.stack([b["sparse"][k] for b in window])
                          for k in ("left", "right")},
               "dense": np.stack([b["dense"] for b in window]),
               "label": np.stack([b["label"] for b in window])}
    js, jm_out = jax.jit(jt.train_many)(js, stacked)   # train_many path
    ts, tm_out = tt.jit_train_many()(ts, stacked)
    np.testing.assert_allclose(tm_out["loss"].numpy(),
                               np.asarray(jm_out["loss"]), rtol=0,
                               atol=TOL["loss"])
    want = jax.jit(jt.eval_step)(js, batches[5])      # eval path
    got = tt.eval_step(ts, batches[5])
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-6)
    _assert_states_close(ts, js)
    weights = init_weights(tm, batches[0], device="cpu")  # serving init
    assert set(weights.tables) == {"categorical"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sad_checkpoint_cross_loads_and_takes_the_same_next_step(writer,
                                                                 tmp_path):
    jm, jt, tm, tt = _pair()
    batches = _batches(steps=4)
    step = jax.jit(jt.train_step)
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    for b in batches[:3]:
        js, _ = step(js, b)
        ts, _ = tt.train_step(ts, b)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jax_save(js, jm, path, model_sign="s-3")
        ts = tt.load(tt.init(batches[0]), path)
    else:
        tt.save(ts, path, model_sign="s-3")
        js = jax_load(jt.init(batches[0]), jm, path)
    assert os.listdir(os.path.join(path, "variable_0")) == []
    with np.load(os.path.join(path, "dense_params.npz")) as z:
        assert z["__embeddings__/categorical"].shape == (VOCAB, DIM + 1)
    with np.load(os.path.join(path, "dense_slots.npz")) as z:
        assert "__embeddings__/categorical/accum" in z.files
    _assert_states_close(ts, js)
    js, jm_out = step(js, batches[3])
    ts, tm_out = tt.train_step(ts, batches[3])
    np.testing.assert_allclose(float(tm_out["loss"]), float(jm_out["loss"]),
                               rtol=0, atol=TOL["loss"])
    _assert_states_close(ts, js)


def test_sad_checkpoint_round_trips_in_the_port_bit_for_bit(tmp_path):
    _, _, tm, tt = _pair()
    batches = _batches(steps=5)
    a = tt.init(batches[0])
    for b in batches[:2]:
        a, _ = tt.train_step(a, b)
    b_state = a.clone()
    tt.save(a, str(tmp_path / "c"))
    loaded = tt.load(tt.init(batches[0]), str(tmp_path / "c"))
    for b in batches[2:]:
        loaded, m1 = tt.train_step(loaded, b)
        b_state, m2 = tt.train_step(b_state, b)
        assert torch.equal(m1["loss"], m2["loss"])
    got = convert.train_state_to_jax(loaded)
    want = convert.train_state_to_jax(b_state)
    for key in ("dense_params", "dense_slots"):
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.save(a, "gs://bucket/ckpt")


def test_sad_export_is_served_by_the_port_and_the_jax_package(tmp_path):
    jm, jt, tm, tt = _pair()
    batches = _batches(steps=4)
    state = tt.init(batches[0])
    for b in batches[:3]:
        state, _ = tt.train_step(state, b)
    export_standalone(state, tm, str(tmp_path / "e"), model_sign="t-3")
    assert os.listdir(tmp_path / "e" / "variable_0") == ["weights.npy"]
    with np.load(tmp_path / "e" / "dense_params.npz") as z:
        assert not any(k.startswith("__embeddings__") for k in z.files)
    served = StandaloneModel.load(str(tmp_path / "e"), device="cpu")
    assert served._tables["categorical"]["kind"] == "array"
    want = tt.eval_step(state, batches[3])["logits"]
    np.testing.assert_array_equal(served.predict(batches[3]).numpy(),
                                  want.numpy())
    jax_served = JaxStandalone.load(str(tmp_path / "e"))
    np.testing.assert_allclose(np.asarray(jax_served.predict(batches[3])),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    # the JAX package's export of a sad state, served by the port
    js = jt.init(batches[0])
    jax_export(js, jm, str(tmp_path / "j"), model_sign="j-0")
    ours = StandaloneModel.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_allclose(
        ours.predict(batches[3]).float().numpy(),
        np.asarray(JaxStandalone.load(str(tmp_path / "j")).predict(
            batches[3])), rtol=1e-5, atol=1e-5)


def test_sad_table_with_its_own_optimizer_is_refused():
    with pytest.raises(ValueError, match="per-variable optimizer"):
        EmbeddingModel(torch.nn.Identity(), [Embedding(
            10, 4, name="t", sparse_as_dense=True,
            optimizer=optimizers.SGD(learning_rate=0.1))])
