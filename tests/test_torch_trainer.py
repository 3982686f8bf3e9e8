"""The port's single-device DeepFM training against the JAX package's.

A small DeepFM (vocabulary 1000, dim 9 folded into one 10-wide table,
hidden (16, 16)) starts from the JAX `Trainer.init` state, carried across by
`convert.train_state_from_jax`; both packages then run 20 steps with
Adagrad(0.05) on the same `synthetic_criteo` batches of 64 (the port's copy
of the generator is pinned byte-identical to the JAX one).

Tolerances, each measured:

- compute_dtype=float32: only the summation order of the matrix products
  and XLA's multiply-add contraction differ. Measured after 20 steps: loss
  1.2e-7, table 5.6e-9, accumulator 7.5e-9, dense params 6.0e-8, dense
  slots 3.0e-8. Held to 1e-6 (loss), 1e-7 (table and accumulator) and
  1e-6 (dense params and slots).
- compute_dtype=bfloat16 (the default): the tower rounds to bf16 at other
  places than XLA's fused jitted step does (as in `test_torch_serving.py`),
  so single activations and gradients differ by a bf16 ulp (2^-8
  relative). Adagrad then moves a parameter by about lr * g / sqrt(accum)
  whatever g's size, so a flipped rounding of a small gradient moves it by
  a good part of lr. Measured after 20 steps: loss 2.3e-4, table 1.6e-4,
  accumulator 1.1e-5, dense params 2.3e-3, dense slots 7.1e-4. Held to
  2e-3, 2e-3, 1e-4, 2e-2 and 1e-2.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params, _unflatten_params
from openembedding_tpu.checkpoint import load_server_model as jax_load
from openembedding_tpu.checkpoint import save_server_model as jax_save
from openembedding_tpu.data import synthetic_criteo as jax_synthetic
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.model import TrainState as JaxState
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu_torch import checkpoint, convert, data, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm

VOCAB, DIM, BATCH, STEPS = 1000, 9, 64, 20
TOL = {"float32": {"loss": 1e-6, "table": 1e-7, "accum": 1e-7,
                   "dense": 1e-6, "dense_slots": 1e-6},
       "bfloat16": {"loss": 2e-3, "table": 2e-3, "accum": 1e-4,
                    "dense": 2e-2, "dense_slots": 1e-2}}


def _batches(steps=STEPS, seed=7):
    return list(data.synthetic_criteo(BATCH, id_space=VOCAB, steps=steps,
                                      seed=seed))


def _pair(compute="float32"):
    """(jax model, jax trainer, port model, port trainer)."""
    jm = jax_make_deepfm(VOCAB, DIM, hidden=(16, 16),
                         compute_dtype=getattr(jnp, compute))
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    tm = make_deepfm(VOCAB, DIM, hidden=(16, 16),
                     compute_dtype=getattr(torch, compute))
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    return jm, jt, tm, tt


def _numpy_state(js):
    """A JAX TrainState as numpy, in `train_state_from_jax`'s arguments."""
    return dict(
        tables={n: {"weights": np.array(t.weights),
                    "slots": {k: np.array(v) for k, v in t.slots.items()}}
                for n, t in js.tables.items()},
        dense_params={k: np.array(v)
                      for k, v in _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v)
                     for k, v in _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _jax_state(d):
    """`convert.train_state_to_jax`'s dict as a JAX TrainState."""
    return JaxState(
        step=jnp.asarray(d["step"], jnp.int32),
        dense_params=_unflatten_params(d["dense_params"]),
        dense_slots=_unflatten_params(d["dense_slots"]),
        tables={n: JaxTable(weights=jnp.asarray(t["weights"]),
                            slots={k: jnp.asarray(v)
                                   for k, v in t["slots"].items()})
                for n, t in d["tables"].items()},
        model_version=jnp.asarray(d["model_version"], jnp.int32))


def _assert_states_close(ts, js, tol):
    got = convert.train_state_to_jax(ts)
    want = _numpy_state(js)
    for name, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][name]["weights"],
                                   t["weights"], rtol=0, atol=tol["table"])
        for k, v in t["slots"].items():
            np.testing.assert_allclose(got["tables"][name]["slots"][k], v,
                                       rtol=0, atol=tol["accum"], err_msg=k)
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            assert got[key][k].shape == v.shape, k
            np.testing.assert_allclose(
                got[key][k], v, rtol=0, err_msg=k,
                atol=tol["dense" if key == "dense_params" else "dense_slots"])
    assert (got["step"], got["model_version"]) == (want["step"],
                                                   want["model_version"])


def test_synthetic_criteo_byte_identical_to_jax():
    for kw in ({"id_space": VOCAB, "seed": 7}, {"id_space": 1 << 24,
                                               "seed": 3, "alpha": 1.2}):
        ours = data.synthetic_criteo(33, steps=3, **kw)
        theirs = jax_synthetic(33, steps=3, **kw)
        for a, b in zip(ours, theirs):
            for key in ("dense", "label"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
            ids_a, ids_b = a["sparse"]["categorical"], b["sparse"][
                "categorical"]
            assert ids_a.dtype == ids_b.dtype == np.int64
            assert ids_a.tobytes() == ids_b.tobytes()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_twenty_steps_match_jax(compute):
    jm, jt, tm, tt = _pair(compute)
    batches = _batches()
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    step = jax.jit(jt.train_step)
    jax_losses, port_losses = [], []
    for b in batches:
        js, m = step(js, b)
        jax_losses.append(float(m["loss"]))
        ts, m = tt.train_step(ts, b)
        port_losses.append(float(m["loss"]))
    tol = TOL[compute]
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0,
                               atol=tol["loss"])
    assert port_losses[-1] < port_losses[0]
    _assert_states_close(ts, js, tol)


def test_train_many_equals_train_steps_bit_for_bit():
    _, _, tm, tt = _pair()
    batches = _batches(steps=4)
    a = tt.init(batches[0])
    b = a.clone()
    losses = []
    for batch in batches:
        a, m = tt.train_step(a, batch)
        losses.append(m["loss"])
    stacked = {"sparse": {"categorical": np.stack(
                   [x["sparse"]["categorical"] for x in batches])},
               "dense": np.stack([x["dense"] for x in batches]),
               "label": np.stack([x["label"] for x in batches])}
    b, m = tt.train_many(b, stacked)
    assert m["loss"].shape == (4,)
    assert torch.equal(m["loss"], torch.stack(losses))
    got, want = convert.train_state_to_jax(b), convert.train_state_to_jax(a)
    assert got["step"] == want["step"] == 4
    for key in ("dense_params", "dense_slots"):
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])
    for name, t in want["tables"].items():
        np.testing.assert_array_equal(got["tables"][name]["weights"],
                                      t["weights"])
        for k, v in t["slots"].items():
            np.testing.assert_array_equal(got["tables"][name]["slots"][k], v)


def test_eval_step_and_weighted_loss_match_jax():
    jm, jt, tm, tt = _pair()
    batches = _batches(steps=3)
    js = jt.init(batches[0])
    js, _ = jax.jit(jt.train_step)(js, batches[1])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    batch = dict(batches[2])
    batch["weight"] = (np.arange(BATCH) % 3).astype(np.float32)
    want = jax.jit(jt.eval_step)(js, batch)
    got = tt.eval_step(ts, batch)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_loads_and_takes_the_same_next_step(writer,
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
        ts = checkpoint.load_server_model(tt.init(batches[0]), tm, path)
    else:
        checkpoint.save_server_model(ts, tm, path, model_sign="s-3")
        js = jax_load(jt.init(batches[0]), jm, path)
    assert sorted(os.listdir(path)) == ["dense_params.npz",
                                        "dense_slots.npz", "model_config.json",
                                        "model_meta", "variable_0"]
    assert sorted(os.listdir(os.path.join(path, "variable_0"))) == [
        "slot_accum.npy", "weights.npy"]
    with open(os.path.join(path, "model_meta")) as f:
        extra = json.load(f)["extra"]
    assert extra["step"] == 3 and extra["include_optimizer"] is True
    _assert_states_close(ts, js, TOL["float32"])
    js, jm_out = step(js, batches[3])
    ts, tm_out = tt.train_step(ts, batches[3])
    np.testing.assert_allclose(float(tm_out["loss"]), float(jm_out["loss"]),
                               rtol=0, atol=1e-6)
    _assert_states_close(ts, js, TOL["float32"])


def test_train_state_round_trips_through_the_jax_layout():
    """port -> JAX layout -> port keeps every value; the JAX step on the
    carried state equals the port's step."""
    jm, jt, tm, tt = _pair()
    batches = _batches(steps=2)
    ts = tt.init(batches[0])
    ts, _ = tt.train_step(ts, batches[0])
    js = _jax_state(convert.train_state_to_jax(ts))
    back = convert.train_state_to_jax(convert.train_state_from_jax(
        make_deepfm(VOCAB, DIM, hidden=(16, 16), compute_dtype=torch.float32),
        **_numpy_state(js), device="cpu"))
    for key in ("dense_params", "dense_slots"):
        for k, v in convert.train_state_to_jax(ts)[key].items():
            np.testing.assert_array_equal(back[key][k], v)
    js, jm_out = jax.jit(jt.train_step)(js, batches[1])
    ts, tm_out = tt.train_step(ts, batches[1])
    np.testing.assert_allclose(float(tm_out["loss"]), float(jm_out["loss"]),
                               rtol=0, atol=1e-6)
    _assert_states_close(ts, js, TOL["float32"])


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_deepfm(VOCAB, DIM, hidden=(16, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model)
    trainer = Trainer(model, device="cpu")
    state = trainer.init(_batches(steps=1)[0])
    assert state.tables["categorical"].weights.device.type == "cpu"
    assert isinstance(trainer.optimizer, optimizers.Adagrad)


def test_trainer_refuses_what_is_not_ported():
    """Hash tables are not ported and raise. (batch_transform and
    sparse_as_dense tables are ported: tests/test_torch_sparse_as_dense.py.)"""
    model = make_deepfm(VOCAB, DIM, hidden=(16, 16))
    model.batch_transform = lambda b: b
    Trainer(model, device="cpu").init(_batches(steps=1)[0])
    hashed = make_deepfm(VOCAB, DIM, hidden=(16, 16), hashed=True,
                         capacity=4096)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(hashed, device="cpu").init(_batches(steps=1)[0])


def test_per_table_optimizer_reaches_the_spec_and_the_step():
    """make_deepfm(optimizer=...) writes the optimizer into the table spec as
    the JAX factory does; the step applies it to the table and the trainer's
    optimizer to the dense tower."""
    sgd = {"category": "sgd", "learning_rate": 0.1}
    jm = jax_make_deepfm(VOCAB, DIM, hidden=(16, 16),
                         optimizer=jax_embed.SGD(learning_rate=0.1))
    tm = make_deepfm(VOCAB, DIM, hidden=(16, 16),
                     optimizer=optimizers.make_optimizer(dict(sgd)))
    assert tm.config == jm.config
    for name, spec in tm.specs.items():
        assert spec.to_config() == jm.specs[name].to_config()
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    state = tt.init(_batches(steps=1)[0])
    assert list(state.tables["categorical"].slots) == ["moment"]
    assert all(list(s) == ["accum"] for s in state.dense_slots.values())
    tt.train_step(state, _batches(steps=1)[0])


def _trained(steps=3):
    _, _, tm, tt = _pair()
    batches = _batches(steps=steps + 1)
    state = tt.init(batches[0])
    for b in batches[:steps]:
        state, _ = tt.train_step(state, b)
    return tm, tt, state, batches[steps]


def test_export_of_trained_state_predicts_like_eval_step(tmp_path):
    tm, tt, state, batch = _trained()
    export_standalone(state, tm, str(tmp_path / "e"), model_sign="t-3")
    assert not any(f.startswith("slot_") for f in
                   os.listdir(tmp_path / "e" / "variable_0"))
    served = StandaloneModel.load(str(tmp_path / "e"), device="cpu")
    assert served.step == 3
    got = served.predict(batch)
    want = tt.eval_step(state, batch)["logits"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_export_of_trained_state_loads_in_jax(tmp_path):
    tm, tt, state, batch = _trained()
    export_standalone(state, tm, str(tmp_path / "e"), model_sign="t-3")
    jax_served = JaxStandalone.load(str(tmp_path / "e"))
    got = np.asarray(jax_served.predict(batch))
    want = tt.eval_step(state, batch)["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
