"""Hashed tables between the packages on disk, and the hashed-LR example:
checkpoints both ways with and without optimizer state, save-load-continue,
standalone exports both ways, and `criteo_lr_subclass.main` against the
JAX example's loop (see `tests/test_torch_hashed.py` for the models and the
tolerances)."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from openembedding_tpu.checkpoint import load_server_model as jax_load
from openembedding_tpu.checkpoint import save_server_model as jax_save
from openembedding_tpu.data import CriteoBatcher as JaxBatcher
from openembedding_tpu.data import read_criteo_tsv as jax_read_tsv
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_lr as jax_make_lr
import openembedding_tpu as jax_embed
from openembedding_tpu_torch import checkpoint, convert
from openembedding_tpu_torch.examples import criteo_lr_subclass
from openembedding_tpu_torch.export import StandaloneModel, export_standalone

from test_torch_hashed import (F32, LOSS_RTOL, TRAIN100, _assert_states_close,
                               _batches, _numpy_state, _pair, _start)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("include_optimizer", [True, False])
def test_checkpoints_cross_load(writer, include_optimizer, tmp_path):
    jm, jt, tm, tt, js, ts, batches = _start("deepfm_fold")
    step = jax.jit(jt.train_step)
    for b in batches[:2]:  # the table not yet full: every id loads
        js, _ = step(js, b)
        ts, _ = tt.train_step(ts, b)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jax_save(js, jm, path, include_optimizer=include_optimizer)
    else:
        tt.save(ts, path, include_optimizer=include_optimizer)
    # one template for both loads: the rows of the slots no loaded id takes
    # are the template's, and new ids start from them (the port's template
    # takes over the model's dense module, so it is made after the save)
    template = jt.init(batches[0])
    loaded = checkpoint.load_server_model(convert.train_state_from_jax(
        tm, **_numpy_state(template), device="cpu"), tm, path)
    ref = jax_load(template, jm, path)
    files = sorted(os.listdir(os.path.join(path, "variable_0")))
    assert files == (["ids.npy", "slot_accum.npy", "weights.npy"]
                     if include_optimizer else ["ids.npy", "weights.npy"])
    assert os.path.exists(os.path.join(path, "dense_slots.npz")) \
        == include_optimizer
    with open(os.path.join(path, "model_meta")) as f:
        meta = json.load(f)
    assert meta["extra"]["include_optimizer"] is include_optimizer
    assert meta["variables"][0]["table"]["category"] == "hash"
    # both packages load the same files into the same slots, bit for bit
    # where a fresh init is not involved: keys and the placed rows
    got = convert.train_state_to_jax(loaded)["tables"]["categorical"]
    want = _numpy_state(ref)["tables"]["categorical"]
    np.testing.assert_array_equal(got["keys"], want["keys"])
    assert got["overflow"] == want["overflow"] == 0
    ids = np.load(os.path.join(path, "variable_0", "ids.npy"))
    rows = np.load(os.path.join(path, "variable_0", "weights.npy"))
    slots = np.searchsorted(ids, got["keys"])
    sel = got["keys"] >= 0
    np.testing.assert_array_equal(got["weights"][sel], rows[slots[sel]])
    np.testing.assert_array_equal(want["weights"][sel], rows[slots[sel]])
    if include_optimizer:
        np.testing.assert_array_equal(
            got["slots"]["accum"][sel],
            np.load(os.path.join(path, "variable_0",
                                 "slot_accum.npy"))[slots[sel]])
    else:  # the template's fresh slots, in both packages
        np.testing.assert_array_equal(got["slots"]["accum"],
                                      want["slots"]["accum"])
        for k, v in _numpy_state(ref)["dense_slots"].items():
            np.testing.assert_array_equal(
                convert.train_state_to_jax(loaded)["dense_slots"][k], v)
    # the id -> row contents equal the trained state's
    _assert_states_close(loaded, js, positions=False, tol=dict(
        F32, accum=np.inf if not include_optimizer else F32["accum"],
        dense_slots=np.inf if not include_optimizer else F32["dense_slots"]))
    # and the next step agrees
    ref, jmet = step(ref, batches[2])
    loaded, tmet = tt.train_step(loaded, batches[2])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=0, atol=1e-6)


def test_save_load_continue_equals_an_uninterrupted_run(tmp_path):
    """Bit-equal losses and id -> row contents after a reload: a loaded
    table may hold colliding ids at swapped slots, and linear probing
    occupies the same slots whatever the insertion order, so new ids land
    where they would have."""
    _, _, tm, tt = _pair("deepfm_fold")
    batches = _batches()
    a = tt.init(batches[0])  # the load's template draws the same rows
    for b in batches[:2]:  # saved before the table is full: no id drops
        a, _ = tt.train_step(a, b)
    tt.save(a, str(tmp_path / "c"))
    a = a.clone()  # its own dense module: the load's template takes the model's
    loaded = tt.load(tt.init(batches[0]), str(tmp_path / "c"))
    for b in batches[2:12]:  # the table fills and overflows
        a, m1 = tt.train_step(a, b)
        loaded, m2 = tt.train_step(loaded, b)
        assert torch.equal(m1["loss"], m2["loss"])
    got = convert.train_state_to_jax(loaded)["tables"]["categorical"]
    want = convert.train_state_to_jax(a)["tables"]["categorical"]
    gs, ws = got["keys"] >= 0, want["keys"] >= 0
    go, wo = np.argsort(got["keys"][gs]), np.argsort(want["keys"][ws])
    np.testing.assert_array_equal(got["keys"][gs][go], want["keys"][ws][wo])
    np.testing.assert_array_equal(got["weights"][gs][go],
                                  want["weights"][ws][wo])
    np.testing.assert_array_equal(np.flatnonzero(gs), np.flatnonzero(ws))
    assert got["overflow"] == want["overflow"] > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hash_exports_cross_serve(writer, tmp_path):
    jm, jt, tm, tt, js, ts, batches = _start("deepfm_fold")
    step = jax.jit(jt.train_step)
    for b in batches[:4]:
        js, _ = step(js, b)
        ts, _ = tt.train_step(ts, b)
    path = str(tmp_path / "export")
    if writer == "jax":
        jax_export(js, jm, path)
    else:
        export_standalone(ts, tm, path)
    assert sorted(os.listdir(os.path.join(path, "variable_0"))) == [
        "ids.npy", "weights.npy"]
    tsm = StandaloneModel.load(path, device="cpu")
    jsm = JaxStandalone.load(path)
    query = batches[5]     # seen and unseen ids, -1 pads
    query = {"sparse": {"categorical": np.where(
        np.arange(26) % 7 == 0, -1, query["sparse"]["categorical"])},
        "dense": query["dense"], "label": query["label"]}
    got = tsm.predict(query).numpy()
    np.testing.assert_allclose(got, np.asarray(jsm.predict(query)),
                               rtol=1e-5, atol=1e-5)
    ids = query["sparse"]["categorical"]
    np.testing.assert_array_equal(tsm.lookup("categorical", ids).numpy(),
                                  np.asarray(jsm.lookup("categorical", ids)))
    # the served logits are the trainer's eval logits
    np.testing.assert_allclose(got, tt.eval_step(ts, query)["logits"].numpy(),
                               rtol=1e-5, atol=1e-5)


def _jax_lr_example(tmp_path, batch=32, epochs=4):
    """The JAX example's model and loop (`examples/criteo_lr_subclass.py`)
    -> (its init state written as a checkpoint, per-step losses, final
    state)."""
    model = jax_make_lr(-1, hashed=True, capacity=1 << 16)
    trainer = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.05))

    def epoch():
        return JaxBatcher(jax_read_tsv(TRAIN100, batch, id_space=1 << 62,
                                       drop_remainder=False, native="off"),
                          batch)

    state = trainer.init(next(iter(epoch())))
    init_path = str(tmp_path / "jax_init")
    jax_save(state, model, init_path)
    step = trainer.jit_train_step()
    losses = []
    for _ in range(epochs):
        for b in epoch():
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    return init_path, losses, state


def test_lr_example_matches_the_jax_example(tmp_path, capsys):
    """Both start from the JAX example's init state (`--load`): the dense
    tower's kernel is drawn by each framework's own generator."""
    init_path, want, js = _jax_lr_example(tmp_path)
    ckpt, saved = str(tmp_path / "ckpt"), str(tmp_path / "saved")
    out = criteo_lr_subclass.main(["--device", "cpu", "--load", init_path,
                                   "--checkpoint", ckpt, "--save", saved])
    assert len(out["losses"]) == len(want) == 16
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    assert "epoch 3: loss" in capsys.readouterr().out
    got = convert.train_state_to_jax(out["state"])["tables"]["categorical"]
    np.testing.assert_array_equal(got["keys"],
                                  np.asarray(js.tables["categorical"].keys))
    # --save leaves the optimizer out, --checkpoint keeps it
    assert not os.path.exists(os.path.join(saved, "dense_slots.npz"))
    assert os.path.exists(os.path.join(ckpt, "dense_slots.npz"))
    # --load resumes: one more epoch from the checkpoint
    more = criteo_lr_subclass.main(["--device", "cpu", "--load", ckpt,
                                    "--epochs", "1"])
    assert more["state"].step == 20
    assert np.isfinite(more["losses"]).all()


def test_lr_example_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        criteo_lr_subclass.main(["--epochs", "1"])
