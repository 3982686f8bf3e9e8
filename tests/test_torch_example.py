"""The port's Criteo training entry point
(`openembedding_tpu_torch/examples/criteo_deepctr.py`) on the CPU, against
the JAX package's `Trainer` on the same batches.

`main` runs the flagship DeepFM at a small vocabulary (1000 rows, the full
400-400-400 bf16 tower) on `examples/train100.tsv` in batches of 32, read by
the native reader and rebatched by `CriteoBatcher` (three batches a pass;
`repeat` starts the next pass at row 0). Both packages start from one state:
the JAX `Trainer.init` state, written by the JAX package's checkpoint writer
and loaded by `main --load`.

Tolerance of the losses against the JAX package: the tower computes in
bf16, which both frameworks round at other places (see
`tests/test_torch_trainer.py`). The raw Criteo dense features (log(x+4)^2,
up to about 50) make the losses large (6 to 58), so the bound is relative:
measured over 6 steps at most 4.4e-4, held to 2^-8, one bf16 rounding.
Runs of the port against each other are bit-equal: the same code on the
same batches.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import save_server_model as jax_save
from openembedding_tpu.data import CriteoBatcher as JaxBatcher
from openembedding_tpu.data import read_criteo_tsv as jax_read_tsv
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu_torch import convert
from openembedding_tpu_torch.examples import criteo_deepctr
from openembedding_tpu_torch.export import StandaloneModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN100 = os.path.join(REPO, "examples", "train100.tsv")
VOCAB, BATCH = 1000, 32
BASE = ["--device", "cpu", "--data", TRAIN100, "--batch-size", str(BATCH),
        "--vocabulary", str(VOCAB)]
LOSS_RTOL = 2.0 ** -8


def _jax_batches(steps):
    it = iter(JaxBatcher(jax_read_tsv(TRAIN100, BATCH, id_space=VOCAB,
                                      native="off", repeat=True), BATCH))
    return [next(it) for _ in range(steps)]


def _jax_start(tmp_path, cache: bool):
    """The JAX Trainer's init state, written as a checkpoint -> (trainer,
    state, checkpoint path)."""
    model = jax_make_deepfm(VOCAB, 9)
    if cache:
        model.specs["categorical"] = dataclasses.replace(
            model.specs["categorical"], sparse_as_dense=True)
    trainer = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.05))
    state = trainer.init(_jax_batches(1)[0])
    path = str(tmp_path / ("jax_init_sad" if cache else "jax_init"))
    jax_save(state, model, path)
    return trainer, state, path


@pytest.mark.parametrize("mode", ["step", "scan", "cache", "cache_scan"])
def test_main_losses_match_the_jax_trainer(mode, tmp_path):
    cache = mode.startswith("cache")
    jt, js, path = _jax_start(tmp_path, cache)
    extra = ["--steps", "6", "--load", path]
    if "scan" in mode:
        extra += ["--scan", "2"]
    if cache:
        extra += ["--cache", str(VOCAB)]
    out = criteo_deepctr.main(BASE + extra)
    assert out["steps"] == 6 and out["losses"].shape == (6,)
    assert np.isfinite(out["losses"]).all()
    assert (list(out["state"].embeddings) == ["categorical"]) == cache
    step = jax.jit(jt.train_step)
    want = []
    for b in _jax_batches(6):
        js, m = step(js, b)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL, atol=0)
    if "scan" not in mode:
        assert 0.0 <= out["train_auc"] <= 1.0


def _state_arrays(state):
    d = convert.train_state_to_jax(state)
    out = {f"dense/{k}": v for k, v in d["dense_params"].items()}
    out.update({f"slot/{k}": v for k, v in d["dense_slots"].items()})
    for name, t in d["tables"].items():
        out[f"{name}/weights"] = t["weights"]
        out.update({f"{name}/{k}": v for k, v in t["slots"].items()})
    return out


def _assert_runs_equal(a, b):
    np.testing.assert_array_equal(a["losses"], b["losses"])
    x, y = _state_arrays(a["state"]), _state_arrays(b["state"])
    assert x.keys() == y.keys()
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("cache", [False, True])
def test_save_load_continue_equals_an_uninterrupted_run(cache, tmp_path):
    """Three steps are one pass over the file, so a run resumed from the
    checkpoint of the first three sees the batches an uninterrupted six-step
    run sees; prefetch and the scan driver change nothing."""
    flags = ["--cache", str(VOCAB)] if cache else []
    whole = criteo_deepctr.main(BASE + flags + ["--steps", "6"])
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "export")
    first = criteo_deepctr.main(BASE + flags + [
        "--steps", "3", "--save", ckpt, "--export", export, "--prefetch"])
    resumed = criteo_deepctr.main(BASE + flags + [
        "--steps", "3", "--load", ckpt, "--scan", "2", "--prefetch"])
    assert resumed["state"].step == 6
    np.testing.assert_array_equal(first["losses"], whole["losses"][:3])
    resumed["losses"] = np.concatenate([first["losses"], resumed["losses"]])
    _assert_runs_equal(resumed, whole)

    served = StandaloneModel.load(export, device="cpu")
    batch = _jax_batches(1)[0]
    np.testing.assert_array_equal(
        served.predict(batch).numpy(),
        first["trainer"].eval_step(first["state"], batch)["logits"].numpy())


def test_eager_and_graph_drivers_agree_on_the_cpu():
    graph = criteo_deepctr.main(BASE + ["--steps", "4"])
    eager = criteo_deepctr.main(BASE + ["--steps", "4", "--eager",
                                        "--prefetch"])
    _assert_runs_equal(graph, eager)
    synthetic = criteo_deepctr.main(["--device", "cpu", "--synthetic",
                                     "--batch-size", "16", "--vocabulary",
                                     "500", "--steps", "3", "--scan", "3"])
    assert synthetic["losses"].shape == (3,)


@pytest.mark.parametrize("argv", [
    ["--persist-steps", "2"],
    ["--persist-steps", "2", "--persist-incremental"],
    ["--persist-steps", "3", "--persist-incremental", "--prefetch"],
    ["--persist-steps", "2", "--persist-incremental", "--scan", "2"]],
    ids=["full", "incremental", "incremental-prefetch",
         "incremental-scan"])
def test_persist_restores_mains_state(argv, tmp_path):
    """`--persist ROOT` (every `--persist-steps`, incremental or not, with
    prefetch or `--scan` windows): a restore of the root into a fresh state
    equals the state `main` returns, bit for bit."""
    from openembedding_tpu_torch.microbench import state_bits
    from openembedding_tpu_torch.persist import (list_deltas, list_persists,
                                                 restore_server_model)
    root = str(tmp_path / "persist")
    out = criteo_deepctr.main(BASE + ["--steps", "6", "--persist", root]
                              + argv)
    assert out["persist"] == root
    kinds = [r["kind"] for r in out["persister"].history]
    assert kinds == (["full"] * 3 if "--persist-incremental" not in argv
                     else ["full", "delta", "delta"] if "2" in argv
                     else ["full", "delta"])
    assert list_persists(root) and (
        bool(list_deltas(root)) == ("--persist-incremental" in argv))
    trainer = out["trainer"]
    fresh = trainer.init(_jax_batches(1)[0])
    got = restore_server_model(fresh, out["model"], root, trainer=trainer)
    assert (got.step, got.model_version) == (6, 6)
    want = out["state"]
    a, b = state_bits(got), state_bits(want)
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize("flag", [
    ["--offload", "64"], ["--report-interval", "1"],
    ["--metrics-log", "m.jsonl"], ["--profile", "trace"],
    ["--flight-recorder", "8"], ["--trace-dump", "t.json"],
    ["--skew-report"]], ids=lambda f: f[0])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        criteo_deepctr.main(BASE + ["--steps", "1"] + flag)


def test_other_families_and_no_card_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        criteo_deepctr.main(BASE + ["--model", "two_tower", "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        criteo_deepctr.main(["--data", TRAIN100, "--steps", "1"])
