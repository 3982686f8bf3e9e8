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


OFFLOAD = 1024  # slots: 0.6 x 1024 holds about one batch's distinct ids


@pytest.mark.parametrize("scan", [False, True], ids=["step", "scan"])
def test_offload_save_export_persist(scan, tmp_path):
    """`--offload SLOTS`: the table hashed and host-cached, evicting over
    the stream (stepwise, or a `--scan 2` window's union at once); the
    checkpoint loads into a trainer without the offload equal by id, the
    export serves `eval_step`'s logits, the persist root restores the
    store bit for bit."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.persist import restore_server_model
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "export")
    root = str(tmp_path / "persist")
    argv = BASE + ["--offload", str(OFFLOAD), "--steps", "6", "--save", ckpt,
                   "--export", export, "--persist", root,
                   "--persist-steps", "2"] + (["--scan", "2"] if scan else [])
    out = criteo_deepctr.main(argv)
    trainer, state, model = out["trainer"], out["state"], out["model"]
    ot = trainer.offload["categorical"]
    assert model.specs["categorical"].storage == "host_cached"
    assert ot.counters["evictions"] + ot.counters["flushes"] > 0
    assert np.isfinite(out["losses"]).all()
    store = trainer.offload_store_snapshots(state)["categorical"]

    # into a trainer without the offload (a hash table big enough)
    spec = dataclasses.replace(model.specs["categorical"], storage="hbm",
                               capacity=1 << 13)
    plain_model = criteo_deepctr.build_model(
        criteo_deepctr.build_parser().parse_args(BASE), model.config)
    plain_model.specs["categorical"] = spec
    plain = Trainer(plain_model, trainer.optimizer, device="cpu")
    batch = _jax_batches(1)[0]
    loaded = plain.load(plain.init(batch), ckpt)
    t = loaded.tables["categorical"]
    sel = np.flatnonzero(t.keys.numpy() >= 0)
    order = sel[np.argsort(t.keys.numpy()[sel])]
    assert t.keys.numpy()[order].tobytes() == store.ids.tobytes()
    assert t.weights.numpy()[order].tobytes() == store.weights.tobytes()
    assert (t.slots["accum"].numpy()[order].tobytes()
            == store.slots["accum"].tobytes())

    state = trainer.offload_prepare(state, batch)
    served = StandaloneModel.load(export, device="cpu")
    np.testing.assert_array_equal(
        served.predict(batch).numpy(),
        trainer.eval_step(state, batch)["logits"].numpy())

    fresh_trainer = Trainer(model, trainer.optimizer, device="cpu")
    fresh = fresh_trainer.init(batch)
    got = restore_server_model(fresh, model, root, trainer=fresh_trainer)
    assert got.step == 6
    back = fresh_trainer.offload_store_snapshots(got)["categorical"]
    assert back.ids.tobytes() == store.ids.tobytes()
    assert back.weights.tobytes() == store.weights.tobytes()


def test_offload_equals_an_in_hbm_hash_table_until_it_evicts():
    """A cache that never evicts places each id where the in-HBM hash
    table of its size does, with the same initializer rows: the losses
    and the table are the in-HBM run's, bit for bit."""
    slots = 1 << 12
    off = criteo_deepctr.main(BASE + ["--offload", str(slots), "--steps",
                                      "4"])
    ot = off["trainer"].offload["categorical"]
    assert ot.counters["evictions"] + ot.counters["flushes"] == 0
    model = off["model"]
    hbm_model = criteo_deepctr.build_model(
        criteo_deepctr.build_parser().parse_args(BASE), model.config)
    hbm_model.specs["categorical"] = dataclasses.replace(
        model.specs["categorical"], storage="hbm")
    from openembedding_tpu_torch.model import Trainer
    trainer = Trainer(hbm_model, off["trainer"].optimizer, device="cpu")
    batches = _jax_batches(4)
    state = trainer.init(batches[0])
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_array_equal(off["losses"], np.float32(losses))
    a = off["state"].tables["categorical"]
    b = state.tables["categorical"]
    for x, y in ((a.keys, b.keys), (a.weights, b.weights),
                 (a.slots["accum"], b.slots["accum"])):
        assert torch.equal(x, y)


def test_offload_refused_with_cache():
    with pytest.raises(SystemExit):
        criteo_deepctr.main(BASE + ["--offload", "64", "--cache",
                                    str(VOCAB), "--steps", "1"])


@pytest.mark.parametrize("flag", [
    ["--report-interval", "1"],
    ["--metrics-log", "m.jsonl"], ["--profile", "trace"],
    ["--flight-recorder", "8"], ["--trace-dump", "t.json"],
    ["--skew-report"]], ids=lambda f: f[0])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        criteo_deepctr.main(BASE + ["--steps", "1"] + flag)


def test_other_families_and_no_card_raise(monkeypatch, capsys):
    # the retrieval and sequence families have batches of their own: the
    # entry point refuses them, as the JAX one refuses two_tower
    for family in ("two_tower", "sasrec", "bert4rec"):
        with pytest.raises(SystemExit):
            criteo_deepctr.main(BASE + ["--model", family, "--steps", "1"])
        assert "its own batch schema" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        criteo_deepctr.main(["--data", TRAIN100, "--steps", "1"])
