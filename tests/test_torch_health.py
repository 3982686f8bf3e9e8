"""The port's numerics sentinel, `halt_on_nonfinite` and `measure_every`
on the single-device Trainer, against the JAX package's.

A small DeepFM (vocabulary 1000, dim 9, hidden (16, 16), float32 tower)
starts from the JAX `Trainer.init` state, carried across by
`convert.train_state_from_jax`; both packages run the same
`synthetic_criteo` batches of 64 with Adagrad(0.05).

Tolerances: the sentinel's float32 sums run in another order than XLA's
(the port lays the dense leaves end to end first), and the states drift
apart by the ulps `test_torch_trainer.py` measures. Measured over 5 steps:
the `health.*` gauges within 3e-7 relative. Held to 1e-5 relative.
Non-finite counts of clean steps are exact (0), and so are the names in a
halt's `sources`. Past a planted NaN the per-source counts may differ:
torch's ReLU backward passes a NaN on where XLA's `select(x > 0, g, 0)`
stops it, so more dense gradients turn NaN in the port; the loss count
is equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params, _unflatten_params
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.model import TrainState as JaxState
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.utils import capsule as jax_capsule
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu.utils import trace as jax_trace
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.utils import capsule, metrics, stepwatch, trace

VOCAB, DIM, BATCH = 1000, 9, 64
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_registries():
    for m, t in ((metrics, trace), (jax_metrics, jax_trace)):
        with m._LOCK:  # other tests' series leave their keys registered
            m._REGISTRY.clear()
        t.RECORDER.clear()
    yield
    capsule.configure(None)
    jax_capsule.configure(None)


def _batches(steps, seed=7):
    return list(data.synthetic_criteo(BATCH, id_space=VOCAB, steps=steps,
                                      seed=seed))


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


def _jax_state(d):
    return JaxState(
        step=jnp.asarray(d["step"], jnp.int32),
        dense_params=_unflatten_params(d["dense_params"]),
        dense_slots=_unflatten_params(d["dense_slots"]),
        tables={n: JaxTable(weights=jnp.asarray(t["weights"].copy()),
                            slots={k: jnp.asarray(v.copy())
                                   for k, v in t["slots"].items()})
                for n, t in d["tables"].items()},
        model_version=jnp.asarray(d["model_version"], jnp.int32))


def _pair(**kw):
    jm = jax_make_deepfm(VOCAB, DIM, hidden=(16, 16),
                         compute_dtype=jnp.float32)
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0, **kw)
    tm = make_deepfm(VOCAB, DIM, hidden=(16, 16),
                     compute_dtype=torch.float32)
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu",
                 **kw)
    return jm, jt, tm, tt


def _start(jt, tm, batch, plant=None):
    """(jax state, port state) from one numpy state; `plant(d)` edits the
    numpy state first."""
    d = _numpy_state(jt.init(batch))
    if plant is not None:
        plant(d)
    js = _jax_state(d)
    ts = convert.train_state_from_jax(tm, **{k: v for k, v in d.items()},
                                      device="cpu")
    return js, ts


def _health(report):
    return {k: v for k, v in report.items() if k.startswith("health.")}


def test_sentinel_health_matches_jax():
    _, jt, tm, tt = _pair(sentinel=True)
    batches = _batches(6)
    js, ts = _start(jt, tm, batches[0])
    step = jax.jit(jt.train_step)
    for b in batches[1:]:
        js, jm = step(js, b)
        ts, tmet = tt.train_step(ts, b)
        want_stats = jax.device_get(jm["stats"])
        got_stats = tmet["stats"]
        assert set(got_stats) == set(want_stats)
        for k, v in want_stats.items():
            g = float(got_stats[k])
            if "nonfinite" in k or k.endswith("ef_elems"):
                assert g == float(v), k
            else:
                np.testing.assert_allclose(g, float(v), rtol=RTOL, err_msg=k)
        want_h = jt.record_step_stats(jm)
        got_h = tt.record_step_stats(tmet)
        assert got_h["sentinel"] and want_h["sentinel"]
        assert got_h["nonfinite"] == want_h["nonfinite"] == {}
        for k, v in want_h["grad_norm"].items():
            np.testing.assert_allclose(got_h["grad_norm"][k], v, rtol=RTOL)
        got_r, want_r = _health(metrics.report()), _health(
            jax_metrics.report())
        assert set(got_r) == set(want_r)
        for k, v in want_r.items():
            np.testing.assert_allclose(got_r[k], v, rtol=RTOL, err_msg=k)
    assert got_r["health.nonfinite_total"] == 0.0


def test_sentinel_off_leaves_the_stats_as_they_were():
    _, jt, tm, tt = _pair()
    batches = _batches(2)
    js, ts = _start(jt, tm, batches[0])
    ts, m = tt.train_step(ts, batches[1])
    assert m["stats"] == {}
    assert tt.record_step_stats(m) == {"sentinel": False, "nonfinite": {},
                                       "grad_norm": {}}
    assert not [a for a in metrics._REGISTRY.values()
                if a.name.startswith("health.") and a.count]


def _plant(where, batches, k):
    """A NaN where `where` says: a table row that batch k pulls and no
    earlier batch does, or the first dense kernel's first weight."""
    earlier = set(np.concatenate(
        [b["sparse"]["categorical"].reshape(-1) for b in batches[:k]]))
    row = int(next(i for i in batches[k]["sparse"]["categorical"].reshape(-1)
                   if i not in earlier))

    def plant(d):
        if where == "table":
            d["tables"]["categorical"]["weights"][row, 3] = np.nan
        elif where == "dense":
            key = sorted(k for k in d["dense_params"] if "kernel" in k)[0]
            d["dense_params"][key].reshape(-1)[0] = np.nan
    return plant


@pytest.mark.parametrize("where,source",
                         [("table", "categorical"), ("dense", "dense"),
                          ("loss", "loss")])
def test_halt_names_the_sources_jax_names(where, source, tmp_path):
    """Steps before k record clean health; step k raises in both packages
    with the same sources, a capsule is written (it loads in both) and the
    flight recorder holds the `health/nonfinite` event."""
    _, jt, tm, tt = _pair(halt_on_nonfinite=True)
    assert tt.sentinel
    capsule.configure(str(tmp_path / "caps"))
    batches = _batches(4)
    k = 3
    if where == "loss":
        batches[k] = dict(batches[k])
        batches[k]["label"] = batches[k]["label"].copy()
        batches[k]["label"][5] = np.nan
    js, ts = _start(jt, tm, batches[0], _plant(where, batches, k))
    step = jax.jit(jt.train_step)
    for b in (batches[1:k] if where != "dense" else []):
        js, jm = step(js, b)
        assert not jt.record_step_stats(jm)["nonfinite"]
        ts, tmet = tt.train_step(ts, b)
        assert not tt.record_step_stats(tmet)["nonfinite"]
    with pytest.raises(jax_metrics.NonFiniteError) as want:
        js, jm = step(js, batches[k])
        jt.record_step_stats(jm)
    with pytest.raises(metrics.NonFiniteError) as got:
        ts, tmet = tt.train_step(ts, batches[k])
        tt.record_step_stats(tmet)
    assert source in got.value.sources
    assert set(got.value.sources) == set(want.value.sources)
    assert got.value.sources.get("loss") == want.value.sources.get("loss")
    caps = sorted(os.listdir(tmp_path / "caps"))
    assert len(caps) == 1
    cap = capsule.load(str(tmp_path / "caps" / caps[0]))
    assert cap["reason"] == "nonfinite" and cap["hlo_budget_digest"] is None
    assert jax_capsule.load(str(tmp_path / "caps" / caps[0]))["attrs"][
        "offenders"]
    events = [(e.group, e.name) for e in trace.RECORDER.events()]
    assert ("health", "nonfinite") in events


def test_halt_off_records_and_does_not_raise():
    _, _, tm, tt = _pair(sentinel=True)
    batches = _batches(3)
    ts = tt.init(batches[0])
    ts.tables["categorical"].weights[
        int(batches[1]["sparse"]["categorical"][0, 0]), 0] = float("nan")
    ts, m = tt.train_step(ts, batches[1])
    h = tt.record_step_stats(m)
    assert {"categorical", "dense", "loss"} <= set(h["nonfinite"])
    assert metrics.report()["health.nonfinite_total"] > 0


def test_stepwatch_cadence_input_timed_and_refusal():
    with pytest.raises(ValueError):
        stepwatch.StepWatch(every=0)
    _, _, tm, tt = _pair(measure_every=3)
    batches = _batches(10)
    ts = tt.init(batches[0])
    step = tt.jit_train_step()
    for b in tt.input_timed(batches[1:]):
        ts, _ = step(ts, b)
    watch = tt._ensure_stepwatch()
    assert (watch.calls, watch.samples, watch.input_waits) == (9, 3, 9)
    acc = metrics.Accumulator.get("trainer.step_ms", "hist")
    assert acc.count == 3
    assert metrics.Accumulator.get("trainer.input_wait_ms", "hist").count == 9
    # one device: no collective, no attribution
    assert not any(k.startswith("trainer.hlo_bytes")
                   for k in metrics.report())
    assert Trainer(tm, device="cpu").jit_train_step().__class__.__name__ \
        == "CompiledStep"
