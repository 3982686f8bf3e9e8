"""The train step's phases (`utils/phases.py`) on the CPU.

- Untimed, the step makes no timing event and no phase clock, and its
  losses are those of the timed step and of K single steps, bit for bit.
- The clock's bookkeeping against a fake event clock: nesting, sums over
  steps, self time, the top-level phases partitioning the window, and one
  wait, on the last event alone.
- A timed window on the CPU (host clock events): every phase, its counters
  against a count of the batches' ids.
- The names that `test_torch_obs_entry.py` and `chip_smoke.py` read appear
  once a step, as profiler ranges and as spans; one `trainer.pull` range.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from openembedding_tpu_torch.model import CompiledStep, Trainer
from openembedding_tpu_torch.models import from_config
from openembedding_tpu_torch.optimizers import Adagrad
from openembedding_tpu_torch.utils import metrics, phases, trace

K, B, F, D = 3, 16, 4, 3
STEP_PHASES = {"trainer.pull", "trainer.compute", "trainer.apply",
               "trainer.dense_apply", "trainer.sparse_apply", "trainer.dedup"}


def _window(seed, hashed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, size=(K, B, F)).astype(np.int64)
    if hashed:
        ids = ids * 7919 + 123456789
    return {"sparse": {"categorical": ids},
            "dense": rng.normal(size=(K, B, D)).astype(np.float32),
            "label": (rng.random((K, B)) > 0.5).astype(np.float32)}


def _step_batch(w, k):
    return {"sparse": {"categorical": w["sparse"]["categorical"][k]},
            "dense": w["dense"][k], "label": w["label"][k]}


def _fresh(hashed):
    torch.manual_seed(0)
    model = from_config({"family": "deepfm", "compute_dtype": "float32",
                         "vocabulary": -1 if hashed else 64, "dim": 4,
                         "hidden": [8], "hashed": hashed, "capacity": 512})
    tr = Trainer(model, Adagrad(learning_rate=0.05), device="cpu")
    return tr, tr.init(_step_batch(_window(0, hashed), 0))


def _bits(x):
    return x.detach().reshape(-1).numpy().view(np.int32)


@pytest.mark.parametrize("hashed", [False, True])
def test_untimed_step_makes_no_event_and_matches_timed(hashed, monkeypatch):
    windows = [_window(s, hashed) for s in (1, 2)]

    def refuse(*a, **kw):
        raise AssertionError("a timing event or clock on the untimed path")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(phases, "PhaseClock", refuse)
        tr, state = _fresh(hashed)
        many = tr.jit_train_many()
        untimed = [many(state, w)[1] for w in windows]
        assert not ({"distinct", "inserted", "phases"} & set(untimed[0]))
        assert many.phase_ms() == {}
        tr1, state1 = _fresh(hashed)
        single = [tr1.train_step(state1, _step_batch(w, k))[1]["loss"]
                  for w in windows for k in range(K)]
        tr2, state2 = _fresh(hashed)
        one = tr2.jit_train_step()
        one(state2, _step_batch(windows[0], 0))
    tr3, state3 = _fresh(hashed)
    timed_many = tr3.jit_train_many(timed=True)
    timed = [timed_many(state3, w)[1] for w in windows]
    loss = torch.cat([m["loss"] for m in untimed])
    np.testing.assert_array_equal(_bits(loss), _bits(torch.stack(single)))
    np.testing.assert_array_equal(
        _bits(loss), _bits(torch.cat([m["loss"] for m in timed])))
    np.testing.assert_array_equal(
        _bits(state.tables["categorical"].weights),
        _bits(state3.tables["categorical"].weights))


class _Tick:
    """A fake event clock: `now` advances by hand; each event remembers the
    tick it was recorded at and counts its waits."""

    now = 0.0
    waited = []

    def __init__(self):
        self.t = None

    def record(self):
        self.t = _Tick.now

    def synchronize(self):
        _Tick.waited.append(self)

    def elapsed_time(self, end):
        return end.t - self.t


def _advance(ms):
    _Tick.now += ms


def test_clock_bookkeeping_on_a_fake_clock():
    _Tick.now, _Tick.waited = 0.0, []
    with metrics._LOCK:
        metrics._REGISTRY.clear()
    with phases.clocked(None, True, event=_Tick) as clock:
        assert phases.active() is clock
        with phases.phase("trainer", "window"):
            for step in range(2):
                with phases.phase("trainer", "pull"):
                    _advance(1.0)
                    with phases.phase("hash", "probe_insert"):
                        _advance(3.0 + step)
                with phases.phase("trainer", "compute"):
                    _advance(5.0)
                with phases.phase("trainer", "apply"):
                    with phases.phase("trainer", "dense_apply"):
                        _advance(2.0)
                    with phases.phase("trainer", "sparse_apply"):
                        _advance(0.5)
                        with phases.phase("trainer", "dedup"):
                            _advance(1.0)
                _advance(0.25)  # outside the step's phases: a gap
    assert phases.active() is None
    whole = clock.ms(observe=True)
    assert whole == {"hash.probe_insert": 7.0, "trainer.pull": 9.0,
                     "trainer.compute": 10.0, "trainer.dense_apply": 4.0,
                     "trainer.dedup": 2.0, "trainer.sparse_apply": 3.0,
                     "trainer.apply": 7.0, "trainer.window": 26.5}
    own = clock.self_ms()
    assert own["trainer.pull"] == 2.0 and own["hash.probe_insert"] == 7.0
    assert own["trainer.apply"] == 0.0 and own["trainer.sparse_apply"] == 1.0
    assert own["trainer.window"] == 0.5  # the gaps between the steps
    top = sum(whole[n] for n in ("trainer.pull", "trainer.compute",
                                 "trainer.apply"))
    assert top + own["trainer.window"] == whole["trainer.window"]
    assert sum(own.values()) == whole["trainer.window"]
    # every wait was on the window's end, the last event stamped
    last = clock.intervals[-1][3]
    assert clock.intervals[-1][0] == "trainer.window"
    assert _Tick.waited and all(e is last for e in _Tick.waited)
    rep = metrics.report()
    assert rep["trainer.pull.device_ms"] == 4.5  # one observation a step
    assert rep["trainer.window.device_ms"] == 26.5


@pytest.mark.parametrize("hashed", [False, True])
def test_timed_window_on_the_cpu(hashed):
    tr, state = _fresh(hashed)
    w = _window(3, hashed)
    step = tr.jit_train_many(timed=True)
    _, m = step(state, w)
    ms = step.phase_ms()
    want = STEP_PHASES | {"trainer.window"} | (
        {"hash.probe_insert"} if hashed else set())
    assert set(ms) == want
    assert all(v > 0 for v in ms.values())
    top = ms["trainer.pull"] + ms["trainer.compute"] + ms["trainer.apply"]
    assert top <= ms["trainer.window"]
    assert ms["trainer.dedup"] <= ms["trainer.sparse_apply"]
    assert (ms["trainer.dense_apply"] + ms["trainer.sparse_apply"]
            <= ms["trainer.apply"])
    if hashed:
        assert ms["hash.probe_insert"] <= ms["trainer.pull"]
    assert len(m["phases"].intervals) == 1 + K * len(want - {"trainer.window"})
    ids = w["sparse"]["categorical"]
    distinct = sum(len(np.unique(ids[k])) for k in range(K))
    assert int(m["distinct"]) == distinct
    assert int(m["inserted"]) == (len(np.unique(ids)) if hashed else 0)
    _, m = step(state, w)  # every id has its slot now
    assert int(m["inserted"]) == 0 and int(m["distinct"]) == distinct


def test_eval_graph_refuses_timing():
    tr, _ = _fresh(False)
    with pytest.raises(ValueError):
        CompiledStep(tr, kind="eval", timed=True)


def test_step_names_appear_once_a_step():
    tr, state = _fresh(True)
    w = _window(4, True)
    trace.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            tr.train_step(state, _step_batch(w, k))
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CPU]
    for name in STEP_PHASES | {"hash.probe_insert"}:
        assert names.count(name) == 2, (name, names.count(name))
    spans = [f"{s.group}.{s.name}" for s in trace.RECORDER.spans()]
    for name in STEP_PHASES | {"hash.probe_insert"}:
        assert spans.count(name) == 2, (name, spans.count(name))
