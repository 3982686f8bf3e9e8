"""The port's SLOs (`utils/slo.py`), metric history (`utils/history.py`)
and capsules (`utils/capsule.py`) against the JAX package's: the same spec
file and the same observations at the same clock give the same verdicts,
breach and recovery edges and `slo.*` series; the same samples give the
same history rings, `/historz` queries and sparklines; a capsule written by
either package loads in both (the port's `hlo_budget_digest` is null, its
`memory` the ledger's `export()`)."""

import json
import os

import pytest

from openembedding_tpu.utils import capsule as jc
from openembedding_tpu.utils import history as jh
from openembedding_tpu.utils import metrics as jm
from openembedding_tpu.utils import slo as jslo
from openembedding_tpu.utils import trace as jt
from openembedding_tpu_torch.utils import capsule as tc
from openembedding_tpu_torch.utils import history as th
from openembedding_tpu_torch.utils import metrics as tm
from openembedding_tpu_torch.utils import slo as tslo
from openembedding_tpu_torch.utils import trace as tt

PKGS = {"jax": (jm, jslo, jh, jt, jc), "port": (tm, tslo, th, tt, tc)}


@pytest.fixture(autouse=True)
def _fresh():
    for m, _s, h, t, c in PKGS.values():
        with m._LOCK:
            m._REGISTRY.clear()
        h.HISTORY.clear()
        t.RECORDER.clear()
        c.configure(None)
    yield
    for _m, _s, _h, _t, c in PKGS.values():
        c.configure(None)


SPECS = [
    {"name": "p99", "metric": "serving.predict.ms", "selector": "p99",
     "op": "<=", "threshold": 50.0, "fast_window_s": 2.0,
     "slow_window_s": 6.0, "burn_threshold": 0.5},
    {"name": "fresh", "metric": "sync.freshness_ms", "threshold": 100.0,
     "fast_window_s": 1.0, "slow_window_s": 3.0},
    {"name": "never", "metric": "never.observed", "threshold": 1.0},
]


def _drive(tag, spec_path):
    m, slo, h, t, _c = PKGS[tag]
    ev = slo.SLOEvaluator(slo.load_specs(spec_path))
    verdicts = []
    for tick in range(12):
        now = 1000.0 + tick
        lat = 80.0 if 3 <= tick < 8 else 5.0
        for _ in range(20):
            m.observe("serving.predict.ms", lat, "hist",
                      labels={"model": "a"})
        m.observe("sync.freshness_ms", 150.0 if 3 <= tick < 8 else 40.0,
                  "gauge")
        verdicts.append([{k: v for k, v in d.items()}
                         for d in ev.evaluate_now(now=now)])
        h.HISTORY.sample_registry(ts=now)
    edges = [(e.name, e.attrs.get("slo")) for e in t.RECORDER.events()]
    series = {k: v for k, v in m.report().items() if k.startswith("slo.")}
    return verdicts, edges, series, ev.render_text(), ev.exit_code()


def test_same_specs_and_observations_same_verdicts(tmp_path):
    path = tmp_path / "specs.json"
    path.write_text(json.dumps(SPECS))
    want = _drive("jax", str(path))
    got = _drive("port", str(path))
    assert got == want
    fresh = [v["verdict"] for tick in got[0] for v in tick
             if v["name"] == "fresh"]
    assert "BREACHED" in fresh and fresh[-1] == "OK"
    assert ("breach", "fresh") in got[1] and ("recovered", "fresh") in got[1]
    # the histogram is cumulative: its p99 breaches and stays breached
    assert ("breach", "p99") in got[1]
    assert [v["verdict"] for v in got[0][0] if v["name"] == "never"] == [
        "UNKNOWN"]
    assert tslo.parse_spec(SPECS[0]) == tslo.SLOSpec(**SPECS[0])
    with pytest.raises(ValueError):
        tslo.parse_spec(dict(SPECS[0], bogus=1))


def test_history_rings_and_sparklines_equal():
    for tag in ("jax", "port"):
        m, _s, h, _t, _c = PKGS[tag]
        for tick in range(30):
            m.observe("trainer.step_ms", 1.0 + (tick % 7), "hist")
            m.observe("exchange.cost_drift", 0.01 * tick, "gauge",
                      labels={"table": "t"})
            m.observe("persist.committed", 1)
            h.HISTORY.sample_registry(ts=500.0 + tick)
    assert th.HISTORY.export() == jh.HISTORY.export()
    assert th.HISTORY.names() == jh.HISTORY.names()
    assert th.HISTORY.query("trainer.step_ms", window_s=5, now=529.0) == \
        jh.HISTORY.query("trainer.step_ms", window_s=5, now=529.0)
    assert th.render_sparklines() == jh.render_sparklines()
    assert th.sparkline([1, 2, 3, 2, 1]) == jh.sparkline([1, 2, 3, 2, 1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_capsules_load_in_both_packages(writer, tmp_path):
    m, _s, h, t, c = PKGS[writer]
    c.configure(str(tmp_path), min_interval_s=0.0)
    c.register_context("trainer", lambda: {"lr": 0.05})
    m.observe("health.nonfinite_total", 2.0)
    h.HISTORY.sample_registry(ts=1.0)
    t.event("health", "nonfinite", loss=1.0)
    with t.span("trainer", "step"):
        path = c.trigger("nonfinite", offenders={"loss": 1.0})
    c.unregister_context("trainer")
    assert path and os.path.exists(path)
    a, b = jc.load(path), tc.load(path)
    assert a == b
    assert a["reason"] == "nonfinite" and a["context"]["trainer"]["lr"] == 0.05
    assert a["open_spans"][0]["name"] == "step"
    assert {"version", "ts", "attrs", "flight", "history", "metrics",
            "memory", "lineage", "fingerprint", "context",
            "hlo_budget_digest"} <= set(a)
    if writer == "port":
        from openembedding_tpu_torch.utils import memwatch
        assert a["hlo_budget_digest"] is None
        assert a["memory"] == json.loads(json.dumps(memwatch.WATCH.export()))
    # rate-limited per reason, and disarmed writes nothing
    c.configure(str(tmp_path), min_interval_s=3600.0)
    assert c.trigger("x") and c.trigger("x") is None
    c.configure(None)
    assert c.trigger("y") is None and not c.enabled()
