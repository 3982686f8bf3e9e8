"""The port's metrics registry (`utils/metrics.py`) against the JAX
package's, on the same calls.

- One seeded sequence of `observe` calls (every kind, labels, histograms
  over the whole bucket range) gives equal `report()`, `prometheus_text()`
  line for line and equal JSONL records (`PeriodicReporter`).
- `parse_prometheus` / `merge_prometheus` of either package read the other
  package's scrape and merge to the same text.
- `record_step_stats` on one stats dict (per-shard vector stats, hot-row
  and migration stats, sentinel stats with a NaN) gives equal gauges and
  an equal health summary; the port is handed torch tensors (read in one
  copy), JAX numpy. All exact: both fold the same float64 values.
"""

import json

import numpy as np
import pytest
import torch

from openembedding_tpu.utils import metrics as jm
from openembedding_tpu.utils import trace as jt
from openembedding_tpu_torch.utils import metrics as tm
from openembedding_tpu_torch.utils import trace as tt


@pytest.fixture(autouse=True)
def _fresh():
    for m in (jm, tm):
        with m._LOCK:
            m._REGISTRY.clear()
    for t in (jt, tt):
        t.RECORDER.clear()
    yield


def _calls(seed=3, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ("sum", "avg", "max", "gauge", "hist")[i % 5]
        name = f"grp.{kind}_metric"
        labels = ({"table": f"t{rng.integers(3)}"} if rng.random() < 0.5
                  else None)
        out.append((name, float(rng.lognormal(0.0, 3.0)), kind, labels))
    return out


def _both(fn):
    return fn(jm), fn(tm)


def test_observe_sequence_reports_and_scrapes_equal():
    for m in (jm, tm):
        for name, v, kind, labels in _calls():
            m.observe(name, v, kind, labels=labels)
    want, got = _both(lambda m: m.report())
    assert got == want
    want, got = _both(lambda m: m.prometheus_text())
    assert got.splitlines() == want.splitlines()
    assert _both(lambda m: m.report_table())[0] == tm.report_table()
    want, got = _both(lambda m: m.report(reset=True))
    assert got == want
    assert jm.report() == tm.report()


def test_jsonl_records_equal(tmp_path):
    recs = {}
    for tag, m in (("jax", jm), ("port", tm)):
        for name, v, kind, labels in _calls(seed=5, n=100):
            m.observe(name, v, kind, labels=labels)
        path = tmp_path / f"{tag}.jsonl"
        rep = m.PeriodicReporter(0, jsonl_path=str(path), history=False)
        rep.start()
        rep.stop()
        recs[tag] = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(recs["jax"]) == len(recs["port"]) == 1
    assert recs["jax"][0]["metrics"] == recs["port"][0]["metrics"]
    assert set(recs["port"][0]) == {"ts", "metrics"}


def test_parse_and_merge_read_either_scrape():
    for m in (jm, tm):
        for name, v, kind, labels in _calls(seed=9, n=150):
            m.observe(name, v, kind, labels=labels)
    jax_text, port_text = jm.prometheus_text(), tm.prometheus_text()
    assert tm.parse_prometheus(jax_text) == jm.parse_prometheus(jax_text)
    assert jm.parse_prometheus(port_text) == tm.parse_prometheus(port_text)
    scrapes = [("a", jax_text), ("b", port_text)]
    merged = tm.merge_prometheus(scrapes)
    assert merged == jm.merge_prometheus(scrapes)
    # the fleet count of a histogram is the sum of the parts'
    parsed = tm.parse_prometheus(merged)
    counts = [v for n, lab, v in parsed["samples"]
              if n == "oetpu_grp_hist_metric_count" and not lab]
    parts = [v for n, lab, v in tm.parse_prometheus(port_text)["samples"]
             if n == "oetpu_grp_hist_metric_count" and not lab]
    assert counts == [2 * parts[0]]


def _stats():
    rng = np.random.default_rng(11)
    S = 4
    st = {}
    for t in ("user", "item"):
        st[f"{t}/pull_indices"] = np.float32(512)
        st[f"{t}/pull_unique"] = np.float32(rng.integers(100, 500))
        st[f"{t}/pull_overflow"] = np.int32(rng.integers(3))
        st[f"{t}/shard_rows"] = rng.integers(0, 200, S).astype(np.int32)
        st[f"{t}/shard_positions"] = rng.integers(1, 300, S).astype(np.int32)
        st[f"{t}/bucket_fill"] = rng.random(S).astype(np.float32)
        st[f"{t}/hot_hits"] = np.float32(rng.integers(0, 512))
        st[f"{t}/hot_unique"] = np.float32(rng.integers(0, 64))
        st[f"{t}/hot_bytes_saved"] = np.float32(rng.integers(0, 1 << 20))
        st[f"{t}/mig_unique"] = np.float32(rng.integers(0, 32))
        st[f"{t}/mig_hits"] = np.float32(rng.integers(0, 100))
        st[f"{t}/grad_sumsq"] = np.float32(rng.random() * 10)
        st[f"{t}/grad_nonfinite"] = np.float32(0)
        st[f"{t}/ef_abs_sum"] = np.float32(rng.random())
        st[f"{t}/ef_elems"] = np.float32(4096)
        st[f"{t}/quant_err_sumsq"] = np.float32(rng.random() * 1e-3)
    st["item/grad_sumsq"] = np.float32(np.nan)
    st["item/grad_nonfinite"] = np.float32(7)
    st["health/loss_nonfinite"] = np.float32(1)
    st["health/dense_grad_sumsq"] = np.float32(np.inf)
    st["health/dense_grad_nonfinite"] = np.float32(3)
    st["dense/grad_density"] = np.float32(0.25)
    st["user_overflow"] = np.int32(2)
    return st


def test_record_step_stats_gauges_and_health_equal():
    st = _stats()
    want = jm.record_step_stats(dict(st))
    got = tm.record_step_stats({k: torch.from_numpy(np.array(v))
                                for k, v in st.items()})
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["nonfinite"] == {"item": 7.0, "dense": 3.0, "loss": 1.0}
    a, b = jm.report(), tm.report()
    assert set(a) == set(b)
    for k in a:
        assert (np.isnan(a[k]) and np.isnan(b[k])) or a[k] == b[k], k
    assert ("health", "nonfinite") in [(e.group, e.name)
                                       for e in tt.RECORDER.events()]
    # numpy values and plain floats are taken as they are
    tm.record_step_stats({"x/pull_indices": np.float32(3), "y": 2.0})
    assert tm.report()["x.pull_indices"] == 3.0


def test_host_values_reads_every_tensor_in_one_copy(monkeypatch):
    """The dict's tensors are concatenated and copied once per device."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    out = tm._host_values({"a": torch.ones(3), "b": torch.tensor(2.0),
                           "c": torch.zeros(2, 2, dtype=torch.int32),
                           "d": 5.0})
    assert calls == [(8,)]
    assert out["a"].shape == (3,) and out["b"].shape == ()
    assert out["c"].dtype == np.float64 and out["d"] == 5.0


def test_nonfinite_error_message_and_sources():
    e, f = jm.NonFiniteError({"loss": 1.0, "t": 2}), tm.NonFiniteError(
        {"loss": 1.0, "t": 2})
    assert str(e) == str(f) and e.sources == f.sources
