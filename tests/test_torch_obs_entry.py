"""The Criteo entry point's six telemetry flags on the CPU.

Each flag runs the synthetic-free TSV path (`examples/train100.tsv`,
batches of 32, vocabulary 1000, 4 steps) against the same run without it:
the losses are equal bit for bit (telemetry reads, it never writes the
state), and what the flag writes parses. `--skew-report`'s ids satisfy the
sketch's bound `est - err <= true <= est` against an exact count of the
ids of the batches the sketch did not drop. Under `--mesh` at two gloo
ranks every rank runs the reporter and rank 0 alone writes the JSONL.
These replace the cases that pinned the flags' former refusals.
"""

import json
import os

import numpy as np
import pytest

from openembedding_tpu_torch.examples import criteo_deepctr
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.utils import metrics, sketch, trace

import torch_obs_ranks

TRAIN100 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "train100.tsv")
BASE = ["--device", "cpu", "--data", TRAIN100, "--batch-size", "32",
        "--vocabulary", "1000", "--steps", "4"]


@pytest.fixture(autouse=True)
def _fresh():
    with metrics._LOCK:
        metrics._REGISTRY.clear()
    trace.RECORDER.clear()
    sketch.MONITOR.reset()
    cap = trace.RECORDER.capacity
    yield
    trace.configure(cap)


@pytest.fixture(scope="module")
def plain_losses():
    return criteo_deepctr.main(BASE)["losses"]


def _run(flags, plain):
    out = criteo_deepctr.main(BASE + flags)
    np.testing.assert_array_equal(out["losses"], plain)
    return out


def test_report_interval(plain_losses, capsys):
    _run(["--report-interval", "0.01"], plain_losses)
    printed = capsys.readouterr().out
    assert "== accumulator report ==" in printed
    # the end-of-run table holds the loop's and the step's spans
    assert "train.step.ms" in printed and "trainer.compute.ms" in printed


def test_metrics_log(plain_losses, tmp_path):
    path = tmp_path / "m.jsonl"
    _run(["--metrics-log", str(path)], plain_losses)
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert records and all(set(r) == {"ts", "metrics"} for r in records)
    assert records[-1]["metrics"]["train.step.ms"] > 0


def test_profile(plain_losses, tmp_path):
    _run(["--profile", str(tmp_path / "prof")], plain_losses)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "trainer.compute" in names  # the step's profiler ranges


def test_flight_recorder(plain_losses):
    _run(["--flight-recorder", "8"], plain_losses)
    assert trace.RECORDER.capacity == 8
    assert len(trace.RECORDER.tail()) == 8


def test_trace_dump(plain_losses, tmp_path):
    path = tmp_path / "t.json"
    _run(["--trace-dump", str(path)], plain_losses)
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"trainer.pull", "trainer.compute", "trainer.apply",
            "train.step"} <= names
    by_id = {e["args"]["span_id"]: e for e in events if e["ph"] == "X"}
    nested = [e for e in events if e["name"] == "trainer.compute"
              and by_id.get(e["args"].get("parent_id"), {}).get("name")
              == "train.step"]
    assert nested  # the step's phases nest under the loop's span


def test_skew_report(plain_losses, capsys, monkeypatch):
    kept = []
    observe = sketch.MONITOR.observe

    def counting(table, ids):
        ok = observe(table, ids)
        if ok:
            kept.append(np.asarray(ids).reshape(-1))
        return ok
    monkeypatch.setattr(sketch.MONITOR, "observe", counting)
    _run(["--skew-report"], plain_losses)
    assert "== workload skew: hot ids" in capsys.readouterr().out
    sketch.MONITOR.drain()
    ids = np.concatenate(kept)
    true = dict(zip(*np.unique(ids[ids >= 0], return_counts=True)))
    top = sketch.MONITOR.sketch("categorical").topk()
    assert top
    for hid, est, err in top:
        assert est - err <= true.get(hid, 0) <= est, (hid, est, err)


def test_report_interval_and_metrics_log_under_mesh(tmp_path):
    base = BASE + ["--mesh"]
    log = str(tmp_path / "m.jsonl")
    out = run_local(torch_obs_ranks.entry_telemetry, 2,
                    args=(base, ["--report-interval", "1000",
                                 "--metrics-log", log]),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in out:
        assert r["plain"] == r["flagged"]
        # every rank folds its steps' exchange stats into its registry
        assert any(k.startswith("exchange.unique_ratio") for k in r["keys"])
        assert "train.step.ms" in r["keys"]
    # no tick within the run: the one record is rank 0's final snapshot
    records = [json.loads(line) for line in open(log)]
    assert len(records) == 1
    assert "train.step.ms" in records[0]["metrics"]
