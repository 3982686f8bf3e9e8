"""The check that decides `correct`, at a size the CPU holds: the program's
plain CPU path against the reference passes; the control (the reference
with its float32 state held in bfloat16, in the program's place) fails;
and a run whose timed path is broken underneath fails, once for each fault
a one-card training cell can have."""

import pytest

from benchmark import judge, run, spec, traffic
from benchmark.reference import deepfm

from openembedding_tpu_torch import model as program_model

SEED = 2**31 + 77


def one_chip_cells():
    return [w["name"] for w in spec.load()["workloads"] if w["chips"] == 1]


def _run(root, cell):
    bench = spec.load(root)
    return run.run(bench, cell, SEED, 0.2, False, device="cpu", root=root,
                   bench_dir=f"{root}/benchmark")


@pytest.mark.parametrize("cell", one_chip_cells())
def test_sound_program_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert list(out["metrics"]) == ["examples_per_s", "setup_s"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", one_chip_cells())
def test_control_is_not_correct(tiny, cell):
    bench = spec.load(tiny)
    parts = spec.cell_parts(bench, cell, tiny, f"{tiny}/benchmark")
    cfg, mix = parts["config"], parts["traffic"]
    windows = traffic.make_pool(mix, cfg, SEED)
    batches = [traffic.batch_of(windows, s)
               for s in range(mix["check_windows"] * mix["window"])]
    ref = deepfm.train(cfg, batches, SEED, "cpu")
    control = deepfm.train(cfg, batches, SEED, "cpu", state_dtype="bfloat16")
    ok, checks = judge.verdict(judge.numbers(control, ref, cfg),
                               cfg["limits"])
    assert not ok, checks


@pytest.mark.parametrize("cell", one_chip_cells())
def test_explain_points_at_where_a_run_departs(tiny, cell):
    bench = spec.load(tiny)
    parts = spec.cell_parts(bench, cell, tiny, f"{tiny}/benchmark")
    cfg, mix = parts["config"], parts["traffic"]
    windows = traffic.make_pool(mix, cfg, SEED)
    batches = [traffic.batch_of(windows, s)
               for s in range(mix["check_windows"] * mix["window"])]
    ref = deepfm.train(cfg, batches, SEED, "cpu")
    same = judge.explain(ref, ref, cfg)
    assert same[0].startswith("explain: 0 of ")
    assert "explain: 0 of " in [x for x in same if "table rows" in x][0]
    half = deepfm.train(cfg, batches, SEED, "cpu", half_batch=True)
    lines = judge.explain(half, ref, cfg)
    assert lines[0].startswith(f"explain: {len(batches)} of ")
    rows = [x for x in lines if "table rows" in x][0]
    assert not rows.startswith("explain: 0 of ")
    assert any(x.startswith("explain: row ") for x in lines)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(program_model.Trainer, "tables_apply",
                        lambda self, *a, **k: {})
    monkeypatch.setattr(program_model.Trainer, "dense_update",
                        lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    orig = program_model.Trainer._step

    def half(self, state, b, packed):
        n = b["label"].shape[0] // 2
        cut = {"sparse": {k: v[:n] for k, v in b["sparse"].items()},
               "dense": b["dense"][:n], "label": b["label"][:n]}
        return orig(self, state, cut, packed)
    monkeypatch.setattr(program_model.Trainer, "_step", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", one_chip_cells())
def test_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny, cell)
    assert not out["correct"], out["checks"]


def test_run_needs_a_card(tiny, tmp_path):
    import subprocess
    import sys
    for root in (spec.ROOT, tiny):
        env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
               "HOME": str(tmp_path)}
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "deepfm_d9.train", "--seed", "1", "--seconds",
                            "1", "--trace", "0"], cwd=root, env=env,
                           capture_output=True, text=True)
        assert p.returncode != 0
        assert "{" not in p.stdout

