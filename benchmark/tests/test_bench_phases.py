"""The phase metrics (`phases.py` and its readers) on the CPU: each has its
entry and its file, reads None off the card and against a program without
a timed driver, and reads the program's split on a tiny cell run as the
card would run it."""

import os
import types

import pytest
import torch

from benchmark import phases, program, run, spec, traffic

PHASE_METRICS = {"pull_ms": "trainer.pull", "probe_ms": "hash.probe_insert",
                 "tower_ms": "trainer.compute",
                 "dense_apply_ms": "trainer.dense_apply",
                 "dedup_ms": "trainer.dedup",
                 "push_ms": "trainer.sparse_apply"}


def _ctx(cfg, mix, windows, trainer, state, step, device, logged):
    k = mix["window"]
    traced = [1, 0]
    return run.Context(
        config=cfg, traffic=mix, trace=None,
        traced_batches=[j * k + s for j in traced for s in range(k)],
        unique=run.unique_counts(windows, torch.device("cpu")),
        device=device, log=logged.append, mesh=None,
        program={"trainer": trainer, "state": state, "step": step,
                 "windows": windows})


def test_every_phase_metric_has_its_entry_and_file():
    bench = spec.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in PHASE_METRICS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("ms", "lower", "program_span", "examples_per_s")
        assert m["workloads"]
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           f"{name}.py"))
    assert entries["probe_ms"]["workloads"] == ["deepfm_d9_hashed.train"]


@pytest.mark.parametrize("name", sorted(PHASE_METRICS))
def test_phase_metric_reads_none_off_the_card(name):
    ctx = run.Context(device=torch.device("cpu"))
    assert spec.reader(name).read(ctx) is None


def test_a_program_without_a_timed_driver_reads_none():
    class Untimed:
        def jit_train_many(self):
            raise AssertionError("built a driver")

    class Step:
        def _release(self):
            raise AssertionError("released the run's graphs")

    logged = []
    ctx = run.Context(device=types.SimpleNamespace(type="cuda"),
                      log=logged.append,
                      program={"trainer": Untimed(), "step": Step()})
    for name in PHASE_METRICS:
        assert spec.reader(name).read(ctx) is None
    assert len(logged) == 1


@pytest.mark.parametrize("cell", ["deepfm_d9.train",
                                  "deepfm_d9_hashed.train"])
def test_phase_split_of_a_tiny_cell(tiny, cell):
    bdir = os.path.join(tiny, "benchmark")
    parts = spec.cell_parts(spec.load(tiny), cell, tiny, bdir)
    cfg, mix = parts["config"], parts["traffic"]
    windows = traffic.make_pool(mix, cfg, 3, -1)
    trainer, state = program.build(cfg, traffic.batch_of(windows, 0),
                                   torch.device("cpu"))
    step = trainer.jit_train_many()
    step(state, windows[0])
    logged = []
    # the card's path on the CPU: the timed driver runs its eager window
    ctx = _ctx(cfg, mix, windows, trainer, state, step,
               types.SimpleNamespace(type="cuda"), logged)
    got = {name: spec.reader(name, bdir).read(ctx) for name in PHASE_METRICS}
    for name, phase in PHASE_METRICS.items():
        if phase == "hash.probe_insert" and not cfg["hashed"]:
            assert got[name] is None
        else:
            assert got[name] > 0, name
    assert got["dedup_ms"] <= got["push_ms"]
    split = ctx.__dict__[phases._KEY]
    assert sum(split[p] for p in phases.TOP) <= split["trainer.window"]
    if not cfg["hashed"]:  # the tiny hashed table overflows: fewer live rows
        assert any(": equal; inserted 0" in line for line in logged), logged
