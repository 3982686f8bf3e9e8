"""The port's device-memory ledger (`utils/memwatch.py`) and
`MeshTrainer.memory_model` against the JAX package's.

- The ledger: the same component entries in both packages' `MemWatch`
  give the same `memory.*` gauges, the same `export()`, the same
  `preflight` verdicts and the same `memory/preflight_reject` events;
  `sample_devices` reports nothing for a CPU device, as JAX's does on a CPU
  backend; shared storage (slots as column views of one array) counts
  once.
- `memory_model` on 2 gloo ranks (4 in `test_torch_memwatch_s4.py`), a
  DeepFM (10-wide table, hidden (16, 16), Adagrad) in six
  configurations: an array table alone, with 16 hot rows and 8 migrated
  rows, at the int8 wire (residuals), under ZeRO at the fp32 and at the
  int8 dense wire, and a hash table with hot rows, migration and the int8
  wire; each with a hot set and moves installed and one step taken. The
  analytic and measured views agree exactly on every component both
  price, the ledger's gauges carry them, and the port's analytic figure
  equals the JAX MeshTrainer's on every component: the port's layouts
  take the JAX package's bytes (an array table's probe keys are int32 in
  both, a hash table's one int64 lane where JAX keeps a uint32 pair: 8
  bytes either way; the overflow counter 4 bytes in both).
- The preflights of the JAX package's `tests/test_flightdata.py`: a hot
  cache's fill under a 64-byte budget keeps the state cache-free (one
  `memory/preflight_reject` event, reason "hot_fill") and goes through
  with room; a controller's `prime` under an 8-byte budget keeps the
  current sizes and records `placement/prime_rejected`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.utils import memwatch as jax_memwatch
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu.utils import trace as jax_trace
from openembedding_tpu_torch import data
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.utils import memwatch, metrics, trace

import torch_placement_ranks as ranks

T = ranks.TABLE


def _batches(hashed):
    return list(data.synthetic_criteo(
        64, id_space=(1 << 40) if hashed else 1000, steps=3, seed=7))


def _jax_models(S):
    out = {}
    for name, (hashed, kw) in ranks.MEM_CONFIGS.items():
        batches = _batches(hashed)
        model = jax_make_deepfm(1000, 9, hidden=(16, 16), hashed=hashed,
                                capacity=4096 if hashed else 0,
                                compute_dtype=jnp.float32)
        tr = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                            mesh=jax_make_mesh(jax.devices()[:S]),
                            **{"wire": "fp32", **kw})
        out[name] = tr.memory_model(tr.init(batches[0]))
    return out


def memory_model_tests(S):
    """(the module fixture, the tests) of the memory model at S ranks."""
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        cfg = {"batches": _batches(False), "hash_batches": _batches(True)}
        port = run_local(ranks.memory_models, S, args=(cfg,), timeout_s=120,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return _jax_models(S), port

    @pytest.mark.parametrize("config", sorted(ranks.MEM_CONFIGS))
    def test_analytic_equals_measured_and_jax(runs, config):
        jax_models, port = runs
        hashed, kw = ranks.MEM_CONFIGS[config]
        want = jax_models[config]["analytic"]
        for r in port:
            got = r[config]
            a, m = got["analytic"], got["measured"]
            assert set(a) == set(m), (set(a) ^ set(m))
            for key in sorted(a):
                assert a[key] == m[key], (key, a[key], m[key])
            assert got["total"] == sum(m.values())
            expect = {f"table_weights/{T}", f"table_slots/{T}",
                      "dense_params"}
            if hashed:
                expect.add(f"table_keys/{T}")
            if kw.get("wire") == "int8":
                expect.add(f"table_ef/{T}")
            if kw.get("hot_rows"):
                expect |= {f"hot/{T}", f"mig/{T}"}
                assert m[f"hot/{T}"] == got["hot_bytes"]
            if kw.get("dense_shard"):
                expect.add("zero_slots")
                if kw.get("dense_wire") == "int8":
                    expect |= {"zero_ef", "zero_master"}
            else:
                expect.add("dense_slots")
            assert set(a) == expect
            # the port prices every component as the JAX package does
            assert set(a) == set(want)
            for key in want:
                assert a[key] == want[key], (key, a[key], want[key])
            # the ledger's gauges
            g = got["gauges"]
            assert g["memory.total_bytes"] == got["total"]
            for key, v in m.items():
                comp, _, table = key.partition("/")
                lbl = (f'{{component="{comp}",table="{table}"}}' if table
                       else f'{{component="{comp}"}}')
                assert g[f"memory.bytes{lbl}"] == v
            assert got["export"]["device_total_bytes"] == got["total"]
            assert "memory.hbm_used" not in g  # a CPU device: no stats

    return runs, test_analytic_equals_measured_and_jax


runs, test_memory_model_analytic_equals_measured_and_jax = \
    memory_model_tests(2)


@pytest.fixture
def fresh():
    def wipe():
        for w in (memwatch.WATCH, jax_memwatch.WATCH):
            w.clear()
            w.configure(None)
            w.__dict__.pop("_last_device_stats", None)
        with metrics._LOCK:
            metrics._REGISTRY.clear()
        with jax_metrics._LOCK:
            jax_metrics._REGISTRY.clear()
        trace.RECORDER.clear()
        jax_trace.RECORDER.clear()
    wipe()
    yield
    wipe()


ENTRIES = [("table_weights", 4000, {"table": "a"}, False),
           ("table_slots", 4000, {"table": "a"}, False),
           ("hot", 1288, {"table": "a"}, False),
           ("dense_params", 1234, None, False),
           ("zero_slots", 640, None, False),
           ("host_store", 99999, {"table": "h"}, True)]


def _memory_gauges(report):
    return {k: v for k, v in report.items() if k.startswith("memory.")}


@pytest.mark.parametrize("budget", [None, 10000, 20000])
def test_ledger_matches_jax_memwatch(fresh, budget):
    port, ref = memwatch.MemWatch(budget), jax_memwatch.MemWatch(budget)
    for w in (port, ref):
        for comp, b, lbl, host in ENTRIES:
            w.set_component(comp, b, labels=lbl, host=host)
        w.set_component("hot", 1300, labels={"table": "a"})  # idempotent key
    assert port.entries() == ref.entries()
    assert port.total_bytes() == ref.total_bytes() == 11174
    assert port.total_bytes(True) == ref.total_bytes(True)
    port.publish()
    ref.publish()
    assert _memory_gauges(metrics.report()) == \
        _memory_gauges(jax_metrics.report())
    for delta in (-5, 0, 1, 5000, 8826, 8827, 10**9):
        assert port.preflight(delta, reason=f"ask{delta}") == \
            ref.preflight(delta, reason=f"ask{delta}")
    ev = [(e.name, e.attrs) for e in trace.RECORDER.tail()
          if getattr(e, "group", None) == "memory"]
    want = [(e.name, e.attrs) for e in jax_trace.RECORDER.tail()
            if getattr(e, "group", None) == "memory"]
    assert ev == want and (len(ev) > 0) == (budget is not None)
    assert _memory_gauges(metrics.report()) == \
        _memory_gauges(jax_metrics.report())
    assert port.sample_devices("cpu") is None
    assert ref.sample_devices() is None
    assert port.export() == ref.export()
    port.clear("hot")
    ref.clear("hot")
    assert port.export() == ref.export()
    port.clear()
    assert port.entries() == [] and port.total_bytes() == 0


def test_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("OETPU_HBM_BUDGET", "4096")
    assert memwatch.MemWatch().budget_bytes == \
        jax_memwatch.MemWatch().budget_bytes == 4096
    assert memwatch.MemWatch(7).budget_bytes == 7
    monkeypatch.delenv("OETPU_HBM_BUDGET")
    assert memwatch.MemWatch().budget_bytes is None


def test_tree_bytes_count_shared_storage_once():
    base = torch.zeros((100, 20))
    a, b = base[:, :10], base[:, 10:]          # column views of one array
    assert memwatch.tree_device_bytes({"a": a, "b": b}) == base.nbytes
    assert memwatch.tree_device_bytes([a]) == a.numel() * 4
    assert memwatch.tree_device_bytes([base, base]) == base.nbytes
    row = torch.zeros(8, dtype=torch.int32)
    assert memwatch.tree_device_bytes(
        (row, np.zeros(3, np.int64), {"x": None})) == 32 + 24
    assert memwatch.array_device_bytes(torch.zeros((3, 5),
                                                   dtype=torch.bfloat16)) == 30
    assert memwatch.array_device_bytes(np.zeros((2, 2), np.float32)) == 16


def test_hot_fill_and_prime_preflights(tmp_path):
    cfg = {"batches": _batches(False)}
    out = run_local(ranks.preflight_cases, 2, args=(cfg,), timeout_s=120,
                    tmp_dir=str(tmp_path))
    for r in out:
        assert r["fill_rejected"] and r["fill_rejects"] == 1.0
        assert [e["reason"] for e in r["fill_events"]] == ["hot_fill"]
        assert r["fill_installed"]["ids"] == [0, 1, 2, 3]
        assert not r["prime_hot_rows"] and not r["prime_mig_rows"]
        assert r["prime_hot"] and not r["prime_epoch_moved"]
        assert "prime_rejected" in r["prime_events"]
