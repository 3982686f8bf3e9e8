"""The placement controller's wire management (`manage_wire=True`)
through the port against the JAX package's, at S = 2.

A DeepFM (10-wide table, hidden (16, 16)) under ZeRO at the int8 dense
wire, the table's wire fp32 at start, on the drifting-Zipf stream of
`torch_placement_ranks.drift_batches` (the pool's 24 ids carry 0.6 of the
traffic, so `recommend_wire` picks int8 for the table). Both sides start
from the JAX MeshTrainer's state. `prime` installs the recommendation
(the table's int8 wire and its residuals) and turns the dense stats on;
a direct `apply_wire` to bf16 before step 5 drops the residuals, the next
cadence step's recommendation brings int8 back; the measured
`dense.grad_density` gauge is replaced before every `on_step` by a
schedule (0.05 for six steps, 0.5 for two, 0.05 again) that makes
`apply_dense_wire` flip to sparse_topk, back to int8 after the 4-step
cooldown, and refuse the next flip inside it.

Held equal to the JAX run after prime and every step, on both ranks:
`status()` (formats, rejit counts, the dense-wire reason strings), the
trainer's `wire` dict, dense wire and k, the dense stats flag and whether
the table carries residuals. And `trainer.graph_epoch` moves once per real
change (prime's one, each real format change, each dense flip) and never
for a no-op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.placement import PlacementController as JaxController
from openembedding_tpu.placement import PlacementPolicy as JaxPolicy
from openembedding_tpu.placement.policy import row_bytes
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu.utils.sketch import SkewMonitor as JaxMonitor
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_placement_ranks as ranks
from test_torch_mesh_train_int8 import numpy_state

S = 2
T = ranks.TABLE
DENSITY = [0.05] * 6 + [0.5] * 2 + [0.05] * 2


def _jax_trainer(cfg):
    model = jax_make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    return JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                          mesh=jax_make_mesh(jax.devices()[:S]), wire="fp32",
                          dense_shard=True, dense_wire="int8")


def _jax_run(cfg):
    with jax_metrics._LOCK:
        jax_metrics._REGISTRY.clear()
    tr = _jax_trainer(cfg)
    mon = JaxMonitor(k=64, sync=True, decay=0.9)
    policy = JaxPolicy(cfg["budget"], mig_rows=16, refresh_cooldown_steps=3)
    policy.dense_wire_cooldown_steps = cfg["dense_cooldown"]
    ctrl = JaxController(tr, policy, monitor=mon, interval_steps=2,
                         manage_wire=True)
    batches = cfg["batches"]
    for b in batches[:3]:
        mon.observe(T, b["sparse"][T])
    state = tr.init(batches[0])
    cfg["state"] = numpy_state(tr.dense_to_replicated(state))
    state = ctrl.prime(state)

    def snap():
        return {"status": ctrl.status(), "wire": tr.wire,
                "dense_wire": tr.dense_wire, "dense_topk": tr.dense_topk,
                "dense_stats": tr.dense_stats,
                "ef": state.tables[T].ef is not None}
    out = {"prime": snap(), "steps": []}
    for i, b in enumerate(batches):
        if i + 1 == cfg["bf16_at"]:
            state = ctrl.apply_wire(state, {T: "bf16"})
            out["after_bf16"] = snap()
        mon.observe(T, b["sparse"][T])
        state, m = tr.jit_train_step(b, state)(state, b)
        jax_metrics.record_step_stats(m["stats"])
        jax_metrics.observe("dense.grad_density", cfg["density"][i],
                            "gauge")
        state = ctrl.on_step(state, step=i + 1)
        out["steps"].append(snap())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = {"vocab": 1 << 12, "budget": 8 * row_bytes(10, 1),
           "dense_cooldown": 4, "bf16_at": 5, "density": DENSITY,
           "batches": ranks.drift_batches(S, len(DENSITY) // 2)}
    want = _jax_run(cfg)
    port = run_local(ranks.wire_run, S, args=(cfg,), timeout_s=120,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return want, port


def _same(got, want):
    g = {k: v for k, v in got.items() if k != "epoch"}
    assert g == want


def test_wire_decisions_match_jax(runs):
    want, port = runs
    for r in port:
        _same(r["prime"], want["prime"])
        _same(r["after_bf16"], want["after_bf16"])
        assert len(r["steps"]) == len(want["steps"])
        for got, exp in zip(r["steps"], want["steps"]):
            _same(got, exp)
    p = want["prime"]
    assert p["wire"] == {T: "int8", "*": "fp32"} and p["ef"]
    assert p["dense_stats"]
    assert want["after_bf16"]["wire"][T] == "bf16" \
        and not want["after_bf16"]["ef"]
    modes = [s["dense_wire"] for s in want["steps"]]
    assert "sparse_topk" in modes and modes[-1] == "int8"
    assert "cooldown" in want["steps"][-1]["status"]["dense_wire_reason"]


def test_graph_epoch_moves_once_per_real_change(runs):
    _, port = runs
    for r in port:
        assert r["prime"]["epoch"] == 1
        prev = r["prime"]
        snaps = [r["after_bf16"]] + r["steps"]
        bf16_at = 4  # after the fourth step's snapshot
        seq = r["steps"][:bf16_at] + [r["after_bf16"]] + r["steps"][bf16_at:]
        assert snaps
        for s in seq:
            st, pst = s["status"], prev["status"]
            changes = ((st["wire_rejits"] - pst["wire_rejits"])
                       + (st["dense_wire_rejits"]
                          - pst["dense_wire_rejits"]))
            assert s["epoch"] - prev["epoch"] == changes, s
            prev = s
        assert r["steps"][-1]["status"]["wire_rejits"] == 3
        assert r["steps"][-1]["status"]["dense_wire_rejits"] == 2
        assert r["measured_density"] is not None
