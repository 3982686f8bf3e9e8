"""The port's self-driving placement against the JAX package's, on the JAX
acceptance scenario (`tests/test_placement.py::
test_e2e_drift_controller_closes_the_loop`) at S = 4.

A DeepFM (one 10-wide array table of 4,096 rows, hidden (16, 16), float32
tower, Adagrad(0.1), fp32 wire) trains on the drifting-Zipf stream of
`torch_placement_ranks.drift_batches`: a heavy pool of 24 ids drawn with
weights 1/(r+1) at 0.6 of the positions, homed on shard 3 for 15 steps
and on shard 1 for 15 more, batches of 64. Each side's controller gets
only a byte budget (8 rows), `mig_rows=32`, a 3-step cooldown and
cadence, and a `SkewMonitor(k=64, decay=0.85)` fed the global ids; both
start from the JAX MeshTrainer's init (`mesh_state_from_jax`).

Held equal to the JAX run: `prime`'s sizes and installed sets, the hot
ids and moves installed after every step (so the steps at which the
refreshes and migrations fire), and `status()` after every step, on every
rank. The losses, the weights and the dense params and slots after
`hot_sync` within the mesh tests' fp32 bounds (1e-6, 2e-6 for the dense
ones; `test_torch_mesh_train_int8.py`); measured: loss 6e-8, weights
7.8e-8, dense params 1.2e-7, dense slots 2.4e-7. The Adagrad accumulators
are held to 1e-5: the pool's rows take hundreds of duplicate gradients a
step, summed in other orders on the two sides, and their accumulators
reach about 1.5 in 30 steps (measured 2.6e-6, where the mesh tests' 10
steps of `synthetic_criteo` stay under 3e-8). The JAX acceptance test's
learning rate of 0.1 moves the 30-step losses apart by up to 1.7e-6, so
both sides here use the mesh tests' 0.05. The port also holds
JAX's bounds: final imbalance <= 1.15, hit ratio within 0.05 of the
sketch's prediction, `mig_hits > 0`, the `placement.*` gauges and the
`render_status()` text; and, in place of JAX's one trace, after `prime`
neither `trainer.graph_epoch` nor any state tensor's `data_ptr` moves.
"""

import threading

import jax
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.placement import PlacementController as JaxController
from openembedding_tpu.placement import PlacementPolicy as JaxPolicy
from openembedding_tpu.placement import render_status as jax_render_status
from openembedding_tpu.placement.policy import row_bytes
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu.utils.sketch import SkewMonitor as JaxMonitor
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_placement_ranks as ranks
from test_torch_mesh_train_int8 import numpy_state

S, STEPS_PER_PHASE, H = 4, 15, 8
TOL = 1e-6
SLOT_TOL = 1e-5
T = ranks.TABLE


def _cfg():
    return {"vocab": 1 << 12, "lr": 0.05, "k": 64, "decay": 0.85,
            "budget": H * row_bytes(10, 1), "mig_rows": 32, "cooldown": 3,
            "target": 1.05, "interval": 3, "H": H,
            "batches": ranks.drift_batches(S, STEPS_PER_PHASE)}


def _ids(part):
    if part is None:
        return None
    ids = np.asarray(part.ids)
    keep = ids >= 0
    out = {"ids": ids[keep].astype(np.int64).tolist()}
    if hasattr(part, "owners"):
        out["owners"] = np.asarray(part.owners)[keep].tolist()
    return out


def _jax_run(cfg):
    """The JAX controller on the same scenario (the acceptance test's
    loop) -> the same record as `ranks.controller_run`."""
    with jax_metrics._LOCK:
        jax_metrics._REGISTRY.clear()
    model = jax_make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                            compute_dtype=jax.numpy.float32)
    tr = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=cfg["lr"]),
                        mesh=jax_make_mesh(jax.devices()[:S]), wire="fp32")
    mon = JaxMonitor(k=cfg["k"], sync=True, decay=cfg["decay"])
    policy = JaxPolicy(cfg["budget"], mig_rows=cfg["mig_rows"],
                       refresh_cooldown_steps=cfg["cooldown"],
                       imbalance_target=cfg["target"])
    ctrl = JaxController(tr, policy, monitor=mon,
                         interval_steps=cfg["interval"])
    batches = cfg["batches"]
    for b in batches[:3]:
        mon.observe(T, b["sparse"][T])
    state = tr.init(batches[0])
    start = numpy_state(state)
    state = ctrl.prime(state)
    prime = {"hot_rows": tr.hot_rows, "mig_rows": tr.mig_rows,
             "hot": _ids(state.tables[T].hot),
             "mig": _ids(state.tables[T].mig), "status": ctrl.status()}
    step = tr.jit_train_step(batches[0], state)
    out = {"start": start, "prime": prime, "losses": [], "stats": [],
           "installed": [], "statuses": []}
    for i, b in enumerate(batches):
        mon.observe(T, b["sparse"][T])
        state, m = step(state, b)
        out["losses"].append(float(m["loss"]))
        out["stats"].append({k: np.asarray(v) for k, v in
                             jax.device_get(m["stats"]).items()})
        jax_metrics.record_step_stats(m["stats"])
        state = ctrl.on_step(state, step=i + 1)
        out["installed"].append({"hot": _ids(state.tables[T].hot),
                                 "mig": _ids(state.tables[T].mig)})
        out["statuses"].append(ctrl.status())
    out["render"] = jax_render_status()
    out["state"] = numpy_state(tr.hot_sync(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    # the JAX init first (the port starts from it), then both sides at once
    model = jax_make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                            compute_dtype=jax.numpy.float32)
    init = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=cfg["lr"]),
                          mesh=jax_make_mesh(jax.devices()[:S]), wire="fp32")
    cfg["state"] = numpy_state(init.init(cfg["batches"][0]))
    port = {}

    def spawn():
        try:
            port["out"] = run_local(
                ranks.controller_run, S, args=(cfg,), timeout_s=180,
                tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            port["err"] = e
    t = threading.Thread(target=spawn)
    t.start()
    want = _jax_run(cfg)
    t.join()
    if "err" in port:
        raise port["err"]
    return cfg, want, port["out"]


def test_prime_sizes_and_sets_match_jax(runs):
    _, want, port = runs
    for r in port:
        assert r["prime"]["hot_rows"] == want["prime"]["hot_rows"] \
            == {T: H}, r["prime"]
        assert r["prime"]["mig_rows"] == want["prime"]["mig_rows"]
        assert r["prime"]["hot"] == want["prime"]["hot"]
        assert r["prime"]["mig"] == want["prime"]["mig"]
        assert r["prime"]["status"] == want["prime"]["status"]
        assert r["epoch_moves_at_prime"] == 1


def test_every_step_installs_jax_decisions(runs):
    _, want, port = runs
    for r in port:
        for i, (got, exp) in enumerate(zip(r["installed"],
                                           want["installed"])):
            assert got == exp, (r["prime"], i)
        assert r["statuses"] == want["statuses"]
    st = want["statuses"][-1]
    assert st["migrations_applied"] >= 1
    assert st["last_refresh_step"][T] > STEPS_PER_PHASE


def test_losses_stats_and_tables_match_jax(runs):
    _, want, port = runs
    for r in port:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=0,
                                   atol=TOL)
        for k, (a, b) in enumerate(zip(r["stats"], want["stats"])):
            assert set(a) == set(b), k
            for key in b:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{k} {key}")
    got = mesh_state_to_jax([r["state"] for r in port])
    exp = want["state"]
    for name in ("weights",):
        np.testing.assert_allclose(got["tables"][T][name],
                                   exp["tables"][T][name], rtol=0, atol=TOL)
    for k in exp["tables"][T]["slots"]:
        np.testing.assert_allclose(got["tables"][T]["slots"][k],
                                   exp["tables"][T]["slots"][k], rtol=0,
                                   atol=SLOT_TOL)
    for part in ("dense_params", "dense_slots"):
        for k in exp[part]:
            np.testing.assert_allclose(got[part][k], exp[part][k], rtol=0,
                                       atol=2 * TOL, err_msg=k)


def test_port_holds_the_acceptance_bounds(runs):
    cfg, _, port = runs
    for r in port:
        tail = r["stats"][-3:]
        pos = np.mean([np.asarray(s[f"{T}/shard_positions"], np.float64)
                       for s in tail], axis=0)
        assert float(pos.max() / pos.mean()) <= 1.15
        last = r["stats"][-1]
        hit = float(last[f"{T}/hot_hits"]) / float(last[f"{T}/pull_indices"])
        assert abs(hit - r["predicted"][H]) < 0.05, (hit, r["predicted"])
        assert hit > 0.3
        assert float(last[f"{T}/mig_hits"]) > 0
        rep = r["report"]
        assert rep["placement.refreshes"] >= 1
        assert rep[f'placement.moved_ratio{{table="{T}"}}'] > 0
        txt = r["render"]
        assert f"hot_rows={H}" in txt and "migrations_applied=" in txt
        assert "last_refresh=step" in txt
        # after prime: no capture anew, no tensor rebound
        assert not r["epoch_moved"] and r["same_ptrs"]
        kinds = [name for name, _ in r["events"]]
        assert kinds.count("prime") == 1 and "refresh" in kinds \
            and "migrate" in kinds
    assert all(r["render"] == port[0]["render"] for r in port)
