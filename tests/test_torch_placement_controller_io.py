"""The port's placement controller, two more of the JAX package's
acceptance tests (`tests/test_placement.py`), through the port:

- `test_checkpoint_export_delta_byte_identical` at S = 4: a
  controller-driven run's sharded checkpoint, standalone export and
  incremental-persist deltas equal a placement-off run's on the same
  batches byte for byte (fp32 wire: training is bit-equal through the hot
  cache and the migration annex, and `hot_sync` writes both back before
  every reader), and the losses are equal;
- `test_controller_background_watcher_parks_decisions` at S = 2: the
  watcher thread computes decisions off the training thread and parks
  them. At S > 1 a parked decision is installed at the next cadence step,
  where every rank meets (the JAX controller installs it at the next
  `on_step`): an off-cadence `on_step` leaves it parked, the cadence step
  installs rank 0's set on every rank.

And `MeshTrainer.refresh_hot_rows` from the sketches at S = 2 (`monitor=`,
the trainer's `enable_skew_monitor()` feed, the global monitor), against
the JAX MeshTrainer's on the same sketch, each rank's sketch fed other
ids: every rank installs rank 0's top-H.
"""

import os

import numpy as np

from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.placement.policy import row_bytes

import torch_placement_ranks as ranks

T = ranks.TABLE


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(d, fn)
            out[os.path.relpath(full, root)] = full
    return out


def _same_files(off, on, skip):
    a, b = _tree(off), _tree(on)
    assert a.keys() == b.keys() and a
    n = 0
    for rel, p_off in a.items():
        if os.path.basename(rel) in skip:
            continue
        if rel.endswith(".npz"):
            with np.load(p_off) as x, np.load(b[rel]) as y:
                assert sorted(x.files) == sorted(y.files), rel
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k],
                                                  err_msg=f"{rel}:{k}")
        else:
            with open(p_off, "rb") as fa, open(b[rel], "rb") as fb:
                assert fa.read() == fb.read(), f"differs: {rel}"
        n += 1
    assert n > 0


def test_checkpoint_export_delta_byte_identical(tmp_path):
    S = 4
    cfg = {"vocab": 1 << 12, "budget": 8 * row_bytes(10, 1),
           "batches": ranks.drift_batches(S, 6, seed=7),
           "off": str(tmp_path / "off"), "on": str(tmp_path / "on")}
    out = run_local(ranks.persistence_runs, S, args=(cfg,), timeout_s=120,
                    tmp_dir=str(tmp_path))
    for r in out:
        assert r["on"]["losses"] == r["off"]["losses"]
        assert r["on"]["status"] == out[0]["on"]["status"]
    st = out[0]["on"]["status"]
    assert st["primed"] and st["hot_rows"] == {T: 8}
    _same_files(tmp_path / "off" / "ckpt", tmp_path / "on" / "ckpt",
                skip=("model_meta",))
    _same_files(tmp_path / "off" / "export", tmp_path / "on" / "export",
                skip=("model_meta", "model_meta.json"))
    # the delta payloads (`table_*.npz`; a delta's meta carries its time)
    off, on = _tree(tmp_path / "off" / "persist"), \
        _tree(tmp_path / "on" / "persist")
    deltas = sorted(p for p in off if os.path.basename(p).startswith("table_"))
    assert deltas and deltas == sorted(
        p for p in on if os.path.basename(p).startswith("table_"))
    for rel in deltas:
        with np.load(off[rel]) as x, np.load(on[rel]) as y:
            assert sorted(x.files) == sorted(y.files), rel
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k],
                                              err_msg=f"{rel}:{k}")


def test_controller_background_watcher_parks_decisions(tmp_path):
    S = 2
    rng = np.random.default_rng(0)
    heavy = np.repeat(np.arange(8) * S + S - 1, 8)
    batch = {"sparse": {T: np.resize(heavy, (64, 26)).astype(np.int32)},
             "dense": rng.normal(size=(64, 13)).astype(np.float32),
             "label": np.zeros((64,), np.float32)}
    cfg = {"vocab": 1 << 12, "budget": 4 * row_bytes(10, 1),
           "batch": batch}
    out = run_local(ranks.watcher_run, S, args=(cfg,), timeout_s=120,
                    tmp_dir=str(tmp_path))
    lead = out[0]
    assert lead["parked"] is not None, "watcher never parked a decision"
    assert lead["parked"]["refresh"] and lead["still_parked"]
    for r in out:
        assert not r["left"]
        assert r["hot"]["ids"] == lead["parked"]["hot"]
        assert r["status"] == lead["status"]
    assert lead["status"]["last_refresh_step"][T] == 2


def test_refresh_hot_rows_from_the_sketches_installs_rank0_top_h(tmp_path):
    """`refresh_hot_rows(state, monitor=...)`, `refresh_hot_rows(state)`
    with the trainer's feed and with the global monitor: each installs the
    sketch's top-H (migrated ids skipped) as the JAX MeshTrainer installs
    it from the same sketch, and every rank installs rank 0's set though
    each rank's sketch saw other ids."""
    import jax
    import jax.numpy as jnp

    import openembedding_tpu as jax_embed
    from openembedding_tpu.models import make_deepfm as jax_make_deepfm
    from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
    from openembedding_tpu.parallel import make_mesh as jax_make_mesh
    from openembedding_tpu.utils.sketch import SkewMonitor as JaxMonitor
    S, H = 2, 8
    rng = np.random.default_rng(11)
    skews = [np.repeat(rng.choice(4096, 40, replace=False),
                       rng.integers(1, 30, 40)) for _ in range(3)]
    moves = (skews[0][:2].astype(np.int64), np.asarray([0, 1]))
    cfg = {"vocab": 1 << 12, "H": H, "skews": skews, "moves": moves,
           "batches": ranks.drift_batches(S, 1)}
    out = run_local(ranks.sketch_refresh, S, args=(cfg,), timeout_s=120,
                    tmp_dir=str(tmp_path))
    model = jax_make_deepfm(1 << 12, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    tr = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                        mesh=jax_make_mesh(jax.devices()[:S]), wire="fp32",
                        hot_rows=H, mig_rows=4)
    state = tr.init(cfg["batches"][0])
    state = tr.migrate_rows(state, moves={T: moves})
    for k, key in enumerate(("monitor", "trainer_feed", "global")):
        mon = JaxMonitor(k=32, sync=True)
        mon.observe(T, skews[k])
        state = tr.refresh_hot_rows(state, monitor=mon)
        want = tr._np_id_list(state.tables[T].hot.ids).tolist()
        assert set(moves[0].tolist()).isdisjoint(want)
        for r in out:
            assert r[key]["ids"] == want, (key, r[key], want)
    assert out[0]["set_size"] == H
