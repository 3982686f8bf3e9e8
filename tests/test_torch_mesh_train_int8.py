"""The port's MeshTrainer with skew-aware placement against the JAX
package's: 10-step trajectories.

The model and data of `test_torch_mesh_train.py` (a DeepFM with one
10-wide table, hidden (16, 16), float32 tower, Adagrad(0.05), batches of
64 from `synthetic_criteo`). Both sides start from the JAX MeshTrainer's
init carried across (`convert.mesh_state_from_jax`, its empty hot cache,
directory and zero residuals included), install the same hot set
(`refresh_hot_rows`, the 16 most frequent ids) and moves (`migrate_rows`,
8 ids one shard over) before step 0 and other ones before step 5, and end
with `hot_sync`. Compared: losses, the summed stats (equal), tables,
slots, residuals, caches and annexes, dense params and slots, and a hash
table's keys and overflow (bit-exact).

Configurations: the int8 wire with error feedback, alone and with hot
rows, migration and the int8 `hot_wire` ("int8 with all"); hot rows,
migration and both at the fp32 wire. A file each keeps a file's run well
under 40 s: this one runs both int8 ones on array tables at S = 2;
`test_torch_mesh_train_placement.py` fp32 hot rows and fp32 migration
(array, S = 2); `test_torch_mesh_train_int8_hash.py` int8 with all on hash
tables (2^40 id space) at S = 2; `test_torch_mesh_train_int8_s4.py` int8
with all on array tables at S = 4; `test_torch_mesh_train_int8_s4_hash.py`
fp32 hot rows with migration on hash tables at S = 4.

Tolerances. At the fp32 wire the bounds of `test_torch_mesh_train.py`
hold (measured over the three fp32 configurations, array and hash, S = 2
and 4: loss 1.2e-7, tables 1.1e-8, slots 3e-8, caches and annexes 1.1e-8,
dense params 6e-8, dense slots 2.4e-7; held to 1e-6, and 2e-6 for the
dense slots). At the int8 wire a float32 ulp between the two sides' dense
gradients (their sums run in other orders) changes the dither, which
hashes the value's bits, so a pushed code moves by one step of its
block's scale (1/127 of the block's max); Adagrad and the next pulls
carry that on. Measured over the two int8 configurations, array and hash,
S = 2 and 4 (10 steps): loss 2.7e-4, tables 7.2e-4, slots 1.4e-4,
residuals 5.3e-4, caches 4.8e-4, annexes 6.2e-4, dense params 5.4e-3,
dense slots 9.8e-3. Held to 1e-3 (loss), 2e-3 (tables, residuals, caches,
annexes), 5e-4 (slots) and 2e-2 (dense params and slots). Step 0's loss,
before any rounding has moved apart, is held to 1e-6 (measured 6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import data
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

VOCAB, BATCH, STEPS, CAPACITY = 1000, 64, 10, 4096
H, M = 16, 8
# (name, wire, hot_rows, mig_rows, hot_wire)
CONFIGS = [("int8-ef", "int8", 0, 0, None),
           ("int8-ef-hot-mig-hot_int8", "int8", H, M, "int8"),
           ("fp32-hot", "fp32", H, 0, None),
           ("fp32-mig", "fp32", 0, M, None),
           ("fp32-hot-mig", "fp32", H, M, None)]
TOL = {"fp32": {"loss": 1e-6, "table": 1e-6, "slot": 1e-6, "dense": 2e-6},
       "int8": {"loss": 1e-3, "table": 2e-3, "slot": 5e-4, "dense": 2e-2}}


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.array(x)


def numpy_state(js):
    """A JAX TrainState as numpy (`train_state_from_jax`'s arguments), the
    placement state and residuals included."""
    tables = {}
    for n, t in js.tables.items():
        d = {"weights": np.array(t.weights),
             "slots": {k: np.array(v) for k, v in t.slots.items()}}
        if t.keys is not None:
            d["keys"], d["overflow"] = np.array(t.keys), int(t.overflow)
        if t.ef is not None:
            d["ef"] = np.array(t.ef)
        for kind, fields in (("hot", ("keys", "rank", "ids")),
                             ("mig", ("keys", "rank", "ids", "owners"))):
            part = getattr(t, kind)
            if part is not None:
                d[kind] = {k: _tree(getattr(part, k))
                           for k in fields + ("weights", "slots")}
        tables[n] = d
    return dict(
        tables=tables,
        dense_params={k: np.array(v) for k, v in
                      _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v) for k, v in
                     _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _batches(hashed, steps=STEPS):
    return list(data.synthetic_criteo(
        BATCH, id_space=(1 << 40) if hashed else VOCAB, steps=steps, seed=7))


def _placement(batches, S):
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in batches])
    u, c = np.unique(ids, return_counts=True)
    top = u[np.argsort(-c, kind="stable")]
    return ({0: top[:H], 5: top[4:H + 4]},
            {0: (top[20:20 + M], (top[20:20 + M] + 1) % S),
             5: (top[24:24 + M - 2], (top[24:24 + M - 2] + 2) % S)})


def _jax_run(S, kind, config, tmp=None, steps=STEPS):
    name, wire, hot_rows, mig_rows, hot_wire = config
    hashed = kind == "hash"
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32, hashed=hashed,
                            capacity=CAPACITY if hashed else 0)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:S]),
                             wire=wire, hot_rows=hot_rows, mig_rows=mig_rows,
                             hot_wire=hot_wire)
    batches = _batches(hashed, steps)
    hot_ids, moves = _placement(batches, S)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    step = trainer.jit_train_step(batches[0], state)
    losses, stats = [], []
    for k, b in enumerate(batches):
        if k in hot_ids and trainer.hot_enabled:
            state = trainer.refresh_hot_rows(
                state, hot_ids={"categorical": hot_ids[k]})
        if k in moves and trainer.mig_enabled:
            state = trainer.migrate_rows(state,
                                         moves={"categorical": moves[k]})
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        stats.append({k: np.asarray(v) for k, v in m["stats"].items()})
    state = trainer.hot_sync(state)
    if tmp is not None:
        trainer.save(state, tmp)
    cfg = {"vocab": VOCAB, "hashed": hashed, "capacity": CAPACITY,
           "wire": wire, "hot_rows": hot_rows, "mig_rows": mig_rows,
           "hot_wire": hot_wire, "state": start, "batches": batches,
           "hot_ids": hot_ids, "moves": moves}
    return cfg, losses, stats, numpy_state(state)


def trajectory_tests(S, kind, configs=CONFIGS):
    """(the module fixture, the test) of `configs` at S ranks: the JAX runs,
    then every configuration on S port ranks (one launch), compared."""
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        jax_runs = [_jax_run(S, kind, c) for c in configs]
        port = run_local(ranks.placement_trajectories, S,
                         args=([cfg for cfg, *_ in jax_runs],),
                         timeout_s=120,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return jax_runs, port

    @pytest.mark.parametrize("config", configs, ids=lambda c: c[0])
    def test_ten_steps_with_placement_match_the_jax_mesh_trainer(runs,
                                                                 config):
        jax_runs, port = runs
        i = configs.index(config)
        check(S, config, jax_runs[i], [port[r][i] for r in range(S)])

    return runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=what)


def check(S, config, jax_run, port):
    name, wire, hot_rows, mig_rows, _ = config
    tol = TOL["int8" if wire == "int8" else "fp32"]
    _, want_losses, want_stats, want = jax_run
    for r in range(S):
        _close(port[r]["losses"], want_losses, tol["loss"], "loss")
        _close(port[r]["losses"][0], want_losses[0], 1e-6, "step-0 loss")
        for k, (a, b) in enumerate(zip(port[r]["stats"], want_stats)):
            assert set(a) == set(b), k
            for key in b:
                if wire == "fp32" or k == 0:
                    np.testing.assert_array_equal(a[key], b[key],
                                                  err_msg=f"{k} {key}")
    assert want_losses[-1] < want_losses[0]
    if hot_rows:
        assert all(s["categorical/hot_hits"] > 0 for s in want_stats)
    if mig_rows:
        assert want_stats[0]["categorical/mig_hits"] > 0
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    assert got["step"] == want["step"] == STEPS
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    _close(g["weights"], t["weights"], tol["table"], "weights")
    for k, v in t["slots"].items():
        _close(g["slots"][k], v, tol["slot"], k)
    assert ("ef" in g) == ("ef" in t) == (wire == "int8")
    if "ef" in t:
        _close(g["ef"], t["ef"], tol["table"], "ef")
    for part in ("hot", "mig"):
        assert (part in g) == (part in t)
        if part in t:
            for k, v in t[part].items():
                if k == "slots":
                    for s, a in v.items():
                        _close(g[part][k][s], a, tol["slot"], part + s)
                elif k == "weights":
                    _close(g[part][k], v, tol["table"], part)
                else:
                    np.testing.assert_array_equal(g[part][k], v,
                                                  err_msg=part + k)
    if "keys" in t:
        np.testing.assert_array_equal(g["keys"], t["keys"])
        assert g["overflow"] == t["overflow"] > 0
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            _close(got[key][k], v, tol["dense"], k)


INT8 = [c for c in CONFIGS if c[1] == "int8"]
FP32_HOT, FP32_MIG = [CONFIGS[2]], [CONFIGS[3]]
INT8_ALL, FP32_ALL = [CONFIGS[1]], [CONFIGS[4]]

runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer = \
    trajectory_tests(2, "array", INT8)
