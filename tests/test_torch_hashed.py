"""Hashed tables (`input_dim=-1`) through the port's `Trainer` against the
JAX package on the CPU (64-bit types on: single-lane int64 keys); their
checkpoints, exports and the hashed-LR example are in
`tests/test_torch_hashed_io.py`.

Models: a hashed DeepFM with the first-order weight folded into the latent
table and split into its own 1-wide table (both read the same ids, so the
two tables insert alike), and the hashed LR (one 1-wide table). Ids come
from `synthetic_criteo` over the 2^62 id space into a table of 4096 slots:
20 steps of 64 x 26 ids fill it and overflow it, so the runs compare the
overflow counters too.

Keys, slot placement and overflow counters are integer work and match
bit-exact. Floats: the towers compute in float32, and the tolerances are
`test_torch_trainer.py`'s float32 ones (matrix-product summation order and
XLA's contraction of multiply-adds), except the hashed-LR example, which
runs its default bf16 tower on raw Criteo features and is held to
`test_torch_example.py`'s relative loss bound, one bf16 rounding (2^-8).
One run trains the default bf16 tower, held to `test_torch_trainer.py`'s
bfloat16 tolerances.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params, _unflatten_params
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.model import TrainState as JaxState
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.models import make_lr as jax_make_lr
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm, make_lr

from test_torch_trainer import TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN100 = os.path.join(REPO, "examples", "train100.tsv")
CAPACITY, DIM, BATCH, STEPS = 4096, 9, 64, 20
ID_SPACE = 1 << 62
LOSS_RTOL = 2.0 ** -8
F32 = TOL["float32"]


def _batches(steps=STEPS, seed=11):
    return list(data.synthetic_criteo(BATCH, id_space=ID_SPACE, steps=steps,
                                      seed=seed))


def _stack(batches):
    return {"sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in batches])},
            "dense": np.stack([b["dense"] for b in batches]),
            "label": np.stack([b["label"] for b in batches])}


def _pair(family, compute="float32"):
    """(jax model, jax trainer, port model, port trainer); float32 towers
    unless `compute` says otherwise."""
    kw = dict(hashed=True, capacity=CAPACITY,
              compute_dtype=getattr(jnp, compute))
    tkw = dict(hashed=True, capacity=CAPACITY,
               compute_dtype=getattr(torch, compute))
    if family == "lr":
        jm = jax_make_lr(-1, **kw)
        tm = make_lr(-1, **tkw)
    else:
        fo = family.split("_")[1]
        jm = jax_make_deepfm(-1, DIM, hidden=(16, 16), first_order=fo, **kw)
        tm = make_deepfm(-1, DIM, hidden=(16, 16), first_order=fo, **tkw)
    assert tm.config == jm.config
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    return jm, jt, tm, tt


def _numpy_state(js):
    return dict(
        tables={n: {"weights": np.array(t.weights),
                    "slots": {k: np.array(v) for k, v in t.slots.items()},
                    "keys": np.array(t.keys), "overflow": int(t.overflow)}
                for n, t in js.tables.items()},
        dense_params={k: np.array(v)
                      for k, v in _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v)
                     for k, v in _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _start(family, compute="float32"):
    jm, jt, tm, tt = _pair(family, compute)
    batches = _batches()
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    return jm, jt, tm, tt, js, ts, batches


def _assert_states_close(ts, js, tol=F32, positions=True):
    """Keys and overflow bit-exact, floats within `tol`. `positions` False
    compares each table by its id -> row contents (a loaded table may place
    colliding ids the other way round; `np_hash_insert`)."""
    got = convert.train_state_to_jax(ts)
    want = _numpy_state(js)
    for name, t in want["tables"].items():
        g = got["tables"][name]
        assert g["overflow"] == t["overflow"], name
        arrays = [("weights", g["weights"], t["weights"], tol["table"])] + [
            (k, g["slots"][k], v, tol["accum"]) for k, v in t["slots"].items()]
        if positions:
            np.testing.assert_array_equal(g["keys"], t["keys"])
            for what, a, b, atol in arrays:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=what)
            continue
        gsel, tsel = g["keys"] >= 0, t["keys"] >= 0
        go, to = np.argsort(g["keys"][gsel]), np.argsort(t["keys"][tsel])
        np.testing.assert_array_equal(g["keys"][gsel][go],
                                      t["keys"][tsel][to])
        for what, a, b, atol in arrays:
            np.testing.assert_allclose(a[gsel][go], b[tsel][to], rtol=0,
                                       atol=atol, err_msg=what)
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            np.testing.assert_allclose(
                got[key][k], v, rtol=0, err_msg=k,
                atol=tol["dense" if key == "dense_params" else "dense_slots"])


FAMILIES = ["deepfm_fold", "deepfm_split", "lr"]


@pytest.mark.parametrize("family,compute", [
    (f, "float32") for f in FAMILIES] + [("deepfm_fold", "bfloat16")])
def test_twenty_steps_match_the_jax_trainer(family, compute):
    jm, jt, tm, tt, js, ts, batches = _start(family, compute)
    assert tm.specs["categorical"].use_hash_table
    step = jax.jit(jt.train_step)
    graph = tt.jit_train_step()  # the CPU runs the eager step
    jl, tl = [], []
    for i, b in enumerate(batches):
        js, jmet = step(js, b)
        ts, tmet = (graph if i % 2 else tt.train_step)(ts, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert set(tmet["stats"]) == {f"{n}_overflow" for n in tm.specs}
    tol = TOL[compute]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol["loss"])
    _assert_states_close(ts, js, tol)
    for name in tm.specs:
        assert tt.table_overflow(ts, name) == jt.table_overflow(js, name) > 0
    assert tt.overflow_count({}) == 0 and tt.check_overflow({}) is False


@pytest.mark.parametrize("family", FAMILIES)
def test_train_many_matches_the_jax_scan(family):
    """Both pack the table on the CPU (keys apart); "overflow" counts the
    window's probe misses in the port, where the JAX single-device scan
    reports 0 (ROADMAP.md §C): it equals the growth of JAX's counters."""
    jm, jt, tm, tt, js, ts, batches = _start(family)
    window = batches[:8]
    assert jt._packed_layouts(js) and tt._packed_layouts(ts)
    before = sum(int(t.overflow) for t in js.tables.values())
    js, jmet = jt.jit_train_many()(js, _stack(window))
    ts, tmet = tt.train_many(ts, _stack(window))
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]),
                               rtol=0, atol=F32["loss"])
    _assert_states_close(ts, js)
    after = sum(int(t.overflow) for t in js.tables.values())
    assert int(tmet["overflow"]) == after - before
    assert int(jmet["overflow"]) == 0


def test_train_many_equals_train_steps_bit_for_bit():
    _, _, tm, tt, _, a, batches = _start("deepfm_fold")
    b = a.clone()
    losses, oflow = [], 0
    for batch in batches[:6]:
        a, m = tt.train_step(a, batch)
        losses.append(m["loss"])
        oflow += int(m["stats"]["categorical_overflow"])
    b, m = tt.train_many(b, _stack(batches[:6]))
    assert torch.equal(m["loss"], torch.stack(losses))
    assert int(m["overflow"]) == oflow
    got, want = convert.train_state_to_jax(b), convert.train_state_to_jax(a)
    t, u = got["tables"]["categorical"], want["tables"]["categorical"]
    for key in ("keys", "weights"):
        np.testing.assert_array_equal(t[key], u[key])
    np.testing.assert_array_equal(t["slots"]["accum"], u["slots"]["accum"])
    assert t["overflow"] == u["overflow"]


def _jax_state(d):
    return JaxState(
        step=jnp.asarray(d["step"], jnp.int32),
        dense_params=_unflatten_params(d["dense_params"]),
        dense_slots=_unflatten_params(d["dense_slots"]),
        tables={n: JaxTable(weights=jnp.asarray(t["weights"]),
                            slots={k: jnp.asarray(v)
                                   for k, v in t["slots"].items()},
                            keys=jnp.asarray(t["keys"]),
                            overflow=jnp.asarray(t["overflow"], jnp.int32))
                for n, t in d["tables"].items()},
        model_version=jnp.asarray(d["model_version"], jnp.int32))


def test_state_round_trips_and_pair_keys_convert():
    """port -> JAX layout -> port keeps every key bit; a JAX state with
    split-pair keys converts by its resident ids."""
    from openembedding_tpu.ops.id64 import np_split_ids
    jm, jt, tm, tt, js, ts, batches = _start("deepfm_fold")
    for b in batches[:2]:  # the table not yet full: every id re-inserts
        ts, _ = tt.train_step(ts, b)
    d = convert.train_state_to_jax(ts)
    back = convert.train_state_to_jax(convert.train_state_from_jax(
        _pair("deepfm_fold")[2], **{k: d[k] for k in (
            "tables", "dense_params", "dense_slots", "step",
            "model_version")}, device="cpu"))
    np.testing.assert_array_equal(back["tables"]["categorical"]["keys"],
                                  d["tables"]["categorical"]["keys"])
    # the JAX step on the carried state equals the port's step
    js = _jax_state(d)
    js, jmet = jax.jit(jt.train_step)(js, batches[2])
    ts, tmet = tt.train_step(ts, batches[2])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=0, atol=1e-6)
    _assert_states_close(ts, js)
    # split-pair keys: the same id -> row contents after the re-insert
    t = dict(d["tables"]["categorical"])
    t["keys"] = np_split_ids(t["keys"])
    paired = convert.train_state_from_jax(
        _pair("deepfm_fold")[2], tables={"categorical": t},
        dense_params=d["dense_params"], dense_slots=d["dense_slots"],
        device="cpu")
    pk = paired.tables["categorical"].keys.numpy()
    sel, ids = pk >= 0, d["tables"]["categorical"]["keys"]
    assert sorted(pk[sel].tolist()) == sorted(ids[ids >= 0].tolist())
    src = {int(k): i for i, k in enumerate(ids) if k >= 0}
    for slot in np.flatnonzero(sel)[:200]:
        np.testing.assert_array_equal(
            paired.tables["categorical"].weights[slot].numpy(),
            t["weights"][src[int(pk[slot])]])
