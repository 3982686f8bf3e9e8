"""Host-cached tables (`storage="host_cached"`) through the port's `Trainer`
against the JAX package's on the CPU, from one state: the JAX trainer's
init carried across, its host-offload table too
(`convert.offload_from_jax`).

Models: the hashed LR built from the user-facing `Embedding(...,
storage="host_cached")` layer, and the small hashed DeepFM (dim 9 folded,
a float32 16-16 tower) with its table made host-cached. Ids come from
`synthetic_criteo` over the 2^62 id space; the caches hold one batch but
not the stream, so the runs evict (clock) and flush. The initializer is
`Constant(0.0)`, as in the JAX package's offload tests: the frameworks'
random draws differ, a constant fresh template does not.

After every `offload_prepare` the cache equals JAX's slot for slot and the
store equals JAX's by id. Losses within `test_torch_trainer.py`'s float32
tolerance (atol 1e-6, rtol 0: tighter than JAX's own rtol 1e-5 / atol
1e-6), rows within its table tolerance. The port's offload run equals the
port's in-HBM run of the same stream bit for bit (rows round-trip exactly
through the store, and the steps do the same arithmetic in the same
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.initializers import Constant as JaxConstant
from openembedding_tpu.model import EmbeddingModel as JaxModel
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.models import make_lr as jax_make_lr
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.embedding import Embedding
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.model import EmbeddingModel, Trainer
from openembedding_tpu_torch.models import make_deepfm, make_lr

from test_torch_trainer import TOL

F32 = TOL["float32"]
DIM, BATCH = 9, 16
ID_SPACE = 1 << 62
CACHE = 1024        # 0.6 * 1024 = 614 slots before an eviction; a batch
BIG = 1 << 14       # of 16 x 26 ids has at most 416 distinct ones


def batches(steps=8, seed=11, batch=BATCH):
    return list(data.synthetic_criteo(batch, id_space=ID_SPACE, steps=steps,
                                      seed=seed))


def stack(bs):
    return {"sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in bs])},
            "dense": np.stack([b["dense"] for b in bs]),
            "label": np.stack([b["label"] for b in bs])}


def models(family, capacity, storage="host_cached"):
    """(JAX model, port model) of `family` with a Constant(0.0) hashed
    table of `capacity` slots in `storage`."""
    if family == "lr":
        jlr = jax_make_lr(-1, hashed=True, capacity=capacity,
                          compute_dtype=jnp.float32)
        tlr = make_lr(-1, hashed=True, capacity=capacity,
                      compute_dtype=torch.float32)
        je = jax_embed.Embedding(-1, 1, name="categorical",
                                 capacity=capacity, storage=storage,
                                 embeddings_initializer=JaxConstant(0.0))
        te = Embedding(-1, 1, name="categorical", capacity=capacity,
                       storage=storage,
                       embeddings_initializer=Constant(0.0))
        return (JaxModel(jlr.module, [je], loss_fn=jlr.loss_fn,
                         config=jlr.config),
                EmbeddingModel(tlr.module, [te], loss_fn=tlr.loss_fn,
                               config=tlr.config))
    jm = jax_make_deepfm(-1, DIM, hidden=(16, 16), hashed=True,
                         capacity=capacity, compute_dtype=jnp.float32)
    tm = make_deepfm(-1, DIM, hidden=(16, 16), hashed=True,
                     capacity=capacity, compute_dtype=torch.float32)
    jm.specs["categorical"] = dataclasses.replace(
        jm.specs["categorical"], storage=storage,
        initializer=JaxConstant(0.0))
    tm.specs["categorical"] = dataclasses.replace(
        tm.specs["categorical"], storage=storage, initializer=Constant(0.0))
    return jm, tm


def numpy_state(js):
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


def start(family, capacity=CACHE, **kw):
    """Both trainers from the JAX init (the offload tables carried)."""
    jm, tm = models(family, capacity)
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.3), seed=0, **kw)
    tt = Trainer(tm, optimizers.Adagrad(learning_rate=0.3), device="cpu",
                 **kw)
    bs = batches()
    js = jt.init(bs[0])
    tt.init(bs[0])  # makes the port's offload table
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    convert.offload_from_jax(jt.offload["categorical"],
                             tt.offload["categorical"])
    ts.tables["categorical"] = tt.offload["categorical"].state
    return jt, tt, js, ts, bs


def assert_caches_equal(tt, jt):
    p, j = tt.offload["categorical"], jt.offload["categorical"]
    np.testing.assert_array_equal(p.state.keys.numpy(),
                                  np.asarray(j.state.keys))
    np.testing.assert_allclose(p.state.weights.numpy(),
                               np.asarray(j.state.weights), rtol=0,
                               atol=F32["table"])
    for k, v in p.state.slots.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j.state.slots[k]),
                                   rtol=0, atol=F32["accum"])
    np.testing.assert_array_equal(p._resident_sorted, j._resident_sorted)
    np.testing.assert_array_equal(p._ref, j._ref)
    got, want = convert.offload_to_jax(p), j.store
    want.drain()
    np.testing.assert_array_equal(got["store"]["ids"], want.ids)
    np.testing.assert_allclose(got["store"]["weights"], want.weights,
                               rtol=0, atol=F32["table"])
    for k, v in want.slots.items():
        np.testing.assert_allclose(got["store"]["slots"][k], v, rtol=0,
                                   atol=F32["accum"])


def all_ids(bs):
    ids = np.unique(np.concatenate([b["sparse"]["categorical"].reshape(-1)
                                    for b in bs]))
    return ids[ids >= 0]


@pytest.mark.parametrize("family", ["lr", "deepfm"])
def test_offload_trainer_matches_jax_and_in_hbm(family):
    jt, tt, js, ts, bs = start(family)
    jstep = jax.jit(jt.train_step)
    tstep = tt.jit_train_step()  # eager on the CPU
    jl, tl = [], []
    for b in bs:
        js = jt.offload_prepare(js, b)
        ts2 = tt.offload_prepare(ts, b)
        assert ts2 is ts  # the same state, its cache updated in place
        assert_caches_equal(tt, jt)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    p = tt.offload["categorical"]
    assert p.counters["evictions"] + p.counters["flushes"] > 0
    assert len(p.store) > 0
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32["loss"])
    ids = all_ids(bs)
    jt.offload["categorical"].adopt(js.tables["categorical"])
    np.testing.assert_allclose(
        p.lookup_anywhere(ids),
        jt.offload["categorical"].lookup_anywhere(ids), rtol=0,
        atol=F32["table"])

    # the port's in-HBM run of the same stream from the same init: bit-equal
    _, hm = models(family, BIG, storage="hbm")
    ht = Trainer(hm, optimizers.Adagrad(learning_rate=0.3), device="cpu")
    hs = ht.init(bs[0])
    js0 = numpy_state(JaxTrainer(models(family, CACHE)[0],
                                 jax_embed.Adagrad(learning_rate=0.3),
                                 seed=0).init(bs[0]))
    dense = convert.train_state_from_jax(hm, **{
        **js0, "tables": {"categorical": convert.train_state_to_jax(hs)[
            "tables"]["categorical"]}}, device="cpu")
    hl = []
    for b in bs:
        dense, m = ht.train_step(dense, b)
        hl.append(float(m["loss"]))
    assert hl == tl
    from openembedding_tpu_torch.embedding import lookup
    want = lookup(hm.specs["categorical"], dense.tables["categorical"],
                  torch.from_numpy(ids)).numpy()
    assert want.tobytes() == p.lookup_anywhere(ids).tobytes()


def test_offload_train_many_across_windows():
    """Windows of 3 through `offload_train_many` (one union admission a
    window, evictions between windows: 4096 slots hold about two windows'
    ids at 0.6) equal the JAX package's windows and the port's step
    loop."""
    jt, tt, js, ts, bs = start("deepfm", capacity=4096)
    bs = batches(steps=9, seed=9)
    jlosses, tlosses = [], []
    for i in range(0, len(bs), 3):
        w = stack(bs[i:i + 3])
        js, jm = jt.offload_train_many(js, w)
        ts, tm = tt.offload_train_many(ts, w)
        assert_caches_equal(tt, jt)
        jlosses += np.asarray(jm["loss"]).tolist()
        tlosses += tm["loss"].tolist()
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=F32["loss"])
    p = tt.offload["categorical"]
    assert len(p.store) > 0

    # the step loop over the same batches from the same start
    _, lt, _, ls, _ = start("deepfm", capacity=4096)
    llosses = []
    for b in bs:
        ls = lt.offload_prepare(ls, b)
        ls, m = lt.train_step(ls, b)
        llosses.append(float(m["loss"]))
    assert llosses == tlosses
    ids = all_ids(bs)
    assert (p.lookup_anywhere(ids).tobytes()
            == lt.offload["categorical"].lookup_anywhere(ids).tobytes())


def test_train_many_needs_prepare():
    _, tt, _, ts, bs = start("lr")
    w = stack(bs[:2])
    with pytest.raises(ValueError, match="offload_train_many"):
        tt.train_many(ts, w)
    with pytest.raises(ValueError, match="offload_train_many"):
        tt.jit_train_many()(ts, w)
    ts = tt.offload_prepare(ts, w)
    ts, m = tt.train_many(ts, w)
    assert np.isfinite(m["loss"].numpy()).all()


def test_table_overflow_banked_across_flushes():
    """A cache of 64 slots and batches of 64 x 26 ids: admissions overflow,
    flushes reset the device counter, `table_overflow` keeps the banked
    count, equal to JAX's."""
    jt, tt, js, ts, _ = start("lr", capacity=64)
    jstep = jax.jit(jt.train_step)
    for b in batches(steps=3, batch=64, seed=5):
        with pytest.warns(RuntimeWarning, match="unique ids"):
            js = jt.offload_prepare(js, b)
        with pytest.warns(RuntimeWarning, match="unique ids"):
            ts = tt.offload_prepare(ts, b)
        js, _ = jstep(js, b)
        ts, _ = tt.train_step(ts, b)
        assert (tt.table_overflow(ts, "categorical")
                == jt.table_overflow(js, "categorical"))
    p = tt.offload["categorical"]
    assert p._overflow_flushed > 0
    assert tt.table_overflow(ts, "categorical") == p.total_overflow


def test_jit_eval_step_matches_eval_step_and_jax():
    jt, tt, js, ts, bs = start("deepfm")
    jstep = jax.jit(jt.train_step)
    for b in bs[:3]:
        js = jt.offload_prepare(js, b)
        ts = tt.offload_prepare(ts, b)
        js, _ = jstep(js, b)
        ts, _ = tt.train_step(ts, b)
    b = bs[3]
    js = jt.offload_prepare(js, b)
    ts = tt.offload_prepare(ts, b)
    ev = tt.jit_eval_step()
    got = ev(ts, b)
    eager = tt.eval_step(ts, b)
    assert torch.equal(got["logits"], eager["logits"])
    assert torch.equal(got["loss"], eager["loss"])
    want = jt.jit_eval_step()(js, b)
    np.testing.assert_allclose(got["logits"].numpy().reshape(-1),
                               np.asarray(want["logits"]).reshape(-1),
                               rtol=0, atol=F32["loss"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=F32["loss"])
    assert ts.step == 3  # evaluation advances nothing
