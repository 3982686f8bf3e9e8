"""Checkpoints, exports and persist roots of host-cached tables across the
two packages and across the offload on and off, on the CPU.

The small hashed DeepFM of `test_torch_offload_trainer.py` (a 1024-slot
cache that evicts over the stream), trained six steps in one package, then
saved, exported or persisted, and read back by the other package or by a
trainer without the offload. A table is compared by id (ids, rows and
Adagrad accumulators, in id order): a host store is id-sorted, an in-HBM
load re-inserts by `np_hash_insert`, and nothing in a save or a load does
arithmetic, so every comparison is bit for bit. Exports serve through
`StandaloneModel` with logits equal to `eval_step`'s on a prepared batch.
"""

import dataclasses
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.embedding import lookup as jax_lookup
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.persist import \
    restore_server_model as jax_restore
from openembedding_tpu_torch import (AsyncPersister, IncrementalPersister,
                                     PersistPolicy, optimizers,
                                     restore_server_model)
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.parallel.checkpoint import save_sharded

from test_torch_offload_trainer import CACHE, batches, models, start

STEPS = 6
BIG = 1 << 14


def by_id(ids, weights, accum):
    order = np.argsort(ids, kind="stable")
    return {"ids": np.asarray(ids)[order],
            "weights": np.asarray(weights, np.float32)[order],
            "accum": np.asarray(accum)[order]}


def port_table(trainer, state):
    """The whole categorical table of a port state, by id."""
    if trainer.offload:
        st = trainer.offload_store_snapshots(state)["categorical"]
        return by_id(st.ids, st.weights, st.slots["accum"])
    t = state.tables["categorical"]
    keys = t.keys.numpy()
    sel = keys >= 0
    return by_id(keys[sel], t.weights.numpy()[sel],
                 t.slots["accum"].numpy()[sel])


def jax_table(trainer, state):
    if trainer.offload:
        st = trainer.offload_store_snapshots(state)["categorical"]
        return by_id(st.ids, st.weights, st.slots["accum"])
    t = state.tables["categorical"]
    keys = np.asarray(t.keys)
    sel = keys >= 0
    return by_id(keys[sel], np.asarray(t.weights)[sel],
                 np.asarray(t.slots["accum"])[sel])


def assert_tables_equal(got, want):
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def port_trainer(offload=True, capacity=CACHE):
    _, tm = models("deepfm", capacity if offload else BIG,
                   "host_cached" if offload else "hbm")
    return Trainer(tm, optimizers.Adagrad(learning_rate=0.3), device="cpu")


def jax_trainer(offload=True, capacity=CACHE, mesh=None):
    jm, _ = models("deepfm", capacity if offload else BIG,
                   "host_cached" if offload else "hbm")
    if mesh is not None:
        return JaxMeshTrainer(jm, jax_embed.Adagrad(learning_rate=0.3),
                              mesh=mesh)
    return JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.3), seed=0)


def port_trained(steps=STEPS):
    _, tt, _, ts, bs = start("deepfm")
    for b in bs[:steps]:
        ts = tt.offload_prepare(ts, b)
        ts, _ = tt.train_step(ts, b)
    assert len(tt.offload["categorical"].store) > 0
    return tt, ts, bs


def test_checkpoint_across_packages_and_offload(tmp_path):
    tt, ts, bs = port_trained()
    want = port_table(tt, ts)
    path = str(tmp_path / "ck")
    tt.save(ts, path)
    assert not os.path.exists(os.path.join(path, "variable_0",
                                           "keys.npy"))
    # into the port, with and without the offload
    for offload in (True, False):
        t = port_trainer(offload)
        s = t.load(t.init(bs[0]), path)
        assert_tables_equal(port_table(t, s), want)
        assert s.step == STEPS
    # into the JAX package, with and without the offload
    for offload in (True, False):
        jt = jax_trainer(offload)
        js = jt.load(jt.init(bs[0]), path)
        assert_tables_equal(jax_table(jt, js), want)
    # training goes on from the loaded store
    t = port_trainer()
    s = t.load(t.init(bs[0]), path)
    s = t.offload_prepare(s, bs[STEPS])
    s, m = t.train_step(s, bs[STEPS])
    assert np.isfinite(float(m["loss"]))

    # the JAX offload trainer's checkpoint into the port, both ways
    jt = jax_trainer()
    js = jt.init(bs[0])
    step = jax.jit(jt.train_step)
    for b in bs[:STEPS]:
        js = jt.offload_prepare(js, b)
        js, _ = step(js, b)
    jpath = str(tmp_path / "jax_ck")
    jt.save(js, jpath)
    jwant = jax_table(jt, js)
    for offload in (True, False):
        t = port_trainer(offload)
        s = t.load(t.init(bs[0]), jpath)
        assert_tables_equal(port_table(t, s), jwant)


def test_in_hbm_checkpoint_loads_into_offload(tmp_path):
    bs = batches()
    t = port_trainer(offload=False)
    s = t.init(bs[0])
    for b in bs[:STEPS]:
        s, _ = t.train_step(s, b)
    path = str(tmp_path / "ck")
    t.save(s, path)
    o = port_trainer()
    os_ = o.load(o.init(bs[0]), path)
    assert_tables_equal(port_table(o, os_), port_table(t, s))
    assert o.offload["categorical"].resident_count == 0  # the cache reset


def test_sharded_checkpoints_with_stores(tmp_path):
    """`save_sharded` of a port store at one shard loads in the JAX package;
    the JAX MeshTrainer's sharded save of its store (one source shard,
    `src_shards` in the meta) loads in the port, with and without the
    offload."""
    tt, ts, bs = port_trained()
    path = str(tmp_path / "sharded")
    save_sharded(ts, tt.model, path, num_shards=1, rank=0,
                 offload_stores=tt.offload_store_snapshots(ts))
    want = port_table(tt, ts)
    for offload in (True, False):
        jt = jax_trainer(offload)
        js = jt.load(jt.init(bs[0]), path)
        assert_tables_equal(jax_table(jt, js), want)
    mesh = jax_make_mesh(jax.devices()[:2])
    jt = jax_trainer(capacity=2 * CACHE, mesh=mesh)
    js = jt.init(bs[0])
    step = jt.jit_train_step(bs[0], js)
    for b in bs[:4]:
        js = jt.offload_prepare(js, b)
        js, _ = step(js, b)
    jpath = str(tmp_path / "jax_sharded")
    jt.save(js, jpath)
    jwant = jax_table(jt, js)
    for offload in (True, False):
        t = port_trainer(offload)
        s = t.load(t.init(bs[0]), jpath)
        assert_tables_equal(port_table(t, s), jwant)


def test_export_serves_the_whole_table(tmp_path):
    tt, ts, bs = port_trained()
    path = str(tmp_path / "export")
    export_standalone(ts, tt.model, path,
                      offload_stores=tt.offload_store_snapshots(ts))
    ids = np.load(os.path.join(path, "variable_0", "ids.npy"))
    assert ids.size == len(tt.offload["categorical"].store)
    b = bs[STEPS]
    ts = tt.offload_prepare(ts, b)
    want = tt.eval_step(ts, b)["logits"].reshape(-1)
    served = StandaloneModel.load(path, device="cpu")
    got = served.predict(b)
    assert torch.equal(got.reshape(-1), want)
    jgot = np.asarray(JaxStandalone.load(path).predict(b)).reshape(-1)
    np.testing.assert_allclose(jgot, want.numpy(), rtol=0, atol=1e-6)


def test_persist_roots_across_packages(tmp_path):
    """AsyncPersister of the offload trainer (every 2 steps) and an
    IncrementalPersister, which persists in full for a host-cached table:
    restored into the port with and without the offload and into the JAX
    package; a JAX root restores into the port."""
    _, tt, _, ts, bs = start("deepfm")
    root = str(tmp_path / "root")
    inc = str(tmp_path / "inc")
    with AsyncPersister(tt, tt.model, root,
                        policy=PersistPolicy(every_steps=2)) as p, \
            IncrementalPersister(tt, tt.model, inc, full_every=100,
                                 policy=PersistPolicy(every_steps=2)) as q:
        for b in bs[:STEPS]:
            ts = tt.offload_prepare(ts, b)
            ts, _ = tt.train_step(ts, b)
            p.maybe_persist(ts)
            q.maybe_persist(ts, batch=b)
    assert [h["kind"] for h in q.history] == ["full"] * 3
    want = port_table(tt, ts)
    for r in (root, inc):
        for offload in (True, False):
            t = port_trainer(offload)
            s = restore_server_model(t.init(bs[0]), t.model, r, trainer=t)
            assert s.step == STEPS
            assert_tables_equal(port_table(t, s), want)
        jt = jax_trainer()
        js = jax_restore(jt.init(bs[0]), jt.model, r, trainer=jt)
        assert_tables_equal(jax_table(jt, js), want)

    jt = jax_trainer()
    js = jt.init(bs[0])
    step = jax.jit(jt.train_step)
    jroot = str(tmp_path / "jax_root")
    with jax_embed.AsyncPersister(jt, jt.model, jroot,
                                  policy=jax_embed.PersistPolicy(
                                      every_steps=2)) as p:
        for b in bs[:4]:
            js = jt.offload_prepare(js, b)
            js, _ = step(js, b)
            p.maybe_persist(js)
    t = port_trainer()
    s = restore_server_model(t.init(bs[0]), t.model, jroot, trainer=t)
    assert_tables_equal(port_table(t, s), jax_table(jt, js))
