"""The port's `HostOffloadTable` (`tables/host_offload.py`) against the JAX
package's on the CPU, driven through the same id stream and gradients.

After every `prepare` the device cache equals JAX's slot for slot (keys
exactly: both run the device probe, the highest batch index winning a
contended slot; weights and slots within float32 tolerance), the store
equals JAX's by id, and the residency, its clock bits, the per-shard counts
and the banked overflow are equal. The cases mirror `tests/test_host_offload
.py`: clock eviction keeping the hot rows, the flush policy, a
flush-triggering batch re-admitting its residents, an oversized batch
warning with a truthful residency, an array spec refused, the pipelined
path against the synchronous one at densify_k 1 and 4, a stale stage
discarded. The initializer is `Constant(0.0)`: the two frameworks' random
draws differ, a constant fresh template does not.

Tolerance: rtol 1e-6, atol 1e-7 on the float rows (the optimizer rules
agree with JAX's to a rounding, `test_torch_optimizers.py`); keys,
residency and counts exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu.embedding import apply_gradients as jax_apply
from openembedding_tpu.embedding import lookup_train as jax_lookup_train
from openembedding_tpu.initializers import Constant as JaxConstant
from openembedding_tpu.tables.host_offload import \
    HostOffloadTable as JaxOffload
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.embedding import (EmbeddingSpec, apply_gradients,
                                               lookup_train)
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.tables.hash_table import hash_find
from openembedding_tpu_torch.tables.host_offload import HostOffloadTable

DIM = 4
RTOL, ATOL = 1e-6, 1e-7


def specs(capacity):
    kw = dict(name="t", input_dim=-1, output_dim=DIM, capacity=capacity,
              variable_id=0)
    return (JaxSpec(initializer=JaxConstant(0.0), **kw),
            EmbeddingSpec(initializer=Constant(0.0), **kw))


class Pair:
    """One JAX and one port table driven alike, compared after each call."""

    def __init__(self, capacity, lr=0.3, **kw):
        self.jspec, self.spec = specs(capacity)
        self.jopt = jax_embed.Adagrad(learning_rate=lr)
        self.opt = optimizers.Adagrad(learning_rate=lr)
        self.j = JaxOffload(self.jspec, self.jopt, **kw)
        self.p = HostOffloadTable(self.spec, self.opt, device="cpu", **kw)
        self.check()

    def prepare(self, ids):
        ids = np.asarray(ids, np.int64)
        self.j.prepare(jnp.asarray(ids))
        self.p.prepare(ids)
        self.check()

    def stage(self, ids):
        ids = np.asarray(ids, np.int64)
        self.j.stage(ids)
        self.p.stage(ids)

    def step(self, ids, grads):
        ids = np.asarray(ids, np.int64)
        st, _ = jax_lookup_train(self.jspec, self.j.state, jnp.asarray(ids))
        self.j.state = jax_apply(self.jspec, st, self.jopt, jnp.asarray(ids),
                                 jnp.asarray(grads))
        ids_t = torch.from_numpy(ids)
        _, _, _, slot = lookup_train(self.spec, self.p.state, ids_t)
        apply_gradients(self.spec, self.p.state, self.opt, ids_t,
                        torch.from_numpy(np.asarray(grads, np.float32)),
                        slot=slot)

    def check(self):
        j, p = self.j, self.p
        np.testing.assert_array_equal(p.state.keys.numpy(),
                                      np.asarray(j.state.keys))
        np.testing.assert_allclose(p.state.weights.numpy(),
                                   np.asarray(j.state.weights),
                                   rtol=RTOL, atol=ATOL)
        for k, v in p.state.slots.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(j.state.slots[k]),
                                       rtol=RTOL, atol=ATOL)
        assert int(p.state.overflow) == int(np.asarray(j.state.overflow))
        np.testing.assert_array_equal(p._resident_sorted, j._resident_sorted)
        np.testing.assert_array_equal(p._ref, j._ref)
        np.testing.assert_array_equal(p._shard_counts, j._shard_counts)
        assert p._overflow_flushed == j._overflow_flushed
        self.check_store()

    def check_store(self):
        ps, js = self.p.store, self.j.store
        ids = np.unique(np.concatenate(
            [ps.ids, js.ids] + [c[0] for c in ps._pending + js._pending]))
        gh, gw, gs = ps.lookup(ids)
        wh, ww, ws = js.lookup(ids)
        np.testing.assert_array_equal(gh, wh)
        np.testing.assert_allclose(gw, ww, rtol=RTOL, atol=ATOL)
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL, atol=ATOL)

    def rows(self, ids):
        got = self.p.lookup_anywhere(ids)
        want = self.j.lookup_anywhere(ids)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return got


def id_stream(rounds, seed=7, size=12, space=1 << 20):
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, space, size=size).astype(np.int64)
               for _ in range(rounds)]
    grads = [rng.standard_normal((size, DIM)).astype(np.float32)
             for _ in range(rounds)]
    return batches, grads


@pytest.mark.parametrize("eviction", ["clock", "flush"])
def test_stream_matches_jax(eviction):
    """8 rounds of 12 ids over 2^20 into 32 slots: evictions and flushes
    every few rounds; cache, store and residency equal JAX's after every
    prepare and step, the rows wherever they live too."""
    pair = Pair(32, high_water=0.8, eviction=eviction)
    batches, grads = id_stream(8)
    for ids, g in zip(batches, grads):
        pair.prepare(ids)
        pair.step(ids, g)
        pair.check()
    assert len(pair.p.store) > 0
    if eviction == "flush":
        assert pair.p.counters["flushes"] > 0
    pair.rows(np.unique(np.concatenate(batches)))
    pair.check()


def test_clock_eviction_keeps_hot_resident():
    """A stable hot set of 8 and 6 fresh ids a round in 32 slots at 0.6: the
    hot ids never leave the card, the cold ones reach the store, no
    whole-cache flush; equal to JAX throughout."""
    pair = Pair(32, lr=0.1, high_water=0.6)
    rng = np.random.default_rng(3)
    hot = np.unique(rng.integers(0, 1 << 19, size=8).astype(np.int64))
    for r in range(8):
        cold = np.arange(6, dtype=np.int64) + (1 << 20) + 100 * r
        ids = np.concatenate([hot, cold])
        pair.prepare(ids)
        pair.step(ids, np.ones((ids.size, DIM), np.float32))
    for h in hot:
        assert pair.p.is_resident(int(h))
    assert (pair.p.store.ids >= (1 << 20)).any()
    assert not np.isin(hot, pair.p.store.ids).any()
    assert pair.p.counters["flushes"] == 0
    assert pair.p.counters["evictions"] > 0
    pair.check()


def test_flush_triggering_batch_readmits_resident_ids():
    """A batch holding a resident id that trips the flush: the id comes back
    with its state, equal to two updates of an uncached table."""
    pair = Pair(32, lr=0.5, high_water=0.5, eviction="flush")
    a = np.asarray([777], np.int64)
    pair.prepare(a)
    pair.step(a, np.ones((1, DIM), np.float32))
    pair.prepare(np.arange(100, 112, dtype=np.int64))
    assert pair.p.is_resident(777)
    batch = np.asarray([777, 900, 901, 902, 903], np.int64)
    pair.prepare(batch)  # 13 + 4 > 16: the flush
    assert pair.p.is_resident(777)
    pair.step(batch, np.full((5, DIM), 2.0, np.float32))
    got = pair.rows(a)
    # Adagrad(0.5) from 0 with accumulator 0.1: two updates of 1 then 2
    acc1 = 0.1 + 1.0
    w1 = -0.5 * 1.0 / np.sqrt(acc1)
    acc2 = acc1 + 4.0
    w2 = w1 - 0.5 * 2.0 / np.sqrt(acc2)
    np.testing.assert_allclose(got[0], np.full(DIM, w2, np.float32),
                               rtol=1e-6)


def test_oversized_batch_warns_and_residency_is_truthful():
    pair = Pair(16, high_water=0.5)
    big = np.arange(100, 140, dtype=np.int64)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        pair.j.prepare(jnp.asarray(big))
        pair.p.prepare(big)
    assert any("unique ids" in str(w.message) for w in seen)
    pair.check()
    p = pair.p
    assert p.resident_count <= p.capacity
    slot = hash_find(p.state.keys, torch.from_numpy(p.resident_ids()))
    assert bool((slot < p.capacity).all())
    assert p.total_overflow > 0


def test_array_spec_refused():
    spec = EmbeddingSpec(name="a", input_dim=100, output_dim=DIM,
                         variable_id=0)
    with pytest.raises(ValueError, match="hash-table"):
        HostOffloadTable(spec, optimizers.Adagrad(), device="cpu")
    _, hspec = specs(32)
    for bad in (dict(high_water=0.0), dict(eviction="lru"),
                dict(densify_k=0), dict(stage_depth=0)):
        with pytest.raises(ValueError):
            HostOffloadTable(hspec, optimizers.Adagrad(), device="cpu",
                             **bad)


@pytest.mark.parametrize("densify_k", [1, 4])
def test_pipeline_matches_sync_path(densify_k):
    """Staging a batch ahead (and densified writebacks) trains exactly as
    the synchronous path, with staged payloads consumed; equal to JAX's
    pipelined table after every prepare."""
    batches, grads = id_stream(8)
    sync = HostOffloadTable(specs(32)[1], optimizers.Adagrad(
        learning_rate=0.3), device="cpu", high_water=0.8)
    opt = sync.optimizer
    for ids, g in zip(batches, grads):
        sync.prepare(ids)
        t = torch.from_numpy(ids)
        _, _, _, slot = lookup_train(sync.spec, sync.state, t)
        apply_gradients(sync.spec, sync.state, opt, t, torch.from_numpy(g),
                        slot=slot)
    pair = Pair(32, high_water=0.8, pipeline=True, densify_k=densify_k)
    pair.stage(batches[0])
    for r, (ids, g) in enumerate(zip(batches, grads)):
        pair.prepare(ids)
        if r + 1 < len(batches):
            pair.stage(batches[r + 1])
        pair.step(ids, g)
    assert pair.p.pipe_hits > 0
    assert (pair.p.pipe_hits, pair.p.pipe_misses) == (pair.j._pipe_hits,
                                                      pair.j._pipe_misses)
    all_ids = np.unique(np.concatenate(batches))
    np.testing.assert_array_equal(pair.rows(all_ids),
                                  sync.lookup_anywhere(all_ids))
    pair.p.close()


def test_pipeline_stale_stage_discarded():
    """A stage for another batch is a miss; a residency-only change
    revalidates the stage; a store change invalidates it; every path
    trains correctly and equals JAX."""
    pair = Pair(32, lr=0.2, high_water=0.8, pipeline=True)
    p = pair.p
    a = np.arange(100, 112, dtype=np.int64)
    b = np.arange(200, 212, dtype=np.int64)
    pair.stage(a)
    pair.prepare(b)
    assert (p.pipe_misses, p.pipe_hits) == (1, 0)
    assert all(p.is_resident(int(i)) for i in b)
    pair.stage(a)
    p.reset_cache()
    pair.j.reset_cache()
    pair.prepare(a)
    assert (p.pipe_misses, p.pipe_hits) == (1, 1)
    c = np.arange(300, 312, dtype=np.int64)
    pair.stage(c)
    init = {"accum": np.full((1, DIM), 0.1, np.float32)}
    for table in (p, pair.j):
        table.store.merge(np.array([999], np.int64),
                          np.zeros((1, DIM), np.float32),
                          {k: v.copy() for k, v in init.items()})
    pair.prepare(c)
    assert (p.pipe_misses, p.pipe_hits) == (2, 1)
    assert all(p.is_resident(int(i)) for i in c)
    assert p.pipeline_occupancy["all"] == pytest.approx(1 / 3)
    p.close()


def test_load_store_and_reset_keep_tensors():
    """`load_store`, `reset_cache`, eviction and flush write into the
    cache's own tensors (a captured graph holds them), and two resets give
    bit-equal caches."""
    _, spec = specs(32)
    p = HostOffloadTable(spec, optimizers.Adagrad(), device="cpu",
                         high_water=0.6)
    ptrs = [t.data_ptr() for t in p.state.tensors()]
    batches, grads = id_stream(8)
    for ids in batches:
        p.prepare(ids)
    p.flush()
    first = [t.clone() for t in p.state.tensors()]
    p.load_store(np.asarray([5, 3], np.int64),
                 np.ones((2, DIM), np.float32), {})
    assert p.store.slots["accum"][0, 0] == np.float32(0.1)
    p.reset_cache()
    assert all(torch.equal(a, b) for a, b in zip(first, p.state.tensors()))
    assert [t.data_ptr() for t in p.state.tensors()] == ptrs
    assert p.counters["evictions"] > 0
