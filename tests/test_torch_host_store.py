"""The port's `HostStore` (`tables/host_offload.py`) against the JAX
package's, operation for operation on the same seeded numpy rows: every
lookup, merge, defer, drain (last wins), snapshot and wholesale replacement
leaves bit-equal arrays, hit masks, versions and byte counts."""

import numpy as np
import pytest

from openembedding_tpu.tables.host_offload import HostStore as JaxStore
from openembedding_tpu_torch.tables.host_offload import HostStore

DIM = 4
SLOTS = {"accum": DIM, "moment": 1}


def _rows(rng, n):
    return (rng.standard_normal((n, DIM)).astype(np.float32),
            {k: rng.standard_normal((n, w)).astype(np.float32)
             for k, w in SLOTS.items()})


def assert_stores_equal(got, want):
    assert got.ids.tobytes() == want.ids.tobytes()
    assert got.weights.tobytes() == want.weights.tobytes()
    assert sorted(got.slots) == sorted(want.slots)
    for k in want.slots:
        assert got.slots[k].tobytes() == want.slots[k].tobytes(), k
    assert got.version == want.version
    assert got.nbytes() == want.nbytes()
    assert len(got) == len(want)


def assert_lookups_equal(got, want, ids):
    gh, gw, gs = got.lookup(ids)
    wh, ww, ws = want.lookup(ids)
    np.testing.assert_array_equal(gh, wh)
    assert gw.tobytes() == ww.tobytes()
    for k in ws:
        assert gs[k].tobytes() == ws[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 1])
def test_store_ops_match_jax(seed):
    """A seeded mix of merges, defers (duplicates across chunks), drains,
    lookups (pending chunks overlaid) and a replacement."""
    rng = np.random.default_rng(seed)
    ours, theirs = HostStore(DIM, SLOTS), JaxStore(DIM, SLOTS)
    probe = np.arange(0, 400, 3, dtype=np.int64)
    assert_lookups_equal(ours, theirs, probe)  # empty store: zeros
    for r in range(12):
        n = int(rng.integers(1, 40))
        ids = rng.choice(300, size=n, replace=False).astype(np.int64)
        w, s = _rows(rng, n)
        op = r % 3
        for store in (ours, theirs):
            if op == 0:
                store.merge(ids.copy(), w.copy(),
                            {k: v.copy() for k, v in s.items()})
            else:
                store.defer(ids, w, s)
        if op == 2:
            assert ours.drain() == theirs.drain()
        assert_lookups_equal(ours, theirs, probe)
        assert_stores_equal(ours, theirs)
    snap_o, snap_t = ours.snapshot(), theirs.snapshot()
    assert_stores_equal(ours, theirs)  # the snapshot drained both
    assert snap_o.ids.tobytes() == snap_t.ids.tobytes()
    assert snap_o.weights.tobytes() == snap_t.weights.tobytes()
    ids = rng.choice(1000, size=50, replace=False).astype(np.int64)
    w, s = _rows(rng, 50)
    ours.defer(ids[:5], w[:5], {k: v[:5] for k, v in s.items()})
    theirs.defer(ids[:5], w[:5], {k: v[:5] for k, v in s.items()})
    ours.replace_all(ids, w, s)
    theirs.replace_all(ids, w, s)
    assert_stores_equal(ours, theirs)
    assert ours.drain() == theirs.drain() == 0  # pending dropped
    # the snapshot is decoupled from later merges
    before = snap_o.weights.copy()
    ours.merge(snap_o.ids[:3].copy(), np.zeros((3, DIM), np.float32),
               {k: np.zeros((3, w_), np.float32) for k, w_ in SLOTS.items()})
    assert snap_o.weights.tobytes() == before.tobytes()


def test_defer_drain_last_wins():
    """Pending chunks read newest-first before a drain; the drain keeps the
    last write of each id (`tests/test_host_offload.py`'s pin)."""
    ours, theirs = HostStore(DIM, {"accum": DIM}), JaxStore(DIM,
                                                            {"accum": DIM})
    for store in (ours, theirs):
        store.defer(np.asarray([5, 9], np.int64),
                    np.ones((2, DIM), np.float32),
                    {"accum": np.full((2, DIM), 1.0, np.float32)})
        store.defer(np.asarray([9], np.int64),
                    np.full((1, DIM), 7.0, np.float32),
                    {"accum": np.full((1, DIM), 7.0, np.float32)})
    assert_lookups_equal(ours, theirs, np.asarray([5, 9, 11], np.int64))
    hit, w, _ = ours.lookup(np.asarray([5, 9], np.int64))
    assert hit.all() and (w[0] == 1).all() and (w[1] == 7).all()
    assert len(ours) == 0
    assert ours.drain() == theirs.drain() == 2
    assert_stores_equal(ours, theirs)
    assert ours.drain() == 0
