"""The port's heavy-hitter sketches (`utils/sketch.py`) against the JAX
package's: on one seeded Zipf stream (int64 ids with -1 pads, and split
uint32 pairs), `CountMin` tables and `SpaceSaving` summaries (top-k,
estimates, errors, coverage) are bit-equal with and without decay, and
the bound `est - err <= true <= est` holds; `SkewMonitor` counts the
batches it drops in `skew.dropped_batches` as JAX's does, and both render
the same text."""

import numpy as np
import pytest

from openembedding_tpu.utils import metrics as jm
from openembedding_tpu.utils import sketch as js
from openembedding_tpu_torch.utils import metrics as tm
from openembedding_tpu_torch.utils import sketch as ts


@pytest.fixture(autouse=True)
def _fresh():
    for m in (jm, tm):
        with m._LOCK:  # other tests' series leave their keys registered
            m._REGISTRY.clear()
    yield


def _stream(seed=1, batches=40, n=2048):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        ids = (rng.zipf(1.3, n) - 1).astype(np.int64) % (1 << 40)
        ids[rng.random(n) < 0.02] = -1
        out.append(ids.reshape(-1, 8))
    return out


@pytest.mark.parametrize("decay", [None, 0.9])
def test_space_saving_bit_equal(decay):
    a = js.SpaceSaving(k=32, cm_width=512, decay=decay)
    b = ts.SpaceSaving(k=32, cm_width=512, decay=decay)
    stream = _stream()
    for ids in stream:
        a.update(ids)
        b.update(ids)
    assert b.topk() == a.topk()
    assert b.coverage() == a.coverage()
    assert b.total == a.total
    assert np.array_equal(b.cm.table, a.cm.table)
    if decay is None:
        flat = np.concatenate([x.reshape(-1) for x in stream])
        flat = flat[flat >= 0]
        true = dict(zip(*np.unique(flat, return_counts=True)))
        for hid, est, err in b.topk():
            assert est - err <= true[hid] <= est


def test_count_min_and_pairs_bit_equal():
    a, b = js.CountMin(1000, 3), ts.CountMin(1000, 3)
    ids = np.concatenate([x.reshape(-1) for x in _stream(batches=3)])
    ids = ids[ids >= 0]
    uniq, cnt = np.unique(ids, return_counts=True)
    a.add(uniq, cnt)
    b.add(uniq, cnt)
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.query(uniq), b.query(uniq))
    # split-pair batches re-join to int64, padding pairs dropped
    pair = np.stack([(uniq >> 32).astype(np.uint32),
                     (uniq & 0xFFFFFFFF).astype(np.uint32)], -1)
    pair = np.concatenate([pair, np.full((3, 2), 0xFFFFFFFF, np.uint32)])
    sa, sb = js.SpaceSaving(16), ts.SpaceSaving(16)
    sa.update(pair)
    sb.update(pair)
    assert sa.topk() == sb.topk() and sb.total == uniq.size


def test_monitor_counts_drops_and_renders_alike():
    outs = []
    for s, m in ((js, jm), (ts, tm)):
        mon = s.SkewMonitor(k=8, queue_size=2)
        mon._ensure_worker = lambda: None  # no worker: the queue fills
        kept = [mon.observe("t", ids) for ids in _stream(batches=5)]
        assert kept == [True, True, False, False, False]
        assert m.report()["skew.dropped_batches"] == 3.0
        del mon._ensure_worker
        mon._ensure_worker()  # the worker folds what was queued
        mon.drain()
        assert mon.observe("t", _stream(seed=2, batches=1)[0])
        mon.drain()
        mon.close()
        mon.publish()
        outs.append((mon.render_text(), mon.sketch("t").topk(),
                     {k: v for k, v in m.report().items()
                      if k.startswith("skew.")}))
    assert outs[0] == outs[1]


def test_sync_monitor_and_shard_balance_text():
    a, b = js.SkewMonitor(k=8, sync=True), ts.SkewMonitor(k=8, sync=True)
    for ids in _stream(batches=3):
        a.observe("u", ids)
        b.observe("u", ids)
    assert a.render_text() == b.render_text()
    for m in (jm, tm):
        for i, v in enumerate([3.0, 9.0, 1.0]):
            m.observe("exchange.shard_positions", v, "gauge",
                      labels={"table": "u", "shard": str(i)})
        m.observe("exchange.shard_imbalance", 2.0, "hist",
                  labels={"table": "u"})
    assert ts.shard_balance_text() == js.shard_balance_text()
