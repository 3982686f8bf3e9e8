"""The port's `PlacementPolicy` (`placement/policy.py`, pure numpy)
against the JAX package's: every method, on seeded telemetry, returns
what JAX's returns, equal to the last character of a reason string and
the last bit of a float.

The telemetry: skewed and flat coverage curves, an empty sketch, a table
without a load vector, a flat and a hot-spotted load vector, an
installed set equal to the top-H, disjoint from it and empty, cooldown
edges (one step inside, on the edge), dense-gradient densities around the
hysteresis band (NaN, negative, inside the cooldown) and a row wider than
the chunk. Plus the JAX unit pins `test_policy_budget_flows_to_the_skewed_
table` and `test_policy_refresh_hysteresis_gain_and_cooldown`, through
the port.
"""

import dataclasses

import numpy as np
import pytest

from openembedding_tpu.placement import policy as jax_policy
from openembedding_tpu_torch.placement import policy as port_policy
from openembedding_tpu_torch.placement.policy import (PlacementPolicy,
                                                      TableTelemetry,
                                                      row_bytes)


def _telemetry(seed, n_tables=3):
    """Seeded tables: a Zipf-skewed one, a flat one, one with an empty
    sketch; load vectors flat, hot-spotted or absent."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_tables):
        kind = ("skewed", "flat", "empty")[t % 3]
        dim = int(rng.choice([1, 4, 8, 10, 16, 64]))
        if kind == "empty":
            cov, top, total = [], [], 0.0
        else:
            n = int(rng.integers(8, 300))
            a = 1.3 if kind == "skewed" else 0.05
            est = np.sort((1000.0 / (np.arange(n) + 1.0) ** a
                           * rng.uniform(0.8, 1.2, n)).astype(np.int64))[::-1]
            total = float(est.sum() * rng.uniform(1.0, 3.0))
            cum = np.minimum(np.cumsum(est) / total, 1.0)
            ks = [1 << i for i in range(int(np.log2(n)) + 1)] + [n]
            cov = [(int(k), float(cum[min(k, n) - 1])) for k in ks]
            ids = rng.choice(1 << 20, size=n, replace=False)
            top = [(int(i), int(e)) for i, e in zip(ids, est)]
        S = int(rng.choice([2, 4, 8]))
        pos = None
        if rng.random() < 0.8:
            pos = rng.uniform(50, 100, S)
            if rng.random() < 0.6:
                pos[int(rng.integers(S))] *= rng.uniform(1.2, 4.0)
        out.append({"name": f"t{t}", "dim": dim, "coverage": cov,
                    "total": total, "top_ids": top,
                    "shard_positions": pos,
                    "slot_cols": int(rng.choice([0, 1, 2]))})
    return out


def _both(kw):
    return (TableTelemetry(**kw), jax_policy.TableTelemetry(**kw))


def _policies(seed):
    rng = np.random.default_rng(seed + 100)
    kw = dict(mig_rows=int(rng.choice([8, 32, 64])),
              refresh_min_gain=float(rng.choice([0.0, 0.02, 0.1])),
              refresh_cooldown_steps=int(rng.choice([0, 3, 50])),
              imbalance_target=float(rng.choice([1.0, 1.05, 1.5])),
              min_hot_rows=int(rng.choice([0, 0, 4])))
    budget = int(rng.integers(0, 200)) * row_bytes(10, 1)
    return (PlacementPolicy(budget, **kw),
            jax_policy.PlacementPolicy(budget, **kw))


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        return
    if isinstance(a, float) and isinstance(b, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)
        return
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("seed", range(12))
def test_policy_matches_jax_on_seeded_telemetry(seed):
    tel = [_both(kw) for kw in _telemetry(seed)]
    port_tel = [p for p, _ in tel]
    jax_tel = [j for _, j in tel]
    pp, jp = _policies(seed)
    _same(pp.size_hot(port_tel), jp.size_hot(jax_tel))
    _same(pp.size_mig(port_tel), jp.size_mig(jax_tel))
    _same(pp.recommend_wire(port_tel), jp.recommend_wire(jax_tel))
    rng = np.random.default_rng(seed + 200)
    for (pt, jt) in tel:
        for k in (0, 1, 3, 17, 1024, 5000):
            _same(pt.share_at(k), jt.share_at(k))
        _same(pp.migration_due(pt), jp.migration_due(jt))
        top = [i for i, _ in pt.top_ids]
        for installed in (np.zeros((0,), np.int64),
                          np.asarray(top[:4], np.int64),
                          np.asarray(top[2:9] + [-5, 1 << 21], np.int64)):
            for H in (0, 1, 4, 64):
                _same(pp.churn(installed, pt.top_ids[:H]),
                      jp.churn(installed, jt.top_ids[:H]))
                cd = pp.refresh_cooldown_steps
                for since in (0, cd - 1, cd, cd + 1, 10**9):
                    _same(pp.refresh_due(pt, installed, H, since),
                          jp.refresh_due(jt, installed, H, since))
    for _ in range(20):
        d = float(rng.choice([np.nan, -0.1, 0.0, 0.05, 0.131, 0.132, 0.133,
                              0.197, 0.198, 0.199, 0.22, 0.5, 1.0]))
        for current in ("int8", "bf16", "sparse_topk"):
            for chunk in (None, 0, 32, 100, 4096):
                for since in (0, 199, 200, 10**9):
                    _same(pp.recommend_dense_wire(d, current, chunk=chunk,
                                                  steps_since=since),
                          jp.recommend_dense_wire(d, current, chunk=chunk,
                                                  steps_since=since))
        for chunk in (0, 1, 31, 32, 33, 4096):
            _same(pp._dense_topk(abs(d) if d == d else 0.0, chunk),
                  jp._dense_topk(abs(d) if d == d else 0.0, chunk))


def test_policy_class_constants_match_jax():
    names = [n for n in vars(jax_policy.PlacementPolicy)
             if not n.startswith("_") and not callable(
                 getattr(jax_policy.PlacementPolicy, n))]
    assert "dense_topk_block" in names
    for n in names:
        _same(getattr(PlacementPolicy, n),
              getattr(jax_policy.PlacementPolicy, n))
    assert [f.name for f in dataclasses.fields(TableTelemetry)] == \
        [f.name for f in dataclasses.fields(jax_policy.TableTelemetry)]
    for d in (1, 8, 10, 64):
        for c in (0, 1, 2):
            assert row_bytes(d, c) == jax_policy.row_bytes(d, c)
    assert port_policy.row_bytes(10) == 80


def _curve(shares):
    return list(enumerate(shares, start=1))


def test_policy_budget_flows_to_the_skewed_table():
    """Greedy traffic-per-byte: a heavily skewed table's knee outbids a
    flat table's head, so the skewed table gets (most of) the rows."""
    skewed = TableTelemetry(
        name="skewed", dim=8, total=10000.0,
        coverage=_curve([0.30, 0.45, 0.55, 0.62, 0.66, 0.68, 0.69, 0.70]))
    flat = TableTelemetry(
        name="flat", dim=8, total=10000.0,
        coverage=_curve([0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08]))
    sizes = PlacementPolicy(6 * row_bytes(8, 1)).size_hot([skewed, flat])
    assert sizes["skewed"] == 6 and sizes["flat"] == 0, sizes
    # a bigger budget spills over once the skewed curve flattens below the
    # flat table's (constant) marginal rate
    sizes2 = PlacementPolicy(12 * row_bytes(8, 1)).size_hot([skewed, flat])
    assert sizes2["skewed"] >= 6 and sum(sizes2.values()) == 12, sizes2
    assert sizes2["flat"] > 0


def test_policy_refresh_hysteresis_gain_and_cooldown():
    t = TableTelemetry(
        name="a", dim=8, total=1000.0,
        coverage=_curve([0.3, 0.5, 0.6, 0.65]),
        top_ids=[(1, 300), (2, 200), (3, 100), (4, 50)])
    policy = PlacementPolicy(1 << 20, refresh_min_gain=0.05,
                             refresh_cooldown_steps=10)
    # inside the cooldown: never, whatever the gain
    due, reason, _ = policy.refresh_due(t, np.asarray([9]), H=2,
                                        steps_since=5)
    assert not due and "cooldown" in reason
    # installed set empty -> initial promotion
    due, reason, _ = policy.refresh_due(t, np.zeros((0,), np.int64), H=2,
                                        steps_since=100)
    assert due and "initial" in reason
    # installed == current top-H: gain ~0, below threshold
    due, reason, gain = policy.refresh_due(t, np.asarray([1, 2]), H=2,
                                           steps_since=100)
    assert not due and gain < 0.05
    # fully rotated installed set: gain = the whole top-H coverage
    due, _reason, gain = policy.refresh_due(t, np.asarray([8, 9]), H=2,
                                            steps_since=100)
    assert due and gain >= 0.49
