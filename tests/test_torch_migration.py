"""Cold-tail migration on the port's mesh against the JAX package's.

- `build_mig_identity`: keys, rank, ids and owners equal to the JAX
  package's (array and hash tables; duplicate and invalid ids, owners out
  of range, more moves than M).
- `plan_migration` (the numpy copy in `placement/`): equal to the JAX
  package's on the same load vectors and candidates.
- One training pull and push with a directory installed by `mig_gather`
  (alone, with a hot set, with int8 residuals), then `mig_writeback`, on
  two port ranks against the JAX mesh: the tolerances of
  `test_torch_hot.py` (rows, residuals and stats bit-exact; tables,
  annexes and caches at the Adagrad rule's bound against jitted JAX).

Placement against no placement inside the port: `test_torch_placement_fp32.py`.
"""

import numpy as np
import pytest

from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu.parallel import sharded as jax_sharded
from openembedding_tpu.placement import migration as jax_migration
from openembedding_tpu_torch.embedding import EmbeddingSpec
from openembedding_tpu_torch.parallel import sharded
from openembedding_tpu_torch.placement import (candidate_weights,
                                               plan_migration)
from test_torch_hot import (_case, _spec_fields, check_placement,
                            placement_runs)


def _mig_identity_cases():
    rng = np.random.default_rng(5)
    big = rng.integers(0, 2 ** 62, size=300, dtype=np.int64)
    small = rng.integers(0, 250, size=300).astype(np.int64)
    for kind, cand in (("array", small), ("hash", big)):
        cand = np.concatenate([cand[:5], cand[:5], [-1, -7], cand[5:]])
        owners = rng.integers(-1, 5, size=cand.size)
        for M in (1, 8, 100, 512):
            yield kind, M, cand, owners
        yield kind, 8, None, None


@pytest.mark.parametrize("kind,M,cand,owners", list(_mig_identity_cases()),
                         ids=lambda v: getattr(v, "size", v))
def test_mig_identity_equals_the_jax_package(kind, M, cand, owners):
    fields = _spec_fields(kind, 4)
    got = sharded.build_mig_identity(EmbeddingSpec(name="v", **fields), M,
                                     cand, owners, num_shards=4)
    template = np.full(4, -1, np.int64) if kind == "hash" else None
    want = jax_sharded.build_mig_identity(
        JaxSpec(name="v", **fields), M, cand, owners, num_shards=4,
        key_template=template)
    assert set(got) == set(want) == {"keys", "rank", "ids", "owners"}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _plan_cases():
    rng = np.random.default_rng(9)
    for S in (2, 4, 8):
        for _ in range(4):
            load = rng.integers(0, 5000, size=S).astype(np.float64)
            load[rng.integers(S)] *= 4
            ids = rng.permutation(10000)[:200]
            w = np.sort(rng.pareto(1.2, size=200))[::-1] * 100
            yield S, load, list(zip(ids.tolist(), w.tolist()))
    yield 4, np.zeros(4), [(1, 2.0)]
    yield 4, np.ones(4), []


@pytest.mark.parametrize("S,load,cand", list(_plan_cases()),
                         ids=lambda v: str(getattr(v, "size", v)))
def test_plan_migration_equals_the_jax_package(S, load, cand):
    for max_moves, target, total, exclude in ((16, 1.05, 0.0, None),
                                              (300, 1.0, 1e5, [c for c, _
                                                               in cand[:3]])):
        got = plan_migration(load, cand, num_shards=S, max_moves=max_moves,
                             target=target, total=total, exclude=exclude)
        want = jax_migration.plan_migration(
            load, cand, num_shards=S, max_moves=max_moves, target=target,
            total=total, exclude=exclude)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    hot = [c for c, _ in cand[::7]]
    assert candidate_weights(cand, hot) \
        == jax_migration.candidate_weights(cand, hot)


MIG_CASES = {
    "array-fp32": dict(kind="array", mig=6),
    "array-int8-ef-hot-grouped": dict(kind="array", wire="int8", mig=6,
                                      hot=4, ef=True, grouped=True),
    "hash-fp32-hot": dict(kind="hash", mig=6, hot=4),
    "hash-int8-ef": dict(kind="hash", wire="int8", mig=6, ef=True),
}

mig_runs = placement_runs(lambda S: {
    name: _case(S, seed=10 + i, **kw)
    for i, (name, kw) in enumerate(MIG_CASES.items())}, 2)


@pytest.mark.parametrize("name", list(MIG_CASES))
def test_one_step_with_migrated_rows_matches_the_jax_mesh(mig_runs, name):
    S, runs = mig_runs
    port, want = runs[name]
    check_placement(S, [port[r][name] for r in range(S)], want)
    stats = port[0][name]["stats"]
    assert stats["mig_unique"] > 0 and stats["mig_hits"] > 0
