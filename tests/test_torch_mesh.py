"""The port's sharded pull/push protocol against the JAX package's.

The port runs S gloo ranks, each a process spawned by
`parallel.multihost.run_local` (one thread, a FileStore under the test's
temporary directory, a join timeout: a rank that fails or deadlocks fails
the test). The JAX side runs in this process on `make_mesh(jax.devices()
[:S])` over the 8 virtual CPU devices of `conftest.py`. Both start from the
same global, shard-major table; rank r feeds rows [r*n, (r+1)*n) of the
same id and grad batches that the JAX mesh shards.

Tolerances:

- plans (unique ids, counts, inverse, owners, bucket slots, buckets, the
  received ids), the stats and a hash table's keys: bit-exact (integer
  work, and the probe places ids as JAX's does);
- pulled rows: bit-exact (a copy), fp32 and bf16 wire;
- the table after the push (Adagrad): atol 2e-6 and rtol 2.5e-7, the
  rule's tolerance against jitted JAX (XLA contracts multiply-adds;
  bit-exact against JAX run op by op, `tests/test_torch_optimizers.py`),
  relative for the rows that many duplicates push far from unit scale
  (measured: 2 float32 ulps, 3.8e-6 at 17.39);
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import openembedding_tpu as jax_embed
from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import sharded as jax_sharded
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

VOCAB, DIM, N = 200, 4, 48        # ids per rank
CAPACITY = 64                     # hash slots per shard
TIMEOUT = 60


def _case(S, kind, wire="fp32", cf=0.0, grouped=False, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "hash":
        spec = {"input_dim": -1, "output_dim": DIM,
                "capacity": CAPACITY * S}
        pool = rng.integers(0, 2 ** 63 - 1, size=40, dtype=np.int64)
        pool[:3] = [2 ** 63 - 1, 0, 2 ** 62 + 5]
        ids = pool[rng.integers(0, len(pool), size=S * N)]
        rows = CAPACITY * S
    else:
        spec = {"input_dim": VOCAB, "output_dim": DIM}
        ids = rng.integers(0, VOCAB + 20, size=S * N)  # some out of vocab
        rows = -(-VOCAB // S) * S
    ids[rng.random(S * N) < 0.1] = -1  # pads
    return {"spec": spec, "ids": ids.astype(np.int64),
            "grads": rng.normal(size=(S * N, DIM)).astype(np.float32),
            "weights": rng.normal(size=(rows, DIM)).astype(np.float32),
            "accum": np.full((rows, DIM), 0.1, np.float32),
            "keys": np.full(rows, -1, np.int64), "capacity_factor": cf,
            "wire": wire, "grouped": grouped}


def _jax_protocol(S, case):
    """The case through the JAX package's protocol on an S-device mesh ->
    the same fields as `torch_mesh_ranks.protocol`, every per-rank array
    stacked in rank order."""
    spec = JaxSpec(name="v", variable_id=0, **case["spec"])
    opt = jax_embed.Adagrad(learning_rate=0.1)
    hashed = spec.use_hash_table
    state = JaxTable(
        weights=jnp.asarray(case["weights"]),
        slots={"accum": jnp.asarray(case["accum"])},
        keys=jnp.asarray(case["keys"]) if hashed else None,
        overflow=jnp.zeros((), jnp.int32) if hashed else None)
    tspec = JaxTable(weights=P("data"), slots={"accum": P("data")},
                     keys=P("data") if hashed else None,
                     overflow=P() if hashed else None)
    cf, wire = case["capacity_factor"], case["wire"]

    def step(state, ids, grads):
        if case["grouped"]:
            states, rows, stats, plans = jax_sharded.grouped_lookup_train(
                [spec], [state], [ids], capacity_factor=cf, wire=wire)
            state, rows, stats, plan = states[0], rows[0], stats[0], plans[0]
            states, push = jax_sharded.grouped_apply_gradients(
                [spec], [state], [opt], [ids], [grads], capacity_factor=cf,
                plans=[plan], wire=wire)
            state, push = states[0], push[0]
        else:
            state, rows, stats, plan = jax_sharded.sharded_lookup_train(
                spec, state, ids, capacity_factor=cf, wire=wire)
            state, push = jax_sharded.sharded_apply_gradients(
                spec, state, opt, ids, grads, capacity_factor=cf, plan=plan,
                wire=wire)
        per_rank = {k: jnp.reshape(v, (1,) + jnp.shape(v))
                    for k, v in {**stats, **push}.items()}
        return state, {
            "recv_ids": plan.recv_ids, "bucket_ids": plan.buckets.bucket_ids,
            "owner": plan.buckets.owner, "slot": plan.buckets.slot,
            "unique_ids": plan.uniq.unique_ids, "counts": plan.uniq.counts,
            "inverse": plan.uniq.inverse, "rows": rows, "stats": per_rank}

    mesh = jax_make_mesh(jax.devices()[:S])
    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(tspec, P("data"), P("data")),
                               out_specs=(tspec, P("data")),
                               check_vma=False))
    state, out = fn(state, jnp.asarray(case["ids"]),
                    jnp.asarray(case["grads"]))
    out = jax.tree_util.tree_map(np.asarray, out)
    out["weights"] = np.asarray(state.weights)
    out["accum"] = np.asarray(state.slots["accum"])
    if hashed:
        out["keys"], out["overflow"] = (np.asarray(state.keys),
                                        int(state.overflow))
    return out


CASES = {
    "array-fp32": dict(kind="array"),
    "array-bf16": dict(kind="array", wire="bf16"),
    "array-overflow": dict(kind="array", cf=0.3),
    "array-grouped-bf16": dict(kind="array", wire="bf16", grouped=True),
    "hash-fp32": dict(kind="hash"),
    "hash-grouped-bf16": dict(kind="hash", wire="bf16", grouped=True),
}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"S{s}")
def protocol_runs(request, tmp_path_factory):
    """Every case on S port ranks (one launch) and on the JAX mesh."""
    S = request.param
    cases = {name: _case(S, seed=i, **kw)
             for i, (name, kw) in enumerate(CASES.items())}
    port = run_local(ranks.protocol_cases, S, args=(cases,),
                     timeout_s=TIMEOUT,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return S, cases, port, {name: _jax_protocol(S, c)
                            for name, c in cases.items()}


def _per_rank(arr, S, r):
    n = arr.shape[0] // S
    return arr[r * n:(r + 1) * n]


@pytest.mark.parametrize("name", list(CASES))
def test_plans_and_received_ids_are_bit_exact(protocol_runs, name):
    S, cases, port, want = protocol_runs
    for r in range(S):
        got = port[r][name]
        for key in ("recv_ids", "bucket_ids", "owner", "slot", "unique_ids",
                    "counts", "inverse"):
            np.testing.assert_array_equal(
                got[key], _per_rank(want[name][key], S, r),
                err_msg=f"{name} rank {r} {key}")
        for key, v in got["stats"].items():
            np.testing.assert_array_equal(
                v, want[name]["stats"][key][r], err_msg=f"{name} {key}")
    if name == "array-overflow":
        assert sum(int(port[r][name]["stats"]["pull_overflow"])
                   for r in range(S)) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_pulled_rows_are_bit_exact(protocol_runs, name):
    S, _, port, want = protocol_runs
    for r in range(S):
        np.testing.assert_array_equal(
            port[r][name]["rows"], _per_rank(want[name]["rows"], S, r),
            err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_updates_match_within_the_rule_tolerance(protocol_runs, name):
    S, cases, port, want = protocol_runs
    weights = np.concatenate([port[r][name]["weights"] for r in range(S)])
    accum = np.concatenate([port[r][name]["accum"] for r in range(S)])
    np.testing.assert_allclose(weights, want[name]["weights"], rtol=2.5e-7,
                               atol=2e-6)
    np.testing.assert_allclose(accum, want[name]["accum"], rtol=2.5e-7,
                               atol=2e-6)
    assert not np.array_equal(weights, cases[name]["weights"])
    if "keys" in want[name]:
        keys = np.concatenate([port[r][name]["keys"] for r in range(S)])
        np.testing.assert_array_equal(keys, want[name]["keys"])
        for r in range(S):
            assert int(port[r][name]["overflow"]) == want[name]["overflow"]
    for r in range(S):
        assert port[r][name]["staged_bytes"] == 0  # gloo on host tensors


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        run_local(ranks.fail_on_rank_1, 2, timeout_s=TIMEOUT,
                  tmp_dir=str(tmp_path))

