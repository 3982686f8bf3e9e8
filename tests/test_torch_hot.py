"""Hot-row replication on the port's mesh against the JAX package's.

- Identities (`build_hot_identity`): keys, rank and ids equal to the JAX
  package's, for array tables (int32 keys) and hash tables (int64 keys),
  with duplicate and invalid candidates and more candidates than H.
- The protocol: one training pull and push of one table with a hot set
  installed by `hot_gather` (and in some cases residuals and a migration
  directory), then `hot_writeback` / `mig_writeback`, on S = 2 port ranks
  (S = 4: `test_torch_hot_s4.py`) against the JAX mesh on the same
  inputs. Pulled rows, residuals
  and stats are bit-exact (copies, the int8 codec, integer work); the
  tables, caches and annexes after the push are held to the Adagrad rule's
  tolerance against jitted JAX (atol 2e-6, rtol 2.5e-7, as in
  `test_torch_mesh.py`; measured: up to 2 float32 ulps); a hash table's
  keys and overflow are bit-exact. The int8 `hot_wire` runs its reduce
  (encode, all_to_all, sum in rank order, encode, all_gather) and holds
  the same bound.
- The lifecycle inside the port: a gather followed by a write-back leaves
  the shards bit for bit; refreshes, migrations, `hot_sync`, a save and a
  load between steps keep every tensor of the state (`data_ptr`), so no
  graph goes stale; the load keeps the sets and gathers their rows from
  the loaded shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import openembedding_tpu as jax_embed
from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.embedding import HotRows as JaxHot
from openembedding_tpu.embedding import MigRows as JaxMig
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import sharded as jax_sharded
from openembedding_tpu_torch import data
from openembedding_tpu_torch.embedding import EmbeddingSpec
from openembedding_tpu_torch.parallel import sharded
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

VOCAB, DIM, N = 200, 4, 48        # ids per rank
CAPACITY = 64                     # hash slots per shard
TIMEOUT = 60
TABLE_TOL = dict(rtol=2.5e-7, atol=2e-6)


def _spec_fields(kind, S):
    if kind == "hash":
        return {"input_dim": -1, "output_dim": DIM, "capacity": CAPACITY * S}
    return {"input_dim": VOCAB, "output_dim": DIM}


def _case(S, kind, wire="fp32", *, hot=0, mig=0, ef=False, hot_wire=None,
          grouped=False, seed=0):
    """A skewed batch: a few ids take most positions, so the hot set and
    the moves hold ids the batch pulls."""
    rng = np.random.default_rng(seed)
    if kind == "hash":
        pool = rng.integers(0, 2 ** 63 - 1, size=40, dtype=np.int64)
        pool[:3] = [2 ** 63 - 1, 0, 2 ** 62 + 5]
        rows = CAPACITY * S
    else:
        pool = rng.permutation(VOCAB + 20)[:40].astype(np.int64)
        rows = -(-VOCAB // S) * S
    p = 1.0 / np.arange(1, len(pool) + 1)
    ids = pool[rng.choice(len(pool), size=S * N, p=p / p.sum())]
    ids[rng.random(S * N) < 0.1] = -1
    case = {"spec": _spec_fields(kind, S), "ids": ids,
            "grads": rng.normal(size=(S * N, DIM)).astype(np.float32),
            "weights": rng.normal(size=(rows, DIM)).astype(np.float32),
            "accum": np.full((rows, DIM), 0.1, np.float32),
            "keys": np.full(rows, -1, np.int64), "wire": wire,
            "hot_wire": hot_wire, "grouped": grouped,
            "hot_rows": hot, "mig_rows": mig,
            # candidates hottest first, a duplicate and an invalid id among
            # them; the moves skip the hot ids
            "hot_ids": np.concatenate([pool[:hot], pool[:2], [-5]]),
            "moves": (pool[hot:hot + mig],
                      (pool[hot:hot + mig] + 1) % S)}
    if ef:
        case["ef"] = (rng.normal(size=(rows, DIM)) * 1e-3).astype(np.float32)
    return case


def _jax_identity(fn, *args, **kw):
    return {k: jnp.asarray(v) for k, v in fn(*args, **kw).items()}


def jax_placement(S, case):
    """`torch_mesh_ranks.placement_protocol` through the JAX package on an
    S-device mesh, every per-rank array stacked in rank order."""
    spec = JaxSpec(name="v", variable_id=0, **case["spec"])
    opt = jax_embed.Adagrad(learning_rate=0.1)
    hashed = spec.use_hash_table
    has_ef = case.get("ef") is not None
    state = JaxTable(
        weights=jnp.asarray(case["weights"]),
        slots={"accum": jnp.asarray(case["accum"])},
        keys=jnp.asarray(case["keys"]) if hashed else None,
        overflow=jnp.zeros((), jnp.int32) if hashed else None,
        ef=jnp.asarray(case["ef"]) if has_ef else None)
    H, M = case.get("hot_rows", 0), case.get("mig_rows", 0)
    hot_id = mig_id = None
    if H:
        hot_id = _jax_identity(jax_sharded.build_hot_identity, spec, H,
                               case["hot_ids"], key_template=state.keys)
    if M:
        ids, owners = case["moves"]
        mig_id = _jax_identity(jax_sharded.build_mig_identity, spec, M, ids,
                               owners, num_shards=S, key_template=state.keys)
    tin = JaxTable(weights=P("data"), slots={"accum": P("data")},
                   keys=P("data") if hashed else None,
                   overflow=P() if hashed else None,
                   ef=P("data") if has_ef else None)
    wire, hot_wire = case["wire"], case.get("hot_wire")

    def step(state, ids, grads, hot_id, mig_id):
        if hot_id is not None:
            state = jax_sharded.hot_gather(spec, state, hot_id)
        if mig_id is not None:
            state = jax_sharded.mig_gather(spec, state, mig_id)
        if case.get("grouped"):
            states, rows, stats, plans = jax_sharded.grouped_lookup_train(
                [spec], [state], [ids], wire=wire)
            states, _ = jax_sharded.grouped_apply_gradients(
                [spec], states, [opt], [ids], [grads], plans=plans,
                wire=wire, hot_wire=hot_wire)
            state, rows, stats = states[0], rows[0], stats[0]
        else:
            state, rows, stats, plan = jax_sharded.sharded_lookup_train(
                spec, state, ids, wire=wire)
            state, _ = jax_sharded.sharded_apply_gradients(
                spec, state, opt, ids, grads, plan=plan, wire=wire,
                hot_wire=hot_wire)
        out = {"rows": rows, "stats": {k: jnp.reshape(v, (1,) + jnp.shape(v))
                                       for k, v in stats.items()},
               "pushed": {"weights": state.weights,
                          "accum": state.slots["accum"]}}
        if state.ef is not None:
            out["ef"] = state.ef
        for kind in ("hot", "mig"):
            part = getattr(state, kind)
            if part is not None:
                out[kind] = {"weights": part.weights,
                             "accum": part.slots["accum"]}
        state = jax_sharded.hot_writeback(spec, state)
        state = jax_sharded.mig_writeback(spec, state)
        state = state.replace(hot=None, mig=None)
        out.update(weights=state.weights, accum=state.slots["accum"])
        return state, out

    ospec = {"rows": P("data"), "stats": P("data"),
             "pushed": {"weights": P("data"), "accum": P("data")},
             "weights": P("data"), "accum": P("data")}
    if has_ef:
        ospec["ef"] = P("data")
    if H:
        ospec["hot"] = {"weights": P(), "accum": P()}
    if M:
        ospec["mig"] = {"weights": P("data"), "accum": P("data")}
    mesh = jax_make_mesh(jax.devices()[:S])
    fn = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(tin, P("data"), P("data"), P(), P()),
        out_specs=(tin, ospec), check_vma=False))
    state, out = fn(state, jnp.asarray(case["ids"]),
                    jnp.asarray(case["grads"]), hot_id, mig_id)
    out = jax.tree_util.tree_map(np.asarray, out)
    if hashed:
        out["keys"], out["overflow"] = (np.asarray(state.keys),
                                        int(state.overflow))
    return out


def check_placement(S, port_ranks, want):
    """The port's ranks' results (stacked in rank order) against
    `jax_placement`'s."""
    def stack(get):
        return np.concatenate([get(port_ranks[r]) for r in range(S)])

    np.testing.assert_array_equal(stack(lambda o: o["rows"]), want["rows"])
    for k, v in want["stats"].items():
        got = np.stack([np.asarray(port_ranks[r]["stats"][k])
                        for r in range(S)]).reshape(v.shape)
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert set(port_ranks[0]["stats"]) == set(want["stats"])
    if "ef" in want:
        np.testing.assert_array_equal(stack(lambda o: o["ef"]), want["ef"])
    for part in ("pushed", "mig"):
        if part in want:
            for k in ("weights", "accum"):
                np.testing.assert_allclose(stack(lambda o: o[part][k]),
                                           want[part][k], err_msg=part + k,
                                           **TABLE_TOL)
    if "hot" in want:
        for r in range(S):
            for k in ("weights", "accum"):
                np.testing.assert_allclose(port_ranks[r]["hot"][k],
                                           want["hot"][k], **TABLE_TOL)
            np.testing.assert_array_equal(port_ranks[r]["hot"]["weights"],
                                          port_ranks[0]["hot"]["weights"])
    for k in ("weights", "accum"):
        np.testing.assert_allclose(stack(lambda o: o[k]), want[k],
                                   err_msg=k, **TABLE_TOL)
    if "keys" in want:
        np.testing.assert_array_equal(stack(lambda o: o["keys"]),
                                      want["keys"])
        assert all(port_ranks[r]["overflow"] == want["overflow"]
                   for r in range(S))


def placement_runs(cases_fn, S):
    """A module fixture: every case of `cases_fn(S)` on S port ranks (one
    launch) and on the JAX mesh."""
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        cases = cases_fn(S)
        port = run_local(ranks.placement_protocol_cases, S, args=(cases,),
                         timeout_s=TIMEOUT,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return S, {name: (port, jax_placement(S, c))
                   for name, c in cases.items()}
    return runs


HOT_CASES = {
    "array-fp32": dict(kind="array", hot=8),
    "array-int8-ef-hot_int8": dict(kind="array", wire="int8", hot=8,
                                   ef=True, hot_wire="int8"),
    "array-bf16-hot_bf16-grouped": dict(kind="array", wire="bf16", hot=8,
                                        grouped=True),
    "hash-fp32-grouped": dict(kind="hash", hot=8, grouped=True),
    "hash-int8-ef-hot_int8-grouped": dict(kind="hash", wire="int8", hot=6,
                                          ef=True, hot_wire="int8",
                                          grouped=True),
}

def hot_cases(S):
    return {name: _case(S, seed=i, **kw)
            for i, (name, kw) in enumerate(HOT_CASES.items())}


def one_step_test(S):
    """(the module fixture, the test) of the hot cases at S ranks."""
    runs = placement_runs(hot_cases, S)

    @pytest.mark.parametrize("name", list(HOT_CASES))
    def test_one_step_with_hot_rows_matches_the_jax_mesh(runs, name):
        S, by_name = runs
        port, want = by_name[name]
        check_placement(S, [port[r][name] for r in range(S)], want)
        stats = port[0][name]["stats"]
        assert stats["hot_unique"] > 0 and stats["hot_hits"] > 0

    return runs, test_one_step_with_hot_rows_matches_the_jax_mesh


# S = 4: `test_torch_hot_s4.py` (a file each stays well under 40 s)
runs, test_one_step_with_hot_rows_matches_the_jax_mesh = one_step_test(2)


def _identity_cases():
    rng = np.random.default_rng(3)
    big = rng.integers(0, 2 ** 62, size=300, dtype=np.int64)
    small = rng.integers(0, VOCAB + 50, size=300).astype(np.int64)
    for kind, cand in (("array", small), ("hash", big)):
        cand = np.concatenate([cand[:5], cand[:5], [-1, -7], cand[5:]])
        for H in (1, 8, 100, 512):
            yield kind, H, cand
        yield kind, 8, None


@pytest.mark.parametrize("kind,H,cand", list(_identity_cases()),
                         ids=lambda v: getattr(v, "size", v))
def test_hot_identity_equals_the_jax_package(kind, H, cand):
    fields = _spec_fields(kind, 2)
    got = sharded.build_hot_identity(EmbeddingSpec(name="v", **fields), H,
                                     cand)
    template = np.full(4, -1, np.int64) if kind == "hash" else None
    want = jax_sharded.build_hot_identity(JaxSpec(name="v", **fields), H,
                                          cand, key_template=template)
    assert set(got) == set(want) == {"keys", "rank", "ids"}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    placed = int((got["ids"] >= 0).sum())
    assert placed == int((got["rank"] < H).sum()) <= H


def _lifecycle_cfg(kind, S, tmp):
    hashed = kind == "hash"
    batches = list(data.synthetic_criteo(
        64, id_space=(1 << 40) if hashed else 1000, steps=3, seed=7))
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in batches])
    u, c = np.unique(ids, return_counts=True)
    top = u[np.argsort(-c, kind="stable")]
    return {"vocab": 1000, "hashed": hashed, "capacity": 4096,
            "wire": "fp32", "hot_rows": 16, "mig_rows": 8,
            "batches": batches, "tmp": str(tmp),
            "hot_ids": {0: top[:16], 2: top[8:24]},
            "moves": {0: (top[30:38], (top[30:38] + 1) % S),
                      3: (top[40:44], (top[40:44] + 1) % S)}}


@pytest.mark.parametrize("kind", ["array", "hash"])
def test_lifecycle_round_trips_and_keeps_the_tensors(kind, tmp_path):
    out = run_local(ranks.lifecycle, 2,
                    args=(_lifecycle_cfg(kind, 2, tmp_path / "ckpt"),),
                    timeout_s=TIMEOUT, tmp_dir=str(tmp_path))
    for r in out:
        assert r["round_trip"], "gather then write-back moved a bit"
        assert r["same_tensors"], "a refresh or a load replaced a tensor"
        assert r["load_regathers"], "a load lost the sets or their rows"
        assert r["placed"] == {"hot": 16, "mig": 4}
