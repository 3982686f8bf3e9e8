"""Online sync into a sharded servable: `ShardedModel.apply_update` of the
port against the JAX package's, on the same deltas.

Ported from `tests/test_sync.py::test_sharded_servable_apply_update_parity`.
The JAX MeshTrainer (8 host devices) trains a small DeepFM with an
`IncrementalPersister` (a delta every step); its checkpoint after step 1
loads into both packages' sharded servables, and every later delta is
applied to each. After every delta the port's rows are bit-equal to the
JAX servable's, and at the end to the mesh trainer's read-only pull; the
servable an update came from still answers as it did (RCU: a touched
shard is a clone, an untouched one is shared). Array tables at T = 2 and 8
shards, hashed tables at T = 8 (find-or-insert under the shard's probe).
A hash delta that no longer fits the serving table raises in both
packages, and the refusals of a bad delta are JAX's. Logits are held to
`tests/test_torch_serving.py`'s bfloat16 bound (atol 2e-2, rtol 1e-2).
"""

import json
import os
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.serving import ShardedModel as JaxSharded
from openembedding_tpu.parallel.sharded import sharded_lookup
from openembedding_tpu.persist import IncrementalPersister, PersistPolicy
from openembedding_tpu_torch import data
from openembedding_tpu_torch.parallel.serving import ShardedModel
from openembedding_tpu_torch.persist import _load_delta_table, list_deltas

from test_torch_serving import TOL

VOCAB = 1 << 10
HASH_SPACE = 1 << 40


def _chain(root, hashed):
    """The JAX mesh run: (trainer, final state, checkpoint after step 1,
    persist root, batches)."""
    kw = dict(hashed=True, capacity=1 << 14) if hashed else {}
    model = jax_make_deepfm(vocabulary=-1 if hashed else VOCAB, dim=4,
                            hidden=(8,), **kw)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(), seed=3)
    if hashed:
        # a serving hash table is sized from the checkpoint's ids (about
        # 0.7 full), so a delta may add only a few: the base batch again,
        # then the base batch with one row of new ids, twice
        base = next(data.synthetic_criteo(32, id_space=HASH_SPACE, steps=1,
                                          seed=9))
        new = next(data.synthetic_criteo(32, id_space=HASH_SPACE, steps=1,
                                         seed=6))
        batches = [base, base]
        for row in (0, 1):
            b = {k: np.array(v) for k, v in base.items() if k != "sparse"}
            ids = np.array(base["sparse"]["categorical"])
            ids[row] = new["sparse"]["categorical"][row]
            batches.append({**b, "sparse": {"categorical": ids}})
    else:
        batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=4,
                                             seed=5))
    state = trainer.init(batches[0])
    step = trainer.jit_train_step(batches[0], state)
    persist = str(root / "persist")
    ck = str(root / "ck")
    with IncrementalPersister(trainer, model, persist, window=2,
                              policy=PersistPolicy(every_steps=1),
                              full_every=100) as p:
        state, _ = step(state, batches[0])
        p.maybe_persist(state, batch=batches[0])
        p.wait()
        trainer.save(state, ck)
        for b in batches[1:]:
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
        p.wait()
    return trainer, state, ck, persist, batches


@pytest.fixture(scope="module")
def array_chain(tmp_path_factory):
    return _chain(tmp_path_factory.mktemp("array"), hashed=False)


@pytest.fixture(scope="module")
def hash_chain(tmp_path_factory):
    return _chain(tmp_path_factory.mktemp("hash"), hashed=True)


def _deltas(root):
    """[(step, model_version, tables, dense)] of a persist root, each
    delta's rows read the port's way (`persist._load_delta_table`)."""
    out = []
    for dstep, dpath in list_deltas(root):
        with open(os.path.join(dpath, "meta.json")) as f:
            meta = json.load(f)
        tables = {}
        for name in meta["tables"]:
            ids, w, _slots = _load_delta_table(dpath, name)
            tables[name] = (ids, w)
        with np.load(os.path.join(dpath, "dense.npz")) as z:
            dense = {k[len("params/"):]: z[k] for k in z.files
                     if k.startswith("params/")}
        out.append((dstep, meta["model_version"], tables, dense))
    return out


def _touched(batches):
    ids = np.unique(np.concatenate(
        [np.asarray(b["sparse"]["categorical"]).reshape(-1)
         for b in batches]))
    return ids[ids >= 0]


@pytest.mark.parametrize("kind,T", [("array", 2), ("array", 8),
                                    ("hash", 8)])
def test_sharded_servable_apply_update_parity(request, kind, T):
    trainer, state, ck, root, batches = request.getfixturevalue(
        f"{kind}_chain")
    sm = ShardedModel.load(ck, devices=["cpu"] * T)
    ref = JaxSharded.load(ck)
    assert sm.step == ref.step == 1
    ids = _touched(batches)
    probe = np.concatenate([ids, [-1, 12345 if kind == "hash" else VOCAB]])
    first = sm
    first_rows = first.lookup("categorical", probe).numpy().copy()
    deltas = _deltas(root)
    assert len(deltas) == 3
    for dstep, version, tables, dense in deltas:
        old = sm
        before = old.lookup("categorical", probe).numpy().copy()
        sm = sm.apply_update(tables, dense, step=dstep,
                             model_version=version)
        ref = ref.apply_update(tables, dense, step=dstep,
                               model_version=version)
        assert sm.step == dstep and sm is not old
        np.testing.assert_array_equal(
            sm.lookup("categorical", probe).numpy(),
            np.asarray(ref.lookup("categorical", probe)))
        # RCU: the servable the update came from answers as it did
        np.testing.assert_array_equal(
            old.lookup("categorical", probe).numpy(), before)
        # the shards the delta did not touch are shared, the others copied
        touched = {int(i) % T for i in tables["categorical"][0]}
        for r, (a, b) in enumerate(zip(old.tables["categorical"],
                                       sm.tables["categorical"])):
            assert (a.weights is b.weights) == (r not in touched)
    np.testing.assert_array_equal(
        first.lookup("categorical", probe).numpy(), first_rows)

    # the end state: the mesh trainer's own read-only pull
    spec = trainer.model.specs["categorical"]
    pull = jax.jit(jax.shard_map(
        partial(sharded_lookup, spec, axis=trainer.axis), mesh=trainer.mesh,
        in_specs=(trainer._table_pspec(spec), P()), out_specs=P(),
        check_vma=False))
    want = np.asarray(pull(state.tables["categorical"], jnp.asarray(ids)))
    np.testing.assert_array_equal(sm.lookup("categorical", ids).numpy(),
                                  want)
    req = {"sparse": {"categorical": np.asarray(
        batches[0]["sparse"]["categorical"])},
        "dense": np.asarray(batches[0]["dense"])}
    np.testing.assert_allclose(sm.predict(req).numpy(),
                               np.asarray(ref.predict(req)),
                               **TOL["bfloat16"])


def test_hash_delta_that_overflows_the_serving_table_raises(hash_chain):
    """A delta of more new ids than the serving shards have free slots
    raises in both packages, and the servable stays as it was."""
    trainer, state, ck, root, batches = hash_chain
    sm = ShardedModel.load(ck, devices=["cpu"] * 8)
    ref = JaxSharded.load(ck)
    slots = sum(ts.keys.shape[0] for ts in sm.tables["categorical"])
    new = np.arange(1, slots + 1, dtype=np.int64) * 1_000_003
    rows = np.ones((new.size, 5), np.float32)
    _, _, _, dense = _deltas(root)[0]
    probe = _touched(batches[:1])
    before = sm.lookup("categorical", probe).numpy().copy()
    for servable in (sm, ref):
        with pytest.raises(RuntimeError, match="did not fit"):
            servable.apply_update({"categorical": (new, rows)}, dense,
                                  step=9)
    np.testing.assert_array_equal(sm.lookup("categorical", probe).numpy(),
                                  before)


@pytest.mark.parametrize("fault", ["ids_out_of_range", "torn_rows",
                                   "unknown_variable", "dense_missing",
                                   "dense_shape"])
def test_bad_deltas_are_refused_as_jax_refuses_them(array_chain, fault):
    trainer, state, ck, root, batches = array_chain
    _, _, tables, dense = _deltas(root)[0]
    ids, rows = tables["categorical"]
    tables, dense = dict(tables), dict(dense)
    if fault == "ids_out_of_range":
        tables["categorical"] = (np.append(ids[:-1], VOCAB), rows)
        err = ValueError
    elif fault == "torn_rows":
        tables["categorical"] = (ids, rows[:-1])
        err = ValueError
    elif fault == "unknown_variable":
        tables["nope"] = (ids, rows)
        err = KeyError
    elif fault == "dense_missing":
        dense.pop(sorted(dense)[0])
        err = ValueError
    else:
        k = sorted(dense)[0]
        dense[k] = np.zeros(np.shape(dense[k])[:-1] + (3,), np.float32)
        err = ValueError
    sm = ShardedModel.load(ck, devices=["cpu"] * 4)
    with pytest.raises(err):
        sm.apply_update(tables, dense, step=9)
    with pytest.raises(err):
        JaxSharded.load(ck).apply_update(tables, dense, step=9)
