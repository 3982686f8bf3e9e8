"""Online sync across the packages: the wire protocol is the JAX package's,
so a node of either package follows a publisher of the other.

- A port serving node follows a JAX publisher node (a JAX trainer's
  `IncrementalPersister` root), and a JAX serving node follows a port
  publisher node. At fp32 the applied rows equal the trainer's live rows
  bit for bit; at bf16 and int8 they equal what a node of the publisher's
  own package applies from the same feed, bit for bit.
- `StandaloneModel.apply_update` on one delta gives the JAX servable's
  tables bit for bit (array, hash and sparse_as_dense tables; the dense
  params exactly), and refuses a torn or foreign delta with JAX's message,
  leaving the servable as it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.persist import \
    IncrementalPersister as JaxIncrementalPersister
from openembedding_tpu.persist import PersistPolicy as JaxPersistPolicy
from openembedding_tpu.serving import ModelManager as JaxManager
from openembedding_tpu.serving import ModelRegistry as JaxRegistry
from openembedding_tpu.sync import SyncSubscriber as JaxSubscriber
from openembedding_tpu_torch import IncrementalPersister, PersistPolicy, data
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.serving import ModelManager, ModelRegistry
from openembedding_tpu_torch.sync import SyncSubscriber

from torch_sync_util import VOCAB, node, reset_telemetry, train_setup

IDS = np.arange(VOCAB, dtype=np.int64)


@pytest.fixture(autouse=True)
def _fresh():
    reset_telemetry()
    yield
    reset_telemetry()


def _jax_chain(tmp_path, steps=4):
    """A JAX trainer's base at step 1 (exported) and deltas to `steps` ->
    (root, export_dir, the live table's rows)."""
    model = jax_make_deepfm(VOCAB, 4, hidden=(8,), compute_dtype=jnp.float32)
    trainer = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=steps,
                                         seed=1))
    state = trainer.init(batches[0])
    step = trainer.jit_train_step()
    root, export_dir = str(tmp_path / "jroot"), str(tmp_path / "jexport")
    with JaxIncrementalPersister(trainer, model, root, window=2,
                                 policy=JaxPersistPolicy(every_steps=1),
                                 full_every=100) as p:
        for i, b in enumerate(batches):
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
            p.wait()
            if i == 0:
                jax_export(state, model, export_dir, model_sign="x")
    return root, export_dir, np.asarray(state.tables["categorical"].weights)


def _port_chain(tmp_path, steps=4):
    model, trainer, state, batches = train_setup(steps)
    root, export_dir = str(tmp_path / "proot"), str(tmp_path / "pexport")
    with IncrementalPersister(trainer, model, root, window=2,
                              policy=PersistPolicy(every_steps=1),
                              full_every=100) as p:
        for i, b in enumerate(batches):
            state, _ = trainer.train_step(state, b)
            p.maybe_persist(state, batch=b)
            p.wait()
            if i == 0:
                export_standalone(state, model, export_dir, model_sign="x")
    return root, export_dir, state.tables["categorical"].weights.numpy()


def _follow(tmp_path, package, feed, export_dir, fmt):
    """A manager of `package` loads the export and follows `feed` in one
    poll -> the rows it serves for every id."""
    reg = str(tmp_path / f"reg_{package}_{fmt}")
    if package == "port":
        mgr = ModelManager(ModelRegistry(reg), device="cpu")
        sub = SyncSubscriber(mgr, "x", feed, wire=fmt)
    else:
        mgr = JaxManager(JaxRegistry(reg))
        sub = JaxSubscriber(mgr, "x", feed, wire=fmt)
    mgr.load_model("x", export_dir)
    assert sub.poll() == 3, sub.last_error
    assert sub.version == 4 and mgr.find_model("x").step == 4
    return np.asarray(mgr.find_model("x").lookup("categorical", IDS))


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_nodes_follow_the_other_package(tmp_path, publisher):
    root, export_dir, live = (_jax_chain if publisher == "jax"
                              else _port_chain)(tmp_path)
    follower = "port" if publisher == "jax" else "jax"
    with node(str(tmp_path / "pub"), publisher,
              publish={"x": root}) as (url, _):
        got = _follow(tmp_path, follower, url, export_dir, "fp32")
        np.testing.assert_array_equal(got.view(np.int32), live.view(np.int32))
        for fmt in ("bf16", "int8"):
            got = _follow(tmp_path, follower, url, export_dir, fmt)
            own = _follow(tmp_path, publisher, url, export_dir, fmt)
            np.testing.assert_array_equal(got.view(np.int32),
                                          own.view(np.int32))
            assert not np.array_equal(got, live)  # the codec rounded


# -- apply_update against JAX -------------------------------------------------


def _export(tmp_path, kind):
    """A JAX export of a small DeepFM whose table is `kind` (array, hash or
    sparse_as_dense), loaded by both packages."""
    model = jax_make_deepfm(VOCAB, 4, hidden=(8,), compute_dtype=jnp.float32,
                            hashed=kind == "hash",
                            capacity=4 * VOCAB if kind == "hash" else 0)
    if kind == "sad":
        spec = model.specs["categorical"]
        model.specs["categorical"] = dataclasses.replace(
            spec, sparse_as_dense=True)
    trainer = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    batch = next(iter(data.synthetic_criteo(64, id_space=VOCAB, steps=1,
                                            seed=2)))
    state = trainer.init(batch)
    state, _ = trainer.jit_train_step()(state, batch)  # hash: inserts ids
    path = str(tmp_path / f"export_{kind}")
    jax_export(state, model, path, model_sign="x")
    return (JaxStandalone.load(path),
            StandaloneModel.load(path, device="cpu"))


def _delta(jsm, kind, rng):
    """A delta of `jsm`'s shape: rows for existing and (hash) new ids, and
    a perturbed dense tree."""
    t = jsm._tables["categorical"]
    if kind == "hash":
        ids = np.concatenate([t["ids"][::3], rng.integers(
            VOCAB, 1 << 40, 20)]).astype(np.int64)
    else:
        ids = rng.choice(VOCAB, 200, replace=False).astype(np.int64)
    rows = rng.standard_normal((ids.size, t["dim"])).astype(np.float32)
    dense = {k: (np.asarray(v) + rng.standard_normal(np.shape(v)))
             .astype(np.float32)
             for k, v in _flatten_params(jsm.dense_params).items()}
    if kind == "sad":
        dense["__embeddings__/categorical"] = rng.standard_normal(
            np.shape(t["weights"])).astype(np.float32)
        return {}, dense
    return {"categorical": (ids, rows)}, dense


@pytest.mark.parametrize("kind", ["array", "hash", "sad"])
def test_apply_update_matches_jax_bit_for_bit(tmp_path, kind):
    jsm, tsm = _export(tmp_path, kind)
    rng = np.random.default_rng(3)
    first = tsm
    old = {k: v["weights"].clone() for k, v in tsm._tables.items()}
    old_dense = tsm.export_dense()
    for step in (2, 3):
        tables, dense = _delta(jsm, kind, rng)
        jsm = jsm.apply_update(tables, dense, step=step, model_version=7)
        new = tsm.apply_update(tables, dense, step=step, model_version=7)
        assert new is not tsm and (new.step, new.model_version) == (step, 7)
        tsm = new
        for name, jt in jsm._tables.items():
            tt = tsm._tables[name]
            assert tt["kind"] == jt["kind"]
            w = tt["weights"].numpy()
            want = np.asarray(jt["weights"])
            assert w.shape == want.shape
            np.testing.assert_array_equal(w.view(np.int32),
                                          want.view(np.int32))
            if jt["kind"] == "hash":
                np.testing.assert_array_equal(tt["ids"], jt["ids"])
        got_dense = tsm.export_dense()
        want_dense = jsm.export_dense()
        assert got_dense.keys() == want_dense.keys()
        for k, v in want_dense.items():
            np.testing.assert_array_equal(got_dense[k], v)
    if kind != "hash":  # the same predict from the same tables and tower
        batch = next(iter(data.synthetic_criteo(8, id_space=VOCAB, steps=1,
                                                seed=4)))
        np.testing.assert_allclose(tsm.predict(batch).numpy(),
                                   np.asarray(jsm.predict(batch)),
                                   atol=1e-5, rtol=1e-5)
    # RCU: the first servable's tensors were never written
    for k, w in old.items():
        assert torch.equal(first._tables[k]["weights"], w)
    for k, v in first.export_dense().items():
        np.testing.assert_array_equal(v, old_dense[k])


@pytest.mark.parametrize("fault", ["torn", "unknown", "range", "dense",
                                   "shape"])
def test_apply_update_refuses_as_jax_does(tmp_path, fault):
    jsm, tsm = _export(tmp_path, "array")
    tables, dense = _delta(jsm, "array", np.random.default_rng(5))
    ids, rows = tables["categorical"]
    if fault == "torn":
        tables["categorical"] = (ids, rows[:-1])
    elif fault == "unknown":
        tables["nope"] = tables.pop("categorical")
    elif fault == "range":
        ids = ids.copy()
        ids[0] = VOCAB + 5
        tables["categorical"] = (ids, rows)
    elif fault == "dense":
        dense.pop(sorted(dense)[0])
    else:
        k = sorted(dense)[0]
        dense[k] = np.concatenate([dense[k], dense[k]])
    errors = []
    for sm in (jsm, tsm):
        with pytest.raises((KeyError, ValueError)) as e:
            sm.apply_update(tables, dense, step=2)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_recipe_less_export_keeps_its_dense_params(tmp_path):
    """An export without `model_config.json` (no module to load the tower
    into) still exports and updates its dense params as JAX's does."""
    import os
    jsm, _ = _export(tmp_path, "array")
    path = str(tmp_path / "export_array")
    os.remove(os.path.join(path, "model_config.json"))
    jsm, tsm = JaxStandalone.load(path), StandaloneModel.load(path,
                                                              device="cpu")
    assert tsm.model is None and tsm.dense is None
    tables, dense = _delta(jsm, "array", np.random.default_rng(6))
    for _ in range(2):
        got, want = tsm.export_dense(), jsm.export_dense()
        assert got.keys() == want.keys() and got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
        assert tsm.export_manifest() == jsm.export_manifest()
        jsm = jsm.apply_update(tables, dense, step=2)
        tsm = tsm.apply_update(tables, dense, step=2)
