"""The port's incremental persistence (`IncrementalPersister`: a full base,
then touched-row deltas chained by parent pointers) against the JAX
package's, on the small DeepFM of `tests/test_persist.py`.

A restore (the base, then the chain's consistent prefix) equals the live
state bit for bit: tables, slots, dense params and slots, the step
counters; a hash table by id -> rows (a load places a contended slot by
`np_hash_insert`, lowest index wins, the replay by the device probe,
highest wins: ROADMAP.md's ground rules). The dirty tracker is held to
the JAX tracker on the same batches, and chains written by the JAX
package (array and hash tables, the hash keys single-lane and split-pair)
restore in the port equal to the JAX run's live state.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import openembedding_tpu as jax_embed
from openembedding_tpu.initializers import Constant as JaxConstant
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.persist import DirtyTracker as JaxDirtyTracker
from openembedding_tpu.persist import \
    IncrementalPersister as JaxIncrementalPersister
from openembedding_tpu.persist import PersistPolicy as JaxPersistPolicy
from openembedding_tpu_torch import (IncrementalPersister, PersistPolicy,
                                     convert, data, optimizers,
                                     restore_server_model)
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.persist import (DirtyTracker, delta_chain,
                                             list_deltas, list_persists)

from test_torch_persist import _assert_bit_equal, _numpy_state

VOCAB = 1 << 10
CAPACITY = 4096


def _trainer(model):
    return Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                   device="cpu")


@pytest.fixture()
def setup():
    model = make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))
    trainer = _trainer(model)
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=6, seed=1))
    return model, trainer, trainer.init(batches[0]), batches


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _run(trainer, model, state, batches, root, *, every=2, full_every=100,
         wait_each=False, **kw):
    """Train on `batches`, observing each; -> (state, {step: a clone at each
    persist}, the persister)."""
    states = {}
    with IncrementalPersister(trainer, model, root, window=2,
                              policy=PersistPolicy(every_steps=every),
                              full_every=full_every, **kw) as p:
        for b in batches:
            state, _ = trainer.train_step(state, b)
            if p.maybe_persist(state, batch=b):
                states[state.step] = state.clone()
                if wait_each:
                    p.wait()
        p.wait()
    return state, states, p


def _restore(model, root, batch):
    fresh = _trainer(model)
    return fresh, restore_server_model(fresh.init(batch), model, root,
                                       trainer=fresh)


def test_incremental_restore_equals_live_state(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _, p = _run(trainer, model, state, batches, root)
    assert [s for s, _ in list_persists(root)] == [2]
    assert [s for s, _ in list_deltas(root)] == [4, 6]
    assert [r["kind"] for r in p.history] == ["full", "delta", "delta"]
    for r in p.history[1:]:
        assert r["rows"] == r["touched"]["categorical"] > 0
    names = sorted(os.listdir(list_deltas(root)[0][1]))
    assert names == ["COMMIT", "dense.npz", "done.0", "meta.json",
                     "table_categorical.npz"]
    fresh, restored = _restore(model, root, batches[0])
    _assert_bit_equal(restored, state)
    a, _ = fresh.train_step(restored, batches[0])
    b, _ = trainer.train_step(state, batches[0])
    _assert_bit_equal(a, b)


def test_incremental_bytes_proportional_to_touched(tmp_path):
    """A 2^16-row table trained on batches that touch 64 ids: every delta
    is under 1/100 of the full base."""
    big = 1 << 16
    model = make_deepfm(vocabulary=big, dim=4, hidden=(8,))
    trainer = _trainer(model)
    rng = np.random.default_rng(7)
    hot = rng.integers(0, big, size=64)
    batches = [{"sparse": {"categorical":
                           hot[rng.integers(0, 64, size=(16, 26))]
                           .astype(np.int32)},
                "label": rng.random(16).astype(np.float32)}
               for _ in range(4)]
    state = trainer.init(batches[0])
    root = str(tmp_path / "persist")
    state, _, p = _run(trainer, model, state, batches, root, every=1)
    fulls, deltas = list_persists(root), list_deltas(root)
    assert len(fulls) == 1 and len(deltas) == 3
    full_bytes = _dir_bytes(fulls[0][1])
    for (_, path), rec in zip(deltas, p.history[1:]):
        assert _dir_bytes(path) * 100 < full_bytes
        assert rec["bytes"] == _dir_bytes(path)
    _, restored = _restore(model, root, batches[0])
    _assert_bit_equal(restored, state)


def test_incremental_uncommitted_delta_ignored(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, states, _ = _run(trainer, model, state, batches, root,
                            wait_each=True)
    os.remove(os.path.join(list_deltas(root)[-1][1], "COMMIT"))
    _, restored = _restore(model, root, batches[0])
    assert restored.step == 4  # the consistent prefix: base 2 + delta 4
    _assert_bit_equal(restored, states[4])


def test_incremental_full_every_and_gc(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _, p = _run(trainer, model, state, batches, root, every=1,
                       full_every=2, keep=10)
    # persists at 1..6: fulls at 1 and 4, two deltas after each
    assert [r["kind"] for r in p.history] == [
        "full", "delta", "delta", "full", "delta", "delta"]
    assert [s for s, _ in list_persists(root)][-1] == 4
    assert [s for s, _ in list_deltas(root)] == [5, 6]
    _, restored = _restore(model, root, batches[0])
    _assert_bit_equal(restored, state)


def test_superseded_delta_gc_opt_out(setup, tmp_path):
    model, trainer, _, batches = setup
    for prune, keeps_old in ((True, False), (False, True)):
        root = str(tmp_path / f"persist_{prune}")
        state, _, _ = _run(trainer, model, trainer.init(batches[0]), batches,
                           root, every=1, full_every=2, keep=10,
                           wait_each=True, prune_deltas=prune)
        newest_full = list_persists(root)[-1][0]
        assert newest_full == 4
        old = [d for d, _ in list_deltas(root) if d <= newest_full]
        assert bool(old) == keeps_old, (prune, old)
        _, restored = _restore(model, root, batches[0])
        _assert_bit_equal(restored, state)


def test_incremental_unobserved_window_falls_back_to_full(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    with IncrementalPersister(trainer, model, root, window=2,
                              policy=PersistPolicy(every_steps=1),
                              full_every=100) as p:
        state, _ = trainer.train_step(state, batches[0])
        p.maybe_persist(state, batch=batches[0])  # the base
        state, _ = trainer.train_step(state, batches[1])
        with pytest.warns(RuntimeWarning, match="observed"):
            p.maybe_persist(state)  # nothing observed: full, with a warning
    assert [s for s, _ in list_persists(root)] == [1, 2]
    assert list_deltas(root) == []


def test_delta_chain_broken_link_replays_prefix(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    _, states, _ = _run(trainer, model, state, batches[:4], root, every=1,
                        wait_each=True)
    deltas = list_deltas(root)
    assert [s for s, _ in deltas] == [2, 3, 4]
    shutil.rmtree(deltas[1][1])  # delta 3 goes
    base, chain = delta_chain(root)
    assert base is not None
    assert [os.path.basename(c) for c in chain] == ["delta_000000000002"]
    _, restored = _restore(model, root, batches[0])
    assert restored.step == 2
    _assert_bit_equal(restored, states[2])


def test_dirty_tracker_window_semantics():
    model = make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))
    jm = jax_make_deepfm(VOCAB, 4, hidden=(8,))
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=3, seed=5))
    batches.append({"sparse": {"categorical": np.asarray([[3, -1], [7, 7]])}})
    port, ref = DirtyTracker(model), JaxDirtyTracker(jm)
    for b in batches:
        port.observe(b)
        ref.observe(b)
    assert port.observed == ref.observed == 4
    got, want = port.take(), ref.take()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["categorical"], want["categorical"])
    assert got["categorical"].dtype == np.int64
    assert (got["categorical"] >= 0).all()
    assert port.take()["categorical"].size == 0  # the window starts anew
    # CPU tensors observe like numpy
    port.observe({"sparse": {"categorical": torch.tensor([[5, 3], [9, 5]])}})
    np.testing.assert_array_equal(port.take()["categorical"], [3, 5, 9])


def test_dirty_tracker_applies_batch_transform():
    """The tracker runs the model's `batch_transform` as the step does:
    the table's feature may exist only after it."""
    model = make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))
    jm = jax_make_deepfm(VOCAB, 4, hidden=(8,))
    feat = model.specs["categorical"].feature_name

    def transform(batch):
        sp = dict(batch["sparse"])
        sp[feat] = np.concatenate([np.asarray(sp["site_a"]),
                                   np.asarray(sp["site_b"])], axis=1)
        return {**batch, "sparse": sp}

    model.batch_transform = transform
    jm.batch_transform = transform
    batch = {"sparse": {"site_a": np.array([[1, 2]], np.int64),
                        "site_b": np.array([[3, 2, 7]], np.int64)},
             "dense": None, "label": np.zeros((1,), np.float32)}
    port, ref = DirtyTracker(model), JaxDirtyTracker(jm)
    port.observe(batch)
    ref.observe(batch)
    got = port.take()["categorical"]
    np.testing.assert_array_equal(got, [1, 2, 3, 7])
    np.testing.assert_array_equal(got, ref.take()["categorical"])


# -- hash tables ---------------------------------------------------------------


def _hashed_port_model():
    model = make_deepfm(vocabulary=-1, dim=4, hidden=(8,), hashed=True,
                        capacity=CAPACITY)
    model.specs["categorical"] = dataclasses.replace(
        model.specs["categorical"], initializer=Constant(0.0))
    return model


def _by_id(keys, weights, slots):
    """A hash table's resident rows in id order (single-lane int64 keys)."""
    keys = np.asarray(keys)
    sel = np.flatnonzero(keys >= 0)
    pick = sel[np.argsort(keys[sel])]
    out = {"ids": keys[pick], "weights": np.asarray(weights)[pick]}
    out.update({k: np.asarray(v)[pick] for k, v in slots.items()})
    return out


def _port_by_id(ts):
    return _by_id(ts.keys.numpy(), ts.weights.numpy(),
                  {k: v.numpy() for k, v in ts.slots.items()})


def _assert_by_id_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_incremental_hash_table(tmp_path):
    model = _hashed_port_model()
    trainer = _trainer(model)
    batches = list(data.synthetic_criteo(16, id_space=1 << 40, steps=6,
                                         seed=2))
    state = trainer.init(batches[0])
    root = str(tmp_path / "persist")
    state, _, p = _run(trainer, model, state, batches, root)
    assert len(list_deltas(root)) == 2
    fresh, restored = _restore(model, root, batches[0])
    assert restored.step == 6
    a, b = restored.tables["categorical"], state.tables["categorical"]
    _assert_by_id_equal(_port_by_id(a), _port_by_id(b))
    assert int(a.overflow) == int(b.overflow) == 0
    live = convert.train_state_to_jax(state)
    got = convert.train_state_to_jax(restored)
    for part in ("dense_params", "dense_slots"):
        for k, v in live[part].items():
            assert got[part][k].tobytes() == v.tobytes(), k
    # the next step agrees by id
    a_state, ma = fresh.train_step(restored, batches[0])
    b_state, mb_ = trainer.train_step(state, batches[0])
    assert float(ma["loss"]) == float(mb_["loss"])
    _assert_by_id_equal(_port_by_id(a_state.tables["categorical"]),
                        _port_by_id(b_state.tables["categorical"]))


@pytest.mark.parametrize("x64", [True, False], ids=["single_lane", "pair"])
def test_jax_hash_chain_restores_in_the_port(x64, tmp_path):
    """A hashed chain written by the JAX package (x64 on: single-lane keys;
    off: split-pair keys, int64 ids in the deltas all the same) restores in
    the port equal to the JAX run's live state, by id."""
    root = str(tmp_path / "jax")
    with jax.enable_x64(x64):
        jm = jax_make_deepfm(vocabulary=-1, dim=4, hidden=(8,), hashed=True,
                             capacity=CAPACITY)
        jm.specs["categorical"] = dataclasses.replace(
            jm.specs["categorical"], initializer=JaxConstant(0.0))
        jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
        from openembedding_tpu.data import synthetic_criteo as jax_synthetic
        batches = list(jax_synthetic(16, id_space=1 << 62, steps=4, seed=2,
                                     ids_dtype=np.int64 if x64 else "pair"))
        js = jt.init(batches[0])
        assert js.tables["categorical"].keys.ndim == (1 if x64 else 2)
        step = jax.jit(jt.train_step)
        with JaxIncrementalPersister(jt, jm, root, window=2,
                                     policy=JaxPersistPolicy(every_steps=1),
                                     full_every=100) as p:
            for b in batches:
                js, _ = step(js, b)
                p.maybe_persist(js, batch=b)
        want = _numpy_state(js)
        t = js.tables["categorical"]
        want_table = {"keys": np.asarray(t.keys),
                      "weights": np.asarray(t.weights),
                      "slots": {k: np.asarray(v) for k, v in t.slots.items()}}
    assert len(list_deltas(root)) == 3
    keys, weights, slots = convert._single_lane(
        want_table["keys"], want_table["weights"], want_table["slots"])
    model = _hashed_port_model()
    trainer = _trainer(model)
    sample = next(data.synthetic_criteo(16, id_space=1 << 40, steps=1))
    restored = restore_server_model(trainer.init(sample), model, root,
                                    trainer=trainer)
    assert restored.step == 4 and restored.model_version == 4
    _assert_by_id_equal(_port_by_id(restored.tables["categorical"]),
                        _by_id(keys, weights, slots))
    got = convert.train_state_to_jax(restored)
    for part in ("dense_params", "dense_slots"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert got[part][k].tobytes() == v.tobytes(), k
