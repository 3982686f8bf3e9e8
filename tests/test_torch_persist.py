"""The port's async persistence (`openembedding_tpu_torch.persist`) against
the JAX package's: the policy, the commit protocol and crash consistency,
retention, deferred write errors, the snapshot's isolation from in-place
steps, and roots that cross between the packages bit for bit.

The counterparts of `tests/test_persist.py`'s AsyncPersister tests run on
the same small DeepFM (`make_deepfm(vocabulary=1<<10, dim=4,
hidden=(8,))`) and the same seeded batches. For the cross-package round
trips both packages start from the JAX init (carried across by
`convert.train_state_from_jax`) and train on the same batches; each root
is restored by the other package and must equal the writer's live state
bit for bit (a restore copies bytes; nothing is recomputed).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.persist import (
    AsyncPersister as JaxAsyncPersister,
    IncrementalPersister as JaxIncrementalPersister,
    PersistPolicy as JaxPersistPolicy,
    restore_server_model as jax_restore)
from openembedding_tpu_torch import (AsyncPersister, IncrementalPersister,
                                     PersistPolicy, convert, data,
                                     optimizers, restore_server_model)
from openembedding_tpu_torch import microbench as mb
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.persist import (latest_persist, list_deltas,
                                             list_persists,
                                             persist_server_model)

VOCAB = 1 << 10


def _model():
    return make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))


def _trainer(model):
    return Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                   device="cpu")


@pytest.fixture()
def setup():
    model = _model()
    trainer = _trainer(model)
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=6, seed=1))
    return model, trainer, trainer.init(batches[0]), batches


def _bits(state):
    """Every tensor of the state as its bytes."""
    return {k: v.detach().contiguous().reshape(-1).view(torch.uint8).clone()
            for k, v in mb.state_bits(state).items()}


def _assert_bit_equal(a, b):
    ba, bb = _bits(a), _bits(b)
    assert ba.keys() == bb.keys()
    unequal = [k for k in ba if not torch.equal(ba[k], bb[k])]
    assert not unequal, unequal
    assert (a.step, a.model_version) == (b.step, b.model_version)


def test_policy_steps_and_seconds():
    for Policy in (PersistPolicy, JaxPersistPolicy):
        p = Policy(every_steps=10)
        got = [p.should_persist(5), p.should_persist(10)]
        p.mark(10)
        got += [p.should_persist(15), p.should_persist(20)]
        assert got == [False, True, False, True]
        pt = Policy(every_seconds=0.05)
        assert not pt.should_persist(1)
        time.sleep(0.06)
        assert pt.should_persist(1)
        with pytest.raises(ValueError):
            Policy()


def test_persist_restore_round_trip(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    persisted = []
    with AsyncPersister(trainer, model, root, window=2, keep=10,
                        policy=PersistPolicy(every_steps=2)) as p:
        for b in batches:
            state, _ = trainer.train_step(state, b)
            if p.maybe_persist(state):
                persisted.append(state.step)
        p.wait()
    assert persisted == [2, 4, 6]
    assert [s for s, _ in list_persists(root)] == [2, 4, 6]
    assert [r["kind"] for r in p.history] == ["full"] * 3
    assert all(r["bytes"] > 0 and r["write_ms"] >= 0 for r in p.history)
    fresh = _trainer(model)
    restored = restore_server_model(fresh.init(batches[0]), model, root,
                                    trainer=fresh)
    _assert_bit_equal(restored, state)
    # the restored state trains on as the live one does
    a, _ = fresh.train_step(restored, batches[0])
    b, _ = trainer.train_step(state, batches[0])
    _assert_bit_equal(a, b)


def test_uncommitted_persist_ignored(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _ = trainer.train_step(state, batches[0])
    with AsyncPersister(trainer, model, root, window=1,
                        policy=PersistPolicy(every_steps=1)) as p:
        p.persist(state)
    # a crash mid-write: a newer directory without its COMMIT marker
    committed = latest_persist(root)
    crashed = os.path.join(root, "persist_000000000099")
    shutil.copytree(committed, crashed)
    os.unlink(os.path.join(crashed, "COMMIT"))
    assert latest_persist(root) == committed
    restored = restore_server_model(trainer.init(batches[0]), model, root,
                                    trainer=trainer)
    assert restored.step == 1
    # a stale `.writing` directory of a crashed run goes at construction
    os.makedirs(os.path.join(root, "persist_000000000005.writing"))
    AsyncPersister(trainer, model, root).close()
    assert not any(n.endswith(".writing") for n in os.listdir(root))


def test_gc_keeps_last_k(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    with AsyncPersister(trainer, model, root, window=1, keep=2,
                        policy=PersistPolicy(every_steps=1)) as p:
        for b in batches[:5]:
            state, _ = trainer.train_step(state, b)
            p.persist(state)
            p.wait()  # one at a time, so the gc sees each commit
    assert [s for s, _ in list_persists(root)] == [4, 5]


def test_repersist_same_step_supersedes(setup, tmp_path):
    """A restarted run that reaches a step again overwrites that step's
    persist (committed or left by a crash) instead of failing."""
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _ = trainer.train_step(state, batches[0])
    for _ in range(2):
        path = persist_server_model(trainer, model, state, root, window=1)
    assert [s for s, _ in list_persists(root)] == [1]
    assert path == latest_persist(root)
    restored = restore_server_model(trainer.init(batches[0]), model, root,
                                    trainer=trainer)
    _assert_bit_equal(restored, state)


def test_restore_without_persist_raises(setup, tmp_path):
    model, trainer, state, _ = setup
    with pytest.raises(FileNotFoundError):
        restore_server_model(state, model, str(tmp_path / "empty"),
                             trainer=trainer)


def test_writer_error_propagates(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _ = trainer.train_step(state, batches[0])
    p = AsyncPersister(trainer, model, root, window=1,
                       policy=PersistPolicy(every_steps=1))
    try:
        p.persist(state)
        p._q.join()
        # a file where the writer must rename its directory: the write fails
        state, _ = trainer.train_step(state, batches[1])
        with open(os.path.join(root, "persist_000000000002"), "w") as f:
            f.write("in the way")
        p.persist(state)
        p._q.join()
        with pytest.raises(RuntimeError, match="async persist failed"):
            p.persist(state)  # the next persist raises it, and drops it
        p.wait()  # raised once, not again
    finally:
        p.close()
    assert [s for s, _ in list_persists(root)] == [1]


def test_close_is_idempotent_and_raises_a_late_error(setup, tmp_path):
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _ = trainer.train_step(state, batches[0])
    p = AsyncPersister(trainer, model, root, window=1)
    with open(os.path.join(root, "persist_000000000001"), "w") as f:
        f.write("in the way")
    p.persist(state)
    with pytest.raises(RuntimeError, match="async persist failed"):
        p.close()
    p.close()
    assert not p._thread.is_alive()


def test_snapshot_isolated_from_in_place_steps(setup, tmp_path):
    """`persist()` copies before it returns: the steps after it update the
    state's tensors in place while the write is pending, and the persisted
    bytes are still the persisted step's."""
    model, trainer, state, batches = setup
    root = str(tmp_path / "persist")
    state, _ = trainer.train_step(state, batches[0])
    want = state.clone()
    gate = threading.Event()
    p = AsyncPersister(trainer, model, root, window=2,
                       policy=PersistPolicy(every_steps=1))
    try:
        # hold the writer until the later steps have run
        p._q.put((lambda tmp: gate.wait() and os.makedirs(tmp), 0,
                  str(tmp_path / "held"), {"kind": "hold"}))
        p.persist(state)
        for b in batches[1:]:
            state, _ = trainer.train_step(state, b)
        assert state.step == 6
        gate.set()
        p.wait()
    finally:
        gate.set()
        p.close()
    restored = restore_server_model(trainer.init(batches[0]), model, root,
                                    trainer=trainer)
    _assert_bit_equal(restored, want)


def test_snapshot_writes_the_live_states_bytes(setup, tmp_path):
    """`save_server_model` writes a host snapshot byte for byte as it writes
    the live state."""
    from openembedding_tpu_torch.checkpoint import save_server_model
    from openembedding_tpu_torch.parallel.checkpoint import (
        snapshot_addressable)
    model, trainer, state, batches = setup
    state, _ = trainer.train_step(state, batches[0])
    snap = snapshot_addressable(state)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        mb.state_bits(snap).values(), mb.state_bits(state).values()))
    a, b = str(tmp_path / "live"), str(tmp_path / "snap")
    save_server_model(state, model, a, model_sign="s")
    save_server_model(snap, model, b, model_sign="s")
    for dirpath, _, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), a)
            if rel.endswith(".npz"):
                za, zb = np.load(os.path.join(a, rel)), np.load(
                    os.path.join(b, rel))
                assert za.files == zb.files
                for k in za.files:
                    assert za[k].tobytes() == zb[k].tobytes(), (rel, k)
                continue
            with open(os.path.join(a, rel), "rb") as fa, \
                    open(os.path.join(b, rel), "rb") as fb:
                got, want = fa.read(), fb.read()
            if rel == "model_meta":  # it names its own directory
                got = got.replace(a.encode(), b"")
                want = want.replace(b.encode(), b"")
            assert got == want, rel


# -- roots across the packages -------------------------------------------------


def _numpy_state(js):
    """A JAX TrainState as numpy (`train_state_from_jax`'s arguments)."""
    return dict(
        tables={n: {"weights": np.array(t.weights),
                    "slots": {k: np.array(v) for k, v in t.slots.items()}}
                for n, t in js.tables.items()},
        dense_params={k: np.array(v) for k, v in
                      _flatten_params(js.dense_params).items()},
        dense_slots={k: np.array(v) for k, v in
                     _flatten_params(js.dense_slots).items()},
        step=int(js.step), model_version=int(js.model_version))


def _assert_numpy_equal(got, want):
    assert (got["step"], got["model_version"]) == (want["step"],
                                                   want["model_version"])
    for part in ("dense_params", "dense_slots"):
        assert got[part].keys() == want[part].keys(), part
        for k in want[part]:
            assert got[part][k].tobytes() == want[part][k].tobytes(), k
    for name, t in want["tables"].items():
        g = got["tables"][name]
        assert g["weights"].tobytes() == t["weights"].tobytes(), name
        assert g["slots"].keys() == t["slots"].keys()
        for k in t["slots"]:
            assert g["slots"][k].tobytes() == t["slots"][k].tobytes(), k


def _both_packages():
    jm = jax_make_deepfm(VOCAB, 4, hidden=(8,))
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05), seed=0)
    tm = _model()
    tt = _trainer(tm)
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=5, seed=1))
    return jm, jt, tm, tt, batches


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["full", "incremental"])
def test_port_root_restores_in_jax(incremental, tmp_path):
    jm, jt, tm, tt, batches = _both_packages()
    template = jt.init(batches[0])
    state = convert.train_state_from_jax(tm, **_numpy_state(template),
                                         device="cpu")
    root = str(tmp_path / "port")
    cls = IncrementalPersister if incremental else AsyncPersister
    kw = {"full_every": 100} if incremental else {}
    with cls(tt, tm, root, policy=PersistPolicy(every_steps=2), **kw) as p:
        for b in batches:
            state, _ = tt.train_step(state, b)
            p.maybe_persist(state, batch=b)
        p.persist(state)  # step 5
    if incremental:
        assert [s for s, _ in list_deltas(root)] == [4, 5]
    restored = jax_restore(template, jm, root, trainer=jt)
    _assert_numpy_equal(_numpy_state(restored),
                        convert.train_state_to_jax(state))


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["full", "incremental"])
def test_jax_root_restores_in_the_port(incremental, tmp_path):
    jm, jt, tm, tt, batches = _both_packages()
    js = jt.init(batches[0])
    template = convert.train_state_from_jax(tm, **_numpy_state(js),
                                            device="cpu")
    step = jax.jit(jt.train_step)
    root = str(tmp_path / "jax")
    cls = JaxIncrementalPersister if incremental else JaxAsyncPersister
    kw = {"full_every": 100} if incremental else {}
    with cls(jt, jm, root, policy=JaxPersistPolicy(every_steps=2),
             **kw) as p:
        for b in batches:
            js, _ = step(js, b)
            p.maybe_persist(js, batch=b)
        p.persist(js)
    if incremental:
        assert [s for s, _ in list_deltas(root)] == [4, 5]
    want = _numpy_state(js)
    restored = restore_server_model(template, tm, root, trainer=tt)
    _assert_numpy_equal(convert.train_state_to_jax(restored), want)


def test_wall_clock_policy_refused_over_several_ranks(setup, tmp_path):
    """persist() runs collectives at S > 1, so every rank must persist at
    the same steps: a wall-clock policy is refused there (before the
    persister touches the group), and taken on one rank."""
    import types
    model, trainer, _, _ = setup
    two = types.SimpleNamespace(mesh=types.SimpleNamespace(rank=0, size=2))
    with pytest.raises(ValueError, match="step-driven"):
        AsyncPersister(two, model, str(tmp_path / "p"),
                       policy=PersistPolicy(every_seconds=1.0))
    with pytest.raises(ValueError, match="step-driven"):
        IncrementalPersister(two, model, str(tmp_path / "p"),
                             policy=PersistPolicy(every_seconds=1.0))
    AsyncPersister(trainer, model, str(tmp_path / "q"),
                   policy=PersistPolicy(every_seconds=1.0)).close()
    with pytest.raises(ValueError):
        AsyncPersister(trainer, model, str(tmp_path / "q"), window=0)
    with pytest.raises(ValueError):
        IncrementalPersister(trainer, model, str(tmp_path / "q"),
                             full_every=0)
