"""Persistence over the port's mesh at S = 2 gloo ranks on the CPU
(`parallel.multihost.run_local`; rank functions in
`tests/torch_persist_ranks.py`).

Each configuration trains the small DeepFM of the mesh tests (vocabulary
1000 or a 2^40 hashed id space, dim 9, a float32 16-16 tower) six steps
with an IncrementalPersister (a full base at step 2, deltas at 4 and 6),
then restores the root into a fresh state on every rank: bit-equal to the
live state, ZeRO chunks, residuals, hot cache and migration directory
included, and so is the step after. The configurations: an array table,
a hash table, the int8 wire with its error-feedback residuals (`__ef__`
in the deltas), 16 hot rows with 8 migration rows, and ZeRO; the last two
at the fp32 wire, whose files equal the plain run's (the placement is
written back and the dense slots unsharded before a persist). The array
and hash roots also restore without a trainer (`mesh=`), and on one
device, equal by id to the assembled live state. A root the JAX
MeshTrainer wrote on four devices (one process: the unsuffixed delta
files holding every shard's rows) restores at S = 2, equal by id to the
JAX run's live state.
"""

import numpy as np

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.persist import \
    IncrementalPersister as JaxIncrementalPersister
from openembedding_tpu.persist import PersistPolicy as JaxPersistPolicy
from openembedding_tpu_torch import (convert, data, optimizers,
                                     restore_server_model)
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.parallel.sharded import deinterleave_rows

import torch_mesh_ranks as mesh_ranks
import torch_persist_ranks as ranks
from test_torch_mesh_train import numpy_state

VOCAB, BATCH, CAPACITY, STEPS = 1000, 64, 1 << 15, 6


def batches(hashed=False, steps=STEPS + 1, seed=7):
    return list(data.synthetic_criteo(
        BATCH, id_space=(1 << 40) if hashed else VOCAB, steps=steps,
        seed=seed))


def by_id(state, shards, hashed):
    """{"ids", "weights", slot...} of the table in id order: an array table
    deinterleaved from `shards` shards, a hash table's resident ids
    sorted."""
    t = state["tables"]["categorical"]
    arrays = {"weights": t["weights"], **t["slots"]}
    if hashed:
        keys = np.asarray(t["keys"])
        sel = np.flatnonzero(keys >= 0)
        pick = sel[np.argsort(keys[sel])]
        return {"ids": keys[pick],
                **{k: np.asarray(v)[pick] for k, v in arrays.items()}}
    return {k: deinterleave_rows(np.asarray(v), shards, VOCAB)
            for k, v in arrays.items()}


def assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), \
            f"{what}: {k}"


def assert_same_dense(got, want, what):
    for part in ("dense_params", "dense_slots"):
        assert_same(got[part], want[part], f"{what} {part}")


def single_device_restore(root, hashed):
    model = mesh_ranks.deepfm(VOCAB, hashed=hashed, capacity=CAPACITY)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                      device="cpu")
    state = trainer.init(batches(hashed, steps=1)[0])
    return convert.train_state_to_jax(
        restore_server_model(state, model, root, trainer=trainer))


def jax_root(root, S=4):
    """The JAX MeshTrainer on S devices of one process, persisted
    incrementally -> its live state as numpy."""
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:S]))
    bs = batches()
    state = trainer.init(bs[0])
    step = trainer.jit_train_step(bs[0], state)
    with JaxIncrementalPersister(trainer, model, root, window=2,
                                 policy=JaxPersistPolicy(every_steps=2),
                                 full_every=100) as p:
        for b in bs[:STEPS]:
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
    return numpy_state(state)


CONFIGS = {
    "array": dict(trainerless=True),
    "hash": dict(hashed=True, capacity=CAPACITY, trainerless=True),
    "int8 ef": dict(wire="int8"),
    "placed": dict(hot_rows=16, mig_rows=8),
    "zero": dict(dense_shard=True),
}


def test_mesh_persist_s2(tmp_path):
    S = 2
    cfgs = []
    for name, extra in CONFIGS.items():
        hashed = extra.get("hashed", False)
        bs = batches(hashed)
        cfg = {"vocab": VOCAB, "batches": bs, "steps": STEPS, "every": 2,
               "full_every": 100, "root": str(tmp_path / name.replace(" ",
                                                                  "_")),
               **extra}
        if name == "placed":
            ids, counts = np.unique(np.concatenate(
                [b["sparse"]["categorical"].reshape(-1) for b in bs]),
                return_counts=True)
            order = np.argsort(-counts, kind="stable")
            cold = ids[order[-8:]]
            cfg["hot_ids"] = {0: ids[order[:16]]}
            cfg["moves"] = {0: (cold, (cold + 1) % S)}
        cfgs.append(cfg)
    jroot = str(tmp_path / "jax4")
    jax_live = jax_root(jroot)
    out = run_local(ranks.cases, S, args=(
        cfgs, [{"vocab": VOCAB, "batches": batches(), "root": jroot}]),
        timeout_s=120, tmp_dir=str(tmp_path))
    runs = {name: [r["runs"][i] for r in out]
            for i, name in enumerate(CONFIGS)}
    for name, per_rank in runs.items():
        for r in per_rank:
            what = f"{name} rank {r['rank']}"
            assert r["step"] == STEPS, what
            assert r["unequal"] == [], what
            assert r["unequal_next"] == [] and r["same_next_loss"], what
            assert [h[0] for h in r["history"]] == ["full", "delta",
                                                    "delta"], what
            assert r.get("unequal_trainerless", []) == [], what
        # the rows a delta holds are split between the ranks by ownership
        rows = [sum(h[2] for h in r["history"][1:]) for r in per_rank]
        assert all(n > 0 for n in rows), (name, rows)

    files = runs["array"][0]["files"]
    delta = "delta_000000000004"
    assert sorted(k for k in files if k.startswith(delta)) == [
        f"{delta}/{n}" for n in ("COMMIT", "dense.npz", "done.0", "done.1",
                                 "meta.json", "table_categorical.p0.npz",
                                 "table_categorical.p1.npz")]
    assert files[f"{delta}/meta.json"]["parent"] == 2
    assert files[f"{delta}/meta.json"]["tables"] == ["categorical"]
    assert "persist_000000000002/variable_0/shard_00001_of_00002/weights.npy" \
        in files
    # the int8 wire's residuals ride the deltas as the slot __ef__
    ef_files = runs["int8 ef"][0]["files"]
    for r in range(S):
        assert "slot___ef__" in ef_files[f"{delta}/table_categorical.p{r}.npz"]
    # placement and ZeRO persist the plain run's bytes
    for name in ("placed", "zero"):
        assert runs[name][0]["files"] == files, name
        assert [r["history"] for r in runs[name]] == [
            r["history"] for r in runs["array"]], name

    # on one device, equal by id to the live state assembled from the ranks
    for name, hashed in (("array", False), ("hash", True)):
        live = convert.mesh_state_to_jax([r["live"] for r in runs[name]])
        got = single_device_restore(cfgs[list(CONFIGS).index(name)]["root"],
                                    hashed)
        assert got["step"] == STEPS
        assert_same(by_id(got, 1, hashed), by_id(live, S, hashed), name)
        assert_same_dense(got, live, name)

    # the JAX four-device root at S = 2
    port = convert.mesh_state_to_jax([r["restores"][0] for r in out])
    assert port["step"] == jax_live["step"] == STEPS
    assert_same(by_id(port, S, False), by_id(jax_live, 4, False), "jax4")
    assert_same_dense(port, jax_live, "jax4")
