"""Sharded checkpoints across the packages and mesh sizes.

The JAX MeshTrainer trains a small DeepFM (an array table and a hash
table, in turn) two steps on S = 4 devices and saves its sharded
checkpoint (`parallel/checkpoint.py` layout); the port loads it on 2 gloo
ranks and saves its own sharded checkpoint at S = 2, which loads into the
JAX MeshTrainer at S = 4 and into the single-device Trainer of both
packages. Every load holds the JAX state's id -> row contents (weights and
accumulator), the dense params and slots and the step counter, bit for
bit: a load copies; a hash table re-inserts its ids, so only its id -> row
contents (not its slots) are the saved table's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.parallel.checkpoint import checkpoint_layout
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks
from test_torch_mesh_train import numpy_state

VOCAB, BATCH, CAPACITY = 1000, 64, 4096


def _by_id(state, shards, vocab):
    """{"weights", "accum"} in id order: array tables deinterleaved
    (shard-major, `shards` shards), hash tables' resident ids sorted."""
    t = state["tables"]["categorical"]
    w, a = np.asarray(t["weights"]), np.asarray(t["slots"]["accum"])
    if "keys" in t:
        keys = np.asarray(t["keys"])
        sel = np.flatnonzero(keys >= 0)
        order = np.argsort(keys[sel])
        pick = sel[order]
        return {"ids": keys[pick], "weights": w[pick], "accum": a[pick]}
    from openembedding_tpu_torch.parallel.sharded import deinterleave_rows
    return {"weights": deinterleave_rows(w, shards, vocab),
            "accum": deinterleave_rows(a, shards, vocab)}


def _same_contents(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _same_dense(got, want, what):
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key]), what
        for k, v in want[key].items():
            np.testing.assert_array_equal(np.asarray(got[key][k]),
                                          np.asarray(v), err_msg=f"{what} {k}")


@pytest.mark.parametrize("hashed", [False, True], ids=["array", "hash"])
def test_sharded_checkpoints_cross_load(hashed, tmp_path):
    kw = {"hashed": True, "capacity": CAPACITY} if hashed else {}
    batches = list(data.synthetic_criteo(
        BATCH, id_space=(1 << 40) if hashed else VOCAB, steps=2, seed=3))

    def jax_model():
        return jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                               compute_dtype=jnp.float32, **kw)

    jt = JaxMeshTrainer(jax_model(), jax_embed.Adagrad(learning_rate=0.05),
                        mesh=jax_make_mesh(jax.devices()[:4]))
    js = jt.init(batches[0])
    step = jt.jit_train_step(batches[0], js)
    for b in batches:
        js, _ = step(js, b)
    want = numpy_state(js)
    jax_ckpt, port_ckpt = str(tmp_path / "jax4"), str(tmp_path / "port2")
    jt.save(js, jax_ckpt)
    assert checkpoint_layout(jax_ckpt) == "sharded"

    # the JAX S = 4 checkpoint into the port at S = 2, saved again at S = 2
    cfg = {"vocab": VOCAB, "hashed": hashed, "capacity": CAPACITY,
           "batch": batches[0], "load": jax_ckpt, "save": port_ckpt}
    port = run_local(ranks.load_and_save, 2, args=(cfg,), timeout_s=60,
                     tmp_dir=str(tmp_path))
    got = convert.mesh_state_to_jax(port)
    assert got["step"] == want["step"] == 2
    _same_contents(_by_id(got, 2, VOCAB), _by_id(want, 4, VOCAB),
                   "jax S=4 -> port S=2")
    _same_dense(got, want, "jax S=4 -> port S=2")
    assert sorted(os.listdir(os.path.join(port_ckpt, "variable_0"))) == [
        "shard_00000_of_00002", "shard_00001_of_00002"]

    # the port's S = 2 checkpoint into the JAX MeshTrainer at S = 4
    back = jt.load(jt.init(batches[0]), port_ckpt)
    _same_contents(_by_id(numpy_state(back), 4, VOCAB),
                   _by_id(want, 4, VOCAB), "port S=2 -> jax S=4")
    _same_dense(numpy_state(back), want, "port S=2 -> jax S=4")

    # ... and into the single-device Trainer of both packages
    one = JaxTrainer(jax_model(), jax_embed.Adagrad(learning_rate=0.05))
    single = numpy_state(one.load(one.init(batches[0]), port_ckpt))
    _same_contents(_by_id(single, 1, VOCAB), _by_id(want, 4, VOCAB),
                   "port S=2 -> jax single device")
    model = ranks.deepfm(VOCAB, hashed=hashed, capacity=CAPACITY)
    tt = Trainer(model, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    ts = tt.load(tt.init(batches[0]), port_ckpt)
    assert ts.step == 2
    mine = convert.train_state_to_jax(ts)
    _same_contents(_by_id(mine, 1, VOCAB), _by_id(want, 4, VOCAB),
                   "port S=2 -> port single device")
    _same_dense(mine, want, "port S=2 -> port single device")
    if hashed:
        t = ts.tables["categorical"]
        assert int(t.overflow) == 0
        assert int((t.keys >= 0).sum()) == len(_by_id(want, 4, VOCAB)["ids"])
