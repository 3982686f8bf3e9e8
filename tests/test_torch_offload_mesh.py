"""Host-cached tables over the port's mesh at S = 2 gloo ranks on the CPU
(`parallel.multihost.run_local`; rank functions in
`tests/torch_offload_ranks.py`) against the JAX MeshTrainer on two
devices, from the JAX init.

The small hashed DeepFM (dim 9 folded, a float32 16-16 tower, a
Constant(0.0) table), a cache of 2 x 1024 slots row-sharded over the ranks,
global batches of 16 over the 2^40 id space: five prepared steps (staged a
batch ahead on the pipelined run), then an `offload_train_many` window of
three. The caches evict over the stream. Each rank admits the ids it owns
from the union of both ranks' batches; the residency is the same on every
rank and equals JAX's, the ranks' stores together hold JAX's store's ids,
and the rows by id (`lookup_anywhere`, a collective) equal JAX's within
`test_torch_trainer.py`'s float32 tolerances, losses too (the port's loss
is the ranks' mean of their local means). The in-HBM mesh over the same
batches gives the same losses and rows bit for bit. The mesh's sharded
checkpoint (each rank's store as its shard) loads in the JAX package and
into the port's single-device Trainer; a full persist restores at S = 2.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.initializers import Constant as JaxConstant
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import data, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_offload_ranks as ranks
from test_torch_mesh_train import numpy_state
from test_torch_trainer import TOL

F32 = TOL["float32"]
S, BATCH, CAPACITY, STEPS, WINDOW = 2, 16, 2048, 5, 3


def jax_model(capacity=CAPACITY):
    m = jax_make_deepfm(-1, 9, hidden=(16, 16), hashed=True,
                        capacity=capacity, compute_dtype=jnp.float32)
    m.specs["categorical"] = dataclasses.replace(
        m.specs["categorical"], storage="host_cached",
        initializer=JaxConstant(0.0))
    return m


def stack(bs):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *bs)


@pytest.mark.parametrize("pipelined", [False, True])
def test_mesh_offload_s2(tmp_path, pipelined):
    bs = list(data.synthetic_criteo(BATCH, id_space=1 << 40,
                                    steps=STEPS + WINDOW, seed=7))
    trainer_kw = (dict(offload_pipeline=True, offload_stage_depth=2,
                       offload_densify=4) if pipelined else {})
    jt = JaxMeshTrainer(jax_model(), jax_embed.Adagrad(learning_rate=0.3),
                        mesh=jax_make_mesh(jax.devices()[:S]), **trainer_kw)
    js = jt.init(bs[0])
    start = numpy_state(js)
    step = jt.jit_train_step(bs[0], js)
    jlosses = []
    for b in bs[:STEPS]:
        js = jt.offload_prepare(js, b)
        js, m = step(js, b)
        jlosses.append(float(m["loss"]))
    jot = jt.offload["categorical"]
    residency = jot.resident_ids()
    js, m = jt.offload_train_many(js, stack(bs[STEPS:]))
    jlosses += np.asarray(m["loss"]).tolist()
    ids = np.unique(np.concatenate([b["sparse"]["categorical"].reshape(-1)
                                    for b in bs]))
    jot.adopt(js.tables["categorical"])
    jrows = jot.lookup_anywhere(ids)
    jstore = jot.store.snapshot().ids

    cfg = {"capacity": CAPACITY, "big": 1 << 14, "batches": bs,
           "jax_state": start, "steps": STEPS, "window": WINDOW, "ids": ids,
           "ckpt": str(tmp_path / "ckpt"), "root": str(tmp_path / "root"),
           "trainer": trainer_kw}
    out = run_local(ranks.offload_mesh_run, S, args=(cfg,), timeout_s=300)

    for r, o in enumerate(out):
        assert (o["counters"].get("evictions", 0)
                + o["counters"].get("flushes", 0)) > 0
        np.testing.assert_array_equal(o["residency"], residency)
        np.testing.assert_allclose(o["losses"], jlosses, rtol=0,
                                   atol=F32["loss"])
        np.testing.assert_allclose(o["rows"], jrows, rtol=0,
                                   atol=F32["table"])
        assert o["hbm_losses"] == o["losses"]
        assert o["hbm_rows"].tobytes() == o["rows"].tobytes()
        assert o["restored_rows"].tobytes() == o["rows"].tobytes()
        assert o["loaded_rows"].tobytes() == o["rows"].tobytes()
        assert o["restored_step"] == STEPS + WINDOW
        assert (o["store_ids"] % S == r).all()
        assert o["files"] == [f"shard_{k:05d}_of_{S:05d}" for k in range(S)]
    if pipelined:
        assert out[0]["pipe"][0] > 0
    np.testing.assert_array_equal(
        np.unique(np.concatenate([o["store_ids"] for o in out])),
        np.unique(jstore))

    # the mesh's checkpoint in the JAX package and on one port device
    jt2 = JaxMeshTrainer(jax_model(), jax_embed.Adagrad(learning_rate=0.3),
                         mesh=jax_make_mesh(jax.devices()[:S]))
    js2 = jt2.load(jt2.init(bs[0]), cfg["ckpt"])
    jot2 = jt2.offload["categorical"]
    jot2.adopt(js2.tables["categorical"])
    np.testing.assert_array_equal(jot2.lookup_anywhere(ids), out[0]["rows"])
    tm = ranks.offload_model(CAPACITY)
    t1 = Trainer(tm, optimizers.Adagrad(learning_rate=0.3), device="cpu")
    s1 = t1.load(t1.init(bs[0]), cfg["ckpt"])
    assert (t1.offload["categorical"].lookup_anywhere(ids).tobytes()
            == out[0]["rows"].tobytes())
    assert s1.step == STEPS + WINDOW
