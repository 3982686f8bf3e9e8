"""`SeqMeshTrainer`'s sharded checkpoints across the packages and mesh
sizes, and the export of a context-parallel model serving with local
attention.

BERT4Rec (ring attention, float32, Adagrad(0.1)) at VOCAB 512, DIM 16,
SEQ 32: the JAX SeqMeshTrainer on a (2, 2) mesh trains two steps and saves
its sharded checkpoint (4 shards, `id % 4`); the port on four gloo ranks
as a (2, 2) mesh loads it (and evaluates), and from the JAX init trains
the same two steps and saves its own. The port's checkpoint loads into
the JAX SeqMeshTrainer on a (1, 2) mesh (2 shards) and into the
single-device Trainer of both packages; the port's single-device state
exports a standalone model whose recipe rebuilds with attention="full",
served by both packages. Loads copy: tables, dense params and slots and
the step bit for bit. The trained states and the served logits agree
within 2e-6 (`test_torch_seq_mesh.py`'s bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np

import openembedding_tpu as jembed
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.parallel import SeqMeshTrainer as JaxSeqMeshTrainer
from openembedding_tpu.parallel import deinterleave_rows
from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.parallel.multihost import run_local

from test_torch_mesh_train import numpy_state
from test_torch_seq_mesh import (DIM, HEADS, SEQ, VOCAB, assemble, jax_mesh,
                                 jax_model)
from test_torch_sequential import _batches
import torch_seq_ranks as ranks

ROWS = VOCAB + 1     # BERT4Rec's [MASK] row


def _id_major(state, shards):
    t = state["tables"]["item"]
    return {"weights": deinterleave_rows(np.asarray(t["weights"]), shards,
                                         ROWS),
            **{k: deinterleave_rows(np.asarray(v), shards, ROWS)
               for k, v in t["slots"].items()}}


def _same(got, want, what, exact=True):
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6,
                                       err_msg=f"{what} {k}")


def _same_dense(got, want, what, exact=True):
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key]), what
        _same({k: np.asarray(v) for k, v in got[key].items()},
              {k: np.asarray(v) for k, v in want[key].items()},
              f"{what} {key}", exact)


def test_checkpoints_and_export(tmp_path):
    batches = _batches("bert4rec", 2, batch=8, seed=13)
    jt = JaxSeqMeshTrainer(jax_model("bert4rec", "ring"),
                           jembed.Adagrad(learning_rate=0.1),
                           mesh=jax_mesh(), seed=7, wire="fp32")
    js = jt.init(batches[0])
    start = numpy_state(js)
    step = jt.jit_train_step(batches[0], js)
    for b in batches:
        js, _ = step(js, b)
    want = numpy_state(js)
    jax_ckpt, port_ckpt = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.save(js, jax_ckpt)

    cfg = {"shape": (2, 2), "family": "bert4rec", "vocab": VOCAB,
           "dim": DIM, "heads": HEADS, "attention": "ring",
           "optimizer": "adagrad", "lr": 0.1, "state": start,
           "batches": batches, "load": jax_ckpt, "save": port_ckpt}
    port = run_local(ranks.checkpoint_io, 4, args=(cfg,), timeout_s=120,
                     tmp_dir=str(tmp_path))

    # the JAX checkpoint in the port at (2, 2): a copy
    loaded = convert.mesh_state_to_jax([p["loaded"] for p in port])
    assert loaded["step"] == want["step"] == 2
    _same(_id_major(loaded, 4), _id_major(want, 4), "jax -> port (2, 2)")
    _same_dense(loaded, want, "jax -> port (2, 2)")
    # the port's own steps equal the JAX ones
    trained = convert.mesh_state_to_jax([p["trained"] for p in port])
    _same(_id_major(trained, 4), _id_major(want, 4), "port steps",
          exact=False)
    _same_dense(trained, want, "port steps", exact=False)

    # the port's (2, 2) checkpoint into the JAX SeqMeshTrainer at (1, 2)
    from jax.sharding import Mesh
    small = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))
    jt2 = JaxSeqMeshTrainer(jax_model("bert4rec", "ring"),
                            jembed.Adagrad(learning_rate=0.1), mesh=small,
                            seed=7, wire="fp32")
    back = numpy_state(jt2.load(jt2.init(batches[0]), port_ckpt))
    assert back["step"] == 2
    _same(_id_major(back, 2), _id_major(trained, 4), "port -> jax (1, 2)")
    _same_dense(back, trained, "port -> jax (1, 2)")

    # ... into the single-device Trainer of both packages
    one = JaxTrainer(jax_model("bert4rec", "full"),
                     jembed.Adagrad(learning_rate=0.1))
    single = numpy_state(one.load(one.init(batches[0]), port_ckpt))
    _same(_id_major(single, 1), _id_major(trained, 4), "port -> jax single")
    model = ranks.seq_model(dict(cfg, attention="ring"))
    tt = Trainer(model, optimizers.Adagrad(learning_rate=0.1), device="cpu")
    ts = tt.load(tt.init(batches[0]), port_ckpt)
    mine = convert.train_state_to_jax(ts)
    assert ts.step == 2
    _same(_id_major(mine, 1), _id_major(trained, 4), "port -> port single")
    _same_dense(mine, trained, "port -> port single")

    # the export: a ring-attention model serving with local attention
    path = str(tmp_path / "export")
    export_standalone(ts, model, path)
    sm = StandaloneModel.load(path, device="cpu")
    assert sm.model.module.attention == "full"
    query = {"sparse": batches[1]["sparse"]}
    got = sm.predict(query).numpy()
    assert got.shape == (8, SEQ, 2)
    np.testing.assert_allclose(
        got, np.asarray(JaxStandalone.load(path).predict(query)), rtol=0,
        atol=2e-6)

    # the port's (2, 2) eval of the loaded JAX state is the single-device
    # JAX forward of that state
    s1 = one.init(batches[0])
    s1 = s1.replace(dense_params=jax.device_get(js.dense_params),
                    tables={"item": s1.tables["item"].replace(
                        weights=jnp.asarray(_id_major(want, 4)["weights"]))})
    ref = np.asarray(jax.jit(one.eval_step)(s1, batches[0])["logits"])
    np.testing.assert_allclose(assemble([p["eval"]["logits"] for p in port]),
                               ref, rtol=0, atol=2e-6)
