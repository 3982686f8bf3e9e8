"""bfloat16 tables through export and serving, standalone and sharded.

A DeepFM whose table spec is `datatype="bfloat16"` (float32 tower) trains
two steps on the CPU; its export writes the table's 2-byte words (numpy
`V2`, as the JAX package writes them), and `StandaloneModel` and the
sharded `ShardedModel` (from the trainer's checkpoint, 4 shards) serve
it in bfloat16. The oracle is the same state with its table widened to
float32, exported and served as a float32 table: every lookup equals the
oracle's rows rounded to bfloat16 (they are bfloat16 values, so the
rounding is exact), and every logit equals the oracle's bit for bit (the
tower widens the rows to float32 first). A float32 delta applied to the
bfloat16 servables lands rounded to bfloat16, as the oracle fed the
rounded rows; `export_rows` sends the 2-byte words. Array and hash
tables.

Across the packages: the JAX package's bfloat16 export, single
checkpoint and sharded checkpoint load into the port bit for bit. The
other direction does not work in the JAX package (it cannot read a `V2`
table back: ROADMAP.md §C), so it is not tested.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.sharded import deinterleave_rows
from openembedding_tpu_torch import data, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel.serving import ShardedModel

VOCAB = 1 << 10


def _model(hashed, datatype):
    m = make_deepfm(-1 if hashed else VOCAB, 4, hidden=(16,),
                    compute_dtype=torch.float32, hashed=hashed,
                    capacity=4096 if hashed else 0)
    m.specs["categorical"] = dataclasses.replace(m.specs["categorical"],
                                                 datatype=datatype)
    return m


def _bits(t):
    """A bfloat16 tensor (or V2 array) as its int16 words."""
    if isinstance(t, np.ndarray):
        return t.view(np.int16)
    return t.view(torch.int16).numpy()


def _request(batch):
    return {"sparse": {"categorical": np.asarray(
        batch["sparse"]["categorical"])},
        "dense": np.asarray(batch["dense"])}


@pytest.mark.parametrize("hashed", [False, True], ids=["array", "hash"])
def test_bfloat16_tables_export_and_serve(hashed, tmp_path):
    space = (1 << 40) if hashed else VOCAB
    batches = list(data.synthetic_criteo(32, id_space=space, steps=3,
                                         seed=5))
    model = _model(hashed, "bfloat16")
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                      device="cpu")
    state = trainer.init(batches[0])
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    table = state.tables["categorical"]
    assert table.weights.dtype == torch.bfloat16

    # the oracle: the same state, its table widened to float32
    f32_model = _model(hashed, "float32")
    oracle = state.clone()
    oracle.tables["categorical"] = dataclasses.replace(
        oracle.tables["categorical"],
        weights=oracle.tables["categorical"].weights.float())
    export_standalone(state, model, str(tmp_path / "bf16"))
    export_standalone(oracle, f32_model, str(tmp_path / "f32"))
    words = np.load(str(tmp_path / "bf16" / "variable_0" / "weights.npy"))
    assert words.dtype == np.dtype("V2")
    sb = StandaloneModel.load(str(tmp_path / "bf16"), model=model,
                              device="cpu")
    so = StandaloneModel.load(str(tmp_path / "f32"), model=f32_model,
                              device="cpu")
    assert sb._tables["categorical"]["weights"].dtype == torch.bfloat16

    trainer.save(state, str(tmp_path / "ck"))
    sh = ShardedModel.load(str(tmp_path / "ck"), devices=["cpu"] * 4,
                           model=model)
    assert all(ts.weights.dtype == torch.bfloat16
               for ts in sh.tables["categorical"])

    ids = np.unique(np.asarray(batches[0]["sparse"]["categorical"]))
    probe = np.concatenate([ids, [-1, 12345 if hashed else VOCAB + 3]])
    want = so.lookup("categorical", probe).bfloat16()
    if hashed:
        keys = table.keys.numpy()
        pos = {int(k): i for i, k in enumerate(keys) if k >= 0}
        trained = table.weights[[pos[int(i)] for i in ids]]
    else:
        trained = table.weights[torch.from_numpy(ids)]
    np.testing.assert_array_equal(_bits(want[:ids.size]), _bits(trained))
    req = _request(batches[0])
    for servable in (sb, sh):
        got = servable.lookup("categorical", probe)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(servable.predict(req).numpy(),
                                      so.predict(req).numpy())

    # a float32 delta: rows land rounded to bfloat16
    rng = np.random.default_rng(0)
    new = np.asarray(batches[2]["sparse"]["categorical"]).reshape(-1)
    d_ids = np.unique(np.concatenate([ids[:20], new[new >= 0][:20]]))
    d_rows = rng.normal(size=(d_ids.size, 5)).astype(np.float32)
    rounded = torch.from_numpy(d_rows).bfloat16()
    dense = sb.export_dense()
    sb2 = sb.apply_update({"categorical": (d_ids, d_rows)}, dense, step=3)
    sh2 = sh.apply_update({"categorical": (d_ids, d_rows)}, dense, step=3)
    so2 = so.apply_update({"categorical": (d_ids, rounded.float().numpy())},
                          dense, step=3)
    want2 = so2.lookup("categorical", probe).bfloat16()
    req2 = _request(batches[2])
    for old, servable in ((sb, sb2), (sh, sh2)):
        np.testing.assert_array_equal(
            _bits(servable.lookup("categorical", d_ids)), _bits(rounded))
        np.testing.assert_array_equal(
            _bits(servable.lookup("categorical", probe)), _bits(want2))
        np.testing.assert_array_equal(servable.predict(req2).numpy(),
                                      so2.predict(req2).numpy())
        # RCU: the servable the delta came from is as it was
        np.testing.assert_array_equal(
            _bits(old.lookup("categorical", probe)), _bits(want))
        # export_rows: the 2-byte words, in export order
        man = servable.export_manifest()["variables"][0]
        rows = servable.export_rows("categorical", 0, man["rows"])
        assert rows["weights"].dtype == np.dtype("V2")
        order = rows["ids"] if hashed else np.arange(VOCAB)
        np.testing.assert_array_equal(
            _bits(rows["weights"]),
            _bits(so2.lookup("categorical", order).bfloat16()))


def test_jax_bfloat16_tables_load_into_the_port(tmp_path):
    """The JAX package's bfloat16 export and checkpoints (single and
    sharded) serve in the port with the JAX trainer's rows, bit for bit."""
    jm = jax_make_deepfm(VOCAB, 4, hidden=(16,), compute_dtype=jnp.float32)
    jm.specs["categorical"] = dataclasses.replace(jm.specs["categorical"],
                                                  datatype="bfloat16")
    batch = next(data.synthetic_criteo(32, id_space=VOCAB, steps=1, seed=5))
    jt = JaxTrainer(jm, jax_embed.Adagrad(learning_rate=0.05))
    js = jt.init(batch)
    js, _ = jt.jit_train_step()(js, batch)
    rows = np.asarray(js.tables["categorical"].weights)
    assert rows.dtype == jnp.bfloat16
    jax_export(js, jm, str(tmp_path / "export"))
    jt.save(js, str(tmp_path / "ck"))

    mt = JaxMeshTrainer(jm, jax_embed.Adagrad(learning_rate=0.05),
                        mesh=jax_make_mesh(jax.devices()[:4]))
    ms = mt.init(batch)
    ms, _ = mt.jit_train_step(batch, ms)(ms, batch)
    mesh_rows = deinterleave_rows(np.asarray(ms.tables["categorical"].weights),
                                  4, VOCAB)
    mt.save(ms, str(tmp_path / "mesh_ck"))

    model = _model(False, "bfloat16")
    ids = np.arange(VOCAB)
    sa = StandaloneModel.load(str(tmp_path / "export"), model=model,
                              device="cpu")
    got = sa.lookup("categorical", ids)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), rows.view(np.int16))
    sh = ShardedModel.load(str(tmp_path / "ck"), devices=["cpu"] * 4,
                           model=model)
    np.testing.assert_array_equal(_bits(sh.lookup("categorical", ids)),
                                  rows.view(np.int16))
    req = _request(batch)
    np.testing.assert_array_equal(sh.predict(req).numpy(),
                                  sa.predict(req).numpy())
    sm = ShardedModel.load(str(tmp_path / "mesh_ck"), devices=["cpu"] * 2,
                           model=model)
    np.testing.assert_array_equal(_bits(sm.lookup("categorical", ids)),
                                  mesh_rows.view(np.int16))
