"""The port's sharded serving (`parallel/serving.ShardedModel`) against the
JAX package's, on array tables.

Checkpoints come from both packages' trainers on the CPU: the JAX
MeshTrainer over 8 devices (the sharded layout) and the JAX `Trainer`
(single), the port's `Trainer` (single) and the port's sharded writer
(`parallel/checkpoint.save_sharded`, each of 8 ranks' states from the JAX
mesh state). Each checkpoint is served by both packages at T = 2, 4 and 8
shards (the port's shards on `devices=["cpu"] * T`, JAX's on the first T of
its 8 host devices). Lookups and `export_rows` are bit-exact between the
packages and against the writer's rows; every shard holds exactly
`rows_per_shard(T)` rows. Logits: the towers compute in bfloat16 (the
models' default), so the two packages are held to the serving bound of
`tests/test_torch_serving.py` (atol 2e-2, rtol 1e-2); within the port, a
predict is held to itself at 1e-5.

Ported from `tests/test_serving_sharded.py`; its hashed, host-cached,
pair-layout, REST, restore and combiner cases are in
`test_torch_serving_sharded_io.py`.
"""

import numpy as np
import pytest
import torch

import jax

import openembedding_tpu as jax_embed
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.serving import ShardedModel as JaxSharded
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.export import RaggedBatchError
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel.checkpoint import (checkpoint_layout,
                                                         save_sharded)
from openembedding_tpu_torch.parallel.serving import ShardedModel
from openembedding_tpu_torch.parallel.sharded import deinterleave_rows

from test_torch_mesh_train import numpy_state
from test_torch_serving import TOL

VOCAB = 1 << 10
S = 8  # the JAX mesh trainer's devices
PROBE = np.asarray([0, 1, 7, 513, VOCAB - 1, -1, -3, VOCAB + 5], np.int64)


def _jax_model():
    return jax_make_deepfm(vocabulary=VOCAB, dim=4, hidden=(16,))


def _port_model():
    return make_deepfm(vocabulary=VOCAB, dim=4, hidden=(16,))


def _batches(steps, seed=5):
    return list(data.synthetic_criteo(32, id_space=VOCAB, steps=steps,
                                      seed=seed))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{writer: (path, the written table in id order)} and a batch."""
    root = tmp_path_factory.mktemp("sharded_ckpts")
    batches = _batches(3)
    out = {}

    jt = JaxMeshTrainer(_jax_model(), jax_embed.Adagrad(learning_rate=0.05),
                        mesh=jax_make_mesh(), seed=3)
    js = jt.init(batches[0])
    step = jt.jit_train_step(batches[0], js)
    for b in batches:
        js, _ = step(js, b)
    jt.save(js, str(root / "jax_sharded"))
    mesh_rows = deinterleave_rows(
        np.asarray(js.tables["categorical"].weights), S, VOCAB)
    out["jax_sharded"] = (str(root / "jax_sharded"), mesh_rows)

    # the port's sharded writer, rank by rank, from the same mesh state
    model = _port_model()
    state = numpy_state(js)
    for r in range(S):
        rank_state = convert.mesh_state_from_jax(state, model, S, r,
                                                 device="cpu")
        save_sharded(rank_state, model, str(root / "port_sharded"),
                     num_shards=S, rank=r)
    out["port_sharded"] = (str(root / "port_sharded"), mesh_rows)

    one = JaxTrainer(_jax_model(), jax_embed.Adagrad(learning_rate=0.05),
                     seed=4)
    s1 = one.init(batches[0])
    s1, _ = one.jit_train_step()(s1, batches[0])
    one.save(s1, str(root / "jax_single"))
    out["jax_single"] = (str(root / "jax_single"),
                         np.asarray(s1.tables["categorical"].weights))

    pt = Trainer(_port_model(), optimizers.Adagrad(learning_rate=0.05),
                 seed=5, device="cpu")
    ps = pt.init(batches[0])
    for b in batches[:2]:
        ps, _ = pt.train_step(ps, b)
    pt.save(ps, str(root / "port_single"))
    out["port_single"] = (str(root / "port_single"),
                          ps.tables["categorical"].weights.numpy().copy())
    return out, batches[0]


def _load_both(path, T):
    port = ShardedModel.load(path, devices=["cpu"] * T)
    ref = JaxSharded.load(path, mesh=jax_make_mesh(jax.devices()[:T]))
    return port, ref


def _request(batch, n=None):
    req = {"sparse": {"categorical": np.asarray(
        batch["sparse"]["categorical"])},
        "dense": np.asarray(batch["dense"])}
    if n is not None:
        req = {"sparse": {"categorical": req["sparse"]["categorical"][:n]},
               "dense": req["dense"][:n]}
    return req


@pytest.mark.parametrize("T", [2, 4, 8])
@pytest.mark.parametrize("writer", ["jax_sharded", "port_sharded",
                                    "jax_single", "port_single"])
def test_sharded_model_matches_jax(checkpoints, writer, T):
    ckpts, batch = checkpoints
    path, rows = ckpts[writer]
    assert checkpoint_layout(path) == writer.split("_")[1]
    sm, ref = _load_both(path, T)

    # never materialized: every shard holds exactly its own rows, no slots
    shards = sm.tables["categorical"]
    assert len(shards) == T
    for ts in shards:
        assert ts.weights.shape == (-(-VOCAB // T), 5)
        assert ts.slots == {}
    assert sm.step == ref.step and sm.model_version == ref.model_version

    # pulls: the writer's rows by id, zeros for pads and out-of-range ids,
    # bit for bit the JAX servable's
    got = sm.lookup("categorical", PROBE).numpy()
    np.testing.assert_array_equal(got[:5], rows[PROBE[:5]])
    assert (got[5:] == 0).all()
    np.testing.assert_array_equal(
        got, np.asarray(ref.lookup("categorical", PROBE)))
    ids2d = np.asarray(batch["sparse"]["categorical"])
    np.testing.assert_array_equal(
        sm.lookup("categorical", ids2d).numpy(),
        np.asarray(ref.lookup("categorical", ids2d)))

    # the live-replica surface
    assert sm.export_manifest()["variables"] == \
        ref.export_manifest()["variables"]
    for start, count in ((0, 300), (300, 1000), (1020, 64)):
        a, b = sm.export_rows("categorical", start, count), \
            ref.export_rows("categorical", start, count)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["weights"], b["weights"])
    da, db = sm.export_dense(), ref.export_dense()
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k])

    # predict: the same rows through a bf16 tower in each package
    req = _request(batch)
    logits = sm.predict(req).numpy()
    assert logits.shape == (32,)
    np.testing.assert_allclose(logits, np.asarray(ref.predict(req)),
                               **TOL["bfloat16"])


def test_request_padding_stays_in_buckets(checkpoints, monkeypatch):
    """Request sizes pad to power-of-two buckets, answers are right at
    every size, and a ragged batch is refused, never silently padded."""
    ckpts, batch = checkpoints
    path, rows = ckpts["jax_sharded"]
    sm = ShardedModel.load(path, devices=["cpu"] * S)
    sizes = []
    raw = ShardedModel._lookup_raw

    def recording(self, name, flat):
        sizes.append(flat.shape[0])
        return raw(self, name, flat)

    monkeypatch.setattr(ShardedModel, "_lookup_raw", recording)
    for n in (1, 2, 3, 5, 7, 8, 11, 13):
        ids = np.arange(n, dtype=np.int64)
        np.testing.assert_array_equal(
            sm.lookup("categorical", ids).numpy(), rows[:n])
    # sizes <= 8 share the 8-bucket, 11 and 13 the 16-bucket: the
    # counterpart of JAX's "at most two compiled programs"
    assert sorted(set(sizes)) == [8, 16]

    bad = {"sparse": {"categorical": batch["sparse"]["categorical"][:6]},
           "dense": np.asarray(batch["dense"])[:3]}
    with pytest.raises(RaggedBatchError, match="ragged"):
        sm.predict(bad)

    logits = {}
    for n in (1, 3, 4, 6):
        logits[n] = sm.predict(_request(batch, n)).numpy()
        assert logits[n].shape == (n,)
    np.testing.assert_allclose(logits[3], logits[6][:3], rtol=1e-5,
                               atol=1e-6)
    ref = JaxSharded.load(path)
    np.testing.assert_allclose(
        logits[6], np.asarray(ref.predict(_request(batch, 6))),
        **TOL["bfloat16"])
