"""The port's sharded serving against the JAX package's on hash tables:
in-device hashed tables served at T = 2, 4 and 8 shards from either
package's checkpoint (both layouts), and host-cached tables, whose store
outgrows the device cache, so the serving table is sized from the
checkpoint's ids.

Ported from `tests/test_serving_sharded.py`. The port's shards sit on
`devices=["cpu"] * T`, JAX's on the first T of its 8 host devices. The
serving tables have the same size in both packages; rows (lookups and
`export_rows`) are bit-exact between them and against the writer's rows
by id, absent ids pull zeros; logits from the bfloat16 towers are held to
`tests/test_torch_serving.py`'s bound (atol 2e-2, rtol 1e-2).
"""

import numpy as np
import pytest

import jax

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.serving import ShardedModel as JaxSharded
from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel.checkpoint import save_sharded
from openembedding_tpu_torch.parallel.serving import ShardedModel

from test_torch_mesh_train import numpy_state
from test_torch_offload_io import jax_trainer, port_trained
from test_torch_serving import TOL

S = 8
HASH_SPACE = 1 << 40


def _by_id(keys, weights):
    keys = np.asarray(keys)
    sel = np.flatnonzero(keys >= 0)
    order = np.argsort(keys[sel])
    return keys[sel][order], np.asarray(weights)[sel][order]


@pytest.fixture(scope="module")
def hashed_checkpoints(tmp_path_factory):
    """{writer: (path, resident ids sorted, their rows)} of the hashed
    DeepFM, and the first batch."""
    root = tmp_path_factory.mktemp("hashed_ckpts")
    batches = list(data.synthetic_criteo(32, id_space=HASH_SPACE, steps=2,
                                         seed=9))
    out = {}
    jm = jax_make_deepfm(vocabulary=-1, dim=4, hidden=(16,), hashed=True,
                         capacity=2048)
    jt = JaxMeshTrainer(jm, jax_embed.Adagrad(learning_rate=0.05),
                        mesh=jax_make_mesh())
    js = jt.init(batches[0])
    step = jt.jit_train_step(batches[0], js)
    for b in batches:
        js, _ = step(js, b)
    jt.save(js, str(root / "jax_sharded"))
    t = js.tables["categorical"]
    out["jax_sharded"] = (str(root / "jax_sharded"),
                          *_by_id(t.keys, t.weights))
    # the port's sharded writer, rank by rank, from the same state
    pm = make_deepfm(vocabulary=-1, dim=4, hidden=(16,), hashed=True,
                     capacity=2048)
    state = numpy_state(js)
    for r in range(S):
        save_sharded(convert.mesh_state_from_jax(state, pm, S, r,
                                                 device="cpu"),
                     pm, str(root / "port_sharded"), num_shards=S, rank=r)
    out["port_sharded"] = (str(root / "port_sharded"), *out["jax_sharded"][1:])

    pt = Trainer(pm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    ps = pt.init(batches[0])
    for b in batches:
        ps, _ = pt.train_step(ps, b)
    pt.save(ps, str(root / "port_single"))
    t = ps.tables["categorical"]
    out["port_single"] = (str(root / "port_single"),
                          *_by_id(t.keys.numpy(), t.weights.numpy()))
    return out, batches[0]


@pytest.mark.parametrize("writer,T", [
    ("jax_sharded", 2), ("jax_sharded", 4), ("jax_sharded", 8),
    ("port_sharded", 4), ("port_single", 2), ("port_single", 8)])
def test_sharded_model_hashed_variable(hashed_checkpoints, writer, T):
    """Hash tables re-insert into the serving shards; absent ids pull
    zeros; the serving table is sized as JAX sizes it."""
    ckpts, batch = hashed_checkpoints
    path, ids, rows = ckpts[writer]
    sm = ShardedModel.load(path, devices=["cpu"] * T)
    ref = JaxSharded.load(path, mesh=jax_make_mesh(jax.devices()[:T]))
    shards = sm.tables["categorical"]
    assert len({ts.keys.shape[0] for ts in shards}) == 1
    assert sum(ts.keys.shape[0] for ts in shards) == \
        ref.tables["categorical"].keys.shape[0]
    assert all(ts.slots == {} for ts in shards)

    probe = np.concatenate([ids[:32], [12345, -1], ids[-3:]])
    got = sm.lookup("categorical", probe).numpy()
    np.testing.assert_array_equal(got[:32], rows[:32])
    np.testing.assert_array_equal(got[-3:], rows[-3:])
    assert (got[32:34] == 0).all()
    np.testing.assert_array_equal(
        got, np.asarray(ref.lookup("categorical", probe)))
    ids2d = np.asarray(batch["sparse"]["categorical"])
    np.testing.assert_array_equal(
        sm.lookup("categorical", ids2d).numpy(),
        np.asarray(ref.lookup("categorical", ids2d)))

    man = sm.export_manifest()["variables"]
    assert man == ref.export_manifest()["variables"]
    assert man[0]["kind"] == "hash" and man[0]["rows"] == ids.size
    for start, count in ((0, 100), (100, 10 ** 6)):
        a = sm.export_rows("categorical", start, count)
        b = ref.export_rows("categorical", start, count)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["weights"], b["weights"])
    req_ = {"sparse": {"categorical": ids2d},
            "dense": np.asarray(batch["dense"])}
    np.testing.assert_allclose(sm.predict(req_).numpy(),
                               np.asarray(ref.predict(req_)),
                               **TOL["bfloat16"])


def test_sharded_model_serves_host_cached_checkpoint(tmp_path):
    """A host-cached table's store holds far more rows than its device
    cache: the serving table is sized from the checkpoint's ids, and every
    stored row serves, in both packages, from either package's
    checkpoint."""
    tt, ts, bs = port_trained()
    store = tt.offload_store_snapshots(ts)["categorical"]
    assert store.ids.size > tt.offload["categorical"].capacity
    port_path = str(tmp_path / "port_ck")
    tt.save(ts, port_path)

    jt = jax_trainer()
    js = jt.init(bs[0])
    step = jax.jit(jt.train_step)
    for b in bs[:6]:
        js = jt.offload_prepare(js, b)
        js, _ = step(js, b)
    jax_path = str(tmp_path / "jax_ck")
    jt.save(js, jax_path)
    jstore = jt.offload_store_snapshots(js)["categorical"]

    for path, st in ((port_path, store), (jax_path, jstore)):
        sm = ShardedModel.load(path, devices=["cpu"] * 4)
        ref = JaxSharded.load(path, mesh=jax_make_mesh(jax.devices()[:4]))
        assert sum(ts_.keys.shape[0] for ts_ in sm.tables["categorical"]) \
            >= st.ids.size
        got = sm.lookup("categorical", st.ids).numpy()
        np.testing.assert_array_equal(got, np.asarray(st.weights,
                                                      np.float32))
        np.testing.assert_array_equal(
            got, np.asarray(ref.lookup("categorical", st.ids)))


def test_a_shard_whose_ids_do_not_fit_grows(tmp_path, monkeypatch):
    """A serving hash shard is sized as JAX sizes it, about 0.7 full of its
    share of the checkpoint's ids, and an id may find no slot within the
    probe budget there (here 1 of the 2,697 ids of one 128-row batch, at
    T = 8). JAX refuses the load; the port grows that shard by a quarter
    and loads it again, and serves every row, the other shards at JAX's
    size. With no growth allowed it refuses as JAX does."""
    from openembedding_tpu_torch.parallel import serving as psrv
    pm = make_deepfm(vocabulary=-1, dim=4, hidden=(16,), hashed=True,
                     capacity=1 << 14)
    pt = Trainer(pm, optimizers.Adagrad(learning_rate=0.05), device="cpu")
    batch = next(data.synthetic_criteo(128, id_space=HASH_SPACE, steps=1,
                                       seed=5))
    state, _ = pt.train_step(pt.init(batch), batch)
    assert pt.table_overflow(state, "categorical") == 0
    path = str(tmp_path / "ck")
    pt.save(state, path)
    msg = "1 checkpointed ids did not fit the serving hash table"
    with pytest.raises(RuntimeError, match=msg):
        JaxSharded.load(path)

    sm = ShardedModel.load(path, devices=["cpu"] * S)
    sizes = [ts.keys.shape[0] for ts in sm.tables["categorical"]]
    jax_size = -(-2697 * 10 // (7 * S))
    assert sorted(set(sizes)) == [jax_size, jax_size * 5 // 4]
    ids, rows = _by_id(state.tables["categorical"].keys.numpy(),
                       state.tables["categorical"].weights.numpy())
    assert ids.size == 2697
    np.testing.assert_array_equal(sm.lookup("categorical", ids).numpy(),
                                  rows)

    monkeypatch.setattr(psrv, "HASH_GROWTHS", 0)
    with pytest.raises(RuntimeError, match=msg):
        ShardedModel.load(path, devices=["cpu"] * S)
