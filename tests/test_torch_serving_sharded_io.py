"""The port's sharded serving against the JAX package's: the REST
`shard_num` path, the restore from a sharded peer, a split-pair hash
checkpoint, and combiner (pooled) features.

Ported from `tests/test_serving_sharded.py` (its array-table cases are in
`test_torch_serving_sharded.py`, its hashed and host-cached ones in
`test_torch_serving_sharded_hash.py`). Each checkpoint, written by either
package's trainer, is served by both packages on the CPU (the port's
shards on `devices=["cpu"] * T`, JAX's on its 8 host devices). Rows are
bit-exact between the packages and against the writer's rows by id;
logits are held to `tests/test_torch_serving.py`'s bounds (bfloat16 towers
atol 2e-2, rtol 1e-2; float32 towers 1e-5).
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.data import synthetic_criteo as jax_synthetic_criteo
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.models import make_two_tower as jax_make_two_tower
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.serving import ShardedModel as JaxSharded
from openembedding_tpu.serving import restore_from_peer as jax_restore
from openembedding_tpu_torch.export import StandaloneModel
from openembedding_tpu_torch.models import make_two_tower
from openembedding_tpu_torch.parallel.serving import ShardedModel
from openembedding_tpu_torch.serving import make_server, restore_from_peer
from openembedding_tpu_torch.tables.hash_table import np_join_ids

from test_torch_serving import TOL
from test_torch_serving_sharded import checkpoints  # noqa: F401 (fixture)
from torch_sync_util import req

VOCAB = 1 << 10
S = 8
HASH_SPACE = 1 << 40


@pytest.fixture()
def server(tmp_path):
    httpd = make_server(str(tmp_path / "registry"), port=0, device="cpu",
                        devices=["cpu"] * S)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd
    httpd.shutdown()
    httpd.server_close()


def test_rest_sharded_serving(checkpoints, server, tmp_path):  # noqa: F811
    """POST /models with shard_num=8 serves the checkpoint from 8 shards;
    pull and predict answer as the JAX servable does; a shard_num beyond
    the node's devices is refused and recorded."""
    ckpts, batch = checkpoints
    path, rows = ckpts["jax_sharded"]
    base, httpd = server
    status, entry = req(f"{base}/models", "POST",
                        {"model_sign": "big-0", "model_uri": path,
                         "replica_num": 1, "shard_num": 8})[:2]
    assert status == 200 and entry["status"] == "NORMAL"
    sm = httpd.manager._cache["big-0"]
    assert isinstance(sm, ShardedModel) and sm.num_shards == 8
    assert [ts.weights.shape[0] for ts in sm.tables["categorical"]] == \
        [VOCAB // 8] * 8
    ref = JaxSharded.load(path)

    ids = [0, 1, 7, 513]
    status, out = req(f"{base}/models/big-0/pull", "POST",
                      {"variable": "categorical", "ids": ids})[:2]
    assert status == 200
    np.testing.assert_array_equal(np.asarray(out["weights"], np.float32),
                                  rows[ids])
    body = {"sparse": {"categorical":
                       np.asarray(batch["sparse"]["categorical"]).tolist()},
            "dense": np.asarray(batch["dense"]).tolist()}
    status, out = req(f"{base}/models/big-0/predict", "POST", body)[:2]
    assert status == 200
    np.testing.assert_allclose(
        np.asarray(out["logits"]).reshape(-1),
        np.asarray(ref.predict({"sparse": {"categorical": np.asarray(
            batch["sparse"]["categorical"])},
            "dense": np.asarray(batch["dense"])})).reshape(-1),
        **TOL["bfloat16"])

    # a missing sparse feature is the caller's error: 400, never 404
    status, out = req(f"{base}/models/big-0/predict", "POST",
                      {"sparse": {}})[:2]
    assert status == 400 and "categorical" in out["error"]

    # a shard_num beyond this node's devices is refused and recorded
    status, out = req(f"{base}/models", "POST",
                      {"model_sign": "toobig-0", "model_uri": path,
                       "shard_num": 64})[:2]
    assert status == 500 and "exceeds the 8 devices" in out["error"]
    status, entry = req(f"{base}/models/toobig-0")[:2]
    assert status == 200 and entry["status"] == "ERROR"

    # /statusz names the servable's kind
    import urllib.request
    with urllib.request.urlopen(f"{base}/statusz") as r:
        assert "big-0: step=3 kind=ShardedModel" in r.read().decode()


def test_default_devices_need_a_card(checkpoints, tmp_path,  # noqa: F811
                                     monkeypatch):
    """With no device list a sharded model loads over every CUDA card; a
    node without one refuses it (500, ERROR), never moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = checkpoints[0]["jax_sharded"]
    httpd = make_server(str(tmp_path / "reg"), port=0, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        status, out = req(f"{base}/models", "POST",
                          {"model_sign": "m", "model_uri": path,
                           "shard_num": 2})[:2]
        assert status == 500 and "no CUDA device" in out["error"]
        assert req(f"{base}/models/m")[1]["status"] == "ERROR"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_restore_from_sharded_peer(checkpoints, server, tmp_path):  # noqa: F811,E501
    """`restore_from_peer` against a sharded port node, by both packages:
    the rows page out through the sharded pull, and each restored export
    answers as the peer does."""
    ckpts, batch = checkpoints
    path, rows = ckpts["jax_sharded"]
    base, httpd = server
    status, entry = req(f"{base}/models", "POST",
                        {"model_sign": "shpeer-0", "model_uri": path,
                         "shard_num": 8})[:2]
    assert status == 200 and entry["status"] == "NORMAL"

    # pages smaller than the vocabulary: many pages from the sharded peer
    dest = restore_from_peer(base, "shpeer-0", str(tmp_path / "restored"),
                             page=300)
    restored = StandaloneModel.load(dest, device="cpu")
    ids = np.asarray([0, 1, 7, 513, VOCAB - 1])
    status, want = req(f"{base}/models/shpeer-0/pull", "POST",
                       {"variable": "categorical", "ids": ids.tolist()})[:2]
    assert status == 200
    got = restored.lookup("categorical", ids).numpy()
    np.testing.assert_array_equal(got, np.asarray(want["weights"],
                                                  np.float32))
    np.testing.assert_array_equal(got, rows[ids])

    req_ = {"sparse": {"categorical": np.asarray(
        batch["sparse"]["categorical"])}, "dense": np.asarray(batch["dense"])}
    peer = httpd.manager._cache["shpeer-0"]
    np.testing.assert_array_equal(restored.predict(req_).numpy(),
                                  peer.predict(req_).numpy())

    # the JAX package restores from the port's sharded node too
    jdest = jax_restore(base, "shpeer-0", str(tmp_path / "jax_restored"),
                        page=300)
    jrestored = JaxStandalone.load(jdest)
    np.testing.assert_array_equal(
        np.asarray(jrestored.lookup("categorical", ids)), rows[ids])


def test_export_rows_pair_layout_hash(tmp_path, server):
    """A checkpoint of JAX's split-pair hash keys (64-bit types off) served
    sharded by the port: resident ids enumerate, rows page out, and a
    restored export answers as the peer and JAX's servable do."""
    with jax.enable_x64(False):  # pin the split-pair key layout
        model = jax_make_deepfm(vocabulary=-1, dim=4, hidden=(16,),
                                hashed=True, capacity=2048)
        trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                                 mesh=jax_make_mesh())
        batches = list(jax_synthetic_criteo(32, id_space=HASH_SPACE,
                                            steps=2, seed=9,
                                            ids_dtype="pair"))
        state = trainer.init(batches[0])
        assert state.tables["categorical"].keys.ndim == 2  # pair layout
        step = trainer.jit_train_step(batches[0], state)
        for b in batches:
            state, _ = step(state, b)
        path = str(tmp_path / "ck_pair")
        trainer.save(state, path)

    base, httpd = server
    status, entry = req(f"{base}/models", "POST",
                        {"model_sign": "pair-0", "model_uri": path,
                         "shard_num": 8})[:2]
    assert status == 200 and entry["status"] == "NORMAL"
    peer = httpd.manager._cache["pair-0"]
    ref = JaxSharded.load(path)
    man = peer.export_manifest()["variables"]
    assert man == ref.export_manifest()["variables"]
    assert man[0]["kind"] == "hash" and man[0]["rows"] > 0

    dest = restore_from_peer(base, "pair-0", str(tmp_path / "restored_pair"),
                             page=7)  # many pages over the resident ids
    restored = StandaloneModel.load(dest, device="cpu")
    probe = np_join_ids(np.asarray(
        batches[0]["sparse"]["categorical"]).reshape(-1, 2))[:16]
    want = peer.lookup("categorical", probe).numpy()
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(
        restored.lookup("categorical", probe).numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(ref.lookup("categorical", probe)))


def test_sharded_model_serves_combiner_checkpoint(tmp_path):
    """`predict` pools multivalent (combiner) features from a sharded
    checkpoint as JAX's servable does, and a wider pad of the same request
    changes nothing (the mask comes from the host ids)."""
    jm = jax_make_two_tower(256, 128, dim=4, tower=(8,), combiner="mean",
                            compute_dtype=jnp.float32)
    trainer = JaxMeshTrainer(jm, jax_embed.Adagrad(learning_rate=0.1),
                             mesh=jax_make_mesh(), seed=2)
    batch = {"sparse": {"user": jnp.asarray([[1, 2, -1], [3, -1, -1]] * 4),
                        "item": jnp.asarray([[5, -1], [6, 7]] * 4)},
             "dense": None, "label": None}
    state = trainer.init(batch)
    state, _ = trainer.jit_train_step(batch, state)(state, batch)
    path = str(tmp_path / "comb_ck")
    trainer.save(state, path)

    pm = make_two_tower(256, 128, dim=4, tower=(8,), combiner="mean",
                        compute_dtype=torch.float32)
    sm = ShardedModel.load(path, devices=["cpu"] * S, model=pm)
    ref = JaxSharded.load(path)
    req_ = {"sparse": {k: np.asarray(v) for k, v in batch["sparse"].items()}}
    got = sm.predict(req_).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.predict(req_)),
                               **TOL["float32"])
    # and through the checkpoint's own recipe
    np.testing.assert_array_equal(
        ShardedModel.load(path, devices=["cpu"] * 2).predict(req_).numpy(),
        got)

    wider = {"sparse": {
        "user": np.concatenate([req_["sparse"]["user"],
                                np.full((8, 2), -1, np.int64)], axis=1),
        "item": req_["sparse"]["item"]}}
    np.testing.assert_allclose(sm.predict(wider).numpy(), got, rtol=1e-5,
                               atol=1e-6)
