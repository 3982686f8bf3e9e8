"""The port's standalone serving against the JAX package's, on one export.

The JAX package writes small exports (Trainer.init, table columns overwritten
with non-zero numpy values, `export_standalone`); the port loads them with
`StandaloneModel.load(path, device="cpu")` and must predict and pull what the
JAX `StandaloneModel` does, at the tolerances of `test_torch_models.py`
(float32 1e-5; bfloat16 atol 2e-2, rtol 1e-2), with lookups bit-exact. The
reverse direction (the port writes, JAX reads) and the REST surface are held
to the same answers.

bfloat16 here differs from the eager comparison in `test_torch_models.py`:
the JAX predict is jitted, and XLA fuses the FM term's elementwise ops in
float32, skipping bf16 roundings that the eager flax module and the port
keep. The difference is then about one bf16 ulp of the FM term. Table values
are drawn in [-0.1, 0.1] (trained-embedding magnitude), which keeps |logit|
under about 4 and one ulp there at 2^-6 < atol. The measured max abs diff was
7.8e-3 (split, dim 64) and 2.0e-3 (folded, dim 9). With values in
[-0.5, 0.5], the FM term reaches about 40 and the diff 0.125: one ulp at
that size.
"""

import threading
import urllib.error

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu_torch.export import (StandaloneModel,
                                            export_standalone)
from openembedding_tpu_torch.model import init_weights
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.ops import gather
from openembedding_tpu_torch.serving import (ModelManager, ModelRegistry,
                                             ServingClient, make_server)

VOCAB = 1000
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
# recipe -> (dim, compute dtype, hashed)
RECIPES = {"folded_f32": (4, "float32", False),
           "folded_bf16": (9, "bfloat16", False),
           "split_bf16": (64, "bfloat16", False),
           "split_f32": (64, "float32", False),
           "hashed_f32": (4, "float32", True)}


def _batch(rng, n, id_space=VOCAB):
    """Ids with -1 pads and out-of-range ids (absent ids for hash tables)."""
    ids = rng.integers(0, id_space, size=(n, 26)).astype(np.int64)
    ids[rng.random((n, 26)) < 0.1] = -1
    ids[rng.random((n, 26)) < 0.05] = id_space + 17
    return {"sparse": {"categorical": ids},
            "dense": rng.standard_normal((n, 13)).astype(np.float32)}


def _jax_export(path, dim, compute, hashed):
    model = jax_make_deepfm(VOCAB, dim, hidden=(16, 16), hashed=hashed,
                            capacity=4 * VOCAB if hashed else 0,
                            compute_dtype=getattr(jnp, compute))
    trainer = Trainer(model, jax_embed.Adagrad(learning_rate=0.05), seed=3)
    rng = np.random.default_rng(dim)
    batch = _batch(rng, 64)
    batch["label"] = rng.integers(0, 2, 64).astype(np.float32)
    state = trainer.init(batch)
    if hashed:  # a train step inserts the batch's ids into the hash table
        state, _ = trainer.jit_train_step()(state, batch)
    tables = {}
    for name, ts in state.tables.items():
        w = rng.uniform(-0.1, 0.1, ts.weights.shape).astype(np.float32)
        tables[name] = ts.replace(weights=jnp.asarray(w))
    state = state.replace(tables=tables)
    jax_export(state, model, path, model_sign="m-0")
    return path


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    return {name: _jax_export(str(root / name), *spec)
            for name, spec in RECIPES.items()}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_predict_matches_jax(exports, recipe):
    dim, compute, hashed = RECIPES[recipe]
    jsm = JaxStandalone.load(exports[recipe])
    tsm = StandaloneModel.load(exports[recipe], device="cpu")
    assert tsm.variable_names == jsm.variable_names
    assert (tsm.step, tsm.model_version) == (jsm.step, jsm.model_version)
    rng = np.random.default_rng(11)
    for n in (1, 5, 8, 37):
        batch = _batch(rng, n)
        want = np.asarray(jsm.predict(batch))
        got = tsm.predict(batch)
        assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
        np.testing.assert_allclose(got.numpy(), want, **TOL[compute])


@pytest.mark.parametrize("recipe", ["folded_f32", "split_f32", "hashed_f32"])
def test_lookup_matches_jax_bit_exact(exports, recipe):
    jsm = JaxStandalone.load(exports[recipe])
    tsm = StandaloneModel.load(exports[recipe], device="cpu")
    ids = np.array([[0, 5, -1, VOCAB - 1], [VOCAB, VOCAB + 17, 1 << 40, 3]],
                   np.int64)
    for name in tsm.variable_names:
        got = tsm.lookup(name, ids)
        want = np.asarray(jsm.lookup(name, ids))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    if recipe == "hashed_f32":
        resident = tsm._tables["categorical"]["ids"][:3]
        assert tsm.lookup("categorical", resident).abs().sum() > 0


def test_port_export_loads_in_jax(tmp_path):
    """Reverse direction: the port's export_standalone writes, the JAX
    package loads and predicts the same."""
    rng = np.random.default_rng(21)
    for dim, compute, tdt in ((4, "float32", torch.float32),
                              (64, "float32", torch.float32),
                              (9, "bfloat16", torch.bfloat16)):
        model = make_deepfm(VOCAB, dim, hidden=(16, 16), compute_dtype=tdt)
        state = init_weights(model, _batch(rng, 4), seed=dim, device="cpu")
        for name, w in state.tables.items():  # non-zero first-order columns
            state.tables[name] = torch.from_numpy(
                rng.uniform(-0.1, 0.1, tuple(w.shape)).astype(np.float32))
        path = str(tmp_path / f"port_{dim}")
        meta = export_standalone(state, model, path, model_sign="p-0")
        assert [v.storage_name for v in meta.variables] == list(model.specs)
        jsm = JaxStandalone.load(path)
        tsm = StandaloneModel.load(path, device="cpu")
        batch = _batch(rng, 13)
        np.testing.assert_allclose(tsm.predict(batch).numpy(),
                                   np.asarray(jsm.predict(batch)),
                                   **TOL[compute])
        for name in model.specs:
            np.testing.assert_array_equal(
                np.asarray(jsm.lookup(name, np.arange(VOCAB))),
                state.tables[name].numpy())


def test_predict_launch_accounting_and_errors(exports):
    tsm = StandaloneModel.load(exports["split_f32"], device="cpu")
    before = gather.LAUNCHES["gather_rows"]
    tsm.predict(_batch(np.random.default_rng(0), 3))
    assert gather.LAUNCHES["gather_rows"] == before  # CPU: no kernel launch
    bad = _batch(np.random.default_rng(0), 3)
    bad["dense"] = bad["dense"][:2]
    with pytest.raises(ValueError, match="ragged serving batch"):
        tsm.predict(bad)
    with pytest.raises(KeyError):
        tsm.predict({"sparse": {"other": np.zeros((2, 26), np.int64)}})


def test_entry_points_raise_without_cuda(exports, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StandaloneModel.load(exports["folded_f32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(str(tmp_path / "reg"), port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_weights(make_deepfm(10, 4, hidden=(4,)),
                     _batch(np.random.default_rng(0), 2, id_space=10))


@pytest.fixture()
def server(tmp_path):
    httpd = make_server(str(tmp_path / "registry"), port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _status(fn, *args, **kw):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args, **kw)
    return e.value.code


def test_rest_matches_jax(exports, server):
    url, httpd = server
    client = ServingClient(url)
    path = exports["folded_bf16"]
    entry = client.create_model("m-0", path)
    assert entry["status"] == "NORMAL" and "m-0" in client.show_models()
    jsm = JaxStandalone.load(path)
    rng = np.random.default_rng(5)
    for n in (1, 5, 37):
        batch = _batch(rng, n)
        got = client.predict("m-0", batch["sparse"], batch["dense"])
        np.testing.assert_allclose(got, np.asarray(jsm.predict(batch)),
                                   **TOL["bfloat16"])
    ids = [0, 3, -1, VOCAB + 5, 1 << 40]
    np.testing.assert_array_equal(client.pull("m-0", "categorical", ids),
                                  np.asarray(jsm.lookup("categorical",
                                                        np.asarray(ids))))

    good = _batch(rng, 2)
    ragged = {"categorical": [[1, 2, 3], [4]]}
    assert _status(client.predict, "m-0", ragged, good["dense"]) == 400
    assert _status(client.predict, "m-0", good["sparse"],
                   good["dense"][:1]) == 400
    assert _status(client.predict, "m-0", {"other": [[1] * 26]},
                   good["dense"][:1]) == 400
    assert _status(client._request, "POST", "/models/m-0/pull",
                   {"ids": [1]}) == 400
    assert _status(client.predict, "nope-0", good["sparse"],
                   good["dense"]) == 404
    assert _status(client.pull, "m-0", "no_such_var", [1]) == 404
    assert _status(client._request, "GET", "/models/nope-0") == 404
    assert client._request("GET", "/models/m-0")["status"] == "NORMAL"
    assert client._request("GET", "/healthz") == {"status": "ok"}
    assert client._request("DELETE", "/models/m-0") == {"deleted": "m-0"}
    assert _status(client.predict, "m-0", good["sparse"],
                   good["dense"]) == 404


def test_registry_and_manager(exports, tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    mgr = ModelManager(reg, device="cpu")
    reg.create_model("c-0", exports["folded_f32"])
    with pytest.raises(RuntimeError, match="CREATING"):
        mgr.find_model("c-0")  # not servable until NORMAL
    reg.set_status("c-0", "NORMAL")
    assert mgr.find_model("c-0") is mgr.find_model("c-0")
    with pytest.raises(FileExistsError):
        reg.create_model("c-0", "/x")
    with pytest.raises(ValueError, match="sharded serving is not ported"):
        mgr.load_model("s-0", exports["folded_f32"], shard_num=2)
    assert reg.get("s-0")["status"] == "ERROR"
    with pytest.raises(Exception):
        mgr.load_model("bad", str(tmp_path / "missing"))
    assert reg.get("bad")["status"] == "ERROR"
