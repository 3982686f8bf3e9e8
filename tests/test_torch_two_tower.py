"""The port's two-tower retrieval model against the JAX package's.

`make_two_tower` at small widths (256 users, 128 items, dim 8, tower
(16, 8)), fixed-field and multivalent (`combiner="mean"`), on the JAX
example's planted generator (`examples/two_tower_retrieval.py`). The port
starts from the JAX init (`convert.train_state_from_jax`). Tolerances:
the forward and the loss within 5e-6 in float32 (a matmul's and a
log-softmax's order of adds, on scores up to 20 in size: a few ulps) and 2e-2 in bfloat16 (the towers round to
bfloat16 between layers, as flax's do, but the two libraries' bfloat16
matmuls and norms accumulate differently); a 20-step Adagrad trajectory
within 2e-5 (loss) and 2e-5 (tables, dense) in float32; the mesh at S = 2
against the JAX MeshTrainer within the same; served scores within 1e-5 of
the other package's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jembed
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import from_config as jax_from_config
from openembedding_tpu.models import make_two_tower as jax_make_two_tower
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import (from_config, in_batch_softmax_loss,
                                            make_two_tower)
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.serving import ServingClient, make_server

from test_torch_mesh_train import numpy_state
import torch_seq_ranks as ranks

USERS, ITEMS, DIM, TOWER, BATCH = 256, 128, 8, (16, 8), 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batches(n, seed=0, batch=BATCH):
    from examples.two_tower_retrieval import synthetic_histories
    rng = np.random.default_rng(seed)
    return [synthetic_histories(rng, batch, USERS, ITEMS, 5, 3)
            for _ in range(n)]


def _fixed(batches):
    """The same ids, fixed-field: pads replaced by real ids."""
    out = []
    for b in batches:
        u, i = (np.where(b["sparse"][k] < 0, 1, b["sparse"][k])
                for k in ("user", "item"))
        out.append({"sparse": {"user": u, "item": i}, "dense": None,
                    "label": None})
    return out


def _pair(combiner="mean", dtype="float32"):
    jd, td = DTYPES[dtype]
    jm = jax_make_two_tower(USERS, ITEMS, DIM, tower=TOWER, combiner=combiner,
                            compute_dtype=jd)
    tm = make_two_tower(USERS, ITEMS, DIM, tower=TOWER, combiner=combiner,
                        compute_dtype=td)
    return (jm, JaxTrainer(jm, jembed.Adagrad(learning_rate=0.1)), tm,
            Trainer(tm, optimizers.Adagrad(learning_rate=0.1), device="cpu"))


@pytest.mark.parametrize("dtype,atol,loss_atol", [
    ("float32", 5e-6, 5e-6), ("bfloat16", 0.15, 2e-2)])
@pytest.mark.parametrize("combiner", ["mean", ""])
def test_forward_and_loss_match_jax(combiner, dtype, atol, loss_atol):
    batches = _batches(2)
    if not combiner:
        batches = _fixed(batches)
    jm, jt, tm, tt = _pair(combiner, dtype)
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    want = jax.jit(jt.eval_step)(js, batches[1])
    got = tt.eval_step(ts, batches[1])
    assert tuple(got["logits"].shape) == (BATCH, BATCH)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=atol)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=loss_atol)
    names = set(convert.dense_to_flax(ts.dense))
    assert "log_inv_temperature" in names and \
        "user_tower/Dense_1/kernel" in names


def test_in_batch_softmax_loss_weighted():
    from openembedding_tpu.models import (
        in_batch_softmax_loss as jax_loss)
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(6, 6)).astype(np.float32) * 5
    w = np.asarray([1, 1, 0, 1, 0, 1], np.float32)
    for weight in (None, w):
        got = in_batch_softmax_loss(
            torch.tensor(scores), None,
            None if weight is None else torch.tensor(weight))
        want = jax_loss(jnp.asarray(scores), None,
                        None if weight is None else jnp.asarray(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-6)


def test_twenty_steps_match_the_jax_trainer():
    batches = _batches(20, seed=3)
    jm, jt, tm, tt = _pair("mean")
    js = jt.init(batches[0])
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    step = jt.jit_train_step()
    jl, tl = [], []
    for b in batches:
        js, m = step(js, b)
        ts, n = tt.train_step(ts, b)
        jl.append(float(m["loss"]))
        tl.append(float(n["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    assert jl[-1] < jl[0]
    got = convert.train_state_to_jax(ts)
    want = numpy_state(js)
    for name, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][name]["weights"],
                                   t["weights"], rtol=0, atol=2e-5)
    for k, v in want["dense_params"].items():
        np.testing.assert_allclose(got["dense_params"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)


def test_mesh_two_ranks_match_the_jax_mesh_trainer(tmp_path):
    """Each rank's in-batch softmax over its own rows, as each JAX
    device's: parity with the JAX MeshTrainer, not a fault."""
    batches = _batches(6, seed=5, batch=2 * BATCH)
    jm = jax_make_two_tower(USERS, ITEMS, DIM, tower=TOWER, combiner="mean",
                            compute_dtype=jnp.float32)
    jt = JaxMeshTrainer(jm, jembed.Adagrad(learning_rate=0.1),
                        mesh=jax_make_mesh(jax.devices()[:2]), wire="fp32")
    js = jt.init(batches[0])
    start = numpy_state(js)
    step = jt.jit_train_step(batches[0], js)
    losses = []
    for b in batches:
        js, m = step(js, b)
        losses.append(float(m["loss"]))
    cfg = {"users": USERS, "items": ITEMS, "dim": DIM, "tower": TOWER,
           "combiner": "mean", "state": start, "batches": batches}
    port = run_local(ranks.two_tower_trajectory, 2, args=(cfg,),
                     timeout_s=90, tmp_dir=str(tmp_path))
    for r in range(2):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=0,
                                   atol=2e-5)
    got = convert.mesh_state_to_jax([p["state"] for p in port])
    want = numpy_state(js)
    for name, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][name]["weights"],
                                   t["weights"], rtol=0, atol=2e-5)


@pytest.fixture()
def server(tmp_path):
    httpd = make_server(str(tmp_path / "registry"), port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_export_serves_at_another_width(tmp_path, server):
    """Train at widths 6/3, serve at 3/2 (in process and over REST), both
    packages' exports in both packages; the (n, bucket) score matrix of
    the JAX package's `out[:n]`."""
    batches = _batches(3, seed=7)
    jm, jt, tm, tt = _pair("mean")
    js = jt.init(batches[0])
    js, _ = jax.jit(jt.train_step)(js, batches[0])
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    tt.train_step(ts, batches[1])
    js, _ = jax.jit(jt.train_step)(js, batches[1])
    query = {"sparse": {
        "user": np.asarray([[11, 4, -1], [200, -1, -1], [7, 8, 9]],
                           np.int64),
        "item": np.asarray([[4, 11], [7, -1], [20, -1]], np.int64)}}
    client = ServingClient(server)
    for writer in ("jax", "port"):
        path = str(tmp_path / writer)
        if writer == "jax":
            jax_export(js, jm, path)
        else:
            export_standalone(ts, tm, path)
        got = StandaloneModel.load(path, device="cpu").predict(query).numpy()
        want = np.asarray(JaxStandalone.load(path).predict(query))
        assert got.shape == want.shape == (3, 8)  # n rows, bucket columns
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        client.create_model(f"tt-{writer}", path)
        rest = client.predict(f"tt-{writer}", query["sparse"])
        np.testing.assert_allclose(rest, got, rtol=0, atol=1e-6)
        # ragged JSON lists: the width buckets to a power of two
        ragged = client.predict(f"tt-{writer}", {
            "user": [[11, 4], [200], [7, 8, 9]],
            "item": [[4, 11], [7], [20]]})
        np.testing.assert_allclose(ragged, got, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got[:, :3], tt.eval_step(ts, query)["logits"].numpy()[:, :3],
        rtol=0, atol=5e-6)


def test_from_config_round_trip():
    tm = make_two_tower(USERS, ITEMS, DIM, tower=TOWER, combiner="sum",
                        compute_dtype=torch.float32)
    again = from_config(tm.config)
    assert again.module.tower == TOWER
    assert again.specs["user"].combiner == "sum"
    jm = jax_from_config(tm.config)
    assert tuple(jm.module.tower) == TOWER


def test_example_main_trains_and_serves():
    from openembedding_tpu_torch.examples import two_tower_retrieval as ex
    out = ex.main(["--device", "cpu", "--steps", "12"])
    assert out["losses"][-1] < out["losses"][0]
    assert out["scores"].shape == (2, 8) and np.isfinite(out["scores"]).all()
