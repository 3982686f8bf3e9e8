"""The sequential recommenders' standalone exports between the packages
and `from_config` (see `test_torch_sequential.py` for the models).

A model trained with attention="ring" exports a recipe whose
`serving_overrides` rebuild it with local attention; a JAX export is
served by the port and the port's by the JAX package, in process and over
REST. Tolerances: (n, S, 2) logits within 2e-6 between the packages
(float32), REST within 1e-6 of the in-process answer (JSON floats).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.models import make_bert4rec as jax_make_bert4rec
from openembedding_tpu.models import make_sasrec as jax_make_sasrec
from openembedding_tpu_torch import convert
from openembedding_tpu_torch.export import (StandaloneModel, export_standalone,
                                            load_model_config)
from openembedding_tpu_torch.models import (from_config, make_bert4rec,
                                            make_sasrec)
from openembedding_tpu_torch.serving import ServingClient, make_server

from test_torch_mesh_train import numpy_state
from test_torch_sequential import DIM, SEQ, VOCAB, _batches, _pair


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


@pytest.mark.parametrize("family", ["sasrec", "bert4rec"])
def test_exports_cross_serve(family, tmp_path, server):
    """A JAX export served by the port and the port's by JAX, trained with
    attention="ring" (the recipe's `serving_overrides` rebuild it with
    local attention): (n, S, 2) equal within 2e-6, and over REST."""
    jm, jt, tm, tt = _pair(family)
    jring = (jax_make_bert4rec if family == "bert4rec" else
             jax_make_sasrec)(VOCAB, DIM, num_heads=2, attention="ring",
                              compute_dtype=jnp.float32)
    tring = (make_bert4rec if family == "bert4rec" else make_sasrec)(
        VOCAB, DIM, num_heads=2, attention="ring",
        compute_dtype=torch.float32)
    batches = _batches(family, 2, batch=5)
    js = jt.init(batches[0])
    js, _ = jax.jit(jt.train_step)(js, batches[0])
    ts = convert.train_state_from_jax(tm, **numpy_state(js), device="cpu")
    client = ServingClient(server)
    query = {"sparse": batches[1]["sparse"]}
    for writer in ("jax", "port"):
        path = str(tmp_path / writer)
        if writer == "jax":
            jax_export(js, jring, path)
        else:
            export_standalone(ts, tring, path)
        sm = StandaloneModel.load(path, device="cpu")
        assert sm.model.module.attention == "full"
        got = sm.predict(query).numpy()
        want = np.asarray(JaxStandalone.load(path).predict(query))
        assert got.shape == want.shape == (5, SEQ, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        client.create_model(f"{family}-{writer}", path)
        rest = client.predict(f"{family}-{writer}", query["sparse"])
        np.testing.assert_allclose(rest, got, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, tt.eval_step(ts, batches[1])["logits"].numpy(), rtol=0,
        atol=2e-6)
    assert load_model_config(path, attention="ring").module.attention == \
        "ring"


def test_from_config_builds_every_family():
    import openembedding_tpu.models as jzoo
    from openembedding_tpu_torch import models as zoo
    assert set(zoo._FAMILIES) == set(jzoo._FAMILIES)
    model = make_bert4rec(VOCAB, DIM, attention="ring")
    again = from_config(model.config)
    assert again.module.causal is False and again.module.attention == "ring"
    assert again.specs["item"].input_dim == VOCAB + 1
    assert model.config["serving_overrides"] == {"attention": "full"}
