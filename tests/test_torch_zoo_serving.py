"""The CTR zoo's standalone exports between the packages (a JAX
`export_standalone` served by the port's `StandaloneModel` and the port's
export served by the JAX package's) and the flax names of DCN's and DLRM's
layers without dense features (see `tests/test_torch_zoo.py`)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu_torch import convert
from openembedding_tpu_torch.export import StandaloneModel, export_standalone

from test_torch_trainer import _numpy_state
from test_torch_zoo import FAMILIES, _batches, _pair


@pytest.mark.parametrize("family", FAMILIES)
def test_exports_cross_serve(family, tmp_path):
    jm, jt, tm, tt = _pair(family)
    batches = _batches(3, seed=9)
    js = jt.init(batches[0])
    js, _ = jax.jit(jt.train_step)(js, batches[0])
    ts = tt.init(batches[0])
    ts, _ = tt.train_step(ts, batches[0])
    query = {"sparse": batches[1]["sparse"], "dense": batches[1]["dense"]}
    query["sparse"]["categorical"][::5, 3] = -1
    for writer in ("jax", "port"):
        path = str(tmp_path / writer)
        if writer == "jax":
            jax_export(js, jm, path)
        else:
            export_standalone(ts, tm, path)
        got = StandaloneModel.load(path, device="cpu").predict(query)
        want = JaxStandalone.load(path).predict(query)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        assert os.path.exists(os.path.join(path, "model_config.json"))
    # the port's served logits are its trainer's eval logits
    np.testing.assert_allclose(
        got.numpy(), tt.eval_step(ts, dict(query, label=batches[1]["label"]))[
            "logits"].numpy(), rtol=0, atol=1e-6)


def test_flax_names_without_dense_features():
    """DCN and DLRM number their layers as flax does when no dense
    features come in (the layer made only for them is missing)."""
    batch = dict(_batches(1)[0])
    batch.pop("dense")
    for family in ("dcn", "dlrm"):
        jm, jt, tm, tt = _pair(family)
        js = jt.init(batch)
        ts = tt.init(batch)
        want = {k: np.asarray(v).shape
                for k, v in _flatten_params(js.dense_params).items()}
        got = {k: v.shape for k, v in convert.dense_to_flax(ts.dense).items()}
        assert got == want, family
        ts = convert.train_state_from_jax(tm, **_numpy_state(js),
                                          device="cpu")
        np.testing.assert_allclose(
            tt.eval_step(ts, batch)["logits"].numpy(),
            np.asarray(jax.jit(jt.eval_step)(js, batch)["logits"]),
            rtol=0, atol=1e-5)


def test_dlrm_interaction_order_is_jax_triu():
    f = 7
    iu, ju = torch.triu_indices(f, f, offset=1)
    jiu, jju = jnp.triu_indices(f, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))
