"""The port's DeepFM/MLP against the JAX package's flax modules.

A flax `module.init` makes the params; `convert.dense_from_flax` carries them
into the torch module; the same numpy rows and dense features go through
both, and the logits are compared:

- compute_dtype=float32: atol = rtol = 1e-5 (only the summation order of the
  matrix products differs; measured max abs diff 1.1e-6);
- compute_dtype=bfloat16 (the default): atol = 2e-2, rtol = 1e-2. The port
  rounds where flax does (inputs, kernels and bias cast to bf16, the product
  rounded before the bias add), and the measured max abs diff was 4.8e-7 over
  5 seeds at dims 4, 9 and 64. But the float32 sums ahead of each rounding
  run in another order, so a value next to a rounding boundary can round the
  other way. One such flip at the bf16 tower output moves the logit by one
  bf16 ulp, at most 2^-7 |logit| < rtol |logit|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu import initializers as jax_init
from openembedding_tpu.checkpoint import _flatten_params as jax_flatten
from openembedding_tpu.models import ctr as jax_ctr
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu import embedding as jax_embedding
from openembedding_tpu_torch import embedding, initializers, models
from openembedding_tpu_torch.checkpoint import (_flatten_params,
                                                _unflatten_params)
from openembedding_tpu_torch.convert import (dense_from_flax, dense_to_flax,
                                             tables_from_numpy)
from openembedding_tpu_torch.models import ctr

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _flax_params(module, seed, *args):
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    return {k: np.asarray(v) for k, v in jax_flatten(params).items()}


def _embedded(rng, b, fields, dim, split):
    if split:
        return {"categorical": rng.standard_normal((b, fields, dim)),
                "first_order": rng.standard_normal((b, fields, 1))}
    return {"categorical": rng.standard_normal((b, fields, dim + 1))}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,split", [(4, False), (9, False), (64, True)])
def test_deepfm_matches_flax(dim, split, compute):
    jdt, tdt = DTYPES[compute]
    rng = np.random.default_rng(dim)
    emb = {k: (0.1 * v).astype(np.float32)
           for k, v in _embedded(rng, 37, 26, dim, split).items()}
    dense = rng.standard_normal((37, 13)).astype(np.float32)
    jm = jax_ctr.DeepFM(hidden=(16, 16), compute_dtype=jdt)
    jemb = {k: jnp.asarray(v) for k, v in emb.items()}
    flat = _flax_params(jm, dim, jemb, jnp.asarray(dense))
    want = np.asarray(jm.apply({"params": _unflatten_params(flat)}, jemb,
                               jnp.asarray(dense)))

    tm = ctr.DeepFM(hidden=(16, 16), compute_dtype=tdt)
    dense_from_flax(flat, tm)
    with torch.inference_mode():
        got = tm({k: torch.from_numpy(v) for k, v in emb.items()},
                 torch.from_numpy(dense))
    assert got.dtype == torch.float32 and tuple(got.shape) == (37,)
    np.testing.assert_allclose(got.numpy(), want, **TOL[compute])


def test_deepfm_without_dense_features_matches_flax():
    rng = np.random.default_rng(5)
    emb = {"categorical": (0.1 * rng.standard_normal((8, 26, 10))).astype(
        np.float32)}
    jm = jax_ctr.DeepFM(hidden=(16, 16), compute_dtype=jnp.float32)
    jemb = {k: jnp.asarray(v) for k, v in emb.items()}
    flat = _flax_params(jm, 0, jemb, None)
    assert "Dense_0/kernel" not in flat  # no dense linear without features
    want = np.asarray(jm.apply({"params": _unflatten_params(flat)}, jemb,
                               None))
    tm = ctr.DeepFM(hidden=(16, 16), compute_dtype=torch.float32)
    dense_from_flax(flat, tm)
    got = tm({"categorical": torch.from_numpy(emb["categorical"])}, None)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               **TOL["float32"])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("activate_last", [False, True])
def test_mlp_matches_flax(activate_last, compute):
    jdt, tdt = DTYPES[compute]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((19, 30)).astype(np.float32)
    jm = jax_ctr.MLP((16, 8, 3), activate_last=activate_last,
                     compute_dtype=jdt)
    flat = _flax_params(jm, 1, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": _unflatten_params(flat)},
                               jnp.asarray(x)).astype(jnp.float32))
    tm = ctr.MLP((16, 8, 3), activate_last=activate_last, compute_dtype=tdt)
    dense_from_flax({f"MLP_0/{k}": v for k, v in flat.items()},
                    _Wrap(tm))
    got = tm(torch.from_numpy(x)).float().detach().numpy()
    np.testing.assert_allclose(got, want, **TOL[compute])


def test_dense_flax_round_trip_is_exact():
    rng = np.random.default_rng(11)
    emb = {"categorical": jnp.asarray(rng.standard_normal((4, 26, 10)),
                                      jnp.float32)}
    flat = _flax_params(jax_ctr.DeepFM(hidden=(16, 16)), 3, emb,
                        jnp.zeros((4, 13), jnp.float32))
    tm = ctr.DeepFM(hidden=(16, 16))
    dense_from_flax(flat, tm)
    back = dense_to_flax(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    assert tm.mlp.layers[0].weight.shape == (16, 13 + 26 * 9)


def test_dense_from_flax_rejects_unknown_and_partial_layers():
    tm = ctr.DeepFM(hidden=(16,))
    with pytest.raises(KeyError, match="no counterpart"):
        dense_from_flax({"MLP_0/Dense_7/kernel": np.zeros((2, 16))}, tm)
    with pytest.raises(KeyError, match="both kernel and bias"):
        dense_from_flax({"Dense_0/kernel": np.zeros((13, 1))}, tm)
    with pytest.raises(RuntimeError, match="no parameters"):
        tm({"categorical": torch.zeros(2, 26, 10)}, torch.zeros(2, 13))


@pytest.mark.parametrize("dim", [1, 4, 9, 15, 16, 31, 64, 100, 128])
def test_make_deepfm_recipe_matches_jax(dim):
    """Same first-order layout, table specs and model_config recipe, so
    either package rebuilds the other's exports."""
    jmodel = jax_make_deepfm(1000, dim, hidden=(16, 16))
    tmodel = models.make_deepfm(1000, dim, hidden=(16, 16))
    assert tmodel.config == jmodel.config
    assert list(tmodel.specs) == list(jmodel.specs)
    for name, spec in tmodel.specs.items():
        js = jmodel.specs[name]
        assert (spec.output_dim, spec.feature_name, spec.variable_id) == (
            js.output_dim, js.feature_name, js.variable_id)
        assert spec.to_config() == js.to_config()


def test_from_config_ports_deepfm_only():
    cfg = jax_make_deepfm(500, 4, hidden=(8,),
                          compute_dtype=jnp.float32).config
    m = models.from_config(cfg)
    assert isinstance(m.module, ctr.DeepFM)
    assert m.module.compute_dtype == torch.float32
    assert m.module.hidden == (8,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.from_config({"family": "wdl", "vocabulary": 10})
    with pytest.raises(ValueError, match="unknown model family"):
        models.from_config({"family": "nope"})


@pytest.mark.parametrize("cfg", [
    {"category": "constant", "value": 0.5},
    {"category": "uniform", "minval": -0.2, "maxval": 0.3},
    {"category": "normal", "mean": 0.1, "stddev": 0.05},
    {"category": "truncated_normal", "mean": 0.0, "stddev": 0.2},
    {"category": "combined_first_order", "mean": 0.0, "stddev": 1e-2},
])
def test_initializers_match_jax_in_distribution(cfg):
    """Same config round trip as the JAX registry; draws agree in
    distribution (mean, std, range) on 200k samples, not draw for draw."""
    t_init = initializers.make_initializer(cfg)
    j_init = jax_init.make_initializer(cfg)
    assert t_init.to_config() == j_init.to_config()
    gen = torch.Generator()
    gen.manual_seed(0)
    t = t_init(gen, (20000, 10)).numpy()
    j = np.asarray(j_init(jax.random.PRNGKey(0), (20000, 10), jnp.float32))
    assert t.dtype == np.float32
    for a, b in ((t, j), (t[:, 1:], j[:, 1:])):
        assert abs(a.mean() - b.mean()) < 5e-3 * max(1.0, abs(b).max())
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.02, atol=1e-7)
    np.testing.assert_allclose([t.min(), t.max()], [j.min(), j.max()],
                               rtol=0.05, atol=1e-3 * abs(j).max())
    if cfg["category"] == "combined_first_order":
        assert not t[:, 0].any()


def test_keras_initializer_aliases():
    assert initializers.make_initializer(
        {"category": "RandomNormal", "stddev": 0.3}) == initializers.Normal(
        stddev=0.3)
    assert initializers.make_initializer(
        {"category": "Ones", "__ones__": True}) == initializers.Constant(1.0)
    with pytest.raises(ValueError):
        initializers.make_initializer({"category": "nope"})


class _Wrap(torch.nn.Module):
    """Lets a bare MLP be loaded under flax's `MLP_0/...` names."""

    def __init__(self, mlp):
        super().__init__()
        self.mlp = mlp

    def flax_dense(self):
        return self.mlp.flax_dense("MLP_0/")



def test_flat_param_names_round_trip_like_jax():
    """The port's numpy `_flatten_params`/`_unflatten_params` give the JAX
    package's flat names (the keys of `dense_params.npz`)."""
    rng = np.random.default_rng(2)
    emb = {"categorical": jnp.asarray(rng.standard_normal((2, 26, 10)),
                                      jnp.float32)}
    params = jax_ctr.DeepFM(hidden=(8,)).init(
        jax.random.PRNGKey(0), emb, jnp.zeros((2, 13)))["params"]
    flat = {k: np.asarray(v) for k, v in jax_flatten(params).items()}
    tree = _unflatten_params(flat)
    assert set(tree) == set(params) and set(tree["MLP_0"]) == set(
        params["MLP_0"])
    back = _flatten_params(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert set(_flatten_params({"a": {"b": torch.ones(2)}})) == {"a/b"}


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combine_matches_jax(combiner):
    """Multivalent pooling with -1 pads (value masked, count clamped >= 1,
    all-pad rows pool to zeros), from host ids and from an explicit mask."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 20, size=(6, 5)).astype(np.int64)
    ids[0] = -1
    rows = rng.standard_normal((6, 5, 4)).astype(np.float32)
    tspec = embedding.EmbeddingSpec("v", 20, 4, combiner=combiner)
    jspec = jax_embedding.EmbeddingSpec("v", 20, 4, combiner=combiner)
    want = np.asarray(jax_embedding.combine(jspec, jnp.asarray(ids),
                                            jnp.asarray(rows)))
    got = embedding.combine(tspec, torch.from_numpy(ids),
                            torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    served = embedding.serve_rows(tspec, ids,
                                  lambda i: torch.from_numpy(rows))
    np.testing.assert_allclose(served.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[0].any()
    with pytest.raises(ValueError, match="needs ids"):
        embedding.combine(tspec, torch.from_numpy(ids[0]),
                          torch.from_numpy(rows[0]))


def test_tables_from_numpy_keeps_bits():
    """float32 tables as they are; a bfloat16 table saved by the JAX package
    (an ml_dtypes array, or 2-byte void after np.save/np.load) bit for bit."""
    rng = np.random.default_rng(4)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    bf = np.asarray(jnp.asarray(f32, jnp.bfloat16))
    out = tables_from_numpy({"a": f32, "b": bf, "c": bf.view("V2")},
                            device="cpu")
    assert out["a"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"].numpy(), f32)
    for k in ("b", "c"):
        assert out[k].dtype == torch.bfloat16 and out[k].is_contiguous()
        np.testing.assert_array_equal(out[k].view(torch.int16).numpy(),
                                      bf.view(np.int16))
