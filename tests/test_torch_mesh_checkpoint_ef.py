"""A sharded checkpoint with int8-wire residuals (`__ef__`) written by
either package loads in the other, the residuals, tables and slots
bit-exact (the run: two steps of `test_torch_mesh_train_int8.py`'s int8
configuration)."""

import jax
import jax.numpy as jnp
import numpy as np

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.parallel.multihost import run_local
from test_torch_mesh_train_int8 import (CONFIGS, VOCAB, _jax_run,
                                        numpy_state)

import torch_mesh_ranks as ranks


def test_ef_checkpoints_load_across_the_packages(tmp_path):
    """The JAX MeshTrainer's int8 run saved (residuals as `__ef__`), loaded
    by two port ranks and saved again; the JAX MeshTrainer loads the port's
    save. Residuals, tables and slots bit-exact both ways."""
    config = CONFIGS[0]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    cfg, _, _, want = _jax_run(2, "array", config, tmp=jax_dir, steps=2)
    out = run_local(ranks.ef_load_and_save, 2,
                    args=({**cfg, "load": jax_dir, "save": port_dir},),
                    timeout_s=60, tmp_dir=str(tmp_path))
    got = mesh_state_to_jax(out)
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    for k in ("weights", "ef"):
        np.testing.assert_array_equal(g[k], t[k], err_msg=k)
    np.testing.assert_array_equal(g["slots"]["accum"], t["slots"]["accum"])
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    trainer = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.05),
                             mesh=jax_make_mesh(jax.devices()[:2]),
                             wire="int8")
    state = trainer.init(cfg["batches"][0])
    assert state.tables["categorical"].ef is not None
    back = numpy_state(trainer.load(state, port_dir))["tables"]["categorical"]
    for k in ("weights", "ef"):
        np.testing.assert_array_equal(back[k], t[k], err_msg=k)
