"""Checkpoints of the port's ZeRO MeshTrainer (`dense_shard=True`) on two
gloo ranks (`multihost.run_local`), Adam 0.01, fp32:

- a ZeRO run's sharded save equals the replicated run's byte for byte
  (an .npz by its arrays' bytes, since a zip member carries its write
  time; model_meta, which holds a random model sign, aside), and the
  saved states externalized are bit-equal: `save` writes `externalize`'s
  per-leaf form;
- each checkpoint loads into a trainer of either kind (ZeRO on or off) and
  two more steps go on bit-equal to the replicated run's: losses and the
  externalized state;
- the JAX `MeshTrainer(dense_shard=True)`'s checkpoint loads here, and
  ours loads there, each bit-equal (dense params and slots) to what was
  saved.

About 15 s alone.
"""

import pytest

from openembedding_tpu_torch.parallel.multihost import run_local

import torch_zero_ranks as zr
from test_torch_mesh_train import numpy_state
from test_torch_zero import S, _jax_trainer
from torch_mesh_ranks import flat_state


def _dense(flat):
    return {k: v for k, v in flat.items() if k.startswith("/dense_")}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    trainer = _jax_trainer(dense_shard=True)
    batches = zr.batches(2, seed=5)
    state = trainer.init(batches[0])
    step = trainer.jit_train_step(batches[0], state)
    for b in batches:
        state, _ = step(state, b)
    trainer.save(state, str(root / "jax"))
    jax_saved = numpy_state(trainer.externalize(state))
    port = run_local(zr.checkpoints, S, args=(
        {"root": str(root), "jax": str(root / "jax")},), timeout_s=120,
        tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    loader = _jax_trainer(dense_shard=True)
    loaded = loader.load(loader.init(batches[0]), str(root / "on"))
    return port, jax_saved, numpy_state(loader.externalize(loaded))


def test_zero_checkpoint_is_byte_identical_to_the_replicated_one(
        checkpoints):
    port, _, _ = checkpoints
    for r in range(S):
        assert port[r]["saved_differ"] == []
        assert port[r]["same_files"], port[r]["files"]
    assert any(f.endswith("dense_slots.npz") for f in port[0]["files"])


@pytest.mark.parametrize("combo", [("off", "on"), ("on", "off"),
                                   ("on", "on")],
                         ids=lambda c: f"{c[0]}-to-{c[1]}")
def test_checkpoints_cross_zero_on_and_off(checkpoints, combo):
    port, _, _ = checkpoints
    for r in range(S):
        base_losses, base = port[r]["runs"][("off", "off")]
        losses, ext = port[r]["runs"][combo]
        assert losses == base_losses
        assert zr._same_bits(base, ext) == []


def test_checkpoints_cross_packages(checkpoints):
    port, jax_saved, jax_loaded = checkpoints
    want = _dense(flat_state(jax_saved))
    for r in range(S):
        got = _dense(flat_state(port[r]["from_jax"]))
        assert zr._same_bits(got, want) == []
    got = _dense(flat_state(jax_loaded))
    assert zr._same_bits(got, _dense(port[0]["saved"])) == []
