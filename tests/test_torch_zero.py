"""The port's ZeRO dense-state sharding (`MeshTrainer(dense_shard=True)`,
`parallel/zero.py`) at fp32, on two gloo ranks (`multihost.run_local`).

- Against the port's replicated MeshTrainer from one init, for each of the
  nine optimizer rules (two `train_step`s and a `train_many` window of
  two): the losses and the externalized state (tables, dense params and
  dense slots) are bit-equal. The flat slot's chunk sum is
  `collectives.reduce_scatter`'s, which adds in the replicated
  `dense_sum`'s order, and every rule is elementwise along its row. Each
  rank holds (1, C) chunks of the vector slots and one (1, 1) of a scalar
  slot.
- Against the JAX `MeshTrainer(dense_shard=True)` (the dense tower on
  Adam 0.01, the table on Adagrad 0.05, as `test_torch_mesh_train.py`'s
  tables, whose bounds an Adam row, moving by about lr whatever its
  gradient's size, would not keep): 10 steps
  from the JAX init carried across in its flat form
  (`convert.mesh_state_from_jax`, the ranks' chunks of the global flat
  vectors), compared with `test_torch_mesh_train.py`'s bounds (loss 1e-6,
  tables and dense params 1e-6, dense slots 2e-6; measured: loss 1.2e-7,
  table 1.7e-8, accumulator 2.2e-8, dense params 4.5e-7, flat m 3.7e-8,
  v 2.3e-10, the beta powers equal). Both sides sum two ranks' partials,
  where the order does not matter; what differs is the forward's and
  backward's matmuls (XLA contracts multiply-adds), and Adam carries a
  gradient's last bits into a dense step of about lr.
- A table on the trainer's Adam (no optimizer of its own): the JAX
  MeshTrainer's state holds its slots sorted by name, and the fused apply
  takes them by name (`ops/apply.in_slot_order`). Three steps from the
  JAX ZeRO init against the JAX run: loss 1e-6, table 1e-5, its slots
  1e-7 (measured: loss 0, table 9.4e-7, m 8.4e-9, v 5.5e-12, the beta
  powers equal; an Adam row moves by about lr whatever its gradient's
  size, so a gradient's last bits reach the weights at lr's scale).
- The JAX validation errors (`tests/test_zero.py:467-498`).

`test_torch_zero_checkpoint.py` holds the checkpoints,
`test_torch_zero_wire.py` the dense wires, `test_torch_zero_s4.py` four
ranks and the pipelined window. About 20 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.mesh import Mesh
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_zero_ranks as zr
from test_torch_mesh_train import numpy_state

S, VOCAB, STEPS = 2, 1000, 10
TOL = {"loss": 1e-6, "table": 1e-6, "dense_params": 1e-6,
       "dense_slots": 2e-6}
ADAM_TABLE_STEPS = 3
ADAM_TOL = {"loss": 1e-6, "table": 1e-5, "table_slots": 1e-7}


@pytest.fixture(scope="module")
def nine(tmp_path_factory):
    return run_local(zr.zero_vs_replicated, S, args=(
        {"optimizers": list(zr.NINE), "steps": 2, "window": 2},),
        timeout_s=120, tmp_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("name", list(zr.NINE))
def test_fp32_zero_is_bit_equal_to_the_replicated_run(nine, name):
    for r in range(S):
        got = nine[r][name]
        assert got["flat"]
        assert got["same_losses"]
        assert got["differ"] == []
        total, chunk, padded = got["plan"]
        assert padded == S * chunk >= total > 0
        opt = zr.NINE[name]()
        for slot, width in opt.slot_shapes(2).items():
            assert got["shapes"][slot] == ((1, 1) if width == 1
                                           else (1, chunk)), slot
        assert set(got["shapes"]) == set(opt.slot_shapes(2))


def _jax_trainer(table_optimizer=None, shards=S, **kw):
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32,
                            optimizer=table_optimizer)
    return JaxMeshTrainer(model, jax_embed.Adam(learning_rate=0.01),
                          mesh=jax_make_mesh(jax.devices()[:shards]),
                          wire="fp32", **kw)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=what)


def _jax_run(table_optimizer, steps):
    """(JAX ZeRO trainer, its init as numpy, the batches, the losses, the
    final state) of `steps` jitted steps."""
    trainer = _jax_trainer(table_optimizer, dense_shard=True)
    batches = zr.batches(steps)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    step = trainer.jit_train_step(batches[0], state)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return trainer, start, batches, losses, state


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """The Adagrad-table run of 10 steps and, in the same spawn of the
    ranks, the Adam-table run of ADAM_TABLE_STEPS."""
    trainer, start, batches, losses, state = _jax_run(
        jax_embed.Adagrad(learning_rate=0.05), STEPS)
    _, adam_start, adam_batches, adam_losses, adam_state = _jax_run(
        None, ADAM_TABLE_STEPS)
    cfgs = [{"vocab": VOCAB,
             "optimizer": optimizers.Adam(learning_rate=0.01),
             "table_optimizer": optimizers.Adagrad(learning_rate=0.05),
             "state": start, "batches": batches},
            {"vocab": VOCAB,
             "optimizer": optimizers.Adam(learning_rate=0.01),
             "state": adam_start, "batches": adam_batches}]
    port = run_local(zr.trajectories, S, args=(cfgs,), timeout_s=120,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return {"losses": losses, "want": numpy_state(state),
            "want_ext": numpy_state(trainer.externalize(state)),
            "start": start, "port": [p[0] for p in port],
            "adam": (adam_start, adam_losses, numpy_state(adam_state),
                     [p[1] for p in port])}


def test_ten_steps_match_the_jax_zero_mesh_trainer(trajectory):
    want_losses, want, want_ext, start, port = (
        trajectory[k] for k in ("losses", "want", "want_ext", "start",
                                "port"))
    assert any(k.startswith("__zero__/") for k in start["dense_slots"])
    for r in range(S):
        _close(port[r]["losses"], want_losses, TOL["loss"], "loss")
    assert want_losses[-1] < want_losses[0]
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    assert set(got["dense_slots"]) == set(want["dense_slots"]) == {
        "__zero__/m", "__zero__/v", "__zero__/beta_1_t", "__zero__/beta_2_t"}
    for k, v in want["dense_slots"].items():
        assert got["dense_slots"][k].shape == v.shape, k
        _close(got["dense_slots"][k], v, TOL["dense_slots"], k)
    for k, v in want["dense_params"].items():
        _close(got["dense_params"][k], v, TOL["dense_params"], k)
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    _close(g["weights"], t["weights"], TOL["table"], "weights")
    ext = port[0]["external"]
    assert set(ext["dense_slots"]) == set(want_ext["dense_slots"])
    for k, v in want_ext["dense_slots"].items():
        _close(ext["dense_slots"][k], v, TOL["dense_slots"], k)


def test_adam_tables_load_from_the_jax_mesh_trainer(trajectory):
    start, want_losses, want, port = trajectory["adam"]
    # the JAX MeshTrainer's state holds an Adam table's slots sorted by
    # name, not in the rule's order
    slots = list(start["tables"]["categorical"]["slots"])
    assert slots == sorted(slots) != list(
        optimizers.Adam(0.01).slot_shapes(1))
    for r in range(S):
        _close(port[r]["losses"], want_losses, ADAM_TOL["loss"], "loss")
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    _close(g["weights"], t["weights"], ADAM_TOL["table"], "weights")
    assert set(g["slots"]) == set(t["slots"])
    for k, v in t["slots"].items():
        _close(g["slots"][k], v, ADAM_TOL["table_slots"], k)


def _mesh():
    return Mesh(group=None, rank=0, size=S, device=torch.device("cpu"),
                backend="gloo")


def test_validation_errors():
    def make(**kw):
        return MeshTrainer(make_deepfm(VOCAB, 9, hidden=(16, 16)),
                           optimizers.Adagrad(learning_rate=0.1),
                           mesh=_mesh(), **kw)

    with pytest.raises(ValueError, match="dense_shard"):
        make(dense_wire="int8")
    with pytest.raises(ValueError, match="dense_wire"):
        make(dense_shard=True, dense_wire="int4")
    assert make(dense_shard=True, dense_wire="fp32").dense_wire is None
    with pytest.raises(ValueError, match="dense_topk"):
        make(dense_shard=True, dense_wire="int8", dense_topk=32)
    with pytest.raises(ValueError, match="dense_topk"):
        make(dense_shard=True, dense_wire="sparse_topk", dense_topk=0)
    tr = make(dense_shard=True, dense_wire="int8")
    with pytest.raises(ValueError, match="dense_topk"):
        tr.set_dense_wire(None, "int8", dense_topk=4)
    with pytest.raises(ValueError, match="dense_wire"):
        tr.set_dense_wire(None, "int4")
    assert make(dense_shard=True).zero_enabled
    one = MeshTrainer(make_deepfm(VOCAB, 9, hidden=(16, 16)), mesh=Mesh(
        group=None, rank=0, size=1, device=torch.device("cpu"),
        backend="gloo"), dense_shard=True)
    assert not one.zero_enabled
