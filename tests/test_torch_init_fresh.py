"""Every `init` gives a dense module of its own (`model._materialize_dense`
on `layers.unmaterialized_copy` of the model's module), as every JAX
`init` returns new parameters.

For `Trainer`, `MeshTrainer` at S = 1 and 2 (ZeRO off and on) and
`init_weights`: a second `init` after three training steps on the first
state equals the first init bit for bit (the externalized state: tables,
dense params and dense slots), and the two states share no tensor, so a
step on one leaves the other as it was. `model.module` stays the
template: materialized by hand with other draws, or loaded into by
`convert.train_state_from_jax`, it changes nothing a later `init` draws.
`StandaloneModel.load` loads into a copy of its own. About 10 s alone.
"""

import numpy as np
import torch

from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.layers import materialize
from openembedding_tpu_torch.model import Trainer, init_weights
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.mesh import Mesh
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_zero_ranks as zr
from torch_mesh_ranks import _same_bits, deepfm, flat_state


def _snapshot(state):
    return flat_state(convert.train_state_to_jax(state))


def _three_steps(trainer, state):
    for b in zr.batches(3):
        state, _ = trainer.train_step(state, b)
    return state


def test_trainer_init_is_fresh_every_time():
    model = deepfm(1000)
    tr = Trainer(model, optimizers.Adam(learning_rate=0.01), device="cpu")
    b = zr.batches(1)[0]
    first = tr.init(b)
    before = _snapshot(first)
    first = _three_steps(tr, first)
    assert _same_bits(before, _snapshot(first))  # the steps trained
    second = tr.init(b)
    assert _same_bits(before, _snapshot(second)) == []
    assert zr.shared_tensors(first, second) == 0
    assert second.dense is not model.module and first.dense is not \
        second.dense
    # the template stays unmaterialized, and materializing it by hand
    # changes no later init
    assert not any(True for _ in model.module.parameters())
    gen = torch.Generator().manual_seed(99)
    materialize(model.module, {n: torch.zeros(2, 1, 10) for n in
                               model.specs}, torch.zeros(2, 13),
                generator=gen)
    assert any(True for _ in model.module.parameters())
    assert _same_bits(before, _snapshot(tr.init(b))) == []


def test_mesh_trainer_one_rank_init_is_fresh():
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    for shard in (False, True):
        tr = MeshTrainer(deepfm(1000), optimizers.Adam(learning_rate=0.01),
                         mesh=mesh, wire="fp32", dense_shard=shard)
        b = zr.batches(1)[0]
        first = tr.init(b)
        before = _snapshot(first)
        first = _three_steps(tr, first)
        second = tr.init(b)
        assert _same_bits(before, _snapshot(second)) == []
        assert zr.shared_tensors(first, second) == 0


def test_mesh_trainer_two_ranks_init_is_fresh(tmp_path):
    for rank in run_local(zr.fresh_inits, 2, args=({},), timeout_s=90,
                          tmp_dir=str(tmp_path)):
        for shard in (False, True):
            got = rank[shard]
            assert got["differ"] == [] and got["trained_differ"]
            assert got["shared"] == 0


def test_init_weights_is_fresh_and_untouched_by_training():
    model = deepfm(1000)
    b = zr.batches(1)[0]
    w1 = init_weights(model, b, device="cpu")
    dense1 = {k: v.clone() for k, v in w1.dense.state_dict().items()}
    tr = Trainer(model, optimizers.Adam(learning_rate=0.01), device="cpu")
    _three_steps(tr, tr.init(b))
    w2 = init_weights(model, b, device="cpu")
    for k, v in w2.dense.state_dict().items():
        assert torch.equal(v, dense1[k]), k
        assert torch.equal(w1.dense.state_dict()[k], dense1[k]), k
    assert w1.dense is not w2.dense
    assert not set(p.data_ptr() for p in w1.dense.parameters()) & set(
        p.data_ptr() for p in w2.dense.parameters())


def test_states_from_jax_and_exports_own_their_modules(tmp_path):
    model = deepfm(1000)
    tr = Trainer(model, optimizers.Adam(learning_rate=0.01), device="cpu")
    b = zr.batches(1)[0]
    state = _three_steps(tr, tr.init(b))
    js = convert.train_state_to_jax(state)
    a = convert.train_state_from_jax(model, device="cpu", **{
        k: js[k] for k in ("tables", "dense_params", "dense_slots")})
    c = convert.train_state_from_jax(model, device="cpu", **{
        k: js[k] for k in ("tables", "dense_params", "dense_slots")})
    assert zr.shared_tensors(a, c) == 0
    assert a.dense is not model.module
    assert _same_bits(_snapshot(a), _snapshot(c)) == []
    a = _three_steps(tr, a)
    assert _same_bits(_snapshot(a), _snapshot(c))
    export_standalone(state, model, str(tmp_path))
    served = StandaloneModel.load(str(tmp_path), model=model, device="cpu")
    assert served.dense is not model.module
    assert not any(True for _ in model.module.parameters())
    logits = served.predict(b)
    want = tr.eval_step(state, b)["logits"]
    np.testing.assert_allclose(logits.numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)
