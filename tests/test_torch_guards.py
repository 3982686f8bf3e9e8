"""The port's runtime guards (`utils/guards.py`): what the JAX package's
guards protect, the port's way (ROADMAP.md §C). A new batch structure past
the budget raises `RecompileError` at that call and `trace_counter` counts
it; a CUDA-graph driver is budgeted on its captures (here a stand-in that
counts as `model.CompiledStep` does); the collective fingerprint is stable
across steps, changes when a collective is planted, is equal on both of
two gloo ranks, and the capsule carries `last_fingerprint()`. The JAX
guards' behaviour on the same budget is the reference for the error
points."""

import types

import numpy as np
import pytest
import torch

from openembedding_tpu.utils import guards as jax_guards
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.data import synthetic_criteo
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.utils import capsule, guards

import torch_fs_ranks as ranks

VOCAB = 256


def _trainer():
    model = make_deepfm(VOCAB, 4, hidden=(8,), compute_dtype=torch.float32)
    return Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                   device="cpu")


def test_a_new_batch_structure_past_the_budget_raises():
    tr = _trainer()
    b16, b16b = list(synthetic_criteo(16, id_space=VOCAB, steps=2, seed=1))
    b8 = next(synthetic_criteo(8, id_space=VOCAB, steps=1, seed=2))
    state = tr.init(b16)
    step = guards.assert_no_recompile(tr.jit_train_step(), label="step")
    with guards.trace_counter(step) as tc:
        state, _ = step(state, b16)
        state, _ = step(state, b16b)  # the same structure: no new capture
        assert tc.new_traces == 1
        before = state.step
        with pytest.raises(guards.RecompileError, match="'step' traced 2"):
            step(state, b8)
        assert state.step == before  # raised before the step ran
    assert tc.new_traces == 2 and step.trace_count() == 2
    relaxed = guards.assert_no_recompile(tr.jit_train_step(), max_traces=2)
    state, _ = relaxed(state, b16)
    state, _ = relaxed(state, b8)
    assert relaxed.trace_count() == 2


def test_plain_callables_count_structures_as_jax_counts_traces():
    """The same calls through the port's guard and the JAX guard: both
    raise on the third structure with a budget of 2, and count alike."""
    calls = [np.zeros(3, np.float32), np.ones(3, np.float32),
             np.zeros(4, np.float32), np.zeros(3, np.int32)]
    port = guards.assert_no_recompile(lambda x: x.sum(), max_traces=2)
    jax_fn = jax_guards.assert_no_recompile(lambda x: x.sum(), max_traces=2)
    for fn, error in ((port, guards.RecompileError),
                      (jax_fn, jax_guards.RecompileError)):
        fn(calls[0])
        fn(calls[1])  # same shape and dtype: no new trace
        fn(calls[2])
        with pytest.raises(error):
            fn(calls[3])
        assert fn.trace_count() == 3
    assert guards.assert_no_recompile(lambda x: x)(5) == 5

    @guards.assert_no_recompile(max_traces=1)
    def double(batch):
        return {k: v * 2 for k, v in batch.items()}

    double({"a": torch.ones(2)})
    with pytest.raises(guards.RecompileError):
        double({"a": torch.ones(2), "b": torch.ones(2)})


def test_a_graph_driver_is_budgeted_on_its_captures():
    """A driver on the card counts its captures (`CompiledStep.captures`);
    the guard raises after the call that captured past the budget."""
    card = types.SimpleNamespace(device=torch.device("cuda"))
    idle = types.SimpleNamespace(captures=3, trainer=card)

    class Step:
        captures = 0
        trainer = card

        def __call__(self, state, batch):
            if batch == "new":
                self.captures += 1
            return state, {}

    step = Step()
    step.captures = 1  # captured before the guard was put on
    guarded = guards.assert_no_recompile(step)
    with guards.trace_counter(guarded, step, idle) as tc:
        guarded(None, "new")
        guarded(None, "same")
        assert guarded.trace_count() == 1 and tc.new_traces == 2
        with pytest.raises(guards.RecompileError, match="captured 2 new"):
            guarded(None, "new")
    assert guarded.__wrapped__ is step


def test_fingerprints_stable_planted_and_equal_on_two_ranks(tmp_path):
    out = run_local(ranks.fingerprints, 2,
                    args=({"vocab": VOCAB,
                           "capsule_dir": str(tmp_path / "caps")},),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in (0, 1):
        fps = out[r]["fps"]
        assert fps[0] == fps[1] != fps[2]  # stable; a planted one shows
        assert out[r]["pinned_ok"] == fps[0] and out[r]["tripped"]
        assert out[r]["last"] == out[r]["capsule_fp"] == fps[2]
        kinds = [e[0] for e in out[r]["seq"]]
        assert kinds.count("all_to_all") >= 3 and "all_reduce" in kinds
        assert all(e[1] == 2 for e in out[r]["seq"])
    assert out[0]["fps"] == out[1]["fps"]
    assert out[0]["seq"] == out[1]["seq"]


def test_one_rank_records_nothing_and_the_capsule_carries_the_last():
    tr = _trainer()
    b = next(synthetic_criteo(16, id_space=VOCAB, steps=1, seed=3))
    box = {"state": tr.init(b)}

    def step(batch):
        box["state"], _ = tr.train_step(box["state"], batch)

    assert guards.collective_sequence(step, b) == []
    fp = guards.collective_fingerprint(step, b)
    assert box["state"].step == 2  # running the function trained
    assert guards.last_fingerprint() == fp
    writer = capsule.CapsuleWriter("unused")
    assert writer._payload("t", {})["fingerprint"] == fp
