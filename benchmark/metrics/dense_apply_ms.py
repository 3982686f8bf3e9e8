"""`dense_apply_ms`: device ms a step of the program's phase
`trainer.dense_apply` (`model.Trainer._step_tail`: the tower's Adagrad
update, `dense_update`), from the events the window's CUDA graph stamps at
every replay under the program's timed driver (`benchmark/phases.py`); the
mean over the traced windows."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "trainer.dense_apply")
