"""`push_ms`: device ms a step of the program's phase `trainer.sparse_apply`
(`model.Trainer._step_tail`: every table's push, its dedup
`trainer.dedup` and the fused apply kernel), from the events the window's
CUDA graph stamps at every replay under the program's timed driver
(`benchmark/phases.py`); the mean over the traced windows."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "trainer.sparse_apply")
