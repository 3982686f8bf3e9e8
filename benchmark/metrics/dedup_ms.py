"""`dedup_ms`: device ms a step of the program's phase `trainer.dedup`
(`ops/sparse._push_dedup`: the push's sort, segment sums and routing,
inside `trainer.sparse_apply`), from the events the window's CUDA graph
stamps at every replay under the program's timed driver
(`benchmark/phases.py`); the mean over the traced windows."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "trainer.dedup")
