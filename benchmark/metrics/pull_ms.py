"""`pull_ms`: device ms a step of the program's phase `trainer.pull`
(`model.Trainer._step`: the batch's ids and every table's pull; on a
hashed table its dedup, the probe `hash.probe_insert` and the gather),
from the events the window's CUDA graph stamps at every replay under the
program's timed driver (`benchmark/phases.py`); the mean over the traced
windows."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "trainer.pull")
