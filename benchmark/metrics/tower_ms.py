"""`tower_ms`: device ms a step of the program's phase `trainer.compute`
(`model.Trainer._step_tail`: the pulled rows made autograd leaves, the
tower's forward, the loss, the backward and the dense gradients), from
the events the window's CUDA graph stamps at every replay under the
program's timed driver (`benchmark/phases.py`); the mean over the traced
windows."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "trainer.compute")
