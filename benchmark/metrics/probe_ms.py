"""`probe_ms`: device ms a step of the program's phase `hash.probe_insert`
(`tables/hash_table.hash_lookup_train`: the 64 probe rounds of
`hash_find_or_insert` with the claim buffer's fill) inside the window's
step, from the events the window's CUDA graph stamps at every replay
under the program's timed driver (`benchmark/phases.py`); the mean over
the traced windows. The program's counterpart of `hash_probe_ms`, which
times the same probe in a graph of the harness's own."""

from benchmark import phases


def read(ctx):
    return phases.step_ms(ctx, "hash.probe_insert")
