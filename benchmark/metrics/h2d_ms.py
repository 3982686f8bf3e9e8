"""`h2d_ms`: host milliseconds a window spends in the program's
`trainer.h2d` range (`CompiledStep` copying the numpy window into the
graph's static buffers), the mean over the traced windows."""

from benchmark import profiling


def read(ctx):
    if ctx.trace is None:
        return None
    spans = profiling.host_ranges(ctx.trace, "trainer.h2d")
    if not spans:
        return None
    return sum(spans) / len(spans) / 1000.0
