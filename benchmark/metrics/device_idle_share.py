"""`device_idle_share`: the share (%) of the traced window of replayed
windows in which no device record (kernel, copy or memset) runs."""

from benchmark import profiling


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - profiling.busy_us(ctx.trace)
                    / profiling.window_us(ctx.trace))
