"""`nccl_share`: the share (%) of the traced window that NCCL kernels
(the exchange's all_to_alls, the dense sum) run on this rank's card."""

from benchmark import profiling


def read(ctx):
    if ctx.trace is None or ctx.mesh is None:
        return None
    us = sum(r[1] for r in profiling.by_name(ctx.trace, "nccl"))
    return 100.0 * us / profiling.window_us(ctx.trace)
