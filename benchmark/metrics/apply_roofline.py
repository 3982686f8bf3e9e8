"""`apply_roofline`: the fused sparse apply kernel (`ops/apply.py` ->
`csrc/fused_sparse_apply.cu`) against its byte bound (%): the device time
of the records named `fused_apply` in the traced window, against the
deduplicated rows' ids, counts and gradients read and their weights and
accumulators read and written once (`costs.apply_bytes`), at the HBM
peak."""

from benchmark import costs, profiling

KERNEL = "fused_apply"


def read(ctx):
    if ctx.trace is None:
        return None
    recs = profiling.by_name(ctx.trace, KERNEL)
    calls = sum(r[2] for r in recs)
    steps = ctx.traced_batches
    if calls != len(steps):  # one push a step, or the bytes are not known
        ctx.log(f"apply_roofline: {calls} records for {len(steps)} steps")
        return None
    us = sum(r[1] for r in recs)
    nbytes = sum(costs.apply_bytes(ctx.config, ctx.unique[t]) for t in steps)
    return 100.0 * nbytes / costs.peak(ctx.kind)["hbm_bytes_s"] / (us * 1e-6)
