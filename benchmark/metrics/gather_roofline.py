"""`gather_roofline`: the pull's gather kernel (`ops/gather.py` ->
`csrc/gather_rows.cu`) against its byte bound (%): the device time of the
records named `gather_rows` in the traced window, against the row
indices, each distinct row read once and the rows written
(`costs.gather_bytes`) of the traced steps, at the HBM peak."""

from benchmark import costs, profiling

KERNEL = "gather_rows"


def read(ctx):
    if ctx.trace is None:
        return None
    recs = profiling.by_name(ctx.trace, KERNEL)
    calls = sum(r[2] for r in recs)
    steps = ctx.traced_batches
    if calls != len(steps):  # one pull a step, or the bytes are not known
        ctx.log(f"gather_roofline: {calls} records for {len(steps)} steps")
        return None
    us = sum(r[1] for r in recs)
    n = ctx.traffic["batch_size"] * ctx.traffic["num_fields"]
    nbytes = sum(costs.gather_bytes(ctx.config, n, ctx.unique[t])
                 for t in steps)
    return 100.0 * nbytes / costs.peak(ctx.kind)["hbm_bytes_s"] / (us * 1e-6)
