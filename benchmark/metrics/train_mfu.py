"""`train_mfu`: the training step's least time on the card over its
measured time (%), a whole-step utilisation against the time a user waits.
The least time is the larger of the step's model operations at the card's
bf16 peak and its compulsory bytes at the HBM peak (`costs.py`), worked out
from the configuration, the mix and the pool's distinct ids; the measured
time is the untraced window's seconds a step on the host's clock, the same
seconds `examples_per_s` divides by, so the source is `host_clock`. Which
bound holds goes to the log, with the card's power limit."""

from benchmark import costs


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    cfg, mix = ctx.config, ctx.traffic
    b, nf, nd = mix["batch_size"], mix["num_fields"], mix["dense_dim"]
    unique = sum(ctx.unique) / len(ctx.unique)
    flops = costs.step_flops(cfg, b, nd, nf)
    nbytes = costs.step_bytes(cfg, b, nd, nf, unique)
    least, bound = costs.least_seconds(flops, nbytes, ctx.kind)
    ctx.log(f"train_mfu: {flops:.6g} operations and {nbytes:.6g} bytes a "
            f"step; the {bound} bound holds, {least * 1e6:.4f} us, against "
            f"{ctx.step_seconds * 1e6:.4f} us measured; {ctx.kind}, power "
            f"limit {ctx.power_limit}")
    return 100.0 * least / ctx.step_seconds
