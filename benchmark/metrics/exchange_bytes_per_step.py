"""`exchange_bytes_per_step`: the bytes this rank's collectives carry a
step, every kind summed, as the window's capture recorded them
(`CompiledStep.collective_bytes`, from `parallel/collectives.record_bytes`)
over the window's steps."""


def read(ctx):
    if ctx.mesh is None:
        return None
    seen = ctx.program["step"].collective_bytes
    if not seen:
        return None
    return float(sum(seen.values())) / ctx.traffic["window"]
