"""`hash_probe_ms`: device milliseconds of one `hash_find_or_insert`
(`tables/hash_table.py`) of one pool batch's distinct ids, as the training
pull probes them, against the cell's own table after the window (every
pool id is in it by then). The probe is captured in a CUDA graph, as the
window's graph holds it, so its 64 rounds of launches cost the host
nothing; CUDA events around each of 20 replays after 3 unmeasured ones;
the median."""

import statistics

import torch

CALLS, WARM = 20, 3


def read(ctx):
    if not ctx.config["hashed"] or ctx.device.type != "cuda":
        return None
    from openembedding_tpu_torch.ops.dedup import unique_with_counts
    from openembedding_tpu_torch.tables.hash_table import hash_find_or_insert
    keys = ctx.program["state"].tables["categorical"].keys
    ids = torch.from_numpy(
        ctx.program["windows"][0]["sparse"]["categorical"][0].reshape(-1)
    ).to(ctx.device)
    uniq = unique_with_counts(ids)
    probe = torch.where(uniq.counts > 0, uniq.unique_ids,
                        torch.full_like(uniq.unique_ids, -1))
    stream = torch.cuda.Stream(ctx.device)
    stream.wait_stream(torch.cuda.current_stream(ctx.device))
    with torch.cuda.stream(stream):
        hash_find_or_insert(keys, probe)
    torch.cuda.current_stream(ctx.device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        hash_find_or_insert(keys, probe)
    times = []
    for n in range(WARM + CALLS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize(ctx.device)
        if n >= WARM:
            times.append(e0.elapsed_time(e1))
    del graph
    return statistics.median(times)
