"""Line-rate ingest soak of the port (port of `tools/ingest_soak.py`'s
`run` and `main`): find the compute ceiling, feed the window loop through
the depth-D device feed ring at line rate, and show that the input-wait
attribution points the right way.

    python -m openembedding_tpu_torch.ingest_soak            # the CUDA card
    python -m openembedding_tpu_torch.ingest_soak --device cpu

One rank (or `--devices S` ranks, spawned by `parallel.multihost.run_local`:
NCCL with a card each, else gloo, staged through the host on cards), three
measured phases over the same window driver:

  ceiling    pre-staged windows, min ms a step: what the device absorbs
             with input off the books (examples/s a device);
  line rate  `MeshTrainer.train_stream` fed by `data.ingest.feed` (sharded
             synthetic "days" -> parse pool -> depth-D ring): the measured
             `ingest.input_wait_share` is judged against the ingest SLO (a
             copy of the JAX package's `tools/ingest_slo.json`: < 5%,
             compute-bound);
  throttled  the same loop behind a producer paced at 2x the measured
             ceiling: the share must read input-bound (the control that
             shows the lane attributes, not flatters).

Asserted at exit: the throttled control's inverted attribution and a
pooled-vs-inline reader bit-identity spot check. The line-rate SLO verdict
becomes the exit code unless `--no-slo-gate` is given. The JAX tool's
`--weave` (interleavings explored under its `tools/oeweave`) is not
ported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: the ingest SLO: a copy of the JAX package's `tools/ingest_slo.json`
SLO_SPECS = [
    {
        "name": "input_wait_share",
        "metric": "ingest.input_wait_share",
        "selector": "value",
        "op": "<=",
        "threshold": 0.05,
        "description": "the train loop blocks on input < 5% of window wall "
                       "time (compute-bound, not input-bound)",
    },
]


def _files(windows: int, window: int, vocab: int) -> list:
    return [f"synthetic://steps={windows * window // 2}&seed={7 + s}"
            f"&id_space={vocab}" for s in range(2)]


def _soak(mesh, cfg: dict) -> dict:
    """The three phases on this rank -> the report (see `run`)."""
    import torch

    from . import optimizers
    from .data import ingest
    from .models import make_deepfm
    from .parallel import MeshTrainer, multihost
    from .utils import metrics, slo

    quiet = cfg["quiet"] or mesh.rank != 0

    def log(msg):
        if not quiet:
            print(f"[ingest_soak] {msg}", flush=True)

    S, window, batch = mesh.size, cfg["window"], cfg["batch"]
    files = _files(cfg["windows"], window, cfg["vocab"])

    def ring(label, throttle_s=0.0, d=cfg["depth"]):
        return ingest.feed(files, batch, mesh=mesh, source="synthetic",
                           depth=d, window=window, workers=cfg["workers"],
                           label=label, throttle_s=throttle_s)

    # determinism spot check: the parse pool's reorder stage must be
    # bit-identical to the inline reader over the same sharded file list
    inline = list(ingest.sharded_reader(files, batch, source="synthetic",
                                        host_id=0, num_hosts=1))
    pooled = list(ingest.sharded_reader(files, batch, source="synthetic",
                                        host_id=0, num_hosts=1,
                                        workers=cfg["workers"]))
    reader_identical = len(inline) == len(pooled) and all(
        np.array_equal(a["sparse"]["categorical"],
                       b["sparse"]["categorical"])
        and np.array_equal(a["dense"], b["dense"])
        for a, b in zip(inline, pooled))

    model = make_deepfm(vocabulary=cfg["vocab"], dim=9)
    tr = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                     mesh=mesh, capacity_factor=0.0, wire="fp32",
                     pipeline_steps=True)
    cuda = mesh.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(mesh.device)) if cuda \
        else (lambda: None)

    # phase 1: the compute ceiling (input off the books)
    metrics.reset_all()
    staged = list(ring("stage"))
    state = tr.init(multihost.node_rows(inline[0], mesh))
    many = tr._many_driver()
    times = []
    for i, w in enumerate(staged):
        sync()
        t0 = time.perf_counter()
        state, m = many(state, w)
        sync()
        if i:
            times.append((time.perf_counter() - t0) / window)
    del staged
    ceiling_s = min(times)
    log(f"compute ceiling: {ceiling_s * 1e3:.3f} ms/step "
        f"({batch / ceiling_s / S:.0f} examples/s a device on {S} "
        f"rank(s), {mesh.device.type})")

    # phase 2: ring-fed at line rate, the SLO-gated run
    metrics.reset_all()
    t0 = time.perf_counter()
    state, rep = tr.train_stream(state, ring("line"))
    elapsed = time.perf_counter() - t0
    share = ingest.input_wait_share()
    evaluator = slo.SLOEvaluator(specs=[slo.parse_spec(d)
                                        for d in SLO_SPECS])
    verdicts = evaluator.evaluate_now()
    slo_exit = evaluator.exit_code()
    log("line-rate SLOs:\n" + evaluator.render_text())

    # phase 3: the throttled control, the producer paced at
    # throttle_factor x the measured ceiling: must read input-bound
    metrics.reset_all()
    state, trep = tr.train_stream(
        state, ring("slow", throttle_s=cfg["throttle_factor"] * ceiling_s,
                    d=1))
    tshare = ingest.input_wait_share()

    report = {
        "num_shards": S,
        "batch": batch,
        "window": window,
        "windows": rep["windows"],
        "compute_ms_per_step": round(ceiling_s * 1e3, 3),
        "compute_ceiling_eps_per_chip": round(batch / ceiling_s / S, 1),
        "line_rate": {
            "examples_per_sec_per_chip": round(
                rep["windows"] * window * batch / elapsed / S, 1),
            "input_wait_share": share,
            "loss": rep["loss"],
        },
        "throttled": {
            "windows": trep["windows"],
            "input_wait_share": tshare,
        },
        "reader_pool_bit_identical": reader_identical,
        "slo": {v["name"]: v["verdict"] for v in verdicts},
        "slo_exit_code": slo_exit,
        "device": str(mesh.device),
        "captures": getattr(many, "captures", None),
    }
    log(json.dumps(report, indent=2))
    return report


def run(*, windows=6, window=8, batch=512, vocab=1 << 13, depth=3,
        workers=2, devices=1, throttle_factor=2.0, quiet=False,
        device=None) -> dict:
    """-> report dict. Raises AssertionError when the soak's invariants
    break. The report carries the line-rate SLO verdicts (judged over the
    line-rate phase only: the throttled phase breaches on purpose) and
    `slo_exit_code`, which `main()` adopts as the exit status.

    `device`: None is the CUDA card (raises without one), "cpu" the CPU.
    `devices`: the ranks; at 1 the soak runs in this process on a one-rank
    group, above it on spawned ranks (rank 0's report)."""
    import torch

    from .device import resolve_device
    from .parallel import make_mesh, multihost

    dev = resolve_device(device)
    cfg = dict(windows=windows, window=window, batch=batch, vocab=vocab,
               depth=depth, workers=workers,
               throttle_factor=throttle_factor, quiet=quiet)
    if devices > 1:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = "nccl" if dev.type == "cuda" and cards >= devices \
            else "gloo"
        report = multihost.run_local(
            _soak, devices, backend=backend, device=dev.type,
            args=(cfg,), timeout_s=3600, threads=0)[0]
    else:
        import torch.distributed as dist
        own = not dist.is_initialized()
        if own:
            multihost.initialize("nccl" if dev.type == "cuda" else "gloo")
        try:
            report = _soak(make_mesh(device=dev), cfg)
        finally:
            if own:
                dist.destroy_process_group()
    share = report["line_rate"]["input_wait_share"]
    tshare = report["throttled"]["input_wait_share"]
    assert report["reader_pool_bit_identical"], report
    assert share is not None and tshare is not None, report
    assert tshare > 0.25, (
        f"throttled producer not attributed input-bound: {tshare}", report)
    assert tshare > share, report
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--window", type=int, default=8,
                    help="steps per window (the train_many K)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=1 << 13)
    ap.add_argument("--depth", type=int, default=3,
                    help="feed-ring depth (windows staged ahead)")
    ap.add_argument("--workers", type=int, default=2,
                    help="parse-pool workers")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks (spawned above 1)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--throttle-factor", type=float, default=2.0,
                    help="throttled-control producer pace as a multiple of "
                         "the measured per-step compute ceiling")
    ap.add_argument("--no-slo-gate", action="store_true",
                    help="report SLO verdicts but exit 0 regardless "
                         "(default: exit with the line-rate SLO verdict: "
                         "0 OK, 1 breached, 2 unknown)")
    args = ap.parse_args(argv)
    report = run(windows=args.windows, window=args.window, batch=args.batch,
                 vocab=args.vocab, depth=args.depth, workers=args.workers,
                 devices=args.devices, throttle_factor=args.throttle_factor,
                 device=args.device)
    print(json.dumps(report))
    return 0 if args.no_slo_gate else report["slo_exit_code"]


if __name__ == "__main__":
    sys.exit(main())
