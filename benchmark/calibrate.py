#!/usr/bin/env python3
"""The readings a training cell's limits are set from, at the cell's own size,
in one process (on several cards, one set of rank processes for all the
seeds):

- the program's: for each seed, a fresh model, state and window driver
  (`jit_train_many()`) given the seed's weights, driven through the run's
  first `check_windows` calls, and judged against the reference;
- the control's: the reference with its float32 state held in bfloat16,
  put in the program's place;
- planted faults': the reference trained on the first half of each batch,
  and on several cards the reference with no gradient crossing the ranks,
  each put in the program's place.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--out FILE]

Prints one JSON line per reading and writes them all to `--out`. Needs the
card, as a run does; the runs themselves never call this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _HERE in sys.path:
    sys.path.remove(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import judge, spec, traffic  # noqa: E402
from benchmark.reference import weights as W  # noqa: E402


def program_readings(cfg, mix, seed, dev, mesh=None):
    """The program's first steps from `seed` (on a `mesh`, this rank's
    side), copied aside -> the snapshot (`program.snapshot`) and the
    check's batches."""
    from benchmark import program
    rank = -1 if mesh is None else mesh.rank
    cw, k = mix["check_windows"], mix["window"]
    small = dict(mix, pool_batches=cw * k)
    windows = traffic.make_pool(small, cfg, seed, rank)
    trainer, state = program.build(cfg, traffic.batch_of(windows, 0), dev,
                                   mesh)
    program.load_weights(state, cfg, seed, mix["dense_dim"],
                         mix["num_fields"], rank)
    step = trainer.jit_train_many()
    losses = []
    for w in range(cw):
        state, m = step(state, windows[w])
        losses.append(m["loss"].clone())
    touched = None if cfg["hashed"] else np.unique(np.concatenate(
        [w_["sparse"]["categorical"].reshape(-1) for w_ in windows]))
    stray = W.stray_sample(W.table_rows(cfg), mix["stray_rows"], seed, dev,
                           max(rank, 0))
    dense0 = W.dense_params(cfg, mix["dense_dim"], mix["num_fields"], seed,
                            dev)
    snap = program.snapshot(state, cfg, losses, touched, stray, dense0,
                            max(rank, 0) * W.table_rows(cfg))
    del step, state, trainer, m
    gc.collect()
    torch.cuda.empty_cache()
    return snap, [traffic.batch_of(windows, s) for s in range(cw * k)]


def rank_readings(mesh, dev, cfg, mix, seeds):
    """One rank's side of the mesh's readings: [(snapshot, batches)] a
    seed."""
    return [program_readings(cfg, mix, seed, dev, mesh) for seed in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bench = spec.load()
    parts = spec.cell_parts(bench, args.workload)
    cfg, mix = parts["config"], parts["traffic"]
    reference = importlib.import_module(
        f"benchmark.reference.{cfg['reference']}")
    stray_n = mix["stray_rows"]
    rows = []

    def emit(kind, seed, values):
        row = {"cell": args.workload, "kind": kind, "seed": seed, **values}
        rows.append(row)
        print(json.dumps(row), flush=True)

    chips = parts["workload"]["chips"]
    faults = [("control_bf16_state", {"state_dtype": "bfloat16"}),
              ("fault_half_batch", {"half_batch": True})]
    if chips == 1:
        def readings(seed):
            return program_readings(cfg, mix, seed, dev)

        def follow(seed, batches, **kw):
            return reference.train(cfg, batches, seed, dev, stray_n=stray_n,
                                   **kw)
    else:
        from benchmark import mesh, program
        by_rank = mesh.run_ranks(chips, "cuda", dict(
            cfg=cfg, mix=mix, seeds=args.seeds),
            target="benchmark.calibrate:rank_readings", timeout_s=3000.0)
        faults.append(("fault_no_exchange", {"exchange": False}))

        def readings(seed):
            i = args.seeds.index(seed)
            return (program.join([r[i][0] for r in by_rank]),
                    [r[i][1] for r in by_rank])

        def follow(seed, batches, **kw):
            return reference.train_sharded(cfg, batches, seed, dev,
                                           shards=chips, wire=cfg["wire"],
                                           stray_n=stray_n, **kw)
    for seed in args.seeds:
        snap, batches = readings(seed)
        ref = follow(seed, batches)
        emit("program", seed, judge.numbers(snap, ref, cfg))
        if seed in args.control_seeds:
            for kind, kw in faults:
                other = follow(seed, batches, **kw)
                other["stray"] = {"w": other["stray"]["w0"],
                                  "acc": torch.full_like(
                                      other["stray"]["w0"],
                                      cfg["optimizer"][
                                          "initial_accumulator_value"])}
                emit(kind, seed, judge.numbers(other, ref, cfg))
        del snap, ref
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
