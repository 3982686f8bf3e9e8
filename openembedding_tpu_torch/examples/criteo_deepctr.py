"""Criteo CTR training on one device: the port of the single-device flow of
`examples/criteo_deepctr.py`.

    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --data day_0.tsv --vocabulary 16777216 --prefetch --steps 1000
    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --device cpu --data examples/train100.tsv --batch-size 32 \\
        --vocabulary 1000 --steps 10

A CTR model of the zoo (`--model`: lr, wdl, deepfm, xdeepfm, dcn or dlrm;
two_tower, sasrec and bert4rec are not ported yet and raise) at the JAX
entry point's defaults, with one folded table of `--vocabulary` rows
(`--dim` + 1 wide; LR's is 1 wide and takes no `--dim`), trained by
`Trainer` with `--optimizer` on Criteo TSV files (`--data`, parsed by the
native reader and rebatched by `CriteoBatcher`) or on the synthetic Zipfian
stream (`--synthetic`, the default without `--data`). Steps run through
`Trainer.jit_train_step` (a CUDA graph on the card), through
`Trainer.train_step` with `--eager`, or `--scan K` steps a window through
`jit_train_many` (`train_many` with `--eager`).

Flag map to the reference benchmark, as in the JAX script:
  --cache N     tables with vocabulary <= N become sparse_as_dense
  --prefetch    batches reach the card through pinned memory on a side stream
                (`data.prefetch_to_device`)
  --save/--load/--export  checkpoint, resume, standalone serving export

It prints the loss every 20 steps, then examples/s, the train AUC and the
paths it wrote. The JAX script's flags whose modules the port lacks raise
NotImplementedError naming their ROADMAP.md item. `main(argv)` returns what
the run made (state, losses, rates), for callers that check it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import models as zoo
from .. import optimizers
from ..data import (CriteoBatcher, prefetch_to_device, read_criteo_tsv,
                    synthetic_criteo)
from ..device import resolve_device
from ..model import Trainer
from ..utils.metrics import auc

OPTIMIZERS = {
    "adagrad": lambda lr: optimizers.Adagrad(learning_rate=lr),
    "adam": lambda lr: optimizers.Adam(learning_rate=lr),
    "ftrl": lambda lr: optimizers.Ftrl(learning_rate=lr),
    "sgd": lambda lr: optimizers.SGD(learning_rate=lr),
    "rmsprop": lambda lr: optimizers.RMSprop(learning_rate=lr),
}

# the JAX zoo's families; two_tower, sasrec and bert4rec raise in
# `models.from_config`
FAMILIES = ("bert4rec", "dcn", "deepfm", "dlrm", "lr", "sasrec", "two_tower",
            "wdl", "xdeepfm")

# flag -> (its default, what is missing, the ROADMAP.md item)
NOT_PORTED = {
    "mesh": (False, "the mesh path (MeshTrainer)", "3"),
    "capacity_factor": (0.0, "the mesh path's exchange buckets", "3"),
    "on_overflow": ("count", "the mesh path's exchange buckets", "3"),
    "offload": (0, "host-cached tables", "4"),
    "persist": ("", "persistence (persist.py)", "3"),
    "persist_steps": (50, "persistence (persist.py)", "3"),
    "persist_incremental": (False, "persistence (persist.py)", "3"),
    "report_interval": (0.0, "metrics reporting (utils/metrics)", "6"),
    "metrics_log": ("", "metrics reporting (utils/metrics)", "6"),
    "profile": ("", "the profiler trace of the train loop", "6"),
    "flight_recorder": (0, "the flight recorder (utils/trace)", "6"),
    "trace_dump": ("", "the flight recorder (utils/trace)", "6"),
    "skew_report": (False, "the skew sketches (utils/sketch)", "1.5 and 6"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m openembedding_tpu_torch.examples.criteo_deepctr",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="deepfm", choices=FAMILIES)
    ap.add_argument("--dim", type=int, default=9)
    ap.add_argument("--optimizer", default="adagrad",
                    choices=sorted(OPTIMIZERS))
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--vocabulary", type=int, default=1 << 22)
    ap.add_argument("--data", nargs="*", default=None,
                    help="Criteo TSV file(s), plain or .gz")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cache", type=int, default=0,
                    help="sparse_as_dense for vocab <= N (reference --cache)")
    ap.add_argument("--scan", type=int, default=0, metavar="K",
                    help="K steps per window through jit_train_many; "
                         "per-step logits (and so the train AUC) are not "
                         "collected in this mode")
    ap.add_argument("--prefetch", action="store_true",
                    help="pinned, double-buffered copy to the card on a side "
                         "stream (data.prefetch_to_device)")
    ap.add_argument("--eager", action="store_true",
                    help="run train_step / train_many eagerly instead of "
                         "their CUDA graphs (jit_train_step / "
                         "jit_train_many)")
    ap.add_argument("--save", default="")
    ap.add_argument("--load", default="")
    ap.add_argument("--export", default="",
                    help="standalone serving export dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must "
                         "be asked for)")
    g = ap.add_argument_group("not ported (raise NotImplementedError)")
    g.add_argument("--mesh", action="store_true")
    g.add_argument("--capacity-factor", type=float, default=0.0)
    g.add_argument("--on-overflow", default="count",
                   choices=["count", "grow", "raise"])
    g.add_argument("--offload", type=int, default=0, metavar="SLOTS")
    g.add_argument("--persist", default="")
    g.add_argument("--persist-steps", type=int, default=50)
    g.add_argument("--persist-incremental", action="store_true")
    g.add_argument("--report-interval", type=float, default=0.0)
    g.add_argument("--metrics-log", default="", metavar="PATH")
    g.add_argument("--profile", default="", metavar="DIR")
    g.add_argument("--flight-recorder", type=int, default=0, metavar="N")
    g.add_argument("--trace-dump", default="", metavar="PATH")
    g.add_argument("--skew-report", action="store_true")
    return ap


def _refuse_unported(args) -> None:
    for dest, (default, what, item) in NOT_PORTED.items():
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag}: {what} is not ported yet (ROADMAP.md item {item})")


def stack_batches(window: List[Dict]) -> Dict:
    """K batches -> one stacked batch (a leading K dim on every leaf), on
    the device the leaves are on."""
    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: stack([x[k] for x in leaves]) for k in leaves[0]}
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack(leaves)
    return stack(window)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    recipe = {"family": args.model, "vocabulary": args.vocabulary,
              "dim": args.dim}
    if args.model == "lr":
        recipe.pop("dim")  # LR's table is the 1-wide first-order weight
    model = zoo.from_config(recipe)
    if args.cache > 0 and args.vocabulary <= args.cache:
        spec = model.specs["categorical"]
        model.specs["categorical"] = dataclasses.replace(
            spec, sparse_as_dense=True)
        print(f"cache mode: categorical ({args.vocabulary}) is "
              "dense-mirrored")
    trainer = Trainer(model, OPTIMIZERS[args.optimizer](args.learning_rate),
                      device=device)

    if args.data:
        # native="on": a reader that does not build fails the run
        rows = read_criteo_tsv(args.data, args.batch_size,
                               id_space=args.vocabulary, drop_remainder=True,
                               repeat=True, native="on")
        batches = iter(CriteoBatcher(rows, args.batch_size))
    else:
        batches = synthetic_criteo(args.batch_size, id_space=args.vocabulary,
                                   ids_dtype=np.int32)
    if args.prefetch:
        batches = prefetch_to_device(batches, device=device)
    try:
        return _train(args, model, trainer, batches, device)
    finally:
        batches.close()


def _train(args, model, trainer, batches, device) -> dict:
    first = next(batches)
    state = trainer.init(first)
    if args.load:
        state = trainer.load(state, args.load)
        print(f"resumed at step {state.step}")

    losses, labels, scores = [], [], []
    t0 = time.perf_counter()
    if args.scan > 1:
        many = trainer.train_many if args.eager else trainer.jit_train_many()
        driver = many
        done, window = 0, [first]
        while done < args.steps:
            while len(window) < min(args.scan, args.steps - done):
                window.append(next(batches))
            state, m = many(state, stack_batches(window))
            losses.append(m["loss"].clone())
            if not done:  # the steady rate leaves out the first window
                _sync(device)
                t1 = time.perf_counter()
                steady_steps = args.steps - len(window)
            done += len(window)
            window = []
            print(f"step {done}: loss {float(m['loss'][-1]):.4f}")
        loss = float(m["loss"][-1])
        mode = f" (scan K={args.scan})"
    else:
        step = trainer.train_step if args.eager else trainer.jit_train_step()
        driver = step
        state, m = step(state, first)
        losses.append(m["loss"].clone().reshape(1))
        _sync(device)
        t1, steady_steps = time.perf_counter(), args.steps - 1
        for i in range(1, args.steps):
            batch = next(batches)
            state, m = step(state, batch)
            losses.append(m["loss"].clone().reshape(1))
            labels.append(batch["label"])
            scores.append(m["logits"].reshape(-1).clone())
            if i % 20 == 0:
                print(f"step {i}: loss {float(m['loss']):.4f}")
        loss = float(m["loss"])  # fences the device work
        mode = ""
    t2 = time.perf_counter()
    seconds, steady_seconds = t2 - t0, t2 - t1
    trained = args.steps
    rate = trained * args.batch_size / seconds
    steady_rate = (steady_steps * args.batch_size / steady_seconds
                   if steady_steps else float("nan"))
    print(f"trained {trained} steps{mode}, loss {loss:.4f}, {rate:,.0f} "
          f"examples/s ({steady_rate:,.0f} after the first "
          f"{'window' if mode else 'step'})")
    train_auc = None
    if labels:
        train_auc = auc(np.concatenate([_host(x) for x in labels]),
                        np.concatenate([_host(x) for x in scores]))
        print(f"train AUC {train_auc:.4f}")

    if args.save:
        trainer.save(state, args.save)
        print(f"checkpoint -> {args.save}")
    if args.export:
        from ..export import export_standalone
        export_standalone(state, model, args.export)
        print(f"standalone serving export -> {args.export}")
    return {"model": model, "trainer": trainer, "state": state,
            "driver": driver, "steps": trained,
            "losses": torch.cat(losses).cpu().numpy(), "loss": loss,
            "seconds": seconds, "examples_per_s": rate,
            "steady_steps": steady_steps, "steady_seconds": steady_seconds,
            "steady_examples_per_s": steady_rate, "train_auc": train_auc}


if __name__ == "__main__":
    main()
