"""Criteo CTR training: the port of `examples/criteo_deepctr.py`, on one
device or, with `--mesh`, over the ranks of a `torch.distributed` group.

    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --data day_0.tsv --vocabulary 16777216 --prefetch --steps 1000
    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --device cpu --data examples/train100.tsv --batch-size 32 \\
        --vocabulary 1000 --steps 10
    torchrun --nproc-per-node 4 -m \\
        openembedding_tpu_torch.examples.criteo_deepctr --mesh \\
        --data day_0.tsv --vocabulary 16777216 --steps 1000

A CTR model of the zoo (`--model`: lr, wdl, deepfm, xdeepfm, dcn or dlrm;
two_tower, sasrec and bert4rec have batches of their own and are refused,
as the JAX entry point refuses two_tower) at the JAX
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
  --offload SLOTS  the table bigger than the card: a SLOTS-slot hashed
                device cache in front of the whole table in host RAM
                (storage="host_cached", `tables/host_offload.py`): each
                step's ids are admitted first (`Trainer.offload_prepare`,
                fed the host batch), a --scan window's union at once
                (`offload_train_many`); --save, --export and --persist
                write the host store. Not with --cache.
  --persist ROOT    the reference's pmem AutoPersist: an async persist every
                --persist-steps steps (`persist.AsyncPersister`), or with
                --persist-incremental a full base and touched-row deltas
                between (`persist.IncrementalPersister`); restore with
                `persist.restore_server_model`. Under --mesh every rank
                persists its shards and rank 0 commits. The persister
                observes each trained batch as the host read it (never the
                card's prefetched copy) and closes before the rates print.
  --mesh        `parallel.MeshTrainer` over the world group (tables
                row-sharded, the batch data-parallel): under torchrun S
                ranks, NCCL on cards (rank r on cuda:<LOCAL_RANK>), gloo on
                the CPU; with no launcher a one-rank group. Every rank reads
                the same stream and keeps its rows (`multihost.local_batch`,
                so --batch-size is the global batch). --capacity-factor and
                --on-overflow size and govern the exchange buckets (the
                drops are checked every 20 steps and every window).
                --save/--load write and read the sharded checkpoint; --export
                writes it too, and rank 0 exports from it.

It prints the loss every 20 steps, then examples/s, the train AUC and the
paths it wrote. The JAX script's flags whose modules the port lacks raise
NotImplementedError naming their ROADMAP.md item. `main(argv)` returns what
the run made (state, losses, rates), for callers that check it.
"""

from __future__ import annotations

import argparse
import collections
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

# the JAX zoo's families; the retrieval and sequence ones have batch
# schemas of their own (`examples/two_tower_retrieval.py`, the sequence
# generators of `models/sequential.py`), not Criteo's
NOT_CTR = ("two_tower", "sasrec", "bert4rec")
FAMILIES = ("bert4rec", "dcn", "deepfm", "dlrm", "lr", "sasrec", "two_tower",
            "wdl", "xdeepfm")

# flag -> (its default, what is missing, the ROADMAP.md item)
NOT_PORTED = {
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
    ap.add_argument("--mesh", action="store_true",
                    help="MeshTrainer over the torch.distributed world "
                         "group (one rank without a launcher)")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--on-overflow", default="count",
                    choices=["count", "grow", "raise"])
    ap.add_argument("--offload", type=int, default=0, metavar="SLOTS",
                    help="train the table bigger than the card: a SLOTS-row "
                         "device cache, the whole table in host RAM "
                         "(storage='host_cached', tables/host_offload.py)")
    ap.add_argument("--persist", default="", metavar="ROOT",
                    help="async persist root dir")
    ap.add_argument("--persist-steps", type=int, default=50)
    ap.add_argument("--persist-incremental", action="store_true",
                    help="dirty-window persistence: deltas proportional to "
                         "the rows touched since the last persist "
                         "(persist.IncrementalPersister)")
    g = ap.add_argument_group("not ported (raise NotImplementedError)")
    g.add_argument("--report-interval", type=float, default=0.0)
    g.add_argument("--metrics-log", default="", metavar="PATH")
    g.add_argument("--profile", default="", metavar="DIR")
    g.add_argument("--flight-recorder", type=int, default=0, metavar="N")
    g.add_argument("--trace-dump", default="", metavar="PATH")
    g.add_argument("--skew-report", action="store_true")
    return ap


def build_model(args, recipe):
    """The zoo model of the recipe, its table sparse_as_dense under
    --cache, a host-cached hash table of --offload slots under
    --offload."""
    model = zoo.from_config(recipe)
    spec = model.specs["categorical"]
    if args.cache > 0 and args.vocabulary <= args.cache:
        model.specs["categorical"] = dataclasses.replace(
            spec, sparse_as_dense=True)
    if args.offload > 0:
        model.specs["categorical"] = dataclasses.replace(
            spec, input_dim=-1, capacity=args.offload,
            storage="host_cached", sparse_as_dense=False)
    return model


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
    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(args)
    if args.model in NOT_CTR:
        parser.error(f"{args.model} has its own batch schema; use the zoo "
                     "API directly")
    if args.mesh and args.export and not args.save:
        parser.error("--export under --mesh exports from the sharded "
                     "checkpoint: give --save too")
    if args.offload > 0 and args.cache > 0:
        parser.error("--cache (dense-mirrored) and --offload (host-cached) "
                     "are mutually exclusive")
    device = resolve_device(args.device)
    recipe = {"family": args.model, "vocabulary": args.vocabulary,
              "dim": args.dim}
    if args.model == "lr":
        recipe.pop("dim")  # LR's table is the 1-wide first-order weight
    model = build_model(args, recipe)
    if args.cache > 0 and args.vocabulary <= args.cache:
        print(f"cache mode: categorical ({args.vocabulary}) is "
              "dense-mirrored")
    if args.offload > 0:
        print(f"offload mode: {args.offload}-row device cache, the whole "
              "table in host RAM")
    opt = OPTIMIZERS[args.optimizer](args.learning_rate)
    mesh = None
    if args.mesh:
        from ..parallel import MeshTrainer, make_mesh, multihost
        multihost.initialize("nccl" if device.type == "cuda" else "gloo")
        mesh = make_mesh(device=args.device)
        trainer = MeshTrainer(model, opt, mesh=mesh,
                              capacity_factor=args.capacity_factor,
                              on_overflow=args.on_overflow)
        print(f"mesh: rank {mesh.rank} of {mesh.size} ({mesh.backend}, "
              f"{mesh.device}), tables row-sharded, batch data-parallel")
    else:
        trainer = Trainer(model, opt, device=device)

    if args.data:
        # native="on": a reader that does not build fails the run
        rows = read_criteo_tsv(args.data, args.batch_size,
                               id_space=args.vocabulary, drop_remainder=True,
                               repeat=True, native="on")
        batches = iter(CriteoBatcher(rows, args.batch_size))
    else:
        batches = synthetic_criteo(args.batch_size, id_space=args.vocabulary,
                                   ids_dtype=np.int32)
    if mesh is not None:
        batches = _local_batches(batches, mesh)
        device = mesh.device
    host = None
    if args.persist or args.offload:
        host = collections.deque()
        batches = _tap(batches, host)
    if args.prefetch:
        batches = prefetch_to_device(batches, device=device)
    try:
        return _train(args, model, trainer, batches, device, recipe, host)
    finally:
        batches.close()


def _tap(batches, host):
    """The batches, each also appended to `host` as the host read it: the
    host-cached table's admission and the persister read the trained
    batches from there, in order, whatever the prefetch holds on the
    card."""
    for b in batches:
        host.append(b)
        yield b


def _persisted(persister, read, state) -> None:
    """The host batches just trained (`read`), observed (an incremental
    persister), then the policy's persist."""
    if hasattr(persister, "observe"):
        for b in read:
            persister.observe(b)
    persister.maybe_persist(state)


def _take(host, steps: int) -> list:
    """The next `steps` host batches (none without a tap)."""
    return [host.popleft() for _ in range(steps)] if host is not None else []


def _local_batches(batches, mesh):
    """This rank's rows of every global batch."""
    from ..parallel.multihost import local_batch
    for b in batches:
        yield local_batch(b, mesh)


def _drops(m) -> torch.Tensor:
    """A step's or window's exchange drops, summed on the device (nothing
    read back): what `MeshTrainer.check_overflow` is fed."""
    parts = [v for k, v in m.get("stats", {}).items()
             if k.endswith("_overflow")]
    if "overflow" in m:
        parts.append(m["overflow"])
    return sum(p.to(torch.int64) for p in parts)


def _check_drops(trainer, pending) -> None:
    """Drive the mesh's overflow policy with the drops since the last
    check."""
    if trainer.check_overflow({"overflow": pending}):
        print(f"  exchange capacity grew to f={trainer.capacity_factor} "
              "(the graphs capture anew)")


def _train(args, model, trainer, batches, device, recipe, host) -> dict:
    mesh = getattr(trainer, "mesh", None) is not None
    offload = args.offload > 0
    first = next(batches)
    state = trainer.init(first)
    if args.load:
        state = trainer.load(state, args.load)
        print(f"resumed at step {state.step}")
    persister = None
    if args.persist:
        from ..persist import (AsyncPersister, IncrementalPersister,
                               PersistPolicy)
        cls = (IncrementalPersister if args.persist_incremental
               else AsyncPersister)
        persister = cls(trainer, model, args.persist,
                        policy=PersistPolicy(every_steps=args.persist_steps))

    losses, labels, scores = [], [], []
    t0 = time.perf_counter()
    if args.scan > 1:
        many = trainer.train_many if args.eager else trainer.jit_train_many()
        driver = many
        done, window = 0, [first]
        while done < args.steps:
            while len(window) < min(args.scan, args.steps - done):
                window.append(next(batches))
            read = _take(host, len(window))
            if offload:
                # one admission of the window's union, then the window
                state, m = trainer.offload_train_many(
                    state, stack_batches(window), driver=many)
            else:
                state, m = many(state, stack_batches(window))
            losses.append(m["loss"].clone())
            if persister is not None:
                _persisted(persister, read, state)
            if mesh:
                _check_drops(trainer, _drops(m))
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
        read = _take(host, 1)
        if offload:
            state = trainer.offload_prepare(state, read[0])
        state, m = step(state, first)
        losses.append(m["loss"].clone().reshape(1))
        if persister is not None:
            _persisted(persister, read, state)
        pending = _drops(m) if mesh else None
        _sync(device)
        t1, steady_steps = time.perf_counter(), args.steps - 1
        for i in range(1, args.steps):
            batch = next(batches)
            read = _take(host, 1)
            if offload:
                state = trainer.offload_prepare(state, read[0])
            state, m = step(state, batch)
            losses.append(m["loss"].clone().reshape(1))
            labels.append(batch["label"])
            scores.append(m["logits"].reshape(-1).clone())
            if persister is not None:
                _persisted(persister, read, state)
            if mesh:
                pending = pending + _drops(m)
            if i % 20 == 0:
                print(f"step {i}: loss {float(m['loss']):.4f}")
                if mesh:
                    _check_drops(trainer, pending)
                    pending = pending * 0
        loss = float(m["loss"])  # fences the device work
        if mesh:
            _check_drops(trainer, pending)
        mode = ""
    t2 = time.perf_counter()
    if persister is not None:
        persister.close()
        print(f"persisted {len(persister.history)} times -> {args.persist}")
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
        if mesh:
            # the whole tables on rank 0, from the sharded checkpoint
            if trainer.mesh.rank == 0:
                one = Trainer(build_model(args, recipe), trainer.optimizer,
                              device=device)
                whole = one.load(one.init(first), args.save)
                export_standalone(
                    whole, one.model, args.export,
                    offload_stores=one.offload_store_snapshots(whole))
                del one, whole
            from ..parallel.collectives import barrier
            barrier(trainer.mesh)
        else:
            export_standalone(
                state, model, args.export,
                offload_stores=trainer.offload_store_snapshots(state))
        print(f"standalone serving export -> {args.export}")
    return {"model": model, "trainer": trainer, "state": state,
            "driver": driver, "steps": trained,
            "losses": torch.cat(losses).cpu().numpy(), "loss": loss,
            "seconds": seconds, "examples_per_s": rate,
            "steady_steps": steady_steps, "steady_seconds": steady_seconds,
            "steady_examples_per_s": steady_rate, "train_auc": train_auc,
            "persist": args.persist or None, "persister": persister}


if __name__ == "__main__":
    main()
