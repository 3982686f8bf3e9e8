#!/usr/bin/env python3
"""One run of one cell of the benchmark of `openembedding_tpu_torch`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. A training cell runs so:

1. Set-up: the pool of batches from the seed (`traffic.py`, the mix's
   file), the model from the configuration's file through the program's
   zoo recipe, a `Trainer` and its state, the benchmark's starting weights
   copied in (`reference/weights.py`), and the window driver
   `Trainer.jit_train_many()` (`CompiledStep`, one CUDA graph of K steps).
   Its first `check_windows` calls are the first steps of the very state
   the window then trains: the first call runs the K steps eagerly and
   captures them, the next ones replay the graph. What they leave is
   copied aside for the check. Then `warmup_windows` more replays.
2. The window: numpy windows of K batches fed to the driver (its copy into
   the graph's static buffers, `trainer.h2d`, is timed) in a closed loop
   for `--seconds`, ended on `torch.cuda.synchronize()`.
3. With `--trace 1`: a few more windows under the guarded profiler, and
   the per-layer metrics' readers (`metrics/<name>.py`).
4. The check, once the program's state is freed: the plain reference
   (`reference/`) follows the same first steps from the same weights and
   batches, and `judge.py` compares.

A cell on several cards runs steps 1-3 in one rank process a card
(`mesh.py`, a `parallel.MeshTrainer` over NCCL), each rank with its own
batches; this process then aggregates and runs the check.

The last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key. Without enough CUDA cards, or with `jax`, `jaxlib`,
`flax` or `openembedding_tpu` loaded once the window has closed, the run
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_T0_WALL = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _HERE in sys.path:
    sys.path.remove(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# Python's compiled bytecode, kept in a fixed directory of the checkout even
# where the environment asks for none (PYTHONDONTWRITEBYTECODE): without it
# every run compiles torch's Python sources anew, 8-11 s of each set-up on
# the card's machine. The first run of a checkout writes it, as it builds
# the kernels; the rank processes of a mesh inherit it. Only a run as a
# script sets it, not an import of this module.
PYCACHE = os.path.join(_ROOT, "benchmark_pycache")
if __name__ == "__main__":
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import judge, profiling, spec, traffic  # noqa: E402
from benchmark.reference import weights as W  # noqa: E402

# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "openembedding_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, each compared
    whole (`openembedding_tpu_torch` is not `openembedding_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), for the log."""
    if dev.type != "cuda":
        return {"kind": "cpu", "power_limit": "none"}
    kind = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"kind": kind, "power_limit": out or "unknown"}


def pin(windows: list) -> list:
    """The pool's windows moved into page-locked host memory, still numpy
    arrays: the host's copy engine reads them directly, as it reads a
    data pipeline's pinned staging buffers, so a window's copy does not
    wait on a pageable staging copy whose speed follows the host's other
    load."""
    def leaf(a):
        t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                        pin_memory=True)
        out = t.numpy()
        out[...] = a
        return out
    return [{"sparse": {k: leaf(v) for k, v in w["sparse"].items()},
             "dense": leaf(w["dense"]), "label": leaf(w["label"])}
            for w in windows]


def unique_counts(windows, dev) -> list:
    """Distinct ids of every pool batch, counted on `dev`."""
    out = []
    for w in windows:
        ids = torch.from_numpy(w["sparse"]["categorical"]).to(dev)
        out += [int(torch.unique(ids[k]).numel())
                for k in range(ids.shape[0])]
    return out


class Context:
    """What a per-layer metric's reader reads: the cell's parts, the traced
    window (`trace`, None when no session kept its brackets), which pool
    batches the traced steps trained (`traced_batches`), each pool batch's
    distinct ids (`unique`), the untraced window's seconds a step
    (`step_seconds`), the card (`kind`, `power_limit`), the rank's `mesh`
    (None on one card) and the program's live objects (`program`: trainer,
    state, step, windows)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def train_part(bench: dict, cell: str, parts: dict, seed: int,
               seconds: float, trace: bool, dev: torch.device,
               bench_dir: str, t0_wall: float, mesh=None) -> dict:
    """The program's side of a run on one card (on a `mesh`, this rank's
    side): set-up, the first steps copied aside, the window, and with
    `trace` the per-layer readers -> {"snap", "batches" (the check's
    batches), "setup_s", "steps", "elapsed", "metrics" (per-layer),
    "device", "breakdown"}."""
    from benchmark import program
    wl, cfg, mix = parts["workload"], parts["config"], parts["traffic"]
    rank = -1 if mesh is None else mesh.rank
    log(f"set-up: imports at {time.time() - t0_wall:.3f} s")
    torch.empty(1, device=dev)
    log(f"set-up: imports and the card's context at "
        f"{time.time() - t0_wall:.3f} s")
    k, b = mix["window"], mix["batch_size"]
    nf, nd = mix["num_fields"], mix["dense_dim"]
    cw, wu = mix["check_windows"], mix["warmup_windows"]
    t = time.perf_counter()
    windows = traffic.make_pool(mix, cfg, seed, rank)
    if dev.type == "cuda":
        windows = pin(windows)
    log(f"set-up: pool of {mix['pool_batches']} batches in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    trainer, state = program.build(cfg, traffic.batch_of(windows, 0), dev,
                                   mesh)
    program.load_weights(state, cfg, seed, nd, nf, rank)
    _sync(dev)
    log(f"set-up: model, state and weights in {time.perf_counter() - t:.3f} s")
    dense0 = W.dense_params(cfg, nd, nf, seed, dev)
    step = trainer.jit_train_many()
    t = time.perf_counter()
    losses = []
    for w in range(cw):
        state, m = step(state, windows[w])
        losses.append(m["loss"].clone())
    _sync(dev)
    log(f"set-up: first {cw} windows (capture) in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    touched = None
    if not cfg["hashed"]:
        touched = np.unique(np.concatenate(
            [windows[w]["sparse"]["categorical"].reshape(-1)
             for w in range(cw)]))
    stray = W.stray_sample(W.table_rows(cfg), mix["stray_rows"], seed, dev,
                           max(rank, 0))
    snap = program.snapshot(state, cfg, losses, touched, stray, dense0,
                            max(rank, 0) * W.table_rows(cfg))
    t_check = time.perf_counter() - t
    log(f"check: the first {cw * k} steps copied aside in {t_check:.3f} s "
        "(not set-up)")
    nwin = len(windows)
    t = time.perf_counter()
    for w in range(wu):
        step(state, windows[(cw + w) % nwin])
    _sync(dev)
    t_warm = (time.perf_counter() - t) / wu
    setup_s = time.time() - t0_wall - t_check
    log(f"set-up: {setup_s:.4f} s; graph launches a window: "
        f"{step.graph_launches}")

    i, done = cw + wu, 0
    if mesh is None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            step(state, windows[i % nwin])
            i += 1
            done += 1
        _sync(dev)
        elapsed = time.perf_counter() - t0
    else:
        # the ranks run one count of windows, rank 0's warm-up pace over
        # the seconds asked, between two barriers
        count = torch.tensor([max(1, round(seconds / t_warm))], device=dev)
        torch.distributed.broadcast(count, 0)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(int(count.item())):
            step(state, windows[i % nwin])
            i += 1
            done += 1
        _sync(dev)
        torch.distributed.barrier()
        elapsed = time.perf_counter() - t0
    steps = done * k
    log(f"window: {done} windows, {steps} steps, {steps * b} examples in "
        f"{elapsed:.4f} s on this card")
    card = card_info(dev)
    log(f"card: {card['kind']}, power limit {card['power_limit']}")
    uniq = unique_counts(windows, dev)
    log(f"pool: distinct ids a batch min {min(uniq)} median "
        f"{statistics.median(uniq)} max {max(uniq)} of {nf * b}")
    out = {"snap": snap, "setup_s": setup_s, "steps": steps,
           "elapsed": elapsed, "metrics": {}, "breakdown": None,
           "batches": [traffic.batch_of(windows, s) for s in range(cw * k)],
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": card["kind"]}}
    if trace:
        traced = [(i + j) % nwin for j in range(cfg["trace_windows"])]

        def fn():
            for j in traced:
                step(state, windows[j])

        tr = profiling.traced(fn) if dev.type == "cuda" else None
        ctx = Context(workload=wl, config=cfg, traffic=mix, trace=tr,
                      traced_batches=[j * k + s for j in traced
                                      for s in range(k)],
                      unique=uniq, step_seconds=elapsed / steps,
                      kind=card["kind"], power_limit=card["power_limit"],
                      device=dev, log=log, mesh=mesh,
                      program={"trainer": trainer, "state": state,
                               "step": step, "windows": windows})
        for mdef in spec.per_layer(bench, cell):
            v = spec.reader(mdef["name"], bench_dir).read(ctx)
            if v is not None:
                out["metrics"][mdef["name"]] = v
        del ctx
        if tr is not None:
            out["device"]["busy_s"] = profiling.busy_us(tr) * 1e-6
            out["device"]["window_s"] = profiling.window_us(tr) * 1e-6
            out["breakdown"] = profiling.breakdown(tr)
            log(f"trace: {len(tr['device'])} device records in "
                f"{out['device']['window_s']:.6f} s, {tr['sessions']} "
                "session(s)")
    out["device"]["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else 0)
    log(f"memory: peak {out['device']['memory_peak_bytes']} bytes allocated")
    if cfg["hashed"]:  # read once the peak is: its mask is not the program's
        held = int((state.tables[program.TABLE].keys >= 0).sum())
        log(f"table: {held} of {W.table_rows(cfg)} slots held after the "
            f"window (load {held / W.table_rows(cfg):.6f})")
    return out


def run(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: str = spec.ROOT,
        bench_dir: str = spec.BENCH_DIR) -> dict:
    """One run of `cell` -> the result object (without printing it). A cell
    on several cards runs one rank process a card (`mesh.py`); this
    process then holds no card until the ranks have ended."""
    parts = spec.cell_parts(bench, cell, root, bench_dir)
    wl, cfg, mix = parts["workload"], parts["config"], parts["traffic"]
    chips = wl["chips"]
    if chips == 1:
        parts_out = [train_part(bench, cell, parts, seed, seconds, trace,
                                torch.device(device), bench_dir, _T0_WALL)]
    else:
        from benchmark import mesh
        parts_out = mesh.run_ranks(chips, device, dict(
            bench=bench, cell=cell, parts=parts, seed=seed, seconds=seconds,
            trace=trace, bench_dir=bench_dir, t0_wall=_T0_WALL))
    gc.collect()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r0 = parts_out[0]
    k, b = mix["window"], mix["batch_size"]
    steps = r0["steps"]
    out = {"correct": False, "attempted": steps * chips, "failed": 0}
    if trace:
        names = [m["name"] for m in spec.per_layer(bench, cell)]
        metrics = {}
        for n in names:
            vals = [p["metrics"][n] for p in parts_out if n in p["metrics"]]
            if len(vals) == chips:
                if chips > 1:
                    log(f"{n} by rank: {vals}")
                unit = next(m["unit"] for m in bench["per_layer"]
                            if m["name"] == n)
                metrics[n] = {"value": sum(vals) / chips, "unit": unit}
        if r0["breakdown"] is not None:
            out["breakdown"] = r0["breakdown"]
    else:
        rate = steps * b * chips / r0["elapsed"]
        setup_s = max(p["setup_s"] for p in parts_out)
        log(f"window: {rate:.1f} examples/s over {chips} card(s)")
        metrics = {"examples_per_s": {"value": rate, "unit": "examples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        names = {m["name"] for m in spec.end_to_end(bench, cell)}
        metrics = {n: v for n, v in metrics.items() if n in names}
    device_out = dict(r0["device"], count=chips, memory_peak_bytes=max(
        p["device"]["memory_peak_bytes"] for p in parts_out))
    for key in ("busy_s", "window_s"):
        if all(key in p["device"] for p in parts_out):
            device_out[key] = sum(p["device"][key] for p in parts_out) / chips
    t = time.perf_counter()
    reference = importlib.import_module(
        f"benchmark.reference.{cfg['reference']}")
    if chips == 1:
        snap = r0["snap"]
        ref = reference.train(cfg, r0["batches"], seed, dev,
                              stray_n=mix["stray_rows"])
    else:
        from benchmark import program
        snap = program.join([p["snap"] for p in parts_out])
        ref = reference.train_sharded(
            cfg, [p["batches"] for p in parts_out], seed, dev, shards=chips,
            wire=cfg["wire"], stray_n=mix["stray_rows"])
    values = judge.numbers(snap, ref, cfg)
    ok, checks = judge.verdict(values, cfg["limits"])
    if not ok:
        for line in judge.explain(snap, ref, cfg):
            log(line)
    log(f"check: reference and comparison in {time.perf_counter() - t:.3f} s")
    out.update(correct=ok, metrics=metrics, device=device_out)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count()} available: no result")
        return 2
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
