"""Kernel micro-benchmark of the port: the port of `tools/pallas_microbench.py`.

    python -m openembedding_tpu_torch.microbench [--device cpu]

On the CUDA card (the default), with n = 26 x 4096 = 106,496 ids, for a
dim-64 table of 2^22 rows and a dim-128 table of 2^21 rows, each with an
Adagrad(0.05) accumulator:

- gather: the `gather_rows` kernel on uniform ids against its plain version
  and one library call computing the same function (`index_select` +
  `where`, which the port never calls);
- window gather: `gather_rows_windows` (one launch) on sorted uniform ids
  and on sorted ids drawn from the first 10% of the table, each at window
  16 and 64: the kernel, its plain version, the gather kernel and the
  library call on the same ids; what the launch stages (runs, rows,
  bytes; `gather_windows.staged_bytes`) and, on the card, the kernel's
  time under three staging rules (none, dense runs, every run);
- apply: the `fused_sparse_apply` kernel on the deduplicated update of n
  uniform ids, against its plain version and `torch.optim.Adagrad` on the
  same coalesced sparse gradient (which the port never calls), and the
  whole `sparse_apply_dense_table` (dedup + kernel);

then the train step of `make_deepfm(vocabulary=2^22, dim=9)` at batch 4096
on one `synthetic_criteo(4096, id_space=2^14, seed=7, ids_dtype=int32)`
batch, 30 timed steps after 4 untimed ones, through `Trainer.jit_train_step`
(kernels, CUDA graph), eager `train_step` (kernels) and eager with the plain
versions; the three runs start from one state and must end bit-equal.

Unlike the JAX tool, every kernel runs at both widths (the CUDA kernels
take any width), every kernel result is held bit-equal to its plain version
(a mismatch raises, so the exit code is non-zero), and each measurement
prints as one JSON line. Kernel times are device times from CUDA events
(`device_ms`); train steps are wall time ending in a synchronize. Bounds
take each input byte read once and each output byte written once at the
card's 3.35 TB/s.

`--device cpu` shrinks the shapes as the JAX tool's `--interpret` does
(tables of 2^14 rows, n 2048, batch 256, 5 timed steps) and runs the plain
versions (the wrappers' path for CPU tensors); its times are host-clock
times on the CPU, not device times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import data, optimizers
from .device import resolve_device
from .model import Trainer, dense_leaves
from .models import make_deepfm
from .ops import apply, gather, gather_windows, plain_versions, sparse

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
WINDOWS = (16, 64)
# the window gather's staging rule at three settings: none stages, the
# dense runs stage (half their span requested), every run of 2+ rows does
STAGE_SHARES = (float("inf"), 0.5, 0.0)


class MismatchError(RuntimeError):
    """A kernel disagreed with its plain version."""


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers (4-byte -> int32, 2-byte -> int16)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(bits(got), bits(want)):
        err = (float((got.float() - want.float()).abs().max())
               if got.shape == want.shape else "shape")
        raise MismatchError(f"{what}: not bit-equal (max abs err {err}, "
                            f"shapes {tuple(got.shape)} {tuple(want.shape)})")


def device_ms(fn: Callable[[], object], samples: int = 25,
              spin_cycles: int = 2_000_000,
              before: Optional[Callable[[], object]] = None) -> float:
    """Median device time of one `fn()` over `samples` CUDA-event-timed
    calls. A spin kernel runs first so the host has enqueued the start event
    and all of `fn`'s work before the device reaches them: the events then
    time the device work alone, not the host's launch overhead. `before`,
    if given, runs ahead of the spin kernel of each call, untimed (to empty
    L2, say)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn: Callable[[], object], iters: int = 3) -> float:
    """Wall time per call on the host (the CPU run's only clock)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def gather_bytes(ids: np.ndarray, id_itemsize: int, valid, n_rows: int,
                 dim: int, itemsize: int) -> dict:
    """Bytes a gather must move for these inputs: the rows it reads (only
    in-range, unmasked ids), every output row written, the ids, the mask.
    `sector_read_bytes` counts the 32-byte sectors each row read touches."""
    ok = (ids >= 0) & (ids < n_rows)
    if valid is not None:
        ok &= valid
    row = dim * itemsize
    start = ids[ok] * row
    sectors = (start + row - 1) // 32 - start // 32 + 1
    n = ids.shape[0]
    read = int(ok.sum()) * row
    write = n * row
    other = n * id_itemsize + (n if valid is not None else 0)
    return {"useful_bytes": read + write + other,
            "sector_read_bytes": int(sectors.sum()) * 32,
            "read_bytes": read, "write_bytes": write}


def apply_bytes(rows: np.ndarray, counts: np.ndarray, n_rows: int, dim: int,
                itemsize: int, slot_widths) -> dict:
    """Bytes the fused apply must move for these inputs: for each live slot
    (count > 0, row in range) its weight row and every slot row read and
    written and its gradient row read; every slot's id and count read.
    `sector_bytes` counts the 32-byte sectors the table and slot rows touch
    in place of their exact bytes."""
    live = (counts > 0) & (rows >= 0) & (rows < n_rows)
    r = rows[live].astype(np.int64)
    widths = [dim * itemsize] + [4 * w for w in slot_widths]

    def sectors(row_bytes):
        start = r * row_bytes
        return int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())

    table = 2 * len(r) * sum(widths)
    table_sectors = 2 * 32 * sum(sectors(w) for w in widths)
    other = len(r) * dim * 4 + rows.shape[0] * (rows.itemsize + 4)
    return {"live_rows": int(len(r)), "useful_bytes": table + other,
            "sector_bytes": table_sectors + other}


def state_bits(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a TrainState (tables, slots, a hash table's keys and
    overflow counter, a mesh table's residuals, hot cache and migration
    directory and annex, dense parameters, sparse_as_dense tables and their
    slots) by name."""
    out = {}
    for name, t in state.tables.items():
        out[f"{name}/weights"] = t.weights
        out.update({f"{name}/{k}": v for k, v in t.slots.items()})
        if t.keys is not None:
            out[f"{name}/keys"] = t.keys
            out[f"{name}/overflow"] = t.overflow
        if t.ef is not None:
            out[f"{name}/ef"] = t.ef
        for kind in ("hot", "mig"):
            part = getattr(t, kind)
            if part is not None:
                out.update({f"{name}/{kind}/{k}": v for k, v in vars(
                    part).items() if k != "slots"})
                out.update({f"{name}/{kind}/{k}": v
                            for k, v in part.slots.items()})
    for pname, p in dense_leaves(state.dense, state.embeddings):
        out[f"dense/{pname}"] = p.detach()
    for pname, slots in state.dense_slots.items():  # or the ZeRO flat form
        out.update({f"dense/{pname}/{k}": v for k, v in slots.items()})
    return out


def library_gather(w: torch.Tensor, ids: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gather's function through library calls: index_select of the
    clamped ids, zeros where an id is out of range or masked out (a
    yardstick only; the port never calls it)."""
    n_rows = w.shape[0]
    ok = (ids >= 0) & (ids < n_rows)
    if valid is not None:
        ok = ok & valid
    rows = torch.index_select(w, 0, ids.clamp(0, n_rows - 1))
    return torch.where(ok[:, None], rows, 0.0)


def library_adagrad(opt, w: torch.Tensor, idx: torch.Tensor,
                    g: torch.Tensor, counts: torch.Tensor
                    ) -> Callable[[], None]:
    """One `torch.optim.Adagrad` step on a copy of `w` with the coalesced
    sparse gradient of the live rows, as a callable (a yardstick only: it
    divides g by the root before multiplying by lr, so it is not bit-equal
    to the rule, and the port never calls it)."""
    live = counts > 0
    param = torch.nn.Parameter(w.clone())
    grad = torch.sparse_coo_tensor(idx[live][None], g[live], param.shape,
                                   check_invariants=False).coalesce()
    lib_opt = torch.optim.Adagrad(
        [param], lr=opt.learning_rate,
        initial_accumulator_value=opt.initial_accumulator_value,
        eps=opt.epsilon)

    def step():
        param.grad = grad
        lib_opt.step()

    return step


class _Bench:
    """Timing and printing for one run on one device."""

    def __init__(self, device: torch.device, out: List[dict]):
        self.device = device
        self.cuda = device.type == "cuda"
        self.name = (torch.cuda.get_device_name(device) if self.cuda
                     else "cpu")
        self.out = out

    def ms(self, fn: Callable[[], object]) -> float:
        return device_ms(fn) if self.cuda else host_ms(fn)

    def emit(self, rec: dict) -> dict:
        """Print one record as a JSON line, with the device it ran on and
        its clock (CUDA events unless the record names another)."""
        rec = {"timer": "cuda_events" if self.cuda else "host_clock", **rec,
               "device": self.name}
        print(json.dumps(rec), flush=True)
        self.out.append(rec)
        return rec


def bench_dim(b: _Bench, dim: int, vocab: int, n: int, seed: int = 0
              ) -> None:
    dev = b.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.randn((vocab, dim), generator=gen, device=dev)
    table = f"f32 {vocab}x{dim}"
    ids_np = rng.integers(0, vocab, n)
    ids = torch.from_numpy(ids_np).to(dev)
    nbytes = gather_bytes(ids_np, 8, None, vocab, dim, 4)
    bound = nbytes["useful_bytes"] / HBM_BYTES_PER_S * 1e3

    got = gather.gather_rows(w, ids)
    check_equal(f"gather_rows dim {dim}", got,
                gather.gather_rows_reference(w, ids))
    check_equal(f"library gather dim {dim}", library_gather(w, ids), got)
    b.emit({"bench": "gather", "table": table, "n": n, "ids": "uniform",
            "bit_equal": True,
            "ms": b.ms(lambda: gather.gather_rows(w, ids)),
            "plain_ms": b.ms(lambda: gather.gather_rows_reference(w, ids)),
            "library_ms": b.ms(lambda: library_gather(w, ids)),
            "bound_ms": bound, **nbytes})

    # window-batched gather on sorted ids at two densities: uniform (about
    # one row per window) and the hottest 10% of the table (the shape of
    # frequency-relabeled ids, where rows share windows)
    for label, ids_np in (
            ("uniform", np.sort(ids_np)),
            ("hot10%", np.sort(rng.integers(0, max(vocab // 10, 1), n)))):
        rows = torch.from_numpy(ids_np).to(dev)
        per_row = gather.gather_rows(w, rows)
        nbytes = gather_bytes(ids_np, 8, None, vocab, dim, 4)
        for window in WINDOWS:
            got = gather_windows.gather_rows_windows(w, rows, window=window)
            what = f"gather_rows_windows dim {dim} {label} W {window}"
            check_equal(what, got, gather_windows.gather_rows_windows_reference(
                w, rows, window=window))
            check_equal(what + " vs gather_rows", got, per_row)
            rec = {"bench": "gather_windows", "table": table, "n": n,
                   "ids": f"sorted {label}", "window": window,
                   "bit_equal": True,
                   "ms": b.ms(lambda: gather_windows.gather_rows_windows(
                       w, rows, window=window)),
                   "plain_ms": b.ms(
                       lambda: gather_windows.gather_rows_windows_reference(
                           w, rows, window=window)),
                   "gather_rows_ms": b.ms(
                       lambda: gather.gather_rows(w, rows)),
                   "library_ms": b.ms(lambda: library_gather(w, rows)),
                   "bound_ms": nbytes["useful_bytes"] / HBM_BYTES_PER_S
                   * 1e3, "useful_bytes": nbytes["useful_bytes"],
                   "staged_by_share": {}}
            for share in STAGE_SHARES:
                st = gather_windows.staged_bytes(
                    ids_np, vocab, dim * 4, window=window, stage_share=share,
                    base_offset=w.data_ptr() % 16)
                rec["staged_by_share"][str(share)] = st._asdict()
                if b.cuda:  # the rule changes the kernel's reads only
                    check_equal(f"{what} stage_share {share}",
                                gather_windows.gather_rows_windows(
                                    w, rows, window=window,
                                    stage_share=share), got)
                    rec.setdefault("ms_by_share", {})[str(share)] = b.ms(
                        lambda: gather_windows.gather_rows_windows(
                            w, rows, window=window, stage_share=share))
            b.emit(rec)
        del per_row

    # the fused apply on one deduplicated update of n uniform ids
    opt = optimizers.Adagrad(learning_rate=0.05)
    accum = opt.init_slots(vocab, dim, device=dev)["accum"]
    grads = torch.randn((n, dim), generator=gen, device=dev)
    g, counts, idx = sparse._dedup_routed(vocab, ids, grads, None)
    w2, accum2 = w.clone(), accum.clone()
    apply.fused_sparse_apply(opt, w, {"accum": accum}, idx, g, counts)
    apply.fused_sparse_apply_reference(opt, w2, {"accum": accum2}, idx, g,
                                       counts)
    check_equal(f"fused_sparse_apply dim {dim} weights", w, w2)
    check_equal(f"fused_sparse_apply dim {dim} accum", accum, accum2)
    del w2, accum2
    nbytes = apply_bytes(idx.cpu().numpy(), counts.cpu().numpy(), vocab, dim,
                         4, [dim])
    slots = {"accum": accum}
    b.emit({"bench": "apply", "table": f"{table} + accum", "n": n,
            "ids": "uniform", "optimizer": "adagrad", "bit_equal": True,
            "ms": b.ms(lambda: apply.fused_sparse_apply(
                opt, w, slots, idx, g, counts)),
            "plain_ms": b.ms(lambda: apply.fused_sparse_apply_reference(
                opt, w, slots, idx, g, counts)),
            "library_ms": b.ms(library_adagrad(opt, w, idx, g, counts)),
            "with_dedup_ms": b.ms(lambda: sparse.sparse_apply_dense_table(
                opt, w, slots, ids, grads)),
            "bound_ms": nbytes["useful_bytes"] / HBM_BYTES_PER_S * 1e3,
            **nbytes})


def bench_train(b: _Bench, vocab: int, batch_size: int, iters: int) -> None:
    """The train step through the graph, eager and plain; all three end in
    the same state, bit for bit."""
    model = make_deepfm(vocabulary=vocab, dim=9)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                      device=b.device)
    batch = next(data.synthetic_criteo(batch_size, id_space=1 << 14, steps=1,
                                       seed=7, ids_dtype=np.int32))
    state0 = trainer.init(batch)
    finals = {}
    for mode in ("graph", "eager", "plain"):
        state = state0.clone()
        step = trainer.jit_train_step() if mode == "graph" else \
            trainer.train_step
        with plain_versions() if mode == "plain" else nullcontext():
            for _ in range(4):  # untimed; the graph's first call captures
                state, m = step(state, batch)
            if b.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, m = step(state, batch)
            loss = float(m["loss"])  # waits for the last step
            dt = (time.perf_counter() - t0) / iters
        rec = {"bench": "train_step", "mode": mode,
               "model": f"deepfm vocab {vocab} dim 9 hidden 400-400-400",
               "batch": batch_size, "steps": iters, "ms": dt * 1e3,
               "examples_per_s": batch_size / dt, "loss": loss,
               "timer": "host_clock"}
        if mode == "graph":
            rec.update(captures=step.captures, replays=step.replays,
                       graph_launches=step.graph_launches,
                       launches_captured=dict(step.launches_captured),
                       launches_replayed=dict(step.launches_replayed))
        b.emit(rec)
        finals[mode] = state
    want = state_bits(finals["eager"])
    for mode in ("graph", "plain"):
        got = state_bits(finals[mode])
        for k in want:
            check_equal(f"train step {mode} vs eager: {k}", got[k], want[k])


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the benchmark; returns the records it printed. Raises on the
    first mismatch."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the shrunk run of the plain versions "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: List[dict] = []
    b = _Bench(dev, out)
    small = dev.type == "cpu"
    head = {"bench": "device", "torch": torch.__version__}
    if b.cuda:
        head["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[dev.index or 0]
    b.emit(head)
    n = 2048 if small else 26 * 4096
    bench_dim(b, 64, 1 << (14 if small else 22), n)
    bench_dim(b, 128, 1 << (14 if small else 21), n)
    if b.cuda:
        torch.cuda.empty_cache()
    bench_train(b, 1 << (14 if small else 22), 256 if small else 4096,
                5 if small else 30)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
