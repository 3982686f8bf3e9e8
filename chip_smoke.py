#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`openembedding_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, exits non-zero and skips the
final line:

1. device  — the card's name and power limit (nvidia-smi), CUDA present;
2. build   — nvcc builds the three kernels, `csrc/gather_rows.cu`,
   `csrc/gather_rows_windows.cu` and `csrc/fused_sparse_apply.cu` (all
   three include the row-copy core's lane map `csrc/gather_core.cuh`), at
   the same time (one thread each); ptxas's registers and spills per kernel
   instance, the grids of the gather and of every apply instance (resident
   blocks, read once per card), a check that the window kernel's staging
   constants are the ones `ops/gather_windows.staged_bytes` mirrors, and
   one that `ops/apply.launch_plan` picks the kernel's word and tile
   (`oe_fused_sparse_apply_plan`) for every rule, widths 1 to 1024, both
   table types, and addresses and strides off every word boundary;
3. kernel  — the gather against its plain PyTorch version on the card at the
   serving path's shapes (a 2^24 x 10 float32 table, 4096 x 26 Zipfian ids
   with -1 pads and out-of-range ids; int32/int64 ids, with and without a
   mask; one bfloat16 table of width 64) and at the row-copy core's edges:
   rows of 36 bytes (float32 width 9) and 18 bytes (bfloat16 width 9), a
   table view 8-byte aligned (`w[1:]`), n not a multiple of the tile, and
   n = 1 (the floor of one launch). Every case must be bit-equal. Times:
   the kernel, the plain version, and one library call computing the same
   function (index_select + where, a yardstick the port never calls),
   beside the memory bound at 3.35 TB/s;
4. windows — the window-batched gather (one launch, no prepass) against
   its plain version and against the gather kernel, bit-equal, on the
   2^24 x 10 table with the sorted ids the dedup emits for one
   `synthetic_criteo(4096, id_space=2^24, seed=7)` batch (windows 16 and
   64), the dedup's ids of Zipf(1.1) ranks left unhashed
   (frequency-relabeled ids, whose dense head stages), unsorted Zipfian ids
   with -1 pads and out-of-range ids, unsorted ids with duplicates, a
   bfloat16 table, a table whose last window is partial, and a table
   smaller than the window (which goes through the gather kernel). Each
   case runs under three staging rules (none, dense runs, every run), all
   bit-equal, with what each stages (`staged_bytes`) and its time; after
   the last phase, torch.profiler must see one device kernel per call
   (traced after every timing, so that no timed phase runs after a
   profiler session). Times: the kernel, its plain version, the gather
   kernel and the library call, beside the byte bound;
5. apply   — the fused sparse apply against its plain version on the card.
   Main case: the 2^24 x 10 float32 table and its Adagrad accumulator,
   updated from one `synthetic_criteo(4096, id_space=2^24, seed=7)` batch
   deduplicated by `ops/sparse._dedup_routed`; every table and slot must be
   bit-equal after the same in-place update of two clones, and an update
   whose counts are all 0 must leave both bit-identical. Times: the kernel,
   its one-slot call (the floor of a launch) and its all-padding call (one
   coalesced count and id round per tile), the kernel and its one-slot
   call again with L2 emptied before each call (rows from DRAM, not from
   the L2 the timed calls leave them in), the plain version,
   `torch.optim.Adagrad` stepping on the same coalesced sparse gradient (a
   yardstick the port never calls), the bound from the bytes the update must move (and from
   the 32-byte sectors it touches). Packed cases: the gate
   (`ops/sparse.packed_layout`) refuses the table on the card; the same
   update through the packed weights+slots array (2^24 x 20 at width 10,
   2^22 x 128 at width 64) is bit-equal to the split arrays all the same,
   with the gather and the apply timed in both layouts and the pack and
   unpack that a packed window adds: the measurement behind the gate's
   refusal.
   Edge cases of the kernel's lane map, two updates each, bit-equal, with
   the launch plan checked against
   the kernel's: widths 1, 9, 10, 11, 16, 64 and 128 (words of 1, 2 and 4
   elements, partial tiles; int32 ids at two of them), bfloat16 tables of
   widths 10 and 16, RMSprop's slots as column views 4 and 8 bytes off a
   16-byte boundary (the columns between them untouched), a `w[1:]` view,
   n = 1 and n = 1001 slots, an update whose counts are all 0 (tables
   bit-identical), and Adam, Adamax and TestOptimizer (per-row state) at
   widths 10 and 64. Further cases: all nine optimizer rules on a small
   table with duplicates, -1 pads and out-of-range ids, a bfloat16 table
   with Adam (the 1-wide per-row slots), each bit-equal; Ftrl with
   learning_rate_power -0.7 (`powf`) within a stated tolerance. After the
   last phase, torch.profiler must see one device kernel per apply call;
6. serve   — the full-width DeepFM (`make_deepfm(vocabulary=1<<24, dim=9)`,
   random weights from a seed) exported, loaded by a REST server and driven
   through `ServingClient`: predict at batch 1, 100 and 4096 and a pull. The
   answers must equal the same servable's in-process forward with the plain
   gather in place of the kernel (tolerance 0: the gather is a copy and
   everything else is the same code on the same card), and the kernel's
   launch count must rise by one per table per predict and one per pull;
7. train   — the same DeepFM trained by `Trainer` with Adagrad(0.05) from a
   seeded init on `synthetic_criteo` batches of 4096: 24 eager
   `train_step`s and two eager `train_many` windows of 16 (split: the gate
   packs no table on the card); each step must launch exactly one gather
   and one apply per table. The
   same 56 steps from a clone of the initial state as eager `train_step`s
   with the plain versions swapped in must launch no kernel and give the
   same losses, tables, accumulators, dense parameters and dense slots, bit
   for bit (the gather is a copy, the apply is bit-equal, the segment sums
   keep one order, and cuBLAS runs with a fixed workspace). Then the same
   steps from another clone through the CUDA graphs: 24 `jit_train_step`
   calls and two `jit_train_many` windows of 16, bit-equal again; each
   captured step launches one gather and one apply per table, and the
   launches that ran (warm-ups and replays; a capture runs nothing) are
   one gather and one apply per table per step. Last, the two windows again,
   from the state after the 24 graph steps, through a `jit_train_many`
   whose gate packs the table: the packed layout the card's gate refuses,
   held bit-equal to the split steps and timed against them. Prints ex/s
   for each way of stepping, the profiler's device busy time, idle share
   and top device operations per step, and the peak device memory;
8. microbench — `openembedding_tpu_torch.microbench` at full size (its own
   JSON lines): every kernel at widths 64 and 128 against its plain version
   and a library call, and the train step through the graph, eager and
   plain. Its launches are counted as they ran: its graph's capture is
   taken out and its replays put in.

Then the `kernels` line, and last `{"ok": true, "device": {...}}`.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# cuBLAS picks its workspace per stream unless told otherwise, and results
# may then differ between runs; set before CUDA initializes
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

SEED = 0
VOCAB = 1 << 24          # the flagship table: 2^24 rows
DIM = 9                  # latent width; the folded table is DIM + 1 wide
BATCH = 4096
FIELDS = 26              # Criteo categorical fields
NUM_DENSE = 13           # Criteo dense fields
SIGN = "deepfm-smoke-0"
TRAIN_SEED = 7           # synthetic_criteo seed of bench.py's trainer case
TRAIN_STEPS = 24         # train_step calls; the first WARM_STEPS are untimed
WARM_STEPS = 4
MANY_STEPS = 16          # K of each train_many window
MANY_WINDOWS = 2         # the graph is captured on the first, replayed after
KERNELS = ("gather_rows", "gather_rows_windows", "fused_sparse_apply")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def zipf_ids(rng, n: int, vocab: int) -> np.ndarray:
    """Zipf(1.1) ranks scattered over the table, with 2% -1 pads and 1%
    out-of-range ids (all below 2^31, so the int32 cases see them too)."""
    ranks = rng.zipf(1.1, n) - 1
    ids = (ranks % vocab) * 2654435761 % vocab
    u = rng.random(n)
    ids[u < 0.02] = -1
    oor = (u >= 0.02) & (u < 0.03)
    ids[oor] = vocab + rng.integers(0, 1 << 20, int(oor.sum()))
    ids[:8] = [-1, vocab, vocab - 1, 0, (1 << 31) - 1, -(1 << 31), 5, vocab]
    return ids.astype(np.int64)


def make_batch(rng, n: int) -> dict:
    return {"sparse": {"categorical":
                       zipf_ids(rng, n * FIELDS, VOCAB).reshape(n, FIELDS)},
            "dense": rng.standard_normal((n, NUM_DENSE)).astype(np.float32)}


def host_ms(torch, fn, iters: int = 200) -> float:
    """Wall time per call of back-to-back calls ending in a synchronize:
    what a caller pays per call, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _gather_case(torch, mb, gather, tname, w, ids_host, id_dtype, valid_np,
                 dev) -> dict:
    """One gather case: the kernel bit-equal to its plain version, its
    time beside the plain version's, the library call's and the bound."""
    ids = torch.from_numpy(ids_host).to(dev, id_dtype)
    valid = (torch.from_numpy(valid_np).to(dev) if valid_np is not None
             else None)
    launches = gather.LAUNCHES["gather_rows"]
    got = gather.gather_rows(w, ids, valid)
    check(gather.LAUNCHES["gather_rows"] == launches + 1,
          "one gather_rows call is one kernel launch")
    want = gather.gather_rows_reference(w, ids, valid)
    torch.cuda.synchronize()
    equal = torch.equal(mb.bits(got), mb.bits(want))
    err = float((got.float() - want.float()).abs().max())
    n_rows = w.shape[0]
    nbytes = mb.gather_bytes(ids_host, ids.element_size(), valid_np, n_rows,
                             w.shape[1], w.element_size())
    rec = {
        "phase": "kernel", "case": tname,
        "table": f"{str(w.dtype).split('.')[-1]} {n_rows}x{w.shape[1]}",
        "table_address_mod_16": w.data_ptr() % 16,
        "ids": f"{ids.shape[0]} {str(id_dtype).split('.')[-1]}",
        "mask": valid is not None, "bit_equal": equal, "max_abs_err": err,
        "ms": mb.device_ms(lambda: gather.gather_rows(w, ids, valid)),
        "plain_ms": mb.device_ms(
            lambda: gather.gather_rows_reference(w, ids, valid)),
        "library_ms": mb.device_ms(lambda: mb.library_gather(w, ids, valid)),
        "host_ms_per_call": host_ms(
            torch, lambda: gather.gather_rows(w, ids, valid)),
        **nbytes,
        "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
        "sector_bound_ms": (nbytes["sector_read_bytes"]
                            + nbytes["useful_bytes"]
                            - nbytes["read_bytes"]) / mb.HBM_BYTES_PER_S
        * 1e3,
    }
    emit(rec)
    check(equal, f"gather_rows bit-equal to its plain version ({rec})")
    return rec


def phase_kernel(torch, mb, gather) -> dict:
    """Kernel vs plain version at the serving path's shapes and at the
    edges of the row-copy core (word widths, alignment, ragged tiles, the
    one-row launch floor); returns the main-path case (float32 table, int64
    ids, no mask) for the kernels line."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w32 = torch.randn((VOCAB, DIM + 1), generator=gen, device=dev)
    ids_np = zipf_ids(rng, BATCH * FIELDS, VOCAB)
    ids64_np = ids_np.copy()
    ids64_np[8:24] = (1 << 40) + np.arange(16)  # past int32, int64 only
    mask_np = rng.random(ids_np.shape[0]) < 0.9
    cases = [("main", w32, ids64_np, torch.int64, None),
             ("int32 ids", w32, ids_np, torch.int32, None),
             ("int32 ids, mask", w32, ids_np, torch.int32, mask_np),
             ("mask", w32, ids64_np, torch.int64, mask_np)]
    # uniform ids: no hot rows for L2 to keep, unlike the Zipfian cases
    uniform_np = rng.integers(0, VOCAB, ids_np.shape[0])
    cases.append(("uniform ids", w32, uniform_np, torch.int64, None))
    w16 = torch.randn((VOCAB, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    cases.append(("bf16 width 64: 16-byte words", w16, ids64_np, torch.int64,
                  None))
    # the core's other words: 36-byte rows move in 4-byte words, 18-byte
    # bfloat16 rows in 2-byte words, and a view that starts 40 bytes into
    # the table (8-byte aligned) in 8-byte words
    w9 = torch.randn((1 << 22, 9), generator=gen, device=dev)
    ids22_np = zipf_ids(rng, BATCH * FIELDS, 1 << 22)
    cases += [("f32 width 9: 4-byte words", w9, ids22_np, torch.int64, None),
              ("bf16 width 9: 2-byte words", w9.to(torch.bfloat16), ids22_np,
               torch.int64, None),
              ("view w[1:], 8-byte aligned", w32[1:], ids64_np, torch.int64,
               None),
              # n not a multiple of the 32-row tile, and one row: the
              # floor of one launch
              ("n = 1001", w32, ids64_np[:1001], torch.int64, None),
              ("n = 1: launch floor", w32, ids64_np[6:7], torch.int64, None)]
    main = None
    for tname, w, ids_host, id_dtype, valid_np in cases:
        rec = _gather_case(torch, mb, gather, tname, w, ids_host, id_dtype,
                           valid_np, dev)
        if tname == "main":
            main = rec
    return main


def device_kernels(torch, fn, tries: int = 3) -> tuple:
    """Names of the device kernels that one call of `fn` enqueues, as
    torch.profiler traces them, and the profiler sessions it took. Inside
    each session the call sits between two spin kernels (left out of the
    names), and the session ends a few ms after the last kernel: a short
    session of one call alone sometimes traced no device kernel on the
    H100. A session that sees no kernel but the spins is taken again: the
    card ran the call (its output is checked), so the trace lost it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10_000)
            fn()
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
            time.sleep(0.01)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "spin" not in e.name]
        if names:
            break
    return names, attempt


STAGE_SHARES = (float("inf"), 0.5, 0.0)  # none, dense runs, every run


def phase_windows(torch, mb, gather, gather_windows, sparse, data) -> dict:
    """The window gather against its plain version and the gather kernel,
    under three staging rules; returns the main case (the dedup's sorted
    ids, window 16, the default rule) and the calls `kernels_profile`
    traces once every timing is done."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    w32 = torch.randn((VOCAB, DIM + 1), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)

    def dedup(ids):
        # the ids the apply reads as the dedup emits them: the sorted
        # unique ids, then one distinct out-of-range id per padding slot
        return sparse._dedup_routed(
            VOCAB, ids, torch.zeros((ids.shape[0], 1), device=dev), None)[2]

    # Zipf(1.1) ranks left unhashed: frequency-relabeled ids, as the
    # reference's criteo_preprocess.cpp writes them; their head is dense
    ranks = rng.zipf(1.1, BATCH * FIELDS) - 1
    relabeled = dedup(torch.from_numpy(ranks % VOCAB).to(dev))
    zipf = torch.from_numpy(zipf_ids(rng, BATCH * FIELDS, VOCAB)).to(dev)
    w16 = torch.randn((VOCAB, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    small = torch.randn((8, DIM + 1), generator=gen, device=dev)
    small_ids = torch.from_numpy(rng.integers(-2, 12, 5000)).to(dev)
    # 1,000,003 rows: the last window of 16 (and of 64) holds 3 rows;
    # sorted ids crowd the table's end, some past it
    partial = torch.randn((1_000_003, DIM + 1), generator=gen, device=dev)
    partial_ids = torch.from_numpy(np.sort(rng.integers(
        1_000_003 - 4000, 1_000_003 + 8, 20_000))).to(dev)
    dups = torch.from_numpy(rng.integers(0, 3000, 50_000)).to(dev)
    cases = [("dedup sorted", w32, dedup(ids), 16),
             ("dedup sorted", w32, dedup(ids), 64),
             ("relabeled dedup sorted", w32, relabeled, 16),
             ("relabeled dedup sorted", w32, relabeled, 64),
             ("zipf unsorted", w32, zipf, 16),
             ("zipf unsorted bf16", w16, zipf.to(torch.int32), 16),
             ("unsorted with duplicates", w32, dups, 16),
             ("last window partial", partial, partial_ids, 16),
             ("last window partial", partial, partial_ids, 64),
             ("table smaller than the window", small, small_ids, 16)]
    main = None
    for name, w, rows, window in cases:
        n_rows, dim = w.shape
        before = (gather.LAUNCHES["gather_rows"],
                  gather_windows.LAUNCHES["gather_rows_windows"])
        got = gather_windows.gather_rows_windows(w, rows, window=window)
        after = (gather.LAUNCHES["gather_rows"],
                 gather_windows.LAUNCHES["gather_rows_windows"])
        routed = (1, 0) if n_rows < window else (0, 1)
        check((after[0] - before[0], after[1] - before[1]) == routed,
              f"window gather {name}: launches {before} -> {after}")
        want = gather_windows.gather_rows_windows_reference(w, rows,
                                                            window=window)
        per_row = gather.gather_rows(w, rows)
        torch.cuda.synchronize()
        equal = (torch.equal(mb.bits(got), mb.bits(want))
                 and torch.equal(mb.bits(got), mb.bits(per_row)))
        err = max(float((got.float() - want.float()).abs().max()),
                  float((got.float() - per_row.float()).abs().max()))
        ids_np = rows.cpu().numpy()
        nbytes = mb.gather_bytes(ids_np, rows.element_size(), None, n_rows,
                                 dim, w.element_size())
        rec = {"phase": "windows", "case": name,
               "table": f"{str(w.dtype).split('.')[-1]} {n_rows}x{dim}",
               "ids": f"{rows.shape[0]} {str(rows.dtype).split('.')[-1]}",
               "window": window, "bit_equal": equal, "max_abs_err": err,
               "ms": mb.device_ms(lambda: gather_windows.gather_rows_windows(
                   w, rows, window=window)),
               "plain_ms": mb.device_ms(
                   lambda: gather_windows.gather_rows_windows_reference(
                       w, rows, window=window)),
               "gather_rows_ms": mb.device_ms(
                   lambda: gather.gather_rows(w, rows)),
               "library_ms": mb.device_ms(
                   lambda: mb.library_gather(w, rows)),
               **nbytes,
               "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S
               * 1e3}
        if n_rows >= window:
            rec["by_share"] = {}
            for share in STAGE_SHARES:
                # the rule changes how the kernel reads, never what it returns
                alt = gather_windows.gather_rows_windows(
                    w, rows, window=window, stage_share=share)
                torch.cuda.synchronize()
                same = torch.equal(mb.bits(alt), mb.bits(want))
                equal = equal and same
                st = gather_windows.staged_bytes(
                    ids_np, n_rows, dim * w.element_size(), window=window,
                    stage_share=share, base_offset=w.data_ptr() % 16)
                rec["by_share"][str(share)] = {
                    "bit_equal": same, **st._asdict(),
                    "ms": mb.device_ms(
                        lambda: gather_windows.gather_rows_windows(
                            w, rows, window=window, stage_share=share))}
        rec["bit_equal"] = equal
        emit(rec)
        check(equal, f"gather_rows_windows bit-equal to its plain version "
              f"and to gather_rows ({rec})")
        if main is None:
            main = rec
    # traced last (`kernels_profile`), so that no timed phase runs after a
    # profiler session
    calls = [(f"relabeled dedup sorted, stage_share {share}",
              lambda share=share: gather_windows.gather_rows_windows(
                  w32, relabeled, stage_share=share))
             for share in (float("inf"), 0.5)]
    return main, calls


def kernels_profile(torch, phase: str, calls, kernel: str) -> None:
    """Each call under torch.profiler, one a session: it must enqueue one
    device kernel, `kernel`, and nothing else (no prepass, no copy)."""
    for name, fn in calls:
        kernels, sessions = device_kernels(torch, fn)
        emit({"phase": phase, "case": f"profiler: {name}",
              "device_kernels_per_call": kernels,
              "profiler_sessions": sessions})
        check(len(kernels) == 1 and kernel in kernels[0],
              f"one {phase} call enqueues one device kernel, {kernel} "
              f"({name}: {kernels})")


def _apply_once(torch, mb, apply, opt, w, slots, idx, g, counts):
    """The kernel on (w, slots) and the plain version on clones; returns
    (kernel's, plain's) tables and slots after the update."""
    w2 = w.clone()
    s2 = {k: v.clone() for k, v in slots.items()}
    before = apply.LAUNCHES["fused_sparse_apply"]
    apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
    check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
          "one fused_sparse_apply call is one kernel launch")
    apply.fused_sparse_apply_reference(opt, w2, s2, idx, g, counts)
    check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
          "the plain version launches no kernel")
    torch.cuda.synchronize()
    return (w, slots), (w2, s2)


def _max_err(got, want) -> float:
    (w, s), (w2, s2) = got, want
    errs = [float((w.float() - w2.float()).abs().max())]
    errs += [float((s[k] - s2[k]).abs().max()) for k in s]
    return max(errs)


def _bit_equal(torch, mb, got, want) -> bool:
    (w, s), (w2, s2) = got, want
    return (torch.equal(mb.bits(w), mb.bits(w2))
            and all(torch.equal(mb.bits(s[k]), mb.bits(s2[k])) for k in s))


def apply_small_cases(torch, mb, apply, sparse, optimizers) -> list:
    """Every rule on a small table: duplicates, -1 pads and out-of-range
    ids, three updates in a row (so the slots leave their initial values),
    the kernel held against the plain version after each."""
    dev = torch.device("cuda")
    cases = [
        ("default", optimizers.Default(learning_rate=0.1), torch.float32, 0.0),
        ("sgd", optimizers.SGD(learning_rate=0.05, momentum=0.9,
                               nesterov=True), torch.float32, 0.0),
        ("adagrad", optimizers.Adagrad(learning_rate=0.1), torch.float32, 0.0),
        ("adadelta", optimizers.Adadelta(learning_rate=0.5), torch.float32,
         0.0),
        ("adam", optimizers.Adam(learning_rate=0.01), torch.float32, 0.0),
        ("adamax", optimizers.Adamax(learning_rate=0.01), torch.float32, 0.0),
        ("ftrl", optimizers.Ftrl(learning_rate=0.05,
                                 l1_regularization_strength=0.01,
                                 l2_regularization_strength=0.01),
         torch.float32, 0.0),
        ("rmsprop", optimizers.RMSprop(learning_rate=0.05, momentum=0.5),
         torch.float32, 0.0),
        ("test", optimizers.TestOptimizer(), torch.float32, 0.0),
        ("adam bf16", optimizers.Adam(learning_rate=0.05), torch.bfloat16,
         0.0),
        # powf is not correctly rounded: the kernel and torch.pow may round
        # differently, by a few ulp of each power
        ("ftrl pow -0.7", optimizers.Ftrl(
            learning_rate=0.05, learning_rate_power=-0.7, beta=0.3,
            l1_regularization_strength=0.01,
            l2_shrinkage_regularization_strength=0.02), torch.float32, 1e-5),
    ]
    rng = np.random.default_rng(SEED + 2)
    n_rows, n = 1000, 600
    out = []
    for name, opt, dtype, tol in cases:
        dim = 16 if dtype == torch.bfloat16 else 12
        w = torch.from_numpy(rng.standard_normal((n_rows, dim)).astype(
            np.float32)).to(dev, dtype)
        slots = opt.init_slots(n_rows, dim, device=dev)
        worst, equal = 0.0, True
        for _ in range(3):
            ids = rng.integers(-1, n_rows + 100, n)
            ids[:50] = ids[50:100]  # certain duplicates
            grads = torch.from_numpy(rng.standard_normal((n, dim)).astype(
                np.float32)).to(dev)
            g, counts, idx = sparse._dedup_routed(
                n_rows, torch.from_numpy(ids).to(dev), grads, None)
            got, want = _apply_once(torch, mb, apply, opt, w, slots, idx, g,
                                    counts)
            worst = max(worst, _max_err(got, want))
            equal = equal and _bit_equal(torch, mb, got, want)
            w, slots = want  # continue from the plain version's state
        rec = {"phase": "apply", "case": name, "table": f"{n_rows}x{dim} "
               f"{str(dtype).split('.')[-1]}", "bit_equal": equal,
               "max_abs_err": worst, "tolerance": tol}
        emit(rec)
        if tol == 0.0:
            check(equal, f"fused_sparse_apply bit-equal to its plain version "
                  f"({rec})")
        else:
            check(worst <= tol, f"fused_sparse_apply within {tol} of its "
                  f"plain version ({rec})")
        out.append(rec)
    return out


def apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                      dim: int, n_rows: int) -> dict:
    """One Adagrad update of a criteo batch's rows through the packed
    weights+slots array against the split arrays (bit-equal), and the
    times that decide whether `train_many` should pack at this width (the
    gate refuses it on the card): the pull's gather and the apply in both
    layouts, and the pack and unpack that a window adds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    opt = optimizers.Adagrad(learning_rate=0.05)
    w = 1e-2 * torch.randn((n_rows, dim), generator=gen, device=dev)
    accum = 0.1 + torch.rand((n_rows, dim), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=n_rows,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)
    grads = 1e-3 * torch.randn((ids.shape[0], dim), generator=gen,
                               device=dev)
    g, counts, idx = sparse._dedup_routed(n_rows, ids, grads, None)
    check(sparse.packed_layout(dim, {"accum": accum}) is None,
          f"the gate keeps the width-{dim} table split on the card")
    lay = (("accum", dim),)
    packed = sparse.pack_table(w, {"accum": accum}, lay)
    pw, ps = sparse.unpack_table(packed, lay, dim, torch.float32)
    split = {"accum": accum}
    apply.fused_sparse_apply(opt, w, split, idx, g, counts)
    apply.fused_sparse_apply(opt, pw, ps, idx, g, counts)
    torch.cuda.synchronize()
    equal = (torch.equal(mb.bits(w), mb.bits(pw.contiguous()))
             and torch.equal(mb.bits(accum), mb.bits(ps["accum"].contiguous())))
    pulled = gather.gather_rows(packed, ids)[:, :dim]
    equal = equal and torch.equal(mb.bits(pulled.contiguous()),
                                  mb.bits(gather.gather_rows(w, ids)))
    times = {
        "split_gather_ms": mb.device_ms(lambda: gather.gather_rows(w, ids)),
        "packed_gather_ms": mb.device_ms(
            lambda: gather.gather_rows(packed, ids)),
        "split_apply_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, w, split, idx, g, counts)),
        "packed_apply_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, pw, ps, idx, g, counts)),
        "pack_ms": mb.device_ms(
            lambda: sparse.pack_table(w, split, lay), samples=5),
    }

    def unpack():
        w.copy_(pw)
        accum.copy_(ps["accum"])

    times["unpack_ms"] = mb.device_ms(unpack, samples=5)
    per_step = {lay_name: times[f"{lay_name}_gather_ms"]
                + times[f"{lay_name}_apply_ms"]
                for lay_name in ("split", "packed")}
    rec = {"phase": "apply", "case": f"packed vs split, width {dim}",
           "table": f"f32 {n_rows}x{dim} + accum", "bit_equal": equal,
           **times,
           "window16_split_ms": MANY_STEPS * per_step["split"],
           "window16_packed_ms": MANY_STEPS * per_step["packed"]
           + times["pack_ms"] + times["unpack_ms"]}
    emit(rec)
    check(equal, f"packed apply and pull bit-equal to the split ones ({rec})")
    return rec


def _apply_edge_case(torch, mb, apply, sparse, rng, name, opt, dtype, dim,
                     layout="split", n_ids=3000, id_dtype="int64",
                     zero_counts=False) -> dict:
    """Two updates in a row of a 5000-row table, each the kernel on one copy
    against the plain version on another, every array bit-equal after each (with
    `zero_counts`, also bit-identical to before). layout: "split" (arrays
    of their own), "w[1:]" (every array a view one row in), or "off4" /
    "off8" (weights and the two slots of RMSprop as column views of one
    (n_rows, 52) array, the slots starting 4 / 8 bytes off a 16-byte
    boundary, the columns between them checked too)."""
    dev = torch.device("cuda")
    n_rows = 5000
    names = list(opt.slot_shapes(dim))
    if layout in ("off4", "off8"):
        offsets = (17, 34) if layout == "off4" else (18, 36)
        backing = [torch.from_numpy(rng.standard_normal((n_rows, 52)).astype(
            np.float32)).abs().to(dev)]

        def views(b):
            return b[0][:, :dim], {k: b[0][:, o:o + dim]
                                   for k, o in zip(names, offsets)}
    else:
        skip = 1 if layout == "w[1:]" else 0
        w = torch.from_numpy(rng.standard_normal(
            (n_rows + skip, dim)).astype(np.float32)).to(dev, dtype)
        backing = [w, *opt.init_slots(n_rows + skip, dim, device=dev).values()]

        def views(b):
            return b[0][skip:], {k: v[skip:] for k, v in zip(names, b[1:])}
    equal, worst, plans = True, 0.0, set()
    for update in range(2):
        ids = rng.integers(-1, n_rows + 50, n_ids)
        ids[:n_ids // 10] = ids[n_ids // 10:2 * (n_ids // 10)]  # duplicates
        ids[0] = n_rows // 2  # at least one live slot, also at n = 1
        grads = torch.from_numpy(rng.standard_normal((n_ids, dim)).astype(
            np.float32)).to(dev)
        g, counts, idx = sparse._dedup_routed(
            n_rows, torch.from_numpy(ids).to(dev, getattr(torch, id_dtype)),
            grads, None)
        if zero_counts:
            counts.zero_()
        got_b = [b.clone() for b in backing]
        want_b = [b.clone() for b in backing]
        (w, slots), (w2, s2) = views(got_b), views(want_b)
        arrays = apply.plan_arrays(opt, w, slots, g)
        plan = apply.launch_plan(opt.rule, dim, arrays)
        c_plan = apply.kernel_plan(opt.rule, dim, arrays)
        check((plan.word_elems, plan.tile_rows) == c_plan,
              f"{name}: launch_plan {plan} is the kernel's {c_plan}")
        plans.add((plan.word_elems, plan.tile_rows))
        before = apply.LAUNCHES["fused_sparse_apply"]
        apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
        check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
              "one fused_sparse_apply call is one kernel launch")
        apply.fused_sparse_apply_reference(opt, w2, s2, idx, g, counts)
        torch.cuda.synchronize()
        for a, b in zip(got_b, want_b):
            equal = equal and torch.equal(mb.bits(a), mb.bits(b))
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        if zero_counts:
            equal = equal and all(torch.equal(mb.bits(a), mb.bits(b))
                                  for a, b in zip(got_b, backing))
        backing = want_b  # continue from the plain version's state
    rec = {"phase": "apply", "case": name,
           "table": f"{n_rows}x{dim} {str(dtype).split('.')[-1]}",
           "layout": layout, "ids": id_dtype,
           "slots": int(idx.shape[0]),
           "plan_word_elems_tile_rows": sorted(plans), "bit_equal": equal,
           "max_abs_err": worst, "tolerance": 0.0}
    emit(rec)
    check(equal, f"fused_sparse_apply bit-equal to its plain version ({rec})")
    return rec


def apply_edge_cases(torch, mb, apply, sparse, optimizers) -> tuple:
    """What the kernel's lane map can get wrong: each word (E = 1, 2, 4) and
    partial tiles (widths 1 to 128), bfloat16 words, views off a 16-byte
    boundary, one slot, a ragged slot count, an update with no live slot,
    and the three rules with per-row state; returns the records and two
    calls for the profiler check."""
    rng = np.random.default_rng(SEED + 6)
    f32, bf16, i32 = torch.float32, torch.bfloat16, "int32"
    ada = optimizers.Adagrad(learning_rate=0.1)
    rms = optimizers.RMSprop(learning_rate=0.05, momentum=0.5)
    cases = [(f"adagrad width {d}", ada, f32, d, {}) for d in (1, 9, 10)]
    cases += [("adagrad width 11, int32 ids", ada, f32, 11,
               {"id_dtype": i32}),
              ("adagrad width 16", ada, f32, 16, {}),
              ("adagrad width 64, int32 ids", ada, f32, 64,
               {"id_dtype": i32}),
              ("adagrad width 128", ada, f32, 128, {}),
              ("adagrad bf16 width 10", ada, bf16, 10, {}),
              ("adagrad bf16 width 16", ada, bf16, 16, {}),
              ("rmsprop column views 4 bytes off", rms, f32, 16,
               {"layout": "off4"}),
              ("rmsprop column views 8 bytes off", rms, f32, 16,
               {"layout": "off8"}),
              ("adagrad view w[1:] width 10", ada, f32, 10,
               {"layout": "w[1:]"}),
              ("adagrad width 10, n = 1", ada, f32, 10, {"n_ids": 1}),
              ("adagrad width 10, n = 1001", ada, f32, 10,
               {"n_ids": 1001}),
              ("adagrad width 10, counts all 0", ada, f32, 10,
               {"zero_counts": True})]
    for rule, opt in (("adam", optimizers.Adam(learning_rate=0.01)),
                      ("adamax", optimizers.Adamax(learning_rate=0.01)),
                      ("test", optimizers.TestOptimizer())):
        cases += [(f"{rule} width {d}", opt, f32, d, {}) for d in (10, 64)]
    out = [_apply_edge_case(torch, mb, apply, sparse, rng, name, opt, dtype,
                            dim, **kw)
           for name, opt, dtype, dim, kw in cases]

    # one small call of each table type for the profiler, traced last
    dev = torch.device("cuda")
    calls = []
    adam = optimizers.Adam(learning_rate=0.01)
    for dtype, opt in ((f32, ada), (bf16, adam)):
        w = torch.randn((5000, 10), device=dev).to(dtype)
        slots = opt.init_slots(5000, 10, device=dev)
        ids = torch.from_numpy(rng.integers(0, 5000, 1001)).to(dev)
        g, counts, idx = sparse._dedup_routed(
            5000, ids, torch.randn((1001, 10), device=dev), None)
        calls.append((f"{type(opt).__name__} {str(dtype).split('.')[-1]} "
                      f"5000x10, 1001 slots",
                      lambda opt=opt, w=w, slots=slots, idx=idx, g=g,
                      counts=counts: apply.fused_sparse_apply(
                          opt, w, slots, idx, g, counts)))
    return out, calls


def phase_apply(torch, mb, apply, gather, sparse, optimizers, data) -> tuple:
    """The apply kernel against its plain version at the training path's
    shapes, its one-slot and all-padding times, warm and with L2 emptied,
    the packed cases, the lane map's edge cases and the small
    cases; returns the main case and the calls the profiler check traces
    once every timing is done."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    dim = DIM + 1
    opt = optimizers.Adagrad(learning_rate=0.05)
    w = 1e-2 * torch.randn((VOCAB, dim), generator=gen, device=dev)
    accum = opt.init_slots(VOCAB, dim, device=dev)["accum"]
    accum += torch.rand((VOCAB, dim), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)
    grads = 1e-3 * torch.randn((ids.shape[0], dim), generator=gen, device=dev)
    g, counts, idx = sparse._dedup_routed(VOCAB, ids, grads, None)
    torch.cuda.synchronize()
    got, want = _apply_once(torch, mb, apply, opt, w, {"accum": accum}, idx,
                            g, counts)
    equal = _bit_equal(torch, mb, got, want)
    err = _max_err(got, want)
    del want
    w, slots = got

    rows_np = idx.cpu().numpy()
    counts_np = counts.cpu().numpy()
    nbytes = mb.apply_bytes(rows_np, counts_np, VOCAB, dim, w.element_size(),
                            [dim])
    arrays = apply.plan_arrays(opt, w, slots, g)
    plan = apply.launch_plan(opt.rule, dim, arrays)
    check((plan.word_elems, plan.tile_rows)
          == apply.kernel_plan(opt.rule, dim, arrays),
          "the main case's launch plan is the kernel's")
    tiles = -(-len(counts_np) // plan.tile_rows)
    live = np.zeros(tiles * plan.tile_rows, bool)
    live[:len(counts_np)] = counts_np > 0
    # the update with every count 0 leaves the table as it is
    zeros = torch.zeros_like(counts)
    before = (w.clone(), slots["accum"].clone())
    apply.fused_sparse_apply(opt, w, slots, idx, g, zeros)
    torch.cuda.synchronize()
    padding_equal = _bit_equal(torch, mb, (w, slots),
                               (before[0], {"accum": before[1]}))
    del before
    run = lambda: apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
    one_slot = lambda: apply.fused_sparse_apply(opt, w, slots, idx[:1], g[:1],
                                                counts[:1])
    # a read of 256 MB, five times the H100's L2, before each cold call
    flush = torch.ones(1 << 26, device=dev)
    run_plain = lambda: apply.fused_sparse_apply_reference(
        opt, w, slots, idx, g, counts)
    rec = {
        "phase": "apply", "case": "main adagrad",
        "table": f"f32 {VOCAB}x{dim} + accum",
        "slots": int(idx.shape[0]), **nbytes,
        "plan": plan._asdict(), "tiles": tiles,
        "tiles_with_a_live_slot": int(live.reshape(
            tiles, plan.tile_rows).any(1).sum()),
        "bit_equal": equal,
        "all_padding_bit_identical": padding_equal,
        "max_abs_err": err,
        "ms": mb.device_ms(run),
        # one live slot: the floor of a launch; every slot padding: one
        # coalesced count and id round per tile
        "one_slot_ms": mb.device_ms(one_slot),
        "all_padding_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, w, slots, idx, g, zeros)),
        # the same with the rows in DRAM: what the update takes above its
        # floor, against the sector bound
        "cold_ms": mb.device_ms(run, before=flush.sum),
        "cold_one_slot_ms": mb.device_ms(one_slot, before=flush.sum),
        "plain_ms": mb.device_ms(run_plain),
        "library_ms": mb.device_ms(mb.library_adagrad(opt, w, idx, g,
                                                      counts)),
        "host_ms_per_call": host_ms(torch, run),
        "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
        "sector_bound_ms": nbytes["sector_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
    }
    emit(rec)
    check(equal, f"fused_sparse_apply bit-equal to its plain version at "
          f"the main case ({rec})")
    check(padding_equal, "an update whose counts are all 0 leaves the "
          "table and its slots bit-identical")
    del w, slots, got, flush
    torch.cuda.empty_cache()
    rec["packed"] = [
        apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                          dim, VOCAB),
        apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                          64, 1 << 22)]
    torch.cuda.empty_cache()
    rec["edge_cases"], calls = apply_edge_cases(torch, mb, apply, sparse,
                                                optimizers)
    rec["small_cases"] = apply_small_cases(torch, mb, apply, sparse,
                                           optimizers)
    return rec, calls


def profile_device(torch, fn, calls: int = 10, unit: str = "predict"
                   ) -> dict:
    """Device busy time of `calls` calls of `fn` under torch.profiler: the
    sum of kernel and copy times on the card against the wall time, and the
    five costliest device ops, per call. The train step's `trainer.*`
    ranges appear twice: as host ranges (their host ms) and as annotations
    on the device timeline (the span from their first kernel to their
    last, idle gaps included); neither counts as device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith("trainer.")]
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and e not in spans]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(busy_ms > 0, f"the profiler saw device work in {unit}")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = {"profile_calls": calls,
           f"profile_wall_ms_per_{unit}": wall_ms / calls,
           f"profile_device_ms_per_{unit}": busy_ms / calls,
           "profile_device_idle_share": 1.0 - busy_ms / wall_ms,
           "profile_top_device_ops": [
               [e.key[:60], e.self_device_time_total / 1e3 / calls,
                e.count // calls] for e in top]}
    if spans:
        out[f"profile_spans_ms_per_{unit}"] = {
            e.key + (" device span" if e.device_type == DeviceType.CUDA
                     else " host"):
            (e.device_time_total if e.device_type == DeviceType.CUDA
             else e.cpu_time_total) / 1e3 / calls for e in spans}
    return out


def phase_serve(torch, ops, gather) -> int:
    """Full-width DeepFM over REST; returns the gather launches of the run."""
    from openembedding_tpu_torch.export import export_standalone
    from openembedding_tpu_torch.model import init_weights
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.serving import ServingClient, make_server

    rng = np.random.default_rng(SEED + 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    httpd = thread = None
    try:
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        t0 = time.perf_counter()
        state = init_weights(model, make_batch(rng, 8), seed=SEED)
        export_dir = os.path.join(tmp, "export")
        export_standalone(state, model, export_dir, model_sign=SIGN)
        export_s = time.perf_counter() - t0
        del state, model
        torch.cuda.empty_cache()

        httpd = make_server(os.path.join(tmp, "registry"), port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                               timeout=300)

        # the main path's run: counts start at 0 here and are read below
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        client.create_model(SIGN, export_dir)
        load_s = time.perf_counter() - t0
        sm = httpd.manager.find_model(SIGN)
        n_tables = len(sm.variable_names)
        answers = []
        for b in (1, 100, BATCH):
            batch = make_batch(rng, b)
            before = gather.LAUNCHES["gather_rows"]
            logits = client.predict(SIGN, batch["sparse"], batch["dense"])
            delta = gather.LAUNCHES["gather_rows"] - before
            check(delta == n_tables, f"predict at batch {b} launched the "
                  f"gather {delta} times, expected {n_tables}")
            answers.append((batch, logits))
        pull_ids = [0, 7, 123456, VOCAB - 1, -1, VOCAB, VOCAB + 5, 1 << 40]
        before = gather.LAUNCHES["gather_rows"]
        pulled = client.pull(SIGN, "categorical", pull_ids)
        check(gather.LAUNCHES["gather_rows"] - before == 1,
              "a pull launches the gather once")

        big = answers[-1][0]
        rest = []
        for _ in range(10):
            t0 = time.perf_counter()
            client.predict(SIGN, big["sparse"], big["dense"])
            rest.append(time.perf_counter() - t0)

        def inproc():
            sm.predict(big)
            torch.cuda.synchronize()

        for _ in range(3):
            inproc()
        local = []
        for _ in range(30):
            t0 = time.perf_counter()
            inproc()
            local.append(time.perf_counter() - t0)
        profile = profile_device(torch, inproc)
        launches = gather.LAUNCHES["gather_rows"]

        # reference: the same servable, the plain gather in place of the kernel
        worst = 0.0
        with ops.plain_versions():
            for batch, logits in answers:
                ref = sm.predict(batch).float().cpu().numpy()
                n = batch["dense"].shape[0]
                check(logits.shape == (n,) and np.isfinite(logits).all(),
                      f"finite logits of shape ({n},)")
                err = float(np.abs(logits - ref).max())
                worst = max(worst, err)
                check(err == 0.0, f"REST logits at batch {n} equal the plain-"
                      f"gather forward (max abs err {err})")
            ref_rows = sm.lookup("categorical", np.asarray(pull_ids)).float(
            ).cpu().numpy()
        check(np.array_equal(pulled, ref_rows), "pulled rows equal the plain "
              "gather's")
        check(not pulled[4:].any() and pulled[:4].any(),
              "invalid ids pull zero rows, valid ones do not")
        rest_p50, local_p50 = np.median(rest), np.median(local)
        emit({"phase": "serve", "model": "deepfm vocab 2^24 dim 9 "
              "hidden 400-400-400 bf16", "tables": n_tables,
              "export_s": export_s, "load_s": load_s,
              "max_abs_err_vs_plain": worst, "tolerance": 0.0,
              "rest_p50_ms_4096": rest_p50 * 1e3,
              "rest_rows_per_s_4096": BATCH / rest_p50,
              "inproc_p50_ms_4096": local_p50 * 1e3,
              "inproc_rows_per_s_4096": BATCH / local_p50,
              "gather_launches": launches, **profile})
        check(launches > 0, "the serving run launched the gather kernel")
        return launches
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
            check(not thread.is_alive(), "the server thread stopped")
        shutil.rmtree(tmp, ignore_errors=True)


def _stacked(batches) -> dict:
    return {"sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in batches])},
            "dense": np.stack([b["dense"] for b in batches]),
            "label": np.stack([b["label"] for b in batches])}


def _windows(batches) -> list:
    return [_stacked(batches[TRAIN_STEPS + w * MANY_STEPS:
                             TRAIN_STEPS + (w + 1) * MANY_STEPS])
            for w in range(MANY_WINDOWS)]


def _timed_steps(torch, step, state, batches, losses) -> tuple:
    """TRAIN_STEPS calls of `step`, the last TRAIN_STEPS - WARM_STEPS timed;
    each loss cloned (a captured step overwrites its outputs)."""
    for k in range(WARM_STEPS):
        state, m = step(state, batches[k])
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WARM_STEPS, TRAIN_STEPS):
        state, m = step(state, batches[k])
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def _run_windows(torch, many, state, windows, losses) -> tuple:
    """Every window through `many`; the last one timed."""
    seconds = 0.0
    for w, stacked in enumerate(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = many(state, stacked)
        losses.extend(m["loss"].clone().unbind(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(int(m["overflow"]) == 0, "no overflow on one device")
    return state, seconds


def _compare(torch, mb, state, losses, ref, ref_losses, what: str) -> dict:
    got, want = mb.state_bits(state), mb.state_bits(ref)
    diffs = {k: float((got[k].float() - want[k].float()).abs().max())
             for k in got}
    unequal = sorted(k for k in got if not torch.equal(mb.bits(got[k]),
                                                       mb.bits(want[k])))
    loss_equal = np.array_equal(losses.view(np.int32),
                                ref_losses.view(np.int32))
    out = {f"loss_bit_equal_{what}": bool(loss_equal),
           f"state_unequal_{what}": unequal,
           f"state_max_abs_diff_{what}": max(diffs.values())}
    check(loss_equal and not unequal, f"training equals the {what} run bit "
          f"for bit ({out})")
    return out


def graph_record(driver) -> dict:
    """What a `model.CompiledStep` counted: captures, replays and the
    launches of one replay."""
    return {"captures": driver.captures, "replays": driver.replays,
            "launches_per_replay": driver.launches_per_replay}


def ran_launches(counted: dict, graphs) -> dict:
    """The kernel launches that ran on the card in a run through CUDA-graph
    drivers, from their `graph_record`s: the wrappers' counts over the run
    less what each capture counted, since a captured launch runs nothing,
    plus what each replay ran. Each driver must have captured once."""
    out = dict(counted)
    for d in graphs:
        check(d["captures"] == 1, f"one capture per driver ({d})")
        for k, n in d["launches_per_replay"].items():
            out[k] += n * (d["replays"] - d["captures"])
    return out


def _pack_every_table(dim, slots, weights_dtype=None):
    """A gate that packs every table with slots, as the gate does off the
    card (the train phase's float32 Adagrad table is far below its cap)."""
    return tuple((k, int(slots[k].shape[1])) for k in sorted(slots))


def phase_train(torch, mb, ops, optimizers, data) -> dict:
    """Full-width DeepFM training through both kernels, held against the
    same steps through both plain versions and through the CUDA graphs."""
    from openembedding_tpu_torch import model as model_module
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm

    torch.cuda.reset_peak_memory_stats()
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    steps = TRAIN_STEPS + MANY_WINDOWS * MANY_STEPS
    batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                         seed=TRAIN_SEED, steps=steps))
    windows = _windows(batches)
    state = trainer.init(batches[0])
    check(trainer._packed_layouts(state) == {},
          "the gate keeps the table split on the card")
    ref, graph_state = state.clone(), state.clone()
    n_tables = len(model.specs)
    to_np = lambda ls: torch.stack(ls).cpu().numpy()

    # the main path's run: counts start at 0 here and are read below
    ops.reset_launch_counts()
    losses = []
    state, seconds = _timed_steps(torch, trainer.train_step, state, batches,
                                  losses)
    state, many_seconds = _run_windows(torch, trainer.train_many, state,
                                       windows, losses)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("gather_rows", "fused_sparse_apply"):
        check(launches[k] == steps * n_tables, f"{k} launched {launches[k]} "
              f"times in {steps} steps of {n_tables} table(s)")
    losses = to_np(losses)
    check(np.isfinite(losses).all(), f"finite losses {losses}")

    # the same steps as eager train_steps through the plain versions: no
    # launch may be counted
    ref_losses = []
    with ops.plain_versions():
        ref, ref_seconds = _timed_steps(torch, trainer.train_step, ref,
                                        batches, ref_losses)
        for b in batches[TRAIN_STEPS:]:
            ref, m = trainer.train_step(ref, b)
            ref_losses.append(m["loss"])
    check(ops.launch_counts() == launches, "the plain run launched no kernel")
    rec = _compare(torch, mb, state, losses, ref, to_np(ref_losses),
                   "vs_plain")

    # the same steps through the CUDA graphs, the path's second run: counts
    # start at 0 here and are read below, as the graphs ran them
    step, many = trainer.jit_train_step(), trainer.jit_train_many()
    graph_losses = []
    ops.reset_launch_counts()
    graph_state, graph_seconds = _timed_steps(torch, step, graph_state,
                                              batches, graph_losses)
    packed_state = graph_state.clone()
    graph_state, graph_many_seconds = _run_windows(
        torch, many, graph_state, windows, graph_losses)
    graph = {"step": graph_record(step), "many": graph_record(many)}
    graph_launches = ran_launches(ops.launch_counts(), graph.values())
    for k in ("gather_rows", "fused_sparse_apply"):
        check(graph_launches[k] == steps * n_tables, f"{k} ran "
              f"{graph_launches[k]} times in {steps} graph steps of "
              f"{n_tables} table(s)")
    rec.update(_compare(torch, mb, graph_state, to_np(graph_losses), state,
                        losses, "graphs_vs_eager"))

    # the two windows again through a graph on the packed layout, which
    # the gate refuses on the card: held to the split steps and timed
    packed_losses = []
    with mock.patch.object(model_module, "packed_layout", _pack_every_table):
        packed_many = trainer.jit_train_many()
        check(trainer._packed_layouts(packed_state) == {
            "categorical": (("accum", DIM + 1),)}, "the window packs")
        packed_state, packed_seconds = _run_windows(
            torch, packed_many, packed_state, windows, packed_losses)
    rec.update(_compare(torch, mb, packed_state, to_np(packed_losses), state,
                        losses[TRAIN_STEPS:], "packed_graph_vs_eager"))
    graph["packed_many"] = graph_record(packed_many)
    for name, d in graph.items():
        calls, k = ((TRAIN_STEPS, 1) if name == "step"
                    else (MANY_WINDOWS, MANY_STEPS))
        check(d["captures"] == 1 and d["replays"] == calls - 1,
              f"jit_train_{name}: one capture, then replays ({d})")
        check(d["launches_per_replay"] == {
            "gather_rows": k * n_tables, "gather_rows_windows": 0,
            "fused_sparse_apply": k * n_tables},
            f"each captured step launches one gather and one apply per "
            f"table ({d})")
    for st in (graph_state, packed_state):
        check(st.tables["categorical"].weights.shape == (VOCAB, DIM + 1)
              and list(st.tables["categorical"].slots) == ["accum"],
              "the state leaves train_many in the split layout")
    del packed_many, packed_state

    def one_step():
        trainer.train_step(state, batches[0])
        torch.cuda.synchronize()

    def one_replay():
        step(graph_state, batches[0])
        torch.cuda.synchronize()

    def one_window():
        many(graph_state, windows[0])
        torch.cuda.synchronize()

    profile = profile_device(torch, one_step, calls=5, unit="step")
    graph_profile = profile_device(torch, one_replay, calls=5, unit="step")
    many_profile = profile_device(torch, one_window, calls=3, unit="window")
    many_profile["profile_device_ms_per_step"] = (
        many_profile["profile_device_ms_per_window"] / MANY_STEPS)
    timed = TRAIN_STEPS - WARM_STEPS
    # the profiler slows the host; the idle share against the unprofiled
    # wall time of the timed steps is what a run without it sees
    for prof, wall_s, n in ((profile, seconds, timed),
                            (graph_profile, graph_seconds, timed),
                            (many_profile, graph_many_seconds, MANY_STEPS)):
        prof["device_idle_share_unprofiled"] = (
            1.0 - prof["profile_device_ms_per_step"] * n / (wall_s * 1e3))
    rec = {"phase": "train", "model": "deepfm vocab 2^24 dim 9 hidden "
           "400-400-400 bf16, Adagrad(0.05)", "batch": BATCH,
           "steps": steps, "launches": launches,
           "graph_launches": graph_launches,
           "losses": losses.tolist(),
           "loss_first_last": [float(losses[0]), float(losses[-1])],
           "examples_per_s": BATCH * timed / seconds,
           "step_ms": seconds * 1e3 / timed,
           "train_many_examples_per_s": BATCH * MANY_STEPS / many_seconds,
           "plain_examples_per_s": BATCH * timed / ref_seconds,
           "graph_step_examples_per_s": BATCH * timed / graph_seconds,
           "graph_step_ms": graph_seconds * 1e3 / timed,
           "graph_many_examples_per_s":
               BATCH * MANY_STEPS / graph_many_seconds,
           "graph_many_ms_per_step": graph_many_seconds * 1e3 / MANY_STEPS,
           "graph_packed_many_examples_per_s":
               BATCH * MANY_STEPS / packed_seconds,
           "graph_packed_many_ms_per_step":
               packed_seconds * 1e3 / MANY_STEPS,
           "graphs": graph, **rec,
           "peak_memory_bytes": peak, **profile,
           "graph_step_profile": graph_profile,
           "graph_many_profile": many_profile}
    emit(rec)
    return rec


def phase_build(torch, kernel_modules, _build) -> None:
    """Build every kernel at the same time, one nvcc each."""
    t0 = time.perf_counter()
    errors = []

    def build(lib_fn):
        try:
            lib_fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m._library,))
               for m in kernel_modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for m in kernel_modules:
        info = _build.BUILD_INFO[m.KERNEL]
        emit({"phase": "build", "kernel": m.KERNEL,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"],
              "ptxas": [ln for ln in info["log"].splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]})
    gather, gather_windows = kernel_modules[:2]
    lib = gather_windows._library()
    rule = (lib.oe_window_gather_tile(), lib.oe_window_gather_stage_bytes(),
            lib.oe_window_gather_stage_min_rows())
    check(rule == (gather_windows.TILE, gather_windows.STAGE_BYTES,
                   gather_windows.STAGE_MIN_ROWS),
          f"the window kernel's staging rule {rule} is the one "
          "ops/gather_windows.staged_bytes mirrors")
    glib = gather._library()
    emit({"phase": "build", "gather_rows_grid_blocks": {
        f"{wb}-byte words, {ib}-byte ids":
        glib.oe_gather_rows_resident_blocks(wb, ib)
        for wb in (16, 8, 4, 2) for ib in (4, 8)}})
    apply = kernel_modules[2]
    alib = apply._library()
    emit({"phase": "build", "fused_sparse_apply_grid_blocks": {
        f"rule {rule}, {eb}-byte table, E {e}":
        alib.oe_fused_sparse_apply_resident_blocks(rule, eb, e)
        for rule in range(len(apply.WIDE_SLOTS)) for eb in (4, 2)
        for e in apply.WORD_ELEMS}})
    plans = apply_plan_cases(apply)
    emit({"phase": "build", "fused_sparse_apply_plans_checked": plans})


def apply_plan_cases(apply) -> int:
    """`ops/apply.launch_plan` against the kernel's own plan
    (`oe_fused_sparse_apply_plan`, which reads addresses and strides and
    nothing they point to) for every rule, widths from 1 to 1024, both
    table types, and each array in turn moved 2, 4 or 8 bytes off a
    16-byte boundary or given an odd or even row stride; returns the cases
    checked."""
    base = 1 << 20
    cases = 0
    for rule, wide in enumerate(apply.WIDE_SLOTS):
        for dim in (1, 2, 3, 4, 9, 10, 11, 12, 16, 64, 65, 128, 1024):
            for eb in (4, 2):
                def arrays(which=-1, off=0, stride_add=0):
                    out = []
                    for k in range(wide + 2):
                        bytes_ = eb if k == 0 else 4
                        addr = base * (k + 1) + (off if k == which else 0)
                        out.append((addr, dim + (stride_add if k == which
                                                 else 0), bytes_))
                    return out
                variants = [arrays()]
                for which in range(wide + 2):
                    variants += [arrays(which, off) for off in (2, 4, 8)
                                 if off % (eb if which == 0 else 4) == 0]
                    variants += [arrays(which, 0, add) for add in (1, 2)]
                for arrs in variants:
                    want = apply.kernel_plan(rule, dim, arrs)
                    got = apply.launch_plan(rule, dim, arrs)
                    check((got.word_elems, got.tile_rows) == want,
                          f"ops/apply.launch_plan {got} is the kernel's "
                          f"plan {want} (rule {rule}, width {dim}, arrays "
                          f"{arrs})")
                    cases += 1
    return cases


def phase_microbench(torch, mb, ops) -> tuple:
    """The micro-benchmark at full size; -> (its records, the launches that
    ran: its train step's graph counted as it replayed, not as captured)."""
    ops.reset_launch_counts()  # the path's run: counts read just after
    records = mb.main([])
    graphs = [r for r in records if "launches_per_replay" in r]
    check(len(graphs) == 1, "the micro-benchmark ran one graph driver")
    launches = ran_launches(ops.launch_counts(), graphs)
    for k in KERNELS:
        check(launches[k] > 0, f"the micro-benchmark launched {k}")
    emit({"phase": "microbench", "records": len(records),
          "launches": launches, "graph": {k: graphs[0][k] for k in (
              "captures", "replays", "launches_per_replay")}})
    return records, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from openembedding_tpu_torch import data, microbench as mb, optimizers
    from openembedding_tpu_torch import ops
    from openembedding_tpu_torch.ops import (_build, apply, gather,
                                             gather_windows, sparse)
    phase_build(torch, (gather, gather_windows, apply), _build)

    main_gather = phase_kernel(torch, mb, gather)
    main_windows, profile_calls = phase_windows(
        torch, mb, gather, gather_windows, sparse, data)
    torch.cuda.empty_cache()
    main_apply, apply_calls = phase_apply(torch, mb, apply, gather, sparse,
                                          optimizers, data)
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch, ops, gather)
    train = phase_train(torch, mb, ops, optimizers, data)
    torch.cuda.empty_cache()
    _, bench_launches = phase_microbench(torch, mb, ops)
    kernels_profile(torch, "windows", profile_calls, "window_gather")
    kernels_profile(torch, "apply", apply_calls, "fused_apply")
    by_path = {k: {"serve": serve_launches if k == "gather_rows" else 0,
                   "train": train["launches"][k],
                   "train_graphs": train["graph_launches"][k],
                   "microbench": bench_launches[k]} for k in KERNELS}
    rows = [("gather_rows", "gather_rows.cu", ":148", main_gather),
            ("gather_rows_windows", "gather_rows_windows.cu", ":282",
             main_windows),
            ("fused_sparse_apply", "fused_sparse_apply.cu", ":464",
             main_apply)]
    emit({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"openembedding_tpu_torch/csrc/{src}",
        "replaces": f"openembedding_tpu/ops/pallas_sparse.py{line}",
        "launches": sum(by_path[k].values()),
        "launches_by_path": by_path[k],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": "bytes",
        "library_ms": rec["library_ms"]} for k, src, line, rec in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
