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
   the apply phase, torch.profiler must see one device kernel per call
   (traced after the three kernel phases' timings, and before the later
   phases' many profiler sessions, after which a session has once traced
   no kernel at all). Times: the kernel, its plain version, the gather
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
   learning_rate_power -0.7 (`powf`) within a stated tolerance. Then
   torch.profiler must see one device kernel per apply call;
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
8. example — the Criteo training entry point (`python -m
   openembedding_tpu_torch.examples.criteo_deepctr`, through its `main`)
   on a Criteo-format TSV written from a seed (20 x 4096 rows, about 20 MB:
   a label, 13 integer counts and 26 8-hex-digit Zipfian tokens, about 5%
   of the fields empty) and its .gz copy. The native reader's batches
   (plain and .gz) must be byte-identical to the Python reader's; both
   engines' rows/s, and the native reader's steady ms per batch as the
   entry point's loop reads it. The full-width DeepFM at `--vocabulary 16777216 --dim 9
   --batch-size 4096`, 64 steps (the file repeats), through eager steps,
   `jit_train_step` and `jit_train_many` (`--scan 16`), each with and
   without `--prefetch` (pinned, double-buffered, side stream): every run
   bit-equal (losses and whole state) to the same steps through both plain
   versions with no prefetch, and launching one gather and one apply a
   step; ex/s and the idle share of each (its driver's device busy time
   under the profiler against the run's steady wall time). Save after one
   pass of the file, load into a fresh state, continue: bit-equal to the
   uninterrupted plain run; the export's logits equal `eval_step`'s.
   The copy alone: `jit_train_step` over the file's batches already
   parsed, each batch copied pageable, by the pinned prefetch as the steps
   run, or pinned before the loop, in turns.
   `--cache` with a 2^20 x 10 sparse_as_dense table: eager and graph
   drivers bit-equal to the plain path, the profiler sees the gather kernel
   on the table's pull, and the checkpoint and export round-trip it;
9. hash    — the hashed flagship, `make_deepfm(1 << 24, 9, hashed=True,
   capacity=1 << 24)` (2^24 int64 keys, a 2^24 x 10 float32 table and its
   Adagrad accumulator), on the example phase's TSV (written again from
   its seed) read into the 2^62 id space: 64 eager steps, 64
   `jit_train_step` calls and four `jit_train_many` windows of 16, each
   bit-equal in losses and whole state (keys, weights, slots, overflow,
   dense) to the same steps through the plain versions, one gather and one
   apply a step; save after 20 steps, load into a fresh state and run the
   other 44: the losses and the id -> row contents of the uninterrupted
   run; the export's logits equal `eval_step`'s; a table of a quarter of
   one batch's unique ids, 8 eager and 8 graph steps bit-equal to the
   plain path with the same nonzero overflow; the same table filled to
   0.6 of its slots with seeded ids before one pass of the file (3 eager
   steps, then graph steps), bit-equal to the plain path. Reports, at
   both loads, the probe's device time and launches a step (the kernels
   inside its profiler range in eager steps; the push takes the pull's
   slots, so a step probes once), each probe alone by CUDA events, the
   graph step's ms, device ms and idle share (beside the array flagship's
   graph run of the example phase), the load and the new ids of every
   step, and the peak device memory;
10. lr_example — `python -m
   openembedding_tpu_torch.examples.criteo_lr_subclass` through its `main`
   at its own settings (a hashed LR of 2^16 slots on
   `examples/train100.tsv`, batch 32, 4 epochs) with `--checkpoint` and
   `--save`, bit-equal to its steps through the plain versions (eager:
   the plain apply cannot be captured), then `--load` of the checkpoint
   for one more epoch;
11. zoo    — the entry point's `main` for `--model` lr, wdl, xdeepfm, dcn
   and dlrm at `--vocabulary 16777216 --dim 9 --batch-size 4096` on the
   TSV: 16 eager and 16 graph steps, each bit-equal to the plain path, one
   gather a step (and one at init) and one apply a step; the graph run's
   export served over REST, its logits equal to `eval_step`'s; ms, device
   ms and idle share a step per family;
12. mesh   — the mesh path (`openembedding_tpu_torch.parallel`), each
   run bit-equal to the same run through the plain versions. mesh1:
   `make_deepfm(1 << 24, 9)` through `MeshTrainer` on a one-rank NCCL
   group (`case_mesh1` of `bench.py`), the train phase's batches: 24
   eager steps and two windows of 16, then the same through
   `jit_train_step` and `jit_train_many` (no collective at S = 1), one
   gather and one apply a step; the single-device Trainer from the same
   state (its largest difference reported), ms a step, device ms and idle
   share beside the array flagship's graph step. mesh4-staged: four gloo
   ranks spawned on the one card (`multihost.run_local`; the kernels were
   built before they start), the same table at 2^22 rows a shard, global
   batch 4096 (1,024 a rank): four eager steps at the fp32 wire and four
   at the default bf16 wire (a float32 tower), and two steps of the
   hashed flagship (2^22 slots a shard); each rank holds its steps bit-equal to the plain
   versions (keys and overflow too) and launches both kernels; step 0's
   rows (fp32 wire) within rtol 1e-5 / atol 1e-6 of the single-device
   Trainer with its loss scaled by 4, from the same shards interleaved;
   ms a step and the bytes staged through the host. The entry point's
   `--mesh` at one rank on the TSV: a graph run saved (sharded) after one
   pass, loaded, 16 steps more, held to one uninterrupted plain run. NCCL
   across cards (`jit_train_step` captured) only where the machine has
   two cards or more; otherwise the phase says it did not run;
13. microbench — `openembedding_tpu_torch.microbench` at full size (its own
   JSON lines): every kernel at widths 64 and 128 against its plain version
   and a library call, and the train step through the graph, eager and
   plain. Its launches are counted as they ran: its graph's capture is
   taken out and its replays put in.

Then the `kernels` line, and last `{"ok": true, "device": {...}}`.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gzip
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
    # LR's table: rows one float wide (4 bytes), the hashed pull's miss row
    # (slot == capacity) and -1 pads among the ids
    w1 = torch.randn((VOCAB, 1), generator=gen, device=dev)
    ids1_np = ids64_np.copy()
    ids1_np[100:140] = VOCAB
    cases += [("f32 width 1: LR's 4-byte rows", w1, ids1_np, torch.int64,
               None),
              ("f32 width 9: 4-byte words", w9, ids22_np, torch.int64, None),
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


def by_id_bits(torch, mb, state) -> dict:
    """`mb.state_bits` with every hash table's resident rows (keys, weights,
    slots) in id order: a table loaded from a checkpoint may hold two
    colliding ids at each other's slots, and equals the saved one in its
    id -> row contents."""
    out = mb.state_bits(state)
    for name, t in state.tables.items():
        if t.keys is None:
            continue
        sel = torch.nonzero(t.keys >= 0).squeeze(1)
        rows = sel[torch.argsort(t.keys[sel])]
        out[f"{name}/keys"] = t.keys[rows]
        out[f"{name}/weights"] = t.weights[rows]
        out.update({f"{name}/{k}": v[rows] for k, v in t.slots.items()})
    return out


def _compare(torch, mb, state, losses, ref, ref_losses, what: str,
             by_id: bool = False) -> dict:
    bits = (lambda s: by_id_bits(torch, mb, s)) if by_id else mb.state_bits
    got, want = bits(state), bits(ref)
    check(got.keys() == want.keys() and all(
        got[k].shape == want[k].shape for k in got),
        f"{what}: the states hold the same tensors and shapes")
    diffs = {k: float((got[k].double() - want[k].double()).abs().max())
             if got[k].numel() else 0.0 for k in got}
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
    """What a `model.CompiledStep` has counted so far (copies: the driver
    counts on): captures, replays, the launches of one replay of each graph
    it keeps, and the launches its captures counted and its replays ran."""
    return {"captures": driver.captures, "replays": driver.replays,
            "graph_launches": driver.graph_launches,
            "launches_captured": dict(driver.launches_captured),
            "launches_replayed": dict(driver.launches_replayed)}


def ran_launches(counted: dict, graphs, captures: int = 1) -> dict:
    """The kernel launches that ran on the card in a run through CUDA-graph
    drivers, from their `graph_record`s: the wrappers' counts over the run
    less what each capture counted, since a captured launch runs nothing,
    plus what each replay ran. Each driver must have captured `captures`
    times, once per batch structure of the run, and kept every graph: a
    driver that captures again for a structure it has seen fails."""
    out = dict(counted)
    for d in graphs:
        check(d["captures"] == captures == len(d["graph_launches"]),
              f"{captures} capture(s) per driver, each graph kept ({d})")
        for k in out:
            out[k] += (d["launches_replayed"].get(k, 0)
                       - d["launches_captured"].get(k, 0))
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
        check(d["graph_launches"] == [{
            "gather_rows": k * n_tables, "gather_rows_windows": 0,
            "fused_sparse_apply": k * n_tables}],
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


EXAMPLE_BATCHES = 20      # the TSV: 20 x 4096 rows, one pass of the file
EXAMPLE_STEPS = 64        # each driving run; the file repeats (period 20)
EXAMPLE_K = 16            # --scan K: four windows of 16
CACHE_VOCAB = 1 << 20     # --cache: a 2^20 x 10 float32 sparse_as_dense table
CACHE_STEPS = 24
SAVE_STEPS = EXAMPLE_BATCHES  # save after one pass: the resumed run reads
                              # the batches the uninterrupted run reads next


def write_criteo_tsv(path: str, rows: int, seed: int) -> None:
    """Criteo-format rows from a seed, shaped like the day logs: a 0/1 label
    (25% clicks), 13 heavy-tailed integer counts (1% of them -1) and 26
    categorical 8-hex-digit tokens, Zipfian within each field; about 5% of
    the fields empty."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(rows) < 0.25).astype(np.int64)
    ints = np.floor(rng.pareto(1.5, (rows, NUM_DENSE)) * 3).astype(np.int64)
    ints[rng.random(ints.shape) < 0.01] = -1
    ranks = (rng.zipf(1.2, (rows, FIELDS)) - 1).astype(np.uint64)
    salt = np.arange(FIELDS, dtype=np.uint64) * np.uint64(0x9E3779B9)
    toks = (ranks * np.uint64(2654435761) + salt) & np.uint64(0xFFFFFFFF)
    empty = rng.random((rows, NUM_DENSE + FIELDS)) < 0.05
    with open(path, "w") as f:
        for r in range(rows):
            e = empty[r]
            cols = [str(labels[r])]
            cols += ["" if e[i] else str(v) for i, v in enumerate(ints[r])]
            cols += ["" if e[NUM_DENSE + i] else f"{int(t):08x}"
                     for i, t in enumerate(toks[r])]
            f.write("\t".join(cols) + "\n")


def _same_batches(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        pairs = [(x["label"], y["label"]), (x["dense"], y["dense"]),
                 (x["sparse"]["categorical"], y["sparse"]["categorical"])]
        if any(u.dtype != v.dtype or u.shape != v.shape
               or u.tobytes() != v.tobytes() for u, v in pairs):
            return False
    return True


def example_reader(data, tsv: str, gz: str) -> list:
    """The native and the Python engine on the TSV, and the native engine on
    its .gz copy: byte-identical batches, and each engine's rows/s (the
    native library built first, its build timed apart)."""
    from openembedding_tpu_torch import native as native_mod
    t0 = time.perf_counter()
    native_mod.load()
    build_s = time.perf_counter() - t0

    def read(path, engine):
        t0 = time.perf_counter()
        out = list(data.read_criteo_tsv(path, BATCH, id_space=VOCAB,
                                        native=engine))
        return out, time.perf_counter() - t0

    native, native_s = read(tsv, "on")
    python, python_s = read(tsv, "off")
    gzipped, gz_s = read(gz, "on")
    # the entry point's input as its loop sees it: the native reader
    # repeating the file through CriteoBatcher, past its first batch
    it = iter(data.CriteoBatcher(data.read_criteo_tsv(
        tsv, BATCH, id_space=VOCAB, repeat=True, native="on"), BATCH))
    next(it)
    t0 = time.perf_counter()
    for _ in range(EXAMPLE_STEPS):
        next(it)
    steady_ms = (time.perf_counter() - t0) * 1e3 / EXAMPLE_STEPS
    it.close()
    rows = EXAMPLE_BATCHES * BATCH
    same = _same_batches(native, python)
    same_gz = _same_batches(native, gzipped)
    emit({"phase": "example", "case": "reader", "rows": rows,
          "tsv_bytes": os.path.getsize(tsv), "gz_bytes": os.path.getsize(gz),
          "native_build_s": build_s,
          "batches": len(native),
          "native_rows_per_s": rows / native_s,
          "python_rows_per_s": rows / python_s,
          "native_gz_rows_per_s": rows / gz_s,
          "native_steady_ms_per_batch": steady_ms,
          "native_steady_rows_per_s": BATCH / steady_ms * 1e3,
          "native_vs_python_byte_identical": same,
          "gz_byte_identical": same_gz})
    check(len(native) == EXAMPLE_BATCHES and same and same_gz,
          "the native reader's batches (plain and .gz) are byte-identical "
          "to the Python reader's")
    return native


def _run_main(ops, ex, argv, captures: int = 1) -> tuple:
    """`ex.main(argv)`, the counts set to 0 just before and read just after
    -> (its result, the kernel launches that ran). `captures`: the batch
    structures of the run, each captured once by a graph driver."""
    from openembedding_tpu_torch.model import CompiledStep
    ops.reset_launch_counts()
    out = ex.main(argv)
    counted = ops.launch_counts()
    drv = out["driver"]
    if isinstance(drv, CompiledStep):
        out["graph"] = graph_record(drv)
        return out, ran_launches(counted, [out["graph"]], captures)
    return out, counted


def _driver_profile(torch, ex, out, batches, many: bool) -> dict:
    """The run's device busy time per step (its driver on more batches of
    the file, under torch.profiler, after the run was checked) and the idle
    share of its steady window against it."""
    drv, state = out["driver"], out["state"]
    arg = ex.stack_batches(batches[:EXAMPLE_K]) if many else batches[0]

    def call():
        drv(state, arg)
        torch.cuda.synchronize()

    prof = profile_device(torch, call, calls=3,
                          unit="window" if many else "step")
    busy = (prof["profile_device_ms_per_window"] / EXAMPLE_K if many
            else prof["profile_device_ms_per_step"])
    steady_ms = out["steady_seconds"] * 1e3
    return {"device_ms_per_step": busy,
            "device_idle_share": 1.0 - busy * out["steady_steps"] / steady_ms,
            "profile_top_device_ops": prof["profile_top_device_ops"]}


def _example_record(torch, mb, out, launches, ref_state, ref_losses,
                    what: str, steps: int, n_apply: int) -> dict:
    """A run's numbers, its losses and state held bit-equal to the plain
    run's (`ref_state` None: a run that stops early, whose losses are held
    to the plain run's first ones), and its launches checked: the model has
    one table, pulled by the gather each step and, unless it is
    sparse_as_dense (`n_apply` 0), pushed by the apply."""
    rec = {"run": what, "steps": out["steps"], "loss": out["loss"],
           "examples_per_s": out["examples_per_s"],
           "steady_examples_per_s": out["steady_examples_per_s"],
           "steady_ms_per_step": out["steady_seconds"] * 1e3
           / max(out["steady_steps"], 1),
           "train_auc": out["train_auc"], "launches": launches}
    if "graph" in out:
        rec["graph"] = out["graph"]
    if ref_state is None:
        equal = np.array_equal(out["losses"].view(np.int32),
                               ref_losses[:steps].view(np.int32))
        rec["loss_bit_equal_vs_plain"] = equal
        check(equal, f"{what}: losses equal the plain run's bit for bit")
    else:
        rec.update(_compare(torch, mb, out["state"], out["losses"],
                            ref_state, ref_losses, "vs_plain"))
    # the gather launches once more at init: the pass that materializes
    # the dense module pulls the first batch
    check(launches["gather_rows"] == steps + 1
          and launches["fused_sparse_apply"] == steps * n_apply
          and launches["gather_rows_windows"] == 0,
          f"{what}: launched one gather a step and one at init, and "
          f"{n_apply} apply a step ({launches})")
    return rec


def example_in_memory(torch, data, optimizers, batches) -> dict:
    """The copy alone, without the reader: `jit_train_step` over the file's
    batches already parsed (cycled), each batch copied (1) pageable by the
    step, (2) pinned by `prefetch_to_device`'s producer thread as the steps
    run, or (3) pinned by the same stager before the loop (all staged,
    no producer running: the floor of the pinned copy), in turns (1 2 3 3
    2 1), 64 timed steps each after 4 untimed."""
    import itertools

    from openembedding_tpu_torch.data.criteo import _PinnedStager
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    trainer = Trainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                      optimizers.Adagrad(learning_rate=0.05))
    state = trainer.init(batches[0])
    step = trainer.jit_train_step()
    modes = ("pageable", "pinned_prefetch", "pinned_staged_before")
    out = {f"{mode}_ms_per_step": [] for mode in modes}
    for mode in modes + modes[::-1]:
        it = itertools.cycle(batches)
        if mode == "pinned_prefetch":
            it = data.prefetch_to_device(it)
        elif mode == "pinned_staged_before":
            stager = _PinnedStager(torch.device("cuda"), EXAMPLE_STEPS + 4)
            staged = [stager.stage(next(it))
                      for _ in range(EXAMPLE_STEPS + 4)]
            torch.cuda.synchronize()
            it = (stager.hand_over(x) for x in staged)
        for _ in range(4):
            state, m = step(state, next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXAMPLE_STEPS):
            state, m = step(state, next(it))
        torch.cuda.synchronize()
        out[f"{mode}_ms_per_step"].append(
            (time.perf_counter() - t0) * 1e3 / EXAMPLE_STEPS)
        if mode == "pinned_prefetch":
            it.close()
    check(np.isfinite(float(m["loss"])), "finite loss")
    emit({"phase": "example", "case": "graph step, batches in memory",
          **out})
    return out


def phase_example(torch, mb, ops, data, optimizers) -> dict:
    """The Criteo training entry point (`python -m
    openembedding_tpu_torch.examples.criteo_deepctr`) at full width on a
    Criteo TSV from a seed; -> {kernel: launches in the phase's runs}."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.export import StandaloneModel

    tmp = tempfile.mkdtemp(prefix="chip_smoke-example-")
    total = {k: 0 for k in KERNELS}
    try:
        tsv, gz = os.path.join(tmp, "day.tsv"), os.path.join(tmp, "day.tsv.gz")
        t0 = time.perf_counter()
        write_criteo_tsv(tsv, EXAMPLE_BATCHES * BATCH, SEED + 3)
        with open(tsv, "rb") as f, gzip.open(gz, "wb", compresslevel=1) as g:
            shutil.copyfileobj(f, g)
        emit({"phase": "example", "case": "data", "write_s":
              time.perf_counter() - t0})
        batches = example_reader(data, tsv, gz)
        on_card = [{"sparse": {"categorical": torch.from_numpy(
                        b["sparse"]["categorical"]).cuda()},
                    "dense": torch.from_numpy(b["dense"]).cuda(),
                    "label": torch.from_numpy(b["label"]).cuda()}
                   for b in batches[:EXAMPLE_K]]

        def argv(steps, *extra, vocab=VOCAB):
            return ["--vocabulary", str(vocab), "--dim", str(DIM),
                    "--batch-size", str(BATCH), "--data", tsv,
                    "--steps", str(steps), *extra]

        def drive(args, what, ref, ref_losses, steps, n_apply=1,
                  profile=True):
            """One run of the entry point, checked; a run held to the
            whole plain run (`ref` given) is profiled too, unless told
            not to."""
            out, launches = _run_main(ops, ex, args)
            for k in KERNELS:
                total[k] += launches[k]
            rec = _example_record(torch, mb, out, launches, ref, ref_losses,
                                  what, steps, n_apply)
            if ref is not None and profile:
                prefetch = "--prefetch" in args
                rec.update(_driver_profile(
                    torch, ex, out, on_card if prefetch else batches,
                    "--scan" in args))
            return out, rec

        # the plain path: eager steps through both plain versions, no
        # prefetch; no launch may be counted
        ops.reset_launch_counts()
        with ops.plain_versions():
            ref = ex.main(argv(EXAMPLE_STEPS, "--eager"))
        check(sum(ops.launch_counts().values()) == 0,
              "the plain run launched no kernel")
        ref_state, ref_losses = ref["state"], ref["losses"]
        check(np.isfinite(ref_losses).all(), "finite losses")
        del ref
        runs = []
        order = [("eager", ["--eager"]), ("eager+prefetch",
                                          ["--eager", "--prefetch"]),
                 ("graph", []), ("graph+prefetch", ["--prefetch"]),
                 ("graph+prefetch", ["--prefetch"]), ("graph", []),
                 ("scan", ["--scan", str(EXAMPLE_K)]),
                 ("scan+prefetch", ["--scan", str(EXAMPLE_K), "--prefetch"]),
                 ("scan+prefetch", ["--scan", str(EXAMPLE_K), "--prefetch"]),
                 ("scan", ["--scan", str(EXAMPLE_K)])]
        for what, extra in order:
            # one profiler session per way of stepping: the repeat of each
            # is timed only
            out, rec = drive(argv(EXAMPLE_STEPS, *extra), what, ref_state,
                             ref_losses, EXAMPLE_STEPS,
                             profile=all(r["run"] != what for r in runs))
            emit({"phase": "example", "case": "train", **rec})
            runs.append(rec)
            del out
            torch.cuda.empty_cache()

        # save after one pass, load into a fresh state, continue: equal to
        # the uninterrupted plain run
        ckpt, export = os.path.join(tmp, "ckpt"), os.path.join(tmp, "export")
        first, _ = drive(argv(SAVE_STEPS, "--prefetch", "--save", ckpt,
                              "--export", export),
                         "graph+prefetch, save", None, ref_losses,
                         SAVE_STEPS)
        served = StandaloneModel.load(export)
        want = first["trainer"].eval_step(first["state"], batches[0])
        got = served.predict(batches[0])
        export_equal = torch.equal(got, want["logits"])
        check(export_equal, "the export's logits equal eval_step's")
        first_losses = first["losses"]
        del first, served
        torch.cuda.empty_cache()
        resumed, launched = _run_main(
            ops, ex, argv(EXAMPLE_STEPS - SAVE_STEPS, "--prefetch",
                          "--load", ckpt))
        for k in KERNELS:
            total[k] += launched[k]
        check(launched["gather_rows"] - 1 == launched["fused_sparse_apply"]
              == EXAMPLE_STEPS - SAVE_STEPS, f"the resumed run launched one "
              f"gather and one apply a step, and one gather at init "
              f"({launched})")
        losses = np.concatenate([first_losses, resumed["losses"]])
        resume = _compare(torch, mb, resumed["state"], losses, ref_state,
                          ref_losses, "save_load_continue_vs_uninterrupted")
        emit({"phase": "example", "case": "save, load, continue",
              "save_steps": SAVE_STEPS,
              "continue_steps": EXAMPLE_STEPS - SAVE_STEPS,
              "export_logits_equal_eval_step": export_equal, **resume})
        del resumed, ref_state
        torch.cuda.empty_cache()
        in_memory = example_in_memory(torch, data, optimizers, batches)
        torch.cuda.empty_cache()
        cache = example_cache(torch, mb, ops, ex, argv, drive, batches, tmp,
                              total)
        return {"launches": total, "runs": runs, "cache": cache,
                "in_memory": in_memory}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def example_cache(torch, mb, ops, ex, argv, drive, batches, tmp, total
                  ) -> dict:
    """--cache: the table as a 2^20 x 10 sparse_as_dense table (and its
    Adagrad accumulator), pulled by the gather kernel with a gradient and
    updated whole by the dense path; eager and graph drivers bit-equal to
    the plain path, checkpoint and export round-tripped."""
    from openembedding_tpu_torch.export import StandaloneModel
    cache = ["--cache", str(CACHE_VOCAB)]

    def args(steps, *extra):
        return argv(steps, *cache, *extra, vocab=CACHE_VOCAB)

    with ops.plain_versions():
        ref = ex.main(args(CACHE_STEPS, "--eager"))
    state = ref["state"]
    check(state.tables == {} and state.embeddings["categorical"].shape
          == (CACHE_VOCAB, DIM + 1), "the --cache table is sparse_as_dense")
    out = {}
    for what, extra in (("eager+prefetch", ["--eager", "--prefetch"]),
                        ("graph+prefetch", ["--prefetch"])):
        run, rec = drive(args(CACHE_STEPS, *extra), f"cache {what}", state,
                         ref["losses"], CACHE_STEPS, n_apply=0)
        if what.startswith("eager"):
            def one_step():
                run["trainer"].train_step(run["state"], batches[0])
            names, sessions = device_kernels(torch, one_step)
            rec["profiler_kernels_per_step"] = len(names)
            rec["profiler_gather_kernels"] = [n[:60] for n in names
                                              if "gather_rows_kernel" in n]
            check(len(rec["profiler_gather_kernels"]) == 1,
                  f"the profiler sees the gather kernel on the "
                  f"sparse_as_dense pull ({names})")
        emit({"phase": "example", "case": "cache train", **rec})
        out[what] = rec
        del run
        torch.cuda.empty_cache()
    ckpt, export = os.path.join(tmp, "ckpt_cache"), os.path.join(
        tmp, "export_cache")
    half = SAVE_STEPS  # one pass of the file, as for the flagship
    first, _ = drive(args(half, "--prefetch", "--save", ckpt, "--export",
                          export), "cache save", None, ref["losses"], half,
                     n_apply=0)
    served = StandaloneModel.load(export)
    export_equal = torch.equal(
        served.predict(batches[0]),
        first["trainer"].eval_step(first["state"], batches[0])["logits"])
    check(export_equal, "the --cache export's logits equal eval_step's")
    del first, served
    resumed, launched = _run_main(
        ops, ex, args(CACHE_STEPS - half, "--prefetch", "--load", ckpt))
    for k in KERNELS:
        total[k] += launched[k]
    check(launched["gather_rows"] == CACHE_STEPS - half + 1
          and launched["fused_sparse_apply"] == 0,
          f"the resumed --cache run launched one gather a step and one at "
          f"init ({launched})")
    losses = np.concatenate([ref["losses"][:half], resumed["losses"]])
    out["save_load_continue"] = _compare(
        torch, mb, resumed["state"], losses, state, ref["losses"],
        "cache_save_load_continue_vs_uninterrupted")
    out["export_logits_equal_eval_step"] = export_equal
    emit({"phase": "example", "case": "cache save, load, continue",
          **out["save_load_continue"],
          "export_logits_equal_eval_step": export_equal})
    return out


HASH_CAPACITY = 1 << 24   # the hashed flagship's slots (2^24 x 10 table)
HASH_ID_SPACE = 1 << 62   # the reader folds tokens into the hashed id space
HASH_STEPS = 64           # each way of stepping
HASH_SAVE = 20            # save after 20 steps, load, run the other 44
HASH_K = 16               # jit_train_many windows: four of 16
SMALL_STEPS = 8           # the small-capacity run that overflows
LOADED_FILL = 0.6         # the loaded run: the share of slots filled first
LOADED_STEPS = 20         # its steps: one pass of the file, new ids in each
LOADED_EAGER = 3          # its first steps, eager under the profiler


def _tsv_batches(data, tsv: str, id_space: int, steps: int) -> list:
    """`steps` batches of the TSV through the native reader, the file
    repeating, as the entry points read it."""
    it = iter(data.CriteoBatcher(data.read_criteo_tsv(
        tsv, BATCH, id_space=id_space, repeat=True, native="on"), BATCH))
    out = [next(it) for _ in range(steps)]
    it.close()
    return out


def _eager(torch, trainer, state, batches) -> tuple:
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    return state, torch.stack(losses).cpu().numpy()


def _graph_steps(torch, step, state, batches) -> tuple:
    """`step` over the batches, its losses cloned; the steps after the
    first WARM_STEPS timed -> (state, losses, ms a step)."""
    losses = []
    for i, b in enumerate(batches):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - WARM_STEPS)
    return state, torch.stack(losses).cpu().numpy(), ms


def probe_profile(torch, fn, calls: int = 3) -> dict:
    """The hash probe's share of `calls` eager train steps under
    torch.profiler: the device kernels that start inside the device-side
    spans of the `hash.probe_insert` range (the step's one probe: the push
    takes the pull's slots), their summed time and their count, per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("hash.probe")]
    kernels = [e for e in events if not e.name.startswith(("hash.",
                                                          "trainer."))]
    inside = [e for e in kernels
              if any(a <= e.time_range.start < b for a, b in spans)]
    probe_us = sum(e.time_range.elapsed_us() for e in inside)
    step_us = sum(e.time_range.elapsed_us() for e in kernels)
    check(len(spans) == calls and probe_us > 0,
          f"the profiler saw one probe range a step ({len(spans)} spans)")
    return {"probe_device_ms_per_step": probe_us / 1e3 / calls,
            "probe_launches_per_step": len(inside) / calls,
            "step_device_ms_per_step": step_us / 1e3 / calls,
            "step_launches_per_step": len(kernels) / calls}


def new_ids_per_step(batches, resident=()) -> list:
    """How many of each batch's distinct ids no earlier batch (nor
    `resident`) held: the ids its pull inserts into a table that overflows
    nothing."""
    seen = np.asarray(resident, np.int64)
    out = []
    for b in batches:
        ids = np.unique(b["sparse"]["categorical"])
        ids = ids[ids >= 0]
        new = ids[~np.isin(ids, seen)]
        out.append(int(len(new)))
        seen = np.concatenate([seen, new])
    return out


def hash_loaded(torch, mb, ops, trainer, batches) -> dict:
    """The flagship's table filled to LOADED_FILL with seeded ids of the
    2^62 space before the run, as a day of Criteo fills it: one pass of the
    file (every step inserts ids) from it, the first LOADED_EAGER steps
    eager under the profiler (the probe's device time at this load), the
    rest through `jit_train_step` (timed), all bit-equal to the same steps
    through the plain versions; then the graph step's device ms."""
    from openembedding_tpu_torch.tables import hash_table
    state = trainer.init(batches[0])
    keys = state.tables["categorical"].keys
    rng = np.random.default_rng(SEED + 11)
    fill = np.unique(rng.integers(0, HASH_ID_SPACE,
                                  int(LOADED_FILL * HASH_CAPACITY)))
    fill_overflow = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for chunk in np.array_split(fill, 8):
        _, over = hash_table.hash_find_or_insert(
            keys, torch.as_tensor(chunk, device="cuda"))
        fill_overflow += int(over)
    fill_s = time.perf_counter() - t0
    load_before = int((keys >= 0).sum()) / HASH_CAPACITY
    ref = state.clone()
    runs = batches[:LOADED_STEPS]
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, runs)
    ops.reset_launch_counts()
    losses, it = [], iter(runs)

    def eager_step():
        nonlocal state
        state, m = trainer.train_step(state, next(it))
        losses.append(m["loss"])

    probe = probe_profile(torch, eager_step, calls=LOADED_EAGER)
    eager = ops.launch_counts()
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    state, graph_losses, graph_ms = _graph_steps(torch, step, state,
                                                 runs[LOADED_EAGER:])
    ran = ran_launches(ops.launch_counts(), [graph_record(step)])
    for k in ("gather_rows", "fused_sparse_apply"):
        check(eager[k] == LOADED_EAGER and
              ran[k] == LOADED_STEPS - LOADED_EAGER,
              f"the loaded run: one {k} a step ({eager}, {ran})")
    rec = _compare(torch, mb, state, np.concatenate(
        [torch.stack(losses).cpu().numpy(), graph_losses]), ref, ref_losses,
        "loaded_vs_plain")
    del ref

    def one_replay():
        step(state, runs[0])
        torch.cuda.synchronize()

    device_ms = profile_device(torch, one_replay, calls=5,
                               unit="step")["profile_device_ms_per_step"]
    out = {"fill_ids": int(len(fill)), "fill_overflow": fill_overflow,
           "fill_seconds": fill_s, "load_before": load_before,
           "load_after": int((keys >= 0).sum()) / HASH_CAPACITY,
           "steps": LOADED_STEPS, "new_ids_per_step": new_ids_per_step(runs),
           "overflow": trainer.table_overflow(state, "categorical"),
           "graph_ms_per_step": graph_ms,
           "graph_device_ms_per_step": device_ms,
           "graph_idle_share": 1.0 - device_ms / graph_ms, **probe, **rec,
           "launches": {k: eager[k] + ran[k] for k in KERNELS}}
    del state, step
    torch.cuda.empty_cache()
    return out


def hash_small_capacity(torch, mb, ops, optimizers, batches) -> dict:
    """A table of a quarter of one batch's unique ids: eager and graph steps
    through the kernels, bit-equal to the plain path, overflow equal and
    nonzero."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    ids = batches[0]["sparse"]["categorical"]
    capacity = len(np.unique(ids[ids >= 0])) // 4
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=capacity)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    base = trainer.init(batches[0])
    ref, graph_state = base.clone(), base.clone()
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, batches[:SMALL_STEPS])
    state, losses = _eager(torch, trainer, base, batches[:SMALL_STEPS])
    rec = _compare(torch, mb, state, losses, ref, ref_losses,
                   "small_capacity_vs_plain")
    step = trainer.jit_train_step()
    graph_state, graph_losses, _ = _graph_steps(
        torch, step, graph_state, batches[:SMALL_STEPS])
    rec.update(_compare(torch, mb, graph_state, graph_losses, ref,
                        ref_losses, "small_capacity_graph_vs_plain"))
    overflow = [trainer.table_overflow(s, "categorical")
                for s in (state, graph_state, ref)]
    check(overflow[0] == overflow[1] == overflow[2] > 0,
          f"the small table overflows alike on every path ({overflow})")
    return {"capacity": capacity, "steps": SMALL_STEPS,
            "overflow": overflow[0], **rec}


def phase_hash(torch, mb, ops, data, optimizers, tsv: str,
               array_graph: dict) -> dict:
    """The hashed flagship, `make_deepfm(1 << 24, 9, hashed=True, capacity=
    1 << 24)`, on the seeded TSV read into the 2^62 id space: eager steps,
    `jit_train_step` and `jit_train_many` windows, all bit-equal to the
    plain path; save, load and continue; export and serve; a small table
    that overflows; the probe's device time. -> {kernel: launches}."""
    from openembedding_tpu_torch.export import StandaloneModel, export_standalone
    from openembedding_tpu_torch.examples.criteo_deepctr import stack_batches
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.tables import hash_table

    torch.cuda.reset_peak_memory_stats()
    batches = _tsv_batches(data, tsv, HASH_ID_SPACE, HASH_STEPS)
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    base = trainer.init(batches[0])
    ts = base.tables["categorical"]
    check(ts.keys.shape == (HASH_CAPACITY,) and ts.weights.shape == (
        HASH_CAPACITY, DIM + 1), "the hashed flagship's table")
    check(trainer._packed_layouts(base) == {},
          "the gate keeps the hash table split on the card")
    ref, state, graph_state, many_state, first = (base.clone()
                                                  for _ in range(5))
    del base
    total = {k: 0 for k in KERNELS}

    def counted():
        got = ops.launch_counts()
        for k in KERNELS:
            total[k] += got[k]
        return got

    ops.reset_launch_counts()
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, batches)
    check(sum(ops.launch_counts().values()) == 0,
          "the plain run launched no kernel")
    check(np.isfinite(ref_losses).all(), "finite losses")

    # the main path's runs: counts set to 0 just before each, read after
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = _eager(torch, trainer, state, batches)
    eager_ms = (time.perf_counter() - t0) * 1e3 / HASH_STEPS
    launches = counted()
    check(launches["gather_rows"] == launches["fused_sparse_apply"]
          == HASH_STEPS, f"one gather and one apply a hashed step "
          f"({launches})")
    rec = _compare(torch, mb, state, losses, ref, ref_losses, "vs_plain")

    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    graph_state, graph_losses, graph_ms = _graph_steps(torch, step,
                                                       graph_state, batches)
    graph = {"step": graph_record(step)}
    ran = ran_launches(counted(), [graph["step"]])
    check(ran["gather_rows"] == ran["fused_sparse_apply"] == HASH_STEPS,
          f"the graph steps ran one gather and one apply a step ({ran})")
    rec.update(_compare(torch, mb, graph_state, graph_losses, ref,
                        ref_losses, "graph_vs_plain"))

    many = trainer.jit_train_many()
    ops.reset_launch_counts()
    many_losses, overflow = [], 0
    for w in range(HASH_STEPS // HASH_K):
        if w == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        many_state, m = many(many_state, stack_batches(
            batches[w * HASH_K:(w + 1) * HASH_K]))
        many_losses.append(m["loss"].clone())
        overflow += int(m["overflow"])
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / (HASH_STEPS - HASH_K)
    graph["many"] = graph_record(many)
    ran = ran_launches(counted(), [graph["many"]])
    check(ran["gather_rows"] == ran["fused_sparse_apply"] == HASH_STEPS,
          f"the windows ran one gather and one apply a step ({ran})")
    check(overflow == 0, f"no id overflows the flagship table ({overflow})")
    rec.update(_compare(torch, mb, many_state,
                        torch.cat(many_losses).cpu().numpy(), ref,
                        ref_losses, "many_vs_plain"))
    del many_state, many
    torch.cuda.empty_cache()

    # the probe: its share of an eager step under the profiler, and alone
    # (CUDA events) on one batch's ids against the trained keys
    probe = probe_profile(
        torch, lambda: trainer.train_step(state, batches[0]))
    flat = torch.as_tensor(batches[0]["sparse"]["categorical"],
                           device="cuda").reshape(-1)
    uniq = torch.unique(flat)
    keys = state.tables["categorical"].keys.clone()
    probe["probe_insert_ms_alone"] = mb.device_ms(
        lambda: hash_table.hash_find_or_insert(keys, uniq))
    probe["probe_find_ms_alone"] = mb.device_ms(
        lambda: hash_table.hash_find(keys, flat))
    del keys

    def one_replay():
        step(graph_state, batches[0])
        torch.cuda.synchronize()

    graph_profile = profile_device(torch, one_replay, calls=5, unit="step")
    device_ms = graph_profile["profile_device_ms_per_step"]

    # save after HASH_SAVE steps, load into a fresh state, run the rest:
    # the id -> row contents and the losses of the uninterrupted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke-hash-")
    try:
        ckpt, export = os.path.join(tmp, "ckpt"), os.path.join(tmp, "export")
        ops.reset_launch_counts()
        first, first_losses = _eager(torch, trainer, first,
                                     batches[:HASH_SAVE])
        trainer.save(first, ckpt)
        del first
        torch.cuda.empty_cache()
        loaded = trainer.load(trainer.init(batches[0]), ckpt)
        check(trainer.table_overflow(loaded, "categorical") == 0,
              "every saved id loads")
        loaded, rest_losses = _eager(torch, trainer, loaded,
                                     batches[HASH_SAVE:])
        got = counted()
        check(got["gather_rows"] == got["fused_sparse_apply"] == HASH_STEPS,
              f"save, load, continue: one gather and one apply a step "
              f"({got})")
        rec.update(_compare(torch, mb, loaded, np.concatenate(
            [first_losses, rest_losses]), ref, ref_losses,
            "save_load_continue_vs_uninterrupted", by_id=True))
        del loaded
        torch.cuda.empty_cache()

        ops.reset_launch_counts()
        export_standalone(graph_state, model, export)
        served = StandaloneModel.load(export)
        logits = served.predict(batches[0])
        got = counted()
        check(got["gather_rows"] == 1, f"a predict launches one gather "
              f"({got})")
        want = trainer.eval_step(graph_state, batches[0])["logits"]
        export_equal = bool(torch.equal(logits, want))
        check(export_equal, "the hashed export's logits equal eval_step's")
        del served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    del ref, graph_state, step
    torch.cuda.empty_cache()

    loaded = hash_loaded(torch, mb, ops, trainer, batches)
    for k in KERNELS:
        total[k] += loaded["launches"][k]
    ops.reset_launch_counts()
    small = hash_small_capacity(torch, mb, ops, optimizers, batches)
    counted()
    resident = int((state.tables["categorical"].keys >= 0).sum())
    new_ids = new_ids_per_step(batches)
    out = {"phase": "hash", "model": "deepfm hashed, capacity 2^24, dim 9, "
           "hidden 400-400-400 bf16, Adagrad(0.05); ids in 2^62",
           "batch": BATCH, "steps": HASH_STEPS, "resident_ids": resident,
           "load": resident / HASH_CAPACITY, "new_ids_per_step": new_ids,
           "steps_without_new_ids": sum(n == 0 for n in new_ids),
           "probe_profiled_new_ids": 0,  # batch 0 again: resident already
           "losses_first_last": [float(losses[0]), float(losses[-1])],
           "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "graph_device_ms_per_step": device_ms,
           "graph_idle_share": 1.0 - device_ms / graph_ms,
           "graph_many_ms_per_step": many_ms,
           "array_flagship_graph": array_graph,
           "graph_profile_top_device_ops":
               graph_profile["profile_top_device_ops"],
           **probe, "graphs": graph, "export_logits_equal_eval_step":
           export_equal, "peak_memory_bytes": peak, **rec,
           "loaded": loaded, "small_capacity": small, "launches": total}
    emit(out)
    del state
    torch.cuda.empty_cache()
    return total


def phase_lr_example(torch, mb, ops) -> dict:
    """The hashed-LR example (`python -m
    openembedding_tpu_torch.examples.criteo_lr_subclass`) at its own
    settings, with --checkpoint and --save, then --load: bit-equal to the
    same run through the plain versions. -> {kernel: launches}."""
    from openembedding_tpu_torch.examples import criteo_lr_subclass as lr
    from openembedding_tpu_torch.model import Trainer
    tmp = tempfile.mkdtemp(prefix="chip_smoke-lr-")
    total = {k: 0 for k in KERNELS}
    try:
        ckpt, saved = os.path.join(tmp, "ckpt"), os.path.join(tmp, "saved")
        ops.reset_launch_counts()
        # the plain path: the example's steps as eager train_steps (the
        # plain apply reads its live rows back to the host, which a graph
        # cannot capture)
        with ops.plain_versions(), mock.patch.object(
                Trainer, "jit_train_step", lambda self: self.train_step):
            ref = lr.main([])
        check(sum(ops.launch_counts().values()) == 0,
              "the plain run launched no kernel")
        t0 = time.perf_counter()
        # a pass is three full batches and a padded one (100 rows, batch
        # 32): two batch structures, two graphs
        out, launches = _run_main(ops, lr, ["--checkpoint", ckpt,
                                            "--save", saved], captures=2)
        seconds = time.perf_counter() - t0
        steps = len(out["losses"])
        check(launches["gather_rows"] == launches["fused_sparse_apply"]
              == steps, f"one gather and one apply a step ({launches})")
        rec = _compare(torch, mb, out["state"], out["losses"], ref["state"],
                       ref["losses"], "vs_plain")
        check(not os.path.exists(os.path.join(saved, "dense_slots.npz"))
              and os.path.exists(os.path.join(ckpt, "dense_slots.npz")),
              "--save leaves the optimizer out, --checkpoint keeps it")
        resumed, more = _run_main(ops, lr, ["--load", ckpt, "--epochs", "1"],
                                  captures=2)
        check(resumed["state"].step == steps + len(resumed["losses"])
              and np.isfinite(resumed["losses"]).all()
              and more["gather_rows"] == more["fused_sparse_apply"]
              == len(resumed["losses"]), f"--load resumes ({more})")
        for k in KERNELS:
            total[k] = launches[k] + more[k]
        emit({"phase": "lr_example", "steps": steps,
              "resumed_steps": len(resumed["losses"]),
              "overflow": out["trainer"].table_overflow(out["state"],
                                                        "categorical"),
              "resident_ids": int((out["state"].tables["categorical"].keys
                                   >= 0).sum()),
              "losses": out["losses"].tolist(), "seconds": seconds,
              "graph": out["graph"], "launches": total, **rec})
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ZOO = ("lr", "wdl", "xdeepfm", "dcn", "dlrm")
ZOO_STEPS = 16


def phase_zoo(torch, mb, ops, data, tsv: str) -> dict:
    """Every other CTR family through the Criteo entry point at full width
    (`--vocabulary 16777216 --dim 9 --batch-size 4096`): 16 eager and 16
    graph steps, each bit-equal to the plain path; the graph run's export
    served once over REST, its logits equal to eval_step's.
    -> {kernel: launches}."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.serving import ServingClient, make_server

    batches = _tsv_batches(data, tsv, VOCAB, 2)
    total = {k: 0 for k in KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke-zoo-")
    httpd = make_server(os.path.join(tmp, "registry"), port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                           timeout=300)
    try:
        for family in ZOO:
            args = ["--model", family, "--vocabulary", str(VOCAB), "--dim",
                    str(DIM), "--batch-size", str(BATCH), "--data", tsv,
                    "--steps", str(ZOO_STEPS)]
            ops.reset_launch_counts()
            with ops.plain_versions():
                ref = ex.main(args + ["--eager"])
            check(sum(ops.launch_counts().values()) == 0,
                  f"{family}: the plain run launched no kernel")
            check(np.isfinite(ref["losses"]).all(), f"{family}: finite")
            rec = {"phase": "zoo", "family": family,
                   "table": list(ref["state"].tables["categorical"]
                                 .weights.shape)}
            export = os.path.join(tmp, f"export_{family}")
            for what, extra in (("eager", ["--eager"]),
                                ("graph", ["--export", export])):
                out, launches = _run_main(ops, ex, args + extra)
                for k in KERNELS:
                    total[k] += launches[k]
                run = _example_record(torch, mb, out, launches, ref["state"],
                                      ref["losses"], f"{family} {what}",
                                      ZOO_STEPS, 1)
                rec[what] = run
                if what == "graph":  # served before the profile steps on
                    sign = f"{family}-smoke"
                    ops.reset_launch_counts()
                    client.create_model(sign, export)
                    b = batches[1]
                    served = client.predict(sign, b["sparse"], b["dense"])
                    got = ops.launch_counts()
                    for k in KERNELS:
                        total[k] += got[k]
                    want = out["trainer"].eval_step(out["state"], b)[
                        "logits"].float().cpu().numpy()
                    equal = bool(np.array_equal(served, want))
                    rec["rest_logits_equal_eval_step"] = equal
                    rec["rest_max_abs_err"] = float(
                        np.abs(served - want).max())
                    check(equal and got["gather_rows"] == 1,
                          f"{family}: REST logits equal eval_step's "
                          f"({rec['rest_max_abs_err']}), one gather ({got})")
                run.update(_driver_profile(torch, ex, out, batches, False))
                del out
                torch.cuda.empty_cache()
            emit(rec)
            del ref
            torch.cuda.empty_cache()
        return total
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the server thread stopped")
        shutil.rmtree(tmp, ignore_errors=True)


MESH_STAGED = 4           # ranks of the staged run on the one card (gloo)
MESH_STAGED_STEPS = 4     # its eager steps per wire format
MESH_HASH_STEPS = 2       # the hashed flagship's steps at 4 ranks
MESH_ENTRY_SAVE = EXAMPLE_BATCHES  # the entry point saves after one pass
MESH_ENTRY_STEPS = 16     # then loads and runs 16 more


def _mesh_launches(counted: dict) -> dict:
    check(counted["gather_rows_windows"] == 0,
          f"the mesh path launches no window gather ({counted})")
    return {k: counted[k] for k in KERNELS}


def mesh_one(torch, mb, ops, data, optimizers, array_graph) -> dict:
    """`case_mesh1` at full width: `make_deepfm(2^24, 9)` through
    MeshTrainer on a one-rank NCCL group, the train phase's batches: eager
    steps and windows, the plain versions, both graph drivers; against the
    single-device Trainer from the same state."""
    import torch.distributed as dist
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer, make_mesh
    from openembedding_tpu_torch.parallel import multihost

    tmp = tempfile.mkdtemp(prefix="chip_smoke-pg-")
    multihost.initialize("nccl", init_file=os.path.join(tmp, "store"),
                         rank=0, world_size=1)
    try:
        mesh = make_mesh()
        check(mesh.size == 1 and mesh.backend == "nccl",
              f"a one-rank NCCL mesh ({mesh})")
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh)
        steps = TRAIN_STEPS + MANY_WINDOWS * MANY_STEPS
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=TRAIN_SEED, steps=steps))
        windows = _windows(batches)
        state = trainer.init(batches[0])
        check(state.tables["categorical"].weights.shape == (VOCAB, DIM + 1),
              "one shard of one rank is the whole table")
        ref, graph_state, single_state = (state.clone(), state.clone(),
                                          state.clone())
        to_np = lambda ls: torch.stack(ls).cpu().numpy()

        ops.reset_launch_counts()  # the path's run: counts read just after
        losses = []
        state, seconds = _timed_steps(torch, trainer.train_step, state,
                                      batches, losses)
        state, _ = _run_windows(torch, trainer.train_many, state, windows,
                                losses)
        launches = _mesh_launches(ops.launch_counts())
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] == steps, f"mesh1: {k} launched "
                  f"{launches[k]} times in {steps} steps")
        losses = to_np(losses)
        check(np.isfinite(losses).all(), "mesh1: finite losses")

        ref_losses = []
        with ops.plain_versions():
            for b in batches:
                ref, m = trainer.train_step(ref, b)
                ref_losses.append(m["loss"])
        rec = _compare(torch, mb, state, losses, ref, to_np(ref_losses),
                       "vs_plain")

        step, many = trainer.jit_train_step(), trainer.jit_train_many()
        graph_losses = []
        ops.reset_launch_counts()
        graph_state, graph_seconds = _timed_steps(torch, step, graph_state,
                                                  batches, graph_losses)
        graph_state, many_seconds = _run_windows(torch, many, graph_state,
                                                 windows, graph_losses)
        graphs = {"step": graph_record(step), "many": graph_record(many)}
        graph_launches = _mesh_launches(ran_launches(
            ops.launch_counts(), graphs.values()))
        for k in ("gather_rows", "fused_sparse_apply"):
            check(graph_launches[k] == steps, f"mesh1 graphs: {k} ran "
                  f"{graph_launches[k]} times in {steps} steps")
        rec.update(_compare(torch, mb, graph_state, to_np(graph_losses),
                            state, losses, "graphs_vs_eager"))

        # the single-device Trainer from the same state
        single = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
        single_losses = []
        for b in batches:
            single_state, m = single.train_step(single_state, b)
            single_losses.append(m["loss"])
        got, want = mb.state_bits(state), mb.state_bits(single_state)
        diffs = {k: float((got[k].double() - want[k].double()).abs().max())
                 for k in got}
        single_losses = to_np(single_losses)
        rec["vs_single_device_max_abs_diff"] = max(diffs.values())
        rec["vs_single_device_loss_max_abs_diff"] = float(
            np.abs(losses - single_losses).max())
        rec["vs_single_device_bit_equal"] = bool(
            all(torch.equal(mb.bits(got[k]), mb.bits(want[k])) for k in got)
            and np.array_equal(losses.view(np.int32),
                               single_losses.view(np.int32)))

        def one_replay():
            step(graph_state, batches[0])
            torch.cuda.synchronize()

        prof = profile_device(torch, one_replay, calls=5, unit="step")
        timed = TRAIN_STEPS - WARM_STEPS
        graph_ms = graph_seconds * 1e3 / timed
        rec.update({
            "run": "mesh1", "steps": steps, "launches": launches,
            "graph_launches": graph_launches, "graphs": graphs,
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "eager_ms_per_step": seconds * 1e3 / timed,
            "graph_step_ms": graph_ms,
            "graph_many_ms_per_step": many_seconds * 1e3 / MANY_STEPS,
            "graph_step_device_ms": prof["profile_device_ms_per_step"],
            "graph_step_idle_share": 1.0 - prof[
                "profile_device_ms_per_step"] / graph_ms,
            "graph_step_top_device_ops": prof["profile_top_device_ops"],
            "array_flagship_graph_in_memory": array_graph["in_memory"]})
        del state, ref, graph_state, single_state, step, many
        return rec
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _staged_run(torch, mb, ops, trainer, state, batches):
    """Eager steps on this rank, counts set to 0 just before and read just
    after, then the same steps through the plain versions from a clone,
    bit-equal -> (state, losses, launches, ms a step, staged bytes a step,
    the comparison)."""
    ref = state.clone()
    mesh = trainer.mesh
    ops.reset_launch_counts()
    staged0 = mesh.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = _mesh_launches(ops.launch_counts())
    staged = (mesh.staged_bytes - staged0) / len(batches)
    ref_losses = []
    with ops.plain_versions():
        for b in batches:
            ref, m = trainer.train_step(ref, b)
            ref_losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    cmp = _compare(torch, mb, state, losses, ref,
                   torch.stack(ref_losses).cpu().numpy(), "vs_plain")
    return state, losses, launches, ms, staged, cmp


def mesh_staged_rank(mesh):
    """One rank of the staged run (gloo, its tensors on the card): the
    flagship at both wire formats, then the hashed flagship. Returns numpy
    and plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.staged and mesh.size == MESH_STAGED, f"a staged mesh {mesh}")
    out = {"rank": mesh.rank, "runs": []}
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=MESH_STAGED_STEPS))
    batches = [local_batch(b, mesh) for b in globals_]
    for wire in ("fp32", None):
        # a float32 tower: its products do not round with the batch size,
        # so step 0 holds to the single-device run's at the fp32 bound
        model = make_deepfm(vocabulary=VOCAB, dim=DIM,
                            compute_dtype=torch.float32)
        trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh, wire=wire)
        state = trainer.init(batches[0])
        check(state.tables["categorical"].weights.shape
              == (VOCAB // MESH_STAGED, DIM + 1), "a rank holds one shard")
        state, losses, launches, ms, staged, cmp = _staged_run(
            torch, mb, ops, trainer, state, batches[:1])
        # step 0's rows of the ids this rank owns, for the parent's
        # single-device run
        g = np.unique(globals_[0]["sparse"]["categorical"])
        own = g[g % mesh.size == mesh.rank]
        rows0 = state.tables["categorical"].weights[
            torch.from_numpy(own // mesh.size).to(mesh.device)].cpu().numpy()
        state, more, more_launches, ms, staged, cmp2 = _staged_run(
            torch, mb, ops, trainer, state, batches[1:])
        out["runs"].append({
            "wire": trainer.wire_for("categorical"),
            "losses": np.concatenate([losses, more]).tolist(),
            "launches": {k: launches[k] + more_launches[k]
                         for k in launches},
            "ms_per_step": ms, "staged_bytes_per_step": staged,
            "step0_ids": own, "step0_rows": rows0, **cmp,
            **{k + "_later": v for k, v in cmp2.items()}})
        del trainer, state
        torch.cuda.empty_cache()
    hashed = list(data.synthetic_criteo(BATCH, id_space=HASH_ID_SPACE,
                                        seed=TRAIN_SEED,
                                        steps=MESH_HASH_STEPS))
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh)
    hb = [local_batch(b, mesh) for b in hashed]
    state = trainer.init(hb[0])
    check(state.tables["categorical"].keys.shape
          == (HASH_CAPACITY // MESH_STAGED,), "a rank holds one hash shard")
    state, losses, launches, ms, staged, cmp = _staged_run(
        torch, mb, ops, trainer, state, hb)
    ts = state.tables["categorical"]
    out["runs"].append({
        "wire": "hash " + trainer.wire_for("categorical"),
        "losses": losses.tolist(), "launches": launches, "ms_per_step": ms,
        "staged_bytes_per_step": staged,
        "resident": int((ts.keys >= 0).sum()),
        "overflow": int(ts.overflow), **cmp})
    return out


def _step0_single(torch, optimizers, data):
    """The single-device Trainer's step 0 from the staged run's initial
    state (its shards drawn again here from their generators, in id
    order), its loss scaled by S -> (the table after the step, the loss /
    S)."""
    from openembedding_tpu_torch.embedding import init_table_state
    from openembedding_tpu_torch.model import (Trainer, _table_generator,
                                               binary_logloss)
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel.sharded import deinterleave_rows
    S = MESH_STAGED
    model = make_deepfm(vocabulary=VOCAB, dim=DIM,
                        compute_dtype=torch.float32)
    model.loss_fn = lambda lo, la, w=None: S * binary_logloss(lo, la, w)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED, steps=1))
    state = trainer.init(batch)
    spec = model.specs["categorical"]
    shards = [init_table_state(spec, trainer.opt_for(spec), _table_generator(
        trainer.seed, spec, trainer.device, (r, S)), num_shards=S).weights
              for r in range(S)]
    state.tables["categorical"].weights.copy_(
        deinterleave_rows(torch.cat(shards), S, VOCAB))
    del shards
    state, m = trainer.train_step(state, batch)
    w = state.tables["categorical"].weights
    return w, float(m["loss"]) / S


def mesh_staged(torch, optimizers, data) -> dict:
    """Four ranks on the one card over gloo, staged through the host."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(mesh_staged_rank, MESH_STAGED, backend="gloo",
                      device="cuda", timeout_s=600, threads=0)
    wall = time.perf_counter() - t0
    w, loss = _step0_single(torch, optimizers, data)
    rec = {"run": "mesh4-staged", "ranks": MESH_STAGED,
           "wall_seconds": wall, "per_rank": []}
    worst = 0.0
    for out in ranks:
        for run in out["runs"]:
            for k in ("gather_rows", "fused_sparse_apply"):
                check(run["launches"][k] > 0, f"rank {out['rank']} "
                      f"({run['wire']}) launched {k}")
            if "step0_ids" in run:
                want = w[torch.from_numpy(run["step0_ids"]).to(w.device)]
                got = torch.from_numpy(run["step0_rows"]).to(w.device)
                diff = float((got - want).abs().max())
                run["step0_vs_single_device_max_abs_diff"] = diff
                run["step0_loss_vs_single_device"] = [run["losses"][0],
                                                      loss]
                del run["step0_ids"], run["step0_rows"]
                # the bf16 wire rounds the pulled rows and the pushed
                # grads: only the fp32 wire is held to the fp32 bound
                if run["wire"] == "fp32":
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                          f"rank {out['rank']}: step-0 rows within rtol "
                          "1e-5 / atol 1e-6 of the single-device Trainer "
                          f"with its loss scaled by S ({diff})")
                    check(abs(run["losses"][0] - loss) <= 1e-5 * abs(loss),
                          f"rank {out['rank']}: step-0 loss "
                          f"{run['losses'][0]} against {loss}")
                    worst = max(worst, diff)
            rec["per_rank"].append({"rank": out["rank"], **run})
    rec["step0_fp32_vs_single_device_max_abs_diff"] = worst
    del w
    return rec


def mesh_entry(torch, mb, ops, tsv: str) -> dict:
    """The entry point's `--mesh` at one rank on the seeded TSV: a graph
    run saved after one pass, then loaded and run 16 steps more, held to
    one uninterrupted run through the plain versions."""
    import torch.distributed as dist
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    tmp = tempfile.mkdtemp(prefix="chip_smoke-mesh-")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        base = ["--mesh", "--data", tsv, "--vocabulary", str(VOCAB),
                "--dim", str(DIM), "--batch-size", str(BATCH)]
        saved, l1 = _run_main(ops, ex, base + [
            "--steps", str(MESH_ENTRY_SAVE), "--save", ckpt])
        check(sorted(os.listdir(os.path.join(ckpt, "variable_0")))
              == ["shard_00000_of_00001"], "a sharded checkpoint")
        loaded, l2 = _run_main(ops, ex, base + [
            "--steps", str(MESH_ENTRY_STEPS), "--load", ckpt])
        total = MESH_ENTRY_SAVE + MESH_ENTRY_STEPS
        with ops.plain_versions():
            plain = ex.main(base + ["--steps", str(total), "--eager"])
        launches = {k: l1[k] + l2[k] for k in KERNELS}
        check(launches["gather_rows_windows"] == 0
              and launches["gather_rows"] == total + 2
              and launches["fused_sparse_apply"] == total,
              f"--mesh: one gather a step (and one at each init), one "
              f"apply a step ({launches})")
        rec = {"run": "entry --mesh", "steps": total, "launches": launches,
               "saved_graph": saved["graph"], "loaded_graph": loaded["graph"],
               "steady_ms_per_step": loaded["steady_seconds"] * 1e3
               / max(loaded["steady_steps"], 1)}
        both = np.concatenate([saved["losses"], loaded["losses"]])
        rec.update(_compare(torch, mb, loaded["state"], both,
                            plain["state"], plain["losses"],
                            "save_load_vs_plain"))
        return rec
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_nccl_rank(mesh, steps):
    """One rank of the NCCL run across cards: eager steps against the same
    steps through `jit_train_step`, bit-equal."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = [local_batch(b, mesh) for b in data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=steps)]
    trainer = MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                          optimizers.Adagrad(learning_rate=0.05), mesh=mesh)
    state = trainer.init(batches[0])
    graph_state = state.clone()
    # step 0 apart: NCCL sets its communicators up at the first collective
    state, first, launches, _, _, cmp = _staged_run(
        torch, mb, ops, trainer, state, batches[:1])
    state, more, more_launches, ms, _, cmp2 = _staged_run(
        torch, mb, ops, trainer, state, batches[1:])
    losses = np.concatenate([first, more])
    launches = {k: launches[k] + more_launches[k] for k in launches}
    cmp.update({k + "_later": v for k, v in cmp2.items()})
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    graph_losses = []
    for i, b in enumerate(batches):
        if i == 1:  # after the capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        graph_state, m = step(graph_state, b)
        graph_losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    graph = graph_record(step)
    ran = ran_launches(ops.launch_counts(), [graph])
    cmp.update(_compare(torch, mb, graph_state,
                        torch.stack(graph_losses).cpu().numpy(), state,
                        losses, "graph_vs_eager"))
    return {"rank": mesh.rank, "eager_ms_per_step": ms,
            "graph_ms_per_step": graph_ms, "launches": launches,
            "graph_launches": ran, **cmp}


def phase_mesh(torch, mb, ops, data, optimizers, tsv: str,
               array_graph: dict) -> dict:
    """The mesh path (`openembedding_tpu_torch.parallel`): mesh1, the staged
    four-rank run, the entry point's --mesh, and NCCL across cards where
    the machine has them -> {kernel: launches of the phase}."""
    t0 = time.perf_counter()
    one = mesh_one(torch, mb, ops, data, optimizers, array_graph)
    emit({"phase": "mesh", **one})
    torch.cuda.empty_cache()
    staged = mesh_staged(torch, optimizers, data)
    emit({"phase": "mesh", **staged})
    torch.cuda.empty_cache()
    entry = mesh_entry(torch, mb, ops, tsv)
    emit({"phase": "mesh", **entry})
    torch.cuda.empty_cache()
    launches = {k: one["launches"][k] + one["graph_launches"][k]
                + entry["launches"][k] for k in KERNELS}
    for rank in staged["per_rank"]:
        for k in KERNELS:
            launches[k] += rank["launches"][k]
    cards = torch.cuda.device_count()
    if cards >= 2:
        from openembedding_tpu_torch.parallel.multihost import run_local
        S = min(4, cards)
        nccl = run_local(mesh_nccl_rank, S, backend="nccl", device="cuda",
                         args=(MESH_STAGED_STEPS,), timeout_s=600, threads=0)
        for r in nccl:
            for k in KERNELS:
                launches[k] += r["launches"][k] + r["graph_launches"][k]
        emit({"phase": "mesh", "run": f"nccl x{S}", "per_rank": nccl})
    else:
        emit({"phase": "mesh", "run": "nccl across cards",
              "not_run": f"the machine has {cards} card: NCCL refuses two "
              "ranks of one communicator on one card"})
    emit({"phase": "mesh", "launches": launches,
          "wall_seconds": time.perf_counter() - t0})
    return launches


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
    graphs = [r for r in records if "graph_launches" in r]
    check(len(graphs) == 1, "the micro-benchmark ran one graph driver")
    launches = ran_launches(ops.launch_counts(), graphs)
    for k in KERNELS:
        check(launches[k] > 0, f"the micro-benchmark launched {k}")
    emit({"phase": "microbench", "records": len(records),
          "launches": launches, "graph": {k: graphs[0][k] for k in (
              "captures", "replays", "graph_launches")}})
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
    kernels_profile(torch, "windows", profile_calls, "window_gather")
    kernels_profile(torch, "apply", apply_calls, "fused_apply")
    del profile_calls, apply_calls
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch, ops, gather)
    train = phase_train(torch, mb, ops, optimizers, data)
    torch.cuda.empty_cache()
    example = phase_example(torch, mb, ops, data, optimizers)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-tsv-")
    try:
        # the example phase's TSV again (same seed), for the later phases
        tsv = os.path.join(tmp, "day.tsv")
        write_criteo_tsv(tsv, EXAMPLE_BATCHES * BATCH, SEED + 3)
        # the array flagship's graph step: through the entry point on the
        # TSV (the reader's pace) and on batches in memory (train phase)
        array_graph = next(
            {k: r[k] for k in ("steady_ms_per_step", "device_ms_per_step",
                               "device_idle_share")}
            for r in example["runs"] if r["run"] == "graph")
        array_graph["in_memory"] = {
            "ms_per_step": train["graph_step_ms"],
            "device_ms_per_step":
                train["graph_step_profile"]["profile_device_ms_per_step"],
            "idle_share": train["graph_step_profile"][
                "device_idle_share_unprofiled"]}
        hash_launches = phase_hash(torch, mb, ops, data, optimizers, tsv,
                                   array_graph)
        torch.cuda.empty_cache()
        lr_launches = phase_lr_example(torch, mb, ops)
        torch.cuda.empty_cache()
        zoo_launches = phase_zoo(torch, mb, ops, data, tsv)
        torch.cuda.empty_cache()
        mesh_launches = phase_mesh(torch, mb, ops, data, optimizers, tsv,
                                   array_graph)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, bench_launches = phase_microbench(torch, mb, ops)
    by_path = {k: {"serve": serve_launches if k == "gather_rows" else 0,
                   "train": train["launches"][k],
                   "train_graphs": train["graph_launches"][k],
                   "example": example["launches"][k],
                   "hash": hash_launches[k],
                   "lr_example": lr_launches[k],
                   "zoo": zoo_launches[k],
                   "mesh": mesh_launches[k],
                   "microbench": bench_launches[k]} for k in KERNELS}
    for path in ("hash", "lr_example", "zoo", "mesh"):
        for k in ("gather_rows", "fused_sparse_apply"):
            check(by_path[k][path] > 0, f"the {path} phase launched {k}")
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
