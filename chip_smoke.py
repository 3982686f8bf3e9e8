#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`openembedding_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, exits non-zero and skips the
final line:

1. device  — the card's name and power limit (nvidia-smi), CUDA present;
2. build   — nvcc builds both kernels, `csrc/gather_rows.cu` and
   `csrc/fused_sparse_apply.cu`, at the same time (one thread each);
3. kernel  — the gather against its plain PyTorch version on the card at the
   serving path's shapes (a 2^24 x 10 float32 table, 4096 x 26 Zipfian ids
   with -1 pads and out-of-range ids; int32/int64 ids, with and without a
   mask; one bfloat16 table of width 64). Every case must be bit-equal.
   Times: the kernel, the plain version, and one library call computing the
   same function (index_select + where, a yardstick the port never calls),
   beside the memory bound at 3.35 TB/s;
4. apply   — the fused sparse apply against its plain version on the card.
   Main case: the 2^24 x 10 float32 table and its Adagrad accumulator,
   updated from one `synthetic_criteo(4096, id_space=2^24, seed=7)` batch
   deduplicated by `ops/sparse._dedup_routed`; every table and slot must be
   bit-equal after the same in-place update of two clones. Times: the
   kernel, the plain version, `torch.optim.Adagrad` stepping on the same
   coalesced sparse gradient (a yardstick the port never calls), the bound
   from the bytes the update must move (and from the 32-byte sectors it
   touches). Further cases: all nine optimizer rules on a small table with
   duplicates, -1 pads and out-of-range ids, a bfloat16 table with Adam
   (the 1-wide per-row slots), each bit-equal; Ftrl with
   learning_rate_power -0.7 (`powf`) within a stated tolerance;
5. serve   — the full-width DeepFM (`make_deepfm(vocabulary=1<<24, dim=9)`,
   random weights from a seed) exported, loaded by a REST server and driven
   through `ServingClient`: predict at batch 1, 100 and 4096 and a pull. The
   answers must equal the same servable's in-process forward with the plain
   gather in place of the kernel (tolerance 0: the gather is a copy and
   everything else is the same code on the same card), and the kernel's
   launch count must rise by one per table per predict and one per pull;
6. train   — the same DeepFM trained by `Trainer` with Adagrad(0.05) from a
   seeded init on `synthetic_criteo` batches of 4096: 24 `train_step`s and
   one `train_many` window of 4. Each step must launch exactly one gather
   and one apply per table. The same steps from a clone of the initial
   state with both plain versions swapped in must launch no kernel and
   give the same losses, tables, accumulators, dense parameters and dense
   slots, bit for bit (the gather is a copy, the apply is bit-equal, the
   segment sums keep one order, and cuBLAS runs with a fixed workspace).
   Prints ex/s, the profiler's device busy time, idle share and top device
   operations per step, and the peak device memory.

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
from contextlib import contextmanager

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SIGN = "deepfm-smoke-0"
TRAIN_SEED = 7           # synthetic_criteo seed of bench.py's trainer case
TRAIN_STEPS = 24         # train_step calls; the first WARM_STEPS are untimed
WARM_STEPS = 4
MANY_STEPS = 4           # one train_many window after them


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


def device_ms(torch, fn, samples: int = 25, spin_cycles: int = 2_000_000
              ) -> float:
    """Median device time of one `fn()` over `samples` CUDA-event-timed
    calls. A spin kernel runs first so the host has enqueued the start event
    and all of `fn`'s work before the device reaches them: the events then
    time the device work alone, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def gather_bytes(ids: np.ndarray, id_itemsize: int, valid, n_rows: int,
                 dim: int, itemsize: int) -> dict:
    """Bytes the gather must move for these inputs: the rows it reads (only
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


def phase_kernel(torch, gather) -> dict:
    """Kernel vs plain version at the serving shapes; returns the main-path
    case (float32 table, int64 ids, no mask) for the kernels line."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w32 = torch.randn((VOCAB, DIM + 1), generator=gen, device=dev)
    ids_np = zipf_ids(rng, BATCH * FIELDS, VOCAB)
    ids64_np = ids_np.copy()
    ids64_np[8:24] = (1 << 40) + np.arange(16)  # past int32, int64 only
    mask_np = rng.random(ids_np.shape[0]) < 0.9
    mask = torch.from_numpy(mask_np).to(dev)
    cases = [("f32", w32, ids_np, torch.int32, None),
             ("f32", w32, ids64_np, torch.int64, None),
             ("f32", w32, ids_np, torch.int32, mask_np),
             ("f32", w32, ids64_np, torch.int64, mask_np)]
    # uniform ids: no hot rows for L2 to keep, unlike the Zipfian cases
    uniform_np = rng.integers(0, VOCAB, ids_np.shape[0])
    cases.append(("f32 uniform", w32, uniform_np, torch.int64, None))
    w16 = torch.randn((VOCAB, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    cases.append(("bf16", w16, ids64_np, torch.int64, None))
    main = None
    for tname, w, ids_host, id_dtype, valid_np in cases:
        ids = torch.from_numpy(ids_host).to(dev, id_dtype)
        valid = mask if valid_np is not None else None
        launches = gather.LAUNCHES["gather_rows"]
        got = gather.gather_rows(w, ids, valid)
        check(gather.LAUNCHES["gather_rows"] == launches + 1,
              "one gather_rows call is one kernel launch")
        want = gather.gather_rows_reference(w, ids, valid)
        torch.cuda.synchronize()
        bits = torch.int32 if w.dtype == torch.float32 else torch.int16
        equal = torch.equal(got.view(bits), want.view(bits))
        err = float((got.float() - want.float()).abs().max())
        n_rows = w.shape[0]

        def library(w=w, ids=ids, valid=valid, n_rows=n_rows):
            ok = (ids >= 0) & (ids < n_rows)
            if valid is not None:
                ok = ok & valid
            rows = torch.index_select(w, 0, ids.clamp(0, n_rows - 1))
            return torch.where(ok[:, None], rows, 0.0)

        nbytes = gather_bytes(ids_host, ids.element_size(), valid_np,
                              n_rows, w.shape[1], w.element_size())
        rec = {
            "phase": "kernel", "table": f"{tname} {n_rows}x{w.shape[1]}",
            "ids": f"{ids.shape[0]} {str(id_dtype).split('.')[-1]}",
            "mask": valid is not None, "bit_equal": equal,
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: gather.gather_rows(w, ids, valid)),
            "plain_ms": device_ms(
                torch, lambda: gather.gather_rows_reference(w, ids, valid)),
            "library_ms": device_ms(torch, library),
            "host_ms_per_call": host_ms(
                torch, lambda: gather.gather_rows(w, ids, valid)),
            **nbytes,
            "bound_ms": nbytes["useful_bytes"] / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": (nbytes["sector_read_bytes"]
                                + nbytes["useful_bytes"]
                                - nbytes["read_bytes"]) / HBM_BYTES_PER_S
            * 1e3,
        }
        emit(rec)
        check(equal, f"gather_rows bit-equal to its plain version ({rec})")
        if tname == "f32" and id_dtype == torch.int64 and valid is None:
            main = rec
    return main


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


@contextmanager
def plain_apply(apply):
    """Swap the apply kernel's wrapper for its plain version."""
    kernel = apply.fused_sparse_apply
    apply.fused_sparse_apply = apply.fused_sparse_apply_reference
    try:
        yield
    finally:
        apply.fused_sparse_apply = kernel


def _bits(t):
    """The tensor's bits as integers (float32 -> int32, bfloat16 -> int16)."""
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _apply_once(torch, apply, opt, w, slots, idx, g, counts):
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


def _bit_equal(torch, got, want) -> bool:
    (w, s), (w2, s2) = got, want
    return (torch.equal(_bits(w), _bits(w2))
            and all(torch.equal(_bits(s[k]), _bits(s2[k])) for k in s))


def apply_small_cases(torch, apply, sparse, optimizers) -> list:
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
            got, want = _apply_once(torch, apply, opt, w, slots, idx, g,
                                    counts)
            worst = max(worst, _max_err(got, want))
            equal = equal and _bit_equal(torch, got, want)
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


def phase_apply(torch, apply, sparse, optimizers, data) -> dict:
    """The apply kernel against its plain version at the training path's
    shapes, then the small cases; returns the main case."""
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
    got, want = _apply_once(torch, apply, opt, w, {"accum": accum}, idx, g,
                            counts)
    equal = _bit_equal(torch, got, want)
    err = _max_err(got, want)
    del want
    w, slots = got

    # the library yardstick: torch.optim.Adagrad on the coalesced sparse
    # gradient of the same deduplicated rows (it divides g by the root
    # before multiplying by lr, so it is not bit-equal to the rule)
    live = counts > 0
    param = torch.nn.Parameter(w.clone())
    torch.sparse.check_sparse_tensor_invariants.disable()  # built valid
    sparse_grad = torch.sparse_coo_tensor(
        idx[live][None], g[live], param.shape).coalesce()
    lib_opt = torch.optim.Adagrad([param], lr=opt.learning_rate,
                                  initial_accumulator_value=0.1,
                                  eps=opt.epsilon)

    def library():
        param.grad = sparse_grad
        lib_opt.step()

    rows_np = idx.cpu().numpy()
    counts_np = counts.cpu().numpy()
    nbytes = apply_bytes(rows_np, counts_np, VOCAB, dim, w.element_size(),
                         [dim])
    run = lambda: apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
    run_plain = lambda: apply.fused_sparse_apply_reference(
        opt, w, slots, idx, g, counts)
    rec = {
        "phase": "apply", "case": "main adagrad",
        "table": f"f32 {VOCAB}x{dim} + accum",
        "slots": int(idx.shape[0]), **nbytes, "bit_equal": equal,
        "max_abs_err": err,
        "ms": device_ms(torch, run),
        "plain_ms": device_ms(torch, run_plain),
        "library_ms": device_ms(torch, library),
        "host_ms_per_call": host_ms(torch, run),
        "bound_ms": nbytes["useful_bytes"] / HBM_BYTES_PER_S * 1e3,
        "sector_bound_ms": nbytes["sector_bytes"] / HBM_BYTES_PER_S * 1e3,
    }
    emit(rec)
    check(equal, f"fused_sparse_apply bit-equal to its plain version at the "
          f"main case ({rec})")
    del w, slots, got, param, lib_opt, sparse_grad
    torch.cuda.empty_cache()
    rec["small_cases"] = apply_small_cases(torch, apply, sparse, optimizers)
    return rec


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
        out["profile_spans_ms_per_step"] = {
            e.key + (" device span" if e.device_type == DeviceType.CUDA
                     else " host"):
            (e.device_time_total if e.device_type == DeviceType.CUDA
             else e.cpu_time_total) / 1e3 / calls for e in spans}
    return out


@contextmanager
def plain_gather(gather):
    """Swap the kernel's wrapper for its plain version (reference runs)."""
    kernel = gather.gather_rows
    gather.gather_rows = gather.gather_rows_reference
    try:
        yield
    finally:
        gather.gather_rows = kernel


def phase_serve(torch, gather) -> int:
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
        gather.LAUNCHES["gather_rows"] = 0
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
        with plain_gather(gather):
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


def _run_training(torch, trainer, state, batches) -> tuple:
    """TRAIN_STEPS train_step calls, then one train_many window; returns
    (state, losses as a float32 numpy array, seconds of the timed steps)."""
    losses = []
    for k in range(WARM_STEPS):
        state, m = trainer.train_step(state, batches[k])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WARM_STEPS, TRAIN_STEPS):
        state, m = trainer.train_step(state, batches[k])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state, m = trainer.train_many(state, _stacked(batches[TRAIN_STEPS:]))
    losses.extend(m["loss"].unbind(0))
    return state, torch.stack(losses).cpu().numpy(), seconds


def _state_bits(torch, state) -> dict:
    """Every tensor of a TrainState (tables, slots, dense params and slots)
    by name, on the host."""
    out = {}
    for name, t in state.tables.items():
        out[f"{name}/weights"] = t.weights
        out.update({f"{name}/{k}": v for k, v in t.slots.items()})
    for pname, p in state.dense.named_parameters():
        out[f"dense/{pname}"] = p.detach()
        out.update({f"dense/{pname}/{k}": v
                    for k, v in state.dense_slots[pname].items()})
    return out


def phase_train(torch, gather, apply, optimizers, data) -> dict:
    """Full-width DeepFM training through both kernels, held against the
    same steps through both plain versions."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm

    torch.cuda.reset_peak_memory_stats()
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    batches = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED,
        steps=TRAIN_STEPS + MANY_STEPS))
    state = trainer.init(batches[0])
    ref = state.clone()
    n_tables = len(model.specs)
    steps = TRAIN_STEPS + MANY_STEPS

    # the main path's run: counts start at 0 here and are read below
    gather.LAUNCHES["gather_rows"] = 0
    apply.LAUNCHES["fused_sparse_apply"] = 0
    state, losses, seconds = _run_training(torch, trainer, state, batches)
    launches = {"gather_rows": gather.LAUNCHES["gather_rows"],
                "fused_sparse_apply": apply.LAUNCHES["fused_sparse_apply"]}
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        check(v == steps * n_tables, f"{k} launched {v} times in {steps} "
              f"steps of {n_tables} table(s)")
    check(np.isfinite(losses).all(), f"finite losses {losses}")

    # the same steps through both plain versions: no launch may be counted
    with plain_gather(gather), plain_apply(apply):
        ref, ref_losses, ref_seconds = _run_training(torch, trainer, ref,
                                                     batches)
    check(gather.LAUNCHES["gather_rows"] == launches["gather_rows"]
          and apply.LAUNCHES["fused_sparse_apply"]
          == launches["fused_sparse_apply"],
          "the plain run launched no kernel")
    got, want = _state_bits(torch, state), _state_bits(torch, ref)
    diffs = {k: float((got[k].float() - want[k].float()).abs().max())
             for k in got}
    unequal = sorted(k for k in got if not torch.equal(_bits(got[k]),
                                                       _bits(want[k])))
    loss_equal = np.array_equal(losses.view(np.int32),
                                ref_losses.view(np.int32))

    def one_step():
        trainer.train_step(state, batches[0])
        torch.cuda.synchronize()

    profile = profile_device(torch, one_step, calls=5, unit="step")
    timed = TRAIN_STEPS - WARM_STEPS
    rec = {"phase": "train", "model": "deepfm vocab 2^24 dim 9 hidden "
           "400-400-400 bf16, Adagrad(0.05)", "batch": BATCH,
           "steps": steps, "launches": launches,
           "losses": losses.tolist(),
           "loss_first_last": [float(losses[0]), float(losses[-1])],
           "examples_per_s": BATCH * timed / seconds,
           "step_ms": seconds * 1e3 / timed,
           "plain_examples_per_s": BATCH * timed / ref_seconds,
           "loss_bit_equal_to_plain": bool(loss_equal),
           "state_unequal_to_plain": unequal,
           "state_max_abs_diff_vs_plain": max(diffs.values()),
           "peak_memory_bytes": peak, **profile}
    emit(rec)
    check(loss_equal and not unequal, "training through the kernels equals "
          f"the plain run bit for bit (unequal: {unequal}, max diff "
          f"{rec['state_max_abs_diff_vs_plain']})")
    return rec


def phase_build(torch, gather, apply, _build) -> None:
    """Build both kernels at the same time, one nvcc each."""
    t0 = time.perf_counter()
    errors = []

    def build(lib_fn):
        try:
            lib_fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m._library,))
               for m in (gather, apply)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for m in (gather, apply):
        info = _build.BUILD_INFO[m.KERNEL]
        emit({"phase": "build", "kernel": m.KERNEL,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"],
              "ptxas": [ln for ln in info["log"].splitlines()
                        if "registers" in ln or "spill" in ln]})


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

    from openembedding_tpu_torch import data, optimizers
    from openembedding_tpu_torch.ops import _build, apply, gather, sparse
    phase_build(torch, gather, apply, _build)

    main_gather = phase_kernel(torch, gather)
    main_apply = phase_apply(torch, apply, sparse, optimizers, data)
    serve_launches = phase_serve(torch, gather)
    train = phase_train(torch, gather, apply, optimizers, data)
    emit({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/gather_rows.cu",
        "replaces": "openembedding_tpu/ops/pallas_sparse.py:148",
        "launches": serve_launches + train["launches"]["gather_rows"],
        "max_abs_err": main_gather["max_abs_err"],
        "ms": main_gather["ms"], "plain_ms": main_gather["plain_ms"],
        "bound_ms": main_gather["bound_ms"], "bound_by": "bytes",
        "library_ms": main_gather["library_ms"]}, {
        "name": "fused_sparse_apply", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/fused_sparse_apply.cu",
        "replaces": "openembedding_tpu/ops/pallas_sparse.py:464",
        "launches": train["launches"]["fused_sparse_apply"],
        "max_abs_err": main_apply["max_abs_err"],
        "ms": main_apply["ms"], "plain_ms": main_apply["plain_ms"],
        "bound_ms": main_apply["bound_ms"], "bound_by": "bytes",
        "library_ms": main_apply["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
