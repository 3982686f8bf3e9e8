#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`openembedding_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, exits non-zero and skips the
final line:

1. device  — the card's name and power limit (nvidia-smi), CUDA present;
2. build   — nvcc builds the gather kernel from `csrc/gather_rows.cu`;
3. kernel  — the kernel against its plain PyTorch version on the card at the
   serving path's shapes (a 2^24 x 10 float32 table, 4096 x 26 Zipfian ids
   with -1 pads and out-of-range ids; int32/int64 ids, with and without a
   mask; one bfloat16 table of width 64). Every case must be bit-equal.
   Times: the kernel, the plain version, and one library call computing the
   same function (index_select + where, a yardstick the port never calls),
   beside the memory bound at 3.35 TB/s;
4. serve   — the full-width DeepFM (`make_deepfm(vocabulary=1<<24, dim=9)`,
   random weights from a seed) exported, loaded by a REST server and driven
   through `ServingClient`: predict at batch 1, 100 and 4096 and a pull. The
   answers must equal the same servable's in-process forward with the plain
   gather in place of the kernel (tolerance 0: the gather is a copy and
   everything else is the same code on the same card), and the kernel's
   launch count must rise by one per table per predict and one per pull.

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

SEED = 0
VOCAB = 1 << 24          # the flagship table: 2^24 rows
DIM = 9                  # latent width; the folded table is DIM + 1 wide
BATCH = 4096
FIELDS = 26              # Criteo categorical fields
NUM_DENSE = 13           # Criteo dense fields
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SIGN = "deepfm-smoke-0"


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


def profile_predict(torch, fn, calls: int = 10) -> dict:
    """Device busy time of `calls` in-process predicts under torch.profiler:
    the sum of kernel and copy times on the card against the wall time, and
    the five costliest device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(busy_ms > 0, "the profiler saw device work in predict")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return {"profile_calls": calls,
            "profile_wall_ms_per_predict": wall_ms / calls,
            "profile_device_ms_per_predict": busy_ms / calls,
            "profile_device_idle_share": 1.0 - busy_ms / wall_ms,
            "profile_top_device_ops": [
                [e.key[:60], e.self_device_time_total / 1e3 / calls,
                 e.count // calls] for e in top]}


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
        profile = profile_predict(torch, inproc)
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

    from openembedding_tpu_torch.ops import _build, gather
    t0 = time.perf_counter()
    gather._library()
    info = _build.BUILD_INFO[gather.KERNEL]
    emit({"phase": "build", "kernel": gather.KERNEL,
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"],
          "ptxas": [ln for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    main_case = phase_kernel(torch, gather)
    launches = phase_serve(torch, gather)
    emit({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/gather_rows.cu",
        "replaces": "openembedding_tpu/ops/pallas_sparse.py:148",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes", "library_ms": main_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
