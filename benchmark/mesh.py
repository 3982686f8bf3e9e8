"""A cell on several cards: one rank process a card, started here and
waited for.

Each rank joins a process group (NCCL on the cards, gloo on the CPU) at a
free local port, builds its `openembedding_tpu_torch.parallel` mesh and
runs its side of the run (`run.train_part`), and hands its result back
through a file in a temporary directory. The process that started them
holds no card while they run; it aggregates their results and runs the
check once they have ended.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# a run's own limit is 360 s; the ranks get what is left of it
RANK_TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_entry(rank: int, size: int, port: int, device: str, target: str,
               args: dict, out_dir: str) -> None:
    """One rank: join the group, run `target` ("module:function", called
    with the rank's mesh and device and `args`), write its result (or its
    traceback), leave the group."""
    code = 0
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank)
        from openembedding_tpu_torch.parallel.mesh import make_mesh
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        res = fn(mesh=make_mesh(device=str(dev)), dev=dev, **args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:  # noqa: BLE001 — reported to the parent
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def run_ranks(size: int, device: str, args: dict,
              target: str = "benchmark.run:train_part",
              timeout_s: float = RANK_TIMEOUT_S) -> list:
    """Start `size` ranks of `target`, wait for all of them -> their results
    in rank order. A rank that fails or outlives `timeout_s` ends them all
    and raises with every rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="oetpu_bench_ranks_")
    try:
        port = free_port()
        procs = [ctx.Process(target=rank_entry,
                             args=(r, size, port, device, target, args,
                                   work))
                 for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r in range(size):
            path = os.path.join(work, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError("a rank failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n"
                               + "\n".join(errors))
        out = []
        for r in range(size):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
