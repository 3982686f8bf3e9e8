"""Process-group set-up, the rank's slice of the batch and a local launcher
(port of `openembedding_tpu/parallel/multihost.py:38-120`).

The JAX package's rendezvous is `jax.distributed.initialize`; the port's is
`torch.distributed.init_process_group`, fed by `torchrun`'s environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) or by a shared
init file, always with a finite timeout. Every rank reads the same batch
stream and keeps its own rows (`local_batch`), the JAX `global_batch`
sharding `P("data")` seen from one rank.

`run_local` spawns S ranks on this machine (the tests and `chip_smoke.py`
use it); `torchrun --nproc-per-node S` is the production launcher.
`allgather_host_ids` and `host_sharded_reader` are not ported yet
(ROADMAP.md item 3).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

DEFAULT_TIMEOUT_S = 300.0


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def initialize(backend: Optional[str] = None, *,
               init_file: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the default process group (no-op when it exists).

    Under `torchrun` (RANK and WORLD_SIZE set) it joins through the
    environment; with `init_file` through that shared file (`rank` and
    `world_size` given); with neither, as the one rank of a one-rank group
    (a fresh init file in a temporary directory). `backend`: None is NCCL
    when a card is present, gloo otherwise."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = _timeout(timeout_s)
    if init_file is None and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if init_file is None:
        if rank not in (None, 0) or world_size not in (None, 1):
            raise ValueError("rank and world_size need an init_file (or "
                             "torchrun's environment)")
        init_file = os.path.join(tempfile.mkdtemp(prefix="oetpu_pg_"),
                                 "store")
        rank, world_size = 0, 1
    if rank is None or world_size is None:
        raise ValueError("init_file needs rank and world_size")
    store = dist.FileStore(init_file, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)


def host_id() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch(batch, mesh: Mesh):
    """Rank r's rows `[r*B/S, (r+1)*B/S)` of every leaf of a global batch
    (numpy arrays or tensors; None stays None). B must divide by S."""
    S, r = mesh.size, mesh.rank

    def take(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        n = x.shape[0]
        if n % S:
            raise ValueError(f"global batch {n} does not divide by the "
                             f"mesh's {S} ranks")
        m = n // S
        return x[r * m:(r + 1) * m]

    return take(batch)


def _rank_main(fn, rank: int, world_size: int, backend: str, device: str,
               store_path: str, out_dir: str, args: tuple, threads: int,
               timeout_s: float) -> None:
    """One spawned rank: join the group, run `fn(mesh, *args)`, write its
    result (or its traceback) into `out_dir`, leave the group."""
    code = 0
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(backend, init_file=store_path, rank=rank,
                   world_size=world_size, timeout_s=timeout_s)
        from .mesh import make_mesh
        if device == "cuda":
            dev = f"cuda:{rank % torch.cuda.device_count()}"
        else:
            dev = device
        if dev.startswith("cuda"):
            torch.cuda.set_device(torch.device(dev))
        result = fn(make_mesh(device=dev), *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:  # noqa: BLE001 — reported to the parent
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    os._exit(code)


def run_local(fn: Callable[..., Any], world_size: int, *,
              backend: str = "gloo", device: str = "cpu",
              args: tuple = (), timeout_s: float = 120.0,
              threads: int = 1, tmp_dir: Optional[str] = None) -> List[Any]:
    """Run `fn(mesh, *args)` on `world_size` local ranks, each a process
    started by the `spawn` method, joined through a `FileStore`; returns
    their results in rank order. `device`: "cpu", or "cuda" (rank r on card
    r % count: every rank on the one card of a one-card machine). `fn` and
    its arguments must pickle, and so must its result.

    A rank that raises, dies or outlives `timeout_s` fails the run: the
    other ranks are killed and a RuntimeError carries every rank's
    traceback. `threads`: torch's intra-op threads per rank (0 keeps the
    default)."""
    ctx = torch.multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="oetpu_ranks_", dir=tmp_dir)
    try:
        store = os.path.join(work, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, backend, device, store, work, args,
                  threads, timeout_s), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = False
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs):
                failed = True
                break
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(work, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (killed: a rank failed or the run "
                                 f"passed {timeout_s:.0f} s)"
                                 if p.exitcode and p.exitcode < 0 else ""))
        if failed or errors:
            raise RuntimeError(f"{world_size}-rank run failed:\n"
                               + "\n".join(errors))
        out = []
        for r in range(world_size):
            with open(os.path.join(work, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)

