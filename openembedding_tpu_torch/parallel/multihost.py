"""Process-group set-up, the rank's slice of the batch and a local launcher
(port of `openembedding_tpu/parallel/multihost.py:38-120`).

The JAX package's rendezvous is `jax.distributed.initialize`; the port's is
`torch.distributed.init_process_group`, fed by `torchrun`'s environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) or by a shared
init file, always with a finite timeout. Every rank reads the same batch
stream and keeps its own rows (`local_batch`), the JAX `global_batch`
sharding `P("data")` seen from one rank.

`global_batch` / `window_batch` give a rank its rows of the node's batch
(or of a stacked window, along axis 1) on its device: the ingest ring's
staging (`data/ingest.py`). A node is the JAX package's host: every rank
of a node reads the node's stream (`node_id`, `num_nodes`).

`run_local` spawns S ranks on this machine (the tests and `chip_smoke.py`
use it); `torchrun --nproc-per-node S` is the production launcher.
`allgather_host_ids` unions the ranks' host-side id sets (the incremental
persister's touched rows); `host_sharded_reader` reads a TSV stream split
by rows over the ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

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


def node_id() -> int:
    """This process's node (torchrun's GROUP_RANK; 0 without it): the
    "host" of the JAX package's multi-host ingest, which reads its own
    slice of the files (`data.ingest.sharded_files`) and feeds every rank
    on the node."""
    return int(os.environ.get("GROUP_RANK", 0))


def num_nodes() -> int:
    """The number of nodes (torchrun's NNODES; 1 without it)."""
    return int(os.environ.get("NNODES", 1))


def _node_rows(x, mesh: Mesh, axis: str, dim: int):
    """This rank's rows along `dim` of its node's share of a batch: the
    node's N ranks along `axis` (the mesh's ranks on the axis, over
    `num_nodes()`) split the node's rows in rank order."""
    names = tuple(mesh.axis_names)
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's {names}")
    if len(names) == 1:
        pos, size = mesh.rank, mesh.size
    else:
        coords = divmod(mesh.rank, mesh.shape[1])
        pos, size = coords[names.index(axis)], mesh.shape[names.index(axis)]
    nodes = num_nodes()
    if size % nodes:
        raise ValueError(f"the mesh's {size} ranks along {axis!r} do not "
                         f"divide over {nodes} nodes")
    per_node = size // nodes
    return _block(x, per_node, pos % per_node, dim, "batch")


def node_rows(local, mesh: Mesh, axis: str = "data", dim: int = 0):
    """This rank's block of every leaf of the node's batch along `dim`, on
    the host (numpy arrays or tensors as given; None stays None): what
    `global_batch` (dim 0) and `window_batch` (dim 1) put on the device."""
    def take(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim < dim + 1:
            raise ValueError(f"{'window_batch' if dim else 'global_batch'}"
                             f" leaf ndim {x.ndim}: need "
                             f"{'(K, batch, ...)' if dim else '(batch, ...)'}")
        return _node_rows(x, mesh, axis, dim)

    return take(local)


def _put_rows(local, mesh: Mesh, axis: str, dim: int):
    def put(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return torch.as_tensor(x).to(mesh.device)

    return put(node_rows(local, mesh, axis, dim))


def global_batch(local: Dict, mesh: Mesh, axis: str = "data") -> Dict:
    """This rank's rows of a batch, as tensors on the mesh's device.

    `local` is the node's rows of the global batch (the whole batch on one
    node): every rank of a node reads the node's stream and keeps its own
    block of rows, in rank order along `axis` (on one node this is
    `local_batch`). It is the JAX `global_batch` seen from one rank: the
    JAX package puts a host's rows on its devices, sharded over the axis."""
    return _put_rows(local, mesh, axis, 0)


def window_batch(local: Dict, mesh: Mesh, axis: str = "data") -> Dict:
    """`global_batch` for a stacked K-step window: every leaf is (K, batch,
    ...), the batch dim is axis 1 and K stays whole on every rank (what
    `MeshTrainer.train_many` steps over). A leaf of fewer than 2 dims
    raises ValueError."""
    return _put_rows(local, mesh, axis, 1)


def _block(x, size: int, index: int, dim: int, what: str):
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"global {what} {n} does not divide by the mesh's "
                         f"{size} ranks")
    m = n // size
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * m, (index + 1) * m)
    return x[tuple(sl)]


def local_batch(batch, mesh: Mesh):
    """Rank r's rows `[r*B/S, (r+1)*B/S)` of every leaf of a global batch
    (numpy arrays or tensors; None stays None). B must divide by S.

    On a 2-D (data, seq) mesh (`make_seq_mesh`), rank d*P + s's block as
    the JAX SeqMeshTrainer shards the batch: sparse ids (B, ..., S) take
    the d-th B/D rows and the s-th S/P chunk of their last (sequence) dim;
    a label of two dims or more is sharded (data, seq); everything else
    (dense features, weight, a 1-D label) over data only."""
    if len(mesh.axis_names) == 2:
        return _local_batch_2d(batch, mesh)
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


def _local_batch_2d(batch, mesh: Mesh):
    D, P = mesh.shape
    d, s = divmod(mesh.rank, P)

    def rows(x):
        return None if x is None else _block(x, D, d, 0, "batch")

    out = {}
    for key, value in batch.items():
        if key == "sparse":
            out[key] = {k: _block(rows(v), P, s, v.ndim - 1, "sequence")
                        for k, v in value.items()}
        elif key == "label" and value is not None and value.ndim >= 2:
            out[key] = _block(rows(value), P, s, 1, "sequence")
        else:
            out[key] = rows(value)
    return out


def allgather_host_ids(ids, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The union of every rank's host-side id set -> sorted unique int64
    (negative ids dropped). A collective: every rank calls it at the same
    point with its own set (the incremental persister's touched ids: each
    rank observes only its slice of the batch, but a row any rank's batch
    touched belongs in the delta). Two rounds over the mesh's group, as in
    the JAX package: the counts, then the ids padded with -1 to the
    largest count. `mesh`: None is the world group (or this process alone
    without one)."""
    ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
    ids = ids[ids >= 0]
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return ids
        mesh = make_mesh(device="cpu" if dist.get_backend() == "gloo"
                         else None)
    if mesh.size == 1:
        return ids
    from . import collectives as coll
    dev = mesh.device
    counts = coll.all_gather(mesh, torch.tensor([ids.size],
                                                dtype=torch.int64,
                                                device=dev))
    m = int(torch.cat(counts).max())
    if m == 0:
        return np.empty((0,), np.int64)
    padded = torch.full((m,), -1, dtype=torch.int64, device=dev)
    padded[:ids.size] = torch.from_numpy(ids).to(dev)
    gathered = torch.cat(coll.all_gather(mesh, padded)).cpu().numpy()
    gathered = np.unique(gathered)
    return gathered[gathered >= 0]


def host_sharded_reader(paths: Sequence[str], global_batch_size: int,
                        mesh: Optional[Mesh] = None, *,
                        id_space: int = 1 << 25, repeat: bool = False,
                        native: str = "auto") -> Iterator[Dict]:
    """Criteo TSV split over the ranks by rows: rank r of S reads rows
    `i % S == r` (the reference's tf.data shard per worker) and yields its
    local batches of `global_batch_size // S` rows, numpy, what
    `MeshTrainer` steps on (the JAX package assembles them into global
    arrays; a port rank keeps its own). `mesh`: None is this process's
    rank in the world group (`host_id`, `num_hosts`). Every rank yields as
    many batches a pass: rows differ by at most one between ranks, which
    the dropped remainder absorbs."""
    from ..data.criteo import read_criteo_tsv
    hosts = mesh.size if mesh is not None else num_hosts()
    me = mesh.rank if mesh is not None else host_id()
    if global_batch_size % max(1, hosts) != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {hosts} "
            "hosts")
    local_bs = global_batch_size // max(1, hosts)
    yield from read_criteo_tsv(paths, local_bs, id_space=id_space,
                               host_id=me, num_hosts=hosts,
                               drop_remainder=True, repeat=repeat,
                               native=native)


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

