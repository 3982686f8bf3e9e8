"""The meshes of the port: one process per rank over `torch.distributed`.

Port of `openembedding_tpu/parallel/mesh.py`. The JAX package runs one SPMD
program over a `jax.sharding.Mesh` with one axis, "data"; the port runs one
process per rank, and rank r plays device r of that mesh under
`shard_map`: it holds one shard of every table and one slice of the batch,
and the collectives go through the rank's process group (NCCL on cards,
gloo on the CPU).

How the JAX package's sharding specs read here:

- table rows, `P("data")`: rank r holds shard r, the rows of the ids with
  `id % S == r` at local row `id // S` (the reference's layout);
- dense params and their slots, `P()`: replicated, every rank holds all of
  them (broadcast from rank 0 at init, then kept equal by the dense sum);
- the batch, `P("data")` on its leading dim: rank r takes rows
  `[r*B/S, (r+1)*B/S)` of the global batch (`multihost.local_batch`).

The 2-D mesh of context parallelism (`make_seq_mesh`, the JAX package's
`Mesh(devices.reshape(D, P), ("data", "seq"))` under `SeqMeshTrainer`):
D x P ranks, data-major, rank = d * P + s, the order in which JAX flattens
the axis tuple ("data", "seq"), so the tables row-sharded over the whole
mesh (`id % (D*P)`) are JAX's shard for shard. The mesh object is the
world's (the sparse exchange, the dense sum and the metrics run over all
D*P ranks) and carries two more: `seq`, this rank's group along the
sequence axis (ring and Ulysses attention), and `data`, its group along
the data axis.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass
class Mesh:
    """One rank's view of the 1-D mesh: its process group (None = the
    world), rank, size S, device, backend and the axis name. `staged_bytes`
    counts the bytes that collectives copied between the card and the host
    because the backend moves host tensors only (gloo with CUDA tensors)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = DATA_AXIS
    staged_bytes: int = 0
    # a 2-D mesh (`make_seq_mesh`): its axis names and shape (D, P), and
    # this rank's sub-meshes along each axis
    axis_names: Tuple[str, ...] = (DATA_AXIS,)
    shape: Tuple[int, ...] = ()
    seq: Optional["Mesh"] = None
    data: Optional["Mesh"] = None

    def total_staged_bytes(self) -> int:
        """The bytes staged through the host by this mesh's collectives and
        its sub-meshes'."""
        return self.staged_bytes + sum(
            m.staged_bytes for m in (self.seq, self.data) if m is not None)

    @property
    def staged(self) -> bool:
        """Whether the collectives copy through host buffers: gloo with
        tensors on a card, at two ranks or more."""
        return (self.size > 1 and self.backend == "gloo"
                and self.device.type == "cuda")


def _default_device(rank: int) -> torch.device:
    """cuda:<LOCAL_RANK> (torchrun's), else the rank's card in turn; raises
    without a card (`device.resolve_device`)."""
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """The mesh over `group` (default: the world group, which must be
    initialized: `multihost.initialize`). `device`: the rank's device; None
    is the rank's card (`cuda:<LOCAL_RANK>`) and raises without one; pass
    "cpu" for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialized: call "
            "parallel.multihost.initialize() (or run under torchrun) first")
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    device = (_default_device(rank) if device is None
              else torch.device(device))
    return Mesh(group=group, rank=rank, size=size, device=device,
                backend=str(dist.get_backend(group)))


SEQ_AXIS = "seq"


def make_seq_mesh(data: int, seq: int, *, device=None,
                  axis_names: Tuple[str, str] = (DATA_AXIS, SEQ_AXIS)
                  ) -> Mesh:
    """This rank's view of the 2-D (data, seq) mesh over the world group
    of `data * seq` ranks (initialized: `multihost.initialize`): the world
    mesh, with `seq` (the P ranks d*P .. d*P + P-1 of its data row) and
    `data` (the D ranks s, P + s, ... of its seq column) as sub-meshes. A
    collective: every rank calls it, and makes every group in the same
    order (the seq groups by d, then the data groups by s); an axis of
    size 1 has no group (its collectives are the identity)."""
    world = make_mesh(device=device)
    if world.size != data * seq:
        raise ValueError(f"a ({data}, {seq}) mesh needs {data * seq} ranks, "
                         f"the world has {world.size}")
    d, s = divmod(world.rank, seq)

    def sub(members, rank, name):
        group = dist.new_group(members) if len(members) > 1 else None
        return Mesh(group=group, rank=rank, size=len(members),
                    device=world.device, backend=world.backend,
                    axis_name=name, axis_names=(name,))

    seq_meshes = [sub([row * seq + j for j in range(seq)], s, axis_names[1])
                  for row in range(data)]
    data_meshes = [sub([i * seq + col for i in range(data)], d,
                       axis_names[0]) for col in range(seq)]
    return dataclasses.replace(world, axis_names=tuple(axis_names),
                               shape=(data, seq), seq=seq_meshes[d],
                               data=data_meshes[s])
