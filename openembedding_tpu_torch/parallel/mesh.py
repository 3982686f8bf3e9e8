"""The 1-D mesh of the port: one process per rank over `torch.distributed`.

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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

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
