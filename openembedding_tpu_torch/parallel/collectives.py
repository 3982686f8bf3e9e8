"""The collectives of the mesh path (port-only: `jax.lax` supplies them in
the JAX package).

- `all_to_all`: an (S, cap, ...) tensor, slice s to rank s, the slices
  received stacked in rank order (`jax.lax.all_to_all(x, axis, 0, 0)`);
- `psum`: an exact sum over the ranks, for integer stats and counters;
- `dense_sum`: the sum over the ranks of float tensors, made
  deterministic: the S partials are all_gathered and added in rank order,
  ((p0 + p1) + p2) + ..., the source-order fold that XLA:CPU's all-reduce
  does (`parallel/sharded.py:626-634` of the JAX package), so runs repeat
  bit for bit on the card too;
- `pmean`: `dense_sum` / S; `broadcast`, `barrier`.

At S = 1 every collective is the identity and launches nothing, as in the
JAX package. Under NCCL the tensors stay on the card. Under gloo, which
moves host tensors only, a CUDA tensor goes through host buffers because
the caller chose `backend="gloo"`; the bytes copied each way are counted
in `mesh.staged_bytes`. Gloo and NCCL both refuse int16 and uint16
("Invalid scalar type", "Unconvertible NCCL type Short"), so a tensor of
such a dtype (the bf16 wire's carrier) travels as an int8 view of the same
bytes.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from .mesh import Mesh

_BYTE_VIEW = (torch.int16, torch.uint16)


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if mesh.staged:
        mesh.staged_bytes += x.numel() * x.element_size()
        x = x.cpu()
    if x.dtype in _BYTE_VIEW:
        x = x.view(torch.int8)
    return x


def _from_wire(mesh: Mesh, x: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
    if x.dtype != like.dtype:
        x = x.view(like.dtype)
    if x.device != like.device:
        mesh.staged_bytes += x.numel() * x.element_size()
        x = x.to(like.device)
    return x


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(S, cap, ...) -> (S, cap, ...): row s of the result is what rank s
    sent this rank."""
    if mesh.size == 1:
        return x
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all takes a leading dim of {mesh.size} "
                         f"ranks, got shape {tuple(x.shape)}")
    send = _to_wire(mesh, x)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=mesh.group)
    return _from_wire(mesh, out, x)


def all_gather(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's `x`, in rank order."""
    if mesh.size == 1:
        return [x]
    send = _to_wire(mesh, x)
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return [_from_wire(mesh, p, x) for p in parts]


def dense_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, added in rank order: bit for bit the same
    on every rank and from run to run."""
    if mesh.size == 1:
        return x
    parts = all_gather(mesh, x)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of an integer tensor (exact in any order)."""
    return dense_sum(mesh, x)


def pmean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`dense_sum` / S (`jax.lax.pmean`)."""
    if mesh.size == 1:
        return x
    return dense_sum(mesh, x) / mesh.size


def psum_stats(mesh: Mesh, stats: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Every stat summed over the ranks in one collective: the stats travel
    as one float64 vector, exact for the integer counts (below 2^53) and
    for the one-hot float32 fill shares (one nonzero term each)."""
    if mesh.size == 1 or not stats:
        return stats
    keys = sorted(stats)
    flat = torch.cat([stats[k].reshape(-1).to(torch.float64) for k in keys])
    total = dense_sum(mesh, flat)
    out, off = {}, 0
    for k in keys:
        v = stats[k]
        out[k] = total[off:off + v.numel()].reshape(v.shape).to(v.dtype)
        off += v.numel()
    return out


def broadcast_(mesh: Mesh, x: torch.Tensor, src: int = 0) -> None:
    """Rank `src`'s `x` into every rank's `x`, in place."""
    if mesh.size == 1:
        return
    buf = _to_wire(mesh, x)
    dist.broadcast(buf, src=src, group=mesh.group)
    x.copy_(_from_wire(mesh, buf, x))


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
