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
- `pmean`: `dense_sum` / S; `broadcast`, `barrier`;
- the ZeRO dense update's two (`parallel/zero.py`): `reduce_scatter`,
  this rank's chunk of the sum added in rank order as `dense_sum` adds
  it, and `all_gather_tiled`, the ranks' chunks laid end to end;
- context parallelism's three (`parallel/sequence.py`), on a seq group
  and differentiable (`torch.autograd.Function`s): `ppermute`, each rank's
  tensor to the next rank of the ring, whose backward rotates the other
  way; `all_to_all_grad`, `all_to_all` whose backward is the same
  all_to_all of the gradient (it is its own inverse); and
  `all_gather_cat`, the ranks' tensors concatenated along a dim (no
  gradient: the key-padding mask). `ppermute` is an `all_to_all_single`
  with one non-empty slice each way, the collective the mesh's graphs
  already capture over NCCL (no point-to-point call).

At S = 1 every collective is the identity and launches nothing, as in the
JAX package.

`record_bytes()` counts, while it is open, the result bytes of each
collective per kind, under the names of XLA's HLO ops that the JAX package
counts (`all_to_all`, `all_reduce` for `dense_sum` / `psum` / `pmean` /
`psum_stats`, `all_gather`, `reduce_scatter`, `collective_permute`); a
collective built on another counts once, under its own kind.
`record_sequence()` records the same collectives in order, with the group
size, dtype and shape of each (`utils/guards`' fingerprint). Under NCCL the
tensors stay on the card. Under gloo, which
moves host tensors only, a CUDA tensor goes through host buffers because
the caller chose `backend="gloo"`; the bytes copied each way are counted
in `mesh.staged_bytes`. Gloo and NCCL both refuse int16 and uint16
("Invalid scalar type", "Unconvertible NCCL type Short"), so a tensor of
such a dtype (the bf16 wire's carrier) travels as an int8 view of the same
bytes; a bool tensor travels as uint8.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List

import torch
import torch.distributed as dist

from .mesh import Mesh

_BYTE_VIEW = {torch.int16: torch.int8, torch.uint16: torch.int8,
              torch.bool: torch.uint8}


# the open `record_bytes` dicts and `record_sequence` lists, and how deep
# the current collective nests in another (only the outermost one counts)
_RECORDS: List[Dict[str, int]] = []
_SEQUENCES: List[List[tuple]] = []
_DEPTH = [0]


@contextlib.contextmanager
def record_bytes():
    """Count the result bytes of every collective run inside the block,
    per kind -> the dict, filled as they run."""
    seen: Dict[str, int] = {}
    _RECORDS.append(seen)
    try:
        yield seen
    finally:
        _RECORDS.remove(seen)


@contextlib.contextmanager
def record_sequence():
    """Record every collective run inside the block, in order, as (kind,
    group size, dtype, shape) -> the list, filled as they run (what
    `utils/guards.collective_fingerprint` hashes). A dict of stats
    (`psum_stats`) records its keys, shapes and dtypes."""
    seq: List[tuple] = []
    _SEQUENCES.append(seq)
    try:
        yield seq
    finally:
        _SEQUENCES.remove(seq)


def _signature(x) -> tuple:
    if isinstance(x, dict):
        return ("dict", tuple((k, str(v.dtype), tuple(v.shape))
                              for k, v in sorted(x.items())))
    return (str(x.dtype), tuple(x.shape))


def _note(kind: str, mesh: Mesh, x, scale) -> None:
    """Count one outermost collective in the open records."""
    if _RECORDS:
        n = int(_nbytes(x) * scale(mesh))
        for seen in _RECORDS:
            seen[kind] = seen.get(kind, 0) + n
    if _SEQUENCES:
        entry = (kind, mesh.size) + _signature(x)
        for seq in _SEQUENCES:
            seq.append(entry)


def _nbytes(x) -> int:
    if isinstance(x, dict):
        return sum(v.numel() * 8 for v in x.values())
    return x.numel() * x.element_size()


def _counted(kind: str, scale=lambda mesh: 1):
    """Count a collective's result bytes (`_nbytes` of its input times
    `scale(mesh)`) under `kind` in every open `record_bytes`, and record it
    in every open `record_sequence`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(mesh, x, *args, **kwargs):
            if (_RECORDS or _SEQUENCES) and _DEPTH[0] == 0 \
                    and mesh.size > 1:
                _note(kind, mesh, x, scale)
            _DEPTH[0] += 1
            try:
                return fn(mesh, x, *args, **kwargs)
            finally:
                _DEPTH[0] -= 1
        return wrapped
    return deco


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if mesh.staged:
        mesh.staged_bytes += x.numel() * x.element_size()
        x = x.cpu()
    if x.dtype in _BYTE_VIEW:
        x = x.view(_BYTE_VIEW[x.dtype])
    return x


def _from_wire(mesh: Mesh, x: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
    if x.dtype != like.dtype:
        x = x.view(like.dtype)
    if x.device != like.device:
        mesh.staged_bytes += x.numel() * x.element_size()
        x = x.to(like.device)
    return x


@_counted("all_to_all")
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


@_counted("all_gather", lambda mesh: mesh.size)
def all_gather(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's `x`, in rank order."""
    if mesh.size == 1:
        return [x]
    send = _to_wire(mesh, x)
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return [_from_wire(mesh, p, x) for p in parts]


def rank_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """((p0 + p1) + p2) + ...: the ranks' parts added in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@_counted("all_reduce")
def dense_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, added in rank order: bit for bit the same
    on every rank and from run to run."""
    if mesh.size == 1:
        return x
    return rank_sum(all_gather(mesh, x))


@_counted("reduce_scatter", lambda mesh: 1 / mesh.size)
def reduce_scatter(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(S * C,) -> (C,): chunk r of the sum over the ranks on rank r, the
    all_to_all of the (S, C) view and the S chunks received added in rank
    order; bit for bit `dense_sum(mesh, x)[r*C:(r+1)*C]`, the port's
    counterpart of `psum_scatter(tiled=True)`. Not
    `dist.reduce_scatter_tensor`: NCCL's ring adds the partials in its own
    order, and the ZeRO update would no longer equal the replicated one."""
    if mesh.size == 1:
        return x
    recv = all_to_all(mesh, x.reshape(mesh.size, -1))
    return rank_sum(list(recv.unbind(0)))


def all_gather_tiled(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(C, ...) -> (S * C, ...): every rank's `x` concatenated in rank order
    (`all_gather(tiled=True)`); int16 travels as int8 bytes."""
    if mesh.size == 1:
        return x
    return torch.cat(all_gather(mesh, x))


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of an integer tensor (exact in any order)."""
    return dense_sum(mesh, x)


@_counted("all_reduce")
def pmean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`dense_sum` / S (`jax.lax.pmean`)."""
    if mesh.size == 1:
        return x
    return dense_sum(mesh, x) / mesh.size


@_counted("all_reduce")
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


@_counted("broadcast")
def broadcast_(mesh: Mesh, x: torch.Tensor, src: int = 0) -> None:
    """Rank `src`'s `x` into every rank's `x`, in place."""
    if mesh.size == 1:
        return
    buf = _to_wire(mesh, x)
    dist.broadcast(buf, src=src, group=mesh.group)
    x.copy_(_from_wire(mesh, buf, x))


def broadcast_object(mesh: Mesh, obj=None, src: int = 0):
    """Rank `src`'s picklable `obj`, returned on every rank (the others'
    `obj` is ignored): its length, then its bytes, by `broadcast_` on the
    rank's device."""
    if mesh.size == 1:
        return obj
    import pickle
    payload = pickle.dumps(obj) if mesh.rank == src else b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=mesh.device)
    broadcast_(mesh, n, src=src)
    buf = torch.zeros((int(n.item()),), dtype=torch.uint8, device=mesh.device)
    if mesh.rank == src:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    broadcast_(mesh, buf, src=src)
    return obj if mesh.rank == src else pickle.loads(
        buf.cpu().numpy().tobytes())


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        if _DEPTH[0] == 0:
            for seq in _SEQUENCES:
                seq.append(("barrier", mesh.size))
        dist.barrier(group=mesh.group)


# -- context parallelism (`parallel/sequence.py`) -------------------------------


@_counted("collective_permute")
def _shift(mesh: Mesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's `x` to rank (r + shift) % S, rank (r - shift) % S's
    received: one `all_to_all_single` whose only non-empty slices are
    those two."""
    S = mesh.size
    dst, src = (mesh.rank + shift) % S, (mesh.rank - shift) % S
    send = _to_wire(mesh, x).reshape(-1)
    out = torch.empty_like(send)
    n = send.numel()
    dist.all_to_all_single(out, send, [n if j == src else 0 for j in range(S)],
                           [n if j == dst else 0 for j in range(S)],
                           group=mesh.group)
    return _from_wire(mesh, out, x).reshape(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(mesh, x, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.mesh, g, -1), None


def ppermute(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rotate around the ring: rank r's `x` to rank (r + 1) % S, so this
    rank gets rank r - 1's (`jax.lax.ppermute` with the perm
    [(j, (j + 1) % S)]); the backward rotates the gradient the other way.
    Every rank of the group calls it, in the same order."""
    if mesh.size == 1:
        return x
    if x.requires_grad:
        return _PPermute.apply(x, mesh)
    return _shift(mesh, x, 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_to_all(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(ctx.mesh, g.contiguous()), None


def all_to_all_grad(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`all_to_all` of an (S, ...) tensor with a gradient: slice s of the
    gradient goes back to rank s (the all_to_all is its own inverse)."""
    if mesh.size == 1:
        return x
    return _AllToAll.apply(x, mesh)


def all_gather_cat(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order
    (`jax.lax.all_gather(x, axis, axis=dim, tiled=True)`), no gradient."""
    if mesh.size == 1:
        return x
    return torch.cat(all_gather(mesh, x.detach()), dim=dim)
