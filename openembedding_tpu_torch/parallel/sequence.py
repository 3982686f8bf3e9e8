"""Sequence (context) parallelism: ring attention and Ulysses attention
(port of `openembedding_tpu/parallel/sequence.py`).

The JAX package writes both as per-device code under `shard_map` over a
mesh axis "seq"; here each rank runs them over its seq group (the 2-D
mesh's `seq` sub-mesh, `parallel/mesh.make_seq_mesh`), with the
differentiable collectives of `parallel/collectives.py`:

- `ring_attention`: q stays put; the k/v block and its key-padding mask
  rotate around the ring (`collectives.ppermute`) while an online-softmax
  accumulator (running max and denominator in float32) folds in one block a
  step. Memory is O(S/P) a rank.
- `ulysses_attention`: two all_to_alls re-shard seq -> heads, so each rank
  runs full attention on H/P heads, then shard back. Needs num_heads % P
  == 0.

Both match `reference_attention` (plain softmax attention, the single-device
oracle) within float tolerance. q/k/v are (B, S_local, H, D); `causal` uses
global positions (seq rank i holds positions [i*S_local, (i+1)*S_local)).
Softmax math is float32 whatever the input dtype, the output cast back to
q's. The products are `torch.einsum`, as the JAX package's are plain `jnp`.

A module names its axis ("seq"), as a JAX module names the `shard_map`
axis; `bind_axis(name, mesh)` binds the name to a seq sub-mesh for the
duration (`parallel.SeqMeshTrainer` binds it around its forward passes),
and an unbound name raises, as an unbound axis does in JAX.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Callable, Dict, Optional, Union

import torch

from ..layers import sqrt_f32
from . import collectives as coll
from .mesh import Mesh

NEG_INF = -1e30

_BOUND: Dict[str, Mesh] = {}


@contextmanager
def bind_axis(name: str, mesh: Mesh):
    """Bind the axis `name` to `mesh` (a seq sub-mesh) for the duration."""
    prev = _BOUND.get(name)
    _BOUND[name] = mesh
    try:
        yield mesh
    finally:
        if prev is None:
            del _BOUND[name]
        else:
            _BOUND[name] = prev


def axis_mesh(axis: Union[str, Mesh]) -> Mesh:
    """The sub-mesh an axis name is bound to (a `Mesh` is returned as it
    is); raises NameError for an unbound name."""
    if isinstance(axis, Mesh):
        return axis
    mesh = _BOUND.get(axis)
    if mesh is None:
        raise NameError(f"unbound axis name: {axis} (run the module under "
                        "parallel.SeqMeshTrainer, or bind it with "
                        "sequence.bind_axis)")
    return mesh


def _causal_keep(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        k_offset: int = 0,
                        kv_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain softmax attention, the oracle both schemes must match. Offsets
    give the q and k blocks their global positions for the causal mask.
    `kv_valid` (B, Sk) bool: the key-padding mask, False keys take no
    softmax mass (bidirectional attention needs it, BERT4Rec). Masked
    scores are NEG_INF, not -inf: a query row with every key masked gets a
    uniform softmax over all keys, as in the JAX package, not NaN."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / sqrt_f32(D, dev)
    if causal:
        keep = _causal_keep(q_offset + torch.arange(Sq, device=dev),
                            k_offset + torch.arange(Sk, device=dev))
        scores = torch.where(keep, scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                       v.to(torch.float32))
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: Union[str, Mesh], causal: bool = True,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring (context-parallel) attention over the seq group `axis`.

    At step t this rank (ring index i) holds the kv block of rank
    (i - t) mod P and folds it into its running accumulator; the block, its
    values and its key-padding mask `kv_valid` (B, S_local) then move to
    the next rank (P - 1 rotations: the JAX loop's last one brings each
    block home and is never read). A query row with every key masked has
    l = 0 and gives 0 (`o / max(l, 1e-30)`), where `reference_attention`
    gives a uniform average: both as in the JAX package."""
    mesh = axis_mesh(axis)
    P, i = mesh.size, mesh.rank
    B, S, H, D = q.shape
    dev = q.device
    qf = q.to(torch.float32)
    scale = 1.0 / sqrt_f32(D, dev)
    q_pos = i * S + torch.arange(S, device=dev)
    gb = (torch.ones((B, S), dtype=torch.bool, device=dev)
          if kv_valid is None else kv_valid)
    kb, vb = k, v
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, S, D), dtype=torch.float32, device=dev)
    for t in range(P):
        src = (i - t) % P
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              kb.to(torch.float32)) * scale
        if causal:
            k_pos = src * S + torch.arange(S, device=dev)
            scores = torch.where(_causal_keep(q_pos, k_pos), scores,
                                 NEG_INF)
        scores = torch.where(gb[:, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        # fully masked rows keep m == NEG_INF: freeze them so exp() stays 0
        alpha = torch.exp(torch.where(m > NEG_INF / 2, m - m_new, 0.0))
        # a fully masked block has m_new == NEG_INF and scores - m_new == 0:
        # gate on the raw scores so masked entries add exactly 0
        p = torch.where(scores > NEG_INF / 2,
                        torch.exp(scores - m_new[..., None]), 0.0)
        l = l * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                vb.to(torch.float32))
        m = m_new
        if t + 1 < P:
            kb = coll.ppermute(mesh, kb)
            vb = coll.ppermute(mesh, vb)
            gb = coll.ppermute(mesh, gb)
    out = o / torch.clamp(l, min=1e-30)[..., None]              # (B,H,S,D)
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: Union[str, Mesh], causal: bool = True,
                      kv_valid: Optional[torch.Tensor] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Ulysses (all-to-all) sequence parallelism over the seq group `axis`:
    re-shard seq -> heads, full attention on H/P heads (`attn_fn`, default
    `reference_attention`), re-shard back. `kv_valid` (B, S_local) is
    all_gathered along the group (ring order is global position order):
    after the re-shard the key axis is global. A custom `attn_fn` with a
    `kv_valid` is refused: its mask contract is unknown."""
    mesh = axis_mesh(axis)
    P = mesh.size
    B, S, H, D = q.shape
    if H % P != 0:
        raise ValueError(f"num_heads {H} not divisible by seq-parallel "
                         f"size {P}")
    if kv_valid is not None:
        if attn_fn is not None:
            raise ValueError(
                "ulysses_attention: kv_valid with a custom attn_fn is not "
                "supported — apply the key-padding mask inside attn_fn")
        kv_valid = coll.all_gather_cat(mesh, kv_valid, dim=1)
    attn = attn_fn or partial(reference_attention, causal=causal,
                              kv_valid=kv_valid)

    def to_heads(x):   # (B, S/P, H, D) -> (B, S, H/P, D)
        parts = x.reshape(B, S, P, H // P, D).permute(2, 0, 1, 3, 4)
        got = coll.all_to_all_grad(mesh, parts.contiguous())
        return got.permute(1, 0, 2, 3, 4).reshape(B, P * S, H // P, D)

    def to_seq(x):     # (B, S, H/P, D) -> (B, S/P, H, D)
        parts = x.reshape(B, P, S, H // P, D).permute(1, 0, 2, 3, 4)
        got = coll.all_to_all_grad(mesh, parts.contiguous())
        return got.permute(1, 2, 0, 3, 4).reshape(B, S, H, D)

    out = attn(to_heads(q), to_heads(k), to_heads(v))
    return to_seq(out).to(q.dtype)


__all__ = ["NEG_INF", "bind_axis", "axis_mesh", "reference_attention",
           "ring_attention", "ulysses_attention"]
