"""ZeRO dense-state sharding: the flat layout and its conversions (port of
`openembedding_tpu/parallel/zero.py`).

The dense tower's parameters stay replicated (every rank's forward pass
needs all of them), but its optimizer state need not be:
`MeshTrainer(dense_shard=True)` gives each of the S ranks 1/S of the
flattened dense state,

    grads  --reduce_scatter-->  this rank's chunk of the summed grad
    chunk update: optimizer.apply on 1/S of the elements
    new params  --all_gather-->  replicated params again

so the optimizer memory and the update's work a rank fall S-fold.

Layout (the JAX package's, element for element)
-----------------------------------------------
The trainable dense leaves, the sparse_as_dense tables (`__embeddings__/
<name>`) among them, flatten one after another into one float32 vector,
zero-padded to S * C with C = ceil(total / S) (rounded up to a multiple of
`align`). The leaves go in the order `jax.tree_util.tree_flatten` gives
the JAX package's trainable tree, the sort by key path, and each leaf is
flattened in flax's layout: a `Dense` kernel as (in, out), the transpose
of the port's (out, in) weight (`convert.flax_leaves` knows the names).
So the codec's 32-wide blocks, the top-k's candidates per destination
chunk, and a ZeRO state carried across from JAX cover the same elements
in both packages.

Optimizer slots split by width (`SparseOptimizer.slot_shapes`):

- vector slots (Adagrad's accum, Adam's m and v, ...) become one (1, S*C)
  vector, of which rank r holds its (1, C) chunk, the elements it updates;
- scalar slots (Adam's and Adamax's beta powers, the test optimizer's
  flip state) become one (1, 1) slot shared by every leaf, replicated.
  Every dense leaf updates every step, so the per-leaf values are equal
  (`check_scalar_slots_equal` holds a conversion to it).

At fp32 the update equals the replicated one bit for bit: the chunk's sum
is `collectives.reduce_scatter`'s, which adds the ranks' partials in the
replicated `dense_sum`'s order, every optimizer rule is elementwise along
the row, and the padding lanes carry zero weights and gradients and the
slots' initial values, so they never reach a real element. The
conversions are slices and concatenations, so a shard/unshard round trip
is byte-identical and checkpoints equal a run's without ZeRO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..model import dense_leaves
from ..ops import wire
from ..optimizers import SparseOptimizer

# reserved key marking a state's dense slots as the flat sharded form
ZERO_KEY = "__zero__"

# Slot names inside the ZERO_KEY dict that only the dense wire
# (`MeshTrainer(dense_wire=...)`) keeps:
# - DENSE_EF_KEY: this rank's error-feedback residual over the whole
#   padded vector, what its int8 or top-k encode failed to ship last step
#   (JAX: global (1, S*padded), each device's block its own residual);
# - DENSE_MASTER_KEY: the float32 master weights of this rank's chunk; the
#   replicated params the forward pass reads carry the bfloat16 all_gather's
#   rounding, the chunk's optimizer math never does.
# `unshard_slots` walks the plan's slot names only, so the external form
# never holds them and checkpoints keep the schema of a run without a wire.
DENSE_EF_KEY = "__dense_ef__"
DENSE_MASTER_KEY = "__dense_master__"


def is_sharded_slots(slots) -> bool:
    return isinstance(slots, dict) and ZERO_KEY in slots


def is_rank_block(slot: str, shape) -> bool:
    """Whether flat slot `slot` of `shape` is a rank's block of a global
    (1, S * width) array (a vector slot, the residual, the masters) rather
    than a (1, 1) scalar slot that every rank holds alike."""
    return tuple(shape) != (1, 1) or slot in (DENSE_EF_KEY, DENSE_MASTER_KEY)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One trainable dense leaf: its flat flax name (the JAX tree path
    joined by "/"), its key in the port's dense slots (a parameter's name
    or `__embeddings__/<name>`), and whether the port's tensor is the
    transpose of the flax leaf (a `Dense` kernel)."""

    name: str
    key: str
    kernel: bool = False


def trainable_leaves(module: nn.Module,
                     embeddings: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> List[Tuple[Leaf, torch.Tensor]]:
    """(leaf, tensor) of every dense leaf in JAX's flatten order: sorted by
    the flax path, key by key, so the `__embeddings__` tables fall where
    JAX puts them."""
    from ..convert import flax_leaves
    flax = flax_leaves(module)
    out = []
    for key, tensor in dense_leaves(module, embeddings):
        if key in flax:
            name, kernel = flax[key]
        elif key in dict(module.named_parameters()):
            raise ValueError(f"dense parameter {key!r} has no flax name: "
                             f"{type(module).__name__}.flax_dense() must "
                             "list its layer")
        else:
            name, kernel = key, False
        out.append((Leaf(name, key, kernel), tensor))
    return sorted(out, key=lambda lt: tuple(lt[0].name.split("/")))


@dataclasses.dataclass(frozen=True)
class DenseShardPlan:
    """The flat layout of one trainable dense subtree. `shapes` are the
    flax shapes ((in, out) for a kernel)."""

    leaves: Tuple[Leaf, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    num_shards: int
    chunk: int          # C = ceil(total / S), rounded up to `align`
    padded: int         # S * C
    vector_slots: Tuple[str, ...]
    scalar_slots: Tuple[str, ...]
    slot_init: Dict[str, float]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def build_plan(params: Sequence[Tuple[Leaf, torch.Tensor]],
               optimizer: SparseOptimizer, num_shards: int, *,
               align: int = 1) -> DenseShardPlan:
    """The plan of the leaves `trainable_leaves` gives. `align` rounds the
    chunk up to a multiple (the dense wire passes `wire.INBAND_BLOCK`, so
    every chunk is whole codec blocks); the extra lanes are zero padding
    like the rest."""
    for _, t in params:
        if t.element_size() > 4:
            raise ValueError(
                "dense_shard supports <=32-bit dense params (the flat shard "
                f"buffer is f32); got a {_dtype_name(t.dtype)} leaf — the "
                "replicated baseline's own optimizer math runs in f32 "
                "anyway")
    leaves = tuple(leaf for leaf, _ in params)
    shapes = tuple(tuple(t.shape[::-1]) if leaf.kernel else tuple(t.shape)
                   for leaf, t in params)
    sizes = tuple(int(t.numel()) for _, t in params)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    total = off
    S = max(1, int(num_shards))
    chunk = -(-total // S) if total else 0
    if align > 1 and chunk:
        chunk = -(-chunk // align) * align
    # width classes from a probe width that cannot collide with 1
    widths = optimizer.slot_shapes(2)
    return DenseShardPlan(
        leaves=leaves, shapes=shapes,
        dtypes=tuple(t.dtype for _, t in params), sizes=sizes,
        offsets=tuple(offsets), total=total, num_shards=S, chunk=chunk,
        padded=S * chunk,
        vector_slots=tuple(k for k, w in widths.items() if w != 1),
        scalar_slots=tuple(k for k, w in widths.items() if w == 1),
        slot_init={k: float(optimizer.slot_init(k)) for k in widths})


def flatten_tree(plan: DenseShardPlan,
                 tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """{slot key: tensor} (params or gradients in the port's layout) ->
    the (padded,) float32 vector, flax layout, zero tail."""
    parts = [(tree[leaf.key].t() if leaf.kernel else tree[leaf.key])
             .detach().reshape(-1).to(torch.float32) for leaf in plan.leaves]
    if plan.padded > plan.total:
        device = parts[0].device if parts else None
        parts.append(torch.zeros(plan.padded - plan.total,
                                 dtype=torch.float32, device=device))
    return torch.cat(parts) if parts else torch.zeros(0)


def unflatten_tree(plan: DenseShardPlan, flat: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """(padded,) float32 -> {slot key: tensor} in the port's layout and
    each leaf's dtype (a kernel as a transposed view)."""
    out = {}
    for leaf, shape, dtype, size, off in zip(
            plan.leaves, plan.shapes, plan.dtypes, plan.sizes, plan.offsets):
        piece = flat[off:off + size].reshape(shape)
        out[leaf.key] = (piece.t() if leaf.kernel else piece).to(dtype)
    return out


@torch.no_grad()
def write_tree(plan: DenseShardPlan, flat: torch.Tensor,
               tree: Mapping[str, torch.Tensor]) -> None:
    """`unflatten_tree(plan, flat)` copied into `tree`'s tensors, in
    place."""
    for key, value in unflatten_tree(plan, flat).items():
        tree[key].copy_(value)


def _row_to_flax(leaf: Leaf, shape, row: torch.Tensor) -> torch.Tensor:
    """A (1, size) slot row in the port's layout -> (size,) in flax's."""
    if leaf.kernel:
        return row.reshape(shape[::-1]).t().reshape(-1)
    return row.reshape(-1)


def _row_from_flax(leaf: Leaf, shape, piece: torch.Tensor) -> torch.Tensor:
    """Inverse of `_row_to_flax` -> a (1, size) row."""
    if leaf.kernel:
        return piece.reshape(shape).t().reshape(1, -1)
    return piece.reshape(1, -1).clone()


def shard_slots(plan: DenseShardPlan,
                slots_tree: Mapping[str, Mapping[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Per-leaf dense slots {slot key: {slot: (1, size)}} -> the flat slot
    dict {slot: (1, padded) vector | (1, 1) scalar}, the padding at the
    slot's initial value. Concatenation only: lossless."""
    out: Dict[str, torch.Tensor] = {}
    for name in plan.vector_slots:
        parts = [_row_to_flax(leaf, shape, slots_tree[leaf.key][name])
                 .to(torch.float32)
                 for leaf, shape in zip(plan.leaves, plan.shapes)]
        if plan.padded > plan.total:
            device = parts[0].device if parts else None
            parts.append(torch.full((plan.padded - plan.total,),
                                    plan.slot_init[name],
                                    dtype=torch.float32, device=device))
        flat = torch.cat(parts) if parts else torch.zeros(0)
        out[name] = flat.reshape(1, -1)
    for name in plan.scalar_slots:
        if plan.leaves:
            out[name] = slots_tree[plan.leaves[0].key][name].reshape(
                1, 1).to(torch.float32).clone()
        else:
            out[name] = torch.full((1, 1), plan.slot_init[name],
                                   dtype=torch.float32)
    return out


def unshard_slots(plan: DenseShardPlan,
                  flat_slots: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The flat slot dict (whole (1, padded) vectors) -> per-leaf dense
    slots: vector slots sliced back per leaf, each leaf its own copy of
    the shared scalars. Only the plan's slot names: the dense wire's
    masters and residual stay behind."""
    out = {}
    for leaf, shape, size, off in zip(plan.leaves, plan.shapes, plan.sizes,
                                      plan.offsets):
        d = {}
        for name in plan.vector_slots:
            d[name] = _row_from_flax(
                leaf, shape, flat_slots[name].reshape(-1)[off:off + size])
        for name in plan.scalar_slots:
            d[name] = flat_slots[name].reshape(1, 1).clone()
        out[leaf.key] = d
    return out


def encode_flat(flat: torch.Tensor, fmt: str) -> torch.Tensor:
    """(n,) float32 (n a multiple of `wire.INBAND_BLOCK`) -> the in-band
    encoding, one codec block a row: (n/B, W) in the carrier dtype (int8
    codes with their scales' lanes, or the bfloat16 bits as int16). Rounds
    to nearest: the int8 dense wire carries a residual instead of the
    dither."""
    return wire.pack_inband(flat.reshape(-1, wire.INBAND_BLOCK), fmt)


def decode_flat(enc: torch.Tensor, fmt: str) -> torch.Tensor:
    """Inverse of `encode_flat` -> (n,) float32."""
    return wire.unpack_inband(enc, wire.INBAND_BLOCK, fmt).reshape(-1)


def encode_flat_topk(flat: torch.Tensor, num_shards: int,
                     k: int) -> torch.Tensor:
    """(padded,) float32, destination-major -> (S, topk_wire_width(k))
    int8: one sparse top-k payload a destination chunk, rounded to
    nearest (the untransmitted mass feeds `__dense_ef__`)."""
    return wire.pack_topk(flat.reshape(num_shards, -1), k)


def decode_flat_topk(enc: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """(n, topk_wire_width(k)) int8 -> dense (n, chunk) float32, the
    untransmitted elements exactly 0."""
    return wire.unpack_topk(enc, k, chunk)


def _carrier_itemsize(fmt: str) -> int:
    return torch.empty((), dtype=wire.wire_carrier_dtype(fmt)).element_size()


def dense_wire_cost(plan: DenseShardPlan, fmt: Optional[str], *,
                    topk: Optional[int] = None) -> dict:
    """The bytes a rank's dense update moves, per format (the JAX
    package's model, which prices the collectives' result buffers):

    - None / "fp32": the reduce_scatter and the all_gather of the padded
      float32 vector (`rs_bytes`, `ag_bytes`);
    - "int8" / "bf16": the all_to_all whose result holds every source's
      encoding of this rank's chunk (padded / INBAND_BLOCK codec blocks of
      the in-band width), and the params' all_gather on the 2-byte carrier
      (`a2a_bytes`, `ag_bytes`);
    - "sparse_topk" (`topk` = k needed): S payloads of `topk_wire_width(k)`
      int8 lanes, and the same all_gather."""
    S, padded = plan.num_shards, plan.padded
    if S <= 1 or padded == 0:
        return {"format": fmt or "fp32", "rs_bytes": 0, "a2a_bytes": 0,
                "ag_bytes": 0, "bytes_per_step": 0}
    if not fmt or fmt == "fp32":
        rs = ag = padded * 4
        return {"format": "fp32", "rs_bytes": rs, "a2a_bytes": 0,
                "ag_bytes": ag, "bytes_per_step": rs + ag}
    if fmt == "sparse_topk":
        if not topk:
            raise ValueError("dense_wire_cost: fmt='sparse_topk' needs topk")
        a2a = S * wire.topk_wire_width(int(topk))
        ag = padded * 2  # the updated params ride the 2-byte carrier
        return {"format": fmt, "k": int(topk), "rs_bytes": 0,
                "a2a_bytes": int(a2a), "ag_bytes": int(ag),
                "bytes_per_step": int(a2a + ag)}
    blocks = padded // wire.INBAND_BLOCK
    a2a = (blocks * wire.rows_wire_width(wire.INBAND_BLOCK, fmt)
           * _carrier_itemsize(fmt))
    ag = padded * 2
    return {"format": fmt, "rs_bytes": 0, "a2a_bytes": int(a2a),
            "ag_bytes": int(ag), "bytes_per_step": int(a2a + ag)}


def plan_device_bytes(plan: DenseShardPlan, *, ef: bool = False,
                      master: bool = False) -> Dict[str, int]:
    """A rank's bytes of the flat dense state: each vector slot's (1, C)
    float32 chunk and one float32 a scalar slot; `ef` adds the residual
    (the whole padded vector a rank), `master` the chunk's masters. The
    replicated params are `params_device_bytes`."""
    out = {"zero_slots": plan.chunk * 4 * len(plan.vector_slots)
           + 4 * len(plan.scalar_slots)}
    if ef:
        out["zero_ef"] = plan.padded * 4
    if master:
        out["zero_master"] = plan.chunk * 4
    return out


def params_device_bytes(plan: DenseShardPlan) -> int:
    """A rank's bytes of the replicated params the plan flattens, in their
    own dtypes."""
    return sum(size * torch.empty((), dtype=dt).element_size()
               for size, dt in zip(plan.sizes, plan.dtypes))


def check_scalar_slots_equal(plan: DenseShardPlan, slots_tree) -> None:
    """One scalar slot for every leaf is lossless only when every leaf
    holds the same value (true of any state this package trained: every
    dense leaf updates every step). A state that breaks it fails here
    rather than have its optimizer state rewritten."""
    for name in plan.scalar_slots:
        vals = [slots_tree[leaf.key][name].detach().reshape(-1)
                for leaf in plan.leaves]
        for v in vals[1:]:
            if not torch.equal(v.view(torch.int32),
                               vals[0].view(torch.int32)):
                raise ValueError(
                    f"dense_shard: scalar optimizer slot {name!r} differs "
                    "across dense leaves — this state was not produced by "
                    "whole-tree dense training and cannot be sharded "
                    "losslessly (load it with dense_shard off)")
