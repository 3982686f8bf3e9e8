"""Single-shard sparse table ops (port of `openembedding_tpu/ops/sparse.py`):
the gather, the scatter, the dedup + fused optimizer apply of one training
step, and the packed weights+slots layout of `Trainer.train_many`.

Tables update in place: the apply writes the touched rows of the weights
and slots it is given, the port's counterpart of the JAX package donating
the table to the step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import apply, gather
from .dedup import unique_with_counts


def lookup_rows(weights: torch.Tensor, rows: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather rows for ids of any shape -> rows.shape + (dim,). Out-of-range or
    invalid ids return zeros, the invalid-id contract of the JAX package."""
    flat = rows.reshape(-1).contiguous()
    mask = valid.reshape(-1).contiguous() if valid is not None else None
    out = gather.gather_rows(weights, flat, mask)
    return out.reshape(tuple(rows.shape) + (weights.shape[1],))


def scatter_rows(weights: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Overwrite rows in place and return `weights`: row rows[i] takes
    values[i] (cast to the table's dtype) where 0 <= rows[i] < n_rows and
    valid[i]; every other slot is dropped. The rows written must be
    unique. The selection reads its size back to the host."""
    n_rows = weights.shape[0]
    ok = (rows >= 0) & (rows < n_rows)
    if valid is not None:
        ok = ok & valid
    sel = torch.nonzero(ok).squeeze(1)
    weights.index_copy_(0, rows[sel].long(), values[sel].to(weights.dtype))
    return weights


def _dedup_routed(n_rows: int, row_ids: torch.Tensor, grads: torch.Tensor,
                  pre_counts: Optional[torch.Tensor]):
    """Dedup + routing prologue of the apply -> (g, counts, idx).

    Routing invariants (as in the JAX package):
    - padding (count 0) and negative ids route to the out-of-range sort key
      `n_rows` before the dedup: torch, like jax, wraps a negative index,
      so id -1 would otherwise train the last row;
    - slots of out-of-range unique ids get count 0 after the segment sums;
    - every invalid unique slot i maps to the distinct out-of-range row
      n_rows + i, so `idx` is ascending and duplicate-free."""
    n = row_ids.shape[0]
    if pre_counts is None:
        pre_counts = torch.ones(n, dtype=torch.int32, device=row_ids.device)
    keys = torch.where((pre_counts > 0) & (row_ids >= 0), row_ids,
                       torch.full_like(row_ids, n_rows))
    uniq = unique_with_counts(keys)
    g = uniq.segment_reduce(grads)
    counts = uniq.segment_reduce(pre_counts.to(torch.int32))
    counts = torch.where(uniq.unique_ids < n_rows, counts,
                         torch.zeros_like(counts))
    idx = torch.where(counts > 0, uniq.unique_ids,
                      n_rows + torch.arange(n, dtype=uniq.unique_ids.dtype,
                                            device=row_ids.device))
    return g, counts, idx


def sparse_apply_dense_table(
    optimizer,
    weights: torch.Tensor,
    slots: Dict[str, torch.Tensor],
    row_ids: torch.Tensor,
    grads: torch.Tensor,
    pre_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused sparse update of an array table, in place.

    row_ids: (n,) row indices (duplicates, -1 pads and out-of-range ids
    allowed); grads: (n, dim) per-occurrence gradients; pre_counts: (n,)
    multiplicity already accumulated upstream, default 1 per occurrence,
    0 = pad. Duplicate gradients are summed and the optimizer runs once per
    unique row, in float32 whatever the table's dtype; untouched rows stay
    bit-identical. Returns (weights, slots), the tensors given."""
    g, counts, idx = _dedup_routed(weights.shape[0], row_ids, grads,
                                   pre_counts)
    # through the module attribute, so a caller can swap in the plain version
    return apply.fused_sparse_apply(optimizer, weights, slots, idx,
                                    g.float(), counts)


# ---------------------------------------------------------------------------
# packed table layout (weights + optimizer slots in one array)
# ---------------------------------------------------------------------------
#
# Inside `Trainer.train_many`, where `packed_layout` allows it (off the card),
# an array table and its slots live column-wise in ONE
# (rows, dim + sum of slot widths) float32 array: the pull gathers a
# packed row and keeps its weight columns, and the apply updates the weight
# and slot columns of a row together (the kernel takes each array as a base
# pointer and a row stride, so the column ranges of the packed array go in
# as they are). The window packs at entry and unpacks at exit, so
# checkpoints, exports and serving only ever see the split layout.

# pack and unpack hold both layouts at once; a table whose packed form is
# larger than this stays split (a quarter of an 80 GB card, so both layouts
# and the rest of the step would still fit there)
PACKED_MAX_BYTES = 20 << 30


def packed_layout(dim: int, slots: Dict[str, torch.Tensor],
                  weights_dtype=torch.float32):
    """Static column layout ((name, width), ...) of a packable table, in
    sorted slot-name order as in the JAX package, or None when the table
    stays split: no slots (the weights are one array already); weights or
    slots not float32 (a bfloat16 table packed as float32 would skip the
    rounding to bfloat16 that the split path applies on every update, so
    `train_many` would no longer equal K `train_step`s); a packed array over
    `PACKED_MAX_BYTES`; slots on the CUDA card.

    The JAX gate also refuses packed widths in 33..127 that are not a
    multiple of 128, a fact of the TPU's 128-lane layout (XLA pads such rows
    and copies the whole table every step). The card has no lanes, and what
    its measurement supports is no packing at any width: `chip_smoke.py`'s
    apply phase on an NVIDIA H100 80GB HBM3 at 700.00 W measured, packed
    against split, per step, the apply kernel 0.0103-0.0104 against
    0.0123-0.0126 ms at width 10 (2^24 rows) and 0.0373-0.0378 against
    0.0377-0.0383 ms at width 64 (2^22 rows), the pull (it gathers the slot
    columns too) 0.0096-0.0097 against 0.0083-0.0085 ms and 0.0401-0.0408
    against 0.0161-0.0166 ms, and the pack and unpack 5.6 ms and 3.2 ms a
    window; a graph window of 16 steps took 1.45-1.52 ms a step packed
    against 1.10-1.19 ms split (PERF.md). Packing saves at width 10 on the
    apply about what it loses on the pull, and nothing at width 64, so the
    pack and unpack are pure cost: the gate refuses every table on the
    card. Off the card it keeps the JAX gate without the width rule, so
    `train_many` on the CPU runs the packed computation that the tests hold
    to the JAX package's."""
    if not slots:
        return None
    if weights_dtype != torch.float32:
        return None
    names = sorted(slots)
    if any(slots[n].dtype != torch.float32 for n in names):
        return None
    if any(slots[n].device.type == "cuda" for n in names):
        return None
    widths = [int(slots[n].shape[1]) for n in names]
    rows = int(slots[names[0]].shape[0])
    if rows * (dim + sum(widths)) * 4 > PACKED_MAX_BYTES:
        return None
    return tuple(zip(names, widths))


def pack_table(weights: torch.Tensor, slots: Dict[str, torch.Tensor],
               layout) -> torch.Tensor:
    """-> (rows, dim + sum of widths) float32, a new array; column order:
    the weights, then the slots in layout order."""
    return torch.cat([weights.float()] + [slots[name] for name, _ in layout],
                     dim=1)


def unpack_table(packed: torch.Tensor, layout, dim: int, weights_dtype
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (weights, {slot: array}) as column views of `packed` (weights
    cast when `weights_dtype` is not float32, which `packed_layout` never
    allows)."""
    weights = packed[:, :dim].to(weights_dtype)
    slots = {}
    off = dim
    for name, width in layout:
        slots[name] = packed[:, off:off + width]
        off += width
    return weights, slots


def sparse_apply_packed_table(optimizer, packed: torch.Tensor, layout,
                              dim: int, row_ids: torch.Tensor,
                              grads: torch.Tensor,
                              pre_counts: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """`sparse_apply_dense_table` on the packed layout, in place: the same
    dedup and the same fused apply, on column views of `packed` (the slots
    in the order the optimizer takes them). Returns `packed`."""
    g, counts, idx = _dedup_routed(packed.shape[0], row_ids, grads,
                                   pre_counts)
    weights, cols = unpack_table(packed, layout, dim, packed.dtype)
    slots = {name: cols[name] for name in optimizer.slot_shapes(dim)}
    apply.fused_sparse_apply(optimizer, weights, slots, idx, g.float(),
                             counts)
    return packed
