"""Single-shard sparse table ops (port of `openembedding_tpu/ops/sparse.py`):
the gather, the scatter, and the dedup + fused optimizer apply of one
training step.

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
