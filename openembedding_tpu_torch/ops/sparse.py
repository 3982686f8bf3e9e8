"""Single-shard sparse table ops (port of `openembedding_tpu/ops/sparse.py`).

Slice 1 ports the read side only: `lookup_rows`. The scatter and the fused
optimizer apply come with training (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import gather


def lookup_rows(weights: torch.Tensor, rows: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather rows for ids of any shape -> rows.shape + (dim,). Out-of-range or
    invalid ids return zeros, the invalid-id contract of the JAX package."""
    flat = rows.reshape(-1).contiguous()
    mask = valid.reshape(-1).contiguous() if valid is not None else None
    out = gather.gather_rows(weights, flat, mask)
    return out.reshape(tuple(rows.shape) + (weights.shape[1],))
