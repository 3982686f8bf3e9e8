"""Static-capacity dedup (port of `openembedding_tpu/ops/dedup.py`, single-lane
ids).

A buffer of n ids dedups into a buffer of n slots: the first `num_unique`
slots hold the sorted unique ids, the rest are padding with `counts == 0`.
Nothing here reads a value back to the host, so the shapes never depend on
the data.

Order is fixed everywhere, so results repeat bit for bit from run to run and
match the JAX package on the CPU: the sort is stable (as `jnp.argsort` is),
and `segment_reduce` sums each segment's rows one after another in sorted
order (`torch.segment_reduce`, a sequential loop per segment on the CPU and
on CUDA). `index_add_` would sum with atomics in an order that changes
between CUDA runs; it is used only for integers, whose sums are exact in any
order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class UniqueResult(NamedTuple):
    unique_ids: torch.Tensor  # (n,) first num_unique slots: sorted unique ids
    inverse: torch.Tensor     # (n,) int64: ids[i] == unique_ids[inverse[i]]
    counts: torch.Tensor      # (n,) int32 multiplicity; 0 = padding slot
    num_unique: torch.Tensor  # () int64
    order: torch.Tensor       # (n,) int64 stable sort permutation of ids
    seg: torch.Tensor         # (n,) int64 ascending segment id of ids[order]

    def segment_reduce(self, payload: torch.Tensor) -> torch.Tensor:
        """Sum per-occurrence `payload` (n, ...) into the unique slots
        (n, ...); padding slots get zeros."""
        data = payload[self.order]
        if data.is_floating_point():
            # lengths sum to n and are >= 0 by construction: unsafe=True
            # skips the validation, which would read them back to the host
            return torch.segment_reduce(data, "sum", lengths=self.counts,
                                        unsafe=True)
        return torch.zeros_like(data).index_add_(0, self.seg, data)


def unique_with_counts(ids: torch.Tensor) -> UniqueResult:
    """Sort-based unique with inverse mapping and counts, static output
    size n, for single-lane (n,) integer ids."""
    if ids.dim() != 1:
        raise ValueError(f"unique_with_counts takes (n,) ids, got shape "
                         f"{tuple(ids.shape)}")
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    is_new = torch.ones(n, dtype=torch.bool, device=ids.device)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    num_unique = seg[-1] + 1
    # duplicate writes to one slot all carry the same id
    unique_ids = torch.zeros_like(ids).scatter_(0, seg, sorted_ids)
    counts = torch.zeros(n, dtype=torch.int32, device=ids.device).index_add_(
        0, seg, torch.ones(n, dtype=torch.int32, device=ids.device))
    inverse = torch.empty_like(seg).scatter_(0, order, seg)
    return UniqueResult(unique_ids, inverse, counts, num_unique, order, seg)
