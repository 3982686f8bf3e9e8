"""Static-capacity dedup and owner bucketing (port of
`openembedding_tpu/ops/dedup.py`, single-lane ids).

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


def carry_to_unique(uniq: UniqueResult, values: torch.Tensor,
                    fill) -> torch.Tensor:
    """A per-position value (n,) carried to its unique slot (n,) through the
    sort already paid: `values[order]` lines up with the ascending segment
    ids, so one scatter lands each id's value in its slot (every position
    of one id must carry the same value). Padding slots keep `fill`."""
    n = uniq.order.shape[0]
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_(0, uniq.seg, values[uniq.order])


class BucketResult(NamedTuple):
    bucket_ids: torch.Tensor    # (S, capacity) ids grouped by owner shard
    bucket_valid: torch.Tensor  # (S, capacity) bool
    # where unique slot (or input element) i sits: bucket (owner[i], slot[i])
    owner: torch.Tensor         # (n,) int64, S for an invalid slot
    slot: torch.Tensor          # (n,) int64, capacity when not bucketed
    overflow: torch.Tensor      # () int32: ids dropped from a full bucket


def bucket_validity(bucket_ids: torch.Tensor) -> torch.Tensor:
    """Occupancy of a bucket array whose empty slots hold the -1 sentinel
    (`unique_and_route`'s, not `bucket_by_owner`'s zero-filled one), on
    either side of the all_to_all."""
    return bucket_ids >= 0


def bucket_by_owner(ids: torch.Tensor, valid: torch.Tensor, num_shards: int,
                    capacity: int) -> BucketResult:
    """Input ids grouped into per-owner buckets of static capacity, owner
    `id % num_shards` (the reference's layout), input order kept inside a
    bucket; elements past a bucket's capacity are counted in `overflow` and
    dropped. Empty slots are zero-filled and `bucket_valid` is the mask."""
    n = ids.shape[0]
    dev = ids.device
    S = num_shards
    owner = torch.where(valid, torch.remainder(ids, S),
                        torch.full_like(ids, S))
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    group_start = torch.searchsorted(sorted_owner, sorted_owner, right=False)
    slot_sorted = torch.arange(n, device=dev) - group_start
    in_cap = (slot_sorted < capacity) & (sorted_owner < S)
    overflow = torch.sum(~in_cap & (sorted_owner < S)).to(torch.int32)
    flat_pos = torch.where(in_cap, sorted_owner * capacity + slot_sorted,
                           torch.full_like(slot_sorted, S * capacity))
    # one spare slot past the buckets takes the dropped writes
    bucket_ids = torch.zeros(S * capacity + 1, dtype=ids.dtype, device=dev)
    bucket_ids[flat_pos] = ids[order]
    bucket_valid = torch.zeros(S * capacity + 1, dtype=torch.bool,
                               device=dev)
    bucket_valid[flat_pos] = True
    owner_out = torch.empty_like(sorted_owner).scatter_(0, order,
                                                        sorted_owner)
    slot_out = torch.empty_like(slot_sorted).scatter_(
        0, order, torch.where(in_cap, slot_sorted,
                              torch.full_like(slot_sorted, capacity)))
    return BucketResult(bucket_ids[:-1].reshape(S, capacity),
                        bucket_valid[:-1].reshape(S, capacity), owner_out,
                        slot_out, overflow)


def unique_and_route(ids: torch.Tensor, valid: torch.Tensor,
                     num_shards: int, capacity: int, owner=None) -> tuple:
    """Dedup and owner routing from one sort by (owner, id, index) ->
    (UniqueResult, BucketResult).

    The JAX package sorts the three keys in one multi-key sort. Torch has
    no lexsort, so two stable argsorts make it: by id, then by owner (the
    second keeps the first's order among equal owners, and the first keeps
    the input order among equal ids). Owner and id are not packed into one
    key: ids reach 2^63 - 1.

    The unique ids come out owner-major (id-sorted inside an owner), so a
    unique's bucket slot is its rank less its owner group's start. Invalid
    ids (`valid` False) route to the pseudo-owner `num_shards` and reach no
    bucket. Empty bucket slots hold the -1 sentinel, so validity follows
    from the ids (`bucket_validity`) and no mask rides the wire. `owner`:
    an explicit per-position owner in [0, num_shards] (a pure function of
    the id), instead of `id % num_shards`. Every step is integer work."""
    n = ids.shape[0]
    dev = ids.device
    S = num_shards
    if ids.dim() != 1:
        raise ValueError(f"unique_and_route takes (n,) ids, got shape "
                         f"{tuple(ids.shape)}")
    iota = torch.arange(n, device=dev)
    owner_in = (torch.remainder(ids, S) if owner is None else owner).long()
    owner_in = torch.where(valid, owner_in, torch.full_like(owner_in, S))
    by_id = torch.argsort(ids, stable=True)
    order = by_id[torch.argsort(owner_in[by_id], stable=True)]
    so = owner_in[order]
    sorted_ids = ids[order]
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = (so[1:] != so[:-1]) | (sorted_ids[1:] != sorted_ids[:-1])
    seg = torch.cumsum(is_new, 0) - 1
    num_unique = seg[-1] + 1
    unique_ids = torch.zeros_like(ids).scatter_(0, seg, sorted_ids)
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, seg, torch.ones(n, dtype=torch.int32, device=dev))
    inverse = torch.empty_like(seg).scatter_(0, order, seg)
    uniq = UniqueResult(unique_ids, inverse, counts, num_unique, order, seg)

    # owner per unique slot; padding slots keep the pseudo-owner S
    u_owner = torch.full((n,), S, dtype=torch.int64, device=dev).scatter_(
        0, seg, so)
    # bucket slot = unique rank within the owner group (seg is owner-major)
    per_owner = torch.zeros(S + 1, dtype=torch.int64, device=dev).index_add_(
        0, so, is_new.long())
    start = torch.cumsum(per_owner, 0) - per_owner
    slot_u = torch.where(u_owner < S, iota - start[torch.clamp(u_owner, 0,
                                                                 S - 1)],
                         torch.full_like(iota, capacity))
    in_cap = (u_owner < S) & (slot_u < capacity)
    overflow = torch.sum((u_owner < S) & (slot_u >= capacity)).to(
        torch.int32)
    flat_pos = torch.where(in_cap, u_owner * capacity + slot_u,
                           torch.full_like(slot_u, S * capacity))
    bucket_ids = torch.full((S * capacity + 1,), -1, dtype=ids.dtype,
                            device=dev)
    bucket_ids[flat_pos] = unique_ids
    bucket_ids = bucket_ids[:-1].reshape(S, capacity)
    slot_out = torch.where(in_cap, slot_u, torch.full_like(slot_u, capacity))
    return uniq, BucketResult(bucket_ids, bucket_validity(bucket_ids),
                              u_owner, slot_out, overflow)


def concat_owner_buckets(bucket_ids_list) -> torch.Tensor:
    """[(S, cap_t) sentinel-filled bucket arrays] -> one (S, sum cap_t) wire
    array in the widest integer type of the list: each table keeps a fixed
    segment, so the table is known by position and no tag rides the wire.
    Single-lane ids only (the port has no split-pair layout)."""
    dt = max((b.dtype for b in bucket_ids_list),
             key=lambda d: torch.empty((), dtype=d).element_size())
    return torch.cat([b.to(dt) for b in bucket_ids_list], dim=1)


def split_owner_buckets(wire_ids: torch.Tensor, templates) -> list:
    """Inverse of `concat_owner_buckets` after the all_to_all: each table's
    segment in its own dtype. `templates`: [(cap, dtype)] in concatenation
    order. Valid ids fit their own dtype, and -1 stays -1."""
    outs, off = [], 0
    for cap, dtype in templates:
        outs.append(wire_ids[:, off:off + cap].to(dtype))
        off += cap
    if off != wire_ids.shape[1]:
        raise ValueError(f"templates cover {off} slots, wire has "
                         f"{wire_ids.shape[1]}")
    return outs


def unbucket(bucket_rows: torch.Tensor, owner: torch.Tensor,
             slot: torch.Tensor) -> torch.Tensor:
    """Read back each element's row from its (owner, slot) bucket position;
    (S, capacity, ...) rows -> (n, ...), zeros where the element was not
    bucketed."""
    num_shards, capacity = bucket_rows.shape[:2]
    flat = bucket_rows.reshape((num_shards * capacity,)
                               + tuple(bucket_rows.shape[2:]))
    pos = torch.clamp(owner * capacity + slot, 0, num_shards * capacity - 1)
    oob = (owner >= num_shards) | (slot >= capacity)
    out = flat[pos]
    return torch.where(oob.reshape((-1,) + (1,) * (out.dim() - 1)),
                       torch.zeros_like(out), out)


# -- the conflict set of the pipelined loop (`parallel/sharded.py`
# `grouped_conflict_patch`): batch t+1's prefetched rows are stale only where
# batch t's push updated them, and the intersection rides one sort, as the
# exchange does: no hash table, no shape that depends on the data ----------


def member_mask(ref_ids: torch.Tensor, ref_valid: torch.Tensor,
                query_ids: torch.Tensor,
                query_valid: torch.Tensor) -> torch.Tensor:
    """Each query's membership in the set of VALID reference ids, from one
    stable sort of the concatenated (R,) and (Q,) single-lane ids with a
    reference weight riding along: a query is a member when its id's
    segment holds a valid reference entry. Invalid queries are never
    members and invalid references never vouch, so the -1 padding of
    bucket arrays on either side collides harmlessly. -> (Q,) bool."""
    R = ref_ids.shape[0]
    cat = torch.cat([ref_ids, query_ids.to(ref_ids.dtype)])
    n = cat.shape[0]
    contrib = torch.cat([ref_valid.to(torch.int32),
                         torch.zeros(n - R, dtype=torch.int32,
                                     device=cat.device)])
    order = torch.argsort(cat, stable=True)
    s_id = cat[order]
    is_new = torch.ones(n, dtype=torch.bool, device=cat.device)
    is_new[1:] = s_id[1:] != s_id[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    seg_refs = torch.zeros(n, dtype=torch.int32, device=cat.device) \
        .index_add_(0, seg, contrib[order])
    hit = seg_refs[seg] > 0
    out = torch.zeros(n, dtype=torch.bool, device=cat.device) \
        .scatter_(0, order, hit)
    return out[R:] & query_valid


def compact_member_slots(member: torch.Tensor, pcap: int):
    """A (S, cap) membership mask compacted per row into (S, pcap) slot
    indices: member j of row s lands at its rank among row s's members,
    -1 pads. Members past `pcap` drop and are counted in the returned ()
    int32 overflow (such a row keeps its one-step-stale prefetched value).
    -> (slots (S, pcap) int64, overflow)."""
    S, cap = member.shape
    dev = member.device
    pos = torch.cumsum(member.to(torch.int64), dim=1) - 1
    within = member & (pos < pcap)
    row = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    flat_tgt = torch.where(within, row * pcap + pos,
                           torch.full_like(pos, S * pcap))
    col = torch.arange(cap, dtype=torch.int64, device=dev).expand(S, cap)
    # one spare slot past the buckets takes the dropped writes
    slots = torch.full((S * pcap + 1,), -1, dtype=torch.int64, device=dev)
    slots[flat_tgt.reshape(-1)] = col.reshape(-1)
    overflow = torch.sum(member & ~within).to(torch.int32)
    return slots[:-1].reshape(S, pcap), overflow
