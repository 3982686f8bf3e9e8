"""Sharded pull and push: the reference's parameter-server wire protocol as
collectives between the mesh's ranks (port of
`openembedding_tpu/parallel/sharded.py`).

Each rank holds one shard of every table (the ids with `id % S == rank`,
at local row `id // S`) and one slice of the batch. These functions run on
every rank at once, as the JAX package's run inside `shard_map`.

PULL (the reference's client dedup -> one RPC per server -> server gather
-> client reassembly):

1. dedup and owner routing from one sort (`ops/dedup.unique_and_route`);
2. `all_to_all` of the id buckets; empty slots hold -1, so validity
   follows from the ids;
3. the owner serves its rows: array tables through `ops/sparse.lookup_rows`
   at local row `id // S` (the gather kernel); hash tables probe and insert
   on the shard (`tables/hash_table.hash_lookup_train`), the overflow
   increment summed over the ranks;
4. `all_to_all` of the rows back, unbucketed, duplicates expanded.

PUSH and UPDATE, reusing the pull's plan:

1. the client sums its duplicates' grads into the unique slots;
2. ONE `all_to_all` of grads with the counts in extra lanes of the same
   payload (their int32 bits, never rounded);
3. the owner dedups again across the sources (its receive buffer is
   source-major) and applies the optimizer once per unique row through
   `ops/sparse.sparse_apply_dense_table` (the fused apply kernel). A hash
   table applies at the slots its pull found for the same receive
   positions (the keys do not change between the two), where the JAX
   package probes again with `hash_find`: the same slots, one probe less.

So three all_to_alls per dim-group a step: tables of one width share each
of them (`grouped_lookup_train` / `grouped_apply_gradients`), each table a
fixed segment of the concatenated buffer. Rows and grads travel in the
wire format (`ops/wire.py`: fp32, or bf16 or int8 encoded at the sending
edge). With int8, a table carrying `ef` ships q(w + ef) from the owner
and keeps ef' = (w + ef) - deq(q) (error feedback), and the grad push
rounds stochastically (the wire's hash dither). `S == 1` routes by
identity: no collective, no bucket scatter, fp32.

Static capacity: each (source, owner) bucket holds `cap` ids;
`capacity_factor` f sizes it to ceil(f * n / S) (f = 0: cap = n, never
drops). An id past a full bucket pulls zeros and drops its gradient, and
is counted in `pull_overflow` / `push_overflow`. Out-of-vocabulary ids of
an array table pull zeros and train nothing, as on one device.

SKEW-AWARE PLACEMENT (the JAX package's hot rows and cold-tail migration):

- A table with a replicated hot cache (`EmbeddingTableState.hot`) probes
  each id against the hot set (`_hot_probe`, a 16-round probe of a small
  table) before the sort. Hot positions route to the pseudo-owner S: no
  bucket slot, no wire bytes, no owner load. Their rows gather from the
  local cache (`_merge_hot_rows`, the gather kernel), and their gradients
  are summed into an (H, dim) aggregate, reduced over the ranks in rank
  order (`collectives.dense_sum`; the int8 `hot_wire` an all_to_all, a
  per-rank sum and an all_gather of encoded rows) and applied alike on
  every rank by the fused apply over rows `arange(H)` (`_hot_apply`).
  At the fp32 wire the sums fold the ranks in the order the cold owner's
  segment sum does, so an array table's run with hot rows equals one
  without, bit for bit, once `hot_writeback` has written the cache back
  (a hash table may give a promoted id another slot, and so another
  initial row, than its first pull would).
- A table with a migration directory (`EmbeddingTableState.mig`) probes
  each id against it too, and a migrated id routes to its assigned owner
  (`unique_and_route(owner=...)`): no extra collective or byte. The owner
  serves and trains it in its annex (`mig.weights`, the gather and the
  fused apply kernels) and masks it out of the main table, so a hash
  table never inserts it again. `mig_writeback` restores the home rows.
- The lifecycle runs between steps (`build_hot_identity`, `hot_gather`,
  `hot_writeback`, `build_mig_identity`, `mig_gather`, `mig_writeback`):
  contents change, tensors do not, so no captured graph goes stale.

PIPELINED (`MeshTrainer(pipeline_steps=True)`): the pull splits into a
prefetch issued a step ahead (`grouped_prefetch`), a conflict patch after
the previous batch's apply (`grouped_conflict_patch`) and the client's
tail at consume time (`grouped_finalize_pull`); see their section below.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

import numpy as np

from ..embedding import EmbeddingSpec, EmbeddingTableState, HotRows, MigRows
from ..ops import apply as apply_mod
from ..ops import wire as wire_mod
from ..ops.dedup import (BucketResult, UniqueResult, bucket_validity,
                         carry_to_unique, compact_member_slots,
                         concat_owner_buckets, member_mask,
                         split_owner_buckets, unbucket, unique_and_route,
                         unique_with_counts)
from ..ops.sparse import lookup_rows, sparse_apply_dense_table
from ..tables.hash_table import (hash_find, hash_find_or_insert, hash_lookup,
                                 hash_lookup_train, np_hash_insert,
                                 shard_probe)
from . import collectives as coll
from .mesh import Mesh

# probe rounds of the hot set's and the migration directory's tables (C =
# max(2H, 8) slots); `build_hot_identity` places ids within the same budget,
# so the device probe reaches every placed id
HOT_NUM_PROBES = 16


class ExchangePlan(NamedTuple):
    """The routing a pull and its push share: the client's dedup and
    buckets, the ids this rank serves and the capacity; `slot`, for a hash
    table after a training pull, the slot of each received id (`capacity`
    where it is invalid, overflowed or migrated), which the push applies
    at. With a hot cache, `hot_slot` (n,) holds each unique slot's cache
    row (`hot_rows` = H for a cold one); with a migration directory,
    `mig_moved` (n,) int32 is 1 where the directory routed the unique id
    off its `id % S` home (accounting only). `ef_stash` (S, cap, dim), from
    a training serve that ran error feedback: the residual each received
    slot's serve consumed, zeros where it took none (invalid and annex
    slots); local to the owner, never on a wire, it lets the pipelined
    loop's `grouped_conflict_patch` replay the serve."""

    uniq: UniqueResult
    buckets: BucketResult
    recv_ids: torch.Tensor    # (S, cap) ids this rank serves
    recv_valid: torch.Tensor  # (S, cap)
    cap: int
    slot: Optional[torch.Tensor] = None
    hot_slot: Optional[torch.Tensor] = None
    hot_rows: int = 0
    mig_moved: Optional[torch.Tensor] = None
    ef_stash: Optional[torch.Tensor] = None


def _bucket_capacity(n: int, num_shards: int, capacity_factor: float) -> int:
    if capacity_factor <= 0:  # exact mode
        return n
    return max(1, min(n, int(-(-capacity_factor * n // num_shards))))


def _id_valid(spec: EmbeddingSpec, ids: torch.Tensor) -> torch.Tensor:
    """In-vocabulary mask: a hash table takes every non-negative id, an
    array table [0, input_dim), so padded shard rows are never read or
    trained."""
    if spec.use_hash_table:
        return ids >= 0
    return (ids >= 0) & (ids < spec.input_dim)


def flatten_ids(spec: EmbeddingSpec, ids: torch.Tensor) -> torch.Tensor:
    """(...) -> (n,): one entry per id position."""
    del spec
    return ids.reshape(-1)


def ids_positions(spec: EmbeddingSpec, ids: torch.Tensor) -> int:
    del spec
    return ids.numel()


def _identity_plan(spec: EmbeddingSpec, flat: torch.Tensor) -> ExchangePlan:
    """S == 1: every id is local, so the plan serves the unique ids as they
    are (no bucket scatter, no collective)."""
    n = flat.shape[0]
    uniq = unique_with_counts(flat)
    valid = (uniq.counts > 0) & _id_valid(spec, uniq.unique_ids)
    recv_ids, recv_valid = uniq.unique_ids[None], valid[None]
    buckets = BucketResult(
        bucket_ids=recv_ids, bucket_valid=recv_valid,
        owner=torch.zeros(n, dtype=torch.int64, device=flat.device),
        slot=torch.arange(n, device=flat.device),
        overflow=torch.zeros((), dtype=torch.int32, device=flat.device))
    return ExchangePlan(uniq, buckets, recv_ids, recv_valid, n)


def _probe_rank(keys: torch.Tensor, rank: torch.Tensor, empty: int,
                flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each position's rank in a placement probe table (`empty` where it
    misses; invalid positions probe -1 and always miss)."""
    C = keys.shape[0]
    probe = torch.where(valid, flat, torch.full_like(flat, -1))
    pslot = hash_find(keys, probe, num_probes=HOT_NUM_PROBES)
    return torch.where(pslot < C, rank[torch.clamp(pslot, 0, C - 1)].long(),
                       torch.full_like(pslot, empty))


def _hot_probe(hot: HotRows, flat: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Each position's hot cache row in [0, H] (H: a miss)."""
    return _probe_rank(hot.keys, hot.rank, hot.weights.shape[0], flat, valid)


def _mig_find(mig: MigRows, flat: torch.Tensor, valid: torch.Tensor):
    """Each position's directory entry -> (found, rank (M where not),
    owner (-1 where not))."""
    M = mig.ids.shape[0]
    rank = _probe_rank(mig.keys, mig.rank, M, flat, valid)
    found = rank < M
    owner = torch.where(found, mig.owners[torch.clamp(rank, 0, M - 1)].long(),
                        torch.full_like(rank, -1))
    return found, rank, owner


def _route_owner(mig: MigRows, flat: torch.Tensor, valid: torch.Tensor,
                 S: int):
    """Each position's owner under the directory: the assigned owner where
    it hits, the `id % S` home elsewhere, S where invalid -> (owner,
    moved: the directory routed it off its home)."""
    home = torch.remainder(flat, S)
    found, _, own = _mig_find(mig, flat, valid)
    moved = found & (own != home)
    owner = torch.where(valid & found, own,
                        torch.where(valid, home, torch.full_like(home, S)))
    return owner, moved


def _client_route(spec: EmbeddingSpec, flat: torch.Tensor, S: int,
                  capacity_factor: float, hot: Optional[HotRows] = None,
                  mig: Optional[MigRows] = None):
    """The client's dedup and owner routing: a plan without its id
    exchange -> (uniq, buckets, cap, hot_slot, mig_moved), the last two
    None without a cache or a directory. Hot positions route to the
    pseudo-owner S (no bucket slot) and keep their unique slots."""
    cap = _bucket_capacity(flat.shape[0], S, capacity_factor)
    valid = _id_valid(spec, flat)
    if hot is None and mig is None:
        uniq, buckets = unique_and_route(flat, valid, S, cap)
        return uniq, buckets, cap, None, None
    owner = moved = None
    if mig is not None:
        owner, moved = _route_owner(mig, flat, valid, S)
    if hot is None:
        uniq, buckets = unique_and_route(flat, valid, S, cap, owner=owner)
        return uniq, buckets, cap, None, carry_to_unique(
            uniq, moved.to(torch.int32), 0)
    H = hot.weights.shape[0]
    hr = _hot_probe(hot, flat, valid)
    uniq, buckets = unique_and_route(flat, valid & (hr >= H), S, cap,
                                     owner=owner)
    hot_slot = carry_to_unique(uniq, hr, H)
    mig_moved = None if moved is None else carry_to_unique(
        uniq, (moved & (hr >= H)).to(torch.int32), 0)
    return uniq, buckets, cap, hot_slot, mig_moved


_S1_REFUSALS = {
    "hot": "hot-row replication needs S >= 2: on a 1-device mesh the "
           "shard and the cache are the same memory, and two copies of a "
           "row can only diverge (MeshTrainer disables hot_rows at mesh "
           "size 1)",
    "mig": "cold-tail re-sharding needs S >= 2: on a 1-device mesh there "
           "is nowhere to migrate a row to (MeshTrainer disables mig_rows "
           "at mesh size 1)"}


def make_plan(spec: EmbeddingSpec, ids: torch.Tensor, *, mesh: Mesh,
              capacity_factor: float = 0.0, hot: Optional[HotRows] = None,
              mig: Optional[MigRows] = None) -> ExchangePlan:
    """Dedup the rank's ids, bucket them by owner and exchange the buckets
    (one all_to_all); `S == 1` is the identity plan. `hot`: the table's
    cache (hot positions leave the exchange); `mig`: its directory
    (migrated ids route to their assigned owner). Both need S >= 2."""
    flat = flatten_ids(spec, ids)
    if mesh.size == 1:
        if hot is not None:
            raise ValueError(_S1_REFUSALS["hot"])
        if mig is not None:
            raise ValueError(_S1_REFUSALS["mig"])
        return _identity_plan(spec, flat)
    uniq, buckets, cap, hot_slot, moved = _client_route(
        spec, flat, mesh.size, capacity_factor, hot, mig)
    recv_ids = coll.all_to_all(mesh, buckets.bucket_ids)
    return ExchangePlan(uniq, buckets, recv_ids, bucket_validity(recv_ids),
                        cap, None, hot_slot,
                        0 if hot is None else hot.weights.shape[0], moved)


def grouped_make_plans(specs, ids_list, *, mesh: Mesh,
                       capacity_factor: float = 0.0, hots=None,
                       migs=None) -> List[ExchangePlan]:
    """Plans for a dim-group of tables with ONE id all_to_all: each table
    routes as in `make_plan` (with its cache `hots[i]` and directory
    `migs[i]`), and its (S, cap_t) buckets ride as a fixed segment of one
    concatenated buffer."""
    hots = hots if hots is not None else [None] * len(specs)
    migs = migs if migs is not None else [None] * len(specs)
    if mesh.size == 1:
        return [make_plan(spec, ids, mesh=mesh,
                          capacity_factor=capacity_factor, hot=hot, mig=mig)
                for spec, ids, hot, mig in zip(specs, ids_list, hots, migs)]
    parts = [_client_route(spec, flatten_ids(spec, ids), mesh.size,
                           capacity_factor, hot, mig)
             for spec, ids, hot, mig in zip(specs, ids_list, hots, migs)]
    wire_ids = concat_owner_buckets([p[1].bucket_ids for p in parts])
    recv = coll.all_to_all(mesh, wire_ids)
    segs = split_owner_buckets(recv, [(cap, b.bucket_ids.dtype)
                                      for _, b, cap, _, _ in parts])
    return [ExchangePlan(uniq, buckets, seg, bucket_validity(seg), cap, None,
                         hs, 0 if hot is None else hot.weights.shape[0], mv)
            for (uniq, buckets, cap, hs, mv), seg, hot
            in zip(parts, segs, hots)]


def exchange_load_stats(plan: ExchangePlan, *, mesh: Mesh
                        ) -> Dict[str, torch.Tensor]:
    """This rank's share of the per-shard load of one pull (the caller's
    stats sum makes them global): `shard_rows[d]`, the unique rows shard d
    serves; `shard_positions[d]`, the id positions (duplicates counted)
    shard d owns; `bucket_fill[s]`, the fill of source s's fullest bucket
    (one-hot at this rank)."""
    S = mesh.size
    routed = torch.sum(plan.buckets.bucket_valid, dim=1).to(torch.int32)
    w = torch.where(plan.uniq.counts > 0, plan.uniq.counts,
                    torch.zeros_like(plan.uniq.counts))
    positions = torch.zeros(S + 1, dtype=torch.int32,
                            device=w.device).index_add_(
        0, plan.buckets.owner, w)[:S]
    # times the float32 reciprocal: the JAX package's division by a
    # constant, as XLA rewrites it
    occ = routed.max().to(torch.float32) * (1.0 / max(plan.cap, 1))
    fill = torch.zeros(S, dtype=torch.float32, device=w.device)
    fill[mesh.rank] = occ
    return {"shard_rows": routed, "shard_positions": positions,
            "bucket_fill": fill}


def write_rows(dst: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> None:
    """dst[idx[i]] = values[i] in place, dropping every i with idx[i] out
    of [0, rows): the JAX package's `.at[idx].set(mode="drop")`. Rows that
    repeat must repeat one value. Nothing is read back to the host (a graph
    captures it): a dropped write goes to the first kept write's row with
    that write's value, or rewrites row 0 with itself when none is kept."""
    rows = dst.shape[0]
    keep = (idx >= 0) & (idx < rows)
    # (1,) tensors, not 0-d ones: indexing by a 0-d tensor reads it back
    first = torch.argmax(keep.to(torch.int8)).reshape(1)
    any_kept = keep.any()
    vals = values.to(dst.dtype)
    head = idx.index_select(0, first)
    fill_idx = torch.where(any_kept, head, torch.zeros_like(head))
    fill_val = torch.where(any_kept, vals.index_select(0, first), dst[:1])
    shape = (-1,) + (1,) * (vals.dim() - 1)
    dst[torch.where(keep, idx, fill_idx).long()] = torch.where(
        keep.reshape(shape), vals, fill_val)


def _serve_rows(spec: EmbeddingSpec, state: EmbeddingTableState,
                plan: ExchangePlan, *, train: bool, mesh: Mesh,
                fmt: str = "fp32") -> Tuple[torch.Tensor, ExchangePlan]:
    """The owner's side of a pull: this shard's rows for the received ids,
    as the (S, cap, W) payload in wire format `fmt` (encoded here, at the
    owner's edge). A hash table's training pull inserts unseen ids, adds
    the overflow of all the ranks to its counter, and returns the plan with
    the received ids' slots. With a directory, received migrated ids read
    the annex (the gather kernel) and are masked out of the main table, so
    a hash table never inserts them. A training pull at a narrow format
    with `state.ef` ships q(w + ef) and keeps ef' = (w + ef) - deq(q) at
    the row (annex and invalid slots take no residual; a hash table's
    residual sits at the row's slot, taken from the pull's probe), and the
    plan returned carries the residuals the serve consumed
    (`ExchangePlan.ef_stash`). -> (payload, plan)."""
    S = mesh.size
    flat_recv = plan.recv_ids.reshape(-1)
    flat_valid = plan.recv_valid.reshape(-1)
    need_ef = train and fmt != "fp32" and state.ef is not None
    ef_idx = None
    mig = state.mig
    m_found = None
    main_valid = flat_valid
    if mig is not None:
        m_found, m_rank, _ = _mig_find(mig, flat_recv, flat_valid)
        main_valid = flat_valid & ~m_found
    if spec.use_hash_table:
        probe = torch.where(main_valid, flat_recv,
                            torch.full_like(flat_recv, -1))
        if train:
            state, rows, overflow, slot = hash_lookup_train(state, probe)
            if S > 1:
                # the counter is the table's, replicated: every rank adds
                # the increments of all the ranks
                state.overflow.add_(coll.psum(mesh, overflow) - overflow)
            plan = plan._replace(slot=slot)
            ef_idx = slot  # `capacity` (dropped) where invalid or annex
        else:
            rows = hash_lookup(state, probe)
    else:
        local = torch.where(main_valid, torch.div(flat_recv, S,
                                                  rounding_mode="floor"),
                            torch.full_like(flat_recv, -1))
        rows = lookup_rows(state.weights, local)
        if need_ef:
            ef_idx = torch.where(main_valid, local,
                                 torch.full_like(local, state.ef.shape[0]))
    if m_found is not None:
        M = mig.weights.shape[0]
        arows = lookup_rows(mig.weights, torch.where(
            m_found, m_rank, torch.full_like(m_rank, M)))
        rows = torch.where(m_found[:, None], arows.to(rows.dtype), rows)
    if fmt == "fp32":
        return rows.reshape(S, plan.cap, spec.output_dim), plan
    x = rows.float()
    if need_ef:
        # out-of-range rows gather zeros and drop their write; the
        # receive slots of one id gather the same w + ef and so write the
        # same residual
        ef_prev = lookup_rows(state.ef, ef_idx)
        x = x + ef_prev
        enc = wire_mod.pack_inband(x, fmt)
        write_rows(state.ef, ef_idx,
                   wire_mod.residual(x, enc, spec.output_dim, fmt))
        plan = plan._replace(ef_stash=ef_prev.reshape(S, plan.cap,
                                                      spec.output_dim))
    else:
        enc = wire_mod.pack_inband(x, fmt)
    return enc.reshape(S, plan.cap, -1), plan


def _merge_hot_rows(plan: ExchangePlan, uniq_rows: torch.Tensor,
                    hot: Optional[HotRows]) -> torch.Tensor:
    """Overlay the local cache's rows (the gather kernel, row H a zero
    miss) on the exchange's unique rows, whose hot slots came back
    zero."""
    if hot is None or plan.hot_slot is None:
        return uniq_rows
    H = hot.weights.shape[0]
    hrows = lookup_rows(hot.weights, plan.hot_slot)
    return torch.where((plan.hot_slot < H)[:, None],
                       hrows.to(uniq_rows.dtype), uniq_rows)


def _hot_pull_stats(spec: EmbeddingSpec, plan: ExchangePlan,
                    flat: torch.Tensor, fmt: str) -> Dict[str, torch.Tensor]:
    """`hot_hits` (positions served by the cache), `hot_unique` (rows that
    skipped the wire) and `hot_bytes_saved` (those rows times the bytes
    one row's id, pulled row and pushed grad would have cost)."""
    H = plan.hot_rows
    hm = (plan.hot_slot < H) & (plan.uniq.counts > 0)
    hot_unique = torch.sum(hm).to(torch.int32)
    hot_hits = torch.sum(torch.where(hm, plan.uniq.counts,
                                     torch.zeros_like(plan.uniq.counts))
                         ).to(torch.int32)
    w = wire_mod.wire_dtype(fmt).itemsize
    per_row = (wire_mod.id_wire_itemsize(False, flat.element_size())
               + wire_mod.rows_wire_width(spec.output_dim, fmt) * w
               + wire_mod.grads_wire_width(spec.output_dim, fmt) * w)
    return {"hot_unique": hot_unique, "hot_hits": hot_hits,
            "hot_bytes_saved": hot_unique.to(torch.float32) * float(per_row)}


def _mig_pull_stats(plan: ExchangePlan) -> Dict[str, torch.Tensor]:
    """`mig_unique` (rows the directory routed off their home this step)
    and `mig_hits` (the positions they took)."""
    mm = (plan.mig_moved > 0) & (plan.uniq.counts > 0)
    return {"mig_unique": torch.sum(mm).to(torch.int32),
            "mig_hits": torch.sum(torch.where(
                mm, plan.uniq.counts, torch.zeros_like(plan.uniq.counts))
            ).to(torch.int32)}


def _hot_apply(spec: EmbeddingSpec, optimizer, hot: HotRows,
               plan: ExchangePlan, g: torch.Tensor, mesh: Mesh,
               fmt: str = "fp32") -> None:
    """The hot rows' update, in place on every rank alike: the unique
    slots' grad sums scattered into the (H, dim) aggregate, summed over
    the ranks in rank order (the order the cold owner's source-major
    segment sum folds them in), the counts as an exact int32 sum, then the
    fused apply over rows `arange(H)` with the replicated slots (count-0
    rows stay as they are). `fmt`: bf16 rounds the aggregate to bfloat16
    and the sum once more; int8
    encodes the (Hp, W) aggregate, all_to_all's it so rank r holds every
    rank's rows [r Hp/S, (r+1) Hp/S), decodes and sums them in float32,
    re-encodes the sums and all_gathers them in rank order. Every rank
    decodes the same bits, so the replicas stay equal."""
    S = mesh.size
    H = hot.weights.shape[0]
    dim = spec.output_dim
    hm = plan.hot_slot < H
    tgt = torch.where(hm, plan.hot_slot, torch.full_like(plan.hot_slot, H))
    # slot H is the spare row the cold slots write into, cut off after
    hg = torch.zeros((H + 1, dim), dtype=torch.float32, device=g.device)
    hg[tgt] = g.float()
    hc = torch.zeros(H + 1, dtype=torch.int32, device=g.device)
    hc[tgt] = torch.where(hm, plan.uniq.counts,
                          torch.zeros_like(plan.uniq.counts)).to(torch.int32)
    hg, hc = hg[:H], hc[:H]
    if fmt == "fp32":
        tg = coll.dense_sum(mesh, hg)
    elif fmt == "bf16":
        # summed in float32 and rounded once, as XLA's all-reduce of a
        # bfloat16 buffer (its float normalization widens it)
        tg = coll.dense_sum(mesh, hg.to(torch.bfloat16).float()).to(
            torch.bfloat16).float()
    else:
        Hp = -(-H // S) * S
        hp = torch.nn.functional.pad(hg, (0, 0, 0, Hp - H)) if Hp != H else hg
        enc = wire_mod.pack_inband(hp, "int8")
        W = enc.shape[1]
        parts = coll.all_to_all(mesh, enc.reshape(S, Hp // S, W))
        dec = wire_mod.unpack_inband(parts.reshape(-1, W), dim,
                                     "int8").reshape(S, Hp // S, dim)
        partial = coll.rank_sum(list(dec.unbind(0)))
        full = torch.cat(coll.all_gather(
            mesh, wire_mod.pack_inband(partial, "int8")))
        tg = wire_mod.unpack_inband(full, dim, "int8")[:H]
    tc = coll.psum(mesh, hc)
    rows = torch.arange(H, dtype=torch.int64, device=g.device)
    apply_mod.fused_sparse_apply(optimizer, hot.weights, hot.slots, rows,
                                 tg.contiguous(), tc.contiguous())


def _reassemble(plan: ExchangePlan, rows: torch.Tensor, out_shape, dim: int,
                mesh: Mesh, fmt: str = "fp32",
                hot: Optional[HotRows] = None) -> torch.Tensor:
    """The client's side: rows back over the all_to_all (decoded here),
    unbucketed, the cache's rows overlaid, duplicates expanded. At S == 1
    the served rows are the unique rows."""
    if mesh.size == 1:
        uniq_rows = rows[0]
    else:
        back = coll.all_to_all(mesh, rows)
        if fmt != "fp32":
            back = wire_mod.unpack_inband(
                back.reshape(-1, back.shape[-1]), dim,
                fmt).reshape(back.shape[0], -1, dim)
        uniq_rows = unbucket(back, plan.buckets.owner, plan.buckets.slot)
    uniq_rows = _merge_hot_rows(plan, uniq_rows, hot)
    out = uniq_rows[plan.uniq.inverse]
    return out.reshape(tuple(out_shape) + (dim,))


def _pull_stats(spec, ids, plan, load_stats, mesh,
                fmt: str = "fp32") -> Dict[str, torch.Tensor]:
    dev = ids.device
    stats = {
        # a fill on the device: a host tensor could not be captured
        "pull_indices": torch.full((), ids_positions(spec, ids),
                                   dtype=torch.int32, device=dev),
        "pull_unique": plan.uniq.num_unique.to(torch.int32),
        "pull_overflow": plan.buckets.overflow,
    }
    if plan.hot_slot is not None:
        stats.update(_hot_pull_stats(spec, plan, flatten_ids(spec, ids),
                                     fmt))
    if plan.mig_moved is not None:
        stats.update(_mig_pull_stats(plan))
    if load_stats:
        stats.update(exchange_load_stats(plan, mesh=mesh))
    return stats


def _fmt(mesh: Mesh, wire: Optional[str]) -> str:
    return wire_mod.wire_format(wire) if mesh.size > 1 else "fp32"


def _hot_fmt(fmt: str, hot_wire: Optional[str]) -> str:
    """The hot reduce's format: `hot_wire`, else the table's wire."""
    return wire_mod.wire_format(hot_wire) if hot_wire is not None else fmt


def sharded_lookup_train(spec: EmbeddingSpec, state: EmbeddingTableState,
                         ids: torch.Tensor, *, mesh: Mesh,
                         capacity_factor: float = 0.0,
                         load_stats: bool = True,
                         wire: Optional[str] = "fp32"):
    """Training pull of one table -> (state, rows ids.shape + (dim,), stats,
    plan); the plan goes to `sharded_apply_gradients` for the same batch.
    `wire`: the rows' format (None: `$OETPU_WIRE`, then bf16)."""
    plan = make_plan(spec, ids, mesh=mesh, capacity_factor=capacity_factor,
                     hot=state.hot, mig=state.mig)
    fmt = _fmt(mesh, wire)
    rows, plan = _serve_rows(spec, state, plan, train=True, mesh=mesh,
                             fmt=fmt)
    out = _reassemble(plan, rows, ids.shape, spec.output_dim, mesh, fmt,
                      hot=state.hot)
    if fmt != "fp32":
        out = out.to(spec.dtype)
    return state, out, _pull_stats(spec, ids, plan, load_stats, mesh,
                                   fmt), plan


def sharded_lookup(spec: EmbeddingSpec, state: EmbeddingTableState,
                   ids: torch.Tensor, *, mesh: Mesh,
                   capacity_factor: float = 0.0) -> torch.Tensor:
    """Read-only pull (eval, serving): inserts nothing; absent hash ids
    pull zeros; hot rows read the cache, migrated rows the annex. fp32
    wire."""
    plan = make_plan(spec, ids, mesh=mesh, capacity_factor=capacity_factor,
                     hot=state.hot, mig=state.mig)
    rows, plan = _serve_rows(spec, state, plan, train=False, mesh=mesh)
    return _reassemble(plan, rows, ids.shape, spec.output_dim, mesh,
                       hot=state.hot)


def _client_grads(spec, plan, grads):
    """The client's duplicate sums into the unique slots and the exact
    counts of the valid ones (0 elsewhere)."""
    g = plan.uniq.segment_reduce(grads.reshape(-1, spec.output_dim))
    valid = (plan.uniq.counts > 0) & _id_valid(spec, plan.uniq.unique_ids)
    counts = torch.where(valid, plan.uniq.counts,
                         torch.zeros_like(plan.uniq.counts))
    return g, counts.to(torch.int32)


def sharded_apply_gradients(spec: EmbeddingSpec, state: EmbeddingTableState,
                            optimizer, ids: torch.Tensor,
                            grads: torch.Tensor, *, mesh: Mesh,
                            capacity_factor: float = 0.0,
                            plan: Optional[ExchangePlan] = None,
                            wire: Optional[str] = "fp32",
                            hot_wire: Optional[str] = None):
    """Push and fused update of one table, in place -> (state, stats).
    Pass the pull's `plan` to skip a second dedup and id exchange. int8
    grads round stochastically; `hot_wire`: the hot reduce's format
    (None: `wire`'s)."""
    S = mesh.size
    fmt = _fmt(mesh, wire)
    if plan is None:
        plan = make_plan(spec, ids, mesh=mesh,
                         capacity_factor=capacity_factor, hot=state.hot,
                         mig=state.mig)
    g, counts = _client_grads(spec, plan, grads)
    if plan.hot_slot is not None and state.hot is not None:
        _hot_apply(spec, optimizer, state.hot, plan, g, mesh,
                   _hot_fmt(fmt, hot_wire))
    if S == 1:
        # identity routing: the unique slots are the owner's receive buffer
        rids, rg, rc = plan.uniq.unique_ids, g, counts
    elif fmt == "fp32":
        # the counts' int32 bits ride as extra lanes of the grad payload
        # (one float32 lane, two bfloat16 ones): the push is one all_to_all
        lanes = counts.contiguous().view(g.dtype).reshape(counts.shape[0], -1)
        payload = torch.cat([g, lanes], dim=1)
        recv = coll.all_to_all(mesh, _scatter_buckets(payload, plan.buckets,
                                                      S, plan.cap))
        flat = recv.reshape(-1, payload.shape[1])
        rids = plan.recv_ids.reshape(-1)
        rg = flat[:, :spec.output_dim]
        rc = flat[:, spec.output_dim:].contiguous().view(
            torch.int32).reshape(-1)
    else:
        payload = wire_mod.encode_grads(g, counts, fmt,
                                        stochastic=fmt == "int8")
        recv = coll.all_to_all(mesh, _scatter_buckets(payload, plan.buckets,
                                                      S, plan.cap))
        rids = plan.recv_ids.reshape(-1)
        rg32, rc = wire_mod.decode_grads(recv.reshape(-1, recv.shape[-1]),
                                         spec.output_dim, fmt)
        rg = rg32.to(g.dtype)
    _apply_unique(spec, state, optimizer, rids, rg, rc, S, plan.slot)
    return state, {"push_overflow": plan.buckets.overflow}


def _scatter_buckets(payload: torch.Tensor, buckets: BucketResult, S: int,
                     cap: int) -> torch.Tensor:
    """Per-unique-slot payload rows (n, W) into their (owner, slot) bucket
    positions -> (S, cap, W), zeros in empty slots; slots not bucketed
    (invalid, hot, overflowed) go to one spare row that is cut off."""
    width = payload.shape[1]
    ok = (buckets.owner < S) & (buckets.slot < cap)
    flat_pos = torch.where(ok, buckets.owner * cap + buckets.slot,
                           torch.full_like(buckets.slot, S * cap))
    out = torch.zeros((S * cap + 1, width), dtype=payload.dtype,
                      device=payload.device)
    out[flat_pos] = payload
    return out[:-1].reshape(S, cap, width)


def _apply_unique(spec: EmbeddingSpec, state: EmbeddingTableState,
                  optimizer, rids: torch.Tensor, rg: torch.Tensor,
                  rc: torch.Tensor, S: int,
                  slot: Optional[torch.Tensor] = None) -> None:
    """The owner's tail of a push, in place: the received flat ids, grads
    and exact counts (0 = empty or invalid slot) deduplicated across the
    sources (the receive buffer is source-major, so each row sums its
    sources in rank order) and applied once per unique row by the fused
    apply. Received migrated ids apply to the annex the same way and drop
    out of the main table's apply. A hash table applies at `slot` (its
    pull's slots of these receive positions), or probes for them without
    it."""
    mig = state.mig
    if mig is not None:
        m_found, m_rank, _ = _mig_find(mig, rids, rc > 0)
        M = mig.weights.shape[0]
        sparse_apply_dense_table(
            optimizer, mig.weights, mig.slots,
            torch.where(m_found, m_rank, torch.full_like(m_rank, M)), rg,
            pre_counts=torch.where(m_found, rc, torch.zeros_like(rc)),
            dead_apart=True)
        rc = torch.where(m_found, torch.zeros_like(rc), rc)
    live = rc > 0
    zero = torch.zeros_like(rc)
    if spec.use_hash_table:
        capacity = state.keys.shape[0]
        if slot is None:
            slot = hash_find(state.keys, torch.where(
                live, rids, torch.full_like(rids, -1)))
        slot = torch.where(live, slot, torch.full_like(slot, capacity))
        counts = torch.where(slot < capacity, rc, zero)
        rows = torch.clamp(slot, 0, capacity)
    else:
        rows = torch.where(live, torch.div(rids, S, rounding_mode="floor"),
                           torch.full_like(rids, state.weights.shape[0]))
        counts = rc
    # mostly padding: each padding slot its own segment (`dead_apart`)
    sparse_apply_dense_table(optimizer, state.weights, state.slots, rows,
                             rg, pre_counts=counts, dead_apart=True)


def split_wire_groups(groups, fmt_for):
    """Split dim-groups by each table's wire format: tables sharing (dim,
    format) stay on one exchange, in first-appearance order."""
    out = []
    for g in groups:
        by_fmt: Dict[str, list] = {}
        for n in g:
            by_fmt.setdefault(fmt_for(n), []).append(n)
        out.extend(by_fmt.values())
    return out


def _check_dims(specs) -> int:
    dim = specs[0].output_dim
    for spec in specs:
        if spec.output_dim != dim:
            raise ValueError(
                f"grouped exchange needs one embedding dim per group: "
                f"{spec.name!r} has dim {spec.output_dim}, group has {dim}")
    return dim


def grouped_lookup_train(specs, states, ids_list, *, mesh: Mesh,
                         capacity_factor: float = 0.0,
                         wire: Optional[str] = None,
                         load_stats: bool = True):
    """Training pull of one dim-group with one id and one row all_to_all ->
    (states, rows list, stats list, plans), lists in the input order; the
    plans go to `grouped_apply_gradients` for the same batch. Each table
    encodes at its owner's edge with its own residuals; the encoded widths
    are one across the group, so one all_to_all carries them all."""
    if mesh.size > 1:
        # the pipelined loop's two halves, back to back
        states, plans, uniq_rows, stats_list = grouped_prefetch(
            specs, states, ids_list, mesh=mesh,
            capacity_factor=capacity_factor, wire=wire,
            load_stats=load_stats)
        return states, grouped_finalize_pull(
            specs, states, ids_list, plans, uniq_rows), stats_list, plans
    _check_dims(specs)
    plans = grouped_make_plans(specs, ids_list, mesh=mesh,
                               capacity_factor=capacity_factor,
                               hots=[state.hot for state in states],
                               migs=[state.mig for state in states])
    outs = []
    for i, (spec, state, ids) in enumerate(zip(specs, states, ids_list)):
        rows, plans[i] = _serve_rows(spec, state, plans[i], train=True,
                                     mesh=mesh)
        outs.append(_reassemble(plans[i], rows, ids.shape, spec.output_dim,
                                mesh))
    stats_list = [_pull_stats(spec, ids, plan, load_stats, mesh)
                  for spec, ids, plan in zip(specs, ids_list, plans)]
    return states, outs, stats_list, plans


def grouped_apply_gradients(specs, states, optimizers, ids_list, grads_list,
                            *, mesh: Mesh, capacity_factor: float = 0.0,
                            plans=None, wire: Optional[str] = None,
                            hot_wire: Optional[str] = None):
    """Push and fused update of one dim-group, in place: ONE all_to_all
    carries every table's grads and counts (int8 grads rounded
    stochastically); the hot rows reduce apart (`hot_wire`: their format,
    None: `wire`'s) -> (states, stats list)."""
    S = mesh.size
    dim = _check_dims(specs)
    fmt = _fmt(mesh, wire)
    if plans is None:
        plans = grouped_make_plans(
            specs, ids_list, mesh=mesh, capacity_factor=capacity_factor,
            hots=[state.hot for state in states],
            migs=[state.mig for state in states])
    client = [_client_grads(spec, plan, grads)
              for spec, plan, grads in zip(specs, plans, grads_list)]
    for spec, state, opt, plan, (g, _) in zip(specs, states, optimizers,
                                              plans, client):
        if plan.hot_slot is not None and state.hot is not None:
            _hot_apply(spec, opt, state.hot, plan, g, mesh,
                       _hot_fmt(fmt, hot_wire))
    stats_list = [{"push_overflow": plan.buckets.overflow} for plan in plans]
    if S == 1:
        for spec, state, opt, plan, (g, rc) in zip(specs, states, optimizers,
                                                   plans, client):
            _apply_unique(spec, state, opt, plan.uniq.unique_ids, g, rc, S,
                          plan.slot)
        return states, stats_list
    payloads = [_scatter_buckets(
        wire_mod.encode_grads(g, rc, fmt, stochastic=fmt == "int8"),
        plan.buckets, S, plan.cap)
                for plan, (g, rc) in zip(plans, client)]
    recv = coll.all_to_all(mesh, torch.cat(payloads, dim=1))
    width = recv.shape[-1]
    off = 0
    for spec, state, opt, plan, (g, _) in zip(specs, states, optimizers,
                                              plans, client):
        seg = recv[:, off:off + plan.cap].reshape(-1, width)
        off += plan.cap
        rg32, rc = wire_mod.decode_grads(seg, dim, fmt)
        _apply_unique(spec, state, opt, plan.recv_ids.reshape(-1),
                      rg32.to(g.dtype), rc, S, plan.slot)
    return states, stats_list


# ---------------------------------------------------------------------------
# The split exchange of the pipelined loop (`MeshTrainer(pipeline_steps=
# True)`): `grouped_prefetch` runs batch t+1's id plan and a speculative row
# pull before batch t's apply (it reads nothing batch t's gradients make),
# `grouped_conflict_patch` re-gathers after that apply only the rows it
# could have changed, and `grouped_finalize_pull` runs the client's tail at
# consume time. At the fp32 wire the patched rows are a serial pull's, bit
# for bit; at a narrow wire the patch re-encodes them with the serve's codec
# and, where the table carries residuals, replays the serve's error feedback
# from the residuals the prefetch consumed (`ExchangePlan.ef_stash`), so
# rows and residuals are the serial schedule's too.
# ---------------------------------------------------------------------------


def conflict_patch_cap(cap: int, conflict_factor: float) -> int:
    """The conflict patch's slots per (source, owner) pair: `cap` (exact)
    for `conflict_factor <= 0`, else ceil(factor * cap) within [1, cap];
    the members past it keep their one-step-stale prefetched rows (counted
    in `conflict_overflow`)."""
    if conflict_factor <= 0:
        return cap
    return max(1, min(cap, int(-(-conflict_factor * cap // 1))))


def grouped_prefetch(specs, states, ids_list, *, mesh: Mesh,
                     capacity_factor: float = 0.0,
                     wire: Optional[str] = None, load_stats: bool = True):
    """The id plan and a speculative row pull of one dim-group's training
    pull, without the client's tail (`grouped_finalize_pull`): the plans,
    the owner's serve (hash inserts in the serial order, residuals written
    and stashed on the plan) and one all_to_all of the group's rows,
    decoded per unique slot. It reads the tables as they stand, so the rows
    differ from a pull made after the previous batch's apply only where
    that apply wrote, the set `grouped_conflict_patch` re-gathers; hot
    slots stay zero until the finalize's overlay. -> (states, plans,
    unique rows (n, dim) float32 a table, stats a table, as
    `grouped_lookup_train`'s)."""
    S = mesh.size
    if S == 1:
        raise ValueError(
            "grouped_prefetch needs S >= 2: the pipelined loop has nothing "
            "to overlap on a 1-device mesh (MeshTrainer runs the serial "
            "train_many there)")
    dim = _check_dims(specs)
    plans = grouped_make_plans(specs, ids_list, mesh=mesh,
                               capacity_factor=capacity_factor,
                               hots=[state.hot for state in states],
                               migs=[state.mig for state in states])
    fmt = _fmt(mesh, wire)
    rows_list = []
    for i, (spec, state) in enumerate(zip(specs, states)):
        rows, plans[i] = _serve_rows(spec, state, plans[i], train=True,
                                     mesh=mesh, fmt=fmt)
        rows_list.append(rows)
    back = coll.all_to_all(mesh, torch.cat(rows_list, dim=1))
    dec = wire_mod.unpack_inband(back.reshape(-1, back.shape[-1]), dim,
                                 fmt).reshape(S, -1, dim)
    uniq_rows, off = [], 0
    for plan in plans:
        uniq_rows.append(unbucket(dec[:, off:off + plan.cap],
                                  plan.buckets.owner, plan.buckets.slot))
        off += plan.cap
    stats_list = [_pull_stats(spec, ids, plan, load_stats, mesh, fmt)
                  for spec, ids, plan in zip(specs, ids_list, plans)]
    return states, plans, uniq_rows, stats_list


def grouped_finalize_pull(specs, states, ids_list, plans, uniq_rows_list):
    """The client's tail of a prefetched pull, at consume time: the hot
    cache's rows overlaid as the previous apply left them (hot rows never
    ride the buckets, so this keeps them exact), duplicates expanded. Local
    work, no collective. -> rows of each ids' shape + (dim,), in each
    table's dtype."""
    outs = []
    for spec, state, ids, plan, uniq_rows in zip(specs, states, ids_list,
                                                 plans, uniq_rows_list):
        ur = _merge_hot_rows(plan, uniq_rows, state.hot)
        outs.append(ur[plan.uniq.inverse].to(spec.dtype).reshape(
            tuple(ids.shape) + (spec.output_dim,)))
    return outs


def _gather_rows_readonly(spec: EmbeddingSpec, state: EmbeddingTableState,
                          flat_recv: torch.Tensor, flat_valid: torch.Tensor,
                          S: int):
    """The owner's rows for received ids, read only: no hash insert (the
    prefetch inserted every id the patch asks for), no residual written.
    Received migrated ids read the annex, as in `_serve_rows`; both reads
    are the gather kernel. -> (rows (n, dim) in the table's dtype, each
    row's index into `state.ef`: the index `_serve_rows` writes, out of
    range for invalid and annex rows)."""
    mig = state.mig
    m_found = None
    main_valid = flat_valid
    if mig is not None:
        m_found, m_rank, _ = _mig_find(mig, flat_recv, flat_valid)
        main_valid = flat_valid & ~m_found
    if spec.use_hash_table:
        capacity = state.keys.shape[0]
        slot = hash_find(state.keys, torch.where(
            main_valid, flat_recv, torch.full_like(flat_recv, -1)))
        idx = torch.where((slot < capacity) & main_valid, slot,
                          torch.full_like(slot, capacity))
        rows = lookup_rows(state.weights, idx)
        ef_idx = idx
    else:
        local = torch.where(main_valid, torch.div(flat_recv, S,
                                                  rounding_mode="floor"),
                            torch.full_like(flat_recv, -1))
        rows = lookup_rows(state.weights, local)
        n_ef = (state.ef if state.ef is not None
                else state.weights).shape[0]
        ef_idx = torch.where(main_valid, local, torch.full_like(local, n_ef))
    if m_found is not None:
        M = mig.weights.shape[0]
        arows = lookup_rows(mig.weights, torch.where(
            m_found, m_rank, torch.full_like(m_rank, M)))
        rows = torch.where(m_found[:, None], arows.to(rows.dtype), rows)
    return rows, ef_idx


def grouped_conflict_patch(specs, states, prev_plans, plans, uniq_rows_list,
                           *, mesh: Mesh, conflict_factor: float = 0.0,
                           wire: Optional[str] = None):
    """Repair one dim-group's prefetched rows after the previous batch's
    apply. Every row that apply wrote on this shard is a valid received id
    of the previous plan, so the conflict set is the previous plan's valid
    received ids met with the new plan's (`ops/dedup.member_mask`, one sort
    a table). The owner compacts them to `conflict_patch_cap` slots per
    source, re-gathers them from the applied tables
    (`_gather_rows_readonly`) and ONE all_to_all a group ships each row
    with its bucket slot + 1 in the count lanes (the push codec; 0 is
    empty); the client writes them over its prefetched unique rows. With
    residuals (a narrow wire) the owner replays the serve: x' = w + the
    stashed residual, ships q(x') and writes ef' = x' - deq(q(x')) at the
    slots the prefetch's serve wrote. -> (patched unique rows a table,
    stats a table: `conflict_rows`, the patched rows this source sends,
    and `conflict_overflow`, the members past the cap)."""
    S = mesh.size
    dim = _check_dims(specs)
    fmt = _fmt(mesh, wire)
    payloads, metas = [], []
    for spec, state, pplan, plan in zip(specs, states, prev_plans, plans):
        cap = plan.cap
        pcap = conflict_patch_cap(cap, conflict_factor)
        member = member_mask(pplan.recv_ids.reshape(-1),
                             pplan.recv_valid.reshape(-1),
                             plan.recv_ids.reshape(-1),
                             plan.recv_valid.reshape(-1)).reshape(S, cap)
        slots, oflow = compact_member_slots(member, pcap)
        cl = torch.clamp(slots, 0, cap - 1)
        flat_ids = torch.gather(plan.recv_ids, 1, cl).reshape(-1)
        live = (slots >= 0).reshape(-1)
        rows, ef_idx = _gather_rows_readonly(spec, state, flat_ids, live, S)
        counts = (slots + 1).reshape(-1).to(torch.int32)
        if plan.ef_stash is not None:  # the serve ran error feedback
            stash = torch.gather(plan.ef_stash, 1, cl[..., None].expand(
                S, pcap, dim)).reshape(-1, dim)
            x = rows.float() + torch.where(live[:, None], stash,
                                           torch.zeros_like(stash))
            enc = wire_mod.pack_inband(x, fmt)
            write_rows(state.ef, ef_idx,
                       wire_mod.residual(x, enc, dim, fmt))
            payload = torch.cat([enc, wire_mod.counts_to_lanes(counts, fmt)],
                                dim=1)
        else:
            payload = wire_mod.encode_grads(rows.float(), counts, fmt)
        payloads.append(payload.reshape(S, pcap, -1))
        metas.append((pcap, member, oflow))
    recv = coll.all_to_all(mesh, torch.cat(payloads, dim=1))
    width = recv.shape[-1]
    patched, stats_list, off = [], [], 0
    for plan, uniq_rows, (pcap, member, oflow) in zip(plans, uniq_rows_list,
                                                      metas):
        prow, pc = wire_mod.decode_grads(
            recv[:, off:off + pcap].reshape(-1, width), dim, fmt)
        off += pcap
        cap = plan.cap
        live = pc > 0
        src = torch.arange(S, dtype=torch.int64,
                           device=pc.device).repeat_interleave(pcap)
        flat_pos = torch.where(
            live, src * cap + torch.clamp(pc.long() - 1, 0, cap - 1),
            torch.full_like(src, S * cap))
        # one spare row past the buckets takes the empty slots' writes
        stage = torch.zeros((S * cap + 1, dim), dtype=torch.float32,
                            device=pc.device)
        stage[flat_pos] = prow
        smask = torch.zeros(S * cap + 1, dtype=torch.bool, device=pc.device)
        smask[flat_pos] = live
        patch_u = unbucket(stage[:-1].reshape(S, cap, dim),
                           plan.buckets.owner, plan.buckets.slot)
        mask_u = unbucket(smask[:-1].reshape(S, cap), plan.buckets.owner,
                          plan.buckets.slot)
        patched.append(torch.where(mask_u[:, None],
                                   patch_u.to(uniq_rows.dtype), uniq_rows))
        stats_list.append({
            "conflict_rows": torch.sum(member).to(torch.int32) - oflow,
            "conflict_overflow": oflow})
    return patched, stats_list


# ---------------------------------------------------------------------------
# The placement lifecycle, between steps: the host builds an identity (the
# probe table of a hot set or a directory), the ranks fill the cache or the
# annex from the owner shards and write them back. Only bits move: one
# all_gather and a select by owner, no float sum. An existing cache or annex
# takes the new contents in place, so the state keeps its tensors.
# ---------------------------------------------------------------------------


def _probe_keys(spec: EmbeddingSpec, C: int) -> np.ndarray:
    """An empty probe table: int32 keys for an array table (its ids are
    below 2^31), the table's int64 keys for a hash table."""
    return np.full((C,), -1, np.int64 if spec.use_hash_table else np.int32)


def _place(keys: np.ndarray, rank: np.ndarray, cand: np.ndarray
           ) -> np.ndarray:
    """Insert the candidates (unique, best first) into the probe table
    with the device probe's budget; each placed one's slot gets its rank.
    -> the mask of the candidates placed."""
    ins = cand if keys.dtype.itemsize >= 8 else cand.astype(np.int32)
    pos = np_hash_insert(keys, ins, 1, num_probes=HOT_NUM_PROBES)
    placed = pos >= 0
    rank[pos[placed]] = np.arange(int(placed.sum()), dtype=np.int32)
    return placed


def _first_kept(cand: np.ndarray) -> np.ndarray:
    """The index of each distinct candidate's first (best) place, in
    order."""
    _, first = np.unique(cand, return_index=True)
    return np.sort(first)


def build_hot_identity(spec: EmbeddingSpec, hot_rows: int,
                       ids64=None) -> dict:
    """The host-side identity of a hot set (the JAX package's): `keys` (C =
    max(2H, 8) probe slots), `rank` (C,) int32 (H = empty) and `ids` (H,)
    the hot ids by rank (-1 padding), in `_probe_keys`' dtype. `ids64`:
    candidates hottest first (None: an empty set); negative and, for an
    array table, out-of-vocabulary ids drop, a repeated id keeps its first
    rank, and no more than H are taken."""
    H = int(hot_rows)
    C = max(2 * H, 8)
    keys = _probe_keys(spec, C)
    rank = np.full((C,), H, np.int32)
    ids_arr = np.full((H,), -1, keys.dtype)
    cand = np.asarray([] if ids64 is None else ids64, np.int64).reshape(-1)
    cand = cand[cand >= 0]
    if not spec.use_hash_table:
        cand = cand[cand < spec.input_dim]
    cand = cand[_first_kept(cand)][:H]
    if cand.size:
        kept = cand[_place(keys, rank, cand)]
        ids_arr[:kept.size] = kept.astype(keys.dtype)
    return {"keys": keys, "rank": rank, "ids": ids_arr}


def build_mig_identity(spec: EmbeddingSpec, mig_rows: int, ids64=None,
                       owners=None, *, num_shards: int) -> dict:
    """The host-side identity of a migration directory (the JAX
    package's): `keys`, `rank` and `ids` as in `build_hot_identity` and
    `owners` (M,) int32 (-1 padding). `ids64` / `owners`: the moves,
    heaviest first; a move to a shard outside [0, num_shards) drops like an
    invalid id."""
    M = int(mig_rows)
    C = max(2 * M, 8)
    keys = _probe_keys(spec, C)
    rank = np.full((C,), M, np.int32)
    own_arr = np.full((M,), -1, np.int32)
    ids_arr = np.full((M,), -1, keys.dtype)
    cand = np.asarray([] if ids64 is None else ids64, np.int64).reshape(-1)
    cown = np.asarray([] if owners is None else owners,
                      np.int64).reshape(-1)[:cand.size]
    keep = (cand >= 0) & (cown >= 0) & (cown < num_shards)
    if not spec.use_hash_table:
        keep &= cand < spec.input_dim
    cand, cown = cand[keep], cown[keep]
    sel = _first_kept(cand)[:M]
    cand, cown = cand[sel], cown[sel]
    if cand.size:
        placed = _place(keys, rank, cand)
        kept, kown = cand[placed], cown[placed]
        own_arr[:kept.size] = kown.astype(np.int32)
        ids_arr[:kept.size] = kept.astype(keys.dtype)
    return {"keys": keys, "rank": rank, "ids": ids_arr, "owners": own_arr}


def _hot_owner_route(spec: EmbeddingSpec, state: EmbeddingTableState,
                     ids: torch.Tensor, mesh: Mesh, insert: bool):
    """Each listed id's row on this shard and owner: -> (src, owner), `src`
    out of range for ids this shard does not own (gathers give zeros,
    writes drop). A hash table may insert the absent ids it owns (a
    promotion leaves a row for the write-back to land on); the overflow
    counter then grows by the sum over the ranks."""
    S = mesh.size
    ids = ids.long()
    owner = torch.where(ids >= 0, torch.remainder(ids, S),
                        torch.zeros_like(ids))
    if spec.use_hash_table:
        mine, probe = shard_probe(ids, mesh.rank, S)
        if insert:
            slot, oflow = hash_find_or_insert(state.keys, probe)
            state.overflow.add_(coll.psum(mesh, oflow))
        else:
            slot = hash_find(state.keys, probe)
        capacity = state.keys.shape[0]
        src = torch.where(mine & (slot < capacity), slot,
                          torch.full_like(slot, capacity))
        return src, owner
    valid = (ids >= 0) & (ids < spec.input_dim)
    mine = valid & (owner == mesh.rank)
    src = torch.where(mine, torch.div(ids, S, rounding_mode="floor"),
                      torch.full_like(ids, state.weights.shape[0]))
    return src, torch.where(valid, owner, torch.zeros_like(owner))


def _write_back(state: EmbeddingTableState, src: torch.Tensor,
                weights: torch.Tensor, slots: Dict[str, torch.Tensor]):
    write_rows(state.weights, src, weights)
    for k in state.slots:
        write_rows(state.slots[k], src, slots[k])


def _owner_select(spec: EmbeddingSpec, state: EmbeddingTableState,
                  src: torch.Tensor, owner: torch.Tensor, mesh: Mesh):
    """Every rank's copy of the listed rows: each shard gathers the rows it
    owns (zeros elsewhere), one all_gather, and each id takes its owner's
    copy -> (weights float32, {slot: float32})."""
    names = sorted(state.slots)
    cols = [lookup_rows(state.weights, src).float()] + [
        lookup_rows(state.slots[k], src).float() for k in names]
    return _split_cols(_select(mesh, cols, owner), names, cols)


def _select(mesh: Mesh, cols, owner: torch.Tensor) -> torch.Tensor:
    parts = torch.stack(coll.all_gather(mesh, torch.cat(cols, dim=1)))
    n = owner.shape[0]
    return parts[torch.clamp(owner, 0, mesh.size - 1),
                 torch.arange(n, device=owner.device)]


def _split_cols(sel: torch.Tensor, names, cols):
    widths = [c.shape[1] for c in cols]
    out, off = {}, widths[0]
    for k, w in zip(names, widths[1:]):
        out[k] = sel[:, off:off + w]
        off += w
    return sel[:, :widths[0]], out


def identity_tensors(identity: dict, device) -> dict:
    """An identity's host arrays as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in identity.items()}


def hot_writeback(spec: EmbeddingSpec, state: EmbeddingTableState, *,
                  mesh: Mesh) -> EmbeddingTableState:
    """The cache's rows (weights and slots) written into their owner
    shards, in place; no collective (every rank holds every hot row, each
    shard writes the rows it owns; a hash shard inserts an absent one).
    After it the shards equal what a run without the cache holds. The
    cache stays as it is."""
    hot = state.hot
    if hot is None:
        return state
    src, _ = _hot_owner_route(spec, state, hot.ids, mesh,
                              insert=spec.use_hash_table)
    _write_back(state, src, hot.weights, hot.slots)
    return state


def hot_gather(spec: EmbeddingSpec, state: EmbeddingTableState,
               identity: dict, *, mesh: Mesh) -> EmbeddingTableState:
    """The cache for `identity`'s hot set, filled from the owner shards by
    one all_gather and a select by owner (a hash shard inserts an absent
    hot id: it starts from its initializer row, as its first pull would).
    An existing cache takes the identity and the rows in place; a state
    without one gets a new cache. Padding ranks hold zero rows."""
    idn = identity_tensors(identity, state.weights.device)
    src, owner = _hot_owner_route(spec, state, idn["ids"], mesh, insert=True)
    w, slots = _owner_select(spec, state, src, owner, mesh)
    if state.hot is None:
        state.hot = HotRows(
            keys=idn["keys"], rank=idn["rank"], ids=idn["ids"],
            weights=w.to(state.weights.dtype).contiguous(),
            slots={k: v.to(state.slots[k].dtype).contiguous()
                   for k, v in slots.items()})
        return state
    hot = state.hot
    for name in ("keys", "rank", "ids"):
        getattr(hot, name).copy_(idn[name])
    hot.weights.copy_(w)
    for k, v in slots.items():
        hot.slots[k].copy_(v)
    return state


def _mig_live(mig: MigRows, mesh: Mesh):
    """Each migrated row's live copy, its assigned owner's annex row, by
    one all_gather -> (weights float32, {slot: float32})."""
    names = sorted(mig.slots)
    cols = [mig.weights.float()] + [mig.slots[k].float() for k in names]
    return _split_cols(_select(mesh, cols, mig.owners.long()), names, cols)


def mig_writeback(spec: EmbeddingSpec, state: EmbeddingTableState, *,
                  mesh: Mesh) -> EmbeddingTableState:
    """The migrated rows' live copies written back into their home shards,
    in place (a hash home inserts an absent id). After it the main tables
    equal an unmigrated run's. The directory and annex stay as they are."""
    mig = state.mig
    if mig is None:
        return state
    w, slots = _mig_live(mig, mesh)
    src, _ = _hot_owner_route(spec, state, mig.ids, mesh,
                              insert=spec.use_hash_table)
    _write_back(state, src, w, slots)
    return state


def mig_gather(spec: EmbeddingSpec, state: EmbeddingTableState,
               identity: dict, *, mesh: Mesh) -> EmbeddingTableState:
    """Install `identity`'s directory and fill every rank's annex from the
    home shards (one all_gather and a select by home; a hash home inserts
    an absent id). Write the old directory back first (`mig_writeback`) or
    its updates are lost. An existing directory and annex take the new
    contents in place."""
    idn = identity_tensors(identity, state.weights.device)
    src, home = _hot_owner_route(spec, state, idn["ids"], mesh, insert=True)
    w, slots = _owner_select(spec, state, src, home, mesh)
    if state.mig is None:
        state.mig = MigRows(
            keys=idn["keys"], rank=idn["rank"], ids=idn["ids"],
            owners=idn["owners"],
            weights=w.to(state.weights.dtype).contiguous(),
            slots={k: v.to(state.slots[k].dtype).contiguous()
                   for k, v in slots.items()})
        return state
    mig = state.mig
    for name in ("keys", "rank", "ids", "owners"):
        getattr(mig, name).copy_(idn[name])
    mig.weights.copy_(w)
    for k, v in slots.items():
        mig.slots[k].copy_(v)
    return state


# ---------------------------------------------------------------------------
# Layout converters. Shard-major storage: global row (shard * rps + local)
# holds id (local * S + shard). Checkpoints are written in id order, so any
# mesh size can reshard by a relayout.
# ---------------------------------------------------------------------------


def deinterleave_rows(global_rows, num_shards: int, vocab: int):
    """(S*rps, dim) shard-major -> (vocab, dim) id-major; numpy or torch."""
    rps = global_rows.shape[0] // num_shards
    per_shard = global_rows.reshape(num_shards, rps, -1)
    if isinstance(per_shard, torch.Tensor):
        id_major = per_shard.transpose(0, 1).reshape(num_shards * rps, -1)
    else:
        id_major = per_shard.transpose(1, 0, 2).reshape(num_shards * rps, -1)
    return id_major[:vocab]


def interleave_rows(id_major, num_shards: int):
    """(vocab, dim) id-major -> (S*rps, dim) shard-major, zero-padded;
    numpy or torch."""
    vocab, dim = id_major.shape
    rps = -(-vocab // num_shards)
    if isinstance(id_major, torch.Tensor):
        padded = torch.zeros((rps * num_shards, dim), dtype=id_major.dtype,
                             device=id_major.device)
        padded[:vocab] = id_major
        return padded.reshape(rps, num_shards, dim).transpose(0, 1).reshape(
            num_shards * rps, dim)
    import numpy as np
    padded = np.zeros((rps * num_shards, dim), id_major.dtype)
    padded[:vocab] = id_major
    return padded.reshape(rps, num_shards, dim).transpose(1, 0, 2).reshape(
        num_shards * rps, dim)
