"""Sharded pull and push: the reference's parameter-server wire protocol as
collectives between the mesh's ranks (port of
`openembedding_tpu/parallel/sharded.py`, without hot rows, migration, the
pipelined prefetch and the int8 wire, which ROADMAP.md item 3 lists).

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
wire format (`ops/wire.py`: fp32, or bf16 encoded at the sending edge).
`S == 1` routes by identity: no collective, no bucket scatter, fp32.

Static capacity: each (source, owner) bucket holds `cap` ids;
`capacity_factor` f sizes it to ceil(f * n / S) (f = 0: cap = n, never
drops). An id past a full bucket pulls zeros and drops its gradient, and
is counted in `pull_overflow` / `push_overflow`. Out-of-vocabulary ids of
an array table pull zeros and train nothing, as on one device.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..embedding import EmbeddingSpec, EmbeddingTableState
from ..ops import wire as wire_mod
from ..ops.dedup import (BucketResult, UniqueResult, bucket_validity,
                         concat_owner_buckets, split_owner_buckets, unbucket,
                         unique_and_route, unique_with_counts)
from ..ops.sparse import lookup_rows, sparse_apply_dense_table
from ..tables.hash_table import hash_lookup, hash_lookup_train
from . import collectives as coll
from .mesh import Mesh


class ExchangePlan(NamedTuple):
    """The routing a pull and its push share: the client's dedup and
    buckets, the ids this rank serves and the capacity; `slot`, for a hash
    table after a training pull, the slot of each received id (`capacity`
    where it is invalid or overflowed), which the push applies at."""

    uniq: UniqueResult
    buckets: BucketResult
    recv_ids: torch.Tensor    # (S, cap) ids this rank serves
    recv_valid: torch.Tensor  # (S, cap)
    cap: int
    slot: Optional[torch.Tensor] = None


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


def _client_route(spec: EmbeddingSpec, flat: torch.Tensor, S: int,
                  capacity_factor: float):
    """The client's dedup and owner routing: a plan without its id
    exchange -> (uniq, buckets, cap)."""
    cap = _bucket_capacity(flat.shape[0], S, capacity_factor)
    uniq, buckets = unique_and_route(flat, _id_valid(spec, flat), S, cap)
    return uniq, buckets, cap


def make_plan(spec: EmbeddingSpec, ids: torch.Tensor, *, mesh: Mesh,
              capacity_factor: float = 0.0) -> ExchangePlan:
    """Dedup the rank's ids, bucket them by owner and exchange the buckets
    (one all_to_all); `S == 1` is the identity plan."""
    flat = flatten_ids(spec, ids)
    if mesh.size == 1:
        return _identity_plan(spec, flat)
    uniq, buckets, cap = _client_route(spec, flat, mesh.size,
                                       capacity_factor)
    recv_ids = coll.all_to_all(mesh, buckets.bucket_ids)
    return ExchangePlan(uniq, buckets, recv_ids, bucket_validity(recv_ids),
                        cap)


def grouped_make_plans(specs, ids_list, *, mesh: Mesh,
                       capacity_factor: float = 0.0) -> List[ExchangePlan]:
    """Plans for a dim-group of tables with ONE id all_to_all: each table
    routes as in `make_plan`, and its (S, cap_t) buckets ride as a fixed
    segment of one concatenated buffer."""
    if mesh.size == 1:
        return [make_plan(spec, ids, mesh=mesh,
                          capacity_factor=capacity_factor)
                for spec, ids in zip(specs, ids_list)]
    parts = [_client_route(spec, flatten_ids(spec, ids), mesh.size,
                           capacity_factor)
             for spec, ids in zip(specs, ids_list)]
    wire_ids = concat_owner_buckets([b.bucket_ids for _, b, _ in parts])
    recv = coll.all_to_all(mesh, wire_ids)
    segs = split_owner_buckets(recv, [(cap, b.bucket_ids.dtype)
                                      for _, b, cap in parts])
    return [ExchangePlan(uniq, buckets, seg, bucket_validity(seg), cap)
            for (uniq, buckets, cap), seg in zip(parts, segs)]


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


def _serve_rows(spec: EmbeddingSpec, state: EmbeddingTableState,
                plan: ExchangePlan, *, train: bool, mesh: Mesh,
                fmt: str = "fp32") -> Tuple[torch.Tensor, ExchangePlan]:
    """The owner's side of a pull: this shard's rows for the received ids,
    as the (S, cap, W) payload in wire format `fmt` (encoded here, at the
    owner's edge). A hash table's training pull inserts unseen ids, adds
    the overflow of all the ranks to its counter, and returns the plan with
    the received ids' slots. -> (payload, plan)."""
    S = mesh.size
    flat_recv = plan.recv_ids.reshape(-1)
    flat_valid = plan.recv_valid.reshape(-1)
    if spec.use_hash_table:
        probe = torch.where(flat_valid, flat_recv,
                            torch.full_like(flat_recv, -1))
        if train:
            state, rows, overflow, slot = hash_lookup_train(state, probe)
            if S > 1:
                # the counter is the table's, replicated: every rank adds
                # the increments of all the ranks
                state.overflow.add_(coll.psum(mesh, overflow) - overflow)
            plan = plan._replace(slot=slot)
        else:
            rows = hash_lookup(state, probe)
    else:
        local = torch.where(flat_valid, torch.div(flat_recv, S,
                                                  rounding_mode="floor"),
                            torch.full_like(flat_recv, -1))
        rows = lookup_rows(state.weights, local)
    if fmt == "fp32":
        return rows.reshape(S, plan.cap, spec.output_dim), plan
    enc = wire_mod.pack_inband(rows.float(), fmt)
    return enc.reshape(S, plan.cap, -1), plan


def _reassemble(plan: ExchangePlan, rows: torch.Tensor, out_shape, dim: int,
                mesh: Mesh, fmt: str = "fp32") -> torch.Tensor:
    """The client's side: rows back over the all_to_all (decoded here),
    unbucketed, duplicates expanded. At S == 1 the served rows are the
    unique rows."""
    if mesh.size == 1:
        uniq_rows = rows[0]
    else:
        back = coll.all_to_all(mesh, rows)
        if fmt != "fp32":
            back = wire_mod.unpack_inband(
                back.reshape(-1, back.shape[-1]), dim,
                fmt).reshape(back.shape[0], -1, dim)
        uniq_rows = unbucket(back, plan.buckets.owner, plan.buckets.slot)
    out = uniq_rows[plan.uniq.inverse]
    return out.reshape(tuple(out_shape) + (dim,))


def _pull_stats(spec, ids, plan, load_stats, mesh) -> Dict[str, torch.Tensor]:
    dev = ids.device
    stats = {
        # a fill on the device: a host tensor could not be captured
        "pull_indices": torch.full((), ids_positions(spec, ids),
                                   dtype=torch.int32, device=dev),
        "pull_unique": plan.uniq.num_unique.to(torch.int32),
        "pull_overflow": plan.buckets.overflow,
    }
    if load_stats:
        stats.update(exchange_load_stats(plan, mesh=mesh))
    return stats


def _fmt(mesh: Mesh, wire: Optional[str]) -> str:
    return wire_mod.wire_format(wire) if mesh.size > 1 else "fp32"


def sharded_lookup_train(spec: EmbeddingSpec, state: EmbeddingTableState,
                         ids: torch.Tensor, *, mesh: Mesh,
                         capacity_factor: float = 0.0,
                         load_stats: bool = True,
                         wire: Optional[str] = "fp32"):
    """Training pull of one table -> (state, rows ids.shape + (dim,), stats,
    plan); the plan goes to `sharded_apply_gradients` for the same batch.
    `wire`: the rows' format (None: `$OETPU_WIRE`, then bf16)."""
    plan = make_plan(spec, ids, mesh=mesh, capacity_factor=capacity_factor)
    fmt = _fmt(mesh, wire)
    rows, plan = _serve_rows(spec, state, plan, train=True, mesh=mesh,
                             fmt=fmt)
    out = _reassemble(plan, rows, ids.shape, spec.output_dim, mesh, fmt)
    if fmt != "fp32":
        out = out.to(spec.dtype)
    return state, out, _pull_stats(spec, ids, plan, load_stats, mesh), plan


def sharded_lookup(spec: EmbeddingSpec, state: EmbeddingTableState,
                   ids: torch.Tensor, *, mesh: Mesh,
                   capacity_factor: float = 0.0) -> torch.Tensor:
    """Read-only pull (eval, serving): inserts nothing; absent hash ids
    pull zeros. fp32 wire."""
    plan = make_plan(spec, ids, mesh=mesh, capacity_factor=capacity_factor)
    rows, plan = _serve_rows(spec, state, plan, train=False, mesh=mesh)
    return _reassemble(plan, rows, ids.shape, spec.output_dim, mesh)


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
                            wire: Optional[str] = "fp32"):
    """Push and fused update of one table, in place -> (state, stats).
    Pass the pull's `plan` to skip a second dedup and id exchange."""
    S = mesh.size
    fmt = _fmt(mesh, wire)
    if plan is None:
        plan = make_plan(spec, ids, mesh=mesh,
                         capacity_factor=capacity_factor)
    g, counts = _client_grads(spec, plan, grads)
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
        payload = wire_mod.encode_grads(g, counts, fmt)
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
    (invalid, overflowed) go to one spare row that is cut off."""
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
    apply. A hash table applies at `slot` (its pull's slots of these
    receive positions), or probes for them without it."""
    live = rc > 0
    zero = torch.zeros_like(rc)
    if spec.use_hash_table:
        capacity = state.keys.shape[0]
        if slot is None:
            from ..tables.hash_table import hash_find
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
    plans go to `grouped_apply_gradients` for the same batch."""
    S = mesh.size
    dim = _check_dims(specs)
    plans = grouped_make_plans(specs, ids_list, mesh=mesh,
                               capacity_factor=capacity_factor)
    fmt = _fmt(mesh, wire)
    rows_list = []
    for i, (spec, state) in enumerate(zip(specs, states)):
        rows, plans[i] = _serve_rows(spec, state, plans[i], train=True,
                                     mesh=mesh, fmt=fmt)
        rows_list.append(rows)
    if S == 1:
        outs = [_reassemble(plan, rows, ids.shape, spec.output_dim, mesh)
                for spec, ids, plan, rows
                in zip(specs, ids_list, plans, rows_list)]
    else:
        stacked = torch.cat(rows_list, dim=1)
        back = coll.all_to_all(mesh, stacked)
        dec = wire_mod.unpack_inband(back.reshape(-1, back.shape[-1]), dim,
                                     fmt).reshape(S, -1, dim)
        outs, off = [], 0
        for spec, ids, plan in zip(specs, ids_list, plans):
            seg = dec[:, off:off + plan.cap]
            off += plan.cap
            uniq_rows = unbucket(seg, plan.buckets.owner, plan.buckets.slot)
            out = uniq_rows[plan.uniq.inverse]
            outs.append(out.to(spec.dtype).reshape(
                tuple(ids.shape) + (spec.output_dim,)))
    stats_list = [_pull_stats(spec, ids, plan, load_stats, mesh)
                  for spec, ids, plan in zip(specs, ids_list, plans)]
    return states, outs, stats_list, plans


def grouped_apply_gradients(specs, states, optimizers, ids_list, grads_list,
                            *, mesh: Mesh, capacity_factor: float = 0.0,
                            plans=None, wire: Optional[str] = None):
    """Push and fused update of one dim-group, in place: ONE all_to_all
    carries every table's grads and counts -> (states, stats list)."""
    S = mesh.size
    dim = _check_dims(specs)
    fmt = _fmt(mesh, wire)
    if plans is None:
        plans = grouped_make_plans(specs, ids_list, mesh=mesh,
                                   capacity_factor=capacity_factor)
    client = [_client_grads(spec, plan, grads)
              for spec, plan, grads in zip(specs, plans, grads_list)]
    stats_list = [{"push_overflow": plan.buckets.overflow} for plan in plans]
    if S == 1:
        for spec, state, opt, plan, (g, rc) in zip(specs, states, optimizers,
                                                   plans, client):
            _apply_unique(spec, state, opt, plan.uniq.unique_ids, g, rc, S,
                          plan.slot)
        return states, stats_list
    payloads = [_scatter_buckets(wire_mod.encode_grads(g, rc, fmt),
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
