"""Static-capacity open-addressing device hash table (port of
`openembedding_tpu/tables/hash_table.py`, single-lane int64 keys).

A table with `input_dim=-1` holds ids of the 63-bit hashed id space in a
fixed number of slots (`capacity`): `keys` (capacity,) int64 with -1 for an
empty slot, beside the (capacity, dim) weights and their optimizer slots.
Every slot's row is drawn by the initializer when the table is made, so an
id that claims a slot starts from that slot's row.

Probing is linear from `_mix(id) % capacity`, within a budget of
`DEFAULT_NUM_PROBES` distances. An id that finds no slot within the budget
is an overflow: its pull is a zero row, its gradient is dropped, and the
table's `overflow` counter grows.

Placement is exact, not just some valid layout, because an id's initial row
depends on its slot. It is defined by rounds, one a probe distance: in
round d every id without a slot reads the key at distance d as the round
starts; a key equal to the id is its slot, an empty key is claimed, and
where several ids claim one empty slot the one at the highest index of the
probe batch wins and the others probe on. That is the JAX package's rule
on the CPU, where its reread after `keys.at[target].set(ids)` sees the last
update in index order. The plain version, `hash_find_or_insert_reference`,
runs the 64 rounds as torch ops (every round, whatever the data): the
claim is a `scatter_reduce(..., "amax")` of the contenders' indices into a
buffer of `capacity` entries, then a second `amax` scatter writes each
winner's id over the empty key. `amax` does not depend on the order of the
writes, so every device places every id alike.

On the card, `hash_find_or_insert` launches `csrc/hash_probe.cu`
(`ops/hash_probe.py`) instead: the same placement, with no claim buffer,
touching only the entries that can change it.

- The walk reads each id's path on the table as it stands, up to its own
  key or the first empty key. An id already in the table is found there
  (at the flagship's load, at distance 0 or 1), exactly where the rounds
  find it: the slots it passed were occupied, and rounds only fill empty
  slots. An id that meets an empty key at distance d0 is pending.
- The contest (one block of threads, its rounds ended by block barriers)
  runs the rounds from the least d0 for the pending ids alone, each
  joining at its own d0. A contender writes the marker `-2 - index`
  over the empty key with an atomic minimum, so the marker that stands is
  the highest index's, the one the claim buffer's `amax` kept; the winner
  then writes its id over its marker. With no pending id it returns at
  once.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises. A negative id (the dedup's padding slots) is skipped and gets the
slot `capacity`. Keys hold -1 or an id, nothing else negative.

The JAX package also keeps a split-pair uint32 key layout for JAX with 64-bit
types off; the port never builds it, and `np_resident_ids`,
`np_ids_as_int64` and `np_join_ids`/`np_split_ids` convert such states.

The pull's probe is the phase `hash.probe_insert` (`utils/phases`: a
profiler range and a trace span, timed on the device under a timed
driver, which also counts the slots it claims as "inserted" and the ids
that met an empty slot on their walk as "pending"). The train step's push
takes the pull's slots; a push given ids alone probes again, in the phase
`hash.probe_find`.

Ids must be non-negative; -1 is the empty-slot sentinel and the batch pad.
Pulls go through the gather kernel (`ops/gather.gather_rows`), which returns
the zero row for a miss (slot == capacity); pushes go through the dedup and
the fused apply kernel (`ops/sparse.sparse_apply_dense_table`) with count 0
for a miss.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import gather, hash_probe
from ..ops.dedup import unique_with_counts
from ..utils import phases

EMPTY = -1
DEFAULT_NUM_PROBES = 64

# numpy split-pair layout of the JAX package (`ops/id64.py`): hi lane >= 2^31
# marks an empty or padding row
HI_INVALID = np.uint32(0x80000000)
PAIR_EMPTY = np.uint32(0xFFFFFFFF)

_MIX_MUL = 0xFF51AFD7ED558CCD - (1 << 64)  # the uint64 multiplier as int64
_LOW31 = (1 << 31) - 1


def _mix(ids: torch.Tensor) -> torch.Tensor:
    """The avalanche mixer of the JAX package, on int64 tensors holding the
    uint64 bit pattern: the multiply wraps the same way, and the logical
    shift by 33 is the arithmetic one masked to its 31 low bits."""
    u = ids.to(torch.int64)
    u = (u ^ ((u >> 33) & _LOW31)) * _MIX_MUL
    return u ^ ((u >> 33) & _LOW31)


def _mix32(ids: torch.Tensor) -> torch.Tensor:
    """The JAX package's 32-bit mixer (its `_mix` of int32 ids: the probe
    tables of the hot set and the migration directory of an array table),
    uint32 arithmetic carried in int64 and masked to 32 bits."""
    u = ids.to(torch.int64) & 0xFFFFFFFF
    u = ((u ^ (u >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return u ^ (u >> 16)


def _base_slot(ids: torch.Tensor, capacity: int,
               wide: bool = True) -> torch.Tensor:
    """`_mix(ids) % capacity` as an unsigned remainder: a mixed value with
    bit 63 set is negative as int64, and u + 2^64 = u (mod capacity) needs
    2^64 % capacity added back. `wide=False`: the 32-bit mixer of int32
    keys, whose mixed values are non-negative."""
    if not wide:
        return torch.remainder(_mix32(ids), capacity)
    u = _mix(ids)
    r = torch.remainder(u, capacity)
    return torch.where(u < 0, torch.remainder(r + (1 << 64) % capacity,
                                              capacity), r)


def np_mix(ids):
    """Numpy twin of `_mix` (the JAX package's `np_mix`): the host-side
    re-insert of a checkpoint probes the same sequence."""
    if ids.dtype.itemsize >= 8:
        u = ids.astype(np.uint64)
        u = (u ^ (u >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        return u ^ (u >> np.uint64(33))
    u = ids.astype(np.uint32)
    u = (u ^ (u >> np.uint32(16))) * np.uint32(0x45D9F3B)
    return u ^ (u >> np.uint32(16))


def fresh_keys(rows: int, device=None) -> torch.Tensor:
    """An all-empty key array: (rows,) int64 of -1."""
    return torch.full((rows,), EMPTY, dtype=torch.int64, device=device)


# -- numpy id helpers (copies of the JAX package's `ops/id64.py`) -----------


def np_split_ids(ids64) -> np.ndarray:
    """int64 (...,) -> uint32 (..., 2); negative ids become the empty pair."""
    ids = np.asarray(ids64, np.int64)
    hi = (ids >> 32).astype(np.uint32)
    lo = (ids & np.int64(0xFFFFFFFF)).astype(np.uint32)
    neg = ids < 0
    hi[neg] = PAIR_EMPTY
    lo[neg] = PAIR_EMPTY
    return np.stack([hi, lo], axis=-1)


def np_join_ids(pair) -> np.ndarray:
    """uint32 (..., 2) -> int64 (...,); empty and padding rows become -1."""
    pair = np.asarray(pair)
    hi = pair[..., 0].astype(np.int64)
    lo = pair[..., 1].astype(np.int64)
    out = (hi << 32) | lo
    out[pair[..., 0] >= HI_INVALID] = -1
    return out


def np_resident_ids(keys) -> Tuple[np.ndarray, np.ndarray]:
    """(keys in either layout) -> (mask of the slots holding an id, their
    int64 ids)."""
    keys = np.asarray(keys)
    if keys.ndim == 2:
        sel = keys[:, 0] < HI_INVALID
        return sel, np_join_ids(keys[sel])
    sel = keys >= 0
    return sel, keys[sel].astype(np.int64)


def np_ids_as_int64(ids) -> np.ndarray:
    """A hash table's id batch in either layout -> flat int64."""
    ids = np.asarray(ids)
    if ids.dtype == np.uint32 and ids.ndim >= 1 and ids.shape[-1] == 2:
        return np_join_ids(ids).reshape(-1)
    return ids.reshape(-1).astype(np.int64)


def np_hash_insert(keys: np.ndarray, ids: np.ndarray, num_shards: int = 1,
                   num_probes: int = DEFAULT_NUM_PROBES) -> np.ndarray:
    """Host-side insert of unique non-negative `ids` into the numpy `keys`
    ((S * capacity_per_shard,), -1 empty), in place, by the device's probe
    sequence inside the owner shard's range (owner = id % S); int32 ids
    probe by the 32-bit mixer, as `hash_find` of int32 keys does. Returns
    each id's slot, -1 where no empty slot lies within `num_probes`.

    One round per probe distance for all pending ids; among ids claiming one
    empty slot the lowest index wins (the order of a sequential insert) and
    the others advance. That is the JAX package's rule for this function,
    which differs from the device probe's (highest index wins): a loaded
    table may place two colliding ids the other way round than training
    did, so a loaded table equals the saved one in its id -> row contents,
    and equals the JAX package's load of the same files slot for slot."""
    ids = np.asarray(ids)
    if ids.dtype.itemsize < 4:
        ids = ids.astype(np.int64)
    rows_total = keys.shape[0]
    cps = rows_total // num_shards
    owner = (ids.astype(np.int64) % num_shards) * cps
    mixed = np_mix(ids)
    base = (mixed % np.uint64(cps) if ids.dtype.itemsize >= 8
            else mixed % np.uint32(cps)).astype(np.int64)
    pos_out = np.full(len(ids), -1, np.int64)
    max_d = min(num_probes, cps)
    active = np.arange(len(ids))
    dist = np.zeros(len(ids), np.int64)
    while active.size:
        p = owner[active] + (base[active] + dist[active]) % cps
        empty = keys[p] == EMPTY
        cand, cp = active[empty], p[empty]
        order = np.argsort(cp, kind="stable")
        cp_s, cand_s = cp[order], cand[order]
        first = np.ones(cp_s.size, bool)
        if cp_s.size:
            first[1:] = cp_s[1:] != cp_s[:-1]
        win, wp = cand_s[first], cp_s[first]
        keys[wp] = ids[win]
        pos_out[win] = wp
        placed = np.zeros(len(ids), bool)
        placed[win] = True
        rem = active[~placed[active]]
        dist[rem] += 1
        active = rem[dist[rem] < max_d]
    return pos_out


# -- the device probe -------------------------------------------------------


def hash_find_or_insert(keys: torch.Tensor, ids: torch.Tensor,
                        num_probes: int = DEFAULT_NUM_PROBES
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find each id's slot, claiming an empty slot for an id not in the
    table. `keys` (capacity,) int64 is updated in place; `ids` (n,) int64
    must be unique among the non-negative ones (dedup first), negative ids
    are skipped. Returns (slot (n,) int64, `capacity` for a skipped or
    overflowed id; overflow () int32, the non-negative ids left without a
    slot). The placement is the module docstring's rounds: on a CPU tensor
    as torch ops (`hash_find_or_insert_reference`), on a CUDA tensor by the
    walk and the contest (`ops/hash_probe.py`), which read nothing back to
    the host. Under a phase clock (`utils/phases.active`) the slots claimed
    are counted as "inserted" and the ids that met an empty slot on their
    walk as "pending"."""
    probe = (hash_find_or_insert_reference if keys.device.type == "cpu"
             else hash_probe.find_or_insert)
    slot, overflow, inserted, pending = probe(keys, ids, num_probes)
    clock = phases.active()
    if clock is not None:
        clock.count("inserted", inserted)
        clock.count("pending", pending)
    return slot, overflow


def hash_find_or_insert_reference(keys: torch.Tensor, ids: torch.Tensor,
                                  num_probes: int = DEFAULT_NUM_PROBES):
    """The plain version of `hash_find_or_insert`, on any device, with the
    kernels' contract (`ops/hash_probe.find_or_insert`): `num_probes`
    rounds of torch ops, each over every id whatever the data -> (slot,
    overflow, inserted, pending). `inserted` (slots claimed) and `pending`
    (non-negative ids whose walk over the keys as the call found them met
    an empty slot before their own key, within the budget: the ids the
    kernels' contest takes) are () int64."""
    capacity = keys.shape[0]
    n = ids.shape[0]
    device = ids.device
    ids = ids.to(torch.int64)
    placed = ids < 0
    walking = ~placed  # on its walk over the keys as the call found them
    met = torch.zeros_like(placed)  # its walk met an empty key: pending
    claimed = torch.zeros_like(placed)
    index = torch.arange(n, dtype=torch.int32, device=device)
    # a skipped id never claims, so where it probes only spreads its -1s
    base = torch.where(placed, torch.remainder(index.long(), capacity),
                       _base_slot(ids, capacity))
    slot = torch.full((n,), capacity, dtype=torch.int64, device=device)
    # each slot's highest contending index, -1 where none has contended: a
    # contended slot always gets its winner, so the buffer needs no reset,
    # and >= 0 marks a slot this call filled
    claim = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    for d in range(num_probes):
        pos = torch.remainder(base + d, capacity)
        cur = keys[pos]
        was_empty = (cur == EMPTY) | (claim[pos] >= 0)
        met |= walking & was_empty
        walking &= ~was_empty & (cur != ids)
        found = ~placed & (cur == ids)
        slot = torch.where(found, pos, slot)
        placed = placed | found
        want = ~placed & (cur == EMPTY)
        claim.scatter_reduce_(0, pos, torch.where(want, index, -1), "amax")
        got = want & (claim[pos] == index)
        # the winner's id over the empty key; everyone else writes -1, which
        # `amax` never keeps over a key
        keys.scatter_reduce_(0, pos, torch.where(got, ids, EMPTY), "amax")
        slot = torch.where(got, pos, slot)
        placed = placed | got
        claimed |= got
    overflow = torch.sum(~placed).to(torch.int32)
    return slot, overflow, claimed.sum(), met.sum()


def hash_find(keys: torch.Tensor, ids: torch.Tensor,
              num_probes: int = DEFAULT_NUM_PROBES) -> torch.Tensor:
    """Read-only probe: each id's slot, `capacity` where it is absent (an
    empty slot on its path ends the search) or negative. int32 `keys` (the
    placement probe tables of an array table) probe by the 32-bit mixer."""
    capacity = keys.shape[0]
    ids = ids.to(torch.int64)
    base = _base_slot(ids, capacity, wide=keys.dtype != torch.int32)
    slot = torch.full(ids.shape, capacity, dtype=torch.int64,
                      device=ids.device)
    done = ids < 0
    for d in range(num_probes):
        pos = torch.remainder(base + d, capacity)
        cur = keys[pos]
        found = ~done & (cur == ids)
        slot = torch.where(found, pos, slot)
        done = done | found | (cur == EMPTY)
    return slot


def shard_probe(ids: torch.Tensor, rank: int,
                num_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mine, probe) for a row-sharded hash table on rank `rank`: `mine`
    masks the ids this shard owns (`id % S == rank`) and `probe` is `ids`
    with every other entry -1, so the shard's probe never matches them."""
    mine = (ids >= 0) & (torch.remainder(ids, num_shards) == rank)
    return mine, torch.where(mine, ids, torch.full_like(ids, EMPTY))


def hash_lookup(state, ids: torch.Tensor) -> torch.Tensor:
    """Read-only pull of flat ids -> (n, dim); absent ids give zero rows."""
    slot = hash_find(state.keys, ids)
    return gather.gather_rows(state.weights, slot)


def hash_lookup_train(state, ids: torch.Tensor, out_dim: int = None):
    """Training pull of flat ids: unseen ids claim slots (whose rows already
    hold initializer values), in place on `state.keys`; the step's overflow
    is added to `state.overflow` in place. Returns (state, rows (n, dim),
    this pull's overflow (), slot (n,) int64: each id's slot, `capacity`
    for a pad or an overflow). Until the keys change again the slots are
    what `hash_find` of these ids returns, so the step's push takes them
    instead of probing again. `out_dim`: the state holds the packed
    weights+slots layout of `Trainer.train_many`; keep the weight columns."""
    uniq = unique_with_counts(ids.to(torch.int64))
    probe = torch.where(uniq.counts > 0, uniq.unique_ids,
                        torch.full_like(uniq.unique_ids, EMPTY))
    with phases.phase("hash", "probe_insert"):
        uslot, overflow = hash_find_or_insert(state.keys, probe)
    slot = uslot[uniq.inverse]
    rows = gather.gather_rows(state.weights, slot)
    if out_dim is not None and rows.shape[1] != out_dim:
        rows = rows[:, :out_dim]
    state.overflow.add_(overflow)
    return state, rows, overflow, slot


def _grad_slots_and_counts(state, ids: torch.Tensor, slot=None):
    """ids -> (slots, counts) of the push: an absent id (it overflowed at
    the pull) has count 0, so its gradient is dropped. `slot`: the pull's
    slots of these ids (keys unchanged since), which skip the find probe."""
    if slot is None:
        with phases.phase("hash", "probe_find"):
            slot = hash_find(state.keys, ids)
    capacity = state.keys.shape[0]
    return slot, (slot < capacity).to(torch.int32)


def hash_apply_gradients(state, optimizer, ids: torch.Tensor,
                         grads: torch.Tensor, slot: torch.Tensor = None):
    """Push + update, in place: ids -> slots (no insert: the pull inserted
    them; `slot` given: the pull's, no probe), then the dedup and the fused
    apply over slot indices."""
    from ..ops.sparse import sparse_apply_dense_table
    slot, counts = _grad_slots_and_counts(state, ids, slot)
    sparse_apply_dense_table(optimizer, state.weights, state.slots, slot,
                             grads, pre_counts=counts)
    return state


def hash_apply_gradients_packed(state, optimizer, ids: torch.Tensor,
                                grads: torch.Tensor, layout, dim: int,
                                slot: torch.Tensor = None):
    """`hash_apply_gradients` on the packed weights+slots layout."""
    from ..ops.sparse import sparse_apply_packed_table
    slot, counts = _grad_slots_and_counts(state, ids, slot)
    sparse_apply_packed_table(optimizer, state.weights, layout, dim, slot,
                              grads, pre_counts=counts)
    return state
