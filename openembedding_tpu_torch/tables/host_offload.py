"""Two-tier embedding table: a device hash-table cache in front of a host-RAM
store (port of `openembedding_tpu/tables/host_offload.py`).

The counterpart of the reference's PMem backend (`variable/PmemEmbeddingTable.h`:
a DRAM cache in front of persistent pools, `PmemEmbeddingOptimizerVariable.h:
88-198`): the card holds a fixed-capacity hash-table cache
(`tables/hash_table.py`) and the whole table lives in host RAM, so a table
is bounded by host memory, not by the card's.

Protocol (host-driven, between steps; the ids are known on the host from the
input pipeline):

1. `prepare(ids)`: ids evicted to the host earlier are ADMITTED back into the
   cache (`admit_rows`: the probe claims their slots, their rows and optimizer
   slots are copied in); brand-new ids claim slots too and keep the
   initializer rows there. When admission would push a shard over its
   high-water mark, cold residents are evicted first (3).
2. the train step runs on the card against the cache (the normal hash path).
3. clock eviction (`evict_rows`, the reference's per-item LRU): every resident
   id carries a referenced bit, set when a `prepare` touches it; `evict_cold`
   moves only the unreferenced rows to the store and rebuilds the cache with
   the hot rows kept on the card. The whole-cache `flush` (every resident row
   to the store, the cache reset) is the fallback when the hot set leaves no
   room, and the policy `eviction="flush"`.

Every step writes into the cache's own tensors: admission, eviction's rebuild
(the fresh template copied into the existing keys, weights and slots),
`flush`, `reset_cache` and `load_store` all work in place, so a captured CUDA
graph of the train step (`model.CompiledStep`) stays valid across them. The
fresh template is drawn again from a generator seeded as `Trainer.init` seeds
the table's, so two resets give bit-equal caches.

Eviction reads the cold and hot rows, and `sync_to_store` the resident ones,
through the gather kernel (`ops/gather.gather_rows`, with the probe's `found`
as its mask); the train step's pull and push run the gather and the fused
apply kernels as for any hash table. Admission's and the rebuild's row writes
are `index_copy_`, as the JAX package writes them with `.at[].set` outside any
kernel.

Exactness: a row's weights and optimizer state round-trip bit for bit through
evict and admit, so training with a small cache equals training with a large
in-HBM table whenever the initializer does not depend on the slot
(`Constant`).

Pipelining: with `pipeline=True` a one-worker staging thread runs up to
`stage_depth` future batches' store lookups and uploads (`stage(ids)`, through
pinned host memory on a side stream, an event recorded after the copies)
while the current step computes; the matching `prepare(ids)` waits on that
event and pays only the admission. Staging is a hint: a residency epoch and
`HostStore.version` invalidate stale payloads, and a mismatch takes the
synchronous path (a miss). `densify_k=K` folds K eviction writebacks into one
sorted merge (`HostStore.defer` / `drain`); lookups read pending chunks, so
reads stay exact in between.

On the mesh (`mesh=`, one process per rank) the cache is row-sharded as
`parallel/sharded.py` shards a hash table: rank r admits and evicts only the
ids it owns (`id % S == r`, `hash_table.shard_probe`, the probe the owner's
pull runs), and its store holds only those rows. `prepare` first takes the
union of every rank's batch ids (`multihost.allgather_host_ids`), and the
residency, its clock bits and the per-shard counts are kept alike on every
rank: admission and eviction sum their per-id outcomes over the ranks, so
every rank takes the same evict or flush decision. The JAX package drives the
whole mesh from one process with one store; here `offload_store_snapshots`,
checkpoints and `lookup_anywhere` read each rank's own store.

The JAX package's `offload.*` series are published through the registry
(`utils/metrics`) under its names: `offload.staged_bytes`, `admitted`,
`overlap_ratio`, `pipeline_hits` / `misses` / `occupancy{slot=}`,
`densified_merges`, `drained_rows`, `evicted_cold`, `kept_hot`, `flushes`,
and the spans `offload.admit` / `stage` / `drain` / `evict` / `sync` /
`flush`. `offload.staged_bytes` counts the bytes this rank uploads (JAX
pads its payload to a power of two first). The same counts stay
attributes: `pipe_hits`, `pipe_misses`, `slot_hits`, `slot_misses`,
`counters` (admitted and readmitted rows, evictions, evicted and kept
rows, flushes, resident reads, densified merges, drained rows, staged bytes) and `timings` (ms of prepare's split, store lookup, upload and
admission, of staging, eviction and flush; the last `TIMING_SAMPLES` each).
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import gather
from ..utils import metrics
from .hash_table import (EMPTY, hash_find, hash_find_or_insert,
                         np_ids_as_int64, shard_probe)

TIMING_SAMPLES = 1024


class HostStore:
    """Id-sorted host arrays (weights + slots) with merge-update.

    Thread-safe (one RLock around every read and write): the staging worker
    reads through `lookup` while the training thread writes through `merge`
    and `defer`. Writebacks can be deferred (`defer` + `drain`): K eviction
    rounds append pending chunks instead of paying K sorted merges, and
    `drain` folds them last-wins into one merge. `lookup` overlays the
    pending chunks, so a deferred row reads back before the drain."""

    def __init__(self, dim: int, slot_widths: Dict[str, int]):
        self._lock = threading.RLock()
        self.ids = np.empty((0,), np.int64)  # guarded-by: self._lock
        self.weights = np.empty((0, dim), np.float32)  # guarded-by: self._lock
        self.slots = {k: np.empty((0, w), np.float32)
                      for k, w in slot_widths.items()}  # guarded-by: self._lock
        # deferred writeback chunks, oldest first: [(sorted ids, w, slots)]
        self._pending = []  # guarded-by: self._lock
        # bumped on every mutation `lookup` could observe: a staged payload
        # records the version it looked up against
        self.version = 0  # guarded-by: self._lock

    def __len__(self) -> int:
        return len(self.ids)

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """-> (hit mask, weight rows, slot rows) for `ids` (unknown ids give
        zero rows and hit=False). Pending chunks overlay the base arrays,
        the newest winning."""
        with self._lock:
            if len(self.ids) == 0:
                hit = np.zeros((len(ids),), bool)
                w = np.zeros((len(ids),) + self.weights.shape[1:], np.float32)
                s = {k: np.zeros((len(ids),) + v.shape[1:], np.float32)
                     for k, v in self.slots.items()}
            else:
                pos = np.searchsorted(self.ids, ids)
                pos_c = np.clip(pos, 0, len(self.ids) - 1)
                hit = self.ids[pos_c] == ids
                w = np.where(hit[:, None], self.weights[pos_c], 0.0)
                s = {k: np.where(hit[:, None], v[pos_c], 0.0)
                     for k, v in self.slots.items()}
            for pids, pw, ps in self._pending:  # oldest -> newest: last wins
                pos = np.searchsorted(pids, ids)
                pos_c = np.clip(pos, 0, len(pids) - 1)
                h = pids[pos_c] == ids
                if h.any():
                    hit = hit | h
                    w[h] = pw[pos_c[h]]
                    for k in s:
                        s[k][h] = ps[k][pos_c[h]]
            return hit, w, s

    def defer(self, ids: np.ndarray, weights: np.ndarray,
              slots: Dict[str, np.ndarray]) -> None:
        """Queue an upsert for the next `drain` (ids unique within the
        call)."""
        if len(ids) == 0:
            return
        order = np.argsort(ids, kind="stable")
        with self._lock:
            self.version += 1
            self._pending.append((
                np.asarray(ids)[order].astype(np.int64),
                np.asarray(weights)[order].astype(np.float32),
                {k: np.asarray(v)[order].astype(np.float32)
                 for k, v in slots.items()}))

    def drain(self) -> int:
        """Fold every pending chunk into the base arrays with one merge (the
        last write of each id wins, the order of the calls). Returns the
        rows merged."""
        with self._lock:
            if not self._pending:
                return 0
            ids = np.concatenate([c[0] for c in self._pending])
            w = np.concatenate([c[1] for c in self._pending])
            s = {k: np.concatenate([c[2][k] for c in self._pending])
                 for k in self._pending[0][2]}
            self._pending = []
            # the last occurrence of each id: unique() of the reversed array
            # marks each id's first position from the end
            _, ridx = np.unique(ids[::-1], return_index=True)
            keep = len(ids) - 1 - ridx
            self.merge(ids[keep], w[keep], {k: v[keep] for k, v in s.items()})
            return int(keep.size)

    def merge(self, ids: np.ndarray, weights: np.ndarray,
              slots: Dict[str, np.ndarray]) -> None:
        """Upsert rows (ids need not be sorted; an existing id is
        updated)."""
        if len(ids) == 0:
            return
        order = np.argsort(ids, kind="stable")
        ids, weights = ids[order], weights[order]
        slots = {k: v[order] for k, v in slots.items()}
        with self._lock:
            self.version += 1
            if len(self.ids) == 0:
                exists = np.zeros((len(ids),), bool)
                pos_c = np.zeros((len(ids),), np.int64)
            else:
                pos = np.searchsorted(self.ids, ids)
                pos_c = np.clip(pos, 0, len(self.ids) - 1)
                exists = self.ids[pos_c] == ids
            if exists.any():
                self.weights[pos_c[exists]] = weights[exists]
                for k in self.slots:
                    self.slots[k][pos_c[exists]] = slots[k][exists]
            new = ~exists
            if new.any():
                self.ids = np.concatenate([self.ids, ids[new]])
                self.weights = np.concatenate([self.weights, weights[new]])
                for k in self.slots:
                    self.slots[k] = np.concatenate([self.slots[k],
                                                    slots[k][new]])
                order = np.argsort(self.ids, kind="stable")
                self.ids = self.ids[order]
                self.weights = self.weights[order]
                for k in self.slots:
                    self.slots[k] = self.slots[k][order]

    def nbytes(self) -> int:
        with self._lock:
            return (self.ids.nbytes + self.weights.nbytes
                    + sum(v.nbytes for v in self.slots.values())
                    + sum(c[0].nbytes + c[1].nbytes
                          + sum(v.nbytes for v in c[2].values())
                          for c in self._pending))

    def snapshot(self) -> "HostStore":
        """A copy for an async writer (`merge` updates rows in place, so a
        store handed to another thread must not see later flushes). Pending
        chunks drain first: a snapshot is always fully merged."""
        with self._lock:
            self.drain()
            out = HostStore.__new__(HostStore)
            out.ids = self.ids.copy()
            out.weights = self.weights.copy()
            out.slots = {k: v.copy() for k, v in self.slots.items()}
            out._lock = threading.RLock()
            out._pending = []
            out.version = 0
            return out

    def replace_all(self, ids: np.ndarray, weights: np.ndarray,
                    slots: Dict[str, np.ndarray]) -> None:
        """Wholesale replacement (checkpoint load); ids must be unique."""
        order = np.argsort(ids, kind="stable")
        with self._lock:
            self.version += 1
            self._pending = []  # the store they patched is gone
            self.ids = ids[order].astype(np.int64)
            self.weights = weights[order].astype(np.float32)
            self.slots = {k: v[order].astype(np.float32)
                          for k, v in slots.items()}


def _probe(ids: torch.Tensor, rank: int, num_shards: int) -> torch.Tensor:
    """The ids as this shard probes them: every id at S = 1, else the ids
    it owns and -1 elsewhere."""
    if num_shards == 1:
        return ids
    return shard_probe(ids, rank, num_shards)[1]


def _write_rows(state, slot: torch.Tensor, ok: torch.Tensor,
                w_rows: torch.Tensor, s_rows: Dict[str, torch.Tensor]) -> None:
    """state.weights[slot[i]] = w_rows[i] (and every slot's rows) where
    `ok`, in place (reads `ok` back to the host: its nonzero)."""
    sel = torch.nonzero(ok).squeeze(1)
    if sel.numel() == 0:
        return
    dst = slot.index_select(0, sel)
    state.weights.index_copy_(0, dst, w_rows.index_select(0, sel).to(
        state.weights.dtype))
    for k, v in state.slots.items():
        v.index_copy_(0, dst, s_rows[k].index_select(0, sel).to(v.dtype))


@torch.no_grad()
def admit_rows(state, ids: torch.Tensor, w_rows: torch.Tensor,
               s_rows: Dict[str, torch.Tensor], known: torch.Tensor, *,
               rank: int = 0, num_shards: int = 1):
    """Admission into the cache `state` (JAX `_admit_fn` / `_make_mesh_admit`),
    in place: every id this shard owns claims its slot (`hash_find_or_insert`,
    the probe of the train step's pull); the rows and optimizer slots of the
    `known` ones (held by the store) are copied in, a new id keeps its
    slot's initializer row. ids (n,) int64 unique, -1 inert. -> (admitted
    (n,) bool: a slot was claimed on this shard; this shard's overflow ()
    int32, not yet added to the counter)."""
    slot, overflow = hash_find_or_insert(state.keys,
                                         _probe(ids, rank, num_shards))
    admitted = slot < state.keys.shape[0]
    _write_rows(state, slot, admitted & known, w_rows, s_rows)
    return admitted, overflow


@torch.no_grad()
def evict_rows(state, cold_ids: torch.Tensor, hot_ids: torch.Tensor,
               refresh, *, rank: int = 0, num_shards: int = 1):
    """Clock eviction of the cache `state` (JAX `_evict_fn` /
    `_make_mesh_evict`), in place: the cold rows this shard holds read out
    for the store, then the cache rebuilt from the fresh template
    (`refresh(state)`, in place) with the hot rows kept: their ids
    re-inserted, their rows and slots copied to their new slots. An open
    probe chain cannot delete in place (a vacated slot would end later
    probes early), hence the rebuild. Both reads go through the gather
    kernel with the probe's `found` as the mask.

    -> (cold found (nc,) bool, cold weights, {slot: cold rows}, kept (nh,)
    bool, lost (nh,) bool, hot weights, {slot: hot rows}, the re-insert's
    overflow () int32). `lost`: hot rows whose re-insert found no slot
    (rare), handed back for the store."""
    cap = state.keys.shape[0]
    cslot = hash_find(state.keys, _probe(cold_ids, rank, num_shards))
    cfound = cslot < cap
    cold_w = gather.gather_rows(state.weights, cslot, cfound)
    cold_s = {k: gather.gather_rows(v, cslot, cfound)
              for k, v in state.slots.items()}
    hprobe = _probe(hot_ids, rank, num_shards)
    hslot = hash_find(state.keys, hprobe)
    hfound = hslot < cap
    hot_w = gather.gather_rows(state.weights, hslot, hfound)
    hot_s = {k: gather.gather_rows(v, hslot, hfound)
             for k, v in state.slots.items()}
    refresh(state)
    slot, overflow = hash_find_or_insert(state.keys, hprobe)
    ok = hfound & (slot < cap)
    _write_rows(state, slot, ok, hot_w, hot_s)
    lost = hfound & (slot >= cap)
    return cfound, cold_w, cold_s, ok, lost, hot_w, hot_s, overflow


def read_resident(state) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Every resident (id, row, slot rows) of the cache, through the gather
    kernel -> host float32 (ids in slot order)."""
    sel = torch.nonzero(state.keys >= 0).squeeze(1)
    ids = state.keys.index_select(0, sel)
    w = gather.gather_rows(state.weights, sel)
    s = {k: gather.gather_rows(v, sel) for k, v in state.slots.items()}
    return (ids.cpu().numpy(), _host32(w),
            {k: _host32(v) for k, v in s.items()})


def _host32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).cpu().numpy()


def _pad_none(a: np.ndarray) -> np.ndarray:
    return a if a.size else np.full((1,), EMPTY, np.int64)


class HostOffloadTable:
    """Owns the device cache between steps; see the module docstring for the
    prepare -> step protocol. `capacity` = the cache's slots (the spec's),
    the store is unbounded (host RAM). `device`: the cache's device on one
    device; with `mesh` (a `parallel.Mesh`) this rank's shard of the
    row-sharded cache on the mesh's device. `device` None is the CUDA card
    (raises without one)."""

    def __init__(self, spec, optimizer, *, seed: int = 0,
                 high_water: float = 0.6, mesh=None, device=None,
                 eviction: str = "clock", pipeline: bool = False,
                 stage_depth: int = 1, densify_k: int = 1):
        if not spec.use_hash_table:
            raise ValueError("host offload needs a hash-table spec "
                             "(input_dim=-1 + capacity)")
        if not 0 < high_water <= 1:
            raise ValueError("high_water in (0, 1]")
        if eviction not in ("clock", "flush"):
            raise ValueError("eviction must be 'clock' or 'flush'")
        if int(densify_k) < 1:
            raise ValueError("densify_k >= 1 (1 = merge every writeback)")
        if int(stage_depth) < 1:
            raise ValueError("stage_depth >= 1 (1 = single staging slot)")
        from ..embedding import init_table_state
        self.spec = spec
        self.optimizer = optimizer
        self.seed = seed
        self.high_water = high_water
        self.eviction = eviction
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.num_shards = mesh.size if mesh is not None else 1
        if mesh is not None:
            self.device = torch.device(mesh.device)
        else:
            from ..device import resolve_device
            self.device = resolve_device(device)
        self.state = init_table_state(spec, optimizer, self._generator(),
                                      num_shards=self.num_shards)
        self.rows_per_shard = int(self.state.keys.shape[0])
        self.capacity = self.rows_per_shard * self.num_shards
        self.store = HostStore(spec.output_dim,
                               optimizer.slot_shapes(spec.output_dim))
        # residency: sorted ids (every rank's shards, the same on every
        # rank), each with its clock bit, set when a prepare() touches it
        self._resident_sorted = np.empty((0,), np.int64)
        self._ref = np.empty((0,), bool)
        self._shard_counts = np.zeros((self.num_shards,), np.int64)
        # the overflow of earlier caches: the device counter restarts at 0
        # at every reset, the dropped ids stay counted
        self._overflow_flushed = 0
        self.densify_k = int(densify_k)
        self._defer_count = 0
        self.counters = collections.Counter()
        self._counters_lock = threading.Lock()
        self.timings: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=TIMING_SAMPLES))
        # pipelined staging: a ring of up to `stage_depth` futures, oldest
        # first: (raw ids copy, epoch, store version, ring slot, Future).
        # The ring and its counters belong to the training thread; the
        # worker runs the submitted closure, which touches the store (its
        # own lock) and the card (its own stream), never the ring.
        self.pipeline = bool(pipeline)
        self.stage_depth = int(stage_depth)
        self._epoch = 0
        self._stage_ring: collections.deque = collections.deque()
        self._stage_seq = 0
        self.pipe_hits = 0
        self.pipe_misses = 0
        self.slot_hits: Dict[int, int] = {}
        self.slot_misses: Dict[int, int] = {}
        self._stage_pool = None
        self._stage_stream = None
        if self.pipeline:
            from concurrent.futures import ThreadPoolExecutor
            self._stage_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"oetpu-stage-{spec.name}")

    def _generator(self) -> torch.Generator:
        """The table's generator, seeded as `Trainer.init` seeds it (this
        rank's shard on the mesh)."""
        from ..model import _table_generator
        return _table_generator(self.seed, self.spec, self.device,
                                (self.rank, self.num_shards))

    def _refresh(self, state) -> None:
        """The fresh template written into `state`'s own tensors: empty keys,
        the initializer's rows (drawn again from the seeded generator, bit
        for bit the first draw), the optimizer's initial slots."""
        from ..embedding import init_table
        state.keys.fill_(EMPTY)
        state.weights.copy_(init_table(self.spec, self._generator(),
                                       self.num_shards))
        for k, v in state.slots.items():
            v.fill_(self.optimizer.slot_init(k))

    # -- residency ------------------------------------------------------------

    @property
    def resident_count(self) -> int:
        return int(self._resident_sorted.size)

    def is_resident(self, id_: int) -> bool:
        i = int(np.searchsorted(self._resident_sorted, id_))
        return (i < self._resident_sorted.size
                and int(self._resident_sorted[i]) == int(id_))

    def resident_ids(self) -> np.ndarray:
        return self._resident_sorted.copy()

    @property
    def total_overflow(self) -> int:
        """Ids dropped over the table's life, across cache resets (reads the
        device counter)."""
        return self._overflow_flushed + int(self.state.overflow)

    def adopt(self, table_state) -> None:
        """Take the table state the trainer holds (the same object unless
        the caller swapped it)."""
        self.state = table_state

    def device_cache_bytes(self) -> int:
        """Bytes of this rank's cache: its weights, slots and keys and the
        overflow counter (the store is `store.nbytes()`, host memory)."""
        rows = self.rows_per_shard
        item = self.state.weights.element_size()
        widths = sum(self.optimizer.slot_shapes(
            self.spec.output_dim).values())
        return (rows * self.spec.output_dim * item + rows * 4 * widths
                + rows * 8 + 4)

    def _time(self, part: str, t0: float) -> float:
        now = time.perf_counter()
        self.timings[part].append((now - t0) * 1e3)
        return now

    def _would_exceed(self, new_ids: np.ndarray) -> bool:
        """Per-shard high-water check (owner shard = id % S): a hot shard can
        fill while the whole cache is not."""
        counts = self._shard_counts + np.bincount(
            new_ids % self.num_shards, minlength=self.num_shards)
        return bool((counts > self.high_water * self.rows_per_shard).any())

    @staticmethod
    def _split_batch(flat: np.ndarray, resident: np.ndarray):
        """A unique sorted id batch against a residency snapshot -> (clipped
        positions, hit mask, the non-resident ids)."""
        if resident.size:
            pos = np.searchsorted(resident, flat)
            pos_c = np.minimum(pos, resident.size - 1)
            hit = resident[pos_c] == flat
            return pos_c, hit, flat[~hit]
        return (np.zeros((0,), np.int64), np.zeros((flat.size,), bool), flat)

    @staticmethod
    def _unique(ids) -> np.ndarray:
        """The batch's distinct non-negative ids, sorted."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        flat = np.unique(np_ids_as_int64(ids))
        return flat[flat >= 0]

    def _union(self, ids) -> np.ndarray:
        """`_unique`; on the mesh the union over every rank's batch (a
        collective)."""
        flat = self._unique(ids)
        if self.num_shards > 1:
            from ..parallel.multihost import allgather_host_ids
            flat = allgather_host_ids(flat, self.mesh)
        return flat

    # -- admission --------------------------------------------------------------

    def _staged_payload(self, new: np.ndarray, staged: bool = False):
        """Store lookup and upload for the `new` ids this rank owns -> (their
        positions in `new`, ids, weights, {slot: rows}, known; on the card,
        and the event after the upload when `staged` (the worker's side
        stream, through pinned memory)). The upload bytes go to
        `counters["staged_bytes"]`."""
        t0 = time.perf_counter()
        pos = (np.arange(new.size) if self.num_shards == 1
               else np.flatnonzero(new % self.num_shards == self.rank))
        mine = new[pos]
        known, w, s = self.store.lookup(mine)
        t0 = self._time("stage_lookup" if staged else "lookup", t0)
        host = {"ids": mine, "w": w, "known": known,
                **{f"s/{k}": v for k, v in s.items()}}
        nbytes = sum(a.nbytes for a in host.values())
        with self._counters_lock:  # the staging worker adds here too
            self.counters["staged_bytes"] += nbytes
        metrics.observe("offload.staged_bytes", float(nbytes))
        event = None
        if staged and self.device.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self.device)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stage_stream):
                dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(self._stage_stream)
        else:
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in host.items()}
        self._time("stage_upload" if staged else "upload", t0)
        return (pos, dev["ids"], dev["w"],
                {k: dev[f"s/{k}"] for k in s}, dev["known"], event)

    def _admit_ids(self, new: np.ndarray, payload, *,
                   stage_s: float = 0.0) -> None:
        """Admission of a payload, and the residency of the `new` ids it
        covers (summed over the ranks on the mesh)."""
        t0 = time.perf_counter()
        pos, ids, w, s, known, event = payload
        if event is not None:
            # never read a half-copied payload; the tensors were made on the
            # worker's stream and are read on this one
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in (ids, w, known, *s.values()):
                t.record_stream(current)
        with metrics.vtimer("offload", "admit"):
            adm_local, overflow = admit_rows(self.state, ids, w, s, known,
                                             rank=self.rank,
                                             num_shards=self.num_shards)
        # rows this rank took back from its store
        self.counters["readmitted"] += int((adm_local & known).sum())
        if self.num_shards > 1:
            from ..parallel import collectives as coll
            flags = torch.zeros((new.size + 1,), dtype=torch.int32,
                                device=self.device)
            flags[torch.from_numpy(pos).to(self.device)] = adm_local.to(
                torch.int32)
            flags[-1] = overflow
            flags = coll.psum(self.mesh, flags).cpu().numpy()
            admitted, overflow = flags[:-1] > 0, int(flags[-1])
        else:
            admitted = adm_local.cpu().numpy()
        self.state.overflow.add_(overflow)
        got = new[admitted]
        # a sorted merge: `got` is a subset of np.unique's output
        at = np.searchsorted(self._resident_sorted, got)
        self._resident_sorted = np.insert(self._resident_sorted, at, got)
        # fresh admits enter unreferenced: a one-shot id is evictable at the
        # next pressure round, a recurring one gets its bit at the top of its
        # next prepare(), which runs before any eviction
        self._ref = np.insert(self._ref, at, False)
        self._shard_counts += np.bincount(got % self.num_shards,
                                          minlength=self.num_shards)
        self._epoch += 1  # residency changed: staged lookups are stale
        self.counters["admitted"] += int(admitted.sum())
        metrics.observe("offload.admitted", int(admitted.sum()))
        self._time("admit", t0)
        if stage_s:
            # the share of the staging work that ran in the step's shadow
            admit_s = time.perf_counter() - t0
            self.counters["overlap_ratio"] = stage_s / (stage_s + admit_s
                                                        + 1e-12)
            metrics.observe("offload.overlap_ratio",
                            self.counters["overlap_ratio"], "gauge")

    def stage(self, ids) -> None:
        """Stage ahead: a future batch's store lookup and upload on the
        worker while the current step computes (no-op without
        `pipeline=True`). Up to `stage_depth` batches ride the ring; the
        oldest is dropped (a miss) when a new one would exceed it. On the
        mesh the union over the ranks is taken here, on the calling
        thread (a collective); on one device the worker dedups too."""
        if not self.pipeline:
            return
        raw = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
               else np.array(ids, copy=True))
        # on one device the worker dedups; the mesh's union is a collective
        union = self._union(raw) if self.num_shards > 1 else None
        epoch = self._epoch
        sver = self.store.version
        resident = self._resident_sorted  # replaced, never mutated: shared

        def work():
            t0 = time.perf_counter()
            with metrics.vtimer("offload", "stage"):
                flat = union if union is not None else self._unique(raw)
                pos_c, hit, new = self._split_batch(flat, resident)
                payload = self._staged_payload(new, staged=True) \
                    if new.size else None
            return {"flat": flat, "pos_c": pos_c, "hit": hit, "new": new,
                    "payload": payload,
                    "stage_s": time.perf_counter() - t0}

        while len(self._stage_ring) >= self.stage_depth:
            # drop the oldest: staged and never consumed
            _, _, _, slot, fut = self._stage_ring.popleft()
            fut.result()
            self._pipe_miss(slot)
        slot = self._stage_seq % self.stage_depth
        self._stage_seq += 1
        self._stage_ring.append(
            (raw, epoch, sver, slot, self._stage_pool.submit(work)))

    def _pipe_hit(self, slot: int) -> None:
        self.pipe_hits += 1
        self.slot_hits[slot] = self.slot_hits.get(slot, 0) + 1
        metrics.observe("offload.pipeline_hits", 1)
        self._observe_occupancy()

    def _pipe_miss(self, slot: int) -> None:
        self.pipe_misses += 1
        self.slot_misses[slot] = self.slot_misses.get(slot, 0) + 1
        metrics.observe("offload.pipeline_misses", 1)
        self._observe_occupancy()

    def _observe_occupancy(self) -> None:
        occ = self.pipeline_occupancy
        if "all" in occ:
            metrics.observe("offload.pipeline_occupancy", occ["all"],
                            "gauge")
        for slot, v in occ.items():
            if slot != "all":
                metrics.observe("offload.pipeline_occupancy", v, "gauge",
                                labels={"slot": slot})

    @property
    def pipeline_occupancy(self) -> Dict[str, float]:
        """The staged payloads' hit rate: overall and per ring slot."""
        out = {}
        total = self.pipe_hits + self.pipe_misses
        if total:
            out["all"] = self.pipe_hits / total
        for slot in sorted(set(self.slot_hits) | set(self.slot_misses)):
            h = self.slot_hits.get(slot, 0)
            out[str(slot)] = h / (h + self.slot_misses.get(slot, 0))
        return out

    def _take_staged(self, ids):
        """The staged result if a ring entry matches this prepare and is
        still valid, else None. Entries staged for other batches ahead of
        the match are popped as misses; entries behind it stay. Valid: the
        residency epoch and the store version unchanged; where only the
        residency moved, the batch is split again against the current
        residency and taken iff its non-resident ids are unchanged (the
        staged store rows then still cover the admission exactly)."""
        now = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
               else np.asarray(ids))
        while self._stage_ring:
            raw, epoch, sver, slot, fut = self._stage_ring.popleft()
            res = fut.result()  # the worker is done with shared state
            if (raw.shape != now.shape or raw.dtype != now.dtype
                    or not np.array_equal(raw, now)):
                self._pipe_miss(slot)
                continue
            if epoch == self._epoch and sver == self.store.version:
                res["slot"] = slot
                return res
            if sver == self.store.version:
                pos_c, hit, new = self._split_batch(res["flat"],
                                                    self._resident_sorted)
                if np.array_equal(new, res["new"]):
                    return dict(res, pos_c=pos_c, hit=hit, slot=slot)
            self._pipe_miss(slot)
            return None
        return None

    def prepare(self, ids) -> None:
        """Make the cache ready for a batch (numpy ids, or a tensor read back
        to the host): evict or flush where needed, admit the ids that are
        not resident. Call before the train step.

        Over the high-water mark with `eviction="clock"`: the cold residents
        (untouched since the last eviction) move to the store and the hot
        rows stay on the card (`evict_cold`); the whole-cache flush only
        where the hot set leaves no room. With `pipeline=True` a matching
        staged payload is consumed (its lookup and upload already done).

        On the mesh the union comes first, on every rank: a staged hit on
        one rank and a miss on another then run the same collectives."""
        t0 = time.perf_counter()
        flat = self._union(ids) if self.num_shards > 1 else None
        staged = self._take_staged(ids)
        if staged is not None:
            flat, new, hit = staged["flat"], staged["new"], staged["hit"]
            self._time("split", t0)
            if hit.any():
                self._ref[staged["pos_c"][hit]] = True  # the batch's: hot
            self._pipe_hit(staged["slot"])
            if new.size == 0:
                return
            if not self._would_exceed(new):
                self._admit_ids(new, staged["payload"],
                                stage_s=staged["stage_s"])
                return
            # eviction rewrites the residency and the store: the tail of the
            # synchronous path (rare: occupancy crossing the mark)
            self._pressure(new, flat)
            return
        if flat is None:
            flat = self._union(ids)
        pos_c, hit, new = self._split_batch(flat, self._resident_sorted)
        if hit.any():
            self._ref[pos_c[hit]] = True  # the batch's residents are hot
        self._time("split", t0)
        if new.size == 0:
            return
        if self._would_exceed(new):
            self._pressure(new, flat)
            return
        self._admit_ids(new, self._staged_payload(new))

    def _pressure(self, new: np.ndarray, flat: np.ndarray) -> None:
        """The over-the-mark tail of prepare(): evict or flush, then admit
        what the batch still needs (the whole batch after a flush, which
        evicted its resident ids too)."""
        if self.eviction == "clock":
            self.evict_cold()
        if self.eviction != "clock" or self._would_exceed(new):
            self.flush()
            new = flat
        per_shard = self._shard_counts + np.bincount(
            new % self.num_shards, minlength=self.num_shards)
        if per_shard.max(initial=0) > self.rows_per_shard:
            warnings.warn(
                f"batch puts {int(per_shard.max())} unique ids on one "
                f"shard (> {self.rows_per_shard} slots); the device cache "
                "cannot hold one batch and some rows will overflow — "
                "raise `capacity` or shrink the batch", RuntimeWarning)
        self._admit_ids(new, self._staged_payload(new))

    def _store_write(self, ids: np.ndarray, weights: np.ndarray,
                     slots: Dict[str, np.ndarray]) -> None:
        """Evicted rows into the store: a merge at densify_k=1, else
        deferred, K writebacks folded into one merge (`HostStore.drain`)."""
        if self.densify_k <= 1:
            self.store.merge(ids, weights, slots)
            return
        self.store.defer(ids, weights, slots)
        self._defer_count += 1
        if self._defer_count >= self.densify_k:
            with metrics.vtimer("offload", "drain"):
                merged = self.store.drain()
            self.counters["drained_rows"] += merged
            self._defer_count = 0
            self.counters["densified_merges"] += 1
            metrics.observe("offload.densified_merges", 1)
            metrics.observe("offload.drained_rows", merged)

    def evict_cold(self) -> int:
        """Clock eviction: the residents whose bit is clear move to the store,
        the cache is rebuilt keeping the hot rows on the card, and the
        survivors' bits clear. Returns the rows this rank evicted."""
        cold = self._resident_sorted[~self._ref]
        hot = self._resident_sorted[self._ref]
        if cold.size == 0:
            return 0
        t0 = time.perf_counter()
        dev = self.device
        with metrics.vtimer("offload", "evict"):
            (cfound, cw, cs, kept, lost, hw, hs,
             overflow) = evict_rows(
                self.state, torch.from_numpy(cold).to(dev),
                torch.from_numpy(_pad_none(hot)).to(dev), self._refresh,
                rank=self.rank, num_shards=self.num_shards)
            cfound = cfound.cpu().numpy()
            self._store_write(
                cold[cfound], _host32(cw)[cfound],
                {k: _host32(v)[cfound] for k, v in cs.items()})
        nh = hot.size
        lost = lost.cpu().numpy()[:nh]
        if lost.any():
            # hot rows whose re-insert overflowed: to the store, admitted
            # again at their next appearance
            self._store_write(
                hot[lost], _host32(hw)[:nh][lost],
                {k: _host32(v)[:nh][lost] for k, v in hs.items()})
        if self.num_shards > 1:
            from ..parallel import collectives as coll
            flags = torch.cat([kept[:max(nh, 1)].to(torch.int32),
                               overflow.reshape(1)])
            flags = coll.psum(self.mesh, flags).cpu().numpy()
            kept, overflow = flags[:-1] > 0, int(flags[-1])
        else:
            kept = kept.cpu().numpy()
        self.state.overflow.add_(overflow)
        survivors = np.sort(hot[kept[:nh]])
        self._resident_sorted = survivors
        self._ref = np.zeros((survivors.size,), bool)  # second chance expired
        self._shard_counts = np.bincount(
            survivors % self.num_shards, minlength=self.num_shards
        ).astype(np.int64)
        self._epoch += 1  # residency and store changed
        self.counters["evictions"] += 1
        self.counters["evicted_cold"] += int(cfound.sum())
        self.counters["kept_hot"] += int(survivors.size)
        metrics.observe("offload.evicted_cold", int(cfound.sum()))
        metrics.observe("offload.kept_hot", int(survivors.size))
        self._time("evict", t0)
        return int(cfound.sum())

    def sync_to_store(self) -> None:
        """Every resident row written back to the store without resetting the
        cache: a consistent whole table for a checkpoint or a persist while
        training goes on."""
        # drain first: pending chunks hold older values than the device rows
        # merged next
        with metrics.vtimer("offload", "sync"):
            self.counters["drained_rows"] += self.store.drain()
            self._defer_count = 0
            ids, w, s = read_resident(self.state)
            if ids.size:
                self.counters["resident_reads"] += 1
            self.store.merge(ids, w, s)

    def flush(self) -> None:
        """The whole cache to the store, and the cache reset."""
        t0 = time.perf_counter()
        with metrics.vtimer("offload", "flush"):
            self.sync_to_store()
            self.reset_cache()
        self.counters["flushes"] += 1
        metrics.observe("offload.flushes", 1)
        self._time("flush", t0)

    def reset_cache(self) -> None:
        """A fresh cache and an empty residency, in place, without writing to
        the store (a checkpoint load: the store was just replaced). The
        device counter restarts at 0; its value is banked first."""
        self._overflow_flushed += int(self.state.overflow)
        self._refresh(self.state)
        self.state.overflow.zero_()
        self._resident_sorted = np.empty((0,), np.int64)
        self._ref = np.empty((0,), bool)
        self._shard_counts[:] = 0
        self._epoch += 1

    def load_store(self, ids: np.ndarray, weights: np.ndarray,
                   slots: Dict[str, np.ndarray]) -> None:
        """Checkpoint restore: the store replaced and the cache reset.
        Optimizer slots missing from the files (include_optimizer=False)
        take their initial values."""
        full = {}
        n = len(ids)
        for k, width in self.optimizer.slot_shapes(
                self.spec.output_dim).items():
            full[k] = (np.asarray(slots[k], np.float32) if k in slots else
                       np.full((n, width), self.optimizer.slot_init(k),
                               np.float32))
        self.store.replace_all(np.asarray(ids, np.int64),
                               np.asarray(weights, np.float32), full)
        self._defer_count = 0  # replace_all dropped the pending chunks
        self.reset_cache()

    def lookup_anywhere(self, ids) -> np.ndarray:
        """Rows wherever they live (absent ids: zeros): the residents written
        back, then a store read. On the mesh every rank calls it with the
        same ids (a collective: each reads its own store). For eval and
        export, not the hot path."""
        self.sync_to_store()
        raw = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
               else np.asarray(ids))
        flat = np_ids_as_int64(raw)
        out_shape = (raw.shape[:-1] if raw.dtype == np.uint32
                     and raw.ndim >= 1 and raw.shape[-1] == 2 else raw.shape)
        _, rows, _ = self.store.lookup(flat)
        if self.num_shards > 1:
            from ..parallel import collectives as coll
            every = coll.all_gather_tiled(self.mesh, torch.from_numpy(
                np.ascontiguousarray(rows)).reshape(-1).to(self.device))
            every = every.reshape(self.num_shards, *rows.shape).cpu().numpy()
            rows = every[np.where(flat >= 0, flat % self.num_shards, 0),
                         np.arange(flat.size)]
        return rows.reshape(tuple(out_shape) + (self.spec.output_dim,))

    def close(self) -> None:
        """Stop the staging worker (its pending stages are dropped)."""
        if self._stage_pool is not None:
            self._stage_pool.shutdown(wait=True)
            self._stage_pool = None
            self._stage_ring.clear()
