"""Frequent async persistence: the port of `openembedding_tpu/persist.py`,
the counterpart of the reference's Intel PMem backend.

The reference keeps its tables in persistent memory and commits a
checkpoint by flushing a pending window and writing a marker per `work_id`
(`PmemEmbeddingTable.h:236-300`; API `exb.py:697-705`:
`should_persist_server_model`, `persist_server_model(path, window)`,
`restore_server_model`). A card has no persistent memory, so a persist is
a card -> host -> disk pipeline: `persist()` copies the state to host
memory before it returns (the next steps update the live tensors in
place) and a writer thread writes it to disk. A bounded queue of `window`
pending writes is the reference's pending window: a persist past it waits
(backpressure) and nothing is dropped.

Commit protocol: every rank writes its part into `<root>/<name>.writing`
and drops a `done.<rank>` marker; rank 0 alone, once every marker is
there, renames the directory into place and writes the `COMMIT` file
last. A restore reads only committed directories, so a crash mid-write is
never restored. The write path runs no collective: it would interleave
with the training loop's. The collectives a persist needs (the
touched-set union, the ZeRO unshard, the hot rows' write-back) run on the
calling thread inside `persist()`, at the same step on every rank.

Incremental persistence (`IncrementalPersister`): a full base every
`full_every` persists and, in between, `delta_<step>` directories holding
only the rows the batches touched since the last persist (read on the
card through the gather kernel, `ops/gather.gather_rows`) and the small
dense tree, chained by parent pointers under the same commit protocol; a
restore loads the base and replays the chain's consistent prefix. The
on-disk formats are the JAX package's: a root written by either package
restores in the other, at any mesh size and on one device.

Rank and mesh size come from the trainer's mesh (`parallel.MeshTrainer`;
a single-device `Trainer` is rank 0 of 1).

Host-cached tables (`storage="host_cached"`, `tables/host_offload.py`): a
full persist writes each table's whole host store (the residents written
back first, `Trainer.offload_store_snapshots`: a decoupled copy, taken
after the earlier writes have drained, so at most one store copy waits),
and an `IncrementalPersister` of such a trainer persists in full every
time (its tables' touched rows are not tracked, as in the JAX package). A
restore loads the stores and resets the caches; a delta replays into the
store.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import shutil
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

COMMIT_FILE = "COMMIT"
_PERSIST_RE = re.compile(r"persist_(\d+)$")


class PersistPolicy:
    """When to persist: every N steps and/or every T seconds (the
    reference's `should_persist` signal comes from PMem cache occupancy; a
    card's table has no such pressure, so the policy counts steps and
    time)."""

    def __init__(self, every_steps: int = 0, every_seconds: float = 0.0):
        if every_steps <= 0 and every_seconds <= 0:
            raise ValueError("set every_steps and/or every_seconds")
        self.every_steps = every_steps
        self.every_seconds = every_seconds
        self._last_step = 0
        self._last_time = time.monotonic()

    def should_persist(self, step: int) -> bool:
        if self.every_steps > 0 and step - self._last_step >= self.every_steps:
            return True
        if (self.every_seconds > 0
                and time.monotonic() - self._last_time >= self.every_seconds):
            return True
        return False

    def mark(self, step: int) -> None:
        self._last_step = step
        self._last_time = time.monotonic()


def _committed(root: str, pattern) -> List[Tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = pattern.match(name)
        path = os.path.join(root, name)
        if m and os.path.exists(os.path.join(path, COMMIT_FILE)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def list_persists(root: str) -> List[Tuple[int, str]]:
    """(step, path) of committed full persists, oldest first."""
    return _committed(root, _PERSIST_RE)


def latest_persist(root: str) -> Optional[str]:
    persists = list_persists(root)
    return persists[-1][1] if persists else None


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(dirpath, f))
    return total


def _rank_and_size(mesh) -> Tuple[int, int]:
    return (mesh.rank, mesh.size) if mesh is not None else (0, 1)


class AsyncPersister:
    """Card -> host -> disk checkpoint pipeline with pending-window
    backpressure.

        persister = AsyncPersister(trainer, model, root, window=2)
        for batch in data:
            state, m = step(state, batch)
            persister.maybe_persist(state)     # policy-driven
        persister.close()

    Each persist copies this rank's whole state to pinned host memory
    (`parallel.checkpoint.snapshot_addressable`: one copy a tensor in
    stream order, then one synchronization) and queues the write. Host
    memory: up to `window` queued snapshots, the one being written and the
    one a blocked `persist()` holds, each the rank's tables, slots,
    residuals and dense state (the flagship 2^24 x 10 float32 table with
    its Adagrad accumulator: 1.34 GB). A failed write surfaces as a
    RuntimeError at the next `persist`, `wait` or `close`.

    At S > 1 ranks every rank persists at the same steps (a step-driven
    policy; a wall-clock one is refused), `wait()` and `close()` end at a
    barrier (rank 0's commit is done when they return), and `history`
    holds what each persist cost on this rank: its kind, step, ms until
    `persist()` returned, the write's ms and, on rank 0, the committed
    bytes."""

    def __init__(self, trainer, model, root: str, *, window: int = 2,
                 keep: int = 2, include_optimizer: bool = True,
                 policy: Optional[PersistPolicy] = None,
                 commit_timeout: float = 600.0, prune_deltas: bool = True):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.mesh = getattr(trainer, "mesh", None)
        self.rank, self.num_shards = _rank_and_size(self.mesh)
        if self.num_shards > 1 and policy is not None \
                and policy.every_seconds > 0:
            # persist() runs collectives (the touched-set union, the ZeRO
            # unshard): a wall-clock policy fires at different steps on
            # different ranks, and one rank would wait there alone
            raise ValueError(
                "persisters over several ranks need a step-driven policy "
                "(every_steps): wall-clock policies fire at different "
                "steps on different ranks, and persist() runs collectives "
                "(the touched-id union, the ZeRO unshard)")
        self.trainer = trainer
        self.model = model
        self.root = root
        self.keep = keep
        self.prune_deltas = prune_deltas
        self.include_optimizer = include_optimizer
        self.commit_timeout = commit_timeout
        self.policy = policy or PersistPolicy(every_steps=1000)
        self.history: List[Dict] = []
        os.makedirs(root, exist_ok=True)
        # partial attempts of a crashed earlier run go now, before any rank
        # of this run can write: the barrier keeps a faster rank from
        # writing into a directory rank 0 is about to remove
        if self.rank == 0:
            for pat in ("persist_*.writing", "delta_*.writing"):
                for d in glob.glob(os.path.join(root, pat)):
                    shutil.rmtree(d, ignore_errors=True)
        self._barrier()
        self._q: "queue.Queue" = queue.Queue(maxsize=window)
        self._error: Optional[BaseException] = None
        self._close_mu = threading.Lock()
        self._closed = False  # guarded by self._close_mu
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _barrier(self) -> None:
        if self.num_shards > 1:
            from .parallel import collectives
            collectives.barrier(self.mesh)

    # -- producer side --------------------------------------------------------

    def should_persist(self, step: int) -> bool:
        """The reference's `should_persist_server_model`."""
        return self.policy.should_persist(int(step))

    def maybe_persist(self, state, batch=None) -> bool:
        """`batch` is accepted (and ignored) so that call sites drive both
        persisters alike."""
        del batch
        if not self.should_persist(int(state.step)):
            return False
        self.persist(state)
        return True

    def persist(self, state) -> str:
        """Copy the state to host memory now and queue its write; blocks
        only while `window` writes are pending (the reference's
        `persist_server_model(path, window)`). The placement's rows are
        written back into their shards first and ZeRO's dense slots
        unsharded (`trainer.externalize`), so the files equal a run's
        without either."""
        self._raise_pending_error()
        t0 = time.perf_counter()
        return self._persist_full(self.trainer.externalize(state), t0)

    def _persist_full(self, state, t0: float) -> str:
        from .parallel.checkpoint import snapshot_addressable
        step = int(state.step)
        stores = {}
        if getattr(self.trainer, "offload", None):
            # a store copy is the whole table: drain the earlier writes
            # first, so at most one copy waits (the device window stays)
            self._q.join()
            self._raise_pending_error()
            stores = self.trainer.offload_store_snapshots(state)
        snapshot = snapshot_addressable(state)
        path = os.path.join(self.root, f"persist_{step:012d}")
        record = {"kind": "full", "step": step}
        self._submit(lambda tmp: self._write_full_payload(snapshot, stores,
                                                          tmp),
                     step, path, record, t0)
        return path

    def _submit(self, write_cb, step: int, path: str, record: Dict,
                t0: float) -> None:
        record["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        self.history.append(record)
        self._q.put((write_cb, step, path, record))  # waits when full
        self.policy.mark(step)

    # -- writer thread --------------------------------------------------------

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # balances the sentinel's put: a wait() after this close
                # would otherwise block on a task never marked done
                self._q.task_done()
                return
            write_cb, step, path, record = item
            try:
                t0 = time.perf_counter()
                record["bytes"] = self._write_one(write_cb, step, path)
                record["write_ms"] = (time.perf_counter() - t0) * 1e3
                if self.rank == 0:
                    self._gc()
            except BaseException as e:  # noqa: BLE001 — raised to the producer
                self._error = e
            finally:
                self._q.task_done()

    def _write_full_payload(self, snapshot, stores, tmp: str) -> None:
        if self.num_shards > 1:
            from .parallel.checkpoint import save_sharded
            save_sharded(snapshot, self.model, tmp,
                         num_shards=self.num_shards, rank=self.rank,
                         include_optimizer=self.include_optimizer,
                         offload_stores=stores)
        else:
            from .checkpoint import save_server_model
            save_server_model(snapshot, self.model, tmp,
                              include_optimizer=self.include_optimizer,
                              offload_stores=stores)

    def _write_one(self, write_cb, step: int, path: str) -> Optional[int]:
        """Write this rank's part into `<path>.writing`, then commit: every
        rank drops `done.<rank>`; rank 0 alone, once every marker is there,
        renames the directory into place and writes COMMIT last, so no
        rank commits (or collects) a persist another is still writing.
        Returns the committed bytes on rank 0 (None elsewhere)."""
        tmp = f"{path}.writing"
        write_cb(tmp)
        with open(os.path.join(tmp, f"done.{self.rank}"), "w") as f:
            f.write(str(step))
        if self.rank != 0:
            return None
        deadline = time.monotonic() + self.commit_timeout
        while True:
            done = [r for r in range(self.num_shards)
                    if os.path.exists(os.path.join(tmp, f"done.{r}"))]
            if len(done) == self.num_shards:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"persist commit: only {len(done)}/{self.num_shards} "
                    f"ranks finished writing {tmp!r} within "
                    f"{self.commit_timeout}s")
            time.sleep(0.05)
        # a directory already at `path` (a crash between the rename and
        # COMMIT, or a committed persist of this step from an earlier run)
        # would fail the rename forever: the new persist supersedes it
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(os.path.join(path, COMMIT_FILE), "w") as f:
            f.write(str(step))
        return _dir_bytes(path)

    def _gc(self) -> None:
        """Retention after every commit (rank 0): keep the newest `keep`
        full persists and, unless `prune_deltas=False`, drop every delta at
        or below the newest full's step (the chain anchors at the newest
        full, so they are never replayed again). The opt-out is for sync
        publishers that keep history for slow subscribers; with pruning
        on, size `full_every * keep` to their worst lag."""
        persists = list_persists(self.root)
        if self.prune_deltas and persists:
            newest_full = persists[-1][0]
            for step, path in list_deltas(self.root):
                if step <= newest_full:
                    shutil.rmtree(path, ignore_errors=True)
        for _, path in persists[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(path, ignore_errors=True)

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async persist failed: {e}") from e

    # -- lifecycle ------------------------------------------------------------

    def wait(self) -> None:
        """Drain the pending writes (the reference's dump waits its async
        tasks); at S > 1 then a barrier, so every commit is done."""
        self._q.join()
        self._barrier()
        self._raise_pending_error()

    def close(self) -> None:
        """Idempotent, racing closes included: the first caller drains and
        stops the writer, later ones wait for it."""
        with self._close_mu:
            first, self._closed = not self._closed, True
        if not first:
            self._thread.join(timeout=30)
            return
        try:
            self.wait()
        finally:
            # the writer stops even when wait() raises a deferred error, or
            # the thread and its queued snapshots would leak
            self._q.put(None)
            self._thread.join(timeout=30)

    def __enter__(self) -> "AsyncPersister":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- restore --------------------------------------------------------------

    def restore(self, state):
        return restore_server_model(state, self.model, self.root,
                                    trainer=self.trainer)


# -- incremental (dirty-window) persistence -----------------------------------

_DELTA_RE = re.compile(r"delta_(\d+)$")
DELTA_FORMAT = "oetpu-delta-v1"


def list_deltas(root: str) -> List[Tuple[int, str]]:
    """(step, path) of committed deltas, oldest first."""
    return _committed(root, _DELTA_RE)


def delta_chain(root: str) -> Tuple[Optional[str], List[str]]:
    """-> (base persist path, [delta paths to replay in order]).

    The newest committed full persist anchors the chain; committed deltas
    newer than it are walked by parent pointer, and the walk stops at the
    first break (a missing or uncommitted link): the consistent prefix
    restores the state at its last link's step, never a torn mix."""
    base = latest_persist(root)
    if base is None:
        return None, []
    parent = list_persists(root)[-1][0]
    chain = []
    for step, path in list_deltas(root):
        if step <= parent:
            continue
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            break
        if meta.get("parent") != parent or meta.get("format") != DELTA_FORMAT:
            break
        chain.append(path)
        parent = step
    return base, chain


class DirtyTracker:
    """The ids each table's batches touched since the last persist, kept on
    the host from the input stream (where the reference's client knows its
    pull ids, `EmbeddingPullOperator.cpp:60-112`). `observe` dedups one
    batch (O(batch log batch)) and appends; the union across batches waits
    for `take`, once a persist. It applies the model's `batch_transform`
    as the step does. Give it the host batch (numpy or CPU tensors): a
    CUDA batch is read back to the host, which waits for the card."""

    def __init__(self, model):
        self._feats = {name: spec.feature_name
                       for name, spec in model.ps_specs().items()
                       if spec.storage != "host_cached"}
        self._transform = getattr(model, "batch_transform", None)
        self._chunks: Dict[str, List[np.ndarray]] = {
            name: [] for name in self._feats}
        self.observed = 0

    @staticmethod
    def _host_view(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def observe(self, batch) -> None:
        if self._transform is not None:
            batch = self._transform(batch)
        for name, feat in self._feats.items():
            ids = np.unique(self._host_view(batch["sparse"][feat])
                            .astype(np.int64, copy=False))
            ids = ids[ids >= 0]
            if ids.size:
                self._chunks[name].append(ids)
        self.observed += 1

    def take(self) -> Dict[str, np.ndarray]:
        """-> {table: sorted unique int64 ids}; starts a new window."""
        out = {name: (np.unique(np.concatenate(chunks)) if chunks
                      else np.empty((0,), np.int64))
               for name, chunks in self._chunks.items()}
        self._chunks = {name: [] for name in self._feats}
        self.observed = 0
        return out


def read_touched_rows(spec, ts, ids: torch.Tensor, *, rank: int = 0,
                      num_shards: int = 1):
    """The touched-row read of one table shard, on the table's device:
    (found (n,) bool, weights (n, dim), {slot: (n, width)}, the residuals
    as `__ef__`) for the int64 `ids`, whichever rank holds them. `found`
    marks the ids whose rows this shard holds: an array table's ids in the
    vocabulary with `id % S == rank` (local row `id // S`; at S = 1 every
    id in the vocabulary, at its own row), a hash table's ids this shard
    owns and holds (`hash_table.shard_probe`, then `hash_find`). Every row
    comes through `ops/gather.gather_rows` with `found` as its mask (the
    gather kernel on a card), zeros where `found` is False."""
    from .ops import gather
    from .parallel.checkpoint import _slots_with_ef
    from .tables.hash_table import hash_find, shard_probe
    S = num_shards
    if spec.use_hash_table:
        mine, probe = shard_probe(ids, rank, S)
        idx = hash_find(ts.keys, probe)
        found = mine & (idx < ts.keys.shape[0])
    else:
        found = (ids >= 0) & (ids < spec.input_dim)
        if S > 1:
            found = found & (torch.remainder(ids, S) == rank)
        idx = torch.div(ids, S, rounding_mode="floor") if S > 1 else ids
    weights = gather.gather_rows(ts.weights, idx, found)
    slots = {k: gather.gather_rows(v, idx, found)
             for k, v in _slots_with_ef(ts).items()}
    return found, weights, slots


def _host_float32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


class IncrementalPersister(AsyncPersister):
    """AsyncPersister whose persists between full bases cost O(touched
    rows).

        p = IncrementalPersister(trainer, model, root,
                                 policy=PersistPolicy(every_steps=50))
        for batch in data:
            state, m = step(state, batch)
            p.maybe_persist(state, batch=batch)  # observes, maybe persists

    (or `p.observe(batch)` every step and `maybe_persist(state)`). Every
    trained batch must be observed, or its rows go stale in the deltas; a
    window in which steps advanced but nothing was observed falls back to
    a full persist with a RuntimeWarning.

    A full base every `full_every` persists bounds the replay chain;
    deltas in between. A delta reads the touched rows of every table
    (weights, slots, residuals) on the card through the gather kernel
    (`read_touched_rows`), copies them and the dense tree to pinned host
    memory, synchronizes once, and queues the write; it holds only those
    rows. At S > 1 ranks the touched sets are unioned over the ranks first
    (`multihost.allgather_host_ids`: each rank observes only its slice of
    the batch), each rank writes the rows its shards own
    (`table_<name>.p<rank>.npz`, the reference's per-node dump,
    `EmbeddingDumpOperator.cpp:36-96`) and rank 0 the dense tree and the
    meta; the commit protocol makes the delta crash-consistent."""

    def __init__(self, trainer, model, root: str, *, full_every: int = 8,
                 **kw):
        if full_every < 1:
            raise ValueError("full_every must be >= 1")
        super().__init__(trainer, model, root, **kw)
        self.full_every = full_every
        self.tracker = DirtyTracker(model)
        self._since_full = 0
        self._last_persist_step: Optional[int] = None

    def observe(self, batch) -> None:
        self.tracker.observe(batch)

    def maybe_persist(self, state, batch=None) -> bool:
        if batch is not None:
            self.observe(batch)
        return super().maybe_persist(state)

    def persist(self, state) -> str:
        self._raise_pending_error()
        t0 = time.perf_counter()
        state = self.trainer.externalize(state)
        step = int(state.step)
        touched = self.tracker.take()
        if self.num_shards > 1:
            # the union over the ranks, table by table in one order on
            # every rank; it also makes the decision below the same on all
            from .parallel.multihost import allgather_host_ids
            touched = {name: allgather_host_ids(touched[name], self.mesh)
                       for name in sorted(touched)}
        unobserved = (not any(v.size for v in touched.values())
                      and self._last_persist_step is not None
                      and step > self._last_persist_step)
        offload = bool(getattr(self.trainer, "offload", None))
        full = (self._last_persist_step is None
                or self._since_full >= self.full_every or offload
                or unobserved)
        if unobserved and self._since_full < self.full_every \
                and not offload:
            warnings.warn(
                "IncrementalPersister: steps advanced but no batches were "
                "observed since the last persist — falling back to a FULL "
                "persist. Call observe(batch) (or maybe_persist(state, "
                "batch=batch)) for every trained batch.", RuntimeWarning)
        if full:
            path = self._persist_full(state, t0)
            self._since_full = 0
            self._last_persist_step = step
            return path

        tables, dense, rows = self._read_delta(state, touched)
        parent = self._last_persist_step
        # birth_time: the delta's zero point for serving freshness; only
        # rank 0's meta.json holds it
        scalars = {"step": step, "model_version": int(state.model_version),
                   "birth_time": time.time()}
        path = os.path.join(self.root, f"delta_{step:012d}")
        record = {"kind": "delta", "step": step, "rows": rows,
                  "touched": {n: int(v.size) for n, v in touched.items()}}
        self._submit(lambda tmp: self._write_delta_payload(
            tables, dense, scalars, parent, tmp), step, path, record, t0)
        self._since_full += 1
        self._last_persist_step = step
        return path

    def _read_delta(self, state, touched):
        """The touched rows this rank holds and the dense tree, on the host
        -> ({table: {"ids", "weights", "slot_<k>"...}}, {"params",
        "slots"} flax-named, rows kept)."""
        from .convert import dense_slots_to_flax, dense_to_flax
        from .parallel.checkpoint import HostCopies
        host = HostCopies()
        reads = {}
        for name, ids in touched.items():
            if not ids.size:
                continue
            ts = state.tables[name]
            ids_t = torch.from_numpy(ids).to(ts.weights.device)
            found, w, slots = read_touched_rows(
                self.model.specs[name], ts, ids_t, rank=self.rank,
                num_shards=self.num_shards)
            reads[name] = (ids, host.tensor(found), host.tensor(w),
                           host.tree(slots))
        module = host.module(state.dense)
        embeddings = host.tree(state.embeddings)
        dslots = host.tree(state.dense_slots)
        host.wait()
        tables, rows = {}, 0
        for name, (ids, found, w, slots) in reads.items():
            keep = found.numpy()
            out = {"ids": ids[keep], "weights": _host_float32(w)[keep]}
            for k, v in slots.items():
                out[f"slot_{k}"] = _host_float32(v)[keep]
            tables[name] = out
            rows += int(keep.sum())
        dense = {"params": dense_to_flax(module, embeddings),
                 "slots": dense_slots_to_flax(module, dslots)}
        return tables, dense, rows

    def _write_delta_payload(self, tables, dense, scalars, parent: int,
                             tmp: str) -> None:
        os.makedirs(tmp, exist_ok=True)
        # one file a rank over several ranks; one rank keeps the unsuffixed
        # name, as one JAX process writes
        suffix = f".p{self.rank}" if self.num_shards > 1 else ""
        for name, payload in tables.items():
            np.savez(os.path.join(tmp, f"table_{name}{suffix}.npz"),
                     **payload)
        if self.rank != 0:
            return  # the dense tree and the meta are rank 0's
        np.savez(os.path.join(tmp, "dense.npz"),
                 **{f"params/{k}": v for k, v in dense["params"].items()},
                 **{f"slots/{k}": v for k, v in dense["slots"].items()})
        meta = {"format": DELTA_FORMAT, "parent": parent,
                "tables": sorted(tables), **scalars}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)


# -- replay -------------------------------------------------------------------


def _load_delta_table(path: str, name: str):
    """-> (ids, weights, {slot: rows}) of one table of one delta: the
    one-process `table_<name>.npz` or the union of the per-rank
    `table_<name>.p<r>.npz` files (their rows are disjoint)."""
    single = os.path.join(path, f"table_{name}.npz")
    if os.path.exists(single):
        files = [single]
    else:
        files = glob.glob(os.path.join(path, f"table_{name}.p*.npz"))
        files.sort(key=lambda p: int(
            re.search(r"\.p(\d+)\.npz$", p).group(1)))
    if not files:
        return np.empty((0,), np.int64), np.empty((0, 0), np.float32), {}
    ids_l, w_l, slots_l = [], [], None
    for fp in files:
        with np.load(fp) as z:
            ids_l.append(z["ids"])
            w_l.append(z["weights"])
            s = {k[len("slot_"):]: z[k] for k in z.files
                 if k.startswith("slot_")}
        if slots_l is None:
            slots_l = {k: [] for k in s}
        for k, v in s.items():
            slots_l[k].append(v)
    return (np.concatenate(ids_l), np.concatenate(w_l),
            {k: np.concatenate(v) for k, v in (slots_l or {}).items()})


@torch.no_grad()
def _copy_rows(dst: torch.Tensor, idx: torch.Tensor, rows: np.ndarray
               ) -> None:
    """dst[idx] = rows, an indexed copy in place (the JAX package's
    `.at[].set` outside any kernel); float32 rows cast to dst's dtype."""
    src = torch.from_numpy(np.ascontiguousarray(rows)).to(dst.device)
    dst.index_copy_(0, idx, src.to(dst.dtype))


@torch.no_grad()
def _apply_delta(state, model, path: str, *, rank: int = 0,
                 num_shards: int = 1, offload=None) -> None:
    """Replay one committed delta into this rank's shards of `state`, in
    place: of each table the ids this shard owns (`id % S == rank`),
    whatever mesh size wrote them; array rows written at their local rows,
    hash ids found or inserted by the live probe
    (`hash_table.hash_find_or_insert`, its overflow added to the counter)
    and their rows written at their slots. A delta carrying residuals into
    a table without them drops the column; one without them leaves the
    live residuals as they are. Then the dense params, sparse_as_dense
    tables and dense slots (in the per-leaf form), written into the
    state's own tensors, and the step counters. A host-cached table
    (`offload`: {name: HostOffloadTable}) merges the rows into its store,
    its cache reset by the base's load."""
    from .convert import dense_slots_from_flax, flax_leaves, tables_from_numpy
    from .parallel.checkpoint import _slots_with_ef
    from .tables.hash_table import hash_find_or_insert
    S = num_shards
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for name in meta["tables"]:
        spec = model.specs[name]
        ts = state.tables[name]
        ids, w, slots = _load_delta_table(path, name)
        mine = ids >= 0
        if not spec.use_hash_table:
            mine &= ids < spec.input_dim
        if S > 1:
            mine &= ids % S == rank
        if not mine.any():
            continue
        ids, w = ids[mine], w[mine]
        slots = {k: v[mine] for k, v in slots.items()}
        if offload and name in offload:
            store = offload[name].store
            store.merge(ids, np.asarray(w, np.float32),
                        {k: np.asarray(v, np.float32)
                         for k, v in slots.items() if k in store.slots})
            continue
        targets = _slots_with_ef(ts)
        device = ts.weights.device
        if spec.use_hash_table:
            slot, overflow = hash_find_or_insert(
                ts.keys, torch.from_numpy(ids).to(device))
            placed = (slot < ts.keys.shape[0]).cpu().numpy()
            idx = slot[torch.from_numpy(placed).to(device)]
            w = w[placed]
            slots = {k: v[placed] for k, v in slots.items()}
            ts.overflow.add_(overflow)
        else:
            idx = torch.from_numpy(ids // S).to(device)
        _copy_rows(ts.weights, idx, w)
        for k, v in slots.items():
            if k in targets:
                _copy_rows(targets[k], idx, v)

    with np.load(os.path.join(path, "dense.npz")) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        dslots = {k[len("slots/"):]: z[k] for k in z.files
                  if k.startswith("slots/")}
    module = state.dense
    device = next(module.parameters()).device
    for pname, (fname, is_kernel) in flax_leaves(module).items():
        value = torch.from_numpy(np.asarray(params[fname], np.float32))
        module.get_parameter(pname).copy_(value.t() if is_kernel else value)
    prefix = "__embeddings__/"
    for name, table in state.embeddings.items():
        table.copy_(tables_from_numpy({"w": params[prefix + name]},
                                      device=device)["w"])
    loaded = dense_slots_from_flax(dslots, module, device=device)
    for pname, slots in state.dense_slots.items():
        for sname, old in slots.items():
            new = loaded.get(pname, {}).get(sname)
            if new is not None and new.shape == old.shape:
                old.copy_(new)
    state.step = int(meta["step"])
    state.model_version = int(meta["model_version"])


# -- the module API (`exb.py:697-705`) ----------------------------------------


def persist_server_model(trainer, model, state, root: str,
                         window: int = 2) -> str:
    """One persist, waited for (the loop's path is `AsyncPersister`)."""
    with AsyncPersister(trainer, model, root, window=window) as p:
        return p.persist(state)


def restore_server_model(state, model, root: str, *, trainer=None,
                         mesh=None):
    """Restore the newest committed full persist under `root` into
    `state`, in place, then replay the committed delta chain on top; returns
    the state. Crash-consistent at every level: uncommitted directories are
    ignored and a broken chain replays only its consistent prefix (the
    reference's `restore_server_model`, `exb.py:703-705`).

    A root written at any mesh size, by either package, restores into a
    single-device state or a mesh rank's. With a `parallel.MeshTrainer`
    the restore runs through its load path (`MeshTrainer.load`'s): under
    ZeRO in the per-leaf form and sharded again into the state's own flat
    tensors, the hash counters summed over the ranks, the hot cache and
    the migration directory keeping their sets and gathering their rows
    from the restored shards. Without a trainer, a mesh rank's state
    needs `mesh=`: unlike a JAX array, a port tensor does not carry the
    mesh it is sharded over (the JAX package recovers it from the state's
    shardings, `_StateMeshShim`). Such a trainerless restore refuses a
    state with ZeRO slots or placement state, which need the trainer. A
    trainer's host-cached tables restore into their stores (their caches
    reset); without the trainer such a table loads into its cache as a
    hash table."""
    from .checkpoint import load_server_model
    from .parallel.checkpoint import checkpoint_layout, load_sharded
    path, deltas = delta_chain(root)
    if path is None:
        raise FileNotFoundError(f"no committed persist under {root!r}")
    if mesh is None:
        mesh = getattr(trainer, "mesh", None)
    rank, S = _rank_and_size(mesh)
    offload = trainer._adopted(state) if getattr(trainer, "offload",
                                                  None) else None

    def fill(target):
        if S == 1 and checkpoint_layout(path) != "sharded":
            load_server_model(target, model, path, offload=offload)
        else:
            load_sharded(target, model, path, num_shards=S, rank=rank,
                         offload=offload)
        for d in deltas:
            _apply_delta(target, model, d, rank=rank, num_shards=S,
                         offload=offload)

    if trainer is not None:
        return trainer.load_into(state, fill)
    from .parallel import zero
    if zero.is_sharded_slots(state.dense_slots) or any(
            ts.hot is not None or ts.mig is not None
            for ts in state.tables.values()):
        raise ValueError(
            "the state holds ZeRO dense slots or placement state: restore "
            "it with its MeshTrainer (trainer=...)")
    fill(state)
    if S > 1:
        from .parallel import collectives
        for ts in state.tables.values():
            if ts.overflow is not None:
                ts.overflow.copy_(collectives.psum(mesh, ts.overflow))
    return state
