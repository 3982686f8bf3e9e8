"""Sharded checkpoints: each rank writes its own shard, in chunks (port of
`openembedding_tpu/parallel/checkpoint.py`), and the host snapshot a
background writer saves from (`snapshot_addressable`, for `persist.py`).

The reference dumps each server's shard into its own file
(`EmbeddingDumpOperator.cpp:36-96`), so no node holds more than its shard.
Here every rank streams its table shards to their own files `chunk_rows`
rows at a time (card -> host chunk -> memory-mapped .npy), so the host
holds O(chunk), not O(table); rank 0 writes the meta and the replicated
dense files. The disk layout is the JAX package's (meta `tpu-1`,
`extra["layout"] == "sharded"`):

    <path>/model_meta                      JSON (num_shards = S)
    <path>/dense_params.npz, dense_slots.npz, model_config.json
    <path>/variable_<id>/shard_<s>_of_<S>/weights.npy, slot_*.npy
        array tables: the shard's rows in local order (local row l holds
        id l*S + s, the reference's `id % S` interleave)
    <path>/variable_<id>/shard_<s>_of_<S>/ids.npy, weights.npy, slot_*.npy
        hash tables: the shard compacted, id-sorted
        slot___ef__.npy: a table's int8-wire error-feedback residuals
        (`EmbeddingTableState.ef`), saved and loaded like an optimizer
        slot under the reserved name `__ef__`, as the JAX package does;
        a target without `ef` ignores the file, and a checkpoint without
        it leaves the target's residuals as they are. The placement state
        (`hot`, `mig`) is never written: `MeshTrainer.save` writes it
        back into the shards first.

`save_sharded` and `checkpoint.save_server_model` write from a live state
or from `snapshot_addressable`'s host copy of it, byte for byte alike. The
JAX package's `HostShardedArray` (the shards of a global array that one
process holds) has no class here: a rank's tensors are its one shard
already, so the snapshot is a `TrainState` of host tensors.

A host-cached table (`tables/host_offload.py`) writes its host store:
each rank the rows it owns (`offload_stores`: its
`Trainer.offload_store_snapshots`), as that rank's hash shard, id-sorted.
The JAX package, whose one process holds the whole store, writes it as
one source shard and says so in the variable's meta (`src_shards: 1`);
`load_sharded` reads either. Loaded with `offload=`, a rank's rows go
into its store and its cache is reset.

`load_sharded` restores such a checkpoint at ANY target mesh size: an
index remap for array tables (id = l*S + s = m*T + t), a re-insert for
hash tables (`np_hash_insert`, the device probe's sequence inside the
target shard). It also reads a single-device checkpoint
(`checkpoint.save_server_model`'s layout: one source shard), and
`Trainer.load` reads a sharded one at T = 1.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import (MODEL_META_FILE, load_dense, load_hash_table,
                          read_meta, store_rows, variable_meta,
                          write_dense_and_meta, write_store)
from ..convert import table_to_numpy, tables_from_numpy
from ..meta import ModelMeta

DEFAULT_CHUNK_ROWS = 1 << 16
EF_SLOT = "__ef__"


def _shard_dir(vdir: str, shard: int, num_shards: int) -> str:
    return os.path.join(vdir, f"shard_{shard:05d}_of_{num_shards:05d}")


def _stream(path: str, rows: int, take, chunk_rows: int) -> None:
    """Write `rows` rows to the .npy `path`, `take(a, b)` giving rows
    [a, b) as numpy, one chunk at a time through a memory map."""
    from numpy.lib.format import open_memmap
    first = take(0, min(chunk_rows, rows))
    if rows == 0:  # an empty file cannot be memory-mapped
        np.save(path, first)
        return
    mm = open_memmap(path, mode="w+", dtype=first.dtype,
                     shape=(rows,) + first.shape[1:])
    mm[:first.shape[0]] = first
    for a in range(first.shape[0], rows, chunk_rows):
        b = min(a + chunk_rows, rows)
        mm[a:b] = take(a, b)
    mm.flush()
    del mm


def _resident(keys: torch.Tensor, chunk_rows: int) -> tuple:
    """A hash shard's resident slots and their ids, id-sorted, read in
    chunks -> (positions, ids) int64."""
    pos_parts, id_parts = [], []
    for a in range(0, keys.shape[0], chunk_rows):
        k = keys[a:a + chunk_rows].cpu().numpy()
        sel = np.flatnonzero(k >= 0)
        pos_parts.append(a + sel)
        id_parts.append(k[sel])
    pos = np.concatenate(pos_parts) if pos_parts else np.empty(0, np.int64)
    ids = np.concatenate(id_parts) if id_parts else np.empty(0, np.int64)
    order = np.argsort(ids, kind="stable")
    return pos[order], ids[order]


class HostCopies:
    """Host copies of device tensors, made in stream order: each copy is
    enqueued on the tensor's device's current stream, behind the work that
    wrote the tensor, into a pinned host buffer (PyTorch's caching host
    allocator keeps the buffers for reuse); `wait()` synchronizes each
    device's stream once, after which every copy is complete. A CPU
    tensor is cloned (its `.numpy()` would share the live memory). The
    copies share nothing with the originals: a later in-place step does
    not reach them."""

    def __init__(self):
        self._streams: List[torch.cuda.Stream] = []
        self.bytes = 0

    def tensor(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        t = t.detach()
        self.bytes += t.numel() * t.element_size()
        if t.device.type != "cuda":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        stream = torch.cuda.current_stream(t.device)
        if all(s != stream for s in self._streams):
            self._streams.append(stream)
        return out

    def tree(self, tree):
        """A nested dict of tensors, copied leaf by leaf."""
        if isinstance(tree, dict):
            return {k: self.tree(v) for k, v in tree.items()}
        return self.tensor(tree)

    def module(self, module: nn.Module) -> nn.Module:
        """A copy of the module whose parameters and buffers are host
        copies (no device copy of them is made on the way)."""
        memo = {}
        for p in module.parameters():
            memo[id(p)] = nn.Parameter(self.tensor(p),
                                       requires_grad=p.requires_grad)
        for b in module.buffers():
            memo[id(b)] = self.tensor(b)
        return copy.deepcopy(module, memo)

    def table(self, ts):
        """A table's weights, slots, keys, counter and residuals (not its
        placement state, which checkpoints never write)."""
        from ..embedding import EmbeddingTableState
        return EmbeddingTableState(
            weights=self.tensor(ts.weights), slots=self.tree(ts.slots),
            keys=self.tensor(ts.keys), overflow=self.tensor(ts.overflow),
            ef=self.tensor(ts.ef))

    def wait(self) -> None:
        for s in self._streams:
            s.synchronize()
        self._streams = []


def snapshot_addressable(state):
    """A host copy of this rank's state, complete when it returns: every
    table shard, slot, key array, counter and residual, the dense module,
    the sparse_as_dense tables and the dense slots (`HostCopies`: one
    pinned copy each in stream order, then one synchronization), with the
    step counters. A rank holds only its own shards, so the copy is never
    a global table. `save_sharded` or `checkpoint.save_server_model` write
    it on another thread while the next steps update the live tensors in
    place. On a card it holds the rank's whole state in pinned host
    memory until it is dropped."""
    from ..model import TrainState
    host = HostCopies()
    snap = TrainState(
        step=int(state.step), dense=host.module(state.dense),
        dense_slots=host.tree(state.dense_slots),
        tables={n: host.table(ts) for n, ts in state.tables.items()},
        model_version=int(state.model_version),
        embeddings=host.tree(state.embeddings))
    host.wait()
    return snap


def save_sharded(state, model, path: str, *, num_shards: int = 1,
                 rank: int = 0, include_optimizer: bool = True,
                 model_sign: str = "",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 offload_stores: Optional[Dict] = None) -> ModelMeta:
    """Write rank `rank`'s shards of the train state into `path` (rank 0
    also the meta and the dense files). Every rank of the mesh calls it;
    the checkpoint is whole once all have returned (`MeshTrainer.save`
    waits at a barrier; a persist commits once every rank's done marker
    is there). `state` is a live state or `snapshot_addressable`'s copy.
    `offload_stores`: {name: this rank's HostStore} of the host-cached
    tables, written in place of their caches."""
    os.makedirs(path, exist_ok=True)
    model_sign = model_sign or (f"{uuid.uuid4().hex}-"
                                f"{int(state.model_version)}")
    meta = ModelMeta(model_sign=model_sign, uri=path, num_shards=num_shards)
    for name, spec in model.specs.items():
        meta.variables.append(variable_meta(spec))
        if spec.sparse_as_dense:
            continue  # lives in dense_params.npz
        sdir = _shard_dir(os.path.join(path, f"variable_{spec.variable_id}"),
                          rank, num_shards)
        if offload_stores and name in offload_stores:
            write_store(sdir, offload_stores[name], include_optimizer)
            continue
        os.makedirs(sdir, exist_ok=True)
        ts = state.tables[name]
        arrays = {"weights": ts.weights}
        if include_optimizer:
            arrays.update({f"slot_{k}": v
                           for k, v in _slots_with_ef(ts).items()})
        if spec.use_hash_table:
            pos, ids = _resident(ts.keys, chunk_rows)
            np.save(os.path.join(sdir, "ids.npy"), ids)
            sel = torch.from_numpy(pos).to(ts.weights.device)
            for fname, t in arrays.items():
                _stream(os.path.join(sdir, f"{fname}.npy"), len(pos),
                        lambda a, b, t=t: table_to_numpy(t[sel[a:b]]),
                        chunk_rows)
        else:
            for fname, t in arrays.items():
                _stream(os.path.join(sdir, f"{fname}.npy"), t.shape[0],
                        lambda a, b, t=t: table_to_numpy(t[a:b]), chunk_rows)
    if rank == 0:
        write_dense_and_meta(state, model, path, meta, include_optimizer,
                             layout="sharded")
    return meta


def _slots_with_ef(ts) -> Dict[str, torch.Tensor]:
    """The table's slots, with its residuals as the slot `__ef__`."""
    if ts.ef is None:
        return dict(ts.slots)
    return {**ts.slots, EF_SLOT: ts.ef}


def _load_store(ot, ts, src: Dict[int, str], T: int, rank: int) -> None:
    """Every source shard's ids that rank `rank` of T owns, with their rows
    and slot rows, into the host-cached table's store."""
    ids, weights = [], []
    slots = {k: [] for k in ts.slots}
    for sdir in src.values():
        src_ids = np.load(os.path.join(sdir, "ids.npy"))
        sel = np.flatnonzero(src_ids % T == rank)
        ids.append(src_ids[sel])
        weights.append(store_rows(np.load(
            os.path.join(sdir, "weights.npy"), mmap_mode="r")[sel]))
        for k in list(slots):
            p = os.path.join(sdir, f"slot_{k}.npy")
            if os.path.exists(p):
                slots[k].append(np.asarray(np.load(p, mmap_mode="r")[sel]))
            else:
                del slots[k]
    dim = ts.weights.shape[1]
    ot.load_store(
        np.concatenate(ids) if ids else np.empty((0,), np.int64),
        np.concatenate(weights) if weights else
        np.empty((0, dim), np.float32),
        {k: np.concatenate(v) for k, v in slots.items() if v})


def checkpoint_layout(path: str) -> str:
    """'sharded' (this module's layout) or 'single'
    (`checkpoint.save_server_model`'s whole-table files)."""
    with open(os.path.join(path, MODEL_META_FILE)) as f:
        return json.load(f).get("extra", {}).get("layout", "single")


def _source_dirs(vdir: str, layout: str) -> Dict[int, str]:
    """{source shard: its directory}; a single-device checkpoint is one
    source shard, the variable's own directory."""
    if layout != "sharded":
        return {0: vdir}
    out = {}
    for name in os.listdir(vdir):
        if name.startswith("shard_"):
            out[int(name.split("_")[1])] = os.path.join(vdir, name)
    return dict(sorted(out.items()))


def _array_target_shard(t: int, T: int, rows_t: int, src: Dict[int, str],
                        fname: str, S: int, vocab: int) -> np.ndarray:
    """Target shard t of T of an array table: local row m holds id m*T + t,
    read from source shard id % S at local row id // S (memory-mapped; only
    the rows this shard needs). Rows past the vocabulary stay zero."""
    ids = np.arange(rows_t, dtype=np.int64) * T + t
    valid = ids < vocab
    out = None
    for s, sdir in src.items():
        mm = np.load(os.path.join(sdir, fname), mmap_mode="r")
        if out is None:
            out = np.zeros((rows_t,) + mm.shape[1:], mm.dtype)
        sel = valid & (ids % S == s)
        if sel.any():
            out[sel] = mm[ids[sel] // S]
    return out


def load_sharded(state, model, path: str, *, num_shards: int = 1,
                 rank: int = 0, offload: Optional[Dict] = None):
    """Restore a checkpoint (either layout, written at any mesh size) into
    rank `rank`'s shard of a state split in `num_shards` (a `MeshTrainer`
    state; a single-device state is shard 0 of 1), in place; returns it.
    The host holds one target shard of one array at a time. A hash shard
    re-inserts the ids it owns, in source-shard order; its overflow counter
    becomes the ids of this shard that found no slot (`MeshTrainer.load`
    sums them over the ranks). `offload`: {name: HostOffloadTable} of the
    host-cached tables: the ids this rank owns load into its store."""
    meta, extra = read_meta(path, model)
    layout = extra.get("layout", "single")
    # a variable may name its own source shards (the JAX package writes a
    # host store as one)
    src_shards = {v.storage_name: v.table.get("src_shards", meta.num_shards)
                  for v in meta.variables}
    T = num_shards
    load_dense(state, model, path)
    for name, spec in model.ps_specs().items():
        S = src_shards.get(name, meta.num_shards) \
            if layout == "sharded" else 1
        src = _source_dirs(os.path.join(path,
                                        f"variable_{spec.variable_id}"),
                           layout)
        if len(src) != S:
            raise ValueError(
                f"variable {name!r}: checkpoint has {len(src)} shard dirs, "
                f"its meta says {S} (an incomplete dump?)")
        ts = state.tables[name]
        if offload and name in offload:
            _load_store(offload[name], ts, src, T, rank)
            continue
        slots = _slots_with_ef(ts)
        first = next(iter(src.values()))
        names = ["weights"] + [f"slot_{k}" for k in slots if os.path.exists(
            os.path.join(first, f"slot_{k}.npy"))]
        if spec.use_hash_table:
            ids, parts = [], {n: [] for n in names}
            for sdir in src.values():
                src_ids = np.load(os.path.join(sdir, "ids.npy"))
                sel = np.flatnonzero(src_ids % T == rank)
                ids.append(src_ids[sel])
                for n in names:
                    mm = np.load(os.path.join(sdir, f"{n}.npy"),
                                 mmap_mode="r")
                    parts[n].append(np.asarray(mm[sel]))
            rows = {n: tables_from_numpy({"a": np.concatenate(p)},
                                         device=ts.weights.device)["a"]
                    for n, p in parts.items()}
            # the residuals ride as a slot: the load writes `ts.ef` itself
            view = dataclasses.replace(ts, slots=slots)
            load_hash_table(view, np.concatenate(ids), rows.pop("weights"),
                            {n[len("slot_"):]: v for n, v in rows.items()})
            continue
        for n in names:
            dst = ts.weights if n == "weights" else slots[n[len("slot_"):]]
            dst.copy_(tables_from_numpy({"a": _array_target_shard(
                rank, T, dst.shape[0], src, f"{n}.npy", S, spec.input_dim)},
                device=dst.device)["a"])
    state.step = int(extra.get("step", 0))
    state.model_version = int(extra.get("model_version", 0))
    return state
