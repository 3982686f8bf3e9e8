"""Sharded checkpoints: each rank writes its own shard, in chunks (port of
`openembedding_tpu/parallel/checkpoint.py`; the JAX package's snapshot for
a background writer, `snapshot_addressable`, waits with `persist.py`,
ROADMAP.md item 3).

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

`load_sharded` restores such a checkpoint at ANY target mesh size: an
index remap for array tables (id = l*S + s = m*T + t), a re-insert for
hash tables (`np_hash_insert`, the device probe's sequence inside the
target shard). It also reads a single-device checkpoint
(`checkpoint.save_server_model`'s layout: one source shard), and
`Trainer.load` reads a sharded one at T = 1.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict

import numpy as np
import torch

from ..checkpoint import (MODEL_META_FILE, load_dense, load_hash_table,
                          read_meta, variable_meta, write_dense_and_meta)
from ..convert import table_to_numpy, tables_from_numpy
from ..meta import ModelMeta

DEFAULT_CHUNK_ROWS = 1 << 16


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


def save_sharded(state, model, path: str, *, num_shards: int = 1,
                 rank: int = 0, include_optimizer: bool = True,
                 model_sign: str = "",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> ModelMeta:
    """Write rank `rank`'s shards of the train state into `path` (rank 0
    also the meta and the dense files). Every rank of the mesh calls it;
    the checkpoint is whole once all have returned (`MeshTrainer.save`
    waits at a barrier)."""
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
        os.makedirs(sdir, exist_ok=True)
        ts = state.tables[name]
        arrays = {"weights": ts.weights}
        if include_optimizer:
            arrays.update({f"slot_{k}": v for k, v in ts.slots.items()})
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
                 rank: int = 0):
    """Restore a checkpoint (either layout, written at any mesh size) into
    rank `rank`'s shard of a state split in `num_shards` (a `MeshTrainer`
    state; a single-device state is shard 0 of 1), in place; returns it.
    The host holds one target shard of one array at a time. A hash shard
    re-inserts the ids it owns, in source-shard order; its overflow counter
    becomes the ids of this shard that found no slot (`MeshTrainer.load`
    sums them over the ranks)."""
    meta, extra = read_meta(path, model)
    layout = extra.get("layout", "single")
    S = meta.num_shards if layout == "sharded" else 1
    T = num_shards
    device = load_dense(state, model, path)
    for name, spec in model.ps_specs().items():
        src = _source_dirs(os.path.join(path,
                                        f"variable_{spec.variable_id}"),
                           layout)
        if len(src) != S:
            raise ValueError(
                f"variable {name!r}: checkpoint has {len(src)} shard dirs, "
                f"its meta says {S} (an incomplete dump?)")
        ts = state.tables[name]
        first = next(iter(src.values()))
        names = ["weights"] + [f"slot_{k}" for k in ts.slots if os.path.exists(
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
                                         device=device)["a"]
                    for n, p in parts.items()}
            load_hash_table(ts, np.concatenate(ids), rows.pop("weights"),
                            {n[len("slot_"):]: v for n, v in rows.items()})
            continue
        for n in names:
            dst = ts.weights if n == "weights" else ts.slots[n[len("slot_"):]]
            dst.copy_(tables_from_numpy({"a": _array_target_shard(
                rank, T, dst.shape[0], src, f"{n}.npy", S, spec.input_dim)},
                device=device)["a"])
    state.step = int(extra.get("step", 0))
    state.model_version = int(extra.get("model_version", 0))
    return state
