"""Training checkpoints in the JAX package's on-disk format (port of the
single-device part of `openembedding_tpu/checkpoint.py`).

A checkpoint directory holds:

- `model_meta` — the ModelMeta JSON (+ `extra`: step, model_version,
  include_optimizer); `model_config.json` — the zoo recipe;
- `variable_<id>/weights.npy` (rows in global id order) and
  `variable_<id>/slot_<name>.npy`; a hash table is compacted: its resident
  ids sorted (`ids.npy`, int64) with their rows and slot rows in the same
  order; a sparse_as_dense variable's directory stays empty, as in the JAX
  package;
- `dense_params.npz` — the dense params under their flax names, the
  sparse_as_dense tables under `__embeddings__/<name>`; `dense_slots.npz` —
  their slots as `<param>/<slot>` rows of shape (1, size) in the flax layout
  (`convert.dense_slots_to_flax`).

Optimizer state (table slots and `dense_slots.npz`) is left out with
`include_optimizer=False`; a load of such a checkpoint keeps the state's
own slots (fresh ones, from `Trainer.init`). A hash table loads by
re-inserting its ids (`tables/hash_table.np_hash_insert`, the JAX package's
host insert): the loaded table equals the saved one in its id -> row
contents, and the JAX package's load of the same files slot for slot; the
overflow counter restarts at the ids that found no slot. A checkpoint
written by either package loads in the other. One device; the mesh's
per-shard checkpoints are `parallel/checkpoint.py`'s.

A host-cached table (`tables/host_offload.py`) writes its whole host store
(`offload_stores`: `Trainer.offload_store_snapshots`), already id-sorted:
the files of a hash table, so a trainer with or without the offload loads
them. Loaded with `offload=` ({name: HostOffloadTable}), the rows go into
the store and the cache is reset; a hash table's files from a trainer
without the offload load the same way.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

from .meta import ModelMeta, ModelVariableMeta

MODEL_META_FILE = "model_meta"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}, the flat names of `dense_params.npz`."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_numpy(params)
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of `_flatten_params`; leaves stay numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _check_meta(meta: ModelMeta, model) -> None:
    """Every variable of the model must be in the checkpoint with the same
    width, dtype and vocabulary."""
    by_name = {v.storage_name: v for v in meta.variables}
    for name, spec in model.specs.items():
        if name not in by_name:
            raise ValueError(f"checkpoint is missing variable {name!r}")
        ckpt = by_name[name].meta
        if (ckpt.embedding_dim != spec.meta.embedding_dim
                or ckpt.datatype != spec.meta.datatype
                or ckpt.vocabulary_size != spec.meta.vocabulary_size):
            raise ValueError(f"variable {name!r} meta mismatch: {ckpt} vs "
                             f"{spec.meta}")


def compact_hash_table(ts) -> tuple:
    """A hash table's resident rows, id-sorted: (ids int64, the selection
    of their slots in that order), what checkpoints and exports write."""
    keys = _to_numpy(ts.keys)
    sel = np.flatnonzero(keys >= 0)
    ids = keys[sel]
    order = np.argsort(ids, kind="stable")
    return ids[order], sel[order]


def save_server_model(state, model, path: str, *,
                      include_optimizer: bool = True,
                      model_sign: str = "",
                      offload_stores: Optional[Dict[str, Any]] = None
                      ) -> ModelMeta:
    """Dump a `TrainState` into `path` (see the module docstring): a live
    state or its host copy (`parallel.checkpoint.snapshot_addressable`),
    byte for byte alike. `offload_stores`: {name: HostStore} of the
    host-cached tables, each written in place of the table's cache."""
    from .convert import table_to_numpy
    os.makedirs(path, exist_ok=True)
    model_sign = model_sign or f"{uuid.uuid4().hex}-{int(state.model_version)}"
    meta = ModelMeta(model_sign=model_sign, uri=path, num_shards=1)
    for name, spec in model.specs.items():
        vdir = os.path.join(path, f"variable_{spec.variable_id}")
        os.makedirs(vdir, exist_ok=True)
        meta.variables.append(variable_meta(spec))
        if spec.sparse_as_dense:
            continue  # its table is in dense_params.npz
        if offload_stores and name in offload_stores:
            write_store(vdir, offload_stores[name], include_optimizer)
            continue
        ts = state.tables[name]
        weights = table_to_numpy(ts.weights)
        slots = {k: _to_numpy(v) for k, v in ts.slots.items()}
        if spec.use_hash_table:
            ids, sel = compact_hash_table(ts)
            np.save(os.path.join(vdir, "ids.npy"), ids)
            weights = weights[sel]
            slots = {k: v[sel] for k, v in slots.items()}
        np.save(os.path.join(vdir, "weights.npy"), weights)
        if include_optimizer:
            for slot_name, arr in slots.items():
                np.save(os.path.join(vdir, f"slot_{slot_name}.npy"), arr)
    write_dense_and_meta(state, model, path, meta, include_optimizer)
    return meta


def write_store(vdir: str, store, include_optimizer: bool) -> None:
    """A host store as a compacted hash table: `ids.npy`, `weights.npy` and
    (with the optimizer) `slot_<name>.npy`, id-sorted."""
    os.makedirs(vdir, exist_ok=True)
    np.save(os.path.join(vdir, "ids.npy"), store.ids)
    np.save(os.path.join(vdir, "weights.npy"), store.weights)
    if include_optimizer:
        for slot_name, arr in store.slots.items():
            np.save(os.path.join(vdir, f"slot_{slot_name}.npy"), arr)


def store_rows(weights: np.ndarray) -> np.ndarray:
    """Saved weight rows as the store's float32 (a bfloat16 table's 2-byte
    words widened)."""
    if weights.dtype.itemsize == 2 and (weights.dtype.kind == "V"
                                        or weights.dtype.name == "bfloat16"):
        return torch.from_numpy(np.ascontiguousarray(weights).view(
            np.int16)).view(torch.bfloat16).float().numpy()
    return np.asarray(weights, np.float32)


def variable_meta(spec) -> ModelVariableMeta:
    """A variable's entry in `model_meta`."""
    return ModelVariableMeta(
        variable_id=spec.variable_id, storage_name=spec.name, meta=spec.meta,
        optimizer=spec.optimizer.to_config() if spec.optimizer else {},
        initializer=spec.initializer.to_config(),
        table={"category": "hash" if spec.use_hash_table else "array",
               "capacity": spec.capacity,
               "sparse_as_dense": spec.sparse_as_dense})


def write_dense_and_meta(state, model, path: str, meta: ModelMeta,
                         include_optimizer: bool, **extra) -> None:
    """`dense_params.npz`, `dense_slots.npz` (with the optimizer),
    `model_meta` (its `extra`: step, model_version, include_optimizer and
    `extra`) and `model_config.json` (when the model has a recipe)."""
    from .convert import dense_slots_to_flax, dense_to_flax
    from .export import MODEL_CONFIG_FILE
    dense = dense_to_flax(state.dense, state.embeddings)
    np.savez(os.path.join(path, "dense_params.npz"), **dense)
    if include_optimizer:
        np.savez(os.path.join(path, "dense_slots.npz"),
                 **dense_slots_to_flax(state.dense, state.dense_slots))
    meta.dense_manifest = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in dense.items()}
    with open(os.path.join(path, MODEL_META_FILE), "w") as f:
        d = json.loads(meta.to_json())
        d["extra"] = {"step": int(state.step),
                      "model_version": int(state.model_version),
                      "include_optimizer": include_optimizer, **extra}
        json.dump(d, f, indent=2, sort_keys=True)
    if model.config is not None:
        with open(os.path.join(path, MODEL_CONFIG_FILE), "w") as f:
            json.dump(model.config, f, indent=2, sort_keys=True)


def load_server_model(state, model, path: str, *,
                      offload: Optional[Dict[str, Any]] = None):
    """Restore a checkpoint into `state` (a `TrainState` of the same model,
    e.g. from `Trainer.init`) in place, and return it. Tables and slots keep
    their device and dtype. A dense slot or table slot missing from the
    checkpoint, or saved with another shape (another optimizer), keeps the
    state's value; so does every row of a hash table that no loaded id
    takes. `offload`: {name: HostOffloadTable} of the host-cached tables,
    loaded into their stores (`HostOffloadTable.load_store`)."""
    from .convert import tables_from_numpy
    _, extra = read_meta(path, model)
    device = load_dense(state, model, path)
    for name, spec in model.ps_specs().items():
        vdir = os.path.join(path, f"variable_{spec.variable_id}")
        ts = state.tables[name]
        if offload and name in offload:
            slots = {k: np.load(os.path.join(vdir, f"slot_{k}.npy"))
                     for k in ts.slots
                     if os.path.exists(os.path.join(vdir, f"slot_{k}.npy"))}
            offload[name].load_store(
                np.load(os.path.join(vdir, "ids.npy")),
                store_rows(np.load(os.path.join(vdir, "weights.npy"))),
                slots)
            continue
        w = tables_from_numpy({"w": np.load(os.path.join(vdir, "weights.npy"))},
                              device=device)["w"]
        slot_files = {k: os.path.join(vdir, f"slot_{k}.npy") for k in ts.slots}
        slots = {k: torch.from_numpy(np.load(p)).to(device)
                 for k, p in slot_files.items() if os.path.exists(p)}
        if spec.use_hash_table:
            load_hash_table(ts, np.load(os.path.join(vdir, "ids.npy")), w,
                            slots)
            continue
        ts.weights.copy_(w)
        for k, v in slots.items():
            ts.slots[k].copy_(v)
    state.step = int(extra.get("step", 0))
    state.model_version = int(extra.get("model_version", 0))
    return state


def read_meta(path: str, model):
    """A checkpoint's (ModelMeta, extra), checked against the model."""
    with open(os.path.join(path, MODEL_META_FILE)) as f:
        raw = f.read()
    meta = ModelMeta.from_json(raw)
    _check_meta(meta, model)
    return meta, json.loads(raw).get("extra", {})


def load_dense(state, model, path: str) -> torch.device:
    """The dense part of a checkpoint into `state`, in place: the dense
    params, the sparse_as_dense tables and the dense slots (a slot missing
    from the checkpoint, or saved with another shape, keeps the state's
    value). Returns the state's device."""
    from .convert import (dense_from_flax, dense_slots_from_flax,
                          tables_from_numpy)
    device = next(state.dense.parameters()).device
    z = np.load(os.path.join(path, "dense_params.npz"))
    sad = dense_from_flax({k: z[k] for k in z.files}, state.dense)
    for name in model.sad_specs():
        if name not in sad:
            raise ValueError(f"checkpoint holds no sparse_as_dense table "
                             f"{name!r} (dense_params.npz)")
        state.embeddings[name].copy_(
            tables_from_numpy({"w": sad[name]}, device=device)["w"])
    slots_path = os.path.join(path, "dense_slots.npz")
    if os.path.exists(slots_path):
        z = np.load(slots_path)
        loaded = dense_slots_from_flax({k: z[k] for k in z.files},
                                       state.dense, device=device)
        for pname, slots in state.dense_slots.items():
            for sname, old in slots.items():
                new = loaded.get(pname, {}).get(sname)
                if new is not None and new.shape == old.shape:
                    slots[sname] = new
    return device


def load_hash_table(ts, ids: np.ndarray, weights: torch.Tensor,
                    slots: Dict[str, torch.Tensor]) -> None:
    """Re-insert compacted (ids, rows, slot rows) into the hash table `ts`,
    in place: fresh keys, `np_hash_insert`'s placement, each placed id's
    rows written at its slot; the counter becomes the ids left without a
    slot. Rows of the slots no id takes keep their values."""
    from .tables.hash_table import fresh_keys, np_hash_insert
    keys = fresh_keys(ts.keys.shape[0]).numpy()
    pos = np_hash_insert(keys, np.asarray(ids, np.int64))
    placed = np.flatnonzero(pos >= 0)
    dst = torch.from_numpy(pos[placed]).to(ts.weights.device)
    src = torch.from_numpy(placed).to(ts.weights.device)
    ts.keys.copy_(torch.from_numpy(keys))
    ts.weights.index_copy_(0, dst, weights.index_select(0, src))
    for k, v in slots.items():
        ts.slots[k].index_copy_(0, dst, v.index_select(0, src))
    ts.overflow.fill_(int(len(ids) - len(placed)))
