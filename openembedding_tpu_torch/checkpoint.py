"""Training checkpoints in the JAX package's on-disk format (port of the
single-device part of `openembedding_tpu/checkpoint.py`).

A checkpoint directory holds:

- `model_meta` — the ModelMeta JSON (+ `extra`: step, model_version,
  include_optimizer); `model_config.json` — the zoo recipe;
- `variable_<id>/weights.npy` (rows in global id order) and
  `variable_<id>/slot_<name>.npy`; a sparse_as_dense variable's directory
  stays empty, as in the JAX package;
- `dense_params.npz` — the dense params under their flax names, the
  sparse_as_dense tables under `__embeddings__/<name>`; `dense_slots.npz` —
  their slots as `<param>/<slot>` rows of shape (1, size) in the flax layout
  (`convert.dense_slots_to_flax`).

A checkpoint written by either package loads in the other (the port always
writes the optimizer state; it reads checkpoints written without it). The
port has array tables only, on one device.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict

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


def _array_tables_only(model) -> None:
    for name, spec in model.specs.items():
        if spec.use_hash_table:
            raise NotImplementedError(
                f"variable {name!r}: checkpoints of hash tables are not "
                "ported yet (see ROADMAP.md)")


def save_server_model(state, model, path: str, *,
                      model_sign: str = "") -> ModelMeta:
    """Dump a `TrainState` into `path` (see the module docstring)."""
    from .convert import dense_slots_to_flax, dense_to_flax, table_to_numpy
    from .export import MODEL_CONFIG_FILE
    _array_tables_only(model)
    os.makedirs(path, exist_ok=True)
    model_sign = model_sign or f"{uuid.uuid4().hex}-{int(state.model_version)}"
    meta = ModelMeta(model_sign=model_sign, uri=path, num_shards=1)
    for name, spec in model.specs.items():
        vdir = os.path.join(path, f"variable_{spec.variable_id}")
        os.makedirs(vdir, exist_ok=True)
        meta.variables.append(ModelVariableMeta(
            variable_id=spec.variable_id, storage_name=name, meta=spec.meta,
            optimizer=spec.optimizer.to_config() if spec.optimizer else {},
            initializer=spec.initializer.to_config(),
            table={"category": "array", "capacity": spec.capacity,
                   "sparse_as_dense": spec.sparse_as_dense}))
        if spec.sparse_as_dense:
            continue  # its table is in dense_params.npz
        ts = state.tables[name]
        np.save(os.path.join(vdir, "weights.npy"), table_to_numpy(ts.weights))
        for slot_name, arr in ts.slots.items():
            np.save(os.path.join(vdir, f"slot_{slot_name}.npy"),
                    _to_numpy(arr))
    dense = dense_to_flax(state.dense, state.embeddings)
    np.savez(os.path.join(path, "dense_params.npz"), **dense)
    np.savez(os.path.join(path, "dense_slots.npz"),
             **dense_slots_to_flax(state.dense, state.dense_slots))
    meta.dense_manifest = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in dense.items()}
    with open(os.path.join(path, MODEL_META_FILE), "w") as f:
        d = json.loads(meta.to_json())
        d["extra"] = {"step": int(state.step),
                      "model_version": int(state.model_version),
                      "include_optimizer": True}
        json.dump(d, f, indent=2, sort_keys=True)
    if model.config is not None:
        with open(os.path.join(path, MODEL_CONFIG_FILE), "w") as f:
            json.dump(model.config, f, indent=2, sort_keys=True)
    return meta


def load_server_model(state, model, path: str):
    """Restore a checkpoint into `state` (a `TrainState` of the same model,
    e.g. from `Trainer.init`) in place, and return it. Tables and slots keep
    their device and dtype. A dense slot or table slot missing from the
    checkpoint, or saved with another shape (another optimizer), keeps the
    state's value."""
    from .convert import (dense_from_flax, dense_slots_from_flax,
                          tables_from_numpy)
    _array_tables_only(model)
    with open(os.path.join(path, MODEL_META_FILE)) as f:
        raw = f.read()
    meta = ModelMeta.from_json(raw)
    extra = json.loads(raw).get("extra", {})
    _check_meta(meta, model)

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

    for name, spec in model.ps_specs().items():
        vdir = os.path.join(path, f"variable_{spec.variable_id}")
        ts = state.tables[name]
        w = np.load(os.path.join(vdir, "weights.npy"))
        ts.weights.copy_(tables_from_numpy({"w": w}, device=device)["w"])
        for slot_name, arr in ts.slots.items():
            p = os.path.join(vdir, f"slot_{slot_name}.npy")
            if os.path.exists(p):
                arr.copy_(torch.from_numpy(np.load(p)))
    state.step = int(extra.get("step", 0))
    state.model_version = int(extra.get("model_version", 0))
    return state
