"""Standalone model export for serving (port of `openembedding_tpu/export.py`).

The export directory has the JAX package's layout, so either package reads
what the other wrote:

- `model_meta` — the ModelMeta JSON (+ `extra`: step, model_version,
  birth_time); `model_config.json` — the zoo recipe that rebuilds the module;
- `variable_<id>/weights.npy` in global id order (array tables), plus
  `ids.npy`, the sorted resident ids, for hash tables;
- `dense_params.npz` — the dense tower's params under their flax names.

`StandaloneModel.load()` puts the tables and the dense module on one device
(the CUDA card unless the caller asks for the CPU); `lookup` and `predict`
gather rows through the hand-written kernel there (`ops/gather.py`).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .checkpoint import MODEL_META_FILE
from .convert import dense_from_flax, dense_to_flax, tables_from_numpy
from .device import resolve_device
from .embedding import serve_rows
from .layers import unmaterialized_copy
from .meta import ModelMeta, ModelVariableMeta
from .model import EmbeddingModel, TrainState, WeightsState, attach_ids
from .ops import gather

MODEL_CONFIG_FILE = "model_config.json"


def bucket_size(n: int, floor: int = 8) -> int:
    """Serving batch bucket: next power of two >= n (min `floor`)."""
    b = floor
    while b < n:
        b <<= 1
    return b


class RaggedBatchError(ValueError):
    """A serving request whose features disagree on the batch size — the
    caller's error; the REST layer maps it to 400."""


def pad_ids_to_bucket(flat: np.ndarray) -> np.ndarray:
    """Pad a flat id vector to its power-of-two bucket with -1 (absent)."""
    k = flat.shape[0]
    if k == 0:
        return flat
    widths = [(0, bucket_size(k) - k)] + [(0, 0)] * (flat.ndim - 1)
    return np.pad(flat, widths, constant_values=-1)


def pad_serving_batch(batch, n: int, bucket: int):
    """Pad every leading batch dim n -> bucket (sparse ids with -1, dense
    with zeros). Features that disagree on n are rejected."""

    def pad(x, fill, what):
        x = np.asarray(x)
        if x.shape[0] != n:
            raise RaggedBatchError(
                f"ragged serving batch: {what} has {x.shape[0]} rows, "
                f"expected {n}")
        if x.shape[0] == bucket:
            return x
        widths = [(0, bucket - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=fill)

    out = {"sparse": {k: pad(v, -1, f"sparse[{k!r}]")
                      for k, v in batch["sparse"].items()}}
    if batch.get("dense") is not None:
        out["dense"] = pad(batch["dense"], 0, "dense")
    return out


def load_model_config(path: str, **overrides) -> Optional[EmbeddingModel]:
    """Rebuild the EmbeddingModel from a directory's model_config.json
    (None when absent). The recipe's `serving_overrides` apply first (a
    sequence model trained with attention="ring" serves with local
    attention), the caller's `overrides` over them."""
    cfg_path = os.path.join(path, MODEL_CONFIG_FILE)
    if not os.path.exists(cfg_path):
        return None
    from . import models as zoo
    with open(cfg_path) as f:
        cfg = json.load(f)
    return zoo.from_config(cfg, **{**cfg.get("serving_overrides", {}),
                                   **overrides})


def export_standalone(state: Union[WeightsState, TrainState],
                      model: EmbeddingModel, path: str,
                      *, model_sign: str = "",
                      offload_stores: Optional[Dict[str, Any]] = None
                      ) -> ModelMeta:
    """Write every embedding variable and the dense module into a
    self-contained directory, from fresh weights or from a training state.
    Weights only (no optimizer slots). A hash table writes its resident
    ids sorted (`ids.npy`) and their rows (fresh weights from
    `init_weights` hold no id). A sparse_as_dense table is written as a
    plain array table, and served like one. `offload_stores` ({name:
    HostStore}, `Trainer.offload_store_snapshots(state)`) gives a
    host-cached table's whole table: its cache holds only the resident
    rows. A ZeRO mesh state whose params are the dense wire's bfloat16
    carrier is refused: write `MeshTrainer.externalize(state)`, which holds
    the masters."""
    from .checkpoint import compact_hash_table
    from .parallel import zero
    if isinstance(state, TrainState) and zero.DENSE_MASTER_KEY in \
            state.dense_slots.get(zero.ZERO_KEY, {}):
        raise ValueError(
            "the state's dense params are the dense wire's bfloat16 carrier "
            "(its float32 masters are in the ZeRO slots): export "
            "MeshTrainer.externalize(state)")
    os.makedirs(path, exist_ok=True)
    model_sign = model_sign or f"{uuid.uuid4().hex}-{int(state.model_version)}"
    meta = ModelMeta(model_sign=model_sign, uri=path, num_shards=1)
    for name, spec in model.specs.items():
        ids = None
        if offload_stores and name in offload_stores:
            store = offload_stores[name]  # the whole table, id-sorted
            ids, weights = store.ids, torch.from_numpy(store.weights)
        elif isinstance(state, TrainState):
            weights = (state.embeddings[name] if spec.sparse_as_dense
                       else state.tables[name].weights)
            if spec.use_hash_table:
                ids, sel = compact_hash_table(state.tables[name])
                weights = weights[torch.from_numpy(sel).to(weights.device)]
        else:
            weights = state.tables[name]
            if spec.use_hash_table:
                ids = np.zeros(0, np.int64)
                weights = weights[:0]
        if weights.dtype != torch.float32:
            raise NotImplementedError(
                f"variable {name!r}: the port exports float32 tables only, "
                f"got {weights.dtype}")
        vdir = os.path.join(path, f"variable_{spec.variable_id}")
        os.makedirs(vdir, exist_ok=True)
        meta.variables.append(ModelVariableMeta(
            variable_id=spec.variable_id, storage_name=name, meta=spec.meta,
            initializer=spec.initializer.to_config(),
            table={"category": "hash" if ids is not None else "array",
                   "capacity": spec.capacity}))
        if ids is not None:
            np.save(os.path.join(vdir, "ids.npy"), ids)
        np.save(os.path.join(vdir, "weights.npy"),
                weights.detach().cpu().numpy())

    dense = dense_to_flax(state.dense)
    np.savez(os.path.join(path, "dense_params.npz"), **dense)
    meta.dense_manifest = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in dense.items()}
    with open(os.path.join(path, MODEL_META_FILE), "w") as f:
        d = json.loads(meta.to_json())
        d["extra"] = {"standalone": True, "step": int(state.step),
                      "model_version": int(state.model_version),
                      "birth_time": time.time()}
        json.dump(d, f, indent=2, sort_keys=True)
    if model.config is not None:
        with open(os.path.join(path, MODEL_CONFIG_FILE), "w") as f:
            json.dump(model.config, f, indent=2, sort_keys=True)
    return meta


class StandaloneModel:
    """A loaded standalone export: read-only lookups + predict(), with every
    table and the dense module on `self.device`."""

    def __init__(self, meta: ModelMeta, tables: Dict[str, dict],
                 model: Optional[EmbeddingModel], device: torch.device,
                 dense: Optional[torch.nn.Module] = None):
        self.meta = meta
        self._tables = tables      # name -> {kind, weights, dim, [ids]}
        self.model = model         # None if no config recipe and none given
        self.dense = dense         # the export's dense module (model's copy)
        self.device = device
        self.step = 0
        self.model_version = 0

    @classmethod
    def load(cls, path: str, model: Optional[EmbeddingModel] = None,
             device=None) -> "StandaloneModel":
        """Load an export onto `device` (None = the CUDA card; raises when
        there is none). The export's dense weights load into a copy of the
        model's dense module (`self.dense`); `model.module` stays as it
        is."""
        device = resolve_device(device)
        with open(os.path.join(path, MODEL_META_FILE)) as f:
            raw_meta = f.read()
        meta = ModelMeta.from_json(raw_meta)
        extra = json.loads(raw_meta).get("extra", {})
        if model is None:
            model = load_model_config(path)
        tables = {}
        for v in meta.variables:
            vdir = os.path.join(path, f"variable_{v.variable_id}")
            weights = tables_from_numpy(
                {"w": np.load(os.path.join(vdir, "weights.npy"))},
                device=device)["w"]
            entry = {"weights": weights, "dim": int(weights.shape[-1])}
            ids_path = os.path.join(vdir, "ids.npy")
            if os.path.exists(ids_path):
                entry["kind"] = "hash"
                # sorted int64 ids stay on the host: lookup binary-searches
                # them there and gathers the hit rows on the device
                entry["ids"] = np.load(ids_path).astype(np.int64)
            else:
                entry["kind"] = "array"
            tables[v.storage_name] = entry
        dense = None
        if model is not None:
            z = np.load(os.path.join(path, "dense_params.npz"))
            dense = unmaterialized_copy(model.module)
            dense_from_flax({k: z[k] for k in z.files}, dense)
            dense.to(device).eval()
        out = cls(meta, tables, model, device, dense)
        out.step = int(extra.get("step", 0))
        out.model_version = int(extra.get("model_version", 0))
        return out

    @property
    def variable_names(self):
        return list(self._tables)

    def lookup(self, name: str, ids) -> torch.Tensor:
        """Read-only pull: absent/out-of-range ids -> zero rows. The flat id
        count pads to a power-of-two bucket (pad id -1 = absent). One kernel
        launch per call on the card."""
        t = self._tables[name]
        w = t["weights"]
        flat_np = np.asarray(ids)
        ids_shape = flat_np.shape
        flat_np = flat_np.reshape(-1).astype(np.int64)
        k = flat_np.shape[0]
        flat_np = pad_ids_to_bucket(flat_np)
        if t["kind"] == "hash":
            # sorted ids.npy: binary search in full int64 on the host, then
            # the device gather with rows=pos under the hit mask
            n = t["ids"].shape[0]
            if n == 0:
                return torch.zeros(tuple(ids_shape) + (t["dim"],),
                                   dtype=w.dtype, device=self.device)
            pos = np.searchsorted(t["ids"], flat_np)
            hit = t["ids"][np.minimum(pos, n - 1)] == flat_np
            rows = torch.from_numpy(pos.astype(np.int64)).to(self.device)
            valid = torch.from_numpy(hit).to(self.device)
        else:
            rows = torch.from_numpy(flat_np).to(self.device)
            valid = None
        out = gather.gather_rows(w, rows, valid)
        return out[:k].reshape(tuple(ids_shape) + (t["dim"],))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Full forward pass -> the first n rows of the module's output on
        `self.device`: (n,) float32 logits for the CTR families, (n, S, 2)
        for the sequential ones. The request pads to a power-of-two bucket
        and the output is sliced back; the two-tower's (bucket, bucket)
        score matrix comes back (n, bucket), as the JAX package's
        `out[:n]` gives it (its padded items' columns included)."""
        if self.model is None:
            raise ValueError(
                "standalone export has no model_config recipe; pass the "
                "EmbeddingModel to StandaloneModel.load(path, model=...)")
        specs = self.model.specs

        def feat(name):
            return specs[name].feature_name if name in specs else name

        first = feat(next(iter(self._tables)))
        n = np.asarray(batch["sparse"][first]).shape[0]
        # heavy-hitter telemetry (`utils/sketch`): the raw request ids per
        # feature, off the hot path (a bounded-queue put; -1 pads dropped)
        from .utils import sketch
        for fname, fids in batch["sparse"].items():
            sketch.record_ids(fname, fids)
        padded = pad_serving_batch(batch, n, bucket_size(n))
        embedded = {}
        for name in self._tables:
            ids = padded["sparse"][feat(name)]
            if name in specs:
                embedded[name] = serve_rows(
                    specs[name], ids, lambda i, n=name: self.lookup(n, i))
            else:
                embedded[name] = self.lookup(name, ids)
        attach_ids(embedded, self.model, padded, self.device)
        dense = padded.get("dense")
        if dense is not None:
            dense = torch.from_numpy(np.ascontiguousarray(dense)).to(
                self.device)
        out = self.dense(embedded, dense)
        return out[:n]
