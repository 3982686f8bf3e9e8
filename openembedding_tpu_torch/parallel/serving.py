"""Sharded serving: answer pulls and predicts straight from a (sharded)
checkpoint, the tables split over a list of devices and never materialized
whole (port of `openembedding_tpu/parallel/serving.py`).

The reference serves a model too big for one node from the sharded
parameter server: TF-Serving's `PullWeights` pulls from the PS shards with
the read-only handler (`tensorflow/exb_ops.cpp:261-276`,
`server/EmbeddingPullOperator.cpp:50-58, 149-205`).
`export.StandaloneModel` covers the small case by materializing every
table on one device; `ShardedModel` is the big case:

- every table loads shard by shard, shard r of T onto `devices[r]`,
  through `parallel/checkpoint.load_sharded` (either checkpoint layout,
  written at any mesh size); optimizer slots are never read. An array
  table's shard holds `rows_per_shard(T)` rows (id i at shard i % T, local
  row i // T); a hash table's shard is sized from the ids the checkpoint
  holds, not from the training capacity;
- the dense module and the sparse_as_dense tables load once, onto
  `devices[0]`;
- `lookup` sends the request's ids to each shard's device, where the
  shard gathers the rows of the ids it owns (`ops/gather.gather_rows`
  with the owner mask; a hash shard probes first:
  `tables/hash_table.shard_probe` + `hash_find`), and merges the shards'
  rows on `devices[0]` in request order;
- `predict` runs the dense tower once, on `devices[0]`, over the request.

One process holds all T shards and serves every request itself: no ranks
are spawned and no collective runs (the JAX package serves over a device
mesh in one process; `torch.distributed` is one process per rank, which a
REST node is not). `devices` may repeat a card: T shards staged on one
device. The REST layer (`serving.py`) selects this path for a model
registered with `shard_num > 1` (`entry/controller.cc:100-205` places
`shard_num` shards the same way).
"""

from __future__ import annotations

import json
import os
import types
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..checkpoint import MODEL_META_FILE, store_rows
from ..convert import dense_to_flax, table_to_numpy, tables_from_numpy
from ..embedding import EmbeddingSpec, EmbeddingTableState, serve_rows
from ..export import (_BadRange, _dense_module, bucket_size,
                      load_model_config, pad_ids_to_bucket, pad_serving_batch)
from ..layers import Param
from ..meta import ModelMeta
from ..model import SAD_SCOPE, attach_ids
from ..ops import gather
from ..tables.hash_table import (fresh_keys, hash_find, hash_find_or_insert,
                                 shard_probe)

# the times a serving hash shard may grow by a quarter at load (to 2.44x
# JAX's size) before an id without a slot fails the load
HASH_GROWTHS = 4


def serving_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The shards' devices: `devices` as given (a device may repeat: shards
    staged on one card), or every CUDA card of the node (raises when there
    is none: the port never moves to the CPU on its own)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for sharded serving; pass "
                "devices=[...] (e.g. ['cpu'] * T) to choose them")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("sharded serving needs at least one device")
    return out


def _specs_from_meta(meta: ModelMeta) -> Dict[str, EmbeddingSpec]:
    """Enough of each variable's spec, rebuilt from the checkpoint meta, to
    serve it read-only (no initializer or optimizer needed)."""
    out = {}
    for v in meta.variables:
        table = v.table or {}
        out[v.storage_name] = EmbeddingSpec(
            name=v.storage_name,
            input_dim=v.meta.vocabulary_size,
            output_dim=v.meta.embedding_dim,
            datatype=v.meta.datatype,
            capacity=int(table.get("capacity", 0)),
            sparse_as_dense=bool(table.get("sparse_as_dense", False)),
            variable_id=v.variable_id,
        )
    return out


def _ckpt_hash_rows(path: str, variable_id: int) -> int:
    """The ids a checkpoint holds for one hash variable, read from the .npy
    headers (no data loaded). A serving table is sized from this, not from
    the training `capacity`: a host-cached variable's store holds far more
    rows than its device cache."""
    vdir = os.path.join(path, f"variable_{variable_id}")
    direct = os.path.join(vdir, "ids.npy")
    if os.path.exists(direct):
        return int(np.load(direct, mmap_mode="r").shape[0])
    total = 0
    for name in sorted(os.listdir(vdir)):
        p = os.path.join(vdir, name, "ids.npy")
        if name.startswith("shard_") and os.path.exists(p):
            total += int(np.load(p, mmap_mode="r").shape[0])
    return total


class _ServingState(types.SimpleNamespace):
    """A TrainState-shaped stand-in for the checkpoint loaders (`tables`,
    `dense`, `embeddings`, `dense_slots`, `step`, `model_version`): serving
    has no Trainer and must not pay for one."""


class _SpecsModel:
    """A model-shaped stand-in for the checkpoint loaders: the specs."""

    def __init__(self, specs: Dict[str, EmbeddingSpec]):
        self.specs = specs

    def ps_specs(self) -> Dict[str, EmbeddingSpec]:
        return {n: s for n, s in self.specs.items() if not s.sparse_as_dense}

    def sad_specs(self) -> Dict[str, EmbeddingSpec]:
        return {n: s for n, s in self.specs.items() if s.sparse_as_dense}


class _FlatDense(nn.Module):
    """The dense params of a checkpoint with no model recipe: one `Param`
    per flat flax name, so `convert.dense_from_flax` fills it and
    `dense_to_flax` gives the flat params back. It has no forward."""

    def __init__(self, flat: Dict[str, np.ndarray], device: torch.device):
        super().__init__()
        self._layers = {}
        self.params = nn.ModuleList()
        for k, v in flat.items():
            p = Param("zeros")
            p.set_value(torch.from_numpy(np.asarray(v, np.float32)).to(device))
            self._layers[k] = p
            self.params.append(p)

    def flax_dense(self) -> Dict[str, Param]:
        return dict(self._layers)


def _dense(model, flat: Dict[str, np.ndarray], device: torch.device
           ) -> nn.Module:
    """The servable's dense module on `device`: a copy of the model's, or
    the flat params of a checkpoint with no recipe."""
    if model is not None:
        return _dense_module(model, flat, device)
    return _FlatDense(flat, device)


def _load_shard(shim: _SpecsModel, path: str, sizes: Dict[str, int],
                dense: nn.Module, embeddings: Dict[str, torch.Tensor],
                rank: int, num_shards: int, device: torch.device):
    """Shard `rank` of the checkpoint's tables `sizes` ({name: rows}) on
    `device`: zero templates with no optimizer slots (the loader fills
    exactly what a template holds), filled in place by
    `parallel/checkpoint.load_sharded` -> (the tables, the state)."""
    from .checkpoint import load_sharded
    shard = {}
    for name, rows in sizes.items():
        spec = shim.specs[name]
        hashed = spec.use_hash_table
        shard[name] = EmbeddingTableState(
            weights=torch.zeros((rows, spec.output_dim), dtype=spec.dtype,
                                device=device),
            slots={},
            keys=fresh_keys(rows, device=device) if hashed else None,
            overflow=(torch.zeros((), dtype=torch.int32, device=device)
                      if hashed else None))
    state = _ServingState(tables=shard, dense=dense, embeddings=embeddings,
                          dense_slots={}, step=0, model_version=0)
    load_sharded(state, shim, path, num_shards=num_shards, rank=rank)
    return shard, state


class ShardedModel:
    """A checkpoint served from T table shards, shard r on `devices[r]`:
    read-only pulls and predict.

    `load()` reads both checkpoint layouts (sharded or single) written at
    any mesh size. `model` (an `EmbeddingModel`) or the checkpoint's
    `model_config.json` recipe enables `predict`; `lookup` works without.
    `tables[name]` is the list of a table's T shards (weights, and a hash
    table's keys and overflow counter; no slots)."""

    def __init__(self, meta: ModelMeta, specs: Dict[str, EmbeddingSpec],
                 tables: Dict[str, List[EmbeddingTableState]],
                 dense: nn.Module, embeddings: Dict[str, torch.Tensor],
                 devices: List[torch.device], model=None):
        self.meta = meta
        self.specs = specs
        self.tables = tables
        self.dense = dense
        self.embeddings = embeddings  # sparse_as_dense tables, on devices[0]
        self.devices = devices
        self.num_shards = len(devices)
        self.model = model
        # the training step and model_version of the loaded weights (the
        # version online sync negotiates, as `StandaloneModel.step`)
        self.step = 0
        self.model_version = 0
        # hash tables' sorted resident ids; made once per servable, so
        # concurrent REST threads at worst compute it twice
        self._resident_cache: Dict[str, np.ndarray] = {}

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(cls, path: str, *, devices: Optional[Sequence] = None,
             model=None) -> "ShardedModel":
        """Load a checkpoint as len(devices) shards (None = every CUDA
        card).

        A hash shard is sized as the JAX package sizes it, about 0.7 full
        of the checkpoint's ids. Where an id finds no slot within the probe
        budget there, the shard grows by a quarter and loads again, up to
        `HASH_GROWTHS` times (JAX raises at once); past that the load
        raises RuntimeError.

        `path` may be a URI of a registered filesystem (`utils/fs`): the
        checkpoint is staged to a local temporary directory first (the
        loaders are random-access), as `Trainer.load` stages it."""
        from ..utils import fs as fsmod
        if fsmod.is_remote(path):
            with fsmod.staged(path) as local:
                return cls.load(local, devices=devices, model=model)
        path = fsmod.split_uri(os.fspath(path))[1]
        devices = serving_devices(devices)
        T = len(devices)
        with open(os.path.join(path, MODEL_META_FILE)) as f:
            meta = ModelMeta.from_json(f.read())
        if model is None:
            model = load_model_config(path)
        specs = (dict(model.specs) if model is not None
                 else _specs_from_meta(meta))
        shim = _SpecsModel(specs)

        with np.load(os.path.join(path, "dense_params.npz")) as z:
            flat = {k: z[k] for k in z.files
                    if not k.startswith(SAD_SCOPE + "/")}
        dense = _dense(model, flat, devices[0])
        embeddings = {
            name: torch.zeros((spec.input_dim, spec.output_dim),
                              dtype=spec.dtype, device=devices[0])
            for name, spec in shim.sad_specs().items()}

        sizes = {}
        for name, spec in shim.ps_specs().items():
            if spec.use_hash_table:
                # the checkpoint's ids + 43% open-addressing headroom, at
                # least one probe window a shard
                need = _ckpt_hash_rows(path, spec.variable_id)
                sizes[name] = max(-(-need * 10 // (7 * T)), 64)
            else:
                sizes[name] = spec.rows_per_shard(T)
        tables = {name: [] for name in sizes}
        step = model_version = 0
        for r, dev in enumerate(devices):
            shard, state = _load_shard(shim, path, sizes, dense, embeddings,
                                       r, T, dev)
            for _ in range(HASH_GROWTHS):
                # a hash shard where an id found no slot in its probe
                # budget grows by a quarter and loads again
                short = {n for n, ts in shard.items()
                         if ts.overflow is not None and int(ts.overflow)}
                if not short:
                    break
                grown = {n: shard[n].weights.shape[0] * 5 // 4
                         for n in short}
                again, _ = _load_shard(_SpecsModel({
                    n: specs[n] for n in short}), path, grown, dense, {}, r,
                    T, dev)
                shard.update(again)
            for name, ts in shard.items():
                if ts.overflow is not None and int(ts.overflow) > 0:
                    # a serving table must hold every checkpointed row:
                    # zeros for dropped ids would be wrong answers
                    raise RuntimeError(
                        f"variable {name!r}: {int(ts.overflow)} "
                        "checkpointed ids did not fit the serving hash "
                        f"table (shard {r} of {T}, {ts.keys.shape[0]} "
                        "slots)")
                tables[name].append(ts)
            step, model_version = state.step, state.model_version
        out = cls(meta, specs, tables, dense, embeddings, devices,
                  model=model)
        out.step = int(step)
        out.model_version = int(model_version)
        return out

    # -- reads -----------------------------------------------------------------

    @property
    def variable_names(self) -> List[str]:
        return list(self.specs)

    def lookup(self, name: str, ids) -> torch.Tensor:
        """Read-only sharded pull -> ids.shape + (dim,) on `devices[0]`;
        absent, negative and out-of-range ids give zero rows (the
        reference's `read_only_pull`, `EmbeddingPullOperator.cpp:149-205`).
        The flat id count pads to a power-of-two bucket (pad id -1)."""
        spec = self.specs[name]
        raw = np.asarray(ids)
        flat = raw.reshape(-1).astype(np.int64)
        n = flat.shape[0]
        rows = self._lookup_raw(name, pad_ids_to_bucket(flat))[:n]
        return rows.reshape(raw.shape + (spec.output_dim,))

    def _lookup_raw(self, name: str, flat: np.ndarray) -> torch.Tensor:
        """Flat int64 host ids (n,) -> (n, dim) rows on `devices[0]`. The
        ids go up once to each shard's device; there every shard gathers
        the ids it owns (`id % T == r`, local row `id // T`; a hash shard
        its probe's slots, `shard_probe` masking the others) and zero rows
        for the rest; the rows come to `devices[0]` and are merged by
        owner (`torch.where`, a selection: bit for bit)."""
        spec = self.specs[name]
        dev0 = self.devices[0]
        host = torch.from_numpy(flat)
        if spec.sparse_as_dense:
            return gather.gather_rows(self.embeddings[name], host.to(dev0))
        T = self.num_shards
        on = {}  # the ids on each device, uploaded once
        out = None
        for r, ts in enumerate(self.tables[name]):
            dev = ts.weights.device
            ids = on.get(dev)
            if ids is None:
                ids = on[dev] = host.to(dev)
            if spec.use_hash_table:
                mine, probe = shard_probe(ids, r, T)
                rows = gather.gather_rows(ts.weights,
                                          hash_find(ts.keys, probe), mine)
            else:
                mine = ((ids >= 0) & (ids < spec.input_dim)
                        & (torch.remainder(ids, T) == r))
                rows = gather.gather_rows(
                    ts.weights, torch.div(ids, T, rounding_mode="floor"),
                    mine)
            rows = rows.to(dev0)
            out = rows if out is None else torch.where(
                mine.to(dev0)[:, None], rows, out)
        return out

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Forward pass -> the first n rows of the module's output on
        `devices[0]`: sparse pulls from the shards, the dense tower once on
        `devices[0]`. The request pads to a power-of-two bucket. Needs the
        module recipe (model_config.json, or `model=` at load)."""
        if self.model is None:
            raise ValueError(
                "checkpoint has no model_config recipe; pass the "
                "EmbeddingModel to ShardedModel.load(path, model=...)")
        from ..utils import sketch
        # the batch size comes from a REQUIRED feature: a missing one raises
        # KeyError(name), which the REST layer maps to 400
        first = self.specs[next(iter(self.specs))].feature_name
        n = np.asarray(batch["sparse"][first]).shape[0]
        # heavy-hitter telemetry: the raw request ids per feature
        for fname, fids in batch["sparse"].items():
            sketch.record_ids(fname, fids)
        padded = pad_serving_batch(batch, n, bucket_size(n))
        dev0 = self.devices[0]
        embedded = {
            name: serve_rows(spec, padded["sparse"][spec.feature_name],
                             lambda i, name=name: self.lookup(name, i))
            for name, spec in self.specs.items()}
        attach_ids(embedded, self.model, padded, dev0)
        dense = padded.get("dense")
        if dense is not None:
            dense = torch.from_numpy(np.ascontiguousarray(dense)).to(dev0)
        return self.dense(embedded, dense)[:n]

    # -- the live-replica export surface (`serving.restore_from_peer`): the
    # rows stream out through the sharded pull, so only the requesting peer
    # assembles a whole export (the reference's replica-iteration restore,
    # `server/EmbeddingRestoreOperator.cpp:19-106`) ---------------------------

    def _resident_ids(self, name: str) -> np.ndarray:
        """Sorted int64 ids resident in a hash table's shards."""
        cache = self._resident_cache
        if name not in cache:
            keys = np.concatenate([ts.keys.cpu().numpy()
                                   for ts in self.tables[name]])
            cache[name] = np.sort(keys[keys >= 0])
        return cache[name]

    def export_manifest(self) -> dict:
        """Row-iteration manifest: per variable its kind, resident row count
        and width; and the model_meta JSON that rewrites the export."""
        variables = []
        for v in self.meta.variables:
            spec = self.specs[v.storage_name]
            if spec.use_hash_table:
                kind = "hash"
                rows = int(self._resident_ids(v.storage_name).shape[0])
            else:
                kind, rows = "array", int(spec.input_dim)
            variables.append({"storage_name": v.storage_name,
                              "variable_id": v.variable_id,
                              "kind": kind, "rows": rows,
                              "dim": int(spec.output_dim)})
        cfg = self.model.config if self.model is not None else None
        return {"variables": variables,
                "meta": json.loads(self.meta.to_json()),
                "model_config": cfg}

    def export_rows(self, name: str, start: int, count: int
                    ) -> Dict[str, np.ndarray]:
        """Rows [start, start+count) of one variable in export order (hash:
        the id-sorted resident ids and their rows; array: global id
        order), read through the sharded pull."""
        spec = self.specs[name]
        if start < 0 or count < 0:
            raise _BadRange(f"bad row range [{start}, {start}+{count})")
        if spec.use_hash_table:
            ids = self._resident_ids(name)[start:start + count]
            return {"ids": ids,
                    "weights": table_to_numpy(self.lookup(name, ids))}
        stop = min(start + count, spec.input_dim)
        ids = np.arange(start, max(start, stop), dtype=np.int64)
        return {"weights": table_to_numpy(self.lookup(name, ids))}

    def export_dense(self) -> Dict[str, np.ndarray]:
        """Flat flax-named dense params (no sparse_as_dense tables)."""
        return dense_to_flax(self.dense)

    # -- online model sync (`sync/subscriber.py`) -----------------------------

    @torch.no_grad()
    def apply_update(self, tables: Dict[str, tuple],
                     dense_flat: Dict[str, Any], *, step: int,
                     model_version: Optional[int] = None) -> "ShardedModel":
        """One committed delta applied into a NEW servable (the RCU contract
        of `StandaloneModel.apply_update`): `self` is never written, and
        the new servable shares every shard the delta does not touch.

        `tables`: {name: (int64 ids, (n, dim) float32 rows)}; `dense_flat`:
        the delta's whole flat dense tree, `__embeddings__/<name>` entries
        included (a sharded servable keeps its sparse_as_dense tables with
        the dense params). A touched array shard is cloned and its rows
        copied in at their local rows; a touched hash shard clones its keys
        and weights, finds or inserts the ids it owns (`shard_probe` +
        `hash_find_or_insert`) and copies the rows in at their slots. Every
        check runs before anything is built; a hash delta that no longer
        fits the serving table raises RuntimeError (the servable needs a
        reload at a larger shard count). The cards' work has finished when
        this returns, so a swap never publishes a table still being
        written."""
        T = self.num_shards
        updates = {}
        for name, (ids64, rows) in tables.items():
            spec = self.specs.get(name)
            if spec is None:
                raise KeyError(f"delta updates unknown variable {name!r}")
            if spec.sparse_as_dense:
                continue  # rides in dense_flat's __embeddings__ entries
            ids64 = np.asarray(ids64, np.int64).reshape(-1)
            rows = store_rows(np.asarray(rows))
            if rows.shape != (ids64.size, spec.output_dim):
                raise ValueError(
                    f"delta rows for {name!r} have shape {rows.shape}, "
                    f"expected ({ids64.size}, {spec.output_dim}) — torn "
                    "payload?")
            if ids64.size == 0:
                continue
            if not spec.use_hash_table and not (
                    (ids64 >= 0) & (ids64 < spec.input_dim)).all():
                raise ValueError(
                    f"delta ids for array variable {name!r} fall outside "
                    f"[0, {spec.input_dim}) — wrong model or torn payload")
            updates[name] = (ids64, rows)

        sad_prefix = SAD_SCOPE + "/"
        cur = {k: v.shape for k, v in self.export_dense().items()}
        cur.update({sad_prefix + n: tuple(t.shape)
                    for n, t in self.embeddings.items()})
        if set(dense_flat) != set(cur):
            raise ValueError(
                "delta dense tree does not match the servable's: "
                f"missing {sorted(set(cur) - set(dense_flat))[:3]}, "
                f"unexpected {sorted(set(dense_flat) - set(cur))[:3]}")
        for k, shape in cur.items():
            v = np.asarray(dense_flat[k])
            if v.shape != tuple(shape):
                raise ValueError(f"delta dense param {k!r} has shape "
                                 f"{v.shape}, expected {tuple(shape)}")

        dev0 = self.devices[0]
        new_tables = dict(self.tables)
        for name, (ids64, rows) in updates.items():
            spec = self.specs[name]
            shards = list(self.tables[name])
            owner = ids64 % T
            for r in np.unique(owner):
                sel = np.flatnonzero(owner == r)
                ts = shards[r]
                dev = ts.weights.device
                src = torch.from_numpy(rows[sel]).to(dev).to(ts.weights.dtype)
                weights = ts.weights.clone()
                if spec.use_hash_table:
                    keys = ts.keys.clone()
                    mine, probe = shard_probe(
                        torch.from_numpy(ids64[sel]).to(dev), int(r), T)
                    slot, lost = hash_find_or_insert(keys, probe)
                    if int(lost) > 0:
                        raise RuntimeError(
                            f"variable {name!r}: {int(lost)} delta ids did "
                            "not fit the serving hash table — reload the "
                            "model (larger shard count) to resume syncing")
                    placed = mine & (slot < keys.shape[0])
                    weights.index_copy_(0, slot[placed], src[placed])
                    shards[r] = EmbeddingTableState(
                        weights=weights, slots={}, keys=keys,
                        overflow=ts.overflow + lost)
                else:
                    weights.index_copy_(
                        0, torch.from_numpy(ids64[sel] // T).to(dev), src)
                    shards[r] = EmbeddingTableState(weights=weights,
                                                    slots={})
            new_tables[name] = shards

        flat = {k: np.asarray(v) for k, v in dense_flat.items()
                if not k.startswith(sad_prefix)}
        dense = _dense(self.model, flat, dev0)
        embeddings = {
            n: tables_from_numpy({"w": np.asarray(
                dense_flat[sad_prefix + n])}, device=dev0)["w"].to(t.dtype)
            for n, t in self.embeddings.items()}
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        out = ShardedModel(self.meta, self.specs, new_tables, dense,
                           embeddings, self.devices, model=self.model)
        out.step = int(step)
        out.model_version = (int(model_version) if model_version is not None
                             else self.model_version)
        cached = getattr(self, "_pooled_features_cache", None)
        if cached is not None:
            out._pooled_features_cache = cached
        return out
