"""Carry weights and training state between the JAX package's layout and
the port's.

Dense params travel as flat flax-named arrays (`Dense_0/kernel`,
`MLP_0/Dense_2/bias`, ...), the content of an export's `dense_params.npz`.
flax kernels are (in, out); the port's `Dense.weight` is (out, in). A raw
flax param (`self.param`: LR's `bias`, xDeepFM's `cin_<i>`, the two-tower's
`log_inv_temperature`, SASRec's `pos_emb`) is a `layers.Param` under the
same flat name, in the same layout. A flax `LayerNorm`'s `scale` and
`bias` are a `layers.LayerNorm`'s `weight` and `bias`. Dense
optimizer slots travel as flat names `<param>/<slot>` (`Dense_0/kernel/accum`,
the content of a checkpoint's `dense_slots.npz`) of (1, size) rows: a
kernel's slot row is laid out like the flax kernel flattened, so it is
transposed on the way like the kernel it belongs to.

A ZeRO mesh state's dense slots (`parallel/zero.py`) travel in their flat
form, `__zero__/<slot>` (the JAX MeshTrainer's `dense_slots["__zero__"]`):
a vector slot, the masters and the residual as rank blocks of the JAX
global arrays, a (1, 1) scalar slot replicated (`mesh_state_from_jax`,
`mesh_state_to_jax`).

sparse_as_dense tables travel in the dense params under
`__embeddings__/<name>` (rows, dim), and their slots as
`__embeddings__/<name>/<slot>` (1, rows * dim) rows, row-major in both
packages, so they need no relayout.

Hash tables travel as their keys: single-lane int64 keys (the JAX package
with 64-bit types on, the layout its tests run) by position, bit for bit;
split-pair uint32 keys (64-bit types off) by their resident ids, re-inserted
with `np_hash_insert`, their rows and slot rows moved along.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LayerNorm, Param, unmaterialized_copy
from .model import SAD_SCOPE

_SAD_PREFIX = SAD_SCOPE + "/"


def _zero():
    """`parallel/zero.py`, which names the ZeRO flat form (`__zero__/<slot>`
    here); imported on use, as it imports this module on use."""
    from .parallel import zero
    return zero


def _flax_dense(module: nn.Module):
    fn = getattr(module, "flax_dense", None)
    if fn is None:
        raise TypeError(f"{type(module).__name__} does not list its flax "
                        "names (no flax_dense())")
    return fn()


def dense_from_flax(flat: Mapping[str, np.ndarray], module: nn.Module
                    ) -> Dict[str, np.ndarray]:
    """Load flax-named flat params into `module` (on its current device, or
    the CPU for a module with no parameters yet). Every key must name a
    layer of the module, or a sparse_as_dense table (`__embeddings__/
    <name>`), which the module does not hold: those are returned, {name:
    table}. Layers with no key stay as they are. A module whose flax names
    depend on its inputs (DCN's and DLRM's, with or without dense
    features) reads its layout off the names first (`set_flax_layout`):
    it may never have run."""
    set_layout = getattr(module, "set_flax_layout", None)
    if set_layout is not None:
        set_layout(list(flat))
    layers = _flax_dense(module)
    by_layer: Dict[str, Dict[str, np.ndarray]] = {}
    sad = {}
    for key, value in flat.items():
        if key.startswith(_SAD_PREFIX):
            sad[key[len(_SAD_PREFIX):]] = value
            continue
        if isinstance(layers.get(key), Param):
            by_layer[key] = {"value": np.asarray(value)}
            continue
        path, _, leaf = key.rpartition("/")
        leaves = (("scale", "bias") if isinstance(layers.get(path), LayerNorm)
                  else ("kernel", "bias"))
        if path not in layers or leaf not in leaves:
            raise KeyError(f"flax param {key!r} has no counterpart in "
                           f"{type(module).__name__} (layers: "
                           f"{sorted(layers)})")
        by_layer.setdefault(path, {})[leaf] = np.asarray(value)
    device = next((p.device for p in module.parameters()),
                  torch.device("cpu"))
    for path, leaves in by_layer.items():
        if isinstance(layers[path], Param):
            layers[path].set_value(torch.tensor(leaves["value"]).to(device))
            continue
        if isinstance(layers[path], LayerNorm):
            if set(leaves) != {"scale", "bias"}:
                raise KeyError(f"flax layer {path!r} needs scale and bias")
            layers[path].set_parameters(
                torch.tensor(leaves["scale"], dtype=torch.float32).to(device),
                torch.tensor(leaves["bias"], dtype=torch.float32).to(device))
            continue
        if set(leaves) != {"kernel", "bias"}:
            raise KeyError(f"flax layer {path!r} needs both kernel and bias")
        kernel = torch.tensor(leaves["kernel"], dtype=torch.float32)
        bias = torch.tensor(leaves["bias"], dtype=torch.float32)
        layers[path].set_parameters(kernel.t().to(device), bias.to(device))
    return sad


def dense_to_flax(module: nn.Module,
                  embeddings: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, np.ndarray]:
    """The module's materialized `Dense` layers as flat flax-named float32
    arrays: kernels (in, out), biases (out,); then the sparse_as_dense
    `embeddings` given as `__embeddings__/<name>` (a bfloat16 table as its
    2-byte words, as `table_to_numpy` writes it)."""
    out = {}
    for path, layer in _flax_dense(module).items():
        if not layer.materialized:
            continue
        if isinstance(layer, Param):
            out[path] = layer.value.detach().cpu().numpy()
            continue
        if isinstance(layer, LayerNorm):
            out[f"{path}/scale"] = layer.weight.detach().cpu().numpy()
            out[f"{path}/bias"] = layer.bias.detach().cpu().numpy()
            continue
        out[f"{path}/kernel"] = layer.weight.detach().t().contiguous().cpu(
        ).numpy()
        out[f"{path}/bias"] = layer.bias.detach().cpu().numpy()
    for name, t in sorted((embeddings or {}).items()):
        out[_SAD_PREFIX + name] = table_to_numpy(t)
    return out


def tables_from_numpy(arrays: Mapping[str, np.ndarray], *, device
                      ) -> Dict[str, torch.Tensor]:
    """Table weights -> contiguous tensors on `device`. float32 tables keep
    their dtype; 2-byte bfloat16 tables (numpy has no bfloat16, so they
    arrive as a 2-byte void or ml_dtypes array) are reinterpreted bit for
    bit."""
    out = {}
    for name, arr in arrays.items():
        arr = np.require(arr, requirements=["C", "W"])  # copies only if needed
        if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                        or arr.dtype.name == "bfloat16"):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device).contiguous()
    return out


def flax_leaves(module: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """torch parameter name -> (flax param name, is a kernel)."""
    path_of = {id(layer): path for path, layer in _flax_dense(module).items()}
    out = {}
    for mod_name, mod in module.named_modules():
        path = path_of.get(id(mod))
        if path is None or not mod.materialized:
            continue
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, Param):
            out[f"{prefix}value"] = (path, False)
            continue
        if isinstance(mod, LayerNorm):
            out[f"{prefix}weight"] = (f"{path}/scale", False)
            out[f"{prefix}bias"] = (f"{path}/bias", False)
            continue
        out[f"{prefix}weight"] = (f"{path}/kernel", True)
        out[f"{prefix}bias"] = (f"{path}/bias", False)
    return out


def _relayout(row: np.ndarray, shape, is_kernel: bool, to_flax: bool
              ) -> np.ndarray:
    """A (1, size) slot row of a kernel with torch shape (out, in), between
    the torch layout and the flax (in, out) one; 1-wide slots and biases
    stay as they are."""
    if not is_kernel or row.size != shape[0] * shape[1]:
        return row
    out_f, in_f = shape
    grid = row.reshape(out_f, in_f) if to_flax else row.reshape(in_f, out_f)
    return np.ascontiguousarray(grid.T).reshape(1, -1)


def dense_slots_to_flax(module: nn.Module,
                        slots: Mapping[str, Mapping[str, torch.Tensor]]
                        ) -> Dict[str, np.ndarray]:
    """{torch param name or `__embeddings__/<name>`: {slot: (1, size)}} ->
    flat flax-named numpy rows; a ZeRO rank's flat form {`__zero__`: {slot:
    array}} -> `__zero__/<slot>` as it is."""
    zero = _zero()
    if zero.is_sharded_slots(slots):
        return {f"{zero.ZERO_KEY}/{k}": v.detach().cpu().numpy()
                for k, v in slots[zero.ZERO_KEY].items()}
    out = {}
    for pname, (fname, is_kernel) in flax_leaves(module).items():
        shape = tuple(module.get_parameter(pname).shape)
        for sname, row in slots[pname].items():
            out[f"{fname}/{sname}"] = _relayout(
                row.detach().cpu().numpy(), shape, is_kernel, to_flax=True)
    for key in sorted(k for k in slots if k.startswith(_SAD_PREFIX)):
        for sname, row in slots[key].items():
            out[f"{key}/{sname}"] = row.detach().cpu().numpy()
    return out


def dense_slots_from_flax(flat: Mapping[str, np.ndarray], module: nn.Module,
                          *, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat flax-named slot rows -> {torch param name: {slot: tensor}} for
    every parameter of the (materialized) module, and {`__embeddings__/
    <name>`: {slot: tensor}} for every sparse_as_dense table in `flat`.
    ZeRO flat slots (`__zero__/<slot>`) -> {`__zero__`: {slot: tensor}}."""
    key = _zero().ZERO_KEY
    if any(k.startswith(key + "/") for k in flat):
        return {key: {k[len(key) + 1:]: torch.tensor(
            np.asarray(v, np.float32), device=device)
            for k, v in flat.items()}}
    by_param: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        param, _, slot = key.rpartition("/")
        by_param.setdefault(param, {})[slot] = np.asarray(value, np.float32)
    out = {key: {sname: torch.tensor(row, device=device)
                 for sname, row in rows.items()}
           for key, rows in by_param.items() if key.startswith(_SAD_PREFIX)}
    for pname, (fname, is_kernel) in flax_leaves(module).items():
        shape = tuple(module.get_parameter(pname).shape)
        out[pname] = {
            sname: torch.tensor(_relayout(row, shape, is_kernel,
                                          to_flax=False), device=device)
            for sname, row in by_param.get(fname, {}).items()}
    return out


def table_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A table on the host as the JAX package writes it: float32 as it is,
    bfloat16 as its 2-byte words (numpy's "V2", what `np.save` of an
    ml_dtypes bfloat16 array writes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def train_state_from_jax(model, *, tables: Mapping[str, Mapping],
                         dense_params: Mapping[str, np.ndarray],
                         dense_slots: Mapping[str, np.ndarray],
                         step: int = 0, model_version: int = 0, device):
    """A `TrainState` on `device` from the JAX package's state as numpy:
    `tables` {name: {"weights": (rows, dim), "slots": {slot: (rows, w)}}},
    a hash table's also with "keys" (either layout) and "overflow", flat
    flax-named `dense_params` and `dense_slots` (sparse_as_dense tables and
    their slots under `__embeddings__/`). A table's "ef" (rows, dim), "hot"
    {keys, rank, ids, weights, slots} and "mig" {keys, rank, ids, owners,
    weights, slots} come across where given (the mesh's placement state,
    single-lane probe keys). The parameters load into a dense module of
    the state's own (a copy of the model's, `layers.unmaterialized_copy`).
    ZeRO flat dense slots (`__zero__/<slot>`) stay flat."""
    from .embedding import EmbeddingTableState
    from .model import TrainState
    module = unmaterialized_copy(model.module)
    sad = dense_from_flax(dense_params, module)
    module.to(device)
    out_tables = {}
    for name, t in tables.items():
        # a copy: the state updates its tensors in place, and a CPU tensor
        # made from numpy would share the caller's array
        weights = np.array(t["weights"])
        slots = {k: np.asarray(v, np.float32) for k, v in t["slots"].items()}
        keys = overflow = None
        if t.get("keys") is not None:
            keys, weights, slots = _single_lane(np.asarray(t["keys"]),
                                                weights, slots)
            keys = torch.tensor(keys, device=device)
            overflow = torch.tensor(int(t.get("overflow", 0)),
                                    dtype=torch.int32, device=device)
        out_tables[name] = EmbeddingTableState(
            weights=tables_from_numpy({"w": weights}, device=device)["w"],
            slots={k: torch.tensor(v, device=device)
                   for k, v in slots.items()},
            keys=keys, overflow=overflow,
            ef=(None if t.get("ef") is None else
                torch.tensor(np.asarray(t["ef"], np.float32), device=device)),
            hot=_placement_from_jax(model.specs[name], t.get("hot"), "hot",
                                    device),
            mig=_placement_from_jax(model.specs[name], t.get("mig"), "mig",
                                    device))
    return TrainState(
        step=int(step), dense=module,
        dense_slots=dense_slots_from_flax(dense_slots, module, device=device),
        tables=out_tables, model_version=int(model_version),
        embeddings=tables_from_numpy(sad, device=device))


def _placement_from_jax(spec, part, kind: str, device):
    """A JAX `HotRows` / `MigRows` as numpy -> the port's, on `device`."""
    if part is None:
        return None
    from .embedding import HotRows, MigRows
    names = ("keys", "rank", "ids") + (("owners",) if kind == "mig" else ())
    ident = {k: np.asarray(part[k]) for k in names}
    if ident["keys"].ndim == 2:
        raise ValueError(
            f"{spec.name!r}: the {kind} probe table has split-pair keys; "
            "carry the state across from a JAX run with x64 on")
    rows = {"weights": tables_from_numpy({"w": np.asarray(part["weights"])},
                                         device=device)["w"],
            "slots": {k: torch.tensor(np.asarray(v, np.float32),
                                      device=device)
                      for k, v in part["slots"].items()}}
    tensors = {k: torch.tensor(v, device=device) for k, v in ident.items()}
    cls = HotRows if kind == "hot" else MigRows
    return cls(**tensors, **rows)


def _placement_to_jax(part) -> Optional[Dict]:
    if part is None:
        return None
    import dataclasses
    out = {f.name: getattr(part, f.name) for f in dataclasses.fields(part)}
    return {k: ({n: v.detach().cpu().numpy().copy() for n, v in t.items()}
                if k == "slots" else
                np.array(table_to_numpy(t), copy=True))
            for k, t in out.items()}


def _single_lane(keys: np.ndarray, weights: np.ndarray, slots):
    """A JAX hash table's keys -> (int64 keys, weights, slots) of the same
    table with single-lane keys: such keys as they are, split-pair keys
    re-inserted by their resident ids (rows of the slots no id takes keep
    their values)."""
    from .tables.hash_table import np_hash_insert, np_resident_ids
    if keys.ndim == 1:
        return keys.astype(np.int64), weights, slots
    sel, ids = np_resident_ids(keys)
    src = np.flatnonzero(sel)
    out = np.full(keys.shape[0], -1, np.int64)
    pos = np_hash_insert(out, ids)
    ok = pos >= 0

    def move(a):
        moved = a.copy()
        moved[pos[ok]] = a[src[ok]]
        return moved

    return out, move(weights), {k: move(v) for k, v in slots.items()}


def train_state_to_jax(state, *, rank_local: bool = False) -> Dict:
    """The state as numpy in the JAX package's layout: {"step",
    "model_version", "tables": {name: {"weights", "slots"}, with "keys"
    (int64, single-lane) and "overflow" for a hash table, and "ef", "hot"
    and "mig" where the table has them}, "dense_params":
    flat flax names, "dense_slots": flat flax names}. Every array is a
    copy: the train step updates the state's tensors in place, and a CPU
    tensor's `.numpy()` shares its memory.

    A ZeRO rank's flat dense slots are this rank's part of a mesh state
    only: they are refused unless `rank_local` (the form
    `mesh_state_to_jax` assembles); `MeshTrainer.externalize` gives the
    per-leaf form."""
    zero = _zero()
    if zero.is_sharded_slots(state.dense_slots) and not rank_local:
        raise ValueError(
            "the state's dense slots are in the ZeRO flat form "
            f"({zero.ZERO_KEY!r}), one rank's chunks: externalize it first "
            "(MeshTrainer.externalize), or pass rank_local=True for "
            "mesh_state_to_jax")

    def copies(flat):
        return {k: np.array(v, copy=True) for k, v in flat.items()}

    def table(t):
        out = {"weights": np.array(table_to_numpy(t.weights), copy=True),
               "slots": copies({k: v.detach().cpu().numpy()
                                for k, v in t.slots.items()})}
        if t.keys is not None:
            out["keys"] = t.keys.detach().cpu().numpy().copy()
            out["overflow"] = int(t.overflow)
        if t.ef is not None:
            out["ef"] = t.ef.detach().cpu().numpy().copy()
        for kind in ("hot", "mig"):
            if getattr(t, kind) is not None:
                out[kind] = _placement_to_jax(getattr(t, kind))
        return out

    return {
        "step": int(state.step), "model_version": int(state.model_version),
        "tables": {name: table(t) for name, t in state.tables.items()},
        "dense_params": copies(dense_to_flax(state.dense, state.embeddings)),
        "dense_slots": copies(dense_slots_to_flax(state.dense,
                                                  state.dense_slots)),
    }


def mesh_state_from_jax(jax_state: Mapping, model, num_shards: int,
                        rank: int, *, device):
    """Rank `rank`'s `TrainState` of a `parallel.MeshTrainer` over
    `num_shards` ranks, from the JAX MeshTrainer's state as numpy (the
    arguments of `train_state_from_jax`, each table's arrays global and
    shard-major, (S * rows_per_shard, ...)): rows `[r*rps, (r+1)*rps)` of
    every table array (the residuals "ef" and the migration annex too),
    and the replicated dense params, slots, hot caches and directories.
    ZeRO flat dense slots (`__zero__/<slot>`): rank r's block of a vector
    slot (1, S*C), of the residual (1, S*padded) and of the masters
    (1, padded); a (1, 1) scalar slot replicated."""
    def shard(a):
        a = np.asarray(a)
        rps = a.shape[0] // num_shards
        return a[rank * rps:(rank + 1) * rps]

    zero = _zero()
    prefix = zero.ZERO_KEY + "/"

    def dense_slot(key, a):
        if not (key.startswith(prefix)
                and zero.is_rank_block(key[len(prefix):], np.shape(a))):
            return a
        w = np.shape(a)[1] // num_shards
        return np.asarray(a)[:, rank * w:(rank + 1) * w]

    tables = {}
    for name, t in jax_state["tables"].items():
        out = {"weights": shard(t["weights"]),
               "slots": {k: shard(v) for k, v in t["slots"].items()}}
        if t.get("keys") is not None:
            out["keys"], out["overflow"] = shard(t["keys"]), t["overflow"]
        if t.get("ef") is not None:
            out["ef"] = shard(t["ef"])
        if t.get("hot") is not None:
            out["hot"] = t["hot"]
        if t.get("mig") is not None:
            out["mig"] = {**t["mig"], "weights": shard(t["mig"]["weights"]),
                          "slots": {k: shard(v) for k, v
                                    in t["mig"]["slots"].items()}}
        tables[name] = out
    rest = {k: v for k, v in jax_state.items() if k != "tables"}
    rest["dense_slots"] = {k: dense_slot(k, v)
                           for k, v in jax_state["dense_slots"].items()}
    return train_state_from_jax(model, tables=tables, device=device, **rest)


def mesh_state_to_jax(rank_states) -> Dict:
    """The inverse of `mesh_state_from_jax`: the ranks' states (in rank
    order, each as `train_state_to_jax` gives it on its rank,
    `rank_local=True` for a ZeRO state) as one state in the JAX
    MeshTrainer's layout, every table array assembled shard-major in rank
    order (the residuals and the migration annex too), the dense params,
    slots, counters, hot caches and directories rank 0's; ZeRO flat slots
    concatenated along their columns in rank order, a (1, 1) scalar slot
    rank 0's."""
    parts = list(rank_states)
    out = dict(parts[0])
    out["dense_slots"] = {}
    zero = _zero()
    prefix = zero.ZERO_KEY + "/"
    for k, v in parts[0]["dense_slots"].items():
        if k.startswith(prefix) and zero.is_rank_block(k[len(prefix):],
                                                       v.shape):
            v = np.concatenate([p["dense_slots"][k] for p in parts], axis=1)
        out["dense_slots"][k] = v
    out["tables"] = {}
    for name, t in parts[0]["tables"].items():
        every = [p["tables"][name] for p in parts]
        table = {"weights": np.concatenate([e["weights"] for e in every]),
                 "slots": {k: np.concatenate([e["slots"][k] for e in every])
                           for k in t["slots"]}}
        if "keys" in t:
            table["keys"] = np.concatenate([e["keys"] for e in every])
            table["overflow"] = t["overflow"]
        if "ef" in t:
            table["ef"] = np.concatenate([e["ef"] for e in every])
        if "hot" in t:
            table["hot"] = t["hot"]
        if "mig" in t:
            table["mig"] = {**t["mig"], "weights": np.concatenate(
                [e["mig"]["weights"] for e in every]), "slots": {
                k: np.concatenate([e["mig"]["slots"][k] for e in every])
                for k in t["mig"]["slots"]}}
        out["tables"][name] = table
    return out


# -- host-cached tables (`tables/host_offload.py`) -----------------------------


def offload_to_jax(ot) -> Dict:
    """A `HostOffloadTable` as numpy in the JAX package's layout: {"store":
    {"ids", "weights", "slots"} (drained first), "resident" (sorted int64
    ids), "ref" (their clock bits), "shard_counts", "overflow_flushed",
    "table": the cache as `train_state_to_jax` gives a hash table}. Every
    array is a copy."""
    ot.store.drain()
    t = ot.state
    return {
        "store": {"ids": ot.store.ids.copy(),
                  "weights": ot.store.weights.copy(),
                  "slots": {k: v.copy() for k, v in ot.store.slots.items()}},
        "resident": ot._resident_sorted.copy(), "ref": ot._ref.copy(),
        "shard_counts": ot._shard_counts.copy(),
        "overflow_flushed": int(ot._overflow_flushed),
        "table": {"weights": np.array(table_to_numpy(t.weights), copy=True),
                  "slots": {k: v.detach().cpu().numpy().copy()
                            for k, v in t.slots.items()},
                  "keys": t.keys.detach().cpu().numpy().copy(),
                  "overflow": int(t.overflow)}}


def offload_from_jax(source, ot) -> None:
    """Carry a JAX `HostOffloadTable` (read through `np.asarray`, any mesh
    size) or `offload_to_jax`'s dict into the port's `ot`, in place: the
    store (its pending chunks drained), the residency, its clock bits and
    shard counts, the banked overflow and the cache, whose tensors keep
    their identity. Split-pair uint32 keys (`keys.ndim == 2`) are joined
    to int64 and re-inserted by their ids (`np_hash_insert`): such a cache
    equals the JAX one by id, not slot for slot. On a mesh rank `ot`
    takes rank r's rows of a shard-major cache and the store rows it
    owns."""
    if not isinstance(source, Mapping):
        source.store.drain()
        st = source.state
        source = {
            "store": {"ids": source.store.ids,
                      "weights": source.store.weights,
                      "slots": source.store.slots},
            "resident": source._resident_sorted, "ref": source._ref,
            "shard_counts": source._shard_counts,
            "overflow_flushed": source._overflow_flushed,
            "table": {"weights": np.asarray(st.weights),
                      "slots": {k: np.asarray(v)
                                for k, v in st.slots.items()},
                      "keys": np.asarray(st.keys),
                      "overflow": int(np.asarray(st.overflow))}}
    S, r = ot.num_shards, ot.rank
    store = source["store"]
    ids = np.asarray(store["ids"], np.int64)
    mine = np.flatnonzero(ids % S == r)
    ot.store.replace_all(ids[mine], np.asarray(store["weights"])[mine],
                         {k: np.asarray(v)[mine]
                          for k, v in store["slots"].items()})
    ot._resident_sorted = np.asarray(source["resident"], np.int64).copy()
    ot._ref = np.asarray(source["ref"], bool).copy()
    ot._shard_counts = np.asarray(source["shard_counts"], np.int64).copy()
    ot._overflow_flushed = int(source["overflow_flushed"])
    ot._defer_count = 0
    ot._epoch += 1
    t = source["table"]
    rps = ot.rows_per_shard
    keys = np.asarray(t["keys"])
    weights = np.asarray(t["weights"])
    slots = {k: np.asarray(v, np.float32) for k, v in t["slots"].items()}
    if keys.ndim == 2:
        from .tables.hash_table import np_hash_insert, np_resident_ids
        sel, joined = np_resident_ids(keys)
        src = np.flatnonzero(sel)
        out = np.full(keys.shape[0], -1, np.int64)
        pos = np_hash_insert(out, joined, S)
        ok = pos >= 0

        def move(a):
            moved = a.copy()
            moved[pos[ok]] = a[src[ok]]
            return moved

        keys, weights = out, move(weights)
        slots = {k: move(v) for k, v in slots.items()}
    rows = slice(r * rps, (r + 1) * rps)
    dev = ot.state.weights.device
    with torch.no_grad():
        ot.state.keys.copy_(torch.from_numpy(np.array(keys[rows], np.int64)))
        ot.state.weights.copy_(tables_from_numpy(
            {"w": weights[rows]}, device=dev)["w"])
        for k, v in ot.state.slots.items():
            v.copy_(torch.from_numpy(np.array(slots[k][rows])))
        ot.state.overflow.fill_(int(t["overflow"]))
