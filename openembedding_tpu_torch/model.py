"""EmbeddingModel, its states and the single-device Trainer.

Port of `openembedding_tpu/model.py` for one device: `EmbeddingModel`,
`binary_logloss`, `IDS_KEY`/`attach_ids`, `sad_rows`, `WeightsState` (the
tables and dense module an export is written from), `TrainState`, the
dense-path optimizer reuse (`init_dense_slots`, `dense_apply`), `Trainer`
with its host-cached tables' drivers (`offload_prepare`, `offload_stage`,
`offload_train_many`, `offload_flush`, `offload_store_snapshots`;
`tables/host_offload.py`), its compiled steps (`CompiledStep`: a step, a
`train_many` window or `eval_step` as a CUDA graph) and its observability
hooks (the numerics sentinel, `halt_on_nonfinite`, `measure_every`, the
skew monitor; `utils/`).

The dense module is a `torch.nn.Module` called as `module(embedded, dense)`
where `embedded` maps variable name -> (B, ..., dim) pulled rows.

`sparse_as_dense` tables (the reference's 'Cache' mode) are dense leaves, as
in the JAX package, where they live in the dense params under the
`__embeddings__` scope: `TrainState.embeddings` holds them, their optimizer
slots sit in `TrainState.dense_slots` under `__embeddings__/<name>`, the
pull goes through `sad_rows` (the gather kernel, with a gradient) and
`dense_apply` updates the whole table every step.

Batch convention (as in the JAX package): {"sparse": {feature: int ids
(B,) or (B, F)}, "dense": optional float (B, D), "label": (B,), optional
"weight": (B,)}, as numpy arrays or tensors.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .device import resolve_device
from .embedding import (Embedding, EmbeddingSpec, EmbeddingTableState,
                        apply_gradients, combine, init_table,
                        init_table_state, lookup, lookup_train)
from .layers import materialize, unmaterialized_copy
from .ops.sparse import (lookup_rows, lookup_rows_trainable, pack_table,
                         packed_layout, sparse_apply_packed_table,
                         unpack_table)
from .tables.hash_table import hash_apply_gradients_packed
from .optimizers import Adagrad, SparseOptimizer
from .utils import phases as _phases
from .utils import trace as _trace


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy; `weight` makes it a weighted mean."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is None:
        return torch.mean(per)
    w = weight.reshape(-1).to(per.dtype)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


# Reserved key inside `embedded` for modules that declare `takes_ids = True`:
# maps variable name -> that variable's raw id batch.
IDS_KEY = "__ids__"

# The dense-param scope of the sparse_as_dense tables in the JAX package
# (`dense_params["__embeddings__"][name]`); their flat names in
# `dense_params.npz` and the keys of their dense slots are
# `__embeddings__/<name>`.
SAD_SCOPE = "__embeddings__"


def sad_key(name: str) -> str:
    return f"{SAD_SCOPE}/{name}"


def sad_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """A sparse_as_dense table's pull: the gather kernel (its plain version
    on the CPU) with a gradient to the whole table. -1 pads and
    out-of-range ids pull zero rows and train nothing, the invalid-id
    contract of every lookup path (`ops/sparse.lookup_rows_trainable`)."""
    return lookup_rows_trainable(table, ids)


def attach_ids(embedded: Dict[str, Any], model: "EmbeddingModel", batch,
               device=None) -> Dict[str, Any]:
    """Add `embedded[IDS_KEY]` ({variable name: its raw id batch}) iff the
    module opted in via `takes_ids`. Ids already on `device` are used as
    they are (the train step passes its device batch, so nothing is copied
    from the host inside a captured step)."""
    if getattr(model.module, "takes_ids", False):
        embedded[IDS_KEY] = {
            name: _to_device(batch["sparse"][spec.feature_name], device)
            for name, spec in model.specs.items()}
    return embedded


class EmbeddingModel:
    """A dense `nn.Module` + its embedding variables (variable ids assigned
    in declaration order, as in the JAX package)."""

    def __init__(self, module: nn.Module, embeddings: List[Embedding],
                 loss_fn: Callable = binary_logloss,
                 config: Optional[dict] = None):
        self.module = module
        self.config = config
        self.specs: Dict[str, EmbeddingSpec] = {}
        for i, e in enumerate(embeddings):
            spec = dataclasses.replace(e.spec, variable_id=i)
            if spec.name in self.specs:
                raise ValueError(f"duplicate embedding name {spec.name!r}")
            if spec.sparse_as_dense and spec.optimizer is not None:
                # sad tables train on the dense path with the trainer's
                # optimizer, as in the JAX package
                raise ValueError(
                    f"embedding {spec.name!r}: sparse_as_dense tables cannot "
                    "have a per-variable optimizer (they train with the "
                    "dense optimizer)")
            self.specs[spec.name] = spec
        self.loss_fn = loss_fn
        # optional batch -> batch function applied to the device batch at
        # the top of every train, eval and init path (the JAX package's hook
        # for shared Keras layers); it must be made of torch ops, so that a
        # captured step can replay it
        self.batch_transform = None

    def sad_specs(self) -> Dict[str, EmbeddingSpec]:
        """The sparse_as_dense variables: tables kept as dense leaves and
        trained by the dense path."""
        return {n: s for n, s in self.specs.items() if s.sparse_as_dense}

    def ps_specs(self) -> Dict[str, EmbeddingSpec]:
        """Every other variable: tables pulled and pushed row by row."""
        return {n: s for n, s in self.specs.items() if not s.sparse_as_dense}

    def dim_groups(self) -> List[List[str]]:
        """The pulled and pushed tables' names grouped by width, in
        declaration order: the unit of the mesh's fused exchange (the tables
        of a group share its three all_to_alls a step,
        `parallel/sharded.grouped_*`)."""
        groups: Dict[int, List[str]] = {}
        for name, spec in self.ps_specs().items():
            groups.setdefault(spec.output_dim, []).append(name)
        return list(groups.values())


@dataclasses.dataclass
class WeightsState:
    """What an export is written from: table weights by variable name, the
    dense module holding its parameters, and the step counters."""

    tables: Dict[str, torch.Tensor]
    dense: nn.Module
    step: int = 0
    model_version: int = 0


def _table_generator(seed: int, spec: EmbeddingSpec, device,
                     shard: Tuple[int, int] = (0, 1)) -> torch.Generator:
    """A table's own generator; a sparse_as_dense table draws from stream
    7919 + variable id, as the JAX package folds its key for them (the two
    frameworks' draws differ, only their distributions match). `shard`
    (r, S): shard r of a table split in S (`parallel.MeshTrainer`) draws
    from its own stream, so no rank builds the whole table; shard 0 of 1 is
    the whole table's."""
    stream = spec.variable_id + (7919 if spec.sparse_as_dense else 0)
    gen = torch.Generator(device=device)
    r, num = shard
    key = seed * 131071 + stream
    gen.manual_seed(key if num == 1 else (key * 65537 + r) * 4099 + num)
    return gen


def _to_device(x, device) -> torch.Tensor:
    """A tensor already on `device` is returned as it is (no copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _dense_to_device(x, device):
    """A batch's "dense": one tensor, or a dict of inputs keyed by name (a
    converted Keras model's several dense inputs)."""
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return _to_device(x, device)


def _batch_to_device(batch, device) -> Dict[str, Any]:
    out = {"sparse": {k: _to_device(v, device)
                      for k, v in batch["sparse"].items()}}
    for key in ("dense", "label", "weight"):
        if batch.get(key) is not None:
            out[key] = _dense_to_device(batch[key], device)
    return out


def _transformed(model: "EmbeddingModel", batch) -> Dict[str, Any]:
    """`model.batch_transform(batch)` when the model has one."""
    if model.batch_transform is None:
        return batch
    return model.batch_transform(batch)


def _materialize_dense(model: EmbeddingModel, tables: Dict[str, torch.Tensor],
                       sample_batch, seed: int, device) -> nn.Module:
    """A dense module of its own on `device`: a copy of `model.module`
    (`layers.unmaterialized_copy`, so the model's module stays the template
    whether or not something materialized it) whose parameters are created
    from one forward pass over `sample_batch` (already transformed),
    drawing from a generator seeded from `seed`. Every call returns a new
    module, as every JAX `init` returns new parameters. `tables` holds
    every variable's weights, sparse_as_dense ones included. A hash table
    holds no id yet, so its rows are zeros, as the JAX package's init feeds
    them."""
    embedded = {}
    for name, spec in model.specs.items():
        ids = _to_device(sample_batch["sparse"][spec.feature_name], device)
        if spec.use_hash_table:
            rows = torch.zeros(tuple(ids.shape) + (spec.output_dim,),
                               dtype=spec.dtype, device=device)
        else:
            rows = lookup_rows(tables[name], ids)
        # a combiner's pooling collapses the field axis, as in every step
        embedded[name] = combine(spec, ids, rows)
    attach_ids(embedded, model, sample_batch, device)
    dense = sample_batch.get("dense")
    if dense is not None:
        dense = _dense_to_device(dense, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    module = unmaterialized_copy(model.module).to(device)
    materialize(module, embedded, dense, generator=gen)
    return module


def init_weights(model: EmbeddingModel, sample_batch, *, seed: int = 0,
                 device=None) -> WeightsState:
    """Fresh weights on `device` (None = the CUDA card; raises without one).

    Every table draws from its own generator seeded from (seed, variable id);
    the dense module is materialized from one forward pass over
    `sample_batch` ({"sparse": {feature: ids}, "dense": ...}), drawing from a
    generator seeded from `seed`. A sparse_as_dense table is a table here
    like any other: an export serves it as an array table."""
    device = resolve_device(device)
    tables = {name: init_table(spec, _table_generator(seed, spec, device))
              for name, spec in model.specs.items()}
    sample = _transformed(model, _batch_to_device(sample_batch, device))
    dense = _materialize_dense(model, tables, sample, seed, device)
    return WeightsState(tables=tables, dense=dense)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """All training state: the step counters, the dense module (holding its
    parameters), the sparse_as_dense tables `embeddings` {name: (rows,
    dim)}, the dense optimizer slots {parameter name or
    `__embeddings__/<name>`: {slot: (1, size) float32}} (or, on a ZeRO
    mesh, their flat form {`parallel.zero.ZERO_KEY`: {slot: this rank's
    chunk}}) and the other tables {name: EmbeddingTableState}.

    The train step updates the tensors in place, the port's counterpart of
    the JAX package donating its state to the jitted step: a state passed to
    `Trainer.train_step` is the state it returns. `clone()` gives an
    independent copy."""

    step: int
    dense: nn.Module
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    tables: Dict[str, EmbeddingTableState]
    model_version: int = 0
    embeddings: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def clone(self) -> "TrainState":
        return copy.deepcopy(self)


def dense_leaves(module: nn.Module,
                 embeddings: Optional[Dict[str, torch.Tensor]] = None
                 ) -> List[Tuple[str, torch.Tensor]]:
    """(slot key, tensor) of every dense leaf: the module's parameters, then
    the sparse_as_dense tables as `__embeddings__/<name>` in name order (the
    order JAX flattens a dict in)."""
    out = list(module.named_parameters())
    out += [(sad_key(n), embeddings[n]) for n in sorted(embeddings or {})]
    return out


def init_dense_slots(optimizer: SparseOptimizer, module: nn.Module,
                     embeddings: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Slots for every dense leaf, each leaf a 1-row table of `numel`
    columns. A slot row is laid out like the leaf flattened in PyTorch's
    order ((out, in) for a `Dense` weight, row-major for a table)."""
    return {name: optimizer.init_slots(1, p.numel(), p.dtype,
                                       device=p.device)
            for name, p in dense_leaves(module, embeddings)}


def dense_grads(module: nn.Module, embeddings: Dict[str, torch.Tensor],
                sad_leaves: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """{slot key: gradient} of every dense leaf, in `dense_leaves` order:
    each parameter's `.grad`, each sparse_as_dense table's autograd leaf's
    (`sad_leaves[name]`), zeros where a leaf got none (as every leaf gets
    one in the JAX package)."""
    grads = {sad_key(n): leaf.grad for n, leaf in sad_leaves.items()}
    out = {}
    for name, p in dense_leaves(module, embeddings):
        g = grads[name] if name in grads else p.grad
        out[name] = torch.zeros_like(p) if g is None else g
    return out


@torch.no_grad()
def dense_apply(optimizer: SparseOptimizer, module: nn.Module,
                slots: Dict[str, Dict[str, torch.Tensor]],
                embeddings: Optional[Dict[str, torch.Tensor]],
                grads: Dict[str, torch.Tensor]) -> None:
    """The dense update, in place: each leaf from `grads[slot key]`
    (`dense_grads`, zeros for a leaf without a gradient, as every leaf
    takes one in the JAX package). A leaf runs through the sparse rule as a
    1-row table with count 1, in float32, and is cast back to its dtype; a
    table's rows without a gradient take the rule too, as in the JAX
    package. Leaves and slots keep their tensors (new values are copied
    in), so a captured step that replays reads this step's values."""
    for name, p in dense_leaves(module, embeddings):
        g = grads[name]
        ones = torch.ones(1, dtype=torch.int32, device=p.device)
        new_p, new_slots = optimizer.apply(
            p.reshape(1, -1).float(), slots[name],
            g.reshape(1, -1).float(), ones)
        p.copy_(new_p.reshape(p.shape))
        for k, v in new_slots.items():
            slots[name][k].copy_(v)


def _batch_slice(tree, k: int):
    """Step k of a stacked batch (every leaf has a leading K dim)."""
    if isinstance(tree, dict):
        return {key: _batch_slice(v, k) for key, v in tree.items()}
    return None if tree is None else tree[k]


def _batch_key(tree):
    """What a captured graph's static inputs depend on: every leaf's key,
    shape and dtype."""
    if isinstance(tree, dict):
        return tuple((key, _batch_key(v)) for key, v in sorted(tree.items()))
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).rsplit(".", 1)[-1]
    a = np.asarray(tree)
    return a.shape, str(a.dtype)


def _tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors_of(tree[k])]
    return [tree]


def _state_key(state: TrainState) -> tuple:
    """Which tensors a captured graph reads and writes: the address of every
    table, slot, placement and residual tensor, dense parameter and dense
    slot of the state (per leaf, or the ZeRO flat slots with their masters
    and residual). Loading a checkpoint rebinds some of them, and a graph
    would then update the old ones."""
    ptrs = []
    for ts in state.tables.values():
        ptrs += [t.data_ptr() for t in ts.tensors()]
    ptrs += [p.data_ptr() for _, p in dense_leaves(state.dense,
                                                    state.embeddings)]
    ptrs += [v.data_ptr() for v in _tensors_of(state.dense_slots)]
    return tuple(ptrs)


def _copy_batch(dst, src) -> None:
    """Copy a batch into device buffers of the same structure, in place."""
    if isinstance(dst, dict):
        for key, v in dst.items():
            _copy_batch(v, src[key])
    elif dst is not None:
        dst.copy_(src if isinstance(src, torch.Tensor)
                  else torch.as_tensor(np.asarray(src)))


class Trainer:
    """Trains an EmbeddingModel on one device (the CUDA card unless
    `device="cpu"` is asked for; raises when there is no card).

    A step applies the model's `batch_transform` (if any), pulls each
    table's rows through the gather kernel, runs the forward and backward
    pass of the dense module with autograd (the pulled rows are the leaves
    the table gradients come from; a sparse_as_dense table is itself a leaf,
    pulled by `sad_rows`), updates the dense parameters and the
    sparse_as_dense tables with `dense_apply`, and pushes the other tables'
    row gradients through the dedup and the fused apply kernel
    (`embedding.apply_gradients`). Every update happens in place.

    `train_step` and `train_many` run eagerly; `jit_train_step()` and
    `jit_train_many()` return callables that run them as CUDA graphs
    (`CompiledStep`). A batch whose tensors are already on the device (from
    `data.prefetch_to_device`) is used as it is, with no second copy."""

    def __init__(self, model: EmbeddingModel,
                 optimizer: Optional[SparseOptimizer] = None, seed: int = 0,
                 *, device=None, offload_pipeline: bool = False,
                 offload_densify: int = 1, offload_stage_depth: int = 1,
                 sentinel: bool = False, halt_on_nonfinite: bool = False,
                 measure_every: int = 0):
        self.model = model
        self.optimizer = optimizer or Adagrad()
        self.seed = seed
        self.device = resolve_device(device)
        # the numerics sentinel (`_sentinel_stats`): additive health stats
        # in the step's stats, folded into `health.*` gauges by
        # `record_step_stats`; off, the step and its graph are unchanged.
        # `halt_on_nonfinite` implies it and makes `record_step_stats`
        # raise `NonFiniteError` naming the offending table or phase
        self.halt_on_nonfinite = bool(halt_on_nonfinite)
        self.sentinel = bool(sentinel) or self.halt_on_nonfinite
        # sampled step timing (`utils/stepwatch.StepWatch`): one
        # `jit_train_step` call in N bracketed by synchronizes into
        # `trainer.step_ms`; 0 = off
        self.measure_every = int(measure_every)
        self._stepwatch = None
        # the heavy-hitter sketches' feed (`enable_skew_monitor`)
        self._skew = None
        # the host-cached tables' knobs (`tables/host_offload.py`): staging
        # a batch's store lookup and upload ahead on a worker
        # (`offload_stage`), up to `offload_stage_depth` batches ahead, and
        # `offload_densify` K: K eviction writebacks folded into one merge
        self.offload_pipeline = bool(offload_pipeline)
        self.offload_densify = int(offload_densify)
        self.offload_stage_depth = int(offload_stage_depth)
        # {name: HostOffloadTable} of the storage="host_cached" tables,
        # filled by `init`; empty when every table lives on the card
        self.offload: Dict[str, Any] = {}
        self._offload_prepared = False
        self._offload_many = None

    num_shards = 1  # MeshTrainer: the mesh's size

    # bumped when what a captured step holds stops being valid (the mesh's
    # bucket capacity grew): every `CompiledStep` then captures anew
    graph_epoch = 0

    def opt_for(self, spec: EmbeddingSpec) -> SparseOptimizer:
        return spec.optimizer or self.optimizer

    def _loss(self, logits, batch):
        """The weighted mean when the batch carries a per-sample weight. A
        batch may carry no label (the two-tower's in-batch negatives)."""
        w = batch.get("weight")
        if w is None:
            return self.model.loss_fn(logits, batch.get("label"))
        return self.model.loss_fn(logits, batch.get("label"), w)

    def _device_batch(self, batch) -> Dict[str, Any]:
        return _batch_to_device(batch, self.device)

    def init(self, sample_batch) -> TrainState:
        """Fresh state: each table from a generator seeded from (seed,
        variable id) as `init_weights` draws it, with its optimizer's slots
        (a sparse_as_dense table with the dense slots); the dense module
        from one forward pass over `sample_batch`."""
        model = self.model
        tables = {}
        for name, spec in model.ps_specs().items():
            if spec.storage == "host_cached":
                tables[name] = self._offload_table(spec).state
            else:
                tables[name] = init_table_state(
                    spec, self.opt_for(spec),
                    _table_generator(self.seed, spec, self.device))
        embeddings = {name: init_table(
                          spec, _table_generator(self.seed, spec,
                                                 self.device))
                      for name, spec in model.sad_specs().items()}
        sample = _transformed(model, self._device_batch(sample_batch))
        dense = _materialize_dense(
            model, {**{n: t.weights for n, t in tables.items()},
                    **embeddings}, sample, self.seed, self.device)
        return TrainState(
            step=0, dense=dense,
            dense_slots=init_dense_slots(self.optimizer, dense, embeddings),
            tables=tables, model_version=0, embeddings=embeddings)

    def _offload_table(self, spec: EmbeddingSpec):
        """A host-cached table's `HostOffloadTable` (a new one at every
        `init`, as the JAX package's `init_tables` makes it), kept in
        `self.offload`; on a `parallel.MeshTrainer` this rank's shard of the
        row-sharded cache."""
        from .tables.host_offload import HostOffloadTable
        old = self.offload.get(spec.name)
        if old is not None:
            old.close()
        ot = HostOffloadTable(
            spec, self.opt_for(spec), seed=self.seed,
            mesh=getattr(self, "mesh", None), device=self.device,
            pipeline=self.offload_pipeline, densify_k=self.offload_densify,
            stage_depth=self.offload_stage_depth)
        self.offload[spec.name] = ot
        return ot

    # -- checkpoints ---------------------------------------------------------

    def _stage_save(self, write_fn, path: str):
        """`write_fn(path)`; for a remote URI (`utils/fs`) `write_fn` writes
        into a local temporary directory, which is then pushed to the URI
        (`fs.stage_out`) and removed. Each rank pushes only the files it
        wrote, so the uploads of a sharded checkpoint compose."""
        from .utils import fs as fsmod
        if not fsmod.is_remote(path):
            return write_fn(fsmod.split_uri(path)[1])
        import shutil
        import tempfile
        local = tempfile.mkdtemp(prefix="oetpu_ckpt_out_")
        try:
            meta = write_fn(local)
            fsmod.stage_out(local, path)
            return meta
        finally:
            shutil.rmtree(local, ignore_errors=True)

    def _stage_load(self, read_fn, path: str):
        """`read_fn` of a local directory holding `path` (`fs.staged`: a
        remote URI is fetched into a temporary directory first)."""
        from .utils import fs as fsmod
        with fsmod.staged(path) as local:
            return read_fn(fsmod.split_uri(local)[1])

    def save(self, state: TrainState, path: str, **kw):
        """`checkpoint.save_server_model` of the state into `path`, a local
        directory or a URI of a registered filesystem (`utils/fs`: written
        locally, then pushed); pass `include_optimizer=False` to leave the
        optimizer slots out. A host-cached table writes its whole store, the
        residents written back first (`offload_store_snapshots`)."""
        from .checkpoint import save_server_model
        stores = self.offload_store_snapshots(state)
        return self._stage_save(lambda p: save_server_model(
            state, self.model, p, offload_stores=stores, **kw), path)

    def load(self, state: TrainState, path: str) -> TrainState:
        """`checkpoint.load_server_model` from `path` (a local directory, or
        a URI staged to local disk first) into `state`, in place; returns
        it. A sharded checkpoint (written by `parallel.MeshTrainer.save` at
        any mesh size) loads through `parallel/checkpoint.load_sharded`, as
        in the JAX package. A host-cached table loads into its store, its
        cache reset."""
        from .checkpoint import load_server_model
        from .parallel.checkpoint import checkpoint_layout, load_sharded

        def read(p):
            if checkpoint_layout(p) == "sharded":
                return load_sharded(state, self.model, p,
                                    offload=self._adopted(state))
            return load_server_model(state, self.model, p,
                                     offload=self._adopted(state))

        return self._stage_load(read, path)

    def _adopted(self, state: TrainState) -> Dict[str, Any]:
        """`self.offload`, each table holding `state`'s cache."""
        for name, ot in self.offload.items():
            ot.adopt(state.tables[name])
        return self.offload

    # -- host-cached tables (`tables/host_offload.py`) -----------------------
    #
    # The ids are known on the host from the input pipeline, so the trainer
    # drives the cache around the step:
    #
    #     state = trainer.offload_prepare(state, batch)   # admit / evict
    #     state, metrics = step(state, batch)             # the card's step
    #
    # For a K-step window, `offload_train_many` admits the union of the K
    # batches first.

    def offload_prepare(self, state: TrainState, batch) -> TrainState:
        """Admit the batch's ids (numpy or tensors; a stacked window's too)
        into each host-cached table's cache, evicting or flushing first
        where a cache would pass its high-water mark; returns `state`, its
        caches updated in place. No-op without host-cached tables. Also
        the per-batch hook the skew monitor rides (`record_batch_skew`)."""
        self.record_batch_skew(batch)
        if not self.offload:
            return state
        batch = self._host_transformed(batch)
        for name, ot in self._adopted(state).items():
            ot.prepare(batch["sparse"][self.model.specs[name].feature_name])
        self._offload_prepared = True  # train_many's guard
        return state

    def _host_transformed(self, batch):
        """The batch as the step sees it, its ids on the host: the model's
        `batch_transform` (torch ops) runs on CPU tensors."""
        if self.model.batch_transform is None:
            return batch
        return self.model.batch_transform(_batch_to_device(batch, "cpu"))

    def offload_stage(self, batch) -> None:
        """Start a future batch's store lookup and upload on each table's
        staging worker while the card runs the current step (no-op unless
        the trainer was built with `offload_pipeline=True`):

            trainer.offload_stage(batches[0])
            for i, batch in enumerate(batches):
                state = trainer.offload_prepare(state, batch)  # consumes
                if i + 1 < len(batches):
                    trainer.offload_stage(batches[i + 1])      # overlaps
                state, m = step(state, batch)

        With `offload_stage_depth=D` up to D batches may be staged ahead.
        A stage is a hint: `offload_prepare` checks it and takes the
        synchronous path where it no longer holds."""
        if not self.offload:
            return
        batch = self._host_transformed(batch)
        for name, ot in self.offload.items():
            ot.stage(batch["sparse"][self.model.specs[name].feature_name])

    def offload_flush(self, state: TrainState) -> TrainState:
        """Every resident row written back to the store and the caches
        reset, in place (end of training, or before handing tables
        elsewhere)."""
        for ot in self._adopted(state).values():
            ot.flush()
        return state

    def offload_store_snapshots(self, state: Optional[TrainState] = None
                                ) -> Dict[str, Any]:
        """{name: HostStore copy} with every resident row written back:
        what checkpoints, exports and persists write for a host-cached
        table (on a mesh rank, the rows it owns). Empty without host-cached
        tables."""
        if state is not None:
            self._adopted(state)
        out = {}
        for name, ot in self.offload.items():
            ot.sync_to_store()
            out[name] = ot.store.snapshot()
        return out

    def load_into(self, state: TrainState, fill) -> TrainState:
        """`fill(state)` writes a restored state into `state` in place
        (`persist.restore_server_model`); one device needs nothing around
        it (`parallel.MeshTrainer.load_into` does)."""
        fill(state)
        return state

    # -- observability (`utils/`) -------------------------------------------

    def enable_skew_monitor(self, monitor=None):
        """Feed every batch's ids, per table, into the heavy-hitter
        sketches (`utils/sketch.MONITOR` unless one is given) through
        `record_batch_skew`: a bounded-queue put per table per batch,
        dropped and counted in `skew.dropped_batches` when the sketch's
        worker falls behind."""
        from .utils import sketch
        self._skew = monitor if monitor is not None else sketch.MONITOR
        return self._skew

    def record_batch_skew(self, batch) -> None:
        """Enqueue one batch's per-table ids into the skew monitor (no-op
        until `enable_skew_monitor()`). Give it the HOST batch: a tensor on
        the card is read back, which waits for the card."""
        if self._skew is None:
            return
        batch = self._host_transformed(batch)
        sparse = batch.get("sparse") or {}
        for name, spec in self.model.ps_specs().items():
            ids = sparse.get(spec.feature_name)
            if ids is not None:
                if isinstance(ids, torch.Tensor):
                    ids = ids.detach().cpu().numpy()
                self._skew.observe(name, ids)

    def _sentinel_stats(self, loss: torch.Tensor,
                        dense_grads: Dict[str, torch.Tensor],
                        row_grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """The numerics sentinel's stats of this rank, every value additive
        so `reduce_metrics`'s sum over the ranks gives the global figure
        (the JAX package's `_sentinel_stats`): the loss's non-finite count,
        the sum of squares and non-finite count of the dense gradients
        before their reduce and of each table's row gradients, and at a
        narrow wire the sum of squares of each table's row gradients less
        their round trip through the wire codec. The dense leaves are laid
        end to end first, so the sentinel is a handful of launches whatever
        the number of leaves. Float32 sums, as in JAX (in another order:
        a few ulps apart); the counts are exact."""
        f32 = torch.float32
        out = {"health/loss_nonfinite":
               (~torch.isfinite(loss.to(f32))).sum().to(f32)}
        leaves = [g.reshape(-1).to(f32) for g in dense_grads.values()]
        if leaves:
            flat = torch.cat(leaves) if len(leaves) > 1 else leaves[0]
            out["health/dense_grad_sumsq"] = flat.square().sum()
            out["health/dense_grad_nonfinite"] = \
                (~torch.isfinite(flat)).sum().to(f32)
        else:
            zero = torch.zeros((), dtype=f32, device=self.device)
            out["health/dense_grad_sumsq"] = zero
            out["health/dense_grad_nonfinite"] = zero
        for name, g in row_grads.items():
            g = g.to(f32)
            out[f"{name}/grad_sumsq"] = g.square().sum()
            out[f"{name}/grad_nonfinite"] = (~torch.isfinite(g)).sum().to(f32)
            tf = self.wire_for(name) if self.num_shards > 1 else "fp32"
            if tf != "fp32" and g.dim() >= 2 and g.shape[-1] > 0:
                from .ops.wire import pack_inband, unpack_inband
                rows = g.reshape(-1, g.shape[-1])
                back = unpack_inband(pack_inband(rows, tf), rows.shape[-1],
                                     tf)
                out[f"{name}/quant_err_sumsq"] = (back - rows).square().sum()
        return out

    def _sentinel_ef_stats(self, state: TrainState
                           ) -> Dict[str, torch.Tensor]:
        """The sentinel's residual stats, read after the apply: each
        table's |ef| sum and its element count (a fill, never a host copy,
        so a graph captures it)."""
        out = {}
        for name in self.model.ps_specs():
            ef = state.tables[name].ef
            if ef is None:
                continue
            out[f"{name}/ef_abs_sum"] = ef.to(torch.float32).abs().sum()
            out[f"{name}/ef_elems"] = torch.full(
                (), float(ef.numel()), dtype=torch.float32, device=ef.device)
        return out

    def record_step_stats(self, step_metrics):
        """Fold one step's metrics through the registry
        (`utils/metrics.record_step_stats`: one device-to-host copy) and,
        with `halt_on_nonfinite=True`, raise `NonFiniteError` naming the
        offending tables or phases when the sentinel saw a non-finite loss
        or gradient (after a capsule is triggered). Returns the health
        summary. It waits for the step: call it after each step whose
        health is to be judged. A graph step's metrics are its static
        outputs, read here before the next replay overwrites them."""
        from .utils import metrics as _metrics
        stats = step_metrics
        if isinstance(step_metrics, dict) and "stats" in step_metrics:
            stats = step_metrics["stats"]
        health = _metrics.record_step_stats(stats)
        if self.halt_on_nonfinite and health.get("nonfinite"):
            from .utils import capsule as _capsule
            _capsule.trigger("nonfinite", offenders=health["nonfinite"])
            raise _metrics.NonFiniteError(health["nonfinite"])
        return health

    def _ensure_stepwatch(self):
        """This trainer's StepWatch (made once; None when `measure_every`
        <= 0), shared by the measured step and the input-wait lane."""
        if self.measure_every <= 0:
            return None
        if self._stepwatch is None:
            from .utils.stepwatch import StepWatch
            self._stepwatch = StepWatch(
                every=self.measure_every, device=self.device,
                wire_cost=lambda: getattr(self, "last_wire_cost", None))
        return self._stepwatch

    def _wrap_measured(self, fn):
        watch = self._ensure_stepwatch()
        return fn if watch is None else watch.wrap(fn)

    def input_timed(self, batches):
        """Wrap a batch iterator so the time the loop blocks on each
        `next()` lands in `trainer.input_wait_ms` (through this trainer's
        StepWatch when measurement is on)."""
        from .utils.stepwatch import timed_batches
        return timed_batches(batches, self._ensure_stepwatch())

    # -- overflow governance (the JAX package's hooks) ----------------------

    @staticmethod
    def overflow_count(metrics) -> int:
        """Exchange-bucket drops in a step's or window's metrics: always 0
        on one device, as in the JAX package's single-device Trainer (its
        MeshTrainer reads a real counter)."""
        del metrics
        return 0

    def check_overflow(self, metrics, **kw) -> bool:
        """The overflow-policy hook: nothing to do on one device."""
        del metrics, kw
        return False

    def table_overflow(self, state: TrainState, name: str) -> int:
        """Lifetime count of the ids a hash table's pulls found no slot for
        (0 for an array table); reads the device counter back to the host.
        A host-cached table's count includes what earlier caches banked
        (its device counter restarts at 0 at every flush)."""
        ts = state.tables.get(name)
        dev = 0 if ts is None or ts.overflow is None else int(ts.overflow)
        if name in self.offload:
            return self.offload[name]._overflow_flushed + dev
        return dev

    # -- the packed weights+slots layout of train_many ----------------------

    def _packed_layouts(self, state: TrainState) -> Dict[str, tuple]:
        """{name: column layout} of the tables `train_many` packs (see
        `ops/sparse.packed_layout`)."""
        out = {}
        for name, spec in self.model.ps_specs().items():
            ts = state.tables[name]
            lay = packed_layout(spec.output_dim, ts.slots, ts.weights.dtype)
            if lay is not None:
                out[name] = lay
        return out

    def _packed_apply(self, spec: EmbeddingSpec, table: EmbeddingTableState,
                      ids: torch.Tensor, grads: torch.Tensor, layout,
                      slot: Optional[torch.Tensor]) -> None:
        flat_ids = ids.reshape(-1)
        flat_grads = grads.reshape(-1, spec.output_dim)
        if spec.use_hash_table:
            hash_apply_gradients_packed(table, self.opt_for(spec), flat_ids,
                                        flat_grads, layout, spec.output_dim,
                                        slot=slot)
            return
        sparse_apply_packed_table(
            self.opt_for(spec), table.weights, layout, spec.output_dim,
            flat_ids, flat_grads)

    # -- the step's hooks (MeshTrainer overrides them, as the JAX package's
    # MeshTrainer does) ------------------------------------------------------

    def tables_pull(self, state: TrainState, ids: Dict[str, torch.Tensor],
                    packed: Dict[str, tuple]):
        """Pull every table's rows for the batch -> ({name: rows}, {name:
        plan}, stats). One device: each table's own pull; a hash table's
        plan is the slots its pull found (the push takes them), and its
        overflow is the stat `<table>_overflow`."""
        pulled, plans, stats = {}, {}, {}
        for name, spec in self.model.ps_specs().items():
            _, pulled[name], overflow, plans[name] = lookup_train(
                spec, state.tables[name], ids[name],
                out_dim=spec.output_dim if name in packed else None)
            if overflow is not None:
                stats[f"{name}_overflow"] = overflow
        return pulled, plans, stats

    def tables_apply(self, state: TrainState, ids: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], plans,
                     packed: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """Push every table's row gradients and update it in place ->
        stats (none on one device)."""
        for name, spec in self.model.ps_specs().items():
            if name in packed:
                self._packed_apply(spec, state.tables[name], ids[name],
                                   grads[name], packed[name], plans[name])
            else:
                apply_gradients(spec, state.tables[name], self.opt_for(spec),
                                ids[name], grads[name], slot=plans[name])
        return {}

    def dense_grad_stats(self, grads: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """Stats read off the dense gradients before their reduce (`grads`:
        `dense_grads`'s); they ride the step's stats. None on one device
        (`parallel.MeshTrainer(dense_stats=True)` gives
        `dense/grad_density`)."""
        del grads
        return {}

    def reduce_dense_grads(self, grads: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
        """The dense gradients (`dense_grads`'s) reduced for the dense
        apply. As they are on one device."""
        return grads

    def dense_update(self, state: TrainState,
                     grads: Dict[str, torch.Tensor]) -> None:
        """The dense optimizer update, in place, from the reduced gradients
        (`dense_grads`'s): `dense_apply` on every leaf. A ZeRO
        `parallel.MeshTrainer` replaces it with the sharded update."""
        dense_apply(self.optimizer, state.dense, state.dense_slots,
                    state.embeddings, grads)

    def reduce_module_state(self, module: nn.Module) -> None:
        """Frozen state that the forward pass updates (none in the port's
        modules). Nothing to do on one device."""
        del module

    def reduce_metrics(self, loss: torch.Tensor,
                       stats: Dict[str, torch.Tensor]):
        """-> (the loss to report, the stats). As they are on one device."""
        return loss, stats

    def hot_sync(self, state: TrainState) -> TrainState:
        """Write replicated hot rows back into their shards: the identity
        on one device, which holds no placement state
        (`parallel.MeshTrainer.hot_sync` is the mesh's)."""
        return state

    def externalize(self, state: TrainState) -> TrainState:
        """The state as a snapshot writer sees it: `hot_sync`'s. One device
        holds no sharded dense slots; a ZeRO `parallel.MeshTrainer` also
        unshards them (`dense_to_replicated`)."""
        return self.hot_sync(state)

    # -- steps ---------------------------------------------------------------

    def _step(self, state: TrainState, b: Dict[str, Any],
              packed: Dict[str, tuple]
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One step on a batch already on the device: transform -> pull ->
        forward/backward -> dense apply + sparse apply, in place -> (loss,
        logits, stats); on one device stats holds `<table>_overflow`, the
        ids each hash table's pull found no slot for this step. It copies
        nothing from the host and reads nothing back, so it can be captured
        as a CUDA graph. `packed`: {name: column layout} of the tables whose
        state holds the packed array. A hash table probes once a step: its
        push takes the slots its pull found, as the keys do not change
        between them. The pull and the push go through `tables_pull` and
        `tables_apply`, the dense gradients through `dense_grad_stats`,
        `reduce_dense_grads` and `dense_update`, the loss and stats through
        `reduce_metrics` (the hooks MeshTrainer overrides). Its phases
        (`utils/phases.phase`: a profiler range and a trace span each) are
        `trainer.pull` (the batch's transform and every table's pull, a hash
        table's `hash.probe_insert` inside it), then `_step_tail`'s
        `trainer.compute` and `trainer.apply`; they partition the step but
        for `reduce_metrics`."""
        with _phases.phase("trainer", "pull"):
            b = _transformed(self.model, b)
            ids = self._batch_ids(b)
            pulled, plans, stats = self.tables_pull(state, ids, packed)
        return self._step_tail(state, b, ids, pulled, plans, stats, packed)

    def _batch_ids(self, b: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """{table: its feature's ids} of a transformed batch."""
        return {name: b["sparse"][spec.feature_name]
                for name, spec in self.model.specs.items()}

    def _step_tail(self, state: TrainState, b: Dict[str, Any],
                   ids: Dict[str, torch.Tensor],
                   pulled: Dict[str, torch.Tensor], plans,
                   stats: Dict[str, torch.Tensor], packed: Dict[str, tuple],
                   before_apply: Optional[Callable[[], None]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Dict[str, torch.Tensor]]:
        """`_step` after its pull (the JAX package's `_train_step_tail`):
        the sparse_as_dense pulls, forward/backward, the dense and sparse
        applies, the metrics' reduce, on a transformed batch whose tables'
        rows `pulled` and `plans` already hold; the pipelined
        `MeshTrainer.train_many` feeds it rows prefetched a step ahead.
        `before_apply` runs just before the sparse apply (the pipelined
        loop's wait on its prefetch's serve). With the sentinel, its stats
        join `stats` before `reduce_metrics`. Its phases: `trainer.compute`
        (the pulled rows and the sparse_as_dense tables made autograd
        leaves, the sparse_as_dense pulls, forward, loss, backward, the
        dense gradients and their reduce) and `trainer.apply`, which holds
        `trainer.dense_apply` and `trainer.sparse_apply` (the push's dedup,
        `trainer.dedup`, inside it). As spans and ranges they time the host:
        an eager step or a capture. Under a timed driver
        (`jit_train_many(timed=True)`, `utils/phases.clocked`) each is also
        timed on the device at every replay of the graph."""
        sad_specs = self.model.sad_specs()
        with _phases.phase("trainer", "compute"):
            for rows in pulled.values():
                rows.requires_grad_()
            # each sparse_as_dense table enters autograd as a leaf that
            # shares its storage (dense_apply writes the table itself); its
            # pulled rows carry the gradient back to it
            sad_leaves = {name: state.embeddings[name].detach()
                          .requires_grad_() for name in sad_specs}
            for name in sad_specs:
                pulled[name] = sad_rows(sad_leaves[name], ids[name])
            embedded = {name: combine(spec, ids[name], pulled[name])
                        for name, spec in self.model.specs.items()}
            attach_ids(embedded, self.model, b, self.device)
            state.dense.zero_grad(set_to_none=True)
            logits = state.dense(embedded, b.get("dense"))
            loss = self._loss(logits, b)
            loss.backward()
            grads = dense_grads(state.dense, state.embeddings, sad_leaves)
            stats.update(self.dense_grad_stats(grads))
            if self.sentinel:
                with torch.no_grad():
                    stats.update(self._sentinel_stats(
                        loss.detach(), grads,
                        {name: pulled[name].grad
                         for name in self.model.ps_specs()}))
            grads = self.reduce_dense_grads(grads)
        with _phases.phase("trainer", "apply"):
            with _phases.phase("trainer", "dense_apply"):
                self.dense_update(state, grads)
                self.reduce_module_state(state.dense)
            with _phases.phase("trainer", "sparse_apply"), torch.no_grad():
                if before_apply is not None:
                    before_apply()
                stats.update(self.tables_apply(
                    state, ids, {name: pulled[name].grad
                                 for name in self.model.ps_specs()},
                    plans, packed))
                if self.sentinel:
                    stats.update(self._sentinel_ef_stats(state))
        loss, stats = self.reduce_metrics(loss.detach(), stats)
        return loss, logits.detach(), stats

    def train_step(self, state: TrainState, batch, *, timed: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One synchronous step: the batch to the device (`trainer.h2d`),
        then `_step`, in place. Returns (state, {"loss": (), "logits":
        (B,), "stats": {"<table>_overflow": () int32 per hash table, and
        with the sentinel its health stats}}); nothing is read back to the
        host (`record_step_stats` reads them). The JAX package's
        single-device step has no overflow stats (ROADMAP.md §C).
        `timed`: the step's phases are timed on the device and its
        counters kept (`_timed`)."""
        with record_function("trainer.h2d"):
            b = self._device_batch(batch)
        out = self._timed(lambda: self._step_metrics(state, b), timed)
        state.step += 1
        state.model_version += 1
        return state, out

    def _step_metrics(self, state: TrainState, b) -> Dict[str, Any]:
        loss, logits, stats = self._step(state, b, {})
        return {"loss": loss, "logits": logits, "stats": stats}

    def _timed(self, run: Callable[[], Dict[str, Any]], timed: bool
               ) -> Dict[str, Any]:
        """`run()`'s metrics; with `timed`, run inside a phase clock
        (`utils/phases.clocked`) and given its counters, each summed over
        the run's steps on the device: "distinct", the live unique rows of
        every push's dedup, "inserted", the slots the hash tables' pulls
        claimed, and "pending", the pulls' ids that met an empty slot on
        their walk (`tables/hash_table.py`); and "phases", the `PhaseClock`
        whose `ms()` reads the phases' device time."""
        with _phases.clocked(self.device, timed) as clock:
            out = run()
            if clock is not None:
                for name in ("distinct", "inserted", "pending"):
                    out[name] = clock.counters.get(name, torch.zeros(
                        (), dtype=torch.int64, device=self.device))
                out["phases"] = clock
        return out

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Read-only pulls (nothing inserted), the forward pass and the loss
        -> {"logits", "loss"}."""
        b = _transformed(self.model, self._device_batch(batch))
        embedded = {}
        for name, spec in self.model.ps_specs().items():
            ids = b["sparse"][spec.feature_name]
            embedded[name] = combine(
                spec, ids, lookup(spec, state.tables[name], ids))
        for name, spec in self.model.sad_specs().items():
            ids = b["sparse"][spec.feature_name]
            embedded[name] = combine(
                spec, ids, sad_rows(state.embeddings[name], ids))
        attach_ids(embedded, self.model, b, self.device)
        logits = state.dense(embedded, b.get("dense"))
        return {"logits": logits, "loss": self._loss(logits, b)}

    def _many(self, state: TrainState, b: Dict[str, Any]
              ) -> Dict[str, Any]:
        """The K steps of `train_many` on a stacked batch already on the
        device -> the window's metrics: {"loss": (K,), "overflow": ()
        int32, the steps' `_overflow` stats summed}. Packs at entry, runs
        the steps on the packed arrays (a hash table keeps its keys and
        counter apart, updated in place), copies the values back into the
        split tensors at exit; the state's split table objects are back in
        place whatever happens. The whole is the phase `trainer.window`."""
        self._check_offload_prepared()
        with _phases.phase("trainer", "window"):
            return self._many_steps(state, b)

    def _many_steps(self, state: TrainState, b: Dict[str, Any]
                    ) -> Dict[str, Any]:
        layouts = self._packed_layouts(state)
        split = {name: state.tables[name] for name in layouts}
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        try:
            for name, lay in layouts.items():
                ts = split[name]
                state.tables[name] = EmbeddingTableState(
                    weights=pack_table(ts.weights, ts.slots, lay), slots={},
                    keys=ts.keys, overflow=ts.overflow)
            losses = []
            for k in range(b["label"].shape[0]):
                loss, _, stats = self._step(state, _batch_slice(b, k),
                                            layouts)
                losses.append(loss)
                for key, v in stats.items():
                    if key.endswith("_overflow"):
                        overflow = overflow + v
            for name, lay in layouts.items():
                spec = self.model.specs[name]
                w, slots = unpack_table(state.tables[name].weights, lay,
                                        spec.output_dim, spec.dtype)
                split[name].weights.copy_(w)
                for k, v in slots.items():
                    split[name].slots[k].copy_(v)
        finally:
            state.tables.update(split)
        return {"loss": torch.stack(losses), "overflow": overflow}

    def train_many(self, state: TrainState, batches, *, timed: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K steps over stacked batches (every leaf has a leading K dim): the
        port of the JAX package's scan window. Tables that
        `ops/sparse.packed_layout` accepts (none on the card, where packing
        measured slower) run the K steps on the packed weights+slots array:
        packed at entry, copied back into the state's own split tensors at
        exit, so the state outside this function keeps the split layout.
        Equal to K `train_step` calls, bit for bit.
        Returns (state, {"loss": (K,), "overflow": ()}); "overflow" sums the
        steps' `<table>_overflow` stats, the ids the hash tables' pulls found
        no slot for in the window (0 without hash tables). `timed`: the
        window's phases are timed on the device and its counters kept
        (`_timed`)."""
        b = self._device_batch(batches)
        metrics = self._timed(lambda: self._many(state, b), timed)
        k_steps = metrics["loss"].shape[0]
        state.step += k_steps
        state.model_version += k_steps
        return state, metrics

    def _check_offload_prepared(self) -> None:
        """A window over host-cached tables needs the union of its batches
        admitted first: an unprepared cache would train initializer rows
        where the store holds trained ones."""
        if self.offload and not self._offload_prepared:
            raise ValueError(
                "train_many on storage='host_cached' tables needs the union "
                "of the K batches' ids admitted first: use "
                "trainer.offload_train_many(state, batches) (or call "
                "offload_prepare(state, batches) before every window).")

    def offload_train_many(self, state: TrainState, batches, *,
                           driver=None
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """A K-step window over host-cached tables: one admission of the
        union of the K batches' ids (evicting or flushing first where
        needed), then the window through `driver` (default: a
        `jit_train_many` the trainer keeps, a CUDA graph on the card; or
        `train_many`, or another `jit_train_many()`). Each cache must hold
        the union: size `capacity` (and K) so that the union stays under
        the high-water mark, or the admission warns and the ids that
        overflow train initializer rows. Without host-cached tables it is
        the plain window."""
        state = self.offload_prepare(state, batches)
        state, m = (driver or self._many_driver())(state, batches)
        self._adopted(state)
        return state, m

    def _many_driver(self):
        """The window driver `offload_train_many` keeps: `jit_train_many`."""
        if self._offload_many is None:
            self._offload_many = self.jit_train_many()
        return self._offload_many

    # -- compiled steps ------------------------------------------------------

    def jit_train_step(self, timed: bool = False) -> "CompiledStep":
        """`train_step` as a CUDA graph: `step(state, batch) -> (state,
        metrics)`, the state updated in place (see `CompiledStep`; `timed`:
        its phases timed at every replay). With `measure_every=N` the
        driver is wrapped in the trainer's StepWatch (one call in N
        measured); `jit_train_many` and `jit_eval_step` stay unwrapped, as
        in the JAX package."""
        return self._wrap_measured(CompiledStep(self, kind="step",
                                                timed=timed))

    def jit_train_many(self, timed: bool = False) -> "CompiledStep":
        """A whole `train_many` window (its K steps, and the pack and unpack
        where the gate packs) as one CUDA graph, one dispatch per window:
        the port's counterpart of the jitted scan (see `CompiledStep`;
        `timed`: its phases timed at every replay)."""
        return CompiledStep(self, kind="many", timed=timed)

    def jit_eval_step(self) -> "CompiledStep":
        """`eval_step` as a CUDA graph: `fn(state, batch) -> {"logits",
        "loss"}`, the graph's static outputs (clone to keep), bit-equal to
        the eager `eval_step`; captured and kept per batch structure and
        state as `jit_train_step`'s graphs are (see `CompiledStep`). On the
        CPU it runs `eval_step`."""
        return CompiledStep(self, kind="eval")


class CompiledStep:
    """`Trainer.train_step`, a `Trainer.train_many` window (`kind="many"`)
    or `Trainer.eval_step` (`kind="eval"`) captured as a CUDA graph. Called
    as `step(state, batch) -> (state, metrics)`, like the JAX package's
    jitted step functions, the state updated in place; the eval graph as
    `fn(state, batch) -> {"logits", "loss"}`, reading the state only.

    On the card:

    - The first call for a state and a batch structure (keys, leaf shapes
      and dtypes) runs the eager function once on a side stream (the
      warm-up; it is that call's real step) and then captures it on the same
      stream. The graph is kept for that structure, so a loop whose last
      batch of a pass is padded (it carries a "weight") keeps two graphs, as
      a jitted function keeps a compile per shape. Each graph holds its own
      memory pool, so at most `MAX_GRAPHS` are kept: a new structure beyond
      them drops the oldest graph. A call with another state object or a
      state whose tensors were replaced (`checkpoint.load_server_model`
      rebinds some), or after the trainer's `graph_epoch` moved (a mesh
      whose exchange capacity grew), drops every graph and captures anew.
    - Every later call copies the batch into its graph's static device
      buffers (outside the graph), replays the graph (one dispatch) and
      advances the state's step counters (a train step's).
    - `metrics` are the graph's static outputs ("loss", "logits" and
      "stats"; for a window what `train_many` returns: "loss" (K,) and
      "overflow", and a pipelined mesh window's "conflict" and
      "conflict_overflow"). The next call with the same batch structure
      overwrites them: a caller who keeps them across calls clones them.
    - Every update of the captured function writes in place, so a replay
      reads the state as the previous call left it. The graphs hold the
      state they were captured on, their buffers and the memory of their
      intermediates until they are captured anew or this object is
      dropped.
    - A capture that fails raises; nothing falls back to eager.
    - Kernel wrappers count launches while a graph is captured, not when it
      replays: `captures` and `replays` count the captures and the replays,
      `launches_captured` / `launches_replayed` sum what the captures
      counted and what the replays launched, per kernel, and
      `graph_launches` lists what one replay of each kept graph launches.
      The launches that ran are the wrappers' counts less
      `launches_captured` plus `launches_replayed`.
    - `collective_bytes`: the bytes of each collective kind that the last
      capture holds (`parallel/collectives.record_bytes`), what the
      trainer's StepWatch attributes a sampled step's time over. A replay
      runs no host code, so each call is one trace span: `trainer.capture`
      or `trainer.replay`; the step's phase spans fire at the warm-up and
      the capture only.
    - `timed=True` (not for eval): each graph is captured inside a phase
      clock of its own (`utils/phases`), so its phases are event-record
      nodes that every replay stamps on the device, and its metrics add the
      counters "distinct", "inserted" and "pending" (`Trainer._timed`).
      `phase_ms()` reads the last call's phases. The clock is kept in the
      graph's static outputs and dropped with the graph. Untimed, no event
      is made and the graph holds what it always did.

    On a Trainer made with device="cpu" a call runs the eager function."""

    MAX_GRAPHS = 4

    KINDS = ("step", "many", "eval")

    def __init__(self, trainer: Trainer, *, kind: str = "step",
                 timed: bool = False):
        if kind not in self.KINDS:
            raise ValueError(f"kind={kind!r}: expected one of {self.KINDS}")
        if timed and kind == "eval":
            raise ValueError("an eval graph has no phases to time")
        self.trainer = trainer
        self.kind = kind
        self.many = kind == "many"
        self.timed = timed
        self.captures = 0
        self.replays = 0
        self.launches_captured: Dict[str, int] = {}
        self.launches_replayed: Dict[str, int] = {}
        self.collective_bytes: Optional[Dict[str, int]] = None
        self._stream = None
        self._release()

    def _release(self) -> None:
        # batch key -> (graph, static inputs, static outputs, launches)
        self._graphs: Dict[Any, tuple] = {}
        self._clock = None  # the last call's PhaseClock (timed)
        self._state = self._state_ptrs = None
        self._epoch = self.trainer.graph_epoch

    @property
    def graph_launches(self) -> List[Dict[str, int]]:
        """What one replay of each kept graph launches, per kernel, in the
        order of their captures."""
        return [dict(g[3]) for g in self._graphs.values()]

    def _run(self, state: TrainState, b) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        if self.kind == "eval":
            return tr.eval_step(state, b)
        if self.many:
            return tr._timed(lambda: tr._many(state, b), self.timed)
        return tr._timed(lambda: tr._step_metrics(state, b), self.timed)

    def phase_ms(self) -> Dict[str, float]:
        """{phase: device ms summed over the last call's steps} of a timed
        driver (`trainer.window` once, for a window), each step's phases
        also observed in the `<phase>.device_ms` histograms; {} before a
        timed call. It waits on the last call's final event alone. A nested
        phase counts whole, inside its parent's figure too."""
        if self._clock is None:
            return {}
        return self._clock.ms(observe=True)

    def _advance(self, state: TrainState, batch) -> None:
        if self.kind == "eval":
            return
        k = len(batch["label"]) if self.many else 1
        state.step += k
        state.model_version += k

    def _result(self, state: TrainState, metrics):
        if self.timed:
            self._clock = metrics["phases"]
        return metrics if self.kind == "eval" else (state, metrics)

    def __call__(self, state: TrainState, batch):
        tr = self.trainer
        if tr.device.type != "cuda":
            if self.kind == "eval":
                return tr.eval_step(state, batch)
            state, out = (
                tr.train_many(state, batch, timed=self.timed) if self.many
                else tr.train_step(state, batch, timed=self.timed))
            return self._result(state, out)
        if self.many:
            tr._check_offload_prepared()
        key = _batch_key(batch)
        if (state is not self._state or _state_key(state) != self._state_ptrs
                or tr.graph_epoch != self._epoch):
            self._release()  # the old graphs' memory goes first
        if key not in self._graphs:
            if len(self._graphs) == self.MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            with _trace.span("trainer", "capture"):
                return self._capture(state, batch, key)
        graph, static_in, static_out, launches = self._graphs[key]
        with _trace.span("trainer", "replay"):
            with record_function("trainer.h2d"):
                _copy_batch(static_in, batch)
            with record_function("trainer.replay"):
                graph.replay()
        self.replays += 1
        for k, n in launches.items():
            self.launches_replayed[k] = self.launches_replayed.get(k, 0) + n
        self._advance(state, batch)
        return self._result(state, static_out)

    def _capture(self, state: TrainState, batch, key):
        from .ops import launch_counts
        from .parallel.collectives import record_bytes
        tr = self.trainer
        if self._stream is None:
            self._stream = torch.cuda.Stream(tr.device)
        stream = self._stream
        with record_function("trainer.h2d"):
            static_in = tr._device_batch(batch)
        main = torch.cuda.current_stream(tr.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = self._run(state, static_in)  # the warm-up: a real step
        main.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # thread_local: other threads (a prefetch producer staging the
        # next batches) may allocate and copy while this thread captures
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"), \
                record_bytes() as seen:
            static_out = self._run(state, static_in)
        self.collective_bytes = dict(seen)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        for k, n in launches.items():
            self.launches_captured[k] = self.launches_captured.get(k, 0) + n
        self.captures += 1
        self._state, self._state_ptrs = state, _state_key(state)
        self._graphs[key] = (graph, static_in, static_out, launches)
        self._advance(state, batch)
        return self._result(state, out)  # the warm-up: this call's real run
