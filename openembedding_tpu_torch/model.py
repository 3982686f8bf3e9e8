"""EmbeddingModel, its states and the single-device Trainer.

Port of `openembedding_tpu/model.py` for one device: `EmbeddingModel`,
`binary_logloss`, `IDS_KEY`/`attach_ids`, `WeightsState` (the tables and
dense module an export is written from), `TrainState`, the dense-path
optimizer reuse (`init_dense_slots`, `dense_apply`) and `Trainer`.

The dense module is a `torch.nn.Module` called as `module(embedded, dense)`
where `embedded` maps variable name -> (B, ..., dim) pulled rows.

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
from .layers import materialize
from .optimizers import Adagrad, SparseOptimizer


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


def attach_ids(embedded: Dict[str, Any], model: "EmbeddingModel", batch,
               device=None) -> Dict[str, Any]:
    """Add `embedded[IDS_KEY]` ({variable name: its raw id batch}) iff the
    module opted in via `takes_ids`."""
    if getattr(model.module, "takes_ids", False):
        embedded[IDS_KEY] = {
            name: torch.as_tensor(np.asarray(
                batch["sparse"][spec.feature_name]), device=device)
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
            self.specs[spec.name] = spec
        self.loss_fn = loss_fn
        # optional batch -> batch function run ahead of every step (the JAX
        # package's hook for shared Keras layers); the port's Trainer
        # refuses it until it is ported
        self.batch_transform = None


@dataclasses.dataclass
class WeightsState:
    """What an export is written from: table weights by variable name, the
    dense module holding its parameters, and the step counters."""

    tables: Dict[str, torch.Tensor]
    dense: nn.Module
    step: int = 0
    model_version: int = 0


def _table_generator(seed: int, spec: EmbeddingSpec, device
                     ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 131071 + spec.variable_id)
    return gen


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _materialize_dense(model: EmbeddingModel, tables: Dict[str, torch.Tensor],
                       sample_batch, seed: int, device) -> nn.Module:
    """Create the dense module's parameters on `device` from one forward
    pass over `sample_batch`, drawing from a generator seeded from `seed`."""
    embedded = {
        name: lookup(spec, tables[name], _to_device(
            sample_batch["sparse"][spec.feature_name], device))
        for name, spec in model.specs.items()}
    attach_ids(embedded, model, sample_batch, device)
    dense = sample_batch.get("dense")
    if dense is not None:
        dense = _to_device(dense, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.module.to(device)
    materialize(model.module, embedded, dense, generator=gen)
    return model.module


def init_weights(model: EmbeddingModel, sample_batch, *, seed: int = 0,
                 device=None) -> WeightsState:
    """Fresh weights on `device` (None = the CUDA card; raises without one).

    Every table draws from its own generator seeded from (seed, variable id);
    the dense module is materialized from one forward pass over
    `sample_batch` ({"sparse": {feature: ids}, "dense": ...}), drawing from a
    generator seeded from `seed`."""
    device = resolve_device(device)
    tables = {name: init_table(spec, _table_generator(seed, spec, device))
              for name, spec in model.specs.items()}
    dense = _materialize_dense(model, tables, sample_batch, seed, device)
    return WeightsState(tables=tables, dense=dense)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """All training state: the step counters, the dense module (holding its
    parameters), the dense optimizer slots {parameter name: {slot:
    (1, size) float32}} and the tables {name: EmbeddingTableState}.

    The train step updates the tensors in place, the port's counterpart of
    the JAX package donating its state to the jitted step: a state passed to
    `Trainer.train_step` is the state it returns. `clone()` gives an
    independent copy."""

    step: int
    dense: nn.Module
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    tables: Dict[str, EmbeddingTableState]
    model_version: int = 0

    def clone(self) -> "TrainState":
        return copy.deepcopy(self)


def init_dense_slots(optimizer: SparseOptimizer, module: nn.Module
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Slots for every dense parameter, each parameter a 1-row table of
    `numel` columns. A slot row is laid out like the parameter flattened in
    PyTorch's order ((out, in) for a `Dense` weight)."""
    return {name: optimizer.init_slots(1, p.numel(), p.dtype,
                                       device=p.device)
            for name, p in module.named_parameters()}


@torch.no_grad()
def dense_apply(optimizer: SparseOptimizer, module: nn.Module,
                slots: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """The dense update from each parameter's `.grad`, in place: the
    parameter runs through the sparse rule as a 1-row table with count 1,
    in float32, and is cast back to its dtype. A parameter without a
    gradient takes a zero gradient, as every leaf does in the JAX package."""
    for name, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        ones = torch.ones(1, dtype=torch.int32, device=p.device)
        new_p, slots[name] = optimizer.apply(
            p.reshape(1, -1).float(), slots[name],
            g.reshape(1, -1).float(), ones)
        p.copy_(new_p.reshape(p.shape))


def _batch_slice(tree, k: int):
    """Step k of a stacked batch (every leaf has a leading K dim)."""
    if isinstance(tree, dict):
        return {key: _batch_slice(v, k) for key, v in tree.items()}
    return None if tree is None else tree[k]


class Trainer:
    """Trains an EmbeddingModel on one device (the CUDA card unless
    `device="cpu"` is asked for; raises when there is no card).

    A step pulls each table's rows through the gather kernel, runs the
    forward and backward pass of the dense module with autograd (the pulled
    rows are the leaves the table gradients come from), updates the dense
    parameters with `dense_apply`, and pushes the row gradients through the
    dedup and the fused apply kernel (`embedding.apply_gradients`). Every
    update happens in place."""

    def __init__(self, model: EmbeddingModel,
                 optimizer: Optional[SparseOptimizer] = None, seed: int = 0,
                 *, device=None):
        for name, spec in model.specs.items():
            if spec.sparse_as_dense:
                raise NotImplementedError(
                    f"embedding {name!r}: sparse_as_dense tables are not "
                    "ported yet (see ROADMAP.md)")
        if model.batch_transform is not None:
            raise NotImplementedError(
                "EmbeddingModel.batch_transform is not ported yet (see "
                "ROADMAP.md)")
        self.model = model
        self.optimizer = optimizer or Adagrad()
        self.seed = seed
        self.device = resolve_device(device)

    def opt_for(self, spec: EmbeddingSpec) -> SparseOptimizer:
        return spec.optimizer or self.optimizer

    def _loss(self, logits, batch):
        """The weighted mean when the batch carries a per-sample weight."""
        w = batch.get("weight")
        if w is None:
            return self.model.loss_fn(logits, batch["label"])
        return self.model.loss_fn(logits, batch["label"], w)

    def _device_batch(self, batch) -> Dict[str, Any]:
        out = {"sparse": {k: _to_device(v, self.device)
                          for k, v in batch["sparse"].items()}}
        for key in ("dense", "label", "weight"):
            if batch.get(key) is not None:
                out[key] = _to_device(batch[key], self.device)
        return out

    def init(self, sample_batch) -> TrainState:
        """Fresh state: each table from a generator seeded from (seed,
        variable id) as `init_weights` draws it, with its optimizer's slots;
        the dense module from one forward pass over `sample_batch`."""
        tables = {name: init_table_state(
                      spec, self.opt_for(spec),
                      _table_generator(self.seed, spec, self.device))
                  for name, spec in self.model.specs.items()}
        dense = _materialize_dense(
            self.model, {n: t.weights for n, t in tables.items()},
            sample_batch, self.seed, self.device)
        return TrainState(step=0, dense=dense,
                          dense_slots=init_dense_slots(self.optimizer, dense),
                          tables=tables, model_version=0)

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One synchronous step: pull -> forward/backward -> dense apply +
        sparse apply, in place. Returns (state, {"loss": (), "logits":
        (B,)}); nothing is read back to the host. The four phases are
        `torch.profiler` ranges (`trainer.pull`, `trainer.compute`,
        `trainer.dense_apply`, `trainer.sparse_apply`)."""
        specs = self.model.specs
        with record_function("trainer.pull"):
            b = self._device_batch(batch)
            ids = {name: b["sparse"][spec.feature_name]
                   for name, spec in specs.items()}
            pulled = {}
            for name, spec in specs.items():
                _, rows = lookup_train(spec, state.tables[name], ids[name])
                pulled[name] = rows.requires_grad_()
        with record_function("trainer.compute"):
            embedded = {name: combine(spec, ids[name], pulled[name])
                        for name, spec in specs.items()}
            attach_ids(embedded, self.model, batch, self.device)
            state.dense.zero_grad(set_to_none=True)
            logits = state.dense(embedded, b.get("dense"))
            loss = self._loss(logits, b)
            loss.backward()
        with record_function("trainer.dense_apply"):
            dense_apply(self.optimizer, state.dense, state.dense_slots)
        with record_function("trainer.sparse_apply"), torch.no_grad():
            for name, spec in specs.items():
                apply_gradients(spec, state.tables[name], self.opt_for(spec),
                                ids[name], pulled[name].grad)
        state.step += 1
        state.model_version += 1
        return state, {"loss": loss.detach(), "logits": logits.detach()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        specs = self.model.specs
        b = self._device_batch(batch)
        embedded = {}
        for name, spec in specs.items():
            ids = b["sparse"][spec.feature_name]
            embedded[name] = combine(
                spec, ids, lookup(spec, state.tables[name].weights, ids))
        attach_ids(embedded, self.model, batch, self.device)
        logits = state.dense(embedded, b.get("dense"))
        return {"logits": logits, "loss": self._loss(logits, b)}

    def train_many(self, state: TrainState, batches
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K steps over stacked batches (every leaf has a leading K dim):
        the semantics of the JAX package's scan, K `train_step` calls in
        order. Returns (state, {"loss": (K,)})."""
        k_steps = len(batches["label"])
        losses = []
        for k in range(k_steps):
            state, metrics = self.train_step(state, _batch_slice(batches, k))
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}
