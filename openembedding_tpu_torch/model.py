"""EmbeddingModel + the weights-only state.

Port of the serving half of `openembedding_tpu/model.py`: `EmbeddingModel`,
`binary_logloss`, `IDS_KEY`/`attach_ids`, and `WeightsState`, the tables and
dense module an export is written from. The `Trainer` comes with training
(ROADMAP.md).

The dense module is a `torch.nn.Module` called as `module(embedded, dense)`
where `embedded` maps variable name -> (B, ..., dim) pulled rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .embedding import Embedding, EmbeddingSpec, init_table, lookup
from .layers import materialize


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


@dataclasses.dataclass
class WeightsState:
    """What an export is written from: table weights by variable name, the
    dense module holding its parameters, and the step counters."""

    tables: Dict[str, torch.Tensor]
    dense: nn.Module
    step: int = 0
    model_version: int = 0


def init_weights(model: EmbeddingModel, sample_batch, *, seed: int = 0,
                 device=None) -> WeightsState:
    """Fresh weights on `device` (None = the CUDA card; raises without one).

    Every table draws from its own generator seeded from (seed, variable id);
    the dense module is materialized from one forward pass over
    `sample_batch` ({"sparse": {feature: ids}, "dense": ...}), drawing from a
    generator seeded from `seed`."""
    device = resolve_device(device)
    tables = {}
    for name, spec in model.specs.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 131071 + spec.variable_id)
        tables[name] = init_table(spec, gen)
    embedded = {
        name: lookup(spec, tables[name], torch.as_tensor(
            np.asarray(sample_batch["sparse"][spec.feature_name]),
            device=device))
        for name, spec in model.specs.items()}
    attach_ids(embedded, model, sample_batch, device)
    dense = sample_batch.get("dense")
    if dense is not None:
        dense = torch.as_tensor(np.asarray(dense), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.module.to(device)
    materialize(model.module, embedded, dense, generator=gen)
    return WeightsState(tables=tables, dense=model.module)
