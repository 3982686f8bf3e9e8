"""Embedding variable spec, table state + the user-facing `Embedding` layer.

Port of `openembedding_tpu/embedding.py` for array tables: the spec, the
table state (weights + optimizer slots) and its init, the serving lookup,
the training pull (`lookup_train`) and push (`apply_gradients`), the
validity masks and the combiner pooling. The device hash table and
host-cached tables are not ported yet (ROADMAP.md).

Ids are single-lane int64 tensors throughout the port: torch has int64 on
every device, so the JAX package's split-pair uint32 id layout has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .initializers import Initializer, Uniform
from .meta import DataType, EmbeddingVariableMeta, HASH_VOCABULARY_THRESHOLD
from .optimizers import SparseOptimizer
from .ops.sparse import lookup_rows, sparse_apply_dense_table

_NOT_PORTED = "is not ported yet (see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one embedding variable (same fields and config
    dict as the JAX spec). `optimizer` None means the trainer's optimizer."""

    name: str
    input_dim: int                       # -1 -> hashed 63-bit id space
    output_dim: int
    datatype: str = "float32"
    initializer: Initializer = dataclasses.field(default_factory=Uniform)
    optimizer: Optional[SparseOptimizer] = None
    num_shards: int = -1
    sparse_as_dense: bool = False
    capacity: int = 0
    storage: str = "hbm"
    variable_id: int = -1
    feature: str = ""                    # batch feature to read ids from
    combiner: str = ""                   # "", "sum", "mean" or "sqrtn"

    def __post_init__(self):
        if self.input_dim == 0 or self.input_dim < -1:
            raise ValueError(f"invalid input_dim {self.input_dim}")
        if self.output_dim <= 0:
            raise ValueError(f"invalid output_dim {self.output_dim}")
        if self.storage not in ("hbm", "host_cached"):
            raise ValueError(f"invalid storage {self.storage!r} "
                             "(expected 'hbm' or 'host_cached')")
        if self.combiner not in ("", "sum", "mean", "sqrtn"):
            raise ValueError(
                f"embedding {self.name!r}: unknown combiner "
                f"{self.combiner!r} (expected '', 'sum', 'mean' or 'sqrtn')")

    @property
    def use_hash_table(self) -> bool:
        return (self.input_dim == -1
                or self.input_dim >= HASH_VOCABULARY_THRESHOLD)

    @property
    def feature_name(self) -> str:
        """The batch["sparse"] key this variable's ids come from."""
        return self.feature or self.name

    @property
    def meta(self) -> EmbeddingVariableMeta:
        return EmbeddingVariableMeta(
            datatype=self.datatype, embedding_dim=self.output_dim,
            vocabulary_size=-1 if self.use_hash_table else self.input_dim)

    @property
    def dtype(self) -> torch.dtype:
        return DataType(self.datatype).torch_dtype

    def rows_per_shard(self, num_shards: int) -> int:
        """ceil(vocab / S) rows (hash tables: ceil(capacity / S))."""
        if self.use_hash_table:
            if self.capacity <= 0:
                raise ValueError(f"hash-table variable {self.name!r} needs "
                                 "an explicit capacity")
            return -(-self.capacity // num_shards)
        return -(-self.input_dim // num_shards)

    def to_config(self) -> dict:
        return {
            "name": self.name, "input_dim": self.input_dim,
            "output_dim": self.output_dim, "datatype": self.datatype,
            "initializer": self.initializer.to_config(),
            "optimizer": self.optimizer.to_config() if self.optimizer else None,
            "num_shards": self.num_shards,
            "sparse_as_dense": self.sparse_as_dense,
            "capacity": self.capacity, "storage": self.storage,
            "variable_id": self.variable_id, "feature": self.feature,
            "combiner": self.combiner,
        }


def _array_table_only(spec: EmbeddingSpec) -> None:
    if spec.use_hash_table:
        raise NotImplementedError(
            f"hash-table variable {spec.name!r}: the device hash table "
            f"{_NOT_PORTED}")


def init_table(spec: EmbeddingSpec, generator: torch.Generator
               ) -> torch.Tensor:
    """Materialize an array table's weights on the generator's device."""
    _array_table_only(spec)
    return spec.initializer(generator, (spec.rows_per_shard(1),
                                        spec.output_dim), spec.dtype)


@dataclasses.dataclass
class EmbeddingTableState:
    """One array table's training storage: weights (rows, dim) and the
    optimizer's slots {name: (rows, width) float32}. The train step updates
    both in place."""

    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]


def init_table_state(spec: EmbeddingSpec, optimizer: SparseOptimizer,
                     generator: torch.Generator) -> EmbeddingTableState:
    """Weights from the spec's initializer (drawn from `generator`, on its
    device) and the optimizer's slots at their initial values."""
    if spec.storage != "hbm":
        raise NotImplementedError(
            f"variable {spec.name!r}: storage={spec.storage!r} {_NOT_PORTED}")
    weights = init_table(spec, generator)
    slots = optimizer.init_slots(weights.shape[0], spec.output_dim,
                                 spec.dtype, device=weights.device)
    return EmbeddingTableState(weights=weights, slots=slots)


def lookup(spec: EmbeddingSpec, weights: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Single-shard array-table pull: ids (any shape) -> ids.shape + (dim,)."""
    _array_table_only(spec)
    return lookup_rows(weights, ids)


def lookup_train(spec: EmbeddingSpec, state: EmbeddingTableState,
                 ids: torch.Tensor):
    """Training pull -> (state, rows). Array tables never change on a pull,
    so this is `lookup`; the rows are a plain tensor, not a view of the
    table (the caller makes them the leaf it differentiates against)."""
    return state, lookup(spec, state.weights, ids)


def apply_gradients(spec: EmbeddingSpec, state: EmbeddingTableState,
                    optimizer: SparseOptimizer, ids: torch.Tensor,
                    grads: torch.Tensor) -> EmbeddingTableState:
    """Push + update, in place: duplicate ids' gradients summed, the
    optimizer applied once per unique valid id; -1 pads and out-of-range
    ids train nothing. Returns `state`."""
    _array_table_only(spec)
    sparse_apply_dense_table(optimizer, state.weights, state.slots,
                             ids.reshape(-1), grads.reshape(-1, spec.output_dim))
    return state


def valid_mask(spec: EmbeddingSpec, ids: torch.Tensor) -> torch.Tensor:
    """True where an id slot holds a real id (ids >= 0)."""
    return ids >= 0


def np_valid_mask(spec: EmbeddingSpec, ids) -> np.ndarray:
    """Host-side twin of `valid_mask` on the request's original numpy ids."""
    return np.asarray(ids) >= 0


def combine(spec: EmbeddingSpec, ids, rows: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Pool multivalent rows (..., F, dim) over the id axis F per
    `spec.combiner`; identity when no combiner is set. Pad slots contribute
    zero; mean/sqrtn divide by the valid count clamped to >= 1. `mask`
    overrides the id-derived validity."""
    if not spec.combiner:
        return rows
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask), device=rows.device)
    else:
        m = valid_mask(spec, ids)
    if m.dim() < 2:
        raise ValueError(
            f"embedding {spec.name!r}: combiner={spec.combiner!r} needs ids "
            f"of shape (batch, fields), got rank {m.dim()}")
    mf = m.to(rows.dtype)[..., None]
    s = torch.sum(rows * mf, dim=-2)
    if spec.combiner == "sum":
        return s
    cnt = torch.clamp(torch.sum(mf, dim=-2), min=1)
    if spec.combiner == "mean":
        return s / cnt
    return s / torch.sqrt(cnt)


def serve_rows(spec: EmbeddingSpec, ids,
               lookup_fn: Callable[[np.ndarray], torch.Tensor]
               ) -> torch.Tensor:
    """The one serving-side embed: `lookup_fn(ids)` + combiner pooling, the
    mask taken from the original host ids."""
    rows = lookup_fn(ids)
    if spec.combiner:
        rows = combine(spec, None, rows, mask=np_valid_mask(spec, ids))
    return rows


class Embedding:
    """Layer handle mirroring the JAX package's `Embedding`: it carries the
    spec into the enclosing `EmbeddingModel`."""

    def __init__(self, input_dim: int, output_dim: int, *, name: str,
                 datatype: str = "float32",
                 embeddings_initializer: Optional[Initializer] = None,
                 optimizer=None, num_shards: int = -1,
                 sparse_as_dense: bool = False, capacity: int = 0,
                 storage: str = "hbm", feature: str = "", combiner: str = ""):
        self.spec = EmbeddingSpec(
            name=name, input_dim=input_dim, output_dim=output_dim,
            datatype=datatype,
            initializer=embeddings_initializer or Uniform(),
            optimizer=optimizer, num_shards=num_shards,
            sparse_as_dense=sparse_as_dense, capacity=capacity,
            storage=storage, feature=feature, combiner=combiner)
