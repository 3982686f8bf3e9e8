"""Embedding variable spec + the user-facing `Embedding` layer handle.

Port of `openembedding_tpu/embedding.py` for slice 1 (serving): the spec, the
array-table init and lookup, the validity masks and the combiner pooling. The
hash-table device path, the training pull and `apply_gradients` come with
training (ROADMAP.md).

Ids are single-lane int64 tensors throughout the port: torch has int64 on
every device, so the JAX package's split-pair uint32 id layout has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .initializers import Initializer, Uniform
from .meta import DataType, EmbeddingVariableMeta, HASH_VOCABULARY_THRESHOLD
from .ops.sparse import lookup_rows

_NOT_PORTED = "is not ported yet (see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one embedding variable (same fields and config
    dict as the JAX spec). `optimizer` stays None until training is ported."""

    name: str
    input_dim: int                       # -1 -> hashed 63-bit id space
    output_dim: int
    datatype: str = "float32"
    initializer: Initializer = dataclasses.field(default_factory=Uniform)
    optimizer: Optional[object] = None
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
        if self.optimizer is not None:
            raise NotImplementedError(
                f"embedding {self.name!r}: per-variable optimizers come with "
                f"training, which {_NOT_PORTED}")

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
            "initializer": self.initializer.to_config(), "optimizer": None,
            "num_shards": self.num_shards,
            "sparse_as_dense": self.sparse_as_dense,
            "capacity": self.capacity, "storage": self.storage,
            "variable_id": self.variable_id, "feature": self.feature,
            "combiner": self.combiner,
        }


def init_table(spec: EmbeddingSpec, generator: torch.Generator
               ) -> torch.Tensor:
    """Materialize an array table's weights on the generator's device."""
    if spec.use_hash_table:
        raise NotImplementedError(
            f"hash-table variable {spec.name!r}: the device hash table "
            f"{_NOT_PORTED}")
    return spec.initializer(generator, (spec.rows_per_shard(1),
                                        spec.output_dim), spec.dtype)


def lookup(spec: EmbeddingSpec, weights: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Single-shard array-table pull: ids (any shape) -> ids.shape + (dim,)."""
    if spec.use_hash_table:
        raise NotImplementedError(
            f"hash-table variable {spec.name!r}: the device hash lookup "
            f"{_NOT_PORTED}")
    return lookup_rows(weights, ids)


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
