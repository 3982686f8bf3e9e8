"""Embedding variable spec, table state + the user-facing `Embedding` layer.

Port of `openembedding_tpu/embedding.py`: the spec, the table state
(weights + optimizer slots, and for a hash table its keys and overflow
counter) and its init, the serving lookup, the training pull
(`lookup_train`) and push (`apply_gradients`), the validity masks and the
combiner pooling. Array tables index rows by id; hash tables
(`input_dim=-1`, the 63-bit hashed id space) probe `tables/hash_table.py`.
A host-cached hash table (`storage="host_cached"`) keeps its state here as
the device cache of `tables/host_offload.py`, which the trainers drive.

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
from .tables.hash_table import (fresh_keys, hash_apply_gradients,
                                hash_lookup, hash_lookup_train)


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

    def device_bytes(self, optimizer: SparseOptimizer, num_shards: int, *,
                     need_ef: bool = False) -> Dict[str, int]:
        """The bytes one rank holds of this table's base state at S shards,
        by part, priced from the spec without materializing it (the
        `utils/memwatch` ledger; `MeshTrainer.memory_model` holds it equal
        to the live tensors): the weights, the float32 slots, a hash
        table's int64 keys and its () int32 overflow counter, and the
        float32 error-feedback residuals."""
        rows = self.rows_per_shard(num_shards)
        item = torch.empty((), dtype=self.dtype).element_size()
        out = {
            "weights": rows * self.output_dim * item,
            "slots": rows * 4 * sum(
                optimizer.slot_shapes(self.output_dim).values()),
        }
        if self.use_hash_table:
            out["keys"] = rows * 8 + 4
        if need_ef:
            out["ef"] = rows * self.output_dim * 4
        return out

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


def init_table(spec: EmbeddingSpec, generator: torch.Generator,
               num_shards: int = 1) -> torch.Tensor:
    """Materialize a table's weights on the generator's device: the
    vocabulary's rows, or a hash table's `capacity` rows (every slot's row
    drawn now, the one an id that claims the slot starts from); with
    `num_shards`, one shard's `rows_per_shard(num_shards)` rows."""
    return spec.initializer(generator, (spec.rows_per_shard(num_shards),
                                        spec.output_dim), spec.dtype)


@dataclasses.dataclass
class HotRows:
    """The replicated hot-row cache of one table on the mesh
    (`MeshTrainer(hot_rows=H)`, `parallel/sharded.py`): H heavy-hitter
    rows held alike on every rank, so their pulls gather locally and never
    cross the wire, and their gradients are reduced over the ranks like
    dense ones. Membership is a small open-addressing probe table built on
    the host (`sharded.build_hot_identity`): `keys` (C = max(2H, 8),) the
    hot ids (int32 for an array table, the table's key dtype for a hash
    table; -1 empty), `rank` (C,) int32 each probe slot's cache row (H =
    empty), `ids` (H,) the hot ids by rank (-1 padding). `weights` (H, dim)
    and `slots` {name: (H, width)} are the cached rows and their optimizer
    state. Never serialized: `MeshTrainer.hot_sync` writes the rows back
    into their owner shards first."""

    keys: torch.Tensor
    rank: torch.Tensor
    ids: torch.Tensor
    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]


@dataclasses.dataclass
class MigRows:
    """The migration directory and annex of one table on the mesh
    (`MeshTrainer(mig_rows=M)`): up to M cold rows re-homed off their
    `id % S` shard. The directory is replicated: `keys` (C = max(2M, 8),)
    and `rank` (C,) int32 as in `HotRows`, `ids` (M,) the migrated ids by
    rank (-1 padding) and `owners` (M,) int32 each one's assigned shard
    (-1 padding). `weights` (M, dim) and `slots` are this rank's annex: a
    rank's copy of rank m is live where it is m's assigned owner. Never
    serialized (`MeshTrainer.hot_sync` writes the rows back home)."""

    keys: torch.Tensor
    rank: torch.Tensor
    ids: torch.Tensor
    owners: torch.Tensor
    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]


@dataclasses.dataclass
class EmbeddingTableState:
    """One table's training storage: weights (rows, dim) and the optimizer's
    slots {name: (rows, width) float32}; a hash table also has `keys`
    (capacity,) int64 (-1 empty) and `overflow`, a () int32 count of the ids
    its pulls found no slot for (read by `Trainer.table_overflow`, never on
    the step's path). On the mesh a table may also carry `hot` (the
    replicated hot-row cache), `mig` (the migration directory and annex)
    and `ef` (rows, dim) float32, the error-feedback residuals of the int8
    pull wire, laid out like `weights` and saved like an optimizer slot
    (the reserved name `__ef__`). The train step updates all of them in
    place."""

    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]
    keys: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None
    hot: Optional[HotRows] = None
    mig: Optional[MigRows] = None
    ef: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        """Every tensor of the state, in a fixed order (what a captured
        graph reads and writes)."""
        out = [self.weights, *self.slots.values(), self.keys, self.overflow,
               self.ef]
        for part in (self.hot, self.mig):
            if part is not None:
                out += [getattr(part, f.name) for f in dataclasses.fields(
                    part) if f.name != "slots"] + list(part.slots.values())
        return [t for t in out if t is not None]


def init_table_state(spec: EmbeddingSpec, optimizer: SparseOptimizer,
                     generator: torch.Generator,
                     num_shards: int = 1,
                     error_feedback: bool = False) -> EmbeddingTableState:
    """Weights from the spec's initializer (drawn from `generator`, on its
    device) and the optimizer's slots at their initial values; with
    `num_shards`, one shard of the table (`init_table`).
    `error_feedback`: a zero `ef` residual beside the weights. A
    host-cached table's state is its device cache (`capacity` slots)."""
    weights = init_table(spec, generator, num_shards)
    slots = optimizer.init_slots(weights.shape[0], spec.output_dim,
                                 spec.dtype, device=weights.device)
    keys = overflow = None
    if spec.use_hash_table:
        keys = fresh_keys(weights.shape[0], device=weights.device)
        overflow = torch.zeros((), dtype=torch.int32, device=weights.device)
    ef = (torch.zeros((weights.shape[0], spec.output_dim),
                      dtype=torch.float32, device=weights.device)
          if error_feedback else None)
    return EmbeddingTableState(weights=weights, slots=slots, keys=keys,
                               overflow=overflow, ef=ef)


def lookup(spec: EmbeddingSpec, state: EmbeddingTableState,
           ids: torch.Tensor) -> torch.Tensor:
    """Single-shard read-only pull: ids (any shape) -> ids.shape + (dim,).
    Absent, negative and out-of-range ids give zero rows."""
    flat = ids.reshape(-1)
    if spec.use_hash_table:
        rows = hash_lookup(state, flat)
    else:
        rows = lookup_rows(state.weights, flat)
    return rows.reshape(tuple(ids.shape) + (spec.output_dim,))


def lookup_train(spec: EmbeddingSpec, state: EmbeddingTableState,
                 ids: torch.Tensor, out_dim: Optional[int] = None):
    """Training pull -> (state, rows, overflow, slot). Array tables never
    change on a pull (overflow and slot are None); a hash table inserts
    unseen ids and adds the pull's overflow () int32 to its counter, in
    place, and `slot` holds the flat ids' slots, which `apply_gradients`
    takes so the push does not probe again. The rows are a plain tensor,
    not a view of the table (the caller makes them the leaf it
    differentiates against). `out_dim`: the state holds the packed
    weights+slots layout of `Trainer.train_many`; keep the weight
    columns."""
    flat = ids.reshape(-1)
    overflow = slot = None
    if spec.use_hash_table:
        state, rows, overflow, slot = hash_lookup_train(state, flat,
                                                        out_dim=out_dim)
    else:
        rows = lookup_rows(state.weights, flat)
        if out_dim is not None:
            rows = rows[:, :out_dim]
    return state, rows.reshape(tuple(ids.shape) + (spec.output_dim,)), \
        overflow, slot


def apply_gradients(spec: EmbeddingSpec, state: EmbeddingTableState,
                    optimizer: SparseOptimizer, ids: torch.Tensor,
                    grads: torch.Tensor, slot: Optional[torch.Tensor] = None
                    ) -> EmbeddingTableState:
    """Push + update, in place: duplicate ids' gradients summed, the
    optimizer applied once per unique valid id; -1 pads, out-of-range ids
    and a hash table's absent ids train nothing. `slot`: a hash table's
    slots of these ids from `lookup_train` (the keys unchanged since); the
    push probes for them without it. Returns `state`."""
    flat_ids = ids.reshape(-1)
    flat_grads = grads.reshape(-1, spec.output_dim)
    if spec.use_hash_table:
        return hash_apply_gradients(state, optimizer, flat_ids, flat_grads,
                                    slot=slot)
    sparse_apply_dense_table(optimizer, state.weights, state.slots,
                             flat_ids, flat_grads)
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
