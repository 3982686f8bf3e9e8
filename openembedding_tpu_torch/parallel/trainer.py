"""MeshTrainer: the Trainer over the mesh's ranks (port of the core of
`openembedding_tpu/parallel/trainer.py`).

Each rank is one process with one table shard and one slice of the batch
(`parallel/mesh.py`). The step is `Trainer._step` with its hooks replaced,
as the JAX MeshTrainer replaces them:

- `tables_pull` / `tables_apply`: the all_to_all protocol of
  `parallel/sharded.py`, fused per dim-group (`group_exchange=True`) or
  per table;
- `reduce_dense_grads`: the dense gradients SUMMED over the ranks, not
  averaged (the reference's Horovod allreduce with op=Sum), in rank order
  (`collectives.dense_sum`), so the effective dense learning rate scales
  with S as the reference's does;
- `dense_update` under ZeRO (`dense_shard=True`, `parallel/zero.py`): the
  sum folds into a reduce_scatter of the flat gradient, each rank updates
  its 1/S chunk of the flat dense state and all_gathers the new params;
  `dense_wire` narrows both collectives ("bf16", "int8" with an
  error-feedback residual, "sparse_topk": the k largest-magnitude
  elements a destination chunk) and keeps float32 masters of the chunk.
  At fp32 it equals the replicated update bit for bit. `externalize`
  (what `save` writes) unshards the slots; `set_dense_wire` switches the
  format between steps;
- `reduce_metrics`: the loss, each rank's local mean, averaged over the
  ranks for the report; the stats (`<table>/pull_indices`, `pull_unique`,
  `pull_overflow`, `push_overflow`, `shard_rows`, `shard_positions`,
  `bucket_fill`, and with placement `hot_hits`, `hot_unique`,
  `hot_bytes_saved`, `mig_unique`, `mig_hits`) summed.

Skew-aware placement (`parallel/sharded.py`): the int8 wire with
error-feedback residuals (`wire="int8"`, `error_feedback`), the
replicated hot-row cache (`hot_rows`, its reduce's format `hot_wire`,
`refresh_hot_rows`) and cold-tail migration (`mig_rows`, `migrate_rows`);
`hot_sync` writes both back into the shards, as `save` does first.

The pipelined window (`pipeline_steps=True`, S >= 2): `train_many` and
`jit_train_many` issue batch t+1's id plan and a speculative pull a step
ahead, before batch t's forward, backward and applies (on a CUDA mesh over
NCCL, on a stream of the trainer's own), and repair them after batch t's
apply with the conflict patch (`parallel/sharded.py`); bit-equal to the
serial window at every wire format, residuals included, with the
window's counters "conflict" and "conflict_overflow" (`conflict_factor`
caps the patch).

Host-cached tables (`storage="host_cached"`, `tables/host_offload.py`):
each rank holds its shard of the row-sharded cache and a store of the
rows it owns; `offload_prepare` admits the union of every rank's batch
ids, each rank the ids it owns. They carry no hot rows, migration or
residuals (inert, as in the JAX MeshTrainer).

Observability, as in the JAX MeshTrainer: the numerics sentinel's stats
(`sentinel`, `halt_on_nonfinite`) ride the step's one `psum_stats`
collective, so every rank sees the same health and takes the same halt
decision; `measure_every` samples `jit_train_step`; the static wire-cost
model of the step is published as `exchange.*` / `hot.*` / `dense.*`
gauges (`_observe_wire_cost`, `last_wire_cost`) and a window's conflict
counters by `record_window_stats`; `memory_model` / `publish_memory`
price what a rank holds for the `utils/memwatch` ledger, and
`refresh_hot_rows` without explicit ids installs the heavy-hitter
sketches' top sets (rank 0's, sent to every rank), as the placement
controller (`placement/controller.py`) drives it.

`SeqMeshTrainer`: the same over a 2-D (data, seq) mesh
(`mesh.make_seq_mesh`), context parallel: the sequence dim of the batch
sharded over the seq axis, ring or Ulysses attention in the module
(`parallel/sequence.py`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..embedding import (EmbeddingSpec, EmbeddingTableState, HotRows,
                         MigRows, combine, init_table, init_table_state)
from ..model import (EmbeddingModel, TrainState, Trainer, _batch_slice,
                     _materialize_dense, _table_generator, _transformed,
                     attach_ids, dense_leaves, init_dense_slots, sad_rows)
from ..ops import wire as wire_mod
from ..optimizers import SparseOptimizer
from ..utils import metrics as _metrics
from . import collectives as coll
from . import zero
from .mesh import Mesh, make_mesh
from .sharded import (_probe_keys, build_hot_identity, build_mig_identity,
                      grouped_apply_gradients, grouped_conflict_patch,
                      grouped_finalize_pull, grouped_lookup_train,
                      grouped_prefetch, hot_gather, hot_writeback,
                      identity_tensors, mig_gather, mig_writeback,
                      sharded_apply_gradients, sharded_lookup,
                      sharded_lookup_train, split_wire_groups)

class MeshTrainer(Trainer):
    """Trains an EmbeddingModel over the ranks of `mesh` (default: the
    world group, `make_mesh()`): tables row-sharded `id % S`, the batch
    data-parallel (each rank steps on its own rows, `multihost.local_batch`).

    - `capacity_factor`: bucket headroom of the exchange (0: exact,
      cap = n); `on_overflow` what `check_overflow` does when buckets
      dropped ids: "count", "grow" (raise `capacity_factor`, every graph
      driver captures anew) or "raise".
    - `wire`: the rows' and grads' format, "fp32", "bf16" or "int8"
      (None: `$OETPU_WIRE`, then bf16), or a per-table dict with a "*"
      default. `error_feedback`: the owner keeps a residual per row for
      the narrow pull wire (None: on where a table's wire is int8).
    - `hot_rows`: H rows replicated on every rank a table (an int, or
      {table: H}; 0 off), starting empty: `refresh_hot_rows` installs a
      hot set. `hot_wire`: the format of the hot rows' gradient reduce
      (None: the table's wire). `mig_rows`: M rows a table that
      `migrate_rows` may re-home off their `id % S` shard. All three are
      inert at S = 1 and for sparse_as_dense tables.
    - `group_exchange`: tables of one width share three all_to_alls a step
      (False: three per table). `shard_stats`: the per-shard load stats.
    - `pipeline_steps`: `train_many` windows pipelined (inert at S = 1);
      `conflict_factor` in [0, 1] caps the conflict patch at that share of
      the bucket capacity (0: exact, every conflicting row patched).
    - `dense_shard`: ZeRO, each rank holds 1/S of the flat dense optimizer
      state (`parallel/zero.py`; inert at S = 1). `dense_wire` (needs
      `dense_shard`): the dense collectives' format, None / "fp32"
      (lossless), "bf16", "int8" or "sparse_topk"; `dense_topk`: the
      elements a destination chunk ships under "sparse_topk" (None: about
      1/16 of the chunk, `dense_topk_for`). `dense_stats`: each step's
      stats carry `dense/grad_density`, the mean over the ranks of the
      nonzero share of their dense gradients before the reduce.

    `init` gives each rank its shard of every table (shard r of S draws
    from its own generator: no rank builds a whole table) and the same
    dense params (rank 0's, broadcast), their slots in the ZeRO flat form
    where `zero_enabled`. `train_step`, `train_many` and
    `eval_step` run eagerly; `jit_train_step()` / `jit_train_many()` are
    CUDA graphs (`model.CompiledStep`): at S = 1 the graph holds no
    collective, at S >= 2 over NCCL it captures them (the process group
    exists before the capture). A staged run (gloo with tensors on a card)
    has no graph driver: asking for one raises."""

    def __init__(self, model: EmbeddingModel,
                 optimizer: Optional[SparseOptimizer] = None, *,
                 mesh: Optional[Mesh] = None, seed: int = 0,
                 capacity_factor: float = 0.0, on_overflow: str = "count",
                 wire=None, group_exchange: bool = True,
                 shard_stats: bool = True, hot_rows=0, mig_rows=0,
                 hot_wire: Optional[str] = None,
                 error_feedback: Optional[bool] = None,
                 pipeline_steps: bool = False, conflict_factor: float = 0.0,
                 dense_shard: bool = False, dense_wire: Optional[str] = None,
                 dense_topk: Optional[int] = None, dense_stats: bool = False,
                 offload_pipeline: bool = False, offload_densify: int = 1,
                 offload_stage_depth: int = 1, sentinel: bool = False,
                 halt_on_nonfinite: bool = False, measure_every: int = 0):
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(model, optimizer, seed, device=self.mesh.device,
                         offload_pipeline=offload_pipeline,
                         offload_densify=offload_densify,
                         offload_stage_depth=offload_stage_depth,
                         sentinel=sentinel,
                         halt_on_nonfinite=halt_on_nonfinite,
                         measure_every=measure_every)
        self.num_shards = self.mesh.size
        self.capacity_factor = capacity_factor
        if on_overflow not in ("count", "grow", "raise"):
            raise ValueError(f"on_overflow={on_overflow!r}: expected "
                             "'count', 'grow', or 'raise'")
        self.on_overflow = on_overflow
        if isinstance(wire, dict):
            unknown = [k for k in wire if k != "*" and k not in model.specs]
            if unknown:
                raise ValueError(
                    f"wire= names unknown tables {sorted(unknown)} (model "
                    f"tables: {sorted(model.specs)}; use '*' for the "
                    "default format)")
        self.wire = wire
        for name in model.ps_specs():
            self.wire_for(name)  # validates every format now
        if hot_wire is not None:
            wire_mod.wire_format(hot_wire)
        self.hot_wire = hot_wire
        self.error_feedback = error_feedback
        self.hot_rows = hot_rows
        self.mig_rows = mig_rows
        self.group_exchange = group_exchange
        self.shard_stats = shard_stats
        if not 0.0 <= float(conflict_factor) <= 1.0:
            raise ValueError(f"conflict_factor={conflict_factor!r}: expected "
                             "0.0 (exact) .. 1.0")
        self.pipeline_steps = bool(pipeline_steps)
        self.conflict_factor = float(conflict_factor)
        self._side = None  # the prefetch's stream, made at first use
        self.dense_shard = bool(dense_shard)
        if dense_wire in ("fp32", "none"):
            dense_wire = None
        if dense_wire is not None:
            if dense_wire not in ("bf16", "int8", "sparse_topk"):
                raise ValueError(
                    f"dense_wire={dense_wire!r}: expected 'int8', 'bf16', "
                    "'sparse_topk', or None/'fp32' (the lossless round-14 "
                    "path)")
            if not self.dense_shard:
                raise ValueError(
                    "dense_wire quantizes the ZeRO dense collectives — "
                    "construct MeshTrainer(dense_shard=True, dense_wire=...)")
        self.dense_wire = dense_wire
        if dense_topk is not None:
            dense_topk = int(dense_topk)
            if dense_topk <= 0:
                raise ValueError(
                    f"dense_topk={dense_topk}: expected a positive element "
                    "count (or None to auto-size from the chunk)")
            if dense_wire != "sparse_topk":
                raise ValueError(
                    "dense_topk sizes the sparse_topk payload — construct "
                    "MeshTrainer(dense_wire='sparse_topk', dense_topk=...)")
        self.dense_topk = dense_topk
        self.dense_stats = bool(dense_stats)
        self._zero_plan = None
        # the static wire-cost model of the last step's shapes (the JAX
        # package sets it at trace time; `_observe_wire_cost`)
        self.last_wire_cost = None
        self._wire_cost_key = None

    # -- wire formats ---------------------------------------------------------

    def wire_for(self, name: str) -> str:
        """One table's wire format: its entry of a per-table dict, then the
        dict's "*", then `$OETPU_WIRE`, then bf16."""
        if isinstance(self.wire, dict):
            return wire_mod.wire_format(self.wire.get(name,
                                                      self.wire.get("*")))
        return wire_mod.wire_format(self.wire)

    def wire_default(self) -> str:
        """The format of the tables a per-table dict does not name."""
        if isinstance(self.wire, dict):
            return wire_mod.wire_format(self.wire.get("*"))
        return wire_mod.wire_format(self.wire)

    # -- placement and error feedback: which tables carry what ---------------

    def _placed(self, name: str) -> bool:
        """Whether a table can carry placement state: a table on the
        exchange (not sparse_as_dense) of a mesh of two ranks or more that
        is not host-cached (its own cache tier governs it)."""
        spec = self.model.specs.get(name)
        return (self.num_shards > 1 and spec is not None
                and not spec.sparse_as_dense
                and spec.storage != "host_cached")

    def _per_table(self, value, name: str) -> int:
        if isinstance(value, dict):
            return int(value.get(name, 0))
        return int(value)

    def hot_rows_for(self, name: str) -> int:
        """A table's hot cache rows (0: none; always 0 at S = 1)."""
        return self._per_table(self.hot_rows, name) if self._placed(name) \
            else 0

    def mig_rows_for(self, name: str) -> int:
        """A table's migration annex rows (0: none; always 0 at S = 1)."""
        return self._per_table(self.mig_rows, name) if self._placed(name) \
            else 0

    def ef_for(self, name: str) -> bool:
        """Whether a table carries error-feedback residuals: the
        `error_feedback` argument, else where its wire is int8 (never at
        S = 1, where nothing rides a wire)."""
        if not self._placed(name):
            return False
        if self.error_feedback is not None:
            return bool(self.error_feedback)
        return self.wire_for(name) == "int8"

    @property
    def hot_enabled(self) -> bool:
        return any(self.hot_rows_for(n) for n in self.model.ps_specs())

    @property
    def mig_enabled(self) -> bool:
        return any(self.mig_rows_for(n) for n in self.model.ps_specs())

    def _hot_specs(self) -> Dict[str, EmbeddingSpec]:
        return {n: s for n, s in self.model.ps_specs().items()
                if self.hot_rows_for(n)}

    def _mig_specs(self) -> Dict[str, EmbeddingSpec]:
        return {n: s for n, s in self.model.ps_specs().items()
                if self.mig_rows_for(n)}

    # -- ZeRO dense-state sharding (parallel/zero.py) -----------------------------

    @property
    def zero_enabled(self) -> bool:
        """Whether the dense update runs sharded: asked for, on two ranks or
        more (at S = 1 the chunk is the whole vector)."""
        return self.dense_shard and self.num_shards > 1

    def _dense_trainable(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """{slot key: tensor} of the trainable dense leaves: the module's
        parameters and the sparse_as_dense tables (the port's modules hold
        no frozen state)."""
        return dict(dense_leaves(state.dense, state.embeddings))

    def _zero_plan_for(self, state: TrainState) -> zero.DenseShardPlan:
        """The flat layout of the trainable leaves (cached: the shapes are
        the model's). Under a dense wire every chunk is whole in-band codec
        blocks; the extra padding is inert."""
        if self._zero_plan is None:
            align = wire_mod.INBAND_BLOCK if self.dense_wire else 1
            self._zero_plan = zero.build_plan(
                zero.trainable_leaves(state.dense, state.embeddings),
                self.optimizer, self.num_shards, align=align)
        return self._zero_plan

    @property
    def dense_ef_enabled(self) -> bool:
        """The dense wires that keep the `__dense_ef__` residual: int8's
        rounding and sparse_topk's untransmitted mass; bf16 goes without."""
        return self.dense_wire in ("int8", "sparse_topk")

    def dense_topk_for(self, plan: zero.DenseShardPlan) -> int:
        """k of dense_wire="sparse_topk": `dense_topk` clamped to the chunk,
        else about 1/16 of the chunk rounded up to whole INBAND_BLOCK codec
        blocks."""
        if plan.chunk <= 0:
            return 0
        k = self.dense_topk
        if k is None:
            k = -(-plan.chunk // 16)
            k = -(-k // wire_mod.INBAND_BLOCK) * wire_mod.INBAND_BLOCK
        return max(1, min(int(k), plan.chunk))

    def _chunk(self, plan: zero.DenseShardPlan, flat: torch.Tensor
               ) -> torch.Tensor:
        """This rank's (1, C) chunk of a (padded,) or (1, padded) vector."""
        C, r = plan.chunk, self.mesh.rank
        return flat.reshape(-1)[r * C:(r + 1) * C].reshape(1, -1)

    @torch.no_grad()
    def dense_to_sharded(self, state: TrainState) -> TrainState:
        """The per-leaf dense slots -> the flat form, in place (nothing to do
        when ZeRO is off or the slots are flat already): this rank's chunk
        of each vector slot, the shared scalar slots, and under a dense wire
        the chunk's float32 masters (from the params) and a zero residual.
        Slices only: `dense_to_replicated` gives the slots back byte for
        byte."""
        if not self.zero_enabled or zero.is_sharded_slots(state.dense_slots):
            return state
        plan = self._zero_plan_for(state)
        if plan.total == 0:
            return state
        zero.check_scalar_slots_equal(plan, state.dense_slots)
        flat = {name: (self._chunk(plan, v) if name in plan.vector_slots
                       else v).clone()
                for name, v in zero.shard_slots(plan,
                                                state.dense_slots).items()}
        if self.dense_wire:
            flat[zero.DENSE_MASTER_KEY] = self._chunk(plan, zero.flatten_tree(
                plan, self._dense_trainable(state))).clone()
            if self.dense_ef_enabled:
                flat[zero.DENSE_EF_KEY] = torch.zeros(
                    (1, plan.padded), dtype=torch.float32, device=self.device)
        state.dense_slots = {zero.ZERO_KEY: flat}
        return state

    @torch.no_grad()
    def dense_to_replicated(self, state: TrainState) -> TrainState:
        """The flat dense slots -> the per-leaf form a run without ZeRO
        holds, as a new `TrainState` sharing the tables (`state` is left as
        it is): every vector slot all_gathered and cut back per leaf. Under
        a dense wire the new state's dense module and sparse_as_dense
        tables are copies holding the all_gathered float32 masters, not the
        bfloat16-rounded params the forward pass reads, and the residual is
        dropped (it re-seeds to zeros). The state a checkpoint or an export
        is written from."""
        if not zero.is_sharded_slots(state.dense_slots):
            return state
        plan = self._zero_plan_for(state)
        flat = state.dense_slots[zero.ZERO_KEY]
        whole = {name: (coll.all_gather_tiled(self.mesh, flat[name]
                                              .reshape(-1)).reshape(1, -1)
                        if name in plan.vector_slots else flat[name])
                 for name in (*plan.vector_slots, *plan.scalar_slots)}
        slots = zero.unshard_slots(plan, whole)
        if zero.DENSE_MASTER_KEY not in flat:
            return dataclasses.replace(state, dense_slots=slots)
        master = coll.all_gather_tiled(
            self.mesh, flat[zero.DENSE_MASTER_KEY].reshape(-1))
        dense = copy.deepcopy(state.dense)
        embeddings = {n: t.clone() for n, t in state.embeddings.items()}
        zero.write_tree(plan, master, dict(dense_leaves(dense, embeddings)))
        return dataclasses.replace(state, dense=dense, dense_slots=slots,
                                   embeddings=embeddings)

    def externalize(self, state: TrainState) -> TrainState:
        """`hot_sync`, then the dense slots unsharded
        (`dense_to_replicated`): what `save` writes and an export should be
        written from."""
        return self.dense_to_replicated(self.hot_sync(state))

    @torch.no_grad()
    def _adopt(self, state: TrainState, rep: TrainState) -> TrainState:
        """`rep` (per-leaf, from `dense_to_replicated` or a load into it)
        made `state`'s dense part, then sharded: its params and
        sparse_as_dense tables copied into `state`'s tensors, its slots
        taken over."""
        if rep.dense is not state.dense:
            for (_, dst), (_, src) in zip(
                    dense_leaves(state.dense, state.embeddings),
                    dense_leaves(rep.dense, rep.embeddings)):
                dst.copy_(src)
        state.dense_slots = rep.dense_slots
        return self.dense_to_sharded(state)

    def set_dense_wire(self, state: TrainState, dense_wire,
                       dense_topk=None) -> TrainState:
        """Switch the dense collectives' format between steps, in place:
        nothing when the format and k are the ones in use; else the state
        unsharded (the params take the masters, the residual drops), the
        format swapped, and the state sharded again under the new layout
        (its alignment and wire slots depend on the format). Every
        `CompiledStep` captures anew (`graph_epoch`). The int8 and sparse_topk
        residual re-seeds to zeros, as after a checkpoint's round trip."""
        if dense_wire in (None, "fp32"):
            dense_wire = None
        elif dense_wire not in ("int8", "bf16", "sparse_topk"):
            raise ValueError(
                f"set_dense_wire: dense_wire={dense_wire!r}: expected "
                "'int8', 'bf16', 'sparse_topk', or None/'fp32'")
        if dense_topk is not None:
            if dense_wire != "sparse_topk":
                raise ValueError(
                    "set_dense_wire: dense_topk only applies to "
                    "dense_wire='sparse_topk'")
            dense_topk = int(dense_topk)
            if dense_topk <= 0:
                raise ValueError(f"set_dense_wire: dense_topk={dense_topk} "
                                 "must be positive")
        if dense_wire == self.dense_wire and dense_topk == self.dense_topk:
            return state
        rep = self.dense_to_replicated(state)
        self.dense_wire = dense_wire
        self.dense_topk = dense_topk
        self._zero_plan = None
        self.graph_epoch += 1
        _metrics.observe("dense.wire_rejits", 1)
        return self._adopt(state, rep)

    # -- device-memory accounting (utils/memwatch ledger) ---------------------

    def _hot_device_bytes(self, spec: EmbeddingSpec, H: int) -> int:
        """The bytes one rank holds of a table's hot cache at H rows: the
        probe keys (C = max(2H, 8) slots, in `build_hot_identity`'s key
        dtype: int32 for an array table, int64 for a hash table), their
        int32 ranks, the id list, the weights and the float32 slots."""
        if H <= 0:
            return 0
        C = max(2 * H, 8)
        kb = _probe_keys(spec, 0).itemsize
        item = torch.empty((), dtype=spec.dtype).element_size()
        widths = sum(self.opt_for(spec).slot_shapes(spec.output_dim).values())
        return (C * kb + C * 4 + H * kb
                + H * spec.output_dim * item + H * 4 * widths)

    def _mig_device_bytes(self, spec: EmbeddingSpec, M: int) -> int:
        """The bytes one rank holds of a table's migration set at M rows:
        the directory (probe keys and ranks, ids, int32 owners) and the
        rank's annex (M rows of weights and float32 slots)."""
        if M <= 0:
            return 0
        C = max(2 * M, 8)
        kb = _probe_keys(spec, 0).itemsize
        item = torch.empty((), dtype=spec.dtype).element_size()
        widths = sum(self.opt_for(spec).slot_shapes(spec.output_dim).values())
        return (C * kb + C * 4 + M * kb + M * 4
                + M * spec.output_dim * item + M * 4 * widths)

    def memory_model(self, state: Optional[TrainState] = None) -> dict:
        """This rank's byte model of what the trainer keeps on its device.

        -> {"analytic": {"component/table": bytes}, "measured": {...},
        "host": {...}, "device_total_bytes": int}. The analytic view prices
        the shapes the trainer would hold (specs, placement sizes and the
        ZeRO plan: usable before init and before a resize); the measured
        view walks the live `state` tensors. The two agree exactly on every
        component both price; the dense components need `state`."""
        from ..utils import memwatch as _memwatch
        analytic: Dict[str, int] = {}
        measured: Dict[str, int] = {}
        host: Dict[str, int] = {}
        for name, spec in self.model.ps_specs().items():
            if spec.storage == "host_cached":
                ot = self.offload.get(name)
                if ot is not None:
                    analytic[f"offload_cache/{name}"] = \
                        ot.device_cache_bytes()
                    measured[f"offload_cache/{name}"] = \
                        _memwatch.tree_device_bytes(ot.state)
                    host[f"host_store/{name}"] = ot.store.nbytes()
                continue
            for sub, b in spec.device_bytes(
                    self.opt_for(spec), self.num_shards,
                    need_ef=self.ef_for(name)).items():
                analytic[f"table_{sub}/{name}"] = b
            H = self.hot_rows_for(name)
            if H:
                analytic[f"hot/{name}"] = self._hot_device_bytes(spec, H)
            M = self.mig_rows_for(name)
            if M:
                analytic[f"mig/{name}"] = self._mig_device_bytes(spec, M)
            if state is None or name not in state.tables:
                continue
            ts = state.tables[name]
            measured[f"table_weights/{name}"] = \
                _memwatch.array_device_bytes(ts.weights)
            measured[f"table_slots/{name}"] = \
                _memwatch.tree_device_bytes(ts.slots)
            if ts.keys is not None:
                measured[f"table_keys/{name}"] = (
                    _memwatch.array_device_bytes(ts.keys)
                    + (_memwatch.array_device_bytes(ts.overflow)
                       if ts.overflow is not None else 0))
            if ts.ef is not None:
                measured[f"table_ef/{name}"] = \
                    _memwatch.array_device_bytes(ts.ef)
            if ts.hot is not None:
                measured[f"hot/{name}"] = _memwatch.tree_device_bytes(ts.hot)
            if ts.mig is not None:
                measured[f"mig/{name}"] = _memwatch.tree_device_bytes(ts.mig)
        if state is not None:
            self._dense_memory(state, analytic, measured)
        totals = measured or analytic
        return {"analytic": analytic, "measured": measured, "host": host,
                "device_total_bytes": sum(totals.values())}

    def _dense_memory(self, state: TrainState, analytic: Dict[str, int],
                      measured: Dict[str, int]) -> None:
        """The dense components: the params and sparse_as_dense tables
        (replicated), their slots (the ZeRO flat chunks, or per leaf)."""
        from ..utils import memwatch as _memwatch
        measured["dense_params"] = _memwatch.tree_device_bytes(
            [t for _, t in dense_leaves(state.dense, state.embeddings)])
        analytic["dense_params"] = measured["dense_params"]
        slots = state.dense_slots
        if zero.is_sharded_slots(slots):
            flat = slots[zero.ZERO_KEY]
            has_ef = zero.DENSE_EF_KEY in flat
            has_master = zero.DENSE_MASTER_KEY in flat
            analytic.update(zero.plan_device_bytes(
                self._zero_plan_for(state), ef=has_ef, master=has_master))
            measured["zero_slots"] = sum(
                _memwatch.array_device_bytes(v) for k, v in flat.items()
                if k not in (zero.DENSE_EF_KEY, zero.DENSE_MASTER_KEY))
            if has_ef:
                measured["zero_ef"] = \
                    _memwatch.array_device_bytes(flat[zero.DENSE_EF_KEY])
            if has_master:
                measured["zero_master"] = _memwatch.array_device_bytes(
                    flat[zero.DENSE_MASTER_KEY])
        elif slots is not None:
            measured["dense_slots"] = _memwatch.tree_device_bytes(slots)
            analytic["dense_slots"] = measured["dense_slots"]

    def publish_memory(self, state: Optional[TrainState] = None) -> dict:
        """The model into the memwatch ledger (`memory.bytes{component=,
        table=}` gauges, the measured figure where both views have one),
        reconciled against the device's allocator where the device is a
        card (`MemWatch.sample_devices`). Returns `memory_model(state)`."""
        from ..utils import memwatch as _memwatch
        model = self.memory_model(state)
        view = dict(model["analytic"])
        view.update(model["measured"])
        for key, nbytes in view.items():
            comp, _, table = key.partition("/")
            _memwatch.WATCH.set_component(
                comp, nbytes, labels={"table": table} if table else None)
        for key, nbytes in model["host"].items():
            comp, _, table = key.partition("/")
            _memwatch.WATCH.set_component(
                comp, nbytes, labels={"table": table} if table else None,
                host=True)
        _memwatch.WATCH.publish()
        _memwatch.WATCH.sample_devices(self.device)
        return model

    # -- agreement between the ranks ------------------------------------------

    def _rank0(self, fn):
        """`fn()` evaluated on rank 0, its result on every rank (one object
        broadcast): what the ranks must install alike."""
        if self.mesh.size == 1:
            return fn()
        return coll.broadcast_object(
            self.mesh, fn() if self.mesh.rank == 0 else None)

    def _agree(self, ok: bool) -> bool:
        """True on every rank when `ok` is True on every rank (one psum)."""
        if self.mesh.size == 1:
            return bool(ok)
        bad = torch.full((1,), 0.0 if ok else 1.0, dtype=torch.float32,
                         device=self.device)
        return float(coll.psum(self.mesh, bad).item()) == 0.0

    # -- init -----------------------------------------------------------------

    def init(self, sample_batch) -> TrainState:
        """This rank's state: shard r of every table (rows
        `[r*rps, (r+1)*rps)` of the shard-major (S*rps, dim) table, drawn
        from shard r's generator; S = 1 draws the single-device table), the
        optimizer's slots (a zero `ef` where `ef_for`), an empty hot cache
        (zero rows) and an empty directory and annex where the table has
        them, and the dense params and sparse_as_dense tables, the same on
        every rank (rank 0's, broadcast, as the reference's Horovod
        broadcast)."""
        model, mesh, device = self.model, self.mesh, self.device
        shard = (mesh.rank, mesh.size)
        tables = {}
        for name, spec in model.ps_specs().items():
            if spec.storage == "host_cached":
                tables[name] = self._offload_table(spec).state
                continue
            tables[name] = init_table_state(
                spec, self.opt_for(spec),
                _table_generator(self.seed, spec, device, shard),
                num_shards=mesh.size, error_feedback=self.ef_for(name))
            self._attach_empty(spec, tables[name])
        embeddings = {name: init_table(
                          spec, _table_generator(self.seed, spec, device))
                      for name, spec in model.sad_specs().items()}
        sample = _transformed(model, self._device_batch(sample_batch))
        # the dense module's draws depend on its input widths only: it is
        # materialized from zero rows, with no exchange
        zero_rows = {name: torch.zeros((1, spec.output_dim),
                                       dtype=spec.dtype, device=device)
                     for name, spec in model.specs.items()}
        dense = _materialize_dense(model, zero_rows, sample, self.seed,
                                   device)
        with torch.no_grad():
            for p in list(dense.parameters()) + list(embeddings.values()):
                coll.broadcast_(mesh, p.data)
        return self.dense_to_sharded(TrainState(
            step=0, dense=dense,
            dense_slots=init_dense_slots(self.optimizer, dense, embeddings),
            tables=tables, model_version=0, embeddings=embeddings))

    def _attach_empty(self, spec: EmbeddingSpec,
                      ts: EmbeddingTableState) -> None:
        """An empty cache and an empty directory with a zero annex, where
        the table has them (the JAX MeshTrainer's `init_tables`)."""
        opt, dim, dev = self.opt_for(spec), spec.output_dim, self.device
        H = self.hot_rows_for(spec.name)
        if H:
            ident = identity_tensors(build_hot_identity(spec, H), dev)
            ts.hot = HotRows(
                **ident, weights=torch.zeros((H, dim), dtype=spec.dtype,
                                             device=dev),
                slots=opt.init_slots(H, dim, spec.dtype, device=dev))
        M = self.mig_rows_for(spec.name)
        if M:
            ident = identity_tensors(build_mig_identity(
                spec, M, num_shards=self.num_shards), dev)
            ts.mig = MigRows(
                **ident, weights=torch.zeros((M, dim), dtype=spec.dtype,
                                             device=dev),
                slots=opt.init_slots(M, dim, spec.dtype, device=dev))

    # -- the placement lifecycle (between steps) ------------------------------

    def _hot_tables(self, state: TrainState):
        tables = {n: state.tables[n] for n in self._hot_specs()}
        missing = [n for n, ts in tables.items() if ts.hot is None]
        if missing:
            raise ValueError(
                f"tables {missing} carry no hot cache: states managed by a "
                "hot-enabled MeshTrainer must come from its init()/load()/"
                "refresh_hot_rows()")
        return tables

    def hot_sync(self, state: TrainState) -> TrainState:
        """Write every row the placement serves from elsewhere back into its
        home shard, in place: the hot rows into their owner shards, the
        migrated rows from their assigned owners' annexes. The cache, the
        directory and the annex stay live. `save` calls it first, so a
        checkpoint equals a run's without placement, byte for byte."""
        for name, ts in self._hot_tables(state).items():
            hot_writeback(self.model.specs[name], ts, mesh=self.mesh)
        for name in self._mig_specs():
            ts = state.tables[name]
            if ts.mig is not None:
                mig_writeback(self.model.specs[name], ts, mesh=self.mesh)
        return state

    @staticmethod
    def _np_id_list(ids: torch.Tensor) -> np.ndarray:
        """A cache's or directory's ids -> its valid ids, int64, by rank."""
        a = ids.detach().cpu().numpy()
        return a[a >= 0].astype(np.int64)

    @classmethod
    def _id_list(cls, ids: torch.Tensor) -> set:
        return set(cls._np_id_list(ids).tolist())

    def migrate_rows(self, state: TrainState, moves=None) -> TrainState:
        """Re-home up to `mig_rows` cold rows a table between steps, in
        place: the old migrated rows written back home, the new directory
        installed, the annex filled from the homes (bit copies both ways).
        `moves`: {table: (ids, owners)}, heaviest first
        (`placement.plan_migration` makes them from `shard_positions`); a
        table not named gets an empty directory. Ids in the table's hot
        set are dropped: the two sets stay disjoint. Every rank calls it
        with the same moves."""
        moves = moves or {}
        for name, spec in self._mig_specs().items():
            ts = state.tables[name]
            ids, owners = moves.get(name) or (None, None)
            if ids is not None and ts.hot is not None:
                hot_now = self._id_list(ts.hot.ids)
                ids = np.asarray(ids, np.int64).reshape(-1)
                owners = np.asarray(owners, np.int64).reshape(-1)[:ids.size]
                keep = np.asarray([i not in hot_now for i in ids.tolist()],
                                  bool)
                ids, owners = ids[keep], owners[keep]
            ident = build_mig_identity(spec, self.mig_rows_for(name), ids,
                                       owners, num_shards=self.num_shards)
            _metrics.observe(
                "placement.migrated_rows",
                float(int((np.asarray(ident["rank"])
                           < self.mig_rows_for(name)).sum())),
                "gauge", labels={"table": name})
            if ts.mig is not None:
                mig_writeback(spec, ts, mesh=self.mesh)
                if ts.mig.weights.shape[0] != self.mig_rows_for(name):
                    ts.mig = None  # re-sized: a new directory and annex
            mig_gather(spec, ts, ident, mesh=self.mesh)
        _metrics.observe("placement.migrations", 1)
        return state

    def refresh_hot_rows(self, state: TrainState, hot_ids=None,
                         monitor=None) -> TrainState:
        """Promote and demote the hot sets between steps, in place: the old
        hot rows written back to their owner shards, the new sets
        installed, their rows gathered into the cache (bit copies).

        New sets come from `hot_ids` ({table: ids, hottest first}; every
        rank calls it with the same ids) or, for a table it does not name,
        the heavy-hitter sketches: the top `hot_rows` of `monitor`, the
        trainer's `enable_skew_monitor()` feed, or the global
        `utils.sketch.MONITOR`, read on rank 0 and sent to every rank, so
        the ranks install one set. Ids in the table's migration directory
        are skipped. A table without a cache gets one: the one refresh
        that allocates, asked of `utils.memwatch.WATCH.preflight` first
        (reason "hot_fill"; it goes ahead only where every rank's verdict
        passes, else the state comes back unchanged). A cache whose size
        no longer matches `hot_rows` (the placement controller's `prime`
        re-sized it) is written back and made anew."""
        specs = self._hot_specs()
        if not specs:
            return state
        need = [n for n in specs if hot_ids is None or n not in hot_ids]
        tops = {}
        if need:
            mon = monitor if monitor is not None else self._skew
            if mon is None:
                from ..utils import sketch
                mon = sketch.MONITOR
            tops = self._rank0(lambda: {
                n: [h for h, _est, _err in
                    mon.sketch(n).topk(self.hot_rows_for(n))]
                for n in need})
        idents = {}
        for name, spec in specs.items():
            cand = np.asarray(tops[name] if name in tops else hot_ids[name],
                              np.int64).reshape(-1)
            ts = state.tables[name]
            if ts.mig is not None and cand.size:
                migrated = self._id_list(ts.mig.ids)
                cand = np.asarray([i for i in cand.tolist()
                                   if i not in migrated], np.int64)
            idents[name] = build_hot_identity(spec, self.hot_rows_for(name),
                                              cand)
            _metrics.observe(
                "hot.set_size",
                float(int((np.asarray(idents[name]["rank"])
                           < self.hot_rows_for(name)).sum())),
                "gauge", labels={"table": name})
        _metrics.observe("hot.refreshes", 1)
        missing = [n for n in specs if state.tables[n].hot is None]
        if missing and len(missing) != len(specs):
            self._hot_tables(state)  # raises: some tables lost their cache
        if missing:
            from ..utils import memwatch as _memwatch
            delta = sum(self._hot_device_bytes(specs[n], self.hot_rows_for(n))
                        for n in missing)
            if not self._agree(_memwatch.WATCH.preflight(
                    delta, reason="hot_fill")):
                return state
        for name, spec in specs.items():
            ts = state.tables[name]
            if ts.hot is not None:
                hot_writeback(spec, ts, mesh=self.mesh)
                if ts.hot.weights.shape[0] != self.hot_rows_for(name):
                    ts.hot = None
            hot_gather(spec, ts, idents[name], mesh=self.mesh)
        return state

    def drop_unplaced(self, state: TrainState) -> TrainState:
        """Write back and drop the caches and directories of tables whose
        `hot_rows` / `mig_rows` is now 0 (after a re-size), in place."""
        for name, spec in self.model.ps_specs().items():
            ts = state.tables.get(name)
            if ts is None:
                continue
            if ts.hot is not None and not self.hot_rows_for(name):
                hot_writeback(spec, ts, mesh=self.mesh)
                ts.hot = None
            if ts.mig is not None and not self.mig_rows_for(name):
                mig_writeback(spec, ts, mesh=self.mesh)
                ts.mig = None
        return state

    # -- overflow governance --------------------------------------------------

    @staticmethod
    def overflow_count(metrics) -> int:
        """Exchange-bucket drops in a step's or window's metrics (reads
        them back to the host)."""
        total = int(metrics.get("overflow", 0))
        for k, v in metrics.get("stats", {}).items():
            if k.endswith("_overflow"):
                total += int(v)
        return total

    def check_overflow(self, metrics, *, growth: float = 2.0) -> bool:
        """Drive the overflow policy with a step's or window's metrics.
        Returns True when the exchange capacity grew: bucket shapes are
        static, so every graph driver of this trainer captures anew at its
        next call. "count" only watches; "raise" fails loud; "grow"
        multiplies `capacity_factor` by `growth`, up to S, where a bucket
        holds every id (exact mode, which never drops)."""
        dropped = self.overflow_count(metrics)
        if dropped == 0:
            return False
        if self.on_overflow == "raise":
            raise RuntimeError(
                f"{dropped} ids overflowed the all_to_all buckets "
                f"(capacity_factor={self.capacity_factor}); raise "
                "capacity_factor or construct "
                "MeshTrainer(on_overflow='grow')")
        if self.on_overflow != "grow" or self.capacity_factor <= 0:
            return False
        new = min(self.capacity_factor * growth, float(self.num_shards))
        if new == self.capacity_factor:
            return False
        _metrics.observe("exchange.capacity_grown", 1)
        self.capacity_factor = new
        self.graph_epoch += 1
        return True

    # -- checkpoints ----------------------------------------------------------

    def save(self, state: TrainState, path: str, **kw):
        """Every rank writes its own shards (`parallel/checkpoint.py`), rank
        0 the meta and the dense files; returns once all have written. To a
        remote URI (`utils/fs`) each rank writes into a local temporary
        directory and pushes only the files it wrote. The
        placement is written back first (`hot_sync`), so the files equal a
        run's without it; `ef` is saved as the slot `__ef__`."""
        from .checkpoint import save_sharded
        stores = self.offload_store_snapshots(state)
        state = self.externalize(state)
        meta = self._stage_save(lambda p: save_sharded(
            state, self.model, p, num_shards=self.num_shards,
            rank=self.mesh.rank, offload_stores=stores, **kw), path)
        coll.barrier(self.mesh)
        return meta

    def load(self, state: TrainState, path: str) -> TrainState:
        """A checkpoint of either layout, written at any mesh size, into
        this rank's shards, in place; a hash table's overflow counter
        becomes the ids of every shard that found no slot; `ef` loads from
        the `__ef__` slot where the checkpoint has it. The hot cache and
        the directory keep their sets and re-gather their rows from the
        loaded shards. Under ZeRO the dense part loads in its per-leaf form
        and is sharded again into the state's own flat tensors (the graphs
        hold their addresses); the masters come from the loaded params and
        the residual re-seeds to zeros."""
        from .checkpoint import load_sharded
        return self._stage_load(lambda p: self.load_into(
            state, lambda target: load_sharded(
                target, self.model, p, num_shards=self.num_shards,
                rank=self.mesh.rank, offload=self._adopted(state))), path)

    def load_into(self, state: TrainState, fill) -> TrainState:
        """`load`'s path around `fill(target)`, which writes a restored
        state into this rank's `target` in place (`persist`'s restore loads
        a base and replays its deltas there): under ZeRO `target` is the
        per-leaf form, sharded again into the state's own flat tensors
        after it; every hash counter becomes the sum over the ranks; the
        cache and the directory gather their rows from the result."""
        sharded = zero.is_sharded_slots(state.dense_slots)
        target = self.dense_to_replicated(state) if sharded else state
        fill(target)
        if sharded:
            self._reshard_into(state, target)
        else:
            self.dense_to_sharded(state)
        for ts in state.tables.values():
            if ts.overflow is not None:
                ts.overflow.copy_(coll.psum(self.mesh, ts.overflow))
        # the cache and the directory are never saved: re-install the sets
        # the state held (or empty ones) and gather their rows from the
        # loaded shards; the stale cached rows are never written back
        for name, spec in self._hot_specs().items():
            ts = state.tables[name]
            hot_gather(spec, ts, self._identity(ts.hot, spec, "hot"),
                       mesh=self.mesh)
        for name, spec in self._mig_specs().items():
            ts = state.tables[name]
            mig_gather(spec, ts, self._identity(ts.mig, spec, "mig"),
                       mesh=self.mesh)
        return state

    @torch.no_grad()
    def _reshard_into(self, state: TrainState, rep: TrainState) -> None:
        """`rep`'s dense part (per-leaf, just loaded) written into `state`'s
        params, sparse_as_dense tables and flat slots, in place, and its
        step counters taken over."""
        fresh = self._adopt(dataclasses.replace(state, dense_slots=None), rep)
        flat = state.dense_slots[zero.ZERO_KEY]
        for name, v in fresh.dense_slots[zero.ZERO_KEY].items():
            flat[name].copy_(v)
        state.step, state.model_version = rep.step, rep.model_version

    def _identity(self, part, spec: EmbeddingSpec, kind: str) -> dict:
        """The identity a cache or directory holds (an empty one for
        None), as the host arrays `hot_gather` / `mig_gather` take."""
        if part is None:
            if kind == "hot":
                return build_hot_identity(spec, self.hot_rows_for(spec.name))
            return build_mig_identity(spec, self.mig_rows_for(spec.name),
                                      num_shards=self.num_shards)
        names = ("keys", "rank", "ids") + (("owners",) if kind == "mig"
                                           else ())
        return {k: getattr(part, k).cpu().numpy().copy() for k in names}

    # -- the step's hooks -------------------------------------------------------

    def _packed_layouts(self, state: TrainState) -> Dict[str, tuple]:
        """No table is packed on the mesh: `train_many` runs the split
        layout (equal to the packed one bit for bit on one device)."""
        del state
        return {}

    def _exchange_groups(self):
        """Dim-groups split by each table's wire format."""
        return split_wire_groups(self.model.dim_groups(), self.wire_for)

    def tables_pull(self, state, ids, packed):
        self._observe_wire_cost(ids)
        pulled, plans, stats = {}, {}, {}
        ps = self.model.ps_specs()
        if self.group_exchange:
            for names in self._exchange_groups():
                _, outs, stats_list, plan_list = grouped_lookup_train(
                    [ps[n] for n in names], [state.tables[n] for n in names],
                    [ids[n] for n in names], mesh=self.mesh,
                    capacity_factor=self.capacity_factor,
                    wire=self.wire_for(names[0]),
                    load_stats=self.shard_stats)
                for n, out, st, plan in zip(names, outs, stats_list,
                                            plan_list):
                    pulled[n], plans[n] = out, plan
                    stats.update({f"{n}/{k}": v for k, v in st.items()})
            return pulled, plans, stats
        for n, spec in ps.items():
            _, pulled[n], st, plans[n] = sharded_lookup_train(
                spec, state.tables[n], ids[n], mesh=self.mesh,
                capacity_factor=self.capacity_factor,
                load_stats=self.shard_stats, wire=self.wire_for(n))
            stats.update({f"{n}/{k}": v for k, v in st.items()})
        return pulled, plans, stats

    def tables_apply(self, state, ids, grads, plans, packed):
        stats = {}
        ps = self.model.ps_specs()
        if self.group_exchange:
            for names in self._exchange_groups():
                specs = [ps[n] for n in names]
                _, stats_list = grouped_apply_gradients(
                    specs, [state.tables[n] for n in names],
                    [self.opt_for(s) for s in specs], [ids[n] for n in names],
                    [grads[n] for n in names], mesh=self.mesh,
                    capacity_factor=self.capacity_factor,
                    plans=[plans[n] for n in names],
                    wire=self.wire_for(names[0]), hot_wire=self.hot_wire)
                for n, st in zip(names, stats_list):
                    stats.update({f"{n}/{k}": v for k, v in st.items()})
            return stats
        for n, spec in ps.items():
            _, st = sharded_apply_gradients(
                spec, state.tables[n], self.opt_for(spec), ids[n], grads[n],
                mesh=self.mesh, capacity_factor=self.capacity_factor,
                plan=plans[n], wire=self.wire_for(n),
                hot_wire=self.hot_wire)
            stats.update({f"{n}/{k}": v for k, v in st.items()})
        return stats

    def reduce_dense_grads(self, grads):
        """Every dense gradient summed over the ranks, in rank order: one
        collective per dtype over the gradients laid end to end. Under ZeRO
        as they are: the sum folds into `dense_update`'s reduce_scatter."""
        if self.mesh.size == 1 or self.zero_enabled:
            return grads
        out = dict(grads)
        for dtype in sorted({g.dtype for g in grads.values()}, key=str):
            group = [k for k, g in grads.items() if g.dtype == dtype]
            total = coll.dense_sum(self.mesh, torch.cat(
                [grads[k].reshape(-1) for k in group]))
            off = 0
            for k in group:
                n = grads[k].numel()
                out[k] = total[off:off + n].view_as(grads[k])
                off += n
        return out

    def dense_grad_stats(self, grads) -> Dict[str, torch.Tensor]:
        """`dense/grad_density` where `dense_stats`: the nonzero share of this
        rank's dense gradients before the reduce, divided by S, so the
        stats' sum over the ranks (`reduce_metrics`) is the ranks' mean.
        The count adds in float32 and the share is the count times the
        float32 reciprocal of total * S, what XLA makes of the JAX
        package's division by that constant."""
        if not self.dense_stats:
            return {}
        total = sum(g.numel() for g in grads.values())
        if total == 0:
            return {}
        nnz = torch.zeros((), dtype=torch.float32, device=self.device)
        for g in grads.values():
            nnz = nnz + torch.count_nonzero(g).to(torch.float32)
        return {"dense/grad_density":
                nnz * (1.0 / float(total * self.num_shards))}

    @torch.no_grad()
    def dense_update(self, state, grads) -> None:
        """The ZeRO dense update (the dense optimizer over all ranks
        otherwise), in place; `grads` are each rank's own, not summed:

        - fp32: the flat gradient reduce_scattered (summed in rank order),
          this rank's chunk of the params updated with its chunk of the
          flat slots (`optimizer.apply` on a (1, C) row), the new chunks
          all_gathered into the params;
        - "bf16" / "int8": the flat gradient (int8: plus the residual)
          encoded, all_to_all'd by destination chunk, the S sources decoded
          and added in float32 in rank order; the update reads and writes
          the chunk's float32 masters, and the params are all_gathered on
          the bfloat16 carrier. int8 keeps the new residual, the gradient
          less what its encoding decodes to, as one rounding: XLA contracts
          the JAX package's `flat_g - decode_flat(enc)` into a fused
          multiply-add (`wire.residual`);
        - "sparse_topk": as int8, but each destination chunk ships its k
          largest-magnitude elements (`zero.encode_flat_topk`), the sources'
          payloads decoded to dense chunks and added; the residual keeps
          what was not shipped and the shipped elements' rounding (two
          roundings: XLA does not contract this one).

        Ranges `trainer.dense_reduce_scatter` / `trainer.dense_grad_exchange`,
        `trainer.dense_update` and `trainer.dense_gather`."""
        if not self.zero_enabled:
            return super().dense_update(state, grads)
        plan = self._zero_plan_for(state)
        if plan.total == 0:
            return super().dense_update(state, grads)
        mesh, fmt = self.mesh, self.dense_wire
        S, C = plan.num_shards, plan.chunk
        self._observe_dense_cost(plan)
        flat_slots = state.dense_slots[zero.ZERO_KEY]
        params = self._dense_trainable(state)
        new_ef = None
        if not fmt:
            with record_function("trainer.dense_reduce_scatter"):
                g_local = coll.reduce_scatter(
                    mesh, zero.flatten_tree(plan, grads))
        elif fmt == "sparse_topk":
            with record_function("trainer.dense_grad_exchange"):
                k = self.dense_topk_for(plan)
                flat_g = zero.flatten_tree(plan, grads) \
                    + flat_slots[zero.DENSE_EF_KEY].reshape(-1)
                enc = zero.encode_flat_topk(flat_g, S, k)   # (S, Wk) int8
                new_ef = (flat_g.reshape(S, C)
                          - zero.decode_flat_topk(enc, k, C)).reshape(1, -1)
                recv = coll.all_to_all(mesh, enc.reshape(S, 1, -1))
                parts = zero.decode_flat_topk(recv.reshape(S, -1), k, C)
                g_local = coll.rank_sum(list(parts.unbind(0)))
        else:
            with record_function("trainer.dense_grad_exchange"):
                flat_g = zero.flatten_tree(plan, grads)
                if fmt == "int8":
                    flat_g = flat_g + flat_slots[zero.DENSE_EF_KEY].reshape(-1)
                enc = zero.encode_flat(flat_g, fmt)         # (padded/B, W)
                if fmt == "int8":
                    new_ef = wire_mod.residual(
                        flat_g.reshape(-1, wire_mod.INBAND_BLOCK), enc,
                        wire_mod.INBAND_BLOCK, fmt).reshape(1, -1)
                W = enc.shape[1]
                recv = coll.all_to_all(mesh, enc.reshape(S, -1, W))
                parts = zero.decode_flat(recv.reshape(-1, W), fmt).reshape(
                    S, C)
                g_local = coll.rank_sum(list(parts.unbind(0)))
        with record_function("trainer.dense_update"):
            if fmt:
                w_local = flat_slots[zero.DENSE_MASTER_KEY]
                opt_slots = {k: v for k, v in flat_slots.items()
                             if k not in (zero.DENSE_MASTER_KEY,
                                          zero.DENSE_EF_KEY)}
            else:
                w_local = self._chunk(plan, zero.flatten_tree(plan, params))
                opt_slots = flat_slots
            new_w, new_slots = self.optimizer.apply(
                w_local, opt_slots, g_local.reshape(1, -1),
                torch.ones(1, dtype=torch.int32, device=self.device))
        with record_function("trainer.dense_gather"):
            if fmt:
                carrier = new_w.reshape(-1).to(torch.bfloat16).view(
                    torch.int16)
                flat_new = coll.all_gather_tiled(mesh, carrier).view(
                    torch.bfloat16).to(torch.float32)
            else:
                flat_new = coll.all_gather_tiled(mesh, new_w.reshape(-1))
            zero.write_tree(plan, flat_new, params)
        for k, v in new_slots.items():
            flat_slots[k].copy_(v)
        if fmt:
            flat_slots[zero.DENSE_MASTER_KEY].copy_(new_w)
        if new_ef is not None:
            flat_slots[zero.DENSE_EF_KEY].copy_(new_ef)

    def _observe_dense_cost(self, plan: zero.DenseShardPlan) -> None:
        """The ZeRO update's static costs as `dense.*` gauges, and its
        collectives' bytes in `last_wire_cost` (the JAX package publishes
        them at trace time; host code, so a replay runs none of it)."""
        fmt = self.dense_wire
        k = self.dense_topk_for(plan) if fmt == "sparse_topk" else None
        dcost = zero.dense_wire_cost(plan, fmt, topk=k)
        if self.last_wire_cost is not None:
            cost = dict(self.last_wire_cost)
            cost["dense_wire_format"] = dcost["format"]
            cost["dense_a2a_bytes"] = dcost["a2a_bytes"]
            cost["dense_reduce_scatter_bytes"] = dcost["rs_bytes"]
            cost["dense_all_gather_bytes"] = dcost["ag_bytes"]
            cost["dense_bytes_per_step"] = dcost["bytes_per_step"]
            if k is not None:
                cost["dense_wire_k"] = int(k)
            self.last_wire_cost = cost
        obs = _metrics.observe
        obs("dense.params_total", float(plan.total), "gauge")
        obs("dense.zero_shards", float(plan.num_shards), "gauge")
        obs("dense.shard_elems", float(plan.chunk), "gauge")
        obs("dense.opt_state_bytes_per_replica",
            float(len(plan.vector_slots) * plan.chunk * 4
                  + len(plan.scalar_slots) * 4), "gauge")
        obs("dense.reduce_scatter_bytes", float(dcost["rs_bytes"]), "gauge")
        obs("dense.a2a_bytes", float(dcost["a2a_bytes"]), "gauge")
        obs("dense.all_gather_bytes", float(dcost["ag_bytes"]), "gauge")
        obs("dense.wire_bytes_per_step", float(dcost["bytes_per_step"]),
            "gauge")
        obs("dense.wire_dtype",
            {None: 4.0, "bf16": 2.0, "int8": 1.0, "sparse_topk": 1.0}[fmt],
            "gauge")
        fp32_cost = zero.dense_wire_cost(plan, None)
        obs("dense.wire_bytes_saved",
            float(fp32_cost["bytes_per_step"] - dcost["bytes_per_step"]),
            "gauge")
        if k is not None:
            obs("dense.grad_topk", float(k), "gauge")

    def _observe_wire_cost(self, ids: Dict[str, torch.Tensor], *,
                           pipelined: bool = False) -> None:
        """Publish the static wire-cost model of a step over these ids'
        shapes (the JAX package's `_observe_wire_cost`, run there once per
        trace; here once per shape, format and capacity) and keep it in
        `last_wire_cost`, which the StepWatch prices bytes with."""
        ps_specs = self.model.ps_specs()
        key = (pipelined, self.capacity_factor,
               tuple((n, tuple(ids[n].shape), ids[n].element_size())
                     for n in ps_specs))
        if key == self._wire_cost_key:
            return
        self._wire_cost_key = key
        from .sharded import _bucket_capacity, conflict_patch_cap
        obs = _metrics.observe
        tables = []
        for name, spec in ps_specs.items():
            n = ids[name].numel()
            cap = _bucket_capacity(max(n, 1), self.num_shards,
                                   self.capacity_factor)
            tables.append({"dim": spec.output_dim, "cap": cap,
                           "pair": spec.use_hash_table,
                           "id_itemsize": ids[name].element_size(),
                           "fmt": self.wire_for(name)})
            labels = {"table": name}
            obs("exchange.pull_positions", float(n), "gauge", labels=labels)
            obs("exchange.bucket_capacity", float(cap), "gauge",
                labels=labels)
            obs("exchange.row_dim", float(spec.output_dim), "gauge",
                labels=labels)
            M = self.mig_rows_for(name)
            if M:
                obs("placement.mig_rows", float(M), "gauge", labels=labels)
        fmt = self.wire_default()
        cost = wire_mod.exchange_cost(tables, self.num_shards, fmt,
                                      fused=self.group_exchange)
        _metrics.observe_exchange_cost(cost)
        for name in ps_specs:
            obs("exchange.wire_dtype",
                float(torch.empty((), dtype=wire_mod.wire_dtype(
                    self.wire_for(name))).element_size()),
                "gauge", labels={"table": name})
        if pipelined:
            ptables = [dict(t, pcap=conflict_patch_cap(
                t["cap"], self.conflict_factor)) for t in tables]
            pcost = wire_mod.conflict_patch_cost(ptables, self.num_shards,
                                                 fmt)
            cost = dict(cost)
            cost["overlapped_bytes"] = int(cost["bytes_per_step"])
            cost["conflict_patch_bytes"] = int(pcost["bytes_patch"])
            cost["bytes_per_step"] = (int(cost["bytes_per_step"])
                                      + int(pcost["bytes_patch"]))
            cost["collectives_per_step"] = (int(cost["collectives_per_step"])
                                            + int(pcost["collectives"]))
            obs("exchange.conflict_patch_bytes", float(pcost["bytes_patch"]),
                "gauge")
            obs("exchange.overlapped_bytes", float(cost["overlapped_bytes"]),
                "gauge")
        hot_by_fmt: Dict[str, list] = {}
        for name, spec in ps_specs.items():
            H = self.hot_rows_for(name)
            if not H:
                continue
            obs("hot.rows", float(H), "gauge", labels={"table": name})
            hfmt = (wire_mod.wire_format(self.hot_wire)
                    if self.hot_wire is not None else self.wire_for(name))
            hot_by_fmt.setdefault(hfmt, []).append(
                {"dim": spec.output_dim, "hot": H})
        if hot_by_fmt:
            tot = a2a = ag = 0
            for hfmt, hot_tables in hot_by_fmt.items():
                hcost = wire_mod.hot_reduce_cost(hot_tables, self.num_shards,
                                                 hfmt)
                tot += int(hcost["bytes"])
                a2a += int(hcost["a2a_bytes"])
                ag += int(hcost["all_gather_bytes"])
            obs("hot.replicate_bytes_per_step", float(tot), "gauge")
            cost = dict(cost)
            cost["hot_replicate_bytes"] = tot
            cost["hot_a2a_bytes"] = a2a
            cost["hot_all_gather_bytes"] = ag
            cost["hot_wire_format"] = ",".join(sorted(hot_by_fmt))
        self.last_wire_cost = cost

    def record_window_stats(self, metrics) -> None:
        """Fold a `train_many` window's host-visible counters into gauges:
        a pipelined window's `exchange.conflict_rows{table=}` and
        `exchange.conflict_overflow`, in one device-to-host copy; nothing
        for a serial window."""
        conflict = (metrics.get("conflict")
                    if isinstance(metrics, dict) else None)
        if not conflict:
            return
        names = sorted(conflict)
        vals = [conflict[n] for n in names]
        co = metrics.get("conflict_overflow")
        if co is not None:
            vals.append(co)
        host = torch.stack([torch.as_tensor(v).reshape(()).to(torch.float64)
                            for v in vals]).cpu().tolist()
        for name, v in zip(names, host):
            _metrics.observe("exchange.conflict_rows", float(v), "gauge",
                             labels={"table": name})
        if co is not None:
            _metrics.observe("exchange.conflict_overflow", float(host[-1]),
                             "gauge")

    def reduce_module_state(self, module: nn.Module) -> None:
        """Float buffers a forward pass updates (none in the port's
        modules) averaged over the ranks, as the JAX MeshTrainer pmeans
        its frozen state."""
        for buf in module.buffers():
            if buf.is_floating_point():
                buf.copy_(coll.pmean(self.mesh, buf))

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss to report from this rank's: the mean over the ranks."""
        return coll.pmean(self.mesh, loss)

    def reduce_metrics(self, loss, stats):
        return (self._reduce_loss(loss),
                coll.psum_stats(self.mesh, stats))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Read-only pulls through `sharded_lookup` (no insert) -> this
        rank's logits and the loss averaged over the ranks."""
        b = _transformed(self.model, self._device_batch(batch))
        embedded = {}
        for name, spec in self.model.ps_specs().items():
            ids = b["sparse"][spec.feature_name]
            embedded[name] = combine(spec, ids, sharded_lookup(
                spec, state.tables[name], ids, mesh=self.mesh,
                capacity_factor=self.capacity_factor))
        for name, spec in self.model.sad_specs().items():
            ids = b["sparse"][spec.feature_name]
            embedded[name] = combine(spec, ids,
                                     sad_rows(state.embeddings[name], ids))
        attach_ids(embedded, self.model, b, self.device)
        logits = state.dense(embedded, b.get("dense"))
        return {"logits": logits,
                "loss": self._reduce_loss(self._loss(logits, b))}

    # -- the pipelined window ---------------------------------------------------

    def _pipeline_on(self) -> bool:
        """Whether `train_many` pipelines: asked for, on two ranks or more
        (at S = 1 the exchange is local, there is nothing to overlap)."""
        return self.pipeline_steps and self.num_shards > 1

    def _pipeline_groups(self):
        """The exchanges the pipelined loop fans over: the (dim, format)
        groups, or one table each under group_exchange=False (one table's
        group pulls what its per-table pull does, bit for bit)."""
        groups = self._exchange_groups()
        if not self.group_exchange:
            return [[n] for g in groups for n in g]
        return groups

    def _prefetch_stream(self):
        """The side stream the prefetch runs on: a CUDA mesh over NCCL
        only. A staged or CPU mesh blocks the host at every collective, so
        it runs the same schedule on the one stream."""
        if self.device.type != "cuda" or self.mesh.staged:
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    @torch.no_grad()
    def _pipeline_prefetch(self, state, ids):
        """A batch's id plans and speculative rows, a step ahead
        (`sharded.grouped_prefetch`) -> ({table: plan}, {table: unique
        rows}, the pull stats as `tables_pull` names them)."""
        ps = self.model.ps_specs()
        plans, rows, stats = {}, {}, {}
        for names in self._pipeline_groups():
            _, plan_list, rows_list, stats_list = grouped_prefetch(
                [ps[n] for n in names], [state.tables[n] for n in names],
                [ids[n] for n in names], mesh=self.mesh,
                capacity_factor=self.capacity_factor,
                wire=self.wire_for(names[0]), load_stats=self.shard_stats)
            for n, plan, r, st in zip(names, plan_list, rows_list,
                                      stats_list):
                plans[n], rows[n] = plan, r
                stats.update({f"{n}/{k}": v for k, v in st.items()})
        return plans, rows, stats

    @torch.no_grad()
    def _pipeline_finalize(self, state, ids, plans, rows):
        """The prefetched pull consumed: the hot overlay and the duplicates'
        expansion (`sharded.grouped_finalize_pull`) -> {table: rows}."""
        ps = self.model.ps_specs()
        pulled = {}
        for names in self._pipeline_groups():
            outs = grouped_finalize_pull(
                [ps[n] for n in names], [state.tables[n] for n in names],
                [ids[n] for n in names], [plans[n] for n in names],
                [rows[n] for n in names])
            pulled.update(zip(names, outs))
        return pulled

    @torch.no_grad()
    def _pipeline_patch(self, state, prev_plans, plans, rows):
        """The next batch's rows repaired after this batch's apply
        (`sharded.grouped_conflict_patch`; narrow-wire residuals replayed
        in place) -> ({table: rows}, {table: patched rows this rank sent},
        members past the cap)."""
        ps = self.model.ps_specs()
        patched, conflict = {}, {}
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        for names in self._pipeline_groups():
            outs, stats_list = grouped_conflict_patch(
                [ps[n] for n in names], [state.tables[n] for n in names],
                [prev_plans[n] for n in names], [plans[n] for n in names],
                [rows[n] for n in names], mesh=self.mesh,
                conflict_factor=self.conflict_factor,
                wire=self.wire_for(names[0]))
            for n, out, st in zip(names, outs, stats_list):
                patched[n], conflict[n] = out, st["conflict_rows"]
                overflow = overflow + st["conflict_overflow"]
        return patched, conflict, overflow

    def _many(self, state: TrainState, b):
        """`Trainer._many`, pipelined where `_pipeline_on`."""
        self._check_offload_prepared()
        if not self._pipeline_on():
            return super()._many(state, b)
        return self._many_pipelined(state, b)

    def _many_pipelined(self, state: TrainState, b):
        """The pipelined window, in place:

            prologue  prefetch(b[0])
            step t    prefetch(b[t+1])    issued first, on the side stream
                      finalize(b[t])      its rows as batch t's pull
                      forward, backward, dense apply; the sparse apply
                      once the prefetch is done (its serve has read the
                      tables, its stats ride this step's)
                      patch(b[t+1])
            last      finalize(b[K-1]), forward, backward, applies

        Batch t+1's pull stats ride step t's (its hash inserts happen in
        the serial order, and an apply never moves a key, so the plans'
        slots hold). The side stream waits on the main stream before each
        prefetch, so a block it allocates is never reused while the main
        stream still reads the block's last tenant; the main stream waits
        on the prefetch before the sparse apply, the first work that writes
        what the prefetch reads or reads what it writes. -> {"loss": (K,),
        "overflow", "conflict": {table: patched rows summed over the ranks
        and steps}, "conflict_overflow"}."""
        model, mesh, dev = self.model, self.mesh, self.device
        K = b["label"].shape[0]
        batches = [_transformed(model, _batch_slice(b, k)) for k in range(K)]
        ids = [self._batch_ids(bt) for bt in batches]
        side = self._prefetch_stream()
        main = torch.cuda.current_stream(dev) if side is not None else None

        def overflow_of(stats):
            total = torch.zeros((), dtype=torch.int32, device=dev)
            for key, v in stats.items():
                if key.endswith("_overflow"):
                    total = total + v
            return total

        self._observe_wire_cost(ids[0], pipelined=True)
        plans, rows, pf_stats = self._pipeline_prefetch(state, ids[0])
        # the prologue's pull overflow and the patch counters are this
        # rank's; one sum over the ranks at the end of the window
        first = overflow_of(pf_stats)
        conflict = {n: torch.zeros((), dtype=torch.int32, device=dev)
                    for n in model.ps_specs()}
        coflow = torch.zeros((), dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        losses = []
        for t in range(K):
            ahead = t + 1 < K
            before_apply = None
            if ahead and side is not None:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    nplans, nrows, pf_stats = self._pipeline_prefetch(
                        state, ids[t + 1])
                before_apply = lambda: main.wait_stream(side)
            elif ahead:
                nplans, nrows, pf_stats = self._pipeline_prefetch(
                    state, ids[t + 1])
            pulled = self._pipeline_finalize(state, ids[t], plans, rows)
            loss, _, stats = self._step_tail(
                state, batches[t], ids[t], pulled, plans,
                dict(pf_stats) if ahead else {}, {}, before_apply)
            losses.append(loss)
            overflow = overflow + overflow_of(stats)
            if ahead:
                nrows, rows_patched, co = self._pipeline_patch(
                    state, plans, nplans, nrows)
                for n, c in rows_patched.items():
                    conflict[n] = conflict[n] + c
                coflow = coflow + co
                plans, rows = nplans, nrows
        names = list(conflict)
        total = coll.psum(mesh, torch.stack(
            [first] + [conflict[n] for n in names] + [coflow]))
        return {"loss": torch.stack(losses), "overflow": overflow + total[0],
                "conflict": {n: total[1 + i] for i, n in enumerate(names)},
                "conflict_overflow": total[-1]}

    # -- compiled steps -------------------------------------------------------

    def _graphs_allowed(self) -> None:
        if self.mesh.staged:
            raise RuntimeError(
                "a staged mesh (gloo with tensors on a card) has no graph "
                "driver: its collectives copy through the host. Run "
                "train_step / train_many, or use NCCL")

    def jit_train_step(self, timed: bool = False):
        self._graphs_allowed()
        return super().jit_train_step(timed)

    def jit_train_many(self, timed: bool = False):
        self._graphs_allowed()
        return super().jit_train_many(timed)

    def jit_eval_step(self):
        """`eval_step` as a CUDA graph (its pulls' exchange and the loss's
        mean over the ranks captured, as the train step's collectives
        are); none on a staged mesh."""
        self._graphs_allowed()
        return super().jit_eval_step()

    def _many_driver(self):
        """The window driver the trainer keeps (`offload_train_many`'s and
        `train_stream`'s): `jit_train_many`, or `train_many` on a staged
        mesh, which has no graph driver."""
        if self.mesh.staged:
            return self.train_many
        return super()._many_driver()

    def train_stream(self, state: TrainState, windows, *,
                     block: bool = True, driver=None):
        """Drive the window driver over a stream of stacked K-step windows
        already on the device (a `data.ingest.FeedRing` in window mode),
        with the input-wait attribution lane: each window's blocking
        `next()` lands in `trainer.input_wait_ms` (`input_timed`) and each
        window's wall time in the `trainer.window_ms` histogram, the
        denominator `data.ingest.input_wait_share` folds the waits against.
        Window stats fold through `record_window_stats`.

        `driver`: None is the trainer's kept window driver
        (`_many_driver`: the `jit_train_many` CUDA graph, or `train_many`
        on a staged mesh; on the CPU the eager window). The ring drops a
        partial window, so every window has one structure and the graph is
        captured once. `block=True` synchronizes the trainer's stream after
        every window (and before the first), so `window_ms` is the window's
        wall time; with `block=False` only the launches are timed.

        Returns `(state, {"windows": n, "loss": last})`, `last` the last
        step's loss of the last window (None for an empty stream)."""
        import time as _time
        cuda = self.device.type == "cuda"
        sync = (torch.cuda.current_stream(self.device).synchronize
                if cuda and block else (lambda: None))
        many = driver if driver is not None else self._many_driver()
        n = 0
        last = None
        sync()
        for w in self.input_timed(windows):
            t0 = _time.perf_counter()
            state, m = many(state, w)
            sync()
            _metrics.observe("trainer.window_ms",
                             (_time.perf_counter() - t0) * 1e3, "hist")
            self.record_window_stats(m)
            # a graph's outputs are overwritten by its next replay
            last = m["loss"][-1].clone() if isinstance(m, dict) else None
            n += 1
        return state, {"windows": n,
                       "loss": None if last is None else float(last)}



class SeqMeshTrainer(MeshTrainer):
    """Context-parallel trainer over a 2-D (data, seq) mesh
    (`mesh.make_seq_mesh(D, P)`; port of the JAX package's
    `SeqMeshTrainer`):

    - batch rows over "data", the sequence dim over "seq": each rank steps
      on its (B/D, ..., S/P) block (`multihost.local_batch` cuts it), and
      the module's ring or Ulysses attention runs over the rank's seq group
      (the trainer binds the module's `seq_axis` around every forward
      pass);
    - the tables row-sharded over all D*P ranks (`id % (D*P)`): the
      pull/push all_to_all, the dense sum and the metrics run over the
      whole mesh;
    - the dense gradients summed over all ranks (the sum of the
      reference, not a mean: the seq shards of one sample also sum);
    - a loss function that takes `norm_axis` (`sasrec_bce_loss`) is
      normalized by the mask count of the whole mesh, and the reported
      loss is the sum over the ranks, the global mean.

    Logits come out (B/D, S/P, 2) on each rank. The module must use
    attention "ring" or "ulysses" with `seq_axis` the mesh's second axis
    name (e.g. `make_sasrec(..., attention="ring")`). Graph drivers
    capture where the backend allows it (NCCL on cards); a staged mesh
    (gloo with tensors on a card) runs eagerly. The numerics sentinel,
    `halt_on_nonfinite` and `measure_every` work as on `MeshTrainer`."""

    def __init__(self, model: EmbeddingModel,
                 optimizer: Optional[SparseOptimizer] = None, *, mesh: Mesh,
                 seed: int = 0, capacity_factor: float = 0.0, wire=None,
                 group_exchange: bool = True, shard_stats: bool = True,
                 hot_rows=0, mig_rows=0, hot_wire: Optional[str] = None,
                 error_feedback: Optional[bool] = None,
                 sentinel: bool = False, halt_on_nonfinite: bool = False,
                 measure_every: int = 0):
        if len(mesh.axis_names) != 2 or mesh.seq is None:
            raise ValueError(
                f"SeqMeshTrainer needs a 2-D (data, seq) mesh "
                f"(make_seq_mesh), got axes {mesh.axis_names}")
        super().__init__(model, optimizer, mesh=mesh, seed=seed,
                         capacity_factor=capacity_factor, wire=wire,
                         group_exchange=group_exchange,
                         shard_stats=shard_stats, hot_rows=hot_rows,
                         mig_rows=mig_rows, hot_wire=hot_wire,
                         error_feedback=error_feedback, sentinel=sentinel,
                         halt_on_nonfinite=halt_on_nonfinite,
                         measure_every=measure_every)
        self.data_axis, self.seq_axis = mesh.axis_names
        from ..models.sequential import takes_norm_axis
        self._norm = takes_norm_axis(model.loss_fn)

    def _bound(self):
        """The module's seq axis bound to this rank's seq group."""
        from .sequence import bind_axis
        return bind_axis(self.seq_axis, self.mesh.seq)

    def _loss(self, logits, batch):
        """Normalized by the mask count of the whole mesh where the loss
        function takes `norm_axis`: with the sequence dim sharded, a
        per-shard mean would upweight positions on padding-heavy shards
        against the same batch trained without context parallelism."""
        if not self._norm:
            return super()._loss(logits, batch)
        w = batch.get("weight")
        args = (logits, batch["label"]) if w is None else (
            logits, batch["label"], w)
        return self.model.loss_fn(*args, norm_axis=self.mesh)

    def _reduce_loss(self, loss):
        """Each rank's loss is its sum over the global count, so the global
        mean is the sum over the ranks (not the mean of the ranks')."""
        if self._norm:
            return coll.dense_sum(self.mesh, loss)
        return super()._reduce_loss(loss)

    def _step_tail(self, *args, **kwargs):
        with self._bound():
            return super()._step_tail(*args, **kwargs)

    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        with self._bound():
            return super().eval_step(state, batch)
