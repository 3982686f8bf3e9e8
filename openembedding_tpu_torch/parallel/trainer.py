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

The JAX MeshTrainer's ZeRO dense sharding and its wire, host offload, the
numerics sentinel and `measure_every` are not ported: setting one away
from its default raises NotImplementedError naming its ROADMAP.md item.
So does `refresh_hot_rows` without explicit ids, which reads the
heavy-hitter sketches (item 6). `SeqMeshTrainer` waits for the sequence
models (item 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..embedding import (EmbeddingSpec, EmbeddingTableState, HotRows,
                         MigRows, combine, init_table, init_table_state)
from ..model import (EmbeddingModel, TrainState, Trainer, _batch_slice,
                     _materialize_dense, _table_generator, _transformed,
                     attach_ids, init_dense_slots, sad_rows)
from ..ops import wire as wire_mod
from ..optimizers import SparseOptimizer
from ..utils.fs import local_path
from . import collectives as coll
from .mesh import Mesh, make_mesh
from .sharded import (build_hot_identity, build_mig_identity,
                      grouped_apply_gradients, grouped_conflict_patch,
                      grouped_finalize_pull, grouped_lookup_train,
                      grouped_prefetch, hot_gather, hot_writeback,
                      identity_tensors, mig_gather, mig_writeback,
                      sharded_apply_gradients, sharded_lookup,
                      sharded_lookup_train, split_wire_groups)

# constructor arguments of the JAX MeshTrainer the port does not have:
# name -> (default, ROADMAP.md item)
NOT_PORTED = {
    "dense_shard": (False, "3 (ZeRO)"), "dense_wire": (None, "3 (ZeRO)"),
    "dense_topk": (None, "3 (ZeRO)"), "dense_stats": (False, "3 (ZeRO)"),
    "offload_pipeline": (False, "4"), "offload_densify": (1, "4"),
    "offload_stage_depth": (1, "4"),
    "sentinel": (False, "1.5"), "halt_on_nonfinite": (False, "1.5"),
    "measure_every": (0, "1.5"),
}


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

    `init` gives each rank its shard of every table (shard r of S draws
    from its own generator: no rank builds a whole table) and the same
    dense params (rank 0's, broadcast). `train_step`, `train_many` and
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
                 **unported):
        for key, value in unported.items():
            if key not in NOT_PORTED:
                raise TypeError(f"MeshTrainer got an unexpected argument "
                                f"{key!r}")
            default, item = NOT_PORTED[key]
            if value != default:
                raise NotImplementedError(
                    f"MeshTrainer({key}=...) is not ported yet (ROADMAP.md "
                    f"item {item})")
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(model, optimizer, seed, device=self.mesh.device)
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
        exchange (not sparse_as_dense) of a mesh of two ranks or more."""
        spec = self.model.specs.get(name)
        return (self.num_shards > 1 and spec is not None
                and not spec.sparse_as_dense)

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
        tables = {name: init_table_state(
                      spec, self.opt_for(spec),
                      _table_generator(self.seed, spec, device, shard),
                      num_shards=mesh.size, error_feedback=self.ef_for(name))
                  for name, spec in model.ps_specs().items()}
        for name, spec in model.ps_specs().items():
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
        return TrainState(
            step=0, dense=dense,
            dense_slots=init_dense_slots(self.optimizer, dense, embeddings),
            tables=tables, model_version=0, embeddings=embeddings)

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
    def _id_list(ids: torch.Tensor) -> set:
        a = ids.detach().cpu().numpy()
        return set(a[a >= 0].astype(np.int64).tolist())

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
            if ts.mig is not None:
                mig_writeback(spec, ts, mesh=self.mesh)
            mig_gather(spec, ts, ident, mesh=self.mesh)
        return state

    def refresh_hot_rows(self, state: TrainState, hot_ids=None,
                         monitor=None) -> TrainState:
        """Promote and demote the hot sets between steps, in place: the old
        hot rows written back to their owner shards, the new sets
        installed, their rows gathered into the cache (bit copies).
        `hot_ids`: {table: ids, hottest first}; every rank calls it with
        the same ids. Ids in the table's migration directory are skipped.
        A table without a cache gets one (the only call that allocates).
        Sets from the heavy-hitter sketches (`hot_ids=None`, `monitor`)
        are not ported (ROADMAP.md item 6)."""
        specs = self._hot_specs()
        if not specs:
            return state
        if monitor is not None:
            raise NotImplementedError(
                "refresh_hot_rows(monitor=...) reads the heavy-hitter "
                "sketches, not ported yet (ROADMAP.md item 6); pass hot_ids")
        idents = {}
        for name, spec in specs.items():
            if hot_ids is None or name not in hot_ids:
                raise NotImplementedError(
                    f"refresh_hot_rows without hot_ids[{name!r}] reads the "
                    "heavy-hitter sketches, not ported yet (ROADMAP.md item "
                    "6); pass hot_ids={table: ids}")
            cand = np.asarray(hot_ids[name], np.int64).reshape(-1)
            ts = state.tables[name]
            if ts.mig is not None and cand.size:
                migrated = self._id_list(ts.mig.ids)
                cand = np.asarray([i for i in cand.tolist()
                                   if i not in migrated], np.int64)
            idents[name] = build_hot_identity(spec, self.hot_rows_for(name),
                                              cand)
        missing = [n for n in specs if state.tables[n].hot is None]
        if missing and len(missing) != len(specs):
            self._hot_tables(state)  # raises: some tables lost their cache
        for name, spec in specs.items():
            ts = state.tables[name]
            if ts.hot is not None:
                hot_writeback(spec, ts, mesh=self.mesh)
            hot_gather(spec, ts, idents[name], mesh=self.mesh)
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
        self.capacity_factor = new
        self.graph_epoch += 1
        return True

    # -- checkpoints ----------------------------------------------------------

    def save(self, state: TrainState, path: str, **kw):
        """Every rank writes its own shards (`parallel/checkpoint.py`), rank
        0 the meta and the dense files; returns once all have written. The
        placement is written back first (`hot_sync`), so the files equal a
        run's without it; `ef` is saved as the slot `__ef__`."""
        from .checkpoint import save_sharded
        meta = save_sharded(self.externalize(state), self.model,
                            local_path(path), num_shards=self.num_shards,
                            rank=self.mesh.rank, **kw)
        coll.barrier(self.mesh)
        return meta

    def load(self, state: TrainState, path: str) -> TrainState:
        """A checkpoint of either layout, written at any mesh size, into
        this rank's shards, in place; a hash table's overflow counter
        becomes the ids of every shard that found no slot; `ef` loads from
        the `__ef__` slot where the checkpoint has it. The hot cache and
        the directory keep their sets and re-gather their rows from the
        loaded shards."""
        from .checkpoint import load_sharded
        load_sharded(state, self.model, local_path(path),
                     num_shards=self.num_shards, rank=self.mesh.rank)
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

    def reduce_dense_grads(self, state, sad_leaves) -> None:
        """Every dense gradient summed over the ranks, in rank order: one
        collective per dtype over the gradients laid end to end."""
        if self.mesh.size == 1:
            return
        leaves = [p for _, p in state.dense.named_parameters()]
        leaves += [sad_leaves[n] for n in sorted(sad_leaves)]
        for leaf in leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        for dtype in sorted({leaf.dtype for leaf in leaves}, key=str):
            group = [leaf for leaf in leaves if leaf.dtype == dtype]
            total = coll.dense_sum(self.mesh, torch.cat(
                [leaf.grad.reshape(-1) for leaf in group]))
            off = 0
            for leaf in group:
                n = leaf.numel()
                leaf.grad = total[off:off + n].view_as(leaf)
                off += n

    def reduce_module_state(self, module: nn.Module) -> None:
        """Float buffers a forward pass updates (none in the port's
        modules) averaged over the ranks, as the JAX MeshTrainer pmeans
        its frozen state."""
        for buf in module.buffers():
            if buf.is_floating_point():
                buf.copy_(coll.pmean(self.mesh, buf))

    def reduce_metrics(self, loss, stats):
        return (coll.pmean(self.mesh, loss),
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
                "loss": coll.pmean(self.mesh, self._loss(logits, b))}

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

    def jit_train_step(self):
        self._graphs_allowed()
        return super().jit_train_step()

    def jit_train_many(self):
        self._graphs_allowed()
        return super().jit_train_many()

