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
  `bucket_fill`) summed.

The JAX MeshTrainer's hot rows, migration, ZeRO dense sharding and its
wire, the pipelined loop, host offload, the numerics sentinel and
`measure_every` are not ported: setting one away from its default raises
NotImplementedError naming its ROADMAP.md item. `SeqMeshTrainer` waits for
the sequence models (item 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..embedding import combine, init_table, init_table_state
from ..model import (EmbeddingModel, TrainState, Trainer, _materialize_dense,
                     _table_generator, _transformed, attach_ids,
                     init_dense_slots, sad_rows)
from ..ops import wire as wire_mod
from ..optimizers import SparseOptimizer
from ..utils.fs import local_path
from . import collectives as coll
from .mesh import Mesh, make_mesh
from .sharded import (grouped_apply_gradients, grouped_lookup_train,
                      sharded_apply_gradients, sharded_lookup,
                      sharded_lookup_train, split_wire_groups)

# constructor arguments of the JAX MeshTrainer the port does not have:
# name -> (default, ROADMAP.md item)
NOT_PORTED = {
    "hot_rows": (0, "3 (hot rows)"), "mig_rows": (0, "3 (migration)"),
    "hot_wire": (None, "3 (hot rows)"),
    "error_feedback": (None, "3 (the int8 wire)"),
    "dense_shard": (False, "3 (ZeRO)"), "dense_wire": (None, "3 (ZeRO)"),
    "dense_topk": (None, "3 (ZeRO)"), "dense_stats": (False, "3 (ZeRO)"),
    "offload_pipeline": (False, "4"), "offload_densify": (1, "4"),
    "offload_stage_depth": (1, "4"),
    "pipeline_steps": (False, "3 (the pipelined loop)"),
    "conflict_factor": (0.0, "3 (the pipelined loop)"),
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
    - `wire`: the rows' and grads' format, "fp32" or "bf16" (None:
      `$OETPU_WIRE`, then bf16), or a per-table dict with a "*" default.
    - `group_exchange`: tables of one width share three all_to_alls a step
      (False: three per table). `shard_stats`: the per-shard load stats.

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
                 shard_stats: bool = True, **unported):
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
            fmt = self.wire_for(name)  # validates every format now
            if self.num_shards > 1:
                wire_mod.wire_dtype(fmt)  # int8 raises: not ported
        self.group_exchange = group_exchange
        self.shard_stats = shard_stats

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

    # -- init -----------------------------------------------------------------

    def init(self, sample_batch) -> TrainState:
        """This rank's state: shard r of every table (rows
        `[r*rps, (r+1)*rps)` of the shard-major (S*rps, dim) table, drawn
        from shard r's generator; S = 1 draws the single-device table), the
        optimizer's slots, and the dense params and sparse_as_dense tables,
        the same on every rank (rank 0's, broadcast, as the reference's
        Horovod broadcast)."""
        model, mesh, device = self.model, self.mesh, self.device
        shard = (mesh.rank, mesh.size)
        tables = {name: init_table_state(
                      spec, self.opt_for(spec),
                      _table_generator(self.seed, spec, device, shard),
                      num_shards=mesh.size)
                  for name, spec in model.ps_specs().items()}
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
        0 the meta and the dense files; returns once all have written."""
        from .checkpoint import save_sharded
        meta = save_sharded(self.externalize(state), self.model,
                            local_path(path), num_shards=self.num_shards,
                            rank=self.mesh.rank, **kw)
        coll.barrier(self.mesh)
        return meta

    def load(self, state: TrainState, path: str) -> TrainState:
        """A checkpoint of either layout, written at any mesh size, into
        this rank's shards, in place; a hash table's overflow counter
        becomes the ids of every shard that found no slot."""
        from .checkpoint import load_sharded
        load_sharded(state, self.model, local_path(path),
                     num_shards=self.num_shards, rank=self.mesh.rank)
        for ts in state.tables.values():
            if ts.overflow is not None:
                ts.overflow.copy_(coll.psum(self.mesh, ts.overflow))
        return state

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
                    wire=self.wire_for(names[0]))
                for n, st in zip(names, stats_list):
                    stats.update({f"{n}/{k}": v for k, v in st.items()})
            return stats
        for n, spec in ps.items():
            _, st = sharded_apply_gradients(
                spec, state.tables[n], self.opt_for(spec), ids[n], grads[n],
                mesh=self.mesh, capacity_factor=self.capacity_factor,
                plan=plans[n], wire=self.wire_for(n))
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

