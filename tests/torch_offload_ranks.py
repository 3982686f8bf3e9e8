"""What the port's host-offload mesh tests (`test_torch_offload_mesh.py`)
run on each spawned rank.

The functions take the rank's `Mesh` first (`parallel.multihost.run_local`
calls `fn(mesh, *args)` in a fresh process) and return numpy and plain
values only. This module imports torch and the port, never JAX.
"""

import dataclasses
import os

import numpy as np
import torch

from openembedding_tpu_torch import (AsyncPersister, PersistPolicy, convert,
                                     data, optimizers, restore_server_model)
from openembedding_tpu_torch.examples import criteo_deepctr as ex
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.multihost import local_batch
from openembedding_tpu_torch.parallel.sharded import sharded_lookup

from torch_mesh_ranks import deepfm


def offload_model(capacity, storage="host_cached"):
    model = deepfm(-1, hashed=True, capacity=capacity,
                   initializer=Constant(0.0))
    model.specs["categorical"] = dataclasses.replace(
        model.specs["categorical"], storage=storage)
    return model


def _trainer(mesh, cfg, storage="host_cached"):
    capacity = cfg["capacity"] if storage == "host_cached" else cfg["big"]
    return MeshTrainer(offload_model(capacity, storage),
                       optimizers.Adagrad(learning_rate=0.3), mesh=mesh,
                       wire="fp32", **cfg.get("trainer", {}))


def _start(mesh, cfg, storage="host_cached"):
    """A trainer and this rank's state from the JAX MeshTrainer's init
    (`cfg["jax_state"]`): the dense part carried, the cache the trainer's
    own (a fresh Constant(0.0) cache equals JAX's)."""
    trainer = _trainer(mesh, cfg, storage)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    own = trainer.init(batches[0])
    state = convert.mesh_state_from_jax(cfg["jax_state"], trainer.model,
                                        mesh.size, mesh.rank, device="cpu")
    state.tables["categorical"] = own.tables["categorical"]
    return trainer, state, batches


def _rows(trainer, state, ids):
    """The table's rows of `ids` wherever they live (a collective)."""
    if trainer.offload:
        return trainer.offload["categorical"].lookup_anywhere(ids)
    return sharded_lookup(trainer.model.specs["categorical"],
                          state.tables["categorical"], torch.from_numpy(ids),
                          mesh=trainer.mesh).numpy()


def offload_mesh_run(mesh, cfg):
    """The host-cached DeepFM over the ranks: `cfg["steps"]` steps
    (prepare, then an eager step; staged a batch ahead where
    `cfg["trainer"]` pipelines), then one `offload_train_many` window of
    the next `cfg["window"]` batches; a sharded save, a full persist and
    its restore into a fresh state; the in-HBM mesh over the same batches.
    -> losses, rows by id, residency, store ids, counters, the restore's
    rows and the in-HBM run's losses and rows."""
    trainer, state, batches = _start(mesh, cfg)
    ot = trainer.offload["categorical"]
    steps, K = cfg["steps"], cfg["window"]
    losses = []
    trainer.offload_stage(batches[0])
    for i, b in enumerate(batches[:steps]):
        state = trainer.offload_prepare(state, b)
        if i + 1 < steps:
            trainer.offload_stage(batches[i + 1])
        state, m = trainer.train_step(state, b)
        losses.append(float(m["loss"]))
    residency = ot.resident_ids()
    window = batches[steps:steps + K]
    state, m = trainer.offload_train_many(state, ex.stack_batches(window))
    losses += m["loss"].tolist()
    ids = cfg["ids"]
    rows = _rows(trainer, state, ids)
    out = {"losses": losses, "rows": rows, "residency": residency,
           "store_ids": ot.store.ids.copy(), "counters": dict(ot.counters),
           "pipe": (ot.pipe_hits, ot.pipe_misses),
           "overflow": trainer.table_overflow(state, "categorical")}

    trainer.save(state, cfg["ckpt"])
    with AsyncPersister(trainer, trainer.model, cfg["root"],
                        policy=PersistPolicy(every_steps=1)) as p:
        p.persist(state)
    fresh = _trainer(mesh, cfg)
    restored = restore_server_model(fresh.init(batches[0]), fresh.model,
                                    cfg["root"], trainer=fresh)
    out["restored_rows"] = _rows(fresh, restored, ids)
    out["restored_step"] = restored.step
    loaded = fresh.load(fresh.init(batches[0]), cfg["ckpt"])
    out["loaded_rows"] = _rows(fresh, loaded, ids)
    out["files"] = sorted(os.listdir(os.path.join(cfg["ckpt"],
                                                  "variable_0")))

    hbm, hstate, _ = _start(mesh, cfg, storage="hbm")
    hlosses = []
    for b in batches[:steps + K]:
        hstate, m = hbm.train_step(hstate, b)
        hlosses.append(float(m["loss"]))
    out["hbm_losses"] = hlosses
    out["hbm_rows"] = _rows(hbm, hstate, ids)
    return out


def entry_offload(mesh, argv, steps):
    """The entry point's `main(argv)` (`--mesh --offload`) on this rank, then
    the same prepared steps through MeshTrainer directly -> both runs'
    losses, whether the cache evicted, and this rank's stored ids."""
    out = ex.main(argv)
    args = ex.build_parser().parse_args(argv)
    recipe = {"family": args.model, "vocabulary": args.vocabulary,
              "dim": args.dim}
    trainer = MeshTrainer(ex.build_model(args, recipe),
                          optimizers.Adagrad(args.learning_rate), mesh=mesh)
    rows = data.read_criteo_tsv(args.data, args.batch_size,
                                id_space=args.vocabulary, drop_remainder=True,
                                repeat=True, native="on")
    it = iter(data.CriteoBatcher(rows, args.batch_size))
    batches = [local_batch(next(it), mesh) for _ in range(steps)]
    it.close()
    state = trainer.init(batches[0])
    losses = []
    for b in batches:
        state = trainer.offload_prepare(state, b)
        state, m = trainer.train_step(state, b)
        losses.append(float(m["loss"]))
    ot = out["trainer"].offload["categorical"]
    return {"main": out["losses"].tolist(), "direct": losses,
            "evicted": ot.counters["evictions"] + ot.counters["flushes"] > 0,
            "store_ids": ot.store.ids.copy()}
