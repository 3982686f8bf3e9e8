"""What the port's mesh tests run on each spawned rank.

The functions take the rank's `Mesh` first (`parallel.multihost.run_local`
calls `fn(mesh, *args)` in a fresh process) and return numpy only. This
module imports torch and the port, never JAX: a spawned rank imports it to
find its function, and must start quickly.
"""

import numpy as np
import torch

from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.embedding import (EmbeddingSpec,
                                               EmbeddingTableState)
from openembedding_tpu_torch.initializers import Constant
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import MeshTrainer, sharded
from openembedding_tpu_torch.parallel.multihost import local_batch

OPTIMIZERS = {
    "adagrad": lambda lr=0.1: optimizers.Adagrad(learning_rate=lr),
    "adam": lambda lr=0.05: optimizers.Adam(learning_rate=lr),
    "ftrl": lambda lr=0.1: optimizers.Ftrl(learning_rate=lr),
    "rmsprop": lambda lr=0.05: optimizers.RMSprop(learning_rate=lr),
    "momentum": lambda lr=0.1: optimizers.SGD(learning_rate=lr,
                                              momentum=0.9),
    "adamax": lambda lr=0.05: optimizers.Adamax(learning_rate=lr),
}


def to_host(tree):
    """A result tree with every tensor as a numpy array (for `run_local`'s
    pickled results)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy()
        return t.numpy().copy()
    return tree


def _shard(a, mesh):
    a = np.asarray(a)
    rps = a.shape[0] // mesh.size
    return a[mesh.rank * rps:(mesh.rank + 1) * rps]


def protocol(mesh, case):
    """One table's training pull and push on this rank: `case` holds the
    spec's fields, the global shard-major arrays (weights, accumulator,
    keys), the global id and grad batches (rank r steps on its rows), the
    capacity factor and the wire format. Returns the plan, the pulled rows,
    the stats and the shard after the update."""
    spec = EmbeddingSpec(name="v", variable_id=0, **case["spec"])
    table = EmbeddingTableState(
        weights=torch.tensor(_shard(case["weights"], mesh)),
        slots={"accum": torch.tensor(_shard(case["accum"], mesh))})
    if spec.use_hash_table:
        table.keys = torch.tensor(_shard(case["keys"], mesh))
        table.overflow = torch.zeros((), dtype=torch.int32)
    ids = torch.tensor(local_batch(case["ids"], mesh))
    grads = torch.tensor(local_batch(case["grads"], mesh))
    cf, wire = case["capacity_factor"], case["wire"]
    opt = optimizers.Adagrad(learning_rate=0.1)
    if case.get("grouped"):
        _, rows, stats, plans = sharded.grouped_lookup_train(
            [spec], [table], [ids], mesh=mesh, capacity_factor=cf,
            wire=wire)
        rows, stats, plan = rows[0], stats[0], plans[0]
        _, push = sharded.grouped_apply_gradients(
            [spec], [table], [opt], [ids], [grads], mesh=mesh,
            capacity_factor=cf, plans=[plan], wire=wire)
        push = push[0]
    else:
        _, rows, stats, plan = sharded.sharded_lookup_train(
            spec, table, ids, mesh=mesh, capacity_factor=cf, wire=wire)
        _, push = sharded.sharded_apply_gradients(
            spec, table, opt, ids, grads, mesh=mesh, capacity_factor=cf,
            plan=plan, wire=wire)
    out = {"recv_ids": plan.recv_ids, "bucket_ids": plan.buckets.bucket_ids,
           "owner": plan.buckets.owner, "slot": plan.buckets.slot,
           "unique_ids": plan.uniq.unique_ids, "counts": plan.uniq.counts,
           "inverse": plan.uniq.inverse, "rows": rows,
           "stats": {**stats, **push}, "weights": table.weights,
           "accum": table.slots["accum"], "staged_bytes": mesh.staged_bytes}
    if spec.use_hash_table:
        out["keys"], out["overflow"] = table.keys, table.overflow
    return to_host(out)


def deepfm(vocab, *, hashed=False, capacity=0, dim=9, hidden=(16, 16),
           initializer=None):
    model = make_deepfm(vocab, dim, hidden=hidden, hashed=hashed,
                        capacity=capacity, compute_dtype=torch.float32)
    if initializer is not None:
        import dataclasses
        spec = model.specs["categorical"]
        model.specs["categorical"] = dataclasses.replace(
            spec, initializer=initializer)
    return model


def trajectory(mesh, cfg):
    """`cfg["steps"]` MeshTrainer steps on this rank's rows of the global
    batches, from the JAX MeshTrainer's state (`mesh_state_from_jax`);
    -> the losses and the rank's state in the JAX layout."""
    model = deepfm(cfg["vocab"], hashed=cfg["hashed"],
                   capacity=cfg.get("capacity", 0))
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire=cfg["wire"],
                          group_exchange=cfg["grouped"],
                          capacity_factor=cfg.get("capacity_factor", 0.0))
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                        mesh.rank, device="cpu")
    losses, overflow = [], 0
    for b in cfg["batches"]:
        state, m = trainer.train_step(state, local_batch(b, mesh))
        losses.append(float(m["loss"]))
        overflow += trainer.overflow_count(m)
    return {"losses": losses, "overflow": overflow,
            "state": convert.train_state_to_jax(state)}


def randomized(mesh, case):
    """Step 0 of the port's MeshTrainer on this rank (Constant-initialized
    table, so both sides start alike) -> the shard's table, the loss."""
    model = deepfm(case["vocab"], hashed=case["hashed"],
                   capacity=case["capacity"], dim=case["dim"] - 1,
                   hidden=(8,), initializer=Constant(0.05))
    trainer = MeshTrainer(model, OPTIMIZERS[case["opt"]](), mesh=mesh)
    batch = local_batch(case["batch"], mesh)
    state = trainer.init(batch)
    state, m = trainer.train_step(state, batch)
    t = state.tables["categorical"]
    return to_host({"loss": m["loss"], "weights": t.weights,
                    "keys": t.keys, "slots": t.slots})


def protocol_cases(mesh, cases):
    return {name: protocol(mesh, c) for name, c in cases.items()}


def trajectories(mesh, cfgs):
    return [trajectory(mesh, c) for c in cfgs]


def randomized_cases(mesh, cases):
    return [randomized(mesh, c) for c in cases]


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins, so
    the launcher has to kill it."""
    if mesh.rank == 1:
        raise ValueError("planted")
    from openembedding_tpu_torch.parallel import collectives
    collectives.barrier(mesh)


def exchange_encoded(mesh, x, counts):
    """Two ranks all_to_all bf16-encoded grads and counts (the int16
    carrier) -> what this rank received."""
    from openembedding_tpu_torch.ops import wire
    from openembedding_tpu_torch.parallel import collectives
    payload = wire.encode_grads(torch.tensor(x) * (mesh.rank + 1),
                                torch.tensor(counts), "bf16")
    recv = collectives.all_to_all(mesh, payload.reshape(2, 4, -1))
    _, c = wire.decode_grads(recv.reshape(8, -1), x.shape[1], "bf16")
    return {"dtype": str(recv.dtype), "recv": recv.numpy(),
            "counts": c.numpy()}


def load_and_save(mesh, cfg):
    """This rank loads the checkpoint `cfg["load"]` (any layout, any mesh
    size) into a fresh MeshTrainer state and saves it, sharded, into
    `cfg["save"]` -> the rank's state in the JAX layout."""
    model = deepfm(cfg["vocab"], hashed=cfg["hashed"],
                   capacity=cfg.get("capacity", 0))
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh)
    state = trainer.init(local_batch(cfg["batch"], mesh))
    state = trainer.load(state, cfg["load"])
    trainer.save(state, cfg["save"])
    return convert.train_state_to_jax(state)


def entry_and_direct(mesh, argv, steps):
    """The entry point's `main(argv)` with `--mesh` on this rank, then the
    same run through MeshTrainer directly -> both runs' losses."""
    from openembedding_tpu_torch import data
    from openembedding_tpu_torch import models as zoo
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    out = ex.main(argv)
    args = ex.build_parser().parse_args(argv)
    model = zoo.from_config({"family": args.model,
                             "vocabulary": args.vocabulary, "dim": args.dim})
    trainer = MeshTrainer(model, optimizers.Adagrad(args.learning_rate),
                          mesh=mesh)
    rows = data.read_criteo_tsv(args.data, args.batch_size,
                                id_space=args.vocabulary, drop_remainder=True,
                                repeat=True, native="on")
    it = iter(data.CriteoBatcher(rows, args.batch_size))
    batches = [local_batch(next(it), mesh) for _ in range(steps)]
    it.close()
    state = trainer.init(batches[0])
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(float(m["loss"]))
    return {"main": out["losses"].tolist(), "direct": losses,
            "mesh_size": out["trainer"].mesh.size}
