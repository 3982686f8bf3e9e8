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
                                               EmbeddingTableState, HotRows,
                                               MigRows)
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


def placement_protocol(mesh, case):
    """One training pull and push of one table with the placement of
    `case` installed on this rank: residuals `case["ef"]` (global,
    shard-major), a hot set (`hot_rows`, `hot_ids`) through `hot_gather`, a
    directory (`mig_rows`, `moves`) through `mig_gather`; then both written
    back. -> the pulled rows, the stats, and the shard, residuals, cache
    and annex after the push, and the shard after the write-back."""
    spec = EmbeddingSpec(name="v", variable_id=0, **case["spec"])
    table = EmbeddingTableState(
        weights=torch.tensor(_shard(case["weights"], mesh)),
        slots={"accum": torch.tensor(_shard(case["accum"], mesh))})
    if spec.use_hash_table:
        table.keys = torch.tensor(_shard(case["keys"], mesh))
        table.overflow = torch.zeros((), dtype=torch.int32)
    if case.get("ef") is not None:
        table.ef = torch.tensor(_shard(case["ef"], mesh))
    if case.get("hot_rows"):
        sharded.hot_gather(spec, table, sharded.build_hot_identity(
            spec, case["hot_rows"], case["hot_ids"]), mesh=mesh)
    if case.get("mig_rows"):
        ids, owners = case["moves"]
        sharded.mig_gather(spec, table, sharded.build_mig_identity(
            spec, case["mig_rows"], ids, owners, num_shards=mesh.size),
            mesh=mesh)
    ids = torch.tensor(local_batch(case["ids"], mesh))
    grads = torch.tensor(local_batch(case["grads"], mesh))
    wire, hot_wire = case["wire"], case.get("hot_wire")
    opt = optimizers.Adagrad(learning_rate=0.1)
    if case.get("grouped"):
        _, rows, stats, plans = sharded.grouped_lookup_train(
            [spec], [table], [ids], mesh=mesh, wire=wire)
        rows, stats = rows[0], stats[0]
        sharded.grouped_apply_gradients(
            [spec], [table], [opt], [ids], [grads], mesh=mesh, plans=plans,
            wire=wire, hot_wire=hot_wire)
    else:
        _, rows, stats, plan = sharded.sharded_lookup_train(
            spec, table, ids, mesh=mesh, wire=wire)
        sharded.sharded_apply_gradients(
            spec, table, opt, ids, grads, mesh=mesh, plan=plan, wire=wire,
            hot_wire=hot_wire)
    out = {"rows": rows, "stats": stats, "pushed": {
        "weights": table.weights.clone(),
        "accum": table.slots["accum"].clone()}}
    if table.ef is not None:
        out["ef"] = table.ef
    for kind in ("hot", "mig"):
        part = getattr(table, kind)
        if part is not None:
            out[kind] = {"weights": part.weights.clone(),
                         "accum": part.slots["accum"].clone()}
    sharded.hot_writeback(spec, table, mesh=mesh)
    sharded.mig_writeback(spec, table, mesh=mesh)
    out.update(weights=table.weights, accum=table.slots["accum"])
    if spec.use_hash_table:
        out["keys"], out["overflow"] = table.keys, table.overflow
    return to_host(out)


def lifecycle(mesh, cfg):
    """The placement lifecycle on a MeshTrainer state: a gather followed by
    a write-back leaves the shards bit for bit as they were; then a few
    steps with `refresh_hot_rows`, `migrate_rows` and `hot_sync` between
    them keep every tensor of the state where it was. -> what held."""
    trainer = placement_trainer(mesh, cfg)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    state = trainer.init(batches[0])
    ts = state.tables["categorical"]
    before = {k: v.clone() for k, v in (("weights", ts.weights),
                                        ("accum", ts.slots["accum"]))}
    state = place(trainer, state, cfg, 0)
    state = trainer.hot_sync(state)
    out = {"round_trip": bool(torch.equal(before["weights"], ts.weights)
                              and torch.equal(before["accum"],
                                              ts.slots["accum"]))}
    ptrs = [t.data_ptr() for t in ts.tensors()]
    for k, b in enumerate(batches):
        state = place(trainer, state, cfg, k + 1)
        state, _ = trainer.train_step(state, b)
        state = trainer.hot_sync(state)
    out["placed"] = {"hot": int((ts.hot.ids >= 0).sum()),
                     "mig": int((ts.mig.ids >= 0).sum())}
    # a save writes the placement back; a load keeps the sets and gathers
    # their rows from the loaded shards, over whatever the cache held
    kept = {k: v.clone() for k, v in (("hot", ts.hot.weights),
                                      ("ids", ts.hot.ids),
                                      ("owners", ts.mig.owners))}
    trainer.save(state, cfg["tmp"])
    ts.hot.weights.zero_()
    state = trainer.load(state, cfg["tmp"])
    out["load_regathers"] = all(torch.equal(kept[k], v) for k, v in (
        ("hot", ts.hot.weights), ("ids", ts.hot.ids),
        ("owners", ts.mig.owners)))
    out["same_tensors"] = ptrs == [t.data_ptr() for t in ts.tensors()]
    return out


def _state_bytes(state) -> dict:
    """Every tensor of a state as numpy (the tables after `hot_sync`, the
    dense params and slots), for bit-for-bit comparisons."""
    st = convert.train_state_to_jax(state)
    out = {f"dense/{k}": v for k, v in st["dense_params"].items()}
    out.update({f"dense_slots/{k}": v for k, v in st["dense_slots"].items()})
    for n, t in st["tables"].items():
        out[f"{n}/weights"] = t["weights"]
        out.update({f"{n}/{k}": v for k, v in t["slots"].items()})
        if "keys" in t:
            out[f"{n}/keys"], out[f"{n}/overflow"] = t["keys"], t["overflow"]
    return out


def _files(path) -> dict:
    """{file: its bytes} of a checkpoint; an .npz by its arrays' bytes (a
    zip member carries its write time), `model_meta` left out (it holds a
    random model sign)."""
    import os
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            if name.endswith(".npz"):
                with np.load(full) as z:
                    out[rel] = {k: z[k].tobytes() for k in z.files}
            elif name != "model_meta":
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def placement_vs_plain(mesh, cfg):
    """The same steps with the placement of `cfg` (fp32 wire) and without,
    from one state: -> whether the losses, the whole state after
    `hot_sync` and the files of a sharded save are equal bit for bit."""
    import os
    plain_cfg = {**cfg, "hot_rows": 0, "mig_rows": 0}
    placed = placement_trainer(mesh, cfg)
    plain = placement_trainer(mesh, plain_cfg, model=placed.model)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    state = placed.init(batches[0])
    ref = state.clone()
    for ts in ref.tables.values():
        ts.hot = ts.mig = None
    ref_losses, losses = [], []
    for k, b in enumerate(batches):
        ref, m = plain.train_step(ref, b)
        ref_losses.append(m["loss"].clone())
    for k, b in enumerate(batches):
        state = place(placed, state, cfg, k)
        state, m = placed.train_step(state, b)
        losses.append(m["loss"].clone())
        stats = m["stats"]
    got, want = _state_bytes(placed.hot_sync(state)), _state_bytes(ref)
    same_state = set(got) == set(want) and all(
        np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
        for k in got)
    placed.save(state, os.path.join(cfg["tmp"], "placed"))
    plain.save(ref, os.path.join(cfg["tmp"], "plain"))
    same_files = None
    if mesh.rank == 0:
        a = _files(os.path.join(cfg["tmp"], "placed"))
        b = _files(os.path.join(cfg["tmp"], "plain"))
        same_files = set(a) == set(b) and all(a[k] == b[k] for k in a)
    return {"same_losses": bool(torch.equal(torch.stack(losses),
                                            torch.stack(ref_losses))),
            "same_state": same_state, "same_files": same_files,
            "stats": to_host({k: v for k, v in stats.items()
                              if "hot" in k or "mig" in k})}


def ef_load_and_save(mesh, cfg):
    """A MeshTrainer of `cfg` (int8 wire: residuals on) loads the checkpoint
    `cfg["load"]` and saves it, sharded, into `cfg["save"]` -> the rank's
    state in the JAX layout."""
    trainer = placement_trainer(mesh, cfg)
    state = trainer.init(local_batch(cfg["batches"][0], mesh))
    state = trainer.load(state, cfg["load"])
    trainer.save(state, cfg["save"])
    return convert.train_state_to_jax(state)


def inert_at_one_rank(mesh, cfg):
    """At S = 1 a MeshTrainer given every placement argument (int8 wire,
    residuals, hot rows, migration) holds no placement state and trains as
    one without them; `make_plan` refuses a cache or a directory. -> what
    held, and the refusals' messages."""
    placed = placement_trainer(mesh, {**cfg, "error_feedback": True})
    plain = placement_trainer(mesh, {**cfg, "wire": "fp32", "hot_rows": 0,
                                     "mig_rows": 0}, model=placed.model)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    state = placed.init(batches[0])
    ts = state.tables["categorical"]
    out = {"no_state": ts.hot is None and ts.mig is None and ts.ef is None,
           "flags": [placed.hot_enabled, placed.mig_enabled,
                     placed.ef_for("categorical")]}
    ref = state.clone()
    state = placed.refresh_hot_rows(state, hot_ids={"categorical": [1, 2]})
    state = placed.migrate_rows(state, moves={"categorical": ([3], [0])})
    for b in batches:
        state, m = placed.train_step(state, b)
        ref, r = plain.train_step(ref, b)
        out.setdefault("same_losses", True)
        out["same_losses"] &= bool(torch.equal(m["loss"], r["loss"]))
    out["same_state"] = all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            _state_bytes(state).values(), _state_bytes(ref).values()))
    spec = placed.model.specs["categorical"]
    rows = torch.zeros(4, spec.output_dim)
    hot = HotRows(**sharded.identity_tensors(
        sharded.build_hot_identity(spec, 4), "cpu"), weights=rows, slots={})
    mig = MigRows(**sharded.identity_tensors(
        sharded.build_mig_identity(spec, 4, num_shards=1), "cpu"),
                  weights=rows, slots={})
    ids = torch.tensor(batches[0]["sparse"]["categorical"])
    out["refusals"] = []
    for kw in ({"hot": hot}, {"mig": mig}):
        try:
            sharded.make_plan(spec, ids, mesh=mesh, **kw)
        except ValueError as e:
            out["refusals"].append(str(e))
    return out


def placement_protocol_cases(mesh, cases):
    return {name: placement_protocol(mesh, c) for name, c in cases.items()}


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


def placement_trainer(mesh, cfg, model=None, **kw):
    """A MeshTrainer of `cfg`'s placement configuration (wire, hot_rows,
    mig_rows, hot_wire, error_feedback) over `mesh`; `kw`: more of its
    arguments."""
    model = model or deepfm(cfg["vocab"], hashed=cfg["hashed"],
                            capacity=cfg.get("capacity", 0))
    return MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                       mesh=mesh, wire=cfg["wire"],
                       group_exchange=cfg.get("grouped", True),
                       hot_rows=cfg.get("hot_rows", 0),
                       mig_rows=cfg.get("mig_rows", 0),
                       hot_wire=cfg.get("hot_wire"),
                       error_feedback=cfg.get("error_feedback"), **kw)


def place(trainer, state, cfg, k):
    """The placement changes `cfg` asks for before step k: a hot set
    (`cfg["hot_ids"][k]`) and a move list (`cfg["moves"][k]`)."""
    if k in cfg.get("hot_ids", {}) and trainer.hot_enabled:
        state = trainer.refresh_hot_rows(
            state, hot_ids={"categorical": cfg["hot_ids"][k]})
    if k in cfg.get("moves", {}) and trainer.mig_enabled:
        state = trainer.migrate_rows(
            state, moves={"categorical": cfg["moves"][k]})
    return state


def placement_trajectory(mesh, cfg):
    """`cfg["batches"]` MeshTrainer steps with the placement of `cfg`
    (changed before the steps `place` names), from the JAX MeshTrainer's
    state; `hot_sync` at the end -> the losses, the summed stats and the
    rank's state in the JAX layout (cache, directory and residuals
    included)."""
    trainer = placement_trainer(mesh, cfg)
    state = convert.mesh_state_from_jax(cfg["state"], trainer.model,
                                        mesh.size, mesh.rank, device="cpu")
    losses, stats = [], []
    for k, b in enumerate(cfg["batches"]):
        state = place(trainer, state, cfg, k)
        state, m = trainer.train_step(state, local_batch(b, mesh))
        losses.append(float(m["loss"]))
        stats.append(to_host(m["stats"]))
    state = trainer.hot_sync(state)
    return {"losses": losses, "stats": stats,
            "state": convert.train_state_to_jax(state)}


def placement_trajectories(mesh, cfgs):
    return [placement_trajectory(mesh, c) for c in cfgs]


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


# -- the pipelined window (`MeshTrainer(pipeline_steps=True)`) ---------------


def stack_batches(batches):
    """K batches -> one whose every leaf has a leading K dim."""
    if isinstance(batches[0], dict):
        return {k: stack_batches([b[k] for b in batches]) for k in batches[0]}
    return np.stack(batches)


def flat_state(tree, prefix=""):
    """A `train_state_to_jax` tree flattened to {path: numpy} (the cache's
    and the directory's identities, the residuals and the annex too)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_state(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _same_bits(a: dict, b: dict) -> list:
    """The keys where two flat states differ (empty: equal bit for bit)."""
    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return sorted(k for k in a if a[k].dtype != b[k].dtype
                  or a[k].tobytes() != b[k].tobytes())


def pipeline_trainer(mesh, cfg, model):
    """`placement_trainer` with the pipelined window on (`cfg`'s
    `conflict_factor`)."""
    return placement_trainer(mesh, cfg, model, pipeline_steps=True,
                             conflict_factor=cfg.get("conflict_factor", 0.0))


def pipelined_window(mesh, cfg):
    """One `train_many` window of `cfg["batches"]` on this rank, serial and
    pipelined, from one state (the JAX MeshTrainer's carried across, or
    `init`'s) with `cfg`'s placement installed before it. -> which tensors
    of the two windows' states differ (none: bit-equal, residuals, cache
    and annex included), whether the losses are equal, both windows'
    metric keys, the pipelined window's counters, and its losses and state
    after `hot_sync` in the JAX layout."""
    model = deepfm(cfg["vocab"], hashed=cfg["hashed"],
                   capacity=cfg.get("capacity", 0))
    serial = placement_trainer(mesh, cfg, model)
    piped = pipeline_trainer(mesh, cfg, model)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    if "state" in cfg:
        state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                            mesh.rank, device="cpu")
    else:
        state = serial.init(batches[0])
    state = place(serial, state, cfg, 0)
    ref = state.clone()
    stacked = stack_batches(batches)
    ref, rm = serial.train_many(ref, stacked)
    state, pm = piped.train_many(state, stacked)
    differ = _same_bits(flat_state(convert.train_state_to_jax(state)),
                        flat_state(convert.train_state_to_jax(ref)))
    out = {"differ": differ,
           "same_losses": bool(torch.equal(pm["loss"], rm["loss"])),
           "serial_keys": sorted(rm), "pipelined_keys": sorted(pm),
           "losses": pm["loss"].tolist(), "overflow": int(pm["overflow"]),
           "serial_overflow": int(rm["overflow"])}
    if "conflict" in pm:
        out["conflict"] = {n: int(v) for n, v in pm["conflict"].items()}
        out["conflict_overflow"] = int(pm["conflict_overflow"])
    state = piped.hot_sync(state)
    out["state"] = convert.train_state_to_jax(state)
    return out


def pipelined_windows(mesh, cfgs):
    return [pipelined_window(mesh, c) for c in cfgs]


def pipeline_order(mesh, cfg):
    """A pipelined window on this rank with its collectives logged, each
    tagged with the phase that issued it ("prefetch", "dense" for the dense
    gradients' sum, "push", "metrics", "patch", "window" for the window's
    counters), and again from the same state with batch 0's labels
    flipped. -> the log, and whether batch 1's prefetched plan and rows,
    and its rows after the patch, are equal between the two runs."""
    from openembedding_tpu_torch.parallel import collectives as coll
    model = deepfm(cfg["vocab"], hashed=cfg["hashed"])
    trainer = pipeline_trainer(mesh, cfg, model)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    state = trainer.init(batches[0])
    log, phase, seen = [], ["window"], []

    def tagged(name, fn):
        def call(*a, **kw):
            saved, phase[0] = phase[0], name
            try:
                return fn(*a, **kw)
            finally:
                phase[0] = saved
        return call

    for name in ("all_to_all", "dense_sum"):
        fn = getattr(coll, name)
        setattr(coll, name, lambda *a, _n=name, _f=fn, **kw: (
            log.append((phase[0], _n)), _f(*a, **kw))[1])
    for attr, name in (("_pipeline_prefetch", "prefetch"),
                       ("_pipeline_patch", "patch"),
                       ("reduce_dense_grads", "dense"),
                       ("tables_apply", "push"),
                       ("reduce_metrics", "metrics")):
        setattr(trainer, attr, tagged(name, getattr(trainer, attr)))
    prefetch, patch = trainer._pipeline_prefetch, trainer._pipeline_patch

    def record_prefetch(*a, **kw):
        plans, rows, stats = prefetch(*a, **kw)
        seen.append(("prefetch", plans["categorical"].recv_ids.clone(),
                     rows["categorical"].clone()))
        return plans, rows, stats

    def record_patch(*a, **kw):
        rows, counts, overflow = patch(*a, **kw)
        seen.append(("patch", rows["categorical"].clone()))
        return rows, counts, overflow

    trainer._pipeline_prefetch = record_prefetch
    trainer._pipeline_patch = record_patch
    flipped = [dict(b) for b in batches]
    flipped[0]["label"] = 1 - np.asarray(batches[0]["label"])
    runs = []
    for bs in (batches, flipped):
        seen.clear()
        trainer.train_many(state.clone(), stack_batches(bs))
        runs.append(list(seen))
    order = list(log[:len(log) // 2])
    a, b = runs
    return {"log": order,
            "prefetch_equal": all(torch.equal(x, y) for x, y in
                                  zip(a[1][1:], b[1][1:])),
            "patched_equal": torch.equal(a[2][1], b[2][1])}
