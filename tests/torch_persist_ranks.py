"""What the port's mesh persistence tests (`test_torch_persist_mesh*.py`)
run on each spawned rank.

The functions take the rank's `Mesh` first (`parallel.multihost.run_local`
calls `fn(mesh, *args)` in a fresh process) and return numpy and plain
values only. This module imports torch and the port, never JAX.
"""

import json
import os

import numpy as np

from openembedding_tpu_torch import (IncrementalPersister, PersistPolicy,
                                     convert, optimizers,
                                     restore_server_model)
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.multihost import local_batch

from torch_mesh_ranks import _same_bits, deepfm, flat_state, place


def trainer_of(mesh, cfg, model=None):
    """A MeshTrainer of `cfg`: the wire, the placement (hot_rows,
    mig_rows, hot_wire), ZeRO (`dense_shard`) and the optimizer ("adagrad"
    or "adam")."""
    model = model or deepfm(cfg["vocab"], hashed=cfg.get("hashed", False),
                            capacity=cfg.get("capacity", 0))
    opt = (optimizers.Adam(learning_rate=0.01) if cfg.get("opt") == "adam"
           else optimizers.Adagrad(learning_rate=0.05))
    return MeshTrainer(model, opt, mesh=mesh, wire=cfg.get("wire", "fp32"),
                       hot_rows=cfg.get("hot_rows", 0),
                       mig_rows=cfg.get("mig_rows", 0),
                       hot_wire=cfg.get("hot_wire"),
                       dense_shard=cfg.get("dense_shard", False))


def rank_state(state, rank: int) -> dict:
    """The rank's whole state, flat, in the JAX layout (ZeRO chunks,
    residuals, cache and directory included); of the migration annex the
    rows this rank owns (the others are copies no step reads, refreshed by
    a load); a hash table's resident rows in id order (a restore places
    contended ids by another rule than the live probe, so only its id ->
    rows contents are the live table's)."""
    st = convert.train_state_to_jax(state, rank_local=True)
    for t in st["tables"].values():
        if "mig" in t:
            live = t["mig"]["owners"] == rank
            t["mig"]["weights"] = t["mig"]["weights"][live]
            t["mig"]["slots"] = {k: v[live]
                                 for k, v in t["mig"]["slots"].items()}
        if "keys" not in t:
            continue
        keys = t["keys"]
        sel = np.flatnonzero(keys >= 0)
        pick = sel[np.argsort(keys[sel], kind="stable")]
        t["keys"] = keys[pick]
        for k in ("weights", "ef"):
            if k in t:
                t[k] = t[k][pick]
        t["slots"] = {k: v[pick] for k, v in t["slots"].items()}
    return flat_state(st)


def root_files(root: str) -> dict:
    """{file: contents} of every committed directory under `root`: an .npz
    by its arrays' bytes (a zip member carries its write time), a delta's
    meta without its wall-clock `birth_time`; `model_meta` left out (a
    random model sign)."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            full = os.path.join(d, name)
            rel = os.path.relpath(full, root)
            if name.endswith(".npz"):
                with np.load(full) as z:
                    out[rel] = {k: z[k].tobytes() for k in z.files}
            elif name == "meta.json":
                with open(full) as f:
                    meta = json.load(f)
                meta.pop("birth_time")
                out[rel] = meta
            elif name != "model_meta":
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def persist_run(mesh, cfg):
    """`cfg["steps"]` steps of the global batches on this rank's rows with
    an IncrementalPersister (every `cfg["every"]` steps, a full base every
    `cfg["full_every"]`; the placement of `cfg` installed before step 0),
    then a restore of the root into a fresh state of the same trainer (the
    same placement installed first), and one more step on both. -> the
    keys where the restored state and, after the step, the two states
    differ (none: bit-equal), the persists' kinds and rows, the root's
    files (rank 0), and the live state as `train_state_to_jax` gives it
    (externalized: placement written back, dense slots per leaf)."""
    root = cfg["root"]
    trainer = trainer_of(mesh, cfg)
    batches = [local_batch(b, mesh) for b in cfg["batches"]]
    state = place(trainer, trainer.init(batches[0]), cfg, 0)
    with IncrementalPersister(trainer, trainer.model, root, window=2,
                              keep=10,
                              policy=PersistPolicy(every_steps=cfg["every"]),
                              full_every=cfg["full_every"]) as p:
        for b in batches[:cfg["steps"]]:
            state, _ = trainer.train_step(state, b)
            p.maybe_persist(state, batch=b)
    fresh = trainer_of(mesh, cfg, trainer.model)
    template = place(fresh, fresh.init(batches[0]), cfg, 0)
    restored = restore_server_model(template, fresh.model, root,
                                    trainer=fresh)
    out = {"rank": mesh.rank, "step": restored.step,
           "unequal": _same_bits(rank_state(restored, mesh.rank),
                                 rank_state(state, mesh.rank)),
           "history": [(r["kind"], r["step"], r.get("rows"))
                       for r in p.history]}
    if cfg.get("trainerless"):
        bare = trainer_of(mesh, cfg, trainer.model)
        alone = restore_server_model(bare.init(batches[0]), bare.model, root,
                                     mesh=mesh)
        out["unequal_trainerless"] = _same_bits(rank_state(alone, mesh.rank),
                                                rank_state(state, mesh.rank))
    nxt = batches[cfg["steps"]]
    restored, m1 = fresh.train_step(restored, nxt)
    live_next, m2 = trainer.train_step(state.clone(), nxt)
    out["unequal_next"] = _same_bits(rank_state(restored, mesh.rank),
                                     rank_state(live_next, mesh.rank))
    out["same_next_loss"] = float(m1["loss"]) == float(m2["loss"])
    out["live"] = convert.train_state_to_jax(trainer.externalize(state))
    if mesh.rank == 0:
        out["files"] = root_files(root)
    return out


def persist_runs(mesh, cfgs):
    return [persist_run(mesh, c) for c in cfgs]


def restore_roots(mesh, cfgs):
    """Each `cfg["root"]` restored into a fresh MeshTrainer state of `cfg`
    on this rank -> the rank's states as `train_state_to_jax` gives them
    (externalized)."""
    out = []
    for cfg in cfgs:
        trainer = trainer_of(mesh, cfg)
        state = trainer.init(local_batch(cfg["batches"][0], mesh))
        state = restore_server_model(state, trainer.model, cfg["root"],
                                     trainer=trainer)
        out.append(convert.train_state_to_jax(trainer.externalize(state)))
    return out


def union_ids(mesh, sets):
    """`allgather_host_ids` of this rank's set `sets[rank]`, over the mesh
    and over the world group (no mesh given)."""
    from openembedding_tpu_torch.parallel.multihost import allgather_host_ids
    mine = sets[mesh.rank]
    return {"mesh": allgather_host_ids(mine, mesh),
            "world": allgather_host_ids(mine)}


def cases(mesh, runs, restores):
    """`persist_runs(runs)` and `restore_roots(restores)` in one spawn."""
    return {"runs": persist_runs(mesh, runs),
            "restores": restore_roots(mesh, restores)}


def entry_persist(mesh, argv):
    """The entry point's `main(argv)` (with `--mesh --persist ...`) on
    this rank, then its root restored into a fresh state of its trainer ->
    the keys where that state and `main`'s differ, the persists' kinds and
    the restored step."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    out = ex.main(argv)
    trainer, args = out["trainer"], ex.build_parser().parse_args(argv)
    fresh = trainer.init(local_batch(next(iter(ex.CriteoBatcher(
        ex.read_criteo_tsv(args.data, args.batch_size,
                           id_space=args.vocabulary, native="off"),
        args.batch_size))), mesh))
    got = restore_server_model(fresh, trainer.model, args.persist,
                               trainer=trainer)
    return {"rank": mesh.rank, "step": got.step,
            "unequal": _same_bits(rank_state(got, mesh.rank),
                                  rank_state(out["state"], mesh.rank)),
            "kinds": [r["kind"] for r in out["persister"].history]}
