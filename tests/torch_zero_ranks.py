"""What the port's ZeRO tests (`test_torch_zero*.py`) run on each spawned
rank.

The functions take the rank's `Mesh` first (`parallel.multihost.run_local`
calls `fn(mesh, *args)` in a fresh process) and return numpy only. This
module imports torch and the port, never JAX: a spawned rank imports it to
find its function, and must start quickly.
"""

import os

import numpy as np
import torch

from openembedding_tpu_torch import convert, data, optimizers
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import MeshTrainer, zero
from openembedding_tpu_torch.parallel.multihost import local_batch

from torch_mesh_ranks import (_files, _same_bits, deepfm, flat_state,
                              stack_batches)

# the nine optimizer rules, at rates that keep a 16-16 tower finite
NINE = {
    "default": lambda: optimizers.Default(learning_rate=0.05),
    "momentum": lambda: optimizers.SGD(learning_rate=0.05, momentum=0.9),
    "adagrad": lambda: optimizers.Adagrad(learning_rate=0.1),
    "adadelta": lambda: optimizers.Adadelta(learning_rate=1.0),
    "adam": lambda: optimizers.Adam(learning_rate=0.01),
    "adamax": lambda: optimizers.Adamax(learning_rate=0.01),
    "ftrl": lambda: optimizers.Ftrl(learning_rate=0.1),
    "rmsprop": lambda: optimizers.RMSprop(learning_rate=0.01),
    "test": lambda: optimizers.TestOptimizer(learning_rate=0.01, flip=0.001),
}


def batches(steps, seed=7, vocab=1000, batch=64):
    return list(data.synthetic_criteo(batch, id_space=vocab, steps=steps,
                                      seed=seed))


def external(trainer, state):
    """The externalized state in the JAX layout, flattened ({path: array})."""
    return flat_state(convert.train_state_to_jax(trainer.externalize(state)))


def _bytes(x) -> bytes:
    return np.asarray(x).tobytes()


def zero_vs_replicated(mesh, cfg):
    """For each optimizer of `cfg["optimizers"]`: the replicated MeshTrainer
    and `MeshTrainer(dense_shard=True)` from one init, through
    `cfg["steps"]` `train_step`s and a `train_many` window of
    `cfg["window"]` -> {name: the keys of the externalized states that
    differ (none: bit-equal), whether the losses are equal, the flat
    slots' shapes on this rank, and the plan's (total, chunk, padded)}."""
    gb = batches(cfg["steps"] + cfg["window"])
    bs = [local_batch(b, mesh) for b in gb]
    out = {}
    for name in cfg["optimizers"]:
        runs = []
        for shard in (False, True):
            model = deepfm(1000)
            tr = MeshTrainer(model, NINE[name](), mesh=mesh, wire="fp32",
                             dense_shard=shard)
            st = tr.init(bs[0])
            losses = []
            for b in bs[:cfg["steps"]]:
                st, m = tr.train_step(st, b)
                losses.append(_bytes(m["loss"]))
            st, m = tr.train_many(st, stack_batches(bs[cfg["steps"]:]))
            losses.append(_bytes(m["loss"]))
            runs.append((tr, st, losses))
        (_, s0, l0), (tz, sz, lz) = runs
        plan = tz._zero_plan
        out[name] = {
            "differ": _same_bits(external(runs[0][0], s0),
                                 external(tz, sz)),
            "same_losses": l0 == lz,
            "flat": zero.is_sharded_slots(sz.dense_slots),
            "shapes": {k: tuple(v.shape) for k, v in
                       sz.dense_slots[zero.ZERO_KEY].items()},
            "plan": (plan.total, plan.chunk, plan.padded)}
    return out


def trajectory(mesh, cfg):
    """`cfg["batches"]` steps of `MeshTrainer(dense_shard=True,
    dense_wire=cfg["dense_wire"], dense_stats=...)` on this rank's rows
    (the tables with `cfg["table_optimizer"]` where given),
    from the JAX MeshTrainer's ZeRO state (`mesh_state_from_jax`) -> the
    losses, the stats, the rank's state in the flat form
    (`rank_local=True`) and the externalized state."""
    model = make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                        compute_dtype=torch.float32,
                        optimizer=cfg.get("table_optimizer"))
    opt = NINE[cfg["optimizer"]]() if isinstance(cfg["optimizer"], str) \
        else cfg["optimizer"]
    tr = MeshTrainer(model, opt, mesh=mesh, wire="fp32", dense_shard=True,
                     dense_wire=cfg.get("dense_wire"),
                     dense_topk=cfg.get("dense_topk"),
                     dense_stats=cfg.get("dense_stats", False))
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                        mesh.rank, device="cpu")
    assert zero.is_sharded_slots(state.dense_slots)
    losses, stats = [], []
    for b in cfg["batches"]:
        state, m = tr.train_step(state, local_batch(b, mesh))
        losses.append(float(m["loss"]))
        stats.append({k: np.asarray(v) for k, v in m["stats"].items()})
    return {"losses": losses, "stats": stats,
            "state": convert.train_state_to_jax(state, rank_local=True),
            "external": convert.train_state_to_jax(tr.externalize(state))}


def trajectories(mesh, cfgs):
    return [trajectory(mesh, c) for c in cfgs]


def checkpoints(mesh, cfg):
    """Adam, 2 steps with ZeRO off and on from one init, each saved into
    `cfg["root"]/off` and `/on`; then each checkpoint loaded into a trainer
    of the other kind (and of its own), 2 more steps -> whether the saves
    are byte-identical (`torch_mesh_ranks._files`: an .npz by its arrays'
    bytes, model_meta aside), the saved ZeRO state
    externalized, the continued runs' losses and externalized states, and
    the JAX checkpoint `cfg["jax"]` loaded into a ZeRO trainer (its
    externalized state)."""
    bs = [local_batch(b, mesh) for b in batches(4, seed=11)]

    def trainer(shard, wire=None):
        return MeshTrainer(deepfm(1000), optimizers.Adam(learning_rate=0.01),
                           mesh=mesh, wire="fp32", dense_shard=shard,
                           dense_wire=wire)

    saved = {}
    for tag, shard in (("off", False), ("on", True)):
        tr = trainer(shard)
        st = tr.init(bs[0])
        for b in bs[:2]:
            st, _ = tr.train_step(st, b)
        path = os.path.join(cfg["root"], tag)
        tr.save(st, path)
        saved[tag] = path
        saved[tag + "_state"] = external(tr, st)
    out = {"same_files": _files(saved["off"]) == _files(saved["on"]),
           "files": sorted(_files(saved["on"])), "runs": {},
           "saved": saved["on_state"],
           "saved_differ": _same_bits(saved["off_state"],
                                      saved["on_state"])}
    for src in ("off", "on"):
        for dst, shard in (("off", False), ("on", True)):
            tr = trainer(shard)
            st = tr.init(bs[0])
            st = tr.load(st, saved[src])
            assert zero.is_sharded_slots(st.dense_slots) == shard
            losses = []
            for b in bs[2:]:
                st, m = tr.train_step(st, b)
                losses.append(_bytes(m["loss"]))
            out["runs"][(src, dst)] = (losses, external(tr, st))
    if cfg.get("jax"):
        tr = trainer(True)
        st = tr.load(tr.init(bs[0]), cfg["jax"])
        out["from_jax"] = convert.train_state_to_jax(tr.externalize(st))
    return out


def wire_lifecycle(mesh, cfg):
    """The dense wires' checkpoints and `set_dense_wire`: an int8 and a
    sparse_topk run of 2 steps saved, each loaded into a trainer without
    ZeRO and into one of its own format (its residual re-seeded to zeros)
    and stepped once; then an fp32 ZeRO state moved to int8 and back ->
    the externalized states and what each check found."""
    bs = [local_batch(b, mesh) for b in batches(4, seed=13)]

    def trainer(**kw):
        return MeshTrainer(deepfm(1000), optimizers.Adam(learning_rate=0.01),
                           mesh=mesh, wire="fp32", **kw)

    out = {}
    for fmt in ("int8", "sparse_topk"):
        tr = trainer(dense_shard=True, dense_wire=fmt)
        st = tr.init(bs[0])
        for b in bs[:2]:
            st, _ = tr.train_step(st, b)
        path = os.path.join(cfg["root"], fmt)
        tr.save(st, path)
        saved = external(tr, st)
        rec = {}
        for tag, kw in (("replicated", {}),
                        ("same", dict(dense_shard=True, dense_wire=fmt))):
            tr2 = trainer(**kw)
            st2 = tr2.load(tr2.init(bs[0]), path)
            rec[tag + "_differ"] = _same_bits(saved, external(tr2, st2))
            if tag == "same":
                flat = st2.dense_slots[zero.ZERO_KEY]
                rec["ef_zero"] = not flat[zero.DENSE_EF_KEY].any().item()
                rec["master_chunk"] = tuple(
                    flat[zero.DENSE_MASTER_KEY].shape)
            st2, m = tr2.train_step(st2, bs[2])
            rec[tag + "_loss"] = float(m["loss"])
        out[fmt] = rec
    tr = trainer(dense_shard=True)
    st = tr.init(bs[0])
    st, _ = tr.train_step(st, bs[0])
    before, epoch = external(tr, st), tr.graph_epoch
    same = tr.set_dense_wire(st, "int8")
    flat = st.dense_slots[zero.ZERO_KEY]
    out["switch"] = {
        "in_place": same is st,
        "epoch": tr.graph_epoch - epoch,
        "ef_zero": not flat[zero.DENSE_EF_KEY].any().item(),
        "to_int8_differ": _same_bits(before, external(tr, st)),
        "aligned": tr._zero_plan.chunk % 32 == 0,
        "noop": tr.set_dense_wire(st, "int8") is st
        and tr.graph_epoch - epoch == 1}
    tr.set_dense_wire(st, None)
    out["switch"]["back_differ"] = _same_bits(before, external(tr, st))
    out["switch"]["flat_keys"] = sorted(st.dense_slots[zero.ZERO_KEY])
    st, m = tr.train_step(st, bs[1])
    out["switch"]["loss"] = float(m["loss"])
    return out


def pipelined(mesh, cfg):
    """A `train_many` window of `cfg["k"]` batches with fp32 ZeRO, serial and
    pipelined from one init -> the keys of the two states that differ
    (flat slots included) and whether the losses are equal."""
    bs = [local_batch(b, mesh) for b in batches(cfg["k"])]
    model = deepfm(1000)
    kw = dict(mesh=mesh, wire=cfg.get("wire", "fp32"), dense_shard=True)
    serial = MeshTrainer(model, optimizers.Adam(learning_rate=0.01), **kw)
    piped = MeshTrainer(model, optimizers.Adam(learning_rate=0.01),
                        pipeline_steps=True, **kw)
    state = serial.init(bs[0])
    ref = state.clone()
    stacked = stack_batches(bs)
    ref, rm = serial.train_many(ref, stacked)
    state, pm = piped.train_many(state, stacked)

    def flat(s):
        return flat_state(convert.train_state_to_jax(s, rank_local=True))

    return {"differ": _same_bits(flat(state), flat(ref)),
            "same_losses": bool(torch.equal(pm["loss"], rm["loss"])),
            "conflict": int(pm["conflict"]["categorical"])}


def s4_runs(mesh, replicated, int8, window):
    """The four-rank file's runs in one launch: `zero_vs_replicated`,
    the int8 `trajectory` and the `pipelined` window."""
    return {"replicated": zero_vs_replicated(mesh, replicated),
            "int8": trajectory(mesh, int8),
            "pipelined": pipelined(mesh, window)}


def _tensors(state):
    """Every tensor a state holds (tables, dense params, slots and
    embeddings)."""
    from openembedding_tpu_torch.model import _tensors_of, dense_leaves
    out = [t for ts in state.tables.values() for t in ts.tensors()]
    out += [p for _, p in dense_leaves(state.dense, state.embeddings)]
    return out + _tensors_of(state.dense_slots)


def shared_tensors(a, b) -> int:
    """How many storages two states share."""
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(a)}
    return sum(t.untyped_storage().data_ptr() in ptrs for t in _tensors(b))


def fresh_inits(mesh, cfg):
    """For ZeRO off and on: `init`, three steps on that state, `init` again
    -> whether the second init equals the first bit for bit (its state
    before the steps), and how many storages the two states share."""
    bs = [local_batch(b, mesh) for b in batches(3)]
    out = {}
    for shard in (False, True):
        tr = MeshTrainer(deepfm(1000), optimizers.Adam(learning_rate=0.01),
                         mesh=mesh, wire="fp32", dense_shard=shard)
        first = tr.init(bs[0])
        before = external(tr, first)
        for b in bs:
            first, _ = tr.train_step(first, b)
        second = tr.init(bs[0])
        out[shard] = {"differ": _same_bits(before, external(tr, second)),
                      "trained_differ": bool(_same_bits(
                          before, external(tr, first))),
                      "shared": shared_tensors(first, second)}
    return out
