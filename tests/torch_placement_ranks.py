"""What the port's self-driving placement tests run on each spawned rank
(`parallel.multihost.run_local` calls `fn(mesh, *args)` in a fresh
process), and the data both packages' sides of those tests share. This
module imports torch, numpy and the port, never JAX.
"""

import numpy as np
import torch

from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.multihost import local_batch
from openembedding_tpu_torch.placement import (PlacementController,
                                               PlacementPolicy,
                                               render_status)
from openembedding_tpu_torch.utils import memwatch, metrics, trace
from openembedding_tpu_torch.utils.sketch import SkewMonitor

TABLE = "categorical"


def drift_batches(S, steps_per_phase, *, batch=64, vocab=1 << 12, pool=24,
                  hot_share=0.6, seed=5):
    """The drifting-Zipf stream of the JAX package's placement acceptance
    test (`tests/test_placement.py::_drift_batches`, its draws in its
    order): a 1/(r+1)-weighted heavy pool homed on shard S-1, a pool homed
    on shard 1 from the midpoint; the tail cycles over the vocabulary, so
    its per-shard load is flat. DeepFM batches: the 13 dense features come
    from a generator of their own (seed + 1), so the ids and labels are the
    JAX test's draws."""
    rng = np.random.default_rng(seed)
    dense_rng = np.random.default_rng(seed + 1)
    pool_a = (np.arange(pool) * S + S - 1).astype(np.int64)
    pool_b = (np.arange(pool) * S + 1).astype(np.int64)
    w = 1.0 / (np.arange(pool) + 1.0)
    w /= w.sum()
    tail = np.arange(vocab, dtype=np.int64)
    t_off, out = 0, []
    for i in range(2 * steps_per_phase):
        p = pool_a if i < steps_per_phase else pool_b
        ids = np.empty((batch, 26), np.int64)
        flat = ids.reshape(-1)
        n = flat.size
        flat[:] = tail[(t_off + np.arange(n)) % vocab]
        t_off += n
        mask = rng.random(n) < hot_share
        flat[mask] = p[rng.choice(pool, size=int(mask.sum()), p=w)]
        out.append({
            "sparse": {TABLE: ids.astype(np.int32)},
            "label": rng.integers(0, 2, (batch,)).astype(np.float32),
            "dense": dense_rng.normal(size=(batch, 13)).astype(np.float32)})
    return out


def fresh_telemetry():
    metrics.reset_all()
    with metrics._LOCK:
        metrics._REGISTRY.clear()
    trace.RECORDER.clear()
    memwatch.WATCH.clear()
    memwatch.WATCH.configure(None)
    memwatch.WATCH.__dict__.pop("_last_device_stats", None)


def model_of(cfg):
    return make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                       compute_dtype=torch.float32)


def ids_of(part):
    """A cache's or directory's ids (and owners) as plain lists."""
    if part is None:
        return None
    ids = part.ids.detach().cpu().numpy()
    keep = ids >= 0
    out = {"ids": ids[keep].astype(np.int64).tolist()}
    if hasattr(part, "owners"):
        out["owners"] = part.owners.detach().cpu().numpy()[keep].tolist()
    return out


def state_ptrs(state) -> dict:
    """data_ptr of every table, cache and directory tensor of the state."""
    return {f"{name}/{i}": t.data_ptr()
            for name, ts in state.tables.items()
            for i, t in enumerate(ts.tensors())}


def events(group):
    return [(e.name, dict(e.attrs)) for e in trace.RECORDER.tail(100000)
            if getattr(e, "group", None) == group]


def controller_run(mesh, cfg):
    return _drive(mesh, cfg)[0]


def _drive(mesh, cfg):
    """-> (`controller_run`'s record, the live controller).

    The drift scenario through the port's controller on this rank: the
    monitor fed the global ids (rank 0's is the one read), `prime` after
    three batches, then every batch through `jit_train_step` with
    `record_step_stats` and `on_step`. -> what each step installed, the
    losses, stats, statuses, the state after `hot_sync`, and the capture
    invariants (graph_epoch and every state tensor's data_ptr after
    prime)."""
    fresh_telemetry()
    S = mesh.size
    model = model_of(cfg)
    tr = MeshTrainer(model, optimizers.Adagrad(learning_rate=cfg["lr"]),
                     mesh=mesh, wire="fp32")
    mon = SkewMonitor(k=cfg["k"], sync=True, decay=cfg["decay"])
    policy = PlacementPolicy(cfg["budget"], mig_rows=cfg["mig_rows"],
                             refresh_cooldown_steps=cfg["cooldown"],
                             imbalance_target=cfg["target"])
    ctrl = PlacementController(tr, policy, monitor=mon,
                               interval_steps=cfg["interval"])
    batches = cfg["batches"]
    for b in batches[:3]:
        mon.observe(TABLE, b["sparse"][TABLE])
    state = convert.mesh_state_from_jax(cfg["state"], model, S, mesh.rank,
                                        device="cpu")
    epoch0 = tr.graph_epoch
    state = ctrl.prime(state)
    out = {"prime": {"hot_rows": dict(tr.hot_rows)
                     if isinstance(tr.hot_rows, dict) else tr.hot_rows,
                     "mig_rows": dict(tr.mig_rows)
                     if isinstance(tr.mig_rows, dict) else tr.mig_rows,
                     "hot": ids_of(state.tables[TABLE].hot),
                     "mig": ids_of(state.tables[TABLE].mig),
                     "status": ctrl.status()},
           "epoch_moves_at_prime": tr.graph_epoch - epoch0}
    epoch = tr.graph_epoch
    ptrs = state_ptrs(state)
    step = tr.jit_train_step()
    losses, stats, installed, statuses = [], [], [], []
    for i, b in enumerate(batches):
        mon.observe(TABLE, b["sparse"][TABLE])
        state, m = step(state, local_batch(b, mesh))
        losses.append(float(m["loss"]))
        st = {k: v.detach().cpu().numpy().copy()
              for k, v in m["stats"].items()}
        stats.append(st)
        tr.record_step_stats(m)
        state = ctrl.on_step(state, step=i + 1)
        installed.append({"hot": ids_of(state.tables[TABLE].hot),
                          "mig": ids_of(state.tables[TABLE].mig)})
        statuses.append(ctrl.status())
    out.update(losses=losses, stats=stats, installed=installed,
               statuses=statuses, epoch_moved=tr.graph_epoch != epoch,
               same_ptrs=state_ptrs(state) == ptrs,
               captures=getattr(step, "captures", None),
               predicted=dict(mon.sketch(TABLE).coverage([cfg["H"]])),
               render=render_status(),
               report={k: v for k, v in metrics.report().items()
                       if k.startswith(("placement.", "hot.", "exchange."))},
               events=events("placement"))
    state = tr.hot_sync(state)
    out["state"] = convert.train_state_to_jax(state)
    return out, ctrl


def _placement_run(mesh, cfg, root, placement):
    """The JAX package's persistence-obliviousness run on this rank: the
    drift stream's steps with an IncrementalPersister (every 2 steps), the
    controller on or off, then a sharded save and an export. -> losses."""
    from openembedding_tpu_torch import IncrementalPersister, PersistPolicy
    from openembedding_tpu_torch.export import export_standalone
    fresh_telemetry()
    tr = MeshTrainer(model_of(cfg), optimizers.Adagrad(learning_rate=0.1),
                     mesh=mesh, wire="fp32")
    batches = cfg["batches"]
    mon = SkewMonitor(k=64, sync=True, decay=0.9)
    ctrl = None
    if placement:
        policy = PlacementPolicy(cfg["budget"], mig_rows=16,
                                 refresh_cooldown_steps=2,
                                 imbalance_target=1.05)
        ctrl = PlacementController(tr, policy, monitor=mon,
                                   interval_steps=2)
        for b in batches[:2]:
            mon.observe(TABLE, b["sparse"][TABLE])
    state = tr.init(local_batch(batches[0], mesh))
    if ctrl is not None:
        state = ctrl.prime(state)
    step = tr.jit_train_step()
    losses = []
    with IncrementalPersister(tr, tr.model, f"{root}/persist", window=1,
                              policy=PersistPolicy(every_steps=2),
                              full_every=100) as p:
        for i, b in enumerate(batches):
            if ctrl is not None:
                mon.observe(TABLE, b["sparse"][TABLE])
            lb = local_batch(b, mesh)
            state, m = step(state, lb)
            losses.append(float(m["loss"]))
            tr.record_step_stats(m)
            if ctrl is not None:
                state = ctrl.on_step(state, step=i + 1)
            p.maybe_persist(state, batch=lb)
        p.wait()
    tr.save(state, f"{root}/ckpt", model_sign="t")
    synced = tr.externalize(state)
    if mesh.rank == 0:
        export_standalone(synced, tr.model, f"{root}/export",
                          model_sign="t-0")
    from openembedding_tpu_torch.parallel import collectives
    collectives.barrier(mesh)
    out = {"losses": losses}
    if ctrl is not None:
        out["status"] = ctrl.status()
    return out


def persistence_runs(mesh, cfg):
    return {"off": _placement_run(mesh, cfg, cfg["off"], False),
            "on": _placement_run(mesh, cfg, cfg["on"], True)}


def watcher_run(mesh, cfg):
    """The JAX package's watcher test on this rank: the watcher (rank 0's)
    parks a decision off the training thread; an off-cadence `on_step`
    leaves it parked, the next cadence step installs it on every rank."""
    import time
    fresh_telemetry()
    S = mesh.size
    heavy = np.repeat(np.arange(8) * S + S - 1, 50)
    mon = SkewMonitor(k=32, sync=True)
    mon.observe(TABLE, heavy)
    tr = MeshTrainer(model_of(cfg), optimizers.Adagrad(learning_rate=0.1),
                     mesh=mesh, wire="fp32")
    policy = PlacementPolicy(cfg["budget"], refresh_cooldown_steps=0)
    ctrl = PlacementController(tr, policy, monitor=mon, interval_steps=2)
    b = cfg["batch"]
    state = ctrl.prime(tr.init(local_batch(b, mesh)))
    primed = ids_of(state.tables[TABLE].hot)
    ctrl.start(interval_s=0.05)
    pending = None
    try:
        if mesh.rank == 0:
            for _ in range(50):
                time.sleep(0.1)
                with ctrl._lock:
                    pending = ctrl._pending
                if pending is not None:
                    break
        state = ctrl.on_step(state, step=1)   # off-cadence: stays parked
        with ctrl._lock:
            still = ctrl._pending is not None
        parked = None if pending is None else {
            "refresh": pending.refresh,
            "hot": pending.tables[TABLE].hot_ids[
                :pending.tables[TABLE].hot_rows].tolist()}
        ctrl.stop()   # no new decision parks before the cadence step
        state = ctrl.on_step(state, step=2)   # cadence: installs rank 0's
        with ctrl._lock:
            left = ctrl._pending is not None
    finally:
        ctrl.stop()
    return {"rank": mesh.rank, "parked": parked, "still_parked": still,
            "left": left, "primed": primed,
            "hot": ids_of(state.tables[TABLE].hot),
            "status": ctrl.status()}


MEM_CONFIGS = {
    # name -> (hashed, MeshTrainer arguments)
    "array": (False, {}),
    "array-hot-mig": (False, {"hot_rows": 16, "mig_rows": 8}),
    "array-int8": (False, {"wire": "int8"}),
    "array-zero": (False, {"dense_shard": True}),
    "array-zero-int8": (False, {"dense_shard": True, "dense_wire": "int8"}),
    "hash-hot-mig-int8": (True, {"wire": "int8", "hot_rows": 16,
                                 "mig_rows": 8}),
}


def mem_model(hashed, vocab=1000, capacity=4096):
    return make_deepfm(vocab, 9, hidden=(16, 16), hashed=hashed,
                       capacity=capacity if hashed else 0,
                       compute_dtype=torch.float32)


def mem_sets(batches, S):
    """The hot set and the moves the memory tests install (content swaps)."""
    ids = np.concatenate([b["sparse"][TABLE].reshape(-1) for b in batches])
    u, c = np.unique(ids, return_counts=True)
    top = u[np.argsort(-c, kind="stable")].astype(np.int64)
    return top[:16], (top[20:28], (top[20:28] + 1) % S)


def memory_models(mesh, cfg):
    """Each configuration of `MEM_CONFIGS` on this rank: init, a hot set
    and moves installed, then `memory_model` and `publish_memory`. -> per
    configuration the analytic and measured views and the ledger's
    gauges."""
    out = {}
    for name, (hashed, kw) in MEM_CONFIGS.items():
        fresh_telemetry()
        batches = cfg["hash_batches" if hashed else "batches"]
        kw = {"wire": "fp32", **kw}
        tr = MeshTrainer(mem_model(hashed), optimizers.Adagrad(
            learning_rate=0.05), mesh=mesh, **kw)
        state = tr.init(local_batch(batches[0], mesh))
        hot, moves = mem_sets(batches, mesh.size)
        state = tr.refresh_hot_rows(state, hot_ids={TABLE: hot})
        state = tr.migrate_rows(state, moves={TABLE: moves})
        state, _ = tr.train_step(state, local_batch(batches[0], mesh))
        model = tr.publish_memory(state)
        gauges = {k: v for k, v in metrics.report().items()
                  if k.startswith("memory.")}
        out[name] = {"analytic": model["analytic"],
                     "measured": model["measured"],
                     "total": model["device_total_bytes"],
                     "gauges": gauges, "export": memwatch.WATCH.export(),
                     "hot_bytes": tr._hot_device_bytes(
                         tr.model.specs[TABLE], tr.hot_rows_for(TABLE))}
        del tr, state
    return out


def preflight_cases(mesh, cfg):
    """The JAX package's two preflight tests on this rank: the hot-cache
    fill (hot_rows set after init) under a 64-byte budget, then with room;
    and a controller's `prime` under an 8-byte budget."""
    out = {}
    batches = cfg["batches"]
    b0 = local_batch(batches[0], mesh)
    # (1) the fill: the one refresh that allocates
    fresh_telemetry()
    tr = MeshTrainer(mem_model(False), optimizers.Adagrad(
        learning_rate=0.05), mesh=mesh, wire="fp32")
    state = tr.init(b0)
    tr.hot_rows = 4
    hot = {TABLE: np.arange(4, dtype=np.int64)}
    memwatch.WATCH.configure(budget_bytes=64)
    state2 = tr.refresh_hot_rows(state, hot_ids=hot)
    out["fill_rejected"] = (state2 is state
                            and state.tables[TABLE].hot is None)
    out["fill_rejects"] = metrics.report().get("memory.preflight_rejects")
    out["fill_events"] = [a for n, a in events("memory")
                          if n == "preflight_reject"]
    memwatch.WATCH.configure(budget_bytes=None)
    state3 = tr.refresh_hot_rows(state, hot_ids=hot)
    out["fill_installed"] = ids_of(state3.tables[TABLE].hot)
    # (2) prime under budget pressure keeps the current sizes
    fresh_telemetry()
    tr = MeshTrainer(mem_model(False), optimizers.Adagrad(
        learning_rate=0.05), mesh=mesh, wire="fp32")
    state = tr.init(b0)
    mon = SkewMonitor(k=32, sync=True)
    for b in batches[:3]:
        mon.observe(TABLE, b["sparse"][TABLE])
    policy = PlacementPolicy(8 * 80, mig_rows=16)
    ctl = PlacementController(tr, policy, monitor=mon)
    memwatch.WATCH.configure(budget_bytes=8)
    epoch = tr.graph_epoch
    state2 = ctl.prime(state)
    out["prime_hot_rows"] = tr.hot_rows
    out["prime_mig_rows"] = tr.mig_rows
    out["prime_hot"] = state2.tables[TABLE].hot is None
    out["prime_epoch_moved"] = tr.graph_epoch != epoch
    out["prime_events"] = [n for n, _ in events("placement")]
    return out


def wire_run(mesh, cfg):
    """The controller with `manage_wire=True` on this rank (ZeRO at the
    int8 dense wire): `prime`, then steps with the measured density gauge
    replaced by `cfg["density"][step]` before each `on_step`, and one
    direct `apply_wire` to bf16 before step `cfg["bf16_at"]`. -> per step
    the status, the trainer's formats and the graph_epoch moves."""
    fresh_telemetry()
    S = mesh.size
    model = model_of(cfg)
    tr = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                     mesh=mesh, wire="fp32", dense_shard=True,
                     dense_wire="int8")
    mon = SkewMonitor(k=64, sync=True, decay=0.9)
    policy = PlacementPolicy(cfg["budget"], mig_rows=16,
                             refresh_cooldown_steps=3)
    policy.dense_wire_cooldown_steps = cfg["dense_cooldown"]
    ctrl = PlacementController(tr, policy, monitor=mon, interval_steps=2,
                               manage_wire=True)
    batches = cfg["batches"]
    for b in batches[:3]:
        mon.observe(TABLE, b["sparse"][TABLE])
    state = convert.mesh_state_from_jax(cfg["state"], model, S, mesh.rank,
                                        device="cpu")
    state = tr.dense_to_sharded(state)
    epoch = tr.graph_epoch
    state = ctrl.prime(state)

    def snap():
        return {"status": ctrl.status(), "wire": tr.wire,
                "dense_wire": tr.dense_wire, "dense_topk": tr.dense_topk,
                "dense_stats": tr.dense_stats,
                "ef": state.tables[TABLE].ef is not None,
                "epoch": tr.graph_epoch - epoch}
    out = {"prime": snap(), "steps": []}
    step = tr.jit_train_step()
    for i, b in enumerate(batches):
        if i + 1 == cfg["bf16_at"]:
            state = ctrl.apply_wire(state, {TABLE: "bf16"})
            out["after_bf16"] = snap()
        mon.observe(TABLE, b["sparse"][TABLE])
        state, m = step(state, local_batch(b, mesh))
        tr.record_step_stats(m)
        out.setdefault("measured_density", metrics.report().get(
            "dense.grad_density"))
        metrics.observe("dense.grad_density", cfg["density"][i], "gauge")
        state = ctrl.on_step(state, step=i + 1)
        out["steps"].append(snap())
    out["events"] = events("placement")
    out["rejit_gauges"] = {k: v for k, v in metrics.report().items()
                           if "rejits" in k}
    return out


def statusz_run(mesh, cfg):
    """`controller_run`'s scenario on this rank, its ledger published, then
    rank 0 serves `/statusz` over the port's REST server (an empty
    registry) and reads it. -> the page (rank 0)."""
    import threading
    import urllib.request

    from openembedding_tpu_torch import serving
    fresh_telemetry()
    out, ctrl = _drive(mesh, cfg)   # the panel lists live controllers
    tr = MeshTrainer(model_of(cfg), optimizers.Adagrad(learning_rate=0.05),
                     mesh=mesh, wire="fp32", hot_rows=8, mig_rows=8)
    tr.publish_memory(tr.init(local_batch(cfg["batches"][0], mesh)))
    if mesh.rank != 0:
        return None
    httpd = serving.make_server(cfg["registry"], port=0, device="cpu")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/statusz"
        with urllib.request.urlopen(url, timeout=60) as r:
            page = r.read().decode()
    finally:
        httpd.shutdown()
    return {"page": page, "render": ctrl.render_text(),
            "export": memwatch.WATCH.export()}


def sketch_refresh(mesh, cfg):
    """`refresh_hot_rows` from the sketches on this rank: `monitor=`, then
    the trainer's `enable_skew_monitor()` feed, then the global
    `sketch.MONITOR`; each rank's sketches fed other ids (its own rows of
    the batch, `cfg["skews"][k]` of them shifted by the rank), so only rank
    0's may be installed. -> the installed ids of each."""
    from openembedding_tpu_torch.utils import sketch
    fresh_telemetry()
    sketch.MONITOR.reset()
    tr = MeshTrainer(model_of(cfg), optimizers.Adagrad(learning_rate=0.05),
                     mesh=mesh, wire="fp32", hot_rows=cfg["H"],
                     mig_rows=4)
    state = tr.init(local_batch(cfg["batches"][0], mesh))
    state = tr.migrate_rows(state, moves={TABLE: cfg["moves"]})

    def feed(mon, k):
        mon.observe(TABLE, cfg["skews"][k] + mesh.rank * 7)
        return mon
    out = {}
    state = tr.refresh_hot_rows(state, monitor=feed(
        SkewMonitor(k=32, sync=True), 0))
    out["monitor"] = ids_of(state.tables[TABLE].hot)
    tr.enable_skew_monitor(feed(SkewMonitor(k=32, sync=True), 1))
    state = tr.refresh_hot_rows(state)
    out["trainer_feed"] = ids_of(state.tables[TABLE].hot)
    tr._skew = None
    sketch.MONITOR = feed(SkewMonitor(k=32, sync=True), 2)
    state = tr.refresh_hot_rows(state, hot_ids={"other": [1]})
    out["global"] = ids_of(state.tables[TABLE].hot)
    out["set_size"] = metrics.report().get(
        f'hot.set_size{{table="{TABLE}"}}')
    return out
