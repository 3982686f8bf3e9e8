"""What the port's remote-storage and ingest tests run on each spawned rank.

The functions take the rank's `Mesh` first (`parallel.multihost.run_local`
calls `fn(mesh, *args)` in a fresh process) and return numpy only. This
module imports torch and the port, never JAX.
"""

import os

import numpy as np
import torch

from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.data import ingest, synthetic_criteo
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel import MeshTrainer
from openembedding_tpu_torch.parallel.multihost import local_batch
from openembedding_tpu_torch.utils import fs as fsmod
from openembedding_tpu_torch.utils import guards, metrics


class DirFS(fsmod.FileSystemBase):
    """Test double: `<scheme>://x` -> files under a local root."""

    def __init__(self, root):
        self.root = root

    def _p(self, uri):
        return os.path.join(self.root, uri.split("://", 1)[1])

    def open(self, uri, mode="rb"):
        os.makedirs(os.path.dirname(self._p(uri)), exist_ok=True)
        return open(self._p(uri), mode)

    def exists(self, uri):
        return os.path.exists(self._p(uri))

    def listdir(self, uri):
        return sorted(os.listdir(self._p(uri)))

    def makedirs(self, uri):
        os.makedirs(self._p(uri), exist_ok=True)

    def isdir(self, uri):
        return os.path.isdir(self._p(uri))


def save_sharded_to_uri(mesh, cfg):
    """`MeshTrainer.save` of one trained step to a URI of a mock scheme
    registered in this rank's process -> the rank's state (JAX layout)."""
    fsmod.register_filesystem(cfg["scheme"], DirFS(cfg["root"]))
    model = make_deepfm(cfg["vocab"], 4, hidden=(8,),
                        compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.1),
                          mesh=mesh, wire="fp32")
    b = local_batch(cfg["batch"], mesh)
    state = trainer.init(b)
    state, _ = trainer.train_step(state, b)
    trainer.save(state, cfg["uri"])
    fresh = trainer.init(b)
    fresh = trainer.load(fresh, cfg["uri"])
    return {"saved": convert.train_state_to_jax(state),
            "loaded": convert.train_state_to_jax(fresh)}


def stream(mesh, cfg):
    """`train_stream` over `ingest.feed(synthetic files, window=K,
    mesh=mesh)` from the JAX MeshTrainer's initial state -> the report,
    each window's losses and the rank's state (JAX layout)."""
    metrics._REGISTRY.clear()
    model = make_deepfm(cfg["vocab"], 4, hidden=(8,),
                        compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire="fp32", seed=1)
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                        mesh.rank, device="cpu")
    ring = ingest.feed(cfg["files"], cfg["batch"], mesh=mesh,
                       source="synthetic", window=cfg["window"],
                       workers=2, depth=3, label="stream")
    losses = []
    many = trainer.jit_train_many()

    def driver(st, w):
        st, m = many(st, w)
        losses.append(m["loss"].clone().numpy())
        return st, m

    state, rep = trainer.train_stream(state, ring, driver=driver)
    return {"report": rep, "losses": np.stack(losses),
            "state": convert.train_state_to_jax(state),
            "windows_ms": metrics.Accumulator.get(
                "trainer.window_ms", "hist").count}


def fingerprints(mesh, cfg):
    """Two fingerprinted train steps, then one with a planted collective
    -> the three fingerprints and a capsule's `fingerprint`."""
    from openembedding_tpu_torch.parallel import collectives
    from openembedding_tpu_torch.utils import capsule
    model = make_deepfm(cfg["vocab"], 4, hidden=(8,),
                        compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire="fp32")
    batches = [local_batch(b, mesh) for b in synthetic_criteo(
        16, id_space=cfg["vocab"], steps=3, seed=4)]
    state = trainer.init(batches[0])
    box = {"state": state}

    def step(b, plant=False):
        box["state"], _ = trainer.train_step(box["state"], b)
        if plant:
            collectives.dense_sum(mesh, torch.ones(3))

    fps = [guards.collective_fingerprint(step, batches[0]),
           guards.collective_fingerprint(step, batches[1]),
           guards.collective_fingerprint(step, batches[2], plant=True)]
    seq = guards.collective_sequence(step, batches[0])
    pinned_ok = guards.assert_collective_fingerprint(step, fps[0],
                                                     batches[1])
    try:
        guards.assert_collective_fingerprint(step, fps[0], batches[2],
                                             plant=True)
        tripped = False
    except guards.CollectiveMismatchError:
        tripped = True
    payload = capsule.CapsuleWriter(cfg["capsule_dir"])._payload("test", {})
    return {"fps": fps, "seq": seq, "pinned_ok": pinned_ok,
            "tripped": tripped, "last": guards.last_fingerprint(),
            "capsule_fp": payload["fingerprint"]}


def bound_vs_throttled(mesh, cfg):
    """The attribution pin on this rank: the same windows fed at line rate,
    then behind a producer throttled to `cfg["factor"]` x the fast run's
    mean window time a window (rank 0's, sent to every rank, so the ranks
    pace alike) -> both reports, both input-wait shares, the throttle."""
    from openembedding_tpu_torch.parallel import collectives
    model = make_deepfm(cfg["vocab"], 4, hidden=(8,),
                        compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, seed=1, wire="fp32")
    src = list(synthetic_criteo(16, id_space=cfg["vocab"], steps=6, seed=0))
    state = trainer.init(local_batch(src[0], mesh))
    out = {}
    for label, depth in (("fast", 3), ("slow", 1)):
        throttle = 0.0
        if label == "slow":
            window_ms = metrics.Accumulator.get("trainer.window_ms",
                                                "hist").value()
            throttle = collectives.broadcast_object(
                mesh, cfg["factor"] * window_ms / 2e3)
        metrics._REGISTRY.clear()
        ring = ingest.FeedRing(iter(src), depth=depth, mesh=mesh, window=2,
                               label=label, throttle_s=throttle)
        state, rep = trainer.train_stream(state, ring)
        out[label] = {"report": rep, "share": ingest.input_wait_share(),
                      "throttle_s": throttle}
    return out
