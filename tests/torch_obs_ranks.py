"""What the port's observability mesh tests run on each spawned rank
(`parallel.multihost.run_local` calls `fn(mesh, *args)` in a fresh
process). Imports torch and the port, never JAX."""

import numpy as np

from openembedding_tpu_torch.utils import metrics


def entry_telemetry(mesh, base, flags):
    """The entry point's `main` on this rank without and with the telemetry
    `flags` -> both runs' losses and the registry's keys after the second."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    plain = ex.main(base)["losses"].tolist()
    metrics.reset_all()
    flagged = ex.main(base + flags)["losses"].tolist()
    return {"rank": mesh.rank, "plain": plain, "flagged": flagged,
            "keys": sorted(k for k, a in metrics._REGISTRY.items()
                           if a.count)}


def health_trajectory(mesh, cfg):
    """`cfg["batches"]` MeshTrainer steps (int8 wire, `halt_on_nonfinite`)
    on this rank's rows, from the JAX MeshTrainer's state; each step's
    stats through `record_step_stats` -> per step the health gauges'
    report, and the step and sources of a `NonFiniteError`."""
    import torch

    from openembedding_tpu_torch import convert, optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    model = make_deepfm(cfg["vocab"], 9, hidden=(16, 16),
                        compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire="int8", halt_on_nonfinite=True)
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                        mesh.rank, device="cpu")
    out = {"rank": mesh.rank, "health": [], "halt": None}
    for k, b in enumerate(cfg["batches"]):
        with metrics._LOCK:  # only this step's series
            metrics._REGISTRY.clear()
        state, m = trainer.train_step(state, local_batch(b, mesh))
        try:
            trainer.record_step_stats(m)
        except metrics.NonFiniteError as e:
            out["halt"] = (k, dict(e.sources))
            break
        out["health"].append({key: v for key, v in metrics.report().items()
                              if key.startswith("health.")})
    return out
