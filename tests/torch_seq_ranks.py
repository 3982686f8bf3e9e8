"""What the port's context-parallel tests run on each spawned rank.

The functions take the rank's world `Mesh` first (`parallel.multihost.
run_local` calls `fn(mesh, *args)` in a fresh process), build the 2-D
(data, seq) mesh from it where they need one, and return numpy only. This
module imports torch and the port, never JAX: a spawned rank imports it to
find its function, and must start quickly.
"""

import numpy as np
import torch

from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.models import make_bert4rec, make_sasrec
from openembedding_tpu_torch.parallel import (SeqMeshTrainer, make_seq_mesh,
                                              sequence)
from openembedding_tpu_torch.parallel.multihost import local_batch

from torch_mesh_ranks import to_host

OPTIMIZERS = {
    "adagrad": lambda lr: optimizers.Adagrad(learning_rate=lr),
    "adam": lambda lr: optimizers.Adam(learning_rate=lr),
}


def _seq_block(x, mesh2):
    """This rank's (B, S/P, ...) block of a (B, S, ...) array (data dim
    whole: the attention tests run on a (1, P) mesh)."""
    P, s = mesh2.shape[1], mesh2.rank % mesh2.shape[1]
    n = x.shape[1] // P
    return x[:, s * n:(s + 1) * n]


_LINES = {}


def _line(mesh):
    """The (1, P) mesh over the world, made once a process (a collective:
    every rank makes it at the same call)."""
    if mesh.size not in _LINES:
        _LINES[mesh.size] = make_seq_mesh(1, mesh.size, device=mesh.device)
    return _LINES[mesh.size]


def attention(mesh, cfg):
    """Ring or Ulysses attention on this rank's seq block of the global
    q, k, v (and kv_valid) over a (1, P) mesh -> the block's output and,
    with `cfg["grad"]`, the gradients of sum(out^2) over the whole sequence
    with respect to this rank's q, k and v blocks."""
    mesh2 = _line(mesh)
    fn = {"ring": sequence.ring_attention,
          "ulysses": sequence.ulysses_attention}[cfg["kind"]]
    q, k, v = (torch.tensor(_seq_block(np.asarray(cfg[n]), mesh2),
                            requires_grad=True) for n in "qkv")
    if cfg["dtype"] == "bfloat16":
        q, k, v = (t.detach().to(torch.bfloat16).requires_grad_()
                   for t in (q, k, v))
    kv = cfg.get("kv_valid")
    kv = None if kv is None else torch.tensor(_seq_block(np.asarray(kv),
                                                         mesh2))
    out = fn(q, k, v, axis=mesh2.seq, causal=cfg["causal"], kv_valid=kv)
    res = {"out": out.detach().float().numpy()}
    if cfg.get("grad"):
        torch.sum(torch.square(out.float())).backward()
        res.update({f"g{n}": t.grad.float().numpy()
                    for n, t in zip("qkv", (q, k, v))})
    return res


def ulysses_refuses(mesh, heads):
    """Ulysses with H % P != 0 and with a custom attn_fn beside kv_valid:
    both raise ValueError -> the two messages."""
    mesh2 = _line(mesh)
    x = torch.zeros((1, 2, heads, 4))
    msgs = []
    try:
        sequence.ulysses_attention(x, x, x, axis=mesh2.seq)
    except ValueError as e:
        msgs.append(str(e))
    y = torch.zeros((1, 2, mesh.size, 4))
    try:
        sequence.ulysses_attention(
            y, y, y, axis=mesh2.seq,
            kv_valid=torch.ones((1, 2), dtype=torch.bool),
            attn_fn=sequence.reference_attention)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def seq_model(cfg, attention=None):
    make = make_bert4rec if cfg["family"] == "bert4rec" else make_sasrec
    return make(cfg["vocab"], cfg["dim"], num_heads=cfg["heads"],
                num_blocks=cfg.get("blocks", 2),
                attention=attention or cfg["attention"],
                hashed=cfg.get("hashed", False),
                capacity=cfg.get("capacity", 0),
                compute_dtype=getattr(torch, cfg.get("dtype", "float32")))


def seq_trainer(mesh, cfg):
    mesh2 = make_seq_mesh(*cfg["shape"], device=mesh.device)
    model = seq_model(cfg)
    opt = OPTIMIZERS[cfg["optimizer"]](cfg["lr"])
    return mesh2, model, SeqMeshTrainer(model, opt, mesh=mesh2,
                                        wire=cfg.get("wire", "fp32"))


def trajectory(mesh, cfg):
    """`SeqMeshTrainer` on a (D, P) mesh from the JAX SeqMeshTrainer's
    state (`mesh_state_from_jax`): the eval logits and loss on the first
    batch, then `cfg["batches"]` train steps on this rank's blocks -> the
    losses, the step logits, the eval output and the rank's state in the
    JAX layout. With `cfg["save"]`, the state is saved (sharded) after the
    steps; with `cfg["load"]`, a fresh state loads that checkpoint and
    evaluates the first batch."""
    mesh2, model, trainer = seq_trainer(mesh, cfg)
    batches = cfg["batches"]
    if cfg.get("load"):
        state = trainer.init(local_batch(batches[0], mesh2))
        state = trainer.load(state, cfg["load"])
        ev = trainer.eval_step(state, local_batch(batches[0], mesh2))
        return {"eval": to_host(ev),
                "state": convert.train_state_to_jax(state)}
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh2.size,
                                        mesh2.rank, device=mesh2.device)
    ev = trainer.eval_step(state, local_batch(batches[0], mesh2))
    losses, logits = [], []
    for b in batches:
        state, m = trainer.train_step(state, local_batch(b, mesh2))
        losses.append(float(m["loss"]))
        logits.append(m["logits"].float().numpy())
    if cfg.get("save"):
        trainer.save(state, cfg["save"])
    return {"eval": to_host(ev), "losses": losses, "logits": logits,
            "state": convert.train_state_to_jax(state),
            "staged_bytes": trainer.mesh.total_staged_bytes()}


def trajectories(mesh, cfgs):
    return [trajectory(mesh, c) for c in cfgs]


def two_tower_trajectory(mesh, cfg):
    """`MeshTrainer` over the 1-D mesh on the two-tower, from the JAX
    MeshTrainer's state -> the losses and the rank's state (each rank's
    in-batch softmax sees its own rows, as each JAX device does)."""
    from openembedding_tpu_torch.models import make_two_tower
    from openembedding_tpu_torch.parallel import MeshTrainer
    model = make_two_tower(cfg["users"], cfg["items"], cfg["dim"],
                           tower=cfg["tower"], combiner=cfg["combiner"],
                           compute_dtype=torch.float32)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.1),
                          mesh=mesh, wire="fp32")
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh.size,
                                        mesh.rank, device="cpu")
    losses = []
    for b in cfg["batches"]:
        state, m = trainer.train_step(state, local_batch(b, mesh))
        losses.append(float(m["loss"]))
    return {"losses": losses, "state": convert.train_state_to_jax(state)}


def attention_cases(mesh, cfgs, refuse_heads=None):
    """`attention` for every case (one (1, P) mesh), then, with
    `refuse_heads`, `ulysses_refuses` -> (results, messages)."""
    out = [attention(mesh, c) for c in cfgs]
    msgs = ulysses_refuses(mesh, refuse_heads) if refuse_heads else []
    return out, msgs


def checkpoint_io(mesh, cfg):
    """On a (D, P) mesh: the JAX checkpoint `cfg["load"]` loaded into a
    fresh state and evaluated on the first batch; then, from the JAX init,
    `cfg["batches"]` steps saved (sharded) into `cfg["save"]` -> both
    states in the JAX layout and the eval."""
    mesh2, model, trainer = seq_trainer(mesh, cfg)
    b0 = local_batch(cfg["batches"][0], mesh2)
    loaded = trainer.load(trainer.init(b0), cfg["load"])
    ev = trainer.eval_step(loaded, b0)
    state = convert.mesh_state_from_jax(cfg["state"], model, mesh2.size,
                                        mesh2.rank, device=mesh2.device)
    for b in cfg["batches"]:
        state, _ = trainer.train_step(state, local_batch(b, mesh2))
    trainer.save(state, cfg["save"])
    return {"loaded": convert.train_state_to_jax(loaded),
            "eval": to_host(ev), "trained": convert.train_state_to_jax(state)}
