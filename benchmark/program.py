"""The system under test, as the benchmark drives it: `openembedding_tpu_torch`
built from a configuration file, given the benchmark's starting weights,
and read back for the check. The only module of the harness, with the
metric readers, that imports the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import from_config
from openembedding_tpu_torch.optimizers import Adagrad

from .reference import weights as W

TABLE = "categorical"

_OPTIMIZERS = {"adagrad": Adagrad}


def optimizer(config: dict):
    opt = dict(config["optimizer"])
    return _OPTIMIZERS[opt.pop("name")](**opt)


def build(config: dict, sample_batch: Dict, device, mesh=None) -> tuple:
    """-> (trainer, state): the configuration's model through the zoo's
    recipe (`models.from_config`), a `Trainer` with its optimizer (on a
    `mesh`, a `parallel.MeshTrainer` over it with the configuration's
    `wire`, the table `capacity` slots a card), and the trainer's own
    fresh state. A hashed table's configuration states no vocabulary: its
    ids span 63 bits."""
    cards = 1 if mesh is None else mesh.size
    model = from_config({"family": config["family"],
                         "compute_dtype": config["compute_dtype"],
                         "vocabulary": config.get("vocabulary", -1),
                         "dim": config["dim"], "hidden": config["hidden"],
                         "hashed": config["hashed"],
                         "capacity": config["capacity"] * cards})
    if mesh is None:
        trainer = Trainer(model, optimizer(config), device=device)
    else:
        from openembedding_tpu_torch.parallel import MeshTrainer
        trainer = MeshTrainer(model, optimizer(config), mesh=mesh,
                              wire=config["wire"])
    return trainer, trainer.init(sample_batch)


@torch.no_grad()
def load_weights(state, config: dict, seed: int, num_dense: int,
                 num_fields: int, shard: int = -1) -> None:
    """The benchmark's starting weights into the state, in place: the table
    (`weights.fill_table`; on a mesh this rank's `shard`), every tower
    parameter (`weights.dense_params`) and every accumulator at the
    optimizer's initial value."""
    acc0 = config["optimizer"]["initial_accumulator_value"]
    ts = state.tables[TABLE]
    W.fill_table(ts.weights, config, seed, shard)
    for v in ts.slots.values():
        v.fill_(acc0)
    mine = W.dense_params(config, num_dense, num_fields, seed,
                          ts.weights.device)
    named = dict(state.dense.named_parameters())
    if set(named) != set(mine):
        raise ValueError(f"the tower's parameters {sorted(named)} are not "
                         f"the configuration's {sorted(mine)}")
    for name, v in mine.items():
        named[name].copy_(v)
    for slots in state.dense_slots.values():
        for v in slots.values():
            v.fill_(acc0)


@torch.no_grad()
def snapshot(state, config: dict, losses, touched: np.ndarray,
             stray: torch.Tensor, dense0: Dict[str, torch.Tensor],
             offset: int = 0) -> Dict:
    """What the check reads of the program after its first steps, copied to
    the CPU (the structure `judge.numbers` compares): the steps' losses; the
    table's rows `touched` (an array table) or its occupied slots (a hashed
    table, with their keys and the overflow counter); every tower
    parameter with its accumulator; the rows of the sample `stray`. On a
    mesh, `offset` (shard * capacity) is added to this shard's slots, so
    the ranks' snapshots join (`join`)."""
    ts = state.tables[TABLE]
    out = {"losses": torch.cat([x.reshape(-1) for x in losses]).float().cpu()}
    if config["hashed"]:
        index = torch.nonzero(ts.keys >= 0).reshape(-1)
        out["placement"] = (index.cpu().numpy(),
                            ts.keys[index].cpu().numpy())
        out["overflow"] = int(ts.overflow)
    else:
        index = torch.from_numpy(touched).to(ts.weights.device)
    acc = ts.slots["accum"]
    if offset:
        out["placement"] = (out["placement"][0] + offset,
                            out["placement"][1])
    out["table"] = {"index": index.cpu() + offset,
                    "w": ts.weights[index].float().cpu(),
                    "acc": acc[index].float().cpu()}
    out["stray"] = {"w": ts.weights[stray].float().cpu(),
                    "acc": acc[stray].float().cpu()}
    out["dense"] = {}
    for name, p in state.dense.named_parameters():
        a = state.dense_slots[name]["accum"].reshape(p.shape)
        out["dense"][name] = (p.detach().float().cpu().clone(),
                              a.float().cpu().clone(),
                              dense0[name].float().cpu().clone())
    return out


def join(snaps: list) -> Dict:
    """The ranks' snapshots of a row-sharded hashed table as one: the table,
    placement and stray rows concatenated in shard order; the losses, the
    overflow counter (every rank holds the total) and the tower from rank
    0."""
    out = dict(snaps[0])
    out["placement"] = tuple(np.concatenate([s["placement"][i]
                                             for s in snaps]) for i in (0, 1))
    out["table"] = {k: torch.cat([s["table"][k] for s in snaps])
                    for k in ("index", "w", "acc")}
    out["stray"] = {k: torch.cat([s["stray"][k] for s in snaps])
                    for k in ("w", "acc")}
    return out
