"""Plain DeepFM training with Adagrad, the reference the benchmark's training
cells are judged against.

What it follows is the configuration as stated, written from the model's
description and not from the program's code:

- One folded table of `dim + 1` columns over all sparse fields: column 0 is
  the first-order weight, columns 1..dim the latent vector.
- logit = sum of the first-order weights + a linear term over the dense
  features + the FM pairwise term 0.5 * sum_d[(sum_f v)^2 - sum_f v^2] +
  an MLP (ReLU hidden layers, linear last layer) over the dense features
  concatenated with the flattened latent vectors. The FM term, the linear
  term and the MLP compute in the configuration's `compute_dtype`; the
  first-order sum and the logit in float32.
- Loss: mean sigmoid cross-entropy.
- Adagrad: accum += g^2; w -= lr * g / (sqrt(accum) + eps), on every tower
  parameter and, per step, once on each table row the batch touches, with
  the gradients of an id's occurrences summed.
- A hashed table places ids by linear probing from mix64(id) % capacity, at
  most `num_probes` rounds; where ids contend for one empty slot in a round,
  the largest id of the step takes it. An id that finds no slot pulls a zero
  row and trains nothing.

`state_dtype` stores the table, its accumulator, the tower parameters and
their accumulators in that type between steps (the control: bfloat16 where
the configuration states float32). `half_batch` trains each step on the
first half of its rows (a planted fault).

Plain torch and numpy; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import weights as W

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def mix64(ids: np.ndarray) -> np.ndarray:
    """The 64-bit avalanche mixer of the hashed table's placement."""
    u = ids.astype(np.uint64)
    u = (u ^ (u >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    return u ^ (u >> np.uint64(33))


def place_hashed(steps_ids: List[np.ndarray], capacity: int,
                 num_probes: int):
    """Each step's ids placed into an empty table in order -> (slots: one
    (n,) int64 array per step, `capacity` where an id found no slot;
    occupied slots (m,) sorted; their keys (m,))."""
    keys = np.full(capacity, -1, dtype=np.int64)
    out = []
    for ids in steps_ids:
        uniq, inverse = np.unique(ids, return_inverse=True)
        base = (mix64(uniq) % np.uint64(capacity)).astype(np.int64)
        slot = np.full(uniq.shape, capacity, dtype=np.int64)
        todo = np.arange(uniq.shape[0])
        for d in range(num_probes):
            if todo.size == 0:
                break
            pos = (base[todo] + d) % capacity
            cur = keys[pos]
            found = cur == uniq[todo]
            slot[todo[found]] = pos[found]
            want = cur == -1
            wpos, wid = pos[want], todo[want]
            # per contended slot the largest id wins: sort by (slot, id)
            order = np.lexsort((uniq[wid], wpos))
            wpos, wid = wpos[order], wid[order]
            last = np.ones(wpos.shape, dtype=bool)
            last[:-1] = wpos[1:] != wpos[:-1]
            keys[wpos[last]] = uniq[wid[last]]
            slot[wid[last]] = wpos[last]
            placed = found.copy()
            placed[np.flatnonzero(want)[order[last]]] = True
            todo = todo[~placed]
        out.append(slot[inverse.reshape(-1)])
    occupied = np.flatnonzero(keys >= 0)
    return out, occupied, keys[occupied]


def _adagrad(p: torch.Tensor, acc: torch.Tensor, g: torch.Tensor,
             lr: float, eps: float):
    """One Adagrad update in float32 -> (new p, new acc)."""
    acc = acc.float() + g * g
    return p.float() - lr * g / (torch.sqrt(acc) + eps), acc


def forward(params: Dict[str, torch.Tensor], rows: torch.Tensor,
            dense: torch.Tensor, hidden_layers: int, cd: torch.dtype
            ) -> torch.Tensor:
    """(B,) float32 logits from the pulled rows (B, F, dim + 1) float32 and
    the dense features (B, D)."""
    first = rows[..., 0].float().sum(-1)
    v = rows[..., 1:].to(cd)
    fm = 0.5 * (v.sum(1).square() - v.square().sum(1)).sum(-1).float()
    dn = dense.to(cd)
    lin = (dn @ params["linear.weight"].to(cd).t()
           + params["linear.bias"].to(cd))[:, 0].float()
    x = torch.cat([dn, v.reshape(v.shape[0], -1)], dim=-1)
    for i in range(hidden_layers + 1):
        x = (x @ params[f"mlp.layers.{i}.weight"].to(cd).t()
             + params[f"mlp.layers.{i}.bias"].to(cd))
        if i < hidden_layers:
            x = torch.relu(x)
    return first + lin + fm + x[:, 0].float()


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy, in float32."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@torch.no_grad()
def train(config: dict, batches: List[Dict], seed: int, device, *,
          state_dtype: str = "float32", half_batch: bool = False,
          stray_n: int = 0) -> Dict:
    """Follow the program's first `len(batches)` steps from the benchmark's
    starting weights -> {"losses": (T,), "table": {"index": rows (or slots)
    touched, sorted; "w", "acc": their values; "w0": their starting rows},
    "dense": {name: (param, accum, start)}, "overflow": ids left without a
    slot, "placement": (slots, keys) of a hashed table, "stray": {"index",
    "w0"} of the sampled rows}. Everything returned is float32 on the CPU."""
    sd = _DTYPES[state_dtype]
    cd = _DTYPES[config["compute_dtype"]]
    opt = config["optimizer"]
    lr, eps, acc0 = (opt["learning_rate"], opt["epsilon"],
                     opt["initial_accumulator_value"])
    rows_total = W.table_rows(config)
    ids_np = [np.asarray(b["sparse"]["categorical"]).reshape(-1)
              for b in batches]
    out: Dict = {}
    if config["hashed"]:
        slots, occ, keys = place_hashed(ids_np, rows_total,
                                        config["num_probes"])
        out["placement"] = (occ, keys)
        out["overflow"] = int(sum((s == rows_total).sum() for s in slots))
        rows_np = slots
    else:
        rows_np = ids_np
    touched = np.unique(np.concatenate(rows_np))
    touched = touched[touched < rows_total]
    w0_full = W.fill_table(torch.empty((rows_total, config["dim"] + 1),
                                       device=device), config, seed)
    t_dev = torch.from_numpy(touched).to(device)
    w0 = w0_full[t_dev].float()
    if stray_n:
        sample = W.stray_sample(rows_total, stray_n, seed, device)
        out["stray"] = {"index": sample.cpu(),
                        "w0": w0_full[sample].float().cpu()}
    del w0_full
    # the touched rows, plus one zero row (index n) that a missed id pulls
    n = touched.shape[0]
    table = torch.cat([w0, torch.zeros((1, w0.shape[1]), device=device)]
                      ).to(sd)
    acc = torch.full_like(table, acc0)
    f = ids_np[0].shape[0] // np.asarray(batches[0]["label"]).shape[0]
    nd = np.asarray(batches[0]["dense"]).shape[-1]
    p0 = W.dense_params(config, nd, f, seed, device)
    params = {k: v.to(sd) for k, v in p0.items()}
    pacc = {k: torch.full_like(v, acc0) for k, v in params.items()}
    hl = len(config["hidden"])
    losses = []
    for b, rws in zip(batches, rows_np):
        dense = torch.as_tensor(np.asarray(b["dense"]), device=device)
        label = torch.as_tensor(np.asarray(b["label"]), device=device)
        cidx_np = np.searchsorted(touched, rws)
        cidx_np[rws >= rows_total] = n
        cidx = torch.from_numpy(cidx_np).to(device)
        bsz = label.shape[0]
        if half_batch:
            bsz //= 2
            dense, label, cidx = dense[:bsz], label[:bsz], cidx[:bsz * f]
        with torch.enable_grad():
            rows = table[cidx].float().reshape(bsz, f, -1).requires_grad_()
            leaves = {k: v.detach().float().clone().requires_grad_()
                      for k, v in params.items()}
            loss = logloss(forward(leaves, rows, dense, hl, cd), label)
            loss.backward()
        losses.append(loss.detach().float())
        width = table.shape[1]
        g = torch.zeros((n + 1, width), device=device).index_add_(
            0, cidx, rows.grad.reshape(-1, width))
        hit = torch.unique(cidx)
        hit = hit[hit < n]
        new_w, new_a = _adagrad(table[hit], acc[hit], g[hit], lr, eps)
        table[hit], acc[hit] = new_w.to(sd), new_a.to(sd)
        for k, leaf in leaves.items():
            new_p, new_a = _adagrad(params[k], pacc[k], leaf.grad, lr, eps)
            params[k], pacc[k] = new_p.to(sd), new_a.to(sd)
    out["losses"] = torch.stack(losses).cpu()
    out["table"] = {"index": torch.from_numpy(touched),
                    "w": table[:n].float().cpu(), "acc": acc[:n].float().cpu(),
                    "w0": w0.cpu()}
    out["dense"] = {k: (params[k].float().cpu(), pacc[k].float().cpu(),
                        p0[k].cpu()) for k in params}
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bfloat16 (to nearest, ties to even) and back."""
    return x.to(torch.bfloat16).float()


@torch.no_grad()
def train_sharded(config: dict, rank_batches: List[List[Dict]], seed: int,
                  device, *, shards: int, wire: str, stray_n: int = 0,
                  state_dtype: str = "float32", half_batch: bool = False,
                  exchange: bool = True) -> Dict:
    """`train` over a mesh of `shards` data-parallel ranks and a hashed table
    row-sharded by id % shards, each shard `capacity` slots placed as one
    table of its own -> the structure `train` returns, table rows indexed
    shard * capacity + slot. `rank_batches[r][t]` is rank r's batch of step
    t. Each step:

    - rank r pulls its distinct ids' rows from their owners; with `wire`
      "bf16" each row is rounded to bfloat16 on the way;
    - its loss is the mean over its own rows; the reported loss is the mean
      of the ranks';
    - its gradients are summed over its duplicates, rounded to the wire,
      and summed at the owner over the ranks; each owner applies Adagrad
      once per row;
    - the tower's gradients are summed over the ranks.

    The owner places the distinct ids it receives as `train` places a
    step's ids. `exchange=False` plants a fault: no gradient crosses the
    ranks (an owner applies only its own rank's gradients, and the tower
    takes rank 0's alone)."""
    sd = _DTYPES[state_dtype]
    cd = _DTYPES[config["compute_dtype"]]
    opt = config["optimizer"]
    lr, eps, acc0 = (opt["learning_rate"], opt["epsilon"],
                     opt["initial_accumulator_value"])
    wround = _bf16 if wire == "bf16" else (lambda x: x)
    S, cap = shards, W.table_rows(config)
    steps = len(rank_batches[0])
    ids = [[np.asarray(rank_batches[r][t]["sparse"]["categorical"]
                       ).reshape(-1) for t in range(steps)]
           for r in range(S)]
    # each owner places the step's distinct ids it owns; an id's global
    # index is shard * capacity + slot, and `miss` (a zero row) where it
    # found no slot
    miss = S * cap
    known_ids, known_at, occ, keys, overflow = [], [], [], [], 0
    for o in range(S):
        owned = [np.unique(np.concatenate([ids[r][t] for r in range(S)]))
                 for t in range(steps)]
        owned = [u[u % S == o] for u in owned]
        slots, so, ko = place_hashed(owned, cap, config["num_probes"])
        for u, sl in zip(owned, slots):
            overflow += int((sl == cap).sum())
            known_ids.append(u)
            known_at.append(np.where(sl == cap, miss, sl + o * cap))
        occ.append(so + o * cap)
        keys.append(ko)
    out: Dict = {"placement": (np.concatenate(occ), np.concatenate(keys)),
                 "overflow": overflow}
    kid, first = np.unique(np.concatenate(known_ids), return_index=True)
    kat = np.concatenate(known_at)[first]
    gidx = [[kat[np.searchsorted(kid, ids[r][t])] for t in range(steps)]
            for r in range(S)]
    touched = np.unique(np.concatenate([g for rr in gidx for g in rr]))
    touched = touched[touched < miss]
    w0 = torch.empty((touched.shape[0], config["dim"] + 1), device=device)
    stray_idx, stray_w0 = [], []
    for o in range(S):
        full = W.fill_table(torch.empty((cap, config["dim"] + 1),
                                        device=device), config, seed, o)
        mine = (touched // cap) == o
        at = torch.from_numpy(np.flatnonzero(mine)).to(device)
        w0[at] = full[torch.from_numpy(touched[mine] - o * cap).to(device)]
        if stray_n:
            sample = W.stray_sample(cap, stray_n, seed, device, shard=o)
            stray_idx.append(sample.cpu() + o * cap)
            stray_w0.append(full[sample].float().cpu())
        del full
    if stray_n:
        out["stray"] = {"index": torch.cat(stray_idx),
                        "w0": torch.cat(stray_w0)}
    n = touched.shape[0]
    table = torch.cat([w0, torch.zeros((1, w0.shape[1]), device=device)]
                      ).to(sd)
    acc = torch.full_like(table, acc0)
    b0 = rank_batches[0][0]
    f = ids[0][0].shape[0] // np.asarray(b0["label"]).shape[0]
    nd = np.asarray(b0["dense"]).shape[-1]
    p0 = W.dense_params(config, nd, f, seed, device)
    params = {k: v.to(sd) for k, v in p0.items()}
    pacc = {k: torch.full_like(v, acc0) for k, v in params.items()}
    hl = len(config["hidden"])
    losses = []
    for t in range(steps):
        grow = torch.zeros((n + 1, table.shape[1]), device=device)
        dgrad = {k: torch.zeros_like(v, dtype=torch.float32)
                 for k, v in params.items()}
        step_loss = 0.0
        for r in range(S):
            b = rank_batches[r][t]
            dense = torch.as_tensor(np.asarray(b["dense"]), device=device)
            label = torch.as_tensor(np.asarray(b["label"]), device=device)
            c_np = np.searchsorted(touched, gidx[r][t])
            c_np[gidx[r][t] >= miss] = n
            cidx = torch.from_numpy(c_np).to(device)
            bsz = label.shape[0]
            if half_batch:
                bsz //= 2
                dense, label, cidx = dense[:bsz], label[:bsz], cidx[:bsz * f]
            uniq, inv = torch.unique(cidx, return_inverse=True)
            pulled = wround(table[uniq].float())
            with torch.enable_grad():
                rows = pulled[inv].reshape(bsz, f, -1).requires_grad_()
                leaves = {k: v.detach().float().clone().requires_grad_()
                          for k, v in params.items()}
                loss = logloss(forward(leaves, rows, dense, hl, cd), label)
                loss.backward()
            step_loss = step_loss + loss.detach().float()
            gu = torch.zeros((uniq.shape[0], table.shape[1]), device=device
                             ).index_add_(0, inv, rows.grad.reshape(
                                 -1, table.shape[1]))
            if not exchange:
                own = torch.from_numpy(touched).to(device)[
                    uniq.clamp(max=n - 1)] // cap == r
                gu = gu * own[:, None]
            grow.index_add_(0, uniq, wround(gu))
            for k, leaf in leaves.items():
                if exchange or r == 0:
                    dgrad[k] += leaf.grad
        losses.append(step_loss / S)
        hit = torch.unique(torch.cat([torch.from_numpy(np.searchsorted(
            touched, gidx[r][t])).to(device) for r in range(S)]))
        hit = hit[hit < n]
        new_w, new_a = _adagrad(table[hit], acc[hit], grow[hit], lr, eps)
        table[hit], acc[hit] = new_w.to(sd), new_a.to(sd)
        for k in params:
            new_p, new_a = _adagrad(params[k], pacc[k], dgrad[k], lr, eps)
            params[k], pacc[k] = new_p.to(sd), new_a.to(sd)
    out["losses"] = torch.stack(losses).cpu()
    out["table"] = {"index": torch.from_numpy(touched),
                    "w": table[:n].float().cpu(), "acc": acc[:n].float().cpu(),
                    "w0": w0.cpu()}
    out["dense"] = {k: (params[k].float().cpu(), pacc[k].float().cpu(),
                        p0[k].cpu()) for k in params}
    return out
