"""The comparison that decides `correct` for a training cell: the numbers
read off the program's first steps against the reference's, each beside its
limit. Plain numpy and torch; imports nothing of the program.

Both sides hand in the same structure (see `reference/deepfm.train`): the
steps' losses, the table's touched rows (or a hashed table's occupied slots)
with their weights and accumulators, every tower parameter with its
accumulator, a hashed table's placement and overflow, and a sample of rows
that no batch touched.

Numbers, each the worst over what it covers:

- `loss_gap`: |L_p - L_r| / |L_r| over the steps.
- `grad_gap`: per leaf (the table, each tower parameter), the gap between
  the norms of the accumulator's growth, sum_t g_t^2, the gradients as the
  optimizer got them, over the reference's norm of that leaf or of the
  median leaf, whichever is larger.
- `change_gap`: the same for the change of the weights from their start.
- `row_gap`: ||W_p - W_r|| / ||W_r - W_0|| over the touched rows, matched
  by id: a row trained under another id shows here.
- `placement_mismatch` (hashed): occupied (slot, key) pairs on one side and
  not the other; `overflow_gap` (hashed): the difference of the counts of
  ids left without a slot. Exact: limit 0.
- `stray_rows`: sampled rows outside the batches whose weights or
  accumulator moved. Exact: limit 0.

A leaf whose reference gradient, sqrt(sum_t ||g_t||^2), is under a
thousandth of the median leaf's moves by round-off alone and is left out of
`grad_gap` and `change_gap`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SMALL_LEAF = 1e-3


def _leaves(out: Dict, acc0: float) -> Dict[str, tuple]:
    """{leaf: (accumulator growth, weight change)} as float64 tensors."""
    t = out["table"]
    res = {"table": ((t["acc"] - acc0).double(),
                     (t["w"] - t["w0"]).double())}
    for name, (p, acc, p0) in out["dense"].items():
        res[name] = ((acc - acc0).double(), (p - p0).double())
    return res


def _align(prog: Dict, ref: Dict) -> Dict:
    """The program's table rows on the reference's index (rows both hold)."""
    pi, ri = prog["table"]["index"].numpy(), ref["table"]["index"].numpy()
    common, at_p, at_r = np.intersect1d(pi, ri, return_indices=True)
    pick_p, pick_r = torch.from_numpy(at_p), torch.from_numpy(at_r)
    p = {"table": {k: prog["table"][k][pick_p] for k in ("w", "acc")},
         "dense": prog["dense"]}
    p["table"]["w0"] = ref["table"]["w0"][pick_r]
    r = {"table": {k: ref["table"][k][pick_r] for k in ("w", "acc", "w0")},
         "dense": ref["dense"]}
    missing = len(pi) + len(ri) - 2 * len(common)
    return p, r, missing


def _gap(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor]) -> float:
    """Worst leaf's | ||p|| - ||r|| | over max(||r||, median ||r||)."""
    pn = {k: float(v.detach().norm()) for k, v in p.items()}
    rn = {k: float(v.detach().norm()) for k, v in r.items()}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn)


def numbers(prog: Dict, ref: Dict, config: dict) -> Dict[str, float]:
    """-> {name: value} of every number compared."""
    acc0 = config["optimizer"]["initial_accumulator_value"]
    out = {}
    lp, lr = prog["losses"].double(), ref["losses"].double()
    if lp.shape != lr.shape:
        out["loss_gap"] = float("inf")
    else:
        out["loss_gap"] = float(((lp - lr).abs() / lr.abs()).max())
    p, r, missing = _align(prog, ref)
    lp_, lr_ = _leaves(p, acc0), _leaves(r, acc0)
    grad = {k: float(v[0].sum().clamp(min=0).sqrt()) for k, v in lr_.items()}
    med = float(np.median(list(grad.values())))
    keep = [k for k in lr_ if grad[k] >= SMALL_LEAF * med]
    out["grad_gap"] = _gap({k: lp_[k][0] for k in keep},
                           {k: lr_[k][0] for k in keep})
    out["change_gap"] = _gap({k: lp_[k][1] for k in keep},
                             {k: lr_[k][1] for k in keep})
    dw_r = (r["table"]["w"] - r["table"]["w0"]).double().norm()
    diff = (p["table"]["w"] - r["table"]["w"]).double().norm()
    out["row_gap"] = (float(diff / dw_r) if missing == 0 and dw_r > 0
                      else float("inf"))
    if "placement" in ref:
        (po, pk), (ro, rk) = prog["placement"], ref["placement"]
        po, pk, ro, rk = map(np.asarray, (po, pk, ro, rk))
        common, at_p, at_r = np.intersect1d(po, ro, return_indices=True)
        out["placement_mismatch"] = float(
            len(po) + len(ro) - 2 * len(common)
            + int((pk[at_p] != rk[at_r]).sum()))
        out["overflow_gap"] = float(abs(prog["overflow"] - ref["overflow"]))
    if "stray" in ref:
        idx = ref["stray"]["index"].numpy()
        outside = ~np.isin(idx, prog["table"]["index"].numpy())
        ps = prog["stray"]
        moved = ((ps["w"] != ref["stray"]["w0"]).any(dim=1)
                 | (ps["acc"] != acc0).any(dim=1)).numpy()
        out["stray_rows"] = float((moved & outside).sum())
    return out


def explain(prog: Dict, ref: Dict, config: dict, most: int = 8) -> list:
    """Where a run that is not correct departs from the reference, as lines
    for its log: the steps whose losses differ, the leaves whose gradients
    differ most, and the table rows (by index) whose weights differ by more
    than a hundredth of their change."""
    acc0 = config["optimizer"]["initial_accumulator_value"]
    lines = []
    lp, lr = prog["losses"].double(), ref["losses"].double()
    if lp.shape == lr.shape:
        rel = ((lp - lr).abs() / lr.abs()).tolist()
        off = [t for t, g in enumerate(rel) if g > 1e-6]
        lines.append(f"explain: {len(off)} of {len(rel)} steps' losses "
                     f"differ by more than 1e-6")
        lines += [f"explain: step {t} loss {float(lp[t])!r} reference "
                  f"{float(lr[t])!r}" for t in off[:most]]
    p, r, missing = _align(prog, ref)
    lp_, lr_ = _leaves(p, acc0), _leaves(r, acc0)
    gaps = sorted(((abs(float(lp_[k][0].norm()) - float(lr_[k][0].norm()))
                    / max(float(lr_[k][0].norm()), 1e-30), k)
                   for k in lr_), reverse=True)
    lines += [f"explain: leaf {k} accumulator growth gap {g!r}"
              for g, k in gaps[:3]]
    dw = (r["table"]["w"] - r["table"]["w0"]).double().norm(dim=1)
    diff = (p["table"]["w"] - r["table"]["w"]).double().norm(dim=1)
    bad = torch.nonzero(diff > 0.01 * dw).reshape(-1)
    index = ref["table"]["index"].numpy()
    common = np.intersect1d(prog["table"]["index"].numpy(), index)
    lines.append(f"explain: {int(bad.numel())} of {int(dw.numel())} table "
                 f"rows off by more than 1% of their change; {missing} rows "
                 "on one side only")
    for i in bad[:most].tolist():
        lines.append(f"explain: row {int(common[i])} off by "
                     f"{float(diff[i])!r}, its change {float(dw[i])!r}")
    return lines


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}): correct when every number
    is at or under its limit; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in
              values.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
