"""The train step's phases as the program times them on the device, inside
the window's CUDA graph: what the phase metrics read (`metrics/pull_ms.py`,
`probe_ms.py`, `tower_ms.py`, `dense_apply_ms.py`, `dedup_ms.py`,
`push_ms.py`).

Once a run, at the first of those readers, after the traced window:

1. the untimed driver's graphs are released (nothing after the readers
   replays them), so the timed graph takes their memory;
2. a timed driver, `trainer.jit_train_many(timed=True)`, is built on the
   run's trainer and state: its graph holds an event-record node at each
   phase's entry and exit, which every replay stamps on the device;
3. its first call (the eager run and the capture) and one warm replay run,
   then one replay of each traced window, each followed by
   `CompiledStep.phase_ms()`: each phase's device ms, summed over the
   window's steps.

A phase's figure is its ms a step, the mean over those replays. The log
holds the whole split with each phase's self time, the counters "distinct"
(the push's live unique rows) and "inserted" (the slots the probe claimed)
against the harness's own count of the same batches' distinct ids, and
the top-level phases' sum against the traced window's busy time a step.

Off the card, or where the program has no timed driver (no `timed`
keyword), every reader reads None and nothing is released.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional

from benchmark import profiling

TOP = ("trainer.pull", "trainer.compute", "trainer.apply")

_KEY = "_phase_split"


def step_ms(ctx, phase: str) -> Optional[float]:
    """Device ms a step of the program's phase `phase`, or None."""
    if _KEY not in ctx.__dict__:
        ctx.__dict__[_KEY] = _measure(ctx)
    split = ctx.__dict__[_KEY]
    return None if split is None else split.get(phase)


def _measure(ctx) -> Optional[Dict[str, float]]:
    if ctx.device.type != "cuda":
        return None
    trainer = ctx.program["trainer"]
    if "timed" not in inspect.signature(trainer.jit_train_many).parameters:
        ctx.log("phases: the program has no timed window driver")
        return None
    ctx.program["step"]._release()
    k = ctx.traffic["window"]
    traced = [t // k for t in ctx.traced_batches[::k]]
    state, windows = ctx.program["state"], ctx.program["windows"]
    step = trainer.jit_train_many(timed=True)
    for _ in range(2):  # the eager run with the capture, a warm replay
        step(state, windows[traced[0]])
    whole: Dict[str, float] = {}
    own: Dict[str, float] = {}
    distinct = inserted = 0
    for j in traced:
        _, m = step(state, windows[j])
        for sums, read in ((whole, step.phase_ms()),
                           (own, m["phases"].self_ms())):
            for name, ms in read.items():
                sums[name] = sums.get(name, 0.0) + ms
        distinct += int(m["distinct"])
        inserted += int(m["inserted"])
    steps = len(traced) * k
    split = {name: ms / steps for name, ms in whole.items()}
    _log(ctx, split, {name: ms / steps for name, ms in own.items()}, steps,
         distinct, inserted)
    return split


def _log(ctx, split: Dict[str, float], own: Dict[str, float], steps: int,
         distinct: int, inserted: int) -> None:
    ctx.log(f"phases: device ms a step over {steps} timed steps "
            "(whole / self): " + ", ".join(
                f"{n} {split[n]:.5f} / {own[n]:.5f}" for n in split))
    top = sum(split.get(n, 0.0) for n in TOP)
    if ctx.trace is not None:
        busy = profiling.busy_us(ctx.trace) / len(ctx.traced_batches) / 1e3
        ctx.log(f"phases: pull + compute + apply {top:.5f} ms a step, "
                f"{100.0 * top / busy:.2f}% of the traced window's busy "
                f"{busy:.5f} ms a step")
    want = sum(ctx.unique[t] for t in ctx.traced_batches)
    ctx.log(f"phases: distinct {distinct} (the program's push), {want} "
            f"(the harness's count of the same batches): "
            f"{'equal' if distinct == want else 'NOT EQUAL'}; inserted "
            f"{inserted}")
