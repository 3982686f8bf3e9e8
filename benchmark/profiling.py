"""The guarded `torch.profiler` session and what the readers take from it.

A frozen copy of the program's profiler guard (`chip_smoke.profiled_session`
and `device_kernels`): on the H100 a session may lose its first device
records, so each session opens with 32 short spins, run to their end, that
absorb the loss; the call sits between two long spin kernels (brackets),
and a session that did not trace both brackets is taken again.

The call also runs once inside the session before the first bracket, out
of the window, so that what the profiler does at its first sight of the
window's graph falls outside it: without that run one traced run of the
array cell on the H100 read 26% idle, 11.2 ms of it in `cudaGraphLaunch`
(with it, 14.9%).

The traced window is the device time between the end of the first bracket
and the start of the second: every device record in it belongs to the call
(its kernels, copies and memsets), and every gap in it is time the device
waited for the host.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

BRACKET_CYCLES = 1_000_000  # the spins around the call: about 0.5 ms
WARM_CYCLES = 10_000        # the spins that open a session: about 5 us
OPENING = 32


def _session(fn: Callable[[], None]) -> Dict[str, list]:
    """One profiler session of one call of `fn` (after an unbracketed one)
    -> {"device": [(name, start_us, end_us)], "host": [(name, start_us,
    end_us)]}, each sorted by start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        fn()
        for _ in range(OPENING):
            torch.cuda._sleep(WARM_CYCLES)
        torch.cuda.synchronize()
        torch.cuda._sleep(BRACKET_CYCLES)
        fn()
        torch.cuda._sleep(BRACKET_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.01)
    out = {"device": [], "host": []}
    events = list(prof.events())
    # a `record_function` range is also drawn on the device's timeline
    # (`gpu_user_annotation`) over the work it enqueued: not a device op
    def annotation(e):
        return (getattr(e, "is_user_annotation", False)
                or "user_annotation" in str(getattr(e, "activity_type", "")))
    ranges = {e.name for e in events if annotation(e)}
    for e in events:
        device = e.device_type == DeviceType.CUDA
        if device and (annotation(e) or e.name in ranges):
            continue
        out["device" if device else "host"].append(
            (e.name, float(e.time_range.start), float(e.time_range.end)))
    for v in out.values():
        v.sort(key=lambda r: r[1])
    return out


def _brackets(device: list) -> list:
    return [r for r in device if "spin" in r[0] and r[2] - r[1] >= 100.0]


def traced(fn: Callable[[], None], tries: int = 3) -> Optional[Dict]:
    """The call traced in a session that kept both brackets, up to `tries`
    sessions -> {"device": records inside the window, "host": host records
    that overlap it, "window_us": (start, end), "sessions": tries used};
    None when no session kept both (the reader then reads nothing)."""
    for n in range(1, tries + 1):
        rec = _session(fn)
        br = _brackets(rec["device"])
        if len(br) != 2:
            continue
        lo, hi = br[0][2], br[1][1]
        dev = [r for r in rec["device"] if r[1] >= lo and r[2] <= hi
               and "spin" not in r[0]]
        if not dev:
            continue
        host = [r for r in rec["host"] if r[2] > lo and r[1] < hi]
        return {"device": dev, "host": host, "window_us": (lo, hi),
                "sessions": n}
    return None


def busy_intervals(device: list) -> List[tuple]:
    """The union of the device records' intervals, sorted and merged."""
    out: List[list] = []
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_us(trace: Dict) -> float:
    return sum(e - s for s, e in busy_intervals(trace["device"]))


def window_us(trace: Dict) -> float:
    lo, hi = trace["window_us"]
    return hi - lo


def by_name(trace: Dict, part: str) -> List[tuple]:
    """[(name, device us, calls)] of device records whose name holds
    `part`."""
    out: Dict[str, list] = {}
    for name, s, e in trace["device"]:
        if part in name:
            agg = out.setdefault(name, [0.0, 0])
            agg[0] += e - s
            agg[1] += 1
    return [(k, v[0], v[1]) for k, v in out.items()]


def host_ranges(trace: Dict, name: str) -> List[float]:
    """Durations (us) of the host ranges called `name`."""
    return [e - s for n, s, e in trace["host"] if n == name]


def breakdown(trace: Dict, top: int = 10) -> Dict[str, list]:
    """{"device_ops": [[name, seconds]], "idle_gaps": [[host activity,
    seconds]]}: the device records that took most time, and the idle gaps
    of the window summed by what the host was doing at each gap's middle
    (the innermost host range covering it)."""
    ops: Dict[str, float] = {}
    for name, s, e in trace["device"]:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    lo, hi = trace["window_us"]
    busy = busy_intervals(trace["device"])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps: Dict[str, float] = {}
    host = trace["host"]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inner = [r for r in host if r[1] <= mid <= r[2]]
        label = (min(inner, key=lambda r: r[2] - r[1])[0] if inner
                 else "no host range")
        gaps[label] = gaps.get(label, 0.0) + (e - s) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
