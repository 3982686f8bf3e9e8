"""Measured step timing (port of `openembedding_tpu/utils/stepwatch.py`):
sampled synchronize brackets, byte attribution per collective kind and the
`exchange.cost_drift` gauge, under the JAX package's metric names.

The trainer's phase spans fire in eager steps and while a graph is
captured, never at a replay, so they time no replayed step. This module
measures without touching the step: every Nth CALL of the step callable is
bracketed host-side by `torch.cuda.synchronize()` before (steps still
queued do not count) and after, and lands in the `trainer.step_ms`
histogram; CUDA events around the same call give `trainer.step_device_ms`.
All other calls pay one integer increment.

Attribution: the JAX package reads each collective kind's result bytes off
the compiled HLO once. A CUDA graph has no HLO, so the port counts the
bytes `parallel/collectives.py` moves in one step, per kind
(`collectives.record_bytes`), once: while the step's graph is captured
(`model.CompiledStep.collective_bytes`) or, for an eager step, at the first
sampled call. Each sample then splits its measured wall time over the
kinds in proportion to bytes (`trainer.attrib_ms{kind=}`), as JAX does.

Cost drift and overlap: as in JAX, from the trainer's analytic wire model
(`MeshTrainer.last_wire_cost`): `exchange.us_per_byte` over the exposed
bytes (`bytes_per_step - overlapped_bytes`), `exchange.cost_drift` against
the mean of the first `BASELINE_SAMPLES` samples, and `trainer.overlap_ms`
for the bytes a pipelined window hides.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from . import metrics

BASELINE_SAMPLES = 3


class StepWatch:
    """Wrap a step callable with sampled measurement.

    `every`: sample one call in N (N >= 1). `wire_cost`: zero-arg callable
    returning the trainer's analytic exchange cost dict (or None), read at
    sample time. `device`: the step's device; on a CUDA device a sample is
    bracketed by `torch.cuda.synchronize` and timed with CUDA events too.
    The wrapped callable proxies attribute access to the inner callable
    (`captures`, `replays`, ... of a `model.CompiledStep`)."""

    def __init__(self, every: int = 16, *,
                 wire_cost: Optional[Callable[[], Optional[dict]]] = None,
                 label: str = "trainer", device=None):
        if every < 1:
            raise ValueError(f"StepWatch(every={every}): need >= 1")
        self.every = int(every)
        self.wire_cost = wire_cost
        self.label = label
        self.device = device
        self.calls = 0
        self.samples = 0
        self.input_waits = 0
        self._hlo_bytes: Optional[Dict[str, int]] = None
        self._baseline_us_per_byte: Optional[float] = None
        self._baseline_n = 0

    def _cuda(self) -> bool:
        return self.device is not None and getattr(self.device, "type",
                                                   None) == "cuda"

    def _observe_sample(self, ms: float,
                        device_ms: Optional[float] = None) -> None:
        self.samples += 1
        metrics.observe("trainer.step_ms", ms, "hist")
        if device_ms is not None:
            metrics.observe("trainer.step_device_ms", device_ms, "hist")
        if self._hlo_bytes:
            total = sum(self._hlo_bytes.values())
            for kind, b in self._hlo_bytes.items():
                metrics.observe("trainer.hlo_bytes", float(b), "gauge",
                                labels={"kind": kind})
                if total > 0:
                    metrics.observe("trainer.attrib_ms", ms * b / total,
                                    "gauge", labels={"kind": kind})
        cost = self.wire_cost() if self.wire_cost is not None else None
        bytes_per_step = int((cost or {}).get("bytes_per_step", 0) or 0)
        overlapped = int((cost or {}).get("overlapped_bytes", 0) or 0)
        exposed = max(bytes_per_step - overlapped, 0)
        if exposed > 0:
            us_per_byte = ms * 1e3 / exposed
            metrics.observe("exchange.us_per_byte", us_per_byte, "gauge")
            if self._baseline_n < BASELINE_SAMPLES:
                n = self._baseline_n
                base = self._baseline_us_per_byte or 0.0
                self._baseline_us_per_byte = (base * n + us_per_byte) / (n + 1)
                self._baseline_n = n + 1
            if self._baseline_us_per_byte and self._baseline_us_per_byte > 0:
                metrics.observe(
                    "exchange.cost_drift",
                    us_per_byte / self._baseline_us_per_byte - 1.0, "gauge")
        if overlapped > 0 and self._baseline_us_per_byte:
            metrics.observe("trainer.overlap_ms",
                            overlapped * self._baseline_us_per_byte / 1e3,
                            "gauge")

    def observe_input_wait(self, ms: float) -> None:
        """The input-wait lane: time the train loop spent blocked on the
        next batch (`{label}.input_wait_ms`)."""
        self.input_waits += 1
        metrics.observe(f"{self.label}.input_wait_ms", ms, "hist")

    def wrap(self, fn):
        """-> callable with `fn`'s signature; every Nth call is measured to
        completion, the rest dispatch untouched."""
        return _MeasuredStep(self, fn)


class _MeasuredStep:
    def __init__(self, watch: StepWatch, fn):
        self._watch = watch
        self._fn = fn

    def __call__(self, *args, **kwargs):
        w = self._watch
        w.calls += 1
        if w.calls % w.every:
            return self._fn(*args, **kwargs)
        import torch
        from ..parallel import collectives
        cuda = w._cuda()
        counted = None
        if w._hlo_bytes is None and getattr(self._fn, "collective_bytes",
                                            None) is None:
            counted = collectives.record_bytes()
        if cuda:
            torch.cuda.synchronize(w.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        if counted is not None:
            with counted as seen:
                out = self._fn(*args, **kwargs)
        else:
            out = self._fn(*args, **kwargs)
        device_ms = None
        if cuda:
            end.record()
            torch.cuda.synchronize(w.device)
        ms = (time.perf_counter() - t0) * 1e3
        if cuda:
            device_ms = start.elapsed_time(end)
        if w._hlo_bytes is None:
            got = getattr(self._fn, "collective_bytes", None)
            w._hlo_bytes = dict(got if got is not None else seen)
        w._observe_sample(ms, device_ms)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


def timed_batches(it, watch: Optional[StepWatch] = None, *,
                  label: str = "trainer"):
    """Wrap a batch iterator so each `next()`'s blocking time lands in the
    input-wait lane (`watch.observe_input_wait`, else the
    `{label}.input_wait_ms` histogram)."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        ms = (time.perf_counter() - t0) * 1e3
        if watch is not None:
            watch.observe_input_wait(ms)
        else:
            metrics.observe(f"{label}.input_wait_ms", ms, "hist")
        yield item
