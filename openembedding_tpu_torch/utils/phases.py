"""The train step's phases, named once and timed where they run.

`phase(group, name)` opens, in one call, the `torch.profiler` range
`<group>.<name>` and the trace span of the same name (`trace.span`: the
flight recorder and the `<group>.<name>.ms` histogram). `utils/trace.py`
stays torch-free; this module is its torch-aware companion for the step.

A span and a range time the host: an eager step, or the capture of a CUDA
graph, never a replay, which runs no host code. Inside `clocked(device,
True)` each phase also stamps a timing event at its entry and exit on the
current stream: a `torch.cuda.Event(enable_timing=True, external=True)` on
the card. While a graph is captured an external event becomes an
event-record node of the graph, so every replay stamps it on the device and
the phase is timed at every replay, where the work happens. The clock of a
captured graph (`PhaseClock`) therefore belongs to that graph:
`model.CompiledStep(timed=True)` keeps it beside the graph. Every boundary
of every step gets an event of its own, since one event recorded twice in a
graph keeps only its last stamp. On the CPU, where a step runs
synchronously, the events are host clock reads.

The clock also carries the step's counters (`count`): device tensors summed
as the step runs, read back by no one until the caller asks.

Outside `clocked` a phase creates no event, counts nothing, and adds
nothing to a captured graph.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

from . import metrics, trace

# the clock of the step running in this context; set only by `clocked`
_CLOCK: contextvars.ContextVar[Optional["PhaseClock"]] = \
    contextvars.ContextVar("oetpu_phase_clock", default=None)


class _HostEvent:
    """A timing event of the CPU, where the work is done when the call
    returns: `record` reads the host clock."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _cuda_event():
    return torch.cuda.Event(enable_timing=True, external=True)


class PhaseClock:
    """The phases of one run of a step or window, as timed intervals in the
    order they closed: [name, the enclosing interval or None, start event,
    end event]. `event`: the factory of timing events (default: CUDA events
    on a CUDA `device`, host clock reads otherwise); each needs `record()`,
    `synchronize()` and `elapsed_time(end)` in ms."""

    def __init__(self, device=None, *, event: Optional[Callable] = None):
        if event is None:
            cuda = device is not None and torch.device(device).type == "cuda"
            event = _cuda_event if cuda else _HostEvent
        self._event = event
        self.intervals: List[list] = []
        self._open: List[list] = []
        self.counters: Dict[str, torch.Tensor] = {}

    @contextmanager
    def interval(self, name: str) -> Iterator[None]:
        start = self._event()
        start.record()
        iv = [name, self._open[-1] if self._open else None, start, None]
        self._open.append(iv)
        try:
            yield
        finally:
            self._open.pop()
            iv[3] = self._event()
            iv[3].record()
            self.intervals.append(iv)

    def count(self, name: str, value: torch.Tensor) -> None:
        """Add `value` (a device scalar) to the counter `name`."""
        value = value.to(torch.int64)
        prev = self.counters.get(name)
        self.counters[name] = value if prev is None else prev + value

    def _durations(self) -> List[tuple]:
        """[(name, ms, parent interval)] once the last interval's end has
        been stamped: the one wait, on that event alone."""
        if not self.intervals:
            return []
        self.intervals[-1][3].synchronize()
        return [(name, start.elapsed_time(end), parent)
                for name, parent, start, end in self.intervals]

    def ms(self, observe: bool = False) -> Dict[str, float]:
        """{phase: ms summed over its intervals}; a nested phase counts
        whole, inside its parent's figure too. `observe`: each interval
        also lands in the `<phase>.device_ms` histogram (one observation a
        step for a step's phase)."""
        out: Dict[str, float] = {}
        for name, ms, _ in self._durations():
            out[name] = out.get(name, 0.0) + ms
            if observe:
                metrics.observe(f"{name}.device_ms", ms, "hist")
        return out

    def self_ms(self) -> Dict[str, float]:
        """{phase: its ms less those of the phases directly inside it}."""
        out: Dict[str, float] = {}
        for name, ms, parent in self._durations():
            out[name] = out.get(name, 0.0) + ms
            if parent is not None:
                out[parent[0]] = out.get(parent[0], 0.0) - ms
        return out


def active() -> Optional[PhaseClock]:
    """The clock of the step running in this context, None when untimed."""
    return _CLOCK.get()


@contextmanager
def clocked(device, on: bool, *, event: Optional[Callable] = None
            ) -> Iterator[Optional[PhaseClock]]:
    """With `on`, a new `PhaseClock` for the block: every `phase` opened
    inside it is timed and `active()` returns it. Without, nothing: the
    block runs as it would outside."""
    if not on:
        yield None
        return
    clock = PhaseClock(device, event=event)
    token = _CLOCK.set(clock)
    try:
        yield clock
    finally:
        _CLOCK.reset(token)


@contextmanager
def phase(group: str, name: str) -> Iterator[None]:
    """The profiler range and trace span `<group>.<name>`, and inside
    `clocked` its timed interval."""
    clock = _CLOCK.get()
    with record_function(f"{group}.{name}"), trace.span(group, name):
        if clock is None:
            yield
        else:
            with clock.interval(f"{group}.{name}"):
                yield
