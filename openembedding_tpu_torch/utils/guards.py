"""Runtime invariant guards (port of `openembedding_tpu/utils/guards.py`):
what the JAX package's guards protect, checked the port's way.

The JAX guards count XLA traces and walk jaxprs without running anything.
The port has no trace, so:

- **No re-capture.** The port's counterpart of a recompile is a CUDA-graph
  capture (`model.CompiledStep`). `assert_no_recompile(fn, max_traces=1)`
  wraps a function so that exceeding the budget raises `RecompileError` at
  the call that exceeded it:
  - a `CompiledStep` (a trainer's `jit_train_step()` / `jit_train_many()` /
    `jit_eval_step()`) is budgeted on the growth of its `captures` since
    wrap time, checked after every call; on a trainer off the card, where a
    `CompiledStep` runs eagerly and captures nothing, it is budgeted on the
    distinct batch structures it was called with (keys, shapes, dtypes:
    what would each be captured on the card);
  - any other callable is budgeted on the distinct input structures of its
    arguments (keys, shapes, dtypes, devices; other values by type), and
    the call that brings one too many raises before `fn` runs.
  `max_traces` > 1 covers deliberately multi-mode functions.
- `trace_counter(*fns)`: a context manager whose `.new_traces` counts the
  new captures (or guarded structures) of the given drivers inside the
  block, for loops that assert "N more steps, zero new graphs".
- **A fixed collective sequence.** `collective_fingerprint(fn, *args)`
  runs `fn(*args)` once while `parallel/collectives` records every
  collective it issues, in order: kind (the JAX package's HLO names), group
  size, dtype and shape. Every collective of the port goes through that
  module. The sha256 of the list (16 hex chars) must be the same on every
  rank and must survive hot-row refreshes, migrations and placement cycles;
  `assert_collective_fingerprint` raises `CollectiveMismatchError` with the
  current sequence when it changed, and `last_fingerprint()` is the latest
  one (postmortem capsules carry it). Divergence from the JAX package,
  which traces without running: the fingerprint RUNS `fn`, so it advances
  whatever state `fn` updates (a train step trains); fingerprint a step the
  caller wanted to take anyway. A collective at S = 1 is the identity and
  runs nothing, so it is not recorded.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch

__all__ = ["RecompileError", "CollectiveMismatchError", "TraceCounter",
           "assert_no_recompile", "trace_counter", "collective_sequence",
           "collective_fingerprint", "assert_collective_fingerprint",
           "last_fingerprint"]


class RecompileError(RuntimeError):
    """A guarded driver captured (or a guarded function met new input
    structures) more times than its budget."""


class CollectiveMismatchError(RuntimeError):
    """A pinned collective fingerprint changed: the recorded collective
    sequence differs from the one the pin was taken against."""


class TraceCounter:
    """Mutable trace count for one guarded function (exposed as
    `guarded.traces` on `assert_no_recompile` wrappers of plain callables)."""

    def __init__(self, label: str, limit: int):
        self.label = label
        self.limit = int(limit)
        self.traces = 0

    def hit(self) -> None:
        self.traces += 1
        if self.traces > self.limit:
            raise RecompileError(
                f"{self.label!r} traced {self.traces} times (budget "
                f"{self.limit}): a shape/dtype/structure changed between "
                "calls; the no-re-capture rule (static shapes, "
                "content-only refreshes) is broken at this call site")

    def __repr__(self) -> str:
        return (f"TraceCounter({self.label!r}, traces={self.traces}, "
                f"limit={self.limit})")


def _structure(x):
    """A hashable description of an argument's structure: tensors and
    arrays by shape, dtype (and device), containers by keys and lengths,
    dataclasses by fields, anything else by type."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("array", x.shape, str(x.dtype))
    if isinstance(x, dict):
        return ("dict", tuple((str(k), _structure(v))
                              for k, v in sorted(x.items(),
                                                 key=lambda kv: str(kv[0]))))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_structure(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _structure(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    return type(x).__name__


def _is_compiled_step(fn) -> bool:
    return hasattr(fn, "captures") and hasattr(fn, "trainer")


def _on_card(fn) -> bool:
    return fn.trainer.device.type == "cuda"


def assert_no_recompile(fn=None, *, max_traces: int = 1,
                        label: Optional[str] = None):
    """Guard `fn` against re-captures (see the module docstring). Returns a
    forwarding wrapper with `.trace_count()` (captures or structures since
    wrap) and `.__wrapped__` (the driver, whose counters stay readable).
    Usable as a decorator: `@assert_no_recompile` or
    `@assert_no_recompile(max_traces=2)`."""
    if fn is None:
        return functools.partial(assert_no_recompile, max_traces=max_traces,
                                 label=label)
    name = label or getattr(fn, "__name__", None) or type(fn).__name__

    if _is_compiled_step(fn) and _on_card(fn):
        base = fn.captures

        def guarded(*args, **kwargs):
            out = fn(*args, **kwargs)
            n = fn.captures - base
            if n > max_traces:
                raise RecompileError(
                    f"{name!r} captured {n} new CUDA graphs (budget "
                    f"{max_traces}): this call captured again: a batch "
                    "structure, the state's tensors or the trainer's "
                    "graph_epoch changed (the no-re-capture rule)")
            return out

        guarded.trace_count = lambda: fn.captures - base
        guarded.__wrapped__ = fn
        return guarded

    counter = TraceCounter(name, max_traces)
    seen = set()
    # a CompiledStep off the card: the batch decides what would be captured
    key_of = ((lambda args, kwargs: _structure(
        args[1] if len(args) > 1 else kwargs.get("batch")))
        if _is_compiled_step(fn)
        else (lambda args, kwargs: (_structure(args), _structure(kwargs))))

    def guarded(*args, **kwargs):
        key = key_of(args, kwargs)
        if key not in seen:
            counter.hit()  # raises before `fn` runs: the offending call
            seen.add(key)
        return fn(*args, **kwargs)

    guarded.traces = counter
    guarded.trace_count = lambda: counter.traces
    guarded.__wrapped__ = fn
    if not _is_compiled_step(fn):
        functools.update_wrapper(guarded, fn, updated=())
    return guarded


# -- collective fingerprint -------------------------------------------------


def collective_sequence(fn, *args, **kwargs):
    """Ordered [(kind, group size, dtype, shape)] of every collective
    `fn(*args, **kwargs)` issues, recorded while it RUNS
    (`parallel.collectives.record_sequence`); a collective nested in
    another counts once, as the outer one."""
    from ..parallel import collectives
    with collectives.record_sequence() as seq:
        fn(*args, **kwargs)
    return list(seq)


# the most recent fingerprint computed in this process: postmortem capsules
# (utils/capsule.py) embed it, naming the collective program that was live
_LAST_FINGERPRINT: Optional[str] = None


def last_fingerprint() -> Optional[str]:
    """The most recently computed or asserted collective fingerprint (None
    before any `collective_fingerprint` call in this process)."""
    return _LAST_FINGERPRINT


def _digest(seq: List[tuple]) -> str:
    return hashlib.sha256(repr(seq).encode()).hexdigest()[:16]


def collective_fingerprint(fn, *args, **kwargs) -> str:
    """sha256 (16 hex chars) over `collective_sequence(fn, *args)`: any
    change to which collectives run, in what order, over how many ranks, at
    what shapes and dtypes changes the hash. Runs `fn` once."""
    global _LAST_FINGERPRINT
    fp = _digest(collective_sequence(fn, *args, **kwargs))
    _LAST_FINGERPRINT = fp
    from . import metrics as _metrics
    _metrics.observe("guard.fingerprints", 1.0)
    return fp


def assert_collective_fingerprint(fn, pinned: str, *args,
                                  label: Optional[str] = None,
                                  **kwargs) -> str:
    """Raise `CollectiveMismatchError` if `fn`'s collective sequence no
    longer hashes to `pinned`; returns the (matching) fingerprint. Runs `fn`
    once. The error carries the whole current sequence."""
    global _LAST_FINGERPRINT
    seq = collective_sequence(fn, *args, **kwargs)
    fp = _digest(seq)
    _LAST_FINGERPRINT = fp
    if fp != pinned:
        name = label or getattr(fn, "__name__", None) or repr(fn)
        from . import metrics as _metrics
        _metrics.observe("guard.fingerprint_trips", 1.0)
        raise CollectiveMismatchError(
            f"{name!r}: the collective sequence changed (fingerprint {fp} "
            f"!= pinned {pinned}); it is meant to be invariant under "
            "refreshes, migrations and resizes. Current sequence: "
            f"{seq}")
    return fp


def _trace_total(fn) -> Optional[int]:
    count = getattr(fn, "trace_count", None)
    if count is not None:
        return int(count())
    if _is_compiled_step(fn):
        return int(fn.captures)
    return None


class _TraceDelta:
    """Live view of new captures since the `trace_counter` block began."""

    def __init__(self, fns):
        self._fns = fns
        self._before = [(_trace_total(f) or 0) for f in fns]

    @property
    def per_fn(self):
        return [(_trace_total(f) or 0) - b
                for f, b in zip(self._fns, self._before)]

    @property
    def new_traces(self) -> int:
        return sum(self.per_fn)


@contextmanager
def trace_counter(*drivers):
    """`with trace_counter(step) as tc:` ... `assert tc.new_traces == 0`.

    Counts the new captures of the given `CompiledStep` drivers (or the new
    structures of `assert_no_recompile` wrappers) inside the block; live:
    `.new_traces` is current at any point, after exit too. Other callables
    contribute 0."""
    yield _TraceDelta(drivers)
