"""The port's copy of `openembedding_tpu/utils/trace.py` (torch-free,
letter for letter in its names, headers and exports, so a dump from either
package reads with the other's tools).

Tracing: spans, request ids, a flight recorder, Chrome-trace export.

The reference's operational surfaces stop at scope timers and accumulator
tables (`VTIMER`, evaluate-performance counters, the Prometheus exposer —
`utils/metrics.py` carries those). This module adds the layer they cannot
express: following ONE request (a serving predict, a sync round) through
queue -> batch -> swap across threads, and explaining a tail-latency spike
or a DEGRADED transition after the fact.

- `span(group, name, **attrs)`: thread-safe scope span. Parent/child nesting
  rides a contextvar, so nesting works across `with` blocks in one thread
  and — via `contextvars.copy_context()` — across thread handoffs. Every
  span also lands in the `{group}.{name}.ms` latency histogram
  (`metrics.Accumulator(kind="hist")`), so /metrics p50/p95/p99 and the
  trace view are two projections of the same measurements.
- request ids: `request(rid)` binds a trace id that every span opened inside
  it carries. The serving HTTP surface propagates `X-OETPU-Request-Id`
  (generated when absent) and the sync subscriber stamps each negotiation
  round, so publisher-side handler spans and subscriber-side fetch/apply
  spans of one round share an id.
- cross-process propagation: `TraceContext` serializes (trace id, parent
  span uid) onto the `X-OETPU-Trace` header (`inject_headers` on every
  outbound call, `extract_context` on the serving surface); the callee's
  root span records the caller's process-qualified span uid as
  `remote_parent`, so two nodes' dumps stitch into ONE tree
  (`tools/trace_report.py --trace <rid>` renders it). Spans and events carry
  a (wall, monotonic) timestamp pair — wall for cross-host merges after skew
  correction, monotonic for in-process durations.
- flight recorder: a bounded ring buffer of recent spans + discrete events
  (sync state transitions with reason, rollbacks, persist commits, servable
  swaps). `RECORDER.render_text()` is what `GET /statusz` prints;
  `GET /tracez` serves the same buffer as JSON.
- `dump_chrome(path)`: Chrome-trace/Perfetto JSON ("traceEvents" array,
  complete "X" events + instant "i" events) — load in chrome://tracing or
  ui.perfetto.dev; `tools/trace_report.py` turns a dump into a latency table.

Spans cost two clock reads, a histogram observe, and a deque append — cheap
enough to stay always-on, like the accumulators. NOTE on jitted code: a span
around traced (jit/shard_map/scan) Python measures TRACE time, once per
compile — honest for compile structure, not per-step execution. Put spans
around the jitted CALL (dispatch+wall) or host-side stages for runtime
numbers. In the port the step's phase spans (`model.Trainer._step`, opened
through `utils/phases.phase`) are the capture-time kind inside a CUDA
graph: a replay runs no host code. A timed driver
(`jit_train_many(timed=True)`) times the same phases on the device at every
replay, into the `<group>.<name>.device_ms` histograms.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

from . import metrics

REQUEST_ID_HEADER = "X-OETPU-Request-Id"
TRACE_HEADER = "X-OETPU-Trace"
SERVER_TIME_HEADER = "X-OETPU-Server-Time"

# a stable per-process identity: span ids are process-local counters, so a
# cross-process parent reference must qualify them (`<process>:<span_id>`) to
# be unambiguous once two nodes' dumps are merged
PROCESS_ID = uuid.uuid4().hex[:8]

_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("oetpu_current_span", default=None)
_request_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("oetpu_request_id", default=None)
_remote_parent: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("oetpu_remote_parent", default=None)
_span_ids = itertools.count(1)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def get_request_id() -> Optional[str]:
    return _request_id.get()


@contextmanager
def request(rid: Optional[str] = None, *,
            remote_parent: Optional[str] = None):
    """Bind a request/trace id for the duration of the block; every span
    opened inside carries it as `trace_id` (generated when not given).
    `remote_parent` is a process-qualified span uid (`proc:span_id`) from the
    caller's side of an HTTP hop: the first span opened inside the block with
    no LOCAL parent records it, stitching the two processes' trees."""
    rid = rid or new_request_id()
    token = _request_id.set(rid)
    rtoken = _remote_parent.set(remote_parent)
    try:
        yield rid
    finally:
        _remote_parent.reset(rtoken)
        _request_id.reset(token)


class TraceContext:
    """The serializable cross-process slice of the tracing state: the trace
    (request) id plus the process-qualified id of the span that was open when
    the context was captured. Rides the `X-OETPU-Trace` header as
    `<trace_id>` or `<trace_id>/<process>:<span_id>`."""

    __slots__ = ("trace_id", "parent_span")

    def __init__(self, trace_id: str, parent_span: Optional[str] = None):
        self.trace_id = trace_id
        self.parent_span = parent_span

    def to_header(self) -> str:
        if self.parent_span:
            return f"{self.trace_id}/{self.parent_span}"
        return self.trace_id

    @classmethod
    def from_header(cls, value: str) -> Optional["TraceContext"]:
        value = (value or "").strip()
        if not value:
            return None
        trace_id, _, parent = value.partition("/")
        return cls(trace_id, parent or None)

    @classmethod
    def current(cls) -> Optional["TraceContext"]:
        """Capture the calling context, or None when no request is bound and
        no span is open (nothing to propagate)."""
        rid = _request_id.get()
        s = _current_span.get()
        if rid is None and s is None:
            return None
        parent = s.qualified_id if s is not None else None
        return cls(rid or new_request_id(), parent)


def inject_headers(headers: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Stamp the current trace context onto an outbound HTTP request's
    headers (creating the dict when not given): the legacy request-id header
    plus the `X-OETPU-Trace` context. Returns the dict for chaining."""
    headers = headers if headers is not None else {}
    ctx = TraceContext.current()
    if ctx is not None:
        headers.setdefault(REQUEST_ID_HEADER, ctx.trace_id)
        headers.setdefault(TRACE_HEADER, ctx.to_header())
    return headers


def extract_context(headers) -> Optional[TraceContext]:
    """Read a `TraceContext` off inbound HTTP headers (any Mapping with
    `.get`, e.g. `http.server`'s message object); falls back to the bare
    request-id header; None when neither is present."""
    raw = headers.get(TRACE_HEADER) if headers is not None else None
    ctx = TraceContext.from_header(raw) if raw else None
    if ctx is not None:
        return ctx
    rid = headers.get(REQUEST_ID_HEADER) if headers is not None else None
    return TraceContext(rid) if rid else None


class Span:
    """One timed scope. Mutable while open; recorded on close.

    Carries a (wall, monotonic) timestamp PAIR: `start` is the monotonic
    clock (durations, in-process ordering), `wall` is `time.time()` captured
    at the same moment (cross-host merging after skew correction). Mixing the
    two domains is exactly the bug the pair exists to prevent."""

    __slots__ = ("group", "name", "span_id", "parent_id", "remote_parent",
                 "trace_id", "start", "wall", "duration_ms", "thread",
                 "attrs")

    def __init__(self, group: str, name: str, parent: Optional["Span"],
                 attrs: Dict[str, Any]):
        self.group = group
        self.name = name
        self.span_id = next(_span_ids)
        self.parent_id = parent.span_id if parent is not None else None
        # a root span inside request(remote_parent=...) links to the caller's
        # span across the process boundary; non-roots have a local parent
        self.remote_parent = _remote_parent.get() if parent is None else None
        self.trace_id = _request_id.get()
        self.start = time.perf_counter()
        self.wall = time.time()
        self.duration_ms: Optional[float] = None
        self.thread = threading.get_ident()
        self.attrs = attrs

    @property
    def qualified_id(self) -> str:
        return f"{PROCESS_ID}:{self.span_id}"

    def as_dict(self) -> dict:
        return {"kind": "span", "group": self.group, "name": self.name,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "remote_parent": self.remote_parent,
                "request_id": self.trace_id, "start": self.wall,
                "mono": self.start, "process": PROCESS_ID,
                "duration_ms": self.duration_ms, "thread": self.thread,
                "attrs": dict(self.attrs)}


class Event:
    """A discrete moment (state transition, rollback, commit, swap).
    Like spans, carries the (wall, monotonic) pair — `wall` for cross-host
    merges, `ts` (monotonic) for in-process deltas."""

    __slots__ = ("group", "name", "ts", "wall", "trace_id", "thread", "attrs")

    def __init__(self, group: str, name: str, attrs: Dict[str, Any]):
        self.group = group
        self.name = name
        self.ts = time.perf_counter()
        self.wall = time.time()
        self.trace_id = _request_id.get()
        self.thread = threading.get_ident()
        self.attrs = attrs

    def as_dict(self) -> dict:
        return {"kind": "event", "group": self.group, "name": self.name,
                "request_id": self.trace_id, "ts": self.wall,
                "mono": self.ts, "process": PROCESS_ID,
                "thread": self.thread, "attrs": dict(self.attrs)}


class FlightRecorder:
    """Bounded ring buffer of completed spans + events, oldest evicted first.
    Append order = completion order (a parent span lands AFTER its children).
    """

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(capacity))  # guarded-by: self._lock

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def configure(self, capacity: int) -> None:
        """Resize, keeping the newest entries."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=int(capacity))

    def record(self, item) -> None:
        with self._lock:
            self._buf.append(item)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def tail(self, n: Optional[int] = None) -> List[Any]:
        with self._lock:
            items = list(self._buf)
        return items if n is None else items[-int(n):]

    def spans(self, n: Optional[int] = None) -> List[Span]:
        out = [x for x in self.tail() if isinstance(x, Span)]
        return out if n is None else out[-int(n):]

    def events(self, n: Optional[int] = None) -> List[Event]:
        out = [x for x in self.tail() if isinstance(x, Event)]
        return out if n is None else out[-int(n):]

    def render_text(self, n: int = 40) -> str:
        """The flight-recorder tail as text (the /statusz rendering)."""
        lines = []
        for item in self.tail(n):
            d = item.as_dict()
            ts = d.get("start", d.get("ts"))
            stamp = time.strftime("%H:%M:%S", time.localtime(ts)) + \
                f".{int((ts % 1) * 1e3):03d}"
            rid = f" rid={d['request_id']}" if d["request_id"] else ""
            attrs = " ".join(f"{k}={v}" for k, v in d["attrs"].items())
            if d["kind"] == "span":
                lines.append(
                    f"[{stamp}] SPAN {d['group']}.{d['name']} "
                    f"{d['duration_ms']:.3f}ms{rid}"
                    + (f" {attrs}" if attrs else ""))
            else:
                lines.append(f"[{stamp}] EVT  {d['group']}.{d['name']}{rid}"
                             + (f" {attrs}" if attrs else ""))
        return "\n".join(lines) if lines else "(flight recorder empty)"


RECORDER = FlightRecorder()


def configure(capacity: int) -> None:
    """Resize the global flight recorder (`--flight-recorder N`)."""
    RECORDER.configure(capacity)


@contextmanager
def span(group: str, name: str, *, labels: Optional[Dict[str, str]] = None,
         **attrs):
    """Timed scope: nests under the current span (contextvar), records into
    the flight recorder on exit, and observes the `{group}.{name}.ms`
    latency histogram (+ `.max_ms` high-water mark) — with `labels`, the
    histogram series carries them (`oetpu_..._ms_bucket{model="m"}`)."""
    parent = _current_span.get()
    s = Span(group, name, parent, dict(attrs))
    token = _current_span.set(s)
    t0 = s.start
    try:
        yield s
    except BaseException as e:
        s.attrs.setdefault("error", f"{type(e).__name__}: {e}")
        # explicit status + a discrete flight-recorder event: a span that
        # exits via exception must be filterable on /tracez (and survive in
        # the event ring), not be shaped like a fast success
        s.attrs["status"] = "error"
        event(group, "span_error", span=name, error=s.attrs["error"])
        raise
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        s.duration_ms = ms
        _current_span.reset(token)
        RECORDER.record(s)
        metrics.observe(f"{group}.{name}.ms", ms, "hist", labels=labels)
        metrics.observe(f"{group}.{name}.max_ms", ms, "max", labels=labels)


def current_span() -> Optional[Span]:
    return _current_span.get()


def event(group: str, name: str, **attrs) -> Event:
    """Record a discrete event into the flight recorder."""
    e = Event(group, name, attrs)
    RECORDER.record(e)
    return e


# -- export -------------------------------------------------------------------


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)


def chrome_events(items: Optional[Iterable] = None) -> List[dict]:
    """Flight-recorder contents as Chrome-trace event dicts (ts/dur in us)."""
    pid = os.getpid()
    out = []
    for item in (RECORDER.tail() if items is None else items):
        args = {k: _jsonable(v) for k, v in item.attrs.items()}
        if item.trace_id:
            args["request_id"] = item.trace_id
        args["process"] = PROCESS_ID
        if isinstance(item, Span):
            args["span_id"] = item.span_id
            args["span_uid"] = f"{PROCESS_ID}:{item.span_id}"
            if item.parent_id is not None:
                args["parent_id"] = item.parent_id
                args["parent_uid"] = f"{PROCESS_ID}:{item.parent_id}"
            if item.remote_parent:
                args["remote_parent"] = item.remote_parent
            out.append({"name": f"{item.group}.{item.name}",
                        "cat": item.group, "ph": "X",
                        "ts": item.wall * 1e6,
                        "dur": (item.duration_ms or 0.0) * 1e3,
                        "pid": pid, "tid": item.thread, "args": args})
        else:
            out.append({"name": f"{item.group}.{item.name}",
                        "cat": item.group, "ph": "i", "s": "g",
                        "ts": item.wall * 1e6,
                        "pid": pid, "tid": item.thread, "args": args})
    return out


def dump_chrome(path: str) -> str:
    """Write the flight recorder as Chrome-trace/Perfetto JSON; returns
    `path`. Load in chrome://tracing / ui.perfetto.dev, or feed to
    `tools/trace_report.py` for a per-group latency table."""
    doc = {"traceEvents": chrome_events(), "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
