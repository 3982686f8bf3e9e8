"""The port's copy of `openembedding_tpu/utils/history.py`.

Metric history rings: bounded time-series memory behind every accumulator.

The live surfaces built in rounds 8/16 (`/metrics`, `/statusz`, `/sloz`) are
point-in-time: by the time an operator looks at a breach or a halt, the
evidence is gone. This module keeps a bounded ring of `(ts, snapshot)`
samples per metric series, recorded at `PeriodicReporter` cadence (the same
thread that prints the accumulator table calls `HISTORY.sample_registry()`
just before it), so three consumers gain real history:

- `GET /historz?metric=&window=` serves the rings as JSON series and the
  `/statusz` sparkline panel renders them inline (`render_sparklines`);
- `SLOEvaluator` stores its per-spec verdict samples in `Ring`s from this
  module (same time-pruned window semantics as its former private deques —
  burn-rate verdicts are behavior-identical, pinned by tests/test_slo.py);
- postmortem capsules (`utils/capsule.py`) embed `HISTORY.export()` so a
  `NonFiniteError` or SLO breach carries the minutes leading up to it.

Bounds: `depth` samples per series (default 256) and `label_cap` series per
metric name (default 32) — a runaway label dimension costs one counter
increment (`history.dropped_series`), never unbounded memory. The oelint
metrics pass rejects unregistered label keys at observe() sites for the
same reason (ring x label-set blowup is a lint error, not a pager).

Everything here is host-side Python off the step path: sampling reads the
same locked snapshots `report()` uses, and nothing touches jit — compiled
HLO is byte-identical with history on or off.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import metrics

# ring value for a hist-kind accumulator: a dict of derived stats (the same
# numbers report() exposes) — everything else stores the scalar value()
HIST_FIELDS = ("mean", "p50", "p95", "p99", "count")

SPARK_CHARS = " ▁▂▃▄▅▆▇█"


class Ring:
    """A bounded ring of `(ts, value)` samples.

    The one primitive shared by the metric recorder and the SLO evaluator:
    `append` evicts from the head at `maxlen` (depth bound), `prune_older`
    reproduces the evaluator's time-window semantics (drop samples older
    than a cutoff while MORE than `keep` remain — the latest sample always
    survives so a stale-but-only sample still gets judged)."""

    def __init__(self, maxlen: int):
        self._data: deque = deque(maxlen=max(1, int(maxlen)))
        self._lock = threading.Lock()

    def append(self, ts: float, value: Any) -> None:
        with self._lock:
            self._data.append((float(ts), value))

    def items(self) -> List[Tuple[float, Any]]:
        with self._lock:
            return list(self._data)

    def prune_older(self, cutoff: float, keep: int = 1) -> None:
        with self._lock:
            while len(self._data) > keep and self._data[0][0] < cutoff:
                self._data.popleft()

    def window(self, now: float, window_s: float) -> List[Tuple[float, Any]]:
        cut = now - window_s
        return [(ts, v) for ts, v in self.items() if ts >= cut]

    def last(self) -> Optional[Tuple[float, Any]]:
        with self._lock:
            return self._data[-1] if self._data else None

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


def _sample_value(acc: "metrics.Accumulator") -> Any:
    if acc.kind == "hist":
        snap = acc.hist_snapshot()
        count = snap[2]
        out = {"mean": snap[1] / count if count else 0.0, "count": count}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = metrics.snapshot_quantile(snap, q) if count else 0.0
        return out
    return acc.value()


def scalar(value: Any, field: str = "p99") -> float:
    """One plottable float from a ring value (hist dicts pick `field`)."""
    if isinstance(value, dict):
        return float(value.get(field, value.get("mean", 0.0)))
    return float(value)


class MetricHistory:
    """The registry-wide recorder: one `Ring` per live accumulator series."""

    def __init__(self, depth: int = 256, label_cap: int = 32):
        self.depth = depth
        self.label_cap = label_cap
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._series: Dict[str, Dict[str, Any]] = {}  # key -> {ring, ...}
        self._per_name: Dict[str, int] = {}           # name -> series count
        self._capped: set = set()                     # names past label_cap

    def configure(self, depth: Optional[int] = None,
                  label_cap: Optional[int] = None) -> None:
        """New bounds apply to series created after the call (existing rings
        keep their depth — resizing mid-flight would drop evidence)."""
        with self._lock:
            if depth is not None:
                self.depth = int(depth)
            if label_cap is not None:
                self.label_cap = int(label_cap)

    def _entry(self, acc: "metrics.Accumulator") -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._series.get(acc.key)
            if e is not None:
                return e
            n = self._per_name.get(acc.name, 0)
            if n >= self.label_cap:
                self._capped.add(acc.name)
                return None
            self._per_name[acc.name] = n + 1
            e = self._series[acc.key] = {
                "metric": acc.name, "labels": dict(acc.labels),
                "kind": acc.kind, "ring": Ring(self.depth)}
            return e

    def sample_registry(self, ts: Optional[float] = None) -> int:
        """One sample of every live accumulator into its ring (called by
        `PeriodicReporter` each tick, before the windowed reset). Returns
        the number of series sampled; label-capped series count into the
        `history.dropped_series` counter instead."""
        now = time.time() if ts is None else float(ts)
        with metrics._LOCK:
            accs = list(metrics._REGISTRY.values())
        sampled = dropped = 0
        for acc in accs:
            e = self._entry(acc)
            if e is None:
                dropped += 1
                continue
            e["ring"].append(now, _sample_value(acc))
            sampled += 1
        if dropped:
            metrics.observe("history.dropped_series", float(dropped))
        return sampled

    def ring(self, name: str, labels: Optional[Dict[str, str]] = None,
             kind: str = "gauge", depth: Optional[int] = None) -> Ring:
        """The ring for one explicit series, created on demand — how the
        SLO evaluator stores its per-spec verdict samples (these rings are
        registry-independent: `sample_registry` never writes to them).
        `depth` overrides the recorder default for series whose consumer
        needs a deeper window than the sparkline depth."""
        key = name + metrics._label_key(labels)
        with self._lock:
            e = self._series.get(key)
            if e is None:
                e = self._series[key] = {
                    "metric": name, "labels": dict(labels or {}),
                    "kind": kind,
                    "ring": Ring(depth if depth else self.depth)}
                self._per_name[name] = self._per_name.get(name, 0) + 1
            return e["ring"]

    def drop(self, name: str, labels: Optional[Dict[str, str]] = None
             ) -> None:
        """Forget one series entirely (ring included) — `SLOEvaluator.
        configure` drops the verdict rings of removed specs so a re-added
        spec starts from fresh evidence, exactly like the old deques."""
        key = name + metrics._label_key(labels)
        with self._lock:
            e = self._series.pop(key, None)
            if e is not None:
                n = self._per_name.get(e["metric"], 1) - 1
                if n <= 0:
                    self._per_name.pop(e["metric"], None)
                else:
                    self._per_name[e["metric"]] = n

    def query(self, metric: str, window_s: Optional[float] = None,
              labels: Optional[Dict[str, str]] = None,
              now: Optional[float] = None) -> List[Dict[str, Any]]:
        """All series of `metric` (optionally label-filtered) as
        `{"metric", "labels", "kind", "points": [[ts, value], ...]}`."""
        now = time.time() if now is None else float(now)
        with self._lock:
            entries = [dict(e) for e in self._series.values()
                       if e["metric"] == metric]
        out = []
        for e in entries:
            if labels and any(e["labels"].get(k) != v
                              for k, v in labels.items()):
                continue
            ring: Ring = e["ring"]
            pts = (ring.window(now, window_s) if window_s
                   else ring.items())
            out.append({"metric": e["metric"], "labels": e["labels"],
                        "kind": e["kind"],
                        "points": [[ts, v] for ts, v in pts]})
        return sorted(out, key=lambda s: sorted(s["labels"].items()))

    def names(self) -> List[str]:
        with self._lock:
            return sorted({e["metric"] for e in self._series.values()})

    def export(self) -> Dict[str, Any]:
        """Full dump for capsules: every series, every retained sample."""
        with self._lock:
            entries = list(self._series.items())
        return {key: {"metric": e["metric"], "labels": e["labels"],
                      "kind": e["kind"],
                      "points": [[ts, v] for ts, v in e["ring"].items()]}
                for key, e in entries}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._per_name.clear()
            self._capped.clear()


HISTORY = MetricHistory()


def sparkline(values: List[float], width: int = 40) -> str:
    """ASCII sparkline of the last `width` values (shared y-scale per line)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK_CHARS[1] * len(vals)
    top = len(SPARK_CHARS) - 1
    return "".join(
        SPARK_CHARS[1 + int((v - lo) / span * (top - 1) + 0.5)]
        for v in vals)


def render_sparklines(metric_names: Optional[List[str]] = None,
                      width: int = 40, limit: int = 12) -> str:
    """The `/statusz` history panel: one sparkline per series (hist series
    plot p99). With no explicit list, shows every recorded metric name up
    to `limit` series."""
    names = metric_names if metric_names is not None else HISTORY.names()
    lines: List[str] = []
    for name in names:
        for s in HISTORY.query(name):
            if len(lines) >= limit:
                lines.append(f"... ({len(names)} metrics recorded; "
                             "query /historz?metric=<name>)")
                return "\n".join(lines)
            pts = s["points"]
            if not pts:
                continue
            vals = [scalar(v) for _ts, v in pts]
            lab = metrics._label_key(s["labels"])
            lines.append(f"{s['metric']}{lab:<24.24} "
                         f"{sparkline(vals, width):<{width}} "
                         f"last={vals[-1]:.4g} n={len(vals)}")
    return "\n".join(lines) if lines else "(no history yet)"
