"""The port's copy of `openembedding_tpu/utils/metrics.py`: the same
registry, names, Prometheus text and JSONL records; `record_step_stats`
reads a dict of torch tensors in one device-to-host copy.

Metrics: accumulators, histograms, scope timers, periodic reports,
Prometheus exposition.

Reference parity (SURVEY.md §5 tracing/profiling):
- `Accumulator<SumAggregator>` counters like `pull_indices`/`pull_unique` gated by
  evaluate-performance mode (`EmbeddingPullOperator.cpp:207-252`) -> `Accumulator`
  registry (sum/avg/max/gauge/hist aggregations, thread-safe, always on — negligible
  cost in Python; the per-step device counters ride the jitted step's stats dict
  instead).
- `VTIMER(1, group, name, ms)` scope timers at hot stages
  (`EmbeddingVariableHandle.cpp:107,140`) -> `vtimer(group, name)` context manager,
  now backed by `kind="hist"` latency histograms (p50/p95/p99 instead of avg-only)
  and recorded into the flight recorder (`utils/trace.py` — vtimer IS a span).
- periodic cluster-wide accumulator table when `server.report_interval > 0`
  (`client/WorkerContext.cpp:24-41,140-163`) -> `PeriodicReporter` thread.
- standalone server's Prometheus exposer flags (`entry/server.cc:7-12,35-36`) ->
  `prometheus_text()` (text exposition format, served at /metrics by `serving.py`).

Beyond the reference: metric LABELS (`observe(name, v, labels={"table": ...})` ->
`oetpu_pull_ms{table="user"}`) so per-table skew is visible, and `kind="hist"`
fixed log-spaced-bucket histograms exposing p50/p95/p99 in `report()` and proper
`_bucket`/`_sum`/`_count` series in `prometheus_text()`.

Naming scheme (enforced by `make lint-metrics` / tools/lint_metrics.py): metric
names are dot-joined lowercase `group.name[.qualifier]` segments of
`[a-z0-9_]+` — e.g. `serving.predict.ms`, `sync.rollbacks`,
`exchange.wire_bytes_per_step`. Per-instance dimensions (table, model) go in
labels, never in the name.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Accumulator"] = {}

KINDS = ("sum", "avg", "max", "gauge", "hist")

# log-spaced histogram bucket upper bounds (le semantics): sqrt(2) steps from
# 1e-3 up to ~1.9e5 — 56 buckets covering sub-us timer ticks to minutes-long
# persist writes at <= ~20% worst-case quantile error before interpolation
HIST_BOUNDS: Tuple[float, ...] = tuple(
    1e-3 * (2.0 ** 0.5) ** i for i in range(56))


def _label_key(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class Accumulator:
    """A named metric. kind: "sum" (counter), "avg" (mean of observations),
    "max" (high-water mark), "gauge" (last value), "hist" (log-spaced-bucket
    latency/size histogram with p50/p95/p99). `labels` distinguishes series
    of one metric (per-table, per-model)."""

    def __init__(self, name: str, kind: str = "sum", help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        if kind not in KINDS:
            raise ValueError(f"bad accumulator kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.key = name + _label_key(labels)
        self._lock = threading.Lock()
        self._total = 0.0                      # guarded-by: self._lock
        self._count = 0                        # guarded-by: self._lock
        self._max = float("-inf")              # guarded-by: self._lock
        self._min = float("inf")               # guarded-by: self._lock
        # guarded-by: self._lock
        self._buckets: List[int] = ([0] * (len(HIST_BOUNDS) + 1)
                                    if kind == "hist" else [])

    @classmethod
    def get(cls, name: str, kind: str = "sum", help: str = "",
            labels: Optional[Dict[str, str]] = None) -> "Accumulator":
        key = name + _label_key(labels)
        with _LOCK:
            acc = _REGISTRY.get(key)
            if acc is None:
                # one name must aggregate ONE way across all its label sets —
                # two call sites registering different kinds would otherwise
                # silently aggregate with whichever ran first
                for other in _REGISTRY.values():
                    if other.name == name and other.kind != kind:
                        raise ValueError(
                            f"metric {name!r} already registered with kind "
                            f"{other.kind!r}, requested {kind!r}")
                acc = _REGISTRY[key] = cls(name, kind, help, labels)
            elif acc.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered with kind "
                    f"{acc.kind!r}, requested {kind!r}")
            return acc

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            if self.kind == "gauge":
                self._total = value
                self._count = 1
            else:
                self._total += value
                self._count += 1
            if self.kind == "hist":
                self._buckets[bisect.bisect_left(HIST_BOUNDS, value)] += 1
            if value > self._max:
                self._max = value
            if value < self._min:
                self._min = value

    def value(self) -> float:
        with self._lock:
            if self.kind in ("avg", "hist"):
                return self._total / self._count if self._count else 0.0
            if self.kind == "max":
                return self._max if self._count else 0.0
            return self._total

    def quantile(self, q: float) -> float:
        """Histogram quantile by linear interpolation inside the owning
        bucket, clamped to the observed min/max (tightens narrow
        distributions that land in few buckets)."""
        if self.kind != "hist":
            raise ValueError(f"metric {self.name!r} ({self.kind}) has no "
                             "quantiles; use kind='hist'")
        return snapshot_quantile(self.hist_snapshot(), q)

    def hist_snapshot(self) -> Tuple[List[int], float, int, float, float]:
        """-> (per-bucket counts incl. overflow, sum, count, min, max) under
        ONE lock acquisition — the consistent view `report()` and
        `prometheus_text()` derive mean AND quantiles from (separate
        value()/quantile() reads under load could pair a newer count with an
        older bucket array)."""
        with self._lock:
            return (list(self._buckets), self._total, self._count,
                    self._min, self._max)

    @property
    def count(self) -> int:
        return self._count

    def reset(self) -> None:
        with self._lock:
            self._total = 0.0
            self._count = 0
            self._max = float("-inf")
            self._min = float("inf")
            if self.kind == "hist":
                self._buckets = [0] * (len(HIST_BOUNDS) + 1)


def snapshot_quantile(snapshot, q: float) -> float:
    """Quantile from one `hist_snapshot()` (buckets, sum, count, min, max)
    by linear interpolation inside the owning bucket, clamped to the
    observed min/max."""
    buckets, _total, n, vmin, vmax = snapshot
    if n == 0:
        return 0.0
    target = q * n
    cum = 0.0
    for i, c in enumerate(buckets):
        if c == 0:
            continue
        if cum + c >= target:
            lo = HIST_BOUNDS[i - 1] if i > 0 else 0.0
            hi = HIST_BOUNDS[i] if i < len(HIST_BOUNDS) else vmax
            lo = max(lo, vmin)
            hi = min(hi, vmax)
            if hi < lo:
                hi = lo
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return vmax


def observe(name: str, value: float, kind: str = "sum",
            labels: Optional[Dict[str, str]] = None) -> None:
    Accumulator.get(name, kind, labels=labels).observe(value)


@contextmanager
def vtimer(group: str, name: str):
    """Scope timer (reference VTIMER semantics: `VTIMER(1, group, name, ms)`
    wraps the hot operator stages). Now a full trace span: records into the
    `{group}.{name}.ms` histogram (p50/p95/p99 on /metrics), the `.max_ms`
    high-water mark, and the flight recorder (`utils/trace.py`)."""
    from . import trace  # lazy: trace imports metrics at module level
    with trace.span(group, name):
        yield


def observe_exchange_cost(cost: Dict[str, "object"]) -> None:
    """Publish the sharded exchange's static wire-cost model
    (`ops/wire.exchange_cost`, computed at trace time by
    `MeshTrainer._observe_wire_cost`) as gauges: how many collectives the
    step launches and how many bytes one device ships through them — the
    counters the fused/quantized wire work is measured by."""
    observe("exchange.collectives_per_step",
            float(cost.get("collectives_per_step", 0)), "gauge")
    observe("exchange.wire_bytes_per_step",
            float(cost.get("bytes_per_step", 0)), "gauge")
    observe("exchange.dim_groups", float(cost.get("dim_groups", 0)), "gauge")


class NonFiniteError(RuntimeError):
    """Raised by `Trainer(halt_on_nonfinite=True)` when the numerics sentinel
    sees a non-finite loss or gradient. `sources` maps the offending
    phase/table name ("loss", "dense", or a table name) to the non-finite
    element count the sentinel observed that step."""

    def __init__(self, sources: Dict[str, float]):
        self.sources = dict(sources)
        names = ", ".join(f"{k} ({int(v)} non-finite value(s))"
                          for k, v in sorted(self.sources.items()))
        super().__init__(
            f"non-finite values detected in: {names} — see the health.* "
            "gauges and the flight recorder's health/nonfinite event")


# per-table sentinel stats from `Trainer._sentinel_stats` (additive across
# shards; folded to health.* gauges below, never to trainer.* counters —
# summing sumsq across steps would be meaningless)
_HEALTH_TABLE_STATS = ("grad_sumsq", "grad_nonfinite", "ef_abs_sum",
                       "ef_elems", "quant_err_sumsq")
# global sentinel stats, shipped under the reserved `health/` var
_HEALTH_GLOBAL_STATS = ("loss_nonfinite", "dense_grad_sumsq",
                        "dense_grad_nonfinite")


# oelint: hot-path -- the documented ONE-device_get-per-step call site; the
# host-sync pass budget (1) makes a second get here fail `make lint`
def record_step_stats(stats: Dict[str, "object"]) -> Dict[str, "object"]:
    """Fold a train step's device-side stats dict (`{var}/pull_indices`, `.../
    pull_unique`, `.../pull_overflow`, ...) into host accumulators.

    ONE device-to-host copy of the whole dict (`_host_values`: every
    tensor flattened to float64 and concatenated on its device, then one
    `.cpu()`) — per-key `float()` on device tensors would force one host
    sync per stat on the hot path. Accepts torch tensors, numpy values, and
    plain floats interchangeably. Per-table stats
    (`{var}/{stat}` keys) additionally publish as LABELED counters
    (`oetpu_trainer_pull_indices_total{table="user"}`) so per-table skew
    reads straight off /metrics.

    VECTOR stats are the per-shard load accounting from the jitted exchange
    (`parallel/sharded.exchange_load_stats`): a `{var}/{stat}` key holding an
    (S,) array folds into per-shard labeled gauges
    (`exchange.shard_rows{table=,shard=}`), `shard_positions` additionally
    derives the `exchange.shard_imbalance{table=}` histogram (max/mean over
    shards — Parallax's access-skew number), and
    `pull_unique`/`pull_indices` derive `exchange.unique_ratio{table=}`.

    Hot-row replication stats (`{var}/hot_hits` / `hot_unique` /
    `hot_bytes_saved`, present when `MeshTrainer(hot_rows=...)` is on) derive
    `hot.hit_ratio{table=}` (positions served from the replicated cache /
    positions pulled) and `hot.bytes_saved{table=}` in the SAME device_get —
    no second host sync — and as gauges they survive `report(reset=True)`
    like the other exchange.* gauges.

    Numerics-sentinel stats (`Trainer(sentinel=True)`) fold to `health.*`
    gauges in the same device_get: per-table `health.grad_norm` (sqrt of the
    psum'd sumsq), `health.grad_nonfinite`, `health.ef_abs_mean`,
    `health.quant_err_rel` (relative wire-quantization error), plus
    `health.dense_grad_norm` and the `health.nonfinite_total` counter. Returns
    a health summary dict — `{"sentinel": bool, "nonfinite": {source: count},
    "grad_norm": {source: norm}}` — that `Trainer.record_step_stats` turns
    into `NonFiniteError` under `halt_on_nonfinite`; any non-finite sighting
    also leaves a `health/nonfinite` flight-recorder event."""
    import numpy as np
    stats = _host_values(stats)
    per_table: Dict[str, Dict[str, float]] = {}
    health_raw: Dict[str, float] = {}
    for key, value in stats.items():
        var, sep, stat = key.partition("/")
        table_stat = sep and "/" not in stat
        try:
            if np.ndim(value) >= 1:
                if table_stat and stat in _SHARD_STATS:
                    _fold_shard_stat(var, stat,
                                     np.asarray(value, np.float64).reshape(-1))
                    continue
                if np.size(value) > 1:
                    continue  # unknown vector stat: nothing sane to fold
            v = float(value)
        except (TypeError, ValueError):
            continue
        if var == "health" and table_stat and stat in _HEALTH_GLOBAL_STATS:
            health_raw[stat] = v
            continue
        if table_stat and stat in _HEALTH_TABLE_STATS:
            per_table.setdefault(var, {})[stat] = v
            continue
        if key == "dense/grad_density":
            # MEAN replica density (emitted pre-divided by S, psum'd to the
            # mean): a level, not a count — publish as the gauge the sparse
            # dense-wire policy reads, never the additive counter fold
            observe("dense.grad_density", v, "gauge")
            continue
        observe(key.replace("/", "."), v)
        if table_stat:
            observe(f"trainer.{stat}", v, "sum", labels={"table": var})
            per_table.setdefault(var, {})[stat] = v
    for var, d in per_table.items():
        if d.get("pull_indices"):
            observe("exchange.unique_ratio",
                    d.get("pull_unique", 0.0) / d["pull_indices"], "gauge",
                    labels={"table": var})
            if "hot_hits" in d:
                observe("hot.hit_ratio", d["hot_hits"] / d["pull_indices"],
                        "gauge", labels={"table": var})
            if "mig_hits" in d:
                # share of pulled positions the migration directory re-homed
                # (cold-tail re-sharding; `parallel/sharded._mig_pull_stats`)
                observe("placement.moved_ratio",
                        d["mig_hits"] / d["pull_indices"], "gauge",
                        labels={"table": var})
        if "hot_bytes_saved" in d:
            observe("hot.bytes_saved", d["hot_bytes_saved"], "gauge",
                    labels={"table": var})
    return _fold_health(per_table, health_raw)


def _host_values(stats: Dict[str, "object"]) -> Dict[str, "object"]:
    """`stats` with every torch tensor replaced by a float64 numpy array of
    its shape: ONE `torch.cat` per device of every tensor flattened to
    float64 (NaN and inf survive), then one copy to the host. Other values
    pass through."""
    import torch
    out = dict(stats)
    by_device: Dict[object, List[str]] = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(k)
    for keys in by_device.values():
        flat = torch.cat([out[k].detach().reshape(-1).to(torch.float64)
                          for k in keys]).cpu().numpy()
        at = 0
        for k in keys:
            shape = tuple(out[k].shape)
            n = out[k].numel()
            out[k] = flat[at:at + n].reshape(shape)
            at += n
    return out


def _fold_health(per_table: Dict[str, Dict[str, float]],
                 health_raw: Dict[str, float]) -> Dict[str, "object"]:
    """Sentinel stats -> health.* gauges + the returned health summary.
    sqrt happens HERE, after the cross-shard psum of the additive sumsq
    stats, so the gauges are true global norms."""
    health: Dict[str, "object"] = {"sentinel": False, "nonfinite": {},
                                   "grad_norm": {}}
    total_nf = 0.0
    for var, d in per_table.items():
        if not any(s in d for s in _HEALTH_TABLE_STATS):
            continue
        health["sentinel"] = True
        if "grad_sumsq" in d:
            gn = max(d["grad_sumsq"], 0.0) ** 0.5
            observe("health.grad_norm", gn, "gauge", labels={"table": var})
            health["grad_norm"][var] = gn
        if "grad_nonfinite" in d:
            nf = d["grad_nonfinite"]
            observe("health.grad_nonfinite", nf, "gauge",
                    labels={"table": var})
            if nf:
                total_nf += nf
                health["nonfinite"][var] = nf
        if d.get("ef_elems"):
            observe("health.ef_abs_mean",
                    d.get("ef_abs_sum", 0.0) / d["ef_elems"], "gauge",
                    labels={"table": var})
        if "quant_err_sumsq" in d and d.get("grad_sumsq"):
            rel = (max(d["quant_err_sumsq"], 0.0) / d["grad_sumsq"]) ** 0.5
            observe("health.quant_err_rel", rel, "gauge",
                    labels={"table": var})
    if health_raw:
        health["sentinel"] = True
        if "dense_grad_sumsq" in health_raw:
            dg = max(health_raw["dense_grad_sumsq"], 0.0) ** 0.5
            observe("health.dense_grad_norm", dg, "gauge")
            health["grad_norm"]["dense"] = dg
        dn = health_raw.get("dense_grad_nonfinite", 0.0)
        observe("health.dense_grad_nonfinite", dn, "gauge")
        if dn:
            total_nf += dn
            health["nonfinite"]["dense"] = dn
        ln = health_raw.get("loss_nonfinite", 0.0)
        if ln:
            total_nf += ln
            health["nonfinite"]["loss"] = ln
    if health["sentinel"]:
        # observed EVERY sentinel step (0 included) so the numerics SLO has a
        # judged metric on clean runs instead of verdict UNKNOWN
        observe("health.nonfinite_total", total_nf)
        if total_nf:
            from . import trace  # lazy: trace imports metrics at module level
            trace.event("health", "nonfinite",
                        **{k: float(v)
                           for k, v in health["nonfinite"].items()})
    return health


# per-shard vector stats emitted by `parallel/sharded.exchange_load_stats`
_SHARD_STATS = ("shard_rows", "shard_positions", "bucket_fill")


def _fold_shard_stat(var: str, stat: str, vec) -> None:
    """One per-shard vector stat -> labeled gauges + derived imbalance.
    `shard_rows`/`shard_positions` index by DESTINATION shard (who serves),
    `bucket_fill` by SOURCE shard (whose outgoing a2a bucket is fullest) —
    see `parallel/sharded.exchange_load_stats`."""
    for i, v in enumerate(vec):
        observe(f"exchange.{stat}", float(v), "gauge",
                labels={"table": var, "shard": str(i)})
    if stat == "shard_positions":
        mean = float(vec.mean())
        if mean > 0:
            observe("exchange.shard_imbalance", float(vec.max()) / mean,
                    "hist", labels={"table": var})


def report(reset: bool = False) -> Dict[str, float]:
    """{metric key: value}; histograms add `.p50`/`.p95`/`.p99` keys beside
    their mean. `reset=True` zeroes windowed kinds (sum/avg/max) but SKIPS
    gauges (one-shot values like `exchange.*` wire costs would vanish from
    /metrics after the first periodic report) and histograms (Prometheus
    histogram series are cumulative by contract)."""
    with _LOCK:
        accs = list(_REGISTRY.values())
    out: Dict[str, float] = {}
    for a in accs:
        if a.kind == "hist":
            # ONE snapshot per accumulator: mean and quantiles derive from
            # the same locked view, so a report taken under load can never
            # show quantiles inconsistent with count/sum
            snap = a.hist_snapshot()
            count = snap[2]
            out[a.key] = snap[1] / count if count else 0.0
            if count:
                for q, suffix in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    out[f"{a.key}.{suffix}"] = snapshot_quantile(snap, q)
        else:
            out[a.key] = a.value()
    if reset:
        for a in accs:
            if a.kind not in ("gauge", "hist"):
                a.reset()
    return out


def _format_table(vals: Dict[str, float]) -> str:
    if not vals:
        return "(no metrics)"
    width = max(len(k) for k in vals)
    lines = [f"{k.ljust(width)}  {v:,.3f}" for k, v in sorted(vals.items())]
    return "\n".join(lines)


def report_table(reset: bool = False) -> str:
    """The reference's periodic accumulator table (`WorkerContext.cpp:140-163`)."""
    return _format_table(report(reset=reset))


def reset_all() -> None:
    """Hard reset of EVERY accumulator, gauges and histograms included
    (test/bench isolation — the periodic-report path uses `report(reset=True)`
    which preserves them)."""
    with _LOCK:
        accs = list(_REGISTRY.values())
    for a in accs:
        a.reset()


_SANE = str.maketrans({c: "_" for c in ".-/ "})


def _esc(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                                    "\\n")


def _labels_text(labels: Dict[str, str],
                 extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(k, labels[k]) for k in sorted(labels)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in pairs) + "}"


def _fmt_bound(b: float) -> str:
    return f"{b:.6g}"


def prometheus_text() -> str:
    """Prometheus text exposition (0.0.4) of every accumulator.

    Conformance: counters carry the `_total` suffix; label values are
    escaped; avg/max kinds emit a single well-typed gauge series; hist kinds
    emit cumulative `_bucket{le=...}` (empty interior buckets elided — le
    boundaries stay monotone), `_sum` and `_count` series."""
    lines: List[str] = []
    with _LOCK:
        accs = sorted(_REGISTRY.values(), key=lambda a: (a.name, a.key))
    seen = set()
    for a in accs:
        base = "oetpu_" + a.name.translate(_SANE)
        family = base + ("_total" if a.kind == "sum" else "")
        ptype = {"sum": "counter", "avg": "gauge", "max": "gauge",
                 "gauge": "gauge", "hist": "histogram"}[a.kind]
        if family not in seen:
            seen.add(family)
            if a.help:
                lines.append(f"# HELP {family} {a.help}")
            lines.append(f"# TYPE {family} {ptype}")
        if a.kind == "hist":
            buckets, total, count, _mn, _mx = a.hist_snapshot()
            cum = 0
            for i, c in enumerate(buckets[:-1]):
                if c == 0:
                    continue
                cum += c
                le = _fmt_bound(HIST_BOUNDS[i])
                lines.append(f"{base}_bucket"
                             f"{_labels_text(a.labels, ('le', le))} {cum}")
            lines.append(f"{base}_bucket"
                         f"{_labels_text(a.labels, ('le', '+Inf'))} {count}")
            lines.append(f"{base}_sum{_labels_text(a.labels)} {total}")
            lines.append(f"{base}_count{_labels_text(a.labels)} {count}")
        else:
            lines.append(f"{family}{_labels_text(a.labels)} {a.value()}")
    return "\n".join(lines) + "\n"


class PeriodicReporter:
    """Background thread printing the accumulator table every `interval` seconds
    (enabled when interval > 0, like the reference's `server.report_interval`).
    `reset=True` resets windowed kinds between reports; gauges and histograms
    are preserved (see `report`).

    `jsonl_path` additionally appends each report as one timestamped JSONL
    record (`{"ts": ..., "metrics": {...}}`) for offline analysis; `stop()`
    flushes a final record so short runs (or interval=0 runs that never tick)
    still leave data behind. `jsonl_max_bytes` rotates the log when the next
    record would push it past the bound (`path` -> `path.1` -> ... up to
    `jsonl_keep` rotated files, oldest dropped) so soak-length runs cannot
    fill the disk.

    Each tick also samples every accumulator into the history rings
    (`utils/history.HISTORY`) BEFORE the windowed reset — the rings see the
    same values the report prints (`history=False` opts out)."""

    def __init__(self, interval: float, sink: Optional[Callable[[str], None]] = None,
                 reset: bool = True, jsonl_path: Optional[str] = None,
                 jsonl_max_bytes: int = 0, jsonl_keep: int = 3,
                 history: bool = True):
        self.interval = interval
        self.sink = sink or (lambda s: print(s, flush=True))
        self.reset = reset
        self.jsonl_path = jsonl_path
        self.jsonl_max_bytes = int(jsonl_max_bytes)
        self.jsonl_keep = max(1, int(jsonl_keep))
        self.history = history
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PeriodicReporter":
        if self.interval <= 0:
            return self
        # idempotent under racing start()s (e.g. context manager + explicit
        # call): exactly one reporter thread, never a leaked duplicate
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()
        return self

    def _write_jsonl(self, vals: Dict[str, float]) -> None:
        import json
        line = json.dumps({"ts": time.time(), "metrics": vals},
                          sort_keys=True) + "\n"
        if self.jsonl_max_bytes > 0:
            self._maybe_rotate(len(line))
        with open(self.jsonl_path, "a") as f:
            f.write(line)

    def _maybe_rotate(self, incoming: int) -> None:
        """path -> path.1 -> ... -> path.{keep}; only when the NEXT record
        would cross the bound, so every rotated file is <= jsonl_max_bytes
        and a record never splits across files."""
        import os
        try:
            size = os.path.getsize(self.jsonl_path)
        except OSError:
            return
        if size + incoming <= self.jsonl_max_bytes:
            return
        for i in range(self.jsonl_keep, 0, -1):
            src = self.jsonl_path if i == 1 else f"{self.jsonl_path}.{i - 1}"
            dst = f"{self.jsonl_path}.{i}"
            try:
                if i == self.jsonl_keep and os.path.exists(dst):
                    os.remove(dst)
                if os.path.exists(src):
                    os.replace(src, dst)
            except OSError:
                observe("metrics.report_errors", 1)
                return

    def _tick(self) -> None:
        if self.history:
            from . import history as _history  # lazy: history imports metrics
            _history.HISTORY.sample_registry()
        vals = report(reset=self.reset)
        if self.jsonl_path:
            self._write_jsonl(vals)
        self.sink("== accumulator report ==\n" + _format_table(vals))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — a broken pipe/sink must not
                # kill periodic reporting for the rest of the run
                observe("metrics.report_errors", 1)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:  # join outside the lock (_run never takes it)
            t.join(timeout=5)
        if self.jsonl_path:
            try:  # final flush (no reset: just a snapshot on the way out)
                self._write_jsonl(report(reset=False))
            except Exception:  # noqa: BLE001 — same contract as _run
                observe("metrics.report_errors", 1)

    def __enter__(self) -> "PeriodicReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Fleet aggregation: parse + merge Prometheus text scrapes from N nodes into
# one exposition (`GET /fleetz` on any serving node, tools/metrics_fleet.py).
# Every node's /metrics is otherwise an island; one trainer + N replicas
# should answer "is the whole fleet healthy" from ONE endpoint.
# ---------------------------------------------------------------------------

_SAMPLE_RE = None  # compiled lazily (re import kept local below)


def parse_prometheus(text: str) -> Dict[str, "object"]:
    """Parse a Prometheus text-exposition scrape.

    -> {"types": {family: type}, "help": {family: text},
        "samples": [(name, {label: raw_value}, float), ...]} in input order.
    Label values keep their ESCAPED form (the merger re-emits them
    verbatim); timestamps are not supported (we never emit them)."""
    import re
    global _SAMPLE_RE
    if _SAMPLE_RE is None:
        _SAMPLE_RE = (
            re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)"
                       r"(?:\{(.*)\})?\s+([^\s]+)\s*$"),
            re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"'))
    sample_re, label_re = _SAMPLE_RE
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = sample_re.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(label_re.findall(raw_labels)) if raw_labels else {}
        samples.append((name, labels, value))
    return {"types": types, "help": helps, "samples": samples}


def _series_family(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """-> (family, type) for one sample name. Histogram children
    (`_bucket`/`_sum`/`_count`) resolve to their base family."""
    if name in types:
        return name, types[name]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[:-len(suffix)]
            if types.get(base) == "histogram":
                return base, "histogram"
    # untyped: infer counters by convention so foreign scrapes still merge
    if name.endswith("_total"):
        return name, "counter"
    return name, "untyped"


def merge_prometheus(scrapes) -> str:
    """Merge N Prometheus text scrapes into one fleet exposition.

    `scrapes`: [(instance, text), ...] (or bare texts, numbered). Merge
    rules: counters and histogram series SUM across instances per label set
    (histogram `_bucket` series are de-cumulated per instance, summed on the
    union `le` grid, and re-cumulated — nodes may elide different empty
    buckets); gauges/untyped keep per-instance series (an `instance` label
    is added; the last write wins per (labels, instance), so re-merging a
    merged scrape is stable). The fleet `_count` of every histogram equals
    the sum of the parts' `_count` — the invariant tests pin."""
    pairs = [s if isinstance(s, tuple) else (f"node{i}", s)
             for i, s in enumerate(scrapes)]
    parsed = [(inst, parse_prometheus(text)) for inst, text in pairs]
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for _inst, p in parsed:
        for k, v in p["types"].items():
            types.setdefault(k, v)
        for k, v in p["help"].items():
            helps.setdefault(k, v)

    def lkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted(labels.items()))

    sums: Dict[Tuple, float] = {}
    gauges: Dict[Tuple, float] = {}
    # (family, labels-without-le) -> {instance: {le_string: cum_value}}
    hists: Dict[Tuple, Dict[str, Dict[str, float]]] = {}
    order: List[Tuple[str, Tuple]] = []  # first-seen emit order
    order_seen = set()

    def seen(kind: str, key: Tuple) -> None:
        tag = (kind, key)
        if tag not in order_seen:
            order_seen.add(tag)
            order.append(tag)

    for inst, p in parsed:
        for name, labels, value in p["samples"]:
            family, ptype = _series_family(name, p["types"] or types)
            if ptype == "histogram" and name.endswith("_bucket"):
                base = dict(labels)
                le = base.pop("le", "+Inf")
                key = (family, name, lkey(base))
                hists.setdefault(key, {}).setdefault(inst, {})[le] = value
                seen("hist", key)
            elif ptype in ("counter", "histogram"):
                key = (name, lkey(labels))
                sums[key] = sums.get(key, 0.0) + value
                seen("sum", key)
            else:
                labeled = dict(labels)
                labeled["instance"] = _esc(inst)
                key = (name, lkey(labeled))
                gauges[key] = value
                seen("gauge", key)

    def fmt_labels(items: Tuple[Tuple[str, str], ...]) -> str:
        if not items:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"

    lines: List[str] = []
    emitted_family = set()

    def family_header(name: str) -> None:
        family, ptype = _series_family(name, types)
        if family in emitted_family:
            return
        emitted_family.add(family)
        if family in helps:
            lines.append(f"# HELP {family} {helps[family]}")
        if ptype != "untyped":
            lines.append(f"# TYPE {family} {ptype}")

    done_hist = set()
    for kind, key in order:
        if kind == "hist":
            if key in done_hist:
                continue
            done_hist.add(key)
            family, name, base_items = key
            family_header(name)
            # de-cumulate each instance on its own le grid, sum increments
            # on the union grid, re-cumulate ascending
            def le_sort(le: str) -> float:
                return float("inf") if le in ("+Inf", "inf") else float(le)
            incr: Dict[str, float] = {}
            for inst_series in hists[key].values():
                les = sorted(inst_series, key=le_sort)
                prev = 0.0
                for le in les:
                    incr[le] = incr.get(le, 0.0) + (inst_series[le] - prev)
                    prev = inst_series[le]
            cum = 0.0
            for le in sorted(incr, key=le_sort):
                cum += incr[le]
                items = base_items + (("le", le),)
                items = tuple(sorted(items))
                lines.append(f"{name}{fmt_labels(items)} {_fmt_num(cum)}")
        elif kind == "sum":
            name, items = key
            if key not in sums:
                continue
            family_header(name)
            lines.append(f"{name}{fmt_labels(items)} {_fmt_num(sums[key])}")
        else:
            name, items = key
            if key not in gauges:
                continue
            family_header(name)
            lines.append(f"{name}{fmt_labels(items)} {_fmt_num(gauges[key])}")
    return "\n".join(lines) + "\n"


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def auc(labels, scores) -> float:
    """Rank-based (Mann-Whitney) AUC over pooled predictions — the library
    twin of the Keras AUC the reference prints per epoch
    (`test/benchmark/criteo_deepctr.py`). Ties get their stable-sort rank;
    returns nan when a class is absent."""
    import numpy as np

    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
