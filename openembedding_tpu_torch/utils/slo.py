"""The port's copy of `openembedding_tpu/utils/slo.py` (same specs, verdicts
and series names).

SLO engine: declarative objectives judged over the metrics spine.

The round-8 observability spine RECORDS (`utils/metrics.Accumulator`
histograms/gauges/counters) but never JUDGES — nothing in the tree could
answer "is this node meeting its objectives" until now. This module adds the
judgment layer the production-day harness asserts through:

- `SLOSpec`: one declarative objective — a metric name, a value selector
  (`value` for gauges/counters, `p50`/`p95`/`p99`/`mean` for histograms), a
  comparison against a threshold, and SRE-style multiwindow burn-rate
  evaluation (fast + slow windows; the objective BREACHES only when the
  bad-sample fraction meets `burn_threshold` in BOTH windows, so a single
  tail blip doesn't page but a sustained burn does).
- `SLOEvaluator`: samples every spec against the live accumulator registry
  (a PEEK — never creates metrics, never resets windows), keeps the per-spec
  sample history, and renders verdicts: `OK`, `BREACHED`, or `UNKNOWN`.
  A metric that has never been observed is UNKNOWN — absence of evidence is
  not a pass (the never-observed-metric trap the tests pin). Corollary: a
  `PeriodicReporter(reset=True)` on the same node zeroes counter windows
  back to never-observed between its ticks — judgment-bearing nodes should
  report with `reset=False` (tools/sync_soak.py does; gauges and histograms
  are immune either way). Runs inline (`evaluate_now`) or as a background
  thread (`start()`), and like `PeriodicReporter` it survives a raising
  sink (`slo.eval_errors`).
- Exposition: verdicts publish as `slo.ok{slo=}` gauges + a `slo.breaches`
  counter, OK→BREACHED transitions leave a `slo.breach` flight-recorder
  event (and `slo.recovered` on the way back), `GET /sloz` serves the
  verdict table (text or `?format=json`), `/statusz` carries the panel, and
  `tools/slo_report.py` is the operator CLI.
- `exit_code()`: the process-exit verdict mode — 0 all OK, 1 any BREACHED,
  2 otherwise-clean UNKNOWN — adopted by `tools/sync_soak.py` as its
  pass/fail gate.

Spec files are JSON lists of spec dicts (`load_specs`); the checked-in
default set is `tools/slo_specs.json`. The oelint metrics pass lints every
checked-in spec's `metric` against the `group.name` scheme and the
KNOWN_GROUPS registry, same as observe() call sites.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import history as _history
from . import metrics

# verdict-sample ring depth: far above any real window (slow_window_s=300 at
# 1s cadence is 300 samples), so the TIME prune below is always the binding
# bound and burn-rate semantics match the former unbounded deques exactly
SAMPLE_RING_DEPTH = 4096

OK = "OK"
BREACHED = "BREACHED"
UNKNOWN = "UNKNOWN"

SELECTORS = ("value", "mean", "p50", "p90", "p95", "p99")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over a spine metric.

    `metric` follows the `group.name` scheme; `labels=None` matches EVERY
    label set of the metric (the objective holds for each series — one bad
    table breaches a per-table SLO). `selector` picks the judged value:
    `value` (gauge/counter/avg/max reading) or a histogram quantile/mean.
    The objective is met when `value <op> threshold`; burn-rate windows are
    seconds of evaluator history (a window shorter than one evaluation
    interval degenerates to judging the latest sample alone, by design)."""

    name: str
    metric: str
    threshold: float
    selector: str = "value"
    op: str = "<="
    labels: Optional[Dict[str, str]] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 0.5
    description: str = ""

    def __post_init__(self):
        if self.selector not in SELECTORS:
            raise ValueError(f"slo {self.name!r}: selector "
                             f"{self.selector!r} not in {SELECTORS}")
        if self.op not in _OPS:
            raise ValueError(f"slo {self.name!r}: op {self.op!r} not in "
                             f"{sorted(_OPS)}")
        if self.slow_window_s < self.fast_window_s:
            raise ValueError(f"slo {self.name!r}: slow window "
                             f"({self.slow_window_s}s) shorter than fast "
                             f"({self.fast_window_s}s)")

    def as_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "selector": self.selector, "op": self.op,
                "threshold": self.threshold, "labels": self.labels,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "burn_threshold": self.burn_threshold,
                "description": self.description}


def parse_spec(d: dict) -> SLOSpec:
    """One spec dict (a `load_specs` file entry) -> SLOSpec, unknown keys
    rejected so a typo'd field never silently defaults."""
    known = {"name", "metric", "selector", "op", "threshold", "labels",
             "fast_window_s", "slow_window_s", "burn_threshold",
             "description"}
    extra = set(d) - known
    if extra:
        raise ValueError(f"slo spec {d.get('name', '?')!r}: unknown "
                         f"field(s) {sorted(extra)}")
    return SLOSpec(**d)


def load_specs(path: str) -> List[SLOSpec]:
    """Load a JSON spec file: a list of spec dicts (see tools/slo_specs.json)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise ValueError(f"{path}: expected a JSON list of SLO spec objects")
    return [parse_spec(d) for d in doc]


# The stock objectives every node can evaluate out of the box (override with
# `configure(...)` / `--slo-specs`). Thresholds are deliberately generous —
# they are liveness rails, not tuned production targets; tools/slo_specs.json
# carries the production-day set.
DEFAULT_SLOS: Tuple[SLOSpec, ...] = (
    SLOSpec(name="predict_p99", metric="serving.predict.ms", selector="p99",
            op="<=", threshold=1000.0,
            description="predict tail latency stays under 1s"),
    SLOSpec(name="sync_freshness", metric="sync.version_lag_steps",
            selector="value", op="<=", threshold=50.0,
            description="serving replicas stay within 50 committed steps "
                        "of the trainer"),
    SLOSpec(name="numerics", metric="health.nonfinite_total",
            selector="value", op="==", threshold=0.0, fast_window_s=0.0,
            slow_window_s=300.0, burn_threshold=1e-9,
            description="zero non-finite losses/grads (trips on the first "
                        "bad sample: fast window = latest sample only)"),
    SLOSpec(name="serving_freshness", metric="sync.freshness_ms",
            selector="value", op="<=", threshold=30_000.0, fast_window_s=0.0,
            slow_window_s=300.0, burn_threshold=1e-9,
            description="end-to-end delta freshness (birth->swap, "
                        "skew-corrected) stays under 30s; trips on the "
                        "first stale sample and recovers on the next "
                        "fresh one (fast window = latest sample only)"),
)


def _peek(name: str, labels: Optional[Dict[str, str]]
          ) -> List[metrics.Accumulator]:
    """Registered accumulators matching (name, labels) WITHOUT creating one
    (Accumulator.get would mint an empty metric and turn never-observed
    into observed-as-zero). labels=None matches every label set."""
    with metrics._LOCK:
        accs = [a for a in metrics._REGISTRY.values() if a.name == name]
    if labels is not None:
        want = {k: str(v) for k, v in labels.items()}
        accs = [a for a in accs if a.labels == want]
    return [a for a in accs if a.count > 0]


def _select(acc: metrics.Accumulator, selector: str) -> float:
    if acc.kind == "hist":
        if selector == "value" or selector == "mean":
            return acc.value()
        return acc.quantile(float(selector[1:]) / 100.0)
    # gauges/counters/avg/max have no quantiles; every selector reads the
    # scalar (a spec written for a hist still evaluates if the metric turns
    # out to be a gauge — the gauge-vs-hist test pins this)
    return acc.value()


class SLOEvaluator:
    """Samples specs against the accumulator registry, keeps burn-rate
    history, renders verdicts. Thread-safe; inline or background use."""

    def __init__(self, specs: Optional[List[SLOSpec]] = None,
                 interval_s: float = 1.0,
                 sink: Optional[Callable[[List[dict]], None]] = None):
        self.interval_s = float(interval_s)
        self.sink = sink
        self._lock = threading.Lock()
        self._specs: List[SLOSpec] = list(
            DEFAULT_SLOS if specs is None else specs)  # guarded-by: self._lock
        # guarded-by: self._lock — per-spec verdict-sample ring of
        # (ts, ok: bool|None), stored as `utils/history.Ring`s registered
        # under `slo.samples{slo=}` so capsules and /historz see the same
        # evidence the burn-rate windows judge from
        self._history: Dict[str, _history.Ring] = {}
        self._verdicts: Dict[str, dict] = {}    # guarded-by: self._lock
        self._since: Dict[str, float] = {}      # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._lock

    @property
    def specs(self) -> List[SLOSpec]:
        with self._lock:
            return list(self._specs)

    def configure(self, specs: List[SLOSpec]) -> "SLOEvaluator":
        """Replace the spec set; history of dropped specs is discarded."""
        with self._lock:
            self._specs = list(specs)
            keep = {s.name for s in self._specs}
            for name in [k for k in self._history if k not in keep]:
                del self._history[name]
                _history.HISTORY.drop("slo.samples", labels={"slo": name})
            for d in (self._verdicts, self._since):
                for k in [k for k in d if k not in keep]:
                    del d[k]
        return self

    def _ring(self, name: str) -> _history.Ring:
        """This spec's verdict-sample ring (caller holds self._lock)."""
        r = self._history.get(name)
        if r is None:
            r = _history.HISTORY.ring(
                "slo.samples", labels={"slo": name}, kind="gauge",
                depth=SAMPLE_RING_DEPTH)
            # this evaluator owns the series from here: judgment starts from
            # its OWN samples, never a predecessor evaluator's (a fresh
            # evaluator judging a same-named spec must see never-observed,
            # exactly like the pre-ring private history)
            r.clear()
            # oelint: disable=lockset -- caller holds self._lock (evaluate_now
            # and configure both enter _ring under the evaluator lock)
            self._history[name] = r
        return r

    # -- one evaluation round -------------------------------------------------

    def _sample(self, spec: SLOSpec) -> Tuple[Optional[float], Optional[bool]]:
        """-> (judged value, met?) — (None, None) when the metric has never
        been observed (the UNKNOWN case). With labels=None the WORST series
        is judged: one failing label set fails the spec."""
        accs = _peek(spec.metric, spec.labels)
        if not accs:
            return None, None
        op = _OPS[spec.op]
        values = [_select(a, spec.selector) for a in accs]
        failing = [v for v in values if not op(v, spec.threshold)]
        if failing:
            return failing[0], False
        # all series meet the objective: report the one closest to breaching
        worst = min(values) if spec.op in (">=", ">") else max(values)
        return worst, True

    @staticmethod
    def _window_frac_bad(samples: List[Tuple[float, Optional[bool]]],
                         now: float, window_s: float) -> Optional[float]:
        """Bad-sample fraction over the trailing window. The LATEST sample is
        always in scope (a window shorter than one evaluation interval judges
        exactly that sample); windows with no judged samples return None."""
        if not samples:
            return None
        cutoff = now - window_s
        in_win = [ok for ts, ok in samples if ts >= cutoff and ok is not None]
        if not in_win:
            last_ok = samples[-1][1]
            if last_ok is None:
                return None
            in_win = [last_ok]
        return sum(1 for ok in in_win if not ok) / len(in_win)

    def evaluate_now(self, now: Optional[float] = None) -> List[dict]:
        """One sampling + judgment round over every spec -> verdict dicts
        (also cached for `snapshot()`); publishes `slo.*` metrics and leaves
        breach/recovery flight-recorder events on transitions."""
        from . import trace  # lazy: trace imports metrics at module level
        now = time.time() if now is None else now
        with self._lock:
            specs = list(self._specs)
        out: List[dict] = []
        for spec in specs:
            value, met = self._sample(spec)
            with self._lock:
                hist = self._ring(spec.name)
                hist.append(now, met)
                hist.prune_older(now - max(spec.slow_window_s, 1e-9), keep=1)
                samples = hist.items()
                prev = self._verdicts.get(spec.name, {}).get("verdict")
            fast_bad = self._window_frac_bad(samples, now, spec.fast_window_s)
            slow_bad = self._window_frac_bad(samples, now, spec.slow_window_s)
            if met is None and all(ok is None for _, ok in samples):
                verdict = UNKNOWN
            elif met is None:
                # metric went silent after being judged: keep judging the
                # recorded window rather than flapping to UNKNOWN
                verdict = (BREACHED if (fast_bad or 0) >= spec.burn_threshold
                           and (slow_bad or 0) >= spec.burn_threshold else OK)
            else:
                verdict = (BREACHED
                           if fast_bad is not None and slow_bad is not None
                           and fast_bad >= spec.burn_threshold
                           and slow_bad >= spec.burn_threshold else OK)
            with self._lock:
                if verdict != prev:
                    self._since[spec.name] = now
                since = self._since.get(spec.name, now)
            v = {"name": spec.name, "metric": spec.metric,
                 "selector": spec.selector, "op": spec.op,
                 "threshold": spec.threshold, "value": value,
                 "verdict": verdict, "since": since,
                 "fast_bad_frac": fast_bad, "slow_bad_frac": slow_bad,
                 "samples": len(samples),
                 "description": spec.description}
            out.append(v)
            with self._lock:
                self._verdicts[spec.name] = v
            metrics.observe("slo.ok", 1.0 if verdict == OK else 0.0,
                            "gauge", labels={"slo": spec.name})
            if verdict == BREACHED and prev != BREACHED:
                metrics.observe("slo.breaches", 1)
                trace.event("slo", "breach", slo=spec.name,
                            metric=spec.metric, value=value,
                            op=spec.op, threshold=spec.threshold)
                from . import capsule  # lazy: capsule imports slo surfaces
                capsule.trigger("slo_breach", slo=spec.name,
                                metric=spec.metric, value=value,
                                threshold=spec.threshold)
            elif verdict == OK and prev == BREACHED:
                trace.event("slo", "recovered", slo=spec.name,
                            metric=spec.metric, value=value)
        metrics.observe("slo.evaluations", 1)
        return out

    # -- background evaluator (PeriodicReporter discipline) -------------------

    def start(self) -> "SLOEvaluator":
        if self.interval_s <= 0:
            return self
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                verdicts = self.evaluate_now()
                if self.sink is not None:
                    self.sink(verdicts)
            except Exception:  # noqa: BLE001 — a raising sink must not kill
                # SLO evaluation for the rest of the run (the round-9
                # PeriodicReporter lesson, mirrored here + pinned by tests)
                metrics.observe("slo.eval_errors", 1)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:  # join outside the lock (_run never takes it)
            t.join(timeout=5)

    def __enter__(self) -> "SLOEvaluator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- verdict surfaces -----------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Last round's verdicts in spec order (empty before the first
        evaluation — call `evaluate_now()` for a fresh round)."""
        with self._lock:
            return [dict(self._verdicts[s.name]) for s in self._specs
                    if s.name in self._verdicts]

    def render_text(self) -> str:
        """The /sloz and /statusz-panel rendering."""
        rows = self.snapshot()
        if not rows:
            return "(no SLO verdicts yet)"
        lines = []
        for v in rows:
            val = "never-observed" if v["value"] is None \
                else f"{v['value']:.6g}"
            lines.append(
                f"[{v['verdict']:>8}] {v['name']}: "
                f"{v['metric']}.{v['selector']} {v['op']} "
                f"{v['threshold']:g} (value={val}, "
                f"bad fast/slow={_frac(v['fast_bad_frac'])}"
                f"/{_frac(v['slow_bad_frac'])}, n={v['samples']})"
                + (f" — {v['description']}" if v["description"] else ""))
        return "\n".join(lines)

    def exit_code(self) -> int:
        """Process-exit verdict: 0 = every spec OK, 1 = any BREACHED,
        2 = no breach but something UNKNOWN (absence of evidence is not a
        pass — an exit gate must not go green on a metric that never
        reported)."""
        verdicts = {v["verdict"] for v in self.snapshot()}
        if not verdicts:
            return 2
        if BREACHED in verdicts:
            return 1
        return 2 if UNKNOWN in verdicts else 0


def _frac(f: Optional[float]) -> str:
    return "-" if f is None else f"{f:.2f}"


# The process-global evaluator the serving surface (`GET /sloz`, /statusz
# panel) reads — same singleton discipline as `trace.RECORDER`. Not started:
# /sloz runs `evaluate_now()` per request; `serving.main --slo-interval`
# or an embedding application may `EVALUATOR.start()` it.
EVALUATOR = SLOEvaluator()


def configure(specs: List[SLOSpec]) -> SLOEvaluator:
    """Replace the global evaluator's spec set (`--slo-specs`)."""
    return EVALUATOR.configure(specs)
