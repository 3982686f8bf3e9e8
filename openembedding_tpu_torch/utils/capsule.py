"""The port's copy of `openembedding_tpu/utils/capsule.py`. Divergences
kept on purpose (ROADMAP.md §C): `hlo_budget_digest` is null (no HLO
budget on the card); `fingerprint` is the port's collective fingerprint
(`utils/guards.last_fingerprint()`: the recorded collective sequence, not
a traced one);
`lineage` is the port's delta lineage book (`sync/lineage.BOOK`).

Postmortem capsules: one self-contained flight-data dump per failure.

When a soak run breaches an SLO or a trainer halts on `NonFiniteError`, the
live surfaces (`/statusz`, `/sloz`, `/metrics`) have usually moved on — or
the process is gone — by the time anyone looks. A capsule freezes the
evidence at the moment of failure into one atomic
`capsule-<ts>-<reason>.json.gz`:

- the flight-recorder tail (completed spans + events, request ids intact)
  and the triggering thread's OPEN span stack;
- every metric history ring (`utils/history.HISTORY.export()`) plus a
  point-in-time `metrics.report()`;
- the device-memory ledger (`utils/memwatch.WATCH.export()`);
- the last collective fingerprint (`utils/guards.last_fingerprint()`);
- registered context providers (resolved trainer/serving config —
  `register_context("trainer", lambda: {...})`);
- the sha256 digest of the checked-in HLO-budget table, naming the compiled
  program generation the process was built against.

Trigger sites: `Trainer.record_step_stats` on `NonFiniteError`,
`SLOEvaluator` on an OK->BREACHED edge, the oeweave scheduler on a
`WeaveLeak`, and `POST /capsule` on the serving surface. Capsules are OFF
unless a directory is configured (`configure(dir=...)` or the
`OETPU_CAPSULE_DIR` env) — tests and normal runs never spray files — and
`trigger()` NEVER raises: a broken disk must not turn a diagnosable halt
into a different crash. Rate limiting (per-reason `min_interval_s`) and
bounded retention (`keep` newest capsules) make the failure path safe to
leave armed in production. `tools/capsule_report.py` renders a capsule
offline, no live process needed.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import metrics

CAPSULE_VERSION = 1

_LOCK = threading.Lock()
_WRITER: Optional["CapsuleWriter"] = None
_CONTEXT_PROVIDERS: Dict[str, Callable[[], Any]] = {}


def register_context(name: str, provider: Callable[[], Any]) -> None:
    """Attach a named config/context snapshot to every future capsule
    (called at trigger time; a raising provider contributes its error
    string instead of killing the dump)."""
    with _LOCK:
        _CONTEXT_PROVIDERS[name] = provider


def unregister_context(name: str) -> None:
    with _LOCK:
        _CONTEXT_PROVIDERS.pop(name, None)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _hlo_budget_digest() -> Optional[str]:
    """The JAX package names the compiled program generation by the digest
    of its checked-in HLO budget; a CUDA graph has no such table, so the
    port writes null (ROADMAP.md §C)."""
    return None


def _open_span_stack() -> List[dict]:
    """The triggering context's innermost OPEN span (spans only reach the
    recorder on close, so without this a capsule fired mid-step would not
    say which span it interrupted). Parent links are ids, not pointers, so
    one frame is all that is reachable; ancestors correlate via parent_id
    against the flight tail."""
    from . import trace
    span = trace.current_span()
    if span is None:
        return []
    d = span.as_dict()
    d["open"] = True
    return [d]


class CapsuleWriter:
    """Atomic, rate-limited, retention-bounded capsule emitter."""

    def __init__(self, dir: str, keep: int = 8,
                 min_interval_s: float = 30.0, tail: int = 512):
        self.dir = dir
        self.keep = max(1, int(keep))
        self.min_interval_s = float(min_interval_s)
        self.tail = int(tail)
        self._lock = threading.Lock()
        self._last_write: Dict[str, float] = {}  # guarded-by: self._lock

    # -- assembly -------------------------------------------------------------

    def _payload(self, reason: str, attrs: Dict[str, Any]) -> Dict[str, Any]:
        from . import guards, history, memwatch, trace
        now = time.time()
        context: Dict[str, Any] = {}
        with _LOCK:
            providers = dict(_CONTEXT_PROVIDERS)
        for name, fn in providers.items():
            try:
                context[name] = _jsonable(fn())
            except Exception as e:  # noqa: BLE001 — a raising provider must
                # not kill the dump (record what broke instead)
                context[name] = f"<context provider error: {e!r}>"
        # delta lineage records (where a stale delta's time went): a capsule
        # still writes if the sync layer is broken
        try:
            from ..sync.lineage import BOOK
            lineage_records = BOOK.export()
        except Exception as e:  # noqa: BLE001
            lineage_records = [{"error": f"<lineage unavailable: {e!r}>"}]
        return {
            "version": CAPSULE_VERSION,
            "ts": now,
            "reason": reason,
            "attrs": {k: _jsonable(v) for k, v in attrs.items()},
            "flight": [it.as_dict() for it in trace.RECORDER.tail(self.tail)],
            "open_spans": _open_span_stack(),
            "history": history.HISTORY.export(),
            "metrics": metrics.report(reset=False),
            "memory": memwatch.WATCH.export(),
            "lineage": lineage_records,
            "fingerprint": guards.last_fingerprint(),
            "context": context,
            "hlo_budget_digest": _hlo_budget_digest(),
        }

    # -- emission -------------------------------------------------------------

    def write(self, reason: str, attrs: Dict[str, Any]) -> str:
        """Assemble + atomically write one capsule; returns its path.
        tmp-file + `os.replace`, so a reader never sees a torn capsule."""
        os.makedirs(self.dir, exist_ok=True)
        payload = self._payload(reason, attrs)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(payload["ts"]))
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason) or "capsule"
        path = os.path.join(self.dir, f"capsule-{stamp}-{safe}.json.gz")
        tmp = path + f".tmp{os.getpid()}"
        with gzip.open(tmp, "wt") as f:
            json.dump(payload, f, default=repr)
        os.replace(tmp, path)
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep the newest `keep` capsules, drop the rest."""
        try:
            caps = sorted(
                f for f in os.listdir(self.dir)
                if f.startswith("capsule-") and f.endswith(".json.gz"))
        except OSError:
            return
        for f in caps[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f))
            except OSError:
                pass

    def trigger(self, reason: str, **attrs) -> Optional[str]:
        """Rate-limited write; returns the path, or None when suppressed or
        failed. NEVER raises — the failure path must stay a failure path."""
        now = time.monotonic()
        with self._lock:
            last = self._last_write.get(reason)
            if last is not None and now - last < self.min_interval_s:
                metrics.observe("capsule.rate_limited", 1.0)
                return None
            self._last_write[reason] = now
        try:
            path = self.write(reason, attrs)
        except Exception:  # noqa: BLE001 — see docstring
            metrics.observe("capsule.write_errors", 1.0)
            return None
        metrics.observe("capsule.written", 1.0)
        from . import trace
        trace.event("capsule", "written", reason=reason, path=path)
        return path


def configure(dir: Optional[str], keep: int = 8,
              min_interval_s: float = 30.0) -> Optional[CapsuleWriter]:
    """Arm (or disarm with dir=None) the process-global capsule writer."""
    global _WRITER
    with _LOCK:
        _WRITER = CapsuleWriter(dir, keep=keep,
                                min_interval_s=min_interval_s) \
            if dir else None
        return _WRITER


def _writer() -> Optional[CapsuleWriter]:
    global _WRITER
    with _LOCK:
        if _WRITER is None:
            env = os.environ.get("OETPU_CAPSULE_DIR")
            if env:
                _WRITER = CapsuleWriter(env)
        return _WRITER


def enabled() -> bool:
    return _writer() is not None


def trigger(reason: str, **attrs) -> Optional[str]:
    """The module-level trigger every failure site calls: no-op (None)
    unless a capsule directory is configured; never raises."""
    w = _writer()
    if w is None:
        return None
    return w.trigger(reason, **attrs)


def load(path: str) -> Dict[str, Any]:
    """Read one capsule back (offline: `tools/capsule_report.py`)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)
