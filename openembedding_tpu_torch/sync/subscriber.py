"""Subscriber half of online model sync (port of
`openembedding_tpu/sync/subscriber.py`): live delta apply inside a serving
node.

A per-model state machine against a publisher feed:

    IDLE --poll--> FETCHING --payload ok--> APPLYING --swap--> IDLE
      ^                |                        |
      +-- backoff -- DEGRADED <-- chain/validate/apply failure --+

Each applied delta is published with an atomic servable swap
(`ModelManager.swap`): predicts that already resolved the old servable
finish on it untouched (RCU; `StandaloneModel.apply_update` builds new
tensors and has finished on the device before it returns), the next request
sees the new version. The swap comes only after a delta validates and
applies, so a failure at any point leaves the node on the last good
version; `sync.rollbacks` counts those, and the machine backs off in
DEGRADED until the feed yields a consistent chain again. A subscriber whose
version fell behind the feed's base (its deltas pruned) stays DEGRADED: the
operator reloads the model (POST /models) to resume.

`FaultInjector` is a hook for tests and soaks: it can drop, duplicate,
reorder or truncate deltas between fetch and apply.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional
from urllib.parse import quote

import numpy as np

from ..ops import wire as wire_mod
from ..persist import DELTA_FORMAT
from ..utils import metrics, trace
from . import lineage

IDLE, FETCHING, APPLYING, DEGRADED = "IDLE", "FETCHING", "APPLYING", "DEGRADED"
_STATE_CODE = {IDLE: 0, FETCHING: 1, APPLYING: 2, DEGRADED: 3}


class SyncError(RuntimeError):
    """A sync attempt failed; the node keeps serving the last good version."""


class SyncChainError(SyncError):
    """The fetched delta does not extend the applied chain (torn, reordered,
    duplicated, foreign-format, or parent-mismatched payload)."""


class FaultInjector:
    """Deliberate fault injection between fetch and apply. Subclass and
    override either method; the default is a no-op. `plan` may drop,
    duplicate or reorder the pending step list; `payload` may corrupt or
    truncate one fetched delta (return the payload dict, mutated or not)."""

    def plan(self, steps: List[int]) -> List[int]:
        return steps

    def payload(self, step: int, payload: dict) -> dict:
        return payload


class SyncSubscriber:
    """Keep one model in a `ModelManager` fresh against a publisher feed.

    Drive it either deterministically — `poll()` per tick (tests, soak) — or
    with `start()`/`stop()` for the background thread the serving node CLI
    uses. `feed` is the publisher node's base URL; the model must already be
    loaded on THIS node (POST /models) before the first poll, and its export
    step must sit on the feed's chain (export the base persist's state).
    """

    def __init__(self, manager, model_sign: str, feed: str, *,
                 wire: Optional[str] = None, interval_s: float = 1.0,
                 wait_s: float = 0.0, max_backoff_s: float = 30.0,
                 timeout: float = 30.0, faults: Optional[FaultInjector] = None):
        self.manager = manager
        self.model_sign = model_sign
        self.feed = feed.rstrip("/")
        self.wire = wire_mod.wire_format(wire or "fp32")
        self.interval_s = interval_s
        self.wait_s = wait_s
        self.max_backoff_s = max_backoff_s
        self.timeout = timeout
        self.faults = faults
        # `_mu` guards the machine state the worker thread WRITES and the
        # serving threads READ (`status()` on GET :syncstate / statusz):
        # without it a reader can see a half-updated (state, version,
        # last_degraded_reason) triple mid-transition. Every field marked
        # `# guarded-by: self._mu` is written only under it.
        self._mu = threading.Lock()
        self.state = IDLE                       # guarded-by: self._mu
        self.version: Optional[int] = None      # guarded-by: self._mu
        self.applied = 0                        # guarded-by: self._mu
        self.last_error: Optional[str] = None   # guarded-by: self._mu
        # survives recovery: the reason the machine LAST entered DEGRADED
        # (shown on /statusz and :syncstate — `last_error` clears on the next
        # clean round, this stays for the post-mortem)
        # guarded-by: self._mu
        self.last_degraded_reason: Optional[str] = None
        self._backoff = 0.0                     # guarded-by: self._mu
        self._head_times: Dict[int, float] = {}  # guarded-by: self._mu
        # delta lineage bookkeeping: per-step birth stamps off the feed
        # (publisher clock) and first-seen times (local clock), the
        # Cristian-style clock-offset estimate to the publisher, and the
        # last applied delta's hop decomposition / end-to-end freshness
        self._births: Dict[int, float] = {}      # guarded-by: self._mu
        self._feed_seen: Dict[int, float] = {}   # guarded-by: self._mu
        self._clock_offset_s = 0.0               # guarded-by: self._mu
        self._offset_samples = 0                 # guarded-by: self._mu
        self._last_hops: Optional[dict] = None   # guarded-by: self._mu
        # guarded-by: self._mu
        self._last_freshness_ms: Optional[float] = None
        self._stop = threading.Event()
        # guarded-by: self._mu
        self._thread: Optional[threading.Thread] = None

    # -- wire ----------------------------------------------------------------

    def _get(self, path: str):
        # each sync round binds a request id (`sync_once`); injecting the
        # full trace context (request id + X-OETPU-Trace parent span) onto
        # every feed fetch means the PUBLISHER node's handler spans link
        # back to this subscriber's fetch span as ONE cross-process tree
        headers = trace.inject_headers()
        req = urllib.request.Request(f"{self.feed}{path}", headers=headers)
        t0 = time.time()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
                server_time = r.headers.get(trace.SERVER_TIME_HEADER)
        except urllib.error.HTTPError as e:
            if e.code == 304:
                return None
            raise SyncError(f"feed {path}: HTTP {e.code}") from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise SyncError(f"feed {path}: {e}") from e
        if server_time:
            try:
                self._note_clock(float(server_time), t0, time.time())
            except (TypeError, ValueError):
                pass
        metrics.observe("sync.bytes_fetched", len(raw))
        return raw

    def _note_clock(self, t_server: float, t0: float, t2: float) -> None:
        """Cristian-style clock-offset estimate from one round-trip: the
        publisher stamped `t_server` somewhere inside [t0, t2] of OUR clock,
        so offset ~= t_server - (t0 + t2)/2, error bounded by RTT/2. EWMA
        over rounds smooths network jitter; `status()` and the lineage book
        expose the estimate so merged timelines can de-skew our stamps."""
        offset = t_server - (t0 + t2) / 2.0
        with self._mu:
            if self._offset_samples == 0:
                self._clock_offset_s = offset
            else:
                self._clock_offset_s += 0.3 * (offset - self._clock_offset_s)
            self._offset_samples += 1

    def _get_json(self, path: str):
        raw = self._get(path)
        return None if raw is None else json.loads(raw)

    def _get_npz(self, path: str) -> dict:
        import io
        raw = self._get(path)
        with np.load(io.BytesIO(raw)) as z:
            return {k: z[k] for k in z.files}

    def _fetch_delta(self, step: int) -> dict:
        """-> {"meta", "tables": {name: (ids, rows_f32)}, "dense": flat}."""
        sign = quote(self.model_sign, safe="")
        meta = self._get_json(f"/models/{sign}/delta/{step}/meta")
        tables = {}
        for name in meta.get("tables", []):
            z = self._get_npz(
                f"/models/{sign}/delta/{step}/table/{quote(name, safe='')}"
                f"?wire={self.wire}")
            fmt = str(z["fmt"])
            rows = wire_mod.np_decode_rows(z["wire"], int(z["dim"]), fmt)
            tables[name] = (np.asarray(z["ids"], np.int64), rows)
        dense = self._get_npz(f"/models/{sign}/delta/{step}/dense")
        return {"meta": meta, "tables": tables, "dense": dense}

    # -- state machine -------------------------------------------------------

    def _set_state(self, state: str, reason: Optional[str] = None) -> None:
        with self._mu:
            prev, self.state = self.state, state
            if state == DEGRADED and reason:
                self.last_degraded_reason = reason
        metrics.observe("sync.state", _STATE_CODE[state], "gauge")
        if state != prev:
            # discrete transition -> flight recorder (the /statusz tail that
            # explains a DEGRADED spike after the fact)
            attrs = {"model": self.model_sign, "from": prev, "to": state}
            if reason:
                attrs["reason"] = reason
            trace.event("sync", "state", **attrs)

    def _observe_lag(self, head: Optional[int]) -> None:
        if head is None or self.version is None:
            return
        metrics.observe("sync.version_lag_steps",
                        max(0, head - self.version), "gauge")
        metrics.observe("sync.head_version", float(head), "gauge")
        metrics.observe("sync.applied_version", float(self.version), "gauge")
        t = self._head_times.get(self.version)
        if t is not None:
            metrics.observe("sync.staleness_seconds",
                            max(0.0, time.time() - t), "gauge")
        f = self._freshness_ms(head)
        if f is not None:
            metrics.observe("sync.freshness_ms", f, "gauge")

    def _freshness_ms(self, head: Optional[int]) -> Optional[float]:
        """End-to-end freshness of what THIS node serves: while the feed
        head is ahead of the applied version, the skew-corrected age of the
        head delta's BIRTH (it grows every poll a stalled delta stays
        unapplied — the SLO trip wire); once caught up, frozen at the last
        applied delta's measured birth->swap latency."""
        with self._mu:
            offset = self._clock_offset_s
            last = self._last_freshness_ms
            birth = None
            if (head is not None and self.version is not None
                    and head > self.version):
                birth = self._births.get(head)
        if birth is not None:
            return max(0.0, (time.time() + offset - birth) * 1e3)
        return last

    def _record_lineage(self, step: int, fetched: float, applied_t: float,
                        swapped: float) -> None:
        """Fold one applied delta's hop decomposition into `sync.hop_ms`
        hists, the shared lineage book, and the freshness snapshot. `birth`/
        `commit` stamps are publisher-domain, `seen`/`fetched`/`applied`/
        `swapped` local-domain; the publish hop and the end-to-end number
        cross domains via the Cristian offset estimate. The `fetch` hop runs
        first-seen-on-feed -> fetched, so DEGRADED retry time during a
        payload stall lands on it — the soak's stalled-hop attribution."""
        with self._mu:
            offset = self._clock_offset_s
            birth = self._births.get(step)
            seen = self._feed_seen.get(step)
            commit_t = self._head_times.get(step)
            hops: Dict[str, float] = {}
            if birth is not None and commit_t is not None:
                hops["commit"] = max(0.0, (commit_t - birth) * 1e3)
            if commit_t is not None and seen is not None:
                hops["publish"] = max(0.0, (seen + offset - commit_t) * 1e3)
            if seen is not None:
                hops["fetch"] = max(0.0, (fetched - seen) * 1e3)
            hops["apply"] = max(0.0, (applied_t - fetched) * 1e3)
            hops["swap"] = max(0.0, (swapped - applied_t) * 1e3)
            e2e = None
            if birth is not None:
                e2e = max(0.0, (swapped + offset - birth) * 1e3)
                self._last_freshness_ms = e2e
            self._last_hops = {"step": step, "hops": dict(hops)}
            # stamps for this and older steps are consumed: bound the maps
            self._births = {k: v for k, v in self._births.items()
                            if k > step}
            self._feed_seen = {k: v for k, v in self._feed_seen.items()
                               if k > step}
        for h, v in hops.items():
            metrics.observe("sync.hop_ms", v, "hist", labels={"hop": h})
        if e2e is not None:
            metrics.observe("sync.freshness_ms", e2e, "gauge")
        lineage.BOOK.record(
            self.model_sign, step, trace_id=trace.get_request_id(),
            birth=birth, commit=commit_t, seen=seen, fetched=fetched,
            applied=applied_t, swapped=swapped, hops=hops, offset_s=offset)

    def sync_once(self) -> int:
        """One negotiation round; returns deltas applied. Raises SyncError on
        any failure — state/metrics handling lives in `poll()`. The round
        runs under one request id, propagated to the publisher on every
        fetch (`X-OETPU-Request-Id`)."""
        with trace.request():
            return self._sync_once()

    def _sync_once(self) -> int:
        servable = self.manager.find_model(self.model_sign)
        with self._mu:
            # check and seed under one lock: a poll racing a manual
            # sync_once() must not both observe None and double-seed
            if self.version is None:
                self.version = int(getattr(servable, "step", 0))
        sign = quote(self.model_sign, safe="")
        q = (f"?after={self.version}&wait_s={self.wait_s}"
             if self.wait_s > 0 else "")
        feed = self._get_json(f"/models/{sign}:versions{q}")
        if feed is None:  # 304: nothing newer inside the poll window
            self._observe_lag(self.version)
            return 0
        if feed.get("format") != "oetpu-sync-v1":
            raise SyncError(f"foreign feed format {feed.get('format')!r}")
        head = feed.get("head_step")
        now = time.time()
        with self._mu:
            for d in feed.get("deltas", []):
                self._head_times[d["step"]] = d["commit_time"]
                if d.get("birth_time") is not None:
                    self._births[d["step"]] = float(d["birth_time"])
                # first time THIS node saw the delta on the feed (local
                # clock) — the fetch hop's start, kept across retries
                self._feed_seen.setdefault(d["step"], now)
        self._observe_lag(head)
        if head is None or head <= self.version:
            return 0
        base = feed.get("base_step")
        chain_steps = [d["step"] for d in feed.get("deltas", [])]
        if self.version != base and self.version not in chain_steps:
            raise SyncChainError(
                f"servable version {self.version} is not on the feed chain "
                f"(base {base}, deltas {chain_steps[:8]}...): fell behind "
                "retention — reload the model to resume")
        pending = [s for s in chain_steps if s > self.version]
        if self.faults is not None:
            pending = self.faults.plan(list(pending))

        self._set_state(FETCHING)
        applied = 0
        for step in pending:
            with trace.span("sync", "fetch", step=int(step)):
                payload = self._fetch_delta(step)
            t_fetched = time.time()
            if self.faults is not None:
                payload = self.faults.payload(step, payload)
            meta = payload.get("meta") or {}
            if (meta.get("format") != DELTA_FORMAT
                    or int(meta.get("step", -1)) != int(step)
                    or int(meta.get("parent", -1)) != int(self.version)):
                raise SyncChainError(
                    f"delta {step} does not extend version {self.version} "
                    f"(parent={meta.get('parent')}, "
                    f"format={meta.get('format')!r})")
            self._set_state(APPLYING)
            with trace.span("sync", "apply", step=int(step)):
                new_servable = servable.apply_update(
                    payload["tables"], payload["dense"], step=int(step),
                    model_version=meta.get("model_version"))
            t_applied = time.time()
            with trace.span("sync", "swap", step=int(step)):
                self.manager.swap(self.model_sign, new_servable,
                                  expected=servable)
            t_swapped = time.time()
            servable = new_servable
            with self._mu:
                self.version = int(step)
                self.applied += 1
            applied += 1
            metrics.observe("sync.applied_deltas", 1)
            self._record_lineage(int(step), t_fetched, t_applied, t_swapped)
            self._observe_lag(head)
            self._set_state(FETCHING)
        self._set_state(IDLE)
        return applied

    def _degrade(self, reason: str) -> None:
        with self._mu:
            self.last_error = reason
        metrics.observe("sync.rollbacks", 1)
        trace.event("sync", "rollback", model=self.model_sign,
                    version=self.version, reason=reason)
        self._set_state(DEGRADED, reason=reason)
        with self._mu:
            self._backoff = min(max(self._backoff * 2, self.interval_s),
                                self.max_backoff_s)

    def poll(self) -> int:
        """One guarded tick: sync, or record the failure and degrade.
        Returns deltas applied (0 on failure — check `.state`/`.last_error`)."""
        try:
            applied = self.sync_once()
        except SyncError as e:
            self._degrade(str(e))
            return 0
        except Exception as e:  # noqa: BLE001 — a bug must not kill the loop
            self._degrade(f"{type(e).__name__}: {e}")
            return 0
        with self._mu:
            self.last_error = None
            self._backoff = 0.0
        return applied

    def status(self) -> dict:
        # one consistent snapshot: serving threads render this on
        # :syncstate / statusz while the worker is mid-transition
        with self._mu:
            return {"model_sign": self.model_sign, "feed": self.feed,
                    "state": self.state, "version": self.version,
                    "applied": self.applied, "wire": self.wire,
                    "last_error": self.last_error,
                    "last_degraded_reason": self.last_degraded_reason,
                    "freshness_ms": self._last_freshness_ms,
                    "clock_offset_ms": self._clock_offset_s * 1e3,
                    "last_hops": dict(self._last_hops)
                    if self._last_hops is not None else None}

    # -- background loop -----------------------------------------------------

    def start(self) -> "SyncSubscriber":
        # two racing start()s (CLI + a POST /sync) must not leak a thread
        with self._mu:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll()
            delay = self._backoff if self.state == DEGRADED else self.interval_s
            if self._stop.wait(max(delay, 0.01)):
                return

    def stop(self) -> None:
        self._stop.set()
        with self._mu:
            t, self._thread = self._thread, None
        if t is not None:  # join OUTSIDE the lock: _run takes no lock, but
            t.join(timeout=10)  # a slow join must not block status() readers
