"""The port's `PlacementController` (copy of
`openembedding_tpu/placement/controller.py`): drives hot-cache sizing,
refresh pacing, cold-tail migration and, on request, the wire formats,
with no operator in the loop.

Division of labour:

- A background WATCHER thread (optional, `start()`) snapshots the sketches
  and metrics on a wall-clock cadence, runs the policy and parks the
  resulting `PlacementDecision`. It never touches trainer state: only the
  training loop installs decisions.
- The training loop calls `on_step(state, step)` between steps (an int
  compare off the cadence). On the decision cadence, or when the watcher
  parked a decision, it applies refreshes via
  `MeshTrainer.refresh_hot_rows` and migrations via
  `MeshTrainer.migrate_rows`, both of which write into the state's own
  tensors: a captured step graph stays valid (no capture anew).
- `prime(state)` runs once before the step is captured: it sizes each
  table's hot capacity and migration annex from the policy's byte budget
  (asking `utils.memwatch.WATCH.preflight` first; a rejection keeps the
  current sizes and records `placement/prime_rejected`) and attaches the
  placement state. Sizing changes shapes, so it moves
  `trainer.graph_epoch` once (every `CompiledStep` captures anew at its
  next call): prime before `jit_train_step`, or accept one capture more.
  With `manage_wire=True` a real wire-format change does the same.

The ranks agree. Each rank's process runs a controller, while the JAX
package runs one over an SPMD mesh. At S > 1 every decision is rank 0's
and is sent to every rank with one object broadcast over the mesh
(`parallel/collectives.broadcast_object`): prime's sizes and wire formats,
the hot sets (`refresh_hot_rows` reads rank 0's sketches), the moves, the
wire formats and the dense-wire verdict. Rank 0's monitor is the one read;
a parked decision is installed at the next cadence step, where every rank
meets (the JAX controller installs it at the next `on_step`); every rank
publishes the same `placement.*` gauges and reports the same `status()`.

Every decision exports `placement.*` gauges and a flight-recorder event
(`utils/trace.py`), and `render_status()` feeds the `/statusz` placement
panel.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import metrics as _metrics
from ..utils import trace as _trace
from .migration import candidate_weights, plan_migration
from .policy import PlacementDecision, PlacementPolicy, TableDecision, \
    TableTelemetry

# live controllers for the /statusz panel (weakrefs: a controller's
# lifetime belongs to its owner, not to the status page)
_CONTROLLERS: "List[weakref.ref]" = []
_CONTROLLERS_LOCK = threading.Lock()

# apply_dense_wire reads the density gauge itself unless it is handed one
_READ_GAUGE = object()


def _controllers() -> List["PlacementController"]:
    with _CONTROLLERS_LOCK:
        alive = [r() for r in _CONTROLLERS]
        _CONTROLLERS[:] = [r for r, c in zip(_CONTROLLERS, alive)
                           if c is not None]
        return [c for c in alive if c is not None]


def render_status() -> str:
    """The /statusz placement panel: one block per live controller."""
    ctrls = _controllers()
    if not ctrls:
        return "(no placement controllers)"
    return "\n".join(c.render_text() for c in ctrls)


class PlacementController:
    """Autonomous placement control for one `MeshTrainer`.

    `monitor`: the `SkewMonitor` feeding the decisions (defaults to the
    trainer's `enable_skew_monitor()` feed, falling back to the global
    `utils.sketch.MONITOR`); at S > 1 rank 0's is the one read. Give it
    `decay=` so a drifting workload rotates the sketches. `interval_steps`:
    decision cadence for the inline `on_step` path.
    """

    def __init__(self, trainer, policy: PlacementPolicy, *,
                 monitor=None, interval_steps: int = 50,
                 manage_wire: bool = False):
        self.trainer = trainer
        self.policy = policy
        self._monitor = monitor
        self.interval_steps = int(interval_steps)
        # opt-in: let the controller also set per-table wire precision
        # (policy.recommend_wire -> MeshTrainer(wire={...})). Off by default
        # because a format change is a capture anew, not a content swap.
        self.manage_wire = bool(manage_wire)
        self._wire_active: Dict[str, str] = {}
        self._wire_rejits = 0
        # dense-gradient wire management (guarded-by: self._lock)
        self._dense_wire_rejits = 0
        self._last_dense_wire_step = -10**9
        self._dense_wire_reason = ""
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._pending: Optional[PlacementDecision] = None
        # guarded-by: self._lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._primed = False
        # decision history for /statusz (guarded-by: self._lock)
        self._last_refresh_step: Dict[str, int] = {}
        self._last_refresh_reason: Dict[str, str] = {}
        self._hot_target: Dict[str, int] = {}
        self._predicted_hit: Dict[str, float] = {}
        self._migrations_applied = 0
        self._migrated_rows: Dict[str, int] = {}
        self._decisions = 0
        # the observations of the last `decide` (guarded-by: self._lock),
        # made again by the ranks that receive rank 0's decision
        self._decide_gauges: list = []
        self._step = 0
        with _CONTROLLERS_LOCK:
            _CONTROLLERS.append(weakref.ref(self))

    # -- the ranks -----------------------------------------------------------

    def _mesh(self):
        mesh = getattr(self.trainer, "mesh", None)
        return mesh if mesh is not None and mesh.size > 1 else None

    def _leads(self) -> bool:
        """Whether this process decides: rank 0, or the only rank."""
        mesh = self._mesh()
        return mesh is None or mesh.rank == 0

    def _shared(self, fn):
        """`fn()` on the deciding rank, its result on every rank."""
        mesh = self._mesh()
        if mesh is None:
            return fn()
        from ..parallel import collectives
        return collectives.broadcast_object(
            mesh, fn() if mesh.rank == 0 else None)

    # -- telemetry -----------------------------------------------------------

    @property
    def monitor(self):
        if self._monitor is not None:
            return self._monitor
        mon = getattr(self.trainer, "_skew", None)
        if mon is not None:
            return mon
        from ..utils import sketch
        return sketch.MONITOR

    def _managed_tables(self) -> Dict[str, object]:
        return {n: s for n, s in self.trainer.model.ps_specs().items()
                if not s.sparse_as_dense and s.storage != "host_cached"}

    def _shard_positions(self, name: str) -> Optional[np.ndarray]:
        """Measured per-shard load from the published gauges (the loop's
        `record_step_stats` keeps them fresh each step; the stats are
        summed over the ranks, so every rank reads the same)."""
        rep = _metrics.report()
        pat = re.compile(
            r'^exchange\.shard_positions\{shard="(\d+)",table="%s"\}$'
            % re.escape(name))
        vals = {}
        for key, v in rep.items():
            m = pat.match(key)
            if m:
                vals[int(m.group(1))] = v
        if not vals:
            return None
        return np.asarray([vals.get(i, 0.0)
                           for i in range(max(vals) + 1)], np.float64)

    def telemetry(self) -> List[TableTelemetry]:
        mon = self.monitor
        out = []
        for name, spec in self._managed_tables().items():
            sk = mon.sketch(name)
            # optimizer-slot floats per row, as weight-column multiples
            # (Adagrad: one accumulator column per weight column -> 1)
            widths = self.trainer.opt_for(spec).slot_shapes(spec.output_dim)
            slot_cols = int(round(sum(int(v) for v in widths.values())
                                  / max(spec.output_dim, 1)))
            out.append(TableTelemetry(
                name=name, dim=spec.output_dim,
                coverage=sk.coverage(),
                total=float(sk.total),
                top_ids=[(i, e) for i, e, _err in sk.topk()],
                shard_positions=self._shard_positions(name),
                slot_cols=slot_cols))
        return out

    # -- sizing / prime ------------------------------------------------------

    def prime(self, state):
        """Size the placement capacities from the byte budget and attach
        the placement state; call ONCE, before capturing the step (the one
        shape-changing moment: `trainer.graph_epoch` moves once; everything
        after writes into the state's tensors). Needs warm sketches: feed
        the monitor a few batches first. Returns the state with hot caches
        and migration directories attached."""
        tr = self.trainer

        def plan():
            tel = self.telemetry()
            return (self.policy.recommend_wire(tel) if self.manage_wire
                    else None, self.policy.size_hot(tel),
                    self.policy.size_mig(tel))
        rec, sizes, sized_mig = self._shared(plan)
        changed = False
        if self.manage_wire:
            # the formats before the sizing below, so enabling wire
            # management at prime costs no capture of its own
            state, changed = self._apply_wire(state, rec)
            if getattr(tr, "zero_enabled", False) \
                    and tr.dense_wire in ("int8", "sparse_topk") \
                    and not tr.dense_stats:
                # the measured gradient density feeds
                # `recommend_dense_wire`; the stat changes the step's
                # outputs, folded into prime's one capture
                tr.dense_stats = True
                changed = True
        hot_rows = {n: int(h) for n, h in sizes.items() if h > 0}
        # per-table annex capacity off the measured cold-tail imbalance
        # (policy.size_mig); tables the telemetry doesn't cover keep the
        # static default
        mig_rows = {n: int(sized_mig.get(n, self.policy.mig_rows))
                    for n in self._managed_tables()}
        # memory preflight BEFORE the resize: would the grown caches and
        # annexes still fit? A rejection on any rank keeps the CURRENT
        # capacities (no shape change): an oversized plan must never run
        # the card out of memory
        delta = self._resize_delta_bytes(hot_rows, mig_rows)
        if delta > 0:
            from ..utils import memwatch as _memwatch
            if not tr._agree(_memwatch.WATCH.preflight(
                    delta, reason="placement_prime")):
                _trace.event("placement", "prime_rejected",
                             delta_bytes=int(delta))
                hot_rows = self._current_sizes("hot_rows")
                mig_rows = self._current_sizes("mig_rows")
        resized = False
        for attr, val in (("hot_rows", hot_rows), ("mig_rows", mig_rows)):
            cur = getattr(tr, attr)
            cur_map = {n: (cur.get(n, 0) if isinstance(cur, dict)
                           else int(cur)) for n in self._managed_tables()}
            new_map = {n: val.get(n, 0) for n in self._managed_tables()}
            if cur_map != new_map:
                setattr(tr, attr, val)
                resized = True
        if resized:
            state = tr.drop_unplaced(state)
        if changed or resized:
            # shapes and formats are what a graph captured: every
            # CompiledStep captures anew at its next call
            tr.graph_epoch += 1
        self._hot_target = dict(hot_rows)
        for n, h in hot_rows.items():
            _metrics.observe("placement.hot_rows", float(h), "gauge",
                             labels={"table": n})
        for n, m in mig_rows.items():
            _metrics.observe("placement.mig_rows", float(m), "gauge",
                             labels={"table": n})
        _trace.event("placement", "prime",
                     hot_rows=dict(hot_rows),
                     mig_rows=dict(mig_rows),
                     budget_bytes=self.policy.hot_budget_bytes)
        if tr.mig_enabled:
            state = tr.migrate_rows(state)  # attach empty directories
        if tr.hot_enabled:
            state = tr.refresh_hot_rows(state, monitor=self.monitor)
            with self._lock:
                for n in hot_rows:
                    self._last_refresh_step[n] = self._step
                    self._last_refresh_reason[n] = "prime"
        self._primed = True
        return state

    def _current_sizes(self, attr: str) -> Dict[str, int]:
        """The trainer's INSTALLED per-table capacity map for one attr."""
        cur = getattr(self.trainer, attr)
        return {n: (int(cur.get(n, 0)) if isinstance(cur, dict)
                    else int(cur)) for n in self._managed_tables()}

    def _resize_delta_bytes(self, hot_rows: Dict[str, int],
                            mig_rows: Dict[str, int]) -> int:
        """Per-rank byte delta of installing these hot/mig capacities in
        place of the current ones (the trainer's analytic byte model)."""
        tr = self.trainer
        cur_hot = self._current_sizes("hot_rows")
        cur_mig = self._current_sizes("mig_rows")
        delta = 0
        for name, spec in self._managed_tables().items():
            delta += (tr._hot_device_bytes(spec, int(hot_rows.get(name, 0)))
                      - tr._hot_device_bytes(spec, cur_hot.get(name, 0)))
            delta += (tr._mig_device_bytes(spec, int(mig_rows.get(name, 0)))
                      - tr._mig_device_bytes(spec, cur_mig.get(name, 0)))
        return delta

    def _mig_cap(self, name: str) -> int:
        """The table's INSTALLED annex capacity (a shape the trainer holds
        after prime): plans must fit it; falls back to the policy's static
        default before prime sizes the annexes."""
        cap = getattr(self.trainer, "mig_rows", 0)
        if isinstance(cap, dict):
            return int(cap.get(name, 0)) or self.policy.mig_rows
        return int(cap) or self.policy.mig_rows

    # -- decide --------------------------------------------------------------

    def decide(self, state=None) -> PlacementDecision:
        """Run the policy over current telemetry -> a decision (no state
        mutation; `apply` installs it). `state` supplies the installed hot
        sets for churn/gain math; without it the installed set is assumed
        empty (dry-run mode)."""
        tel = self.telemetry()
        sizes = dict(self._hot_target) or self.policy.size_hot(tel)
        tables: Dict[str, TableDecision] = {}
        refresh = migrate = False
        reasons = []
        gauges = []

        def observe(*args, **kw):
            _metrics.observe(*args, **kw)
            gauges.append((args, kw))
        for t in tel:
            H = int(sizes.get(t.name, 0))
            installed = np.zeros((0,), np.int64)
            mig_installed = None
            if state is not None:
                ts = state.tables.get(t.name)
                if ts is not None and ts.hot is not None:
                    installed = self.trainer._np_id_list(ts.hot.ids)
                if ts is not None and ts.mig is not None:
                    mig_installed = self.trainer._np_id_list(ts.mig.ids)
            with self._lock:
                since = self._step - self._last_refresh_step.get(
                    t.name, -10**9)
            due, reason, gain = self.policy.refresh_due(
                t, installed, H, since)
            churn = self.policy.churn(installed, t.top_ids[:H])
            observe("placement.churn", churn, "gauge",
                    labels={"table": t.name})
            observe("placement.predicted_hit_gain", gain, "gauge",
                    labels={"table": t.name})
            hot_ids = np.asarray([i for i, _e in t.top_ids[:H]], np.int64)
            mig_due, mig_reason = self.policy.migration_due(t)
            moves = (np.zeros((0,), np.int64), np.zeros((0,), np.int64))
            if mig_due and t.shard_positions is not None:
                # Plan the FULL directory from the sketch-derived EXPECTED
                # load, not the measured snapshot: the measured vector
                # already reflects the active directory (a fresh plan from
                # it would find nothing and de-migrate the rows doing the
                # balancing), and one step's sample is noisy. Build the
                # un-migrated picture the sketch predicts — per-candidate
                # load `est/cold_total` of the measured cold positions on
                # its hash home, the un-tracked tail uniform — and solve
                # that. Deterministic given the sketch: when converged the
                # plan reproduces the current assignment (install skipped),
                # a drifted-out id stops being a candidate, and a past move
                # whose owner has become the hot spot is re-assigned. The
                # measured vector stays the TRIGGER (`migration_due`).
                S = self.trainer.num_shards
                cur = {}
                if state is not None:
                    ts = state.tables.get(t.name)
                    if ts is not None and ts.mig is not None:
                        cur_ids = self.trainer._np_id_list(ts.mig.ids)
                        cur_own = ts.mig.owners.detach().cpu().numpy()[
                            :cur_ids.size]
                        cur = {i: int(o) for i, o in
                               zip(cur_ids.tolist(), cur_own.tolist())
                               if int(o) >= 0}
                cands = candidate_weights(t.top_ids, hot_ids)
                step_load = float(np.asarray(t.shard_positions,
                                             np.float64).sum())
                hot_set = set(hot_ids.tolist())
                hot_est = sum(float(e) for i, e in t.top_ids
                              if int(i) in hot_set)
                cold_tot = max(t.total - hot_est, 1.0)
                w_steps = [max(float(w), 0.0) / cold_tot * step_load
                           for _i, w in cands]
                tail = max(step_load - sum(w_steps), 0.0)
                base = np.full((S,), tail / S, np.float64)
                for (i, _w), ws in zip(cands, w_steps):
                    base[int(i) % S] += ws
                ids, owners, proj = plan_migration(
                    base, cands, num_shards=S,
                    max_moves=self._mig_cap(t.name),
                    target=self.policy.imbalance_target,
                    total=cold_tot, exclude=hot_ids)
                moves = (ids, owners)
                if dict(zip(ids.tolist(), owners.tolist())) == cur:
                    # converged: the plan reproduces the active directory —
                    # skip the install rather than churning the annex
                    moves = None
                    mig_due = False
                    mig_reason += " (plan unchanged)"
                else:
                    mig_reason += (f"; {ids.size} moves, projected "
                                   f"imbalance {proj:.3f}")
            elif mig_installed is not None and mig_installed.size \
                    and not mig_due:
                # keep the current directory: re-planning to empty would
                # de-migrate a balanced steady state
                moves = None
            tables[t.name] = TableDecision(
                hot_rows=H,
                predicted_hit=t.share_at(H),
                hot_ids=hot_ids,
                moves=moves,
                reason=f"refresh: {reason}; migrate: {mig_reason}")
            refresh |= due
            migrate |= mig_due
            reasons.append(f"{t.name}: {tables[t.name].reason}")
        with self._lock:
            self._decisions += 1
        observe("placement.decisions", 1)
        with self._lock:
            self._decide_gauges = gauges
        return PlacementDecision(tables=tables, refresh=refresh,
                                 migrate=migrate, reason=" | ".join(reasons))

    # -- wire precision ------------------------------------------------------

    def apply_wire(self, state, rec: Dict[str, str]):
        """Install a per-table wire recommendation (`policy.recommend_wire`).
        When every table's RESOLVED format already matches the
        recommendation this is a no-op (nothing captures anew), the steady
        state once the traffic shape stabilizes. A real format change swaps
        `trainer.wire` to a per-table dict, attaches or drops the int8
        error-feedback residuals to match (zeros: EF is a convergence aid,
        not model state), and moves `trainer.graph_epoch` once, counted in
        `placement.wire_rejits`. Every rank calls it with the same `rec`."""
        state, changed = self._apply_wire(state, rec)
        if changed:
            self.trainer.graph_epoch += 1
        return state

    def _apply_wire(self, state, rec: Dict[str, str]):
        """`apply_wire` without the epoch move -> (state, changed)."""
        tr = self.trainer
        if tr.num_shards <= 1:
            return state, False
        managed = self._managed_tables()
        rec = {n: f for n, f in rec.items() if n in managed}
        if all(tr.wire_for(n) == f for n, f in rec.items()):
            with self._lock:
                self._wire_active = {n: tr.wire_for(n) for n in managed}
            return state, False
        new_wire = dict(rec)
        new_wire["*"] = tr.wire_default()
        tr.wire = new_wire
        for n, spec in managed.items():
            ts = state.tables.get(n)
            if ts is None:
                continue
            need = tr.ef_for(n)
            if need and ts.ef is None:
                ts.ef = torch.zeros((ts.weights.shape[0], spec.output_dim),
                                    dtype=torch.float32, device=tr.device)
            elif not need and ts.ef is not None:
                ts.ef = None
        with self._lock:
            self._wire_rejits += 1
            self._wire_active = {n: tr.wire_for(n) for n in managed}
        _metrics.observe("placement.wire_rejits", 1)
        _trace.event("placement", "wire", step=self._step,
                     formats=dict(sorted(self._wire_active.items())))
        return state, True

    def apply_dense_wire(self, state, density=_READ_GAUGE):
        """Density-adaptive dense-gradient wire: read the measured
        `dense.grad_density` gauge (or take `density`, rank 0's reading at
        S > 1), price sparse vs dense via `policy.recommend_dense_wire`,
        and flip the trainer through `MeshTrainer.set_dense_wire` when the
        verdict changes — a counted capture anew, hysteresis and cooldown
        gated. Only active once the operator chose a narrow dense wire
        (int8 or sparse_topk); fp32/bf16 runs are left alone."""
        tr = self.trainer
        if not getattr(tr, "zero_enabled", False):
            return state
        current = tr.dense_wire
        if current not in ("int8", "sparse_topk"):
            return state
        if density is _READ_GAUGE:
            density = _metrics.report().get("dense.grad_density")
        if density is None:
            return state  # stat not published yet (dense_stats off or
            # no step recorded) — nothing measured to decide on
        plan = tr._zero_plan_for(state)
        with self._lock:
            since = self._step - self._last_dense_wire_step
        mode, k, reason = self.policy.recommend_dense_wire(
            float(density), current, chunk=plan.chunk, steps_since=since)
        _metrics.observe("placement.dense_wire_sparse",
                         1.0 if mode == "sparse_topk" else 0.0, "gauge")
        target_k = k if mode == "sparse_topk" else None
        with self._lock:
            self._dense_wire_reason = reason
        if mode == current and target_k == tr.dense_topk:
            return state
        if since < self.policy.dense_wire_cooldown_steps:
            # the policy's cooldown covers mode flips; this also paces
            # same-mode k resizes — every change here captures anew
            return state
        state = tr.set_dense_wire(state, mode, target_k)
        with self._lock:
            self._dense_wire_rejits += 1
            self._last_dense_wire_step = self._step
        _trace.event("placement", "dense_wire", step=self._step,
                     mode=mode, k=target_k, density=float(density),
                     reason=reason[:200])
        return state

    # -- apply ---------------------------------------------------------------

    def apply(self, state, decision: PlacementDecision):
        """Install a decision between steps (writes into the state's
        tensors). Every rank calls it with the same decision."""
        tr = self.trainer
        if decision.migrate and tr.mig_enabled:
            moves = {n: d.moves for n, d in decision.tables.items()
                     if d.moves is not None and d.moves[0].size}
            if moves:
                state = tr.migrate_rows(state, moves)
                with self._lock:
                    self._migrations_applied += 1
                    for n, (ids, _o) in moves.items():
                        self._migrated_rows[n] = int(ids.size)
                _trace.event("placement", "migrate", step=self._step,
                             rows={n: int(m[0].size)
                                   for n, m in moves.items()})
        if decision.refresh and tr.hot_enabled:
            hot_ids = {n: d.hot_ids[:d.hot_rows]
                       for n, d in decision.tables.items() if d.hot_rows}
            state = tr.refresh_hot_rows(state, hot_ids=hot_ids)
            with self._lock:
                for n, d in decision.tables.items():
                    self._last_refresh_step[n] = self._step
                    self._last_refresh_reason[n] = d.reason
                    self._predicted_hit[n] = d.predicted_hit
            for n, d in decision.tables.items():
                _metrics.observe("placement.predicted_hit",
                                 d.predicted_hit, "gauge",
                                 labels={"table": n})
            _metrics.observe("placement.refreshes", 1)
            _trace.event("placement", "refresh", step=self._step,
                         reason=decision.reason[:200])
        return state

    # -- loop hooks ----------------------------------------------------------

    def on_step(self, state, step: Optional[int] = None):
        """Call between training steps, on every rank. Off-cadence this is
        an int compare; on cadence (or, on one rank, when the watcher
        parked a decision) it decides and applies. At S > 1 it acts only
        on cadence steps, with rank 0's decision (a parked one first).
        Returns the (possibly updated) state."""
        self._step = int(step) if step is not None else self._step + 1
        on_cadence = (self.interval_steps > 0
                      and self._step % self.interval_steps == 0)
        if self._mesh() is None:
            with self._lock:
                pending, self._pending = self._pending, None
            if pending is None:
                if not on_cadence:
                    return state
                pending = self.decide(state)
            got = {"decision": pending}
            if self.manage_wire:
                got["wire"] = self.policy.recommend_wire(self.telemetry())
        else:
            if not on_cadence:
                return state
            got = self._shared(lambda: self._lead(state))
            if not self._leads():
                for args, kw in got["gauges"]:
                    _metrics.observe(*args, **kw)
                with self._lock:
                    self._decisions = got["decisions"]
        state = self.apply(state, got["decision"])
        if self.manage_wire:
            state = self.apply_wire(state, got["wire"])
            state = self.apply_dense_wire(
                state, got.get("density", _READ_GAUGE))
        return state

    def _lead(self, state) -> dict:
        """Rank 0's part of a cadence step at S > 1: the parked decision or
        a new one, the wire verdicts, and what the other ranks record."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            pending = self.decide(state)
        with self._lock:
            out = {"decision": pending, "decisions": self._decisions,
                   "gauges": list(self._decide_gauges)}
        if self.manage_wire:
            out["wire"] = self.policy.recommend_wire(self.telemetry())
            out["density"] = _metrics.report().get("dense.grad_density")
        return out

    # -- background watcher --------------------------------------------------

    def start(self, interval_s: float = 5.0) -> None:
        """Start the watcher thread: computes decisions off the training
        thread on a wall-clock cadence and parks them for `on_step` to
        apply (at S > 1 on rank 0 only, installed at the next cadence
        step). Idempotent."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, args=(float(interval_s),), daemon=True,
                name="oetpu-placement-controller")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=10)

    def _watch(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            if not self._leads():
                continue  # only rank 0's decisions are installed
            try:
                # watcher decides WITHOUT state (installed sets unknown ->
                # gain is an upper bound); on_step applies under the real
                # cooldown bookkeeping
                decision = self.decide()
                if decision.refresh or decision.migrate:
                    with self._lock:
                        self._pending = decision
            except Exception:  # noqa: BLE001 — telemetry must never crash
                _metrics.observe("placement.watch_errors", 1)

    # -- operator surface ----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "primed": self._primed,
                "step": self._step,
                "interval_steps": self.interval_steps,
                "hot_budget_bytes": self.policy.hot_budget_bytes,
                "hot_rows": dict(self._hot_target),
                "predicted_hit": dict(self._predicted_hit),
                "last_refresh_step": dict(self._last_refresh_step),
                "last_refresh_reason": dict(self._last_refresh_reason),
                "migrations_applied": self._migrations_applied,
                "migrated_rows": dict(self._migrated_rows),
                "decisions": self._decisions,
                "imbalance_target": self.policy.imbalance_target,
                "manage_wire": self.manage_wire,
                "wire_formats": dict(self._wire_active),
                "wire_rejits": self._wire_rejits,
                "dense_wire": getattr(self.trainer, "dense_wire", None)
                or "fp32",
                "dense_wire_rejits": self._dense_wire_rejits,
                "dense_wire_reason": self._dense_wire_reason,
            }

    def render_text(self) -> str:
        st = self.status()
        lines = [f"controller: step={st['step']} primed={st['primed']} "
                 f"decisions={st['decisions']} "
                 f"budget={st['hot_budget_bytes']}B "
                 f"imbalance_target={st['imbalance_target']}"
                 + (f" manage_wire=on wire_rejits={st['wire_rejits']}"
                    f" dense_wire={st['dense_wire']}"
                    f" dense_wire_rejits={st['dense_wire_rejits']}"
                    if st["manage_wire"] else "")]
        rep = _metrics.report()
        for name in sorted(self._managed_tables()):
            h = st["hot_rows"].get(name, 0)
            imb = rep.get(f'exchange.shard_imbalance{{table="{name}"}}')
            hit = rep.get(f'hot.hit_ratio{{table="{name}"}}')
            parts = [f"table {name}: hot_rows={h}"]
            if self.trainer.num_shards > 1:
                # active per-table wire format (resolved, not the raw knob)
                parts.append(f"wire={self.trainer.wire_for(name)}")
            if st["predicted_hit"].get(name) is not None:
                parts.append(
                    f"predicted_hit={st['predicted_hit'][name]:.3f}")
            if hit is not None:
                parts.append(f"live_hit={hit:.3f}")
            if st["last_refresh_step"].get(name) is not None:
                reason = re.sub(r"\s+", " ", st["last_refresh_reason"]
                                .get(name, ""))[:120]
                parts.append(f"last_refresh=step {st['last_refresh_step'][name]}"
                             f" ({reason})")
            if st["migrated_rows"].get(name):
                parts.append(f"migrated_rows={st['migrated_rows'][name]}")
            if imb is not None:
                parts.append(f"imbalance={imb:.3f}")
            lines.append("  " + " ".join(parts))
        lines.append(f"  migrations_applied={st['migrations_applied']}")
        return "\n".join(lines)
