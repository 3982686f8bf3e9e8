"""The port's copy of `openembedding_tpu/placement/policy.py`, the
placement decision math: pure numpy, no side effects, decisions equal to
the JAX package's on the same telemetry (reason strings included).

Everything here maps MEASURED telemetry (sketch coverage curves, per-shard
load vectors, the live hot-cache hit ratio) to placement decisions. The
functions are free of trainer and serving dependencies, so the same
policy runs live inside `PlacementController`, dry-run from a /metrics
scrape, and in unit tests with synthetic curves.

Budget semantics: `hot_budget_bytes` bounds the PER-RANK bytes of
replicated hot-row payload — sum over tables of H_t rows x row_bytes_t
(fp32 weights + fp32 optimizer-slot columns; the thing every rank carries
a copy of AND the backward's hot reduce ships every step). The solver walks
each table's coverage curve and spends the budget on the segments with the
highest traffic-per-byte — the knee of a heavily skewed table beats the
head of a flat one, which is exactly "budget flows to the most skewed
tables".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def row_bytes(dim: int, slot_cols: int = 1) -> int:
    """Replicated bytes one cached row costs: fp32 weights + fp32 optimizer
    slot columns (Adagrad: one accumulator column per weight column)."""
    return 4 * dim * (1 + slot_cols)


@dataclasses.dataclass
class TableTelemetry:
    """One table's measured inputs to the policy (built from live sketches
    by the controller, or from a /metrics scrape)."""

    name: str
    dim: int
    # coverage curve [(k, cumulative traffic share of the top-k ids)] —
    # `SpaceSaving.coverage()`; monotone, <= 1.0
    coverage: List[Tuple[int, float]]
    total: float = 0.0                 # ids observed (the share denominator)
    # heavy hitters [(id, est)] hottest-first (the promotion candidates)
    top_ids: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # per-shard duplicate-weighted load (exchange.shard_positions); None
    # until the trainer has published a step's stats
    shard_positions: Optional[np.ndarray] = None
    slot_cols: int = 1

    def share_at(self, k: int) -> float:
        """Interpolated cumulative traffic share of the top-k ids."""
        if k <= 0 or not self.coverage:
            return 0.0
        pts = [(0, 0.0)] + [(int(a), float(b)) for a, b in self.coverage]
        for (k0, s0), (k1, s1) in zip(pts, pts[1:]):
            if k <= k1:
                if k1 == k0:
                    return s1
                return s0 + (s1 - s0) * (k - k0) / (k1 - k0)
        return pts[-1][1]


@dataclasses.dataclass
class TableDecision:
    hot_rows: int                     # ids to install in the hot cache
    predicted_hit: float              # sketch-predicted hit ratio at that H
    hot_ids: np.ndarray               # the ids, hottest first
    moves: Tuple[np.ndarray, np.ndarray]  # (ids, owners) for migrate_rows
    reason: str = ""


@dataclasses.dataclass
class PlacementDecision:
    tables: Dict[str, TableDecision]
    refresh: bool                     # install the hot sets this cycle?
    migrate: bool                     # install the move lists this cycle?
    reason: str = ""


class PlacementPolicy:
    """Sizing + hysteresis rules. Stateless: every method is a pure function
    of its telemetry arguments, so the controller (and the dry-run tool) own
    all bookkeeping.

    - `hot_budget_bytes`: the ONE knob operators must set — per-device
      replicated-cache byte budget (see module doc).
    - `mig_rows`: migration annex scale (capacity is static per table;
      contents rotate freely). The annex costs rows x `row_bytes` per
      shard per table — cheap next to the hot budget, so it is a default,
      not a budget term. `size_mig` adapts the per-table capacity within
      [mig_rows/4, 4*mig_rows] off the measured cold-tail imbalance; the
      flat value is the no-telemetry fallback.
    - `refresh_min_gain`: predicted hit-ratio gain (new top-H coverage minus
      installed-set coverage) a refresh must clear — the hysteresis band
      that stops the controller chasing sketch noise.
    - `refresh_cooldown_steps`: hard floor between refreshes, whatever the
      predicted gain says.
    - `imbalance_target`: migrate only while max/mean `shard_positions`
      exceeds this (1.0 = perfectly flat; the E2E gate accepts <= 1.15).
    """

    def __init__(self, hot_budget_bytes: int, *, mig_rows: int = 64,
                 refresh_min_gain: float = 0.02,
                 refresh_cooldown_steps: int = 50,
                 imbalance_target: float = 1.05,
                 min_hot_rows: int = 0):
        if hot_budget_bytes < 0:
            raise ValueError(f"hot_budget_bytes={hot_budget_bytes} < 0")
        self.hot_budget_bytes = int(hot_budget_bytes)
        self.mig_rows = int(mig_rows)
        self.refresh_min_gain = float(refresh_min_gain)
        self.refresh_cooldown_steps = int(refresh_cooldown_steps)
        self.imbalance_target = float(imbalance_target)
        self.min_hot_rows = int(min_hot_rows)

    # -- auto-sizing ---------------------------------------------------------

    def size_hot(self, tables: Sequence[TableTelemetry]) -> Dict[str, int]:
        """Solve per-table H against the byte budget: greedy
        traffic-per-byte over every table's coverage-curve segments.

        Each segment (k0 -> k1) of a table's curve buys
        `(share(k1) - share(k0)) * total` absolute traffic for
        `(k1 - k0) * row_bytes(dim)` replicated bytes; segments are taken
        best-rate first (a curve's own segments stay in order — coverage is
        concave in practice, and out-of-order picks are impossible anyway
        because a later segment's rate only falls). Partial segments
        allocate proportionally, so small budgets still split sensibly."""
        segs = []  # (rate, table_idx, seg_idx, k0, k1, bytes_per_row)
        for ti, t in enumerate(tables):
            bpr = row_bytes(t.dim, t.slot_cols)
            pts = [(0, 0.0)] + [(int(k), float(s)) for k, s in t.coverage]
            for si, ((k0, s0), (k1, s1)) in enumerate(zip(pts, pts[1:])):
                if k1 <= k0:
                    continue
                gain = max(s1 - s0, 0.0) * max(t.total, 1.0)
                rate = gain / ((k1 - k0) * bpr)
                segs.append((rate, ti, si, k0, k1, bpr))
        segs.sort(key=lambda x: -x[0])
        alloc = {t.name: 0 for t in tables}
        done_upto = {t.name: 0 for t in tables}
        budget = float(self.hot_budget_bytes)
        # multi-pass: a segment can only extend its table's allocated
        # prefix, and float jitter in the rates can order two equal-rate
        # segments against curve order — sweep until a pass allocates
        # nothing so no affordable segment is ever skipped permanently
        progress = True
        while progress and budget > 0:
            progress = False
            for rate, ti, _si, k0, k1, bpr in segs:
                t = tables[ti]
                done = done_upto[t.name]
                if rate <= 0 or budget < bpr or done < k0 or done >= k1:
                    continue
                rows = min(k1 - done, int(budget // bpr))
                if rows <= 0:
                    continue
                alloc[t.name] += rows
                done_upto[t.name] = done + rows
                budget -= rows * bpr
                progress = True
        for t in tables:
            if self.min_hot_rows and t.coverage:
                alloc[t.name] = max(alloc[t.name], self.min_hot_rows)
        return alloc

    def size_mig(self, tables: Sequence[TableTelemetry]) -> Dict[str, int]:
        """Per-table migration annex capacity M off the MEASURED cold-tail
        imbalance (`shard_positions` — the same vector `migration_due`
        gates on).

        The annex is a static shape: every row costs `row_bytes` per shard
        whether used or not, and capacity can only change at a re-jit. A
        flat table wastes the static default; a heavily skewed one starves
        at it. Sizing rule per table: count the sketch heavy hitters homed
        on the hottest shard whose estimated step traffic covers that
        shard's excess over `imbalance_target`, double it (draining the
        head exposes followers the planner also wants to move), clamp to
        [mig_rows/4, 4*mig_rows]. A within-target table gets the floor; a
        table whose tracked mass cannot cover the excess gets the cap (the
        skew lives below the sketch's horizon — give the planner room).
        Tables with no load vector or no sketch data keep the static
        `mig_rows` default."""
        lo = max(self.mig_rows // 4, 1)
        hi = max(self.mig_rows * 4, 1)
        out: Dict[str, int] = {}
        for t in tables:
            if t.shard_positions is None or not t.top_ids:
                out[t.name] = self.mig_rows
                continue
            load = np.asarray(t.shard_positions, np.float64)
            mean = float(load.mean())
            if mean <= 0:
                out[t.name] = self.mig_rows
                continue
            S = int(load.size)
            hot_shard = int(load.argmax())
            excess = float(load[hot_shard]) - self.imbalance_target * mean
            if excess <= 0:
                out[t.name] = lo
                continue
            step_total = float(load.sum())
            total = max(t.total, 1.0)
            need, covered = 0, 0.0
            for i, e in t.top_ids:
                if int(i) % S != hot_shard:
                    continue
                need += 1
                covered += max(float(e), 0.0) / total * step_total
                if covered >= excess:
                    break
            if covered < excess:
                out[t.name] = hi
            else:
                out[t.name] = int(np.clip(2 * need, lo, hi))
        return out

    # -- refresh hysteresis --------------------------------------------------

    @staticmethod
    def churn(installed_ids, top_ids) -> float:
        """Top-K rotation rate: share of the current sketch top-H missing
        from the installed hot set (0 = identical, 1 = fully rotated)."""
        top = [i for i, _ in top_ids]
        if not top:
            return 0.0
        inst = set(int(i) for i in np.asarray(
            installed_ids, np.int64).reshape(-1).tolist())
        missing = sum(1 for i in top if int(i) not in inst)
        return missing / len(top)

    def refresh_due(self, t: TableTelemetry, installed_ids, H: int,
                    steps_since: int) -> Tuple[bool, str, float]:
        """Hysteresis gate for one table -> (due, reason, predicted_gain).
        Predicted gain = coverage of the sketch's CURRENT top-H minus the
        coverage the INSTALLED set still commands (est mass of installed ids
        over the stream total) — i.e. the hit-ratio points a refresh is
        expected to buy. Never fires inside the cooldown."""
        if H <= 0 or not t.top_ids:
            return False, "no hot budget or no sketch data", 0.0
        if steps_since < self.refresh_cooldown_steps:
            return False, f"cooldown ({steps_since} < " \
                f"{self.refresh_cooldown_steps} steps)", 0.0
        inst = set(int(i) for i in np.asarray(
            installed_ids, np.int64).reshape(-1).tolist())
        total = max(t.total, 1.0)
        est = {int(i): float(e) for i, e in t.top_ids}
        cov_installed = sum(est.get(i, 0.0) for i in inst) / total
        cov_new = sum(float(e) for _i, e in t.top_ids[:H]) / total
        gain = cov_new - cov_installed
        if not inst:
            return True, "initial promotion", gain
        if gain >= self.refresh_min_gain:
            return True, (f"predicted hit gain {gain:.3f} >= "
                          f"{self.refresh_min_gain}"), gain
        return False, f"predicted gain {gain:.3f} below threshold", gain

    # -- wire-precision recommendation ---------------------------------------

    # knobs for `recommend_wire` (class-level so an offline dry run and the
    # controller agree by construction):
    # a table whose rows are at most this wide ships fp32 — the id lanes
    # dominate its wire bytes and int8's scale lanes would WIDEN dim-1 rows
    wire_fp32_max_dim = 4
    # int8 needs real skew (EF residuals converge on revisited rows) and
    # enough row width to amortize the in-band scale lanes
    wire_int8_min_dim = 8
    wire_int8_min_share = 0.5          # top-`wire_int8_top_k` traffic share
    wire_int8_top_k = 1024

    def recommend_wire(self, tables: Sequence[TableTelemetry]) \
            -> Dict[str, str]:
        """Per-table wire format off the measured coverage curves — the
        precision dimension of the placement budget (feeds
        `MeshTrainer(wire={...})` via the controller, or a dry run):

        - dim <= `wire_fp32_max_dim`: "fp32" — tiny rows are id-lane bound,
          quantizing them buys nothing and costs scale lanes;
        - dim >= `wire_int8_min_dim` AND the top-1024 ids carry >=
          `wire_int8_min_share` of traffic: "int8" — wide rows under heavy
          skew are exactly where 4x compression + error feedback holds AUC
          (the JAX package's round-13 finding);
        - otherwise "bf16" — the unbiased 2x default for flat-traffic or
          unmeasured tables.
        """
        out: Dict[str, str] = {}
        for t in tables:
            if t.dim <= self.wire_fp32_max_dim:
                out[t.name] = "fp32"
            elif (t.dim >= self.wire_int8_min_dim
                  and t.share_at(self.wire_int8_top_k)
                  >= self.wire_int8_min_share):
                out[t.name] = "int8"
            else:
                out[t.name] = "bf16"
        return out

    # -- dense-wire recommendation -------------------------------------------

    # knobs for `recommend_dense_wire` (class-level for the same reason as
    # the `recommend_wire` set). The sparse_topk codec ships ~5.125 B per
    # transmitted element (int8 value + in-band fp32 block scales + a
    # bitcast int32 index lane) vs int8 dense's ~1.125 B per element, so
    # sparse pays off only below density ~0.22 — the Densifying
    # (arXiv:1905.04035) crossover for this payload shape.
    dense_wire_crossover = 0.22
    # hysteresis band, as fractions of the crossover: enter sparse only
    # well below it, fall back to dense only near it — a density sitting on
    # the boundary must not thrash re-jits
    dense_sparse_enter = 0.6
    dense_sparse_exit = 0.9
    # k headroom over the measured nonzeros per destination row, so a
    # density estimate that wobbles upward does not silently truncate
    dense_topk_margin = 1.5
    # re-jit floor: flipping the dense wire recompiles the step
    dense_wire_cooldown_steps = 200
    # sparse k is padded to the in-band codec's block (ops/wire.INBAND_BLOCK
    # — mirrored here so the policy stays numpy-pure)
    dense_topk_block = 32

    def recommend_dense_wire(self, density: float, current: str = "int8", *,
                             chunk: Optional[int] = None,
                             steps_since: int = 10**9) \
            -> Tuple[str, Optional[int], str]:
        """Dense-gradient wire off the MEASURED gradient density
        (`dense.grad_density` — mean nonzero fraction over the fleet) ->
        (mode, k, reason). `mode` is "sparse_topk" or the dense fallback
        (`current` when already dense, else "int8"); `k` sizes the sparse
        payload (None for dense). Hysteresis: enter sparse below
        `dense_sparse_enter x crossover`, leave above
        `dense_sparse_exit x crossover`, never flip inside the cooldown."""
        dense_mode = current if current != "sparse_topk" else "int8"
        d = float(density)
        if not np.isfinite(d) or d < 0:
            return dense_mode, None, f"density {density!r} unusable"
        enter = self.dense_sparse_enter * self.dense_wire_crossover
        exit_ = self.dense_sparse_exit * self.dense_wire_crossover
        want_sparse = (d <= enter if current != "sparse_topk"
                       else d < exit_)
        target = "sparse_topk" if want_sparse else dense_mode
        if target != current and steps_since < self.dense_wire_cooldown_steps:
            k = None
            if current == "sparse_topk" and chunk:
                k = self._dense_topk(d, int(chunk))
            return current, k, (
                f"cooldown ({steps_since} < "
                f"{self.dense_wire_cooldown_steps} steps)")
        if not want_sparse:
            if current == "sparse_topk":
                return dense_mode, None, (
                    f"density {d:.3f} >= exit {exit_:.3f} "
                    f"(crossover {self.dense_wire_crossover})")
            return dense_mode, None, (
                f"density {d:.3f} above enter {enter:.3f} "
                f"(crossover {self.dense_wire_crossover})")
        k = self._dense_topk(d, int(chunk)) if chunk else None
        side = "<" if current == "sparse_topk" else "<="
        bound = exit_ if current == "sparse_topk" else enter
        return "sparse_topk", k, (
            f"density {d:.3f} {side} {bound:.3f} "
            f"(crossover {self.dense_wire_crossover})")

    def _dense_topk(self, density: float, chunk: int) -> int:
        """Sparse payload size for a measured density: margin over the
        expected nonzeros per destination row, padded to the codec block,
        clamped to the row."""
        if chunk <= 0:
            return 0
        k = int(np.ceil(max(density, 0.0) * chunk * self.dense_topk_margin))
        b = self.dense_topk_block
        k = -(-max(k, 1) // b) * b
        return max(1, min(k, chunk))

    # -- cold-tail migration gate --------------------------------------------

    def migration_due(self, t: TableTelemetry) -> Tuple[bool, str]:
        if t.shard_positions is None:
            return False, "no shard load vector yet"
        load = np.asarray(t.shard_positions, np.float64)
        mean = load.mean()
        if mean <= 0:
            return False, "no measured load"
        imb = float(load.max() / mean)
        if imb > self.imbalance_target:
            return True, (f"imbalance {imb:.3f} > target "
                          f"{self.imbalance_target}")
        return False, f"imbalance {imb:.3f} within target"
