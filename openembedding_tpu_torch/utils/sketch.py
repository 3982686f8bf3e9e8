"""The port's copy of `openembedding_tpu/utils/sketch.py` (pure numpy: the
same top-k, estimates and errors bit for bit on the same stream).

Heavy-hitter sketches: Space-Saving top-K with a count-min backstop.

Parallax (arXiv:1808.02621) measures that sparse-variable access in real
recommendation workloads is heavily Zipf-skewed and argues partitioning
decisions must be driven by MEASURED skew; SparCML (arXiv:1802.08021) shows
sparse-communication cost is dominated by the density/imbalance of exactly
the payloads our fused exchange ships. This module makes that skew cheap to
measure on a live node: which ids are the heavy hitters, per table, with
bounded memory and a documented error bound — without touching the jitted
hot path (the per-shard device-side counters are `parallel/sharded.py`
`exchange_load_stats`; this is the host-side half).

Algorithm — batch-merge Space-Saving with count-min admission:

- A `CountMin` sketch (depth x width, multiply-shift hashing) absorbs EVERY
  unique id of every batch. It only ever over-counts: `query(id) >= true
  count`, with overestimate <= stream_total * depth/width w.h.p.
- A bounded summary of at most `k` entries `(id, est, err)` tracks the
  current heavy hitters. Tracked ids get exact increments. An untracked id
  is admitted with `est = CountMin.query(id)` (its whole history, never an
  undercount) and `err = est - batch_count`; the union is cut back to the
  top-k by `est` (the Space-Saving eviction, batched).

Invariant (the documented error bound, tested in tests/test_skew.py): for
every tracked id, `est - err <= true count <= est`. Any id whose true count
exceeds the smallest tracked `est` is guaranteed to be tracked after its
next appearance (count-min remembers evicted mass, so returning heavy
hitters re-admit at full weight — the classic Space-Saving guarantee without
its pointer churn, vectorized over numpy batches).

`SkewMonitor` is the off-hot-path feeder: callers enqueue raw id batches
(`record_ids(table, ids)` — a bounded queue put, drops + counts when the
worker falls behind), a daemon thread does the `np.unique` + sketch update,
and `publish()` folds the top-K into `skew.*` gauges (rank-labeled, so the
/metrics series set stays bounded at k per table). `GET /statusz` renders
`MONITOR.render_text()`; `tools/skew_report.py` renders a remote node's
scrape.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import metrics

_U64 = np.uint64


def _np_join_ids(pair: np.ndarray) -> np.ndarray:
    """uint32 (..., 2) id pairs (the JAX package's split int64 ids) ->
    int64; an empty/padding pair (high word >= 2^31) becomes -1."""
    hi = pair[..., 0].astype(np.int64)
    lo = pair[..., 1].astype(np.int64)
    out = (hi << 32) | lo
    out[pair[..., 0] >= np.uint32(0x80000000)] = -1
    return out


class CountMin:
    """Count-min sketch over uint64 ids (multiply-shift hashing; width is
    rounded up to a power of two). Only over-counts: `query >= true`."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0x5EE1):
        w = 1
        while w < width:
            w <<= 1
        self.width, self.depth = w, depth
        rng = np.random.default_rng(seed)
        # random ODD multipliers (multiply-shift needs odd a)
        self._a = (rng.integers(1, 1 << 63, size=depth, dtype=np.uint64)
                   * _U64(2) + _U64(1))
        self._shift = _U64(64 - w.bit_length() + 1)
        self.table = np.zeros((depth, w), np.int64)
        self.total = 0

    def _hash(self, row: int, ids: np.ndarray) -> np.ndarray:
        return ((ids * self._a[row]) >> self._shift).astype(np.int64)

    def add(self, ids: np.ndarray, counts: np.ndarray) -> None:
        ids = ids.astype(_U64)
        for r in range(self.depth):
            np.add.at(self.table[r], self._hash(r, ids), counts)
        self.total += int(counts.sum())

    def scale(self, factor: float) -> None:
        """Exponential decay: multiply every cell (and the stream total) by
        `factor` in [0, 1], rounding down — old mass fades geometrically so a
        drifting workload's NEW heavy hitters can outrank stale ones."""
        self.table = np.floor(self.table * factor).astype(np.int64)
        self.total = int(self.total * factor)

    def query(self, ids: np.ndarray) -> np.ndarray:
        if ids.size == 0:
            return np.zeros((0,), np.int64)
        ids = ids.astype(_U64)
        est = self.table[0][self._hash(0, ids)]
        for r in range(1, self.depth):
            est = np.minimum(est, self.table[r][self._hash(r, ids)])
        return est


class SpaceSaving:
    """Bounded top-K heavy-hitter summary (see module doc for the merge rule
    and the `est - err <= true <= est` bound). Thread-safe.

    `decay` (None = off): exponential forgetting — every `update()` batch
    first scales all counts (summary + count-min + stream total) by `decay`,
    so estimates approximate an exponentially-weighted window of
    ~1/(1-decay) batches and a workload shift rotates the top-K instead of
    being drowned by stale mass (tested in tests/test_skew.py). Under decay
    the `est - err <= true <= est` bound holds against the DECAYED true
    count, up to floor-rounding (+-1 per batch per id)."""

    def __init__(self, k: int = 64, cm_width: int = 2048, cm_depth: int = 4,
                 seed: int = 0x5EE1, decay: Optional[float] = None):
        self.k = int(k)
        if decay is not None and not (0.0 < decay <= 1.0):
            raise ValueError(f"decay={decay}: expected a factor in (0, 1]")
        self.decay = None if decay in (None, 1.0) else float(decay)
        self.cm = CountMin(cm_width, cm_depth, seed)
        # summary arrays swap atomically under the lock (update() from the
        # SkewMonitor worker vs topk()/coverage() from serving threads);
        # `cm` is only ever touched while holding it too
        self._ids = np.zeros((0,), np.int64)   # sorted; guarded-by: self._lock
        self._est = np.zeros((0,), np.int64)   # guarded-by: self._lock
        self._err = np.zeros((0,), np.int64)   # guarded-by: self._lock
        self._lock = threading.Lock()

    @property
    def total(self) -> int:
        """Ids seen (valid positions; the share denominator)."""
        return self.cm.total

    def update(self, ids) -> None:
        """Absorb one id batch (any shape; split-pair (n, 2) uint32 batches
        re-join to int64; negative ids — serving padding — are dropped)."""
        ids = np.asarray(ids)
        if ids.dtype == np.uint32 and ids.ndim >= 2 and ids.shape[-1] == 2:
            ids = _np_join_ids(ids.reshape(-1, 2))
        ids = ids.reshape(-1).astype(np.int64, copy=False)
        ids = ids[ids >= 0]
        if ids.size == 0:
            return
        uniq, cnt = np.unique(ids, return_counts=True)
        cnt = cnt.astype(np.int64)
        with self._lock:
            if self.decay is not None:
                self.cm.scale(self.decay)
                self._est = np.floor(self._est * self.decay).astype(np.int64)
                self._err = np.floor(self._err * self.decay).astype(np.int64)
            self.cm.add(uniq, cnt)
            n = self._ids.shape[0]
            if n:
                pos = np.searchsorted(self._ids, uniq)
                pos_c = np.minimum(pos, n - 1)
                hit = self._ids[pos_c] == uniq
            else:
                pos_c = np.zeros(uniq.shape, np.int64)
                hit = np.zeros(uniq.shape, bool)
            # tracked ids: exact increment (uniq is unique -> no dup targets)
            np.add.at(self._est, pos_c[hit], cnt[hit])
            new_ids, new_cnt = uniq[~hit], cnt[~hit]
            if new_ids.size:
                est_new = self.cm.query(new_ids)  # full history, >= true
                merged_ids = np.concatenate([self._ids, new_ids])
                merged_est = np.concatenate([self._est, est_new])
                merged_err = np.concatenate([self._err, est_new - new_cnt])
                if merged_ids.shape[0] > self.k:
                    keep = np.argsort(-merged_est, kind="stable")[:self.k]
                else:
                    keep = np.arange(merged_ids.shape[0])
                order = keep[np.argsort(merged_ids[keep], kind="stable")]
                self._ids = merged_ids[order]
                self._est = merged_est[order]
                self._err = merged_err[order]

    def topk(self, n: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """[(id, est, err)] by descending estimate; `est - err <= true <=
        est` for each."""
        with self._lock:
            order = np.argsort(-self._est, kind="stable")
            if n is not None:
                order = order[:n]
            return [(int(self._ids[i]), int(self._est[i]), int(self._err[i]))
                    for i in order]

    def coverage(self, ks: Optional[List[int]] = None
                 ) -> List[Tuple[int, float]]:
        """Coverage curve [(k, cumulative share of the observed stream the
        top-k tracked ids absorb)] — THE sizing input for
        `MeshTrainer(hot_rows=...)`: pick the knee where extra rows stop
        buying traffic. Defaults to powers of two up to the tracked count.
        Shares use the (possibly over-counted) estimates, so the curve is an
        upper bound with the same `est` semantics as `topk` — CLAMPED to
        [0, 1]: count-min over-counts (and `scale()`'s floor-rounding can
        shrink the stream total faster than the tracked estimates), so the
        raw cumulative sum can exceed the total; a share above 1.0 is
        meaningless to a sizing consumer and a decayed-to-zero total must
        not divide. The curve is monotone non-decreasing by construction
        (cumsum of non-negative estimates, preserved by the clamp)."""
        with self._lock:
            est = np.sort(self._est)[::-1].astype(np.float64)
            total = float(max(self.cm.total, 1))
        est = np.maximum(est, 0.0)
        cum = np.minimum(np.cumsum(est) / total, 1.0)
        if ks is None:
            ks, k = [], 1
            while k < est.size:
                ks.append(k)
                k *= 2
            if est.size:
                ks.append(int(est.size))
        return [(int(k), float(cum[min(int(k), est.size) - 1]))
                for k in ks if k >= 1 and est.size]


class SkewMonitor:
    """Per-table sketch registry fed off the hot path (bounded queue + one
    daemon worker; a full queue DROPS the batch and counts it — telemetry
    must shed load before it slows the path it measures)."""

    def __init__(self, k: int = 64, queue_size: int = 64,
                 sync: bool = False, decay: Optional[float] = None):
        self.k = k
        self.sync = sync
        self.decay = decay  # per-batch exponential forgetting (SpaceSaving)
        self._sketches: Dict[str, SpaceSaving] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        # guarded-by: self._lock
        self._thread: Optional[threading.Thread] = None

    def sketch(self, table: str) -> SpaceSaving:
        with self._lock:
            sk = self._sketches.get(table)
            if sk is None:
                sk = self._sketches[table] = SpaceSaving(self.k,
                                                         decay=self.decay)
            return sk

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._sketches)

    def observe(self, table: str, ids) -> bool:
        """Enqueue one id batch for `table`. Returns False when dropped."""
        if self.sync:
            self.sketch(table).update(ids)
            return True
        self._ensure_worker()
        try:
            self._q.put_nowait((table, ids))
            return True
        except queue.Full:
            metrics.observe("skew.dropped_batches", 1)
            return False

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="oetpu-skew-monitor")
                self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:  # close() sentinel: drain reached, exit
                self._q.task_done()
                return
            table, ids = item
            try:
                self.sketch(table).update(ids)
            except Exception:  # noqa: BLE001 — telemetry must never crash
                metrics.observe("skew.update_errors", 1)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every enqueued batch is folded in (tests, end-of-run
        reports)."""
        if not self.sync:
            self._q.join()

    def close(self) -> None:
        """Stop the worker after folding everything already queued.
        Idempotent; a later `observe` restarts the worker, so close is a
        quiesce point, not an end-of-life. (Before the round-19 oeweave
        audit the worker had NO stop path at all: every monitor leaked its
        thread until process exit.)"""
        if self.sync:
            return
        with self._lock:
            t, self._thread = self._thread, None
        if t is None or not t.is_alive():
            return
        self._q.put(None)  # sentinel queues BEHIND pending batches
        t.join(timeout=5)

    def reset(self) -> None:
        with self._lock:
            self._sketches.clear()

    def publish(self) -> None:
        """Fold the current top-K into `skew.*` gauges. Rank-labeled series
        (`skew.hot_id_count{table=,rank=}`) keep the /metrics series set
        bounded at k per table however the hot set shifts."""
        for table in self.tables():
            sk = self.sketch(table)
            labels = {"table": table}
            metrics.observe("skew.stream_ids", float(sk.total), "gauge",
                            labels=labels)
            top = sk.topk()
            metrics.observe("skew.tracked", float(len(top)), "gauge",
                            labels=labels)
            for rank, (hid, est, err) in enumerate(top):
                rl = {"table": table, "rank": str(rank)}
                metrics.observe("skew.hot_id", float(hid), "gauge", labels=rl)
                metrics.observe("skew.hot_id_count", float(est), "gauge",
                                labels=rl)
                metrics.observe("skew.hot_id_error", float(err), "gauge",
                                labels=rl)

    def render_text(self, top: int = 10) -> str:
        """Per-table hot-id table (the /statusz and `--skew-report` view)."""
        tables = self.tables()
        if not tables:
            return "(no id streams observed)"
        lines = []
        for table in tables:
            sk = self.sketch(table)
            total = max(sk.total, 1)
            lines.append(f"table {table}: {sk.total} ids seen, "
                         f"top-{top} of {len(sk.topk())} tracked "
                         "(est - err <= true <= est)")
            for rank, (hid, est, err) in enumerate(sk.topk(top)):
                lines.append(f"  #{rank:<2d} id={hid:<20d} est={est:<10d} "
                             f"err<={err:<8d} share~{est / total:6.2%}")
            cov = sk.coverage()
            if cov:
                # the hot_rows sizing curve (cumulative traffic share vs
                # top-K), same numbers tools/skew_report.py prints offline
                lines.append("  coverage: " + "  ".join(
                    f"top{k}={share:.1%}" for k, share in cov))
        return "\n".join(lines)


MONITOR = SkewMonitor()


def record_ids(table: str, ids) -> bool:
    """Feed one id batch into the global skew monitor (off the hot path —
    bounded-queue put; drops are counted in `skew.dropped_batches`)."""
    return MONITOR.observe(table, ids)


def shard_balance_text() -> str:
    """Render the per-shard exchange load gauges (`exchange.shard_rows` /
    `shard_positions` / `bucket_fill`, recorded by
    `metrics.record_step_stats` from the jitted step's stats) as a table."""
    import re

    rep = metrics.report()
    pat = re.compile(r'^exchange\.(shard_rows|shard_positions|bucket_fill)'
                     r'\{shard="(\d+)",table="([^"]+)"\}$')
    per: Dict[str, Dict[str, Dict[int, float]]] = {}
    for key, v in rep.items():
        m = pat.match(key)
        if m:
            stat, shard, table = m.group(1), int(m.group(2)), m.group(3)
            per.setdefault(table, {}).setdefault(stat, {})[shard] = v
    if not per:
        return "(no per-shard exchange stats — sharded trainer only)"
    lines = []
    for table in sorted(per):
        stats = per[table]
        imb = rep.get(f'exchange.shard_imbalance{{table="{table}"}}')
        lines.append(f"table {table}:"
                     + (f" imbalance(max/mean)={imb:.3f}"
                        if imb is not None else ""))
        for stat in ("shard_positions", "shard_rows", "bucket_fill"):
            if stat not in stats:
                continue
            vals = [stats[stat].get(i, 0.0)
                    for i in range(max(stats[stat]) + 1)]
            fmt = ("{:.3f}" if stat == "bucket_fill" else "{:.0f}")
            lines.append(f"  {stat:<16s} "
                         + " ".join(fmt.format(v) for v in vals))
    return "\n".join(lines)
