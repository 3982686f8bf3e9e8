"""The port's copy of `openembedding_tpu/utils/memwatch.py`: the
device-memory ledger, its reconciliation against the device's allocator,
and the preflight gate for re-sizing decisions.

- **Components**: producers register per-rank byte figures under a
  `(component, labels)` key: per-table `table_weights` / `table_slots` /
  `table_keys` / `table_ef` (`MeshTrainer.memory_model`), `hot` / `mig`
  caches and annexes, the ZeRO flat chunks (`parallel/zero.
  plan_device_bytes`), `offload_cache` and `host_store` (host memory,
  flagged `host=True` so device totals leave it out). `publish()` exposes
  the ledger as `memory.bytes{component=,table=}` gauges plus
  `memory.total_bytes` / `memory.host_bytes`.
- **Reconciliation**: `sample_devices(device)` reads the CUDA caching
  allocator's live bytes (`torch.cuda.memory_stats(device)
  ["allocated_bytes.all.current"]`, the counterpart of XLA's
  `bytes_in_use`) and the card's total memory (`torch.cuda.mem_get_info`)
  and publishes `memory.hbm_used` / `memory.hbm_limit` /
  `memory.headroom_ratio` and the model-vs-measured gap
  `memory.model_drift` (signed share of the limit). A CPU device reports
  nothing (None), as a CPU backend does in the JAX package; on a card a
  failure to read the stats raises. Without device stats `budget_bytes`
  (constructor / `configure` / `$OETPU_HBM_BUDGET`) stands in as the limit.
  Each rank is one process with its own allocator: ranks staged on one
  card each judge their own ledger against the whole card's memory unless
  a budget is configured.
- **Preflight**: `preflight(delta_bytes)` answers "may the footprint grow
  by this much" against the limit; the placement controller asks it before
  the resize at `prime`, `MeshTrainer.refresh_hot_rows` before the one
  refresh that allocates. A rejection keeps the old sizes (counted in
  `memory.preflight_rejects`, with a `memory/preflight_reject` flight
  event naming the ask).

Host-side bookkeeping only: nothing here launches work on the device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import metrics


def array_device_bytes(arr) -> int:
    """Bytes of one of this rank's arrays: a tensor's elements (each rank
    is one process holding its own shard, so the tensor is the shard), a
    numpy array's `nbytes`."""
    import torch
    if isinstance(arr, torch.Tensor):
        return int(arr.numel()) * int(arr.element_size())
    return int(getattr(arr, "nbytes", 0))


def _leaves(tree, out: list) -> list:
    """Every tensor or numpy array of a nested structure of dicts, lists,
    tuples, dataclasses (`EmbeddingTableState`, `HotRows`, `MigRows`...)
    and modules (their parameters and buffers)."""
    import torch
    if tree is None:
        return out
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    return out


def _span(t) -> Tuple[int, int]:
    """[start, end) bytes of a tensor's elements within its storage."""
    item = t.element_size()
    start = t.storage_offset() * item
    if t.numel() == 0:
        return start, start
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return start, start + (last + 1) * item


def tree_device_bytes(tree) -> int:
    """Sum of `array_device_bytes` over every array of `tree`, storage that
    several tensors share counted once (slots kept as column views of one
    array): the tensors of one storage count the smaller of their summed
    bytes and the span they cover."""
    import torch
    total = 0
    shared: Dict[int, List[Any]] = {}
    seen = set()
    for leaf in _leaves(tree, []):
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            key = leaf.untyped_storage().data_ptr()
            shared.setdefault(key, []).append(leaf)
        else:
            total += array_device_bytes(leaf)
    for ts in shared.values():
        if len(ts) == 1:
            total += array_device_bytes(ts[0])
            continue
        spans = [_span(t) for t in ts]
        total += min(sum(array_device_bytes(t) for t in ts),
                     max(e for _, e in spans) - min(s for s, _ in spans))
    return total


class MemWatch:
    """The component ledger + device reconciliation + preflight gate."""

    def __init__(self, budget_bytes: Optional[int] = None):
        env = os.environ.get("OETPU_HBM_BUDGET")
        self.budget_bytes = (int(budget_bytes) if budget_bytes is not None
                             else int(env) if env else None)
        self._lock = threading.Lock()
        # guarded-by: self._lock — (component, label items) -> entry
        self._components: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}

    def configure(self, budget_bytes: Optional[int]) -> "MemWatch":
        with self._lock:
            self.budget_bytes = (int(budget_bytes)
                                 if budget_bytes is not None else None)
        return self

    # -- the ledger -----------------------------------------------------------

    def set_component(self, component: str, nbytes: int,
                      labels: Optional[Dict[str, str]] = None,
                      host: bool = False) -> None:
        """Record one component's current per-rank byte figure (idempotent
        per (component, labels); `host=True` marks host-RAM residency:
        reported, but left out of the device total preflight guards)."""
        key = (component, tuple(sorted((labels or {}).items())))
        with self._lock:
            self._components[key] = {
                "component": component, "labels": dict(labels or {}),
                "bytes": int(nbytes), "host": bool(host)}

    def clear(self, component: Optional[str] = None) -> None:
        with self._lock:
            if component is None:
                self._components.clear()
            else:
                for k in [k for k in self._components
                          if k[0] == component]:
                    del self._components[k]

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._components.values()]

    def total_bytes(self, host: bool = False) -> int:
        """Device-resident total (or host-resident with `host=True`)."""
        with self._lock:
            return sum(e["bytes"] for e in self._components.values()
                       if e["host"] == host)

    # -- exposition -----------------------------------------------------------

    def publish(self) -> None:
        """The ledger -> `memory.bytes{component=,table=}` gauges (one per
        entry) + `memory.total_bytes` / `memory.host_bytes` +
        `memory.headroom_ratio` when a limit is known."""
        for e in self.entries():
            labels = {"component": e["component"]}
            labels.update(e["labels"])
            metrics.observe("memory.bytes", float(e["bytes"]), "gauge",
                            labels=labels)
        total = self.total_bytes()
        metrics.observe("memory.total_bytes", float(total), "gauge")
        metrics.observe("memory.host_bytes", float(self.total_bytes(True)),
                        "gauge")
        limit = self._limit()
        if limit:
            metrics.observe("memory.headroom_ratio",
                            max(0.0, 1.0 - total / limit), "gauge")

    def _limit(self) -> Optional[int]:
        """Best known capacity: the device's memory if a card reported it
        in this process, else the configured budget."""
        stats = getattr(self, "_last_device_stats", None)
        if stats and stats.get("limit"):
            return int(stats["limit"])
        return self.budget_bytes

    def sample_devices(self, device=None) -> Optional[Dict[str, int]]:
        """Read the allocator's live bytes and the card's memory on
        `device` (None: the current card where CUDA is present, else the
        CPU) and publish the measured gauges + `memory.model_drift`.
        Returns the `{"used": ..., "limit": ...}` summary, or None on a CPU
        device."""
        import torch
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            return None
        used = int(torch.cuda.memory_stats(device)
                   ["allocated_bytes.all.current"])
        limit = int(torch.cuda.mem_get_info(device)[1])
        self._last_device_stats = {"used": used, "limit": limit}
        metrics.observe("memory.hbm_used", float(used), "gauge")
        if limit:
            metrics.observe("memory.hbm_limit", float(limit), "gauge")
            metrics.observe("memory.headroom_ratio",
                            max(0.0, 1.0 - used / limit), "gauge")
            model = self.total_bytes()
            metrics.observe("memory.model_drift",
                            (used - model) / limit, "gauge")
        return self._last_device_stats

    # -- the resize gate ------------------------------------------------------

    def preflight(self, delta_bytes: int, reason: str = "") -> bool:
        """May the device footprint grow by `delta_bytes`? True when no
        limit is configured/measured or the projected total fits under it;
        False rejects the resize (callers keep their current shapes)."""
        limit = self._limit()
        if limit is None or delta_bytes <= 0:
            return True
        projected = self.total_bytes() + int(delta_bytes)
        if projected <= limit:
            return True
        metrics.observe("memory.preflight_rejects", 1.0)
        from . import trace  # lazy: trace imports metrics at module level
        trace.event("memory", "preflight_reject", reason=reason,
                    delta_bytes=int(delta_bytes), projected=int(projected),
                    limit=int(limit))
        return False

    def export(self) -> Dict[str, Any]:
        """The capsule view: ledger entries + totals + limits."""
        out = {"components": self.entries(),
               "device_total_bytes": self.total_bytes(),
               "host_total_bytes": self.total_bytes(True),
               "budget_bytes": self.budget_bytes}
        stats = getattr(self, "_last_device_stats", None)
        if stats:
            out["device_stats"] = dict(stats)
        return out


WATCH = MemWatch()
