"""Publisher half of online model sync (port of
`openembedding_tpu/sync/publisher.py`): a persist root as a versioned feed.

A process that can read the persist root (the trainer's, or any other) runs
the serving HTTP server with this publisher registered for a model sign; the
feed rides the serving surface (`serving.ServingHandler`):

    GET /models/<sign>:versions[?after=<step>&wait_s=<s>]
        -> {"format": "oetpu-sync-v1", "base_step", "head_step",
            "deltas": [{"step", "parent", "commit_time", "birth_time",
                        "tables"}, ...],
            "wire_formats": [...]}   (ETag = the head step; with `after`, a
            bounded long poll that answers 304 if nothing newer commits)
    GET /models/<sign>/delta/<step>/meta           -> the delta's meta.json
    GET /models/<sign>/delta/<step>/dense          -> npz, dense params only
    GET /models/<sign>/delta/<step>/table/<name>[?wire=fp32|bf16|int8]
        -> npz {ids (int64, exact), wire (encoded rows), fmt, dim}
        (ETag = the delta's step: committed deltas never change)

Only the committed consistent chain is served (`persist.delta_chain`): an
uncommitted or orphaned delta directory is invisible. Optimizer slots never
enter the feed (`ops/wire.sync_delta_cost`). The feed is host work: numpy
reads of the root, no device.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import wire as wire_mod
from ..persist import COMMIT_FILE, DELTA_FORMAT, delta_chain, list_persists
from ..utils import metrics, trace

# a bounded poll may park a handler thread at most this long
MAX_WAIT_S = 30.0
FEED_FORMAT = "oetpu-sync-v1"


class SyncPublisher:
    """Read-only view of one persist root for the serving HTTP surface.

    Stateless between requests except a meta.json cache — the feed is
    recomputed from the directory listing per call (the same `delta_chain`
    walk restore uses; cheap at serving-feed rates), so a publisher never
    needs to be told when the trainer commits.
    """

    def __init__(self, root: str, *, wire: Optional[str] = None):
        self.root = root
        # default row encoding when the subscriber doesn't pick one
        self.wire = wire_mod.wire_format(wire or "fp32")
        self._meta_cache: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- feed ----------------------------------------------------------------

    def _delta_meta(self, path: str) -> dict:
        with self._lock:
            cached = self._meta_cache.get(path)
        if cached is not None:
            return cached
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with self._lock:
            self._meta_cache[path] = meta  # committed deltas are immutable
        return meta

    def versions(self) -> dict:
        """The committed chain as one JSON document (see module doc)."""
        base, chain = delta_chain(self.root)
        if base is None:
            return {"format": FEED_FORMAT, "base_step": None,
                    "head_step": None, "deltas": [],
                    "wire_formats": list(wire_mod.FORMATS)}
        base_step = list_persists(self.root)[-1][0]
        head = base_step
        deltas: List[dict] = []
        for path in chain:
            meta = self._delta_meta(path)
            step = int(meta["step"])
            try:
                commit_time = os.path.getmtime(
                    os.path.join(path, COMMIT_FILE))
            except OSError:
                continue  # GC'd between the chain walk and here: feed shrinks
            # birth_time: when the trainer CAPTURED the delta's state
            # (persist.py stamps it into meta) — the zero point of the
            # subscriber's end-to-end freshness chain; absent on deltas
            # written before the stamp existed
            deltas.append({"step": step, "parent": int(meta["parent"]),
                           "commit_time": commit_time,
                           "birth_time": meta.get("birth_time"),
                           "tables": list(meta.get("tables", []))})
            head = step
        return {"format": FEED_FORMAT, "base_step": base_step,
                "head_step": head, "deltas": deltas,
                "wire_formats": list(wire_mod.FORMATS)}

    def wait_versions(self, after: Optional[int],
                      wait_s: float = 0.0) -> Tuple[dict, bool]:
        """-> (feed, changed). With `after`, park up to `wait_s` (capped at
        MAX_WAIT_S) until the head advances past it — the handler turns
        changed=False into 304 Not Modified."""
        feed = self.versions()
        if after is None:
            return feed, True
        deadline = time.monotonic() + min(max(wait_s, 0.0), MAX_WAIT_S)
        while (feed["head_step"] is None or feed["head_step"] <= after):
            if time.monotonic() >= deadline:
                return feed, (feed["head_step"] or 0) > after
            time.sleep(0.05)
            feed = self.versions()
        return feed, True

    # -- delta payloads ------------------------------------------------------

    def _delta_path(self, step: int) -> str:
        path = os.path.join(self.root, f"delta_{int(step):012d}")
        if not os.path.exists(os.path.join(path, COMMIT_FILE)):
            raise KeyError(f"no committed delta at step {step}")
        return path

    def delta_meta(self, step: int) -> dict:
        meta = self._delta_meta(self._delta_path(step))
        if meta.get("format") != DELTA_FORMAT:
            raise KeyError(f"delta at step {step} has foreign format "
                           f"{meta.get('format')!r}")
        return meta

    def delta_table(self, step: int, name: str,
                    fmt: Optional[str] = None) -> bytes:
        """One table's touched rows as an npz body: exact int64 ids beside
        the wire-encoded rows (the sync cost gauges update per serve)."""
        from ..persist import _load_delta_table
        fmt = wire_mod.wire_format(fmt or self.wire)
        path = self._delta_path(step)
        if name not in self.delta_meta(step).get("tables", []):
            raise KeyError(f"delta {step} carries no table {name!r}")
        # the fetch-side half of the sync trace: a subscriber's request id
        # (stamped by the serving handler) correlates this serve with the
        # subscriber's sync.fetch span of the same round
        with trace.span("sync", "serve_delta", step=int(step), table=name,
                        wire=fmt):
            ids, weights, _slots = _load_delta_table(path, name)
            dim = int(weights.shape[1]) if weights.ndim == 2 else 0
            payload = wire_mod.np_encode_rows(weights, fmt)
            metrics.observe_sync_cost(
                wire_mod.sync_delta_cost({name: (int(ids.size), dim)}, fmt))
            buf = io.BytesIO()
            np.savez(buf, ids=np.asarray(ids, np.int64), wire=payload,
                     fmt=np.asarray(fmt), dim=np.asarray(dim, np.int64))
            return buf.getvalue()

    def delta_dense(self, step: int) -> bytes:
        """The delta's dense params (npz; optimizer slot entries dropped)."""
        path = self._delta_path(step)
        with np.load(os.path.join(path, "dense.npz")) as z:
            params = {k[len("params/"):]: z[k] for k in z.files
                      if k.startswith("params/")}
        buf = io.BytesIO()
        np.savez(buf, **params)
        return buf.getvalue()
