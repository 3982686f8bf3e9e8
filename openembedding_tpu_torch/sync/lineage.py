"""Delta lineage (port of `openembedding_tpu/sync/lineage.py`): a per-delta
birth -> commit -> publish -> fetch -> apply -> swap -> serve book.

The subscriber (`sync/subscriber.py`) measures each hop of a delta's
journey; the predict path (`serving.py`) closes the chain with the first
request served at that version. `/timelinez` exports the book,
`tools/fleet_timeline.py` renders it across nodes, capsules bundle it and
`/fleetz` prints the last hop breakdown.

One record per (model sign, step). Stamps are wall times in the clock
domain of the process that wrote them; `offset_s` is the writer's estimated
offset to the publisher's clock (Cristian-style, from request round trips),
so a reader can translate publisher-domain stamps (birth, commit) into the
local domain. Hop durations (`hops`, milliseconds) are computed by the
subscriber at swap time.

The book is bounded (the oldest (sign, step) goes first), and every method
is O(1) and never raises: it sits on the predict path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ..utils import metrics, trace


class LineageBook:
    """Bounded ledger of per-delta lineage records keyed by (sign, step)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        # (sign, step) -> record dict; insertion-ordered for eviction
        self._records: "OrderedDict[tuple, Dict[str, Any]]" = \
            OrderedDict()  # guarded-by: self._lock

    def record(self, sign: str, step: int, **stamps) -> None:
        """Merge stamps into the (sign, step) record, creating it if new.
        Known stamps: trace_id, birth, commit, seen, fetched, applied,
        swapped, first_serve (wall times), hops (dict of hop->ms),
        offset_s (estimated publisher-clock offset). Later writes win for
        scalar stamps; `hops` dicts are merged key-wise."""
        key = (str(sign), int(step))
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = {"sign": key[0], "step": key[1]}
                self._records[key] = rec
                while len(self._records) > self._capacity:
                    self._records.popitem(last=False)
            else:
                self._records.move_to_end(key)
            for k, v in stamps.items():
                if v is None:
                    continue
                if k == "hops" and isinstance(rec.get("hops"), dict) \
                        and isinstance(v, dict):
                    rec["hops"].update(v)
                else:
                    rec[k] = dict(v) if k == "hops" and isinstance(v, dict) \
                        else v

    def note_serve(self, sign: str, step: int,
                   now: Optional[float] = None) -> None:
        """Close a delta's chain with its FIRST predict at that version:
        idempotent (only the first call per (sign, step) lands), O(1), and
        no-throw — it runs inside the predict handler."""
        try:
            import time
            key = (str(sign), int(step))
            now = time.time() if now is None else float(now)
            with self._lock:
                rec = self._records.get(key)
                if rec is None or rec.get("first_serve") is not None:
                    return
                rec["first_serve"] = now
                swapped = rec.get("swapped")
                hops = rec.setdefault("hops", {})
                serve_ms = None
                if swapped is not None:
                    serve_ms = max(0.0, (now - float(swapped)) * 1e3)
                    hops["serve"] = serve_ms
            if serve_ms is not None:
                metrics.observe("sync.hop_ms", serve_ms, "hist",
                                labels={"hop": "serve"})
            trace.event("sync", "first_serve", model=sign, step=int(step))
        except Exception:
            pass

    def get(self, sign: str, step: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._records.get((str(sign), int(step)))
            return dict(rec) if rec is not None else None

    def last(self, sign: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """The most recently touched record (optionally for one sign)."""
        with self._lock:
            for key in reversed(self._records):
                if sign is None or key[0] == str(sign):
                    return dict(self._records[key])
        return None

    def export(self, sign: Optional[str] = None) -> List[Dict[str, Any]]:
        """All records oldest-first (the /timelinez + capsule payload)."""
        with self._lock:
            return [dict(rec) for key, rec in self._records.items()
                    if sign is None or key[0] == str(sign)]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


BOOK = LineageBook()

# canonical hop order of a delta's journey: publisher-side commit, feed
# publication, subscriber fetch/apply/swap, first predict at the version
HOP_ORDER = ("commit", "publish", "fetch", "apply", "swap", "serve")


def note_serve(sign: str, step: int) -> None:
    """Module-level convenience for the predict path."""
    BOOK.note_serve(sign, step)
