"""Serving: model registry, model manager, REST admin + inference server.

Port of `openembedding_tpu/serving.py`: the file-based `ModelRegistry`, a
`ModelManager` of servables (a standalone export at `shard_num == 1`, a
checkpoint served from `shard_num` table shards above it), and the REST
routes

    GET    /models                 registry listing
    GET    /models/<sign>          one registry entry
    GET    /healthz
    POST   /models                 {model_sign, model_uri, replica_num, shard_num}
    POST   /models/<sign>/pull     {variable, ids} (npz with
                                   `Accept: application/octet-stream`)
    POST   /models/<sign>/predict  {sparse: {feature: ids}, dense}
    DELETE /models/<sign>          (stops the model's subscriber)
    GET    /nodes                  this node's info
    DELETE /nodes/<id>             shut the node down

online model sync (`sync/`), as the JAX package serves it:

    GET    /models/<sign>:versions[?after=&wait_s=]   the publisher's feed
    GET    /models/<sign>/delta/<step>/{meta,dense,table/<name>[?wire=]}
    GET    /models/<sign>:syncstate                   the subscriber's status
    POST   /models/<sign>/publish  {persist_root, wire}
    POST   /models/<sign>/sync     {feed, interval_s, wire, wait_s}

the live-replica restore surface (`restore_from_peer` pages it):

    GET    /models/<sign>:exportmeta                  the row manifest
    GET    /models/<sign>:rows?var=&start=&count=     npz pages of rows
    GET    /models/<sign>:dense                       npz dense params

and the telemetry family:

    GET    /metrics                Prometheus text of the registry
    GET    /statusz                operator one-pager (text)
    GET    /tracez[?n=]            the flight recorder's spans and events
    GET    /sloz[?format=text]     SLO verdicts
    GET    /historz[?metric=&window=]  metric history rings
    GET    /timelinez[?n=]         events, spans and the delta lineage book
    GET    /fleetz[?peers=]        this node's /metrics merged with peers'
    POST   /capsule                {reason, ...}: a postmortem capsule

with the JAX package's status codes: 400 for a malformed or ragged request,
404 for an unknown model or variable, 500 for a server fault. Every request
binds a request id (`X-OETPU-Request-Id` / `X-OETPU-Trace`, made when
absent) and runs in a `serving.http` span; predicts in `serving.predict`
and `serving.model_call`; every answer carries `X-OETPU-Server-Time`.
Pulled and predicted ids feed the heavy-hitter sketches. Concurrent
predicts can merge into one device batch (`MicroBatcher`). A standalone
model lives on the server's device (the CUDA card unless the caller asks
for the CPU). A model registered with `shard_num > 1` loads as a
`parallel.serving.ShardedModel` over the first `shard_num` entries of the
node's device list (`devices=`; by default every CUDA card, and none
without a card): its table shards stay apart, one a device, and its dense
tower runs on the first. A list may repeat a device, staging the shards
on one card. A `shard_num` beyond the list is refused (500, and the
registry entry is `ERROR`). Sync, swaps, the batcher, `/statusz` and the
export routes take either kind of servable.

Run a node with `python -m openembedding_tpu_torch.serving --registry DIR`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data import is_ragged, pad_ragged
from .device import resolve_device
from .export import (RaggedBatchError, StandaloneModel, _BadRange,
                     bucket_size)
from .utils import trace

REQUEST_ID_HEADER = trace.REQUEST_ID_HEADER


class _BadRequest(Exception):
    """The client sent an invalid request body (-> 400)."""


MODEL_STATUS = ("CREATING", "NORMAL", "DELETING", "ERROR")


def _ids_array(v, *, pooled: bool = False) -> np.ndarray:
    """Sparse-id JSON payload -> int64 array.

    `pooled=True` (every spec reading this feature has a combiner): ragged
    id lists pad with -1 to the next power-of-two width, rectangular input
    width-buckets the same way, and 1-D input becomes one-id lists.
    `pooled=False`: the field count is part of the model, so the payload must
    be rectangular; a ragged one raises (-> 400)."""
    if not pooled:
        return np.asarray(v, dtype=np.int64)
    if is_ragged(v):
        return _pad_ragged_bucketed(v)
    ids = np.asarray(v, dtype=np.int64)
    if ids.ndim == 1:
        return ids[:, None]
    if ids.ndim == 2:
        b = bucket_size(ids.shape[-1], floor=1)
        if ids.shape[-1] != b:
            ids = np.pad(ids, [(0, 0), (0, b - ids.shape[-1])],
                         constant_values=-1)
    return ids


def _pad_ragged_bucketed(v) -> np.ndarray:
    """Pad ragged id lists to the next power-of-two width with -1."""
    return pad_ragged(v, width=bucket_size(max(len(s) for s in v), floor=1))


def _pull_ids(v) -> np.ndarray:
    """Pull-endpoint ids: ragged lists pad to the power-of-two width;
    rectangular input passes through so the response mirrors its shape."""
    if is_ragged(v):
        return _pad_ragged_bucketed(v)
    return np.asarray(v, dtype=np.int64)


def _pooled_features(servable) -> set:
    """Feature names whose consuming specs all pool (combiner set): the
    features whose width is free at serving time. Memoized per servable."""
    cached = getattr(servable, "_pooled_features_cache", None)
    if cached is not None:
        return cached
    m = getattr(servable, "model", None)
    specs = m.specs if m is not None else {}
    by_feature = {}
    for s in specs.values():
        by_feature.setdefault(s.feature_name, []).append(s)
    out = {f for f, ss in by_feature.items() if all(x.combiner for x in ss)}
    servable._pooled_features_cache = out
    return out


class ModelRegistry:
    """File-backed model registry: one JSON per model_sign under
    <root>/models/, written atomically (tmp + rename). The same files as the
    JAX package's registry."""

    def __init__(self, root: str):
        self.root = root
        self._dir = os.path.join(root, "models")
        os.makedirs(self._dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, sign: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9._-]+", sign):
            raise ValueError(f"bad model sign {sign!r}")
        return os.path.join(self._dir, f"{sign}.json")

    def _write(self, sign: str, entry: dict) -> None:
        path = self._path(sign)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def create_model(self, model_sign: str, uri: str, *, replica_num: int = 1,
                     shard_num: int = 1) -> dict:
        """Register as CREATING; the caller loads, then marks NORMAL. An
        interrupted CREATING entry is overwritten; a NORMAL one refuses."""
        with self._lock:
            cur = self.get(model_sign)
            if cur is not None and cur.get("status") == "NORMAL":
                raise FileExistsError(f"model {model_sign!r} already exists")
            entry = {"model_sign": model_sign, "uri": uri,
                     "replica_num": replica_num, "shard_num": shard_num,
                     "status": "CREATING", "error": "",
                     "create_time": time.time()}
            self._write(model_sign, entry)
            return entry

    def set_status(self, model_sign: str, status: str, error: str = "") -> dict:
        if status not in MODEL_STATUS:
            raise ValueError(f"bad status {status!r}")
        with self._lock:
            entry = self.get(model_sign)
            if entry is None:
                raise KeyError(model_sign)
            entry["status"] = status
            entry["error"] = error
            self._write(model_sign, entry)
            return entry

    def delete_model(self, model_sign: str) -> None:
        with self._lock:
            path = self._path(model_sign)
            if not os.path.exists(path):
                raise KeyError(model_sign)
            os.unlink(path)

    def get(self, model_sign: str) -> Optional[dict]:
        try:
            with open(self._path(model_sign)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def show_models(self) -> Dict[str, dict]:
        out = {}
        for fn in sorted(os.listdir(self._dir)):
            if fn.endswith(".json"):
                with open(os.path.join(self._dir, fn)) as f:
                    entry = json.load(f)
                out[entry["model_sign"]] = entry
        return out


class ModelManager:
    """model_sign -> cached servable; refuses models that are not NORMAL.

    `shard_num <= 1` loads a `StandaloneModel` export onto `device`.
    `shard_num > 1` loads a checkpoint as a `ShardedModel` over the first
    `shard_num` entries of `devices` (None = every CUDA card of the node,
    resolved at load; a device may repeat), never materialized whole: the
    reference's serving from the sharded PS (`exb_ops.cpp:261-276`)."""

    def __init__(self, registry: ModelRegistry, device=None, devices=None):
        self.registry = registry
        self.device = resolve_device(device)
        self.devices = list(devices) if devices is not None else None
        self._cache: Dict[str, Any] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        # per-sign load guards: two first requests for one model load it once
        self._loading: Dict[str, threading.Lock] = {}  # guarded-by: self._lock

    def _load_entry(self, entry: dict):
        shard_num = int(entry.get("shard_num", 1))
        if shard_num <= 1:
            return StandaloneModel.load(entry["uri"], device=self.device)
        from .parallel.serving import ShardedModel, serving_devices
        devices = serving_devices(self.devices)
        if shard_num > len(devices):
            raise ValueError(
                f"shard_num={shard_num} exceeds the {len(devices)} devices "
                "on this serving node")
        return ShardedModel.load(entry["uri"], devices=devices[:shard_num])

    def find_model(self, model_sign: str):
        with self._lock:
            if model_sign in self._cache:
                return self._cache[model_sign]
            guard = self._loading.setdefault(model_sign, threading.Lock())
        with guard:
            with self._lock:  # the winner may have finished while we waited
                if model_sign in self._cache:
                    return self._cache[model_sign]
            entry = self.registry.get(model_sign)
            if entry is None:
                raise KeyError(f"unknown model {model_sign!r}")
            if entry["status"] != "NORMAL":
                raise RuntimeError(
                    f"model {model_sign!r} is {entry['status']}, not servable")
            loaded = self._load_entry(entry)
            with self._lock:
                self._cache[model_sign] = loaded
            return loaded

    def servable_versions(self) -> Dict[str, dict]:
        """{sign: {step, kind}} of every loaded servable (the /statusz
        view: the registry shows what is registered, this what is
        resident)."""
        with self._lock:
            cache = dict(self._cache)
        return {sign: {"step": int(getattr(m, "step", 0) or 0),
                       "kind": type(m).__name__}
                for sign, m in cache.items()}

    def find_model_variable(self, model_sign: str, variable: str):
        m = self.find_model(model_sign)
        if variable not in m.variable_names:
            raise KeyError(f"model {model_sign!r} has no variable {variable!r}")
        return m, variable

    def evict(self, model_sign: str) -> None:
        with self._lock:
            self._cache.pop(model_sign, None)

    def swap(self, model_sign: str, servable, *, expected=None) -> None:
        """RCU publish of a new servable version (online sync): requests
        that already resolved the old object finish on it; the next
        `find_model` returns the new one. With `expected` the swap is
        conditional: it refuses when the cached servable is no longer the
        one the update was derived from (a reload or delete won the
        race)."""
        with self._lock:
            cur = self._cache.get(model_sign)
            if cur is None:
                raise KeyError(
                    f"model {model_sign!r} is not loaded; cannot swap")
            if expected is not None and cur is not expected:
                raise RuntimeError(
                    f"model {model_sign!r} was reloaded concurrently; "
                    "swap abandoned")
            self._cache[model_sign] = servable
        trace.event("serving", "servable_swap", model=model_sign,
                    step=int(getattr(servable, "step", 0) or 0))

    def load_model(self, model_sign: str, uri: str, *, replica_num: int = 1,
                   shard_num: int = 1) -> dict:
        """create_model + load + NORMAL (or ERROR with the failure)."""
        entry = self.registry.create_model(model_sign, uri,
                                           replica_num=replica_num,
                                           shard_num=shard_num)
        try:
            loaded = self._load_entry(entry)
            with self._lock:
                self._cache[model_sign] = loaded
            return self.registry.set_status(model_sign, "NORMAL")
        except Exception as e:  # noqa: BLE001 - status must record any failure
            self.registry.set_status(model_sign, "ERROR", error=str(e))
            raise


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device result on the host as float32 numpy (the one device sync of
    a request or merged batch)."""
    return t.detach().to("cpu", torch.float32).numpy()


class ServingHandler(BaseHTTPRequestHandler):
    manager: ModelManager = None  # set by make_server
    batcher: "Optional[MicroBatcher]" = None  # set when batching is on
    # per-server registries: http.server makes one handler instance a
    # request, so they live on make_server's subclass (fresh dicts there)
    publishers: dict = {}   # model_sign -> sync.SyncPublisher
    subscribers: dict = {}  # model_sign -> sync.SyncSubscriber
    peers: tuple = ()             # the default /fleetz scrape set
    node_info: dict = {}          # make_server assigns one per server
    quiet = True

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    def send_response(self, code, message=None):
        """Every answer echoes the request id, stamps this node's wall clock
        (`X-OETPU-Server-Time`) and records its status on the http span."""
        super().send_response(code, message)
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header(REQUEST_ID_HEADER, rid)
        self.send_header(trace.SERVER_TIME_HEADER, repr(time.time()))
        sp = getattr(self, "_http_span", None)
        if sp is not None:
            sp.attrs["status"] = int(code)

    def _traced(self, method: str, handler):
        """Adopt the caller's trace context (`X-OETPU-Trace`, else
        `X-OETPU-Request-Id`, else a new id), bind it for the request and
        run the handler in the root `serving.http` span."""
        ctx = trace.extract_context(self.headers)
        rid = (ctx.trace_id if ctx is not None else None) \
            or trace.new_request_id()
        self._request_id = rid
        with trace.request(rid, remote_parent=ctx.parent_span
                           if ctx is not None else None):
            with trace.span("serving", "http", method=method,
                            path=self.path) as sp:
                self._http_span = sp
                return handler()

    def _json(self, code: int, payload, headers: Optional[dict] = None
              ) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _blob(self, body: bytes, headers: Optional[dict] = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _npz(self, arrays: dict) -> None:
        """A dict of numpy arrays as an uncompressed .npz body."""
        import io
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self._blob(buf.getvalue())

    def _text(self, body: str, code: int = 200,
              content_type: str = "text/plain; charset=utf-8") -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _statusz_text(self) -> str:
        """Operator one-pager: build, node, loaded servables, the hot ids,
        the placement controllers, SLOs, ingest, metric history, the
        device-memory ledger and the flight recorder's tail."""
        import platform

        from .placement.controller import render_status
        from .utils import history, memwatch, metrics, sketch, slo
        lines = ["== openembedding_tpu_torch serving /statusz =="]
        lines.append(f"build: python={platform.python_version()} "
                     f"torch={torch.__version__}")
        lines.append("node: " + json.dumps(self.node_info, sort_keys=True))
        lines.append("")
        lines.append("-- servables (loaded) --")
        versions = self.manager.servable_versions()
        if not versions:
            lines.append("(none loaded)")
        for sign, v in sorted(versions.items()):
            entry = self.manager.registry.get(sign) or {}
            lines.append(f"{sign}: step={v['step']} kind={v['kind']} "
                         f"status={entry.get('status', '?')}")
        lines.append("")
        lines.append("-- sync subscribers --")
        if not self.subscribers:
            lines.append("(none)")
        for sign, sub in sorted(self.subscribers.items()):
            st = sub.status()
            f = st.get("freshness_ms")
            fresh = f"freshness_ms={f:.1f} " if f is not None else ""
            lines.append(
                f"{sign}: state={st['state']} version={st['version']} "
                f"applied={st['applied']} {fresh}"
                f"last_degraded_reason={st.get('last_degraded_reason')}")
        lines.append("")
        lines.append("-- sync publishers --")
        if not self.publishers:
            lines.append("(none)")
        for sign, pub in sorted(self.publishers.items()):
            try:
                feed = pub.versions()
                lines.append(f"{sign}: head_step={feed['head_step']} "
                             f"base_step={feed['base_step']} "
                             f"deltas={len(feed['deltas'])}")
            except Exception as e:  # noqa: BLE001
                lines.append(f"{sign}: (feed error: {e})")
        lines.append("")
        def panel(title, render):
            # every panel renders whatever the others do
            lines.append(title)
            try:
                lines.append(render())
            except Exception as e:  # noqa: BLE001
                lines.append(f"(unavailable: {e})")
            lines.append("")

        def slo_text():
            slo.EVALUATOR.evaluate_now()
            return slo.EVALUATOR.render_text()

        def memory_text():
            mem = memwatch.WATCH.export()
            if not mem["components"]:
                return "(no components registered)"
            out = []
            for e in sorted(mem["components"],
                            key=lambda e: (e["component"],
                                           sorted(e["labels"].items()))):
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(e["labels"].items()))
                tag = e["component"] + (f"{{{lbl}}}" if lbl else "")
                host = " (host)" if e["host"] else ""
                out.append(f"{tag}: {e['bytes']:,}B{host}")
            out.append(f"device total (model): "
                       f"{mem['device_total_bytes']:,}B")
            return "\n".join(out)

        def ingest_text():
            ingest = {k: v for k, v in metrics.report(reset=False).items()
                      if k.startswith("ingest.")
                      and not k.endswith((".p50", ".p95", ".p99"))}
            return (metrics._format_table(ingest) if ingest
                    else "(no ingest activity)")

        panel("-- workload skew (hot ids) --", lambda: sketch.MONITOR
              .render_text(top=int(self.query.get("top", 8))))
        panel("-- placement (self-driving) --", render_status)
        panel("-- SLOs (GET /sloz for JSON) --", slo_text)
        panel("-- ingest (line-rate) --", ingest_text)
        panel("-- metric history (GET /historz for JSON) --",
              history.render_sparklines)
        panel("-- device memory (memwatch ledger) --", memory_text)
        n = int(self.query.get("n", 40))
        lines.append(f"-- flight recorder (last {n}) --")
        lines.append(trace.RECORDER.render_text(n))
        return "\n".join(lines) + "\n"

    def _fleetz_text(self) -> str:
        """This node's /metrics merged with every peer's
        (`utils/metrics.merge_prometheus`: counters and histogram buckets
        sum, gauges keep an `instance` label). Peers from `?peers=` (comma
        separated base URLs) or the server's `peers`; a peer that does not
        answer becomes a comment line, never a 500."""
        import urllib.request

        from .utils import metrics, sketch
        sketch.MONITOR.publish()
        q = self.query.get("peers")
        peers = ([p for p in q.split(",") if p] if q is not None
                 else list(self.peers))
        scrapes = [(self.node_info.get("node_id", "self"),
                    metrics.prometheus_text())]
        comments = [f"# fleet: {1 + len(peers)} node(s): self + "
                    + (", ".join(peers) if peers else "(no peers)")]
        for peer in peers:
            url = peer.rstrip("/")
            if not url.startswith("http"):
                url = f"http://{url}"
            try:
                req = urllib.request.Request(
                    f"{url}/metrics", headers=trace.inject_headers())
                with urllib.request.urlopen(req, timeout=5.0) as r:
                    scrapes.append((peer, r.read().decode()))
            except Exception as e:  # noqa: BLE001 — degrade, don't 500
                comments.append(f"# fleet: peer {peer} unreachable: {e}")
                metrics.observe("fleet.scrape_errors", 1)
        metrics.observe("fleet.peers", float(len(peers)), "gauge")
        metrics.observe("fleet.nodes_answering", float(len(scrapes)),
                        "gauge")
        merged = metrics.merge_prometheus(scrapes)
        comments.extend(self._fleetz_freshness(merged))
        return "\n".join(comments) + "\n" + merged

    @staticmethod
    def _fleetz_freshness(merged: str) -> list:
        """"Who is stale" comment lines for /fleetz: each instance's
        `sync.freshness_ms` and head / applied version gauges read back out
        of the merged scrape (gauges keep their `instance` label), and this
        node's last hop breakdown from the lineage book."""
        from .sync import lineage
        out = []
        try:
            per: dict = {}
            for line in merged.splitlines():
                for metric, field in (("oetpu_sync_freshness_ms", "fresh"),
                                      ("oetpu_sync_head_version", "head"),
                                      ("oetpu_sync_applied_version",
                                       "applied")):
                    if not line.startswith(metric + "{"):
                        continue
                    m = re.search(r'instance="([^"]*)"', line)
                    inst = m.group(1) if m else "self"
                    try:
                        val = float(line.rsplit(None, 1)[-1])
                    except ValueError:
                        continue
                    per.setdefault(inst, {})[field] = val
            for inst in sorted(per):
                d = per[inst]
                parts = [f"# fleet freshness: {inst}:"]
                if "fresh" in d:
                    parts.append(f"freshness_ms={d['fresh']:.1f}")
                if "head" in d:
                    parts.append(f"head_version={int(d['head'])}")
                if "applied" in d:
                    parts.append(f"applied_version={int(d['applied'])}")
                out.append(" ".join(parts))
            last = lineage.BOOK.last()
            if last is not None and last.get("hops"):
                hops = " ".join(f"{h}={v:.1f}ms" for h, v in
                                sorted(last["hops"].items()))
                out.append(f"# fleet freshness: self last delta "
                           f"step={last['step']} hops: {hops}")
        except Exception as e:  # noqa: BLE001 — degrade, don't 500
            out.append(f"# fleet freshness: unavailable: {e}")
        return out

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        data = json.loads(self.rfile.read(length))
        if not isinstance(data, dict):
            raise _BadRequest("request body must be a JSON object")
        return data

    _TELEMETRY = ("healthz", "metrics", "fleetz", "statusz", "tracez", "sloz",
                  "historz", "timelinez", "capsule")

    def _route(self):
        from urllib.parse import parse_qs, urlsplit
        parts = urlsplit(self.path)
        self.query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        path = parts.path.rstrip("/")
        m = re.fullmatch(
            r"/models/([A-Za-z0-9._-]+)/delta/(\d+)"
            r"/(meta|dense|table/[A-Za-z0-9._-]+)", path)
        if m:
            return "delta", m.group(1), (int(m.group(2)), m.group(3))
        m = re.fullmatch(r"/models/([A-Za-z0-9._-]+)"
                         r"(?::(\w+)|/(pull|predict|publish|sync))?",
                         path)
        if m:
            return "model", m.group(1), m.group(2) or m.group(3)
        if path == "/models":
            return "models", None, None
        m = re.fullmatch(r"/nodes/([A-Za-z0-9._-]+)", path)
        if m:
            return "node", m.group(1), None
        if path == "/nodes":
            return "nodes", None, None
        if path[1:] in self._TELEMETRY:
            return path[1:], None, None
        return None, None, None

    @staticmethod
    def _field(body: dict, *names):
        """Required body field: the first present name wins; absence is the
        caller's error (400)."""
        for n in names:
            if n in body:
                return body[n]
        raise _BadRequest(f"missing required field {names[0]!r}")

    @staticmethod
    def _coerce(fn, value, what: str):
        """Convert a request value; conversion failures are the caller's
        error (400) at the parse site."""
        try:
            return fn(value)
        except (ValueError, TypeError) as e:
            raise _BadRequest(f"bad {what!r}: {e}") from e

    def do_GET(self):  # noqa: N802 (http.server API)
        return self._traced("GET", self._handle_get)

    def _handle_get(self):
        kind, sign, action = self._route()
        try:
            if kind == "models":
                return self._json(200, self.manager.registry.show_models())
            if kind == "model" and action == "versions":
                return self._get_versions(sign)
            if kind == "model" and action == "syncstate":
                sub = self.subscribers.get(sign)
                if sub is None:
                    return self._json(
                        404, {"error": f"model {sign!r} has no subscriber"})
                return self._json(200, sub.status())
            if kind == "delta":
                return self._get_delta(sign, *action)
            if kind == "model" and action in ("exportmeta", "rows", "dense"):
                return self._get_export(sign, action)
            if kind == "model":
                entry = self.manager.registry.get(sign)
                if entry is None:
                    return self._json(404, {"error": f"unknown model {sign}"})
                return self._json(200, entry)
            if kind == "nodes":
                return self._json(200, {"nodes": [self.node_info]})
            if kind == "healthz":
                return self._json(200, {"status": "ok"})
            if kind is not None:
                return self._get_telemetry(kind)
            return self._json(404, {"error": "not found"})
        except _BadRequest as e:
            return self._json(400, {"error": str(e)})
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - every handler error is a 500
            return self._json(500, {"error": str(e)})

    def _get_versions(self, sign: str):
        """The online-sync feed: ETag = the head step; `?after=<step>&
        wait_s=<s>` is a bounded long poll answering 304 when nothing newer
        commits inside the window."""
        pub = self.publishers.get(sign)
        if pub is None:
            return self._json(
                404, {"error": f"model {sign!r} has no publisher"})
        after = self.query.get("after")
        after = (self._coerce(int, after, "after")
                 if after is not None else None)
        wait_s = self._coerce(float, self.query.get("wait_s", 0.0), "wait_s")
        feed, changed = pub.wait_versions(after, wait_s)
        etag = {"ETag": f'"{feed["head_step"]}"'}
        if not changed:
            self.send_response(304)
            self.send_header("ETag", etag["ETag"])
            self.end_headers()
            return None
        return self._json(200, feed, headers=etag)

    def _get_delta(self, sign: str, step: int, fname: str):
        pub = self.publishers.get(sign)
        if pub is None:
            return self._json(
                404, {"error": f"model {sign!r} has no publisher"})
        etag = {"ETag": f'"{step}"'}  # committed deltas never change
        if fname == "meta":
            return self._json(200, pub.delta_meta(step), headers=etag)
        if fname == "dense":
            return self._blob(pub.delta_dense(step), headers=etag)
        fmt = self.query.get("wire")
        if fmt is not None:
            from .ops.wire import wire_format
            fmt = self._coerce(wire_format, fmt, "wire")
        return self._blob(pub.delta_table(step, fname[len("table/"):], fmt),
                          headers=etag)

    def _get_export(self, sign: str, action: str):
        """The live-replica restore surface: a peer pages these to rebuild
        a standalone export with no shared filesystem
        (`restore_from_peer`)."""
        model = self.manager.find_model(sign)
        if action == "exportmeta":
            return self._json(200, model.export_manifest())
        if action == "dense":
            return self._npz(model.export_dense())
        var = self.query.get("var")
        if var is None:
            raise _BadRequest("rows: missing ?var=")
        if var not in model.variable_names:
            return self._json(
                404, {"error": f"model {sign!r} has no variable {var!r}"})
        start = self._coerce(int, self.query.get("start", 0), "start")
        count = self._coerce(int, self.query.get("count", 1 << 16), "count")
        try:
            return self._npz(model.export_rows(var, start, count))
        except _BadRange as e:
            raise _BadRequest(str(e)) from e

    def _get_telemetry(self, kind: str):
        from .utils import history, metrics, sketch, slo
        if kind == "metrics":
            sketch.MONITOR.publish()  # the top-K into skew.* gauges
            return self._text(metrics.prometheus_text(),
                              content_type="text/plain; version=0.0.4")
        if kind == "fleetz":
            return self._text(self._fleetz_text())
        if kind == "statusz":
            return self._text(self._statusz_text())
        if kind == "tracez":
            n = self._coerce(int, self.query.get("n", 256), "n")
            return self._json(200, {
                "spans": [s.as_dict() for s in trace.RECORDER.spans(n)],
                "events": [e.as_dict() for e in trace.RECORDER.events(n)]})
        if kind == "sloz":
            verdicts = slo.EVALUATOR.evaluate_now()
            if self.query.get("format") == "text":
                return self._text(slo.EVALUATOR.render_text())
            return self._json(200, {"verdicts": verdicts,
                                    "exit_code": slo.EVALUATOR.exit_code()})
        if kind == "historz":
            metric = self.query.get("metric")
            if metric is None:
                return self._json(200, {"metrics": history.HISTORY.names()})
            window = self.query.get("window")
            window_s = (self._coerce(float, window, "window")
                        if window is not None else None)
            labels = {k: v for k, v in self.query.items()
                      if k not in ("metric", "window")}
            return self._json(200, {
                "metric": metric, "window_s": window_s,
                "series": history.HISTORY.query(metric, window_s=window_s,
                                                labels=labels or None)})
        if kind == "timelinez":
            from .sync import lineage
            n = self._coerce(int, self.query.get("n", 512), "n")
            return self._json(200, {
                "node": self.node_info.get("node_id", "self"),
                "process": trace.PROCESS_ID, "wall_time": time.time(),
                "events": [e.as_dict() for e in trace.RECORDER.events(n)],
                "spans": [s.as_dict() for s in trace.RECORDER.spans(n)],
                "lineage": lineage.BOOK.export()})
        return self._json(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        return self._traced("POST", self._handle_post)

    def _handle_post(self):
        kind, sign, action = self._route()
        try:
            body = self._body()
            if kind == "capsule":
                # an operator's postmortem dump: 409 when capsules are not
                # armed, 429 when the per-reason rate limit suppressed it
                from .utils import capsule
                if not capsule.enabled():
                    return self._json(409, {
                        "error": "capsules not configured "
                                 "(--capsule-dir / OETPU_CAPSULE_DIR)"})
                reason = str(body.pop("reason", "operator"))
                path = capsule.trigger(reason, **{
                    str(k): v for k, v in body.items()})
                return self._json(
                    200 if path else 429,
                    {"reason": reason, "path": path} if path
                    else {"error": "capsule suppressed (rate limit or "
                                   "write error)", "reason": reason})
            if kind == "models" or (kind == "model" and action is None):
                sign = sign or self._field(body, "model_sign")
                entry = self.manager.load_model(
                    sign, self._field(body, "model_uri", "uri"),
                    replica_num=self._coerce(int, body.get("replica_num", 1),
                                             "replica_num"),
                    shard_num=self._coerce(int, body.get("shard_num", 1),
                                           "shard_num"))
                return self._json(200, entry)
            if kind == "model" and action == "publish":
                # this node becomes the sync publisher for `sign`
                from .sync import SyncPublisher
                root = self._field(body, "persist_root", "root")
                if not os.path.isdir(root):
                    raise _BadRequest(f"persist_root {root!r} is not a "
                                      "directory")
                pub = SyncPublisher(root, wire=body.get("wire"))
                self.publishers[sign] = pub
                return self._json(200, {"model_sign": sign,
                                        **pub.versions()})
            if kind == "model" and action == "sync":
                # a live subscriber on this node
                from .sync import SyncSubscriber
                feed = self._field(body, "feed")
                old = self.subscribers.pop(sign, None)
                if old is not None:
                    old.stop()
                sub = SyncSubscriber(
                    self.manager, sign, feed, wire=body.get("wire"),
                    interval_s=self._coerce(
                        float, body.get("interval_s", 1.0), "interval_s"),
                    wait_s=self._coerce(
                        float, body.get("wait_s", 0.0), "wait_s"))
                self.subscribers[sign] = sub.start()
                return self._json(200, sub.status())
            if kind == "model" and action == "pull":
                model, variable = self.manager.find_model_variable(
                    sign, self._field(body, "variable"))
                ids = self._coerce(_pull_ids, self._field(body, "ids"), "ids")
                from .utils import sketch
                sketch.record_ids(variable, ids)
                rows = _to_host(model.lookup(variable, ids))
                # `Accept: application/octet-stream` streams the rows as npz
                # (`ServingClient(binary=True)`): no JSON float round trip
                if "application/octet-stream" in self.headers.get("Accept",
                                                                  ""):
                    return self._npz({"weights": rows})
                return self._json(200, {"weights": rows.tolist()})
            if kind == "model" and action == "predict":
                # one measurement, two views: the span and the labeled
                # `serving.predict.ms{model=}` histogram
                with trace.span("serving", "predict",
                                labels={"model": sign}, model=sign):
                    model = self.manager.find_model(sign)
                    pooled = _pooled_features(model)
                    batch = {"sparse": {
                        k: self._coerce(
                            lambda v, _p=(k in pooled): _ids_array(
                                v, pooled=_p),
                            v, f"sparse.{k}")
                        for k, v in body.get("sparse", {}).items()}}
                    if body.get("dense") is not None:
                        batch["dense"] = self._coerce(
                            lambda v: np.asarray(v, dtype=np.float32),
                            body["dense"], "dense")
                    try:
                        if self.batcher is not None:
                            logits = self.batcher.predict(model, sign, batch)
                        else:
                            with trace.span("serving", "model_call"):
                                logits = _to_host(model.predict(batch))
                    except KeyError as e:
                        # a feature the model needs is absent from the
                        # request
                        raise _BadRequest(
                            f"predict request is missing sparse feature {e}"
                        ) from e
                    except RaggedBatchError as e:
                        raise _BadRequest(str(e)) from e
                    # close the delta's lineage chain on its first predict
                    # at this version (idempotent, O(1), never raises)
                    from .sync import lineage
                    lineage.note_serve(
                        sign, int(getattr(model, "step", 0) or 0))
                    return self._json(200, {"logits": logits.tolist()})
            return self._json(404, {"error": "not found"})
        except _BadRequest as e:
            return self._json(400, {"error": str(e)})
        except json.JSONDecodeError as e:
            return self._json(400, {"error": f"malformed request body: {e}"})
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            return self._json(500, {"error": str(e)})

    def do_DELETE(self):  # noqa: N802
        return self._traced("DELETE", self._handle_delete)

    def _handle_delete(self):
        kind, sign, _ = self._route()
        try:
            if kind == "model":
                sub = self.subscribers.pop(sign, None)
                if sub is not None:
                    sub.stop()  # a deleted model must not keep syncing
                self.manager.registry.set_status(sign, "DELETING")
                self.manager.evict(sign)
                self.manager.registry.delete_model(sign)
                return self._json(200, {"deleted": sign})
            if kind == "node":
                # the node is this process; shutdown() blocks until this
                # handler returns, so it runs on a thread of its own
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return self._json(200, {"shutdown": sign})
            return self._json(404, {"error": "not found"})
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            return self._json(500, {"error": str(e)})


class ServingClient:
    """REST client with replica failover: it walks its node list from a
    rotating offset and moves on only on connection errors. An HTTP error is
    a server's answer and is raised, not retried."""

    def __init__(self, nodes, timeout: float = 30.0):
        if isinstance(nodes, str):
            nodes = [nodes]
        if not nodes:
            raise ValueError("need at least one serving node URL")
        self.nodes = [n.rstrip("/") for n in nodes]
        self.timeout = timeout
        self._next = 0

    def _request(self, method: str, path: str, body=None, *,
                 binary: bool = False):
        import io
        import urllib.error
        import urllib.request
        start, last = self._next, None
        self._next = (self._next + 1) % len(self.nodes)
        data = json.dumps(body).encode() if body is not None else None
        for i in range(len(self.nodes)):
            node = self.nodes[(start + i) % len(self.nodes)]
            req = urllib.request.Request(f"{node}{path}", data=data,
                                         method=method,
                                         headers=trace.inject_headers())
            if data:
                req.add_header("Content-Type", "application/json")
            if binary:
                req.add_header("Accept", "application/octet-stream")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    raw = r.read()
                    if binary and "octet-stream" in r.headers.get(
                            "Content-Type", ""):
                        return dict(np.load(io.BytesIO(raw)))
                    return json.loads(raw)
            except urllib.error.HTTPError:
                raise  # a server answered; its answer stands
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last = e  # dead/unreachable replica: try the next
        raise ConnectionError(
            f"no live replica among {self.nodes}: {last}") from last

    @staticmethod
    def _jsonable_ids(v):
        """Ragged id lists stay lists (the server pads them); everything
        else normalizes through numpy."""
        if is_ragged(v):
            return [[int(x) for x in row] for row in v]
        return np.asarray(v).tolist()

    def pull(self, model_sign: str, variable: str, ids, *,
             binary: bool = False) -> np.ndarray:
        """`binary=True` asks for the npz reply (Accept negotiation): no
        JSON float round trip, for large pulls."""
        out = self._request("POST", f"/models/{model_sign}/pull",
                            {"variable": variable,
                             "ids": self._jsonable_ids(ids)},
                            binary=binary)
        if binary:
            return out["weights"]
        return np.asarray(out["weights"], np.float32)

    def predict(self, model_sign: str, sparse: Dict[str, Any],
                dense=None) -> np.ndarray:
        body = {"sparse": {k: self._jsonable_ids(v)
                           for k, v in sparse.items()}}
        if dense is not None:
            body["dense"] = np.asarray(dense).tolist()
        out = self._request("POST", f"/models/{model_sign}/predict", body)
        return np.asarray(out["logits"], np.float32)

    def create_model(self, model_sign: str, uri: str, *, replica_num: int = 1,
                     shard_num: int = 1) -> dict:
        return self._request("POST", "/models",
                             {"model_sign": model_sign, "model_uri": uri,
                              "replica_num": replica_num,
                              "shard_num": shard_num})

    def show_models(self) -> dict:
        return self._request("GET", "/models")


class MicroBatcher:
    """Merge concurrent /predict requests into one padded device batch.

    A request parks up to `window_ms` waiting for companions; the first
    arrival (the leader) then runs the whole group as one `model.predict`
    (which pads to a power-of-two bucket), makes the one device-to-host
    copy of the merged logits and hands each request its slice. Groups are
    keyed by (model, feature set and trailing shapes, dense width): only
    structurally identical requests merge. A group reaching `max_batch`
    rows wakes its leader early; a merged call never exceeds `max_batch`
    rows (larger groups run in chunks). A failure reaches every member of
    its chunk and no other request."""

    def __init__(self, manager: "ModelManager", window_ms: float = 2.0,
                 max_batch: int = 4096):
        self.manager = manager
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._full = threading.Condition(self._lock)
        self._groups: Dict[tuple, list] = {}  # guarded-by: self._lock

    @staticmethod
    def _group_key(sign: str, batch: dict) -> tuple:
        """Same feature set, same trailing shapes per feature, same dense
        width."""
        sparse = batch["sparse"]
        dense = batch.get("dense")
        return (sign,
                tuple((k, np.asarray(v).shape[1:])
                      for k, v in sorted(sparse.items())),
                None if dense is None else np.asarray(dense).shape[1:])

    @staticmethod
    def _request_rows(batch: dict) -> int:
        """Leading-dim row count; a request whose own features disagree
        fails alone at enqueue, and an empty one is the caller's error
        (KeyError -> the handler's 400)."""
        if not batch["sparse"]:
            raise KeyError("predict request has no sparse features")
        ns = {k: int(np.asarray(v).shape[0])
              for k, v in batch["sparse"].items()}
        if batch.get("dense") is not None:
            ns["dense"] = int(np.asarray(batch["dense"]).shape[0])
        if len(set(ns.values())) != 1:
            raise RaggedBatchError(f"ragged serving batch: row counts {ns}")
        return next(iter(ns.values()))

    def predict(self, model, sign: str, batch: dict) -> np.ndarray:
        """Blocking: this request's logits slice, on the host. `model` is
        the handler's already-resolved servable."""
        n = self._request_rows(batch)
        entry = {"batch": batch, "n": n, "done": threading.Event(),
                 "out": None, "err": None, "t0": time.monotonic()}
        key = self._group_key(sign, batch)
        with self._lock:
            group = self._groups.setdefault(key, [])
            group.append(entry)
            leader = len(group) == 1
            if not leader and sum(e["n"] for e in group) >= self.max_batch:
                self._full.notify_all()  # wake the leader early
        if leader:
            # leadership is decided once, at enqueue; the leader owns the
            # window and the device call
            with trace.span("serving", "queue_wait", role="leader", rows=n):
                deadline = time.monotonic() + self.window_s
                with self._lock:
                    while (time.monotonic() < deadline
                           and sum(e["n"] for e in self._groups.get(key, ()))
                           < self.max_batch):
                        self._full.wait(timeout=max(
                            0.0, deadline - time.monotonic()))
                    group = self._groups.pop(key, [])
            with trace.span("serving", "batch_exec", requests=len(group),
                            rows=sum(e["n"] for e in group)):
                self._run(model, group)
        else:
            # a follower waits from enqueue until its group's run is done
            with trace.span("serving", "queue_wait", role="follower", rows=n):
                entry["done"].wait()
        entry["done"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def _run(self, model, group: list) -> None:
        # chunk so one merged call never exceeds max_batch rows
        chunk, rows = [], 0
        for e in group:
            if chunk and rows + e["n"] > self.max_batch:
                self._run_chunk(model, chunk)
                chunk, rows = [], 0
            chunk.append(e)
            rows += e["n"]
        if chunk:
            self._run_chunk(model, chunk)

    def _run_chunk(self, model, group: list) -> None:
        from .utils import metrics
        # how long requests parked for companions, and how full the merged
        # batch came out: the window's trade, read off /metrics
        now = time.monotonic()
        for e in group:
            metrics.observe("serving.batch_wait_ms",
                            (now - e["t0"]) * 1e3, "avg")
        metrics.observe("serving.batch_fill_ratio",
                        min(1.0, sum(e["n"] for e in group) / self.max_batch),
                        "avg")
        try:
            batches = [e["batch"] for e in group]
            merged = {"sparse": {
                k: np.concatenate([np.asarray(b["sparse"][k])
                                   for b in batches])
                for k in batches[0]["sparse"]}}
            if batches[0].get("dense") is not None:
                merged["dense"] = np.concatenate(
                    [np.asarray(b["dense"]) for b in batches])
            with trace.span("serving", "model_call",
                            rows=sum(e["n"] for e in group)):
                # the one device-to-host copy of the merged batch
                logits = _to_host(model.predict(merged))
            metrics.observe("serving.predict_batches", 1)
            metrics.observe("serving.predict_requests", len(group))
            off = 0
            for e in group:
                e["out"] = logits[off:off + e["n"]]
                off += e["n"]
        except Exception as err:  # noqa: BLE001 — delivered to every waiter
            for e in group:
                e["err"] = err
        finally:
            for e in group:
                e["done"].set()


def restore_from_peer(peer: str, model_sign: str, dest: str, *,
                      page: int = 1 << 16, timeout: float = 60.0) -> str:
    """Rebuild a model's standalone export from a live serving peer over
    REST: page the peer's `:exportmeta`, `:rows` and `:dense` endpoints and
    write a standard export under `dest`, with no shared filesystem. The
    peer may be a node of either package. Register `dest` with the local
    node (POST /models) to finish the restore.

    Crash safety: everything pages into `dest + ".tmp-<pid>"`, renamed into
    place only after the last byte (meta and config included) is on disk,
    so a peer that dies mid-page, a timeout or a local crash never leaves a
    half-written export at `dest`. A `dest` that exists is replaced only at
    that rename.

    Returns `dest`. Raises on a peer error or a model that is not NORMAL.
    """
    import shutil
    import urllib.request

    def get(path: str) -> bytes:
        req = urllib.request.Request(f"{peer}{path}",
                                     headers=trace.inject_headers())
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()

    entry = json.loads(get(f"/models/{model_sign}"))
    if entry.get("status") != "NORMAL":
        raise RuntimeError(
            f"peer model {model_sign!r} is {entry.get('status')!r}, "
            "not restorable")
    manifest = json.loads(get(f"/models/{model_sign}:exportmeta"))

    tmp = dest.rstrip("/\\") + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    try:
        _page_restore(get, manifest, model_sign, tmp, peer, page,
                      final_uri=dest)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # never leave partial pages
        raise
    if os.path.exists(dest):
        shutil.rmtree(dest)  # replaced only once tmp is complete
    os.replace(tmp, dest)
    return dest


def _page_restore(get, manifest, model_sign: str, dest: str, peer: str,
                  page: int, final_uri: str) -> None:
    """Page the peer's rows, dense params and meta into `dest` (the staging
    directory; the caller renames it); the meta written records
    `final_uri`, where the export lands after the rename."""
    import io
    from urllib.parse import quote

    from .checkpoint import MODEL_META_FILE
    from .export import MODEL_CONFIG_FILE
    os.makedirs(dest, exist_ok=True)
    for v in manifest["variables"]:
        vdir = os.path.join(dest, f"variable_{v['variable_id']}")
        os.makedirs(vdir, exist_ok=True)
        chunks: Dict[str, list] = {"weights": [], "ids": []}
        for start in range(0, v["rows"], page):
            data = np.load(io.BytesIO(get(
                f"/models/{model_sign}:rows"
                f"?var={quote(v['storage_name'], safe='')}"
                f"&start={start}&count={page}")))
            chunks["weights"].append(data["weights"])
            if "ids" in data:
                chunks["ids"].append(data["ids"])
        w = (np.concatenate(chunks["weights"]) if chunks["weights"]
             else np.zeros((0, v["dim"]), np.float32))
        if w.shape[0] != v["rows"]:
            raise RuntimeError(
                f"peer returned {w.shape[0]} rows for {v['storage_name']!r}, "
                f"manifest says {v['rows']} (model changed mid-restore?)")
        np.save(os.path.join(vdir, "weights.npy"), w)
        if v["kind"] == "hash":
            ids = (np.concatenate(chunks["ids"]) if chunks["ids"]
                   else np.zeros((0,), np.int64))
            np.save(os.path.join(vdir, "ids.npy"), ids)

    dense = np.load(io.BytesIO(get(f"/models/{model_sign}:dense")))
    np.savez(os.path.join(dest, "dense_params.npz"),
             **{k: dense[k] for k in dense.files})

    meta = dict(manifest["meta"])
    meta["uri"] = final_uri
    meta["num_shards"] = 1  # the restored artifact is a standalone export
    # the written meta describes the written files
    meta["dense_manifest"] = {
        k: {"shape": list(dense[k].shape), "dtype": str(dense[k].dtype)}
        for k in dense.files}
    meta["extra"] = {"standalone": True,
                     "restored_from": f"{peer}/models/{model_sign}"}
    with open(os.path.join(dest, MODEL_META_FILE), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    if manifest.get("model_config") is not None:
        with open(os.path.join(dest, MODEL_CONFIG_FILE), "w") as f:
            json.dump(manifest["model_config"], f, indent=2, sort_keys=True)


def make_server(registry_root: str, host: str = "127.0.0.1", port: int = 0,
                *, device=None, devices=None, batch_window_ms: float = 0.0,
                max_batch: int = 4096,
                publish: Optional[Dict[str, str]] = None,
                publish_wire: Optional[str] = None,
                peers: Optional[list] = None) -> ThreadingHTTPServer:
    """Build (not start) the serving HTTP server; port 0 picks a free port.
    Standalone models load onto `device` (None = the CUDA card; raises
    without one); a model registered with `shard_num > 1` loads its shards
    over the first `shard_num` of `devices` (None = every CUDA card).
    `batch_window_ms > 0` merges concurrent predicts (`MicroBatcher`, at
    most `max_batch` rows a call). `publish` ({model_sign: persist_root})
    registers online-sync publishers (more via POST
    /models/<sign>/publish; subscribers attach via POST
    /models/<sign>/sync). `peers` (base URLs of other nodes) is the default
    `GET /fleetz` scrape set (`?peers=` overrides it per request)."""
    manager = ModelManager(ModelRegistry(registry_root), device=device,
                           devices=devices)

    class Handler(ServingHandler):
        pass

    Handler.manager = manager
    Handler.batcher = (MicroBatcher(manager, window_ms=batch_window_ms,
                                    max_batch=max_batch)
                       if batch_window_ms > 0 else None)
    Handler.publishers = {}
    Handler.subscribers = {}
    Handler.peers = list(peers or [])
    if publish:
        from .sync import SyncPublisher
        for sign, root in publish.items():
            Handler.publishers[sign] = SyncPublisher(root, wire=publish_wire)
    Handler.node_info = {"node_id": f"{os.uname().nodename}:{os.getpid()}",
                         "registry": registry_root,
                         "device": str(manager.device),
                         "batch_window_ms": batch_window_ms,
                         "publishes": sorted(Handler.publishers),
                         "peers": Handler.peers}
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.manager = manager
    httpd.publishers = Handler.publishers
    httpd.subscribers = Handler.subscribers
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="openembedding_tpu_torch serving node (REST admin + "
                    "inference)")
    ap.add_argument("--registry", required=True, help="registry root directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where models load (default: the CUDA card; "
                         "fails when there is none)")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="merge concurrent /predict requests inside this "
                         "window (0 = off)")
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="largest merged predict batch (rows)")
    ap.add_argument("--publish", action="append", default=[],
                    metavar="SIGN=PERSIST_ROOT",
                    help="serve this persist root's committed delta chain as "
                         "the online-sync feed for SIGN (repeatable)")
    ap.add_argument("--sync-from", action="append", default=[],
                    metavar="SIGN=FEED_URL",
                    help="keep the loaded model SIGN fresh against a "
                         "publisher node's feed (repeatable; the model must "
                         "be loaded on this node)")
    ap.add_argument("--sync-interval", type=float, default=1.0,
                    help="subscriber poll interval, seconds")
    ap.add_argument("--sync-wire", default=None,
                    help="row encoding on the sync wire "
                         "(fp32|bf16|int8; default fp32)")
    ap.add_argument("--peers", action="append", default=[],
                    help="base URLs of other nodes (comma-separated, "
                         "repeatable): GET /fleetz merges their /metrics "
                         "with this node's")
    ap.add_argument("--flight-recorder", type=int, default=0, metavar="N",
                    help="resize the span/event flight recorder (0 keeps "
                         "the default)")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="on shutdown, write the flight recorder as "
                         "Chrome-trace JSON to PATH")
    ap.add_argument("--slo-specs", default=None, metavar="PATH",
                    help="JSON list of SLO specs (default: the built-in "
                         "set); verdicts on GET /sloz")
    ap.add_argument("--slo-interval", type=float, default=0.0,
                    help="also evaluate SLOs on a thread every S seconds")
    ap.add_argument("--capsule-dir", default=None, metavar="DIR",
                    help="arm postmortem capsules (SLO breaches, POST "
                         "/capsule) into DIR")
    args = ap.parse_args(argv)
    from .sync import SyncSubscriber
    from .utils import capsule, slo
    if args.flight_recorder > 0:
        trace.configure(args.flight_recorder)
    if args.capsule_dir:
        capsule.configure(args.capsule_dir)
        capsule.register_context(
            "serving", lambda: {"argv": list(argv) if argv else None,
                                "registry": args.registry,
                                "host": args.host, "port": args.port})
    if args.slo_specs:
        slo.configure(slo.load_specs(args.slo_specs))
    slo_eval = None
    if args.slo_interval > 0:
        slo.EVALUATOR.interval_s = args.slo_interval
        slo_eval = slo.EVALUATOR.start()

    def kv(pairs, what):
        out = {}
        for p in pairs:
            if "=" not in p:
                ap.error(f"--{what} expects SIGN=VALUE, got {p!r}")
            k, v = p.split("=", 1)
            out[k] = v
        return out

    httpd = make_server(args.registry, args.host, args.port,
                        device=args.device,
                        batch_window_ms=args.batch_window_ms,
                        max_batch=args.max_batch,
                        publish=kv(args.publish, "publish"),
                        publish_wire=args.sync_wire,
                        peers=[p for arg in args.peers
                               for p in arg.split(",") if p])
    for sign, feed in kv(args.sync_from, "sync-from").items():
        httpd.subscribers[sign] = SyncSubscriber(
            httpd.manager, sign, feed, wire=args.sync_wire,
            interval_s=args.sync_interval).start()
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(registry: {args.registry}, device: {httpd.manager.device})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        for sub in httpd.subscribers.values():
            sub.stop()
        httpd.server_close()
        if slo_eval is not None:
            slo_eval.stop()
        if args.trace_dump:
            print(f"trace dump: {trace.dump_chrome(args.trace_dump)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
