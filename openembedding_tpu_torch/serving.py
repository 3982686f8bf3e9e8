"""Serving: model registry, model manager, REST admin + inference server.

Port of `openembedding_tpu/serving.py` for slice 1: the file-based
`ModelRegistry`, a `ModelManager` of standalone exports (`shard_num == 1`),
and the REST routes

    GET    /models                 registry listing
    GET    /models/<sign>          one registry entry
    GET    /healthz
    POST   /models                 {model_sign, model_uri, replica_num, shard_num}
    POST   /models/<sign>/pull     {variable, ids}
    POST   /models/<sign>/predict  {sparse: {feature: ids}, dense}
    DELETE /models/<sign>

and the telemetry family, as the JAX package serves it:

    GET    /metrics                Prometheus text of the registry
    GET    /statusz                operator one-pager (text)
    GET    /tracez[?n=]            the flight recorder's spans and events
    GET    /sloz[?format=text]     SLO verdicts
    GET    /historz[?metric=&window=]  metric history rings
    GET    /timelinez[?n=]         events and spans with wall/monotonic time
    GET    /fleetz[?peers=]        this node's /metrics merged with peers'
    POST   /capsule                {reason, ...}: a postmortem capsule

with the JAX package's status codes: 400 for a malformed or ragged request,
404 for an unknown model or variable, 500 for a server fault. Every request
binds a request id (`X-OETPU-Request-Id` / `X-OETPU-Trace`, made when
absent) and runs in a `serving.http` span; predicts in `serving.predict`
and `serving.model_call`; every answer carries `X-OETPU-Server-Time`.
Pulled and predicted ids feed the heavy-hitter sketches. Every loaded
model lives on the server's one device (the CUDA card unless the caller
asks for the CPU). Online sync, the micro-batcher, `/nodes` and the memory
panel of `/statusz` are not ported yet (ROADMAP.md item 6).

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
from .export import RaggedBatchError, StandaloneModel, bucket_size
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
    """model_sign -> cached servable on `device`; refuses models that are not
    NORMAL. Serves standalone exports (`shard_num == 1`) only."""

    def __init__(self, registry: ModelRegistry, device=None):
        self.registry = registry
        self.device = resolve_device(device)
        self._cache: Dict[str, StandaloneModel] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        # per-sign load guards: two first requests for one model load it once
        self._loading: Dict[str, threading.Lock] = {}  # guarded-by: self._lock

    def _load_entry(self, entry: dict) -> StandaloneModel:
        shard_num = int(entry.get("shard_num", 1))
        if shard_num > 1:
            raise ValueError(
                f"shard_num={shard_num}: sharded serving is not ported yet "
                "(see ROADMAP.md); register the model with shard_num=1")
        return StandaloneModel.load(entry["uri"], device=self.device)

    def find_model(self, model_sign: str) -> StandaloneModel:
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

    def find_model_variable(self, model_sign: str, variable: str):
        m = self.find_model(model_sign)
        if variable not in m.variable_names:
            raise KeyError(f"model {model_sign!r} has no variable {variable!r}")
        return m, variable

    def evict(self, model_sign: str) -> None:
        with self._lock:
            self._cache.pop(model_sign, None)

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


def _to_list(t: torch.Tensor) -> list:
    """Device result -> JSON-ready list (the request's one device sync)."""
    return t.detach().to("cpu", torch.float32).numpy().tolist()


class ServingHandler(BaseHTTPRequestHandler):
    manager: ModelManager = None  # set by make_server
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

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
        SLOs, ingest, metric history and the flight recorder's tail."""
        import platform

        from .utils import history, metrics, sketch, slo
        lines = ["== openembedding_tpu_torch serving /statusz =="]
        lines.append(f"build: python={platform.python_version()} "
                     f"torch={torch.__version__}")
        lines.append("node: " + json.dumps(self.node_info, sort_keys=True))
        lines.append("")
        lines.append("-- servables (loaded) --")
        with self.manager._lock:
            loaded = dict(self.manager._cache)
        if not loaded:
            lines.append("(none loaded)")
        for sign in sorted(loaded):
            entry = self.manager.registry.get(sign) or {}
            lines.append(f"{sign}: status={entry.get('status', '?')}")
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

        def ingest_text():
            ingest = {k: v for k, v in metrics.report(reset=False).items()
                      if k.startswith("ingest.")
                      and not k.endswith((".p50", ".p95", ".p99"))}
            return (metrics._format_table(ingest) if ingest
                    else "(no ingest activity)")

        panel("-- workload skew (hot ids) --", lambda: sketch.MONITOR
              .render_text(top=int(self.query.get("top", 8))))
        panel("-- SLOs (GET /sloz for JSON) --", slo_text)
        panel("-- ingest (line-rate) --", ingest_text)
        panel("-- metric history (GET /historz for JSON) --",
              history.render_sparklines)
        panel("-- device memory --",
              lambda: "(the memory ledger is not ported yet)")
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
        return "\n".join(comments) + "\n" + metrics.merge_prometheus(scrapes)

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
        m = re.fullmatch(r"/models/([A-Za-z0-9._-]+)(?:/(pull|predict))?",
                         path)
        if m:
            return "model", m.group(1), m.group(2)
        if path == "/models":
            return "models", None, None
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
            if kind == "model" and action is None:
                entry = self.manager.registry.get(sign)
                if entry is None:
                    return self._json(404, {"error": f"unknown model {sign}"})
                return self._json(200, entry)
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
            n = self._coerce(int, self.query.get("n", 512), "n")
            return self._json(200, {
                "node": self.node_info.get("node_id", "self"),
                "process": trace.PROCESS_ID, "wall_time": time.time(),
                "events": [e.as_dict() for e in trace.RECORDER.events(n)],
                "spans": [s.as_dict() for s in trace.RECORDER.spans(n)],
                "lineage": []})
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
            if kind == "model" and action == "pull":
                model, variable = self.manager.find_model_variable(
                    sign, self._field(body, "variable"))
                ids = self._coerce(_pull_ids, self._field(body, "ids"), "ids")
                from .utils import sketch
                sketch.record_ids(variable, ids)
                return self._json(
                    200, {"weights": _to_list(model.lookup(variable, ids))})
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
                        with trace.span("serving", "model_call"):
                            logits = _to_list(model.predict(batch))
                    except KeyError as e:
                        # a feature the model needs is absent from the
                        # request
                        raise _BadRequest(
                            f"predict request is missing sparse feature {e}"
                        ) from e
                    except RaggedBatchError as e:
                        raise _BadRequest(str(e)) from e
                    return self._json(200, {"logits": logits})
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
        kind, sign, action = self._route()
        try:
            if kind == "model" and action is None:
                self.manager.registry.set_status(sign, "DELETING")
                self.manager.evict(sign)
                self.manager.registry.delete_model(sign)
                return self._json(200, {"deleted": sign})
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

    def _request(self, method: str, path: str, body=None):
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
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
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

    def pull(self, model_sign: str, variable: str, ids) -> np.ndarray:
        out = self._request("POST", f"/models/{model_sign}/pull",
                            {"variable": variable,
                             "ids": self._jsonable_ids(ids)})
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


def make_server(registry_root: str, host: str = "127.0.0.1", port: int = 0,
                *, device=None, peers: Optional[list] = None
                ) -> ThreadingHTTPServer:
    """Build (not start) the serving HTTP server; port 0 picks a free port.
    Models load onto `device` (None = the CUDA card; raises without one).
    `peers` (base URLs of other nodes) is the default `GET /fleetz` scrape
    set (`?peers=` overrides it per request)."""
    manager = ModelManager(ModelRegistry(registry_root), device=device)

    class Handler(ServingHandler):
        pass

    Handler.manager = manager
    Handler.peers = list(peers or [])
    Handler.node_info = {"node_id": f"{os.uname().nodename}:{os.getpid()}",
                         "registry": registry_root,
                         "device": str(manager.device),
                         "peers": Handler.peers}
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.manager = manager
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
    httpd = make_server(args.registry, args.host, args.port,
                        device=args.device,
                        peers=[p for arg in args.peers
                               for p in arg.split(",") if p])
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(registry: {args.registry}, device: {httpd.manager.device})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if slo_eval is not None:
            slo_eval.stop()
        if args.trace_dump:
            print(f"trace dump: {trace.dump_chrome(args.trace_dump)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
