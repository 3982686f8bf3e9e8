"""The port's serving telemetry against the JAX server's on one export
and the same requests, and the `offload.*`, `persist.*` and `ingest.*`
series against JAX's for the same work.

- Each package's server loads the same JAX export and answers the same
  predicts and pulls, each request under a request id its client sends:
  `/metrics` parses (either package's `parse_prometheus`) and holds the
  same serving and skew series with the same counts; `/tracez` holds the
  same span names, one `serving.predict` per predict carrying the id the
  client sent; `/statusz`, `/sloz`, `/historz` and `/timelinez` answer;
  `POST /capsule` is 409 until capsules are armed; `/fleetz` over two port
  servers sums both nodes' counters, as it does over two JAX servers; the
  predicted ids reached the sketch.
- The host-cached table, the persisters and the prefetch publish the same
  series names as JAX's on the same batches, with equal counts (the
  prefetch's dropped items depend on thread timing in both packages).
Counts are compared exactly, times not at all.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu import serving as jax_serving
from openembedding_tpu.data import prefetch_to_device as jax_prefetch
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.persist import AsyncPersister as JaxAsync
from openembedding_tpu.utils import capsule as jc
from openembedding_tpu.utils import metrics as jm
from openembedding_tpu.utils import sketch as jsk
from openembedding_tpu.utils import trace as jt
from openembedding_tpu_torch import data, optimizers, serving
from openembedding_tpu_torch.data import prefetch_to_device
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.persist import AsyncPersister
from openembedding_tpu_torch.utils import capsule as tc
from openembedding_tpu_torch.utils import metrics as tm
from openembedding_tpu_torch.utils import sketch as tsk
from openembedding_tpu_torch.utils import trace as tt

from test_torch_host_offload import Pair

VOCAB, N_PREDICT = 1000, 4
PKG = {"jax": (jax_serving, jm, jt, jsk, jc),
       "port": (serving, tm, tt, tsk, tc)}


@pytest.fixture(autouse=True)
def _fresh():
    for _s, m, t, sk, c in PKG.values():
        with m._LOCK:
            m._REGISTRY.clear()
        t.RECORDER.clear()
        sk.MONITOR.reset()
        c.configure(None)
    yield
    for _s, _m, _t, _sk, c in PKG.values():
        c.configure(None)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obs_export") / "m")
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32)
    trainer = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.05))
    batch = next(iter(data.synthetic_criteo(8, id_space=VOCAB, steps=1)))
    jax_export(trainer.init(batch), model, path, model_sign="m-0")
    return path


def _start(tag, root, **kw):
    srv = PKG[tag][0]
    if tag == "port":
        kw["device"] = "cpu"
    httpd = srv.make_server(root, port=0, **kw)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _drive(tag, export, tmp_path):
    srv, m, t, sk, c = PKG[tag]
    httpd, url = _start(tag, str(tmp_path / f"reg_{tag}"))
    try:
        client = srv.ServingClient(url)
        client.create_model("m-0", export)
        rng = np.random.default_rng(5)
        rids, sent = [], 0
        for i in range(N_PREDICT):
            ids = rng.integers(0, VOCAB, (16, 26)).astype(np.int64)
            sent += ids.size
            rid = f"req-{tag}-{i}"
            rids.append(rid)
            with t.request(rid):
                client.predict("m-0", {"categorical": ids},
                               rng.standard_normal((16, 13)))
        client.pull("m-0", "categorical", [1, 2, 3])
        # a request's http span closes just after its answer is written:
        # wait for the last one before scraping
        deadline = time.time() + 5.0
        while sum(s.name == "http" for s in t.RECORDER.spans()) \
                < N_PREDICT + 2 and time.time() < deadline:
            time.sleep(0.01)
        out = {"rids": rids, "sent": sent + 3}
        code, headers, text = _get(f"{url}/metrics")
        assert code == 200 and headers.get(t.SERVER_TIME_HEADER)
        out["metrics"] = text
        code, _h, body = _get(f"{url}/tracez?n=1000")
        out["tracez"] = json.loads(body)
        for route in ("statusz", "sloz", "historz", "timelinez",
                      "sloz?format=text", "historz?metric=serving.http.ms"):
            code, _h, body = _get(f"{url}/{route}")
            assert code == 200, (tag, route, body)
        out["statusz"] = _get(f"{url}/statusz")[2]
        out["capsule_unarmed"] = _get(f"{url}/capsule", b"{}")[0]
        c.configure(str(tmp_path / f"caps_{tag}"), min_interval_s=0.0)
        code, _h, body = _get(f"{url}/capsule",
                              json.dumps({"reason": "operator"}).encode())
        out["capsule"] = (code, json.loads(body).get("path"))
        sk.MONITOR.drain()
        out["sketch_total"] = sum(sk.MONITOR.sketch(v).total
                                  for v in sk.MONITOR.tables())
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()


def _series(text, parse):
    """{(name, labels) -> value} of the serving/skew families, times
    dropped (histogram buckets, sums, gauges of ms)."""
    out = {}
    for name, labels, v in parse(text)["samples"]:
        if not name.startswith(("oetpu_serving", "oetpu_skew")):
            continue
        if name.endswith(("_bucket", "_sum")) or "max_ms" in name:
            continue
        out[(name, tuple(sorted(labels.items())))] = v
    return out


def test_routes_match_the_jax_server(export, tmp_path):
    got = _drive("port", export, tmp_path)
    want = _drive("jax", export, tmp_path)
    g, w = (_series(got["metrics"], tm.parse_prometheus),
            _series(want["metrics"], jm.parse_prometheus))
    assert _series(got["metrics"], jm.parse_prometheus) == g
    assert set(g) == set(w)
    counts = {k: v for k, v in g.items() if k[0].endswith("_count")}
    assert counts == {k: v for k, v in w.items() if k[0].endswith("_count")}
    assert g[("oetpu_serving_predict_ms_count", (("model", "m-0"),))] \
        == N_PREDICT
    for out in (got, want):
        spans = out["tracez"]["spans"]
        names = {(s["group"], s["name"]) for s in spans}
        assert {("serving", "http"), ("serving", "predict"),
                ("serving", "model_call")} <= names
        predicts = [s for s in spans if s["name"] == "predict"]
        assert sorted(s["request_id"] for s in predicts) == out["rids"]
        assert out["capsule_unarmed"] == 409
        code, path = out["capsule"]
        assert code == 200 and jc.load(path) == tc.load(path)
        assert "-- flight recorder" in out["statusz"]
        assert out["sketch_total"] == out["sent"]
    assert {(s["group"], s["name"]) for s in got["tracez"]["spans"]} == \
        {(s["group"], s["name"]) for s in want["tracez"]["spans"]}


@pytest.mark.parametrize("tag", ["jax", "port"])
def test_fleetz_sums_two_servers(tag, export, tmp_path):
    srv, m, t, _sk, _c = PKG[tag]
    b, url_b = _start(tag, str(tmp_path / "b"))
    a, url_a = _start(tag, str(tmp_path / "a"), peers=[url_b])
    try:
        for url in (url_a, url_b):
            srv.ServingClient(url).create_model("m-0", export)
        m.observe("serving.fleet_probe", 3)
        code, _h, text = _get(f"{url_a}/fleetz")
        assert code == 200 and text.startswith("# fleet: 2 node(s)")
        # one process holds both nodes' registry: each counter twice
        parsed = m.parse_prometheus(text)
        probe = [v for n, lab, v in parsed["samples"]
                 if n == "oetpu_serving_fleet_probe_total"]
        assert probe == [6.0]
        http = [v for n, lab, v in parsed["samples"]
                if n == "oetpu_serving_http_ms_count"]
        assert http and http[0] % 2 == 0
    finally:
        for h in (a, b):
            h.shutdown()
            h.server_close()


def _counts(m, prefix):
    return {k: v for k, v in m.report().items()
            if k.startswith(prefix) and not k.endswith(
                (".p50", ".p95", ".p99")) and "ms" not in k
            and "staged_bytes" not in k and "overlap_ratio" not in k}


def test_offload_series_match_jax():
    p = Pair(capacity=64)
    rng = np.random.default_rng(3)
    for _ in range(12):
        p.prepare(rng.integers(0, 200, 24))
    p.j.flush()
    p.p.flush()
    got, want = _counts(tm, "offload."), _counts(jm, "offload.")
    assert got == want
    assert {"offload.admitted", "offload.evicted_cold", "offload.kept_hot",
            "offload.flushes"} <= set(got)
    spans = {k.split(".ms")[0] for k in tm.report() if k.endswith(".ms")}
    assert spans == {k.split(".ms")[0] for k in jm.report()
                     if k.endswith(".ms") and k.startswith("offload.")}
    assert {k for k in tm.report() if k.startswith("offload.staged_bytes")}


def test_persist_series_match_jax(tmp_path):
    batches = list(data.synthetic_criteo(8, id_space=VOCAB, steps=2))
    jtr = JaxTrainer(jax_make_deepfm(VOCAB, 9, hidden=(8,)),
                     jax_embed.Adagrad(learning_rate=0.05))
    ttr = Trainer(make_deepfm(VOCAB, 9, hidden=(8,)),
                  optimizers.Adagrad(learning_rate=0.05), device="cpu")
    for tr, step, cls, tag in (
            (jtr, jtr.jit_train_step(), JaxAsync, "jax"),
            (ttr, ttr.train_step, AsyncPersister, "port")):
        state = tr.init(batches[0])
        with cls(tr, tr.model, str(tmp_path / tag), window=1) as p:
            for b in batches:
                state, _ = step(state, b)
                p.persist(state)
    got, want = _counts(tm, "persist."), _counts(jm, "persist.")
    assert got == want == {"persist.submitted": 2.0,
                           "persist.committed": 2.0}
    names = lambda m: {k for k in m.report() if k.endswith(".ms")
                       and k.startswith("persist.")}
    assert names(tm) == names(jm)
    assert [e.name for e in tt.RECORDER.events()] == \
        [e.name for e in jt.RECORDER.events()] == ["commit", "commit"]


def test_ingest_series_match_jax():
    batches = list(data.synthetic_criteo(8, id_space=VOCAB, steps=6))
    for pf, kw in ((jax_prefetch, {}), (prefetch_to_device,
                                        {"device": "cpu"})):
        it = pf(iter(batches), size=2, **kw)
        next(it)
        import time
        time.sleep(0.2)  # the producer fills the queue and stalls
        it.close()
    names = lambda m: {k.split("{")[0] for k in m.report()
                       if k.startswith("ingest.")}
    assert names(tm) == names(jm) >= {"ingest.queue_depth",
                                      "ingest.producer_stall_ms",
                                      "ingest.dropped"}
    # the queue's two items at least (a stalled put may land during the
    # drain: timing, in both packages)
    for m in (tm, jm):
        assert m.report()['ingest.dropped{ring="prefetch"}'] >= 2.0
