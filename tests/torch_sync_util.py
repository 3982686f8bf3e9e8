"""Shared pieces of the port's online-sync, micro-batcher, lineage and
serving-HA tests: the small DeepFM and its trainer, serving nodes of either
package on a thread, and a request helper that returns error answers."""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from openembedding_tpu import serving as jax_serving
from openembedding_tpu.sync import lineage as jax_lineage
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu.utils import trace as jax_trace
from openembedding_tpu_torch import data, optimizers, serving
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.sync import lineage
from openembedding_tpu_torch.utils import metrics, trace

VOCAB = 1 << 10
# the serving tolerance of tests/test_torch_serving.py (float32 towers)
TOL = dict(atol=1e-5, rtol=1e-5)


def reset_telemetry():
    """Both packages' metric registries, flight recorders and lineage
    books emptied."""
    for m, t, book in ((metrics, trace, lineage.BOOK),
                       (jax_metrics, jax_trace, jax_lineage.BOOK)):
        with m._LOCK:
            m._REGISTRY.clear()
        t.RECORDER.clear()
        book.clear()


def train_setup(steps=8, hashed=False):
    """The small DeepFM (float32 tower) and its Adagrad trainer on the CPU
    -> (model, trainer, state, batches)."""
    model = make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,),
                        compute_dtype=torch.float32, hashed=hashed,
                        capacity=4 * VOCAB if hashed else 0)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                      device="cpu")
    batches = list(data.synthetic_criteo(16, id_space=VOCAB, steps=steps,
                                         seed=1))
    return model, trainer, trainer.init(batches[0]), batches


def predict_body(batch) -> dict:
    return {"sparse": {k: np.asarray(v).tolist()
                       for k, v in batch["sparse"].items()},
            "dense": np.asarray(batch["dense"]).tolist()}


@contextlib.contextmanager
def node(registry: str, package: str = "port", **kw):
    """A started serving node of `package` ("port" on the CPU, or "jax")
    -> (base URL, server); its subscribers are stopped and the server shut
    down on exit."""
    if package == "port":
        srv = serving.make_server(registry, device="cpu", **kw)
    else:
        srv = jax_serving.make_server(registry, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    finally:
        for sub in list(srv.subscribers.values()):
            sub.stop()
        srv.shutdown()
        srv.server_close()


def req(url, method="GET", payload=None, headers=None):
    """-> (status, JSON body or {}, headers); HTTP errors are answers."""
    data_ = json.dumps(payload).encode() if payload is not None else None
    r = urllib.request.Request(url, data=data_, method=method,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else {}), dict(e.headers)
