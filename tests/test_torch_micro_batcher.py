"""The port's `MicroBatcher` (`openembedding_tpu_torch/serving.py`).

- JAX's five tests (`tests/test_micro_batcher.py`) with the same fake
  model: only structural twins merge, a poisoned group fails alone, an
  internally ragged request fails at enqueue, a full group wakes its
  leader early, and the wait and fill metrics are published.
- With a real `StandaloneModel` on the CPU, concurrent requests merged
  into one device batch get the logits that the same requests get one by
  one, bit for bit, and the JAX servable's within 1e-5 (float32 tower).
- Through `make_server(batch_window_ms=...)`, concurrent REST predicts run
  in fewer device batches than requests (`serving.predict_batches` <
  `serving.predict_requests`) and answer as the unbatched node does.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu_torch import data
from openembedding_tpu_torch.export import (RaggedBatchError,
                                            StandaloneModel, export_standalone)
from openembedding_tpu_torch.serving import MicroBatcher, ServingClient
from openembedding_tpu_torch.utils import metrics

from torch_sync_util import TOL, VOCAB, node, reset_telemetry, train_setup

POISON = 666


@pytest.fixture(autouse=True)
def _fresh():
    reset_telemetry()
    yield
    reset_telemetry()


class FakeModel:
    """A per-row 'predict' that records every call: a row's output is the
    sum of its ids, so each client's slice is checkable however requests
    merged. A batch holding POISON raises."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def predict(self, batch):
        ids = np.asarray(batch["sparse"]["f"])
        with self._lock:
            self.calls.append({"rows": int(ids.shape[0]),
                               "width": int(ids.shape[1]),
                               "features": tuple(sorted(batch["sparse"]))})
        if (ids == POISON).any():
            raise RuntimeError("poisoned batch")
        out = ids.sum(axis=1).astype(np.float32)
        for k in sorted(batch["sparse"]):
            if k != "f":
                out = out + np.asarray(batch["sparse"][k]).sum(axis=1)
        return torch.from_numpy(out)  # a tensor, as the port's servables give


def _batch(ids, extra=None):
    b = {"sparse": {"f": np.asarray(ids, np.int64)}}
    if extra is not None:
        b["sparse"]["g"] = np.asarray(extra, np.int64)
    return b


def _expected(b):
    out = np.asarray(b["sparse"]["f"]).sum(axis=1).astype(np.float32)
    if "g" in b["sparse"]:
        out = out + np.asarray(b["sparse"]["g"]).sum(axis=1)
    return out


def test_mixed_group_keys_merge_only_structural_twins():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=250.0)
    rng = np.random.default_rng(0)
    reqs = [_batch(rng.integers(0, 50, (2, 2))) for _ in range(3)]
    reqs += [_batch(rng.integers(0, 50, (2, 3))) for _ in range(3)]
    reqs += [_batch(rng.integers(0, 50, (2, 2)),
                    extra=rng.integers(0, 50, (2, 2))) for _ in range(3)]
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
        outs = list(ex.map(lambda b: mb.predict(model, "m", b), reqs))
    for b, out in zip(reqs, outs):
        assert isinstance(out, np.ndarray)  # on the host, sliced there
        np.testing.assert_allclose(out, _expected(b))
    assert len(model.calls) < len(reqs)
    for call in model.calls:
        assert (call["width"], call["features"]) in [
            (2, ("f",)), (3, ("f",)), (2, ("f", "g"))]
    assert sum(c["rows"] for c in model.calls) == 2 * len(reqs)


def test_poisoned_group_fails_alone():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=250.0)
    good = [_batch(np.full((2, 3), 7)) for _ in range(2)]
    bad = [_batch([[1, POISON]]), _batch([[2, 3]])]  # width 2: one group
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        good_f = [ex.submit(mb.predict, model, "m", b) for b in good]
        bad_f = [ex.submit(mb.predict, model, "m", b) for b in bad]
        for f in good_f:
            np.testing.assert_allclose(f.result(timeout=30), [21.0, 21.0])
        for f in bad_f:
            with pytest.raises(RuntimeError, match="poisoned"):
                f.result(timeout=30)


def test_internally_ragged_request_fails_alone_at_enqueue():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=50.0)
    ragged = {"sparse": {"f": np.zeros((2, 2), np.int64),
                         "g": np.zeros((3, 2), np.int64)}}
    with pytest.raises(RaggedBatchError):
        mb.predict(model, "m", ragged)
    with pytest.raises(KeyError):
        mb.predict(model, "m", {"sparse": {}})
    assert model.calls == []


def test_early_wake_on_max_batch():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=30_000.0, max_batch=8)
    reqs = [_batch(np.full((4, 2), i)) for i in range(2)]  # 8 rows total
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(lambda b: mb.predict(model, "m", b), reqs))
    assert time.monotonic() - t0 < 10.0, "the leader slept out the window"
    for b, out in zip(reqs, outs):
        np.testing.assert_allclose(out, _expected(b))


def test_batcher_publishes_wait_and_fill_metrics():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=30.0, max_batch=64)
    wait = metrics.Accumulator.get("serving.batch_wait_ms", "avg")
    fill = metrics.Accumulator.get("serving.batch_fill_ratio", "avg")
    w0, f0 = wait.count, fill.count
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        list(ex.map(lambda b: mb.predict(model, "m", b),
                    [_batch(np.full((2, 2), i)) for i in range(3)]))
    assert wait.count > w0 and fill.count > f0
    assert 0.0 < fill.value() <= 1.0 and wait.value() >= 0.0


def test_chunks_never_exceed_max_batch():
    model = FakeModel()
    mb = MicroBatcher(manager=None, window_ms=200.0, max_batch=6)
    reqs = [_batch(np.full((4, 2), i)) for i in range(3)]
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(lambda b: mb.predict(model, "m", b), reqs))
    for b, out in zip(reqs, outs):
        np.testing.assert_allclose(out, _expected(b))
    assert all(c["rows"] <= 6 for c in model.calls)


# -- a real servable ------------------------------------------------------------


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    model, trainer, state, batches = train_setup(3)
    for b in batches:
        state, _ = trainer.train_step(state, b)
    path = str(tmp_path_factory.mktemp("mb") / "export")
    export_standalone(state, model, path, model_sign="mb-0")
    return path


def _requests(n, rows=5):
    return [next(iter(data.synthetic_criteo(rows, id_space=VOCAB, steps=1,
                                            seed=10 + i))) for i in range(n)]


def test_grouped_requests_match_ungrouped(export):
    sm = StandaloneModel.load(export, device="cpu")
    jsm = JaxStandalone.load(export)
    reqs = _requests(6)
    alone = [sm.predict(b).numpy() for b in reqs]
    model = _Counting(sm)
    mb = MicroBatcher(manager=None, window_ms=500.0)
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
        outs = list(ex.map(lambda b: mb.predict(model, "mb-0", b), reqs))
    assert model.calls < len(reqs)  # merged
    for b, want, got in zip(reqs, alone, outs):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, np.asarray(jsm.predict(b)), **TOL)


class _Counting:
    def __init__(self, sm):
        self.sm, self.calls = sm, 0

    def predict(self, batch):
        self.calls += 1
        return self.sm.predict(batch)


def test_server_batches_concurrent_predicts(tmp_path, export):
    reqs = _requests(8)
    with node(str(tmp_path / "plain")) as (plain_url, _), \
            node(str(tmp_path / "batched"), batch_window_ms=200.0,
                 max_batch=4096) as (url, srv):
        for u in (plain_url, url):
            ServingClient(u).create_model("mb-0", export)
        want = [ServingClient(plain_url).predict("mb-0", b["sparse"],
                                                 b["dense"]) for b in reqs]
        b0 = metrics.Accumulator.get("serving.predict_batches").value()
        r0 = metrics.Accumulator.get("serving.predict_requests").value()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            got = list(ex.map(lambda b: ServingClient(url).predict(
                "mb-0", b["sparse"], b["dense"]), reqs))
        batches = metrics.Accumulator.get("serving.predict_batches").value()
        requests = metrics.Accumulator.get(
            "serving.predict_requests").value()
    assert requests - r0 == len(reqs)
    assert batches - b0 < requests - r0
    assert srv.manager.find_model("mb-0") is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
