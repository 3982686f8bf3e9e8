"""The port's online model sync (`openembedding_tpu_torch/sync/`) against
the JAX package's, on the small DeepFM of `tests/test_sync.py`.

- The wire: `sync_delta_cost` and the numpy row codecs equal JAX's.
- The feed: a port publisher over a root the port's `IncrementalPersister`
  wrote answers what the JAX `SyncPublisher` answers over the same root
  (`commit_time` aside), payload arrays equal, with JAX's status codes.
- End to end: a hammer thread predicts through REST across three swaps
  with no failure; after each `poll()` the servable's logits are bit-equal
  to a fresh port export of the same step, and within the serving
  tolerance of `tests/test_torch_serving.py` (float32: 1e-5) of the JAX
  servable that followed the same chain. bf16 and int8 wires stay within
  JAX's codec tolerances of the live rows (3e-2 and 6e-2 of the largest
  magnitude).
- Faults, DEGRADED on /statusz, a subscriber behind retention, the REST
  admin surface and the conditional swap, as JAX's tests hold them.
"""

import io
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from openembedding_tpu.ops import wire as jax_wire
from openembedding_tpu.serving import ModelManager as JaxManager
from openembedding_tpu.serving import ModelRegistry as JaxRegistry
from openembedding_tpu.sync import SyncPublisher as JaxPublisher
from openembedding_tpu.sync import SyncSubscriber as JaxSubscriber
from openembedding_tpu_torch import IncrementalPersister, PersistPolicy
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.ops import wire
from openembedding_tpu_torch.persist import list_deltas, list_persists
from openembedding_tpu_torch.serving import ModelManager, ModelRegistry
from openembedding_tpu_torch.sync import (FaultInjector, SyncPublisher,
                                          SyncSubscriber)
from openembedding_tpu_torch.utils import metrics

from torch_sync_util import (TOL, node, predict_body, req, reset_telemetry,
                             train_setup)

FORMATS = ("fp32", "bf16", "int8")


@pytest.fixture(autouse=True)
def _fresh():
    reset_telemetry()
    yield
    reset_telemetry()


def _persister(trainer, model, root, full_every=100):
    return IncrementalPersister(trainer, model, root, window=2,
                                policy=PersistPolicy(every_steps=1),
                                full_every=full_every)


def _base(tmp_path, sign, steps=8):
    """Train one step, persist the base and export it -> (model, trainer,
    state, batches, root, export_dir, the open persister)."""
    model, trainer, state, batches = train_setup(steps)
    root = str(tmp_path / "persist")
    p = _persister(trainer, model, root)
    state, _ = trainer.train_step(state, batches[0])
    p.maybe_persist(state, batch=batches[0])
    p.wait()
    export_dir = str(tmp_path / "export")
    export_standalone(state, model, export_dir, model_sign=sign)
    return model, trainer, state, batches, root, export_dir, p


def _deltas(trainer, p, state, batches):
    for b in batches:
        state, _ = trainer.train_step(state, b)
        p.maybe_persist(state, batch=b)
    p.wait()
    return state


# -- the wire -----------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_sync_delta_cost_matches_jax(fmt):
    for tables in ({"a": (100, 16)}, {"a": (7, 4), "b": (0, 9)},
                   {"c": (4096, 10), "d": (33, 33), "e": (5, 64)}):
        assert wire.sync_delta_cost(tables, fmt) == \
            jax_wire.sync_delta_cost(tables, fmt)
    c = wire.sync_delta_cost({"a": (100, 16)}, fmt)
    assert c["bytes_ids"] == 800  # ids never narrow
    assert c["bytes_rows"] == {"fp32": 6400, "bf16": 3200,
                               "int8": 2000}[fmt]


@pytest.mark.parametrize("fmt", FORMATS)
def test_np_codecs_match_jax(fmt):
    rng = np.random.default_rng(0)
    for dim in (4, 10, 32, 33):
        x = (rng.standard_normal((64, dim)) * 3).astype(np.float32)
        x[5] = 0.0  # an all-zero row: int8's scale-0 path
        enc = wire.np_encode_rows(x, fmt)
        want = jax_wire.np_encode_rows(x, fmt)
        assert enc.dtype == want.dtype == wire.np_wire_dtype(fmt)
        np.testing.assert_array_equal(enc, want)
        np.testing.assert_array_equal(wire.np_decode_rows(enc, dim, fmt),
                                      jax_wire.np_decode_rows(want, dim, fmt))
    np.testing.assert_array_equal(
        wire.np_decode_rows(wire.np_encode_rows(x, "fp32"), 33, "fp32"), x)


# -- the feed -----------------------------------------------------------------


def _npz(raw):
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


def test_publisher_feed_matches_jax(tmp_path):
    model, trainer, state, batches, root, _, p = _base(tmp_path, "m")
    with p:
        _deltas(trainer, p, state, batches[1:3])  # deltas at 2 and 3
    port, ref = SyncPublisher(root), JaxPublisher(root)

    def strip(feed):
        return {**feed, "deltas": [{k: v for k, v in d.items()
                                    if k != "commit_time"}
                                   for d in feed["deltas"]]}

    feed = port.versions()
    assert strip(feed) == strip(ref.versions())
    assert feed["base_step"] == 1 and feed["head_step"] == 3
    assert [d["commit_time"] for d in feed["deltas"]] == \
        [d["commit_time"] for d in ref.versions()["deltas"]]
    assert port.wait_versions(3, 0.05) == (feed, False)
    for step in (2, 3):
        assert port.delta_meta(step) == ref.delta_meta(step)
        for fmt in FORMATS:
            a = _npz(port.delta_table(step, "categorical", fmt))
            b = _npz(ref.delta_table(step, "categorical", fmt))
            assert a.keys() == b.keys() == {"ids", "wire", "fmt", "dim"}
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            last = a  # the port's last table serve: step 3, int8
        a, b = _npz(port.delta_dense(step)), _npz(ref.delta_dense(step))
        assert a.keys() == b.keys() and not any(k.startswith("slots/")
                                                for k in a)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    cost = wire.sync_delta_cost({"categorical": (last["ids"].size, 5)},
                                "int8")
    assert metrics.Accumulator.get("sync.wire_bytes_per_delta",
                                   "gauge").value() == cost["bytes_total"]
    assert metrics.Accumulator.get("sync.rows_per_delta",
                                   "gauge").value() == cost["rows"]

    # REST: the same status codes, ETags and bodies from both packages
    with node(str(tmp_path / "rp"), publish={"m": root}) as (pu, _), \
            node(str(tmp_path / "rj"), "jax", publish={"m": root}) as (ju, _):
        for path, code in (("/models/m:versions", 200),
                           ("/models/m:versions?after=3&wait_s=0.1", 304),
                           ("/models/m:versions?after=1", 200),
                           ("/models/m:versions?after=x", 400),
                           ("/models/m/delta/2/meta", 200),
                           ("/models/m/delta/99/meta", 404),
                           ("/models/m/delta/2/table/nope", 404),
                           ("/models/m/delta/2/table/categorical?wire=xx",
                            400),
                           ("/models/other:versions", 404),
                           ("/models/other/delta/2/meta", 404)):
            got, want = req(pu + path), req(ju + path)
            assert got[0] == want[0] == code, (path, got[:2], want[:2])
            assert got[2].get("ETag") == want[2].get("ETag"), path
            if code == 200 and "versions" not in path:
                assert got[1] == want[1], path
        assert req(pu + "/models/m:versions")[2]["ETag"] == '"3"'
        for path in ("/models/m/delta/2/table/categorical?wire=bf16",
                     "/models/m/delta/3/dense"):
            with urllib.request.urlopen(pu + path) as r:
                assert r.headers["Content-Type"] == "application/octet-stream"
                assert r.headers["ETag"] == f'"{path.split("/")[4]}"'
                a = _npz(r.read())
            with urllib.request.urlopen(ju + path) as r:
                b = _npz(r.read())
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


# -- end to end ---------------------------------------------------------------


def test_online_sync_end_to_end_bit_exact(tmp_path):
    """Three deltas applied with no restart while a hammer predicts through
    REST; after each poll the servable equals a fresh export bit for bit
    and the JAX servable that followed the same feed within 1e-5."""
    model, trainer, state, batches, root, export_dir, p = _base(
        tmp_path, "sync-0")
    probe = batches[0]
    jax_mgr = JaxManager(JaxRegistry(str(tmp_path / "reg_jax")))
    jax_mgr.load_model("sync-0", export_dir)
    with p, node(str(tmp_path / "rp"), publish={"sync-0": root}) as (pu, _), \
            node(str(tmp_path / "rs")) as (su, srv):
        srv.manager.load_model("sync-0", export_dir)
        stop, failures, served = threading.Event(), [], []

        def hammer():
            while not stop.is_set():
                status, out, _ = req(f"{su}/models/sync-0/predict", "POST",
                                     predict_body(probe))
                (served if status == 200 else failures).append(out)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            sub = SyncSubscriber(srv.manager, "sync-0", pu)
            jsub = JaxSubscriber(jax_mgr, "sync-0", pu)
            assert sub.poll() == 0 and sub.version == 1  # negotiated
            assert jsub.poll() == 0 and jsub.version == 1
            for i, b in enumerate(batches[1:4], start=2):
                state = _deltas(trainer, p, state, [b])
                old = srv.manager.find_model("sync-0")
                old_logits = old.predict(probe).clone()
                assert sub.poll() == 1, sub.last_error
                assert sub.state == "IDLE" and sub.version == i
                assert jsub.poll() == 1, jsub.last_error

                oracle_dir = str(tmp_path / f"oracle_{i}")
                export_standalone(state, model, oracle_dir)
                oracle = StandaloneModel.load(oracle_dir, device="cpu")
                servable = srv.manager.find_model("sync-0")
                assert servable is not old and servable.step == i
                got = servable.predict(probe)
                assert torch.equal(got, oracle.predict(probe))
                # RCU: the old servable was not written
                assert torch.equal(old.predict(probe), old_logits)
                want = np.asarray(jax_mgr.find_model("sync-0").predict(probe))
                np.testing.assert_allclose(got.numpy(), want, **TOL)
        finally:
            stop.set()
            t.join(timeout=30)
    assert failures == [], failures[:3]
    assert served
    assert sub.status()["applied"] == 3
    assert metrics.Accumulator.get("sync.applied_deltas").value() == 3


def test_online_sync_quantized_wire_within_tolerance(tmp_path):
    model, trainer, state, batches, root, export_dir, p = _base(tmp_path, "q")
    with p:
        state = _deltas(trainer, p, state, batches[1:4])
    live = state.tables["categorical"].weights.numpy()
    with node(str(tmp_path / "rp"), publish={"q": root}) as (pu, _):
        for fmt, tol in (("bf16", 3e-2), ("int8", 6e-2)):
            mgr = ModelManager(ModelRegistry(str(tmp_path / f"reg_{fmt}")),
                               device="cpu")
            mgr.load_model("q", export_dir)
            sub = SyncSubscriber(mgr, "q", pu, wire=fmt)
            assert sub.poll() == 3, sub.last_error
            got = mgr.find_model("q").lookup(
                "categorical", np.arange(64, dtype=np.int64)).numpy()
            scale = max(1.0, float(np.abs(live[:64]).max()))
            assert np.abs(got - live[:64]).max() <= tol * scale, fmt
            assert sub.wire == fmt


# -- faults -------------------------------------------------------------------


class _Truncate(FaultInjector):
    """Chop a row off one table payload: a torn delta."""

    def __init__(self, step):
        self.step = step

    def payload(self, step, payload):
        if step == self.step:
            name, (ids, rows) = next(iter(payload["tables"].items()))
            payload["tables"][name] = (ids, rows[:-1])
        return payload


class _Reorder(FaultInjector):
    def plan(self, steps):
        return steps[::-1]


class _DropMiddle(FaultInjector):
    def plan(self, steps):
        return [s for i, s in enumerate(steps) if i != 1 or len(steps) < 2]


class _Duplicate(FaultInjector):
    def plan(self, steps):
        return steps[:1] + steps


@pytest.mark.parametrize("fault_cls", [_Truncate, _Reorder, _DropMiddle,
                                       _Duplicate])
def test_sync_fault_injection_degrades_gracefully(tmp_path, fault_cls):
    """A torn, reordered, dropped or duplicated delta: the node keeps
    serving the last good version (DEGRADED, `sync.rollbacks` up, the
    predict answers), and catches up once the fault clears."""
    model, trainer, state, batches, root, export_dir, p = _base(tmp_path, "f")
    with p:
        _deltas(trainer, p, state, batches[1:4])  # deltas at 2, 3, 4
    with node(str(tmp_path / "rp"), publish={"f": root}) as (pu, _), \
            node(str(tmp_path / "rs")) as (su, srv):
        srv.manager.load_model("f", export_dir)
        faults = fault_cls(2) if fault_cls is _Truncate else fault_cls()
        sub = SyncSubscriber(srv.manager, "f", pu, faults=faults)
        assert sub.poll() == 0
        assert sub.state == "DEGRADED" and sub.last_error
        assert sub.status()["last_degraded_reason"] == sub.last_error
        assert metrics.Accumulator.get("sync.rollbacks").value() == 1
        servable = srv.manager.find_model("f")
        assert servable.step == sub.version  # a consistent prefix
        prefix = sub.version - 1
        status, out, _ = req(f"{su}/models/f/predict", "POST",
                             predict_body(batches[0]))
        assert status == 200 and len(out["logits"]) == 16
        sub.faults = None
        assert sub.poll() == 3 - prefix, sub.last_error
        assert sub.state == "IDLE" and sub.version == 4


def test_statusz_shows_degraded_state_and_reason(tmp_path):
    model, trainer, state, batches, root, export_dir, p = _base(tmp_path, "z")
    with p:
        _deltas(trainer, p, state, batches[1:3])  # deltas at 2, 3
    with node(str(tmp_path / "rp"), publish={"z": root}) as (pu, _), \
            node(str(tmp_path / "rs")) as (su, srv):
        srv.manager.load_model("z", export_dir)
        sub = SyncSubscriber(srv.manager, "z", pu, faults=_Truncate(2))
        srv.subscribers["z"] = sub  # registered on the node, as POST /sync
        assert sub.poll() == 0 and sub.state == "DEGRADED"
        with urllib.request.urlopen(f"{su}/statusz") as resp:
            text = resp.read().decode()
        assert "z: step=1 kind=StandaloneModel status=NORMAL" in text
        assert "z: state=DEGRADED version=1 applied=0" in text
        assert "torn payload" in text
        with urllib.request.urlopen(f"{pu}/statusz") as resp:
            text = resp.read().decode()
        assert "z: head_step=3 base_step=1 deltas=2" in text
        status, st, _ = req(f"{su}/models/z:syncstate")
        assert status == 200 and st["state"] == "DEGRADED"
        assert "torn payload" in st["last_degraded_reason"]
        status, tz, _ = req(f"{su}/tracez")
        evs = [e for e in tz["events"] if e["group"] == "sync"]
        assert any(e["name"] == "rollback" for e in evs)
        assert any(e["name"] == "state" and e["attrs"].get("to") == "DEGRADED"
                   for e in evs)
        sub.faults = None  # the reason stays for the post-mortem
        assert sub.poll() == 2 and sub.state == "IDLE"
        status, st, _ = req(f"{su}/models/z:syncstate")
        assert st["last_error"] is None
        assert "torn payload" in st["last_degraded_reason"]


def test_sync_behind_feed_retention_degrades(tmp_path):
    model, trainer, state, batches, root, export_dir, p = _base(tmp_path, "b")
    with p:
        p.full_every = 1  # fulls at 1 and 3
        for b in batches[1:3]:
            state = _deltas(trainer, p, state, [b])
        p.full_every = 100  # deltas past the newest full
        state = _deltas(trainer, p, state, batches[3:5])
    assert [s for s, _ in list_persists(root)][-1] == 3
    assert [s for s, _ in list_deltas(root)] == [4, 5]
    with node(str(tmp_path / "rp"), publish={"b": root}) as (pu, _):
        mgr = ModelManager(ModelRegistry(str(tmp_path / "reg_b")),
                           device="cpu")
        mgr.load_model("b", export_dir)  # still at step 1 < base 3
        sub = SyncSubscriber(mgr, "b", pu)
        assert sub.poll() == 0
        assert sub.state == "DEGRADED" and "reload" in sub.last_error
        assert mgr.find_model("b").step == 1


def test_sync_over_rest_admin_surface(tmp_path):
    """POST /publish on the trainer's node, POST /sync on the serving
    node, progress on :syncstate; DELETE stops the subscriber."""
    model, trainer, state, batches, root, export_dir, p = _base(tmp_path, "r")
    with p:
        _deltas(trainer, p, state, batches[1:4])
    with node(str(tmp_path / "rp")) as (pu, _), \
            node(str(tmp_path / "rs")) as (su, srv):
        status, out, _ = req(f"{pu}/models/r/publish", "POST",
                             {"persist_root": root})
        assert status == 200 and out["head_step"] == 4
        assert out["model_sign"] == "r"
        assert req(f"{su}/models/r", "POST", {"model_uri": export_dir})[0] \
            == 200
        status, out, _ = req(f"{su}/models/r/sync", "POST",
                             {"feed": pu, "interval_s": 0.05})
        assert status == 200
        assert out["state"] in ("IDLE", "FETCHING", "APPLYING")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status, st, _ = req(f"{su}/models/r:syncstate")
            assert status == 200
            if st["version"] == 4:
                break
            time.sleep(0.05)
        assert st["version"] == 4 and st["applied"] == 3, st
        assert req(f"{pu}/models/x/publish", "POST", {})[0] == 400
        assert req(f"{pu}/models/x/publish", "POST",
                   {"persist_root": str(tmp_path / "nope")})[0] == 400
        assert req(f"{su}/models/x/sync", "POST", {})[0] == 400
        assert req(f"{su}/models/x:syncstate")[0] == 404
        sub = srv.subscribers["r"]
        assert req(f"{su}/models/r", "DELETE")[0] == 200
        assert "r" not in srv.subscribers and sub._thread is None


def test_manager_swap_is_conditional(tmp_path):
    model, trainer, state, batches = train_setup(2)
    export_dir = str(tmp_path / "export")
    export_standalone(state, model, export_dir, model_sign="s")
    mgr = ModelManager(ModelRegistry(str(tmp_path / "reg")), device="cpu")
    with pytest.raises(KeyError):
        mgr.swap("s", object())  # not loaded
    mgr.load_model("s", export_dir)
    cur = mgr.find_model("s")
    other = StandaloneModel.load(export_dir, device="cpu")
    with pytest.raises(RuntimeError, match="reloaded concurrently"):
        mgr.swap("s", other, expected=other)
    mgr.swap("s", other, expected=cur)
    assert mgr.find_model("s") is other
    assert mgr.servable_versions() == {"s": {"step": 0,
                                             "kind": "StandaloneModel"}}
