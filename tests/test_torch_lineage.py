"""The port's delta lineage (`openembedding_tpu_torch/sync/lineage.py`) and
the surfaces that carry it, from JAX's `tests/test_lineage.py`.

- The book: the same records as JAX's `LineageBook` after the same
  writes (hops merged key-wise, None ignored), the oldest record evicted
  at capacity, `note_serve` closing a chain once; the subscriber's
  Cristian clock offset and its EWMA (0.3), as JAX computes them.
- The hop decomposition: a delay injected into the publisher's
  `delta_table` lands on the applied delta's fetch hop (a lower bound set
  by the delay; orderings, never an upper bound on wall time), every stamp
  of the chain is set, and the first REST predict at the version adds the
  serve hop once.
- `/timelinez` carries the book; `tools/fleet_timeline.py` merges a
  publisher node and a serving node (a `python -m
  openembedding_tpu_torch.serving --sync-from` subprocess) into one
  contiguous, ordered chain; capsules carry the book.
"""

import importlib.util
import os
import queue
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from openembedding_tpu.sync import SyncSubscriber as JaxSubscriber
from openembedding_tpu.sync.lineage import LineageBook as JaxBook
from openembedding_tpu_torch import IncrementalPersister, PersistPolicy
from openembedding_tpu_torch.export import export_standalone
from openembedding_tpu_torch.sync import SyncPublisher, SyncSubscriber, lineage
from openembedding_tpu_torch.sync.lineage import LineageBook
from openembedding_tpu_torch.utils import capsule, metrics

from torch_sync_util import node, predict_body, req, reset_telemetry, \
    train_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = ["birth", "commit", "publish", "fetch", "apply", "swap",
         "first_predict"]


@pytest.fixture(autouse=True)
def _fresh():
    reset_telemetry()
    yield
    reset_telemetry()
    capsule.configure(None)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the book -------------------------------------------------------------------


def test_book_matches_jax_merge_and_eviction():
    books = (LineageBook(capacity=3), JaxBook(capacity=3))
    writes = [("m", 1, dict(birth=1.0, hops={"commit": 2.0})),
              ("m", 1, dict(seen=3.0, hops={"fetch": 4.0}, birth=None)),
              ("m", 2, dict(birth=5.0, trace_id="t")),
              ("n", 1, dict(swapped=6.0)),
              ("m", 1, dict(applied=7.0)),  # touched: moves to the end
              ("m", 3, dict(birth=8.0))]    # evicts the oldest: (m, 2)
    for book in books:
        for sign, step, stamps in writes:
            book.record(sign, step, **stamps)
    got, want = (b.export() for b in books)
    assert got == want
    assert [(r["sign"], r["step"]) for r in got] == [("n", 1), ("m", 1),
                                                     ("m", 3)]
    assert got[1]["hops"] == {"commit": 2.0, "fetch": 4.0}
    assert got[1]["birth"] == 1.0 and books[0].get("m", 2) is None
    assert books[0].last() == books[1].last() == got[-1]
    assert books[0].last("n") == books[1].last("n")
    assert books[0].export("m") == books[1].export("m")


def test_note_serve_once():
    book = LineageBook()
    book.note_serve("m", 1, now=1.0)  # no record yet: nothing lands
    assert book.get("m", 1) is None
    book.record("m", 1, swapped=10.0)
    book.note_serve("m", 1, now=10.5)
    book.note_serve("m", 1, now=11.0)  # idempotent
    rec = book.get("m", 1)
    assert rec["first_serve"] == 10.5 and rec["hops"] == {"serve": 500.0}
    acc = metrics.Accumulator.get("sync.hop_ms", "hist",
                                  labels={"hop": "serve"})
    assert acc.count == 1
    lineage.BOOK.record("g", 4, swapped=1.0)
    lineage.note_serve("g", 4)
    assert lineage.BOOK.get("g", 4)["first_serve"] is not None


def test_note_clock_ewma_matches_jax():
    subs = (SyncSubscriber(manager=None, model_sign="m", feed="http://feed"),
            JaxSubscriber(manager=None, model_sign="m", feed="http://feed"))
    for s in subs:
        s._note_clock(100.5, 99.9, 100.1)  # the first sample lands as is
    assert abs(subs[0]._clock_offset_s - 0.5) < 1e-9
    for s in subs:
        s._note_clock(101.5, 99.9, 100.1)  # +1.5: EWMA 0.3
        s._note_clock(99.0, 99.9, 100.1)
    assert subs[0]._clock_offset_s == subs[1]._clock_offset_s
    assert abs(subs[0]._clock_offset_s
               - (0.8 + 0.3 * (-1.0 - 0.8))) < 1e-9
    assert subs[0].status() == subs[1].status()
    assert subs[0].status()["clock_offset_ms"] == \
        subs[0]._clock_offset_s * 1e3


# -- the hop decomposition ------------------------------------------------------


def _chain_base(tmp_path, sign):
    model, trainer, state, batches = train_setup(4)
    root = str(tmp_path / "persist")
    p = IncrementalPersister(trainer, model, root, window=2,
                             policy=PersistPolicy(every_steps=1),
                             full_every=100)
    state, _ = trainer.train_step(state, batches[0])
    p.maybe_persist(state, batch=batches[0])
    p.wait()
    export_dir = str(tmp_path / "export")
    export_standalone(state, model, export_dir, model_sign=sign)
    return trainer, p, state, batches, root, export_dir


def test_hop_decomposition_with_injected_fetch_delay(tmp_path):
    trainer, p, state, batches, root, export_dir = _chain_base(tmp_path,
                                                               "lin-0")
    with p, node(str(tmp_path / "rp")) as (pu, pub_srv), \
            node(str(tmp_path / "rs")) as (su, srv):
        pub = SyncPublisher(root)
        pub_srv.publishers["lin-0"] = pub
        srv.manager.load_model("lin-0", export_dir)
        sub = SyncSubscriber(srv.manager, "lin-0", pu)
        assert sub.poll() == 0 and sub.version == 1
        orig = pub.delta_table

        def slow_table(*a, **kw):
            time.sleep(0.25)
            return orig(*a, **kw)

        pub.delta_table = slow_table
        state, _ = trainer.train_step(state, batches[1])
        p.maybe_persist(state, batch=batches[1])
        p.wait()
        assert sub.poll() == 1, sub.last_error

        st = sub.status()
        assert st["last_hops"]["step"] == 2
        hops = st["last_hops"]["hops"]
        assert {"commit", "publish", "fetch", "apply", "swap"} <= set(hops)
        assert hops["fetch"] >= 250.0, hops  # the injected delay lands here
        assert st["freshness_ms"] >= 250.0
        rec = lineage.BOOK.get("lin-0", 2)
        for stamp in ("birth", "commit", "seen", "fetched", "applied",
                      "swapped"):
            assert rec.get(stamp) is not None, (stamp, rec)
        assert rec["seen"] <= rec["fetched"] <= rec["applied"] \
            <= rec["swapped"]
        assert rec["hops"] == hops and "first_serve" not in rec

        assert req(f"{su}/models/lin-0/predict", "POST",
                   predict_body(batches[0]))[0] == 200
        rec = lineage.BOOK.get("lin-0", 2)
        first = rec["first_serve"]
        assert first >= rec["swapped"] and rec["hops"]["serve"] >= 0.0
        req(f"{su}/models/lin-0/predict", "POST", predict_body(batches[0]))
        assert lineage.BOOK.get("lin-0", 2)["first_serve"] == first

        status, doc, _ = req(f"{su}/timelinez")
        assert status == 200
        assert [(r["sign"], r["step"]) for r in doc["lineage"]] == \
            [("lin-0", 2)]
        assert doc["lineage"][0]["hops"]["fetch"] == hops["fetch"]
        with urllib.request.urlopen(f"{su}/fleetz", timeout=60) as r:
            text = r.read().decode()
        assert "# fleet freshness: self last delta step=2 hops:" in text
        # this node's freshness gauges, read back out of the merged scrape
        assert re.search(r"# fleet freshness: \S+: freshness_ms=[\d.]+ "
                         r"head_version=2 applied_version=2", text), text
        assert f"fetch={hops['fetch']:.1f}ms" in text


# -- fleet timeline over a publisher and a serving subprocess -------------------


def _spawn(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "openembedding_tpu_torch.serving", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    q = queue.Queue()
    threading.Thread(target=lambda: [q.put(x) for x in proc.stdout],
                     daemon=True).start()
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        try:
            line = q.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        seen.append(line)
        if "serving on http://" in line:
            return proc, line.split("serving on ")[1].split()[0]
    proc.kill()
    raise AssertionError(f"serving node never came up: {seen[-3:]!r}")


def test_fleet_timeline_merges_two_port_nodes(tmp_path):
    trainer, p, state, batches, root, export_dir = _chain_base(tmp_path,
                                                               "fl-0")
    ftl = _load_tool("fleet_timeline")
    with p, node(str(tmp_path / "rp"), publish={"fl-0": root}) as (pu, _):
        proc, su = _spawn(["--registry", str(tmp_path / "rs"), "--port", "0",
                           "--device", "cpu", "--sync-from", f"fl-0={pu}",
                           "--sync-interval", "0.05"])
        try:
            # the subscriber degrades until the model is loaded, then syncs
            assert req(f"{su}/models", "POST",
                       {"model_sign": "fl-0", "model_uri": export_dir})[0] \
                == 200
            state, _ = trainer.train_step(state, batches[1])
            p.maybe_persist(state, batch=batches[1])
            p.wait()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                st = req(f"{su}/models/fl-0:syncstate")[1]
                if st.get("version") == 2:
                    break
                time.sleep(0.05)
            assert st["version"] == 2 and st["state"] == "IDLE", st
            assert req(f"{su}/models/fl-0/predict", "POST",
                       predict_body(batches[0]))[0] == 200
            docs = []
            for url in (pu, su):
                doc, offset = ftl.probe(url)
                docs.append((doc["node"], doc, offset))
            assert docs[0][1]["lineage"] == []  # this process synced nothing
        finally:
            assert req(f"{su}/nodes/x", "DELETE")[0] == 200
            assert proc.wait(timeout=60) == 0
    items = ftl.filter_items(ftl.merge(docs), version=2)
    chain = [it for it in items if it["kind"] == "DELTA"]
    assert [it["what"].split()[1] for it in chain] == CHAIN
    ts = [it["ts"] for it in chain]
    assert all(a <= b for a, b in zip(ts, ts[1:]))
    assert {it["node"] for it in chain} == {docs[1][0]}
    assert ftl.render(items).count("DELTA") == len(CHAIN)


# -- capsules -------------------------------------------------------------------


def test_capsule_lineage_roundtrip(tmp_path):
    lineage.BOOK.record("cap-0", 9, birth=1.0, swapped=2.0,
                        hops={"fetch": 40.0})
    capsule.configure(str(tmp_path / "caps"))
    path = capsule.trigger("lineage_test", origin="test_lineage")
    assert path and os.path.exists(path)
    recs = capsule.load(path)["lineage"]
    assert recs == lineage.BOOK.export()
    assert recs[0]["sign"] == "cap-0" and recs[0]["hops"] == {"fetch": 40.0}
    assert np.isfinite(recs[0]["birth"])
