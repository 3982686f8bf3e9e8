"""The port's spans and flight recorder (`utils/trace.py`) against the JAX
package's: the same script of spans (nested, across a thread handoff with
`contextvars.copy_context`, one raising), events and request ids gives the
same recorder contents and the same `chrome_events` names, nesting and
attributes (ids, process tags and times aside); the ring keeps the newest
entries; the trace headers made by either package's `inject_headers` read
back in the other's `extract_context`."""

import contextvars
import threading

import pytest

from openembedding_tpu.utils import metrics as jm
from openembedding_tpu.utils import trace as jt
from openembedding_tpu_torch.utils import metrics as tm
from openembedding_tpu_torch.utils import trace as tt

_VOLATILE = {"request_id", "process", "span_id", "span_uid", "parent_id",
             "parent_uid", "remote_parent"}


@pytest.fixture(autouse=True)
def _fresh():
    for t, m in ((jt, jm), (tt, tm)):
        t.RECORDER.clear()
        t.configure(2048)
        with m._LOCK:  # other tests' series leave their keys registered
            m._REGISTRY.clear()
    yield


def _script(t):
    with t.request("rid-1"):
        with t.span("serving", "http", method="POST"):
            with t.span("serving", "predict", labels={"model": "m"},
                        model="m"):
                t.event("sketch", "record", n=3)
            ctx = contextvars.copy_context()

            def worker():
                with t.span("batch", "exec", rows=8):
                    pass
            th = threading.Thread(target=ctx.run, args=(worker,))
            th.start()
            th.join()
        try:
            with t.span("persist", "write"):
                raise ValueError("disk")
        except ValueError:
            pass
    with t.span("trainer", "step"):
        pass


def _shape(t):
    ev = t.chrome_events()
    names = {e["args"].get("span_id"): e["name"] for e in ev
             if e["ph"] == "X"}
    out = []
    for e in ev:
        args = {k: v for k, v in e["args"].items() if k not in _VOLATILE}
        parent = names.get(e["args"].get("parent_id"))
        out.append((e["name"], e["cat"], e["ph"], parent,
                    e["args"].get("request_id"), sorted(args.items())))
    return out


def test_same_script_same_recorder_and_chrome_events():
    _script(jt)
    _script(tt)
    assert _shape(tt) == _shape(jt)
    shape = _shape(tt)
    # the handoff's span nests under the http span; the raising one is
    # marked and leaves a span_error event
    assert ("batch.exec", "batch", "X", "serving.http", "rid-1",
            [("rows", 8)]) in shape
    err = [s for s in shape if s[0] == "persist.write"][0]
    assert ("status", "error") in err[5]
    assert [s[0] for s in shape if s[2] == "i"] == ["sketch.record",
                                                     "persist.span_error"]
    # every span is also a histogram with the same series
    assert sorted(k for k in tm.report() if k.endswith(".ms")) == sorted(
        k for k in jm.report() if k.endswith(".ms"))
    assert jt.RECORDER.render_text().count("SPAN") == \
        tt.RECORDER.render_text().count("SPAN") == 5


def test_ring_keeps_the_newest():
    for t in (jt, tt):
        t.configure(4)
        for i in range(10):
            t.event("g", f"e{i}")
    assert [e.name for e in tt.RECORDER.events()] == \
        [e.name for e in jt.RECORDER.events()] == ["e6", "e7", "e8", "e9"]
    assert tt.RECORDER.capacity == 4


@pytest.mark.parametrize("src,dst", [(jt, tt), (tt, jt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_headers_cross_the_packages(src, dst):
    assert src.REQUEST_ID_HEADER == dst.REQUEST_ID_HEADER
    assert src.TRACE_HEADER == dst.TRACE_HEADER
    assert src.SERVER_TIME_HEADER == dst.SERVER_TIME_HEADER
    with src.request("abc123"):
        with src.span("client", "call") as sp:
            headers = src.inject_headers()
    ctx = dst.extract_context(headers)
    assert ctx.trace_id == "abc123"
    assert ctx.parent_span == sp.qualified_id
    with dst.request(ctx.trace_id, remote_parent=ctx.parent_span):
        with dst.span("serving", "http") as root:
            pass
    assert root.remote_parent == sp.qualified_id
    assert root.trace_id == "abc123"
    # a bare request-id header is enough
    assert dst.extract_context({src.REQUEST_ID_HEADER: "r9"}).trace_id == "r9"


def test_dump_chrome_loads(tmp_path):
    import json
    _script(tt)
    doc = json.load(open(tt.dump_chrome(str(tmp_path / "t.json"))))
    assert {e["name"] for e in doc["traceEvents"]} >= {"serving.http",
                                                       "trainer.step"}
