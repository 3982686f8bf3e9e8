"""Serving HA in the port: replica failover, kill and restart, and the
live-replica restore (`restore_from_peer` over `:exportmeta` / `:rows` /
`:dense`), from JAX's `tests/test_serving_ha.py` and `tests/test_sync.py`.

- A restore round-trips array and hash tables paged smaller than the
  table: the restored export's lookups equal the peer's bit for bit and
  its predict the original's.
- It is crash safe (a peer dying mid-page leaves no `dest` and no staging
  directory), refuses a source that is not NORMAL, and an unknown sign is
  the peer's 404; bad ranges are 400 and unknown variables 404, as on a
  JAX node.
- Port nodes as `python -m openembedding_tpu_torch.serving --device cpu`
  subprocesses: a client fails over from a killed node, a new node with
  no shared registry restores from a live peer, the killed node restarts.
- Across the packages: the port restores from a JAX node and JAX from a
  port node, and the written arrays are equal.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from openembedding_tpu.serving import restore_from_peer as jax_restore
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.serving import ServingClient, restore_from_peer

from torch_sync_util import VOCAB, node, req, reset_telemetry, train_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGN = "ha-model-1"
IDS = [[1, 2], [3, VOCAB - 1]]


@pytest.fixture(autouse=True)
def _fresh():
    reset_telemetry()
    yield
    reset_telemetry()


def _export(tmp_path_factory, kind):
    """A small trained DeepFM export (array or hash table) and a batch."""
    model, trainer, state, batches = train_setup(3, hashed=kind == "hash")
    for b in batches:
        state, _ = trainer.train_step(state, b)
    path = str(tmp_path_factory.mktemp("ha") / "export")
    export_standalone(state, model, path, model_sign=SIGN)
    return path, batches[0]


@pytest.fixture(scope="module", params=["array", "hash"])
def exported(request, tmp_path_factory):
    return _export(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def array_exported(tmp_path_factory):
    return _export(tmp_path_factory, "array")


def _files(path):
    """{relative path: array} of an export's arrays."""
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            fp = os.path.join(d, f)
            rel = os.path.relpath(fp, path)
            if f.endswith(".npy"):
                out[rel] = np.load(fp)
            elif f.endswith(".npz"):
                with np.load(fp) as z:
                    out.update({f"{rel}/{k}": z[k] for k in z.files})
    return out


def test_restore_from_peer_roundtrip(exported, tmp_path):
    path, batch = exported
    with node(str(tmp_path / "reg1")) as (peer, srv):
        assert req(f"{peer}/models", "POST",
                   {"model_sign": SIGN, "model_uri": path})[0] == 200
        base = ServingClient(peer).pull(SIGN, "categorical", IDS,
                                        binary=True)
        assert base.dtype == np.float32 and base.shape == (2, 2, 5)
        np.testing.assert_array_equal(
            base, ServingClient(peer).pull(SIGN, "categorical", IDS))
        rows = srv.manager.find_model(SIGN).export_manifest()[
            "variables"][0]["rows"]
        page = 3 if rows < 200 else 100  # several pages either way
        assert rows > 2 * page
        dest = restore_from_peer(peer, SIGN, str(tmp_path / "restored"),
                                 page=page)
        restored = StandaloneModel.load(dest, device="cpu")
        got = restored.lookup("categorical", np.asarray(IDS)).numpy()
        np.testing.assert_array_equal(got, base)
        orig = StandaloneModel.load(path, device="cpu")
        assert torch.equal(restored.predict(batch), orig.predict(batch))
        want = _files(path)
        got = _files(dest)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        with open(os.path.join(dest, "model_meta")) as f:
            meta = json.load(f)
        assert meta["uri"] == dest and meta["num_shards"] == 1
        assert meta["extra"]["restored_from"] == f"{peer}/models/{SIGN}"
        for q, code in ((f"/models/{SIGN}:rows?var=categorical&start=-1",
                         400),
                        (f"/models/{SIGN}:rows?var=nope", 404),
                        (f"/models/{SIGN}:rows", 400),
                        (f"/models/{SIGN}:rows?var=categorical&count=x",
                         400),
                        ("/models/nope-0:exportmeta", 404)):
            assert req(peer + q)[0] == code, q


def test_restore_from_peer_crash_safe(exported, tmp_path, monkeypatch):
    """A restore that dies mid-page leaves nothing at dest; a complete
    restore lands, and a second one replaces it."""
    path, _ = exported
    dest = str(tmp_path / "restored")
    with node(str(tmp_path / "reg")) as (peer, srv):
        srv.manager.load_model(SIGN, path)
        real, calls = urllib.request.urlopen, {"n": 0}

        def flaky(url, *a, **kw):
            calls["n"] += 1
            if calls["n"] == 4:  # entry, manifest, a page: then the peer dies
                raise ConnectionError("peer died mid-page")
            return real(url, *a, **kw)

        monkeypatch.setattr(urllib.request, "urlopen", flaky)
        with pytest.raises(ConnectionError):
            restore_from_peer(peer, SIGN, dest, page=16)
        monkeypatch.undo()
        assert calls["n"] >= 4
        assert not os.path.exists(dest)
        assert not any(f.startswith("restored.tmp-")
                       for f in os.listdir(str(tmp_path)))
        assert restore_from_peer(peer, SIGN, dest) == dest
        assert restore_from_peer(peer, SIGN, dest, page=64) == dest
        assert os.path.exists(os.path.join(dest, "model_meta"))
        assert not any(f.startswith("restored.tmp-")
                       for f in os.listdir(str(tmp_path)))


def test_restore_refuses_non_normal(exported, tmp_path):
    path, _ = exported
    with node(str(tmp_path / "regnn")) as (peer, srv):
        srv.manager.registry.create_model("half-0", path)  # never NORMAL
        with pytest.raises(RuntimeError, match="CREATING"):
            restore_from_peer(peer, "half-0", str(tmp_path / "d1"))
        with pytest.raises(urllib.error.HTTPError) as ei:
            restore_from_peer(peer, "nope-0", str(tmp_path / "d2"))
        assert ei.value.code == 404
        assert not os.path.exists(str(tmp_path / "d1"))


@pytest.mark.parametrize("source", ["jax", "port"])
def test_restore_across_packages(exported, tmp_path, source):
    """The port restores from a JAX node and JAX from a port node; both
    restores write the same arrays as a same-package restore."""
    path, batch = exported
    with node(str(tmp_path / "reg"), source) as (peer, srv):
        srv.manager.load_model(SIGN, path)
        a = restore_from_peer(peer, SIGN, str(tmp_path / "by_port"), page=7)
        b = jax_restore(peer, SIGN, str(tmp_path / "by_jax"), page=7)
    fa, fb, want = _files(a), _files(b), _files(path)
    assert fa.keys() == fb.keys() == want.keys()
    for k, v in want.items():
        assert fa[k].dtype == fb[k].dtype == v.dtype, k
        np.testing.assert_array_equal(fa[k], v, err_msg=k)
        np.testing.assert_array_equal(fb[k], v, err_msg=k)
    assert torch.equal(StandaloneModel.load(a, device="cpu").predict(batch),
                       StandaloneModel.load(path, device="cpu").predict(batch))


# -- subprocess nodes: kill -9 and restart ---------------------------------


def _spawn_node(registry, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "openembedding_tpu_torch.serving",
         "--registry", registry, "--port", "0", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    q = queue.Queue()

    def _reader():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=_reader, daemon=True).start()
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        try:
            line = q.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        if "serving on http://" in line:
            return proc, line.split("serving on ")[1].split()[0]
    proc.kill()
    raise AssertionError(f"serving node never came up: {seen[-3:]!r}")


def test_ha_kill_restart_and_peer_restore(array_exported, tmp_path):
    path, _ = array_exported
    reg = str(tmp_path / "reg")
    os.makedirs(reg, exist_ok=True)
    ids = [[5, 6, 7]]
    procs = []
    try:
        n1, u1 = _spawn_node(reg)
        procs.append(n1)
        n2, u2 = _spawn_node(reg)
        procs.append(n2)
        assert req(f"{u1}/models", "POST",
                   {"model_sign": SIGN, "model_uri": path})[0] == 200
        base = ServingClient([u1]).pull(SIGN, "categorical", ids)
        # replica 2 serves the same answer from the shared registry
        np.testing.assert_array_equal(
            ServingClient([u2]).pull(SIGN, "categorical", ids), base)
        status, nodes, _ = req(f"{u2}/nodes")
        assert status == 200 and nodes["nodes"][0]["device"] == "cpu"

        n1.send_signal(signal.SIGKILL)  # the client fails over to node 2
        n1.wait(timeout=30)
        np.testing.assert_array_equal(
            ServingClient([u1, u2]).pull(SIGN, "categorical", ids), base)

        # a new node with no shared registry restores from the live peer
        dest = restore_from_peer(u2, SIGN, str(tmp_path / "restored2"))
        n3, u3 = _spawn_node(str(tmp_path / "reg2"))
        procs.append(n3)
        assert req(f"{u3}/models", "POST",
                   {"model_sign": SIGN, "model_uri": dest})[0] == 200
        np.testing.assert_array_equal(
            ServingClient([u3]).pull(SIGN, "categorical", ids), base)

        # the killed node restarts and serves from the registry
        n1b, u1b = _spawn_node(reg)
        procs.append(n1b)
        np.testing.assert_array_equal(
            ServingClient([u1b]).pull(SIGN, "categorical", ids), base)
        # DELETE /nodes/<id> shuts a node down
        assert req(f"{u3}/nodes/n3", "DELETE")[0] == 200
        assert n3.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
