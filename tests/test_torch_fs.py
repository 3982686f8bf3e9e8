"""The port's remote-storage URIs (`utils/fs.py`) against the JAX package's:
the 8 cases of `tests/test_fs.py` on the port (the scheme registry, the
shell-pipe transport, `hdfs://`, `read_criteo_tsv` off a URI, checkpoints,
exports and sharded checkpoints through a registered scheme, the quiet
abandoned pipe), and the crossing: a checkpoint, an export and a sharded
checkpoint written by either package to a URI load in the other through
the same URI, each package's mock filesystem registered over one root.

Tolerance 0 throughout: a checkpoint moves bytes, the readers parse the
same bytes, and the tables and dense params are compared bit for bit.
"""

import gzip
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import openembedding_tpu as jax_embed
from openembedding_tpu.checkpoint import _flatten_params
from openembedding_tpu.data import read_criteo_tsv as jax_read_criteo_tsv
from openembedding_tpu.data import synthetic_criteo as jax_synthetic
from openembedding_tpu.export import StandaloneModel as JaxStandalone
from openembedding_tpu.export import export_standalone as jax_export
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel.serving import ShardedModel as JaxSharded
from openembedding_tpu.parallel.sharded import deinterleave_rows
from openembedding_tpu.utils import fs as jax_fs
from openembedding_tpu_torch import convert, optimizers
from openembedding_tpu_torch.data import read_criteo_tsv, synthetic_criteo
from openembedding_tpu_torch.export import StandaloneModel, export_standalone
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.parallel.serving import ShardedModel
from openembedding_tpu_torch.utils import fs as fsmod

import torch_fs_ranks as ranks

TSV = os.path.join(os.path.dirname(__file__), "..", "examples", "train100.tsv")
VOCAB = 512


class JaxDirFS(jax_fs.FileSystemBase):
    """The JAX package's side of the mock scheme, over the same root."""

    def __init__(self, root):
        self.root = root

    _p = ranks.DirFS._p
    open = ranks.DirFS.open
    exists = ranks.DirFS.exists
    listdir = ranks.DirFS.listdir
    makedirs = ranks.DirFS.makedirs
    isdir = ranks.DirFS.isdir


@pytest.fixture()
def mockfs(tmp_path):
    root = str(tmp_path / "remote")
    fs = ranks.DirFS(root)
    fsmod.register_filesystem("mock", fs)
    jax_fs.register_filesystem("mock", JaxDirFS(root))
    yield fs
    fsmod._REGISTRY.pop("mock", None)
    jax_fs._REGISTRY.pop("mock", None)


def _shell_fs(**extra):
    return fsmod.ShellPipeFS(
        cat=["cat", "{path}"],
        put=["sh", "-c", "mkdir -p $(dirname {path}) && cat > {path}"],
        test=["test", "-e", "{path}"], ls=["ls", "{path}"],
        mkdir=["mkdir", "-p", "{path}"], **extra)


def _port_trained(seed=0):
    model = make_deepfm(VOCAB, 4, hidden=(8,))
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.1), device="cpu")
    b = next(synthetic_criteo(16, id_space=VOCAB, steps=1, seed=seed))
    st = tr.init(b)
    st, _ = tr.train_step(st, b)
    return model, tr, st, b


def _jax_trained(seed=0):
    model = jax_make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))
    tr = JaxTrainer(model, jax_embed.Adagrad(learning_rate=0.1))
    b = next(jax_synthetic(16, id_space=VOCAB, steps=1, seed=seed))
    st = tr.init(b)
    st, _ = tr.jit_train_step()(st, b)
    return model, tr, st, b


def _jax_numpy(st):
    return {"weights": np.asarray(st.tables["categorical"].weights),
            "slots": {k: np.asarray(v) for k, v in
                      st.tables["categorical"].slots.items()},
            "dense": {k: np.asarray(v) for k, v in
                      _flatten_params(st.dense_params).items()}}


def _port_numpy(st):
    j = convert.train_state_to_jax(st)
    t = j["tables"]["categorical"]
    return {"weights": t["weights"], "slots": t["slots"],
            "dense": j["dense_params"]}


def _assert_states_equal(a, b):
    np.testing.assert_array_equal(a["weights"], b["weights"])
    assert a["slots"].keys() == b["slots"].keys()
    for k in a["slots"]:
        np.testing.assert_array_equal(a["slots"][k], b["slots"][k])
    assert a["dense"].keys() == b["dense"].keys()
    for k in a["dense"]:
        np.testing.assert_array_equal(a["dense"][k], b["dense"][k])


# -- the JAX package's 8 cases, on the port -----------------------------------


def test_split_and_resolve(mockfs):
    for mod in (fsmod, jax_fs):
        assert mod.split_uri("/a/b") == (None, "/a/b")
        assert mod.split_uri("file:///a/b") == (None, "/a/b")
        assert mod.split_uri("mock://x/y") == ("mock", "mock://x/y")
        assert not mod.is_remote("/a/b")
        assert mod.is_remote("mock://x")
    with pytest.raises(ValueError, match="no filesystem registered"):
        fsmod.resolve("unknown://x")
    assert fsmod.local_path("file:///a/b") == "/a/b"
    with pytest.raises(ValueError, match="local files only"):
        fsmod.local_path("mock://x")


def test_shell_pipe_fs_round_trip(tmp_path):
    """A ShellPipeFS over plain sh commands: the pipe transport the hadoop
    registration uses (hadoop itself is absent here)."""
    root = tmp_path / "shellfs"
    root.mkdir()
    fs = _shell_fs(testdir=["test", "-d", "{path}"])
    p = str(root / "a" / "blob.bin")
    payload = os.urandom(1 << 16)
    with fs.open(p, "wb") as f:
        f.write(payload)
    assert fs.exists(p)
    with fs.open(p, "rb") as f:
        assert f.read() == payload
    assert fs.listdir(str(root / "a")) == ["blob.bin"]
    assert fs.isdir(str(root / "a")) and not fs.isdir(p)
    with pytest.raises(NotImplementedError, match="testdir"):
        _shell_fs().isdir(str(root))


def test_hdfs_scheme_registered(monkeypatch):
    for mod in (fsmod, jax_fs):
        fs, _ = mod.resolve("hdfs://nn/path")
        assert isinstance(fs, mod.ShellPipeFS)
        assert fs._cmd("cat", "hdfs://nn/p")[-1] == "hdfs://nn/p"
    fs, _ = fsmod.resolve("viewfs://nn/path")
    jfs, _ = jax_fs.resolve("viewfs://nn/path")
    monkeypatch.setenv("OETPU_HADOOP_BIN", "hadoop-3.4/bin/hadoop")
    for name in ("cat", "put", "test", "ls", "mkdir", "testdir"):
        assert fs._cmd(name, "viewfs://nn/p") == jfs._cmd(name,
                                                          "viewfs://nn/p")
    assert fs._cmd("cat", "x")[0] == "hadoop-3.4/bin/hadoop"


def test_read_criteo_tsv_from_uri(mockfs, tmp_path):
    """The Criteo stream reads straight off a URI, plain and .gz, equal to
    the local read and to the JAX package's read of the same URI."""
    with open(TSV, "rb") as f:
        data = f.read()
    with mockfs.open("mock://data/train.tsv", "wb") as f:
        f.write(data)
    with mockfs.open("mock://data/train.tsv.gz", "wb") as f:
        f.write(gzip.compress(data))
    local = list(read_criteo_tsv([TSV], 32, id_space=1 << 20))
    for uri in ("mock://data/train.tsv", "mock://data/train.tsv.gz"):
        for native in ("auto", "off"):
            remote = list(read_criteo_tsv([uri], 32, id_space=1 << 20,
                                          native=native))
            want = list(jax_read_criteo_tsv([uri], 32, id_space=1 << 20))
            assert len(local) == len(remote) == len(want) == 3
            for a, b, c in zip(local, remote, want):
                for key in ("label", "dense"):
                    np.testing.assert_array_equal(a[key], b[key])
                    np.testing.assert_array_equal(c[key], b[key])
                np.testing.assert_array_equal(a["sparse"]["categorical"],
                                              b["sparse"]["categorical"])
                np.testing.assert_array_equal(c["sparse"]["categorical"],
                                              b["sparse"]["categorical"])
    with pytest.raises(ValueError, match="local files only"):
        next(read_criteo_tsv(["mock://data/train.tsv"], 32, native="on"))


def test_read_criteo_tsv_raises_on_a_transport_failing_mid_stream(
        tmp_path):
    """A transport that dies after writing part of a file fails the read,
    where the consumer reached the end of the stream: no silent
    truncation."""
    fsmod.register_filesystem("broken", fsmod.ShellPipeFS(
        cat=["sh", "-c", f"head -c 20000 {TSV}; exit 3"],
        put=["true"], test=["true"], ls=["true"], mkdir=["true"]))
    try:
        with pytest.raises(IOError, match="rc=3"):
            list(read_criteo_tsv(["broken://x.tsv"], 8, native="off"))
    finally:
        fsmod._REGISTRY.pop("broken", None)


def test_checkpoint_through_uri(mockfs):
    """Trainer.save/load against a mock:// URI: write locally + push, then
    fetch + load: rows identical to the saved state."""
    _, tr, st, b = _port_trained()
    tr.save(st, "mock://ckpts/run1")
    assert mockfs.exists("mock://ckpts/run1/model_meta")
    assert mockfs.exists("mock://ckpts/run1/variable_0/weights.npy")
    _, tr2, _, _ = _port_trained(seed=5)
    st2 = tr2.load(tr2.init(b), "mock://ckpts/run1")
    _assert_states_equal(_port_numpy(st2), _port_numpy(st))


def test_serving_loads_from_uri(mockfs):
    """ShardedModel and StandaloneModel load remote checkpoints and exports
    through staging (and leave no staged copy behind)."""
    import tempfile
    model, tr, st, _ = _port_trained(seed=2)
    tr.save(st, "mock://serve/ck")
    ids = np.asarray([0, 3, 7])
    want = st.tables["categorical"].weights[torch.from_numpy(ids)].numpy()
    before = set(os.listdir(tempfile.gettempdir()))
    sm = ShardedModel.load("mock://serve/ck", devices=["cpu"] * 2)
    np.testing.assert_array_equal(sm.lookup("categorical", ids).numpy(),
                                  want)
    exp = tempfile.mkdtemp()
    export_standalone(st, model, exp)
    fsmod.stage_out(exp, "mock://serve/exp")
    sa = StandaloneModel.load("mock://serve/exp", device="cpu")
    np.testing.assert_array_equal(sa.lookup("categorical", ids).numpy(),
                                  want)
    shutil.rmtree(exp)
    staged = [n for n in set(os.listdir(tempfile.gettempdir())) - before
              if n.startswith(("oetpu_stage_", "oetpu_ckpt_out_"))]
    assert not staged


def test_early_abandoned_pipe_reader_is_quiet(tmp_path):
    """Breaking out of a URI stream early must not raise (the producer is
    terminated quietly); a failed producer still raises."""
    fs = _shell_fs()
    big = tmp_path / "big.bin"
    big.write_bytes(os.urandom(1 << 20))
    r = fs.open(str(big), "rb")
    r.read(1024)
    r.close()  # abandoned mid-stream: no raise
    bad = fs.open(str(tmp_path / "missing.bin"), "rb")
    assert bad.read() == b""
    with pytest.raises(IOError, match="rc="):
        bad.close()


def test_sharded_checkpoint_through_uri(mockfs, tmp_path):
    """MeshTrainer's per-shard save from two ranks pushes each rank's files
    through the adapter (the scheme registered in each rank's process);
    it loads back on the ranks and reshards 2 -> 1 through the URI."""
    batch = next(synthetic_criteo(16, id_space=VOCAB, steps=1, seed=1))
    cfg = {"scheme": "mock", "root": mockfs.root, "vocab": VOCAB,
           "batch": batch, "uri": "mock://ckpts/sharded1"}
    out = run_local(ranks.save_sharded_to_uri, 2, args=(cfg,),
                    timeout_s=90, tmp_dir=str(tmp_path))
    for r in range(2):
        assert mockfs.exists(f"mock://ckpts/sharded1/variable_0/"
                             f"shard_{r:05d}_of_00002/weights.npy")
        saved, loaded = out[r]["saved"], out[r]["loaded"]
        np.testing.assert_array_equal(
            loaded["tables"]["categorical"]["weights"],
            saved["tables"]["categorical"]["weights"])
    model = make_deepfm(VOCAB, 4, hidden=(8,), compute_dtype=torch.float32)
    tr = Trainer(model, optimizers.Adagrad(learning_rate=0.1), device="cpu")
    st = tr.load(tr.init(batch), "mock://ckpts/sharded1")
    shards = np.concatenate([out[r]["saved"]["tables"]["categorical"][
        "weights"] for r in range(2)])
    np.testing.assert_array_equal(
        st.tables["categorical"].weights.numpy()[:VOCAB],
        np.asarray(deinterleave_rows(shards, 2, VOCAB)))


# -- across the packages ------------------------------------------------------


def test_port_checkpoint_loads_in_jax_through_the_uri(mockfs):
    _, tr, st, _ = _port_trained(seed=3)
    tr.save(st, "mock://x/port_ck")
    _, jtr, _, jb = _jax_trained(seed=4)
    jst = jtr.load(jtr.init(jb), "mock://x/port_ck")
    _assert_states_equal(_jax_numpy(jst), _port_numpy(st))


def test_jax_checkpoint_loads_in_the_port_through_the_uri(mockfs):
    _, jtr, jst, _ = _jax_trained(seed=3)
    jtr.save(jst, "mock://x/jax_ck")
    _, tr, _, b = _port_trained(seed=4)
    st = tr.load(tr.init(b), "mock://x/jax_ck")
    _assert_states_equal(_port_numpy(st), _jax_numpy(jst))


def test_exports_cross_through_the_uri(mockfs, tmp_path):
    """Each package's export, staged out to the URI, loads in the other's
    StandaloneModel from the URI: the same rows."""
    ids = np.asarray([0, 3, 7, 511])
    model, _, st, _ = _port_trained(seed=6)
    export_standalone(st, model, str(tmp_path / "pe"))
    fsmod.stage_out(str(tmp_path / "pe"), "mock://exp/port")
    got = np.asarray(JaxStandalone.load("mock://exp/port").lookup(
        "categorical", ids))
    np.testing.assert_array_equal(
        got, st.tables["categorical"].weights[torch.from_numpy(ids)].numpy())
    jmodel, _, jst, _ = _jax_trained(seed=6)
    jax_export(jst, jmodel, str(tmp_path / "je"))
    jax_fs.stage_out(str(tmp_path / "je"), "mock://exp/jax")
    got = StandaloneModel.load("mock://exp/jax", device="cpu").lookup(
        "categorical", ids).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jst.tables["categorical"].weights)[ids])


def test_sharded_checkpoints_cross_through_the_uri(mockfs, tmp_path):
    """A JAX MeshTrainer's sharded checkpoint (8 devices) served by the
    port's ShardedModel from the URI, and the port's two-rank one served by
    JAX's: lookups equal the writer's rows by id."""
    ids = np.arange(0, VOCAB, 37)
    model = jax_make_deepfm(vocabulary=VOCAB, dim=4, hidden=(8,))
    jtr = JaxMeshTrainer(model, jax_embed.Adagrad(learning_rate=0.1),
                         mesh=jax_make_mesh(jax.devices()[:8]))
    b = next(jax_synthetic(16, id_space=VOCAB, steps=1, seed=1))
    jst = jtr.init(b)
    jst, _ = jtr.jit_train_step(b, jst)(jst, b)
    jtr.save(jst, "mock://cross/jax_sharded")
    want = np.asarray(deinterleave_rows(
        np.asarray(jst.tables["categorical"].weights), 8, VOCAB))
    sm = ShardedModel.load("mock://cross/jax_sharded", devices=["cpu"] * 4)
    np.testing.assert_array_equal(sm.lookup("categorical", ids).numpy(),
                                  want[ids])

    batch = next(synthetic_criteo(16, id_space=VOCAB, steps=1, seed=2))
    cfg = {"scheme": "mock", "root": mockfs.root, "vocab": VOCAB,
           "batch": batch, "uri": "mock://cross/port_sharded"}
    out = run_local(ranks.save_sharded_to_uri, 2, args=(cfg,),
                    timeout_s=90, tmp_dir=str(tmp_path))
    rows = np.asarray(deinterleave_rows(np.concatenate(
        [out[r]["saved"]["tables"]["categorical"]["weights"]
         for r in range(2)]), 2, VOCAB))
    jsm = JaxSharded.load("mock://cross/port_sharded")
    np.testing.assert_array_equal(
        np.asarray(jsm.lookup("categorical", ids)), rows[ids])
