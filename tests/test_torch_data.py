"""The port's data path against the JAX package's on the same files.

The readers, the rebatcher and the generators are numpy on both sides, so
every batch must be byte-identical: `read_criteo_tsv` with the port's native
engine and with its Python engine against the JAX Python engine (the
checked oracle) on `examples/train100.tsv` and on a seeded TSV with empty
fields and short rows, `.gz` input, the host interleave,
`drop_remainder`/`repeat`, `read_criteo_csv`, the native TFRecord reader and
`preprocess`, `CriteoBatcher`, `planted_criteo`. `prefetch_to_device` is
checked on the CPU (the card's pinned copy runs in `chip_smoke.py`), and
`auc` against the JAX function.
"""

import gzip
import itertools
import os
import shutil
import struct
import threading
import time

import numpy as np
import pytest

from openembedding_tpu import native as jax_native
from openembedding_tpu.data import criteo as jax_criteo
from openembedding_tpu.utils.metrics import auc as jax_auc
from openembedding_tpu_torch import data, native
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.utils.metrics import auc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN100 = os.path.join(REPO, "examples", "train100.tsv")
N_COLS = 1 + criteo.NUM_DENSE + criteo.NUM_SPARSE

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler")


def _write_tsv(path, rows, seed=0):
    """Criteo-format rows from a seed: about 10% empty fields, and rows cut
    short (missing trailing categorical fields)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            cols = [str(rng.integers(0, 2))]
            cols += ["" if rng.random() < 0.1 else
                     str(int(rng.integers(-5, 1000)))
                     for _ in range(criteo.NUM_DENSE)]
            n_cat = (criteo.NUM_SPARSE if rng.random() < 0.7
                     else int(rng.integers(0, criteo.NUM_SPARSE)))
            cols += ["" if rng.random() < 0.1 else
                     f"{int(rng.integers(0, 1 << 32)):08x}"
                     for _ in range(n_cat)]
            f.write("\t".join(cols) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def seeded_tsv(tmp_path_factory):
    return _write_tsv(tmp_path_factory.mktemp("tsv") / "seeded.tsv", 300)


def _assert_batches_identical(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            x, y = ((a[key]["categorical"], b[key]["categorical"])
                    if key == "sparse" else (a[key], b[key]))
            if x is None:
                assert y is None
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key


@pytest.mark.parametrize("engine", ["on", "off"])
@pytest.mark.parametrize("source", ["train100", "seeded"])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_read_criteo_tsv_byte_identical_to_jax(engine, source, drop_remainder,
                                               seeded_tsv):
    path = TRAIN100 if source == "train100" else seeded_tsv
    kw = dict(id_space=1000, drop_remainder=drop_remainder)
    _assert_batches_identical(
        criteo.read_criteo_tsv(path, 32, native=engine, **kw),
        jax_criteo.read_criteo_tsv(path, 32, native="off", **kw))


@pytest.mark.parametrize("engine", ["on", "off"])
def test_gzip_input_reads_like_the_plain_file(engine, seeded_tsv, tmp_path):
    gz = str(tmp_path / "seeded.tsv.gz")
    with open(seeded_tsv, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    _assert_batches_identical(
        criteo.read_criteo_tsv(gz, 64, native=engine),
        jax_criteo.read_criteo_tsv(seeded_tsv, 64, native="off"))


@pytest.mark.parametrize("engine", ["on", "off"])
def test_hosts_interleave_rows(engine, seeded_tsv):
    seen = 0
    for host in range(3):
        kw = dict(host_id=host, num_hosts=3, drop_remainder=False)
        got = list(criteo.read_criteo_tsv([seeded_tsv, TRAIN100], 16,
                                          native=engine, **kw))
        _assert_batches_identical(got, jax_criteo.read_criteo_tsv(
            [seeded_tsv, TRAIN100], 16, native="off", **kw))
        seen += sum(len(b["label"]) for b in got)
    assert seen == 300 + 120


@pytest.mark.parametrize("engine", ["on", "off"])
def test_repeat_restarts_every_pass(engine):
    """120 rows in batches of 32 with drop_remainder: three batches a pass,
    the next pass starting again at row 0."""
    got = list(itertools.islice(criteo.read_criteo_tsv(
        TRAIN100, 32, native=engine, repeat=True), 7))
    _assert_batches_identical(got, itertools.islice(jax_criteo.read_criteo_tsv(
        TRAIN100, 32, native="off", repeat=True), 7))
    _assert_batches_identical(got[3:6], got[:3])


def test_remote_uris_and_bad_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(criteo.read_criteo_tsv("gs://bucket/day_0.tsv", 8))
    with pytest.raises(ValueError, match="native mode"):
        next(criteo.read_criteo_tsv(TRAIN100, 8, native="maybe"))
    with pytest.raises(NotImplementedError, match="native engine"):
        next(criteo.read_criteo_tfrecord(TRAIN100, 8, engine="tf"))
    assert len(next(criteo.read_criteo_tsv("file://" + TRAIN100, 8,
                                           native="off"))["label"]) == 8


def test_native_library_builds_into_the_port_build_dir():
    native.load()
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "_build")
    assert os.path.basename(path) in (
        os.path.basename(native.library_path(native.ZLIB_FLAGS)),
        os.path.basename(native.library_path(native.NO_ZLIB_FLAGS)))
    assert native.library_path(("-O2",)) != native.library_path(("-O3",))
    assert native.available()


def _write_csv(path, rows, seed=0):
    rng = np.random.default_rng(seed)
    header = ([""] + ["label"] + [f"I{i}" for i in range(1, 14)]
              + [f"C{i}" for i in range(1, 27)])
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in range(rows):
            cols = [str(r), str(rng.integers(0, 2))]
            cols += [f"{rng.random():.6f}" for _ in range(13)]
            cols += ["" if rng.random() < 0.05 else str(rng.integers(0, 50))
                     for _ in range(26)]
            f.write(",".join(cols) + "\n")
    return str(path)


@pytest.mark.parametrize("fold", ["hash", "offsets"])
def test_read_criteo_csv_matches_jax(fold, tmp_path):
    path = _write_csv(tmp_path / "train.csv", 70)
    kw = ({"id_space": 997} if fold == "hash"
          else {"vocab_sizes": [50] * 26})
    for extra in ({}, {"drop_remainder": False},
                  {"host_id": 1, "num_hosts": 2, "drop_remainder": False}):
        _assert_batches_identical(
            criteo.read_criteo_csv(path, 16, **kw, **extra),
            jax_criteo.read_criteo_csv(path, 16, **kw, **extra))


def _masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _example(label: int, dense, cats) -> bytes:
    """A tf.train.Example of the reference's schema, encoded by hand:
    label int64[1], I1..13 float[1], C1..26 int64[1]."""
    def entry(key, feature):
        return _field(1, _field(1, key.encode()) + _field(2, feature))
    ints = lambda v: _field(3, _field(1, _varint(int(v))))  # noqa: E731
    floats = lambda v: _field(2, _field(1, struct.pack("<f", v)))  # noqa: E731
    body = entry("label", ints(label))
    body += b"".join(entry(f"I{i + 1}", floats(v)) for i, v in enumerate(dense))
    body += b"".join(entry(f"C{i + 1}", ints(v)) for i, v in enumerate(cats))
    return _field(1, body)


def _write_tfrecord(path, rows, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, rows)
    dense = rng.standard_normal((rows, 13)).astype(np.float32)
    cats = rng.integers(0, 1 << 20, (rows, 26))
    with open(path, "wb") as f:
        for r in range(rows):
            rec = _example(labels[r], dense[r], cats[r])
            head = struct.pack("<Q", len(rec))
            f.write(head + struct.pack("<I", _masked_crc32c(head)) + rec
                    + struct.pack("<I", _masked_crc32c(rec)))
    return labels.astype(np.float32), dense, cats


def test_native_tfrecord_reader_folds_like_jax(tmp_path):
    paths = [str(tmp_path / f"{k}.tfrecord") for k in range(2)]
    written = [_write_tfrecord(p, 30, seed=k) for k, p in enumerate(paths)]
    labels = np.concatenate([w[0] for w in written])
    dense = np.concatenate([w[1] for w in written])
    cats = np.concatenate([w[2] for w in written])
    for kw in ({"id_space": 1 << 16}, {"vocab_sizes": [1 << 20] * 26}):
        got = list(criteo.read_criteo_tfrecord(paths, 20, **kw))
        assert len(got) == 3
        np.testing.assert_array_equal(
            np.concatenate([b["label"] for b in got]), labels)
        assert np.concatenate([b["dense"] for b in got]).tobytes() == \
            dense.tobytes()
        want = jax_criteo._fold_int_ids(cats, kw.get("id_space"),
                                        kw.get("vocab_sizes"))
        assert np.concatenate([b["sparse"]["categorical"] for b in got]
                              ).tobytes() == want.tobytes()
    halves = [list(criteo.read_criteo_tfrecord(
        paths, 60, host_id=h, num_hosts=2, drop_remainder=False))
        for h in range(2)]
    assert sorted(np.concatenate([b[0]["dense"][:, 0] for b in halves])
                  .tolist()) == sorted(dense[:, 0].tolist())


def test_native_preprocess_matches_jax(seeded_tsv, tmp_path):
    ours = str(tmp_path / "ours.tsv")
    theirs = str(tmp_path / "theirs.tsv")
    vocab = native.preprocess(seeded_tsv, ours, min_count=2)
    want = jax_native.preprocess(seeded_tsv, theirs, min_count=2)
    np.testing.assert_array_equal(vocab, want)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert (vocab >= 1).all()


def _uneven_batches(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 17, 3, 40, 1, 9):
        b = {"sparse": {"categorical": rng.integers(0, 100, (n, 26))},
             "dense": rng.standard_normal((n, 13)).astype(np.float32),
             "label": rng.integers(0, 2, n).astype(np.float32)}
        if n == 3:
            b["weight"] = rng.random(n).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("batch", [8, 16, 75])
def test_criteo_batcher_splits_carries_and_pads_like_jax(batch):
    got = list(data.CriteoBatcher(iter(_uneven_batches()), batch))
    _assert_batches_identical(
        got, jax_criteo.CriteoBatcher(iter(_uneven_batches()), batch))
    assert all(len(b["label"]) == batch for b in got)
    tail = got[-1]
    pad = batch * len(got) - 75
    if pad:
        assert (tail["sparse"]["categorical"][-pad:] == -1).all()
        assert (tail["weight"][-pad:] == 0).all()


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_planted_criteo_byte_identical_to_jax(ids_dtype):
    kw = dict(id_space=1 << 12, seed=5, steps=3, ids_dtype=ids_dtype)
    _assert_batches_identical(data.planted_criteo(64, **kw),
                              jax_criteo.planted_criteo(64, **kw))
    ids = np.arange(-4, 60, dtype=np.int64).reshape(8, 8)
    assert criteo.planted_logit(ids, seed=2).tobytes() == \
        jax_criteo.planted_logit(ids, seed=2).tobytes()
    with pytest.raises(ValueError, match="int32 or int64"):
        next(data.planted_criteo(4, ids_dtype="pair"))


def test_prefetch_on_the_cpu_keeps_order_and_the_batches():
    batches = list(data.synthetic_criteo(16, id_space=100, steps=7))
    got = list(data.prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == 7
    for a, b in zip(got, batches):
        assert a is b  # a plain thread: no copy on the CPU


def test_prefetch_raises_the_producers_error_in_the_consumer():
    def broken():
        yield {"label": np.zeros(2)}
        raise OSError("disk went away")

    it = data.prefetch_to_device(broken(), device="cpu")
    assert next(it)["label"].shape == (2,)
    with pytest.raises(OSError, match="disk went away"):
        next(it)


def test_prefetch_early_exit_reaps_the_producer():
    """A consumer that leaves after one batch of an endless stream stops
    the producer, though it sits on a full queue."""
    before = {t.ident for t in threading.enumerate()}

    def endless():
        for k in itertools.count():
            yield {"label": np.full(1, k)}

    it = data.prefetch_to_device(endless(), size=2, device="cpu")
    assert int(next(it)["label"][0]) == 0
    time.sleep(0.2)  # the producer fills the queue and blocks on it
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        extra = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra


def test_prefetch_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(data.prefetch_to_device(iter([{"label": np.zeros(1)}])))


def test_auc_matches_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 500).astype(np.float32)
    scores = rng.standard_normal(500) + labels
    scores[:50] = 0.25  # ties
    assert auc(labels, scores) == jax_auc(labels, scores)
    assert np.isnan(auc(np.ones(4), np.arange(4.0)))
