"""The port's `data/ingest.py` against the JAX package's, on the same
arguments: the work lists, the sharded readers, the parse pool's order and
faults, the feed ring at depths 1-3, window stacking and its dropped tail,
early exits, the `ingest.*` series and the input-wait fold.

Every comparison is bit-exact (tolerance 0): ingest moves and stacks host
arrays and parses the same bytes with the same parser, and the fold is the
same float arithmetic on the same samples.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from openembedding_tpu.data import criteo as jax_criteo
from openembedding_tpu.data import ingest as jax_ingest
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import multihost as jax_multihost
from openembedding_tpu.utils import metrics as jax_metrics
from openembedding_tpu_torch.data import criteo, ingest
from openembedding_tpu_torch.parallel import multihost
from openembedding_tpu_torch.parallel.mesh import Mesh
from openembedding_tpu_torch.utils import metrics, stepwatch

VOCAB = 1 << 10


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics._REGISTRY.clear()
    jax_metrics._REGISTRY.clear()
    yield
    metrics._REGISTRY.clear()
    jax_metrics._REGISTRY.clear()


def _tsv_files(tmp_path, rows=(10, 7, 12, 9, 11)):
    """A small day-file set, row counts varying so every file's partial
    tail is dropped on both paths (the JAX test's set)."""
    paths = []
    for fi, n in enumerate(rows):
        lines = []
        for r in range(n):
            label = str((fi + r) % 2)
            dense = [str(fi * 100 + r + d) for d in range(13)]
            cats = [format(fi * 10007 + r * 31 + c, "x") for c in range(26)]
            lines.append("\t".join([label] + dense + cats))
        p = tmp_path / f"day_{fi}.tsv"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _assert_batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in ("label", "dense"):
            np.testing.assert_array_equal(_np(x[key]), _np(y[key]))
        np.testing.assert_array_equal(_np(x["sparse"]["categorical"]),
                                      _np(y["sparse"]["categorical"]))


def _host_batches(steps=8, bs=16, seed=0):
    return list(criteo.synthetic_criteo(bs, id_space=VOCAB, steps=steps,
                                        seed=seed))


def _series(registry_module, prefix="ingest."):
    return {k for k in registry_module.report() if k.startswith(prefix)
            and not k.endswith((".p50", ".p95", ".p99"))}


# -- per-node file sharding -----------------------------------------------------


def test_ring_shard_matches_jax_and_covers_every_file():
    for n_files in (0, 1, 5, 11):
        for n_hosts in (1, 2, 3, 4):
            for epoch in range(n_hosts + 1):
                sets = [ingest.ring_shard(n_files, h, n_hosts, epoch)
                        for h in range(n_hosts)]
                assert sets == [jax_ingest.ring_shard(n_files, h, n_hosts,
                                                      epoch)
                                for h in range(n_hosts)]
                assert sorted(i for s in sets for i in s) == list(
                    range(n_files))
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="not in"):
            ingest.ring_shard(5, bad, 4)


def test_sharded_files_match_jax_and_default_to_the_node(monkeypatch):
    files = ["a", "b", "c", "d", "e"]
    for kw in (dict(host_id=0, num_hosts=2, epochs=2),
               dict(host_id=1, num_hosts=3, epochs=3, start_epoch=1),
               dict(host_id=0, num_hosts=1, epochs=1)):
        assert list(ingest.sharded_files(files, **kw)) == list(
            jax_ingest.sharded_files(files, **kw))
    assert list(ingest.sharded_files(["a", "b", "c"], host_id=0,
                                     num_hosts=2, epochs=2)) == [
        (0, 0, "a"), (0, 2, "c"), (1, 1, "b")]
    monkeypatch.delenv("GROUP_RANK", raising=False)
    monkeypatch.delenv("NNODES", raising=False)
    assert list(ingest.sharded_files(files)) == list(
        jax_ingest.sharded_files(files, host_id=0, num_hosts=1))
    # every rank of node 1 of 2 reads node 1's files, whatever its rank
    monkeypatch.setenv("GROUP_RANK", "1")
    monkeypatch.setenv("NNODES", "2")
    monkeypatch.setenv("RANK", "3")
    assert list(ingest.sharded_files(files, epochs=2)) == list(
        jax_ingest.sharded_files(files, host_id=1, num_hosts=2, epochs=2))


def test_sharded_reader_union_bit_identical_to_global(tmp_path):
    """Per host, the port's stream equals the JAX package's for the same
    arguments and the per-file control; the hosts' file sets partition the
    set, so the union is the global reader's stream."""
    paths = _tsv_files(tmp_path)
    n_hosts = 3
    kw = dict(source="tsv", epochs=1, native="off", id_space=VOCAB)
    control = {p: list(ingest.sharded_reader([p], 4, host_id=0, num_hosts=1,
                                             **kw)) for p in paths}
    covered = []
    for h in range(n_hosts):
        mine = ingest.ring_shard(len(paths), h, n_hosts)
        covered.extend(mine)
        got = list(ingest.sharded_reader(paths, 4, host_id=h,
                                         num_hosts=n_hosts, **kw))
        _assert_batches_equal(got, [b for i in mine
                                    for b in control[paths[i]]])
        _assert_batches_equal(got, jax_ingest.sharded_reader(
            paths, 4, host_id=h, num_hosts=n_hosts, **kw))
    assert sorted(covered) == list(range(len(paths)))
    whole = list(ingest.sharded_reader(paths, 4, host_id=0, num_hosts=1,
                                       **kw))
    _assert_batches_equal(whole, [b for p in paths for b in control[p]])


def test_sharded_reader_synthetic_specs_match_jax():
    files = [f"synthetic://steps={2 + s}&seed={s}&id_space={VOCAB}"
             for s in range(4)]
    for n_hosts in (1, 2, 3):
        for h in range(n_hosts):
            kw = dict(source="synthetic", host_id=h, num_hosts=n_hosts,
                      epochs=2)
            _assert_batches_equal(
                ingest.sharded_reader(files, 8, workers=2, **kw),
                jax_ingest.sharded_reader(files, 8, **kw))
    with pytest.raises(ValueError, match="unknown source"):
        ingest.sharded_reader(files, 8, source="nope")


def test_parse_pool_reader_bit_identical_to_inline(tmp_path):
    paths = _tsv_files(tmp_path)
    kw = dict(source="tsv", epochs=2, native="off", id_space=VOCAB)
    inline = list(ingest.sharded_reader(paths, 4, host_id=0, num_hosts=2,
                                        workers=0, **kw))
    pooled = list(ingest.sharded_reader(paths, 4, host_id=0, num_hosts=2,
                                        workers=3, **kw))
    _assert_batches_equal(pooled, inline)
    _assert_batches_equal(pooled, jax_ingest.sharded_reader(
        paths, 4, host_id=0, num_hosts=2, workers=3, **kw))


# -- ParsePool reorder stage ------------------------------------------------


def test_parse_pool_order_deterministic_under_adversarial_delays():
    delays = {0: 0.02, 1: 0.0, 2: 0.015, 3: 0.001, 4: 0.01, 5: 0.0}

    def parse(task):
        time.sleep(delays[task])  # workers finish far out of order
        return task * 10

    for workers in (1, 2, 4):
        with ingest.ParsePool(range(6), parse, workers=workers) as pool:
            got = list(pool)
        with jax_ingest.ParsePool(range(6), parse, workers=workers) as pool:
            want = list(pool)
        assert got == want == [0, 10, 20, 30, 40, 50], f"{workers=}"


@pytest.mark.parametrize("package", ["port", "jax"])
def test_parse_pool_fault_surfaces_at_sequence_position(package):
    mod = ingest if package == "port" else jax_ingest

    def parse(task):
        if task == 3:
            raise RuntimeError("bad file")
        time.sleep(0.002 if task % 2 else 0.0)
        return task

    pool = mod.ParsePool(range(6), parse, workers=3)
    got = []
    with pytest.raises(RuntimeError, match="bad file"):
        for p in pool:
            got.append(p)
    assert got == [0, 1, 2]
    with pool._lock:
        assert pool._dispatcher is None and not pool._workers


def test_parse_pool_task_iterator_fault_and_bad_workers():
    def tasks():
        yield from range(3)
        raise OSError("listing failed")

    got = []
    with pytest.raises(OSError, match="listing failed"):
        for p in ingest.ParsePool(tasks(), lambda t: t, workers=2):
            got.append(p)
    assert got == [0, 1, 2]
    with pytest.raises(ValueError, match="need >= 1"):
        ingest.ParsePool(range(3), lambda t: t, workers=0)


def test_parse_pool_early_exit_joins_every_worker():
    before = {t.ident for t in threading.enumerate()}
    pool = ingest.ParsePool(range(50), lambda t: t, workers=4)
    it = iter(pool)
    assert next(it) == 0
    pool.close()
    pool.close()  # idempotent
    with pool._lock:
        assert pool._dispatcher is None and not pool._workers
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name.startswith("ingest-")]
    assert not leaked, f"leaked threads: {leaked}"


# -- FeedRing -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_feed_ring_bit_identical_at_depths(depth):
    src = _host_batches()
    got = list(ingest.FeedRing(iter(src), depth=depth, device=False,
                               label=f"d{depth}"))
    want = list(jax_ingest.FeedRing(iter(src), depth=depth, device=False,
                                    label=f"d{depth}"))
    _assert_batches_equal(got, src)
    _assert_batches_equal(got, want)


def test_feed_ring_device_mode_bit_identical():
    """Staged onto the CPU (the tests' device; the card is the default)
    and onto a one-rank CPU mesh: tensors equal to the host batches, as the
    JAX ring's mesh mode gives arrays equal to them."""
    src = _host_batches(steps=4)
    with ingest.FeedRing(iter(src), depth=3, device="cpu",
                         label="dev") as ring:
        got = list(ring)
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    with ingest.FeedRing(iter(src), depth=3, mesh=mesh,
                         label="mesh") as ring:
        on_mesh = list(ring)
    with jax_ingest.FeedRing(iter(src), depth=3,
                             mesh=jax_make_mesh(jax.devices()[:1]),
                             label="dev") as ring:
        want = list(ring)
    for batches in (got, on_mesh):
        assert all(isinstance(b["dense"], torch.Tensor) for b in batches)
        _assert_batches_equal(batches, src)
        _assert_batches_equal(batches, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ingest.FeedRing(iter(src), depth=2)  # never falls back


def test_feed_ring_window_mode_stacks_and_drops_tail():
    src = _host_batches(steps=7)
    ws = list(ingest.FeedRing(iter(src), depth=2, device=False, window=3,
                              label="win"))
    want = list(jax_ingest.FeedRing(iter(src), depth=2, device=False,
                                    window=3, label="win"))
    assert len(ws) == len(want) == 2  # 7 batches: 2 windows, 1 dropped
    assert ws[0]["dense"].shape == (3,) + src[0]["dense"].shape
    np.testing.assert_array_equal(ws[1]["dense"][0], src[3]["dense"])
    _assert_batches_equal(ws, want)
    for mod in (metrics, jax_metrics):
        assert mod.Accumulator.get("ingest.dropped", "sum",
                                   labels={"ring": "win"}).value() == 1.0


def test_window_and_global_batch_give_each_rank_the_jax_shard():
    """Four ranks: each rank's `window_batch` / `global_batch` block is the
    JAX package's shard on device r (K whole, the batch dim split)."""
    jmesh = jax_make_mesh(jax.devices()[:4])
    src = _host_batches(steps=2, bs=8)
    window = {"sparse": {"categorical": np.stack(
        [b["sparse"]["categorical"] for b in src])},
        "dense": np.stack([b["dense"] for b in src]),
        "label": np.stack([b["label"] for b in src])}
    jw = jax_multihost.window_batch(window, jmesh)
    jg = jax_multihost.global_batch(src[0], jmesh)
    for r in range(4):
        mesh = Mesh(group=None, rank=r, size=4, device=torch.device("cpu"),
                    backend="gloo")
        w = multihost.window_batch(window, mesh)
        g = multihost.global_batch(src[0], mesh)
        assert w["dense"].shape == (2, 2, 13)
        for key in ("dense", "label"):
            np.testing.assert_array_equal(
                w[key].numpy(), np.asarray(jw[key].addressable_shards[r].data))
            np.testing.assert_array_equal(
                g[key].numpy(), np.asarray(jg[key].addressable_shards[r].data))
        np.testing.assert_array_equal(
            w["sparse"]["categorical"].numpy(), np.asarray(
                jw["sparse"]["categorical"].addressable_shards[r].data))
    mesh = Mesh(group=None, rank=0, size=4, device=torch.device("cpu"),
                backend="gloo")
    for mod, m in ((multihost, mesh), (jax_multihost, jmesh)):
        with pytest.raises(ValueError, match="need \\(K, batch, ...\\)"):
            mod.window_batch({"label": np.zeros(8, np.float32)}, m)


def test_feed_ring_early_exit_joins_producer_and_counts_drops():
    src = _host_batches(steps=12)
    ring = ingest.FeedRing(iter(src), depth=4, device=False, label="early")
    next(ring)
    time.sleep(0.05)  # let the producer fill the ring
    ring.close()
    ring.close()  # idempotent
    with ring._lock:
        assert ring._thread is None
    acc = metrics.Accumulator.get("ingest.dropped", "sum",
                                  labels={"ring": "early"})
    assert acc.value() >= 1.0


def test_feed_ring_propagates_source_exception():
    def bad():
        yield _host_batches(steps=1)[0]
        raise ValueError("source died")

    ring = ingest.FeedRing(bad(), depth=2, device=False, label="bad")
    next(ring)
    with pytest.raises(ValueError, match="source died"):
        next(ring)
    with ring._lock:
        assert ring._thread is None


def test_feed_ring_publishes_the_jax_series():
    src = _host_batches(steps=8, bs=16)
    list(ingest.FeedRing(iter(src), depth=2, device=False, label="tel",
                         rate_every=4))
    list(jax_ingest.FeedRing(iter(src), depth=2, device=False, label="tel",
                             rate_every=4))
    rep = metrics.report()
    assert rep['ingest.examples_per_sec{ring="tel"}'] > 0
    assert rep['ingest.bytes_per_sec{ring="tel"}'] > 0
    assert 'ingest.queue_depth{ring="tel"}' in rep
    assert 'ingest.slot_fill{ring="tel",slot="0"}' in rep
    assert _series(metrics) == _series(jax_metrics)
    # the pool's series too
    files = [f"synthetic://steps=2&seed={s}&id_space={VOCAB}"
             for s in range(3)]
    for mod in (ingest, jax_ingest):
        list(mod.sharded_reader(files, 8, source="synthetic", workers=2,
                                host_id=0, num_hosts=1, label="pool"))
    assert _series(metrics) == _series(jax_metrics)


def test_prefetch_telemetry_and_early_exit_drop_count():
    src = _host_batches(steps=6)
    it = criteo.prefetch_to_device(iter(src), size=3, device="cpu")
    next(it)
    time.sleep(0.05)  # the producer fills the queue, then stalls on it
    it.close()
    jt = jax_criteo.prefetch_to_device(iter(src), size=3)
    next(jt)
    time.sleep(0.05)
    jt.close()
    rep = metrics.report()
    assert 'ingest.queue_depth{ring="prefetch"}' in rep
    assert rep.get('ingest.producer_stall_ms{ring="prefetch"}', 0.0) > 0.0
    assert rep.get('ingest.dropped{ring="prefetch"}', 0.0) >= 1.0
    assert _series(metrics) == _series(jax_metrics)


# -- the measured input-wait attribution lane ---------------------------------


def test_timed_batches_records_input_wait():
    def slow():
        for b in _host_batches(steps=3):
            time.sleep(0.01)
            yield b

    got = list(stepwatch.timed_batches(slow()))
    assert len(got) == 3
    acc = metrics.Accumulator.get("trainer.input_wait_ms", "hist")
    assert acc.count == 3
    assert acc.value() >= 5.0  # the mean wait reflects the 10 ms stalls


def test_input_wait_share_folds_lanes_as_jax_does():
    for mod, reg in ((ingest, metrics), (jax_ingest, jax_metrics)):
        assert mod.input_wait_share() is None  # no lanes yet
        for _ in range(4):
            reg.observe("trainer.input_wait_ms", 1.0, "hist")
            reg.observe("trainer.window_ms", 19.0, "hist")
    share = ingest.input_wait_share()
    assert share == pytest.approx(0.05)
    assert share == jax_ingest.input_wait_share()
    assert metrics.report()["ingest.input_wait_share"] == share
    # uneven samples, labeled lanes, and the step_ms fallback
    rng = np.random.default_rng(3)
    for reg in (metrics, jax_metrics):
        reg._REGISTRY.clear()
    waits, steps = rng.random(7) * 5, rng.random(5) * 40
    for reg in (metrics, jax_metrics):
        for i, w in enumerate(waits):
            reg.observe("trainer.input_wait_ms", float(w), "hist",
                        labels={"lane": str(i % 2)})
        for s in steps:
            reg.observe("trainer.step_ms", float(s), "hist")
    assert ingest.input_wait_share() == jax_ingest.input_wait_share()
    assert ingest.input_wait_share(publish=False) is not None


def test_feed_end_to_end_synthetic():
    """feed() composes reader -> pool -> ring; synthetic spec files shard
    like real days and the stream is bit-identical across worker counts
    and to the JAX package's."""
    files = [f"synthetic://steps=4&seed={s}&id_space={VOCAB}"
             for s in range(3)]
    a = list(ingest.feed(files, 8, source="synthetic", depth=2, workers=0,
                         device=False, label="fa"))
    b = list(ingest.feed(files, 8, source="synthetic", depth=3, workers=2,
                         device=False, label="fb"))
    c = list(jax_ingest.feed(files, 8, source="synthetic", depth=3,
                             workers=2, device=False, label="fb"))
    assert len(a) == 12
    _assert_batches_equal(b, a)
    _assert_batches_equal(b, c)
