"""Line-rate ingest of the port (port of `openembedding_tpu/data/ingest.py`:
the same names, work lists, batches and `ingest.*` series): per-node
file-sharded streaming input, a bounded multi-worker parse pool with a
deterministic reorder stage, and a depth-D device feed ring, the feed path
the reference gets from tf.data interleave+prefetch and the `pulling()`
dataset (`test/benchmark/criteo_deepctr.py:168-240`).

- `sharded_files` / `sharded_reader`: each node reads only its slice of the
  FILE list (no global shuffle barrier, no coordinator). Epochs re-shard by
  ring rotation: epoch e assigns file i to node (i + e) % num_hosts, so
  every epoch covers every file exactly once. Batches never span files, so
  per-node sharded reading is bit-identical to the single global reader
  (`sharded_reader(num_hosts=1)`), file by file.
- Pluggable SOURCES: "tsv" (`criteo.read_criteo_tsv`: native C++ or Python,
  local files or URIs of a registered filesystem, `utils/fs`), "tfrecord"
  (`criteo.read_criteo_tfrecord`, the native engine), "synthetic" (a spec
  string for line-rate soaks), or any callable `(path, batch_size, **kw) ->
  iterator of batch dicts`.
- `ParsePool`: work items carry sequence numbers end to end and a reorder
  stage re-emits the results in dispatch order, whatever the workers'
  timing; a worker's exception surfaces at its sequence position.
- `FeedRing`: `prefetch_to_device` at depth D: host batches (or stacked
  K-step windows) are staged onto the device by a producer thread and
  parked in a bounded ring, so the copy of window t+1 overlaps the steps of
  window t. Bounded stop-aware puts (an abandoned consumer never strands the
  producer), exceptions propagate through the ring, and `close()` drains
  and joins every thread.
- Attribution: the ring publishes `ingest.*` gauges and counters (examples/s,
  bytes/s, queue depth per ring slot, parse and stage ms, producer stall
  time, dropped items); `MeshTrainer.train_stream` times how long the loop
  blocks on the next window into `trainer.input_wait_ms` and each window's
  wall time into `trainer.window_ms`; `input_wait_share()` folds the two
  into the number an SLO gates (< 5%: compute-bound).

A node is the JAX package's host. The port runs one process per rank, and
every rank of a node reads and parses the node's whole stream (the node's
files, `multihost.node_id()` / `num_nodes()`: torchrun's GROUP_RANK and
NNODES, or one node) and keeps its own block of each batch's rows
(`multihost.global_batch`, or of each window's axis 1,
`multihost.window_batch`). On one node of S ranks that is what the JAX
package does in one process over S devices: `feed(files, B, mesh=mesh,
window=K)` into `train_stream` trains the same windows.

Staging (`FeedRing`): `device=False` passes host arrays through untouched;
otherwise the ring stages onto the mesh's device (with a mesh: the rank's
rows) or onto `device` (True: the CUDA card, `device.resolve_device`, which
raises without one; no ring falls back to the CPU on its own). On a card
the producer copies through pinned buffers on a side stream
(`criteo._PinnedStager`, depth + 2 buffer sets, an event per item, no
device-wide synchronize) and the consumer's stream waits for each item's
copy before it reads it; on the CPU the leaves become tensors.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..utils import metrics

__all__ = ["FeedRing", "ParsePool", "SOURCES", "feed", "input_wait_share",
           "register_source", "ring_shard", "sharded_files", "sharded_reader"]

_END = object()          # producer -> consumer: clean end of stream
_TASK_END = object()     # dispatcher -> worker: no more tasks
_WORKER_EXIT = object()  # worker -> reorder stage: this worker is done


# ---------------------------------------------------------------------------
# per-node file sharding with ring-rotation epoch re-sharding
# ---------------------------------------------------------------------------


def ring_shard(num_files: int, host_id: int, num_hosts: int,
               epoch: int = 0) -> List[int]:
    """File indices host `host_id` owns in `epoch`: i with
    (i + epoch) % num_hosts == host_id, ascending. The union over hosts is
    every file exactly once; bumping the epoch rotates the assignment by one
    host, so across num_hosts epochs every host has read every file."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return [i for i in range(num_files)
            if (i + epoch) % num_hosts == host_id]


def sharded_files(files, *, host_id: Optional[int] = None,
                  num_hosts: Optional[int] = None,
                  epochs: Optional[int] = 1,
                  start_epoch: int = 0) -> Iterator[tuple]:
    """-> (epoch, file_index, path) for this host's slice, epoch-major then
    ascending file index: the deterministic work list `sharded_reader` (and
    its ParsePool) consumes. `epochs=None` streams forever. The host
    defaults to this process's node (`multihost.node_id()` of
    `multihost.num_nodes()`), not its rank: every rank of a node reads the
    node's files."""
    if isinstance(files, str):
        files = [files]
    files = list(files)
    if host_id is None or num_hosts is None:
        from ..parallel import multihost
        host_id = multihost.node_id() if host_id is None else host_id
        num_hosts = multihost.num_nodes() if num_hosts is None else num_hosts
    epoch = start_epoch
    while epochs is None or epoch < start_epoch + epochs:
        for i in ring_shard(len(files), host_id, num_hosts, epoch):
            yield (epoch, i, files[i])
        epoch += 1


# ---------------------------------------------------------------------------
# pluggable per-file sources
# ---------------------------------------------------------------------------


def _tsv_source(path: str, batch_size: int, **kw) -> Iterator[Dict]:
    """One Criteo TSV/.gz file (a local path or a URI) -> batches; `kw`
    passes through to `criteo.read_criteo_tsv`. Host sharding is not
    applied here: the file list is already sharded."""
    from .criteo import read_criteo_tsv
    return read_criteo_tsv([path], batch_size, host_id=0, num_hosts=1, **kw)


def _tfrecord_source(path: str, batch_size: int, **kw) -> Iterator[Dict]:
    """One TFRecord file -> batches (`criteo.read_criteo_tfrecord`, the
    native engine: the port has no TensorFlow)."""
    from .criteo import read_criteo_tfrecord
    return read_criteo_tfrecord([path], batch_size, host_id=0, num_hosts=1,
                                **kw)


def _synthetic_source(path: str, batch_size: int, **kw) -> Iterator[Dict]:
    """A `synthetic://k=v&k=v` spec string -> `criteo.synthetic_criteo`
    batches. Understood keys: steps, seed, id_space, fields, dense, alpha,
    e.g. `synthetic://steps=8&seed=3&id_space=4096`. A list of spec strings
    with distinct seeds is a no-IO "file set" that shards like real days."""
    from .criteo import synthetic_criteo
    spec = dict(kw)
    body = str(path).split("://", 1)[1] if "://" in str(path) else ""
    for part in body.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        spec[k] = v
    return synthetic_criteo(
        batch_size,
        id_space=int(spec.get("id_space", 1 << 25)),
        num_fields=int(spec.get("fields", 26)),
        dense_dim=int(spec.get("dense", 13)),
        seed=int(spec.get("seed", 0)),
        alpha=float(spec.get("alpha", 1.05)),
        steps=int(spec.get("steps", 1)))


SOURCES: Dict[str, Callable[..., Iterator[Dict]]] = {
    "tsv": _tsv_source,
    "tfrecord": _tfrecord_source,
    "synthetic": _synthetic_source,
}


def register_source(name: str, fn: Callable[..., Iterator[Dict]]) -> None:
    """Register a custom source: `fn(path, batch_size, **kw)` -> iterator of
    batch dicts for ONE file (batches must not span files: the sharding
    bit-identity invariant)."""
    SOURCES[name] = fn


def _batch_rows(batch: Dict) -> int:
    leaf = batch.get("label")
    if leaf is None:
        leaf = next(iter(batch["sparse"].values()))
    return int(np.asarray(leaf).shape[0])


def _batch_bytes(batch) -> int:
    total = 0
    for leaf in _np_leaves(batch):
        total += getattr(np.asarray(leaf), "nbytes", 0)
    return total


def _np_leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    elif tree is not None:
        yield tree


def _bounded_put(q: queue_mod.Queue, item, stop: threading.Event,
                 stall_ms: Optional[List[float]] = None) -> bool:
    """Stop-aware bounded put: a consumer that abandons the stream can never
    strand a producer blocked forever on a full queue. Returns False once
    `stop` is set. A put that could not land at once adds its whole blocked
    time to `stall_ms[0]` (the final, possibly successful, wait included)."""
    try:
        q.put_nowait(item)
        return True
    except queue_mod.Full:
        pass
    t0 = time.perf_counter() if stall_ms is not None else 0.0
    try:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False
    finally:
        if stall_ms is not None:
            stall_ms[0] += (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# the bounded multi-worker parse pool with a sequence-numbered reorder stage
# ---------------------------------------------------------------------------


class ParsePool:
    """Parse work items on `workers` threads; emit results in DISPATCH order.

    Every task is numbered when dispatched; workers tag their result (or the
    exception the parse raised) with that number, and the consuming iterator
    holds out-of-order results in a reorder buffer until the next sequence
    number arrives: output order is a function of the input order, not of
    worker scheduling. The buffer is bounded by the tasks in flight (task
    queue + workers + result queue).

    `parse_fn(task)` returns any payload (for file ingest: the file's whole
    batch list). A parse failure is delivered at its sequence position:
    everything parsed before the bad file still comes out, in order, then
    the exception raises.

    Lifecycle: `close()` (idempotent; also the iterator's exhaustion or
    abandon path and `__exit__`) stops dispatch, drains both queues, counts
    undelivered results into `ingest.dropped`, and joins every thread."""

    def __init__(self, tasks: Iterable, parse_fn: Callable, *,
                 workers: int = 2, depth: Optional[int] = None,
                 label: str = "pool"):
        if workers < 1:
            raise ValueError(f"ParsePool(workers={workers}): need >= 1")
        self._parse_fn = parse_fn
        self._tasks_it = iter(tasks)
        self._labels = {"pool": label}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._tasks_q: queue_mod.Queue = queue_mod.Queue(maxsize=workers)
        self._out_q: queue_mod.Queue = queue_mod.Queue(
            maxsize=depth if depth else 2 * workers)
        # guarded-by: self._lock (close() swaps them out before joining)
        self._workers = [
            threading.Thread(target=self._work, name=f"ingest-parse-{i}",
                             daemon=True)
            for i in range(workers)]
        self._num_workers = workers
        # guarded-by: self._lock
        self._dispatcher = threading.Thread(
            target=self._dispatch, name="ingest-dispatch", daemon=True)
        for t in self._workers:
            t.start()
        self._dispatcher.start()

    # -- producer side --------------------------------------------------------

    def _dispatch(self) -> None:
        seq = 0
        try:
            for task in self._tasks_it:
                if not _bounded_put(self._tasks_q, (seq, task), self._stop):
                    return
                seq += 1
        except BaseException as e:  # noqa: BLE001 — the task iterator
            # failed: deliver the fault at its sequence position, after
            # every dispatched task's result
            _bounded_put(self._out_q, (seq, e), self._stop)
        finally:
            for _ in range(self._num_workers):
                if not _bounded_put(self._tasks_q, _TASK_END, self._stop):
                    return

    def _work(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._tasks_q.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            if item is _TASK_END:
                _bounded_put(self._out_q, _WORKER_EXIT, self._stop)
                return
            seq, task = item
            t0 = time.perf_counter()
            try:
                payload = self._parse_fn(task)
            except BaseException as e:  # noqa: BLE001 — at its position
                payload = e
            metrics.observe("ingest.parse_ms",
                            (time.perf_counter() - t0) * 1e3, "hist",
                            labels=self._labels)
            if not _bounded_put(self._out_q, (seq, payload), self._stop):
                return

    # -- consumer side: the reorder stage -------------------------------------

    def __iter__(self) -> Iterator:
        buf: Dict[int, object] = {}
        next_seq = 0
        exited = 0
        try:
            while True:
                if next_seq in buf:
                    payload = buf.pop(next_seq)
                    metrics.observe("ingest.reorder_depth", float(len(buf)),
                                    "gauge", labels=self._labels)
                    next_seq += 1
                    if isinstance(payload, BaseException):
                        raise payload
                    yield payload
                    continue
                if exited == self._num_workers and not buf:
                    return  # every worker done, everything emitted in order
                try:
                    item = self._out_q.get(timeout=0.05)
                except queue_mod.Empty:
                    if self._stop.is_set():
                        return  # closed from another thread
                    continue
                if item is _WORKER_EXIT:
                    exited += 1
                    continue
                seq, payload = item
                buf[seq] = payload
        finally:
            self.close()

    def close(self) -> None:
        """Stop + drain + join (idempotent; safe to race)."""
        self._stop.set()
        dropped = 0
        for q in (self._tasks_q, self._out_q):
            while True:
                try:
                    item = q.get_nowait()
                except queue_mod.Empty:
                    break
                if q is self._out_q and isinstance(item, tuple):
                    dropped += 1
        if dropped:
            metrics.observe("ingest.dropped", float(dropped), "sum",
                            labels=self._labels)
        with self._lock:
            t, self._dispatcher = self._dispatcher, None
            ws, self._workers = self._workers, []
        if t is not None:
            t.join(timeout=5)
        for w in ws:
            w.join(timeout=5)

    def __enter__(self) -> "ParsePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the sharded streaming reader (files -> deterministic batch stream)
# ---------------------------------------------------------------------------


def sharded_reader(files, batch_size: int, *,
                   source="tsv",
                   host_id: Optional[int] = None,
                   num_hosts: Optional[int] = None,
                   epochs: Optional[int] = 1, start_epoch: int = 0,
                   workers: int = 0, pool_depth: Optional[int] = None,
                   label: str = "reader",
                   **source_kw) -> Iterator[Dict]:
    """Stream this node's file slice into batches, epoch by epoch.

    `source` names a `SOURCES` entry (or is the callable itself); extra
    keyword arguments pass through to it. `workers=0` parses inline (the
    depth-1 synchronous control); `workers>0` parses files on a `ParsePool`,
    whose reorder stage keeps the batch order bit-identical to the inline
    path. Batches never span files, so the union of every host's stream is
    bit-identical (file by file) to the `num_hosts=1` global reader."""
    if isinstance(source, str):
        if source not in SOURCES:
            raise ValueError(
                f"unknown source {source!r} (known: {sorted(SOURCES)}; "
                "register_source extends)")
        src = SOURCES[source]
    else:
        src = source
    return _sharded_reader(src, files, batch_size, host_id=host_id,
                           num_hosts=num_hosts, epochs=epochs,
                           start_epoch=start_epoch, workers=workers,
                           pool_depth=pool_depth, label=label, **source_kw)


def _sharded_reader(src, files, batch_size, *, host_id, num_hosts, epochs,
                    start_epoch, workers, pool_depth, label, **source_kw):
    tasks = sharded_files(files, host_id=host_id, num_hosts=num_hosts,
                          epochs=epochs, start_epoch=start_epoch)
    if workers <= 0:
        for _epoch, _idx, path in tasks:
            yield from src(path, batch_size, **source_kw)
        return

    def parse_file(task):
        _epoch, _idx, path = task
        return list(src(path, batch_size, **source_kw))

    pool = ParsePool(tasks, parse_file, workers=workers, depth=pool_depth,
                     label=label)
    with pool:
        for batches in pool:
            yield from batches


# ---------------------------------------------------------------------------
# the depth-D device feed ring
# ---------------------------------------------------------------------------


class FeedRing:
    """Depth-D device feed ring: host batches -> batches on the device.

    A producer thread pulls host batches from `it`, optionally groups them
    into stacked K-step `window`s (leading dim K: what
    `MeshTrainer.train_many` steps over; a trailing partial window is
    dropped and counted in `ingest.dropped`), stages them onto the device,
    and parks them in a bounded ring of `depth` slots; the consuming
    thread's `next()` returns batches already on the device, so the copy of
    batch or window t+1 overlaps the steps of window t. Staging (see the
    module docstring):

    - `mesh`: the rank's rows of each batch (`multihost.global_batch`) or
      of each window's axis 1 (`multihost.window_batch`, K whole on every
      rank) along `axis` (the mesh's data axis by default), on the mesh's
      device;
    - `device=False`: host arrays pass through untouched;
    - otherwise onto `device` (True: the CUDA card; raises without one).

    Telemetry (the attribution lane): `ingest.examples` / `ingest.bytes`
    counters, `ingest.examples_per_sec` / `ingest.bytes_per_sec` gauges,
    `ingest.stage_ms` hist (staging time), `ingest.queue_depth` + per-slot
    `ingest.slot_fill{slot=}` gauges, `ingest.producer_stall_ms` (time the
    producer blocked on a full ring: a stall with no consumer wait means
    compute-bound, the healthy state), `ingest.consumer_wait_ms` hist (time
    `next()` blocked: the ring-side twin of `trainer.input_wait_ms`), and
    `ingest.dropped` (staged items an early `close()` discarded). The ring's
    device bytes go into the memory ledger as the `feed_ring` component
    (`utils/memwatch`: depth x the first item's bytes).

    `throttle_s` sleeps the producer per host batch: the deliberately
    input-bound control the soak uses to show the attribution points the
    right way.

    Lifecycle: as `ParsePool.close`: stop, drain (counting drops), join;
    exceptions from the source propagate through the ring."""

    def __init__(self, it: Iterator, *, depth: int = 2,
                 mesh=None, axis: Optional[str] = None,
                 window: Optional[int] = None, device=True,
                 label: str = "ring", rate_every: int = 8,
                 throttle_s: float = 0.0):
        if depth < 1:
            raise ValueError(f"FeedRing(depth={depth}): need >= 1")
        if window is not None and window < 1:
            raise ValueError(f"FeedRing(window={window}): need >= 1")
        self.depth = int(depth)
        self._mesh = mesh
        self._axis = axis
        self._window = window
        self._target = self._resolve_target(device)
        self._stager = None
        if self._target is not None and self._target.type == "cuda":
            from .criteo import _PinnedStager
            # one buffer set being filled, `depth` in the ring, one held by
            # the consumer: a set is reused only after its copy has run
            self._stager = _PinnedStager(self._target, self.depth + 2)
        self._it = iter(it)
        self._labels = {"ring": label}
        self._rate_every = max(1, int(rate_every))
        self._throttle_s = float(throttle_s)
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stall_ms = [0.0]  # [total ms the producer blocked on the ring]
        self.examples = 0       # host rows staged (producer thread only)
        self.bytes = 0          # host bytes staged (producer thread only)
        # guarded-by: self._lock (close() tuple-swaps before joining)
        self._thread = threading.Thread(
            target=self._produce, name=f"ingest-{label}", daemon=True)
        self._thread.start()

    # -- staging --------------------------------------------------------------

    def _resolve_target(self, device) -> Optional[torch.device]:
        """None (host passthrough) or the device the ring stages onto."""
        from ..device import resolve_device
        if device is False:
            return None
        if self._mesh is not None:
            if device is not True and torch.device(device) != \
                    self._mesh.device:
                raise ValueError(f"FeedRing(device={device!r}) with a mesh "
                                 f"on {self._mesh.device}")
            return self._mesh.device
        return resolve_device(None if device is True else device)

    def _axis_name(self) -> str:
        if self._axis is not None:
            return self._axis
        return self._mesh.axis_names[0]

    def _stage(self, item):
        """-> what the ring holds: the item itself (host passthrough), its
        tensors on the CPU, or (tensors on the card, copy-done event)."""
        if self._target is None:
            return item
        if self._mesh is not None:
            from ..parallel import multihost
            item = multihost.node_rows(item, self._mesh, self._axis_name(),
                                       0 if self._window is None else 1)
        if self._stager is not None:
            return self._stager.stage(item)
        from .criteo import _map_leaves
        return _map_leaves(item, lambda _path, x: torch.as_tensor(x).to(
            self._target))

    def _produce(self) -> None:
        seq = 0
        t_start = time.perf_counter()
        pending: List[Dict] = []
        try:
            for host_item in self._it:
                if self._stop.is_set():
                    return
                if self._throttle_s > 0:
                    time.sleep(self._throttle_s)
                rows = _batch_rows(host_item)
                nbytes = _batch_bytes(host_item)
                if self._window is not None:
                    pending.append(host_item)
                    if len(pending) < self._window:
                        self.examples += rows
                        self.bytes += nbytes
                        continue
                    host_item = _stack_window(pending)
                    pending = []
                t0 = time.perf_counter()
                staged = self._stage(host_item)
                metrics.observe("ingest.stage_ms",
                                (time.perf_counter() - t0) * 1e3, "hist",
                                labels=self._labels)
                if seq == 0:
                    # a ring's worth of staged items is this ring's share
                    # of device memory; shapes are static per ring, so the
                    # first item prices all depth slots
                    from ..utils import memwatch
                    memwatch.WATCH.set_component(
                        "feed_ring", self.depth * memwatch.tree_device_bytes(
                            staged[0] if self._stager is not None
                            else staged),
                        labels=self._labels)
                if not _bounded_put(self._q, staged, self._stop,
                                    self._stall_ms):
                    return
                self.examples += rows
                self.bytes += nbytes
                seq += 1
                self._publish(seq, t_start)
            if pending:
                # a trailing partial window cannot be stepped; count it
                metrics.observe("ingest.dropped", float(len(pending)), "sum",
                                labels=self._labels)
            _bounded_put(self._q, _END, self._stop)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            _bounded_put(self._q, e, self._stop)

    def _publish(self, seq: int, t_start: float) -> None:
        depth_now = self._q.qsize()
        metrics.observe("ingest.queue_depth", float(depth_now), "gauge",
                        labels=self._labels)
        slot = dict(self._labels)
        slot["slot"] = str((seq - 1) % self.depth)
        metrics.observe("ingest.slot_fill", float(depth_now), "gauge",
                        labels=slot)
        metrics.observe("ingest.producer_stall_ms", 0.0, "sum",
                        labels=self._labels)  # register the series at 0
        if seq % self._rate_every == 0:
            elapsed = max(time.perf_counter() - t_start, 1e-9)
            metrics.observe("ingest.examples_per_sec",
                            self.examples / elapsed, "gauge",
                            labels=self._labels)
            metrics.observe("ingest.bytes_per_sec", self.bytes / elapsed,
                            "gauge", labels=self._labels)
            stall, self._stall_ms[0] = self._stall_ms[0], 0.0
            if stall:
                metrics.observe("ingest.producer_stall_ms", stall, "sum",
                                labels=self._labels)

    # -- consumer -------------------------------------------------------------

    def __iter__(self) -> "FeedRing":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue_mod.Empty:
                continue
        metrics.observe("ingest.consumer_wait_ms",
                        (time.perf_counter() - t0) * 1e3, "hist",
                        labels=self._labels)
        if item is _END:
            self.close()  # the producer has exited: reap it now
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        if self._stager is not None:
            # the consumer's stream waits for this item's copy; the tensors
            # are kept until that stream's work that reads them is done
            return self._stager.hand_over(item)
        return item

    def close(self) -> None:
        """Stop + drain (counting staged but undelivered items into
        `ingest.dropped`) + join the producer. Idempotent and race-safe: the
        early-exit path every consumer `break` must reach."""
        self._stop.set()
        dropped = 0
        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                break
            if item is not _END and not isinstance(item, BaseException):
                dropped += 1
        if dropped:
            metrics.observe("ingest.dropped", float(dropped), "sum",
                            labels=self._labels)
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "FeedRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _stack_window(batches: List[Dict]) -> Dict:
    """K host batches -> one stacked window (leading dim K on every leaf)."""
    def stack(*leaves):
        if leaves[0] is None:
            return None
        return np.stack([np.asarray(x) for x in leaves])
    out: Dict = {}
    for k in batches[0]:
        if k == "sparse":
            out[k] = {f: stack(*[b[k][f] for b in batches])
                      for f in batches[0][k]}
        else:
            out[k] = stack(*[b[k] for b in batches])
    return out


# ---------------------------------------------------------------------------
# the composed feed path + the attribution fold
# ---------------------------------------------------------------------------


def feed(files, batch_size: int, *, mesh=None, axis: Optional[str] = None,
         source="tsv", depth: int = 2,
         window: Optional[int] = None, workers: int = 0,
         epochs: Optional[int] = 1, start_epoch: int = 0,
         host_id: Optional[int] = None, num_hosts: Optional[int] = None,
         device=True, label: str = "feed",
         throttle_s: float = 0.0, **source_kw) -> FeedRing:
    """The whole ingest path in one call: per-node file-sharded streaming
    (`sharded_reader`, with a ParsePool when `workers > 0`) into a depth-D
    `FeedRing` staging onto the mesh's device (the rank's rows). Returns the
    ring; iterate it for batches on the device (or stacked `window`-step
    windows for `MeshTrainer.train_stream`), and `close()` it (or exhaust
    it) when done. `batch_size` is the node's batch: each rank keeps its
    block of it.

        ring = ingest.feed(days, 4096, mesh=mesh, workers=4, depth=3,
                           window=8, epochs=None)
        state, rep = trainer.train_stream(state, ring)
    """
    it = sharded_reader(files, batch_size, source=source, host_id=host_id,
                        num_hosts=num_hosts, epochs=epochs,
                        start_epoch=start_epoch, workers=workers,
                        label=label, **source_kw)
    return FeedRing(it, depth=depth, mesh=mesh, axis=axis, window=window,
                    device=device, label=label, throttle_s=throttle_s)


def _peek_hist(name: str) -> tuple:
    """(sum, count) over every label set of one metric: a peek (never
    creates the accumulator), summed so labeled lanes fold together."""
    with metrics._LOCK:
        accs = [a for a in metrics._REGISTRY.values() if a.name == name]
    total, count = 0.0, 0
    for a in accs:
        if a.kind == "hist":
            snap = a.hist_snapshot()
            total += snap[1]
            count += snap[2]
        else:
            total += a.value()
            count += a.count
    return total, count


def input_wait_share(*, wait_metric: str = "trainer.input_wait_ms",
                     step_metric: str = "auto",
                     publish: bool = True) -> Optional[float]:
    """The attribution number: mean input wait per window over mean input
    wait plus mean window wall time, from the metrics registry.
    `step_metric="auto"` prefers the window lane (`trainer.window_ms`,
    recorded by `MeshTrainer.train_stream`) and falls back to the sampled
    step lane (`trainer.step_ms`). Publishes `ingest.input_wait_share` (the
    gauge the ingest SLO gates: < 5% = compute-bound) and returns it;
    returns None (publishing nothing) until both lanes have samples."""
    wait_sum, wait_n = _peek_hist(wait_metric)
    if step_metric == "auto":
        step_sum, step_n = _peek_hist("trainer.window_ms")
        if step_n == 0:
            step_sum, step_n = _peek_hist("trainer.step_ms")
    else:
        step_sum, step_n = _peek_hist(step_metric)
    if wait_n == 0 or step_n == 0:
        return None
    wait_mean = wait_sum / wait_n
    step_mean = step_sum / step_n
    denom = wait_mean + step_mean
    if denom <= 0:
        return None
    share = wait_mean / denom
    if publish:
        metrics.observe("ingest.input_wait_share", share, "gauge")
    return share
