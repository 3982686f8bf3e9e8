"""Criteo input pipeline of the port: readers, hashing, folding, synthetic
and planted-signal generators, the rebatcher and the device prefetcher.

Port of `openembedding_tpu/data/criteo.py`. Everything but
`prefetch_to_device` is numpy (torch only to stage batches for the card)
and yields the same batches as the JAX
package, byte for byte (`tests/test_torch_data.py`). Ids are int64 (or
int32 where asked): the split-pair id layout has no place in the port.

- All categorical fields fold into ONE id space (`criteo_fold_offsets` /
  `hash_category` with per-field salts), so a step pulls (B, 26) ids from one
  table.
- `read_criteo_tsv` parses with the native C++ pipeline (`native/`) when it
  builds, and with the Python row parser otherwise; both give the same
  batches.
- `prefetch_to_device` stages batches through pinned host memory and copies
  them to the card on a side stream while the current step runs.
- Multi-host: pass (host_id, num_hosts) and each host reads its interleaved
  slice of rows.

Criteo row format (label \\t I1..I13 \\t C1..C26): integer features
log-transformed (log(x+4)^2, the reference's preprocessor), categorical hex
tokens hashed.
"""

from __future__ import annotations

import ctypes
import gzip
import itertools
import queue as queue_mod
import threading
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

NUM_DENSE = 13
NUM_SPARSE = 26

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def hash_category(token_hash: np.ndarray, field: np.ndarray,
                  id_space: int) -> np.ndarray:
    """Map (token hash, field index) -> folded id in [0, id_space); the
    field salt keeps distinct fields' tokens apart in the shared table."""
    h = (token_hash.astype(np.uint64) ^ _FNV_OFFSET) * _FNV_PRIME
    h ^= (field.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    h *= _FNV_PRIME
    h &= np.uint64(0x7FFFFFFFFFFFFFFF)
    return (h % np.uint64(id_space)).astype(np.int64)


def criteo_fold_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Per-field offsets for folding per-field id spaces into one table:
    field f's id i -> offsets[f] + i."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int64)


def _parse_rows(rows, id_space: int):
    """rows: list of tab-split string fields."""
    n = len(rows)
    labels = np.zeros((n,), np.float32)
    dense = np.zeros((n, NUM_DENSE), np.float32)
    sparse = np.zeros((n, NUM_SPARSE), np.int64)
    fields = np.arange(NUM_SPARSE, dtype=np.uint64)
    for r, cols in enumerate(rows):
        labels[r] = float(cols[0]) if cols[0] else 0.0
        for i in range(NUM_DENSE):
            v = cols[1 + i]
            x = float(v) if v else 0.0
            dense[r, i] = np.square(np.log(max(x, 0.0) + 4.0))
        # tokens wider than 64 bits saturate (strtoull semantics, so the
        # native parser agrees on malformed or overlong tokens)
        toks = np.array(
            [min(int(cols[1 + NUM_DENSE + i], 16), 0xFFFFFFFFFFFFFFFF)
             if cols[1 + NUM_DENSE + i] else i
             for i in range(NUM_SPARSE)], dtype=np.uint64)
        sparse[r] = hash_category(toks, fields, id_space)
    return labels, dense, sparse


def _local_paths(paths) -> list:
    """The paths as a list of local paths (see `utils.fs.local_path`)."""
    from ..utils.fs import local_path
    if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    return [local_path(p) for p in paths]


def read_criteo_tsv(paths, batch_size: int, *, id_space: int = 1 << 25,
                    host_id: int = 0, num_hosts: int = 1,
                    drop_remainder: bool = True,
                    repeat: bool = False,
                    native: str = "auto",
                    native_threads: int = 4) -> Iterator[Dict]:
    """Stream Criteo TSV (optionally .gz) files into fixed-shape batches.

    Rows are interleaved across hosts (row i goes to host i % num_hosts).

    `native`: "auto" uses the C++ parse pipeline (`native/oetpu_data.cpp`)
    when it builds, plain TSV and .gz alike, and falls back to the Python
    parser when it does not; "on" requires it; "off" forces Python. Only
    building the reader falls back: a failure while reading raises.

    With `repeat=True` the Python engine starts every pass with no pending
    rows, so a file with fewer rows than one batch (and `drop_remainder`)
    never yields: it loops forever, as the JAX package's reader does."""
    paths = _local_paths(paths)
    if native not in ("auto", "on", "off"):
        raise ValueError(f"bad native mode {native!r}")
    if native != "off":
        reader = None
        try:
            from .. import native as native_mod
            reader = native_mod.NativeCriteoReader(
                paths, batch_size, id_space=id_space, host_id=host_id,
                num_hosts=num_hosts, num_threads=native_threads,
                drop_remainder=drop_remainder, repeat=repeat)
        except (RuntimeError, OSError):
            if native == "on":
                raise
        if reader is not None:
            yield from reader
            return
    while True:
        pending = []
        for path in paths:
            opener = gzip.open if str(path).endswith(".gz") else open
            with opener(path, "rt") as f:
                for i, line in enumerate(f):
                    if i % num_hosts != host_id:
                        continue
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 1 + NUM_DENSE + NUM_SPARSE:
                        cols = cols + [""] * (1 + NUM_DENSE + NUM_SPARSE
                                              - len(cols))
                    pending.append(cols)
                    if len(pending) == batch_size:
                        labels, dense, sparse = _parse_rows(pending, id_space)
                        yield {"sparse": {"categorical": sparse},
                               "dense": dense, "label": labels}
                        pending = []
        if pending and not drop_remainder:
            labels, dense, sparse = _parse_rows(pending, id_space)
            yield {"sparse": {"categorical": sparse}, "dense": dense,
                   "label": labels}
        if not repeat:
            return


def _fold_int_ids(sparse_cols: np.ndarray, id_space: Optional[int],
                  vocab_sizes: Optional[Sequence[int]]) -> np.ndarray:
    """Fold per-field integer ids (preprocessed, relabeled data) into the
    shared table: contiguous offsets when per-field vocab sizes are known,
    else field-salted hashing."""
    n, f = sparse_cols.shape
    if vocab_sizes is not None:
        offs = criteo_fold_offsets(vocab_sizes)
        return sparse_cols.astype(np.int64) + offs[None, :]
    fields = np.broadcast_to(np.arange(f, dtype=np.uint64), (n, f))
    return hash_category(sparse_cols.astype(np.uint64), fields,
                         id_space or (1 << 25))


def read_criteo_tfrecord(paths, batch_size: int, *,
                         id_space: Optional[int] = None,
                         vocab_sizes: Optional[Sequence[int]] = None,
                         host_id: int = 0, num_hosts: int = 1,
                         drop_remainder: bool = True,
                         repeat: bool = False,
                         engine: str = "native") -> Iterator[Dict]:
    """Stream the reference's TFRecord format (label int64[1], I1..I13
    float32[1], C1..C26 int64[1], categorical already relabeled to ints)
    through the C++ reader (`native.NativeCriteoTFRecordReader`), with the
    categorical ids folded as the JAX package folds them. The JAX package's
    `engine="tf"` (tf.data) is not ported: the port does not depend on
    TensorFlow."""
    if engine != "native":
        raise NotImplementedError(
            f"engine={engine!r}: the port reads TFRecords with the native "
            "engine only (no TensorFlow dependency)")
    from ..native import NativeCriteoTFRecordReader
    for batch in NativeCriteoTFRecordReader(
            _local_paths(paths), batch_size, host_id=host_id,
            num_hosts=num_hosts, drop_remainder=drop_remainder,
            repeat=repeat):
        yield {"sparse": {"categorical": _fold_int_ids(
                   batch["sparse"]["categorical"], id_space, vocab_sizes)},
               "dense": batch["dense"],
               "label": batch["label"]}


def read_criteo_csv(path, batch_size: int, *, id_space: Optional[int] = None,
                    vocab_sizes: Optional[Sequence[int]] = None,
                    host_id: int = 0, num_hosts: int = 1,
                    drop_remainder: bool = True,
                    repeat: bool = False) -> Iterator[Dict]:
    """Stream the reference's preprocessed CSV (header `,label,I1..I13,
    C1..C26`, dense already normalized floats, categorical already
    relabeled ints)."""
    import csv

    path = _local_paths(path)[0]
    while True:
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            col = {name: j for j, name in enumerate(header)}
            ncol_i = [col[f"I{i}"] for i in range(1, NUM_DENSE + 1)]
            ncol_c = [col[f"C{i}"] for i in range(1, NUM_SPARSE + 1)]
            lcol = col["label"]
            rows = []
            for i, line in enumerate(reader):
                if i % num_hosts != host_id:
                    continue
                rows.append(line)
                if len(rows) == batch_size:
                    yield _csv_batch(rows, lcol, ncol_i, ncol_c, id_space,
                                     vocab_sizes)
                    rows = []
            if rows and not drop_remainder:
                yield _csv_batch(rows, lcol, ncol_i, ncol_c, id_space,
                                 vocab_sizes)
        if not repeat:
            return


def _csv_batch(rows, lcol, ncol_i, ncol_c, id_space, vocab_sizes) -> Dict:
    labels = np.asarray([float(r[lcol] or 0) for r in rows], np.float32)
    dense = np.asarray([[float(r[j] or 0) for j in ncol_i] for r in rows],
                       np.float32)
    cats = np.asarray([[int(r[j] or 0) for j in ncol_c] for r in rows],
                      np.int64)
    return {"sparse": {"categorical": _fold_int_ids(cats, id_space,
                                                    vocab_sizes)},
            "dense": dense, "label": labels}


def synthetic_criteo(batch_size: int, *, id_space: int = 1 << 25,
                     num_fields: int = NUM_SPARSE, dense_dim: int = NUM_DENSE,
                     seed: int = 0, alpha: float = 1.05,
                     steps: Optional[int] = None,
                     ids_dtype=np.int64) -> Iterator[Dict]:
    """Synthetic Criteo-like stream with Zipfian ids (the hot-key skew of real
    CTR logs, which the dedup sees). Labels come from a fixed random linear
    model so the loss decreases. `ids_dtype` casts the ids (np.int32 for an
    id space below 2^31)."""
    rng = np.random.default_rng(seed)
    w_dense = rng.normal(size=(dense_dim,)).astype(np.float32) * 0.3
    it = itertools.count() if steps is None else range(steps)
    for _ in it:
        # Zipf via inverse-CDF on uniform: id = floor(u^(-1/(alpha-1)))
        u = rng.random((batch_size, num_fields))
        raw = np.floor(np.clip(u ** (-1.0 / (alpha - 1.0)), 1.0, 2.0 ** 62)
                       ).astype(np.int64)
        fields = np.broadcast_to(np.arange(num_fields, dtype=np.uint64),
                                 (batch_size, num_fields))
        ids64 = hash_category(raw.astype(np.uint64), fields, id_space)
        dense = rng.normal(size=(batch_size, dense_dim)).astype(np.float32)
        logit = (dense @ w_dense
                 + 0.01 * (ids64 % 97 - 48).sum(axis=1) / num_fields)
        labels = (rng.random(batch_size) < 1.0 / (1.0 + np.exp(-logit))
                  ).astype(np.float32)
        yield {"sparse": {"categorical": ids64.astype(ids_dtype)},
               "dense": dense,
               "label": labels}


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (SplitMix64), the per-id weight hash of the
    planted-signal generator."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
         ).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
         ).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def planted_logit(ids64: np.ndarray, *, seed: int = 0,
                  scale: float = 8.0) -> np.ndarray:
    """The true logit of a planted-signal batch: each id contributes a fixed
    hash-derived weight in (-1, 1); the logit is `scale * mean_over_fields`.
    Its held-out AUC is the best a trained model can reach."""
    h = _splitmix64(ids64.astype(np.uint64) ^ np.uint64(0xA5A5_0000 + seed))
    w = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53) * 2.0 - 1.0
    return (scale * w.mean(axis=-1)).astype(np.float32)


def planted_criteo(batch_size: int, *, id_space: int = 1 << 15,
                   num_fields: int = 8, seed: int = 0, alpha: float = 1.05,
                   steps: Optional[int] = None, scale: float = 8.0,
                   label_seed: int = 1, ids_dtype=np.int32) -> Iterator[Dict]:
    """Criteo-like stream with a planted id-conditional signal: Zipfian ids
    like `synthetic_criteo`, labels Bernoulli(sigmoid(planted_logit(ids))).
    `ids_dtype` is np.int32 or np.int64."""
    if ids_dtype not in (np.int32, np.int64, "int32", "int64"):
        raise ValueError(f"ids_dtype {ids_dtype!r}: the port takes int32 or "
                         "int64 ids")
    rng = np.random.default_rng(seed)
    it = itertools.count() if steps is None else range(steps)
    for _ in it:
        u = rng.random((batch_size, num_fields))
        raw = np.floor(np.clip(u ** (-1.0 / (alpha - 1.0)), 1.0, 2.0 ** 62)
                       ).astype(np.int64)
        fields = np.broadcast_to(np.arange(num_fields, dtype=np.uint64),
                                 (batch_size, num_fields))
        ids64 = hash_category(raw.astype(np.uint64), fields, id_space)
        logit = planted_logit(ids64, seed=label_seed, scale=scale)
        labels = (rng.random(batch_size) < 1.0 / (1.0 + np.exp(-logit))
                  ).astype(np.float32)
        yield {"sparse": {"categorical": ids64.astype(ids_dtype)},
               "dense": None, "label": labels}


def _rows_concat(a: Dict, b: Dict) -> Dict:
    out = {"sparse": {k: np.concatenate([a["sparse"][k], b["sparse"][k]])
                      for k in a["sparse"]},
           "label": np.concatenate([a["label"], b["label"]])}
    if a.get("dense") is not None:
        out["dense"] = np.concatenate([a["dense"], b["dense"]])
    if "weight" in a or "weight" in b:
        wa = a.get("weight", np.ones_like(a["label"]))
        wb = b.get("weight", np.ones_like(b["label"]))
        out["weight"] = np.concatenate([wa, wb])
    return out


def _rows_slice(batch: Dict, lo: int, hi: int) -> Dict:
    return {k: ({k2: v2[lo:hi] for k2, v2 in v.items()} if k == "sparse"
                else v[lo:hi])
            for k, v in batch.items() if v is not None}


class CriteoBatcher:
    """Rebatches any row iterator to a fixed batch size: splits oversized
    incoming batches, carries remainders across batches, and pads the final
    partial batch. Padded rows get id -1 (pulls zeros, grads dropped) and a
    `weight` of 0, which the trainer's loss reads, so pad rows contribute
    nothing."""

    def __init__(self, it: Iterator[Dict], batch_size: int):
        self.it = it
        self.batch_size = batch_size

    def __iter__(self):
        B = self.batch_size
        buf: Optional[Dict] = None
        for batch in self.it:
            buf = batch if buf is None else _rows_concat(buf, batch)
            n = buf["label"].shape[0]
            lo = 0
            while n - lo >= B:
                yield _rows_slice(buf, lo, lo + B)
                lo += B
            buf = _rows_slice(buf, lo, n) if lo else buf
            if buf["label"].shape[0] == 0:
                buf = None
        if buf is not None and buf["label"].shape[0] > 0:
            n = buf["label"].shape[0]
            pad = B - n
            out = {
                "sparse": {k: np.concatenate(
                    [v, np.full((pad,) + v.shape[1:], -1, v.dtype)])
                    for k, v in buf["sparse"].items()},
                "label": np.concatenate(
                    [buf["label"], np.zeros((pad,), np.float32)]),
                "weight": np.concatenate(
                    [buf.get("weight", np.ones((n,), np.float32)),
                     np.zeros((pad,), np.float32)]),
            }
            if buf.get("dense") is not None:
                out["dense"] = np.concatenate(
                    [buf["dense"], np.zeros((pad,) + buf["dense"].shape[1:],
                                            buf["dense"].dtype)])
            yield out


def pad_ragged(seqs, width: Optional[int] = None, dtype=np.int64) -> np.ndarray:
    """Variable-length id lists -> a static (len(seqs), width) array padded
    with -1 (= invalid in every lookup path). width=None uses the batch's own
    max length (min 1). A sequence longer than an explicit width raises."""
    lens = [len(s) for s in seqs]
    w = max(lens, default=0) or 1 if width is None else width
    out = np.full((len(lens), w), -1, dtype)
    for r, s in enumerate(seqs):
        if len(s) > w:
            raise ValueError(
                f"pad_ragged: sequence {r} has {len(s)} ids > width {w}; "
                "raise `width` (truncate explicitly if that's what you want)")
        out[r, :len(s)] = np.asarray(s, dtype)
    return out


def is_ragged(ids) -> bool:
    """True for a list/tuple/object-array of variable-length id sequences.
    Rectangular nested lists and real ndarrays are not ragged."""
    if isinstance(ids, np.ndarray):
        return ids.dtype == object
    if not isinstance(ids, (list, tuple)) or not ids:
        return False
    if not all(isinstance(s, (list, tuple, np.ndarray)) for s in ids):
        return False
    return len({len(s) for s in ids}) > 1


# ---------------------------------------------------------------------------
# device prefetch
# ---------------------------------------------------------------------------


def _map_leaves(tree, fn, path=()):
    """`fn(path, leaf)` over a batch's nested dicts; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return None if tree is None else fn(path, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


class _PinnedStager:
    """Copies batches to the card through pinned host buffers on a side
    stream. The producer thread stages (`stage`), the consumer takes the
    batch over (`hand_over`).

    - Each of `slots` pinned buffer sets is reused in turn, once the copy
      that last read it has finished (its event is waited on first).
    - Every batch gets fresh device tensors, allocated on the side stream;
      `hand_over` makes the consumer's stream wait for the copy and records
      the tensors on it, so the caching allocator hands their memory out
      again only once the consumer's work that reads them is done.
    """

    def __init__(self, device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pinned = [dict() for _ in range(slots)]
        self.events = [None] * slots
        self.turn = 0

    def _copy(self, buffers: dict, path, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf
        host = np.ascontiguousarray(
            leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
        dtype = torch.from_numpy(host).dtype
        pin = buffers.get(path)
        if pin is None or pin.shape != host.shape or pin.dtype != dtype:
            pin = torch.empty(host.shape, dtype=dtype, pin_memory=True)
            buffers[path] = pin
        # one plain memcpy that releases the interpreter lock (ctypes does),
        # so the consumer thread keeps launching; torch's CPU copy_ would
        # wake its intra-op thread pool, which competes for cores with the
        # parser's threads
        ctypes.memmove(pin.data_ptr(), host.ctypes.data, host.nbytes)
        out = torch.empty(pin.shape, dtype=pin.dtype, device=self.device)
        out.copy_(pin, non_blocking=True)
        return out

    def stage(self, batch):
        """Producer side: -> (batch of device tensors, copy-done event)."""
        k = self.turn
        self.turn = (k + 1) % len(self.pinned)
        if self.events[k] is not None:
            self.events[k].synchronize()  # its last copy has read the buffers
        buffers = self.pinned[k]
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = _map_leaves(batch,
                              lambda path, x: self._copy(buffers, path, x))
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[k] = event
        return out, event

    def hand_over(self, staged):
        """Consumer side: order the consumer's current stream after the
        copy, and keep the tensors' memory until that stream is done."""
        batch, event = staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in _leaves(batch):
            t.record_stream(stream)
        return batch


def prefetch_to_device(it: Iterator, size: int = 2,
                       device=None) -> Iterator:
    """Background-thread device prefetch: host parsing and the host-to-card
    copy of the next batches overlap the current step (the reference's
    `pulling()` prefetch).

    On the card (`device` None means the CUDA card and raises without one),
    a producer thread stages each batch into pinned host buffers and copies
    it on a side CUDA stream with `non_blocking=True`, `size` batches ahead
    (double buffered by default); each batch is handed over with an event
    that the consumer's stream waits on (`_PinnedStager`). The trainer takes
    such tensors as they are, with no second copy. On `device="cpu"` it is a
    plain thread that yields the batches as they are, with no pinned copy.

    As in the JAX package: an error in the producer is raised in the
    consumer, a consumer that leaves early reaps the thread, and a full
    queue never strands the producer. Telemetry, under the JAX package's
    names (label `ring="prefetch"`): the time the producer blocked on a full
    queue (`ingest.producer_stall_ms`), the queue's depth after each put
    (`ingest.queue_depth`) and the items an early consumer exit discarded
    (`ingest.dropped`)."""
    from ..utils import metrics

    _labels = {"ring": "prefetch"}
    device = resolve_device(device)
    stager = (_PinnedStager(device, size + 1) if device.type == "cuda"
              else None)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put: gives up once the consumer has left, so a consumer
        that abandons the generator never strands the producer on a full
        queue. A put that could not land at once counts its whole wait as
        a stall."""
        try:
            q.put_nowait(item)
            return True
        except queue_mod.Full:
            pass
        t0 = time.perf_counter()
        try:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue_mod.Full:
                    continue
            return False
        finally:
            metrics.observe("ingest.producer_stall_ms",
                            (time.perf_counter() - t0) * 1e3, "sum",
                            labels=_labels)

    def producer():
        try:
            for item in it:
                if stager is not None:
                    item = stager.stage(item)
                if not _put(item):
                    return
                metrics.observe("ingest.queue_depth", float(q.qsize()),
                                "gauge", labels=_labels)
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield stager.hand_over(item) if stager is not None else item
    finally:
        stop.set()
        dropped = 0
        while True:  # unblock a producer mid-put, then reap it
            try:
                item = q.get_nowait()
            except queue_mod.Empty:
                break
            if item is not _END and not isinstance(item, BaseException):
                dropped += 1
        if dropped:
            metrics.observe("ingest.dropped", float(dropped), "sum",
                            labels=_labels)
        t.join(timeout=5)
