"""Host-side data helpers: copies of `pad_ragged`, `is_ragged`,
`hash_category` and `synthetic_criteo` from `openembedding_tpu/data/criteo.py`
(int64 or int32 ids: the split-pair id layout has no place in the port). All
numpy; `tests/test_torch_trainer.py` pins the generator's batches
byte-identical to the JAX package's."""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional

import numpy as np

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
