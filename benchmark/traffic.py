"""The general traffic generator: a mix file under `traffic/` gives its
parameters, this module makes the batches from the run's seed.

Generators, by the mix's `"generator"` key:

- `synthetic_criteo`: a frozen copy of the program's
  `data/criteo.synthetic_criteo` with its `hash_category`, in numpy, so a
  change to the program's generator cannot change the yardstick. Zipfian raw
  ids (inverse CDF of a uniform draw), hashed per field into the table's id
  space; 13 normal dense features; a label drawn from a fixed linear logit
  over the dense features and the ids. The same seed gives the same batches,
  byte for byte, as the program's generator with that seed. Every field
  draws from one unbounded Zipf(`alpha`) unless the mix gives
  `cardinalities`, one count a field: field f then draws its raw ids
  1..n_f from Zipf(`alpha`) cut at n_f (the same uniform draws, so the
  rest of the stream is unchanged).

A pool holds `pool_batches` distinct batches, grouped into windows of
`window` stacked batches (every leaf gets a leading window axis), which a
closed loop cycles through.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def hash_category(token_hash: np.ndarray, field: np.ndarray,
                  id_space: int) -> np.ndarray:
    """(token hash, field index) -> folded id in [0, id_space); the field
    salt keeps distinct fields' tokens apart in the shared table."""
    h = (token_hash.astype(np.uint64) ^ _FNV_OFFSET) * _FNV_PRIME
    h ^= (field.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    h *= _FNV_PRIME
    h &= np.uint64(0x7FFFFFFFFFFFFFFF)
    return (h % np.uint64(id_space)).astype(np.int64)


def zipf_raw(u: np.ndarray, alpha: float, cardinalities=None
             ) -> np.ndarray:
    """Raw ids from uniform draws `u` (B, F) by the inverse CDF of a Zipf
    (Pareto) tail: unbounded (up to 2^62), or field f cut at
    `cardinalities[f]` values (the tail's CDF renormalised on [1, n_f + 1),
    so ids 1..n_f keep the unbounded draw's relative weights)."""
    e = -1.0 / (alpha - 1.0)
    if cardinalities is None:
        return np.floor(np.clip(u ** e, 1.0, 2.0 ** 62)).astype(np.int64)
    n = np.asarray(cardinalities, dtype=np.float64)
    if n.shape != (u.shape[1],) or (n < 1).any():
        raise ValueError(f"cardinalities {cardinalities!r}: one count of "
                         f"at least 1 a field, {u.shape[1]} fields")
    raw = np.floor((1.0 - u * (1.0 - (n + 1.0) ** -(alpha - 1.0))) ** e)
    return np.clip(raw, 1.0, n).astype(np.int64)


def synthetic_criteo(batch_size: int, *, id_space: int, num_fields: int,
                     dense_dim: int, seed, alpha: float,
                     cardinalities=None) -> Iterator[Dict]:
    """Endless stream of Criteo-like batches: {"sparse": {"categorical":
    (B, F) int64}, "dense": (B, D) float32, "label": (B,) float32}."""
    rng = np.random.default_rng(seed)
    w_dense = rng.normal(size=(dense_dim,)).astype(np.float32) * 0.3
    fields = np.broadcast_to(np.arange(num_fields, dtype=np.uint64),
                             (batch_size, num_fields))
    for _ in itertools.count():
        raw = zipf_raw(rng.random((batch_size, num_fields)), alpha,
                       cardinalities)
        ids64 = hash_category(raw.astype(np.uint64), fields, id_space)
        dense = rng.normal(size=(batch_size, dense_dim)).astype(np.float32)
        logit = (dense @ w_dense
                 + 0.01 * (ids64 % 97 - 48).sum(axis=1) / num_fields)
        labels = (rng.random(batch_size) < 1.0 / (1.0 + np.exp(-logit))
                  ).astype(np.float32)
        yield {"sparse": {"categorical": ids64}, "dense": dense,
               "label": labels}


GENERATORS = {"synthetic_criteo": synthetic_criteo}


def id_space(config: dict) -> int:
    """The ids' range: the table's rows, or the 63-bit space of a hashed
    table."""
    return (1 << 63) if config["hashed"] else int(config["vocabulary"])


def make_pool(mix: dict, config: dict, seed: int,
              rank: int = -1) -> List[Dict]:
    """The run's pool: `pool_batches` batches from `seed` (`rank` r >= 0:
    rank r's own batches of a mesh, from the stream (seed, r)), stacked
    into windows of `window` -> [window dict], each leaf (window, B,
    ...)."""
    gen = GENERATORS[mix["generator"]](
        mix["batch_size"], id_space=id_space(config),
        num_fields=mix["num_fields"], dense_dim=mix["dense_dim"],
        seed=seed if rank < 0 else [seed, rank], alpha=mix["alpha"],
        cardinalities=mix.get("cardinalities"))
    k = mix["window"]
    if mix["pool_batches"] % k:
        raise ValueError(f"pool_batches {mix['pool_batches']} is not a "
                         f"multiple of the window {k}")
    windows = []
    for _ in range(mix["pool_batches"] // k):
        batches = [next(gen) for _ in range(k)]
        windows.append({
            "sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in batches])},
            "dense": np.stack([b["dense"] for b in batches]),
            "label": np.stack([b["label"] for b in batches])})
    return windows


def batch_of(windows: List[Dict], t: int) -> Dict:
    """Pool batch `t` (the t-th step of the closed loop's first pass)."""
    w, k = divmod(t, windows[0]["label"].shape[0])
    return {"sparse": {"categorical": windows[w]["sparse"]["categorical"][k]},
            "dense": windows[w]["dense"][k], "label": windows[w]["label"][k]}
