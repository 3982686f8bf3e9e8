"""The port's owner routing (`ops/dedup.py`) against the JAX package's,
bit-exact: integer work only.

`bucket_by_owner`, `unique_and_route` (with a small capacity, so buckets
overflow), `unbucket`, `carry_to_unique`, `concat_owner_buckets` /
`split_owner_buckets` and `bucket_validity`, for S in 1, 2, 4 and 8, on
single-lane int64 ids up to 2^63 - 1 with -1 pads and invalid ids, the
same numpy inputs through both packages (JAX jitted, 64-bit types on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.ops import dedup as jax_dedup
from openembedding_tpu_torch.ops import dedup

SHARDS = [1, 2, 4, 8]
N = 257


def _ids(seed, big=True):
    rng = np.random.default_rng(seed)
    pool = (rng.integers(0, 2 ** 63 - 1, size=60, dtype=np.int64) if big
            else rng.integers(0, 500, size=60))
    pool[:2] = [2 ** 63 - 1, 0]
    ids = pool[rng.integers(0, len(pool), size=N)].astype(np.int64)
    ids[rng.random(N) < 0.1] = -1
    valid = (ids >= 0) & (rng.random(N) < 0.95)
    return ids, valid


def _np(x):
    return np.asarray(x)


def _same(got, want, what):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("cap_share", [1.0, 0.1])
@pytest.mark.parametrize("big", [True, False], ids=["2^63", "small"])
def test_unique_and_route_is_bit_exact(S, cap_share, big):
    ids, valid = _ids(S, big)
    cap = max(1, int(N * cap_share) // S)
    uniq, b = dedup.unique_and_route(torch.tensor(ids), torch.tensor(valid),
                                     S, cap)
    juniq, jb = jax.jit(jax_dedup.unique_and_route, static_argnums=(2, 3))(
        jnp.asarray(ids), jnp.asarray(valid), S, cap)
    for f in ("unique_ids", "inverse", "counts", "num_unique", "order",
              "seg"):
        _same(getattr(uniq, f), getattr(juniq, f), f)
    for f in ("bucket_ids", "bucket_valid", "owner", "slot", "overflow"):
        _same(getattr(b, f), getattr(jb, f), f)
    if cap_share < 1 and S > 1:
        assert int(b.overflow) > 0
    # the client's sums over the unique slots: bit-exact sorted segments
    g = np.random.default_rng(S).normal(size=(N, 3)).astype(np.float32)
    _same(uniq.segment_reduce(torch.tensor(g)),
          juniq.segment_reduce(jnp.asarray(g)), "segment_reduce")


@pytest.mark.parametrize("S", SHARDS)
def test_unique_and_route_takes_an_explicit_owner(S):
    ids, valid = _ids(10 + S)
    owner = (np.abs(ids) // 7 % S).astype(np.int32)
    uniq, b = dedup.unique_and_route(torch.tensor(ids), torch.tensor(valid),
                                     S, N, owner=torch.tensor(owner))
    juniq, jb = jax_dedup.unique_and_route(
        jnp.asarray(ids), jnp.asarray(valid), S, N, owner=jnp.asarray(owner))
    _same(uniq.unique_ids, juniq.unique_ids, "unique_ids")
    _same(b.bucket_ids, jb.bucket_ids, "bucket_ids")


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("cap_share", [1.0, 0.2])
def test_bucket_by_owner_is_bit_exact(S, cap_share):
    ids, valid = _ids(20 + S)
    cap = max(1, int(N * cap_share) // S)
    b = dedup.bucket_by_owner(torch.tensor(ids), torch.tensor(valid), S, cap)
    jb = jax.jit(jax_dedup.bucket_by_owner, static_argnums=(2, 3))(
        jnp.asarray(ids), jnp.asarray(valid), S, cap)
    for f in ("bucket_ids", "bucket_valid", "owner", "slot", "overflow"):
        _same(getattr(b, f), getattr(jb, f), f)


@pytest.mark.parametrize("S", SHARDS)
def test_unbucket_and_carry_to_unique_are_bit_exact(S):
    ids, valid = _ids(30 + S)
    cap = max(1, N // (2 * S))
    uniq, b = dedup.unique_and_route(torch.tensor(ids), torch.tensor(valid),
                                     S, cap)
    juniq, jb = jax_dedup.unique_and_route(jnp.asarray(ids),
                                           jnp.asarray(valid), S, cap)
    rows = np.random.default_rng(S).normal(size=(S, cap, 5)).astype(
        np.float32)
    _same(dedup.unbucket(torch.tensor(rows), b.owner, b.slot),
          jax_dedup.unbucket(jnp.asarray(rows), jb.owner, jb.slot),
          "unbucket")
    per_pos = (np.abs(ids) % 11).astype(np.int32)  # a function of the id
    _same(dedup.carry_to_unique(uniq, torch.tensor(per_pos), -3),
          jax_dedup.carry_to_unique(juniq, jnp.asarray(per_pos), -3),
          "carry_to_unique")
    _same(dedup.bucket_validity(b.bucket_ids),
          jax_dedup.bucket_validity(jb.bucket_ids), "bucket_validity")


@pytest.mark.parametrize("S", SHARDS)
def test_concat_and_split_owner_buckets_are_bit_exact(S):
    parts, jparts, templates, jtemplates = [], [], [], []
    for t, (cap, big) in enumerate([(5, True), (3, False), (7, True)]):
        ids, valid = _ids(40 + 3 * S + t, big)
        _, b = dedup.unique_and_route(torch.tensor(ids), torch.tensor(valid),
                                      S, cap)
        _, jb = jax_dedup.unique_and_route(jnp.asarray(ids),
                                           jnp.asarray(valid), S, cap)
        parts.append(b.bucket_ids)
        jparts.append(jb.bucket_ids)
        templates.append((cap, torch.int64))
        jtemplates.append((cap, False, jnp.int64))
    wire = dedup.concat_owner_buckets(parts)
    jwire = jax_dedup.concat_owner_buckets(jparts)
    _same(wire, jwire, "concat")
    for got, want in zip(dedup.split_owner_buckets(wire, templates),
                         jax_dedup.split_owner_buckets(jwire, jtemplates)):
        _same(got, want, "split")
    with pytest.raises(ValueError, match="templates cover"):
        dedup.split_owner_buckets(wire, templates[:2])
