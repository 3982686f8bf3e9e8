"""The traffic generator: the default stream is the program's synthetic
Criteo byte for byte, and a mix's per-field `cardinalities` cut each field
without changing the rest of the stream."""

import itertools

import numpy as np
import pytest

from benchmark import traffic

KW = dict(id_space=1 << 20, num_fields=6, dense_dim=3, seed=2 ** 31 + 7,
          alpha=1.05)


def _take(gen, n):
    return list(itertools.islice(gen, n))


def test_default_stream_is_the_programs():
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    mine = _take(traffic.synthetic_criteo(256, **KW), 3)
    theirs = _take(synthetic_criteo(256, **KW), 3)
    for a, b in zip(mine, theirs):
        assert np.array_equal(a["sparse"]["categorical"],
                              b["sparse"]["categorical"])
        assert np.array_equal(a["dense"], b["dense"])
        assert np.array_equal(a["label"], b["label"])


def test_cardinalities_cut_each_field():
    cards = [1, 3, 30, 1000, 10 ** 6, 10 ** 9]
    free = _take(traffic.synthetic_criteo(4096, **KW), 2)
    cut = _take(traffic.synthetic_criteo(4096, cardinalities=cards, **KW), 2)
    ids = np.concatenate([b["sparse"]["categorical"] for b in cut])
    for f, n in enumerate(cards):
        distinct = np.unique(ids[:, f]).size
        assert distinct <= n
        if n <= 30:
            assert distinct == n
    free_ids = np.concatenate([b["sparse"]["categorical"] for b in free])
    assert (np.unique(ids[:, 3]).size
            < np.unique(free_ids[:, 3]).size)
    # the same uniform draws: the dense stream is untouched
    for a, b in zip(free, cut):
        assert np.array_equal(a["dense"], b["dense"])


def test_cut_keeps_the_zipf_weights():
    u = np.random.default_rng(3).random((200_000, 1))
    raw = traffic.zipf_raw(u, 1.5, [100])[:, 0]
    assert raw.min() == 1 and raw.max() <= 100
    # P(1) / P(2) of the Pareto tail cut at 101: (1 - 2^-a) / (2^-a - 3^-a)
    a = 0.5
    want = (1 - 2 ** -a) / (2 ** -a - 3 ** -a)
    got = (raw == 1).sum() / (raw == 2).sum()
    assert abs(got / want - 1) < 0.05


def test_bad_cardinalities_raise():
    u = np.random.default_rng(0).random((4, 2))
    with pytest.raises(ValueError):
        traffic.zipf_raw(u, 1.05, [5])
    with pytest.raises(ValueError):
        traffic.zipf_raw(u, 1.05, [5, 0])
