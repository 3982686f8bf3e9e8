"""Training metrics of the port: `auc`, copied from
`openembedding_tpu/utils/metrics.py`. The JAX module's metric registry,
histograms and exporters are ROADMAP.md item 6."""

from __future__ import annotations

import numpy as np


def auc(labels, scores) -> float:
    """Rank-based (Mann-Whitney) AUC over pooled predictions, the library
    twin of the Keras AUC the reference prints per epoch. Ties get their
    stable-sort rank; returns nan when a class is absent."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
