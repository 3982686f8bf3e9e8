"""Host-side id helpers the serving layer needs (copies of `pad_ragged` and
`is_ragged` from `openembedding_tpu/data/criteo.py`)."""

from __future__ import annotations

from typing import Optional

import numpy as np


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
