"""Checkpoint helpers shared with the export (the numpy parts of
`openembedding_tpu/checkpoint.py`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

MODEL_META_FILE = "model_meta"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}, the flat names of `dense_params.npz`."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_numpy(params)
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of `_flatten_params`; leaves stay numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree
