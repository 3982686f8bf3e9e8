"""CTR model families as `torch.nn.Module`s (port of
`openembedding_tpu/models/ctr.py`; slice 1 ports DeepFM).

Each module's `forward(embedded, dense)` takes `embedded` (variable name ->
pulled rows) and the (B, num_dense) float features (or None), and returns
(B,) float32 logits.

The sparse side is one shared table named "categorical" holding dim+1
columns: column 0 is the first-order weight, columns 1..dim the latent vector
(or, split, a dim-wide table plus a 1-wide "first_order" table on the same id
feature). The dtype sequence is the JAX module's: the FM term and the tower in
`compute_dtype`, the first-order sum and the logit in float32, dense features
concatenated before the flattened latent vectors.

Each module lists its `Dense` layers under their flax names
(`flax_dense()`), which `convert.py` uses to carry weights across.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..embedding import Embedding
from ..initializers import CombinedFirstOrder, Normal, Zeros
from ..layers import Dense
from ..model import EmbeddingModel, binary_logloss

CRITEO_NUM_SPARSE = 26   # C1..C26
CRITEO_NUM_DENSE = 13    # I1..I13

CATEGORICAL = "categorical"
FIRST_ORDER = "first_order"


class MLP(nn.Module):
    """Dense tower. Hidden layers ReLU; last layer linear unless
    `activate_last`."""

    def __init__(self, features: Sequence[int], activate_last: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.activate_last = activate_last
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(Dense(f, compute_dtype) for f in features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last or self.activate_last:
                x = torch.relu(x)
        return x

    def flax_dense(self, prefix: str = "") -> Dict[str, Dense]:
        return {f"{prefix}Dense_{i}": d for i, d in enumerate(self.layers)}


def _split_first_order(embedded):
    """-> (first-order weights (B, F), latent vectors (B, F, d)) from the
    folded table, or from the split pair of tables."""
    if FIRST_ORDER in embedded:
        return embedded[FIRST_ORDER][..., 0], embedded[CATEGORICAL]
    e = embedded[CATEGORICAL]
    return e[..., 0], e[..., 1:]


class DeepFM(nn.Module):
    """DeepFM: first-order + FM pairwise interactions + DNN, shared
    embeddings."""

    def __init__(self, hidden: Sequence[int] = (400, 400, 400),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        self.linear = Dense(1, compute_dtype)          # flax Dense_0
        self.mlp = MLP(self.hidden + (1,), compute_dtype=compute_dtype)

    def forward(self, embedded, dense):
        cd = self.compute_dtype
        w, v = _split_first_order(embedded)   # (B,F), (B,F,d)
        first = torch.sum(w.to(torch.float32), dim=-1)
        vb = v.to(cd)
        # FM second order: 0.5 * sum_d [(sum_f v)^2 - sum_f v^2]
        sum_sq = torch.square(torch.sum(vb, dim=1))
        sq_sum = torch.sum(torch.square(vb), dim=1)
        fm = 0.5 * torch.sum(sum_sq - sq_sum, dim=-1).to(torch.float32)
        feats = vb.reshape(vb.shape[0], -1)
        if dense is not None:
            feats = torch.cat([dense.to(cd), feats], dim=-1)
            first = first + self.linear(dense.to(cd))[..., 0].to(
                torch.float32)
        deep = self.mlp(feats)
        return first + fm + deep[..., 0].to(torch.float32)

    def flax_dense(self) -> Dict[str, Dense]:
        return {"Dense_0": self.linear, **self.mlp.flax_dense("MLP_0/")}


def _categorical_embedding(vocabulary: int, dim: int, *, hashed: bool,
                           capacity: int, num_shards: int, optimizer=None,
                           split: bool = False):
    """The categorical table(s): folded, one (dim+1)-wide table with column 0
    the first-order weight; split, a dim-wide latent table plus a 1-wide
    FIRST_ORDER table reading the same id feature. Latent vectors start
    ~ N(0, 1e-4), first-order weights at 0. `optimizer` goes into every
    table's spec (None: the trainer's)."""
    kw = dict(input_dim=-1 if hashed else vocabulary, optimizer=optimizer,
              num_shards=num_shards, capacity=capacity)
    if not split:
        return [Embedding(output_dim=dim + 1, name=CATEGORICAL,
                          embeddings_initializer=CombinedFirstOrder(
                              stddev=1e-4), **kw)]
    return [Embedding(output_dim=dim, name=CATEGORICAL,
                      embeddings_initializer=Normal(stddev=1e-4), **kw),
            Embedding(output_dim=1, name=FIRST_ORDER,
                      embeddings_initializer=Zeros(),
                      feature=CATEGORICAL, **kw)]


def _first_order_mode(mode: str, dim: int) -> str:
    """Resolve first_order="auto" exactly as the JAX package does, so both
    build the same tables: fold when 2*(dim+1) <= 32, split when dim is a
    multiple of 64, fold otherwise."""
    if mode != "auto":
        if mode not in ("fold", "split"):
            raise ValueError(f"first_order={mode!r}: expected fold/split/auto")
        return mode
    if 2 * (dim + 1) <= 32:
        return "fold"
    if dim % 64 == 0:
        return "split"
    return "fold"


def dtype_name(dtype: torch.dtype) -> str:
    """torch.bfloat16 -> "bfloat16" (the name numpy and JAX use)."""
    return str(dtype).rsplit(".", 1)[-1]


def _config(family: str, compute_dtype, **kwargs) -> dict:
    """Serializable rebuild recipe: exactly the factory's keyword arguments,
    the same dict the JAX package writes."""
    return {"family": family, "compute_dtype": dtype_name(compute_dtype),
            **kwargs}


def make_deepfm(vocabulary: int, dim: int = 9, *, hidden=(400, 400, 400),
                hashed: bool = False, capacity: int = 0, num_shards: int = -1,
                optimizer=None, compute_dtype=torch.bfloat16,
                first_order: str = "auto") -> EmbeddingModel:
    fo = _first_order_mode(first_order, dim)
    embs = _categorical_embedding(vocabulary, dim, hashed=hashed,
                                  capacity=capacity, num_shards=num_shards,
                                  optimizer=optimizer, split=fo == "split")
    return EmbeddingModel(
        DeepFM(hidden=hidden, compute_dtype=compute_dtype), embs,
        loss_fn=binary_logloss,
        config=_config("deepfm", compute_dtype, vocabulary=vocabulary,
                       dim=dim, hidden=list(hidden), hashed=hashed,
                       capacity=capacity, num_shards=num_shards,
                       first_order=fo))
