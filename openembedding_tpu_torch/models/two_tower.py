"""Two-tower retrieval model: a user tower and an item tower, in-batch
softmax (port of `openembedding_tpu/models/two_tower.py`).

Batch convention: {"sparse": {"user": (B, Fu) ids, "item": (B, Fi) ids},
"label": unused (the in-batch negatives), "dense": optional user
features}. The module returns the (B, B) score matrix: row i is user i
against every item of the batch; `in_batch_softmax_loss` takes the
diagonal as the positives. With `combiner` both towers pool a -1-padded
id list per row (`embedding.combine`), so their input width does not depend
on the request's field count.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..embedding import Embedding
from ..initializers import Normal
from ..layers import Param
from ..model import EmbeddingModel
from .ctr import MLP, _config

USER = "user"
ITEM = "item"


def in_batch_softmax_loss(scores: torch.Tensor, labels=None,
                          weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Softmax over the in-batch items, the positives on the diagonal;
    `weight` takes padded rows (weight 0) out of the mean."""
    del labels
    logp = -torch.diagonal(torch.log_softmax(scores, dim=-1))
    if weight is None:
        return torch.mean(logp)
    w = weight.reshape(-1).to(logp.dtype)
    return torch.sum(logp * w) / torch.clamp(torch.sum(w), min=1.0)


class TwoTower(nn.Module):
    """User and item MLP towers (flax `user_tower` / `item_tower`), each
    output L2-normalized (`+ 1e-6` on the norm), the dot products scaled by
    exp(`log_inv_temperature`) * 20 in float32. The user tower takes the
    dense features first when the batch carries them."""

    def __init__(self, tower: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.tower = tuple(tower)
        self.compute_dtype = compute_dtype
        self.user_tower = MLP(self.tower, compute_dtype=compute_dtype)
        self.item_tower = MLP(self.tower, compute_dtype=compute_dtype)
        self.log_inv_temperature = Param("zeros")

    def forward(self, embedded, dense):
        u = embedded[USER]                     # (B, Fu, d) or pooled (B, d)
        i = embedded[ITEM]
        u_in = u.reshape(u.shape[0], -1)
        if dense is not None:
            u_in = torch.cat([dense.to(u.dtype), u_in], dim=-1)
        uemb = self.user_tower(u_in)
        iemb = self.item_tower(i.reshape(i.shape[0], -1))
        uemb = uemb / (torch.linalg.vector_norm(uemb, dim=-1, keepdim=True)
                       + 1e-6)
        iemb = iemb / (torch.linalg.vector_norm(iemb, dim=-1, keepdim=True)
                       + 1e-6)
        temp = self.log_inv_temperature((1,))
        return (torch.matmul(uemb, iemb.t()).to(torch.float32)
                * torch.exp(temp[0]) * 20.0)

    def flax_dense(self) -> Dict[str, nn.Module]:
        return {**self.user_tower.flax_dense("user_tower/"),
                **self.item_tower.flax_dense("item_tower/"),
                "log_inv_temperature": self.log_inv_temperature}


def make_two_tower(user_vocabulary: int, item_vocabulary: int, dim: int = 16,
                   *, tower=(256, 128), hashed: bool = False,
                   user_capacity: int = 0, item_capacity: int = 0,
                   num_shards: int = -1, optimizer=None,
                   compute_dtype=torch.bfloat16,
                   combiner: str = "") -> EmbeddingModel:
    """One table a tower ("user", "item"), rows ~ N(0, 1e-4). `combiner`
    (sum/mean/sqrtn) makes both towers multivalent: each row carries a
    -1-padded id list (`data.pad_ragged`), pooled before the MLP, so
    serving takes any request width."""
    embs = [
        Embedding(input_dim=-1 if hashed else user_vocabulary,
                  output_dim=dim, name=USER,
                  embeddings_initializer=Normal(stddev=1e-2),
                  optimizer=optimizer, num_shards=num_shards,
                  capacity=user_capacity, combiner=combiner),
        Embedding(input_dim=-1 if hashed else item_vocabulary,
                  output_dim=dim, name=ITEM,
                  embeddings_initializer=Normal(stddev=1e-2),
                  optimizer=optimizer, num_shards=num_shards,
                  capacity=item_capacity, combiner=combiner),
    ]
    return EmbeddingModel(
        TwoTower(tower=tower, compute_dtype=compute_dtype), embs,
        loss_fn=in_batch_softmax_loss,
        config=_config("two_tower", compute_dtype,
                       user_vocabulary=user_vocabulary,
                       item_vocabulary=item_vocabulary, dim=dim,
                       tower=list(tower), hashed=hashed,
                       user_capacity=user_capacity,
                       item_capacity=item_capacity, num_shards=num_shards,
                       combiner=combiner))
