"""Sequential recommendation: SASRec (causal) and BERT4Rec (bidirectional,
Cloze objective) over item histories (port of
`openembedding_tpu/models/sequential.py`).

The item history runs through the same row-sharded embedding path as CTR
ids, and the self-attention over it can be context-parallel
(`attention="ring"|"ulysses"`, `parallel/sequence.py`) under
`parallel.SeqMeshTrainer`.

Batch convention (Trainer-compatible, both families):
    {"sparse": {"item": (B, 3, S)},   # stacked [history, positives, negatives]
     "label":  (B, S)}                # 1.0 = scored position, 0.0 = not
For SASRec every real position is scored (label = the real-length mask);
for BERT4Rec only the [MASK]ed positions are, and positive and negative ids
are -1 everywhere else. One table pull fetches all three id sets.
"""

from __future__ import annotations

import inspect
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..embedding import Embedding
from ..initializers import Normal
from ..layers import Dense, LayerNorm, Param, is_initializing, sqrt_f32
from ..model import IDS_KEY, EmbeddingModel
from .ctr import _config

ITEM = "item"


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, as JAX computes it (logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))); torch's softplus takes another formula."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def sasrec_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    weight=None, *, norm_axis=None) -> torch.Tensor:
    """logits (B, S, 2) = [positive score, negative score]; labels (B, S)
    mask. BCE(pos -> 1) + BCE(neg -> 0), averaged over the scored
    positions.

    `norm_axis` (set by `parallel.SeqMeshTrainer`: its mesh): normalize by
    the mask count summed over the mesh's ranks instead of this rank's, so
    positions on padding-heavy sequence shards weigh what they weigh
    without context parallelism."""
    pos, neg = logits[..., 0], logits[..., 1]
    per = _softplus(-pos) + _softplus(neg)
    mask = labels.to(per.dtype)
    if weight is not None:
        mask = mask * weight.reshape(-1, 1).to(per.dtype)
    denom = torch.sum(mask)
    if norm_axis is not None:
        from ..parallel import collectives as coll
        denom = coll.dense_sum(norm_axis, denom.detach())
    return torch.sum(per * mask) / torch.clamp(denom, min=1.0)


def takes_norm_axis(loss_fn) -> bool:
    """Whether a loss function takes `norm_axis` (`sasrec_bce_loss`)."""
    try:
        return "norm_axis" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


class SASRec(nn.Module):
    """A transformer over the item history: causal (SASRec) by default,
    bidirectional (`causal=False`) for BERT4Rec; the embedding path, the
    attention, the positional table and the scoring heads are shared.

    `attention`: "full" (one device, or data parallel), "ring" or
    "ulysses" (context parallel: run under `parallel.SeqMeshTrainer`, which
    binds `seq_axis`; the sequence dim of the inputs is then this rank's
    shard). Layers keep the flax names: `ln_attn_{b}`, `qkv_{b}`,
    `proj_{b}`, `ln_ffn_{b}`, `ffn_in_{b}`, `ffn_out_{b}`, `ln_out` and the
    parameter `pos_emb` (max_len, dim) ~ N(0, 0.02)."""

    # the raw-id side channel (`model.IDS_KEY`): the key-padding mask comes
    # from the id values, not from pulled rows
    takes_ids = True

    def __init__(self, dim: int = 32, num_heads: int = 2, num_blocks: int = 2,
                 max_len: int = 512, attention: str = "full",
                 seq_axis: str = "seq",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 causal: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        self.max_len = max_len
        self.attention = attention
        self.seq_axis = seq_axis
        self.compute_dtype = compute_dtype
        self.causal = causal
        cd = compute_dtype
        self.pos_emb = Param("normal", stddev=0.02)
        self.ln_attn = nn.ModuleList(LayerNorm(cd) for _ in range(num_blocks))
        self.qkv = nn.ModuleList(Dense(3 * dim, cd)
                                 for _ in range(num_blocks))
        self.proj = nn.ModuleList(Dense(dim, cd) for _ in range(num_blocks))
        self.ln_ffn = nn.ModuleList(LayerNorm(cd) for _ in range(num_blocks))
        self.ffn_in = nn.ModuleList(Dense(2 * dim, cd)
                                    for _ in range(num_blocks))
        self.ffn_out = nn.ModuleList(Dense(dim, cd)
                                     for _ in range(num_blocks))
        self.ln_out = LayerNorm(cd)

    def _kv_valid(self, embedded, hist: torch.Tensor) -> torch.Tensor:
        """(B, S_local) key-padding mask from the raw id batch
        (`embedded[IDS_KEY]`, pads are -1): exact by construction. Without
        ids (a caller that bypasses the Trainer and serving paths), the
        zero-row heuristic, which drops a real position whose row happens
        to be all zero."""
        ids = embedded.get(IDS_KEY, {}).get(ITEM)
        if ids is None:
            return torch.any(hist != 0, dim=-1)
        return ids[:, 0] >= 0

    def _local(self) -> bool:
        """Whether attention runs on this rank alone: "full", or while
        the parameters are made (`materialize`, flax's init: attention owns
        no parameters, so the local path makes the same ones)."""
        return is_initializing() or self.attention == "full"

    def _attend(self, q, k, v, kv_valid):
        from ..parallel.sequence import (reference_attention, ring_attention,
                                         ulysses_attention)
        if self._local():
            return reference_attention(q, k, v, causal=self.causal,
                                       kv_valid=kv_valid)
        if self.attention == "ring":
            return ring_attention(q, k, v, axis=self.seq_axis,
                                  causal=self.causal, kv_valid=kv_valid)
        if self.attention == "ulysses":
            return ulysses_attention(q, k, v, axis=self.seq_axis,
                                     causal=self.causal, kv_valid=kv_valid)
        raise ValueError(f"unknown attention {self.attention!r}")

    def _seq_rank_size(self):
        """(this rank's index, P) along the seq axis; (0, 1) locally."""
        if self._local():
            return 0, 1
        from ..parallel.sequence import axis_mesh
        mesh = axis_mesh(self.seq_axis)
        return mesh.rank, mesh.size

    def forward(self, embedded, dense):
        del dense
        trio = embedded[ITEM]                       # (B, 3, S_local, d)
        hist, e_pos, e_neg = trio[:, 0], trio[:, 1], trio[:, 2]
        B, S, d = hist.shape
        kv_valid = self._kv_valid(embedded, hist)   # (B, S_local)
        if d != self.dim:
            raise ValueError(f"embedding dim {d} != module dim {self.dim}")
        H = self.num_heads
        Dh = d // H
        seq_rank, seq_size = self._seq_rank_size()
        if S * seq_size > self.max_len:
            # an index past max_len would read past the table: surface the
            # misconfiguration instead
            raise ValueError(f"sequence length {S * seq_size} exceeds "
                             f"max_len={self.max_len}")
        pos_table = self.pos_emb((self.max_len, d))
        offset = seq_rank * S                       # `_pos_offset`
        sqrt_d = sqrt_f32(d, hist.device)
        x = (hist.to(torch.float32) * sqrt_d
             + pos_table[offset:offset + S])
        x = x.to(self.compute_dtype)
        for b in range(self.num_blocks):
            a = self.ln_attn[b](x)
            qkv = self.qkv[b](a).reshape(B, S, 3 * H, Dh)
            q, k, v = torch.split(qkv, H, dim=2)
            o = self._attend(q, k, v, kv_valid).reshape(B, S, d)
            x = x + self.proj[b](o)
            f = self.ffn_in[b](self.ln_ffn[b](x))
            x = x + self.ffn_out[b](torch.relu(f))
        h = self.ln_out(x).to(torch.float32)
        logit_pos = torch.sum(h * e_pos.to(torch.float32), dim=-1)
        logit_neg = torch.sum(h * e_neg.to(torch.float32), dim=-1)
        return torch.stack([logit_pos, logit_neg], dim=-1)   # (B, S, 2)

    def flax_dense(self) -> Dict[str, nn.Module]:
        out: Dict[str, nn.Module] = {"pos_emb": self.pos_emb}
        for b in range(self.num_blocks):
            out.update({f"ln_attn_{b}": self.ln_attn[b],
                        f"qkv_{b}": self.qkv[b], f"proj_{b}": self.proj[b],
                        f"ln_ffn_{b}": self.ln_ffn[b],
                        f"ffn_in_{b}": self.ffn_in[b],
                        f"ffn_out_{b}": self.ffn_out[b]})
        out["ln_out"] = self.ln_out
        return out


def _make_sequential(family: str, *, causal: bool, extra_rows: int,
                     vocabulary: int, dim: int, num_heads: int,
                     num_blocks: int, max_len: int, attention: str,
                     seq_axis: str, hashed: bool, capacity: int,
                     num_shards: int, optimizer, compute_dtype
                     ) -> EmbeddingModel:
    """The sequential families' factory body: one item table (with
    `extra_rows` reserved rows, BERT4Rec's [MASK]), the shared transformer
    and the BCE loss. An export rebuilds with local attention
    (`serving_overrides`): attention parallelism belongs to the run, not
    to the model."""
    emb = Embedding(
        input_dim=-1 if hashed else vocabulary + extra_rows, output_dim=dim,
        name=ITEM, embeddings_initializer=Normal(stddev=0.02),
        optimizer=optimizer, num_shards=num_shards, capacity=capacity)
    module = SASRec(dim=dim, num_heads=num_heads, num_blocks=num_blocks,
                    max_len=max_len, attention=attention, seq_axis=seq_axis,
                    compute_dtype=compute_dtype, causal=causal)
    return EmbeddingModel(
        module, [emb], loss_fn=sasrec_bce_loss,
        config=_config(family, compute_dtype, vocabulary=vocabulary, dim=dim,
                       num_heads=num_heads, num_blocks=num_blocks,
                       max_len=max_len, attention=attention,
                       seq_axis=seq_axis, hashed=hashed, capacity=capacity,
                       num_shards=num_shards,
                       serving_overrides={"attention": "full"}))


def make_sasrec(vocabulary: int, dim: int = 32, *, num_heads: int = 2,
                num_blocks: int = 2, max_len: int = 512,
                attention: str = "full", seq_axis: str = "seq",
                hashed: bool = False, capacity: int = 0, num_shards: int = -1,
                optimizer=None, compute_dtype=torch.bfloat16
                ) -> EmbeddingModel:
    return _make_sequential(
        "sasrec", causal=True, extra_rows=0, vocabulary=vocabulary, dim=dim,
        num_heads=num_heads, num_blocks=num_blocks, max_len=max_len,
        attention=attention, seq_axis=seq_axis, hashed=hashed,
        capacity=capacity, num_shards=num_shards, optimizer=optimizer,
        compute_dtype=compute_dtype)


def make_bert4rec(vocabulary: int, dim: int = 32, *, num_heads: int = 2,
                  num_blocks: int = 2, max_len: int = 512,
                  attention: str = "full", seq_axis: str = "seq",
                  hashed: bool = False, capacity: int = 0,
                  num_shards: int = -1, optimizer=None,
                  compute_dtype=torch.bfloat16) -> EmbeddingModel:
    """BERT4Rec: SASRec's transformer made bidirectional (with the
    key-padding mask that needs), trained to recover items hidden behind a
    [MASK] token (`bert4rec_mask_id`): an array table has one extra row
    for it. The batch is SASRec's trio with `label` 1.0 at the masked
    positions."""
    return _make_sequential(
        "bert4rec", causal=False, extra_rows=1, vocabulary=vocabulary,
        dim=dim, num_heads=num_heads, num_blocks=num_blocks, max_len=max_len,
        attention=attention, seq_axis=seq_axis, hashed=hashed,
        capacity=capacity, num_shards=num_shards, optimizer=optimizer,
        compute_dtype=compute_dtype)


def bert4rec_mask_id(vocabulary: int, hashed: bool = False) -> int:
    """The [MASK] token id of `make_bert4rec(vocabulary, ...)`: id
    `vocabulary` (the extra row) for an array table, 2^62 - 1 (far outside
    the fold-hashed id ranges) for a hashed one."""
    return (1 << 62) - 1 if hashed else vocabulary


# -- synthetic data: the JAX package's generators, copied (numpy only) ----------


def _markov_batch(rng, batch_size: int, seq_len: int, vocabulary: int):
    """Markov-ish item chains (stride walks mod vocab, so the model has
    signal), a sampled negative a position and variable real lengths ->
    (items, stride, neg, real mask)."""
    start = rng.integers(1, vocabulary, size=(batch_size, 1))
    stride = rng.integers(1, 7, size=(batch_size, 1))
    items = (start + stride * np.arange(seq_len)) % vocabulary  # (B, S)
    neg = rng.integers(0, vocabulary, size=(batch_size, seq_len))
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=batch_size)
    real = (np.arange(seq_len)[None, :] < lengths[:, None])
    return items, stride, neg, real


def _seq_batch(hist, pos, neg, hist_keep, score_at):
    """The (B, 3, S) trio and the label: the history kept where
    `hist_keep`, positives and negatives only where `score_at` (-1
    elsewhere: nothing pulled for positions the loss never reads)."""
    ids = np.stack([np.where(hist_keep, hist, -1),
                    np.where(score_at, pos, -1),
                    np.where(score_at, neg, -1)], axis=1).astype(np.int64)
    return {"sparse": {ITEM: ids}, "label": score_at.astype(np.float32)}


def synthetic_masked_sequences(batch_size: int, seq_len: int,
                               vocabulary: int, *, mask_rate: float = 0.2,
                               seed: int = 0, steps=None):
    """Cloze data for BERT4Rec: `synthetic_sequences`' chains with about
    `mask_rate` of the real positions replaced by the [MASK] token in the
    history and labeled (at least one a row). Byte-identical to the JAX
    package's generator for the same arguments."""
    import itertools
    mask_id = bert4rec_mask_id(vocabulary)
    rng = np.random.default_rng(seed)
    it = itertools.count() if steps is None else range(steps)
    for _ in it:
        items, _, neg, real = _markov_batch(rng, batch_size, seq_len,
                                            vocabulary)
        masked = real & (rng.random((batch_size, seq_len)) < mask_rate)
        masked[~masked.any(axis=1), 0] = True
        neg = np.where(neg == items, (neg + 1) % vocabulary, neg)
        yield _seq_batch(np.where(masked, mask_id, items), items, neg,
                         hist_keep=real, score_at=masked)


def synthetic_sequences(batch_size: int, seq_len: int, vocabulary: int, *,
                        seed: int = 0, steps=None):
    """Next-item data: Markov-ish item chains -> Trainer-ready batches
    ((B, 3, S) ids and the (B, S) mask). Byte-identical to the JAX
    package's generator for the same arguments."""
    import itertools
    rng = np.random.default_rng(seed)
    it = itertools.count() if steps is None else range(steps)
    for _ in it:
        hist, stride, neg, real = _markov_batch(rng, batch_size, seq_len,
                                                vocabulary)
        pos = (hist + stride) % vocabulary
        neg = np.where(neg == pos, (neg + 1) % vocabulary, neg)
        yield _seq_batch(hist, pos, neg, hist_keep=real, score_at=real)
