"""CTR model families as `torch.nn.Module`s (port of
`openembedding_tpu/models/ctr.py`): LR, Wide&Deep, DeepFM, xDeepFM, DCN and
DLRM.

Each module's `forward(embedded, dense)` takes `embedded` (variable name ->
pulled rows) and the (B, num_dense) float features (or None), and returns
(B,) float32 logits.

The sparse side is one shared table named "categorical" holding dim+1
columns: column 0 is the first-order weight, columns 1..dim the latent vector
(or, split, a dim-wide table plus a 1-wide "first_order" table on the same id
feature). The dtype sequence is the JAX module's: the FM term and the tower in
`compute_dtype`, the first-order sum and the logit in float32, dense features
concatenated before the flattened latent vectors.

Each module lists its `Dense` layers and raw params (`layers.Param`) under
their flax names (`flax_dense()`), which `convert.py` uses to carry weights
across. flax numbers unnamed layers of one class in the order they are
created; a layer created only when dense features come in (the linear term
over them, DCN's and DLRM's) shifts the numbers of the later ones. The
Criteo batches always have dense features, and `flax_dense()` lists that
layout unless the module has already run without them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..embedding import Embedding
from ..initializers import CombinedFirstOrder, Normal, Zeros
from ..layers import Dense, Param
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


def _dense_linear(layer: Dense, dense: torch.Tensor, cd) -> torch.Tensor:
    """The linear term over the dense features -> (B,) float32."""
    return layer(dense.to(cd))[..., 0].to(torch.float32)


class LogisticRegression(nn.Module):
    """Wide-only model: the sum of the per-field first-order weights, a
    linear term over the dense features and a bias."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear = Dense(1, compute_dtype)           # flax Dense_0
        self.bias = Param("zeros")                      # flax "bias"

    def forward(self, embedded, dense):
        w, _ = _split_first_order(embedded)
        logit = torch.sum(w.to(torch.float32), dim=-1)
        if dense is not None:
            logit = logit + _dense_linear(self.linear, dense,
                                          self.compute_dtype)
        return logit + self.bias((1,))[0]

    def flax_dense(self) -> Dict[str, nn.Module]:
        return {"Dense_0": self.linear, "bias": self.bias}


class WideDeep(nn.Module):
    """Wide & Deep: wide = first-order weights + a linear term over the dense
    features; deep = an MLP over [dense features, flattened latent
    vectors]."""

    def __init__(self, hidden: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        self.linear = Dense(1, compute_dtype)          # flax Dense_0
        self.mlp = MLP(self.hidden + (1,), compute_dtype=compute_dtype)

    def forward(self, embedded, dense):
        w, v = _split_first_order(embedded)   # (B,F), (B,F,d)
        wide = torch.sum(w.to(torch.float32), dim=-1)
        feats = v.reshape(v.shape[0], -1)
        if dense is not None:
            # the dense features join in the table's dtype, as in the JAX
            # module; the tower casts to compute_dtype
            feats = torch.cat([dense.to(v.dtype), feats], dim=-1)
            wide = wide + _dense_linear(self.linear, dense,
                                        self.compute_dtype)
        deep = self.mlp(feats)
        return wide + deep[..., 0].to(torch.float32)

    def flax_dense(self) -> Dict[str, nn.Module]:
        return {"Dense_0": self.linear, **self.mlp.flax_dense("MLP_0/")}


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


class XDeepFM(nn.Module):
    """xDeepFM: linear + CIN (compressed interaction network) + DNN.
    CIN layer k: z = x^{k-1} (outer product over fields) x^0, contracted by
    the layer's (h, H_{k-1}, F) weights."""

    def __init__(self, hidden: Sequence[int] = (400, 400),
                 cin_layers: Sequence[int] = (128, 128),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.cin_layers = tuple(cin_layers)
        self.compute_dtype = compute_dtype
        self.cin = nn.ModuleList(Param("glorot_uniform")
                                 for _ in self.cin_layers)  # cin_<li>
        self.cin_out = Dense(1, compute_dtype)          # flax Dense_0
        self.linear = Dense(1, compute_dtype)           # flax Dense_1
        self.mlp = MLP(self.hidden + (1,), compute_dtype=compute_dtype)

    def forward(self, embedded, dense):
        cd = self.compute_dtype
        w, v = _split_first_order(embedded)
        linear = torch.sum(w.to(torch.float32), dim=-1)
        x0 = v.to(cd)                                   # (B, F, d)
        xk = x0
        cin_outs = []
        for h, param in zip(self.cin_layers, self.cin):
            wmat = param((h, xk.shape[1], x0.shape[1])).to(cd)
            # (B, Hk, d) x (B, F, d) -> (B, Hk, F, d), contracted by W
            z = xk[:, :, None, :] * x0[:, None, :, :]
            xk = torch.einsum("bhfd,nhf->bnd", z, wmat)
            cin_outs.append(torch.sum(xk, dim=-1))      # (B, h)
        cin = torch.cat(cin_outs, dim=-1)
        cin_logit = self.cin_out(cin)[..., 0]
        feats = x0.reshape(x0.shape[0], -1)
        if dense is not None:
            feats = torch.cat([dense.to(cd), feats], dim=-1)
            linear = linear + _dense_linear(self.linear, dense, cd)
        deep = self.mlp(feats)
        return (linear + cin_logit.to(torch.float32)
                + deep[..., 0].to(torch.float32))

    def flax_dense(self) -> Dict[str, nn.Module]:
        return {**{f"cin_{li}": p for li, p in enumerate(self.cin)},
                "Dense_0": self.cin_out, "Dense_1": self.linear,
                **self.mlp.flax_dense("MLP_0/")}


def _with_dense(dense_only: nn.Module, always: nn.Module,
                hint: Optional[bool] = None) -> bool:
    """Whether the module's flax layout is the one with dense features:
    `hint` where a load read it off the names (`set_flax_layout`), else
    yes unless the layer made only for them is missing while a layer made
    in every call exists (the module ran or was loaded without them)."""
    if hint is not None:
        return hint
    return dense_only.materialized or not always.materialized


class _LazyWidthDense(Dense):
    """A `Dense` as wide as its input (DCN's cross layers,
    `nn.Dense(x0.shape[-1])`): its width is set at its first call."""

    def __init__(self, compute_dtype: torch.dtype):
        super().__init__(0, compute_dtype)

    def set_parameters(self, weight, bias) -> None:
        self.features = int(weight.shape[0])
        super().set_parameters(weight, bias)

    def forward(self, x):
        if self.weight is None:
            self.features = x.shape[-1]
        return super().forward(x)


class DCN(nn.Module):
    """DCNv2 (Deep & Cross Network): crosses x_{l+1} = x0 * (W x_l + b) +
    x_l beside an MLP, and a linear term from the first-order weights."""

    def __init__(self, hidden: Sequence[int] = (256, 128), num_cross: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.num_cross = num_cross
        self.compute_dtype = compute_dtype
        self.linear = Dense(1, compute_dtype)   # flax Dense_0 (dense only)
        self.cross = nn.ModuleList(_LazyWidthDense(compute_dtype)
                                   for _ in range(num_cross))  # cross_<li>
        self.mlp = MLP(self.hidden, activate_last=True,
                       compute_dtype=compute_dtype)
        self.out = Dense(1, compute_dtype)      # flax Dense_1 (Dense_0)
        self.flax_with_dense: Optional[bool] = None

    def forward(self, embedded, dense):
        cd = self.compute_dtype
        w, v = _split_first_order(embedded)                 # (B,F), (B,F,d)
        linear = torch.sum(w.to(torch.float32), dim=-1)
        x0 = v.reshape(v.shape[0], -1).to(cd)
        if dense is not None:
            x0 = torch.cat([dense.to(cd), x0], dim=-1)
            linear = linear + _dense_linear(self.linear, dense, cd)
        xk = x0
        for layer in self.cross:
            xk = x0 * layer(xk) + xk
        deep = self.mlp(x0)
        both = torch.cat([xk, deep], dim=-1)
        return linear + self.out(both)[..., 0].to(torch.float32)

    def flax_dense(self) -> Dict[str, nn.Module]:
        out = {f"cross_{li}": c for li, c in enumerate(self.cross)}
        out.update(self.mlp.flax_dense("MLP_0/"))
        if _with_dense(self.linear, self.out, self.flax_with_dense):
            return {"Dense_0": self.linear, **out, "Dense_1": self.out}
        return {**out, "Dense_0": self.out}

    def set_flax_layout(self, names) -> None:
        """The layout of flat flax names about to load into a module that
        may never have run (`convert.dense_from_flax`): with dense features
        iff the output layer is `Dense_1`."""
        self.flax_with_dense = any(n.startswith("Dense_1/") for n in names)


class DLRM(nn.Module):
    """DLRM: a bottom MLP over the dense features (its last layer `dim`
    wide), the pairwise dot products of its output and the field
    embeddings (upper triangle, row-major as `jnp.triu_indices`), a top
    MLP. `dim` is the latent width, which the flax module reads off its
    input."""

    def __init__(self, bottom: Sequence[int] = (512, 256),
                 top: Sequence[int] = (512, 256), dim: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.bottom_mlp = MLP(tuple(bottom) + (dim,), activate_last=True,
                              compute_dtype=compute_dtype)
        self.top_mlp = MLP(tuple(top) + (1,), compute_dtype=compute_dtype)
        self.flax_with_dense: Optional[bool] = None

    def forward(self, embedded, dense):
        _, v = _split_first_order(embedded)   # (B, F, d)
        feats = v.to(self.compute_dtype)
        bot = None
        if dense is not None:
            bot = self.bottom_mlp(dense)
            feats = torch.cat([bot[:, None, :], feats], dim=1)  # (B, F+1, d)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        f = feats.shape[1]
        iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
        # index_select of unique columns: its backward adds each gradient
        # once, so it is the same on every run (advanced indexing's
        # backward accumulates with atomics on the card)
        flat = torch.index_select(inter.reshape(inter.shape[0], f * f), 1,
                                  iu * f + ju)             # (B, f(f-1)/2)
        top_in = torch.cat([bot, flat], dim=-1) if bot is not None else flat
        return self.top_mlp(top_in)[..., 0].to(torch.float32)

    def flax_dense(self) -> Dict[str, nn.Module]:
        if _with_dense(self.bottom_mlp.layers[0], self.top_mlp.layers[0],
                       self.flax_with_dense):
            return {**self.bottom_mlp.flax_dense("MLP_0/"),
                    **self.top_mlp.flax_dense("MLP_1/")}
        return self.top_mlp.flax_dense("MLP_0/")

    def set_flax_layout(self, names) -> None:
        """The layout of flat flax names about to load (see
        `DCN.set_flax_layout`): with dense features iff a second MLP
        (`MLP_1`, the top one) is there."""
        self.flax_with_dense = any(n.startswith("MLP_1/") for n in names)


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


def _make(module: nn.Module, *, vocabulary: int, dim: int, hashed: bool,
          capacity: int, num_shards: int, optimizer, config: dict,
          first_order: str = "fold") -> EmbeddingModel:
    embs = _categorical_embedding(vocabulary, dim, hashed=hashed,
                                  capacity=capacity, num_shards=num_shards,
                                  optimizer=optimizer,
                                  split=first_order == "split")
    return EmbeddingModel(module, embs, loss_fn=binary_logloss,
                          config=config)


def make_lr(vocabulary: int, *, hashed: bool = False, capacity: int = 0,
            num_shards: int = -1, optimizer=None,
            compute_dtype=torch.bfloat16) -> EmbeddingModel:
    # dim 0: the folded table is just the 1-wide first-order weight
    return _make(LogisticRegression(compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=0, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 config=_config("lr", compute_dtype, vocabulary=vocabulary,
                                hashed=hashed, capacity=capacity,
                                num_shards=num_shards))


def make_wdl(vocabulary: int, dim: int = 9, *, hidden=(256, 128),
             hashed: bool = False, capacity: int = 0, num_shards: int = -1,
             optimizer=None, compute_dtype=torch.bfloat16,
             first_order: str = "auto") -> EmbeddingModel:
    fo = _first_order_mode(first_order, dim)
    return _make(WideDeep(hidden=hidden, compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=dim, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 first_order=fo,
                 config=_config("wdl", compute_dtype, vocabulary=vocabulary,
                                dim=dim, hidden=list(hidden), hashed=hashed,
                                capacity=capacity, num_shards=num_shards,
                                first_order=fo))


def make_deepfm(vocabulary: int, dim: int = 9, *, hidden=(400, 400, 400),
                hashed: bool = False, capacity: int = 0, num_shards: int = -1,
                optimizer=None, compute_dtype=torch.bfloat16,
                first_order: str = "auto") -> EmbeddingModel:
    fo = _first_order_mode(first_order, dim)
    return _make(DeepFM(hidden=hidden, compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=dim, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 first_order=fo,
                 config=_config("deepfm", compute_dtype, vocabulary=vocabulary,
                                dim=dim, hidden=list(hidden), hashed=hashed,
                                capacity=capacity, num_shards=num_shards,
                                first_order=fo))


def make_xdeepfm(vocabulary: int, dim: int = 9, *, hidden=(400, 400),
                 cin_layers=(128, 128), hashed: bool = False,
                 capacity: int = 0, num_shards: int = -1, optimizer=None,
                 compute_dtype=torch.bfloat16,
                 first_order: str = "auto") -> EmbeddingModel:
    fo = _first_order_mode(first_order, dim)
    return _make(XDeepFM(hidden=hidden, cin_layers=cin_layers,
                         compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=dim, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 first_order=fo,
                 config=_config("xdeepfm", compute_dtype,
                                vocabulary=vocabulary, dim=dim,
                                hidden=list(hidden),
                                cin_layers=list(cin_layers), hashed=hashed,
                                capacity=capacity, num_shards=num_shards,
                                first_order=fo))


def make_dcn(vocabulary: int, dim: int = 9, *, hidden=(256, 128),
             num_cross: int = 3, hashed: bool = False, capacity: int = 0,
             num_shards: int = -1, optimizer=None,
             compute_dtype=torch.bfloat16,
             first_order: str = "auto") -> EmbeddingModel:
    fo = _first_order_mode(first_order, dim)
    return _make(DCN(hidden=hidden, num_cross=num_cross,
                     compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=dim, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 first_order=fo,
                 config=_config("dcn", compute_dtype, vocabulary=vocabulary,
                                dim=dim, hidden=list(hidden),
                                num_cross=num_cross, hashed=hashed,
                                capacity=capacity, num_shards=num_shards,
                                first_order=fo))


def make_dlrm(vocabulary: int, dim: int = 16, *, bottom=(512, 256),
              top=(512, 256), hashed: bool = False, capacity: int = 0,
              num_shards: int = -1, optimizer=None,
              compute_dtype=torch.bfloat16) -> EmbeddingModel:
    return _make(DLRM(bottom=bottom, top=top, dim=dim,
                      compute_dtype=compute_dtype),
                 vocabulary=vocabulary, dim=dim, hashed=hashed,
                 capacity=capacity, num_shards=num_shards, optimizer=optimizer,
                 config=_config("dlrm", compute_dtype, vocabulary=vocabulary,
                                dim=dim, bottom=list(bottom), top=list(top),
                                hashed=hashed, capacity=capacity,
                                num_shards=num_shards))
