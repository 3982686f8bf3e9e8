"""Model zoo of the port: the nine families of the JAX package's zoo — the
CTR families (LR, Wide&Deep, DeepFM, xDeepFM, DCN, DLRM), the two-tower
retrieval model and the sequential recommenders (SASRec, BERT4Rec)."""

import torch

from .ctr import (MLP, DCN, DLRM, DeepFM, LogisticRegression, WideDeep,
                  XDeepFM, CRITEO_NUM_DENSE, CRITEO_NUM_SPARSE, make_dcn,
                  make_deepfm, make_dlrm, make_lr, make_wdl, make_xdeepfm)
from .sequential import (SASRec, bert4rec_mask_id, make_bert4rec,
                         make_sasrec, sasrec_bce_loss,
                         synthetic_masked_sequences, synthetic_sequences)
from .two_tower import TwoTower, in_batch_softmax_loss, make_two_tower

_FAMILIES = {"lr": make_lr, "wdl": make_wdl, "deepfm": make_deepfm,
             "xdeepfm": make_xdeepfm, "dcn": make_dcn, "dlrm": make_dlrm,
             "two_tower": make_two_tower, "sasrec": make_sasrec,
             "bert4rec": make_bert4rec}
# config keys that hold layer widths (JSON lists -> tuples)
_WIDTHS = ("hidden", "cin_layers", "bottom", "top", "tower")


def from_config(config: dict, **overrides):
    """Rebuild a zoo model from its `EmbeddingModel.config` recipe (the
    export's `model_config.json`, written by either package); the recipe's
    `serving_overrides` are the caller's to apply (`export.py`)."""
    cfg = dict(config)
    cfg.pop("serving_overrides", None)
    cfg.update(overrides)
    family = cfg.pop("family")
    if family not in _FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    cfg["compute_dtype"] = getattr(torch, cfg.get("compute_dtype", "bfloat16"))
    for key in _WIDTHS:
        if key in cfg:
            cfg[key] = tuple(cfg[key])
    return _FAMILIES[family](**cfg)


__all__ = ["MLP", "LogisticRegression", "WideDeep", "DeepFM", "XDeepFM",
           "DCN", "DLRM", "make_lr", "make_wdl", "make_deepfm",
           "make_xdeepfm", "make_dcn", "make_dlrm", "from_config",
           "TwoTower", "make_two_tower", "in_batch_softmax_loss",
           "SASRec", "make_sasrec", "sasrec_bce_loss", "synthetic_sequences",
           "make_bert4rec", "bert4rec_mask_id", "synthetic_masked_sequences",
           "CRITEO_NUM_SPARSE", "CRITEO_NUM_DENSE"]
