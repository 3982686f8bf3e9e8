"""Model zoo of the port: the CTR families of the JAX package's zoo (LR,
Wide&Deep, DeepFM, xDeepFM, DCN, DLRM). The sequence models and the two-tower
retrieval model are queued in ROADMAP.md."""

import torch

from .ctr import (MLP, DCN, DLRM, DeepFM, LogisticRegression, WideDeep,
                  XDeepFM, CRITEO_NUM_DENSE, CRITEO_NUM_SPARSE, make_dcn,
                  make_deepfm, make_dlrm, make_lr, make_wdl, make_xdeepfm)

_FAMILIES = {"lr": make_lr, "wdl": make_wdl, "deepfm": make_deepfm,
             "xdeepfm": make_xdeepfm, "dcn": make_dcn, "dlrm": make_dlrm}
# families of the JAX package's zoo that the port does not have yet
_NOT_PORTED = ("two_tower", "sasrec", "bert4rec")
# config keys that hold layer widths (JSON lists -> tuples)
_WIDTHS = ("hidden", "cin_layers", "bottom", "top")


def from_config(config: dict, **overrides):
    """Rebuild a zoo model from its `EmbeddingModel.config` recipe (the
    export's `model_config.json`, written by either package)."""
    cfg = dict(config)
    cfg.pop("serving_overrides", None)
    cfg.update(overrides)
    family = cfg.pop("family")
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (see ROADMAP.md)")
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
           "CRITEO_NUM_SPARSE", "CRITEO_NUM_DENSE"]
