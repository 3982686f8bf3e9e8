"""Model zoo of the port. Slice 1 ports DeepFM; the other families of the
JAX package's zoo are queued in ROADMAP.md."""

import torch

from .ctr import (MLP, DeepFM, make_deepfm, CRITEO_NUM_SPARSE,
                  CRITEO_NUM_DENSE)

_FAMILIES = {"deepfm": make_deepfm}
# families of the JAX package's zoo that the port does not have yet
_NOT_PORTED = ("lr", "wdl", "xdeepfm", "dcn", "dlrm", "two_tower", "sasrec",
               "bert4rec")

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
    if "hidden" in cfg:
        cfg["hidden"] = tuple(cfg["hidden"])
    return _FAMILIES[family](**cfg)


__all__ = ["MLP", "DeepFM", "make_deepfm", "from_config",
           "CRITEO_NUM_SPARSE", "CRITEO_NUM_DENSE"]
