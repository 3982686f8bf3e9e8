"""Datatype and model metadata, JSON round-trip.

Port of `openembedding_tpu/meta.py`: the same dataclasses read and write the
same `model_meta` JSON; the dtype registry maps names onto torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import numpy as np
import torch

# Format version of the offline (checkpoint) metadata layout; shared with the
# JAX package so either one reads the other's files.
META_FORMAT_VERSION = "tpu-1"

# Vocabulary sizes at or above this threshold (or input_dim == -1 in the layer
# API) mean "ids are 63-bit hashes; use a hash-table variable".
HASH_VOCABULARY_THRESHOLD = 1 << 63


class DataType:
    """String-keyed dtype registry."""

    _TABLE = {
        "int8": torch.int8,
        "int16": torch.int16,
        "int32": torch.int32,
        "int64": torch.int64,
        "float32": torch.float32,
        "float64": torch.float64,
        "bfloat16": torch.bfloat16,
    }

    def __init__(self, name: str):
        name = str(np.dtype(name)) if name not in self._TABLE else name
        if name not in self._TABLE:
            raise ValueError(f"unsupported datatype: {name!r}")
        self.name = name

    @property
    def torch_dtype(self) -> torch.dtype:
        return self._TABLE[self.name]

    def __eq__(self, other):
        return isinstance(other, DataType) and other.name == self.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DataType({self.name})"


@dataclasses.dataclass
class EmbeddingVariableMeta:
    """Shape/dtype meta of one embedding variable."""

    datatype: str = "float32"
    embedding_dim: int = 0
    vocabulary_size: int = 0  # -1 or >= 2**63 means hashed 63-bit id space

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EmbeddingVariableMeta":
        return cls(**{k: d[k] for k in
                      ("datatype", "embedding_dim", "vocabulary_size") if k in d})


@dataclasses.dataclass
class ModelVariableMeta:
    """Per-variable entry of a model meta: meta + variable_id + storage_name,
    plus the config dumps a restore needs."""

    variable_id: int = 0
    storage_name: str = ""
    meta: EmbeddingVariableMeta = dataclasses.field(
        default_factory=EmbeddingVariableMeta)
    optimizer: dict = dataclasses.field(default_factory=dict)
    initializer: dict = dataclasses.field(default_factory=dict)
    table: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelVariableMeta":
        d = dict(d)
        d["meta"] = EmbeddingVariableMeta.from_dict(d.get("meta", {}))
        return cls(**{k: d[k] for k in
                      ("variable_id", "storage_name", "meta", "optimizer",
                       "initializer", "table") if k in d})


@dataclasses.dataclass
class ModelMeta:
    """Model meta written at the root of an export or checkpoint."""

    model_sign: str = ""
    version: str = META_FORMAT_VERSION
    status: str = "NORMAL"
    uri: str = ""
    error: str = ""
    num_shards: int = 1
    variables: List[ModelVariableMeta] = dataclasses.field(default_factory=list)
    # dense (non-embedding) param manifest: name -> {shape, dtype}
    dense_manifest: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ModelMeta":
        d = json.loads(s)
        out = cls(
            model_sign=d.get("model_sign", ""),
            version=d.get("version", META_FORMAT_VERSION),
            status=d.get("status", "NORMAL"),
            uri=d.get("uri", ""),
            error=d.get("error", ""),
            num_shards=d.get("num_shards", 1),
            variables=[ModelVariableMeta.from_dict(v)
                       for v in d.get("variables", [])],
            dense_manifest=d.get("dense_manifest", {}),
        )
        if out.version != META_FORMAT_VERSION:
            raise ValueError(
                f"checkpoint meta version {out.version!r} != supported "
                f"{META_FORMAT_VERSION!r}")
        return out
