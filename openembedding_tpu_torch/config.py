"""Layered, typed configuration tree (port of `openembedding_tpu/config.py`:
the same keys, defaults, checks and unknown-key warnings).

The reference's config stack: Python `Flags` (`openembedding/__init__.py:
33-40`) -> YAML string -> `core::Configure` -> typed `EnvConfig` with
per-field defaults, checkers and docs (`client/EnvConfig.h/.cpp`), plus the
per-variable nested configs with unknown-key warnings
(`variable/Factory.h:35-111`).

Most of the reference's `rpc`/`master` knobs (TCP/RDMA, ZooKeeper,
compression) mean nothing here: `torch.distributed` plays the master role
and NCCL or gloo carry the traffic. The tree keeps the JAX package's knobs
under its names, so one YAML file configures either package.
"""

from __future__ import annotations

import dataclasses
import logging
import typing
import warnings
from typing import Any, Dict, Optional

import yaml

logger = logging.getLogger("openembedding_tpu")


class ConfigNode:
    """Dataclass mixin: build from a dict, warning on unknown keys.

    Mirrors the reference's `Configurable::load_config` unknown-key warnings
    (`variable/Factory.h:85-111`).
    """

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]):
        d = dict(d or {})
        field_names = {f.name for f in dataclasses.fields(cls)}
        # resolve string annotations (PEP 563) to real types for nested nodes
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for key, value in d.items():
            if key not in field_names:
                warnings.warn(f"{cls.__name__}: unknown config key {key!r} ignored")
                continue
            ftype = hints.get(key)
            if isinstance(value, dict) and isinstance(ftype, type) and issubclass(ftype, ConfigNode):
                value = ftype.from_dict(value)
            kwargs[key] = value
        out = cls(**kwargs)
        out.check()
        return out

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def check(self) -> None:
        """Override to validate field values (reference: EnvConfig checkers)."""


@dataclasses.dataclass
class MeshConfig(ConfigNode):
    """How to lay out the mesh.

    Replaces the reference's process-role topology (master/servers/workers,
    `EnvConfig.h`): one process per rank over `torch.distributed`. The `data`
    axis carries data parallelism of the dense part (the reference's Horovod
    ranks); embedding rows are sharded over all ranks (the reference's PS
    shard axis).
    """

    axis_data: str = "data"     # DP axis name (dense grads psum over this)
    axis_model: str = "model"   # optional second axis for very large tables / MP dense
    num_model_shards: int = 1   # size of the model axis; 1 = pure DP mesh

    def check(self):
        if self.num_model_shards < 1:
            raise ValueError("num_model_shards must be >= 1")


@dataclasses.dataclass
class ServerConfig(ConfigNode):
    """Embedding-engine knobs (reference: `EnvConfig.h` server section).

    - reference `cache_size` (DRAM cache MB) -> `pull_capacity_factor`: static per-step
      unique-id buffer headroom under static shapes (CUDA graphs).
    - reference `server_concurrency` -> obviated (the card's streams schedule).
    - reference `update_early_return` -> obviated (no RPC; async launches do this).
    - reference `message_compress` -> obviated (the mesh's `wire=` formats).
    """

    pull_capacity_factor: float = 1.0  # unique-id buffer = factor * batch_ids
    default_num_shards: int = -1       # -1 = all mesh devices (reference default: #servers)
    report_interval: int = -1          # seconds between accumulator reports; <=0 = off


@dataclasses.dataclass
class CheckpointConfig(ConfigNode):
    """(reference: `server_dump_files`, pmem persist knobs, `c_api.cc:295-328`)."""

    files_per_shard: int = 1
    include_optimizer: bool = True
    persist_pending_window: int = 2   # async-persist window (pmem equivalent)


@dataclasses.dataclass
class EnvConfig(ConfigNode):
    """Root config tree (reference: `client/EnvConfig.h` Env root)."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)

    @classmethod
    def from_yaml(cls, text: str) -> "EnvConfig":
        return cls.from_dict(yaml.safe_load(text) or {})

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


class Flags:
    """Process-level flags singleton (reference: `openembedding/__init__.py:33-40`).

    The reference's `master_endpoint`/`bind_ip`/`num_workers`/`wait_num_servers` describe
    a multi-process cluster; here they map to `torch.distributed` initialization
    (`parallel.multihost.initialize`, or torchrun's environment) or nothing (one
    process). Kept: `config` (yaml path or string).
    """

    def __init__(self):
        self.config: str = ""
        self._env: Optional[EnvConfig] = None

    @property
    def env(self) -> EnvConfig:
        if self._env is None:
            if self.config:
                try:
                    with open(self.config) as f:
                        text = f.read()
                except (OSError, IOError):
                    text = self.config  # allow inline yaml string like the reference
                self._env = EnvConfig.from_yaml(text)
            else:
                self._env = EnvConfig()
        return self._env

    def reset(self):
        self.config = ""
        self._env = None


flags = Flags()
