"""Embedding-row initializers.

Port of `openembedding_tpu/initializers.py`. Each initializer is a function
(generator, shape, dtype) -> tensor that draws from an explicit
`torch.Generator` and creates the tensor on that generator's device. The
draws match the JAX versions in distribution, not draw for draw: the two
frameworks' generators give different numbers from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Type

import torch

_REGISTRY: Dict[str, Type["Initializer"]] = {}


def _register(cls):
    _REGISTRY[cls.category] = cls
    return cls


class Initializer:
    category = ""

    def __call__(self, generator: torch.Generator, shape,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def to_config(self) -> dict:
        d = dataclasses.asdict(self)
        d["category"] = self.category
        return d


def _normal(generator, shape, dtype):
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)


@_register
@dataclasses.dataclass
class Constant(Initializer):
    category = "constant"
    value: float = 0.0

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=generator.device)


def Zeros() -> Constant:
    return Constant(0.0)


def Ones() -> Constant:
    return Constant(1.0)


@_register
@dataclasses.dataclass
class Uniform(Initializer):
    category = "uniform"
    minval: float = -0.05
    maxval: float = 0.05

    def __call__(self, generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
        return out.uniform_(self.minval, self.maxval, generator=generator)


@_register
@dataclasses.dataclass
class Normal(Initializer):
    category = "normal"
    mean: float = 0.0
    stddev: float = 0.05

    def __call__(self, generator, shape, dtype=torch.float32):
        return self.mean + self.stddev * _normal(generator, shape, dtype)


@_register
@dataclasses.dataclass
class TruncatedNormal(Initializer):
    """Truncated at 2 sigma, like `jax.random.truncated_normal(key, -2, 2)`."""

    category = "truncated_normal"
    mean: float = 0.0
    stddev: float = 0.05

    def __call__(self, generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return self.mean + self.stddev * out


@_register
@dataclasses.dataclass
class CombinedFirstOrder(Initializer):
    """For the model zoo's combined tables (col 0 = first-order weight, cols
    1..dim = latent vector): column 0 starts at zero, the latent columns
    ~ N(mean, stddev)."""

    category = "combined_first_order"
    mean: float = 0.0
    stddev: float = 1e-4

    def __call__(self, generator, shape, dtype=torch.float32):
        out = self.mean + self.stddev * _normal(generator, shape, dtype)
        out[..., 0] = 0.0
        return out


def make_initializer(config: dict) -> Initializer:
    """Build from a {category, **params} config dict (Keras class names are
    accepted as aliases, as in the JAX package)."""
    config = dict(config)
    category = config.pop("category")
    aliases = {
        "RandomNormal": "normal", "random_normal": "normal",
        "RandomUniform": "uniform", "random_uniform": "uniform",
        "Constant": "constant", "Zeros": "constant", "zeros": "constant",
        "Ones": "constant", "ones": "constant",
        "TruncatedNormal": "truncated_normal",
        "truncated_normal": "truncated_normal",
    }
    category = aliases.get(category, category)
    if category == "constant" and config.pop("__ones__", False):
        config.setdefault("value", 1.0)
    cls = _REGISTRY.get(category)
    if cls is None:
        raise ValueError(f"unknown initializer category {category!r}")
    return cls(**config)
