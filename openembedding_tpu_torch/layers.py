"""`Dense`: the port's counterpart of flax's `nn.Dense`.

A flax layer learns its input width from the first batch it sees (`init`);
`Dense` does the same: its parameters are created by `materialize` (from a
sample forward pass, with an explicit generator) or by loading weights
(`convert.dense_from_flax`), and a forward before either raises.

Numerics follow `nn.Dense(features, dtype=compute_dtype,
param_dtype=float32)`: parameters are stored in float32, and the input, the
kernel and the bias are cast to `compute_dtype`; the product is rounded to
`compute_dtype` before the bias is added, as flax does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Dense(nn.Module):
    """Linear layer y = x W^T + b with flax's lazy input width.

    `weight` is (out, in), PyTorch's layout; `convert.py` transposes to and
    from flax's (in, out) kernels."""

    def __init__(self, features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)
        self._generator: Optional[torch.Generator] = None

    @property
    def materialized(self) -> bool:
        return self.weight is not None

    def set_parameters(self, weight: torch.Tensor, bias: torch.Tensor) -> None:
        """Install (out, in) float32 weights and an (out,) bias."""
        if weight.shape[0] != self.features or bias.shape != (self.features,):
            raise ValueError(
                f"Dense({self.features}): got weight {tuple(weight.shape)} "
                f"and bias {tuple(bias.shape)}")
        self.weight = nn.Parameter(weight.to(torch.float32).contiguous())
        self.bias = nn.Parameter(bias.to(torch.float32).contiguous())

    def init_parameters(self, in_features: int,
                        generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal kernel (truncated normal at 2 sigma,
        variance 1/fan_in, rescaled for the truncation), zero bias."""
        std = math.sqrt(1.0 / in_features) / .87962566103423978
        w = torch.empty((self.features, in_features), dtype=torch.float32,
                        device=generator.device)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.set_parameters(w, torch.zeros(self.features, dtype=torch.float32,
                                           device=generator.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            if self._generator is None:
                raise RuntimeError(
                    "Dense layer has no parameters: call layers.materialize "
                    "or load weights with convert.dense_from_flax first")
            self.init_parameters(x.shape[-1], self._generator)
        cd = self.compute_dtype
        y = torch.matmul(x.to(cd), self.weight.to(cd).t())
        return y + self.bias.to(cd)


@torch.no_grad()
def materialize(module: nn.Module, *args, generator: torch.Generator,
                **kwargs) -> None:
    """Create every `Dense` parameter of `module` from one sample forward
    pass (the counterpart of flax's `module.init(key, *args)`), drawing from
    `generator` in call order."""
    dense = [m for m in module.modules() if isinstance(m, Dense)]
    for m in dense:
        m._generator = generator
    try:
        module(*args, **kwargs)
    finally:
        for m in dense:
            m._generator = None
