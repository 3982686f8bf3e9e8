"""`Dense`, `LayerNorm` and `Param`: the port's counterparts of flax's
`nn.Dense`, `nn.LayerNorm` and of a raw `self.param`.

A flax layer learns its input width from the first batch it sees (`init`);
these layers do the same: their parameters are created by `materialize`
(from a sample forward pass, with an explicit generator) or by loading
weights (`convert.dense_from_flax`), and a forward before either raises.
`is_initializing()` is True inside `materialize`, as flax's
`Module.is_initializing()` is inside `init`.

Numerics follow `nn.Dense(features, dtype=compute_dtype,
param_dtype=float32)`: parameters are stored in float32, and the input, the
kernel and the bias are cast to `compute_dtype`; the product is rounded to
`compute_dtype` before the bias is added, as flax does.
"""

from __future__ import annotations

import copy
import math
import threading
from contextlib import contextmanager
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


class Param(nn.Module):
    """A raw float32 parameter (flax's `self.param(name, init, shape)`),
    created at its first use, whose shape the caller computes from its
    inputs. `init`: "zeros", "glorot_uniform" (flax's, on the last two
    axes: fan_in = shape[-2] * the receptive field, fan_out = shape[-1] *
    the receptive field, the receptive field the product of the leading
    axes) or "normal" (flax's `initializers.normal(stddev)`). Its flat flax
    name is the one its owner lists in `flax_dense()`; `convert.py` carries
    it across unchanged (same layout in both)."""

    def __init__(self, init: str, stddev: float = 1e-2):
        super().__init__()
        if init not in ("zeros", "glorot_uniform", "normal"):
            raise ValueError(f"unknown Param init {init!r}")
        self.init = init
        self.stddev = stddev
        self.register_parameter("value", None)
        self._generator: Optional[torch.Generator] = None

    @property
    def materialized(self) -> bool:
        return self.value is not None

    def set_value(self, value: torch.Tensor) -> None:
        self.value = nn.Parameter(value.to(torch.float32).contiguous())

    def init_value(self, shape, generator: torch.Generator) -> None:
        v = torch.zeros(shape, dtype=torch.float32, device=generator.device)
        if self.init == "glorot_uniform":
            receptive = math.prod(shape[:-2])
            fan_avg = (shape[-2] + shape[-1]) * receptive / 2
            limit = math.sqrt(3.0 / fan_avg)
            v.uniform_(-limit, limit, generator=generator)
        elif self.init == "normal":
            v.normal_(0.0, self.stddev, generator=generator)
        self.set_value(v)

    def forward(self, shape) -> torch.Tensor:
        shape = tuple(int(x) for x in shape)
        if self.value is None:
            if self._generator is None:
                raise RuntimeError(
                    "Param has no value: call layers.materialize or load "
                    "weights with convert.dense_from_flax first")
            self.init_value(shape, self._generator)
        if tuple(self.value.shape) != shape:
            raise ValueError(f"Param holds shape {tuple(self.value.shape)}, "
                             f"its use needs {shape}")
        return self.value


class LayerNorm(nn.Module):
    """flax 0.12's `nn.LayerNorm(dtype=compute_dtype)` over the last axis,
    with flax's defaults rather than torch's: epsilon 1e-6, the variance
    as E[x^2] - E[x]^2 clamped at 0 (`use_fast_variance`), the statistics
    and the normalization in float32 (`force_float32_reductions`), a
    float32 `scale` (`weight` here; ones) and `bias` (zeros), and the
    output cast to `compute_dtype`. `torch.nn.functional.layer_norm`
    (two-pass variance, eps 1e-5) is not that function."""

    def __init__(self, compute_dtype: torch.dtype, epsilon: float = 1e-6):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.epsilon = epsilon
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)
        self._generator: Optional[torch.Generator] = None

    @property
    def materialized(self) -> bool:
        return self.weight is not None

    def set_parameters(self, scale: torch.Tensor, bias: torch.Tensor) -> None:
        """Install the (features,) float32 scale and bias."""
        if scale.shape != bias.shape or scale.dim() != 1:
            raise ValueError(f"LayerNorm: got scale {tuple(scale.shape)} and "
                             f"bias {tuple(bias.shape)}")
        self.weight = nn.Parameter(scale.to(torch.float32).contiguous())
        self.bias = nn.Parameter(bias.to(torch.float32).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            if self._generator is None:
                raise RuntimeError(
                    "LayerNorm has no parameters: call layers.materialize "
                    "or load weights with convert.dense_from_flax first")
            dev = self._generator.device
            self.set_parameters(
                torch.ones(x.shape[-1], dtype=torch.float32, device=dev),
                torch.zeros(x.shape[-1], dtype=torch.float32, device=dev))
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        mu2 = torch.mean(xf * xf, dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mu) * mul + self.bias
        return y.to(self.compute_dtype)


def sqrt_f32(n: int, device) -> torch.Tensor:
    """sqrt(n) in float32 as a 0-d device tensor (`jnp.sqrt(float32(n))`):
    made by a fill, so a captured graph holds no host copy, and a division
    by it is a division (torch turns a division by a host scalar into a
    product with its reciprocal on the card)."""
    return torch.sqrt(torch.full((), float(n), dtype=torch.float32,
                                 device=device))


# the layers whose parameters `materialize` creates
_LAZY = (Dense, Param, LayerNorm)

_INIT = threading.local()


def is_initializing() -> bool:
    """True inside `materialize` (flax's `Module.is_initializing()`)."""
    return getattr(_INIT, "depth", 0) > 0


@contextmanager
def _initializing():
    _INIT.depth = getattr(_INIT, "depth", 0) + 1
    try:
        yield
    finally:
        _INIT.depth -= 1


def unmaterialized_copy(module: nn.Module) -> nn.Module:
    """A deep copy of `module` whose `Dense`, `LayerNorm` and `Param` layers
    hold no parameters, so that `materialize` draws them anew; `module`
    itself is left as it is, materialized or not. Any other tensor of the
    module is copied: the copy shares none with `module`."""
    memo = {id(p): None for m in module.modules()
            if isinstance(m, _LAZY)
            for p in m.parameters(recurse=False)}
    return copy.deepcopy(module, memo)


@torch.no_grad()
def materialize(module: nn.Module, *args, generator: torch.Generator,
                **kwargs) -> None:
    """Create every `Dense`, `LayerNorm` and `Param` parameter of `module`
    from one sample forward pass (the counterpart of flax's
    `module.init(key, *args)`), drawing from `generator` in call order."""
    lazy = [m for m in module.modules() if isinstance(m, _LAZY)]
    for m in lazy:
        m._generator = generator
    try:
        with _initializing():
            module(*args, **kwargs)
    finally:
        for m in lazy:
            m._generator = None
