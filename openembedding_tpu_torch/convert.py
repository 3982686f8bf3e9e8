"""Carry weights between the flax layout and the port's modules.

Dense params travel as flat flax-named arrays (`Dense_0/kernel`,
`MLP_0/Dense_2/bias`, ...), the content of an export's `dense_params.npz`.
flax kernels are (in, out); the port's `Dense.weight` is (out, in).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flax_dense(module: nn.Module):
    fn = getattr(module, "flax_dense", None)
    if fn is None:
        raise TypeError(f"{type(module).__name__} does not list its flax "
                        "names (no flax_dense())")
    return fn()


def dense_from_flax(flat: Mapping[str, np.ndarray], module: nn.Module) -> None:
    """Load flax-named flat params into `module` (on its current device, or
    the CPU for a module with no parameters yet). Every key must name a
    layer of the module; layers with no key stay as they are."""
    layers = _flax_dense(module)
    by_layer: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        path, _, leaf = key.rpartition("/")
        if path not in layers or leaf not in ("kernel", "bias"):
            raise KeyError(f"flax param {key!r} has no counterpart in "
                           f"{type(module).__name__} (layers: "
                           f"{sorted(layers)})")
        by_layer.setdefault(path, {})[leaf] = np.asarray(value)
    device = next((p.device for p in module.parameters()),
                  torch.device("cpu"))
    for path, leaves in by_layer.items():
        if set(leaves) != {"kernel", "bias"}:
            raise KeyError(f"flax layer {path!r} needs both kernel and bias")
        kernel = torch.tensor(leaves["kernel"], dtype=torch.float32)
        bias = torch.tensor(leaves["bias"], dtype=torch.float32)
        layers[path].set_parameters(kernel.t().to(device), bias.to(device))


def dense_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's materialized `Dense` layers as flat flax-named float32
    arrays: kernels (in, out), biases (out,)."""
    out = {}
    for path, layer in _flax_dense(module).items():
        if not layer.materialized:
            continue
        out[f"{path}/kernel"] = layer.weight.detach().t().contiguous().cpu(
        ).numpy()
        out[f"{path}/bias"] = layer.bias.detach().cpu().numpy()
    return out


def tables_from_numpy(arrays: Mapping[str, np.ndarray], *, device
                      ) -> Dict[str, torch.Tensor]:
    """Table weights -> contiguous tensors on `device`. float32 tables keep
    their dtype; 2-byte bfloat16 tables (numpy has no bfloat16, so they
    arrive as a 2-byte void or ml_dtypes array) are reinterpreted bit for
    bit."""
    out = {}
    for name, arr in arrays.items():
        arr = np.require(arr, requirements=["C", "W"])  # copies only if needed
        if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                        or arr.dtype.name == "bfloat16"):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device).contiguous()
    return out
