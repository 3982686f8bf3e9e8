"""Row gather: the port of `openembedding_tpu/ops/pallas_sparse.py::gather_rows`.

`gather_rows(weights, rows, valid)` returns `out[i] = weights[rows[i]]` where
`0 <= rows[i] < n_rows` and `valid[i]`, and +0.0 rows everywhere else.

On a CUDA tensor it launches the hand-written kernel `csrc/gather_rows.cu`
(built on first use by `ops/_build.py`); on a CPU tensor it runs the plain
PyTorch version `gather_rows_reference`. Nothing else picks between them:
a CUDA launch that fails raises, it never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

KERNEL = "gather_rows"
# launches of the CUDA kernel, counted by the wrapper where it launches
LAUNCHES = {"gather_rows": 0}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently

_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)
_MASK_DTYPES = (torch.bool, torch.uint8)


def gather_rows_reference(weights: torch.Tensor, rows: torch.Tensor,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: clamp, index, then mask with
    `torch.where`. Bit-equal to the kernel (both copy rows unchanged)."""
    n_rows, dim = weights.shape
    ok = (rows >= 0) & (rows < n_rows)
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    if n_rows == 0:
        return torch.zeros((rows.shape[0], dim), dtype=weights.dtype,
                           device=weights.device)
    out = weights[rows.clamp(0, n_rows - 1).long()]
    return torch.where(ok[:, None], out, torch.zeros((), dtype=weights.dtype,
                                                     device=weights.device))


def _check(weights, rows, valid) -> None:
    if weights.dim() != 2:
        raise ValueError(f"gather_rows: weights must be 2-D, got shape "
                         f"{tuple(weights.shape)}")
    if weights.dtype not in _TABLE_DTYPES:
        raise TypeError(f"gather_rows: table dtype {weights.dtype} is not "
                        "float32 or bfloat16")
    if rows.dim() != 1:
        raise ValueError(f"gather_rows: rows must be 1-D, got shape "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in _ID_DTYPES:
        raise TypeError(f"gather_rows: id dtype {rows.dtype} is not int32 "
                        "or int64")
    tensors = [weights, rows]
    if valid is not None:
        if valid.shape != rows.shape:
            raise ValueError(f"gather_rows: valid has shape "
                             f"{tuple(valid.shape)}, rows {tuple(rows.shape)}")
        if valid.dtype not in _MASK_DTYPES:
            raise TypeError(f"gather_rows: mask dtype {valid.dtype} is not "
                            "bool or uint8")
        tensors.append(valid)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"gather_rows: inputs on several devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_rows: inputs must be contiguous")


def gather_rows(weights: torch.Tensor, rows: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather table rows; out-of-range and masked-out ids give zero rows.

    weights (n_rows, dim) float32/bfloat16; rows (n,) int32/int64; valid
    (n,) bool/uint8 or None -> (n, dim) in the table's dtype."""
    _check(weights, rows, valid)
    if weights.device.type == "cpu":
        return gather_rows_reference(weights, rows, valid)
    if weights.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for device "
                         f"{weights.device}")
    n_rows, dim = weights.shape
    n = rows.shape[0]
    out = torch.empty((n, dim), dtype=weights.dtype, device=weights.device)
    if n * dim == 0:
        return out
    lib = _library()
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = lib.oe_gather_rows(
            weights.data_ptr(), n_rows, dim, weights.element_size(),
            rows.data_ptr(), rows.element_size(),
            valid.data_ptr() if valid is not None else None,
            n, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.oe_cuda_error_string(rc).decode()
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _COUNT_LOCK:
        LAUNCHES["gather_rows"] += 1
    return out


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits). When
    it loads, it reads each card's SM count and resident blocks, once, so
    that no launch queries the device (a launch may be captured)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load(KERNEL)
            lib.oe_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.oe_gather_rows.restype = ctypes.c_int
            lib.oe_gather_rows_init.argtypes = []
            lib.oe_gather_rows_init.restype = ctypes.c_int
            lib.oe_gather_rows_resident_blocks.argtypes = [ctypes.c_int,
                                                           ctypes.c_int]
            lib.oe_gather_rows_resident_blocks.restype = ctypes.c_int
            lib.oe_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oe_cuda_error_string.restype = ctypes.c_char_p
            for dev in range(torch.cuda.device_count()):
                with torch.cuda.device(dev):
                    rc = lib.oe_gather_rows_init()
                if rc != 0:
                    msg = lib.oe_cuda_error_string(rc).decode()
                    raise RuntimeError(f"gather_rows: reading card {dev}'s "
                                       f"occupancy failed: CUDA error {rc} "
                                       f"({msg})")
            _LIB = lib
    return _LIB
