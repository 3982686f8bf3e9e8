"""Window-batched row gather: the port of
`openembedding_tpu/ops/pallas_sparse.py::gather_rows_windows`.

`gather_rows_windows(weights, rows, *, block=256, window=16)` computes what
`gather.gather_rows(weights, rows)` computes, `out[i] = weights[rows[i]]`
with +0.0 rows for out-of-range ids, by another route. A prepass
(`window_prepass`, torch ops on the device, nothing read back) cuts the
requested rows into blocks of `block`, maps each row to its fixed-grid
window of `window` consecutive table rows, and lists each block's distinct
windows. The kernel then loads each distinct window once and copies every
row out of its staged window. Sorted ids (the dedup's output) share
windows and so load fewer bytes; ids in any order give the same answer.
A table with fewer rows than `window` goes through `gather.gather_rows`,
as the JAX function does.

On a CUDA tensor it launches the hand-written kernel
`csrc/gather_rows_windows.cu` (built on first use by `ops/_build.py`); on a
CPU tensor it runs the plain PyTorch version
`gather_rows_windows_reference`, the same prepass with the windows staged
by tensor indexing. Nothing else picks between them: a CUDA launch that
fails raises, it never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Set

import torch

from . import _build, gather

KERNEL = "gather_rows_windows"
# launches of the CUDA kernel, counted by the wrapper where it launches
LAUNCHES = {"gather_rows_windows": 0}
_COUNT_LOCK = threading.Lock()

DEFAULT_BLOCK = 256
DEFAULT_WINDOW = 16
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)


class WindowPlan(NamedTuple):
    """The prepass's output for nb blocks of `block` requested rows."""
    bases: torch.Tensor    # (nb*block,) int64: block b's slot s -> base row
    nw: torch.Tensor       # (nb,) int32: distinct windows of each block
    slotoff: torch.Tensor  # (nb*block,) int32: slot*window + offset; -1 for
                           # an out-of-range id
    block: int
    window: int


def window_prepass(n_rows: int, rows: torch.Tensor, *, block: int,
                   window: int) -> WindowPlan:
    """The prepass of `pallas_sparse.gather_rows_windows` (`:291-328`) for
    flat ids on their device: clamp into the table, pad to whole blocks with
    the last row's window, sort each block's window ids, mark the distinct
    ones (a window's slot is its rank among them), clamp each window's base
    to `n_rows - window` (the last partial window shifts down; offsets are
    taken against the clamped base), and map each row to its window's slot
    with `searchsorted`. `block` is cut to `max(8, n)` for short inputs, as
    in the JAX function. Reads nothing back to the host. Needs
    `n_rows >= window` and at least one id."""
    flat = rows.reshape(-1).long()
    n = flat.shape[0]
    block = min(block, max(8, n))
    nb = -(-n // block)
    clamped = flat.clamp(0, n_rows - 1)
    # padding reuses the last row's window, so it adds no window
    padded = torch.cat([clamped, clamped[-1:].expand(nb * block - n)])
    per = padded.view(nb, block)
    wid = per // window
    swid = torch.sort(wid, dim=1).values
    is_new = torch.ones_like(swid, dtype=torch.bool)
    is_new[:, 1:] = swid[:, 1:] != swid[:, :-1]
    slot_of_sorted = torch.cumsum(is_new, dim=1) - 1
    nw = (slot_of_sorted[:, -1] + 1).to(torch.int32)

    def wbase(w):
        return torch.clamp(w * window, max=n_rows - window)

    # every sorted window writes its base into its slot; duplicates of one
    # window write the same value
    bases = torch.zeros_like(per).scatter_(1, slot_of_sorted, wbase(swid))
    pos = torch.searchsorted(swid, wid).clamp_(max=block - 1)
    slot = torch.gather(slot_of_sorted, 1, pos)
    slotoff = (slot * window + per - wbase(wid)).view(-1)
    valid = (flat >= 0) & (flat < n_rows)
    slotoff[:n] = torch.where(valid, slotoff[:n], torch.full_like(
        slotoff[:n], -1))
    return WindowPlan(bases.view(-1), nw, slotoff.to(torch.int32), block,
                      window)


def staged_bytes(plan: WindowPlan, row_bytes: int) -> int:
    """Bytes the staging reads for this plan (each block's distinct windows
    once). Reads the window counts back to the host."""
    return int(plan.nw.sum()) * plan.window * row_bytes


def gather_rows_windows_reference(weights: torch.Tensor, rows: torch.Tensor,
                                  *, block: int = DEFAULT_BLOCK,
                                  window: int = DEFAULT_WINDOW
                                  ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same prepass, every block's
    window slots staged with one index read ((nb, block * window, dim)),
    each row copied out of its slot, zeros where the prepass marked an id
    out of range. Bit-equal to `gather.gather_rows_reference(weights,
    rows)` (both copy rows unchanged)."""
    n_rows, dim = weights.shape
    flat = rows.reshape(-1)
    if n_rows < window:
        return gather.gather_rows_reference(weights, flat)
    n = flat.shape[0]
    if n == 0:
        return torch.zeros((0, dim), dtype=weights.dtype,
                           device=weights.device)
    plan = window_prepass(n_rows, flat, block=block, window=window)
    nb, blk = plan.nw.shape[0], plan.block
    win_rows = (plan.bases.view(nb, blk, 1)
                + torch.arange(window, device=weights.device))
    staged = weights[win_rows.view(nb, blk * window)]
    so = plan.slotoff.view(nb, blk).long()
    out = torch.gather(staged, 1, so.clamp(min=0)[..., None].expand(
        nb, blk, dim)).view(nb * blk, dim)[:n]
    ok = (so >= 0).view(-1)[:n]
    return torch.where(ok[:, None], out, torch.zeros((), dtype=weights.dtype,
                                                     device=weights.device))


def _check(weights, rows, block, window) -> None:
    if weights.dim() != 2 or weights.dtype not in _TABLE_DTYPES:
        raise TypeError(f"gather_rows_windows: weights must be 2-D float32 "
                        f"or bfloat16, got {weights.dtype} "
                        f"{tuple(weights.shape)}")
    if rows.dtype not in _ID_DTYPES:
        raise TypeError(f"gather_rows_windows: id dtype {rows.dtype} is not "
                        "int32 or int64")
    if block < 1 or window < 1:
        raise ValueError(f"gather_rows_windows: block {block} and window "
                         f"{window} must be positive")
    if rows.device != weights.device:
        raise ValueError(f"gather_rows_windows: weights on {weights.device}, "
                         f"rows on {rows.device}")
    if not weights.is_contiguous():
        raise ValueError("gather_rows_windows: weights must be contiguous")


def gather_rows_windows(weights: torch.Tensor, rows: torch.Tensor, *,
                        block: int = DEFAULT_BLOCK,
                        window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """Gather table rows by windows; out-of-range ids give zero rows.

    weights (n_rows, dim) float32/bfloat16; rows int32/int64 of any shape
    (flattened) -> (n, dim) in the table's dtype. `rows` should be sorted
    for the staging to share windows; any order gives the same rows."""
    _check(weights, rows, block, window)
    n_rows, dim = weights.shape
    if n_rows < window:  # a window would span the whole table: per-row path
        return gather.gather_rows(weights, rows.reshape(-1).contiguous())
    if weights.device.type == "cpu":
        return gather_rows_windows_reference(weights, rows, block=block,
                                             window=window)
    if weights.device.type != "cuda":
        raise ValueError(f"gather_rows_windows: no kernel for device "
                         f"{weights.device}")
    flat = rows.reshape(-1)
    if flat.shape[0] * dim == 0:
        return torch.empty((flat.shape[0], dim), dtype=weights.dtype,
                           device=weights.device)
    plan = window_prepass(n_rows, flat, block=block, window=window)
    return launch_planned(weights, plan, flat.shape[0])


def launch_planned(weights: torch.Tensor, plan: WindowPlan, n: int
                   ) -> torch.Tensor:
    """The kernel alone, on the plan `window_prepass` made for n ids of
    this CUDA table (the wrapper's second half) -> (n, dim)."""
    n_rows, dim = weights.shape
    out = torch.empty((n, dim), dtype=weights.dtype, device=weights.device)
    row_bytes = dim * weights.element_size()
    with torch.cuda.device(weights.device):
        lib = _library()
        smem = lib.oe_window_gather_smem_bytes()
        if plan.window * row_bytes > smem:
            raise ValueError(
                f"gather_rows_windows: a window of {plan.window} rows of "
                f"{row_bytes} bytes does not fit in the {smem} bytes of "
                "shared memory a block may use; use a smaller window")
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = lib.oe_gather_rows_windows(
            weights.data_ptr(), row_bytes, plan.bases.data_ptr(),
            plan.nw.data_ptr(), plan.slotoff.data_ptr(), n, plan.block,
            plan.window, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.oe_cuda_error_string(rc).decode()
        raise RuntimeError(f"gather_rows_windows kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    with _COUNT_LOCK:
        LAUNCHES["gather_rows_windows"] += 1
    return out


_LIB: Optional[ctypes.CDLL] = None
_READY: Set[int] = set()  # devices whose shared memory limit is set
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits), its
    shared memory limit set once for the current device."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load(KERNEL)
            lib.oe_window_gather_init.argtypes = []
            lib.oe_window_gather_init.restype = ctypes.c_int
            lib.oe_window_gather_smem_bytes.argtypes = []
            lib.oe_window_gather_smem_bytes.restype = ctypes.c_int
            lib.oe_gather_rows_windows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.oe_gather_rows_windows.restype = ctypes.c_int
            lib.oe_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oe_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        if torch.cuda.is_available():
            dev = torch.cuda.current_device()
            if dev not in _READY:
                rc = _LIB.oe_window_gather_init()
                if rc != 0:
                    msg = _LIB.oe_cuda_error_string(rc).decode()
                    raise RuntimeError(f"gather_rows_windows: setting the "
                                       f"shared memory limit failed: CUDA "
                                       f"error {rc} ({msg})")
                _READY.add(dev)
        return _LIB
