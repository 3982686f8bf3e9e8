"""Fused sparse optimizer apply: the port of
`openembedding_tpu/ops/pallas_sparse.py::fused_sparse_apply`.

`fused_sparse_apply(optimizer, weights, slots, rows, grads, counts)` updates,
in place, every row rows[i] with counts[i] > 0 and 0 <= rows[i] < n_rows:
it reads the weight row and every slot row, runs `optimizer`'s row update in
float32 (a bfloat16 table is upcast, then rounded back to nearest even) and
writes both back. No other row is read or written. Rows with counts > 0 must
be unique (`ops/sparse._dedup_routed` guarantees it). Returns
(weights, slots), the tensors given.

On a CUDA tensor it launches the hand-written kernel
`csrc/fused_sparse_apply.cu` (built on first use by `ops/_build.py`); on a
CPU tensor it runs the plain PyTorch version
`fused_sparse_apply_reference`. Nothing else picks between them: a CUDA
launch that fails raises, it never falls back.

The kernel takes each array as a base pointer and a row stride, so weights
and slots may be column ranges of one wider array (a packed layout) as well
as arrays of their own. A warp of the kernel updates a tile of slots, in
words of E elements: `launch_plan` mirrors on the host how a launch picks E
and the tile.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build, gather

KERNEL = "fused_sparse_apply"
# launches of the CUDA kernel, counted by the wrapper where it launches
LAUNCHES = {"fused_sparse_apply": 0}
_COUNT_LOCK = threading.Lock()

_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)
MAX_SLOTS = 4   # kMaxSlots in the kernel source
MAX_HYPER = 8   # kMaxHyper in the kernel source
# the kernel's launch plan (`plan`, `unroll` and `tile_rows` in the sources):
# per rule (`SparseOptimizer.rule`), how many of its slots, first in its
# order, are as wide as the row (the rest hold one column of per-row state)
WIDE_SLOTS = (0, 1, 1, 2, 2, 2, 2, 2, 0)
WORD_ELEMS = (4, 2, 1)  # elements a word, widest first
WORD_FLOATS = 30        # floats of loaded words a lane holds in one round
MAX_UNROLL = 8


class LaunchPlan(NamedTuple):
    word_elems: int  # E: elements a word
    unroll: int      # words of each array a lane loads in one round
    tile_rows: int   # slots a warp's tile holds


def launch_plan(rule: int, dim: int,
                arrays: Sequence[Tuple[int, int, int]]) -> LaunchPlan:
    """The kernel's plan for one launch, computed on the host as the kernel
    computes it. arrays: (address, row stride in elements, element bytes) of
    the weights, of each of the rule's wide slots and of the gradients. E is
    the largest of 4, 2, 1 that divides `dim` and every row stride, and
    whose bytes divide every address; a lane loads `unroll` words of each
    array a round (about WORD_FLOATS floats in all); a tile holds as many
    rows (1..32) as make `unroll` words a lane."""
    e = next((e for e in WORD_ELEMS
              if dim % e == 0 and all(stride % e == 0 and addr % (e * b) == 0
                                      for addr, stride, b in arrays)), 1)
    unroll = min(MAX_UNROLL, max(1, WORD_FLOATS
                                 // ((2 + WIDE_SLOTS[rule]) * e)))
    tile = min(32, max(1, 32 * unroll // (dim // e)))
    return LaunchPlan(e, unroll, tile)


def plan_arrays(optimizer, weights: torch.Tensor,
                slots: Dict[str, torch.Tensor],
                grads: torch.Tensor) -> List[Tuple[int, int, int]]:
    """The `arrays` argument of `launch_plan` for one `fused_sparse_apply`
    call: the weights, the rule's wide slots, the gradients."""
    wide = list(slots.values())[:WIDE_SLOTS[optimizer.rule]]
    return [(t.data_ptr(), t.stride(0), t.element_size())
            for t in (weights, *wide, grads)]


def fused_sparse_apply_reference(optimizer, weights: torch.Tensor,
                                 slots: Dict[str, torch.Tensor],
                                 rows: torch.Tensor, grads: torch.Tensor,
                                 counts: torch.Tensor
                                 ) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """Plain PyTorch twin of the kernel, as the JAX package's XLA path does
    it: zero the counts of out-of-range rows, gather every row, apply the
    rule from `optimizers.py`, scatter back the rows with counts > 0."""
    from .sparse import scatter_rows  # ops/sparse.py imports this module
    n_rows = weights.shape[0]
    live = (counts > 0) & (rows >= 0) & (rows < n_rows)
    counts = torch.where(live, counts, torch.zeros_like(counts))
    w_rows = gather.gather_rows_reference(weights, rows).float()
    s_rows = {k: gather.gather_rows_reference(v, rows)
              for k, v in slots.items()}
    new_w, new_s = optimizer.apply(w_rows, s_rows, grads.float(), counts)
    scatter_rows(weights, rows, new_w, live)
    for k, v in slots.items():
        scatter_rows(v, rows, new_s[k], live)
    return weights, slots


def _check(optimizer, weights, slots, rows, grads, counts) -> None:
    if weights.dim() != 2 or weights.dtype not in _TABLE_DTYPES:
        raise TypeError(f"fused_sparse_apply: weights must be 2-D float32 or "
                        f"bfloat16, got {weights.dtype} "
                        f"{tuple(weights.shape)}")
    n_rows, dim = weights.shape
    want = optimizer.slot_shapes(dim)
    if list(slots) != list(want):
        raise ValueError(f"fused_sparse_apply: {type(optimizer).__name__} "
                         f"takes slots {list(want)} in that order, got "
                         f"{list(slots)}")
    for name, s in slots.items():
        if s.dtype != torch.float32 or tuple(s.shape) != (n_rows, want[name]):
            raise TypeError(f"fused_sparse_apply: slot {name!r} must be "
                            f"float32 {(n_rows, want[name])}, got {s.dtype} "
                            f"{tuple(s.shape)}")
    if rows.dim() != 1 or rows.dtype not in _ID_DTYPES:
        raise TypeError(f"fused_sparse_apply: rows must be 1-D int32/int64, "
                        f"got {rows.dtype} {tuple(rows.shape)}")
    n = rows.shape[0]
    if grads.dtype != torch.float32 or tuple(grads.shape) != (n, dim):
        raise TypeError(f"fused_sparse_apply: grads must be float32 "
                        f"{(n, dim)}, got {grads.dtype} "
                        f"{tuple(grads.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (n,):
        raise TypeError(f"fused_sparse_apply: counts must be int32 ({n},), "
                        f"got {counts.dtype} {tuple(counts.shape)}")
    tensors = [weights, *slots.values(), rows, grads, counts]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_sparse_apply: inputs on several devices "
                         f"{devices}")
    # a row may start anywhere (a column range of a packed array), but the
    # elements of a row and the 1-D inputs must be contiguous
    if not (all(t.stride(1) == 1 for t in (weights, *slots.values(), grads))
            and rows.is_contiguous() and counts.is_contiguous()):
        raise ValueError("fused_sparse_apply: columns must be contiguous")


def fused_sparse_apply(optimizer, weights: torch.Tensor,
                       slots: Dict[str, torch.Tensor], rows: torch.Tensor,
                       grads: torch.Tensor, counts: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-place optimizer update of the rows with counts > 0 (see the module
    docstring). weights (n_rows, dim) float32/bfloat16; slots in
    `optimizer.slot_shapes` order, float32 (n_rows, width); rows (n,)
    int32/int64; grads (n, dim) float32; counts (n,) int32."""
    _check(optimizer, weights, slots, rows, grads, counts)
    if weights.device.type == "cpu":
        return fused_sparse_apply_reference(optimizer, weights, slots, rows,
                                            grads, counts)
    if weights.device.type != "cuda":
        raise ValueError(f"fused_sparse_apply: no kernel for device "
                         f"{weights.device}")
    n_rows, dim = weights.shape
    n = rows.shape[0]
    if n * dim == 0:
        return weights, slots
    hyper = optimizer.hyper()
    lib = _library()
    slot_list = list(slots.values())
    slot_ptrs = (ctypes.c_void_p * MAX_SLOTS)(
        *[s.data_ptr() for s in slot_list])
    slot_strides = (ctypes.c_int64 * MAX_SLOTS)(
        *[s.stride(0) for s in slot_list])
    hyper_arr = (ctypes.c_float * MAX_HYPER)(*hyper)
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = lib.oe_fused_sparse_apply(
            optimizer.rule, hyper_arr, len(hyper),
            weights.data_ptr(), weights.stride(0), weights.element_size(),
            n_rows, dim, len(slot_list), slot_ptrs, slot_strides,
            rows.data_ptr(), rows.element_size(), grads.data_ptr(),
            grads.stride(0), counts.data_ptr(), n, stream)
    if rc != 0:
        msg = lib.oe_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_sparse_apply kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    with _COUNT_LOCK:
        LAUNCHES["fused_sparse_apply"] += 1
    return weights, slots


def kernel_plan(rule: int, dim: int,
                arrays: Sequence[Tuple[int, int, int]]) -> Tuple[int, int]:
    """(E, tile rows) as the built kernel picks them
    (`oe_fused_sparse_apply_plan`, which reads the addresses and never
    what they point to), for `launch_plan`'s arguments: what
    `launch_plan` must agree with."""
    (w_addr, w_stride, w_bytes), *wide, (g_addr, g_stride, _) = arrays
    lib = _library()
    slot_ptrs = (ctypes.c_void_p * MAX_SLOTS)(*[a for a, _, _ in wide])
    slot_strides = (ctypes.c_int64 * MAX_SLOTS)(*[st for _, st, _ in wide])
    e, tile = ctypes.c_int(), ctypes.c_int()
    rc = lib.oe_fused_sparse_apply_plan(
        rule, dim, w_addr, w_stride, w_bytes, slot_ptrs, slot_strides,
        g_addr, g_stride, ctypes.byref(e), ctypes.byref(tile))
    if rc != 0:
        raise RuntimeError(f"fused_sparse_apply: no plan: CUDA error {rc}")
    return e.value, tile.value


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits). When
    it loads, it reads each card's SM count and each kernel instance's
    resident blocks, once, so that no launch queries the device (a launch
    may be captured)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load(KERNEL)
            lib.oe_fused_sparse_apply.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p]
            lib.oe_fused_sparse_apply.restype = ctypes.c_int
            lib.oe_fused_sparse_apply_init.argtypes = []
            lib.oe_fused_sparse_apply_init.restype = ctypes.c_int
            lib.oe_fused_sparse_apply_resident_blocks.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.oe_fused_sparse_apply_resident_blocks.restype = ctypes.c_int
            lib.oe_fused_sparse_apply_plan.argtypes = [
                ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.oe_fused_sparse_apply_plan.restype = ctypes.c_int
            lib.oe_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oe_cuda_error_string.restype = ctypes.c_char_p
            for dev in range(torch.cuda.device_count()):
                with torch.cuda.device(dev):
                    rc = lib.oe_fused_sparse_apply_init()
                if rc != 0:
                    msg = lib.oe_cuda_error_string(rc).decode()
                    raise RuntimeError(f"fused_sparse_apply: reading card "
                                       f"{dev}'s occupancy failed: CUDA "
                                       f"error {rc} ({msg})")
            _LIB = lib
    return _LIB
