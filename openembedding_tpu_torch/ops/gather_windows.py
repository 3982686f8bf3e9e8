"""Window-batched row gather: the port of
`openembedding_tpu/ops/pallas_sparse.py::gather_rows_windows`.

`gather_rows_windows(weights, rows, *, block=256, window=16)` computes what
`gather.gather_rows(weights, rows)` computes, `out[i] = weights[rows[i]]`
with +0.0 rows for out-of-range ids. A table with fewer rows than `window`
goes through `gather.gather_rows`, as the JAX function does.

On a CUDA tensor it is one launch of the hand-written kernel
`csrc/gather_rows_windows.cu` (built on first use by `ops/_build.py`) on
the ids as they are: no prepass. Each CTA takes `block` consecutive ids,
finds its runs (consecutive ids in one fixed window of `window` rows),
copies the rows of a dense run out of one bulk copy of its span and every
other row directly; under the default rule (`STAGE_SHARE`) no run stages
and the kernel skips the run analysis. `staged_bytes` applies the rule to
ids on the host and says what a launch stages.

On a CPU tensor it runs the plain PyTorch version
`gather_rows_windows_reference`: the JAX function's prepass
(`window_prepass`), with the windows staged by tensor indexing. Nothing
else picks between them: a CUDA launch that fails raises, it never falls
back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build, gather

KERNEL = "gather_rows_windows"
# launches of the CUDA kernel, counted by the wrapper where it launches
LAUNCHES = {"gather_rows_windows": 0}
_COUNT_LOCK = threading.Lock()

DEFAULT_BLOCK = 256
DEFAULT_WINDOW = 16
# The kernel's staging rule (`csrc/gather_rows_windows.cu` holds the same
# constants; `chip_smoke.py` checks that they agree): a CTA takes at most
# TILE ids; a run stages when it has at least STAGE_MIN_ROWS positions and
# they are at least `stage_share` of the rows of its span; staged spans
# share a STAGE_BYTES buffer.
TILE = 256
STAGE_BYTES = 32768
STAGE_MIN_ROWS = 2
# No run stages by default: on an H100 the direct path beat staging at every
# density measured, dense runs of frequency-relabeled ids included (PERF.md,
# the kernel table's findings), since the sorted rows a warp reads already
# coalesce. A launch under this rule skips the run analysis.
STAGE_SHARE = float("inf")
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
    """The plain version's prepass (the kernel takes none): that of
    `pallas_sparse.gather_rows_windows` (`:291-328`) for flat ids on their
    device: clamp into the table, pad to whole blocks with the last row's
    window, sort each block's window ids, mark the distinct
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


def kernel_tile(block: int, n: int) -> int:
    """Ids one CTA takes: the JAX function's block cut for short inputs
    (`min(block, max(8, n))`), at most TILE."""
    return min(block, max(8, n), TILE)


class StagedRuns(NamedTuple):
    """What one launch stages: runs, their positions, and the bytes their
    bulk copies read."""
    runs: int
    rows: int
    bytes: int


def staged_bytes(rows, n_rows: int, row_bytes: int, *,
                 block: int = DEFAULT_BLOCK, window: int = DEFAULT_WINDOW,
                 stage_share: float = STAGE_SHARE,
                 base_offset: int = 0) -> StagedRuns:
    """The kernel's run and staging rule applied to `rows` on the host.

    Per tile of `kernel_tile(block, n)` positions: a run is a maximal
    stretch of consecutive positions whose in-range ids share `id //
    window` (an out-of-range id ends a run). A run stages when it has at
    least STAGE_MIN_ROWS positions, the positions are at least
    `stage_share` times the rows from its least to its greatest id, and
    the span's bytes, widened to 16-byte boundaries of the device address
    (the table starts `base_offset` bytes past one), lie inside the table;
    the tile's staged spans are laid out in position order in STAGE_BYTES
    and the first that does not fit stops the staging. Reads the ids to
    the host."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    ids = np.asarray(rows, dtype=np.int64).reshape(-1)
    n = ids.shape[0]
    if n == 0 or n_rows < window:
        return StagedRuns(0, 0, 0)
    tile = kernel_tile(block, n)
    ok = (ids >= 0) & (ids < n_rows)
    win = np.where(ok, ids // window, -1)
    prev = np.concatenate([[-1], win[:-1]])
    prev[::tile] = -1
    first = ok & (win != prev)
    starts = np.flatnonzero(first)
    if starts.size == 0:
        return StagedRuns(0, 0, 0)
    run = (np.cumsum(first) - 1)[ok]
    off = (ids - win * window)[ok]
    count = np.bincount(run, minlength=starts.size)
    lo = np.full(starts.size, window, np.int64)
    hi = np.full(starts.size, -1, np.int64)
    np.minimum.at(lo, run, off)
    np.maximum.at(hi, run, off)
    base = win[starts] * window
    dense = ((count >= STAGE_MIN_ROWS)
             & (count.astype(np.float64) >= stage_share
                * (hi - lo + 1).astype(np.float64)))
    lo_b = (base_offset + (base + lo) * row_bytes) // 16 * 16
    hi_b = -(-(base_offset + (base + hi + 1) * row_bytes) // 16) * 16
    inside = ((lo_b >= base_offset)
              & (hi_b <= base_offset + n_rows * row_bytes)
              & (hi_b - lo_b <= STAGE_BYTES))
    nbytes = np.where(dense & inside, hi_b - lo_b, 0)
    # each tile's exclusive prefix of the bytes, in position order
    tile_of = starts // tile
    excl = np.cumsum(nbytes) - nbytes
    excl -= excl[np.searchsorted(tile_of, tile_of)]
    staged = (nbytes > 0) & (excl + nbytes <= STAGE_BYTES)
    return StagedRuns(int(staged.sum()), int(count[staged].sum()),
                      int(nbytes[staged].sum()))


def gather_rows_windows_reference(weights: torch.Tensor, rows: torch.Tensor,
                                  *, block: int = DEFAULT_BLOCK,
                                  window: int = DEFAULT_WINDOW
                                  ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, as the JAX function computes it:
    the prepass, every block's window slots staged with one index read
    ((nb, block * window, dim)), each row copied out of its slot, zeros
    where the prepass marked an id out of range. Bit-equal to the kernel
    and to `gather.gather_rows_reference(weights, rows)` (all copy rows
    unchanged)."""
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


def _check(weights, rows, block, window, stage_share) -> None:
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
    if not stage_share >= 0:
        raise ValueError(f"gather_rows_windows: stage_share {stage_share} "
                         "must be >= 0 (inf: stage nothing)")
    if rows.device != weights.device:
        raise ValueError(f"gather_rows_windows: weights on {weights.device}, "
                         f"rows on {rows.device}")
    if not weights.is_contiguous():
        raise ValueError("gather_rows_windows: weights must be contiguous")


def gather_rows_windows(weights: torch.Tensor, rows: torch.Tensor, *,
                        block: int = DEFAULT_BLOCK,
                        window: int = DEFAULT_WINDOW,
                        stage_share: float = STAGE_SHARE) -> torch.Tensor:
    """Gather table rows by windows; out-of-range ids give zero rows.

    weights (n_rows, dim) float32/bfloat16; rows int32/int64 of any shape
    (flattened) -> (n, dim) in the table's dtype. Sorted `rows` form the
    longest runs; any order gives the same rows. `stage_share` is the
    kernel's density rule (`staged_bytes`; inf stages nothing); it changes
    how the kernel reads the rows, never what it returns."""
    _check(weights, rows, block, window, stage_share)
    n_rows, dim = weights.shape
    if n_rows < window:  # a window would span the whole table: per-row path
        return gather.gather_rows(weights, rows.reshape(-1).contiguous())
    if weights.device.type == "cpu":
        return gather_rows_windows_reference(weights, rows, block=block,
                                             window=window)
    if weights.device.type != "cuda":
        raise ValueError(f"gather_rows_windows: no kernel for device "
                         f"{weights.device}")
    flat = rows.reshape(-1).contiguous()
    n = flat.shape[0]
    out = torch.empty((n, dim), dtype=weights.dtype, device=weights.device)
    if n * dim == 0:
        return out
    lib = _library()
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = lib.oe_gather_rows_windows(
            weights.data_ptr(), n_rows, dim * weights.element_size(),
            flat.data_ptr(), flat.element_size(), n, kernel_tile(block, n),
            window, float(stage_share), out.data_ptr(), stream)
    if rc != 0:
        msg = lib.oe_cuda_error_string(rc).decode()
        raise RuntimeError(f"gather_rows_windows kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    with _COUNT_LOCK:
        LAUNCHES["gather_rows_windows"] += 1
    return out


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load(KERNEL)
            lib.oe_gather_rows_windows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.oe_gather_rows_windows.restype = ctypes.c_int
            for name in ("oe_window_gather_tile",
                         "oe_window_gather_stage_bytes",
                         "oe_window_gather_stage_min_rows"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_int
            lib.oe_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oe_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
