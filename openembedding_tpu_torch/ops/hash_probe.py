"""The hashed pull's probe on the card: `csrc/hash_probe.cu`, a walk that
finds the ids already in the table and a contest for the few that claim a
slot (the source's note gives the design).

`find_or_insert(keys, ids, num_probes)` is the kernel half of
`tables/hash_table.hash_find_or_insert`: a CUDA tensor launches the walk
and the contest or raises, with no fallback. It returns (slot, overflow,
inserted, pending), the last two () int32 device counts: the slots
claimed, and the non-negative ids that met an empty slot on their walk and
so entered the contest. Nothing is read back to the host, so a CUDA graph
captures the call. The plain version with the same contract is
`tables/hash_table.hash_find_or_insert_reference`, which
`ops.plain_versions()` puts in its place.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "hash_probe"
# launches of the two kernels, counted by the wrapper where it launches
LAUNCHES = {"hash_walk": 0, "hash_contest": 0}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently

# int32 words of the scratch (`csrc/hash_probe.cu`) that hold the counts
_PENDING, _OVERFLOW, _INSERTED = 0, 1, 2


def _check(keys: torch.Tensor, ids: torch.Tensor) -> None:
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"hash probe: keys must be 1-D int64, got "
                        f"{keys.dtype} of shape {tuple(keys.shape)}")
    if ids.dim() != 1:
        raise ValueError(f"hash probe: ids must be 1-D, got shape "
                         f"{tuple(ids.shape)}")
    if keys.device != ids.device:
        raise ValueError(f"hash probe: keys on {keys.device}, ids on "
                         f"{ids.device}")
    if not keys.is_contiguous():
        raise ValueError("hash probe: keys must be contiguous (updated in "
                         "place)")
    if keys.shape[0] == 0:
        raise ValueError("hash probe: a table of no slots")
    if ids.shape[0] >= 1 << 31:
        raise ValueError(f"hash probe: {ids.shape[0]} ids, at most 2^31 - 1")


def find_or_insert(keys: torch.Tensor, ids: torch.Tensor, num_probes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """keys (capacity,) int64, updated in place; ids (n,) int32/int64 ->
    (slot (n,) int64, overflow, inserted, pending: () int32)."""
    _check(keys, ids)
    if keys.device.type != "cuda":
        raise ValueError(f"hash probe: no kernel for device {keys.device}")
    ids = ids.to(torch.int64).contiguous()
    n = ids.shape[0]
    device = keys.device
    lib = _library()
    scratch = torch.zeros(lib.oe_hash_probe_scratch_words(),
                          dtype=torch.int32, device=device)
    slot = torch.empty(n, dtype=torch.int64, device=device)
    counts = (scratch[_OVERFLOW], scratch[_INSERTED], scratch[_PENDING])
    if n == 0:
        return (slot, *counts)
    pend_index = torch.empty(n, dtype=torch.int32, device=device)
    pend_d0 = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.oe_hash_probe(keys.data_ptr(), keys.shape[0], ids.data_ptr(),
                               n, num_probes, slot.data_ptr(),
                               pend_index.data_ptr(), pend_d0.data_ptr(),
                               scratch.data_ptr(), stream)
    if rc != 0:
        msg = lib.oe_cuda_error_string(rc).decode()
        raise RuntimeError(f"hash probe launch failed: CUDA error {rc} "
                           f"({msg})")
    with _COUNT_LOCK:
        LAUNCHES["hash_walk"] += 1
        LAUNCHES["hash_contest"] += 1
    return (slot, *counts)


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (every pointer and
    the stream as c_void_p)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load(KERNEL)
            ptr = ctypes.c_void_p
            lib.oe_hash_probe.argtypes = [
                ptr, ctypes.c_int64, ptr, ctypes.c_int64, ctypes.c_int, ptr,
                ptr, ptr, ptr, ptr]
            lib.oe_hash_probe.restype = ctypes.c_int
            lib.oe_hash_probe_scratch_words.argtypes = []
            lib.oe_hash_probe_scratch_words.restype = ctypes.c_int
            lib.oe_cuda_error_string.argtypes = [ctypes.c_int]
            lib.oe_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB
