"""Wire formats of the sharded exchange (port of the fp32 and bf16 parts of
`openembedding_tpu/ops/wire.py`).

A train step moves three payloads: id buckets out, pulled rows back, pushed
grads and counts out (`parallel/sharded.py`). Tables and the optimizer
apply stay in their own dtype; only the bytes on the wire narrow, and they
widen again at the receiving edge. Rows are encoded at the owner before
the pull's all_to_all and grads at the client before the push's, so the
collectives move the narrow buffers themselves.

Formats (explicit argument, then `$OETPU_WIRE`, then bf16, as in JAX):

- ``fp32``: payloads in their own float dtype, bit-exact;
- ``bf16``: rows and grads rounded to bfloat16 (to nearest, ties to even),
  carried as the int16 words of the same bits (JAX's uint16 carrier; the
  collectives move either as int8 bytes, since gloo and NCCL take no
  16-bit integers);
- ``int8`` (per-block scales in band, error-feedback residuals and the
  dither of stochastic rounding) is not ported: it raises
  NotImplementedError (ROADMAP.md item 3).

Duplicate counts ride exactly: the int32 bits viewed as wire lanes (one
fp32 lane or two bf16 lanes), never rounded. Empty bucket slots are zero
bits, which decode to grad 0 and count 0 in both formats.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

WIRE_ENV = "OETPU_WIRE"
DEFAULT_WIRE = "bf16"
FORMATS = ("fp32", "bf16", "int8")
_ALIASES = {"float32": "fp32", "f32": "fp32", "bfloat16": "bf16",
            "i8": "int8"}


def wire_format(override: Optional[str] = None) -> str:
    """Resolve the wire format: explicit override > $OETPU_WIRE > bf16."""
    fmt = override or os.environ.get(WIRE_ENV, "") or DEFAULT_WIRE
    fmt = _ALIASES.get(fmt.lower(), fmt.lower())
    if fmt not in FORMATS:
        raise ValueError(
            f"unknown wire format {fmt!r} (expected one of {FORMATS}; "
            f"set {WIRE_ENV} or the trainer's wire= argument)")
    return fmt


def _ported(fmt: str) -> str:
    if fmt == "int8":
        raise NotImplementedError(
            "the int8 wire (in-band scales, error-feedback residuals, "
            "stochastic rounding) is not ported yet (ROADMAP.md item 3); "
            "use wire='fp32' or 'bf16'")
    return fmt


def wire_dtype(fmt: str) -> torch.dtype:
    """The value dtype a payload is encoded in (fp32 keeps the payload's
    own float dtype)."""
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[_ported(fmt)]


def wire_carrier_dtype(fmt: str) -> torch.dtype:
    """The dtype the exchanged buffers travel in: float32, or for bf16 the
    int16 words of its bits."""
    return {"fp32": torch.float32, "bf16": torch.int16}[_ported(fmt)]


def count_lanes(fmt: str) -> int:
    """Wire lanes one int32 count takes."""
    return 4 // torch.empty((), dtype=wire_dtype(fmt)).element_size()


def counts_to_lanes(counts: torch.Tensor, fmt: str) -> torch.Tensor:
    """(n,) int32 -> (n, count_lanes(fmt)) in the carrier dtype, the same
    bits."""
    lanes = counts.to(torch.int32).contiguous().view(wire_carrier_dtype(fmt))
    return lanes.reshape(counts.shape[0], -1)


def lanes_to_counts(lanes: torch.Tensor) -> torch.Tensor:
    """Inverse of `counts_to_lanes`: (n, L) wire lanes -> (n,) int32."""
    return lanes.contiguous().view(torch.int32).reshape(-1)


def rows_wire_width(dim: int, fmt: str) -> int:
    """Wire columns of a (n, dim) row payload."""
    _ported(fmt)
    return dim


def grads_wire_width(dim: int, fmt: str) -> int:
    """Wire columns of a (n, dim) grad payload with its count lanes."""
    return rows_wire_width(dim, fmt) + count_lanes(fmt)


def pack_inband(rows: torch.Tensor, fmt: str) -> torch.Tensor:
    """(n, d) float rows -> the wire payload (n, rows_wire_width(d, fmt)):
    fp32 as given, bf16 rounded to nearest even and viewed as int16."""
    if _ported(fmt) == "fp32":
        return rows
    return rows.to(torch.bfloat16).view(torch.int16)


def unpack_inband(wire: torch.Tensor, dim: int, fmt: str) -> torch.Tensor:
    """Inverse of `pack_inband` -> (n, dim) float32 (callers cast to their
    table's dtype)."""
    if _ported(fmt) == "bf16":
        return wire.contiguous().view(torch.bfloat16).float()
    return wire.float()


def encode_grads(grads: torch.Tensor, counts: torch.Tensor,
                 fmt: str) -> torch.Tensor:
    """(n, d) float grads and (n,) int32 counts -> (n, grads_wire_width)
    wire rows; the counts ride bit for bit."""
    g = pack_inband(grads.float() if fmt != "bf16" else grads, fmt)
    return torch.cat([g, counts_to_lanes(counts, fmt)], dim=1)


def decode_grads(wire: torch.Tensor, dim: int,
                 fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ((n, dim) float32 grads, (n,) int32 counts)."""
    body = rows_wire_width(dim, fmt)
    return (unpack_inband(wire[:, :body], dim, fmt),
            lanes_to_counts(wire[:, body:]))


# -- host codecs (numpy), the JAX package's `np_encode_rows` and
# `np_decode_rows`: bf16 as uint16 words, rounded to nearest even --------


def np_encode_rows(rows: np.ndarray, fmt: str) -> np.ndarray:
    """(n, d) float rows -> the host payload (n, d)."""
    rows = np.ascontiguousarray(rows, np.float32)
    if _ported(fmt) == "fp32":
        return rows
    u = rows.view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return ((u + bias) >> np.uint32(16)).astype(np.uint16)


def np_decode_rows(wire: np.ndarray, dim: int, fmt: str) -> np.ndarray:
    """Inverse of `np_encode_rows` -> (n, dim) float32."""
    if _ported(fmt) == "fp32":
        return np.asarray(wire, np.float32)
    u16 = np.ascontiguousarray(wire, dtype=np.uint16)
    return (u16.astype(np.uint32) << np.uint32(16)).view(np.float32)
