"""Wire formats of the sharded exchange and of the ZeRO dense update (port
of `openembedding_tpu/ops/wire.py`).

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
- ``int8``: rows and grads quantized to int8 with one float32 scale per
  `INBAND_BLOCK`-wide block of the row (max-abs / 127), the scales riding
  in band as 4 int8 lanes of their bits per block (`rows_wire_width`).
  Rows round to nearest (even); grad pushes round stochastically with a
  deterministic hash dither of the value bits and the lane (`_dither`),
  the same on every rank. The pull's bias is held by the owner's
  error-feedback residuals (`EmbeddingTableState.ef`,
  `parallel/sharded._serve_rows`).

Duplicate counts ride exactly: the int32 bits viewed as wire lanes (one
fp32 lane or two bf16 lanes), never rounded. Empty bucket slots are zero
bits, which decode to grad 0 and count 0 in both formats.

The sparse top-k payload (`pack_topk`, the ZeRO dense wire
"sparse_topk", `parallel/zero.py`) carries a row's k largest-magnitude
elements in the int8 codec, rounded to nearest, with their int32 column
indices as 4 int8 lanes each; untransmitted elements decode to exact
zeros. Its bytes are the JAX package's, byte for byte.
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

# int8 payloads carry one float32 scale per block as 4 int8 lanes of its bits
_SCALE_LANES = 4
# columns sharing one in-band scale
INBAND_BLOCK = 32
_M32 = 0xFFFFFFFF


def wire_format(override: Optional[str] = None) -> str:
    """Resolve the wire format: explicit override > $OETPU_WIRE > bf16."""
    fmt = override or os.environ.get(WIRE_ENV, "") or DEFAULT_WIRE
    fmt = _ALIASES.get(fmt.lower(), fmt.lower())
    if fmt not in FORMATS:
        raise ValueError(
            f"unknown wire format {fmt!r} (expected one of {FORMATS}; "
            f"set {WIRE_ENV} or the trainer's wire= argument)")
    return fmt


def wire_dtype(fmt: str) -> torch.dtype:
    """The value dtype a payload is encoded in (fp32 keeps the payload's
    own float dtype); its itemsize prices every cost model."""
    return {"fp32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[fmt]


def wire_carrier_dtype(fmt: str) -> torch.dtype:
    """The dtype the exchanged buffers travel in: float32, int8, or for
    bf16 the int16 words of its bits."""
    return {"fp32": torch.float32, "bf16": torch.int16,
            "int8": torch.int8}[fmt]


def _itemsize(fmt: str) -> int:
    return torch.empty((), dtype=wire_dtype(fmt)).element_size()


def count_lanes(fmt: str) -> int:
    """Wire lanes one int32 count takes."""
    return 4 // _itemsize(fmt)


def scale_blocks(dim: int) -> int:
    """In-band float32 scales an int8-encoded (n, dim) payload carries per
    row."""
    return -(-dim // INBAND_BLOCK)


def counts_to_lanes(counts: torch.Tensor, fmt: str) -> torch.Tensor:
    """(n,) int32 -> (n, count_lanes(fmt)) in the carrier dtype, the same
    bits."""
    lanes = counts.to(torch.int32).contiguous().view(wire_carrier_dtype(fmt))
    return lanes.reshape(counts.shape[0], -1)


def lanes_to_counts(lanes: torch.Tensor) -> torch.Tensor:
    """Inverse of `counts_to_lanes`: (n, L) wire lanes -> (n,) int32."""
    return lanes.contiguous().view(torch.int32).reshape(-1)


def rows_wire_width(dim: int, fmt: str) -> int:
    """Wire columns of a (n, dim) row payload (int8: and the in-band scale
    lanes, 4 a block)."""
    return dim + _SCALE_LANES * scale_blocks(dim) if fmt == "int8" else dim


def grads_wire_width(dim: int, fmt: str) -> int:
    """Wire columns of a (n, dim) grad payload with its count lanes."""
    return rows_wire_width(dim, fmt) + count_lanes(fmt)


# -- the int8 codec -----------------------------------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64: the uint32
    multiply, in two 16-bit halves of `c` so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _dither(x32: torch.Tensor) -> torch.Tensor:
    """The stochastic-rounding dither in [0, 1) of the JAX package: a hash
    of each value's bits xor the lane's position in the last dim, mixed
    by two xorshift-multiply rounds; uint32 arithmetic carried in int64,
    masked to 32 bits after each multiply. The same on every rank, and no
    generator state."""
    bits = x32.float().contiguous().view(torch.int32).long() & _M32
    lane = (torch.arange(x32.shape[-1], dtype=torch.int64,
                         device=x32.device) * 2654435761) & _M32
    h = bits ^ lane
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _blocks(x32: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, nb, INBAND_BLOCK), zero-padded."""
    n, dim = x32.shape
    pad = scale_blocks(dim) * INBAND_BLOCK - dim
    if pad:
        x32 = torch.nn.functional.pad(x32, (0, pad))
    return x32.reshape(n, -1, INBAND_BLOCK)


def _quantize_int8(x32: torch.Tensor, stochastic: bool = False
                   ) -> torch.Tensor:
    """(n, d) float32 -> (n, rows_wire_width(d, "int8")) int8: symmetric
    max-abs scaling per block, the float32 scales' bytes in the trailing
    4 * blocks lanes. An all-zero block has scale 0 and decodes to zeros.
    The scale is the max times the float32 reciprocal of 127, which is
    what XLA makes of the JAX package's division by that constant in a
    compiled step."""
    n, dim = x32.shape
    xb = _blocks(x32)
    amax = xb.abs().amax(dim=2)
    scale = amax * (1.0 / 127.0)  # the scalar rounds to float32 first
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    scaled = xb * inv[:, :, None]
    if stochastic:
        qf = torch.floor(scaled + _dither(xb))
    else:
        qf = torch.round(scaled)  # half to even, as jnp.round
    q = torch.clamp(qf, -127, 127).to(torch.int8).reshape(n, -1)[:, :dim]
    lanes = scale.contiguous().view(torch.int8).reshape(n, -1)
    return torch.cat([q, lanes], dim=1)


def _dequantize_int8(wire: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, rows_wire_width(dim, "int8")) int8 -> (n, dim) float32."""
    n = wire.shape[0]
    nb = scale_blocks(dim)
    scale = wire[:, dim:dim + _SCALE_LANES * nb].contiguous().view(
        torch.float32).reshape(n, nb)
    qb = _blocks(wire[:, :dim].to(torch.float32))
    return (qb * scale[:, :, None]).reshape(n, -1)[:, :dim]


def pack_inband(rows: torch.Tensor, fmt: str, *,
                stochastic: bool = False) -> torch.Tensor:
    """(n, d) float rows -> the wire payload (n, rows_wire_width(d, fmt)):
    fp32 as given, bf16 rounded to nearest even and viewed as int16, int8
    with its scales in band (`stochastic`: the dither's rounding, int8
    only)."""
    if fmt == "fp32":
        return rows
    if fmt == "bf16":
        return rows.to(torch.bfloat16).view(torch.int16)
    return _quantize_int8(rows.to(torch.float32), stochastic=stochastic)


def unpack_inband(wire: torch.Tensor, dim: int, fmt: str) -> torch.Tensor:
    """Inverse of `pack_inband` -> (n, dim) float32 (callers cast to their
    table's dtype)."""
    if fmt == "int8":
        return _dequantize_int8(wire, dim)
    if fmt == "bf16":
        return wire.contiguous().view(torch.bfloat16).float()
    return wire.float()


def residual(x: torch.Tensor, wire: torch.Tensor, dim: int,
             fmt: str) -> torch.Tensor:
    """x - unpack_inband(wire), the error feedback's new residual, rounded
    once. For int8 that is x - q * scale as one fused multiply-add, which
    XLA makes of the JAX package's expression: the product of an int8 code
    and a float32 scale is exact in float64, and so is its difference with
    x (the two lie within a factor of 2^8 of each other), so the float64
    difference rounded to float32 is the fused result."""
    if fmt != "int8":
        return x - unpack_inband(wire, dim, fmt)
    n = wire.shape[0]
    nb = scale_blocks(dim)
    scale = wire[:, dim:dim + _SCALE_LANES * nb].contiguous().view(
        torch.float32).reshape(n, nb).double()
    qb = _blocks(wire[:, :dim].to(torch.float64))
    deq = (qb * scale[:, :, None]).reshape(n, -1)[:, :dim]
    return (x.double() - deq).to(torch.float32)


# -- the sparse top-k payload (the ZeRO dense wire "sparse_topk") -------------

# int8 lanes of one transmitted element's int32 column index
_INDEX_LANES = 4


def topk_wire_width(k: int) -> int:
    """Wire columns of one top-k payload row in the int8 carrier: k value
    lanes, their in-band scale lanes, and 4 index lanes a value (about
    5.125 bytes a transmitted element)."""
    return rows_wire_width(k, "int8") + _INDEX_LANES * k


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(n, m) -> (n, k) int64: each row's k largest |x| in `lax.top_k`'s
    order, descending with ties to the lower index. A stable descending
    sort gives that order on every device; `torch.topk` leaves the order
    of ties unspecified, and the codec's scale blocks group the values in
    this order, so it would change the bytes."""
    order = torch.sort(x.abs(), dim=1, descending=True, stable=True).indices
    return order[:, :k]


def pack_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """(n, m) float32 -> (n, topk_wire_width(k)) int8: per row the k
    largest-magnitude elements (`topk_indices`' order), int8-quantized
    with in-band float32 scales per INBAND_BLOCK values (a partial block
    pads as the row codec does), then their int32 column indices as 4
    little-endian int8 lanes each, as JAX's `bitcast_convert_type` lays
    them out. 1 <= k <= m; the indices of a row are distinct, so the
    decode's scatter never collides."""
    n, m = x.shape
    if not 1 <= k <= m:
        raise ValueError(f"pack_topk: k={k} outside [1, {m}]")
    idx = topk_indices(x, k)
    q = _quantize_int8(torch.gather(x, 1, idx).to(torch.float32))
    lanes = idx.to(torch.int32).contiguous().view(torch.int8).reshape(
        n, _INDEX_LANES * k)
    return torch.cat([q, lanes], dim=1)


def unpack_topk(wire: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Inverse of `pack_topk` -> dense (n, m) float32, every untransmitted
    element exactly 0."""
    n = wire.shape[0]
    body = rows_wire_width(k, "int8")
    vals = _dequantize_int8(wire[:, :body], k)
    idx = wire[:, body:].contiguous().view(torch.int32).reshape(n, k)
    out = torch.zeros((n, m), dtype=torch.float32, device=wire.device)
    return out.scatter_(1, idx.long(), vals)


def encode_grads(grads: torch.Tensor, counts: torch.Tensor, fmt: str, *,
                 stochastic: bool = False) -> torch.Tensor:
    """(n, d) float grads and (n,) int32 counts -> (n, grads_wire_width)
    wire rows; the counts ride bit for bit, the grads as `pack_inband`
    codes them."""
    g = pack_inband(grads.float() if fmt != "bf16" else grads, fmt,
                    stochastic=stochastic)
    return torch.cat([g, counts_to_lanes(counts, fmt)], dim=1)


def decode_grads(wire: torch.Tensor, dim: int,
                 fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ((n, dim) float32 grads, (n,) int32 counts)."""
    body = rows_wire_width(dim, fmt)
    return (unpack_inband(wire[:, :body], dim, fmt),
            lanes_to_counts(wire[:, body:]))


# -- host codecs (numpy), copies of the JAX package's `np_encode_rows` and
# `np_decode_rows`: bf16 as uint16 words rounded to nearest even, int8 per
# block with the scales' bytes in band --------------------------------------


def np_encode_rows(rows: np.ndarray, fmt: str) -> np.ndarray:
    """(n, d) float rows -> the host payload (n, rows_wire_width(d, fmt))."""
    rows = np.ascontiguousarray(rows, np.float32)
    if fmt == "fp32":
        return rows
    if fmt == "bf16":
        u = rows.view(np.uint32)
        bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
        return ((u + bias) >> np.uint32(16)).astype(np.uint16)
    n, dim = rows.shape
    nb = scale_blocks(dim)
    pad = nb * INBAND_BLOCK - dim
    xb = (np.pad(rows, ((0, 0), (0, pad))) if pad else rows) \
        .reshape(n, nb, INBAND_BLOCK)
    amax = np.max(np.abs(xb), axis=2)
    scale = (amax / 127.0).astype(np.float32)
    inv = np.zeros_like(scale)
    np.divide(np.float32(1.0), scale, out=inv, where=scale > 0)
    q = np.clip(np.rint(xb * inv[:, :, None]), -127, 127).astype(np.int8)
    q = q.reshape(n, nb * INBAND_BLOCK)[:, :dim]
    lanes = np.ascontiguousarray(scale).view(np.int8).reshape(
        n, nb * _SCALE_LANES)
    return np.concatenate([q, lanes], axis=1)


def np_decode_rows(wire: np.ndarray, dim: int, fmt: str) -> np.ndarray:
    """Inverse of `np_encode_rows` -> (n, dim) float32."""
    if fmt == "fp32":
        return np.asarray(wire, np.float32)
    if fmt == "bf16":
        u16 = np.ascontiguousarray(wire, dtype=np.uint16)
        return (u16.astype(np.uint32) << np.uint32(16)).view(np.float32)
    w = np.ascontiguousarray(wire, dtype=np.int8)
    n = w.shape[0]
    nb = scale_blocks(dim)
    scale = np.ascontiguousarray(
        w[:, dim:dim + _SCALE_LANES * nb]).view(np.float32).reshape(n, nb)
    pad = nb * INBAND_BLOCK - dim
    q = w[:, :dim].astype(np.float32)
    qb = np.pad(q, ((0, 0), (0, pad))) if pad else q
    out = qb.reshape(n, nb, INBAND_BLOCK) * scale[:, :, None]
    return np.ascontiguousarray(out.reshape(n, nb * INBAND_BLOCK)[:, :dim])


def np_wire_dtype(fmt: str):
    """The numpy dtype an encoded row payload is stored and shipped as
    (bf16 as uint16 words: numpy has no bfloat16)."""
    return {"fp32": np.float32, "bf16": np.uint16, "int8": np.int8}[fmt]


# -- static wire-cost models (bytes a rank ships a step) ----------------------


_NP_NAMES = {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}


def id_wire_itemsize(pair: bool, itemsize: int) -> int:
    """Bytes of one bucket slot of the id exchange: 8 for the JAX package's
    split pair, the id's own itemsize otherwise."""
    return 8 if pair else itemsize


def exchange_cost(tables, num_shards: int, fmt: str,
                  fused: bool = True) -> dict:
    """The bytes one rank ships through the three all_to_alls of a step
    (the JAX package's model, the receive volume being symmetric).
    `tables`: [{dim, cap, pair, id_itemsize}] (an optional per-table
    "fmt"); tables sharing (dim, fmt) form one dim-group. `bytes_scales`:
    the int8 scale lanes, already in the row and grad totals."""
    S = num_shards
    groups: dict = {}
    for t in tables:
        groups.setdefault((t["dim"], t.get("fmt", fmt)), []).append(t)
    n_units = len(groups) if fused else len(tables)
    bytes_ids = bytes_rows = bytes_grads = bytes_scales = 0
    for (dim, tf), members in groups.items():
        pair_wire = any(m["pair"] for m in members)
        iid = max(m["id_itemsize"] for m in members)
        tw = _itemsize(tf)
        for m in members:
            cap = m["cap"]
            per_id = (id_wire_itemsize(pair_wire, iid) if fused
                      else id_wire_itemsize(m["pair"], m["id_itemsize"]))
            bytes_ids += S * cap * per_id
            bytes_rows += S * cap * rows_wire_width(dim, tf) * tw
            bytes_grads += S * cap * grads_wire_width(dim, tf) * tw
            if tf == "int8":
                bytes_scales += S * cap * _SCALE_LANES * scale_blocks(dim) \
                    * tw * 2
    total = bytes_ids + bytes_rows + bytes_grads
    return {"format": fmt, "num_shards": S, "fused": fused,
            "dim_groups": len(groups), "tables": len(tables),
            "wire_dtype": _NP_NAMES[fmt],
            "wire_itemsize": _itemsize(fmt),
            "collectives_per_step": 3 * n_units if S > 1 else 0,
            "bytes_ids": int(bytes_ids), "bytes_rows": int(bytes_rows),
            "bytes_grads": int(bytes_grads),
            "bytes_scales": int(bytes_scales) if S > 1 else 0,
            "bytes_per_step": int(total) if S > 1 else 0}


def conflict_patch_cost(tables, num_shards: int, fmt: str) -> dict:
    """The bytes one rank ships through the pipelined loop's conflict patch
    (`parallel/sharded.grouped_conflict_patch`), the JAX package's model:
    one all_to_all a (dim, fmt) group of `pcap` rows per (source, owner)
    pair, in the push codec (the row and the count lanes that carry its
    slot + 1). `tables`: [{dim, cap, pcap}] (an optional per-table "fmt"),
    `pcap` from `parallel/sharded.conflict_patch_cap`. These are the only
    bytes pipelining adds to the serial exchange."""
    S = num_shards
    groups: dict = {}
    for t in tables:
        groups.setdefault((t["dim"], t.get("fmt", fmt)), []).append(t)
    bytes_patch = 0
    for (dim, tf), members in groups.items():
        for m in members:
            bytes_patch += S * m["pcap"] * grads_wire_width(dim, tf) \
                * _itemsize(tf)
    return {"format": fmt, "num_shards": S,
            "collectives": len(groups) if S > 1 else 0,
            "bytes_patch": int(bytes_patch) if S > 1 else 0}


def hot_reduce_cost(hot_rows_by_table, num_shards: int, fmt: str) -> dict:
    """The bytes a rank moves for the hot rows' gradient reduce
    (`parallel/sharded._hot_apply`), the JAX package's model: fp32 and
    bf16 a ring all-reduce of the (H, dim) aggregate, 2 (S - 1) / S * H *
    dim * itemsize; int8 an all_to_all and an all_gather of the encoded
    (Hp, W) buffer (Hp = H rounded up to a multiple of S). The exact int32
    counts' reduce (H * 4 bytes a ring) is in `bytes` for every format.
    `hot_rows_by_table`: [{dim, hot}]."""
    S = num_shards
    ring = 2 * (S - 1) / S if S > 1 else 0
    total = a2a = ag = 0
    for t in hot_rows_by_table:
        H, dim = t["hot"], t["dim"]
        if H <= 0 or S <= 1:
            continue
        total += int(ring * H * 4)
        if fmt == "int8":
            Hp = -(-H // S) * S
            W = rows_wire_width(dim, "int8")
            a2a += Hp * W
            ag += Hp * W
            total += 2 * Hp * W
        else:
            total += int(ring * H * dim * _itemsize(fmt))
    return {"format": fmt, "bytes": int(total),
            "a2a_bytes": int(a2a), "all_gather_bytes": int(ag)}


def sync_delta_cost(tables, fmt: str) -> dict:
    """Bytes of shipping one committed delta to a serving replica
    (`sync/publisher.py` serves it, `utils/metrics.observe_sync_cost`
    publishes it): per table {name: (touched_rows, dim)}, ids as exact int64
    (8 B a row) and rows in the wire format, in-band scale lanes included
    (`bytes_scales` breaks them out). Optimizer slots never ride the sync
    wire."""
    bytes_ids = bytes_rows = bytes_scales = rows_total = 0
    w = np.dtype(np_wire_dtype(fmt)).itemsize
    for _name, (n, dim) in tables.items():
        bytes_ids += n * 8
        bytes_rows += n * rows_wire_width(dim, fmt) * w
        if fmt == "int8":
            bytes_scales += n * _SCALE_LANES * scale_blocks(dim) * w
        rows_total += n
    return {"format": fmt, "rows": int(rows_total),
            "wire_dtype": str(np.dtype(np_wire_dtype(fmt))),
            "bytes_ids": int(bytes_ids), "bytes_rows": int(bytes_rows),
            "bytes_scales": int(bytes_scales),
            "bytes_total": int(bytes_ids + bytes_rows)}
