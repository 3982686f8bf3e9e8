"""The yardstick's arithmetic: the card's published peaks, and the operations
and compulsory bytes of the training step and of its kernels, from the
configuration's shapes and the counts of the batch's ids.

Compulsory bytes count each input byte read once and each output byte
written once, whatever a kernel reads again; data-dependent work is counted
for these inputs (the ids a batch really holds once deduplicated).
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, published dense peaks at the full 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

ID_BYTES = 8      # int64 ids and slots
COUNT_BYTES = 4   # int32 counts
F32 = 4


def peak(kind: str) -> Dict[str, float]:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def tower_layers(config: dict, num_dense: int, num_fields: int) -> list:
    """(in, out) of every matmul of the DeepFM tower: the linear term over
    the dense features and the MLP layers."""
    out = [(num_dense, 1)]
    width = num_dense + num_fields * config["dim"]
    for h in list(config["hidden"]) + [1]:
        out.append((width, h))
        width = h
    return out


def step_flops(config: dict, batch: int, num_dense: int,
               num_fields: int) -> float:
    """Model operations of one training step: each matmul's 2*B*in*out
    forward, twice that backward (the input's gradient and the weight's).
    The FM term and the elementwise work are left out (under 1%)."""
    fwd = sum(2.0 * batch * i * o
              for i, o in tower_layers(config, num_dense, num_fields))
    return 3.0 * fwd


def dense_params(config: dict, num_dense: int, num_fields: int) -> int:
    return sum(i * o + o for i, o in tower_layers(config, num_dense,
                                                  num_fields))


def row_bytes(config: dict) -> int:
    """One table row: the first-order weight and the latent vector."""
    return (config["dim"] + 1) * F32


def step_bytes(config: dict, batch: int, num_dense: int, num_fields: int,
               unique: int) -> float:
    """Compulsory bytes of one training step with `unique` distinct ids:
    the batch read once (ids, dense features, labels); each touched row's
    weights and accumulator read and written once; a hashed table's key of
    each touched slot read once; the tower's parameters and accumulators
    read and written once."""
    inputs = batch * (num_fields * ID_BYTES + num_dense * F32 + F32)
    rows = unique * row_bytes(config) * 4
    keys = unique * ID_BYTES if config["hashed"] else 0
    dense = dense_params(config, num_dense, num_fields) * F32 * 4
    return float(inputs + rows + keys + dense)


def gather_bytes(config: dict, n: int, unique: int) -> float:
    """The pull's gather: n row indices read, each distinct row read once,
    n rows written."""
    return float(n * ID_BYTES + unique * row_bytes(config)
                 + n * row_bytes(config))


def apply_bytes(config: dict, unique: int) -> float:
    """The fused apply over the deduplicated rows: their ids, counts and
    summed gradients read, their weights and accumulators read and written
    once."""
    return float(unique * (ID_BYTES + COUNT_BYTES + row_bytes(config)
                           + 4 * row_bytes(config)))


def least_seconds(flops: float, nbytes: float, kind: str) -> tuple:
    """-> (the least time the card could take, "flops" or "bytes": which
    bound holds)."""
    p = peak(kind)
    tf, tb = flops / p["bf16_flops"], nbytes / p["hbm_bytes_s"]
    return (tf, "flops") if tf >= tb else (tb, "bytes")
