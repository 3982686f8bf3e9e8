"""The starting weights, made by the benchmark from the run's seed and handed
to both sides: copied into the program's state in set-up, and made again
by the reference once the window has closed. On the card each is one or a
few large `torch.Generator` draws, so the same seed on the same device gives
the same values whichever tensor they are drawn into.

Plain torch; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_TABLE, _DENSE, _SAMPLE = 1, 2, 3
_SHARD = 100  # shard r of a row-sharded table draws from stream 100 + r


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of the run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def table_rows(config: dict) -> int:
    """Rows of the table on one card: the vocabulary, or a hashed table's
    slots (`capacity` is what one card holds)."""
    return int(config["capacity"] if config["hashed"]
               else config["vocabulary"])


def fill_table(w: torch.Tensor, config: dict, seed: int,
               shard: int = -1) -> torch.Tensor:
    """The table's starting rows, drawn into `w` (rows, dim + 1) in place
    (`shard` r >= 0: shard r's rows of a row-sharded table): column 0, the
    first-order weight, at 0; the latent columns ~ N(0, stddev), the
    model's own initializer."""
    stream = _TABLE if shard < 0 else _SHARD + shard
    torch.randn(w.shape, generator=generator(seed, stream, w.device),
                out=w, dtype=w.dtype, device=w.device)
    w.mul_(config["init"]["latent_stddev"])
    w[:, 0] = 0.0
    return w


def dense_shapes(config: dict, num_dense: int, num_fields: int
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tower parameter, in the order the tower
    declares them: the linear term over the dense features, then the MLP
    layers (weights (out, in))."""
    out = [("linear.weight", (1, num_dense)), ("linear.bias", (1,))]
    width = num_dense + num_fields * config["dim"]
    for i, h in enumerate(list(config["hidden"]) + [1]):
        out += [(f"mlp.layers.{i}.weight", (h, width)),
                (f"mlp.layers.{i}.bias", (h,))]
        width = h
    return out


def dense_params(config: dict, num_dense: int, num_fields: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} of the tower's starting parameters, one draw
    split in order: weights ~ N(0, 1/fan_in), biases ~ N(0, 0.01^2)."""
    shapes = dense_shapes(config, num_dense, num_fields)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, _DENSE, device),
                       device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        scale = (1.0 / math.sqrt(shape[1]) if name.endswith("weight")
                 else 0.01)
        out[name] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return out


def stray_sample(rows: int, n: int, seed: int, device,
                 shard: int = 0) -> torch.Tensor:
    """`n` row indices of the table (of shard `shard`), drawn from the seed,
    whose values the check reads to see that no row outside the batches
    moved."""
    return torch.randint(0, rows, (n,), generator=generator(
        seed, _SAMPLE + 1000 * shard, device), device=device)
