"""Sparse embedding optimizers as row-update functions.

Port of `openembedding_tpu/optimizers.py`: the same nine rules (Default,
SGD/Momentum, Adagrad, Adadelta, Adam, Adamax, Ftrl, RMSprop and the
deterministic TestOptimizer), the same slot layout, config dicts and
registry. `apply(weights, slots, grads, counts)` maps float32 rows to new
rows; rows with `counts == 0` come back bit-identical (`_masked`).

Each rule keeps the JAX rule's operation order, so that every operation
rounds once at the same place:

- hyperparameters are folded on the host in double exactly as the JAX rule
  folds them (`1 - rho`, `2 * adjusted_l2`, Ftrl's `beta / lr / 2`), listed
  by `hyper()`, and enter the tensor math as float32 scalars; the CUDA
  kernel (`ops/apply.py`) takes the same `hyper()` values;
- every square root goes through `sqrt`, which is correctly rounded on
  every device (`torch.sqrt` on float32 CPU tensors is not);
- a Python number is never the left operand of `/` (torch computes
  `c / x` as `reciprocal(x) * c`), and Ftrl divides by a tensor filled with
  the learning rate rather than by a Python number (a CUDA tensor divided
  by a host scalar is multiplied by its reciprocal).

Run op by op, each rule is bit-exact against the JAX rule run under
`jax.disable_jit()`; against the jitted JAX rule it differs where XLA
contracts a multiply-add (tests/test_torch_optimizers.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Type

import torch

Slots = Dict[str, torch.Tensor]

_REGISTRY: Dict[str, Type["SparseOptimizer"]] = {}


def _register(cls):
    _REGISTRY[cls.category] = cls
    return cls


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root of a float32 tensor through the double root, rounded
    once more to float32. On the card the double root is correctly
    rounded, and 53 bits make that second rounding exact. On the CPU ATen
    takes the double root from MKL's vector math, which can be one double
    ulp off; the float32 result then differs only where the root lies
    within that ulp of a float32 rounding midpoint."""
    return torch.sqrt(x.double()).to(x.dtype)


def _div_full(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c in float32 as a true division, on every device."""
    return x / torch.full_like(x, c)


def _rdiv_full(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x in float32 as a true division, on every device."""
    return torch.full_like(x, c) / x


def _masked(mask, new, old):
    """Rows not touched this step stay bit-identical (padding rows of the
    static unique-id buffer and rows whose count is 0)."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Base: a subclass gives its slot layout, its row update and its
    kernel description (`rule`, `hyper()`).

    `slot_shapes(dim)` -> {name: row width}, in the order the kernel takes
    the slots; slots are (num_rows, width) float32 tensors."""

    category = ""
    rule = -1  # the rule's number in csrc/fused_sparse_apply.cu

    def slot_shapes(self, dim: int) -> Dict[str, int]:
        return {}

    def slot_init(self, name: str) -> float:
        return 0.0

    def hyper(self) -> Tuple[float, ...]:
        """The rule's float constants, folded in double, in kernel order."""
        return ()

    def init_slots(self, num_rows: int, dim: int, dtype=torch.float32,
                   device=None) -> Slots:
        """Every row's slots at their initial value. Slots are float32 even
        for bfloat16 tables (0.999 rounds to 1.0 in bfloat16); `dtype` is
        honoured only when it is at least 4 bytes wide."""
        if torch.empty((), dtype=dtype).element_size() < 4:
            dtype = torch.float32
        return {name: torch.full((num_rows, width), self.slot_init(name),
                                 dtype=dtype, device=device)
                for name, width in self.slot_shapes(dim).items()}

    def apply(self, weights: torch.Tensor, slots: Slots, grads: torch.Tensor,
              counts: torch.Tensor) -> Tuple[torch.Tensor, Slots]:
        """weights/grads: (n, dim) float32; counts: (n,) int, 0 = padding
        row (left as it is). Returns (new_weights, new_slots)."""
        raise NotImplementedError

    def to_config(self) -> dict:
        d = dataclasses.asdict(self)
        d["category"] = self.category
        return d


@_register
@dataclasses.dataclass(frozen=True)
class Default(SparseOptimizer):
    """Stateless SGD; lr=0 means pull-only serving tables."""

    category = "default"
    rule = 0
    learning_rate: float = 0.0

    def hyper(self):
        return (self.learning_rate,)

    def apply(self, weights, slots, grads, counts):
        (lr,) = self.hyper()
        mask = counts > 0
        new_w = weights - lr * grads
        return _masked(mask, new_w, weights), slots


@_register
@dataclasses.dataclass(frozen=True)
class SGD(SparseOptimizer):
    """SGD with momentum/nesterov (Keras: moment = moment*mu + lr*grad)."""

    category = "sgd"
    rule = 1
    learning_rate: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False

    def slot_shapes(self, dim):
        return {"moment": dim}

    def hyper(self):
        return (self.learning_rate, self.momentum,
                1.0 if self.nesterov else 0.0)

    def apply(self, weights, slots, grads, counts):
        lr, mu, _ = self.hyper()
        mask = counts > 0
        moment = slots["moment"] * mu + lr * grads
        if self.nesterov:
            new_w = weights - (moment * mu + lr * grads)
        else:
            new_w = weights - moment
        return (_masked(mask, new_w, weights),
                {"moment": _masked(mask, moment, slots["moment"])})


def Momentum(learning_rate=0.01, momentum=0.9, nesterov=False) -> SGD:
    return SGD(learning_rate=learning_rate, momentum=momentum,
               nesterov=nesterov)


@_register
@dataclasses.dataclass(frozen=True)
class Adagrad(SparseOptimizer):
    """accum += g^2; w -= (lr * g) / (sqrt(accum) + eps)."""

    category = "adagrad"
    rule = 2
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    epsilon: float = 1e-7

    def slot_shapes(self, dim):
        return {"accum": dim}

    def slot_init(self, name):
        return self.initial_accumulator_value

    def hyper(self):
        return (self.learning_rate, self.epsilon)

    def apply(self, weights, slots, grads, counts):
        lr, eps = self.hyper()
        mask = counts > 0
        accum = slots["accum"] + grads * grads
        new_w = weights - lr * grads / (sqrt(accum) + eps)
        return (_masked(mask, new_w, weights),
                {"accum": _masked(mask, accum, slots["accum"])})


@_register
@dataclasses.dataclass(frozen=True)
class Adadelta(SparseOptimizer):
    category = "adadelta"
    rule = 3
    learning_rate: float = 0.001
    rho: float = 0.95
    epsilon: float = 1e-7

    def slot_shapes(self, dim):
        return {"accum": dim, "accum_update": dim}

    def hyper(self):
        return (self.learning_rate, self.rho, 1 - self.rho, self.epsilon)

    def apply(self, weights, slots, grads, counts):
        lr, rho, one_m_rho, eps = self.hyper()
        mask = counts > 0
        accum = slots["accum"] * rho + grads * grads * one_m_rho
        update = (grads * sqrt(slots["accum_update"] + eps)
                  / sqrt(accum + eps))
        accum_update = (slots["accum_update"] * rho
                        + update * update * one_m_rho)
        new_w = weights - lr * update
        return (_masked(mask, new_w, weights),
                {"accum": _masked(mask, accum, slots["accum"]),
                 "accum_update": _masked(mask, accum_update,
                                         slots["accum_update"])})


@_register
@dataclasses.dataclass(frozen=True)
class Adam(SparseOptimizer):
    """Keras Adam with per-row beta^t: lr_t = lr*sqrt(1-b2^t)/(1-b1^t);
    w -= lr_t * m / (sqrt(v) + eps). The beta powers advance only on
    touched rows."""

    category = "adam"
    rule = 4
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7

    def slot_shapes(self, dim):
        return {"m": dim, "v": dim, "beta_1_t": 1, "beta_2_t": 1}

    def slot_init(self, name):
        return 1.0 if name in ("beta_1_t", "beta_2_t") else 0.0

    def hyper(self):
        return (self.learning_rate, self.beta_1, self.beta_2,
                1 - self.beta_1, 1 - self.beta_2, self.epsilon)

    def apply(self, weights, slots, grads, counts):
        lr, b1, b2, one_m_b1, one_m_b2, eps = self.hyper()
        mask = counts > 0
        b1t = slots["beta_1_t"] * b1
        b2t = slots["beta_2_t"] * b2
        lr_t = lr * sqrt(1 - b2t) / (1 - b1t)  # (n, 1)
        m = slots["m"] * b1 + grads * one_m_b1
        v = slots["v"] * b2 + grads * grads * one_m_b2
        new_w = weights - lr_t * m / (sqrt(v) + eps)
        return (_masked(mask, new_w, weights),
                {"m": _masked(mask, m, slots["m"]),
                 "v": _masked(mask, v, slots["v"]),
                 "beta_1_t": _masked(mask, b1t, slots["beta_1_t"]),
                 "beta_2_t": _masked(mask, b2t, slots["beta_2_t"])})


@_register
@dataclasses.dataclass(frozen=True)
class Adamax(SparseOptimizer):
    category = "adamax"
    rule = 5
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7

    def slot_shapes(self, dim):
        return {"m": dim, "v": dim, "beta_1_t": 1}

    def slot_init(self, name):
        return 1.0 if name == "beta_1_t" else 0.0

    def hyper(self):
        return (self.learning_rate, self.beta_1, self.beta_2,
                1 - self.beta_1, self.epsilon)

    def apply(self, weights, slots, grads, counts):
        lr, b1, b2, one_m_b1, eps = self.hyper()
        mask = counts > 0
        b1t = slots["beta_1_t"] * b1
        lr_t = _rdiv_full(lr, 1 - b1t)  # (n, 1)
        m = slots["m"] * b1 + grads * one_m_b1
        v = torch.maximum(torch.abs(grads), slots["v"] * b2)
        new_w = weights - lr_t * m / (v + eps)
        return (_masked(mask, new_w, weights),
                {"m": _masked(mask, m, slots["m"]),
                 "v": _masked(mask, v, slots["v"]),
                 "beta_1_t": _masked(mask, b1t, slots["beta_1_t"])})


@_register
@dataclasses.dataclass(frozen=True)
class Ftrl(SparseOptimizer):
    """Full TF FTRL: l1/l2, l2-shrinkage, beta, and the general
    lr_power != -0.5 path (accum_new adds grad^2, not the shrinkage-adjusted
    g^2, as TF does)."""

    category = "ftrl"
    rule = 6
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0
    l2_shrinkage_regularization_strength: float = 0.0
    learning_rate_power: float = -0.5
    beta: float = 0.0

    def slot_shapes(self, dim):
        return {"accum": dim, "linear": dim}

    def slot_init(self, name):
        return self.initial_accumulator_value if name == "accum" else 0.0

    def hyper(self):
        adjusted_l2 = (self.l2_regularization_strength
                       + self.beta / self.learning_rate / 2)
        return (self.learning_rate, self.l1_regularization_strength,
                2 * adjusted_l2,
                2 * self.l2_shrinkage_regularization_strength,
                -self.learning_rate_power,
                1.0 if self.learning_rate_power == -0.5 else 0.0)

    def apply(self, weights, slots, grads, counts):
        lr, l1, two_adjusted_l2, two_shrinkage, p, _ = self.hyper()
        mask = counts > 0
        accum, linear = slots["accum"], slots["linear"]
        g = grads + two_shrinkage * weights
        accum_new = accum + grads * grads
        if self.learning_rate_power == -0.5:
            sigma = _div_full(sqrt(accum_new) - sqrt(accum), lr)
            quadratic = _div_full(sqrt(accum_new), lr) + two_adjusted_l2
        else:
            sigma = _div_full(torch.pow(accum_new, p) - torch.pow(accum, p),
                              lr)
            quadratic = _div_full(torch.pow(accum_new, p), lr) \
                + two_adjusted_l2
        linear_new = linear + g - sigma * weights
        l1_reg_adjust = torch.clamp(linear_new, -l1, l1)
        new_w = (l1_reg_adjust - linear_new) / quadratic
        return (_masked(mask, new_w, weights),
                {"accum": _masked(mask, accum_new, accum),
                 "linear": _masked(mask, linear_new, linear)})


@_register
@dataclasses.dataclass(frozen=True)
class RMSprop(SparseOptimizer):
    category = "rmsprop"
    rule = 7
    learning_rate: float = 0.001
    rho: float = 0.9
    momentum: float = 0.0
    epsilon: float = 1e-7

    def slot_shapes(self, dim):
        return {"accum": dim, "moment": dim}

    def hyper(self):
        return (self.learning_rate, self.rho, self.momentum, 1 - self.rho,
                self.epsilon)

    def apply(self, weights, slots, grads, counts):
        lr, rho, mu, one_m_rho, eps = self.hyper()
        mask = counts > 0
        accum = slots["accum"] * rho + grads * grads * one_m_rho
        moment = (slots["moment"] * mu
                  + lr * grads / sqrt(accum + eps))
        new_w = weights - moment
        return (_masked(mask, new_w, weights),
                {"accum": _masked(mask, accum, slots["accum"]),
                 "moment": _masked(mask, moment, slots["moment"])})


@_register
@dataclasses.dataclass(frozen=True)
class TestOptimizer(SparseOptimizer):
    """Deterministic flip-state optimizer of the self-checking tests; the
    only rule that divides by the count."""

    category = "test"
    rule = 8
    learning_rate: float = 0.1
    flip: float = 10000.0
    init: float = 0.0

    def slot_shapes(self, dim):
        return {"flip_state": 1}

    def slot_init(self, name):
        return self.init

    def hyper(self):
        return (self.learning_rate, self.flip)

    def apply(self, weights, slots, grads, counts):
        lr, flip = self.hyper()
        mask = counts > 0
        state = flip - slots["flip_state"]  # (n, 1)
        safe_counts = torch.clamp(counts, min=1).to(weights.dtype)[:, None]
        new_w = weights + lr * grads / safe_counts + state
        return (_masked(mask, new_w, weights),
                {"flip_state": _masked(mask, state, slots["flip_state"])})


def make_optimizer(config: dict) -> SparseOptimizer:
    """Build from {category, **params}, the JAX package's config dict."""
    config = dict(config)
    category = config.pop("category")
    cls = _REGISTRY.get(category)
    if cls is None:
        raise ValueError(f"unknown optimizer category {category!r}")
    return cls(**config)
