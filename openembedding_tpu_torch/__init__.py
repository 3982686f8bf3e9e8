"""openembedding_tpu_torch — the PyTorch/CUDA port of `openembedding_tpu`.

The port keeps the JAX package's module names so each counterpart is easy to
find (`embedding.py` <-> `embedding.py`, `ops/sparse.py` <-> `ops/sparse.py`).
It imports `torch` and numpy only, never `jax` or `openembedding_tpu`.

Slice 1 is standalone serving of the CTR model zoo's DeepFM: export, load,
lookup, predict and the REST surface. Slice 2 is single-device training of
the same model (`model.Trainer`, `optimizers`, `checkpoint`). Both device
kernels are hand-written CUDA: the row gather (`csrc/gather_rows.cu`,
wrapper `ops/gather.py`) and the fused sparse optimizer apply
(`csrc/fused_sparse_apply.cu`, wrapper `ops/apply.py`).

Entry points run on the card unless the caller passes `device="cpu"`;
with `device=None` and no CUDA device they raise instead of falling back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
