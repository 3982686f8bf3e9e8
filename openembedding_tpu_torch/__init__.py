"""openembedding_tpu_torch — the PyTorch/CUDA port of `openembedding_tpu`.

The port keeps the JAX package's module names so each counterpart is easy to
find (`embedding.py` <-> `embedding.py`, `ops/sparse.py` <-> `ops/sparse.py`).
It imports `torch` and numpy only, never `jax` or `openembedding_tpu`.

Slice 1 is standalone serving of the CTR model zoo's DeepFM: export, load,
lookup, predict and the REST surface. Slice 2 is single-device training of
the same model (`model.Trainer`, `optimizers`, `checkpoint`). Later slices
add the CUDA-graph drivers, the Criteo entry points
(`examples/criteo_deepctr.py`, `examples/criteo_lr_subclass.py`), hashed
tables (`tables/hash_table.py`), the zoo's CTR families (`models/`), the
mesh (`parallel/`), async persistence (`persist.py`: full persists and
touched-row deltas, restored on one device or over the mesh's ranks),
host-cached tables (`tables/host_offload.py`: a device cache in front of
the whole table in host RAM), and online sync and live replicas (`sync/`:
a persist root's deltas published to serving nodes, applied into new
servables and swapped in; `serving.MicroBatcher`,
`serving.restore_from_peer`), and sharded serving
(`parallel/serving.py`: a checkpoint served from table shards on a list
of devices, `shard_num > 1` on a serving node), and the ingest path
(`data/ingest.py`: file-sharded streaming, a parse pool, a device feed
ring into `parallel.MeshTrainer.train_stream`), remote storage
(`utils/fs.py`: registered URI schemes through save, load and serving),
the YAML configuration tree (`config.py`) and the runtime guards
(`utils/guards.py`).
The device kernels are hand-written CUDA: the row gather
(`csrc/gather_rows.cu`, wrapper `ops/gather.py`), the window gather
(`csrc/gather_rows_windows.cu`) and the fused sparse optimizer apply
(`csrc/fused_sparse_apply.cu`, wrapper `ops/apply.py`).

Entry points run on the card unless the caller passes `device="cpu"`;
with `device=None` and no CUDA device they raise instead of falling back.
"""

from . import config
from .config import EnvConfig, Flags
from .device import resolve_device
from .persist import (AsyncPersister, IncrementalPersister, PersistPolicy,
                      persist_server_model, restore_server_model)

__all__ = ["config", "EnvConfig", "Flags", "resolve_device",
           "AsyncPersister", "IncrementalPersister", "PersistPolicy",
           "persist_server_model", "restore_server_model"]
