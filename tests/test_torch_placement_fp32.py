"""Placement against no placement inside the port, at the fp32 wire.

6 MeshTrainer steps of an array table on two gloo ranks (the fused and the
per-table exchange): with hot rows, with migrated rows and with both (the
sets changed before steps 0 and 3), the losses, the whole state after
`hot_sync` and the files of a sharded save equal those of the same steps
without placement, bit for bit. The hot reduce sums the ranks in the order
the owner's segment sum does, and the annex takes the home row's reduction.
Not for a hash table: promoting or migrating an id inserts it at another
time than its first pull would, so it may take another slot, whose row the
initializer drew otherwise (the JAX package's hash tables do the same;
`test_torch_hot.py` and `test_torch_migration.py` hold the port's to
them).

At S = 1 every placement argument is inert, as in the JAX package: no
cache, directory or residuals, training equal to a run without them bit
for bit, and `make_plan` refuses a cache or a directory with the JAX
package's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openembedding_tpu.embedding import EmbeddingSpec as JaxSpec
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import sharded as jax_sharded
from openembedding_tpu_torch import data
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

TIMEOUT = 60


def _cfg(kind, hot, mig, tmp):
    hashed = kind == "hash"
    batches = list(data.synthetic_criteo(
        64, id_space=(1 << 40) if hashed else 1000, steps=6, seed=7))
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in batches])
    u, c = np.unique(ids, return_counts=True)
    top = u[np.argsort(-c, kind="stable")]
    return {"vocab": 1000, "hashed": hashed, "capacity": 4096,
            "wire": "fp32", "hot_rows": hot, "mig_rows": mig,
            "batches": batches, "tmp": str(tmp),
            "hot_ids": {0: top[:16], 3: top[8:24]},
            "moves": {0: (top[30:38], (top[30:38] + 1) % 2),
                      3: (top[40:46], (top[40:46] + 1) % 2)}}


@pytest.mark.parametrize("hot,mig,grouped", [(16, 0, True), (0, 8, True),
                                             (16, 8, True), (16, 8, False)])
def test_placement_at_fp32_equals_no_placement_bit_for_bit(hot, mig, grouped,
                                                           tmp_path):
    cfg = {**_cfg("array", hot, mig, tmp_path / "ckpt"), "grouped": grouped}
    out = run_local(ranks.placement_vs_plain, 2, args=(cfg,),
                    timeout_s=TIMEOUT, tmp_dir=str(tmp_path))
    for r in out:
        assert r["same_losses"] and r["same_state"], r
    assert out[0]["same_files"]
    if hot:
        assert out[0]["stats"]["categorical/hot_hits"] > 0
    if mig:
        assert out[0]["stats"]["categorical/mig_hits"] > 0


def test_placement_is_inert_at_one_rank(tmp_path):
    cfg = {**_cfg("array", 16, 8, tmp_path), "wire": "int8"}
    out = run_local(ranks.inert_at_one_rank, 1, args=(cfg,),
                    timeout_s=TIMEOUT, tmp_dir=str(tmp_path))[0]
    assert out["no_state"] and out["flags"] == [False, False, False]
    assert out["same_losses"] and out["same_state"]
    # the JAX package's refusals, word for word
    spec = JaxSpec(name="v", input_dim=1000, output_dim=10)
    want = []
    for kw in ("hot", "mig"):
        try:
            jax.shard_map(lambda ids: jax_sharded.make_plan(
                spec, ids, **{kw: object()}).uniq.counts,
                mesh=jax_make_mesh(jax.devices()[:1]),
                in_specs=jax.sharding.PartitionSpec("data"),
                out_specs=jax.sharding.PartitionSpec("data"))(
                    jnp.zeros(8, jnp.int64))
        except ValueError as e:
            want.append(str(e))
    assert out["refusals"] == want and len(want) == 2
