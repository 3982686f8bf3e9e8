"""Persistence over the port's mesh at S = 4 gloo ranks on the CPU (see
`tests/test_torch_persist_mesh.py` for S = 2 and the configurations).

An array and a hash table persisted incrementally at S = 4 restore on
every rank bit-equal to the live state (the hash table by id), and so is
the step after; the delta holds one file a rank. The same roots restore
on one device, equal by id to the assembled live state. A root the JAX
MeshTrainer wrote on four devices of one process restores at S = 4 ranks
equal to the JAX run's live state, array for array (the same shard-major
layout).
"""

from openembedding_tpu_torch import convert
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_persist_ranks as ranks
from test_torch_persist_mesh import (CAPACITY, STEPS, VOCAB, assert_same,
                                     assert_same_dense, batches, by_id,
                                     jax_root, single_device_restore)


def test_mesh_persist_s4(tmp_path):
    S = 4
    cfgs = [{"vocab": VOCAB, "batches": batches(hashed), "steps": STEPS,
             "every": 2, "full_every": 2, "root": str(tmp_path / name),
             "hashed": hashed, "capacity": CAPACITY if hashed else 0}
            for name, hashed in (("array", False), ("hash", True))]
    jroot = str(tmp_path / "jax4")
    jax_live = jax_root(jroot, S=4)
    out = run_local(ranks.cases, S, args=(
        cfgs, [{"vocab": VOCAB, "batches": batches(), "root": jroot}]),
        timeout_s=150, tmp_dir=str(tmp_path))
    for i, cfg in enumerate(cfgs):
        per_rank = [r["runs"][i] for r in out]
        for r in per_rank:
            what = f"{cfg['root']} rank {r['rank']}"
            assert r["unequal"] == [] and r["unequal_next"] == [], what
            assert r["same_next_loss"], what
            # full_every=2: a base, then two deltas before the next base
            assert [h[0] for h in r["history"]] == ["full", "delta",
                                                    "delta"], what
        files = per_rank[0]["files"]
        delta = "delta_000000000004"
        assert sorted(k for k in files if k.startswith(f"{delta}/table")) \
            == [f"{delta}/table_categorical.p{r}.npz" for r in range(S)]
        assert all(f"{delta}/done.{r}" in files for r in range(S))
        live = convert.mesh_state_to_jax([r["live"] for r in per_rank])
        got = single_device_restore(cfg["root"], cfg["hashed"])
        assert got["step"] == STEPS
        assert_same(by_id(got, 1, cfg["hashed"]),
                    by_id(live, S, cfg["hashed"]), cfg["root"])
        assert_same_dense(got, live, cfg["root"])

    port = convert.mesh_state_to_jax([r["restores"][0] for r in out])
    assert port["step"] == jax_live["step"] == STEPS
    t, j = port["tables"]["categorical"], jax_live["tables"]["categorical"]
    assert t["weights"].tobytes() == j["weights"].tobytes()
    assert t["slots"]["accum"].tobytes() == j["slots"]["accum"].tobytes()
    assert_same_dense(port, jax_live, "jax4 -> port S=4")
