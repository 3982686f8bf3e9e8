"""The port's `parallel.multihost.allgather_host_ids` and
`host_sharded_reader` against the JAX package's.

`allgather_host_ids` runs on 3 gloo ranks (`run_local`), each with its own
seeded id set (duplicates and -1 pads included): every rank gets the union
that the JAX function computes from all the sets, over the mesh and over
the world group alike. `host_sharded_reader` runs here with
`host_id` / `num_hosts` patched on both sides, as `tests/test_multihost.py`
does: rank r of S reads the TSV rows `i % S == r` into local batches of
`global_batch // S`, byte for byte the JAX reader's rows.
"""

import types

import numpy as np
import pytest

from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import multihost as jax_multihost
from openembedding_tpu_torch.parallel import multihost
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_persist_ranks as ranks


def test_allgather_host_ids_is_the_union(tmp_path):
    rng = np.random.default_rng(11)
    sets = [rng.integers(-1, 1 << 40, size=n) for n in (50, 0, 7)]
    sets[2] = np.concatenate([sets[2], sets[0][:5], [-1, -1]])
    out = run_local(ranks.union_ids, 3, args=(sets,), timeout_s=60,
                    tmp_dir=str(tmp_path))
    want = jax_multihost.allgather_host_ids(np.concatenate(sets))
    for r in out:
        for how in ("mesh", "world"):
            assert r[how].dtype == np.int64
            np.testing.assert_array_equal(r[how], want)
    # one process, no group: its own set, deduplicated
    np.testing.assert_array_equal(multihost.allgather_host_ids(sets[2]),
                                  jax_multihost.allgather_host_ids(sets[2]))


def _tsv(path, rows=64):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(rows):
            cols = (["1"] + [str(int(x)) for x in rng.integers(0, 9, 13)]
                    + [f"{int(x):x}" for x in rng.integers(0, 1 << 20, 26)])
            f.write("\t".join(cols) + "\n")


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("given", ["process", "mesh"])
def test_host_sharded_reader_matches_jax(hosts, given, tmp_path,
                                         monkeypatch):
    """Rank h of S from the process group (`host_id`, `num_hosts`) or from
    a mesh given."""
    path = str(tmp_path / "t.tsv")
    _tsv(path)
    mesh = jax_make_mesh()
    for h in range(hosts):
        for mod in (multihost, jax_multihost):
            monkeypatch.setattr(mod, "num_hosts", lambda: hosts)
            monkeypatch.setattr(mod, "host_id", lambda h=h: h)
        port_mesh = None
        if given == "mesh":
            monkeypatch.setattr(multihost, "num_hosts", lambda: 1)
            monkeypatch.setattr(multihost, "host_id", lambda: 0)
            port_mesh = types.SimpleNamespace(rank=h, size=hosts)
        got = list(multihost.host_sharded_reader(
            [path], 32, port_mesh, id_space=1 << 20, native="off"))
        want = list(jax_multihost.host_sharded_reader(
            [path], 32, mesh, id_space=1 << 20, native="off"))
        assert len(got) == len(want) == 64 // 32
        for g, w in zip(got, want):
            assert g["sparse"]["categorical"].shape == (32 // hosts, 26)
            for key in ("dense", "label"):
                np.testing.assert_array_equal(g[key], np.asarray(w[key]))
            np.testing.assert_array_equal(
                g["sparse"]["categorical"],
                np.asarray(w["sparse"]["categorical"]))


def test_host_sharded_reader_divisibility(monkeypatch):
    monkeypatch.setattr(multihost, "num_hosts", lambda: 3)
    with pytest.raises(ValueError, match="divisible"):
        next(iter(multihost.host_sharded_reader(["x.tsv"], 16)))
