"""The port's pipelined mesh window against its serial window and the JAX
package's (`MeshTrainer(pipeline_steps=True)`).

The model and data of `test_torch_mesh_train.py`: a DeepFM with one
10-wide table, hidden (16, 16), a float32 tower, Adagrad(0.05), global
batches of 64 from `synthetic_criteo`, here as windows of K = 3 through
`train_many`. On S gloo ranks (`multihost.run_local`) each configuration
runs its window serial and pipelined from one state, the JAX
MeshTrainer's init carried across (`convert.mesh_state_from_jax`), with
its placement installed before the window; the JAX MeshTrainer runs the
same pipelined window through `jit_train_many`.

- The pipelined window equals the serial one bit for bit: losses and the
  whole state (tables, slots, residuals, cache, annex, dense params and
  slots), on every exchange path.
- Against the JAX pipelined window: the bounds `test_torch_mesh_train.py`
  states for the fp32 wire (loss 1e-6, tables and slots 1e-6, dense
  params 1e-6, dense slots 2e-6) and `test_torch_mesh_train_int8.py` for
  the int8 wire. The pipelined window computes what the serial one does,
  so the serial bounds hold as they stand. The window's counters
  ("conflict", "conflict_overflow") depend on ids only and are equal.
- The conflict primitives (`ops/dedup.member_mask`,
  `compact_member_slots`, `sharded.conflict_patch_cap`,
  `wire.conflict_patch_cost`) equal the JAX ones on seeded inputs.
- The overlap's structure: a pipelined step's two prefetch all_to_alls
  come before that step's dense sum, push and patch, and what the
  prefetch returns does not depend on the batch's labels.

This file runs the primitives, the structure, and array tables at fp32
(S = 2) on the fused and the per-table exchange;
`test_torch_pipeline_placement.py` hot rows and migration at fp32;
`test_torch_pipeline_conflict.py` the window of one batch, planted
overlap and a capped patch; `test_torch_pipeline_one_rank.py` S = 1;
`test_torch_pipeline_int8*.py` the int8 wire with error feedback;
`test_torch_pipeline*_s4_hash.py` hash tables at S = 4 (a file each
keeps a file's run well under 40 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openembedding_tpu as jax_embed
from openembedding_tpu.models import make_deepfm as jax_make_deepfm
from openembedding_tpu.ops import dedup as jax_dedup
from openembedding_tpu.ops import wire as jax_wire
from openembedding_tpu.parallel import MeshTrainer as JaxMeshTrainer
from openembedding_tpu.parallel import make_mesh as jax_make_mesh
from openembedding_tpu.parallel import sharded as jax_sharded
from openembedding_tpu_torch import data
from openembedding_tpu_torch.convert import mesh_state_to_jax
from openembedding_tpu_torch.ops import dedup, wire
from openembedding_tpu_torch.parallel import sharded
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks
from test_torch_mesh_train_int8 import TOL, numpy_state

VOCAB, BATCH, K, CAPACITY = 1000, 64, 3, 4096
H, M = 16, 8


# -- the conflict primitives -------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_member_mask_and_compaction_match_jax(seed):
    rng = np.random.default_rng(seed)
    S, cap = 4, 64
    ref = rng.integers(-1, 90, size=S * cap).astype(np.int64)
    qry = rng.integers(-1, 90, size=S * cap).astype(np.int64)
    ref_valid, qry_valid = ref >= 0, rng.random(S * cap) < 0.9
    qry_valid &= qry >= 0
    want = np.asarray(jax_dedup.member_mask(
        jnp.asarray(ref.astype(np.int32)), jnp.asarray(ref_valid),
        jnp.asarray(qry.astype(np.int32)), jnp.asarray(qry_valid)))
    got = dedup.member_mask(torch.from_numpy(ref), torch.from_numpy(ref_valid),
                            torch.from_numpy(qry), torch.from_numpy(qry_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    member = want.reshape(S, cap)
    for pcap in (cap, 20, 3, 1):
        ws, wo = jax_dedup.compact_member_slots(jnp.asarray(member), pcap)
        gs, go = dedup.compact_member_slots(torch.from_numpy(member.copy()),
                                            pcap)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert int(go) == int(wo)
        assert (int(go) > 0) == (pcap < member.sum(1).max())


def test_patch_cap_and_cost_match_jax():
    for cap in (1, 7, 64, 26624):
        for f in (0.0, 0.001, 0.05, 0.5, 1.0):
            assert sharded.conflict_patch_cap(cap, f) == \
                jax_sharded.conflict_patch_cap(cap, f)
    tables = [{"dim": 10, "cap": 26624, "pcap": 26624},
              {"dim": 10, "cap": 500, "pcap": 25, "fmt": "int8"},
              {"dim": 16, "cap": 64, "pcap": 64}]
    for fmt in ("fp32", "bf16", "int8"):
        for S in (1, 2, 4):
            assert wire.conflict_patch_cost(tables, S, fmt) == \
                jax_wire.conflict_patch_cost(tables, S, fmt)
    # the exact patch of the flagship's mesh4 buckets: 44 B a row at fp32
    # (10 values and the count lane), 18 at int8 (10 codes, 4 scale
    # lanes, 4 count lanes)
    assert wire.conflict_patch_cost(tables[:1], 4, "fp32")["bytes_patch"] \
        == 4 * 26624 * 44
    assert wire.conflict_patch_cost(tables[:1], 4, "int8")["bytes_patch"] \
        == 4 * 26624 * 18


# -- windows ------------------------------------------------------------------


def batches_for(hashed=False, k=K, overlap=False):
    """K global batches; `overlap` gives every batch the first 8 rows of
    batch 0 (`tests/test_pipeline.py`'s `_run_pair`), so the prefetch is
    stale where the previous apply wrote."""
    bs = list(data.synthetic_criteo(
        BATCH, id_space=(1 << 40) if hashed else VOCAB, steps=k, seed=7))
    if overlap:
        for b in bs[1:]:
            b["sparse"]["categorical"][:8] = bs[0]["sparse"]["categorical"][:8]
    return bs


def placement_for(batches, S, hot_rows, mig_rows):
    """The hot set (the most frequent ids) and moves (ids one shard over)
    installed before the window."""
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in batches])
    u, c = np.unique(ids, return_counts=True)
    top = u[np.argsort(-c, kind="stable")].astype(np.int64)
    hot = {0: top[:hot_rows]} if hot_rows else {}
    mv = top[hot_rows + 4:hot_rows + 4 + mig_rows]
    moves = {0: (mv, (mv + 1) % S)} if mig_rows else {}
    return hot, moves


def jax_window(S, *, wire="fp32", grouped=True, hashed=False, hot_rows=0,
               mig_rows=0, hot_wire=None, conflict_factor=0.0, k=K,
               overlap=False):
    """The JAX pipelined window -> (the port ranks' config, its losses,
    its counters, its state after `hot_sync` as numpy)."""
    model = jax_make_deepfm(VOCAB, 9, hidden=(16, 16),
                            compute_dtype=jnp.float32, hashed=hashed,
                            capacity=CAPACITY if hashed else 0)
    trainer = JaxMeshTrainer(
        model, jax_embed.Adagrad(learning_rate=0.05),
        mesh=jax_make_mesh(jax.devices()[:S]), wire=wire,
        group_exchange=grouped, hot_rows=hot_rows, mig_rows=mig_rows,
        hot_wire=hot_wire, pipeline_steps=True,
        conflict_factor=conflict_factor)
    batches = batches_for(hashed, k, overlap)
    hot_ids, moves = placement_for(batches, S, hot_rows, mig_rows)
    state = trainer.init(batches[0])
    start = numpy_state(state)
    if hot_ids:
        state = trainer.refresh_hot_rows(
            state, hot_ids={"categorical": hot_ids[0]})
    if moves:
        state = trainer.migrate_rows(state, moves={"categorical": moves[0]})
    stacked = ranks.stack_batches(batches)
    state, m = trainer.jit_train_many(stacked, state)(state, stacked)
    state = trainer.hot_sync(state)
    cfg = {"vocab": VOCAB, "hashed": hashed, "capacity": CAPACITY,
           "wire": wire, "grouped": grouped, "hot_rows": hot_rows,
           "mig_rows": mig_rows, "hot_wire": hot_wire,
           "conflict_factor": conflict_factor, "state": start,
           "batches": batches, "hot_ids": hot_ids, "moves": moves}
    counters = {"conflict": {n: int(v) for n, v in m["conflict"].items()},
                "conflict_overflow": int(m["conflict_overflow"])}
    return cfg, np.asarray(m["loss"]).tolist(), counters, \
        numpy_state(state)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=what)


def check_window(S, jax_run, port):
    """Every rank's pipelined window bit-equal to its serial one; the
    window against the JAX pipelined window; the counters equal."""
    cfg, want_losses, counters, want = jax_run
    tol = TOL["int8" if cfg["wire"] == "int8" else "fp32"]
    capped = cfg["conflict_factor"] > 0
    for r in range(S):
        p = port[r]
        if capped:
            # the rows past the cap keep their prefetched values: the
            # window leaves the serial one, as the JAX window does
            assert p["differ"] and not p["same_losses"]
            assert p["conflict_overflow"] > 0
        else:
            assert p["differ"] == [] and p["same_losses"], (r, p["differ"])
        assert p["serial_keys"] == ["loss", "overflow"]
        assert p["pipelined_keys"] == ["conflict", "conflict_overflow",
                                       "loss", "overflow"]
        assert p["overflow"] == p["serial_overflow"] == 0
        _close(p["losses"], want_losses, tol["loss"], "loss")
        assert p["conflict"] == counters["conflict"]
        assert p["conflict_overflow"] == counters["conflict_overflow"]
    got = mesh_state_to_jax([port[r]["state"] for r in range(S)])
    t, g = want["tables"]["categorical"], got["tables"]["categorical"]
    _close(g["weights"], t["weights"], tol["table"], "weights")
    for k, v in t["slots"].items():
        _close(g["slots"][k], v, tol["slot"], k)
    assert ("ef" in g) == ("ef" in t)
    if "ef" in t:
        _close(g["ef"], t["ef"], tol["table"], "ef")
    for part in ("hot", "mig"):
        assert (part in g) == (part in t)
        if part in t:
            _close(g[part]["weights"], t[part]["weights"], tol["table"],
                   part)
            for s, a in t[part]["slots"].items():
                _close(g[part]["slots"][s], a, tol["slot"], part + s)
            np.testing.assert_array_equal(g[part]["ids"], t[part]["ids"])
    if "keys" in t:
        np.testing.assert_array_equal(g["keys"], t["keys"])
        assert g["overflow"] == t["overflow"]
    for key in ("dense_params", "dense_slots"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            _close(got[key][k], v, tol["dense"], k)


def window_tests(S, cases):
    """(the module fixture, the test) of `cases` {id: jax_window
    arguments} at S ranks: the JAX windows, then every case on S port
    ranks (one launch), compared."""
    names = list(cases)

    @pytest.fixture(scope="module")
    def windows(tmp_path_factory):
        jax_runs = [jax_window(S, **cases[n]) for n in names]
        port = run_local(ranks.pipelined_windows, S,
                         args=([cfg for cfg, *_ in jax_runs],),
                         timeout_s=120,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return jax_runs, port

    @pytest.mark.parametrize("case", names)
    def test_pipelined_window_equals_serial_and_matches_jax(windows, case):
        jax_runs, port = windows
        i = names.index(case)
        check_window(S, jax_runs[i], [port[r][i] for r in range(S)])
        patched = sum(jax_runs[i][2]["conflict"].values())
        # a window of one batch has no step ahead, and so nothing to patch
        assert patched == 0 if cases[case].get("k") == 1 else patched > 0

    return windows, test_pipelined_window_equals_serial_and_matches_jax


windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    2, {"fused": {}, "per_table": {"grouped": False}})


def test_prefetch_is_issued_ahead_and_reads_nothing_of_the_batch_before(
        tmp_path):
    """The overlap's structural pin (in place of the JAX package's jaxpr
    pin, `tests/test_pipeline.py`): in each pipelined step the next
    batch's two prefetch all_to_alls (ids, rows) are issued before this
    batch's dense sum, push and patch, and the prefetch's plan and rows
    stay the same when this batch's labels change (its gradients, apply
    and the patch do change: the pin is not vacuous)."""
    cfg = {"vocab": VOCAB, "hashed": False, "wire": "fp32",
           "batches": batches_for(overlap=True)}
    out = run_local(ranks.pipeline_order, 2, args=(cfg,), timeout_s=60,
                    tmp_dir=str(tmp_path))
    # the metrics' reduce: the loss's mean and the stats' sum
    tail = [("dense", "dense_sum"), ("push", "all_to_all")] + [
        ("metrics", "dense_sum")] * 2
    step = [("prefetch", "all_to_all")] * 2 + tail + [("patch", "all_to_all")]
    last = tail
    want = [("prefetch", "all_to_all")] * 2 + step * (K - 1) + last + [
        ("window", "dense_sum")]
    for r in range(2):
        assert out[r]["log"] == want
        assert out[r]["prefetch_equal"]
        assert not out[r]["patched_equal"]
