"""The port's MeshTrainer against its own single-device Trainer: the
port's version of the JAX package's
`tests/test_mesh.py::test_mesh_matches_single_device_randomized`
(optimizer x width x table kind x duplicate pressure), at S = 2 and 4 gloo
ranks spawned by `parallel.multihost.run_local`.

Step 0 of the mesh against the single-device Trainer with its loss scaled
by S (each rank normalizes by its own batch and the dense grads are
summed: S times the global mean), both from a Constant-initialized table
and the same dense init. Bound: rtol 1e-5, atol 1e-6, the JAX package's
own (`tests/test_mesh.py:166-206`): only the dense sums' order differs.
"""

import functools

import numpy as np
import pytest
import torch

from openembedding_tpu_torch.embedding import lookup
from openembedding_tpu_torch.model import Trainer, binary_logloss
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks

TIMEOUT = 60


RANDOMIZED = [(11, "adam", 4, False, False), (12, "ftrl", 8, False, True),
              (13, "rmsprop", 4, True, False), (14, "adagrad", 8, True, True),
              (15, "momentum", 4, False, False), (16, "adamax", 4, True, True)]


def _randomized_case(S, seed, opt, dim, hashed, dup_heavy):
    rng = np.random.default_rng(seed)
    vocab, B = 64, 8 * S
    ids = rng.integers(0, 6 if dup_heavy else vocab, size=(B, 26))
    if hashed:  # the 63-bit id space
        ids = ids * (2 ** 56 + 12345)
    return {"vocab": vocab, "hashed": hashed, "capacity": 256 if hashed
            else 0, "dim": dim, "opt": opt,
            "batch": {"sparse": {"categorical": ids.astype(np.int64)},
                      "dense": rng.normal(size=(B, 13)).astype(np.float32),
                      "label": rng.random(B).round().astype(np.float32)}}


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_matches_single_device_randomized(S, tmp_path):
    cases = [_randomized_case(S, *c) for c in RANDOMIZED]
    port = run_local(ranks.randomized_cases, S, args=(cases,),
                     timeout_s=TIMEOUT,
                     tmp_dir=str(tmp_path))
    for i, case in enumerate(cases):
        model = ranks.deepfm(case["vocab"], hashed=case["hashed"],
                             capacity=case["capacity"], dim=case["dim"] - 1,
                             hidden=(8,), initializer=ranks.Constant(0.05))
        model.loss_fn = functools.partial(_scaled_logloss, float(S))
        trainer = Trainer(model, ranks.OPTIMIZERS[case["opt"]](),
                          device="cpu")
        state = trainer.init(case["batch"])
        state, m = trainer.train_step(state, case["batch"])
        ids = np.unique(case["batch"]["sparse"]["categorical"])
        spec = model.specs["categorical"]
        want = lookup(spec, state.tables["categorical"],
                      torch.tensor(ids)).numpy()
        got = _rows_by_id(port, i, ids, S, case["hashed"])
        what = f"{case['opt']} dim {case['dim']} hashed={case['hashed']}"
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
        for r in range(S):
            np.testing.assert_allclose(float(port[r][i]["loss"]),
                                       float(m["loss"]) / S, rtol=1e-5,
                                       err_msg=what)


def _scaled_logloss(scale, logits, labels, weight=None):
    return scale * binary_logloss(logits, labels, weight)


def _rows_by_id(port, i, ids, S, hashed):
    """The mesh's rows of `ids`, read off the ranks' shards: array id at
    shard id % S, local row id // S; hash id at its key's slot."""
    out = np.zeros((len(ids), port[0][i]["weights"].shape[1]), np.float32)
    for k, x in enumerate(ids):
        shard = port[int(x % S)][i]
        if hashed:
            (slot,) = np.flatnonzero(shard["keys"] == x)
            out[k] = shard["weights"][slot]
        else:
            out[k] = shard["weights"][x // S]
    return out
