"""The port's attention (`parallel/sequence.py`) against the JAX
package's `reference_attention`.

`reference_attention` on one device; ring and Ulysses attention on 2 and
4 gloo ranks (`multihost.run_local`, a (1, P) mesh, each rank its
sequence block), causal and bidirectional, with and without a key-padding
mask (`kv_valid`, including rows whose keys are all masked); the ring's
gradients of sum(out^2) against the reference's (JAX
`tests/test_sequence.py::test_ring_gradients_match_reference`); Ulysses
refusing H % P != 0 and `kv_valid` beside a custom `attn_fn`.
Tolerances: the reference within 1e-6 of JAX's in float32 (einsum and
softmax orders of adds); ring and Ulysses within 2e-6 of JAX's reference
in float32 and 2e-2 in bfloat16 inputs (the output rounds to bfloat16:
one ulp at these sizes); gradients within 1e-4, the JAX test's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.parallel.sequence import (
    reference_attention as jax_reference)
from openembedding_tpu_torch.parallel.multihost import run_local
from openembedding_tpu_torch.parallel.sequence import (NEG_INF, axis_mesh,
                                                       reference_attention,
                                                       ring_attention)

import torch_seq_ranks as ranks

B, S, H, D = 2, 16, 4, 8


def _qkv(seed, s=S, h=H):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(B, s, h, D)).astype(np.float32)
            for n in "qkv"}


def _kv_valid(seed, s=S):
    rng = np.random.default_rng(seed)
    valid = rng.random((B, s)) > 0.3
    valid[0, :] = False          # a row with every key masked
    valid[1, 0] = True
    return valid


def _jax_ref(case):
    kv = case.get("kv_valid")
    return np.asarray(jax_reference(
        *(jnp.asarray(case[n]) for n in "qkv"), causal=case["causal"],
        kv_valid=None if kv is None else jnp.asarray(kv)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_matches_jax(causal, masked):
    case = dict(_qkv(0), causal=causal,
                kv_valid=_kv_valid(1) if masked else None)
    kv = case["kv_valid"]
    got = reference_attention(
        *(torch.tensor(case[n]) for n in "qkv"), causal=causal,
        kv_valid=None if kv is None else torch.tensor(kv)).numpy()
    np.testing.assert_allclose(got, _jax_ref(case), rtol=0, atol=1e-6)
    if masked and not causal:
        # every key masked: a uniform softmax over all keys, not NaN
        np.testing.assert_allclose(
            got[0], np.broadcast_to(case["v"][0].mean(axis=0), got[0].shape),
            rtol=0, atol=1e-6)


def test_reference_offsets_and_bfloat16():
    case = _qkv(2)
    q, k, v = (torch.tensor(case[n]) for n in "qkv")
    got = reference_attention(q[:, 8:], k, v, causal=True, q_offset=8)
    want = jax_reference(*(jnp.asarray(case[n]) for n in "qkv"),
                         causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 8:],
                               rtol=0, atol=1e-6)
    got16 = reference_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    want16 = jax_reference(*(jnp.asarray(case[n], jnp.bfloat16)
                             for n in "qkv"))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32), rtol=0,
                               atol=2e-2)
    assert NEG_INF == -1e30


def _cases():
    out = []
    for kind in ("ring", "ulysses"):
        for causal in (True, False):
            for masked in (False, True):
                out.append(dict(_qkv(10 + len(out)), kind=kind,
                                causal=causal, dtype="float32",
                                kv_valid=_kv_valid(3) if masked else None,
                                grad=kind == "ring" and masked))
    out.append(dict(_qkv(40), kind="ring", causal=True, dtype="bfloat16",
                    kv_valid=None))
    out.append(dict(_qkv(41), kind="ulysses", causal=False,
                    dtype="bfloat16", kv_valid=_kv_valid(4)))
    out.append(dict(_qkv(42), kind="ring", causal=True, dtype="float32",
                    kv_valid=None, grad=True))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def runs(request, tmp_path_factory):
    P = request.param
    cases = _cases()
    results, msgs = zip(*run_local(
        ranks.attention_cases, P, args=(cases, 3), timeout_s=90,
        tmp_dir=str(tmp_path_factory.mktemp("ranks"))))
    return P, cases, results, msgs


def _assemble(results, i, key):
    return np.concatenate([r[i][key] for r in results], axis=1)


def test_ring_and_ulysses_match_the_reference(runs):
    P, cases, results, _ = runs
    for i, case in enumerate(cases):
        got = _assemble(results, i, "out")
        want = _jax_ref(case)
        atol = 2e-6 if case["dtype"] == "float32" else 2e-2
        if case["kind"] == "ring" and case.get("kv_valid") is not None:
            # a row with every key masked: 0 from the ring, a uniform
            # average from the reference (both as in the JAX package);
            # every other row sees key 0, so no query of it is dead
            dead = ~case["kv_valid"].any(axis=1)
            assert dead.any() and np.all(got[dead] == 0)
            got, want = got[~dead], want[~dead]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"P={P} {case['kind']} "
                                   f"causal={case['causal']}")


def test_ring_gradients_match_the_reference(runs):
    P, cases, results, _ = runs
    for i, case in enumerate(cases):
        if not case.get("grad"):
            continue
        kv = case.get("kv_valid")

        def loss(q, k, v):
            return jnp.sum(jnp.square(jax_reference(
                q, k, v, causal=case["causal"],
                kv_valid=None if kv is None else jnp.asarray(kv))))

        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(case[n]) for n in "qkv"))
        for n, w in zip("qkv", want):
            got = _assemble(results, i, f"g{n}")
            if kv is not None:
                # rows whose keys are all masked: the ring gives 0, the
                # reference a uniform average, so their gradients differ
                live = kv.any(axis=1)
                got, w = got[live], np.asarray(w)[live]
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=f"P={P} d{n}")


def test_ulysses_refuses(runs):
    P, _, _, msgs = runs
    for m in msgs:
        assert len(m) == 2
        assert "not divisible" in m[0] and str(P) in m[0]
        assert "custom attn_fn" in m[1]


def test_unbound_axis_raises():
    x = torch.zeros((1, 2, 2, 4))
    with pytest.raises(NameError, match="unbound axis name: seq"):
        ring_attention(x, x, x, axis="seq")
    with pytest.raises(NameError):
        axis_mesh("data")
