"""The port's packed weights+slots layout and compiled steps against the
JAX package's (`openembedding_tpu/ops/sparse.py`, `tests/test_packed_layout.py`).

- The gate (`packed_layout`): the JAX package's refusals that carry
  meaning stay (no slots, non-float32 weights or slots, a byte cap). Its
  width rule (a packed width in 33..127 that is no multiple of 128 is
  refused) is a fact of the TPU's 128-lane layout: XLA pads such rows and
  copies the whole table every step. The port has no width rule, so a
  65 + 65 = 130 wide table packs in the port and not in JAX; and it
  refuses every table whose slots lie on the CUDA card, where packing
  measured slower than the split layout at every width.
- `pack_table` / `unpack_table` against JAX's: bit-exact (copies).
- The packed apply against the split apply in the port, and against JAX's
  `sparse_apply_packed_table` run under `jax.disable_jit()` (op by op, so
  XLA contracts no multiply-add): bit-exact, for Adagrad, Adam and Ftrl.
- `train_many` (packed) against K `train_step`s in the port: bit-exact,
  state back in the split layout and in the same tensors, "overflow" 0;
  against JAX's `jit_train_many` over 6 steps from the same state: within
  `test_torch_trainer.py`'s float32 tolerances (matrix-product summation
  order and XLA's contraction of multiply-adds).
- `jit_train_step` / `jit_train_many` on the CPU run the eager functions
  and give their results bit for bit (the graphs run only on the card,
  where `chip_smoke.py` holds them bit-equal to eager steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.ops import sparse as jax_sparse
from openembedding_tpu_torch import checkpoint, convert, optimizers
from openembedding_tpu_torch.model import _batch_key, _state_key
from openembedding_tpu_torch.ops import sparse

from test_torch_trainer import (TOL, _assert_states_close, _batches,
                                _numpy_state, _pair)


def _stack(batches):
    return {"sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in batches])},
            "dense": np.stack([b["dense"] for b in batches]),
            "label": np.stack([b["label"] for b in batches])}


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_packed_layout_gate_against_jax(monkeypatch):
    cases = [  # (dim, {slot: (width, dtype)}, weights dtype)
        (10, {"accum": (10, "float32")}, "float32"),
        (10, {}, "float32"),
        (64, {"accum": (64, "float32")}, "float32"),
        (65, {"accum": (65, "float32")}, "float32"),
        (4, {"s": (4, "bfloat16")}, "float32"),
        (6, {"m": (6, "float32"), "v": (6, "float32"),
             "beta_1_t": (1, "float32"), "beta_2_t": (1, "float32")},
         "float32"),
        (8, {"accum": (8, "float32")}, "bfloat16"),
    ]
    for dim, slots, wdt in cases:
        want = jax_sparse.packed_layout(
            dim, {k: jnp.zeros((4, w), getattr(jnp, d))
                  for k, (w, d) in slots.items()}, getattr(jnp, wdt))
        got = sparse.packed_layout(
            dim, {k: _t((4, w), getattr(torch, d))
                  for k, (w, d) in slots.items()}, getattr(torch, wdt))
        if dim == 65:  # the TPU's width rule, which the port drops
            assert want is None and got == (("accum", 65),)
        else:
            assert got == want, (dim, slots, wdt)
    # on the card no table packs; the gate reads the slots' device
    class OnCard:
        device, dtype, shape = torch.device("cuda"), torch.float32, (4, 10)

    assert jax_sparse.packed_layout(
        10, {"accum": jnp.zeros((4, 10), jnp.float32)}) == (("accum", 10),)
    assert sparse.packed_layout(10, {"accum": OnCard()}) is None
    # the byte cap: rows * packed width * 4 bytes
    monkeypatch.setattr(sparse, "PACKED_MAX_BYTES", 4 * 20 * 100)
    assert sparse.packed_layout(10, {"accum": _t((100, 10))}) is not None
    assert sparse.packed_layout(10, {"accum": _t((101, 10))}) is None


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    slots = {"a": rng.standard_normal((16, 6)).astype(np.float32),
             "b": rng.standard_normal((16, 1)).astype(np.float32)}
    lay = sparse.packed_layout(6, {k: torch.from_numpy(v)
                                   for k, v in slots.items()})
    assert lay == jax_sparse.packed_layout(
        6, {k: jnp.asarray(v) for k, v in slots.items()})
    want = np.asarray(jax_sparse.pack_table(
        jnp.asarray(w), {k: jnp.asarray(v) for k, v in slots.items()}, lay))
    packed = sparse.pack_table(torch.from_numpy(w),
                               {k: torch.from_numpy(v)
                                for k, v in slots.items()}, lay)
    assert packed.shape == (16, 13)
    np.testing.assert_array_equal(packed.numpy().view(np.int32),
                                  want.view(np.int32))
    w2, s2 = sparse.unpack_table(packed, lay, 6, torch.float32)
    jw, js = jax_sparse.unpack_table(jnp.asarray(want), lay, 6, jnp.float32)
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(w2.numpy(), w)
    for k in slots:
        np.testing.assert_array_equal(s2[k].numpy(), np.asarray(js[k]))
        np.testing.assert_array_equal(s2[k].numpy(), slots[k])


@pytest.mark.parametrize("opt_name", ["adagrad", "adam", "ftrl"])
def test_packed_apply_matches_split_and_jax(opt_name):
    make = {"adagrad": ("Adagrad", {"learning_rate": 0.1}),
            "adam": ("Adam", {"learning_rate": 0.01}),
            "ftrl": ("Ftrl", {"learning_rate": 0.1,
                              "l1_regularization_strength": 0.01})}
    cls, kw = make[opt_name]
    opt = getattr(optimizers, cls)(**kw)
    jopt = getattr(jax_embed, cls)(**kw)
    dim, rows, n = 6, 64, 40
    rng = np.random.default_rng(1)
    w = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(-1, rows + 3, n)  # -1 pads and out-of-range ids
    ids[:8] = ids[8:16]                  # duplicates
    g = rng.standard_normal((n, dim)).astype(np.float32)
    # slots away from their initial values (Adam's beta powers in (0, 1))
    slots = {}
    for k, v in opt.init_slots(rows, dim).items():
        u = torch.from_numpy(rng.random(v.shape).astype(np.float32))
        slots[k] = 0.4 + 0.5 * u if k.startswith("beta") else v + u
    lay = sparse.packed_layout(dim, slots)
    assert lay is not None

    sw = torch.from_numpy(w.copy())
    ss = {k: v.clone() for k, v in slots.items()}
    sparse.sparse_apply_dense_table(opt, sw, ss, torch.from_numpy(ids),
                                    torch.from_numpy(g))
    packed = sparse.pack_table(torch.from_numpy(w.copy()), slots, lay)
    out = sparse.sparse_apply_packed_table(opt, packed, lay, dim,
                                           torch.from_numpy(ids),
                                           torch.from_numpy(g))
    assert out is packed
    pw, ps = sparse.unpack_table(packed, lay, dim, torch.float32)
    assert torch.equal(pw.view(torch.int32), sw.view(torch.int32))
    for k in ss:
        assert torch.equal(ps[k].view(torch.int32), ss[k].view(torch.int32))

    with jax.disable_jit():
        jpacked = jax_sparse.sparse_apply_packed_table(
            jopt, jax_sparse.pack_table(
                jnp.asarray(w), {k: jnp.asarray(v.numpy())
                                 for k, v in slots.items()}, lay),
            lay, dim, jnp.asarray(ids, jnp.int32), jnp.asarray(g))
    np.testing.assert_array_equal(packed.numpy().view(np.int32),
                                  np.asarray(jpacked).view(np.int32))


def test_train_many_is_k_train_steps_and_leaves_the_split_layout():
    _, _, tm, tt = _pair()
    batches = _batches(steps=5)
    a = tt.init(batches[0])
    assert tt._packed_layouts(a) == {"categorical": (("accum", 10),)}
    b = a.clone()
    table = b.tables["categorical"]
    weights, accum = table.weights, table.slots["accum"]
    losses = []
    for batch in batches:
        a, m = tt.train_step(a, batch)
        losses.append(m["loss"])
    b, m = tt.train_many(b, _stack(batches))
    assert set(m) == {"loss", "overflow"}
    assert m["loss"].shape == (5,)
    assert m["overflow"].dtype == torch.int32 and int(m["overflow"]) == 0
    assert torch.equal(m["loss"], torch.stack(losses))
    # the same split objects and tensors, trained
    assert b.tables["categorical"] is table and table.weights is weights
    assert table.slots["accum"] is accum and list(table.slots) == ["accum"]
    assert weights.shape == (1000, 10)
    assert b.step == b.model_version == 5
    got, want = convert.train_state_to_jax(b), convert.train_state_to_jax(a)
    for key in ("dense_params", "dense_slots"):
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])
    t, u = got["tables"]["categorical"], want["tables"]["categorical"]
    np.testing.assert_array_equal(t["weights"], u["weights"])
    np.testing.assert_array_equal(t["slots"]["accum"], u["slots"]["accum"])


def test_train_many_matches_jax_jit_train_many():
    jm, jt, tm, tt = _pair()
    batches = _batches(steps=6, seed=5)
    js = jt.init(batches[0])
    assert jt._packed_layouts(js), "the JAX side packs this table too"
    ts = convert.train_state_from_jax(tm, **_numpy_state(js), device="cpu")
    js, jmetrics = jt.jit_train_many()(js, _stack(batches))
    ts, metrics = tt.train_many(ts, _stack(batches))
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), rtol=0,
                               atol=TOL["float32"]["loss"])
    assert int(metrics["overflow"]) == int(jmetrics["overflow"]) == 0
    _assert_states_close(ts, js, TOL["float32"])


def test_compiled_steps_on_the_cpu_give_the_eager_results():
    _, _, tm, tt = _pair()
    batches = _batches(steps=7)
    a = tt.init(batches[0])
    b = a.clone()
    step, many = tt.jit_train_step(), tt.jit_train_many()
    for batch in batches[:3]:
        a, ma = tt.train_step(a, batch)
        b, mb = step(b, batch)
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["logits"], mb["logits"])
    a, ma = tt.train_many(a, _stack(batches[3:]))
    b, mb = many(b, _stack(batches[3:]))
    assert torch.equal(ma["loss"], mb["loss"]) and mb["loss"].shape == (4,)
    assert b.step == a.step == 7
    for d in (step, many):
        assert (d.captures, d.replays, d.graph_launches) == (0, 0, [])
    got, want = convert.train_state_to_jax(b), convert.train_state_to_jax(a)
    np.testing.assert_array_equal(got["tables"]["categorical"]["weights"],
                                  want["tables"]["categorical"]["weights"])
    for k in want["dense_params"]:
        np.testing.assert_array_equal(got["dense_params"][k],
                                      want["dense_params"][k])


def test_capture_key_follows_shapes_and_dtypes():
    """A captured graph is reused only for a batch of the same keys, leaf
    shapes and dtypes; numpy and torch leaves of one dtype key alike."""
    batch = _batches(steps=1)[0]
    key = _batch_key(batch)
    assert key == _batch_key({k: (dict(v) if isinstance(v, dict) else v)
                              for k, v in batch.items()})
    as_torch = {"sparse": {"categorical": torch.from_numpy(
                    batch["sparse"]["categorical"])},
                "dense": torch.from_numpy(batch["dense"]),
                "label": torch.from_numpy(batch["label"])}
    assert _batch_key(as_torch) == key
    narrow = dict(batch, sparse={"categorical": batch["sparse"][
        "categorical"].astype(np.int32)})
    assert _batch_key(narrow) != key
    shorter = {"sparse": {"categorical": batch["sparse"]["categorical"][:8]},
               "dense": batch["dense"][:8], "label": batch["label"][:8]}
    assert _batch_key(shorter) != key
    assert _batch_key(dict(batch, weight=batch["label"])) != key


def test_capture_key_follows_the_state_tensors(tmp_path):
    """A graph captured on a state is replayed only while the state holds
    the same tensors: training in place keeps them, loading a checkpoint
    into the same state object rebinds some (dense parameters and slots)."""
    _, _, tm, tt = _pair()
    batches = _batches(steps=2)
    state = tt.init(batches[0])
    key = _state_key(state)
    state, _ = tt.train_step(state, batches[0])
    state, _ = tt.train_many(state, _stack(batches))
    assert _state_key(state) == key
    checkpoint.save_server_model(state, tm, str(tmp_path / "c"))
    assert checkpoint.load_server_model(state, tm, str(tmp_path / "c")) \
        is state
    assert _state_key(state) != key
    assert _state_key(state.clone()) != _state_key(state)
