"""The port's device hash table (`tables/hash_table.py`) against the JAX
package's, with 64-bit types on (its single-lane int64 key layout).

Everything here is integer work or a row copy, so every comparison is
bit-exact: the mixer, the base slot (ids with bit 62 set, mixes with bit 63
set, a capacity that is not a power of two), the probe's keys, slots and
overflow on a crowded table with contended slots and -1 pads, the read-only
probe's misses, the host insert, and lookups. The push through the plain
fused apply is held to the JAX package's jitted push within 2e-6 (XLA
contracts the optimizer's multiply-adds; `test_torch_apply.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as jax_embed
from openembedding_tpu.embedding import EmbeddingTableState as JaxTable
from openembedding_tpu.tables import hash_table as jht
from openembedding_tpu_torch import optimizers
from openembedding_tpu_torch.embedding import EmbeddingTableState
from openembedding_tpu_torch.tables import hash_table as tht


def _ids(rng, n, high=1 << 63):
    """Unique non-negative int64 ids over the whole 63-bit space."""
    ids = rng.integers(0, high, size=n * 2, dtype=np.int64)
    return np.unique(ids)[:n]


def test_mix_bit_exact_against_numpy_and_jax():
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        _ids(rng, 4000),
        np.array([0, 1, (1 << 62), (1 << 62) + 5, (1 << 63) - 1, -1],
                 np.int64)])
    want = jht.np_mix(ids)
    got = tht._mix(torch.from_numpy(ids)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jht._mix(jnp.asarray(ids))),
                                  want)
    np.testing.assert_array_equal(tht.np_mix(ids), want)
    # the test covers mixes with bit 63 set, the unsigned remainder's case
    assert (want >> np.uint64(63)).any() and (~(want >> np.uint64(63))
                                             & np.uint64(1)).any()
    assert ((ids >> 62) & 1).any()


@pytest.mark.parametrize("capacity", [1 << 12, 3001, 1000003])
def test_base_slot_is_the_unsigned_remainder(capacity):
    rng = np.random.default_rng(1)
    ids = _ids(rng, 5000)
    want = (jht.np_mix(ids) % np.uint64(capacity)).astype(np.int64)
    got = tht._base_slot(torch.from_numpy(ids), capacity).numpy()
    np.testing.assert_array_equal(got, want)


def _crowded(rng, capacity, n_first, n_second):
    """Two probe batches of unique ids (sorted, as the dedup emits them,
    and shuffled), with -1 pads, that fill `capacity` over 0.7; several ids
    are built to share a base slot."""
    first = _ids(rng, n_first)
    base = (jht.np_mix(first) % np.uint64(capacity)).astype(np.int64)
    # ids whose base slot equals an existing id's: contention in round 0
    extra, want = [], set(base[:40].tolist())
    while len(extra) < 60:
        c = _ids(rng, 4096)
        b = (jht.np_mix(c) % np.uint64(capacity)).astype(np.int64)
        extra += [int(x) for x, y in zip(c, b) if int(y) in want]
    second = np.setdiff1d(np.concatenate([_ids(rng, n_second),
                                          np.array(extra[:60], np.int64)]),
                          first)
    second = rng.permutation(second)
    pads = np.full(17, -1, np.int64)
    return (np.concatenate([np.sort(first), pads]),
            np.concatenate([second[:len(second) // 2], pads,
                            second[len(second) // 2:]]))


@pytest.mark.parametrize("capacity", [1 << 11, 3001])
def test_find_or_insert_bit_exact_on_a_crowded_table(capacity):
    rng = np.random.default_rng(2)
    b1, b2 = _crowded(rng, capacity, int(capacity * 0.45),
                      int(capacity * 0.4))
    jkeys = jnp.full((capacity,), -1, jnp.int64)
    tkeys = tht.fresh_keys(capacity)
    f = jax.jit(jht.hash_find_or_insert)
    for batch in (b1, b2):
        jkeys, jslot, joflow = f(jkeys, jnp.asarray(batch))
        tslot, toflow = tht.hash_find_or_insert(tkeys,
                                                torch.from_numpy(batch))
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        assert int(toflow) == int(joflow)
    load = float((tkeys >= 0).float().mean())
    assert load > 0.7
    # the second batch overflowed some ids past the probe budget or not;
    # either way every placed id is found again by the read-only probe
    placed = b2[(tslot.numpy() < capacity)]
    got = tht.hash_find(tkeys, torch.from_numpy(placed)).numpy()
    assert (tkeys.numpy()[got] == placed).all()


def test_contended_slot_goes_to_the_last_contender():
    """Two ids built to share a base slot, claimed in one round: JAX's
    reread keeps the later index on XLA:CPU, and so does the port."""
    capacity = 1 << 10
    rng = np.random.default_rng(3)
    c = _ids(rng, 20000)
    b = (jht.np_mix(c) % np.uint64(capacity)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    dup = np.flatnonzero(b[order][1:] == b[order][:-1])[0]
    pair = c[order][dup:dup + 2]
    for ids in (pair, pair[::-1].copy()):
        jkeys, jslot, _ = jht.hash_find_or_insert(
            jnp.full((capacity,), -1, jnp.int64), jnp.asarray(ids))
        tkeys = tht.fresh_keys(capacity)
        tslot, _ = tht.hash_find_or_insert(tkeys, torch.from_numpy(ids))
        base = int(b[order][dup])
        assert int(jkeys[base]) == ids[1]         # the later index wins
        assert int(jslot[1]) == base and int(jslot[0]) == (base + 1) % capacity
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))


def test_overflow_when_the_table_is_too_small():
    rng = np.random.default_rng(4)
    ids = _ids(rng, 300)
    jkeys, jslot, joflow = jht.hash_find_or_insert(
        jnp.full((200,), -1, jnp.int64), jnp.asarray(ids), num_probes=8)
    tkeys = tht.fresh_keys(200)
    tslot, toflow = tht.hash_find_or_insert(tkeys, torch.from_numpy(ids),
                                            num_probes=8)
    assert int(toflow) == int(joflow) > 0
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))


@pytest.mark.parametrize("capacity", [1 << 11, 3001, 700])
def test_pull_slots_are_the_find_probes(capacity):
    """The push takes the pull's slots: they must be what `hash_find`
    returns on the keys the pull left, for duplicates, -1 pads and (at
    capacity 700, below the ids' count) overflowed ids, which both give
    `capacity`."""
    rng = np.random.default_rng(12)
    pool = _ids(rng, 1500)
    state = EmbeddingTableState(
        weights=torch.zeros((capacity, 2)), slots={},
        keys=tht.fresh_keys(capacity),
        overflow=torch.zeros((), dtype=torch.int32))
    for _ in range(3):
        ids = rng.choice(pool, size=800)
        ids[::29] = -1
        ids = torch.from_numpy(ids)
        state, _, overflow, slot = tht.hash_lookup_train(state, ids)
        assert torch.equal(slot, tht.hash_find(state.keys, ids))
    assert (int(state.overflow) > 0) == (capacity < 1500)


def test_hash_find_misses():
    capacity = 4096
    rng = np.random.default_rng(5)
    ids = _ids(rng, 3000)
    tkeys = tht.fresh_keys(capacity)
    tht.hash_find_or_insert(tkeys, torch.from_numpy(ids[:2000]))
    query = np.concatenate([ids, np.array([-1, -7], np.int64)])
    got = tht.hash_find(tkeys, torch.from_numpy(query)).numpy()
    want = np.asarray(jht.hash_find(jnp.asarray(tkeys.numpy()),
                                    jnp.asarray(query)))
    np.testing.assert_array_equal(got, want)
    assert (got[2000:] == capacity).all()          # absent and negative
    assert (got[:2000] < capacity).all()


def test_np_hash_insert_equals_jax():
    rng = np.random.default_rng(6)
    for capacity, shards in ((1 << 12, 1), (3000, 3)):
        ids = _ids(rng, int(capacity * 0.8))
        jk = np.full(capacity, -1, np.int64)
        tk = np.full(capacity, -1, np.int64)
        jpos = jht.np_hash_insert(jk, ids, shards)
        tpos = tht.np_hash_insert(tk, ids, shards)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tpos, jpos)


def test_np_id_helpers_equal_jax():
    from openembedding_tpu.ops import id64
    rng = np.random.default_rng(7)
    ids = np.concatenate([_ids(rng, 100), np.array([-1], np.int64)])
    pair = tht.np_split_ids(ids)
    np.testing.assert_array_equal(pair, id64.np_split_ids(ids))
    np.testing.assert_array_equal(tht.np_join_ids(pair), ids)
    np.testing.assert_array_equal(tht.np_ids_as_int64(pair), ids)
    for keys in (ids, pair):
        sel, got = tht.np_resident_ids(keys)
        jsel, want = id64.np_resident_ids(keys)
        np.testing.assert_array_equal(sel, jsel)
        np.testing.assert_array_equal(got, want)


def _tables(capacity, dim, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(capacity, dim)).astype(np.float32)
    accum = np.full((capacity, dim), 0.1, np.float32)
    jt = JaxTable(weights=jnp.asarray(w.copy()),
                  slots={"accum": jnp.asarray(accum.copy())},
                  keys=jnp.full((capacity,), -1, jnp.int64),
                  overflow=jnp.zeros((), jnp.int32))
    tt = EmbeddingTableState(weights=torch.tensor(w),
                             slots={"accum": torch.tensor(accum)},
                             keys=tht.fresh_keys(capacity),
                             overflow=torch.zeros((), dtype=torch.int32))
    return jt, tt


def test_lookup_and_apply_against_jax():
    capacity, dim = 1500, 5
    jt, tt = _tables(capacity, dim, 8)
    rng = np.random.default_rng(9)
    pool = _ids(rng, 1400)
    jopt = jax_embed.Adagrad(learning_rate=0.1)
    topt = optimizers.Adagrad(learning_rate=0.1)
    pull = jax.jit(jht.hash_lookup_train)
    push = jax.jit(lambda t, i, g: jht.hash_apply_gradients(t, jopt, i, g))
    for step in range(3):
        ids = rng.choice(pool, size=600)            # duplicates
        ids[::37] = -1                              # pads
        # both pull from the same table: the pull is a copy, bit-exact
        jt = jt.replace(weights=jnp.asarray(tt.weights.numpy().copy()),
                        slots={"accum": jnp.asarray(
                            tt.slots["accum"].numpy().copy())})
        jt, jrows = pull(jt, jnp.asarray(ids))
        tt, trows, toflow, tslot = tht.hash_lookup_train(
            tt, torch.from_numpy(ids))
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
        assert int(tt.overflow) == int(jt.overflow)
        g = rng.normal(size=(600, dim)).astype(np.float32)
        jt = push(jt, jnp.asarray(ids), jnp.asarray(g))
        # the push given the pull's slots (the Trainer's) and the push that
        # probes for them train alike
        probed = EmbeddingTableState(
            weights=tt.weights.clone(),
            slots={"accum": tt.slots["accum"].clone()}, keys=tt.keys,
            overflow=tt.overflow)
        tht.hash_apply_gradients(tt, topt, torch.from_numpy(ids),
                                 torch.from_numpy(g), slot=tslot)
        tht.hash_apply_gradients(probed, topt, torch.from_numpy(ids),
                                 torch.from_numpy(g))
        assert torch.equal(probed.weights, tt.weights)
        assert torch.equal(probed.slots["accum"], tt.slots["accum"])
        np.testing.assert_allclose(tt.weights.numpy(), np.asarray(jt.weights),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(tt.slots["accum"].numpy(),
                                   np.asarray(jt.slots["accum"]),
                                   rtol=0, atol=2e-6)
    # the read-only lookup: hits, misses (zero rows) and pads
    query = np.concatenate([pool[:50], _ids(np.random.default_rng(10), 20),
                            np.array([-1], np.int64)])
    np.testing.assert_array_equal(
        tht.hash_lookup(tt, torch.from_numpy(query)).numpy(),
        np.asarray(jht.hash_lookup(
            jt.replace(weights=jnp.asarray(tt.weights.numpy())),
            jnp.asarray(query))))
