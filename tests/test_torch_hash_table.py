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


# -- the card's schedule: the walk, then the marker contest ------------------


def _np_walk_contest(keys, ids, num_probes):
    """Numpy emulation of `csrc/hash_probe.cu` on a copy of `keys`: each id
    walks the table as it stands to its own key or the first empty key;
    the ids that met an empty key at d0 run the rounds from the least d0,
    each joining at its own, and claim by the marker rule (`-2 - index`,
    the least marker stands). -> (keys, slot, overflow, inserted,
    pending)."""
    keys = keys.copy()
    capacity, n = len(keys), len(ids)
    valid = ids >= 0
    base = np.zeros(n, np.int64)
    base[valid] = (jht.np_mix(ids[valid]) % np.uint64(capacity)).astype(
        np.int64)
    slot = np.full(n, capacity, np.int64)
    d0 = np.full(n, -1, np.int64)
    walking = valid.copy()
    for d in range(num_probes):
        pos = (base + d) % capacity
        cur = keys[pos]
        hit = walking & (cur == ids)
        slot[hit] = pos[hit]
        met = walking & (cur == tht.EMPTY)
        d0[met] = d
        walking &= ~(hit | met)
    overflow = int(walking.sum())
    pend = np.flatnonzero(d0 >= 0)
    inserted = 0
    if pend.size:
        left = np.ones(pend.size, bool)
        for d in range(int(d0[pend].min()), num_probes):
            act = left & (d0[pend] <= d)
            idx = pend[act]
            pos = (base[idx] + d) % capacity
            cur = keys[pos]
            found = cur == ids[idx]
            slot[idx[found]] = pos[found]
            contend = cur < 0
            np.minimum.at(keys, pos[contend], -2 - idx[contend])
            win = contend & (keys[pos] == -2 - idx)
            keys[pos[win]] = ids[idx[win]]
            slot[idx[win]] = pos[win]
            inserted += int(win.sum())
            left[np.flatnonzero(act)[found | win]] = False
            assert (keys >= -1).all()          # no marker outlives a round
            if not left.any():
                break
        overflow += int(left.sum())
    return keys, slot, overflow, inserted, int(pend.size)


def _filled(rng, capacity, load):
    """A table filled to `load` through the plain rounds, and its ids."""
    keys = tht.fresh_keys(capacity)
    ids = _ids(rng, int(capacity * load))
    tht.hash_find_or_insert_reference(keys, torch.from_numpy(ids))
    return keys.numpy().copy(), ids


def _case(name, rng):
    """(keys before, probe ids, num_probes) of one schedule case."""
    if name.startswith("crowded"):
        capacity = 1 << 11 if name == "crowded" else 3001
        b1, b2 = _crowded(rng, capacity, int(capacity * 0.45),
                          int(capacity * 0.4))
        keys = tht.fresh_keys(capacity)
        tht.hash_find_or_insert_reference(keys, torch.from_numpy(b1))
        return keys.numpy().copy(), b2, tht.DEFAULT_NUM_PROBES
    if name == "overflow":
        return (np.full(200, -1, np.int64),
                np.concatenate([_ids(rng, 300), np.full(9, -1, np.int64)]), 8)
    if name == "wrap":
        # ids whose base slot lies in the table's last slots: their paths
        # and contests run over the end into slot 0
        capacity = 1 << 12
        keys, _ = _filled(rng, capacity, 0.5)
        c = _ids(rng, 200000)
        b = (jht.np_mix(c) % np.uint64(capacity)).astype(np.int64)
        tail = rng.permutation(c[b >= capacity - 6])[:40]
        keys[capacity - 12:] = -1
        keys[:3] = -1
        ids = np.concatenate([tail, np.full(5, -1, np.int64),
                              _ids(rng, 300)])
        return keys, np.unique(ids)[::-1].copy(), 16
    if name == "holes":
        # an empty slot punched at the base slot of ids that sit further on,
        # and a new id of the same base for some: where the new id comes
        # later in the batch it takes the hole and the old id finds itself
        # behind it; where not, the old id claims the hole (a second copy)
        capacity = 1 << 12
        keys, held = _filled(rng, capacity, 0.75)
        base = (jht.np_mix(held) % np.uint64(capacity)).astype(np.int64)
        at = {int(k): p for p, k in enumerate(keys) if k >= 0}
        far = [i for i, k in enumerate(held) if at[int(k)] != base[i]][:150]
        keys[base[far]] = -1
        cand = _ids(rng, 1 << 19)
        cbase = (jht.np_mix(cand) % np.uint64(capacity)).astype(np.int64)
        rivals = {}
        for c, b in zip(cand, cbase):
            rivals.setdefault(int(b), int(c))
        rival = np.array([rivals[int(b)] for b in base[far]
                          if int(b) in rivals], np.int64)
        ids = np.unique(np.concatenate([held[far], held[:200], rival,
                                        _ids(rng, 300)]))
        ids = np.concatenate([np.full(7, -1, np.int64), rng.permutation(ids)])
        return keys, ids, tht.DEFAULT_NUM_PROBES
    if name == "all_new":
        return (np.full(1 << 12, -1, np.int64),
                np.concatenate([_ids(rng, 2500), np.full(11, -1, np.int64)]),
                tht.DEFAULT_NUM_PROBES)
    assert name == "all_present"
    keys, held = _filled(rng, 1 << 12, 0.6)
    return keys, np.concatenate([rng.permutation(held),
                                 np.full(13, -1, np.int64)]), \
        tht.DEFAULT_NUM_PROBES


@pytest.mark.parametrize("name", ["crowded", "crowded_3001", "overflow",
                                  "wrap", "holes", "all_new", "all_present"])
def test_walk_and_contest_schedule_equals_the_rounds(name):
    """The kernels' schedule, emulated in numpy, places every id, claims
    every slot and counts every overflow as the 64 torch-op rounds do, and
    its pending list is what the plain version counts; the JAX package's
    probe places the same ids alike."""
    rng = np.random.default_rng(sum(name.encode()))
    keys0, ids, num_probes = _case(name, rng)
    keys, slot, overflow, inserted, pending = _np_walk_contest(keys0, ids,
                                                               num_probes)
    tkeys = torch.from_numpy(keys0.copy())
    tslot, toflow, tinserted, tpending = tht.hash_find_or_insert_reference(
        tkeys, torch.from_numpy(ids), num_probes)
    np.testing.assert_array_equal(keys, tkeys.numpy())
    np.testing.assert_array_equal(slot, tslot.numpy())
    assert overflow == int(toflow)
    assert inserted == int(tinserted)
    assert pending == int(tpending)
    jkeys, jslot, joflow = jax.jit(jht.hash_find_or_insert,
                                   static_argnames="num_probes")(
        jnp.asarray(keys0), jnp.asarray(ids), num_probes=num_probes)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    np.testing.assert_array_equal(slot, np.asarray(jslot))
    assert overflow == int(joflow)
    valid = int((ids >= 0).sum())
    if name == "all_present":
        assert pending == inserted == overflow == 0
    elif name == "all_new":
        assert pending == valid and inserted == valid and overflow == 0
    elif name == "overflow":
        assert overflow > 0 and inserted + overflow == valid
    else:
        assert 0 < inserted < pending
    if name == "wrap":
        # some ids of the last slots claimed or found a slot past the end
        live = (ids >= 0) & (slot < len(keys0))
        base = (jht.np_mix(ids[live]) % np.uint64(len(keys0))).astype(
            np.int64)
        assert (slot[live] < base).any()
    if name == "holes":
        # ids of the table whose base slot is a hole: some found themselves
        # behind it, others claimed it
        cap = len(keys0)
        at = {int(k): p for p, k in enumerate(keys0) if k >= 0}
        held = np.array([i for i, k in enumerate(ids) if int(k) in at])
        hbase = (jht.np_mix(ids[held]) % np.uint64(cap)).astype(np.int64)
        holed = keys0[hbase] == tht.EMPTY
        old = np.array([at[int(k)] for k in ids[held]])
        assert (holed & (slot[held] == old)).any()
        assert (holed & (slot[held] == hbase)).any()


def test_cpu_tensors_take_the_plain_rounds(monkeypatch):
    """A CPU tensor never reaches the kernel wrapper, and the plain version
    counts "pending" and "inserted" under a phase clock: every new id on the
    first pull, nothing on a second pull of the same ids."""
    from openembedding_tpu_torch import ops
    from openembedding_tpu_torch.ops import hash_probe
    from openembedding_tpu_torch.utils import phases

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(hash_probe, "find_or_insert", refuse)
    before = dict(hash_probe.LAUNCHES)
    rng = np.random.default_rng(21)
    keys, held = _filled(rng, 1 << 12, 0.3)
    new = np.setdiff1d(_ids(rng, 500), held)
    ids = torch.from_numpy(np.concatenate(
        [np.sort(np.concatenate([held[:300], new])),
         np.full(9, -1, np.int64)]))
    keys = torch.from_numpy(keys)
    want_keys = keys.clone()
    want_slot, want_over, _, _ = tht.hash_find_or_insert_reference(
        want_keys, ids)
    counted = []
    for _ in range(2):
        with phases.clocked("cpu", True) as clock:
            slot, over = tht.hash_find_or_insert(keys, ids)
        counted.append({k: int(v) for k, v in clock.counters.items()})
        if len(counted) == 1:
            assert torch.equal(slot, want_slot) and int(over) == int(
                want_over) == 0
            assert torch.equal(keys, want_keys)
        else:
            assert torch.equal(slot, want_slot)
    assert counted == [{"inserted": len(new), "pending": len(new)},
                       {"inserted": 0, "pending": 0}]
    with phases.clocked("cpu", False) as clock:
        tht.hash_find_or_insert(keys, ids)
    assert clock is None
    assert hash_probe.LAUNCHES == before
    assert {"hash_walk", "hash_contest"} <= set(ops.launch_counts())


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    """The kernel half raises for a CPU tensor (no fallback) and for keys it
    cannot update in place; `plain_versions` swaps in the plain rounds and
    puts the kernel wrapper back."""
    from openembedding_tpu_torch import ops
    from openembedding_tpu_torch.ops import hash_probe
    keys = tht.fresh_keys(64)
    ids = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        hash_probe.find_or_insert(keys, ids, 8)
    with pytest.raises(TypeError):
        hash_probe.find_or_insert(keys.to(torch.int32), ids, 8)
    with pytest.raises(ValueError, match="contiguous"):
        hash_probe.find_or_insert(tht.fresh_keys(128)[::2], ids, 8)
    kernel = hash_probe.find_or_insert
    with ops.plain_versions():
        slot, over, inserted, pending = hash_probe.find_or_insert(keys, ids, 8)
    assert hash_probe.find_or_insert is kernel
    assert int(over) == 0 and int(inserted) == int(pending) == 10
    assert torch.equal(keys[slot], ids)
