"""Cold-tail migration planning: measured load -> explicit id -> owner moves
(a numpy copy of `openembedding_tpu/placement/migration.py`).

Take the per-shard load vector the exchange reports
(`stats["<table>/shard_positions"]`), price each heavy-but-not-hot id's
per-step load from its weight, and greedily re-home ids from overloaded
shards onto the lightest one while that improves the projected max/mean
imbalance. The output is a plain (ids, owners) pair, the input of
`parallel.MeshTrainer.migrate_rows`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def plan_migration(shard_positions, candidates: Sequence[Tuple[int, float]],
                   *, num_shards: int, max_moves: int,
                   target: float = 1.05, total: float = 0.0,
                   exclude=None) -> Tuple[np.ndarray, np.ndarray, float]:
    """-> (ids, owners, projected_imbalance).

    `shard_positions`: (S,) measured per-step load by owner shard (already
    reflects any ACTIVE directory — the load vector is computed from the
    routed plan, so re-planning from a migrated steady state is stable).
    `candidates`: [(id, weight)] heaviest-first COLD ids (caller must have
    removed the hot set); weights are sketch estimates, `total` the
    sketch's observed-stream total on the same scale — each id's per-step
    load is priced as its traffic SHARE of the measured load vector.
    `exclude`: ids never to move (e.g. the hot set, belt and braces).

    Greedy: walk candidates hottest-first; move an id off its CURRENT home
    (its `id % S` hash home — ids already re-homed by an active directory
    are re-planned from scratch, since `migrate_rows` installs a full
    directory, not a delta) onto the lightest shard whenever its home is
    above the mean and the move shrinks the home/dest spread. Stops at
    `max_moves` (the annex capacity) or when projected max/mean <= target."""
    S = int(num_shards)
    load = np.asarray(shard_positions, np.float64).copy()
    if load.size != S or load.sum() <= 0 or not candidates:
        imb = float(load.max() / load.mean()) if load.size and \
            load.mean() > 0 else 0.0
        return (np.zeros((0,), np.int64), np.zeros((0,), np.int64), imb)
    excl = set() if exclude is None else \
        set(int(i) for i in np.asarray(exclude, np.int64).reshape(-1))
    # price sketch estimates in per-step load units: an id with traffic
    # share w/total absorbs that share of the measured positions
    wtot = max(float(total), sum(max(w, 0.0) for _i, w in candidates), 1.0)
    step_load = float(load.sum())
    ids_out: List[int] = []
    own_out: List[int] = []
    for cid, w in candidates:
        if len(ids_out) >= int(max_moves):
            break
        if float(load.max()) / float(load.mean()) <= target:
            break
        cid = int(cid)
        if cid < 0 or cid in excl:
            continue
        home = cid % S
        if load[home] <= float(load.mean()):
            continue  # its shard is not the problem
        w_step = min(max(float(w), 0.0) / wtot * step_load,
                     float(load[home]))
        dest = int(np.argmin(load))
        if dest == home or w_step <= 0:
            continue
        if max(load[home] - w_step, load[dest] + w_step) >= load[home]:
            # accept only strictly-improving moves: the home/dest pair's
            # local max must fall, or the id just flips the hot spot
            continue
        load[home] -= w_step
        load[dest] += w_step
        ids_out.append(cid)
        own_out.append(dest)
    imb = float(load.max() / load.mean()) if load.mean() > 0 else 0.0
    return (np.asarray(ids_out, np.int64), np.asarray(own_out, np.int64),
            imb)


def candidate_weights(top_ids: Sequence[Tuple[int, float]],
                      hot_ids) -> List[Tuple[int, float]]:
    """Heavy-but-not-hot candidates: the sketch's top-K minus the installed
    hot set, hottest first — the ids replication did not absorb but whose
    placement still matters."""
    hot = set(int(i) for i in np.asarray(
        hot_ids, np.int64).reshape(-1).tolist()) if hot_ids is not None \
        else set()
    return [(int(i), float(e)) for i, e in top_ids if int(i) not in hot]
