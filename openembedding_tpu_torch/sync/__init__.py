"""Online model sync (port of `openembedding_tpu/sync/`): stream a training
run's committed embedding deltas into live serving replicas, with no
restart and no full reload.

- `publisher.SyncPublisher` exposes a persist root's committed base/delta
  chain (`persist.IncrementalPersister`'s `delta_<step>` directories) as a
  versioned HTTP feed on the serving surface (`GET /models/<sign>:versions`,
  `GET /models/<sign>/delta/<step>/...`), rows optionally bf16 or int8 on
  the wire (`ops/wire`'s numpy codecs);
- `subscriber.SyncSubscriber` runs inside a serving node: it fetches the
  missing delta suffix, checks the parent-pointer chain, applies rows off
  the predict path (`StandaloneModel.apply_update`: new tensors, the live
  servable never written) and swaps the servable atomically
  (`ModelManager.swap`), staying on the last good version on any failure;
- `lineage` books each delta's birth -> commit -> publish -> fetch ->
  apply -> swap -> first serve.

The feed format (`oetpu-sync-v1`), its JSON keys and npz members, the ETags,
status codes and the `sync.*` metric names are the JAX package's, so nodes
of either package follow each other.
"""

from . import lineage
from .publisher import SyncPublisher
from .subscriber import (FaultInjector, SyncChainError, SyncError,
                         SyncSubscriber)

__all__ = ["SyncPublisher", "SyncSubscriber", "SyncError", "SyncChainError",
           "FaultInjector", "lineage"]
