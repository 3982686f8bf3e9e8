"""Self-driving placement for the mesh (port of the JAX package's
`placement/`):

- `PlacementPolicy` (policy.py): pure numpy decision math, sizing each
  table's hot set from its coverage curve against one replicated-byte
  budget, gating refreshes on predicted hit-ratio gain with hysteresis and
  cooldown, deciding when the cold tail needs re-homing and which wire
  formats to use;
- `plan_migration` (migration.py): measured per-shard loads and
  heavy-but-not-hot ids -> a move list for `MeshTrainer.migrate_rows`;
  `candidate_weights` takes the hot set out of a candidate list;
- `PlacementController` (controller.py): the loop, applying refreshes
  and migrations between steps from the sketches, with `placement.*`
  gauges, flight-recorder events and the `/statusz` panel
  (`render_status`). At S > 1 its decisions are rank 0's, sent to every
  rank.
"""

from .controller import PlacementController, render_status
from .migration import candidate_weights, plan_migration
from .policy import PlacementPolicy, TableTelemetry

__all__ = ["PlacementController", "PlacementPolicy", "TableTelemetry",
           "candidate_weights", "plan_migration", "render_status"]
