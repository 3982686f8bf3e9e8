"""Placement planning for the mesh (port of the JAX package's
`placement/`): `plan_migration` turns measured per-shard loads into a move
list for `parallel.MeshTrainer.migrate_rows`, and `candidate_weights` takes
the hot set out of a candidate list. The sketch-fed policy and controller
wait for the heavy-hitter sketches (ROADMAP.md item 6)."""

from .migration import candidate_weights, plan_migration

__all__ = ["candidate_weights", "plan_migration"]
