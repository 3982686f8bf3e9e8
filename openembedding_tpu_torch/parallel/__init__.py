"""The mesh path over `torch.distributed` (port of
`openembedding_tpu/parallel/`): the 1-D mesh of ranks (`mesh`), its
collectives (`collectives`), process-group set-up and a local launcher
(`multihost`), the sharded pull/push protocol (`sharded`), `MeshTrainer`
(`trainer`) and sharded checkpoints (`checkpoint`)."""

from .mesh import DATA_AXIS, Mesh, make_mesh
from .sharded import (ExchangePlan, deinterleave_rows, grouped_apply_gradients,
                      grouped_lookup_train, interleave_rows,
                      sharded_apply_gradients, sharded_lookup,
                      sharded_lookup_train)
from .trainer import MeshTrainer

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "ExchangePlan",
           "deinterleave_rows", "interleave_rows", "sharded_lookup",
           "sharded_lookup_train", "sharded_apply_gradients",
           "grouped_lookup_train", "grouped_apply_gradients", "MeshTrainer"]
