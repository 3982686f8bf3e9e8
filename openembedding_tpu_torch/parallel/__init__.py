"""The mesh path over `torch.distributed` (port of
`openembedding_tpu/parallel/`): the 1-D mesh of ranks and the 2-D (data,
seq) one (`mesh`), their collectives (`collectives`), process-group set-up
and a local launcher (`multihost`), the sharded pull/push protocol
(`sharded`), `MeshTrainer` and the context-parallel `SeqMeshTrainer`
(`trainer`), ring and Ulysses attention (`sequence`), the ZeRO
dense-state layout (`zero`), sharded checkpoints (`checkpoint`) and
sharded serving (`serving.ShardedModel`: one process, no collective)."""

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, make_mesh, make_seq_mesh
from .sharded import (ExchangePlan, deinterleave_rows, grouped_apply_gradients,
                      grouped_lookup_train, interleave_rows,
                      sharded_apply_gradients, sharded_lookup,
                      sharded_lookup_train)
from . import zero
from .sequence import reference_attention, ring_attention, ulysses_attention
from .trainer import MeshTrainer, SeqMeshTrainer

__all__ = ["DATA_AXIS", "SEQ_AXIS", "Mesh", "make_mesh", "make_seq_mesh",
           "SeqMeshTrainer", "reference_attention", "ring_attention",
           "ulysses_attention", "ExchangePlan",
           "deinterleave_rows", "interleave_rows", "sharded_lookup",
           "sharded_lookup_train", "sharded_apply_gradients",
           "grouped_lookup_train", "grouped_apply_gradients", "MeshTrainer",
           "zero"]
