"""`EmbeddingVariable`: a stateful handle over one table (port of
`openembedding_tpu/variable.py`).

The reference's imperative `Variable` API (`sparse_read`, `pull_weights`,
`push_gradients`, `update_weights`, `set_server_optimizer`) for users who
drive a table directly rather than through `Trainer`. The state lives in
`.state` (an `EmbeddingTableState` on the variable's device); reads go
through the gather kernel (`embedding.lookup` / `lookup_train`) and the
update through the fused apply kernel (`embedding.apply_gradients`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .embedding import (EmbeddingSpec, EmbeddingTableState, apply_gradients,
                        init_table_state, lookup, lookup_train)
from .optimizers import Default, SparseOptimizer


def _generator(spec: EmbeddingSpec, seed: int, device) -> torch.Generator:
    """The table's generator from (seed, variable id); a spec built outside
    an `EmbeddingModel` (variable id -1) takes the stream 2^15, which no
    assigned variable id reaches, as in the JAX package."""
    vid = spec.variable_id if spec.variable_id >= 0 else (1 << 15)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 131071 + vid)
    return gen


class EmbeddingVariable:
    """One table and its optimizer. `device`: None is the CUDA card (raises
    without one); pass "cpu" for the CPU. The table is drawn from a
    generator seeded from (seed, variable id)."""

    def __init__(self, spec: EmbeddingSpec,
                 optimizer: Optional[SparseOptimizer] = None, seed: int = 0,
                 *, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.optimizer = optimizer or spec.optimizer or Default()
        self.state: EmbeddingTableState = init_table_state(
            spec, self.optimizer, _generator(spec, seed, self.device))
        self._pending_ids: Optional[torch.Tensor] = None
        self._pending_grads: Optional[torch.Tensor] = None

    def _coerce_ids(self, ids) -> torch.Tensor:
        """Ids on the variable's device as int64. Ragged input (a list of
        id lists, what the reference's `sparse_read` takes as a
        RaggedTensor) pads to the longest list with -1: pad slots pull zero
        rows and train nothing, so sum-pooling the rows is varlen pooling."""
        from .data import is_ragged, pad_ragged
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int64)
        if is_ragged(ids):
            ids = pad_ragged(ids)
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def sparse_read(self, ids) -> torch.Tensor:
        """The training pull (the reference's `Variable.sparse_read`): ids
        (any shape) -> ids.shape + (dim,); a hash table inserts unseen ids.
        Use `read_only_pull` to serve."""
        ids = self._coerce_ids(ids)
        _, rows, _, _ = lookup_train(self.spec, self.state, ids)
        return rows

    pull_weights = sparse_read

    def read_only_pull(self, ids) -> torch.Tensor:
        """The serving pull: never inserts; absent ids give zero rows."""
        return lookup(self.spec, self.state, self._coerce_ids(ids))

    def prefetch(self, ids) -> None:
        """The reference's `Variable.prefetch`: a hash table inserts unseen
        ids now, so a later `sparse_read` finds them resident; an array
        table has nothing to do."""
        if self.spec.use_hash_table:
            lookup_train(self.spec, self.state, self._coerce_ids(ids))

    def push_gradients(self, ids, grads) -> None:
        """Queue gradients for `update_weights`. Ragged ids coerce as in
        `sparse_read`, so the pull -> push round trip takes the same input;
        the gradients of pad slots (-1) train no row."""
        ids = self._coerce_ids(ids).reshape(-1)
        grads = torch.as_tensor(grads, dtype=torch.float32,
                                device=self.device).reshape(
            -1, self.spec.output_dim)
        if self._pending_ids is None:
            self._pending_ids, self._pending_grads = ids, grads
        else:
            self._pending_ids = torch.cat([self._pending_ids, ids])
            self._pending_grads = torch.cat([self._pending_grads, grads])

    @torch.no_grad()
    def update_weights(self) -> None:
        """Apply the queued gradients once, in place: duplicates summed, the
        optimizer once per unique id."""
        if self._pending_ids is None:
            return
        apply_gradients(self.spec, self.state, self.optimizer,
                        self._pending_ids, self._pending_grads)
        self._pending_ids = self._pending_grads = None

    def set_optimizer(self, optimizer: SparseOptimizer) -> None:
        """Swap the optimizer (the reference's `set_server_optimizer`): slots
        both layouts have, with the same shape, carry over; new ones start
        at their initial value."""
        old = self.state.slots
        new = optimizer.init_slots(self.state.weights.shape[0],
                                   self.spec.output_dim,
                                   self.state.weights.dtype,
                                   device=self.device)
        for name in new:
            if name in old and old[name].shape == new[name].shape:
                new[name] = old[name]
        self.state.slots = new
        self.optimizer = optimizer
