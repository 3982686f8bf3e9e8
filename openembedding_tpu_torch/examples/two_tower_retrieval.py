"""Two-tower retrieval with multivalent (variable-length) features: the port
of `examples/two_tower_retrieval.py`.

    python -m openembedding_tpu_torch.examples.two_tower_retrieval
    python -m openembedding_tpu_torch.examples.two_tower_retrieval \\
        --device cpu --steps 20
    ... --mesh                     # MeshTrainer over the world group

Each user row is a variable-length history (the user id first) and each
item row a variable-length tag list: `data.pad_ragged` pads them to fixed
widths with -1 and `combiner="mean"` pools the valid slots, so the towers
do not depend on the width. `make_two_tower(4096, 2048, dim=16,
tower=(64, 32), combiner="mean")`, Adagrad(0.1), batches of 64 from a
seeded generator with a planted preference (user u likes the items
congruent to u mod 7), trained through `jit_train_step` (a CUDA graph on
the card); then exported and queried at another width than training's.
`--mesh` trains through `parallel.MeshTrainer` over the world group (one
rank alone without torchrun; each rank in-batch softmaxes its own rows, as
each device does in the JAX package) and exports from its sharded
checkpoint. `main(argv)` returns the state, the losses and the served
scores.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np

from .. import optimizers
from ..data import pad_ragged
from ..device import resolve_device
from ..export import StandaloneModel, export_standalone
from ..model import Trainer
from ..models import make_two_tower

N_USERS, N_ITEMS = 4096, 2048
MAX_HIST, MAX_TAGS = 8, 4


def synthetic_histories(rng, batch, n_users, n_items, max_hist, max_tags):
    """The JAX example's generator: user u likes the items congruent to u
    mod 7, which the towers must learn to co-embed."""
    users, items = [], []
    for _ in range(batch):
        u = int(rng.integers(0, n_users))
        group = u % 7
        hist = rng.integers(0, n_users, size=int(rng.integers(1, max_hist)))
        pos = group + 7 * rng.integers(0, n_items // 7,
                                       size=int(rng.integers(1, max_tags)))
        users.append([u] + hist.tolist())
        items.append(pos.tolist())
    return {"sparse": {"user": pad_ragged(users, width=max_hist + 1),
                       "item": pad_ragged(items, width=max_tags)},
            "dense": None, "label": None}


def _positive_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("--steps must be >= 1")
    return n


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m openembedding_tpu_torch.examples.two_tower_retrieval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=_positive_int, default=60)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--mesh", action="store_true",
                    help="train through MeshTrainer over the world group")
    ap.add_argument("--export", default="",
                    help="export directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must "
                         "be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = make_two_tower(N_USERS, N_ITEMS, dim=args.dim, tower=(64, 32),
                           combiner="mean")
    opt = optimizers.Adagrad(learning_rate=0.1)
    mesh = None
    if args.mesh:
        from ..parallel import MeshTrainer, make_mesh, multihost
        multihost.initialize("nccl" if device.type == "cuda" else "gloo")
        mesh = make_mesh(device=args.device)
        trainer = MeshTrainer(model, opt, mesh=mesh)
    else:
        trainer = Trainer(model, opt, device=device)

    def batch_of(rng):
        b = synthetic_histories(rng, args.batch_size, N_USERS, N_ITEMS,
                                MAX_HIST, MAX_TAGS)
        if mesh is not None:
            from ..parallel.multihost import local_batch
            b = local_batch(b, mesh)
        return b

    rng = np.random.default_rng(0)
    sample = batch_of(rng)
    state = trainer.init(sample)
    step = trainer.jit_train_step()
    losses = []
    for i in range(args.steps):
        state, m = step(state, batch_of(rng))
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  in-batch softmax loss {losses[-1]:.4f}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # export, then a ragged query at another width than training's
    query = {"sparse": {
        "user": np.asarray([[11, 4, -1], [200, -1, -1]], np.int64),
        "item": np.asarray([[4, 11], [7, -1]], np.int64)}}
    with tempfile.TemporaryDirectory(prefix="oetpu_two_tower_") as tmp:
        root = args.export or os.path.join(tmp, "export")
        source, src_state = trainer, state
        if mesh is not None:
            # the export needs whole tables: from the sharded checkpoint
            ckpt = os.path.join(tmp, "ckpt")
            trainer.save(state, ckpt)
            source = Trainer(model, opt, device=device)
            src_state = source.load(source.init(sample), ckpt)
        scores = None
        if mesh is None or mesh.rank == 0:
            export_standalone(source.externalize(src_state), model, root,
                              model_sign="tt-demo-0")
            sm = StandaloneModel.load(root, model=model, device=device)
            scores = sm.predict(query).float().cpu().numpy()
            if not np.isfinite(scores).all():
                raise RuntimeError("the served scores are not finite")
            print(f"served score matrix at width 3/2: diag="
                  f"{np.round(np.diagonal(scores), 3).tolist()}")
        if mesh is not None:
            from ..parallel.collectives import barrier
            barrier(mesh)
    return {"state": state, "losses": np.asarray(losses, np.float32),
            "scores": scores, "trainer": trainer, "step": step}


if __name__ == "__main__":
    main()
