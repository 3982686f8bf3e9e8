"""Logistic regression on Criteo with a hashed (2^63) embedding table: the
port of `examples/criteo_lr_subclass.py`.

    python -m openembedding_tpu_torch.examples.criteo_lr_subclass
    python -m openembedding_tpu_torch.examples.criteo_lr_subclass \\
        --device cpu --save /tmp/lr_model --checkpoint /tmp/lr_ckpt
    ... --load /tmp/lr_ckpt          # resume

One `input_dim=-1` table of width 1 (`make_lr(hashed=True,
capacity=1 << 16)`): ids live in the hashed id space (the reader folds
every token into 2^62 ids) and take slots of a fixed-capacity hash table
on the device as they first appear. Trained by `Trainer` with Adagrad(0.05)
through `jit_train_step` (a CUDA graph on the card), one pass of `--data`
per epoch in batches of `--batch-size` (the last one padded). It prints
each epoch's mean loss. `--checkpoint` saves after every epoch with the
optimizer state, `--save` once at the end without it, `--load` resumes.
`main(argv)` returns the state and the per-step losses.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import optimizers
from ..data import CriteoBatcher, read_criteo_tsv
from ..device import resolve_device
from ..model import Trainer
from ..models import make_lr

DEFAULT_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "train100.tsv")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m openembedding_tpu_torch.examples.criteo_lr_subclass",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=DEFAULT_DATA)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--checkpoint", default="",
                    help="save after every epoch (with optimizer state)")
    ap.add_argument("--save", default="",
                    help="save at the end, without optimizer state")
    ap.add_argument("--load", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must "
                         "be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # input_dim=-1: ids of the hashed id space in a fixed-capacity device
    # hash table (size the capacity about twice the ids expected)
    model = make_lr(vocabulary=-1, hashed=True, capacity=1 << 16)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                      device=device)

    def epoch_batches():
        return CriteoBatcher(
            read_criteo_tsv(args.data, args.batch_size, id_space=1 << 62,
                            drop_remainder=False, native="on"),
            args.batch_size)

    state = trainer.init(next(iter(epoch_batches())))
    if args.load:
        state = trainer.load(state, args.load)
        print(f"resumed from {args.load} at step {state.step}")
    step = trainer.jit_train_step()

    losses = []
    for epoch in range(args.epochs):
        epoch_losses = []
        for batch in epoch_batches():
            state, metrics = step(state, batch)
            epoch_losses.append(metrics["loss"].clone())
        epoch_losses = torch.stack(epoch_losses).cpu().numpy()
        losses.append(epoch_losses)
        print(f"epoch {epoch}: loss {np.mean(epoch_losses):.4f}")
        if args.checkpoint:
            trainer.save(state, args.checkpoint)
    if args.save:
        trainer.save(state, args.save, include_optimizer=False)
        print(f"saved to {args.save}")
    return {"model": model, "trainer": trainer, "state": state,
            "driver": step,
            "losses": np.concatenate(losses or [np.zeros(0, np.float32)])}


if __name__ == "__main__":
    main()
