"""Feature: coordinated early stopping (the reference's
`by_feature/early_stopping.py`).

Any process may call ``set_trigger()``; ``check_trigger()`` sums the flag
over processes, so every process breaks out on the same step.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.early_stopping --tiny
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser(num_epochs=10)
    parser.add_argument("--early_stop_loss", type=float, default=0.2)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn)

    losses, stopped_at = [], None
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            losses.append(float(step(batch)))
            if losses[-1] < args.early_stop_loss:  # a local decision ...
                accelerator.set_trigger()
            if accelerator.check_trigger():  # ... that every process sees
                stopped_at = epoch
                break
        if stopped_at is not None:
            break
    acc = evaluate(accelerator, model, eval_dl)
    accelerator.print(f"stopped at epoch {stopped_at}: loss={losses[-1]:.4f} accuracy={acc:.3f}")
    return {"losses": losses, "stopped_at": stopped_at, "accuracy": acc}


if __name__ == "__main__":
    main()
