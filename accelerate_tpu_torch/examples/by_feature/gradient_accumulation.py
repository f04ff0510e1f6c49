"""Feature: gradient accumulation (the reference's
`by_feature/gradient_accumulation.py`).

`Accelerator(gradient_accumulation_steps=N)` makes ``make_train_step`` fold
N microbatches into one optimizer update (and the last batch of an epoch
closes the window). The imperative form, ``with accelerator.accumulate():
accelerator.backward(loss_fn, batch); optimizer.step();
optimizer.zero_grad()``, does the same.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.gradient_accumulation --tiny
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--gradient_accumulation_steps", type=int, default=4)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision,
                              gradient_accumulation_steps=args.gradient_accumulation_steps,
                              device=args.device)
    n_train = 4 if args.tiny else 16
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn)
    losses = []
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            loss = step(batch)  # the optimizer moves on every N-th call
            losses.append(float(loss))
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch}: loss={losses[-1]:.4f} accuracy={acc:.3f} "
                          f"(updates={optimizer.num_updates})")
    return {"losses": losses, "accuracy": acc, "updates": optimizer.num_updates}


if __name__ == "__main__":
    main()
