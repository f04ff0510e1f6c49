"""Feature: Local SGD (the reference's `by_feature/local_sgd.py`).

Each process trains its own copy of the model on its slice of every global
batch, with no collective; every ``--local_sgd_steps`` steps the copies'
parameters and optimizer states are averaged (`local_sgd.LocalSGD`), and
once more at the end.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.local_sgd --tiny --device cpu
    python -m accelerate_tpu_torch.commands.launch --debug_cpu 2 \\
        -m accelerate_tpu_torch.examples.by_feature.local_sgd --tiny
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...local_sgd import LocalSGD, make_local_train_step
from ...utils.random import set_seed
from ._common import base_parser, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--local_sgd_steps", type=int, default=4)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    model = make_model(args.seed, accelerator.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    local_step, sync, replicate, unreplicate = make_local_train_step(loss_fn, model, optimizer)
    island = replicate()
    n_train = 4 if args.tiny else 16
    train_dl = accelerator.prepare_data_loader(
        DataLoaderShard(make_batches(n_train, args.batch_size)))
    losses = []
    with LocalSGD(sync_fn=sync, local_sgd_steps=args.local_sgd_steps) as lsgd:
        for _ in range(args.num_epochs):
            for batch in train_dl:
                island, loss = local_step(island, batch)
                island = lsgd.step(island)  # the average every local_sgd_steps
                losses.append(float(accelerator.reduce(loss, reduction="mean")))
    island = sync(island)  # the final average

    correct = total = 0
    with torch.no_grad():
        for batch in make_batches(4, args.batch_size, seed=1):
            x = torch.from_numpy(batch["x"]).to(accelerator.device)
            preds = island.module(x).argmax(-1).cpu()
            correct += int((preds == torch.from_numpy(batch["labels"]).long()).sum())
            total += len(batch["labels"])
    accelerator.print(f"loss={losses[-1]:.4f} accuracy={correct / total:.3f}")
    return {"losses": losses, "accuracy": correct / total, "params": unreplicate(island)}


if __name__ == "__main__":
    main()
