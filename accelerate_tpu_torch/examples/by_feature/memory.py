"""Feature: an out-of-memory-adaptive batch size (the reference's
`by_feature/memory.py`).

`find_executable_batch_size` calls the training function with a starting
batch size and, when the device runs out of memory
(``torch.cuda.OutOfMemoryError``), releases the attempt's memory and calls
it again with half the batch.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.memory --tiny
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...memory import find_executable_batch_size
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--starting_batch_size", type=int, default=256)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)

    @find_executable_batch_size(starting_batch_size=args.starting_batch_size)
    def inner_training_loop(batch_size: int) -> tuple[float, float]:
        accelerator.print(f"trying batch_size={batch_size}")
        accelerator.free_memory()  # drop the last attempt's prepared objects
        n_train = 4 if args.tiny else 12
        model = make_model(args.seed, accelerator.device)
        model, optimizer, train_dl, eval_dl = accelerator.prepare(
            model, torch.optim.Adam(model.parameters(), lr=args.lr),
            DataLoaderShard(make_batches(n_train, batch_size)),
            DataLoaderShard(make_batches(4, batch_size, seed=1)))
        step = accelerator.make_train_step(loss_fn)
        for _ in range(args.num_epochs):
            for batch in train_dl:
                loss = step(batch)
        return evaluate(accelerator, model, eval_dl), float(loss)

    acc, loss = inner_training_loop()
    accelerator.print(f"converged at batch_size={inner_training_loop.batch_size}: "
                      f"loss={loss:.4f} accuracy={acc:.3f}")
    return {"loss": loss, "accuracy": acc, "batch_size": inner_training_loop.batch_size}


if __name__ == "__main__":
    main()
