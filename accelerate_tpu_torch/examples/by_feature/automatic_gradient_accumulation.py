"""Feature: automatic gradient accumulation (the reference's
`by_feature/automatic_gradient_accumulation.py`).

`find_executable_batch_size` with accumulation: when the batch must shrink
to fit memory, the accumulation count grows so the optimizer still sees an
effective batch of 256.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.automatic_gradient_accumulation --tiny
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...memory import find_executable_batch_size
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model

OBSERVED_BATCH_SIZE = 256  # the effective batch of each optimizer update


def main(argv: list[str] | None = None) -> dict:
    args = base_parser().parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)

    @find_executable_batch_size(starting_batch_size=OBSERVED_BATCH_SIZE)
    def inner_training_loop(batch_size: int) -> tuple[float, float]:
        accum = OBSERVED_BATCH_SIZE // batch_size
        accelerator.print(f"batch_size={batch_size} x accumulation={accum}")
        accelerator.free_memory()
        accelerator.gradient_accumulation_steps = accum
        n_train = 2 * accum if args.tiny else 8 * accum
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
    accelerator.print(f"loss={loss:.4f} accuracy={acc:.3f}")
    return {"loss": loss, "accuracy": acc, "batch_size": inner_training_loop.batch_size}


if __name__ == "__main__":
    main()
