"""Feature: gradient compression hooks (the reference's
`by_feature/ddp_comm_hook.py`).

``make_train_step`` averages the gradients over the processes through the
hook a `DistributedDataParallelKwargs` names: ``bf16`` / ``fp16`` send them
in half the bytes, ``power_sgd`` sends a rank-r factorization with error
feedback (`parallel.compression`). At one process there is nothing to
reduce.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.ddp_comm_hook --tiny --device cpu
    python -m accelerate_tpu_torch.commands.launch --debug_cpu 2 \\
        -m accelerate_tpu_torch.examples.by_feature.ddp_comm_hook --tiny --ddp_comm_hook power_sgd
"""

from __future__ import annotations

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.dataclasses import DistributedDataParallelKwargs
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--ddp_comm_hook", default="bf16",
                        choices=["no", "fp16", "bf16", "power_sgd", "batched_power_sgd"])
    args = parser.parse_args(argv)
    set_seed(args.seed)
    ddp_kwargs = DistributedDataParallelKwargs(comm_hook=args.ddp_comm_hook,
                                               matrix_approximation_rank=2)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn, comm_hook=ddp_kwargs)
    losses = []
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            losses.append(float(step(batch)))
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch} [{args.ddp_comm_hook}]: loss={losses[-1]:.4f} "
                          f"accuracy={acc:.3f}")
    return {"losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
