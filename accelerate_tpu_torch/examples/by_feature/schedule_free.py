"""Feature: schedule-free training (the reference's
`by_feature/schedule_free.py`).

`optimizer.AdamWScheduleFree` (optax's ``schedule_free_adamw``, with a
linear warmup of 2 steps) needs no learning-rate schedule. It keeps the
train point y (the parameters) apart from the point to evaluate at, x,
which `optimizer.schedule_free_eval_params` recovers: the example loads x
for the evaluation and puts y back after.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.schedule_free --tiny
"""

from __future__ import annotations

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...optimizer import AdamWScheduleFree, schedule_free_eval_params
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    args = base_parser(lr=2e-2).parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, AdamWScheduleFree(model.parameters(), lr=args.lr, warmup_steps=2),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn)
    losses = []
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            losses.append(float(step(batch)))
        # evaluate at the interpolated point x, then train on from y
        train_params = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(schedule_free_eval_params(optimizer, model), strict=False)
        acc = evaluate(accelerator, model, eval_dl)
        model.load_state_dict(train_params)
        accelerator.print(f"epoch {epoch}: loss={losses[-1]:.4f} accuracy={acc:.3f}")
    return {"losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
