"""Feature: experiment tracking (the reference's `by_feature/tracking.py`).

``init_trackers`` starts the trackers ``log_with`` names (``"jsonl"`` is
the built-in one), ``log`` records metrics on the main process, trackers
that support it take images and a table, and ``end_training`` closes them.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.tracking --tiny --project_dir DIR
"""

from __future__ import annotations

import tempfile

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--log_with", default="jsonl", help="jsonl (the ported tracker)")
    args = parser.parse_args(argv)
    set_seed(args.seed)
    project_dir = args.project_dir or tempfile.mkdtemp(prefix="tracking_example_")
    accelerator = Accelerator(mixed_precision=args.mixed_precision, log_with=args.log_with,
                              project_dir=project_dir, device=args.device)
    accelerator.init_trackers("tracking_example", config=vars(args))
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn)
    global_step, losses = 0, []
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            losses.append(float(step(batch)))
            accelerator.log({"train_loss": losses[-1]}, step=global_step)
            global_step += 1
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.log({"accuracy": acc, "epoch": epoch}, step=global_step)
        accelerator.print(f"epoch {epoch}: loss={losses[-1]:.4f} accuracy={acc:.3f}")
    # media: the first layer's weight magnitudes as an image, and a table
    if accelerator.is_main_process:
        heat = model.fc1.weight.detach().abs().T  # [features, hidden], the reference's w1
        for tracker in accelerator.trackers:
            try:
                tracker.log_images({"viz/weight_magnitude": heat / heat.max().clamp(min=1e-8)},
                                   step=global_step)
                tracker.log_table("final_metrics", columns=["metric", "value"],
                                  data=[["accuracy", acc], ["final_loss", losses[-1]]],
                                  step=global_step)
            except NotImplementedError:
                pass
    accelerator.end_training()
    accelerator.print(f"metrics logged under {project_dir}")
    return {"losses": losses, "accuracy": acc, "project_dir": project_dir}


if __name__ == "__main__":
    main()
