"""Feature: metrics over every process (the reference's
`by_feature/multi_process_metrics.py`).

Each process evaluates its slice of every global eval batch;
``gather_for_metrics`` collects the slices in rank order and drops the
samples that completed the last, ragged batch, so every process ends with
the whole eval set, each sample once, as one process would.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.multi_process_metrics --tiny --device cpu
    python -m accelerate_tpu_torch.commands.launch --debug_cpu 2 \\
        -m accelerate_tpu_torch.examples.by_feature.multi_process_metrics --tiny
"""

from __future__ import annotations

import numpy as np
import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, loss_fn, make_batches, make_model


def eval_batches(n_samples: int, batch_size: int) -> list[dict]:
    """``n_samples`` eval samples in batches of ``batch_size``, the last one
    short."""
    full = make_batches(-(-n_samples // batch_size), batch_size, seed=1)
    last = n_samples - batch_size * (len(full) - 1)
    full[-1] = {k: v[:last] for k, v in full[-1].items()}
    return full


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--eval_samples", type=int, default=151,
                        help="eval set size; the default leaves a last batch of 23")
    args = parser.parse_args(argv)
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(eval_batches(args.eval_samples, args.batch_size)))
    step = accelerator.make_train_step(loss_fn)
    losses = []
    for _ in range(args.num_epochs):
        for batch in train_dl:
            losses.append(float(step(batch)))

    # the metrics library's way: every process ends with the whole eval set
    all_preds, all_labels = [], []
    with torch.no_grad():
        for batch in eval_dl:
            preds = model(batch["x"]).argmax(-1)
            g = accelerator.gather_for_metrics({"preds": preds, "labels": batch["labels"]})
            all_preds.append(g["preds"].cpu().numpy())
            all_labels.append(g["labels"].cpu().numpy())
    preds, labels = np.concatenate(all_preds), np.concatenate(all_labels)
    accuracy = float((preds == labels).mean())
    accelerator.print(f"eval set {len(labels)} samples on {accelerator.num_processes} "
                      f"process(es), loss={losses[-1]:.4f} accuracy={accuracy:.3f}")
    return {"losses": losses, "eval_samples": len(labels), "labels": labels.tolist(),
            "accuracy": accuracy}


if __name__ == "__main__":
    main()
