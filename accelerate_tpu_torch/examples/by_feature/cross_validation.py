"""Feature: k-fold cross-validation (the reference's
`by_feature/cross_validation.py`).

Each fold trains a fresh model on the other folds' batches; each fold's
test logits are gathered with ``gather_for_metrics`` and the folds'
average is the ensemble's prediction.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.cross_validation --tiny
"""

from __future__ import annotations

import numpy as np
import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--num_folds", type=int, default=3)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    n_train = 4 if args.tiny else 12
    folds = [make_batches(n_train, args.batch_size, seed=f) for f in range(args.num_folds)]
    test_batches = make_batches(4, args.batch_size, seed=99)

    fold_logits, fold_losses, labels = [], [], None
    for fold_idx in range(args.num_folds):
        accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
        train = [b for i, f in enumerate(folds) if i != fold_idx for b in f]
        model = make_model(args.seed + fold_idx, accelerator.device)
        model, optimizer, train_dl, test_dl = accelerator.prepare(
            model, torch.optim.Adam(model.parameters(), lr=args.lr), DataLoaderShard(train),
            DataLoaderShard(test_batches))
        step = accelerator.make_train_step(loss_fn)
        losses = []
        for _ in range(args.num_epochs):
            for batch in train_dl:
                losses.append(float(step(batch)))
        logits_all, labels_all = [], []
        with torch.no_grad():
            for batch in test_dl:
                g = accelerator.gather_for_metrics({"logits": model(batch["x"]),
                                                    "labels": batch["labels"]})
                logits_all.append(g["logits"].cpu().numpy())
                labels_all.append(g["labels"].cpu().numpy())
        fold_logits.append(np.concatenate(logits_all))
        fold_losses.append(losses)
        labels = np.concatenate(labels_all)
        accelerator.print(f"fold {fold_idx}: loss={losses[-1]:.4f}")

    preds = np.mean(fold_logits, axis=0).argmax(-1)  # the ensemble: the folds' mean
    accuracy = float((preds == labels).mean())
    accelerator.print(f"ensembled accuracy={accuracy:.3f}")
    return {"fold_losses": fold_losses, "accuracy": accuracy}


if __name__ == "__main__":
    main()
