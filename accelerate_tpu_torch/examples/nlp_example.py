"""NLP example: BERT sequence classification through the whole Accelerator
flow, the port of the reference's `examples/nlp_example.py`.

The reference's synthetic, separable text-pair task (label-1 rows share a
token prefix), built from ``--seed``: 8 batches to train on and 2 to
evaluate. `Accelerator.prepare` takes the model, torch AdamW with optax's
defaults (betas 0.9/0.999, eps 1e-8, weight decay 1e-4), both loaders and
the reference's schedule (`scheduler.warmup_cosine_decay_schedule`, warm-up
of 4 updates from 0 to ``--lr``, decay over every batch of the run) driven
through `LambdaLR`; each epoch trains with ``make_train_step`` (gradient
accumulation, global-norm clipping), steps the scheduler on each applied
update, and evaluates with ``gather_for_metrics``; ``--with_tracking`` logs
each epoch's loss and accuracy to the JSONL tracker and ``--checkpointing``
ends with ``save_state``.

Run:
    python -m accelerate_tpu_torch.examples.nlp_example                  # BERT-base on CUDA
    python -m accelerate_tpu_torch.examples.nlp_example --tiny --device cpu
    python -m accelerate_tpu_torch.examples.nlp_example --mixed_precision bf16 --lr 2e-5
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from ..accelerator import Accelerator
from ..data_loader import DataLoaderShard
from ..models.bert import BertConfig, BertForSequenceClassification, classification_loss_fn
from ..scheduler import schedule_lambda, warmup_cosine_decay_schedule
from ..utils.random import set_seed

MAX_LEN = 64


def synthetic_mrpc(n: int, vocab: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's task: ``n`` rows of ``MAX_LEN`` ids, and labels; the
    rows labelled 1 start with ids 2..9."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, MAX_LEN)).astype(np.int32)
    labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
    ids[labels == 1, :8] = np.arange(2, 10)
    mask = np.ones((n, MAX_LEN), dtype=np.int32)
    return ids, mask, labels


def get_dataloaders(batch_size: int, vocab: int, seed: int) -> tuple[list[dict], list[dict]]:
    """8 train and 2 eval batches of numpy arrays, the reference's split."""
    ids, mask, labels = synthetic_mrpc(10 * batch_size, vocab, seed)
    n_train = 8 * batch_size

    def batches(lo: int, hi: int) -> list[dict]:
        return [{"input_ids": ids[i:i + batch_size], "attention_mask": mask[i:i + batch_size],
                 "labels": labels[i:i + batch_size]}
                for i in range(lo, hi - batch_size + 1, batch_size)]

    return batches(0, n_train), batches(n_train, len(ids))


def training_function(args: argparse.Namespace, config: BertConfig | None = None,
                      weights: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """Train and evaluate as the reference's example does. ``config``
    replaces the ``--tiny``/base choice and ``weights`` (a state dict) the
    seeded initial weights. Returns what the run saw: every microbatch's
    loss, the lr of every applied update, each epoch's loss, accuracy and
    training seconds (host clock, ending in a sync), the last evaluation's
    predictions, where the checkpoint went and how long it took, and the
    accelerator, model and train step, for a caller that goes on."""
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        log_with="jsonl" if args.with_tracking else None,
        project_dir=args.project_dir,
        device=args.device,
    )
    if args.with_tracking:
        accelerator.init_trackers("nlp_example", config=vars(args))
    set_seed(args.seed)

    config = config or (BertConfig.tiny() if args.tiny else BertConfig.base())
    model = BertForSequenceClassification(config, device=accelerator.device, seed=args.seed)
    if weights is not None:
        model.load_state_dict(weights)

    train_batches, eval_batches = get_dataloaders(args.batch_size, config.vocab_size, args.seed)
    schedule = warmup_cosine_decay_schedule(0.0, args.lr, warmup_steps=4,
                                            decay_steps=len(train_batches) * args.num_epochs)
    optimizer = torch.optim.AdamW(model.parameters(), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(
        model, optimizer, DataLoaderShard(train_batches), DataLoaderShard(eval_batches),
        schedule_lambda(optimizer, schedule))

    step = accelerator.make_train_step(classification_loss_fn, max_grad_norm=args.max_grad_norm)
    run: dict[str, Any] = {"losses": [], "lrs": [], "epochs": [], "train_samples": 0}
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        for batch in train_dl:
            loss = step(batch)
            run["losses"].append(loss)
            run["train_samples"] += len(batch["labels"])
            if accelerator.sync_gradients and not optimizer.step_was_skipped:
                run["lrs"].append(scheduler.get_last_lr()[0])  # the lr this update applied
            scheduler.step()
        loss = float(loss)
        train_s = time.perf_counter() - t0
        correct = total = 0
        preds = []
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["input_ids"], batch["attention_mask"])
                gathered = accelerator.gather_for_metrics({"preds": logits.argmax(-1),
                                                           "labels": batch["labels"]})
                correct += int((gathered["preds"] == gathered["labels"]).sum())
                total += len(gathered["labels"])
                preds += gathered["preds"].tolist()
        acc = correct / max(total, 1)
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} accuracy={acc:.3f}")
        if args.with_tracking:
            accelerator.log({"loss": loss, "accuracy": acc}, step=epoch)
        run["epochs"].append({"epoch": epoch, "loss": loss, "accuracy": acc, "train_s": train_s})
        run["preds"] = preds
    run["losses"] = [float(x) for x in run["losses"]]
    if args.checkpointing:
        t0 = time.perf_counter()
        run["checkpoint_dir"] = accelerator.save_state()
        run["save_s"] = time.perf_counter() - t0
    accelerator.end_training()
    run.update(accelerator=accelerator, model=model, step=step, optimizer=optimizer,
               scheduler=scheduler, train_dl=train_dl)
    return run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT on a synthetic MRPC-shaped task")
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--with_tracking", action="store_true")
    p.add_argument("--checkpointing", action="store_true")
    p.add_argument("--project_dir", default=None)
    p.add_argument("--tiny", action="store_true", help="tiny config for smoke tests")
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    training_function(parser().parse_args())


if __name__ == "__main__":
    main()
