"""Complete NLP example: every feature in one script, the port of the
reference's `examples/complete_nlp_example.py` over the ported BERT:
tracking, checkpoints by epoch or by step, mid-epoch resume, gradient
accumulation, clipping, a learning-rate schedule and gathered metrics.

The nlp example's synthetic task (`nlp_example.get_dataloaders`); torch
AdamW with optax's defaults under the reference's warm-up cosine schedule
through ``LambdaLR``, also registered for checkpointing as the reference
does. ``--checkpointing_steps epoch`` saves ``checkpoints/epoch_<e>``,
``step`` saves ``checkpoints/step_<n>`` every ``--save_every`` batches; a
checkpoint's name tells ``--resume_from_checkpoint`` where to go on from:
after epoch ``e``, or inside an epoch with ``skip_first_batches``.

Run:
    python -m accelerate_tpu_torch.examples.complete_nlp_example --tiny --device cpu \\
        --with_tracking --checkpointing_steps epoch --project_dir DIR
    python -m accelerate_tpu_torch.examples.complete_nlp_example --tiny --device cpu \\
        --project_dir DIR --resume_from_checkpoint DIR/checkpoints/epoch_0
"""

from __future__ import annotations

import argparse
import os
from typing import Any

import torch

from ..accelerator import Accelerator, ProjectConfiguration
from ..data_loader import DataLoaderShard, skip_first_batches
from ..models.bert import BertConfig, BertForSequenceClassification, classification_loss_fn
from ..scheduler import schedule_lambda, warmup_cosine_decay_schedule
from ..utils.random import set_seed
from .nlp_example import get_dataloaders


def training_function(args: argparse.Namespace, config: BertConfig | None = None,
                      weights: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """Train as the reference's example does; ``config`` and ``weights``
    replace the config choice and the seeded weights. Returns every
    microbatch's loss, each epoch's loss and accuracy, and the epoch it
    started from."""
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        log_with="jsonl" if args.with_tracking else None,
        project_config=ProjectConfiguration(project_dir=args.project_dir or "complete_nlp_out",
                                            automatic_checkpoint_naming=True, total_limit=2),
        device=args.device,
    )
    if args.with_tracking:
        accelerator.init_trackers("complete_nlp_example", config=vars(args))
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
    accelerator.register_for_checkpointing(scheduler)

    overall_step, starting_epoch, resume_step = 0, 0, None
    if args.resume_from_checkpoint:
        accelerator.load_state(args.resume_from_checkpoint)
        # the checkpoint's name holds the position: epoch_<e> or step_<n>
        tag = os.path.basename(args.resume_from_checkpoint.rstrip("/"))
        if tag.startswith("epoch_"):
            starting_epoch = int(tag.split("_")[1]) + 1
        elif tag.startswith("step_"):
            overall_step = int(tag.split("_")[1])
            starting_epoch = overall_step // len(train_dl)
            resume_step = overall_step % len(train_dl)

    step = accelerator.make_train_step(classification_loss_fn, max_grad_norm=args.max_grad_norm)
    run: dict[str, Any] = {"losses": [], "epochs": [], "starting_epoch": starting_epoch}
    for epoch in range(starting_epoch, args.num_epochs):
        dl = train_dl
        if resume_step is not None and epoch == starting_epoch:
            dl = skip_first_batches(train_dl, resume_step)
            resume_step = None
        for batch in dl:
            loss = step(batch)
            run["losses"].append(loss)
            scheduler.step()
            overall_step += 1
            if args.checkpointing_steps == "step" and overall_step % args.save_every == 0:
                accelerator.save_state(os.path.join(accelerator.project_dir, "checkpoints",
                                                    f"step_{overall_step}"))
        loss = float(loss)
        correct = total = 0
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["input_ids"], batch["attention_mask"])
                g = accelerator.gather_for_metrics({"preds": logits.argmax(-1),
                                                    "labels": batch["labels"]})
                correct += int((g["preds"] == g["labels"]).sum())
                total += len(g["labels"])
        acc = correct / max(total, 1)
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} accuracy={acc:.3f}")
        run["epochs"].append({"epoch": epoch, "loss": loss, "accuracy": acc})
        if args.with_tracking:
            accelerator.log({"loss": loss, "accuracy": acc, "epoch": epoch}, step=overall_step)
        if args.checkpointing_steps == "epoch":
            accelerator.save_state(os.path.join(accelerator.project_dir, "checkpoints",
                                                f"epoch_{epoch}"))
    accelerator.end_training()
    run["losses"] = [float(x) for x in run["losses"]]
    return run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT with every feature combined")
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--with_tracking", action="store_true")
    p.add_argument("--checkpointing_steps", default=None, choices=[None, "epoch", "step"])
    p.add_argument("--save_every", type=int, default=10, help="batches between step checkpoints")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--project_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    training_function(parser().parse_args())


if __name__ == "__main__":
    main()
