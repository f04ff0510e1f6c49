"""Complete CV example: ResNet classification with every feature combined,
the port of the reference's `examples/complete_cv_example.py`: tracking,
checkpoints, resume, a cosine learning-rate schedule, gradient
accumulation and gathered metrics.

The reference's own synthetic images (class ``c`` shifted by ``0.5 c``), 8
batches to train on and 2 to evaluate; SGD with momentum 0.9 under
``cosine_decay_schedule(lr, 8 x epochs)`` driven through ``LambdaLR`` and
stepped every batch. ``--with_tracking`` logs each epoch's loss and
accuracy to the JSONL tracker; ``--checkpointing`` saves
``checkpoints/epoch_<e>`` after each epoch; ``--resume_from_checkpoint DIR``
loads a checkpoint before training and then trains every epoch again, as
the reference does (the batches repeat each epoch, so a run resumed from
``epoch_0`` retraces the unbroken run's later epochs).

Run:
    python -m accelerate_tpu_torch.examples.complete_cv_example --tiny --device cpu --with_tracking
    python -m accelerate_tpu_torch.examples.complete_cv_example --checkpointing --project_dir DIR
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..accelerator import Accelerator, ProjectConfiguration
from ..data_loader import DataLoaderShard
from ..models.resnet import ResNet, ResNetConfig, image_classification_loss_fn
from ..scheduler import cosine_decay_schedule, schedule_lambda
from ..utils.random import set_seed


def synthetic_images(n: int, size: int, num_classes: int, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The reference's images for this example: NHWC normal noise plus
    ``0.5 x label``, and int32 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    imgs = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    imgs += labels[:, None, None, None].astype(np.float32) * 0.5
    return imgs, labels


def _dir_bytes(path: str) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def training_function(args: argparse.Namespace, config: ResNetConfig | None = None,
                      weights: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """Train, evaluate, track and checkpoint as the reference's example
    does. ``config`` replaces the ``--tiny``/ResNet-50 choice and
    ``weights`` the seeded initial weights. Returns every microbatch's loss,
    each epoch's loss and accuracy, and each checkpoint's directory, bytes
    and save seconds (and the load's seconds)."""
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        log_with="jsonl" if args.with_tracking else None,
        project_config=ProjectConfiguration(project_dir=args.project_dir or "complete_cv_out",
                                            automatic_checkpoint_naming=True, total_limit=2),
        device=args.device,
    )
    if args.with_tracking:
        accelerator.init_trackers("complete_cv_example", config=vars(args))
    set_seed(args.seed)
    config = config or (ResNetConfig.tiny() if args.tiny else ResNetConfig.resnet50())
    size = 32 if args.tiny else 224
    model = ResNet(config, device=accelerator.device, seed=args.seed)
    if weights is not None:
        model.load_state_dict(weights)

    imgs, labels = synthetic_images(10 * args.batch_size, size, config.num_classes, args.seed)
    n_train = 8 * args.batch_size

    def batches(lo: int, hi: int) -> list[dict]:
        return [{"image": imgs[i:i + args.batch_size], "label": labels[i:i + args.batch_size]}
                for i in range(lo, hi - args.batch_size + 1, args.batch_size)]

    schedule = cosine_decay_schedule(args.lr, decay_steps=8 * args.num_epochs)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(
        model, optimizer, DataLoaderShard(batches(0, n_train)),
        DataLoaderShard(batches(n_train, len(imgs))), schedule_lambda(optimizer, schedule))
    run: dict[str, Any] = {"losses": [], "epochs": [], "checkpoints": []}
    if args.resume_from_checkpoint:
        t0 = time.perf_counter()
        accelerator.load_state(args.resume_from_checkpoint)
        run["load_s"] = time.perf_counter() - t0

    step = accelerator.make_train_step(image_classification_loss_fn)
    for epoch in range(args.num_epochs):
        for batch in train_dl:
            loss = step(batch)
            run["losses"].append(loss)
            scheduler.step()
        loss = float(loss)
        correct = total = 0
        with torch.no_grad():
            for batch in eval_dl:
                g = accelerator.gather_for_metrics({"preds": model(batch["image"]).argmax(-1),
                                                    "labels": batch["label"]})
                correct += int((g["preds"] == g["labels"]).sum())
                total += len(g["labels"])
        acc = correct / max(total, 1)
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} accuracy={acc:.3f}")
        run["epochs"].append({"epoch": epoch, "loss": loss, "accuracy": acc})
        if args.with_tracking:
            accelerator.log({"loss": loss, "accuracy": acc}, step=epoch)
        if args.checkpointing:
            t0 = time.perf_counter()
            out = accelerator.save_state(
                os.path.join(accelerator.project_dir, "checkpoints", f"epoch_{epoch}"))
            run["checkpoints"].append({"dir": out, "save_s": time.perf_counter() - t0,
                                       "bytes": _dir_bytes(out)})
    accelerator.end_training()
    run["losses"] = [float(x) for x in run["losses"]]
    run.update(accelerator=accelerator, model=model, optimizer=optimizer, scheduler=scheduler)
    return run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ResNet with tracking, checkpoints and resume")
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--num_epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--with_tracking", action="store_true")
    p.add_argument("--checkpointing", action="store_true")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--project_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    training_function(parser().parse_args())


if __name__ == "__main__":
    main()
