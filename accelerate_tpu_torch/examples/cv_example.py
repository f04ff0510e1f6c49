"""CV example: ResNet image classification through the Accelerator, the
port of the reference's `examples/cv_example.py` (ResNet-50).

The reference's synthetic, separable images (each class a distinct mean
brightness), built from ``--seed``: 8 batches to train on and 2 to
evaluate. `Accelerator.prepare` takes the model, torch SGD with momentum
0.9 (optax ``sgd(lr, momentum=0.9)``'s update) and both loaders; each epoch
trains with ``make_train_step`` and evaluates with ``gather_for_metrics``.
``--tiny`` is the reference's CI size: `ResNetConfig.tiny` at 32 x 32.

Run:
    python -m accelerate_tpu_torch.examples.cv_example                    # ResNet-50 on CUDA
    python -m accelerate_tpu_torch.examples.cv_example --tiny --device cpu
    python -m accelerate_tpu_torch.examples.cv_example --mixed_precision bf16
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from ..accelerator import Accelerator
from ..data_loader import DataLoaderShard
from ..models.resnet import ResNet, ResNetConfig, image_classification_loss_fn
from ..utils.random import set_seed


def synthetic_images(n: int, size: int, num_classes: int, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The reference's images: NHWC fp32, class ``c`` centred on
    ``c / num_classes`` with noise of 0.1, and int32 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    base = labels[:, None, None, None] / num_classes
    images = (base + 0.1 * rng.normal(size=(n, size, size, 3))).astype(np.float32)
    return images, labels


def get_dataloaders(batch_size: int, size: int, num_classes: int, seed: int
                    ) -> tuple[list[dict], list[dict]]:
    """8 train and 2 eval batches of numpy arrays, the reference's split."""
    images, labels = synthetic_images(10 * batch_size, size, num_classes, seed)
    n_train = 8 * batch_size

    def batches(lo: int, hi: int) -> list[dict]:
        return [{"image": images[i:i + batch_size], "label": labels[i:i + batch_size]}
                for i in range(lo, hi - batch_size + 1, batch_size)]

    return batches(0, n_train), batches(n_train, len(images))


def training_function(args: argparse.Namespace, config: ResNetConfig | None = None,
                      weights: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """Train and evaluate as the reference's example does. ``config``
    replaces the ``--tiny``/ResNet-50 choice and ``weights`` (a state dict)
    the seeded initial weights. Returns what the run saw: every
    microbatch's loss, each epoch's loss, accuracy and training seconds
    (host clock, ending in a sync), and the accelerator, model, optimizer
    and train step, for a caller that goes on."""
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        device=args.device,
    )
    set_seed(args.seed)
    config = config or (ResNetConfig.tiny() if args.tiny
                        else ResNetConfig.resnet50(num_classes=args.num_classes))
    size = 32 if args.tiny else args.image_size
    model = ResNet(config, device=accelerator.device, seed=args.seed)
    if weights is not None:
        model.load_state_dict(weights)

    train_batches, eval_batches = get_dataloaders(args.batch_size, size, config.num_classes,
                                                  args.seed)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, optimizer, DataLoaderShard(train_batches), DataLoaderShard(eval_batches))
    step = accelerator.make_train_step(image_classification_loss_fn)
    run: dict[str, Any] = {"losses": [], "epochs": [], "train_samples": 0}
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        for batch in train_dl:
            loss = step(batch)
            run["losses"].append(loss)
            run["train_samples"] += len(batch["label"])
        loss = float(loss)
        train_s = time.perf_counter() - t0
        correct = total = 0
        with torch.no_grad():
            for batch in eval_dl:
                gathered = accelerator.gather_for_metrics(
                    {"p": model(batch["image"]).argmax(-1), "l": batch["label"]})
                correct += int((gathered["p"] == gathered["l"]).sum())
                total += len(gathered["l"])
        acc = correct / max(total, 1)
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} accuracy={acc:.3f}")
        run["epochs"].append({"epoch": epoch, "loss": loss, "accuracy": acc, "train_s": train_s})
    run["losses"] = [float(x) for x in run["losses"]]
    run.update(accelerator=accelerator, model=model, optimizer=optimizer, step=step,
               train_dl=train_dl, image_size=size)
    return run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ResNet on synthetic separable images")
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--num_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    training_function(parser().parse_args())


if __name__ == "__main__":
    main()
