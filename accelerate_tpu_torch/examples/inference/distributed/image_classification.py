"""Image-sharded batch classification, the port of the reference's
`examples/inference/distributed/image_classification.py`: the image batch
splits across processes with padding, so every process runs the same shape,
each process runs ViT on its slice, the predictions gather everywhere and
each process's padded tail is dropped before the gather.

Run:
    python -m accelerate_tpu_torch.examples.inference.distributed.image_classification
    python -m accelerate_tpu_torch.examples.inference.distributed.image_classification --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ....models.vit import ViTConfig, ViTForImageClassification
from ....state import PartialState
from ....utils.operations import gather_object


def run(args: argparse.Namespace) -> list[int]:
    """The gathered predictions, one per image (on every process)."""
    state = PartialState(args.device)
    cfg = ViTConfig.tiny()
    model = ViTForImageClassification(cfg, device=state.device, seed=args.seed)

    images = np.random.default_rng(args.seed).normal(  # NCHW, the torch conv layout
        size=(args.num_images, cfg.num_channels, cfg.image_size, cfg.image_size)
    ).astype(np.float32)

    # split_between_processes pads every process with index >= n % processes,
    # not just the last: each truncates its own padded tail before the gather
    base, extra = divmod(args.num_images, state.num_processes)
    my_real = base + (1 if state.process_index < extra else 0)
    with state.split_between_processes(images, apply_padding=True) as my_images, \
            torch.no_grad():
        logits = model(torch.from_numpy(np.asarray(my_images)).to(state.device))
        preds = logits.argmax(dim=-1).tolist()[:my_real]

    all_preds = gather_object(preds)
    if state.is_main_process:
        print(f"{len(all_preds)} predictions from {state.num_processes} process(es):")
        print(all_preds)
    return all_preds


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ViT predictions over process-sharded images")
    p.add_argument("--num_images", type=int, default=10)  # uneven over several processes
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
