"""Feature: long-context training with sliding-window (band) attention (the
reference's `by_feature/sliding_window_long_context.py`).

``LlamaConfig(sliding_window=W, attention_impl="flash")`` routes causal
attention onto the band flash kernels (`ops.flash_attention.flash_attention`
with ``window=``): only the key blocks inside the window are visited, so
attention costs O(seq x W) rather than O(seq^2), and grouped K/V are read
in place. On the card that is the CUDA band forward, dQ and dK/dV kernels;
on the CPU their plain versions.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.sliding_window_long_context --tiny
"""

from __future__ import annotations

import numpy as np
import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...models.llama import LlamaConfig, LlamaForCausalLM
from ...utils.random import set_seed
from ._common import base_parser


def loss_fn(model, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy over every position but the last."""
    ids = batch["input_ids"]
    logits = model(ids)
    labels = torch.roll(ids, -1, dims=1)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, :-1, None].long()).mean()


def main(argv: list[str] | None = None) -> dict:
    args = base_parser().parse_args(argv)
    set_seed(args.seed)
    seq, window = 128, 32  # at scale: seq 32768, window 4096 (Mistral)
    cfg = LlamaConfig.tiny(dtype=torch.float32, max_position_embeddings=seq,
                           sliding_window=window, attention_impl="flash")
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    rng = np.random.default_rng(args.seed)
    n_batches = 8 if args.tiny else 16
    # tokens from a 32-token subset of the 256-token vocabulary: the loss
    # has room to fall from about ln(256) toward ln(32)
    ids = rng.integers(0, 32, (n_batches, 2, seq)).astype(np.int32)
    model = LlamaForCausalLM(cfg, device=accelerator.device, seed=0)
    model, optimizer, loader = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        DataLoaderShard([{"input_ids": b} for b in ids]))
    step = accelerator.make_train_step(loss_fn)
    losses = [float(step(batch)) for batch in loader]
    accelerator.print(f"sliding-window W={window} over seq={seq}: "
                      f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert min(losses[1:]) < losses[0], losses
    return {"losses": losses}


if __name__ == "__main__":
    main()
