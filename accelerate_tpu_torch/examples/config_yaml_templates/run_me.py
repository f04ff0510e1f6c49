"""Run a config template, the port of the reference's
`examples/config_yaml_templates/run_me.py`: load the YAML, build the
`Accelerator` it describes, print the resolved mesh, and take one tiny GPT-2
step through ``prepare`` and ``make_train_step(lm_loss_fn)``. Under
``mixed_precision: fp8`` the model is built with the fp8 recipe
(`ops.fp8.DelayedScalingRecipe`), so its block projections run in fp8.

Run:
    python -m accelerate_tpu_torch.examples.config_yaml_templates.run_me --config_file FILE
    python -m accelerate_tpu_torch.examples.config_yaml_templates.run_me --config_file FILE --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ...accelerator import Accelerator
from ...commands.config import LaunchConfig
from ...models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn
from ...ops.fp8 import DelayedScalingRecipe
from ...parallel.mesh import ParallelismConfig


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, take the step, and return ``{"mesh", "loss",
    "mixed_precision", "model"}``."""
    ap = argparse.ArgumentParser(description="one tiny GPT-2 step through a config template")
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    cfg = LaunchConfig.from_yaml(args.config_file)
    print(f"compute_environment={cfg.compute_environment} "
          f"mixed_precision={cfg.mixed_precision} "
          f"mesh: dp={cfg.data_parallel_size} fsdp={cfg.fsdp_size} "
          f"tp={cfg.tensor_size} pp={cfg.stage_size}")
    acc = Accelerator(
        mixed_precision=cfg.mixed_precision,
        parallelism_config=ParallelismConfig(data_parallel_size=cfg.data_parallel_size,
                                             fsdp_size=cfg.fsdp_size, tensor_size=cfg.tensor_size,
                                             stage_size=cfg.stage_size),
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        device=args.device,
    )
    mesh = dict(acc.mesh.shape)
    print("mesh:", mesh)

    recipe = DelayedScalingRecipe() if cfg.mixed_precision == "fp8" else None
    mcfg = GPT2Config.tiny(dtype=torch.float32, fp8_recipe=recipe)
    module = GPT2LMHead(mcfg, device=acc.device, seed=0)
    model, _ = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3))
    step = acc.make_train_step(lm_loss_fn)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, mcfg.vocab_size, (8, 16)))
    loss = float(step({"input_ids": ids.to(acc.device)}))
    print("one step ok, loss =", loss)
    return {"mesh": mesh, "loss": loss, "mixed_precision": cfg.mixed_precision, "model": module}


if __name__ == "__main__":
    main()
