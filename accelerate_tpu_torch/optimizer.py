"""The port of `accelerate_tpu.optimizer` ``AcceleratedOptimizer``: a torch
optimizer whose ``step`` and ``zero_grad`` do nothing off a gradient
accumulation boundary, so a training loop can call them every microbatch."""

from __future__ import annotations

from typing import Callable

import torch

from .state import GradientState


class AcceleratedOptimizer:
    """Wraps a `torch.optim.Optimizer`. Gradients accumulate in the
    parameters' ``.grad`` between boundaries (summed over microbatches, as
    the reference's accumulation buffer is). ``num_updates`` counts the
    steps applied."""

    def __init__(self, optimizer: torch.optim.Optimizer, gradient_state: GradientState):
        self.optimizer = optimizer
        self.gradient_state = gradient_state
        self.num_updates = 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the gradients: a no-op while accumulating."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure: Callable | None = None) -> None:
        """Apply the accumulated gradients: a no-op while accumulating."""
        if not self.gradient_state.sync_gradients:
            return
        params = (p for group in self.optimizer.param_groups for p in group["params"])
        if all(p.grad is None for p in params):
            raise RuntimeError("optimizer.step() called with no gradients; run a backward pass first")
        self.optimizer.step(closure)
        self.num_updates += 1
