"""The port of `accelerate_tpu.optimizer` ``AcceleratedOptimizer``: a torch
optimizer whose ``step`` and ``zero_grad`` do nothing off a gradient
accumulation boundary, so a training loop can call them every microbatch,
and which, under fp16, unscales the gradients and skips the update when
they are not finite."""

from __future__ import annotations

from typing import Any, Callable

import torch

from .state import GradientState
from .utils.precision import DynamicGradScaler, GradScalerState


class AcceleratedOptimizer:
    """Wraps a `torch.optim.Optimizer`. Gradients accumulate in the
    parameters' ``.grad`` between boundaries (summed over microbatches, as
    the reference's accumulation buffer is). ``num_updates`` counts the
    updates applied (a skipped fp16 step is not one); ``step_was_skipped``
    says whether the last boundary's update was skipped."""

    def __init__(self, optimizer: torch.optim.Optimizer, gradient_state: GradientState,
                 scaler: DynamicGradScaler | None = None):
        self.optimizer = optimizer
        self.gradient_state = gradient_state
        self.scaler = scaler
        self.scaler_state: GradScalerState | None = None
        if scaler is not None:
            self.scaler_state = scaler.init(self._params()[0].device)
        self.num_updates = 0
        self.skipped_updates = 0
        self.step_was_skipped = False
        self._unscaled = False  # the gradients of this boundary are unscaled already

    @property
    def param_groups(self) -> list[dict]:
        return self.optimizer.param_groups

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def grads(self) -> list[torch.Tensor]:
        """The accumulated gradients (parameters that have one)."""
        return [p.grad for p in self._params() if p.grad is not None]

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the gradients: a no-op while accumulating."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def unscale_(self) -> None:
        """Divide the gradients by the fp16 scale, check them and step the
        scaler's policy; ``step_was_skipped`` says whether they were not all
        finite (reference `Accelerator.unscale_gradients`). Once per
        boundary: a second call does nothing."""
        if self.scaler is None or self._unscaled:
            return
        self.scaler_state, finite = self.scaler.unscale_and_update(self.grads(), self.scaler_state)
        self.step_was_skipped = not bool(finite)
        self._unscaled = True

    def step(self, closure: Callable | None = None) -> None:
        """Apply the accumulated gradients: a no-op while accumulating. Under
        fp16 the gradients are unscaled first (unless `unscale_` ran this
        boundary) and the update is skipped, its gradients dropped, when
        they are not all finite."""
        if not self.gradient_state.sync_gradients:
            self.step_was_skipped = False
            return
        if not self.grads():
            raise RuntimeError("optimizer.step() called with no gradients; run a backward pass first")
        self.unscale_()
        self._unscaled = False
        self._apply(closure)

    def _apply(self, closure: Callable | None = None) -> None:
        """Step the wrapped optimizer, or drop the gradients of a skipped
        step."""
        if self.scaler is not None and self.step_was_skipped:
            self.optimizer.zero_grad(set_to_none=True)
            self.skipped_updates += 1
            return
        self.optimizer.step(closure)
        self.step_was_skipped = False
        self.num_updates += 1

    def state_dict(self) -> dict[str, Any]:
        out = {"optimizer": self.optimizer.state_dict(), "num_updates": self.num_updates,
               "skipped_updates": self.skipped_updates}
        if self.scaler_state is not None:
            out["scaler_state"] = dict(self.scaler_state._asdict())
        return out

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.num_updates = int(state.get("num_updates", 0))
        self.skipped_updates = int(state.get("skipped_updates", 0))
        if "scaler_state" in state and self.scaler is not None:
            device = self.scaler_state.scale.device
            self.scaler_state = GradScalerState(
                **{k: v.to(device) for k, v in state["scaler_state"].items()})
