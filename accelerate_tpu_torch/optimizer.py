"""The port of `accelerate_tpu.optimizer` ``AcceleratedOptimizer``: a torch
optimizer whose ``step`` and ``zero_grad`` do nothing off a gradient
accumulation boundary, so a training loop can call them every microbatch,
and which, under fp16, unscales the gradients and skips the update when
they are not finite.

And `AdamWScheduleFree`, the port of the reference's schedule-free AdamW
(``optax.contrib.schedule_free_adamw``, which its
``examples/by_feature/schedule_free.py`` trains with), with
`schedule_free_eval_params` for the point to evaluate at."""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np

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
        # across processes: the 0-d finite flag every rank agrees on (set by
        # the accelerator at more than one process)
        self.agree_finite: Callable[[torch.Tensor], torch.Tensor] | None = None

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
        grads = self.grads()
        torch._foreach_mul_(grads, 1.0 / self.scaler_state.scale)
        finite = self.scaler.all_finite(grads)
        if self.agree_finite is not None:
            finite = self.agree_finite(finite)
        self.scaler_state = self.scaler.update_state(self.scaler_state, finite)
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


class AdamWScheduleFree(torch.optim.Optimizer):
    """Schedule-free AdamW, optax's ``schedule_free_adamw`` step for step
    (Defazio et al., "The Road Less Scheduled", 2024). The parameters hold
    y, where gradients are taken; the state keeps z (the base iterate) and
    the second moment. Each step, with ``lr_t`` the linear warmup from 0 to
    ``lr`` over ``warmup_steps`` (constant ``lr`` without one):

      - the base update (Adam without momentum, bias-corrected, plus the
        decayed weights of y) moves z by ``-lr_{t-1}`` times it;
      - the averaging weight ``c = max_lr^p / sum(max_lr^p)`` (``p`` is
        ``weight_lr_power``, ``max_lr`` the largest ``lr_t`` so far) moves
        x, recovered from y and the old z, toward the new z;
      - y becomes ``b1 x + (1 - b1) z``.

    The scalars are computed in fp32, as optax computes them. The state is
    per parameter (``z``, ``nu``) and per group (``step_count``,
    ``weight_sum``, ``max_lr``, the base ``count``), so ``state_dict``
    round-trips it."""

    def __init__(self, params: Iterable, lr: float = 0.0025, warmup_steps: int | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, weight_lr_power: float = 2.0):
        if not b1 > 0.0:
            raise ValueError("schedule-free AdamW needs b1 > 0")
        super().__init__(params, dict(lr=lr, warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, weight_lr_power=weight_lr_power,
                                      step_count=1, count=0, weight_sum=0.0, max_lr=0.0))

    @staticmethod
    def _lr(group: dict, count: int) -> np.float32:
        """optax's ``warmup_constant_schedule(0, lr, warmup_steps)`` at
        ``count``, in fp32 (its polynomial form)."""
        lr = np.float32(group["lr"])
        warmup = group["warmup_steps"]
        if warmup is None:
            return lr
        if warmup <= 0:
            return np.float32(0.0)
        frac = np.float32(1.0) - np.float32(min(max(count, 0), warmup)) / np.float32(warmup)
        return np.float32((np.float32(0.0) - lr) * frac + lr)

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        f32 = np.float32
        for group in self.param_groups:
            # optax's arithmetic: fp32 state scalars, Python constants cast
            # to fp32 where they meet a tensor (JAX's weak types, torch's
            # Python scalars)
            b1, b2 = group["b1"], group["b2"]
            lr_sf = self._lr(group, group["step_count"])
            max_lr = max(f32(group["max_lr"]), lr_sf)
            weight = f32(max_lr ** f32(group["weight_lr_power"]))
            total = f32(f32(group["weight_sum"]) + weight)
            if np.isnan(weight) or np.isnan(total):
                ck = f32(np.nan)
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    ck = f32(np.nan_to_num(weight / total, nan=0.0, posinf=np.inf))
            count = group["count"] + 1
            bc2 = float(f32(1.0) - f32(b2) ** f32(count))
            lr_base = float(-self._lr(group, group["count"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["z"] = p.detach().clone()
                    state["nu"] = torch.zeros_like(p)
                z, g = state["z"], p.grad
                nu = (1 - b2) * (g * g) + b2 * state["nu"]
                update = (1 / (torch.sqrt(nu / bc2) + group["eps"])) * g
                update = update + group["weight_decay"] * p
                z_new = z + lr_base * update
                prev_x = (p - (1.0 - b1) * z) / b1
                x = float(f32(1.0) - ck) * prev_x + float(ck) * z_new
                y = b1 * x + (1.0 - b1) * z_new
                p.add_(y - p)
                state["z"], state["nu"] = z_new, nu
            group.update(step_count=group["step_count"] + 1, count=count,
                         weight_sum=float(total), max_lr=float(max_lr))
        return loss


def schedule_free_eval_params(optimizer: Any, model: Any) -> dict[str, torch.Tensor]:
    """The point to evaluate a schedule-free model at, ``x = (y - (1 - b1) z)
    / b1``, by parameter name of ``model`` (an ``nn.Module`` or a prepared
    model), for ``load_state_dict(..., strict=False)``; the parameters a step
    has not touched yet give their own values (optax's counterpart)."""
    optimizer = getattr(optimizer, "optimizer", optimizer)
    if not isinstance(optimizer, AdamWScheduleFree):
        raise ValueError("schedule_free_eval_params needs an AdamWScheduleFree optimizer")
    module = getattr(model, "module", model)
    b1_of = {id(p): np.float32(g["b1"]) for g in optimizer.param_groups for p in g["params"]}
    out = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            state = optimizer.state.get(p)
            if id(p) not in b1_of or not state:
                out[name] = p.detach().clone()
                continue
            b1 = b1_of[id(p)]
            out[name] = (p - float(np.float32(1.0) - b1) * state["z"]) / float(b1)
    return out
