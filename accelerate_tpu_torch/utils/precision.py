"""Mixed-precision policy and the dynamic loss scaler: the port of
`accelerate_tpu.utils.precision` ``PrecisionPolicy`` and
``DynamicGradScaler``.

As in the reference, precision is a functional cast policy around the train
step, not an autocast context: master parameters stay fp32, and under
``"bf16"`` or ``"fp16"`` the forward and backward run on copies of every
floating parameter in that dtype (LayerNorm scale and bias and the
embeddings included). The copies are made with ``Tensor.to``, so autograd
carries their gradients back to the fp32 masters in fp32.

``"fp16"`` scales the loss by a `DynamicGradScaler`, whose state (the scale
and the count of finite steps since the last change) lives in device
tensors, as the reference threads it through its jitted step. ``"fp8"``
(the Hopper fp8 matmuls) is not ported yet (ROADMAP Queue 1, item 21):
asking for it raises.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import NamedTuple

import torch

_AUTOCAST_ENABLED = contextvars.ContextVar("accelerate_tpu_torch_autocast_enabled", default=True)


def autocast_enabled() -> bool:
    """Whether prepared-model calls apply the compute-dtype cast (False
    inside ``Accelerator.autocast(AutocastKwargs(enabled=False))``)."""
    return _AUTOCAST_ENABLED.get()


def set_autocast_enabled(enabled: bool) -> contextvars.Token:
    """Returns the token that `reset_autocast_enabled` takes."""
    return _AUTOCAST_ENABLED.set(bool(enabled))


def reset_autocast_enabled(token: contextvars.Token) -> None:
    _AUTOCAST_ENABLED.reset(token)


@dataclass(frozen=True)
class PrecisionPolicy:
    """``compute_dtype`` is what the forward and backward run in; the master
    parameters stay in their own dtype (fp32)."""

    mode: str = "no"
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def from_mode(cls, mode: str | None) -> "PrecisionPolicy":
        mode = (mode or "no").lower()
        if mode in ("no", "fp32", "none"):
            return cls(mode="no")
        if mode == "bf16":
            return cls(mode="bf16", compute_dtype=torch.bfloat16)
        if mode == "fp16":
            return cls(mode="fp16", compute_dtype=torch.float16)
        if mode == "fp8":
            raise NotImplementedError(
                "mixed_precision='fp8' is not ported yet: it needs the Hopper fp8 matmuls "
                "(ROADMAP Queue 1, item 21)")
        raise ValueError(f"Unknown mixed_precision mode {mode!r}")

    @property
    def requires_loss_scaling(self) -> bool:
        return self.mode == "fp16"

    def cast_to_compute(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Every floating tensor of ``params`` in the compute dtype (a
        differentiable copy); others pass through. Identity under ``"no"``."""
        if self.mode == "no":
            return params
        return {name: t.to(self.compute_dtype) if t.is_floating_point() else t
                for name, t in params.items()}


class GradScalerState(NamedTuple):
    """The scaler's state: ``scale`` (fp32) and ``growth_tracker`` (int32,
    the finite boundaries since the scale last changed), 0-d device
    tensors."""

    scale: torch.Tensor
    growth_tracker: torch.Tensor


@dataclass
class DynamicGradScaler:
    """torch GradScaler's policy as explicit state (reference
    `utils/precision.py:109-170`): double the scale after ``growth_interval``
    finite boundaries (up to ``max_scale``), halve it and skip the update on
    a non-finite one.

    The scale S is split (`split_scale`): ``min(S, max_inner_scale)``
    multiplies the loss inside the fp16 backward (it lifts small gradients
    out of fp16's underflow while a healthy cotangent chain stays under
    65504), and the rest multiplies the fp32 gradients outside it."""

    init_scale: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    max_inner_scale: float = 2.0**10
    max_scale: float = 2.0**24

    def init(self, device: str | torch.device) -> GradScalerState:
        return GradScalerState(torch.tensor(self.init_scale, dtype=torch.float32, device=device),
                               torch.zeros((), dtype=torch.int32, device=device))

    def split_scale(self, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(inner, outer) with inner * outer == scale and inner fp16-safe."""
        inner = torch.clamp(scale, max=self.max_inner_scale)
        return inner, scale / inner

    @staticmethod
    def all_finite(grads: list[torch.Tensor]) -> torch.Tensor:
        """A 0-d bool device tensor: every element of every gradient is
        finite."""
        if not grads:
            return torch.tensor(True)
        flags = [torch.isfinite(g).all() for g in grads]
        return torch.stack(flags).all()

    def update_state(self, state: GradScalerState, finite: torch.Tensor) -> GradScalerState:
        """One policy step, on the device: grow after ``growth_interval``
        finite boundaries (capped at ``max_scale``), back off on overflow."""
        tracker = torch.where(finite, state.growth_tracker + 1, torch.zeros_like(state.growth_tracker))
        grow = tracker >= self.growth_interval
        grown = torch.where(grow, torch.clamp(state.scale * self.growth_factor, max=self.max_scale),
                            state.scale)
        scale = torch.where(finite, grown, state.scale * self.backoff_factor)
        return GradScalerState(scale, torch.where(grow, torch.zeros_like(tracker), tracker))

    def unscale_and_update(self, grads: list[torch.Tensor], state: GradScalerState
                           ) -> tuple[GradScalerState, torch.Tensor]:
        """Divide ``grads`` by the scale in place, check them, and step the
        policy: (the new state, the 0-d finite flag)."""
        torch._foreach_mul_(grads, 1.0 / state.scale)
        finite = self.all_finite(grads)
        return self.update_state(state, finite), finite
