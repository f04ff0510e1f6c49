"""Mixed-precision policy: the port of `accelerate_tpu.utils.precision`
``PrecisionPolicy``.

As in the reference, precision is a functional cast policy around the train
step, not an autocast context: master parameters stay fp32, and under
``"bf16"`` the forward and backward run on bf16 copies of every floating
parameter (LayerNorm scale and bias and the embeddings included). The copies
are made with ``Tensor.to``, so autograd carries their gradients back to the
fp32 masters in fp32.

``"fp16"`` (with its dynamic loss scaler) and ``"fp8"`` are not ported yet
(ROADMAP Queue 1, item 3): asking for them raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
        if mode in ("fp16", "fp8"):
            raise NotImplementedError(
                f"mixed_precision={mode!r} is not ported yet: fp16 needs the "
                "DynamicGradScaler and fp8 the Hopper fp8 matmuls (ROADMAP Queue 1, item 3)"
            )
        raise ValueError(f"Unknown mixed_precision mode {mode!r}")

    def cast_to_compute(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Every floating tensor of ``params`` in the compute dtype (a
        differentiable copy); others pass through. Identity under ``"no"``."""
        if self.mode == "no":
            return params
        return {name: t.to(self.compute_dtype) if t.is_floating_point() else t
                for name, t in params.items()}
