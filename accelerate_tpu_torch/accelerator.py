"""The port of `accelerate_tpu.accelerator` ``Accelerator``, for the training
path ``bench.py`` drives: ``prepare`` a model and its optimizer, then
``make_train_step(loss_fn)`` and call ``step(batch)``.

One process on one device. The train step keeps the reference's semantics
(`accelerate_tpu/accelerator.py` ``make_train_step``):

  - every call is one microbatch; ``_do_sync`` decides whether it closes an
    accumulation boundary;
  - the loss is computed on compute-dtype copies of the fp32 master
    parameters (`utils.precision.PrecisionPolicy.cast_to_compute`), cast to
    fp32, and its gradients are summed into the masters' ``.grad`` over the
    microbatches;
  - at a boundary the sum is scaled by ``1/k``, optionally clipped by the
    global norm with factor ``min(1, max_norm / (norm + 1e-6))``, and the
    optimizer steps and clears the gradients;
  - the returned loss is the microbatch's fp32 loss.

PyTorch runs eagerly, so there is no compiled step and nothing is donated;
the optimizer updates the masters in place. Comm hooks, meshes, fp16 loss
scaling and fp8 wait for later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn
from torch.func import functional_call

from .optimizer import AcceleratedOptimizer
from .state import AcceleratorState, GradientState
from .utils.precision import PrecisionPolicy


class Accelerator:
    """``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). ``mixed_precision`` is ``"no"`` or
    ``"bf16"``; ``"fp16"`` and ``"fp8"`` raise until they are ported."""

    def __init__(self, mixed_precision: str | None = None, gradient_accumulation_steps: int = 1,
                 device: str | torch.device | None = None):
        self.policy = PrecisionPolicy.from_mode(mixed_precision)
        self.state = AcceleratorState(self.policy.mode, device)
        self.gradient_state = GradientState(gradient_accumulation_steps)
        self.step = 0
        self._models: list[nn.Module] = []
        self._optimizers: list[AcceleratedOptimizer] = []

    @property
    def device(self) -> torch.device:
        return self.state.device

    def prepare(self, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> tuple[nn.Module, AcceleratedOptimizer]:
        """Register ``model`` (its parameters are the fp32 masters, already on
        this accelerator's device) and ``optimizer``, built over those
        parameters as PyTorch's idiom has it. Returns the model and the
        `AcceleratedOptimizer`."""
        if not isinstance(model, nn.Module):
            raise TypeError(f"prepare takes an nn.Module, got {type(model).__name__}")
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"prepare takes a torch.optim.Optimizer, got {type(optimizer).__name__}")
        params = list(model.parameters())
        for p in params:
            if p.device != self.device:
                raise ValueError(
                    f"model parameters live on {p.device}, the accelerator on {self.device}: "
                    "build the model on the accelerator's device"
                )
        owned = {id(p) for p in params}
        for group in optimizer.param_groups:
            if any(id(p) not in owned for p in group["params"]):
                raise ValueError("the optimizer holds tensors that are not parameters of the model")
        wrapped = AcceleratedOptimizer(optimizer, self.gradient_state)
        self._models.append(model)
        self._optimizers.append(wrapped)
        return model, wrapped

    def _do_sync(self) -> None:
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs.sync_gradients = True
        else:
            self.step += 1
            gs.sync_gradients = self.step % gs.num_steps == 0

    def make_train_step(self, loss_fn: Callable[[Callable, Any], Any], model: nn.Module | None = None,
                        optimizer: AcceleratedOptimizer | None = None,
                        max_grad_norm: float | None = None) -> Callable[[Any], torch.Tensor]:
        """``step(batch) -> loss``. ``loss_fn(model, batch)`` calls ``model``
        like the module (``model(input_ids)``); the call runs the module on
        the compute-dtype copies of its parameters. With ``max_grad_norm``,
        ``step.grad_norm`` holds the last boundary's global norm before
        clipping (a device scalar)."""
        if model is None:
            model = self._models[0]
        if optimizer is None:
            optimizer = self._optimizers[self._models.index(model)]
        named = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        policy = self.policy
        gs = self.gradient_state

        def step(batch: Any) -> torch.Tensor:
            self._do_sync()
            compute = {**policy.cast_to_compute(named), **buffers}

            def bound(*args: Any, **kwargs: Any) -> Any:
                return functional_call(model, compute, args, kwargs)

            out = loss_fn(bound, batch)
            loss = (out[0] if isinstance(out, tuple) else out).float()
            loss.backward()
            if gs.sync_gradients:
                grads = [p.grad for p in named.values() if p.grad is not None]
                with torch.no_grad():
                    if gs.num_steps != 1:
                        torch._foreach_mul_(grads, 1.0 / gs.num_steps)
                    if max_grad_norm is not None:
                        step.grad_norm = _clip_by_global_norm_(grads, max_grad_norm)
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
            return loss.detach()

        step.grad_norm = None
        return step


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor, in
    fp32 (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def _clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-6))`` (the
    reference's ``_clip_tree``); returns the norm before clipping. No host
    sync: the factor stays on the device."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, factor)
    return norm
