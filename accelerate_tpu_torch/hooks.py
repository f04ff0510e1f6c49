"""Model hooks: pre- and post-forward interception on prepared models, the
port of `accelerate_tpu.hooks`.

As in the reference, a hook wraps the functional call rather than patching
``module.forward``: `accelerator.PreparedModel.__call__` consults the hook
attached to it, and ``pre_forward`` may hand back another parameter dict
(state-dict names to tensors), which the call runs the module on through
`torch.func.functional_call`. That is how offloaded weights stream in:
`AlignDevicesHook` returns the weights moved to the execution device, and
they go when the call returns (or stay for later calls, with
``offload=False``).
"""

from __future__ import annotations

from typing import Any

import torch

from .utils.environment import resolve_device


class ModelHook:
    """The base hook (reference `hooks.py:22`)."""

    def init_hook(self, model: Any) -> Any:
        return model

    def pre_forward(self, model: Any, params: dict[str, torch.Tensor], args: tuple,
                    kwargs: dict) -> tuple[dict[str, torch.Tensor], tuple, dict]:
        """Return the (possibly substituted) ``(params, args, kwargs)``."""
        return params, args, kwargs

    def post_forward(self, model: Any, output: Any) -> Any:
        return output

    def detach_hook(self, model: Any) -> Any:
        return model


class SequentialHook(ModelHook):
    """Several hooks in order (reference `hooks.py:40`)."""

    def __init__(self, *hooks: ModelHook):
        self.hooks = list(hooks)

    def init_hook(self, model):
        for h in self.hooks:
            model = h.init_hook(model)
        return model

    def pre_forward(self, model, params, args, kwargs):
        for h in self.hooks:
            params, args, kwargs = h.pre_forward(model, params, args, kwargs)
        return params, args, kwargs

    def post_forward(self, model, output):
        for h in self.hooks:
            output = h.post_forward(model, output)
        return output

    def detach_hook(self, model):
        for h in self.hooks:
            model = h.detach_hook(model)
        return model


def add_hook_to_module(model: Any, hook: ModelHook, append: bool = False) -> Any:
    """Attach ``hook`` to a `PreparedModel` (after the one it has, in a
    `SequentialHook`, with ``append``)."""
    existing = getattr(model, "_hook", None)
    if append and existing is not None:
        hook = SequentialHook(existing, hook)
    model._hook = hook
    return hook.init_hook(model)


def remove_hook_from_module(model: Any, recurse: bool = False) -> Any:
    hook = getattr(model, "_hook", None)
    if hook is not None:
        model = hook.detach_hook(model)
        model._hook = None
    return model


class AlignDevicesHook(ModelHook):
    """Move the weights to the execution device for the forward (reference
    `hooks.py:85`). ``weights_map`` is any mapping of state-dict names
    (``.`` or the reference's ``/`` joined) to host tensors, such as an
    `utils.offload.OffloadedWeightsLoader`; without one the call's own
    parameters move. ``execution_device=None`` means CUDA (``"cpu"`` for
    the plain path). With ``offload`` (the default) each call makes its
    device copies and they go when it returns; with ``offload=False`` the
    first call's copies stay on the device and every later call runs on
    them, until the hook is detached."""

    def __init__(self, execution_device: Any = None, offload: bool = True,
                 weights_map: Any = None):
        self.execution_device = resolve_device(execution_device)
        self.offload = offload
        self.weights_map = weights_map
        self._device_params: dict[str, torch.Tensor] | None = None

    def pre_forward(self, model, params, args, kwargs):
        if self._device_params is not None:
            return self._device_params, args, kwargs
        if self.weights_map is not None:
            params = {k.replace("/", "."): self.weights_map[k] for k in self.weights_map}
        non_blocking = self.execution_device.type == "cuda"
        params = {k: v.to(self.execution_device, non_blocking=non_blocking and v.is_pinned())
                  for k, v in params.items()}
        if not self.offload:
            self._device_params = params
        return params, args, kwargs

    def detach_hook(self, model):
        self._device_params = None
        return model
