"""Process, accelerator and gradient-accumulation state: the port of
`accelerate_tpu.state` for one process on one device.

The reference shares each state through a class-level dict (every instance
sees the same state). Here an `Accelerator` creates one of each and passes
it to what it prepares, so two accelerators in one process (as in the tests)
never see each other's step counts. The multi-process surface (launchers,
``torch.distributed``) waits for a later slice (ROADMAP Queue 1, item 21).
"""

from __future__ import annotations

import torch

from .utils.environment import resolve_device


class PartialState:
    """One process driving one device: the reference's topology facts,
    reduced to what a single process has."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.process_index = 0
        self.num_processes = 1

    def __repr__(self) -> str:
        return f"PartialState(device={self.device}, num_processes={self.num_processes})"


class AcceleratorState:
    """The process state plus the training plan: the mixed-precision mode."""

    def __init__(self, mixed_precision: str, device: str | torch.device | None = None):
        self.partial = PartialState(device)
        self.mixed_precision = mixed_precision

    @property
    def device(self) -> torch.device:
        return self.partial.device

    def __repr__(self) -> str:
        return f"AcceleratorState(mixed_precision={self.mixed_precision!r}, device={self.device})"


class GradientState:
    """Gradient-accumulation bookkeeping, as the reference keeps it:
    ``num_steps`` microbatches per update, ``sync_gradients`` true on an
    update boundary, ``end_of_dataloader`` forcing a boundary (always false
    until the data loader is ported)."""

    def __init__(self, gradient_accumulation_steps: int = 1):
        if gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got {gradient_accumulation_steps}")
        self.num_steps = gradient_accumulation_steps
        self.sync_gradients = True
        self.sync_with_dataloader = True
        self.end_of_dataloader = False

    def __repr__(self) -> str:
        return f"GradientState(num_steps={self.num_steps}, sync_gradients={self.sync_gradients})"
