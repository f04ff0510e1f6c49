"""Learning-rate schedules: the port of `accelerate_tpu.scheduler`.

`AcceleratedScheduler` steps the scheduler it wraps only on an accumulation
boundary, and not after an fp16 step the scaler skipped (reference
`scheduler.py:46-81`). `OptaxSchedule` gives a plain ``step -> lr``
function a scheduler's interface (reference `scheduler.py:25`).

The reference's examples build their schedules with optax;
`warmup_cosine_decay_schedule` is a plain-Python copy of optax's. The port
drives such a function through `torch.optim.lr_scheduler.LambdaLR` over an
optimizer whose base learning rate is 1.0 (`schedule_lambda`), so the lr
of update ``n`` is ``schedule(n)``, as optax reads its schedule at the update
count before it increments: LambdaLR sets ``schedule(0)`` when it is built,
and each ``scheduler.step()`` after an applied update moves it on.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from .state import GradientState


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: ``init_value`` to ``end_value`` over
    ``transition_steps`` counts, then ``end_value``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps!")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value``
    at ``decay_steps`` (counted from 0, warm-up included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def schedule_lambda(optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float]) -> torch.optim.lr_scheduler.LambdaLR:
    """A `LambdaLR` whose lr at update ``n`` is ``schedule(n)``: every
    param group's base lr is set to 1.0 first, so the lambda's factor is the
    lr itself (AdamW's decoupled weight decay scales by that lr, as optax's
    ``adamw(schedule)`` does)."""
    for group in optimizer.param_groups:
        group["lr"] = 1.0
        group["initial_lr"] = 1.0
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


class OptaxSchedule:
    """A ``count -> lr`` function with a scheduler's interface: ``step()``,
    ``get_last_lr()``, ``state_dict()``."""

    def __init__(self, schedule_fn: Callable[[int], float]):
        self.schedule_fn = schedule_fn
        self.count = 0

    def step(self) -> None:
        self.count += 1

    def get_last_lr(self) -> list[float]:
        return [float(self.schedule_fn(self.count))]

    def state_dict(self) -> dict[str, Any]:
        return {"count": self.count}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.count = int(state["count"])


class AcceleratedScheduler:
    """Steps ``scheduler`` once per applied update: a no-op off an
    accumulation boundary of ``gradient_state`` and after a step one of
    ``optimizers`` skipped (fp16 overflow). With ``step_with_optimizer=False``
    every call steps it, as the reference's does (`scheduler.py:46-81`);
    ``split_batches`` is kept for the reference's signature and changes no
    count there either. `Accelerator.prepare` binds it to the accelerator's
    state and optimizers."""

    def __init__(self, scheduler: Any, optimizers: list | None = None,
                 step_with_optimizer: bool = True, split_batches: bool = False,
                 gradient_state: GradientState | None = None):
        self.scheduler = scheduler
        self.optimizers = optimizers if optimizers is not None else []
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()

    def step(self, *args: Any, **kwargs: Any) -> None:
        if not self.step_with_optimizer:
            self.scheduler.step(*args, **kwargs)
            return
        if not self.gradient_state.sync_gradients:
            return
        if any(opt.step_was_skipped for opt in self.optimizers):
            return
        self.scheduler.step(*args, **kwargs)

    def get_last_lr(self) -> list[float]:
        return self.scheduler.get_last_lr()

    def state_dict(self) -> dict[str, Any]:
        return self.scheduler.state_dict()

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.scheduler.load_state_dict(state)

    def __getattr__(self, name: str) -> Any:
        if name == "scheduler":
            raise AttributeError(name)
        return getattr(self.scheduler, name)
