"""Process, accelerator and gradient-accumulation state: the port of
`accelerate_tpu.state` for one process on one device.

The reference shares each state through a class-level dict (every instance
sees the same state). Here an `Accelerator` creates one of each and passes
it to what it prepares (its optimizers, data loaders and schedulers), so two
accelerators in one process (as in the tests) never see each other's step
counts or boundaries. The multi-process surface (launchers,
``torch.distributed``, barriers that wait) waits for a later slice (ROADMAP
Queue 1, item 21): at one process every process predicate is true and
`PartialState.wait_for_everyone` returns at once.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Callable, Iterator

import torch

from .utils.environment import resolve_device


class PartialState:
    """One process driving one device: the reference's topology facts,
    reduced to what a single process has."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.process_index = 0
        self.local_process_index = 0
        self.num_processes = 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """The reference's barrier; one process has no one to wait for."""

    @contextmanager
    def main_process_first(self) -> Iterator[None]:
        """The main process runs the body before the others (reference
        `state.py:236`): at one process, just the body."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self) -> Iterator[None]:
        with self.main_process_first():
            yield

    @contextmanager
    def split_between_processes(self, inputs: Any, apply_padding: bool = False) -> Iterator[Any]:
        """This process's share of ``inputs`` (reference `state.py:251`):
        at one process, all of it; ``apply_padding`` has nothing to pad."""
        yield inputs

    def _on(self, predicate: Callable[[], bool], function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if predicate():
                return function(*args, **kwargs)
            return None

        return wrapper

    def on_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_last_process, function)

    def on_process(self, function: Callable | None = None, process_index: int = 0) -> Callable:
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self._on(lambda: self.process_index == process_index, function)

    def on_local_process(self, function: Callable | None = None,
                         local_process_index: int = 0) -> Callable:
        if function is None:
            return functools.partial(self.on_local_process, local_process_index=local_process_index)
        return self._on(lambda: self.local_process_index == local_process_index, function)

    def print(self, *args: Any, **kwargs: Any) -> None:
        """Print once per job: on the local main process."""
        if self.is_local_main_process:
            print(*args, **kwargs)

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
    """Gradient-accumulation bookkeeping, as the reference keeps it
    (`accelerate_tpu/state.py:483-530`): ``num_steps`` microbatches per
    update, ``sync_gradients`` true on an update boundary, and the stack of
    data loaders being iterated. The innermost active loader's
    ``end_of_dataloader`` forces a boundary on its last batch (when
    ``sync_with_dataloader``), and its ``remainder`` tells
    ``gather_for_metrics`` how many samples of the last batch are real."""

    def __init__(self, gradient_accumulation_steps: int = 1, adjust_scheduler: bool = True,
                 sync_with_dataloader: bool = True):
        if gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got {gradient_accumulation_steps}")
        self.num_steps = gradient_accumulation_steps
        self.adjust_scheduler = adjust_scheduler
        self.sync_with_dataloader = sync_with_dataloader
        self.sync_gradients = True
        self.active_dataloader: Any = None
        self.dataloader_references: list[Any] = [None]

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        """Real samples in the last batch of a ragged epoch, -1 when none is
        ragged or no loader is active."""
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = sync

    def _add_dataloader(self, dataloader: Any) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader: Any) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    def __repr__(self) -> str:
        return f"GradientState(num_steps={self.num_steps}, sync_gradients={self.sync_gradients})"
