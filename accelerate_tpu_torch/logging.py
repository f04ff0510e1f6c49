"""Multi-process logging: the port of `accelerate_tpu.logging`.

`get_logger` returns a `MultiProcessAdapter`, which logs on the main
process by default, on every process with ``main_process_only=False``, and
one process after another in rank order, each record stamped ``[rank i]``,
with ``in_order=True``. The level may come from
``ACCELERATE_TPU_LOG_LEVEL``. At one process every record is the main
process's.
"""

from __future__ import annotations

import logging
import os
from typing import Any

from .state import PartialState


def _state() -> PartialState:
    return PartialState(device="cpu")  # the process topology; the device is not read


class MultiProcessAdapter(logging.LoggerAdapter):
    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        return not main_process_only or _state().is_main_process

    def log(self, level: int, msg: str, *args: Any, **kwargs: Any) -> None:
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if not self.isEnabledFor(level):
            return
        kwargs.setdefault("stacklevel", 2)
        if not in_order:
            if self._should_log(main_process_only):
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)
            return
        state = _state()
        for i in range(state.num_processes):
            if i == state.process_index:
                msg_i, kwargs_i = self.process(msg, kwargs)
                self.logger.log(level, f"[rank {i}] {msg_i}", *args, **kwargs_i)
            state.wait_for_everyone()

    def process(self, msg: str, kwargs: dict) -> tuple[str, dict]:
        return msg, kwargs


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A rank-aware logger named ``name``; ``log_level`` (or
    ``ACCELERATE_TPU_LOG_LEVEL``) sets its level and the root's."""
    logger = logging.getLogger(name)
    log_level = log_level or os.environ.get("ACCELERATE_TPU_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
