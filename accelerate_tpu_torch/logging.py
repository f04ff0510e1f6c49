"""Multi-process logging: the port of `accelerate_tpu.logging`.

`get_logger` returns a `MultiProcessAdapter`, which logs on the main
process by default, on every process with ``main_process_only=False``, and
one process after another in rank order, each record stamped ``[rank i]``,
with ``in_order=True``. The level may come from
``ACCELERATE_TPU_LOG_LEVEL``. The rank is the process-wide topology
(`state.topology`): the process group's, or the launcher's environment
before the group exists; at one process every record is the main
process's.
"""

from __future__ import annotations

import logging
import os
from typing import Any

from .state import barrier, topology


class MultiProcessAdapter(logging.LoggerAdapter):
    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        return not main_process_only or topology().process_index == 0

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
        import torch.distributed as dist

        top = topology()
        grouped = dist.is_available() and dist.is_initialized() and top.num_processes > 1
        for i in range(top.num_processes):
            if i == top.process_index:
                msg_i, kwargs_i = self.process(msg, kwargs)
                self.logger.log(level, f"[rank {i}] {msg_i}", *args, **kwargs_i)
            if grouped:
                barrier()

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
