"""Main-process-only progress bars: the port of `accelerate_tpu.utils.tqdm`."""

from __future__ import annotations

from .imports import is_tqdm_available


def tqdm(*args, main_process_only: bool = True, **kwargs):
    """tqdm that renders only on the main process; ImportError when tqdm is
    not installed. At one process (the port's runtime until ROADMAP Queue
    1, item 21.3) this process is the main one, so ``main_process_only``
    disables nothing yet."""
    if not is_tqdm_available():
        raise ImportError("tqdm is not installed; `pip install tqdm`.")
    from tqdm import auto

    del main_process_only
    return auto.tqdm(*args, **kwargs)
