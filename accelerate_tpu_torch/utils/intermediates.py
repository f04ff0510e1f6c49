"""Values a forward hands back beside its output: the port's counterpart of
flax's ``intermediates`` collection (``module.sow``).

A layer calls ``sow(name, value)``; the caller that runs the forward inside
``collecting_intermediates()`` receives every value sown there, by name, in
the order sown. `accelerator.BoundModel` and `accelerator.PreparedModel`
collect each call's values into ``model.extra_state["intermediates"]``, as
the reference's mutable collection holds them; outside such a call a sow
is dropped. The values stay in the forward's autograd graph, so a loss
built from them sends gradient back (the MoE router's aux loss). A remat
recompute (`utils.remat`) sows nothing: the first forward already did.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator

from .remat import current_frame

_SOWN: contextvars.ContextVar[dict[str, list] | None] = contextvars.ContextVar(
    "accelerate_tpu_torch_intermediates", default=None)


@contextlib.contextmanager
def collecting_intermediates() -> Iterator[dict[str, list]]:
    """A fresh dict that receives, by name, every value sown inside the
    block."""
    sown: dict[str, list] = {}
    token = _SOWN.set(sown)
    try:
        yield sown
    finally:
        _SOWN.reset(token)


def sow(name: str, value: Any) -> None:
    """Append ``value`` under ``name`` to the collecting call's values, if a
    call collects and this is not a remat recompute."""
    frame = current_frame()
    if frame is not None and frame.recompute:
        return
    sown = _SOWN.get()
    if sown is not None:
        sown.setdefault(name, []).append(value)
