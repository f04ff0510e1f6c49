"""Reliability layer: the port of `accelerate_tpu.reliability`. Deterministic
fault injection (`FaultInjector`), retry with backoff (`RetryPolicy`) and
SIGTERM preemption handling, with its serving variant
`ServingPreemptionHandler`, which drains an engine inside the grace window and
snapshots whatever could not finish for `serving.engine.ServingEngine.resume`.
The serving engine's health flag and quarantine consume the injector's
``serving.decode`` and ``serving.dispatch`` fault points."""

from .faults import (
    ALL_SLOTS,
    SCOPE_CHECKPOINT_RESTORE,
    SCOPE_CHECKPOINT_SAVE,
    SCOPE_PREEMPTION,
    SCOPE_SERVING_DECODE,
    SCOPE_SERVING_DISPATCH,
    DeviceLostError,
    FaultEvent,
    FaultInjector,
    FaultSpec,
    TransientIOError,
    active_injector,
    fault_point,
    inject,
)
from .preemption import (
    SIGTERM_EXIT_CODE,
    PreemptionHandler,
    ServingPreemptionHandler,
    install_preemption_handler,
    install_serving_preemption_handler,
)
from .retry import RetryError, RetryPolicy

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "FaultEvent",
    "TransientIOError",
    "DeviceLostError",
    "active_injector",
    "inject",
    "fault_point",
    "ALL_SLOTS",
    "SCOPE_CHECKPOINT_SAVE",
    "SCOPE_CHECKPOINT_RESTORE",
    "SCOPE_SERVING_DECODE",
    "SCOPE_SERVING_DISPATCH",
    "SCOPE_PREEMPTION",
    "RetryPolicy",
    "RetryError",
    "PreemptionHandler",
    "ServingPreemptionHandler",
    "install_preemption_handler",
    "install_serving_preemption_handler",
    "SIGTERM_EXIT_CODE",
]
