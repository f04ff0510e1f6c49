"""Continuous-batching serving for the PyTorch port (paged KV, GPT-2)."""

from .engine import PagedKVConfig, ServingEngine
from .metrics import ServingMetrics
from .request import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_LENGTH,
    REJECT_EMPTY_PROMPT,
    REJECT_PROMPT_TOO_LONG,
    REJECT_QUEUE_FULL,
    Request,
    RequestOutput,
    SamplingParams,
    SubmitResult,
)
from .scheduler import FIFOScheduler

__all__ = [
    "FINISH_ABORTED",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FIFOScheduler",
    "PagedKVConfig",
    "REJECT_EMPTY_PROMPT",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "ServingEngine",
    "ServingMetrics",
    "SubmitResult",
]
