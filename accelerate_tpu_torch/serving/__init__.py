"""Continuous-batching serving for the PyTorch port (GPT-2; slot or paged KV,
prefix KV reuse, speculative decoding)."""

from .engine import PagedKVConfig, ServingEngine, WeightQuantConfig
from .metrics import Counter, Histogram, ServingMetrics
from .prefix_cache import PrefixCache, PrefixCacheConfig
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
from .speculation import ModelDrafter, NGramDrafter, SpeculationConfig

__all__ = [
    "Counter",
    "FINISH_ABORTED",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FIFOScheduler",
    "Histogram",
    "ModelDrafter",
    "NGramDrafter",
    "PagedKVConfig",
    "PrefixCache",
    "PrefixCacheConfig",
    "REJECT_EMPTY_PROMPT",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "ServingEngine",
    "ServingMetrics",
    "SpeculationConfig",
    "SubmitResult",
    "WeightQuantConfig",
]
