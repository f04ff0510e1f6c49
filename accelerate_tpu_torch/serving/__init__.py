"""Continuous-batching serving for the PyTorch port (GPT-2; slot or paged KV,
prefix KV reuse, speculative decoding, the in-step health flag and
quarantine, queue deadlines and drain, the durable request journal, snapshot
and resume)."""

from .engine import (
    SNAPSHOT_FORMAT,
    PagedKVConfig,
    RecoveryReport,
    ServingEngine,
    WeightQuantConfig,
)
from .journal import JournalError, JournalScan, RequestJournal
from .metrics import Counter, Histogram, ServingMetrics
from .prefix_cache import PrefixCache, PrefixCacheConfig
from .request import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    REJECT_DEADLINE,
    REJECT_DRAINING,
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
    "FINISH_ERROR",
    "FINISH_LENGTH",
    "FIFOScheduler",
    "Histogram",
    "JournalError",
    "JournalScan",
    "ModelDrafter",
    "NGramDrafter",
    "PagedKVConfig",
    "PrefixCache",
    "PrefixCacheConfig",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
    "REJECT_EMPTY_PROMPT",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "RecoveryReport",
    "Request",
    "RequestJournal",
    "RequestOutput",
    "SNAPSHOT_FORMAT",
    "SamplingParams",
    "ServingEngine",
    "ServingMetrics",
    "SpeculationConfig",
    "SubmitResult",
    "WeightQuantConfig",
]
