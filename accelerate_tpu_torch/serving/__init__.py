"""Continuous-batching serving for the PyTorch port (GPT-2; slot or paged KV,
prefix KV reuse, speculative decoding, the in-step health flag and
quarantine, queue deadlines and drain, the durable request journal, snapshot
and resume), with its observability and self-healing layer: the request
tracer and its Perfetto export, SLO goodput, step timings and capacity
headroom, the engine supervisor, telemetry and the anomaly monitor."""

from .anomaly import NULL_ANOMALY, AnomalyConfig, AnomalyMonitor, Detector, NullAnomalyMonitor
from .engine import (
    SNAPSHOT_FORMAT,
    PagedKVConfig,
    RecoveryReport,
    ServingEngine,
    StepTimings,
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
    REJECT_OVERLOAD,
    REJECT_PROMPT_TOO_LONG,
    REJECT_QUEUE_FULL,
    REJECT_UNHEALTHY,
    Request,
    RequestOutput,
    SamplingParams,
    SLOSpec,
    SubmitResult,
)
from .scheduler import FIFOScheduler
from .speculation import ModelDrafter, NGramDrafter, SpeculationConfig
from .supervisor import EngineSupervisor, EngineUnhealthyError, RestartBudget, SupervisorConfig
from .telemetry import NULL_TELEMETRY, NullTelemetry, TelemetryConfig, TelemetryExporter
from .trace import NULL_TRACER, NullTracer, TraceEvent, Tracer

__all__ = [
    "AnomalyConfig",
    "AnomalyMonitor",
    "Counter",
    "Detector",
    "EngineSupervisor",
    "EngineUnhealthyError",
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
    "NULL_ANOMALY",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullAnomalyMonitor",
    "NullTelemetry",
    "NullTracer",
    "PagedKVConfig",
    "PrefixCache",
    "PrefixCacheConfig",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
    "REJECT_EMPTY_PROMPT",
    "REJECT_OVERLOAD",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "REJECT_UNHEALTHY",
    "RecoveryReport",
    "Request",
    "RequestJournal",
    "RequestOutput",
    "RestartBudget",
    "SLOSpec",
    "SNAPSHOT_FORMAT",
    "SamplingParams",
    "ServingEngine",
    "ServingMetrics",
    "SpeculationConfig",
    "StepTimings",
    "SubmitResult",
    "SupervisorConfig",
    "TelemetryConfig",
    "TelemetryExporter",
    "TraceEvent",
    "Tracer",
    "WeightQuantConfig",
]
