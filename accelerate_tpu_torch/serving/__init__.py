"""Continuous-batching serving for the PyTorch port (GPT-2; slot or paged KV,
prefix KV reuse, speculative decoding, the in-step health flag and
quarantine, queue deadlines and drain, the durable request journal, snapshot
and resume), with its observability and self-healing layer (the request
tracer and its Perfetto export, SLO goodput, step timings and capacity
headroom, the engine supervisor, telemetry and the anomaly monitor), and the
fleet above one engine: the `FairScheduler`, the front door
(`ServingFrontend`: token streams off the journal, `SubmitOptions`,
predictive admission), the prefix-aware `ServingCluster` with
journal-backed migration, and the `FleetAutoscaler`; and the host-RAM KV
tier behind the paged pool (`KVTier`, ``kv_tier=``: trie blocks spilled and
paged back in, whole streams hibernated and woken, the `ThrashGuard`)."""

from .anomaly import NULL_ANOMALY, AnomalyConfig, AnomalyMonitor, Detector, NullAnomalyMonitor
from .autoscaler import DETECTOR_THRASH, AutoscalerConfig, FleetAutoscaler
from .cluster import (
    POLICY_PREFIX,
    POLICY_ROUND_ROBIN,
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    STATE_DEAD,
    STATE_DRAINING,
    STATE_OK,
    STATE_RETIRED,
    ClusterConfig,
    ReplicaHandle,
    ServingCluster,
)
from .engine import (
    SNAPSHOT_FORMAT,
    PagedKVConfig,
    RecoveryReport,
    ServingEngine,
    StepTimings,
    WeightQuantConfig,
)
from .frontend import (
    EV_STREAM_DELTA,
    EV_STREAM_ERROR,
    EV_STREAM_FINISH,
    EV_STREAM_FIRST,
    ServingFrontend,
    StreamEvent,
    StreamStall,
    TokenStream,
    predict_ttft,
)
from .journal import JournalError, JournalScan, RequestJournal
from .kv_tier import KVTier, KVTierConfig, ThrashGuard, choose_wake
from .metrics import Counter, Histogram, ServingMetrics, aggregate_snapshots
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
    REJECT_PREDICTED_TTFT,
    REJECT_PROMPT_TOO_LONG,
    REJECT_QUEUE_FULL,
    REJECT_UNHEALTHY,
    Request,
    RequestOutput,
    SamplingParams,
    SLOSpec,
    SubmitOptions,
    SubmitResult,
)
from .scheduler import FairScheduler, FIFOScheduler
from .speculation import ModelDrafter, NGramDrafter, SpeculationConfig
from .supervisor import EngineSupervisor, EngineUnhealthyError, RestartBudget, SupervisorConfig
from .telemetry import NULL_TELEMETRY, NullTelemetry, TelemetryConfig, TelemetryExporter
from .trace import NULL_TRACER, NullTracer, TraceEvent, Tracer

__all__ = [
    "AnomalyConfig",
    "AnomalyMonitor",
    "AutoscalerConfig",
    "ClusterConfig",
    "Counter",
    "DETECTOR_THRASH",
    "Detector",
    "EV_STREAM_DELTA",
    "EV_STREAM_ERROR",
    "EV_STREAM_FINISH",
    "EV_STREAM_FIRST",
    "EngineSupervisor",
    "EngineUnhealthyError",
    "FIFOScheduler",
    "FINISH_ABORTED",
    "FINISH_EOS",
    "FINISH_ERROR",
    "FINISH_LENGTH",
    "FairScheduler",
    "FleetAutoscaler",
    "Histogram",
    "JournalError",
    "KVTier",
    "KVTierConfig",
    "JournalScan",
    "ModelDrafter",
    "NGramDrafter",
    "NULL_ANOMALY",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullAnomalyMonitor",
    "NullTelemetry",
    "NullTracer",
    "POLICY_PREFIX",
    "POLICY_ROUND_ROBIN",
    "PagedKVConfig",
    "PrefixCache",
    "PrefixCacheConfig",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
    "REJECT_EMPTY_PROMPT",
    "REJECT_OVERLOAD",
    "REJECT_PREDICTED_TTFT",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "REJECT_UNHEALTHY",
    "ROLE_DECODE",
    "ROLE_MIXED",
    "ROLE_PREFILL",
    "RecoveryReport",
    "ReplicaHandle",
    "Request",
    "RequestJournal",
    "RequestOutput",
    "RestartBudget",
    "SLOSpec",
    "SNAPSHOT_FORMAT",
    "STATE_DEAD",
    "STATE_DRAINING",
    "STATE_OK",
    "STATE_RETIRED",
    "SamplingParams",
    "ServingCluster",
    "ServingEngine",
    "ServingFrontend",
    "ServingMetrics",
    "SpeculationConfig",
    "StepTimings",
    "StreamEvent",
    "StreamStall",
    "SubmitOptions",
    "SubmitResult",
    "SupervisorConfig",
    "TelemetryConfig",
    "TelemetryExporter",
    "ThrashGuard",
    "TokenStream",
    "TraceEvent",
    "Tracer",
    "WeightQuantConfig",
    "aggregate_snapshots",
    "choose_wake",
    "predict_ttft",
]
