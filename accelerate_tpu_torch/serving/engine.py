"""Continuous-batching serving engine: the port of `accelerate_tpu.serving.engine`
``ServingEngine``, in its slot-pool and paged modes.

Independent requests share one decode step over a fixed set of
``max_concurrency`` slots. Where their KV lives is the mode:

  - slot pool (``paged_kv=False``, the default, as in the reference): one
    contiguous ``[max_concurrency, n_positions, ...]`` row per slot and layer
    (`models.kv_cache.SlotKVCache`, `make_cache`) with a per-slot write
    index. Admission prefills up to ``admit_batch`` queued requests of one
    prompt bucket in one causal forward, samples their first tokens, and
    writes their K/V into their slots' rows (`kv_cache.scatter_cache_slots`,
    which sets each row's index to its true prompt length); every decode
    step writes at each live row's index (``write_mask``: a finished row's
    buffers and index stay bit-identical) and attends the whole row under a
    mask through the plain attention, as the reference's XLA step does: no
    kernel runs there;
  - paged (``paged_kv=True`` or a `PagedKVConfig`): KV lives only in a
    shared per-layer block pool (`models.kv_cache.PagedKVCache`); each
    slot's block table says where its tokens sit. Admission reserves every
    block a request can ever need (prompt + budget, capped at the context)
    up front, all or nothing, so a decode write never finds the pool empty;
    a group that does not fit goes back to the queue front (backpressure,
    never a crash), and the prefill's K/V is scattered into the reserved
    blocks (`kv_cache.scatter_rows_to_blocks`). With
    ``paged_attention="fused"`` every layer's decode attention reads the pool
    in place through the CUDA kernel
    `ops.flash_attention.paged_decode_attention`; ``"gather"`` (the default)
    runs the plain path over the gathered view, the parity oracle;

In both, `step` dispatches one decode step for every slot:
``tokens_per_sync`` iterations of forward, sample, freeze finished rows and
advance. Per-slot decode state (last token, position, remaining budget,
finished mask, block tables, sampling settings) lives in fixed device
buffers that the step updates in place, as the reference keeps it on the
device. A finished slot is frozen inside the step (its KV write is dropped,
its token and position carried). Each step writes one ``[k, 2, b]`` plane:
the sampled tokens and the finished mask of each of its ``k`` iterations.

Dispatch is overlapped, as the reference's: up to ``pipeline_depth`` steps
and admissions are in flight at once. Each queues its output's copy into a
pinned host buffer of its own (a ring of ``pipeline_depth + 1``) behind the
work, then an event; the host reads results the device has finished
without blocking (`torch.cuda.Event.query`), and blocks on the oldest only
when more than ``pipeline_depth - 1`` are in flight. Admission uploads go
through pinned staging buffers, so nothing makes the host wait on the
stream. A finish or first token surfaces when its fetch lands, up to
``pipeline_depth - 1`` `step` calls after the device produced it; a
per-slot generation counter discards the lagged results of a slot that was
retired, cancelled or reseated meanwhile. Every piece of device work runs
on one stream, so a lagged step that still writes through a released slot's
row or blocks runs before any later admission's prefill scatter into them.
``pipeline_depth=1`` is the synchronous flow.

On CUDA the whole decode step is ONE replay of a `torch.cuda.CUDAGraph`,
captured when the engine is built, while every slot is still frozen; a
failed capture or replay raises (there is no eager decode on CUDA). The
Gumbel noise of sampled slots stays outside the graph: before each replay
the host fills a fixed uniform buffer with one ``[vocab]`` draw per
iteration from each sampled slot's own `torch.Generator`, the draws
`models.generation.generate` makes. On the CPU the same step function runs
eagerly.

Retirement (EOS, token budget, context limit) frees the slot: in paged mode
its blocks return to the pool and its table row is parked at the sentinel id
``num_blocks``, so any later write through it is dropped; in slot mode the
row stays frozen (finished) until the next admission overwrites it.

Prefix KV reuse, as the reference's (``prefix_cache=``, `PrefixCacheConfig`;
`serving.prefix_cache`): admission takes each request's longest cached
block-aligned prefix (pinned until the slot retires) and prefills only the
uncached suffix, the scheduler bucketing runs by that suffix. The matched
rows are gathered out of the block pool (`kv_cache.gather_block_rows`) and
the suffix prefills over them, each row at its own ``position_offset`` =
its cached length, through the slot cache's decode path. Slot mode then
writes the rows into the slots as a plain admission does, and owns a
separate block pool: retirement copies the prompt's new full blocks into it
(`PrefixCache.insert`). Paged mode aliases the trie's blocks in the slot's
block table (zero copy: the suffix scatter drops the aliased entries),
retirement moves the prompt's full blocks, never one at or past the
frontier, into the trie (`PrefixCache.adopt`), and under block pressure the
reservation evicts unpinned trie leaves (`PrefixCache.reclaim`); evictable
blocks count as free capacity. The cached admission runs eagerly, as every
admission does; the decode graph reads the tables from their fixed buffer,
so an alias changes only table contents.

Speculative decoding, as the reference's (``speculation=``: a draft depth k,
a `SpeculationConfig` or a drafter; `serving.speculation`; refused with
``tokens_per_sync > 1``): before each dispatch the host drafts up to k tokens
for every greedy slot from its own view of the stream (up to
``pipeline_depth - 1`` tokens stale, which costs acceptance only) into a
fixed ``[b, k]`` device buffer, through pinned memory. The dispatch is one
verify step: one k+1-position forward of the last token and the drafts
(each live row writes ``min(remaining + 1, k + 1)`` KV entries, the rest go
to the sink or are dropped), the longest draft prefix equal to the target's
own greedy choices is accepted (sampled rows take one token, their position
0 sample), cut at the first EOS and at the budget, and the write cursor is
rewound to the accepted frontier (`kv_cache.rewind_frontier`). Paged, the
verify forward takes the gathered view, as the reference's does: the paged
kernel is single-query. On CUDA the verify step is the captured graph.

Health flag and quarantine, as the reference's: every device step (the plain
decode step, the verify step and the admission) computes ``ok =
isfinite(logits).all(-1)`` per row inside the step itself (on CUDA inside the
captured graph), and a row that is not ok freezes as a finished row does
(token, position and budget carried). The health rides out with the tokens.
The host treats an unhealthy row, or a token outside ``[0, vocab)``, as
poisoned and quarantines only that slot: the first offence releases the slot
and requeues the request at the front, to re-prefill from its prompt with its
generator reseeded (the replay is token for token an unpoisoned run); the
second retires it with `FINISH_ERROR`, which donates nothing to the prefix
cache. An active `reliability.FaultInjector` can poison slots: its
``serving.decode`` point ticks once per decode dispatch, and the slots it
names get NaN logits through a fixed ``[b]`` poison buffer that the step
reads, filled through pinned memory (``non_blocking``) only while an
injector is active and cleared on the stream after the poisoned dispatch;
with no injector nothing is uploaded. The ``serving.dispatch`` point runs
before every dispatch (decode steps and admissions).

Deadlines, drain and recovery, as the reference's: a request queued past its
``deadline_s`` is rejected at the next admission with ``rejected:deadline``;
`begin_drain`/`drain`/`end_drain` reject new submits with `REJECT_DRAINING`.
``journal=`` (a path or a `journal.RequestJournal`) writes the durable
request journal: SUBMIT before an acceptance is returned, FIRST_TOKEN when
the admission's token lands, PROGRESS every ``progress_every`` tokens, FINISH
at every terminal edge. `snapshot` writes the queue and every live stream to
one JSON file, atomically; `resume` rebuilds a fresh engine from the journal,
another journal or a snapshot. A stream that was mid-decode is re-admitted
with its emitted tokens (``Request.resume_tokens``): one continuation prefill
of ``prompt + resume_tokens``, its generator fast-forwarded past the draws
those tokens took, so the rest of the stream is the uninterrupted run's.

Quantized serving, as the reference's: ``weight_quant=`` (`WeightQuantConfig`,
``"int8"`` or ``"nf4"``) quantizes the model's weights once at load into a
copy of the model (`utils.quantization.quantize_module`; the caller's model
is not changed) whose nf4 projections run through the CUDA kernel
`ops.nf4_matmul.nf4_matmul`, in either mode; the config's
``kv_cache_dtype=torch.int8`` stores the slot rows or the paged pool as int8
with fp32 scale planes, which the paged fused path hands to the
paged-decode kernel. `ServingEngine.quant_stats` reports both.

Observability, as the reference's: ``tracer=`` (a `trace.Tracer`) records
every request lifecycle edge and every dispatch/fetch pair, stamped on the
host clock only (an emission never waits on the stream), exportable to
Perfetto; with ``annotate=True`` each dispatch (a graph replay, an eager
admission) runs inside ``torch.profiler.record_function(key)``. Requests
carrying a `request.SLOSpec` feed `ServingMetrics.goodput` at retirement.
Every `step` records a `StepTimings` phase breakdown (`last_step_timings`);
`memory_stats` and `capacity_headroom` are the telemetry gauges;
``telemetry=`` (`telemetry.TelemetryExporter`) is polled and ``anomaly=``
(`anomaly.AnomalyMonitor`) observes once a step; ``tracker=`` with
``metrics_log_every=N`` logs the metrics snapshot every N steps. Each of
them defaults to a null singleton and costs one attribute check when off.
A compile (`ServingMetrics.record_compile`) is each CUDA graph capture and
each dispatch during which a kernel library was built or loaded (nvcc at
first use), so a supervisor (`serving.supervisor`) never takes a start-up
step for a stall.

Typical loop::

    engine = ServingEngine(model, max_concurrency=8)
    engine.submit(prompt_ids, SamplingParams(max_new_tokens=64))
    while engine.has_work:
        for out in engine.step():
            ...  # out.tokens, out.finish_reason

or just ``outputs = engine.run(requests)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from ..models.generation import capture_graph, sample
from ..models.kv_cache import (
    BlockAllocator,
    SlotKVCache,
    gather_block_rows,
    kv_store_dtype,
    make_block_pool,
    make_cache,
    rewind_frontier,
    scatter_cache_slots,
    scatter_rows_to_blocks,
    tree_bytes_by_dtype,
    tree_nbytes,
)
from ..ops import _build
from ..ops.flash_attention import paged_decode_attention
from ..ops.nf4_matmul import nf4_matmul, plane_pack, routes_to_kernel
from ..reliability.faults import ALL_SLOTS, active_injector
from ..utils.environment import resolve_device
from ..utils.quantization import (
    QuantizationConfig,
    QuantizedLinear,
    quantize_module,
    quantized_nbytes,
)
from .anomaly import NULL_ANOMALY
from .journal import MAGIC as JOURNAL_MAGIC
from .journal import JournalScan, RequestJournal, request_record
from .metrics import ServingMetrics
from .prefix_cache import NO_MATCH, PrefixCache, PrefixCacheConfig, PrefixMatch
from .request import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
    Request,
    RequestOutput,
    SamplingParams,
    SubmitResult,
)
from .scheduler import FIFOScheduler
from .speculation import resolve_drafter
from .telemetry import NULL_TELEMETRY
from .trace import (
    EV_ADMIT,
    EV_DISPATCH,
    EV_FETCH,
    EV_FINISH,
    EV_QUARANTINE,
    EV_REJECT,
    EV_SUBMIT,
    NULL_TRACER,
    nearest_rank,
)


# the warm-up stream of every decode-graph capture on a device, one reused:
# cuBLAS keeps a workspace for each stream it has run on for the life of the
# process, so a new stream per capture would leave one behind per rebuilt
# engine (the supervisor rebuilds on every restart)
_WARMUP_STREAMS: dict[torch.device, torch.cuda.Stream] = {}

# the engine snapshot's format tag, the reference's: a JSON document written
# atomically (tmp + fsync + rename) by `ServingEngine.snapshot`, restorable by
# `ServingEngine.resume`
SNAPSHOT_FORMAT = "accelerate_tpu/serving-snapshot-v1"


_STEP_PHASES = ("schedule_s", "draft_s", "dispatch_s", "fetch_blocked_s",
                "deliver_s", "journal_s", "telemetry_s", "total_s")


@dataclasses.dataclass
class StepTimings:
    """Host wall-time breakdown of ONE `ServingEngine.step` call (the
    reference's).

    ``schedule_s`` is reap and admission bookkeeping net of everything
    measured elsewhere; ``draft_s`` the drafter's proposals; ``dispatch_s``
    every dispatch (a decode graph replay or eager step with its uniform
    draws and fetch copy, an eager admission), compile or replay;
    ``fetch_blocked_s`` the host blocked on a fetch's event; ``deliver_s``
    token delivery, retirement and SLO accounting net of journal writes;
    ``journal_s`` the journal's appends (with their fsyncs); ``telemetry_s``
    the telemetry poll. The phases partition ``total_s`` up to clock jitter
    (an injected ``step_hang`` lies outside every phase)."""

    schedule_s: float = 0.0
    draft_s: float = 0.0
    dispatch_s: float = 0.0
    fetch_blocked_s: float = 0.0
    deliver_s: float = 0.0
    journal_s: float = 0.0
    telemetry_s: float = 0.0
    total_s: float = 0.0

    def reset(self) -> None:
        for name in _STEP_PHASES:
            setattr(self, name, 0.0)

    def as_dict(self) -> dict[str, float]:
        return {name: round(getattr(self, name), 6) for name in _STEP_PHASES}


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Knobs for the engine's ``paged_kv=`` argument. ``block_tokens`` is the
    allocation granularity, a power of two dividing ``n_positions``.
    ``num_blocks`` sizes the shared pool; None derives ``max_concurrency *
    (n_positions / block_tokens)``, enough for every slot at full context."""

    block_tokens: int = 16
    num_blocks: int | None = None


@dataclasses.dataclass(frozen=True)
class WeightQuantConfig:
    """Knobs for the engine's ``weight_quant=`` argument (the reference's).
    ``mode`` picks the packed format: ``"int8"`` (blockwise absmax over the
    default 64-element blocks: the reference passes no ``block_size`` for
    int8) or ``"nf4"`` (4-bit NormalFloat over ``block_size``-element
    blocks). Weights with fewer than ``min_weight_size`` elements, and every
    1-D leaf (biases, LayerNorm), stay dense."""

    mode: str = "int8"
    block_size: int = 64
    min_weight_size: int = 4096

    def __post_init__(self):
        if self.mode not in ("int8", "nf4"):
            raise ValueError(f"weight_quant mode must be 'int8' or 'nf4', got {self.mode!r}")

    def quantization_config(self, compute_dtype: torch.dtype) -> QuantizationConfig:
        """The `utils.quantization.QuantizationConfig` this mode maps onto;
        ``compute_dtype`` should be the model's param dtype, so dequantized
        weights enter the model at the precision the dense path used."""
        if self.mode == "int8":
            return QuantizationConfig(load_in_8bit=True, compute_dtype=compute_dtype,
                                      min_weight_size=self.min_weight_size)
        return QuantizationConfig(load_in_4bit=True, quant_type="nf4",
                                  block_size=self.block_size, compute_dtype=compute_dtype,
                                  min_weight_size=self.min_weight_size)


@dataclasses.dataclass
class RecoveryReport:
    """What `ServingEngine.resume` rebuilt from a journal or a snapshot (the
    reference's). ``resumed`` requests were mid-decode and re-enter
    admission first with their emitted tokens as a continuation prefill;
    ``restored`` were still queued and re-enter the queue in submit order.
    ``completed`` maps request id -> the terminal `RequestOutput` recovered
    from the journal's FINISH records (or a stream already complete): dedupe
    them against what the dead process delivered. ``expired`` are queued
    requests whose ``deadline_s`` passed during the downtime, rejected with
    ``rejected:deadline``."""

    source: str
    resumed: list[int] = dataclasses.field(default_factory=list)
    restored: list[int] = dataclasses.field(default_factory=list)
    completed: dict[int, RequestOutput] = dataclasses.field(default_factory=dict)
    expired: list[RequestOutput] = dataclasses.field(default_factory=list)
    downtime_s: float = 0.0
    truncated_tail_bytes: int = 0


@dataclasses.dataclass
class _Inflight:
    """One dispatched, not yet fetched piece of device work: an admission's
    ``[3, nb]`` first tokens, finished and health flags, a decode step's
    ``[k, 3, b]`` plane (each iteration's tokens, finished and health
    flags), or a verify step's ``[k + 2, 3, b]`` (``[:k + 1, :2]`` the
    tokens and finished flags of each position, ``[k + 1, 0]`` how many
    tokens each slot emitted, ``[k + 1, 1]`` its health). ``host`` is the
    pinned buffer its copy lands in, ``event`` the CUDA event recorded after
    that copy (None on the CPU, where the copy is done at dispatch). ``slots``/``epochs`` pin each result to the slot
    generation it was dispatched against, so a result that outlived a
    retirement or cancel is dropped instead of reaching the slot's next
    tenant. ``staging`` keeps an admission's pinned upload buffers alive
    until the entry is fetched, which is after their copies ran. ``seq`` is
    the EV_DISPATCH sequence number its EV_FETCH echoes (-1 untraced);
    ``tokens`` the decode iterations it ran (a verify step's positions)."""

    kind: str  # "step" | "spec" | "admit"
    host: torch.Tensor
    slots: tuple[int, ...]
    epochs: tuple[int, ...]
    event: Any = None
    staging: Any = None
    seq: int = -1
    tokens: int = 1


class ServingEngine:
    """Request-level continuous batching over a fixed pool of decode slots.

    ``model`` is a `models.gpt2.GPT2LMHead` living on ``device``
    (``None`` means CUDA; RuntimeError when it is absent). The context length
    is the config's ``n_positions``; KV is stored in the config's
    ``kv_cache_dtype`` (int8 with scale planes), or else its compute dtype.
    ``weight_quant`` (a `WeightQuantConfig`, or its mode as a string)
    serves quantized weights.

    ``pipeline_depth`` bounds how many dispatches (decode steps and
    admissions) may be in flight before the host blocks on the oldest fetch
    (1 = synchronous). ``tokens_per_sync`` is the decode iterations one
    dispatch runs between host fetches (one graph replay on CUDA).
    ``admit_batch`` caps how many same-bucket queued requests one prefill
    admits (batch buckets are the powers of two up to it).

    ``paged_kv`` picks the mode: False (the default) is the slot pool, True
    or a `PagedKVConfig` the paged pool. ``paged_attention`` is the paged
    decode attention: ``"gather"`` (the default, the plain path) or
    ``"fused"`` (the CUDA kernel), which requires ``paged_kv``. The defaults
    are the reference engine's.

    ``prefix_cache`` (True or a `PrefixCacheConfig`) turns on prefix KV
    reuse; in paged mode its ``block_tokens`` must equal the pool's.
    ``speculation`` (a draft depth, a `SpeculationConfig` or a drafter)
    turns every decode dispatch into a verify step; it needs
    ``tokens_per_sync == 1``.

    ``journal`` (a path or a `journal.RequestJournal`) writes the durable
    request journal that `resume` replays; None (the default) writes
    nothing.

    ``metrics`` shares a `ServingMetrics` (a supervisor passes its own, so
    counters span restarts). ``tracer`` (`trace.Tracer`), ``telemetry``
    (`telemetry.TelemetryExporter`) and ``anomaly``
    (`anomaly.AnomalyMonitor`) attach the observability hooks, and
    ``tracker`` with ``metrics_log_every=N`` logs `ServingMetrics.snapshot`
    every N steps; all are off by default, as in the reference."""

    def __init__(
        self,
        model: Any,
        *,
        max_concurrency: int = 8,
        prompt_buckets: tuple[int, ...] = (32, 128, 512),
        max_queue: int = 128,
        eos_token_id: int | None = None,
        pipeline_depth: int = 2,
        admit_batch: int = 4,
        paged_kv: PagedKVConfig | bool = False,
        paged_attention: str = "gather",
        device: str | torch.device | None = None,
        weight_quant: WeightQuantConfig | str | None = None,
        tokens_per_sync: int = 1,
        prefix_cache: PrefixCacheConfig | bool = False,
        speculation: Any = None,
        journal: Any = None,
        tracker: Any = None,
        metrics_log_every: int = 0,
        metrics: ServingMetrics | None = None,
        tracer: Any = None,
        telemetry: Any = None,
        anomaly: Any = None,
    ):
        self.device = resolve_device(device)
        cfg = getattr(model, "config", None)
        if cfg is None or not hasattr(cfg, "n_positions"):
            raise TypeError(f"{type(model).__name__} has no GPT-2 style config")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the engine on {self.device}")
        if isinstance(weight_quant, str):
            weight_quant = WeightQuantConfig(mode=weight_quant)
        self.weight_quant = weight_quant
        # the dense parameter bytes, before quantization (quant_stats)
        self._dense_param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        if weight_quant is not None:
            model = quantize_module(model, weight_quant.quantization_config(cfg.param_dtype))
            # the nf4 kernel's plane layout, built once here on the device
            for mod in model.modules():
                if isinstance(mod, QuantizedLinear) and routes_to_kernel(mod.qweight):
                    plane_pack(mod.qweight)
        self.model = model
        self.max_concurrency = int(max_concurrency)
        if self.max_concurrency < 1:
            raise ValueError(f"max_concurrency must be >= 1, got {max_concurrency}")
        self.paged = bool(paged_kv)
        self.max_len = int(cfg.n_positions)
        self._allocator: BlockAllocator | None = None
        if self.paged:
            pk = paged_kv if isinstance(paged_kv, PagedKVConfig) else PagedKVConfig()
            bt = int(pk.block_tokens)
            if bt < 1 or (bt & (bt - 1)) or self.max_len % bt:
                raise ValueError(
                    f"paged_kv block_tokens must be a power of two dividing "
                    f"n_positions={self.max_len}, got {bt}"
                )
            self._block_tokens = bt
            self._blocks_per_slot = self.max_len // bt
            n_blocks = (int(pk.num_blocks) if pk.num_blocks is not None
                        else self.max_concurrency * self._blocks_per_slot)
            if n_blocks < self._blocks_per_slot:
                raise ValueError(
                    f"num_blocks={n_blocks} cannot seat even one full-context request "
                    f"({self._blocks_per_slot} blocks of {bt} tokens): admission would "
                    "backpressure forever"
                )
            self._allocator = BlockAllocator(n_blocks)
        self.paged_attention = str(paged_attention)
        if self.paged_attention not in ("gather", "fused"):
            raise ValueError(
                f"paged_attention must be 'gather' or 'fused', got {paged_attention!r}"
            )
        if self.paged_attention == "fused" and not self.paged:
            raise ValueError(
                "paged_attention='fused' requires paged_kv: the fused kernel reads the "
                "block pool through the block tables"
            )
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.tokens_per_sync = int(tokens_per_sync)
        if self.tokens_per_sync < 1:
            raise ValueError(f"tokens_per_sync must be >= 1, got {tokens_per_sync}")
        self._drafter: Any = None
        self.draft_tokens = 0
        if speculation is not None:
            if self.tokens_per_sync > 1:
                raise ValueError(
                    "speculation requires tokens_per_sync == 1: the verify step is itself "
                    "the multi-token dispatch, and nesting it in a scan would need host "
                    "drafts mid-scan"
                )
            self._drafter, self.draft_tokens = resolve_drafter(speculation)
        if int(admit_batch) < 1:
            raise ValueError(f"admit_batch must be >= 1, got {admit_batch}")
        # batch buckets: powers of two up to admit_batch
        self._admit_sizes = tuple(1 << i for i in range(int(admit_batch).bit_length())
                                  if 1 << i <= int(admit_batch))
        buckets = tuple(sorted({int(b) for b in prompt_buckets if int(b) <= self.max_len}))
        if not buckets:
            raise ValueError(f"no prompt bucket fits n_positions={self.max_len}: {prompt_buckets}")
        # prompts are capped one short of the context so every request can
        # emit at least one token
        self.scheduler = FIFOScheduler(prompt_buckets=buckets, max_queue=max_queue,
                                       max_prompt_len=min(buckets[-1], self.max_len - 1))
        if self.paged:
            self.scheduler.capacity_fn = self._paged_capacity
        self.eos_token_id = eos_token_id
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.tracker = tracker
        self.metrics_log_every = int(metrics_log_every)
        # the observability hooks: each defaults to a null singleton, so an
        # emission site costs one attribute check when it is off. The
        # scheduler shares the tracer, so QUEUED edges are stamped where the
        # queue changes
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.scheduler.tracer = self.tracer
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.anomaly = anomaly if anomaly is not None else NULL_ANOMALY
        # (key, compiled, wall_s) of the most recent dispatch: what
        # EV_DISPATCH reports
        self._last_dispatch: tuple[str, bool, float] = ("", False, 0.0)
        self._timings = StepTimings()
        self._last_step_timings: dict[str, float] = {}
        self._step_count = 0
        # the decode dispatch's key (the reference's program names)
        self._step_key = (f"spec_k{self.draft_tokens}" if self.draft_tokens else "step"
                          if self.tokens_per_sync == 1 else f"step_x{self.tokens_per_sync}")
        self._draining = False
        # the durable request journal: every accepted submit is on disk
        # before the caller sees the acceptance
        self.journal: RequestJournal | None = None
        if journal is not None:
            self.journal = (journal if isinstance(journal, RequestJournal)
                            else RequestJournal(journal, metrics=self.metrics))
            if self.journal.metrics is None:
                self.journal.metrics = self.metrics
        self._vocab = int(cfg.vocab_size)

        b, dev, k = self.max_concurrency, self.device, self.tokens_per_sync
        if self.paged:
            self._cache = make_block_pool(cfg.n_layer, b, n_blocks, bt, cfg.n_head, cfg.head_dim,
                                          kv_store_dtype(cfg), dev, attention=self.paged_attention)
        else:
            self._cache = make_cache(model, b)
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache:
            pc = (prefix_cache if isinstance(prefix_cache, PrefixCacheConfig)
                  else PrefixCacheConfig())
            if self.paged:
                if int(pc.block_tokens) != self._block_tokens:
                    raise ValueError(
                        f"prefix_cache block_tokens={pc.block_tokens} must equal paged_kv "
                        f"block_tokens={self._block_tokens}: the trie aliases the engine's "
                        "pool blocks directly"
                    )
                # no pool of its own: the trie pins blocks of the engine's pool
                self.prefix_cache = PrefixCache(None, max_len=self.max_len, block_tokens=bt,
                                                metrics=self.metrics, allocator=self._allocator)
            else:
                self.prefix_cache = PrefixCache(self._cache, max_len=self.max_len,
                                                block_tokens=pc.block_tokens,
                                                num_blocks=pc.num_blocks, metrics=self.metrics)
            self.scheduler.prefill_len_fn = self._prefill_len
        # device-resident per-slot state; empty slots stay finished (frozen).
        # The decode step updates these buffers in place, and on CUDA its
        # graph holds their addresses: they are never rebound
        self._d_tokens = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_pos = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_remaining = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_finished = torch.ones(b, dtype=torch.bool, device=dev)
        self._d_temps = torch.zeros(b, dtype=torch.float32, device=dev)
        self._d_topks = torch.zeros(b, dtype=torch.long, device=dev)
        # rows the next dispatch gives NaN logits: all False unless an active
        # FaultInjector poisons a step (`_stage_poison`)
        self._d_poison = torch.zeros(b, dtype=torch.bool, device=dev)
        # paged: the block tables, the only indirection decode follows
        self._d_tables = (torch.full((b, self._blocks_per_slot), n_blocks, dtype=torch.int32,
                                     device=dev) if self.paged else None)
        # the step's inputs and outputs: uniform draws for the Gumbel noise
        # of sampled slots, one [vocab] row per iteration and slot, and the
        # tokens, finished and health flags of each iteration
        self._d_uniform = torch.zeros((k, b, cfg.vocab_size), dtype=torch.float32, device=dev)
        # a verify step's plane is [k_draft + 2, 3, b]: the k_draft + 1
        # positions' tokens and finished flags, then each slot's emitted
        # count and health
        rows = self.draft_tokens + 2 if self.draft_tokens else k
        self._d_out = torch.zeros((rows, 3, b), dtype=torch.long, device=dev)
        # speculation: the drafts of the next verify step, filled before each
        # dispatch from a ring of pinned host buffers (a buffer is rewritten
        # only after its copy ran: see _fetch_ring)
        self._d_drafts = torch.zeros((b, max(self.draft_tokens, 1)), dtype=torch.long, device=dev)
        self._eos = -1 if eos_token_id is None else int(eos_token_id)
        # host-side slot bookkeeping
        self._active = np.zeros(b, bool)
        self._slot_out: list[RequestOutput | None] = [None] * b
        self._slot_req: list[Request | None] = [None] * b
        # prefix cache: each slot's pinned match and whether it hit; paged,
        # the host copy of its table row (what adopt donates from) and how
        # many leading entries alias trie blocks
        self._slot_match: list[PrefixMatch | None] = [None] * b
        self._slot_hit = np.zeros(b, bool)
        self._slot_table_host: list[np.ndarray | None] = [None] * b
        self._slot_aliased = np.zeros(b, np.int64)
        self._slot_gen: list[torch.Generator | None] = [None] * b  # sampled slots only
        # the reference's slot generation: bumped at admission and release,
        # so lagged results of an earlier tenant are recognised and dropped
        self._slot_epoch = np.zeros(b, np.int64)
        self._slot_last_token_t = [0.0] * b
        # each slot's inter-token gaps, kept only while its tenant carries an
        # SLO with an ITL bound (None otherwise): judged at retirement
        self._slot_itl: list[list[float] | None] = [None] * b
        # tokens of each slot's stream already in the journal (PROGRESS is
        # written every journal.progress_every tokens)
        self._slot_logged = np.zeros(b, np.int64)
        self._slot_priv: list[list[int]] = [[] for _ in range(b)]
        self._free: deque[int] = deque(range(b))
        self._next_id = 0
        self._inflight: deque[_Inflight] = deque()
        # one host buffer per dispatch in flight: every dispatch drains to
        # pipeline_depth - 1 in flight, so pipeline_depth + 1 buffers never
        # hand out one whose entry is still unfetched
        pinned = dev.type == "cuda"
        self._fetch_ring = [torch.empty(rows * 3 * b, dtype=torch.long, pin_memory=pinned)
                            for _ in range(self.pipeline_depth + 1)]
        self._draft_ring = [torch.zeros(self._d_drafts.shape, dtype=torch.long, pin_memory=pinned)
                            for _ in range(self.pipeline_depth + 1)]
        # poison masks go up through their own ring, only while an injector
        # is active (a buffer is rewritten only after its copy ran, as above)
        self._poison_ring = [torch.zeros(b, dtype=torch.bool, pin_memory=pinned)
                             for _ in range(self.pipeline_depth + 1)]
        self._ring_next = 0
        self._draft_next = 0
        self._poison_next = 0
        # poison uploads made (only while a FaultInjector is active)
        self.poison_uploads = 0
        self._graph: torch.cuda.CUDAGraph | None = None
        # kernel launches one decode replay makes, by wrapper name (empty on
        # the CPU): the wrappers count only while the graph is captured
        self.graph_launches: dict[str, int] = {}
        if dev.type == "cuda":
            self._capture()

    # --------------------------------------------------------------- requests
    def submit(self, request: Request | Iterable[int],
               params: SamplingParams | None = None) -> SubmitResult:
        """Queue a request (a `Request` or a bare token-id sequence). Never
        blocks: a full queue, an oversized prompt or a draining engine
        returns a rejection with a reason code instead. With a journal the
        acceptance is on disk before it is returned."""
        if not isinstance(request, Request):
            request = Request(prompt=list(request), params=params or SamplingParams())
        request.request_id = self._next_id
        self._next_id += 1
        if request.arrival_time is None:
            request.arrival_time = time.perf_counter()
        self.metrics.mark_start()
        tr = self.tracer
        if tr.enabled:
            tr.emit(EV_SUBMIT, request.request_id, prompt_len=len(request.prompt),
                    slo=request.slo.name if request.slo is not None else None)
        if self._draining:
            self.metrics.requests_rejected.inc()
            if tr.enabled:
                tr.emit(EV_REJECT, request.request_id, reason=REJECT_DRAINING)
            return SubmitResult(False, request.request_id, REJECT_DRAINING,
                                "engine is draining toward shutdown")
        result = self.scheduler.submit(request)
        if not result.accepted and tr.enabled:
            tr.emit(EV_REJECT, request.request_id, reason=result.reason)
        if result.accepted:
            if self.journal is not None:
                self.journal.log_submit(request)  # write-ahead
            self.metrics.requests_submitted.inc()
        else:
            self.metrics.requests_rejected.inc()
        return result

    @property
    def has_work(self) -> bool:
        """Active slots, queued requests or unfetched dispatches remain."""
        return bool(self._active.any()) or self.scheduler.queue_depth > 0 or bool(self._inflight)

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def quant_stats(self) -> dict[str, Any]:
        """Quantized-serving gauges (the reference's), ``{}`` for a
        full-precision engine. Weights (``weight_quant=``): ``weight_bits``,
        the packed payload and scale bytes with the dense leaves
        (``weight_packed_bytes``, `quantized_nbytes`), the dense bytes
        recorded at load and the difference. KV (``kv_cache_dtype=int8``):
        ``kv_bits`` and the int8 payload and fp32 scale bytes of what
        attention reads (the slot rows, or the paged pools' ``[:num_blocks]``
        views, without the sink)."""
        stats: dict[str, Any] = {}
        if self.weight_quant is not None:
            packed = quantized_nbytes(self.model)
            stats["weight_bits"] = 8 if self.weight_quant.mode == "int8" else 4
            stats["weight_packed_bytes"] = packed
            stats["weight_dense_bytes"] = self._dense_param_bytes
            stats["weight_saved_bytes"] = self._dense_param_bytes - packed
        if self._cache.quantized:
            cache = self._cache
            if self.paged:
                payload = [t for i in range(len(cache.k)) for t in cache.pools(i)]
                scales = [t for i in range(len(cache.k)) for t in cache.scale_pools(i)]
            else:
                payload, scales = cache.k + cache.v, cache.k_scale + cache.v_scale
            stats["kv_bits"] = 8
            stats["kv_payload_bytes"] = sum(t.numel() * t.element_size() for t in payload)
            stats["kv_scale_bytes"] = sum(t.numel() * t.element_size() for t in scales)
        return stats

    def memory_stats(self) -> dict[str, Any]:
        """Live memory and occupancy gauges (the reference's keys, unprefixed:
        the telemetry exporter namespaces them under ``serving/mem/``, and
        lifts the ``quant/`` group, present only in a quantized mode, to
        ``serving/quant/``). Host-side only: pool bytes are exact ``nbytes``
        sums of the port's cache tensors (a paged pool's sink block and the
        one write cursor included; the reference keeps no sink and a cursor
        per layer), occupancy comes from the host slot mirrors, the
        ``block_pool/`` gauges from the allocator and the prefix cache, and
        on CUDA ``device{i}/bytes_in_use``, ``bytes_limit`` and
        ``peak_bytes_in_use`` from `torch.cuda`'s allocator counters (none
        of which waits on the stream); the CPU omits them, as the reference
        does."""
        pool_bytes = tree_nbytes(self._cache)
        stats: dict[str, Any] = {
            "slot_pool_bytes": pool_bytes,
            "slots_total": self.max_concurrency,
            "slots_active": self.active_slots,
            "slots_free": len(self._free),
            "queue_depth": self.scheduler.queue_depth,
            "inflight_dispatches": len(self._inflight),
        }
        for dtype, n in tree_bytes_by_dtype(self._cache).items():
            stats[f"slot_pool_bytes/{dtype}"] = n
        for k, v in self.quant_stats().items():
            stats[f"quant/{k}"] = v
        if self.paged:
            # free + resident (trie) + private (slot-held) == total
            alloc = self._allocator
            base = self.prefix_cache.memory_stats() if self.prefix_cache is not None else {}
            resident = int(base.get("blocks_resident", 0))
            for k, v in {
                "pool_bytes": pool_bytes,
                "block_tokens": self._block_tokens,
                "blocks_total": alloc.num_blocks,
                "blocks_free": alloc.free_count,
                "blocks_resident": resident,
                "blocks_private": alloc.owned_count - resident,
                "blocks_pinned": int(base.get("blocks_pinned", 0)),
                "blocks_evictable": int(base.get("blocks_evictable", 0)),
                "blocks_stranded": int(base.get("blocks_stranded", 0)),
                "fragmentation": base.get("fragmentation", 0.0),
            }.items():
                stats[f"block_pool/{k}"] = v
        elif self.prefix_cache is not None:
            for k, v in self.prefix_cache.memory_stats().items():
                stats[f"block_pool/{k}"] = v
        if self.device.type == "cuda":
            i = self.device.index if self.device.index is not None else torch.cuda.current_device()
            stats[f"device{i}/bytes_in_use"] = int(torch.cuda.memory_allocated(i))
            stats[f"device{i}/bytes_limit"] = int(torch.cuda.get_device_properties(i).total_memory)
            stats[f"device{i}/peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(i))
        return stats

    def capacity_headroom(self) -> dict[str, Any]:
        """Admission-capacity estimate (the reference's), host arithmetic over
        the slot mirrors: ``slots_free``, ``queue_depth``,
        ``admissible_requests`` (free slots less the queue already waiting
        for them, floored at 0), ``decode_tokens_remaining`` (tokens still
        owed across active slots at their budgets),
        ``token_capacity_remaining`` (that plus ``max_len - 1`` per free
        slot; paged, the free-slot term is capped by the free blocks' tokens),
        ``decode_tokens_per_sec`` (`ServingMetrics.tokens_per_sec`),
        ``seconds_to_exhaustion`` (capacity over that rate; None while idle)
        and ``est_slot_free_s`` (0 with a free slot, else the smallest
        remaining budget over the per-slot rate; None without a rate).
        Paged adds ``blocks_free`` and ``blocks_per_request_est`` (private
        blocks per active request). The KV tier's ``host_blocks`` is absent:
        the port has no KV tier yet."""
        free = len(self._free)
        remaining: list[int] = []
        for slot in range(self.max_concurrency):
            request, out = self._slot_req[slot], self._slot_out[slot]
            if not self._active[slot] or request is None or out is None:
                continue
            budget = min(int(request.params.max_new_tokens), self.max_len - len(request.prompt))
            remaining.append(max(0, budget - len(out.tokens)))
        decode_remaining = sum(remaining)
        if self.paged:
            blocks_free = self._allocator.free_count
            capacity = decode_remaining + min(free * (self.max_len - 1),
                                              blocks_free * self._block_tokens)
        else:
            capacity = decode_remaining + free * (self.max_len - 1)
        rate = self.metrics.tokens_per_sec()
        if free > 0:
            slot_free_s: float | None = 0.0
        elif rate > 0 and remaining:
            slot_free_s = min(remaining) * len(remaining) / rate
        else:
            slot_free_s = None
        head = {
            "slots_free": free,
            "queue_depth": self.scheduler.queue_depth,
            "admissible_requests": max(0, free - self.scheduler.queue_depth),
            "decode_tokens_remaining": decode_remaining,
            "token_capacity_remaining": capacity,
            "decode_tokens_per_sec": rate,
            "seconds_to_exhaustion": capacity / rate if rate > 0 else None,
            "est_slot_free_s": slot_free_s,
        }
        if self.paged:
            active = self.active_slots
            priv = sum(len(p) for p in self._slot_priv)
            head["blocks_free"] = blocks_free
            head["blocks_per_request_est"] = (priv / active if active
                                              else float(self._blocks_per_slot))
        return head

    def _release_device(self) -> None:
        """Free this engine's device memory now: the captured graph (its
        private memory pool), the KV pools, the per-slot buffers and the
        pinned host rings. For an engine that will not step again (the
        supervisor's restart drops the old engine before the new one
        captures); an engine sits in a reference cycle, so without this its
        memory would wait for the garbage collector."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self._inflight.clear()
        for name in ("_cache", "_d_tokens", "_d_pos", "_d_remaining", "_d_finished", "_d_temps",
                     "_d_topks", "_d_poison", "_d_tables", "_d_uniform", "_d_out", "_d_drafts"):
            setattr(self, name, None)
        self._fetch_ring = self._draft_ring = self._poison_ring = []
        if self.prefix_cache is not None:
            self.prefix_cache.pool = None

    # ------------------------------------------------------------ engine loop
    def step(self) -> list[RequestOutput]:
        """Fetch the results the device has finished, admit into free slots,
        dispatch one decode step (``tokens_per_sync`` iterations) for every
        slot, fetch results lagging by up to ``pipeline_depth`` dispatches,
        and return the requests whose completion was observed during this
        call (at depth > 1 a finish surfaces when its fetch lands, up to
        ``pipeline_depth - 1`` calls after the device produced it). The
        call's phase breakdown is `last_step_timings` after it."""
        tm = self._timings
        tm.reset()
        t_start = time.perf_counter()
        journal = self.journal
        j_start = journal.append_s if journal is not None else 0.0
        finished: list[RequestOutput] = []
        self._reap_ready(finished)
        self._admit_pending(finished)
        # schedule: the reap and admission wall net of the dispatches,
        # fetches, deliveries and journal appends they made
        j_sched = (journal.append_s - j_start) if journal is not None else 0.0
        tm.schedule_s = max(0.0, (time.perf_counter() - t_start) - tm.dispatch_s
                            - tm.fetch_blocked_s - tm.deliver_s - j_sched)
        n_active = self.active_slots
        self.metrics.observe_step(n_active, self.max_concurrency, self.scheduler.queue_depth)
        self._step_count += 1
        if n_active:
            if self.draft_tokens:
                # drafting happens at dispatch time, from the host's
                # (possibly pipeline-lagged) view of each stream
                t_draft = time.perf_counter()
                self._stage_drafts()
                tm.draft_s = time.perf_counter() - t_draft
            poison = self._poison_mask()
            self._dispatch_fault_point()
            self.metrics.dispatch_depth.observe(len(self._inflight) + 1)
            entry = self._dispatch(self._step_key, self._dispatch_step, poison)
            self.metrics.decode_dispatches.inc()
            self.metrics.decode_steps.inc(self.tokens_per_sync)
            if self.draft_tokens:
                self.metrics.spec_forwards.inc()
            self._inflight.append(entry)
            if self.tracer.enabled:
                # the step's phases so far ride the dispatch event
                phases = {"phases": {"schedule_s": round(tm.schedule_s, 6),
                                     "draft_s": round(tm.draft_s, 6),
                                     "dispatch_s": round(tm.dispatch_s, 6)}}
                if self.draft_tokens:
                    self._trace_dispatch(entry, "spec", drafted=self.draft_tokens, **phases)
                else:
                    self._trace_dispatch(entry, "step", **phases)
            self._drain_to(self.pipeline_depth - 1, finished)
        if not self._active.any():
            # nothing left to overlap with: flush the lagged tail so every
            # finish is returned before the caller sees has_work False
            self._drain_to(0, finished)
        if (self.tracker is not None and self.metrics_log_every
                and self._step_count % self.metrics_log_every == 0):
            self.metrics.log_to(self.tracker, step=self._step_count)
        if self.telemetry.enabled:
            t_tel = time.perf_counter()
            self.telemetry.poll(self)
            tm.telemetry_s = time.perf_counter() - t_tel
        tm.journal_s = (journal.append_s - j_start) if journal is not None else 0.0
        tm.total_s = time.perf_counter() - t_start
        self.metrics.observe_step_phases(tm)
        self._last_step_timings = tm.as_dict()
        if self.anomaly.enabled:
            self.anomaly.observe(self)
        return finished

    @property
    def last_step_timings(self) -> dict[str, float]:
        """Phase breakdown (`StepTimings.as_dict`) of the most recent `step`
        call, {} before the first. Supervisor heartbeats and flight-recorder
        bundles embed it."""
        return self._last_step_timings

    def _dispatch_step(self, poison: np.ndarray | None) -> _Inflight:
        """Enqueue one decode dispatch and its fetch: the sampled slots'
        uniform draws, the poison mask (only while an injector poisons), the
        graph replay (the eager step on the CPU) and the copy of its output
        plane behind it."""
        self._fill_uniform()
        if poison is not None:
            self._stage_poison(poison)
        if self._graph is not None:
            self._graph.replay()
        else:
            with torch.no_grad():
                self._step_body()
        if poison is not None:
            self._d_poison.zero_()  # on the stream, after the step read it
        entry = self._fetch("spec" if self.draft_tokens else "step", self._d_out,
                            tuple(range(self.max_concurrency)),
                            tuple(int(e) for e in self._slot_epoch))
        entry.tokens = self.draft_tokens + 1 if self.draft_tokens else self.tokens_per_sync
        return entry

    def _dispatch(self, key: str, fn: Any, *args: Any) -> Any:
        """Run one dispatch ``fn(*args)`` under its key, timed into
        ``dispatch_s``. A dispatch during which a kernel library was built
        or loaded (`ops._build.LOAD_LOG` grew: nvcc at first use) counts as
        one compile of ``key``. With a tracer the call runs inside its
        ``annotation(key)`` (``torch.profiler.record_function`` with
        ``annotate=True``) and its key, compile flag and seconds are kept
        for the EV_DISPATCH event. Nothing here synchronises the stream."""
        loads = len(_build.LOAD_LOG)
        t0 = time.perf_counter()
        if self.tracer.enabled:
            with self.tracer.annotation(key):
                out = fn(*args)
        else:
            out = fn(*args)
        dt = time.perf_counter() - t0
        self._timings.dispatch_s += dt
        compiled = len(_build.LOAD_LOG) != loads
        if compiled:
            self.metrics.record_compile(key, dt)
        self._last_dispatch = (key, compiled, dt)
        return out

    def _trace_dispatch(self, entry: _Inflight, what: str, **extra: Any) -> None:
        """Stamp a just-enqueued `_Inflight` with a dispatch sequence number
        and emit its EV_DISPATCH: which dispatch ran (compile or replay), the
        pipeline depth it joined at, and every (slot, rid, gen) riding it,
        the handle `trace.validate` balances against EV_FETCH."""
        tr = self.tracer
        if not tr.enabled:
            return
        entry.seq = tr.next_seq()
        key, compiled, dt = self._last_dispatch
        reqs = tuple((int(slot), self._slot_req[slot].request_id, int(gen))
                     for slot, gen in zip(entry.slots, entry.epochs)
                     if self._active[slot] and self._slot_req[slot] is not None
                     and self._slot_epoch[slot] == gen)
        tr.emit(EV_DISPATCH, None, seq=entry.seq, what=what, key=key, compiled=compiled,
                dispatch_s=round(dt, 6), depth=len(self._inflight), step=self._step_count,
                reqs=reqs, tokens=entry.tokens, **extra)

    def run(self, requests: Iterable[Request], max_steps: int | None = None
            ) -> list[RequestOutput]:
        """Serve a batch of requests to completion, respecting backpressure (a
        queue-full rejection defers the submit until slots drain). Returns
        outputs in submission order; structurally rejected requests come back
        with ``finish_reason='rejected:<reason>'``. Hitting ``max_steps``
        aborts whatever is still active or queued with `FINISH_ABORTED`."""
        pending = deque(requests)
        outputs: dict[int, RequestOutput] = {}
        steps = 0
        while pending or self.has_work:
            while pending:
                result = self.submit(pending[0])
                if result.accepted:
                    pending.popleft()
                elif result.reason == REJECT_QUEUE_FULL:
                    break  # drain a step, then retry
                else:
                    req = pending.popleft()
                    outputs[result.request_id] = RequestOutput(
                        request_id=result.request_id, prompt_len=len(req.prompt), tokens=[],
                        finish_reason=f"rejected:{result.reason}",
                        arrival_time=req.arrival_time)
            for out in self.step():
                outputs[out.request_id] = out
            steps += 1
            if max_steps is not None and steps >= max_steps and (pending or self.has_work):
                for out in self.abort_all():
                    outputs[out.request_id] = out
                for req in pending:  # deferred by backpressure, never queued
                    if req.request_id is None:
                        req.request_id = self._next_id
                        self._next_id += 1
                    outputs[req.request_id] = RequestOutput(
                        request_id=req.request_id, prompt_len=len(req.prompt), tokens=[],
                        finish_reason=FINISH_ABORTED, arrival_time=req.arrival_time)
                break
        return [outputs[k] for k in sorted(outputs)]

    def cancel(self, request_id: int) -> RequestOutput | None:
        """Abort one request wherever it is: queued (removed) or seated
        (slot retired with `FINISH_ABORTED`, the tokens fetched so far
        returned; in-flight results for it are dropped by the slot's
        generation bump). None if the id is unknown or already finished."""
        now = time.perf_counter()
        queued = self.scheduler.cancel(request_id)
        if queued is not None:
            self.metrics.requests_cancelled.inc()
            self._slo_never_served(queued)
            if self.tracer.enabled:
                self.tracer.emit(EV_FINISH, request_id, reason=FINISH_ABORTED, tokens=0,
                                 depth=len(self._inflight),
                                 **self._slo_trace_attrs(queued.slo))
            if self.journal is not None:
                self.journal.log_finish(request_id, FINISH_ABORTED, [])
            return RequestOutput(
                request_id=request_id, prompt_len=len(queued.prompt), tokens=[],
                finish_reason=FINISH_ABORTED, arrival_time=queued.arrival_time, finish_time=now)
        for slot, out in enumerate(self._slot_out):
            if out is not None and out.request_id == request_id:
                finished: list[RequestOutput] = []
                self._retire(slot, FINISH_ABORTED, now, finished)
                self.metrics.requests_cancelled.inc()
                return finished[0]
        return None

    @property
    def draining(self) -> bool:
        """True between `begin_drain` and `end_drain` (or while `drain`
        runs): every new `submit` is rejected with `REJECT_DRAINING`."""
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting new submits (rejected with `REJECT_DRAINING`)
        while the caller serves out the backlog itself: the incremental half
        of `drain` (the serving preemption handler's grace-window loop)."""
        self._draining = True

    def end_drain(self) -> None:
        """Re-open admission after a `begin_drain` (a cancelled shutdown)."""
        self._draining = False

    def drain(self, max_steps: int | None = None) -> list[RequestOutput]:
        """Graceful shutdown: reject new submits and serve everything queued
        or active to completion; ``max_steps`` bounds the wait, and what is
        left then is aborted. Outputs come in completion order, with any
        abort tail after them (`abort_all`'s order). Admission re-opens on
        return."""
        self.begin_drain()
        outputs: list[RequestOutput] = []
        steps = 0
        try:
            while self.has_work:
                outputs.extend(self.step())
                steps += 1
                if max_steps is not None and steps >= max_steps and self.has_work:
                    outputs.extend(self.abort_all())
                    break
        finally:
            self.end_drain()
        return outputs

    def abort_all(self, reason: str = FINISH_ABORTED) -> list[RequestOutput]:
        """Hard shutdown: abort every queued request, then every active slot
        in ascending slot order (the reference's order), with ``reason``
        (default `FINISH_ABORTED`); active slots keep their partial tokens,
        a queued request its recovered ``resume_tokens``. In-flight results
        are dropped unfetched."""
        now = time.perf_counter()
        aborted: list[RequestOutput] = []
        for req in self.scheduler.drain_queue():
            self.metrics.requests_cancelled.inc()
            self._slo_never_served(req)
            if self.tracer.enabled:
                self.tracer.emit(EV_FINISH, req.request_id, reason=reason,
                                 tokens=len(req.resume_tokens), depth=0,
                                 **self._slo_trace_attrs(req.slo))
            if self.journal is not None:
                self.journal.log_finish(req.request_id, reason, list(req.resume_tokens))
            aborted.append(RequestOutput(
                request_id=req.request_id, prompt_len=len(req.prompt),
                tokens=list(req.resume_tokens), finish_reason=reason,
                arrival_time=req.arrival_time, finish_time=now))
        for slot in np.flatnonzero(self._active):
            self.metrics.requests_cancelled.inc()
            self._retire(int(slot), reason, now, aborted)
        if self.tracer.enabled:
            # the cleared entries are never fetched: their EV_FETCH is
            # emitted as discarded, so dispatch/fetch stays balanced
            for i, entry in enumerate(self._inflight):
                self.tracer.emit(EV_FETCH, None, seq=entry.seq, what=entry.kind, discarded=True,
                                 depth=len(self._inflight) - i - 1, tokens=entry.tokens)
        self._inflight.clear()  # every entry now predates a generation bump
        return aborted

    # ------------------------------------------------------ snapshot / resume
    @staticmethod
    def _entry(request: Request, tokens: list[int], admitted: bool, now: float) -> dict[str, Any]:
        """One snapshot entry: the request's journal identity plus its
        stream state, enough for `resume` to rebuild it."""
        rec = request_record(request)
        rec.pop("rid", None)
        return {
            "rid": request.request_id,
            **rec,
            "toks": [int(t) for t in tokens],
            "retries": int(request.retries),
            "admitted": bool(admitted),
            "waited_s": (max(0.0, now - request.arrival_time)
                         if request.arrival_time is not None else 0.0),
        }

    def snapshot(self, path: str | os.PathLike) -> list[RequestOutput]:
        """Write what a new process needs to continue this engine's work:
        queue order, each live slot's emitted tokens, retry counts and the id
        watermark (generators and budgets follow from seeds and token
        counts). The dispatches in flight are fetched first (no new work is
        dispatched), so the snapshot is a consistent frontier; finishes seen
        meanwhile are returned, to be delivered like `step`'s. The file is
        written atomically (tmp + fsync + rename): a crash mid-write leaves
        the previous snapshot, never a torn one."""
        finished: list[RequestOutput] = []
        self._drain_to(0, finished)
        now = time.perf_counter()
        entries = [self._entry(self._slot_req[slot], self._slot_out[slot].tokens, True, now)
                   for slot in range(self.max_concurrency) if self._active[slot]]
        for request in self.scheduler.snapshot_queue():
            entries.append(self._entry(request, request.resume_tokens,
                                       bool(request.resume_tokens), now))
        data = {"format": SNAPSHOT_FORMAT, "ts": time.time(), "next_id": self._next_id,
                "draining": self._draining, "entries": entries}
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            f.write(json.dumps(data, separators=(",", ":")).encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return finished

    @staticmethod
    def _load_recovery_source(path: Path) -> tuple[str, dict[int, RequestOutput], list[dict],
                                                   float, int, int]:
        """A journal or a snapshot as (kind, completed outputs, pending
        entries, wall time of the crash frontier, next id floor, torn tail
        bytes)."""
        with open(path, "rb") as f:
            head = f.read(len(JOURNAL_MAGIC))
        if head == JOURNAL_MAGIC:
            scan: JournalScan = RequestJournal.scan(path)
            completed = {
                rid: RequestOutput(request_id=rid, prompt_len=len(scan.submits[rid]["prompt"]),
                                   tokens=list(toks), finish_reason=reason)
                for rid, (reason, toks) in scan.finishes.items()
            }
            admitted = set(scan.admit_order)
            entries = []
            for rid in scan.incomplete():
                rec = scan.submits[rid]
                entries.append({
                    "rid": rid, "prompt": rec["prompt"], "params": rec["params"],
                    "deadline_s": rec.get("deadline_s"),
                    "cache_prefix": rec.get("cache_prefix", True),
                    "priority": rec.get("priority", 0),
                    "toks": scan.tokens.get(rid, []), "retries": 0,
                    "admitted": rid in admitted,
                    "waited_s": max(0.0, scan.last_ts - float(rec.get("ts", scan.last_ts))),
                })
            return ("journal", completed, entries, scan.last_ts,
                    max(scan.submits, default=-1) + 1, scan.truncated_tail_bytes)
        data = json.loads(path.read_bytes())
        if data.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(f"{path} is neither a request journal nor a "
                             f"{SNAPSHOT_FORMAT} snapshot")
        return ("snapshot", {}, list(data.get("entries", ())), float(data.get("ts", 0.0)),
                int(data.get("next_id", 0)), 0)

    def resume(self, path: str | os.PathLike | None = None) -> RecoveryReport:
        """Crash-exact recovery: rebuild this idle, freshly built engine's
        work from a durable source: its own journal (the default), another
        journal, or a `snapshot` file.

        - requests with a FINISH record come back in ``report.completed``
          and are not replayed;
        - requests that were mid-decode are re-admitted first (in admission
          order) with their emitted tokens as ``resume_tokens``: one
          continuation prefill and a fast-forwarded generator continue the
          stream as the uninterrupted run does (a stream already at its
          budget or its EOS completes here instead). Their ``deadline_s`` is
          cleared: the pre-crash admission consumed it;
        - queued requests re-enter the queue in submit order; one whose
          ``deadline_s`` passed during the downtime is expired with
          ``rejected:deadline`` (in ``report.expired``, journaled, counted);
          the others keep only their pre-crash wait.

        A foreign source (a snapshot, another journal) is copied into this
        engine's journal, so it covers the next crash."""
        if path is None:
            if self.journal is None:
                raise ValueError("resume() needs a path when the engine has no journal")
            path = self.journal.path
        path = Path(path)
        if self._active.any() or self.scheduler.queue_depth or self._inflight:
            raise RuntimeError("resume() requires an idle engine: restore into a freshly "
                               "built one")
        kind, completed, entries, last_ts, next_id, tail = self._load_recovery_source(path)
        perf_now = time.perf_counter()
        downtime = max(0.0, time.time() - last_ts) if last_ts else 0.0
        report = RecoveryReport(source=kind, downtime_s=downtime, truncated_tail_bytes=tail,
                                completed=completed)
        foreign = (self.journal is not None
                   and Path(self.journal.path).resolve() != path.resolve())
        eos = self.eos_token_id
        for e in entries:
            rid = int(e["rid"])
            prompt = [int(t) for t in e["prompt"]]
            plen = len(prompt)
            toks = [int(t) for t in e.get("toks", ())]
            ep = e["params"]
            sp = SamplingParams(temperature=float(ep["temperature"]), top_k=ep["top_k"],
                                seed=int(ep["seed"]), max_new_tokens=int(ep["max_new_tokens"]))
            admitted = bool(e.get("admitted"))
            deadline = e.get("deadline_s")
            waited = float(e.get("waited_s", 0.0))
            budget = min(sp.max_new_tokens, self.max_len - plen)
            # a stream that finished but lost its FINISH record in the crash
            # completes here: re-admitting it would overrun its budget
            done_reason = None
            if eos is not None and eos in toks:
                toks = toks[:toks.index(eos) + 1]
                done_reason = FINISH_EOS
            elif len(toks) >= budget:
                toks = toks[:budget]
                done_reason = FINISH_LENGTH
            if done_reason is not None:
                report.completed[rid] = RequestOutput(request_id=rid, prompt_len=plen,
                                                      tokens=toks, finish_reason=done_reason)
                if self.tracer.enabled:
                    self.tracer.emit(EV_SUBMIT, rid, prompt_len=plen, recovered=True)
                    self.tracer.emit(EV_FINISH, rid, reason=done_reason, tokens=len(toks),
                                     depth=0)
                if self.journal is not None:
                    if foreign:
                        self.journal.log_submit(Request(prompt=prompt, params=sp, request_id=rid))
                    self.journal.log_finish(rid, done_reason, toks)
                continue
            if not admitted and deadline is not None and waited + downtime >= float(deadline):
                # the client's patience ran out while the process was down
                self.metrics.requests_expired.inc()
                report.expired.append(RequestOutput(
                    request_id=rid, prompt_len=plen, tokens=[],
                    finish_reason=f"rejected:{REJECT_DEADLINE}", finish_time=perf_now))
                if self.tracer.enabled:
                    self.tracer.emit(EV_SUBMIT, rid, prompt_len=plen, recovered=True)
                    self.tracer.emit(EV_REJECT, rid, reason=REJECT_DEADLINE, expired=True)
                if self.journal is not None:
                    if foreign:
                        self.journal.log_submit(Request(prompt=prompt, params=sp, request_id=rid,
                                                        deadline_s=deadline))
                    self.journal.log_finish(rid, f"rejected:{REJECT_DEADLINE}", [])
                continue
            # the resume point must fit a prompt bucket: a longer stream
            # rewinds to the largest prefix that fits and decodes the rest
            # again (deterministically, so the stream is unchanged)
            keep = max(0, min(len(toks), self.scheduler.max_prompt_len - plen))
            request = Request(prompt=prompt, params=sp, request_id=rid,
                              deadline_s=None if admitted else deadline,
                              cache_prefix=bool(e.get("cache_prefix", True)),
                              retries=int(e.get("retries", 0)), resume_tokens=toks[:keep],
                              arrival_time=perf_now - waited, priority=int(e.get("priority", 0)))
            if self.tracer.enabled:
                self.tracer.emit(EV_SUBMIT, rid, prompt_len=plen, recovered=True,
                                 resumed=len(request.resume_tokens))
            result = self.scheduler.submit(request)
            if not result.accepted:
                raise RuntimeError(
                    f"restored request {rid} rejected ({result.reason}): the resuming engine's "
                    "scheduler is smaller than the crashed one's (queue and buckets must cover "
                    "the recovered backlog)")
            self.metrics.mark_start()
            self.metrics.requests_submitted.inc()
            if foreign and self.journal is not None:
                self.journal.log_submit(request)
                if request.resume_tokens:
                    self.journal.log_progress(rid, request.resume_tokens,
                                              len(request.resume_tokens))
            if admitted:
                self.metrics.requests_resumed.inc()
                report.resumed.append(rid)
            else:
                self.metrics.requests_restored.inc()
                report.restored.append(rid)
        all_rids = [e["rid"] for e in entries] + list(report.completed) + [next_id - 1]
        self._next_id = max(self._next_id, max(all_rids, default=-1) + 1)
        return report

    # ------------------------------------------------------------- admission
    def _prefill_len(self, request: Request) -> int:
        """Scheduler probe: the prompt tokens admission would prefill for
        ``request`` now, its uncached suffix (the grouping key of
        suffix-bucketed admission). It pins nothing: admission re-walks and
        pins. A resumed stream prefills ``prompt + resume_tokens`` as one
        plain continuation pass: it never reads the block pool."""
        if not request.cache_prefix or request.resume_tokens:
            return request.prefill_len
        return len(request.prompt) - self.prefix_cache.match_len(request.prompt)

    def _admit_pending(self, finished: list[RequestOutput]) -> None:
        now = time.perf_counter()
        for request in self.scheduler.pop_expired(now):
            # expired while queued: rejected, never admitted
            self.metrics.requests_expired.inc()
            self._slo_never_served(request)
            if self.tracer.enabled:
                self.tracer.emit(EV_REJECT, request.request_id, reason=REJECT_DEADLINE,
                                 expired=True, **self._slo_trace_attrs(request.slo))
            if self.journal is not None:
                self.journal.log_finish(request.request_id, f"rejected:{REJECT_DEADLINE}", [])
            finished.append(RequestOutput(
                request_id=request.request_id, prompt_len=len(request.prompt), tokens=[],
                finish_reason=f"rejected:{REJECT_DEADLINE}", arrival_time=request.arrival_time,
                finish_time=now))
        while self._free:
            run_len = self.scheduler.peek_run(min(len(self._free), self._admit_sizes[-1]))
            if run_len == 0:
                return
            nb = max(s for s in self._admit_sizes if s <= run_len)
            group = self.scheduler.pop_run(nb)
            matches = None
            if self.prefix_cache is not None:
                # pin now: nothing changes the trie between the peek_run
                # probe and this acquire, so the match agrees with the
                # suffix bucket the group was sized by
                matches = [self.prefix_cache.acquire(r.prompt)
                           if r.cache_prefix and not r.resume_tokens else NO_MATCH
                           for r in group]
                if not any(m.tokens for m in matches):
                    for r in group:
                        if r.cache_prefix and not r.resume_tokens:
                            self.metrics.prefix_misses.inc()
                    matches = None  # all missed: the plain admission
            if not self._admit_group(group, finished, matches):
                return  # block-pool backpressure: group requeued

    def _trim_matches(self, group: list[Request], matches: list[PrefixMatch]) -> int:
        """The suffix bucket of a cached group, after trimming every match
        whose cached prefix plus that bucket would overrun ``n_positions``
        (the suffix prefill would write past the row). Trimming grows a
        suffix, which can grow the shared bucket and push other rows over:
        iterate to a fixed point (the bucket only grows and matches only
        shrink; at worst every match is empty)."""
        pc = self.prefix_cache
        while True:
            bucket = self.scheduler.bucket_for(
                max(len(r.prompt) - m.tokens for r, m in zip(group, matches)))
            over = [i for i, m in enumerate(matches)
                    if m.tokens and m.tokens + bucket > self.max_len]
            if not over:
                return bucket
            keep = max(0, (self.max_len - bucket) // pc.block_tokens)
            for i in over:
                matches[i] = pc.trim(matches[i], keep)

    def _admit_group(self, group: list[Request], finished: list[RequestOutput],
                     matches: list[PrefixMatch] | None = None) -> bool:
        """Prefill one same-bucket group, sample its first tokens and seat it
        in free slots. False (group requeued) when the paged pool is short.

        ``matches`` (pinned prefix matches, at least one a hit) takes the
        cached admission: the matched rows are gathered out of the block
        pool and only the suffixes prefill over them, each row from its own
        cached length, through the slot cache's decode path; every row's
        budget is priced on its full prompt, so a hit emits what a cold
        admission would.

        A resumed request (``resume_tokens``, k of them) prefills ``prompt +
        resume_tokens`` in one pass, keeps the budget it started with less
        the k tokens it emitted, and has its generator fast-forwarded past
        their k draws, so its next token is the uninterrupted run's.

        The admission computes each row's health as the decode step does (a
        poisoned row's logits are NaN) and freezes an unhealthy row."""
        nb = len(group)
        if matches is None:
            bucket = self.scheduler.bucket_for(max(r.prefill_len for r in group))
            cached = [0] * nb
        else:
            bucket = self._trim_matches(group, matches)
            cached = [m.tokens for m in matches]
        reservation = None
        if self.paged:
            reservation = self._reserve_blocks(group, matches)
            if reservation is None:
                return False
        try:
            self._dispatch_fault_point()
        except BaseException:
            # the group has left the queue: put it back (its blocks and pins
            # released), so a supervisor that fails the engine accounts for
            # every request of it. The reference loses such a group here.
            for _, priv in reservation or ():
                self._allocator.free(priv)
            for m in matches or ():
                if m.nodes:
                    self.prefix_cache.release(m)
            for request in reversed(group):
                self.scheduler.requeue(request)
            raise
        slots = [self._free.popleft() for _ in group]
        padded = np.zeros((nb, bucket), np.int64)
        lens = np.zeros(nb, np.int64)  # the tokens each row prefills
        budgets = np.zeros(nb, np.int64)
        for i, request in enumerate(group):
            plen, k = len(request.prompt), len(request.resume_tokens)
            src = request.prefill_source()
            padded[i, :len(src) - cached[i]] = src[cached[i]:]
            lens[i] = len(src) - cached[i]
            # the context is fixed-size: cap generation so cache writes stay
            # inside [0, n_positions); the cap is on the original prompt, so a
            # resumed request keeps its budget less the k tokens it emitted
            budgets[i] = min(int(request.params.max_new_tokens), self.max_len - plen) - k
            if k:
                self.metrics.replayed_tokens.inc(plen + k)
            if matches is not None:
                if cached[i]:
                    self.metrics.prefix_hits.inc()
                    self.metrics.prefix_tokens_reused.inc(cached[i])
                elif request.cache_prefix and not k:
                    self.metrics.prefix_misses.inc()
        dev = self.device
        gens = [self._generator(r) for r in group]
        arrays = [padded, np.asarray(slots, np.int64), lens, np.asarray(cached, np.int64),
                  budgets, np.asarray([r.params.temperature for r in group], np.float32),
                  np.asarray([r.params.top_k or 0 for r in group], np.int64)]
        # the blocks the prefill's rows span: the bucket for a plain
        # admission; for a cached one, the longest cached prefix plus the
        # suffix bucket (the trim keeps it inside the row), so the gather,
        # the suffix's attention and the write back cover no more
        if self.paged:
            tables, dest = self._commit_reservation(reservation, group, matches, slots)
            span = -(-(max(cached) + bucket) // self._block_tokens)
            arrays += [tables, np.ascontiguousarray(dest[:, :span])]
        elif matches is not None:
            span = -(-(max(cached) + bucket) // self.prefix_cache.block_tokens)
            # pool blocks of each row's match; entries past it read block 0,
            # positions the suffix overwrites or the mask hides
            tables = np.zeros((nb, span), np.int64)
            for i, m in enumerate(matches):
                tables[i, :len(m.block_ids)] = m.block_ids
            arrays.append(tables)

        def run() -> tuple[torch.Tensor, torch.Tensor]:
            staging, views = self._upload(*arrays)
            ids, slots_t, lens_t, cached_t, budgets_t, temps, topks = views[:7]
            with torch.no_grad():
                if matches is None:
                    kv: list = []
                    hidden = self.model(ids, kv_out=kv, return_hidden=True)
                else:
                    pool = self._cache if self.paged else self.prefix_cache.pool
                    rows = gather_block_rows(pool, views[7][:, :span], cached_t)
                    hidden = self.model(ids, cached_t, cache=rows, return_hidden=True)
                    kv = [rows.storages(layer) for layer in range(len(rows.k))]
                last = self.model.logits(hidden[torch.arange(nb, device=dev), lens_t - 1])
                # health, as in the decode step: a poisoned row's logits are NaN
                last = last.masked_fill(self._d_poison[slots_t][:, None], float("nan"))
                ok = torch.isfinite(last).all(dim=-1)
                first = self._sample(last, temps, topks, gens)
                # decode resumes from the full prompt end: cached prefix + suffix
                prompt_lens = cached_t + lens_t
                if self.paged:
                    tables_t, dest_t = views[7:]
                    scatter_rows_to_blocks(self._cache, kv, slots_t, dest_t,
                                           prompt_lens.to(torch.int32))
                    self._d_tables[slots_t] = tables_t.to(torch.int32)
                else:
                    scatter_cache_slots(self._cache, SlotKVCache.from_rows(kv, prompt_lens), slots_t,
                                        prompt_lens)
                rem0 = budgets_t - 1
                fin0 = (rem0 <= 0) | ((self._eos >= 0) & (first == self._eos)) | ~ok
                self._d_tokens[slots_t] = first
                self._d_pos[slots_t] = prompt_lens
                self._d_remaining[slots_t] = rem0
                self._d_finished[slots_t] = fin0
                self._d_temps[slots_t] = temps
                self._d_topks[slots_t] = topks
                out = torch.stack([first, fin0.long(), ok.long()])
            return staging, out

        key = f"{'admit' if matches is None else 'cached_admit'}[pb{bucket}b{nb}]"
        staging, out = self._dispatch(key, run)
        epochs = []
        for i, (slot, request) in enumerate(zip(slots, group)):
            self._slot_epoch[slot] += 1
            epochs.append(int(self._slot_epoch[slot]))
            self._active[slot] = True
            self._slot_gen[slot] = gens[i]
            self._slot_req[slot] = request
            # a resumed stream's recovered prefix is part of the output, and
            # already in the journal
            self._slot_out[slot] = RequestOutput(
                request_id=request.request_id, prompt_len=len(request.prompt),
                tokens=list(request.resume_tokens), finish_reason="",
                arrival_time=request.arrival_time)
            self._slot_logged[slot] = len(request.resume_tokens)
            slo = request.slo
            self._slot_itl[slot] = [] if slo is not None and slo.itl_p99_s is not None else None
            if matches is not None:
                # the pins travel with the slot, released at retirement
                self._slot_match[slot] = matches[i] if matches[i].nodes else None
                self._slot_hit[slot] = bool(matches[i].tokens)
        self.metrics.prefill_tokens.inc(int(lens.sum()))
        self.metrics.admit_batch_size.observe(nb)
        entry = self._fetch("admit", out, tuple(slots), tuple(epochs), staging=staging)
        self._inflight.append(entry)
        if self.tracer.enabled:
            self._trace_dispatch(entry, "admit" if matches is None else "cached_admit")
            for i, (slot, request) in enumerate(zip(slots, group)):
                self.tracer.emit(EV_ADMIT, request.request_id, slot=slot, gen=epochs[i],
                                 bucket=bucket, seq=entry.seq, cache_hit=bool(cached[i]),
                                 cached_tokens=cached[i], resumed=len(request.resume_tokens),
                                 depth=len(self._inflight))
        # at depth 1 this fetches the first tokens now: an EOS or a 1-token
        # budget frees its slot before the next group is sized
        self._drain_to(self.pipeline_depth - 1, finished)
        return True

    def _upload(self, *arrays: np.ndarray) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Host arrays to the device without a stream synchronisation: packed
        into one staging buffer (pinned on CUDA; PyTorch synchronises the
        stream for a copy from pageable memory, which would wait for every
        dispatch in flight), copied ``non_blocking``, and viewed back by
        dtype and shape on the device. Returns the staging buffer, which must
        outlive the copy, and the device views."""
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // 8) * 8  # every view starts 8-byte aligned
        staging = torch.empty(total, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        flat = staging.numpy()
        for a, off in zip(arrays, offsets):
            flat[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev = staging.to(self.device, non_blocking=True)
        views = [dev[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).reshape(a.shape)
                 for a, off in zip(arrays, offsets)]
        return staging, views

    def _reserve_blocks(self, group: list[Request], matches: list[PrefixMatch] | None
                        ) -> list[tuple[int, list[int]]] | None:
        """All-or-nothing block reservation for one admission group: each
        request needs blocks covering ``min(prompt + max_new_tokens,
        max_len)`` tokens, less its trie-aliased prefix, reserved up front.
        On shortfall unpinned trie leaves are evicted; if still short, the
        pins are dropped, the group goes back to the queue front in its
        original order and None is returned. Otherwise ``(aliased blocks,
        private block ids)`` per request."""
        alloc, bt = self._allocator, self._block_tokens
        needs = []
        for i, request in enumerate(group):
            aliased = matches[i].tokens // bt if matches is not None else 0
            n_res = -(-FIFOScheduler.decode_extent(request, self.max_len) // bt)
            needs.append((aliased, max(0, n_res - aliased)))
        total = sum(n for _, n in needs)
        if alloc.free_count < total and self.prefix_cache is not None:
            self.prefix_cache.reclaim(total - alloc.free_count)
        if alloc.free_count < total:
            for m in matches or ():
                if m.nodes:
                    self.prefix_cache.release(m)
            for request in reversed(group):
                self.scheduler.requeue(request)
            return None
        return [(aliased, alloc.alloc(n) or []) for aliased, n in needs]

    def _commit_reservation(self, reservation: list[tuple[int, list[int]]], group: list[Request],
                            matches: list[PrefixMatch] | None, slots: list[int]
                            ) -> tuple[np.ndarray, np.ndarray]:
        """The admission's table rows (the trie's aliased blocks, then the
        slot's own, the sentinel past them, so a stray read clamps and a
        stray write drops) and scatter destinations: only the blocks the
        prefill writes, ``[aliased, ceil(prefill_len / block_tokens))``. The
        aliased prefix is never written, and reserved decode blocks are
        filled in place by decode before anything reads them."""
        bt, sentinel = self._block_tokens, self._allocator.num_blocks
        nb = len(group)
        tables = np.full((nb, self._blocks_per_slot), sentinel, np.int64)
        dest = np.full((nb, self._blocks_per_slot), sentinel, np.int64)
        for i, (request, slot) in enumerate(zip(group, slots)):
            aliased, priv = reservation[i]
            if aliased:
                tables[i, :aliased] = matches[i].block_ids[:aliased]
            tables[i, aliased:aliased + len(priv)] = priv
            n_written = -(-request.prefill_len // bt)
            dest[i, aliased:n_written] = tables[i, aliased:n_written]
            self._slot_table_host[slot] = tables[i].copy()
            self._slot_priv[slot] = list(priv)
            self._slot_aliased[slot] = aliased
        return tables, dest

    def _blocks_needed(self, request: Request) -> int:
        """Blocks admitting ``request`` now would reserve (the capacity
        probe's price: unpinned, so the reservation checks again)."""
        n_res = -(-FIFOScheduler.decode_extent(request, self.max_len)
                  // self._block_tokens)  # the frontier block counts whole
        if self.prefix_cache is not None and request.cache_prefix:
            n_res -= self.prefix_cache.match_len(request.prompt) // self._block_tokens
        return max(0, n_res)

    def _paged_capacity(self, requests: list[Request]) -> int:
        """Scheduler hook: how many of the front-run requests the pool can
        seat: its free blocks, plus what trie eviction could reclaim
        (optimistic by one race, an evictable block the group's own acquire
        then pins: the reservation checks again and requeues)."""
        avail, n = self._allocator.free_count, 0
        if self.prefix_cache is not None:
            avail += int(self.prefix_cache.memory_stats()["blocks_evictable"])
        for request in requests:
            need = self._blocks_needed(request)
            if need > avail:
                break
            avail -= need
            n += 1
        return n

    # ---------------------------------------------------------------- decode
    @staticmethod
    def _draw(gen: torch.Generator, out: torch.Tensor) -> None:
        """One sampled token's uniform draw: ``out`` (a contiguous
        ``[vocab]`` fp32 tensor) filled from ``gen``. Every draw a stream
        makes (its admission's, each decode iteration's, and a resumed
        stream's fast-forward) goes through this one call on one shape, so
        the generator's state after k draws does not depend on where they
        were made. The values are `models.generation.gumbel_noise`'s
        ``torch.rand`` draw, which is this call on a fresh tensor."""
        out.uniform_(generator=gen)

    def _generator(self, request: Request) -> torch.Generator | None:
        """A sampled request's own generator, seeded from its params and, for
        a resumed stream, fast-forwarded past the draws of its
        ``resume_tokens`` (one ``[vocab]`` draw a token), so its next draw is
        the one the uninterrupted run made; None for a greedy request."""
        if request.params.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device).manual_seed(int(request.params.seed))
        if request.resume_tokens:
            scratch = torch.empty(self._vocab, dtype=torch.float32, device=self.device)
            for _ in request.resume_tokens:
                self._draw(gen, scratch)
        return gen

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, topks: torch.Tensor,
                gens: list[torch.Generator | None]) -> torch.Tensor:
        """Next token per row; sampled rows draw their Gumbel noise from their
        own request's generator, one ``[vocab]`` draw per token."""
        if all(g is None for g in gens):
            return logits.argmax(dim=-1)
        u = torch.full(logits.shape, 0.5, dtype=torch.float32, device=self.device)
        for i, g in enumerate(gens):
            if g is not None:
                self._draw(g, u[i])
        return sample(logits, temps, topks, -torch.log(-torch.log(u)))

    def _fill_uniform(self) -> None:
        """Before each decode dispatch: one ``[vocab]`` uniform draw per
        iteration for every active sampled slot, from the slot's own
        generator in iteration order, which are the draws
        `models.generation.gumbel_noise` makes for one token each. The step
        turns them into Gumbel noise; greedy rows ignore theirs. At depth > 1
        a slot whose finish is not fetched yet draws once more, which its
        stream never sees: its generator is dropped at retirement."""
        for slot in np.flatnonzero(self._active):
            gen = self._slot_gen[slot]
            if gen is not None:
                for t in range(self.tokens_per_sync):
                    self._draw(gen, self._d_uniform[t, slot])

    def _poison_mask(self) -> np.ndarray | None:
        """The ``[b]`` NaN-poison mask of the next decode dispatch: None
        with no active `reliability.FaultInjector` (nothing is uploaded);
        else the injector's ``serving.decode`` point ticks once (so its
        ``at_steps`` index decode dispatches, as in the reference) and names
        the active slots to poison, or None when it names none."""
        injector = active_injector()
        if injector is None:
            return None
        slots = injector.poison_slots()
        if slots is None:
            return None
        mask = np.zeros(self.max_concurrency, bool)
        if slots == ALL_SLOTS:
            mask[self._active] = True
        else:
            for slot in slots:
                if 0 <= slot < self.max_concurrency and self._active[slot]:
                    mask[slot] = True
        return mask if mask.any() else None

    def _stage_poison(self, mask: np.ndarray) -> None:
        """Upload a poison mask into the buffer the step reads, through the
        next pinned ring buffer (``non_blocking``: the host never waits on
        the stream); `step` zeroes the buffer on the stream after the
        dispatch."""
        host = self._poison_ring[self._poison_next]
        self._poison_next = (self._poison_next + 1) % len(self._poison_ring)
        host.numpy()[:] = mask
        self._d_poison.copy_(host, non_blocking=True)
        self.poison_uploads += 1

    @staticmethod
    def _dispatch_fault_point() -> None:
        """The ``serving.dispatch`` fault point, before every dispatch
        (decode steps and admissions): an active injector may stall this
        call (``step_hang``) or raise `reliability.DeviceLostError`
        (``device_error``); otherwise one global load."""
        injector = active_injector()
        if injector is not None:
            injector.dispatch_faults()

    def _stage_drafts(self) -> None:
        """Before a verify dispatch: one ``[b, k]`` draft plane from the
        drafter and the host's view of each greedy slot's stream (prompt +
        fetched tokens), into the next pinned ring buffer and from there
        into the device buffer the verify step reads (``non_blocking``, so
        the host does not wait on the stream). Sampled slots draft nothing:
        they advance one token a dispatch. Unfilled positions stay 0, a
        draft of token 0 that the verifier accepts only if it is greedy's."""
        k, vocab = self.draft_tokens, self.model.config.vocab_size
        host = self._draft_ring[self._draft_next]
        self._draft_next = (self._draft_next + 1) % len(self._draft_ring)
        drafts = host.numpy()
        drafts.fill(0)
        for slot in np.flatnonzero(self._active):
            request, out = self._slot_req[slot], self._slot_out[slot]
            if request.params.temperature > 0:
                continue
            m = 0
            for t in self._drafter.propose(request.prompt, out.tokens):
                t = int(t)
                if m >= k or not 0 <= t < vocab:
                    break  # an out-of-vocab proposal cannot be verified: stop there
                drafts[slot, m] = t
                m += 1
            if m:
                self.metrics.spec_proposed.inc(m)
        self._d_drafts.copy_(host, non_blocking=True)

    def _step_body(self) -> None:
        """The dispatch a decode step runs: the verify step with speculation,
        else ``tokens_per_sync`` plain iterations. On CUDA this is what the
        graph holds."""
        if self.draft_tokens:
            self._spec_step()
        else:
            self._decode_step()

    def _spec_step(self) -> None:
        """One verify step over every slot (the reference's
        ``_build_spec_step_fn``), in place into the fixed buffers:

        - the forward scores ``[token, drafts]`` at positions ``pos ..
          pos + k``; each live row writes ``min(remaining + 1, k + 1)`` KV
          entries (``write_len``), which stay inside its reservation, and a
          frozen row none;
        - position 0 samples as the plain step does (Gumbel noise from the
          slot's draw for sampled rows); positions 1.. are the target's
          greedy choices. A greedy row accepts the longest draft prefix that
          equals those choices and emits it plus one; a sampled row emits its
          one sample. The count is cut at the first EOS and at the budget, so
          finishes land where single steps would put them;
        - position, budget and finished flags advance by what was emitted,
          the token becomes the last emitted, and the write cursor is
          rewound to the accepted frontier: the rejected entries stay past
          it, dead, until the next write lands on them.

        - health over the whole segment: a row with any non-finite logit
          (or poisoned) emits nothing, freezes, and keeps its position (its
          write cursor rewinds to it), for the host to quarantine.

        ``_d_out[:k + 1, :2]`` gets each position's token and finished flag,
        ``_d_out[k + 1, 0]`` each slot's emitted count (0 for a frozen or
        unhealthy row) and ``_d_out[k + 1, 1]`` its health (1 for a frozen
        row)."""
        k = self.draft_tokens
        s = k + 1
        tokens, pos, remaining = self._d_tokens, self._d_pos, self._d_remaining
        live = ~self._d_finished
        seq = torch.cat([tokens[:, None], self._d_drafts], dim=1)  # [b, s]
        write_len = (remaining + 1).clamp(0, s) * live.long()
        paged = {"block_tables": self._d_tables} if self.paged else {}
        logits = self.model(seq, pos, cache=self._cache, write_mask=live, write_len=write_len,
                            **paged)  # [b, s, vocab]
        logits = logits.masked_fill(self._d_poison[:, None, None], float("nan"))
        ok = torch.isfinite(logits).flatten(1).all(dim=1)
        healthy = live & ok
        greedy = logits.argmax(dim=-1)
        noise = -torch.log(-torch.log(self._d_uniform[0]))
        first = sample(logits[:, 0], self._d_temps, self._d_topks, noise)
        out_tokens = torch.cat([first[:, None], greedy[:, 1:]], dim=1)  # [b, s]
        accepted = torch.cumprod((self._d_drafts == greedy[:, :k]).long(), dim=1).sum(dim=1)
        n_cand = torch.where(self._d_temps > 0, torch.ones_like(accepted), accepted + 1)
        hit = (self._eos >= 0) & (out_tokens == self._eos)  # [b, s]
        first_eos = torch.where(hit.any(dim=1), hit.long().argmax(dim=1),
                                torch.full_like(accepted, s))
        n = torch.minimum(n_cand, torch.minimum(remaining.clamp(min=1), first_eos + 1))  # >= 1
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        steps = torch.arange(s, device=tokens.device)[None, :]
        emit = healthy[:, None] & (steps < n[:, None])  # [b, s]
        # a budget can run out only at position n - 1, and an EOS inside the
        # accepted prefix cut n there, so only the last emitted token finishes
        fins = emit & (hit | (remaining[:, None] - (steps + 1) <= 0))
        self._d_out[:s, 0].copy_(out_tokens.T)
        self._d_out[:s, 1].copy_(fins.T)
        self._d_out[s, 0].copy_(torch.where(healthy, n, torch.zeros_like(n)))
        self._d_out[s, 1].copy_(ok | ~live)
        new_pos = torch.where(healthy, pos + n, pos)
        self._d_finished.logical_or_((live & ~ok)
                                     | (healthy & (hit[rows, n - 1] | (remaining - n <= 0))))
        tokens.copy_(torch.where(healthy, out_tokens[rows, n - 1], tokens))
        remaining.sub_(torch.where(healthy, n, torch.zeros_like(n)))
        pos.copy_(new_pos)
        rewind_frontier(self._cache, new_pos)

    def _decode_step(self) -> None:
        """One decode dispatch, ``tokens_per_sync`` iterations over every
        slot: forward, poison (NaN logits for the rows the poison buffer
        marks), health (``ok``: every logit of the row finite), sample,
        freeze finished and unhealthy rows (token, position and budget
        carried; their KV writes dropped from the next iteration on),
        advance, and finish on EOS, budget or health. Every piece of state is
        written in place into the fixed buffers, and iteration ``t``'s
        tokens, finished flags and health (1 for a frozen row) into
        ``_d_out[t]``: on CUDA this is the body of the captured graph."""
        noise = -torch.log(-torch.log(self._d_uniform))
        paged = {"block_tables": self._d_tables} if self.paged else {}
        for t in range(self.tokens_per_sync):
            live = ~self._d_finished
            logits = self.model(self._d_tokens[:, None], self._d_pos, cache=self._cache,
                                write_mask=live, **paged)
            last = logits[:, -1].masked_fill(self._d_poison[:, None], float("nan"))
            ok = torch.isfinite(last).all(dim=-1)
            healthy = live & ok
            nxt = sample(last, self._d_temps, self._d_topks, noise[t])
            nxt = torch.where(healthy, nxt, self._d_tokens)
            self._d_pos.add_(healthy.long())
            self._d_remaining.sub_(healthy.long())
            hit_eos = (self._eos >= 0) & (nxt == self._eos)
            self._d_finished.logical_or_(live & (~ok | hit_eos | (self._d_remaining <= 0)))
            self._d_tokens.copy_(nxt)
            self._d_out[t, 0].copy_(nxt)
            self._d_out[t, 1].copy_(self._d_finished)
            self._d_out[t, 2].copy_(ok | ~live)

    def _capture(self) -> None:
        """Capture `_step_body` (the decode or the verify step) as this
        engine's CUDA graph
        (`models.generation.capture_graph`, with its guards). Every slot is
        still frozen, so the warm-up runs before the capture change nothing
        the engine reads: writes go to the sink block or re-write a frozen
        row's entries, cursors advance by 0, tokens are carried. They also
        build and load the kernel libraries (nvcc at first use) and set the
        kernels' attributes, which must not happen inside a capture. The
        wrappers' launch counts advance while the graph is recorded: the
        difference is what each replay launches."""
        dev = self.device
        t0 = time.perf_counter()
        counters = (paged_decode_attention, nf4_matmul)
        side = _WARMUP_STREAMS.get(dev)
        if side is None:
            side = _WARMUP_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                self._step_body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [fn.launches for fn in counters]
        try:
            graph = capture_graph(self._step_body, dev)
        except RuntimeError as exc:
            raise RuntimeError(f"capturing the decode step as a CUDA graph failed: {exc}") from exc
        self.graph_launches = {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}
        self._graph = graph
        # the warm-up (with any kernel build it triggers) and the capture
        # count as one compile of the decode step
        self.metrics.record_compile(self._step_key, time.perf_counter() - t0)

    # ---------------------------------------------------------------- fetches
    def _fetch(self, kind: str, out: torch.Tensor, slots: tuple[int, ...],
               epochs: tuple[int, ...], staging: Any = None) -> _Inflight:
        """Queue the copy of ``out`` into the next host ring buffer behind the
        work that produces it, then an event; the host reads it once the
        event has passed. The device reuses ``_d_out`` only after this copy,
        by stream order."""
        host = self._fetch_ring[self._ring_next][:out.numel()].view(out.shape)
        self._ring_next = (self._ring_next + 1) % len(self._fetch_ring)
        host.copy_(out, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Inflight(kind, host, slots, epochs, event, staging)

    def _reap_ready(self, finished: list[RequestOutput]) -> None:
        """Process, without blocking, the in-flight results the device has
        already finished, oldest first. A finished slot that waits to be
        fetched costs a frozen decode row per step, so reaping eagerly keeps
        occupancy at the synchronous level; lag remains only while the
        device is still busy, which is when overlap pays."""
        while self._inflight and (self._inflight[0].event is None
                                  or self._inflight[0].event.query()):
            self._process_oldest(finished)

    def _drain_to(self, limit: int, finished: list[RequestOutput]) -> None:
        """Block on the oldest in-flight results until at most ``limit``
        dispatches remain in flight (0 = synchronous)."""
        while len(self._inflight) > limit:
            self._process_oldest(finished)

    def _process_oldest(self, finished: list[RequestOutput]) -> None:
        entry = self._inflight.popleft()
        tm = self._timings
        journal = self.journal
        t0 = time.perf_counter()
        if entry.event is not None:
            entry.event.synchronize()
        fetched = entry.host.numpy().copy()
        blocked = time.perf_counter() - t0
        tm.fetch_blocked_s += blocked
        self.metrics.host_blocked_s.observe(blocked)
        j0 = journal.append_s if journal is not None else 0.0
        now = time.perf_counter()
        if entry.kind == "admit":
            self._process_admit(entry, fetched, now, finished)
        elif entry.kind == "spec":
            self._process_spec(entry, fetched, now, finished)
        else:
            self._process_step(entry, fetched, now, finished)
        j1 = journal.append_s if journal is not None else 0.0
        deliver = max(0.0, (time.perf_counter() - now) - (j1 - j0))
        tm.deliver_s += deliver
        if self.tracer.enabled:
            # emitted after delivery, so the fetch carries its own host cost
            extra = ({"accepted": int(np.max(fetched[self.draft_tokens + 1, 0]))}
                     if entry.kind == "spec" else {})
            self.tracer.emit(EV_FETCH, None, seq=entry.seq, what=entry.kind,
                             blocked_s=round(blocked, 6), depth=len(self._inflight),
                             tokens=entry.tokens,
                             phases={"blocked_s": round(blocked, 6),
                                     "deliver_s": round(deliver, 6),
                                     "journal_s": round(j1 - j0, 6)}, **extra)

    def _live(self, slot: int, epoch: int) -> bool:
        """The slot still holds the tenant a result was dispatched for."""
        return self._slot_epoch[slot] == epoch and self._slot_out[slot] is not None

    def _poisoned(self, healthy: Any, token: int) -> bool:
        """A result the host must not deliver: the step's health flag is
        down, or the token lies outside ``[0, vocab)``."""
        return not healthy or not 0 <= token < self._vocab

    def _process_admit(self, entry: _Inflight, fetched: np.ndarray, now: float,
                       finished: list[RequestOutput]) -> None:
        poisoned_any = False
        for i, (slot, epoch) in enumerate(zip(entry.slots, entry.epochs)):
            if not self._live(slot, epoch):
                continue  # cancelled while the prefill was in flight
            token = int(fetched[0, i])
            if self._poisoned(fetched[2, i], token):
                poisoned_any = True
                self._quarantine(slot, now, finished)
                continue
            out = self._slot_out[slot]
            out.first_token_time = now
            ttft = max(0.0, now - out.arrival_time)
            self.metrics.ttft_s.observe(ttft)
            if self.prefix_cache is not None and self._slot_req[slot].cache_prefix:
                (self.metrics.ttft_hit_s if self._slot_hit[slot]
                 else self.metrics.ttft_miss_s).observe(ttft)
            self._deliver(slot, token, bool(fetched[1, i]), now, finished, first=True)
        if poisoned_any:
            self.metrics.steps_poisoned.inc()

    def _process_step(self, entry: _Inflight, fetched: np.ndarray, now: float,
                      finished: list[RequestOutput]) -> None:
        tokens, fins, oks = fetched[:, 0], fetched[:, 1], fetched[:, 2]  # [k, b] each
        k = tokens.shape[0]
        # one fetch lands up to k tokens per slot at once: the gap since the
        # slot's last token is split evenly over the tokens this entry
        # appends for it (up to its finish or its first unhealthy iteration),
        # so ITL stays per token
        gaps: dict[int, float] = {}
        for slot, epoch in zip(entry.slots, entry.epochs):
            if self._live(slot, epoch):
                n = 0
                for t in range(k):
                    if self._poisoned(oks[t, slot], int(tokens[t, slot])):
                        break
                    n += 1
                    if fins[t, slot]:
                        break
                gaps[slot] = (now - self._slot_last_token_t[slot]) / max(1, n)
        appended = 0
        poisoned_any = False
        # iteration outer, slot inner: token t of every slot retires before
        # token t + 1 of any slot, the order of k single-token dispatches
        for t in range(k):
            for slot, epoch in zip(entry.slots, entry.epochs):
                if not self._live(slot, epoch):
                    continue  # retired, cancelled, quarantined or reseated, mid-scan too
                token = int(tokens[t, slot])
                if self._poisoned(oks[t, slot], token):
                    poisoned_any = True
                    self._quarantine(slot, now, finished)
                    continue
                self._observe_gap(slot, gaps[slot])
                self._deliver(slot, token, bool(fins[t, slot]), now, finished)
                appended += 1
        if appended:
            self.metrics.tokens_per_dispatch.observe(appended)
        if poisoned_any:
            self.metrics.steps_poisoned.inc()

    def _process_spec(self, entry: _Inflight, fetched: np.ndarray, now: float,
                      finished: list[RequestOutput]) -> None:
        """A verify step's fetch: slot ``i`` appends its ``ns[i]`` tokens
        (0 for a frozen row), position outer and slot inner as in
        `_process_step`, so retirement order is what ``ns`` single steps
        would give; an unhealthy slot is quarantined once. Each greedy
        slot's accepted draft length (``ns - 1``) feeds ``spec_accepted``
        and ``spec_accept_len``."""
        s = self.draft_tokens + 1
        tokens, fins = fetched[:s, 0], fetched[:s, 1]
        ns, oks = fetched[s, 0], fetched[s, 1]
        gaps: dict[int, float] = {}
        for slot, epoch in zip(entry.slots, entry.epochs):
            if not self._live(slot, epoch):
                continue
            n = int(ns[slot])
            gaps[slot] = (now - self._slot_last_token_t[slot]) / max(1, n)
            if oks[slot] and n and self._slot_req[slot].params.temperature <= 0:
                self.metrics.spec_accepted.inc(n - 1)
                self.metrics.spec_accept_len.observe(n - 1)
        appended = 0
        poisoned_any = False
        for t in range(s):
            for slot, epoch in zip(entry.slots, entry.epochs):
                if not self._live(slot, epoch):
                    continue  # retired, cancelled, quarantined or reseated mid-walk
                if not oks[slot]:
                    poisoned_any = True
                    self._quarantine(slot, now, finished)
                    continue
                if t >= int(ns[slot]):
                    continue
                token = int(tokens[t, slot])
                if self._poisoned(True, token):
                    poisoned_any = True
                    self._quarantine(slot, now, finished)
                    continue
                self._observe_gap(slot, gaps[slot])
                self._deliver(slot, token, bool(fins[t, slot]), now, finished)
                appended += 1
        if appended:
            self.metrics.tokens_per_dispatch.observe(appended)
            self.metrics.spec_tokens.inc(appended)
        if poisoned_any:
            self.metrics.steps_poisoned.inc()

    def _observe_gap(self, slot: int, gap: float) -> None:
        """One decode token's inter-token gap: into the ITL histogram, and
        into the slot's own gaps while its SLO bounds ITL."""
        self.metrics.inter_token_s.observe(gap)
        if self._slot_itl[slot] is not None:
            self._slot_itl[slot].append(gap)

    def _deliver(self, slot: int, token: int, done: bool, now: float,
                 finished: list[RequestOutput], first: bool = False) -> None:
        """Append one token to a slot's stream and journal it: FIRST_TOKEN
        for an admission's token (``first``), PROGRESS every
        ``progress_every`` tokens otherwise; retire the slot if ``done``."""
        out = self._slot_out[slot]
        out.tokens.append(token)
        self.metrics.tokens_generated.inc()
        self._slot_last_token_t[slot] = now
        journal = self.journal
        if journal is not None:
            if first:
                journal.log_first_token(out.request_id, token, len(out.tokens))
                self._slot_logged[slot] = len(out.tokens)
            elif len(out.tokens) - self._slot_logged[slot] >= journal.progress_every:
                journal.log_progress(out.request_id, out.tokens[self._slot_logged[slot]:],
                                     len(out.tokens))
                self._slot_logged[slot] = len(out.tokens)
        if done:
            reason = FINISH_EOS if token == self._eos else FINISH_LENGTH
            self._retire(slot, reason, now, finished)

    def _quarantine(self, slot: int, now: float, finished: list[RequestOutput]) -> None:
        """The health flag's action on a poisoned slot, and on it alone (the
        device already froze it, so no lagged dispatch writes through it
        further). First offence: release the slot and requeue the request at
        the front, to re-prefill from its prompt with its generator reseeded
        (the replay is token for token an unpoisoned run). Second offence:
        retire it with `FINISH_ERROR`, partial tokens kept."""
        request = self._slot_req[slot]
        if self.tracer.enabled:
            self.tracer.emit(EV_QUARANTINE, request.request_id, slot=slot,
                             gen=int(self._slot_epoch[slot]), retry=request.retries,
                             depth=len(self._inflight))
        if request.retries == 0:
            request.retries += 1
            self.metrics.requests_retried.inc()
            self._release_slot(slot)
            self.scheduler.requeue(request)
        else:
            self._retire(slot, FINISH_ERROR, now, finished)

    # ------------------------------------------------------------ retirement
    def _slo_never_served(self, request: Request) -> None:
        """SLO bookkeeping for an accepted request that ends without being
        admitted (deadline expiry, a queued cancel or abort): a miss for its
        class, its TTFT bound (if any) certainly blown."""
        if request.slo is not None:
            self.metrics.observe_slo(request.slo, clean=False,
                                     ttft_ok=request.slo.ttft_s is None, itl_ok=True, tokens=0)

    @staticmethod
    def _slo_trace_attrs(slo: Any, attained: bool = False) -> dict[str, Any]:
        """SLO class and verdict for a terminal trace event; empty for a
        request without an SLO, whose terminal keeps the plain schema."""
        if slo is None:
            return {}
        return {"slo": slo.name, "attained": bool(attained)}

    def _retire(self, slot: int, reason: str, now: float,
                finished: list[RequestOutput]) -> None:
        out = self._slot_out[slot]
        request = self._slot_req[slot]
        out.finish_reason = reason
        out.finish_time = now
        if out.arrival_time is not None:
            self.metrics.request_latency_s.observe(max(0.0, now - out.arrival_time))
        self.metrics.requests_finished.inc()
        # SLO attainment on clean finishes only: the TTFT bound is judged on
        # the host-observed first-token latency, the ITL bound on this
        # request's own p99 decode gap (nearest rank, as the histograms)
        slo = request.slo
        ttft_ok = itl_ok = True
        if slo is not None:
            if slo.ttft_s is not None:
                ttft_ok = (out.first_token_time is not None and out.arrival_time is not None
                           and out.first_token_time - out.arrival_time <= slo.ttft_s)
            gaps = self._slot_itl[slot]
            if slo.itl_p99_s is not None and gaps:
                itl_ok = nearest_rank(sorted(gaps), 0.99) <= slo.itl_p99_s
        attained = self.metrics.observe_slo(
            slo, clean=reason in (FINISH_EOS, FINISH_LENGTH), ttft_ok=ttft_ok, itl_ok=itl_ok,
            tokens=len(out.tokens) - len(request.resume_tokens))
        if self.tracer.enabled:
            self.tracer.emit(EV_FINISH, out.request_id, slot=slot,
                             gen=int(self._slot_epoch[slot]), reason=reason,
                             tokens=len(out.tokens), depth=len(self._inflight),
                             **self._slo_trace_attrs(slo, attained))
        if self.journal is not None:
            # the terminal record carries the whole stream
            self.journal.log_finish(out.request_id, reason, out.tokens)
        # a poisoned stream donates nothing; nor does a resumed one, whose
        # prompt rows came from a continuation prefill in a larger bucket
        # than a cold prefill of the prompt would use
        if (self.prefix_cache is not None and request.cache_prefix and reason != FINISH_ERROR
                and not request.resume_tokens):
            self._donate(slot, request.prompt)
        self._release_slot(slot)
        finished.append(out)

    def _donate(self, slot: int, prompt: list[int]) -> None:
        """Give a retiring slot's prompt KV to the prefix cache. Safe under
        pipelining: decode writes land at or past the prompt's end and a
        finished slot is frozen on the device, so the prompt region is the
        admission's prefill whenever this runs, and the copy (slot mode) is
        ordered on the stream after that prefill. Paged, ownership of the
        prompt's full blocks moves to the trie (``adopt``; a duplicate goes
        back to the allocator, the aliased prefix stays the trie's); a block
        at or past the frontier, which decode wrote or a lagged dispatch may
        still write, is never adopted: `_release_slot` frees it once the
        table row is parked."""
        if not self.paged:
            self.prefix_cache.insert(prompt, self._cache, slot)
            return
        n_full = len(prompt) // self._block_tokens
        if n_full:
            aliased = int(self._slot_aliased[slot])
            self.prefix_cache.adopt(prompt, [int(x) for x in self._slot_table_host[slot][:n_full]],
                                    owned_from=aliased)
            self._slot_priv[slot] = self._slot_priv[slot][max(0, n_full - aliased):]

    def _release_slot(self, slot: int) -> None:
        """Return a slot (and, paged, its own blocks; the pins of its prefix
        match are dropped). A paged table row is parked
        at the sentinel ``num_blocks`` so any later write through it is
        dropped; the slot is marked finished (frozen) until the next
        admission, and the generation bump drops its results still in
        flight. Steps dispatched before these writes may still write through
        the old row: they run before any later admission's prefill scatter
        into the freed blocks or row, by stream order."""
        if self._slot_match[slot] is not None:
            self.prefix_cache.release(self._slot_match[slot])
        self._slot_match[slot] = None
        self._slot_hit[slot] = False
        self._slot_itl[slot] = None
        if self.paged:
            self._allocator.free(self._slot_priv[slot])
            self._slot_priv[slot] = []
            self._slot_table_host[slot] = None
            self._slot_aliased[slot] = 0
            self._d_tables[slot] = self._allocator.num_blocks
        self._d_finished[slot] = True
        self._slot_out[slot] = None
        self._slot_req[slot] = None
        self._slot_gen[slot] = None
        self._slot_logged[slot] = 0
        self._active[slot] = False
        self._slot_epoch[slot] += 1
        self._free.append(slot)
