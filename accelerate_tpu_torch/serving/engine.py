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

Quantized serving, as the reference's: ``weight_quant=`` (`WeightQuantConfig`,
``"int8"`` or ``"nf4"``) quantizes the model's weights once at load into a
copy of the model (`utils.quantization.quantize_module`; the caller's model
is not changed) whose nf4 projections run through the CUDA kernel
`ops.nf4_matmul.nf4_matmul`, in either mode; the config's
``kv_cache_dtype=torch.int8`` stores the slot rows or the paged pool as int8
with fp32 scale planes, which the paged fused path hands to the
paged-decode kernel. `ServingEngine.quant_stats` reports both.

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
import time
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

from ..models.generation import capture_graph, gumbel_noise, sample
from ..models.kv_cache import (
    BlockAllocator,
    SlotKVCache,
    kv_store_dtype,
    make_block_pool,
    make_cache,
    scatter_cache_slots,
    scatter_rows_to_blocks,
)
from ..ops.flash_attention import paged_decode_attention
from ..ops.nf4_matmul import nf4_matmul, plane_pack, routes_to_kernel
from ..utils.environment import resolve_device
from ..utils.quantization import (
    QuantizationConfig,
    QuantizedLinear,
    quantize_module,
    quantized_nbytes,
)
from .metrics import ServingMetrics
from .request import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_LENGTH,
    REJECT_QUEUE_FULL,
    Request,
    RequestOutput,
    SamplingParams,
    SubmitResult,
)
from .scheduler import FIFOScheduler


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
class _Inflight:
    """One dispatched, not yet fetched piece of device work: an admission's
    ``[2, nb]`` first tokens and finished flags, or a decode step's ``[k, 2,
    b]`` plane. ``host`` is the pinned buffer its copy lands in, ``event``
    the CUDA event recorded after that copy (None on the CPU, where the copy
    is done at dispatch). ``slots``/``epochs`` pin each result to the slot
    generation it was dispatched against, so a result that outlived a
    retirement or cancel is dropped instead of reaching the slot's next
    tenant. ``staging`` keeps an admission's pinned upload buffers alive
    until the entry is fetched, which is after their copies ran."""

    kind: str  # "step" | "admit"
    host: torch.Tensor
    slots: tuple[int, ...]
    epochs: tuple[int, ...]
    event: Any = None
    staging: Any = None


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
    are the reference engine's."""

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
        self.metrics = ServingMetrics()

        b, dev, k = self.max_concurrency, self.device, self.tokens_per_sync
        if self.paged:
            self._cache = make_block_pool(cfg.n_layer, b, n_blocks, bt, cfg.n_head, cfg.head_dim,
                                          kv_store_dtype(cfg), dev, attention=self.paged_attention)
        else:
            self._cache = make_cache(model, b)
        # device-resident per-slot state; empty slots stay finished (frozen).
        # The decode step updates these buffers in place, and on CUDA its
        # graph holds their addresses: they are never rebound
        self._d_tokens = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_pos = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_remaining = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_finished = torch.ones(b, dtype=torch.bool, device=dev)
        self._d_temps = torch.zeros(b, dtype=torch.float32, device=dev)
        self._d_topks = torch.zeros(b, dtype=torch.long, device=dev)
        # paged: the block tables, the only indirection decode follows
        self._d_tables = (torch.full((b, self._blocks_per_slot), n_blocks, dtype=torch.int32,
                                     device=dev) if self.paged else None)
        # the step's inputs and outputs: uniform draws for the Gumbel noise
        # of sampled slots, one [vocab] row per iteration and slot, and the
        # tokens and finished flags of each iteration
        self._d_uniform = torch.zeros((k, b, cfg.vocab_size), dtype=torch.float32, device=dev)
        self._d_out = torch.zeros((k, 2, b), dtype=torch.long, device=dev)
        self._eos = -1 if eos_token_id is None else int(eos_token_id)
        # host-side slot bookkeeping
        self._active = np.zeros(b, bool)
        self._slot_out: list[RequestOutput | None] = [None] * b
        self._slot_gen: list[torch.Generator | None] = [None] * b  # sampled slots only
        # the reference's slot generation: bumped at admission and release,
        # so lagged results of an earlier tenant are recognised and dropped
        self._slot_epoch = np.zeros(b, np.int64)
        self._slot_last_token_t = [0.0] * b
        self._slot_priv: list[list[int]] = [[] for _ in range(b)]
        self._free: deque[int] = deque(range(b))
        self._next_id = 0
        self._inflight: deque[_Inflight] = deque()
        # one host buffer per dispatch in flight: every dispatch drains to
        # pipeline_depth - 1 in flight, so pipeline_depth + 1 buffers never
        # hand out one whose entry is still unfetched
        pinned = dev.type == "cuda"
        self._fetch_ring = [torch.empty(k * 2 * b, dtype=torch.long, pin_memory=pinned)
                            for _ in range(self.pipeline_depth + 1)]
        self._ring_next = 0
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
        blocks: a full queue or an oversized prompt returns a rejection with
        a reason code instead."""
        if not isinstance(request, Request):
            request = Request(prompt=list(request), params=params or SamplingParams())
        request.request_id = self._next_id
        self._next_id += 1
        if request.arrival_time is None:
            request.arrival_time = time.perf_counter()
        self.metrics.mark_start()
        result = self.scheduler.submit(request)
        if result.accepted:
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

    # ------------------------------------------------------------ engine loop
    def step(self) -> list[RequestOutput]:
        """Fetch the results the device has finished, admit into free slots,
        dispatch one decode step (``tokens_per_sync`` iterations) for every
        slot, fetch results lagging by up to ``pipeline_depth`` dispatches,
        and return the requests whose completion was observed during this
        call (at depth > 1 a finish surfaces when its fetch lands, up to
        ``pipeline_depth - 1`` calls after the device produced it)."""
        finished: list[RequestOutput] = []
        self._reap_ready(finished)
        self._admit_pending(finished)
        self.metrics.steps.inc()
        if self._active.any():
            self._fill_uniform()
            if self._graph is not None:
                self._graph.replay()
            else:
                with torch.no_grad():
                    self._decode_step()
            self.metrics.decode_dispatches.inc()
            self.metrics.decode_steps.inc(self.tokens_per_sync)
            self.metrics.dispatch_depth.observe(len(self._inflight) + 1)
            self._inflight.append(self._fetch(
                "step", self._d_out, tuple(range(self.max_concurrency)),
                tuple(int(e) for e in self._slot_epoch)))
            self._drain_to(self.pipeline_depth - 1, finished)
        if not self._active.any():
            # nothing left to overlap with: flush the lagged tail so every
            # finish is returned before the caller sees has_work False
            self._drain_to(0, finished)
        return finished

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

    def abort_all(self) -> list[RequestOutput]:
        """Retire every active slot and drop every queued request with
        `FINISH_ABORTED` (partial tokens kept). In-flight results are
        dropped unfetched."""
        now = time.perf_counter()
        aborted: list[RequestOutput] = []
        for slot in np.flatnonzero(self._active):
            self.metrics.requests_cancelled.inc()
            self._retire(int(slot), FINISH_ABORTED, now, aborted)
        for req in self.scheduler.drain_queue():
            self.metrics.requests_cancelled.inc()
            aborted.append(RequestOutput(
                request_id=req.request_id, prompt_len=len(req.prompt), tokens=[],
                finish_reason=FINISH_ABORTED, arrival_time=req.arrival_time, finish_time=now))
        self._inflight.clear()  # every entry now predates a generation bump
        return aborted

    # ------------------------------------------------------------- admission
    def _admit_pending(self, finished: list[RequestOutput]) -> None:
        while self._free:
            run_len = self.scheduler.peek_run(min(len(self._free), self._admit_sizes[-1]))
            if run_len == 0:
                return
            nb = max(s for s in self._admit_sizes if s <= run_len)
            if not self._admit_group(self.scheduler.pop_run(nb), finished):
                return  # block-pool backpressure: group requeued

    def _admit_group(self, group: list[Request], finished: list[RequestOutput]) -> bool:
        """Prefill one same-bucket group, sample its first tokens and seat it
        in free slots. False (group requeued) when the paged pool is
        short."""
        reservation = None
        if self.paged:
            reservation = self._reserve_blocks(group)
            if reservation is None:
                return False
        nb = len(group)
        slots = [self._free.popleft() for _ in group]
        bucket = self.scheduler.bucket_for(max(r.prefill_len for r in group))
        padded = np.zeros((nb, bucket), np.int64)
        lens = np.zeros(nb, np.int64)
        budgets = np.zeros(nb, np.int64)
        for i, request in enumerate(group):
            plen = len(request.prompt)
            padded[i, :plen] = request.prompt
            lens[i] = plen
            # the context is fixed-size: cap generation so cache writes stay
            # inside [0, n_positions)
            budgets[i] = min(int(request.params.max_new_tokens), self.max_len - plen)
        dev = self.device
        gens = [torch.Generator(device=dev).manual_seed(int(r.params.seed))
                if r.params.temperature > 0 else None for r in group]
        arrays = [padded, np.asarray(slots, np.int64), lens, budgets,
                  np.asarray([r.params.temperature for r in group], np.float32),
                  np.asarray([r.params.top_k or 0 for r in group], np.int64)]
        if self.paged:
            tables, dest = self._commit_reservation(reservation, group, slots)
            n_written = -(-bucket // self._block_tokens)
            arrays += [tables, np.ascontiguousarray(dest[:, :n_written])]
        staging, views = self._upload(*arrays)
        ids, slots_t, lens_t, budgets_t, temps, topks = views[:6]
        with torch.no_grad():
            kv: list = []
            hidden = self.model(ids, kv_out=kv, return_hidden=True)
            last = self.model.logits(hidden[torch.arange(nb, device=dev), lens_t - 1])
            first = self._sample(last, temps, topks, gens)
            if self.paged:
                tables_t, dest_t = views[6:]
                scatter_rows_to_blocks(self._cache, kv, slots_t, dest_t, lens_t.to(torch.int32))
                self._d_tables[slots_t] = tables_t
            else:
                scatter_cache_slots(self._cache, SlotKVCache.from_rows(kv, lens_t), slots_t,
                                    lens_t)
            rem0 = budgets_t - 1
            fin0 = (rem0 <= 0) | ((self._eos >= 0) & (first == self._eos))
            self._d_tokens[slots_t] = first
            self._d_pos[slots_t] = lens_t
            self._d_remaining[slots_t] = rem0
            self._d_finished[slots_t] = fin0
            self._d_temps[slots_t] = temps
            self._d_topks[slots_t] = topks
            out = torch.stack([first, fin0.long()])
        epochs = []
        for i, (slot, request) in enumerate(zip(slots, group)):
            self._slot_epoch[slot] += 1
            epochs.append(int(self._slot_epoch[slot]))
            self._active[slot] = True
            self._slot_gen[slot] = gens[i]
            self._slot_out[slot] = RequestOutput(
                request_id=request.request_id, prompt_len=len(request.prompt), tokens=[],
                finish_reason="", arrival_time=request.arrival_time)
        self.metrics.admit_batch_size.observe(nb)
        self._inflight.append(self._fetch("admit", out, tuple(slots), tuple(epochs),
                                          staging=staging))
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

    def _reserve_blocks(self, group: list[Request]) -> list[list[int]] | None:
        """All-or-nothing block reservation for one admission group: each
        request needs blocks covering ``min(prompt + max_new_tokens,
        max_len)`` tokens, reserved up front. On shortfall the group goes back
        to the queue front in its original order and None is returned."""
        needs = [self._blocks_needed(r) for r in group]
        if self._allocator.free_count < sum(needs):
            for request in reversed(group):
                self.scheduler.requeue(request)
            return None
        return [self._allocator.alloc(n) or [] for n in needs]

    def _commit_reservation(self, reservation: list[list[int]], group: list[Request],
                            slots: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """The admission's table rows (the slot's blocks, sentinel past them)
        and scatter destinations (only the blocks the prefill writes:
        ``[0, ceil(prefill_len / block_tokens))``; reserved decode blocks are
        filled in place by decode before anything reads them)."""
        bt, sentinel = self._block_tokens, self._allocator.num_blocks
        nb = len(group)
        tables = np.full((nb, self._blocks_per_slot), sentinel, np.int32)
        dest = np.full((nb, self._blocks_per_slot), sentinel, np.int64)
        for i, (request, slot, priv) in enumerate(zip(group, slots, reservation)):
            tables[i, :len(priv)] = priv
            n_written = -(-request.prefill_len // bt)
            dest[i, :n_written] = tables[i, :n_written]
            self._slot_priv[slot] = list(priv)
        return tables, dest

    def _blocks_needed(self, request: Request) -> int:
        extent = FIFOScheduler.decode_extent(request, self.max_len)
        return -(-extent // self._block_tokens)  # the frontier block counts whole

    def _paged_capacity(self, requests: list[Request]) -> int:
        """Scheduler hook: how many of the front-run requests the pool's free
        blocks can seat."""
        avail, n = self._allocator.free_count, 0
        for request in requests:
            need = self._blocks_needed(request)
            if need > avail:
                break
            avail -= need
            n += 1
        return n

    # ---------------------------------------------------------------- decode
    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, topks: torch.Tensor,
                gens: list[torch.Generator | None]) -> torch.Tensor:
        """Next token per row; sampled rows draw their Gumbel noise from their
        own request's generator, one ``[1, vocab]`` draw per token."""
        if all(g is None for g in gens):
            return logits.argmax(dim=-1)
        noise = torch.zeros_like(logits, dtype=torch.float32)
        for i, g in enumerate(gens):
            if g is not None:
                noise[i] = gumbel_noise((1, logits.shape[-1]), g, self.device)[0]
        return sample(logits, temps, topks, noise)

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
                    self._d_uniform[t, slot].uniform_(generator=gen)

    def _decode_step(self) -> None:
        """One decode dispatch, ``tokens_per_sync`` iterations over every
        slot: forward, sample, freeze finished rows (token, position and
        budget carried; their KV writes dropped), advance, and finish on EOS
        or budget. Every piece of state is written in place into the fixed
        buffers, and iteration ``t``'s tokens and finished flags into
        ``_d_out[t]``: on CUDA this is the body of the captured graph."""
        noise = -torch.log(-torch.log(self._d_uniform))
        paged = {"block_tables": self._d_tables} if self.paged else {}
        for t in range(self.tokens_per_sync):
            live = ~self._d_finished
            logits = self.model(self._d_tokens[:, None], self._d_pos, cache=self._cache,
                                write_mask=live, **paged)
            nxt = sample(logits[:, -1], self._d_temps, self._d_topks, noise[t])
            nxt = torch.where(live, nxt, self._d_tokens)
            self._d_pos.add_(live.long())
            self._d_remaining.sub_(live.long())
            hit_eos = (self._eos >= 0) & (nxt == self._eos)
            self._d_finished.logical_or_(live & (hit_eos | (self._d_remaining <= 0)))
            self._d_tokens.copy_(nxt)
            self._d_out[t, 0].copy_(nxt)
            self._d_out[t, 1].copy_(self._d_finished)

    def _capture(self) -> None:
        """Capture `_decode_step` as this engine's CUDA graph
        (`models.generation.capture_graph`, with its guards). Every slot is
        still frozen, so the warm-up runs before the capture change nothing
        the engine reads: writes go to the sink block or re-write a frozen
        row's entries, cursors advance by 0, tokens are carried. They also
        build and load the kernel libraries (nvcc at first use) and set the
        kernels' attributes, which must not happen inside a capture. The
        wrappers' launch counts advance while the graph is recorded: the
        difference is what each replay launches."""
        dev = self.device
        counters = (paged_decode_attention, nf4_matmul)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                self._decode_step()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [fn.launches for fn in counters]
        try:
            graph = capture_graph(self._decode_step, dev)
        except RuntimeError as exc:
            raise RuntimeError(f"capturing the decode step as a CUDA graph failed: {exc}") from exc
        self.graph_launches = {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}
        self._graph = graph

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
        t0 = time.perf_counter()
        if entry.event is not None:
            entry.event.synchronize()
        fetched = entry.host.numpy().copy()
        self.metrics.host_blocked_s.observe(time.perf_counter() - t0)
        now = time.perf_counter()
        if entry.kind == "admit":
            self._process_admit(entry, fetched, now, finished)
        else:
            self._process_step(entry, fetched, now, finished)

    def _live(self, slot: int, epoch: int) -> bool:
        """The slot still holds the tenant a result was dispatched for."""
        return self._slot_epoch[slot] == epoch and self._slot_out[slot] is not None

    def _process_admit(self, entry: _Inflight, fetched: np.ndarray, now: float,
                       finished: list[RequestOutput]) -> None:
        for i, (slot, epoch) in enumerate(zip(entry.slots, entry.epochs)):
            if not self._live(slot, epoch):
                continue  # cancelled while the prefill was in flight
            out = self._slot_out[slot]
            out.first_token_time = now
            self.metrics.ttft_s.observe(max(0.0, now - out.arrival_time))
            self._deliver(slot, int(fetched[0, i]), bool(fetched[1, i]), now, finished)

    def _process_step(self, entry: _Inflight, fetched: np.ndarray, now: float,
                      finished: list[RequestOutput]) -> None:
        tokens, fins = fetched[:, 0], fetched[:, 1]  # [k, b] each
        k = tokens.shape[0]
        # one fetch lands up to k tokens per slot at once: the gap since the
        # slot's last token is split evenly over the tokens this entry
        # appends for it (up to its finish), so ITL stays per token
        gaps: dict[int, float] = {}
        for slot, epoch in zip(entry.slots, entry.epochs):
            if self._live(slot, epoch):
                n = next((t + 1 for t in range(k) if fins[t, slot]), k)
                gaps[slot] = (now - self._slot_last_token_t[slot]) / n
        appended = 0
        # iteration outer, slot inner: token t of every slot retires before
        # token t + 1 of any slot, the order of k single-token dispatches
        for t in range(k):
            for slot, epoch in zip(entry.slots, entry.epochs):
                if not self._live(slot, epoch):
                    continue  # retired, cancelled or reseated, mid-scan too
                self.metrics.inter_token_s.observe(gaps[slot])
                self._deliver(slot, int(tokens[t, slot]), bool(fins[t, slot]), now, finished)
                appended += 1
        if appended:
            self.metrics.tokens_per_dispatch.observe(appended)

    def _deliver(self, slot: int, token: int, done: bool, now: float,
                 finished: list[RequestOutput]) -> None:
        self._slot_out[slot].tokens.append(token)
        self.metrics.tokens_generated.inc()
        self._slot_last_token_t[slot] = now
        if done:
            reason = FINISH_EOS if token == self._eos else FINISH_LENGTH
            self._retire(slot, reason, now, finished)

    # ------------------------------------------------------------ retirement
    def _retire(self, slot: int, reason: str, now: float,
                finished: list[RequestOutput]) -> None:
        out = self._slot_out[slot]
        out.finish_reason = reason
        out.finish_time = now
        self.metrics.requests_finished.inc()
        self._release_slot(slot)
        finished.append(out)

    def _release_slot(self, slot: int) -> None:
        """Return a slot (and, paged, its blocks). A paged table row is parked
        at the sentinel ``num_blocks`` so any later write through it is
        dropped; the slot is marked finished (frozen) until the next
        admission, and the generation bump drops its results still in
        flight. Steps dispatched before these writes may still write through
        the old row: they run before any later admission's prefill scatter
        into the freed blocks or row, by stream order."""
        if self.paged:
            self._allocator.free(self._slot_priv[slot])
            self._slot_priv[slot] = []
            self._d_tables[slot] = self._allocator.num_blocks
        self._d_finished[slot] = True
        self._slot_out[slot] = None
        self._slot_gen[slot] = None
        self._active[slot] = False
        self._slot_epoch[slot] += 1
        self._free.append(slot)
