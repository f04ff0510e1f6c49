"""Continuous-batching serving engine over a paged KV pool: the port of
`accelerate_tpu.serving.engine` ``ServingEngine`` in its paged mode.

Independent requests share one decode step over a fixed set of
``max_concurrency`` slots:

  - KV lives only in a shared per-layer block pool
    (`models.kv_cache.PagedKVCache`); each slot's block table says where its
    tokens sit. Admission reserves every block a request can ever need
    (prompt + budget, capped at the context) up front, all or nothing, so a
    decode write never finds the pool empty; a group that does not fit goes
    back to the queue front (backpressure, never a crash);
  - admission prefills up to ``admit_batch`` queued requests of one prompt
    bucket in one causal forward, samples their first tokens, and scatters
    their K/V into the reserved blocks (`kv_cache.scatter_rows_to_blocks`);
  - `step` decodes every slot in one forward. With ``paged_attention=
    "fused"`` (the default) every layer's attention reads the pool in place
    through the CUDA kernel `ops.flash_attention.paged_decode_attention`;
    ``"gather"`` runs the plain path over the gathered view, the parity
    oracle;
  - per-slot decode state (last token, position, remaining budget, finished
    mask, block tables, sampling settings) stays on the device between
    steps, as in the reference. A finished slot is frozen inside the step
    (its KV write is dropped, its token and position carried). The host
    fetches one ``[2, b]`` tensor per step: the sampled tokens and the
    finished mask.

Retirement (EOS, token budget, context limit) frees the slot's blocks and
parks its table row at the sentinel id ``num_blocks``, so any later write
through it is dropped. Dispatch is synchronous (``pipeline_depth=1``).

Quantized serving, as the reference's: ``weight_quant=`` (`WeightQuantConfig`,
``"int8"`` or ``"nf4"``) quantizes the model's weights once at load into a
copy of the model (`utils.quantization.quantize_module`; the caller's model
is not changed) whose nf4 projections run through the CUDA kernel
`ops.nf4_matmul.nf4_matmul`; the config's ``kv_cache_dtype=torch.int8``
stores the paged pool as int8 with fp32 scale planes, which the fused path
hands to the paged-decode kernel. `ServingEngine.quant_stats` reports both.

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

from ..models.generation import gumbel_noise, sample
from ..models.kv_cache import (
    BlockAllocator,
    kv_store_dtype,
    make_block_pool,
    scatter_rows_to_blocks,
)
from ..ops.nf4_matmul import plane_pack, routes_to_kernel
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


class ServingEngine:
    """Request-level continuous batching over a fixed pool of decode slots.

    ``model`` is a `models.gpt2.GPT2LMHead` living on ``device``
    (``None`` means CUDA; RuntimeError when it is absent). The context length
    is the config's ``n_positions``; KV is stored in the config's
    ``kv_cache_dtype`` (int8 with scale planes), or else its compute dtype.
    ``weight_quant`` (a `WeightQuantConfig`, or its mode as a string)
    serves quantized weights.

    Defaults that differ from the reference engine's: ``pipeline_depth=1``
    (the reference's 2), ``paged_kv=True`` (False) and
    ``paged_attention="fused"`` (``"gather"``). The port has neither the
    contiguous slot pool nor overlapped dispatch yet (both raise), so its
    only engine is the paged one at depth 1, and its decode attention is
    the CUDA kernel by default; ``"gather"`` is the plain path, kept as the
    parity oracle. So ``ServingEngine(model)`` builds a different engine in
    each package until ROADMAP Queue 1 items 6 and 7 land."""

    def __init__(
        self,
        model: Any,
        *,
        max_concurrency: int = 8,
        prompt_buckets: tuple[int, ...] = (32, 128, 512),
        max_queue: int = 128,
        eos_token_id: int | None = None,
        pipeline_depth: int = 1,
        admit_batch: int = 4,
        paged_kv: PagedKVConfig | bool = True,
        paged_attention: str = "fused",
        device: str | torch.device | None = None,
        weight_quant: WeightQuantConfig | str | None = None,
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
        if not paged_kv:
            raise NotImplementedError(
                "paged_kv=False (the contiguous slot-pool cache) is not ported yet: "
                "ROADMAP Queue 1, serving modules deferred by slice 1"
            )
        pk = paged_kv if isinstance(paged_kv, PagedKVConfig) else PagedKVConfig()
        bt = int(pk.block_tokens)
        self.max_len = int(cfg.n_positions)
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
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if self.pipeline_depth > 1:
            raise NotImplementedError(
                "pipeline_depth > 1 (overlapped dispatch) is not ported yet: "
                "ROADMAP Queue 1, serving modules deferred by slice 1"
            )
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
        self.scheduler.capacity_fn = self._paged_capacity
        self.eos_token_id = eos_token_id
        self.metrics = ServingMetrics()

        b, dev = self.max_concurrency, self.device
        self._cache = make_block_pool(cfg.n_layer, b, n_blocks, bt, cfg.n_head, cfg.head_dim,
                                      kv_store_dtype(cfg), dev, attention=self.paged_attention)
        # device-resident per-slot state; empty slots stay finished (frozen)
        self._d_tokens = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_pos = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_remaining = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_finished = torch.ones(b, dtype=torch.bool, device=dev)
        self._d_temps = torch.zeros(b, dtype=torch.float32, device=dev)
        self._d_topks = torch.zeros(b, dtype=torch.long, device=dev)
        self._d_tables = torch.full((b, self._blocks_per_slot), n_blocks,
                                    dtype=torch.int32, device=dev)
        self._eos = -1 if eos_token_id is None else int(eos_token_id)
        # host-side slot bookkeeping
        self._active = np.zeros(b, bool)
        self._slot_out: list[RequestOutput | None] = [None] * b
        self._slot_gen: list[torch.Generator | None] = [None] * b  # sampled slots only
        self._slot_last_token_t = [0.0] * b
        self._slot_priv: list[list[int]] = [[] for _ in range(b)]
        self._free: deque[int] = deque(range(b))
        self._next_id = 0

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
        return bool(self._active.any()) or self.scheduler.queue_depth > 0

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def quant_stats(self) -> dict[str, Any]:
        """Quantized-serving gauges (the reference's), ``{}`` for a
        full-precision engine. Weights (``weight_quant=``): ``weight_bits``,
        the packed payload and scale bytes with the dense leaves
        (``weight_packed_bytes``, `quantized_nbytes`), the dense bytes
        recorded at load and the difference. KV (``kv_cache_dtype=int8``):
        ``kv_bits`` and the int8 payload and fp32 scale bytes of the pools
        attention reads (the ``[:num_blocks]`` views, without the sink)."""
        stats: dict[str, Any] = {}
        if self.weight_quant is not None:
            packed = quantized_nbytes(self.model)
            stats["weight_bits"] = 8 if self.weight_quant.mode == "int8" else 4
            stats["weight_packed_bytes"] = packed
            stats["weight_dense_bytes"] = self._dense_param_bytes
            stats["weight_saved_bytes"] = self._dense_param_bytes - packed
        if self._cache.quantized:
            layers = range(len(self._cache.k))
            stats["kv_bits"] = 8
            stats["kv_payload_bytes"] = sum(t.numel() * t.element_size()
                                            for i in layers for t in self._cache.pools(i))
            stats["kv_scale_bytes"] = sum(t.numel() * t.element_size()
                                          for i in layers for t in self._cache.scale_pools(i))
        return stats

    # ------------------------------------------------------------ engine loop
    def step(self) -> list[RequestOutput]:
        """Admit into free slots, decode one token for every active slot, and
        return the requests that finished during this call."""
        finished: list[RequestOutput] = []
        self._admit_pending(finished)
        self.metrics.steps.inc()
        if self._active.any():
            self._decode(finished)
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

    def abort_all(self) -> list[RequestOutput]:
        """Retire every active slot and drop every queued request with
        `FINISH_ABORTED` (partial tokens kept)."""
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
        in free slots. False (group requeued) when the pool is short."""
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
        tables, dest = self._commit_reservation(reservation, group, slots)
        dev = self.device
        gens = [torch.Generator(device=dev).manual_seed(int(r.params.seed))
                if r.params.temperature > 0 else None for r in group]
        slots_t = torch.tensor(slots, dtype=torch.long, device=dev)
        lens_t = torch.from_numpy(lens).to(dev)
        with torch.no_grad():
            kv: list = []
            hidden = self.model(torch.from_numpy(padded).to(dev), kv_out=kv, return_hidden=True)
            last = self.model.logits(hidden[torch.arange(nb, device=dev), lens_t - 1])
            temps = torch.tensor([float(r.params.temperature) for r in group],
                                 dtype=torch.float32, device=dev)
            topks = torch.tensor([int(r.params.top_k or 0) for r in group],
                                 dtype=torch.long, device=dev)
            first = self._sample(last, temps, topks, gens)
            n_written = -(-bucket // self._block_tokens)
            scatter_rows_to_blocks(self._cache, kv, slots_t,
                                   torch.from_numpy(dest[:, :n_written]).to(dev),
                                   lens_t.to(torch.int32))
            rem0 = torch.from_numpy(budgets).to(dev) - 1
            fin0 = (rem0 <= 0) | ((self._eos >= 0) & (first == self._eos))
            self._d_tables[slots_t] = torch.from_numpy(tables).to(dev)
            self._d_tokens[slots_t] = first
            self._d_pos[slots_t] = lens_t
            self._d_remaining[slots_t] = rem0
            self._d_finished[slots_t] = fin0
            self._d_temps[slots_t] = temps
            self._d_topks[slots_t] = topks
            fetched = torch.stack([first, fin0.long()]).cpu().numpy()
        now = time.perf_counter()
        for i, (slot, request) in enumerate(zip(slots, group)):
            self._active[slot] = True
            self._slot_gen[slot] = gens[i]
            self._slot_out[slot] = RequestOutput(
                request_id=request.request_id, prompt_len=len(request.prompt), tokens=[],
                finish_reason="", arrival_time=request.arrival_time, first_token_time=now)
            self.metrics.ttft_s.observe(max(0.0, now - request.arrival_time))
            self._deliver(slot, int(fetched[0, i]), bool(fetched[1, i]), now, finished)
        return True

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

    def _decode(self, finished: list[RequestOutput]) -> None:
        with torch.no_grad():
            live = ~self._d_finished
            logits = self.model(self._d_tokens[:, None], self._d_pos, cache=self._cache,
                                block_tables=self._d_tables, write_mask=live)
            gens = [self._slot_gen[s] if self._active[s] else None
                    for s in range(self.max_concurrency)]
            nxt = self._sample(logits[:, -1], self._d_temps, self._d_topks, gens)
            # finished slots are frozen: token, position and budget carried
            nxt = torch.where(live, nxt, self._d_tokens)
            self._d_pos = torch.where(live, self._d_pos + 1, self._d_pos)
            self._d_remaining = torch.where(live, self._d_remaining - 1, self._d_remaining)
            hit_eos = (self._eos >= 0) & (nxt == self._eos)
            self._d_finished = self._d_finished | (live & (hit_eos | (self._d_remaining <= 0)))
            self._d_tokens = nxt
            fetched = torch.stack([nxt, self._d_finished.long()]).cpu().numpy()
        self.metrics.decode_steps.inc()
        now = time.perf_counter()
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            self.metrics.inter_token_s.observe(now - self._slot_last_token_t[slot])
            self._deliver(slot, int(fetched[0, slot]), bool(fetched[1, slot]), now, finished)

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
        """Return a slot and its blocks. The table row is parked at the
        sentinel ``num_blocks`` so any later write through it is dropped, and
        the slot is marked finished (frozen) until the next admission."""
        self._allocator.free(self._slot_priv[slot])
        self._slot_priv[slot] = []
        self._d_tables[slot] = self._allocator.num_blocks
        self._d_finished[slot] = True
        self._slot_out[slot] = None
        self._slot_gen[slot] = None
        self._active[slot] = False
        self._free.append(slot)
