"""Autoregressive generation over the slot KV cache: the port of
`accelerate_tpu.models.generation`, and the solo oracle of the port's
serving tests.

`generate` runs any model whose ``forward`` takes a `kv_cache.SlotKVCache`
(``GPT2LMHead``, ``LlamaForCausalLM``): the prompt is prefilled in one pass
over the cache at position 0, then each new token is one decode step with
the cache's scalar write index, as the reference's jitted scan does. Rows
share one prompt length (the write index is one for the batch, as in the
reference; batch ragged prompts by bucketing equal lengths). On CUDA the
decode step is captured as a `torch.cuda.CUDAGraph` (`capture_graph`) and
replayed for each token: the reference's step is one compiled program, and
an eager step of a 32-layer model is paced by its host launches. The replayed
step is the eager one, position read from the cache's index on the device,
so both give the same tokens; on the CPU the step runs eagerly. As the
reference's jit cache keeps its compiled program, the graph is kept for the
model's next call (`_CapturedStep`), with the slot cache and the fixed
buffers it reads: ONE per model, for the batch size and greedy or sampled
mode of its last call. A call with another batch or mode drops it and
captures anew, and so does a call after any tensor the model reads has moved
(`_fingerprint`). What stays held on the card between calls is that slot
cache (``2 x layers x batch x max_position_embeddings x kv heads x head_dim``
elements of the model's dtype, or int8 plus fp32 scales: 268 MB for
Llama-2-7B at 512 positions and batch 1 in bf16, 2.1 GB at its own 4096) and
the graph's memory pool; `release_captured` frees them at once, and dropping
the model frees them too.

Sampling is Gumbel-max over temperature-scaled, optionally top-k-masked
logits, as ``jax.random.categorical`` samples. The Gumbel noise comes from a
`torch.Generator`, whose stream differs from ``jax.random``'s: sampled tokens
are reproducible within the port (the serving engine draws each request's
noise from its own generator seeded with ``SamplingParams.seed``, so a
request sampled there equals a batch-1 `generate` with a generator seeded the
same), not across the two frameworks.
"""

from __future__ import annotations

import gc
import weakref
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..ops.nf4_matmul import nf4_matmul
from ..utils.environment import resolve_device
from .kv_cache import SlotKVCache, make_cache


def gumbel_noise(shape: tuple[int, ...], generator: torch.Generator | None,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
           noise: torch.Tensor | None) -> torch.Tensor:
    """Next token per row of ``[n, vocab]`` logits: argmax where
    ``temperature[i] == 0``, else argmax of ``logits / temperature`` masked
    to its ``top_k[i]`` largest (0 = no mask) plus ``noise`` (Gumbel). The
    per-row settings are data, as in the reference engine's ``_sample_slot``,
    so one call serves a batch of mixed requests."""
    greedy = logits.argmax(dim=-1)
    if noise is None:
        return greedy
    vocab = logits.shape[-1]
    temperature = temperature.to(logits.device, torch.float32)
    top_k = top_k.to(logits.device, torch.long)
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits.float() / safe_t[:, None]
    ordered = torch.sort(scaled, dim=-1).values  # ascending
    kth = ordered.gather(-1, (vocab - top_k.clamp(1, vocab))[:, None])
    masked = torch.where((top_k[:, None] > 0) & (scaled < kth), float("-inf"), scaled)
    sampled = (masked + noise).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def capture_graph(fn: Callable[[], None], device: torch.device) -> torch.cuda.CUDAGraph:
    """``fn`` captured as a CUDA graph on ``device``. Run ``fn`` eagerly
    first (on a side stream), so libraries are built, kernel attributes set
    and caches filled before the capture: none of that may happen inside
    one. Nothing may call an unsafe CUDA function while the graph is
    recorded, or the capture is invalidated. Two guards: the garbage
    collector runs before the capture and is off during it, since collecting
    a dropped graph's owner in a reference cycle destroys that graph, and
    PyTorch no longer collects before a capture; and the capture is
    ``thread_local``, so another thread's calls (an event query, a memory
    query) do not invalidate it, as they do under PyTorch's default,
    ``global``. This thread's own unsafe calls still do."""
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.no_grad(), torch.cuda.device(device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    finally:
        if collecting:
            gc.enable()
    return graph


@dataclass
class _CapturedStep:
    """What a captured decode step reads and writes, kept with its graph
    for the model's next `generate` call: the batch size and mode it serves,
    the slot cache, the step's token (its input and output), the sampling
    settings and the noise buffer (None for a greedy graph). ``launches`` is
    what one replay launches, by kernel wrapper: the wrappers' counts advance
    while the graph is recorded, as in the serving engine's capture, and a
    replay runs no wrapper. ``replays`` counts the graph's replays."""

    batch: int
    sampled: bool
    cache: SlotKVCache
    token: torch.Tensor
    temps: torch.Tensor
    top_ks: torch.Tensor
    noise: torch.Tensor | None
    graph: torch.cuda.CUDAGraph | None = None
    fingerprint: tuple = ()
    launches: dict[str, int] = field(default_factory=dict)
    replays: int = 0


# model -> its one _CapturedStep; an entry holds no reference to its model, so
# it goes when the model does
_CAPTURED: "weakref.WeakKeyDictionary[torch.nn.Module, _CapturedStep]" = \
    weakref.WeakKeyDictionary()


def release_captured(model: torch.nn.Module) -> None:
    """Free the decode graph, slot cache and buffers that `generate` keeps
    for ``model``'s next call (see the module docstring for their size)."""
    _CAPTURED.pop(model, None)


def _fingerprint(model: torch.nn.Module) -> tuple:
    """The address of every tensor the model's forward reads (parameters,
    buffers, quantized payloads, scales and the nf4 kernel's plane layout). A
    captured graph reads them where they were: a layer swapped in place or a
    model moved makes a new capture."""
    ptrs = []
    for mod in model.modules():
        ptrs += [t.data_ptr() for t in (*mod._parameters.values(), *mod._buffers.values())
                 if t is not None]
        qt = getattr(mod, "qweight", None)
        if qt is not None:
            ptrs += [t.data_ptr() for t in (qt.data, qt.scales, *(qt._plane_pack or ()))]
    return tuple(ptrs)


def generate(
    model: torch.nn.Module,  # a GPT2LMHead or LlamaForCausalLM
    input_ids: torch.Tensor,  # [b, prompt_len]: rows share one length
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
    *,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations for each prompt row:
    ``[b, max_new_tokens]`` new tokens (prompt not repeated).

    temperature=0 is greedy; otherwise Gumbel-max sampling (optionally top-k)
    with noise from ``generator``, one ``[b, vocab]`` draw per token. The
    prompt is prefilled in one pass over a slot cache (`kv_cache.make_cache`
    with a scalar index; int8 when the config's ``kv_cache_dtype`` says so);
    every later token is one decode step over it. On CUDA the step is
    replayed from a captured CUDA graph, the noise drawn outside it into a
    fixed buffer: a call that finds no graph for its batch size and mode runs
    two steps eagerly on a side stream and captures the third, later calls
    replay from the first step (see the module docstring). On the CPU every
    step runs eagerly. ``device=None`` means CUDA; the model must already
    live on the device."""
    device = resolve_device(device)
    return _generate(model, input_ids, max_new_tokens, temperature, top_k, generator, device,
                     capture=device.type == "cuda")


@torch.no_grad()
def _generate(model: torch.nn.Module, input_ids: torch.Tensor, max_new_tokens: int,
              temperature: float, top_k: int | None, generator: torch.Generator | None,
              device: torch.device, capture: bool) -> torch.Tensor:
    """`generate`'s body. ``capture=False`` runs every step eagerly over a
    cache of its own, on any device and keeping nothing: the tests hold the
    replayed step against it."""
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, generate asked for {device}")
    ids = torch.as_tensor(input_ids, device=device).long()
    b, prompt_len = ids.shape
    sampled = temperature > 0
    held = _CAPTURED.get(model) if capture else None
    if held is not None and (held.batch, held.sampled) != (b, sampled):
        del _CAPTURED[model]  # one entry a model: its cache and graph go first
        held = None
    if held is None:
        cache = make_cache(model, b, per_slot=False)
        vocab = model.config.vocab_size
        held = _CapturedStep(b, sampled, cache,
                             torch.zeros((b, 1), dtype=torch.long, device=device),
                             torch.zeros(b, device=device),
                             torch.zeros(b, dtype=torch.long, device=device),
                             torch.zeros((b, vocab), device=device) if sampled else None)
        if capture:
            _CAPTURED[model] = held
    cache, token, noise = held.cache, held.token, held.noise
    if prompt_len + max_new_tokens > cache.max_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache's {cache.max_len} positions"
        )
    held.temps.fill_(float(temperature))
    held.top_ks.fill_(int(top_k or 0))
    cache.index.zero_()  # a reused cache: what lies past the index is masked

    def draw() -> None:
        if noise is not None:
            noise.copy_(gumbel_noise(tuple(noise.shape), generator, device))

    def step() -> None:
        # the position is the cache's index, on the device
        logits = model(token, cache.index, cache=cache)[:, -1]
        token.copy_(sample(logits, held.temps, held.top_ks, noise)[:, None])

    logits = model(ids, 0, cache=cache)[:, -1]
    draw()
    token.copy_(sample(logits, held.temps, held.top_ks, noise)[:, None])
    out = [token[:, 0].clone()]
    n = max_new_tokens - 1
    if capture and held.graph is not None and held.fingerprint != _fingerprint(model):
        held.graph = None
    eager = n if not capture else 0 if held.graph is not None else min(2, n)
    side = torch.cuda.Stream(device) if capture and eager else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side) if side is not None else nullcontext():
        for _ in range(eager):
            draw()
            step()
            out.append(token[:, 0].clone())
    if side is not None:
        torch.cuda.current_stream(device).wait_stream(side)
    if n > eager:
        if held.graph is None:
            before = nf4_matmul.launches
            held.graph = capture_graph(step, device)
            held.launches = {"nf4_matmul": nf4_matmul.launches - before}
            held.fingerprint = _fingerprint(model)
        for _ in range(n - eager):
            draw()
            held.graph.replay()
            held.replays += 1
            out.append(token[:, 0].clone())
    return torch.stack(out, dim=1)
