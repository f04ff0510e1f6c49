"""Autoregressive generation with a paged KV cache: the port of
`accelerate_tpu.models.generation`, and the solo oracle of the port's
serving tests.

Sampling is Gumbel-max over temperature-scaled, optionally top-k-masked
logits, as ``jax.random.categorical`` samples. The Gumbel noise comes from a
`torch.Generator`, whose stream differs from ``jax.random``'s: sampled tokens
are reproducible within the port (the serving engine draws each request's
noise from its own generator seeded with ``SamplingParams.seed``, so a
request sampled there equals a batch-1 `generate` with a generator seeded the
same), not across the two frameworks.
"""

from __future__ import annotations

import torch

from ..utils.environment import resolve_device
from .kv_cache import kv_store_dtype, make_block_pool, scatter_rows_to_blocks

BLOCK_TOKENS = 16


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


@torch.no_grad()
def generate(
    model: torch.nn.Module,  # a GPT2LMHead
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
    with noise from ``generator``. The prompt is prefilled in one causal pass
    and its K/V scattered into a paged pool (each row owning consecutive
    blocks); every later token is one decode step on the gather path.
    ``device=None`` means CUDA; the model must already live on the device."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, generate asked for {device}")
    cfg = model.config
    ids = torch.as_tensor(input_ids, device=device).long()
    b, prompt_len = ids.shape
    if prompt_len + max_new_tokens > cfg.n_positions:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"n_positions={cfg.n_positions}"
        )
    bps = -(-cfg.n_positions // BLOCK_TOKENS)
    cache = make_block_pool(cfg.n_layer, b, b * bps, BLOCK_TOKENS, cfg.n_head,
                            cfg.head_dim, kv_store_dtype(cfg), device, attention="gather")
    tables = torch.arange(b * bps, dtype=torch.int32, device=device).reshape(b, bps)
    temps = torch.full((b,), float(temperature), device=device)
    top_ks = torch.full((b,), int(top_k or 0), dtype=torch.long, device=device)

    def next_token(logits):
        noise = (gumbel_noise(tuple(logits.shape), generator, device)
                 if temperature > 0 else None)
        return sample(logits, temps, top_ks, noise)

    kv: list = []
    logits = model(ids, kv_out=kv)
    n_written = -(-prompt_len // BLOCK_TOKENS)
    scatter_rows_to_blocks(cache, kv, torch.arange(b, device=device),
                           tables[:, :n_written],
                           torch.full((b,), prompt_len, dtype=torch.int32, device=device))
    token = next_token(logits[:, -1])
    out = [token]
    for step in range(max_new_tokens - 1):
        logits = model(token[:, None], prompt_len + step, cache=cache, block_tables=tables)
        token = next_token(logits[:, -1])
        out.append(token)
    return torch.stack(out, dim=1)
