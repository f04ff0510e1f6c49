"""Attention ops: the plain PyTorch path of `accelerate_tpu.ops.attention`.

All functions take ``[batch, seq, heads, head_dim]`` ("BSHD") layouts, as the
reference does, so the port's tests compare like with like. Numerics follow the
reference: QK^T accumulates in fp32 whatever the input dtype, logits are scaled
after the product, masked positions take ``finfo(float32).min``, the softmax
runs in fp32, and the weights return to the input dtype before the product
with V.
"""

from __future__ import annotations

import math

import torch

_NEG = torch.finfo(torch.float32).min


def _on_cuda(t: torch.Tensor) -> bool:
    """Where ``'auto'`` may pick the flash kernel: a tensor on a CUDA device
    (the reference's ``on_tpu_platform()``)."""
    return t.device.type == "cuda"


def causal_mask(q_len: int, kv_len: int, dtype: torch.dtype = torch.float32,
                offset: int = 0, device: torch.device | str | None = None) -> torch.Tensor:
    """Additive causal mask ``[q_len, kv_len]``: query i attends to keys <= i+offset."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    k_idx = torch.arange(kv_len, device=device)[None, :]
    allowed = k_idx <= q_idx + offset
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(allowed, zero, torch.finfo(dtype).min)


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    bias: torch.Tensor | None = None,  # additive, broadcast to [B, H, Sq, Sk]
    mask: torch.Tensor | None = None,  # boolean [B, 1|H, Sq, Sk] or [Sq, Sk], True = keep
    causal: bool = False,
    window: int | None = None,  # sliding window: query i sees keys in (i - window, i]
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. The products run on fp32 copies of bf16/fp16 inputs,
    which is exact for the products and accumulates in fp32, as the
    reference's ``preferred_element_type=float32`` does; the output returns to
    the input dtype. ``bias`` (T5's relative-position bias) is added in fp32
    after the scale and before the causal, window and boolean masks, where
    the reference adds it. ``window`` requires ``causal``, as in the
    reference."""
    orig_dtype = q.dtype
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = logits + causal_mask(q.shape[1], k.shape[1], device=q.device)
    if window is not None:
        if not causal:
            raise ValueError(
                "window requires causal=True (one rule across xla and flash paths; "
                "a low-side-only band would silently attend future keys)"
            )
        q_idx = torch.arange(q.shape[1], device=q.device)[:, None]
        k_idx = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(k_idx > q_idx - window, logits, _NEG)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None]
        logits = torch.where(mask, logits, _NEG)
    weights = torch.softmax(logits, dim=-1).to(orig_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,
    window: int | None = None,
    implementation: str = "auto",
    block_q: int | None = None,
    block_kv: int | None = None,
) -> torch.Tensor:
    """Dispatching entry point: ``'xla' | 'flash' | 'auto'``, the reference's
    names. ``'xla'`` is the plain path above; ``'flash'`` is
    `flash_attention.flash_attention` (the CUDA kernels on a CUDA tensor, their
    plain versions on the CPU). ``'auto'`` follows the reference's rule with
    "on a CUDA tensor" for "on TPU": the kernel for self-attention at
    ``seq >= 1024``, the plain path otherwise; a ``window`` over a sequence
    with no band block (`flash_attention.band_block_default`) takes the plain
    path. A masked call always takes the plain path, as in the reference: the
    flash kernel has no arbitrary-mask support. ``window`` is Mistral-class
    sliding-window attention (query i sees keys in ``(i - window, i]``); on
    the flash path it runs on the band kernels. GQA K/V pass to the flash
    path unrepeated (the band kernels read kv head ``h // groups``, the
    rectangular path repeats them) and are repeated up to the query heads on
    the plain path. The reference's ``attention()`` takes no additive bias
    either: a model that needs one (T5) calls `dot_product_attention` with
    ``bias=`` directly. ``block_q`` and ``block_kv`` are the reference's TPU
    tiles: accepted and, as in the reference, handed to `flash_attention` on
    the flash path, which checks them as the reference does and ignores them
    (the CUDA kernels choose their own tiles); the plain path ignores
    them."""
    if implementation not in ("auto", "xla", "flash"):
        raise ValueError(f"implementation must be 'auto', 'xla' or 'flash', got {implementation!r}")
    hq, hk = q.shape[2], k.shape[2]
    if hk != hq and (hk == 0 or hq % hk):
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hk})")
    if mask is not None:
        implementation = "xla"
    if implementation == "auto":
        long_self = q.shape[1] >= 1024 and q.shape[1] == k.shape[1]
        implementation = "flash" if _on_cuda(q) and long_self else "xla"
        if window is not None and implementation == "flash":
            from .flash_attention import band_block_default

            if band_block_default(q.shape[1]) is None:
                implementation = "xla"
    if implementation == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window, block_q=block_q,
                               block_kv=block_kv)
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    return dot_product_attention(q, k, v, causal=causal, mask=mask, window=window)
