"""GPT-2: the port of `accelerate_tpu.models.gpt2` for serving and training.

Three forward modes:

  - the full-sequence (non-decode) forward, causal attention over the input
    through ``attention(implementation=config.attention_impl)``: training
    runs it, and admission uses it to prefill prompts (``kv_out`` collects
    each layer's K/V for `kv_cache.scatter_rows_to_blocks` or
    `kv_cache.scatter_cache_slots`);
  - decode over the slot cache (`kv_cache.SlotKVCache`, the reference's
    ``decode=True`` branch): the step's ``s`` tokens are written at the
    cache's index (scalar, or per slot with a write mask) and attend the
    whole ``[b, n_positions, ...]`` buffer under a mask, ``[s, n_positions]``
    for a scalar index and ``[b, 1, s, n_positions]`` per slot, through the
    plain attention (the reference's ``implementation="xla"``: no kernel);
  - the paged decode step: one token per row, written at the row's frontier
    in the `kv_cache.PagedKVCache` pools, attention through the row's block
    table, either with the CUDA kernel in place (``cache.attention ==
    "fused"``) or over the gathered view (``"gather"``); a multi-token
    segment under ``write_len`` (the speculative verify step) always takes
    the gathered view, as in the reference: the kernel is single-query.

Numerics follow the reference: parameters live in ``param_dtype`` and every
projection computes in ``dtype`` (inputs, weight and bias cast to it, as flax
``Dense(dtype=...)`` does); LayerNorm statistics, scale and bias are fp32 with
``eps=1e-5`` and the result is cast back to ``dtype``; the MLP uses the tanh
GELU; q, k and v are the contiguous thirds of the ``qkv`` output; the head is
tied to ``wte`` and its logits accumulate in fp32. Dropout (after the
attention projection and after the MLP, when ``deterministic=False``) draws
from an explicit `torch.Generator`.

The training losses follow the reference: `cross_entropy_loss`,
`_next_token_labels`, `lm_loss_fn`, `lm_loss_fn_fused` (the tied head and
the cross-entropy over row chunks under `torch.utils.checkpoint`, no kernel)
and `lm_loss_fn_pallas` (the tied head fused with the cross-entropy in the
port's CUDA kernels).

`params_from_jax` turns the reference's param tree into this module's state
dict, and `params_to_jax` turns it back, so both packages can run and export
the same weights; with an fp8 model both also carry the reference's
``fp8_meta`` collection. `params_from_hf_gpt2` maps a Hugging Face GPT-2
state dict onto this module's.

fp8 and remat (the reference's ``fp8_recipe``, ``remat`` and
``remat_policy``): with a `ops.fp8.DelayedScalingRecipe` the block
projections (``qkv``, ``proj``, ``up``, ``down``) are `ops.fp8.Fp8Linear`,
whose delayed-scaling state rides the state dict as buffers; decode over an
fp8 model raises, as the reference's does. ``remat=True`` runs each block of
the full-sequence forward under `utils.remat.remat_block` with
``remat_policy``.

Quantized weights (`utils.quantization.quantize_module`, the serving
engine's ``weight_quant=``): a `QuantizedLinear` projection runs through
`ops.nf4_matmul.nf4_matmul`, the CUDA kernel for nf4 weights it routes there
and ``x @ dequantize(W)`` for the rest (int8, unsupported shapes), with the
bias added in ``dtype``; a `QuantizedEmbedding` lookup dequantizes only the
rows it reads, and the tied head dequantizes ``wte``. The dequantized values
are the reference's: fp32 (the param dtype) cast to ``dtype``, except that
the nf4 kernel keeps them fp32 and casts its fp32 sums, as the reference's
kernel does. ``config.kv_cache_dtype=torch.int8`` stores the KV cache (slot
or paged) as int8 with fp32 scale planes (`kv_cache`); a prefill that fills
such a cache attends over the dequantized K/V it stores, as the reference's
does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import attention
from ..ops.flash_attention import paged_decode_attention
from ..ops.fp8 import Fp8Linear, convert_dense_to_fp8, is_meta_key, meta_from_jax, meta_to_jax
from ..ops.fused_ce import fused_cross_entropy
from ..ops.nf4_matmul import nf4_matmul
from ..utils.environment import resolve_device
from ..utils.modeling import state_dict_subtree
from ..utils.quantization import QuantizedEmbedding, QuantizedLinear, dequantize, dequantize_rows
from ..utils.remat import remat_block
from ..utils.safetensors_io import unflatten_state_dict
from .kv_cache import (
    PagedKVCache,
    SlotKVCache,
    _dq,
    _q,
    advance_index,
    decode_cache_update,
    paged_decode_update,
    paged_decode_write,
    slot_attention_mask,
)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"  # 'xla' | 'flash' | 'auto' (ops.attention.attention)
    kv_cache_dtype: torch.dtype | None = None  # None (compute dtype) | torch.int8 (kv_cache.py)
    remat: bool = False
    remat_policy: Any = None  # utils/remat.py: full|dots|dots_no_batch, or a callable
    # fp8 projections: an ops.fp8.DelayedScalingRecipe makes every block
    # projection an ops.fp8.Fp8Linear (same param names, so checkpoints load)
    fp8_recipe: Any = None

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        return cls(**{**dict(n_embd=768, n_layer=12, n_head=12), **kw})

    @classmethod
    def medium(cls, **kw) -> "GPT2Config":
        return cls(**{**dict(n_embd=1024, n_layer=24, n_head=16), **kw})

    @classmethod
    def large(cls, **kw) -> "GPT2Config":
        return cls(**{**dict(n_embd=1280, n_layer=36, n_head=20), **kw})

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """Test-sized config."""
        return cls(**{**dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=2), **kw})


def _linear(config: Any, in_features: int, out_features: int, device: torch.device,
            bias: bool = True) -> nn.Linear:
    """A block projection in ``param_dtype``: ``nn.Linear``, or `Fp8Linear`
    when the config carries an fp8 recipe (the reference's ``_dense``
    factory, `ops.fp8.convert_dense_to_fp8`)."""
    return convert_dense_to_fp8(config.fp8_recipe)(
        in_features, out_features, bias=bias, device=device, dtype=config.param_dtype)


def _refuse_fp8_decode(config: Any) -> None:
    """The reference's `Fp8Dense` refuses a call that does not thread its
    scaling state, which no decode path does."""
    if getattr(config, "fp8_recipe", None) is not None:
        raise ValueError(
            "an fp8 model (fp8_recipe set) cannot decode: its delayed-scaling state "
            "is training state; use the dense or weight-quantized model there")


def _dense(x: torch.Tensor, layer: nn.Linear | QuantizedLinear,
           dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input, weight and bias cast to it,
    as flax ``Dense(dtype=...)`` does. A quantized layer multiplies through
    `nf4_matmul` and adds the bias after; an `Fp8Linear` runs its fp8
    product in ``dtype``."""
    if isinstance(layer, Fp8Linear):
        return layer(x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if isinstance(layer, QuantizedLinear):
        y = nf4_matmul(x.to(dtype), layer.qweight)
        return y if bias is None else y + bias
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _embed(table: nn.Embedding | QuantizedEmbedding | torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding table (a module, or a bare ``[num, dim]``
    tensor), in its param dtype (a quantized table dequantizes only those
    rows)."""
    if isinstance(table, QuantizedEmbedding):
        return dequantize_rows(table.qweight, ids)
    return F.embedding(ids, table if isinstance(table, torch.Tensor) else table.weight)


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``, in x's dtype. No
    ``generator`` means no dropout (the deterministic forward)."""
    if generator is None:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """fp32 statistics, fp32 scale and bias, fp32 result."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


class SelfAttention(nn.Module):
    def __init__(self, config: GPT2Config, device: torch.device):
        super().__init__()
        self.config = config
        e = config.n_embd
        self.qkv = _linear(config, e, 3 * e, device)
        self.proj = _linear(config, e, e, device)

    def forward(self, x: torch.Tensor, layer: int,
                cache: SlotKVCache | PagedKVCache | None = None,
                block_tables: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None,
                write_len: torch.Tensor | None = None,
                kv_out: list | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        q, k, v = _dense(x, self.qkv, cfg.dtype).split(e, dim=-1)
        q = q.reshape(b, s, cfg.n_head, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_head, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_head, cfg.head_dim)
        if isinstance(cache, SlotKVCache):
            k_all, v_all, idx = decode_cache_update(cache, layer, k, v, write_mask, write_len)
            mask = slot_attention_mask(idx, s, cache.max_len)
            out = attention(q, k_all, v_all, mask=mask, implementation="xla")
        elif cache is not None:
            # paged decode: the query at cursor idx attends positions <= idx,
            # a valid span of idx + 1, in both attention paths; query j of a
            # segment sits at idx + j
            if cache.attention == "fused" and s == 1 and write_len is None:
                k_pool, v_pool, scales = paged_decode_write(cache, layer, k, v, block_tables,
                                                            write_mask)
                k_sp, v_sp = scales if scales is not None else (None, None)
                out = paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables,
                                             cache.index + 1, k_scale_pool=k_sp,
                                             v_scale_pool=v_sp)[:, None]
            else:
                k_all, v_all = paged_decode_update(cache, layer, k, v, block_tables, write_mask,
                                                   write_len)
                kv_pos = torch.arange(k_all.shape[1], device=x.device)
                q_pos = cache.index.long()[:, None] + torch.arange(s, device=x.device)
                mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
                out = attention(q, k_all, v_all, mask=mask, implementation="xla")
        else:
            if kv_out is not None and cfg.kv_cache_dtype is not None:
                # the int8 cache this prefill fills: store the payload and
                # scales, attend over what they dequantize to
                (kq, ks), (vq, vs) = _q(k), _q(v)
                kv_out.append((kq, vq, ks, vs))
                k, v = _dq(kq, ks, k.dtype), _dq(vq, vs, v.dtype)
            elif kv_out is not None:
                kv_out.append((k, v))
            out = attention(q, k, v, causal=True, implementation=cfg.attention_impl)
        return _dropout(_dense(out.reshape(b, s, e), self.proj, cfg.dtype), cfg.dropout, generator)


class MLP(nn.Module):
    def __init__(self, config: GPT2Config, device: torch.device):
        super().__init__()
        self.config = config
        hidden = config.mlp_ratio * config.n_embd
        self.up = _linear(config, config.n_embd, hidden, device)
        self.down = _linear(config, hidden, config.n_embd, device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        x = _dense(F.gelu(_dense(x, self.up, cfg.dtype), approximate="tanh"), self.down, cfg.dtype)
        return _dropout(x, cfg.dropout, generator)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, config: GPT2Config, device: torch.device):
        super().__init__()
        self.config = config
        e, pd, eps = config.n_embd, config.param_dtype, config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(e, eps=eps, device=device, dtype=pd)
        self.attn = SelfAttention(config, device)
        self.ln_2 = nn.LayerNorm(e, eps=eps, device=device, dtype=pd)
        self.mlp = MLP(config, device)

    def forward(self, x: torch.Tensor, layer: int, generator: torch.Generator | None = None,
                **decode: Any) -> torch.Tensor:
        dtype = self.config.dtype
        x = x + self.attn(_layer_norm(x, self.ln_1).to(dtype), layer, generator=generator, **decode)
        return x + self.mlp(_layer_norm(x, self.ln_2).to(dtype), generator)


class GPT2LMHead(nn.Module):
    """Decoder-only LM. ``forward`` returns fp32 logits ``[batch, seq, vocab]``.

    ``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). Weights are drawn from ``seed`` with
    the reference's initializer scales: normal(0.02) for ``wte``,
    normal(0.01) for ``wpe``, normal(1/sqrt(fan_in)) for projection kernels,
    zero biases, unit LayerNorm scales."""

    def __init__(self, config: GPT2Config, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        pd = config.param_dtype
        self.wte = nn.Embedding(config.vocab_size, config.n_embd, device=device, dtype=pd)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd, device=device, dtype=pd)
        self.blocks = nn.ModuleList(Block(config, device) for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(config.n_embd, eps=config.layer_norm_epsilon,
                                 device=device, dtype=pd)
        if device.type != "meta":
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.wte.weight.normal_(0.0, 0.02, generator=g)
        self.wpe.weight.normal_(0.0, 0.01, generator=g)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=g)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(
        self,
        input_ids: torch.Tensor,  # [b, s] token ids
        position_offset: int | torch.Tensor = 0,  # scalar, or [b] per-row offsets
        *,
        cache: SlotKVCache | PagedKVCache | None = None,
        block_tables: torch.Tensor | None = None,  # [b, blocks_per_slot] (paged decode)
        write_mask: torch.Tensor | None = None,  # [b] bool: False rows freeze (per slot, paged)
        write_len: torch.Tensor | None = None,  # [b] int: per-row segment cap (per slot, paged)
        kv_out: list | None = None,  # full forward: collects each layer's (k, v)
        return_hidden: bool = False,
        deterministic: bool = True,  # False applies dropout (config.dropout > 0)
        generator: torch.Generator | None = None,  # dropout's random bits
    ) -> torch.Tensor:
        """With a `SlotKVCache` this is decode over the slot cache: the
        ``s`` tokens of each row are written at ``cache.index`` (see
        `kv_cache.decode_cache_update` for ``write_mask`` and ``write_len``,
        per-slot caches only) and the index advances past them. With a
        `PagedKVCache` it is one paged decode step (``s == 1``): each row's
        token is written at ``cache.index`` through ``block_tables`` (rows
        where ``write_mask`` is False write nothing) and the cursor of
        writing rows advances by one; with ``write_len``, a segment of ``s``
        tokens of which each row writes its first ``clip(write_len, 0, s)``
        (`kv_cache.paged_frontier_write`) and advances by as many. Without a
        cache, the causal forward
        over ``input_ids``. ``return_hidden`` returns the final LayerNorm output in
        the compute dtype instead of logits (see `logits`). With
        ``deterministic=False`` and ``config.dropout > 0``, dropout draws from
        ``generator``."""
        cfg = self.config
        b, s = input_ids.shape
        if cache is not None or kv_out is not None:
            _refuse_fp8_decode(cfg)
        decode: dict[str, Any] = {}
        if isinstance(cache, SlotKVCache):
            decode = dict(cache=cache, write_mask=write_mask, write_len=write_len)
        elif cache is not None:
            if block_tables is None:
                raise ValueError("paged decode needs block_tables ([b, blocks_per_slot])")
            if write_mask is None:
                write_mask = torch.ones(b, dtype=torch.bool, device=input_ids.device)
            decode = dict(cache=cache, block_tables=block_tables, write_mask=write_mask,
                          write_len=write_len)
        elif kv_out is not None:
            decode = dict(kv_out=kv_out)
        x = self.embed(input_ids, position_offset)
        if deterministic or cfg.dropout == 0.0:
            generator = None
        elif generator is None:
            raise ValueError("dropout with deterministic=False needs an explicit torch.Generator")
        for i, block in enumerate(self.blocks):
            if cfg.remat and not decode:
                x = remat_block(block, cfg.remat_policy)(x, i, generator=generator)
            else:
                x = block(x, i, generator, **decode)
        if isinstance(cache, SlotKVCache):
            advance_index(cache, s, write_mask, write_len)
        elif cache is not None:
            step = write_mask.to(cache.index.dtype)
            if write_len is not None:
                step = step * write_len.to(cache.index.dtype).clamp(0, s)
            cache.index += step
        return self.head(x, return_hidden)

    def embed(self, input_ids: torch.Tensor,
              position_offset: int | torch.Tensor = 0) -> torch.Tensor:
        """Token and position embeddings in the compute dtype, at positions
        ``position_offset + arange(s)`` (an offset per row when it is
        ``[b]``), clamped to the table as the reference's gather clamps."""
        cfg = self.config
        steps = torch.arange(input_ids.shape[1], device=input_ids.device)
        if isinstance(position_offset, torch.Tensor) and position_offset.ndim == 1:
            positions = position_offset.long()[:, None] + steps  # [b, s]: per-row positions
        else:
            # [1, s], shared by the batch; a 0-d device tensor (a slot cache's
            # index) is read on the device, so a CUDA graph can capture the step
            positions = (steps + position_offset)[None]
        positions = positions.clamp(max=cfg.n_positions - 1)
        return _embed(self.wte, input_ids).to(cfg.dtype) + _embed(self.wpe, positions).to(cfg.dtype)

    def head(self, x: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
        """The final LayerNorm and the tied LM head: fp32 logits, or with
        ``return_hidden`` the normed states in the compute dtype."""
        x = _layer_norm(x, self.ln_f).to(self.config.dtype)
        return x if return_hidden else self.logits(x)

    def reference_state_dict(self) -> dict[str, Any]:
        """The weights under the reference's names and layout
        (`params_to_jax`), without an fp8 model's scaling state."""
        return params_to_jax({k: v for k, v in self.state_dict().items() if not is_meta_key(k)})

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied LM head over compute-dtype hidden states: fp32 logits. The
        product runs on fp32 copies of the compute-dtype operands, so with
        bf16 weights the products are exact and the sums fp32: the
        reference's bf16 einsum with ``preferred_element_type=float32``."""
        dtype = self.config.dtype
        if isinstance(self.wte, QuantizedEmbedding):
            return F.linear(hidden.to(dtype).float(), dequantize(self.wte.qweight, dtype).float())
        return F.linear(hidden.to(dtype).float(), self.wte.weight.to(dtype).float())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Token-level cross-entropy with masking, fp32 accumulation: the mean
    over the positions whose label is not ``ignore_index``, and 0 (not NaN)
    when every position is ignored."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logprobs, -1, safe_labels[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def _next_token_labels(batch: dict) -> torch.Tensor:
    """Labels for causal LM: explicit ``labels``, or ``input_ids`` shifted
    left with the trailing position ignored."""
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(batch["input_ids"][:, 1:], (0, 1), value=-100)
    return labels


def lm_loss_fn(model, batch: dict) -> torch.Tensor:
    """Next-token LM loss, usable with `Accelerator.make_train_step`."""
    logits = model(batch["input_ids"])
    return cross_entropy_loss(logits, _next_token_labels(batch))


def chunked_cross_entropy(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100, chunk: int = 1024) -> torch.Tensor:
    """The tied head fused with the cross-entropy over row chunks, with no
    kernel (the reference's ``chunked_cross_entropy``): each ``[chunk, V]``
    tile of fp32 logits is made, reduced to its rows' logsumexp and label
    logit, and dropped; `torch.utils.checkpoint` makes it again in the
    backward, so the ``[N, V]`` logits never exist whole. The mean over the
    rows whose label is not ``ignore_index``, 0 when every row is."""
    def one_chunk(x: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        mask = lab != ignore_index
        safe = torch.where(mask, lab, torch.zeros_like(lab)).long()
        logits = F.linear(x.float(), wte.float())  # [chunk, V], exact products, fp32 sums
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[:, None])[:, 0]
        return ((lse - ll) * mask).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, hidden.shape[0], chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            one_chunk, hidden[lo:lo + chunk], labels[lo:lo + chunk], use_reentrant=False)
    return total / (labels != ignore_index).sum().clamp(min=1)


def lm_loss_fn_fused(model, batch: dict, chunk: int = 1024) -> torch.Tensor:
    """Next-token LM loss with the head fused into `chunked_cross_entropy`
    (``bench.py``'s ``BENCH_FUSED_CE=1``); drop-in for `lm_loss_fn` with
    `Accelerator.make_train_step`, whose `BoundModel` carries the
    compute-dtype ``wte.weight`` in ``model.params``."""
    hidden = model(batch["input_ids"], return_hidden=True)
    labels = _next_token_labels(batch)
    b, s, e = hidden.shape
    wte = model.params["wte.weight"].to(hidden.dtype)
    return chunked_cross_entropy(hidden.reshape(b * s, e), wte, labels.reshape(b * s), chunk=chunk)


def lm_loss_fn_pallas(model, batch: dict, block_r: int | None = None,
                      block_v: int | None = None) -> torch.Tensor:
    """Next-token LM loss with the tied head fused into the cross-entropy
    (`ops.fused_ce.fused_cross_entropy`): on a CUDA model the forward, dH and
    dW run in the port's hand-written CUDA kernels and the ``[b * s, V]``
    logits never reach memory; on the CPU their plain versions run. Named
    after the reference's Pallas loss it ports; drop-in for `lm_loss_fn`
    with `Accelerator.make_train_step`, whose `BoundModel` carries the
    compute-dtype ``wte.weight`` in ``model.params``. ``block_r`` and
    ``block_v`` are the reference's TPU tiles: accepted, so a call written
    for the reference runs, and ignored, since the CUDA kernels choose their
    own tiles."""
    hidden = model(batch["input_ids"], return_hidden=True)
    labels = _next_token_labels(batch)
    b, s, e = hidden.shape
    wte = model.params["wte.weight"].to(hidden.dtype)
    return fused_cross_entropy(hidden.reshape(b * s, e), wte, labels.reshape(b * s))


def gpt2_blockwise(config: GPT2Config):
    """GPT-2 as a `big_modeling.BlockwiseModel` for offload streaming:
    ``embed -> block_i... -> head``, each running `GPT2LMHead`'s own code
    (``embed``, a `Block`, ``head``) on a weightless ``meta`` model. Pair
    with `gpt2_blockwise_state_dict`."""
    from ..big_modeling import BlockwiseModel, call_block

    template = GPT2LMHead(config, device="meta")

    def make_block_fn(i: int):
        return lambda p, x: call_block(template.blocks[0], p, x, i)

    fns = [("embed", lambda p, ids: call_block(template, p, ids, method="embed"))]
    fns += [(f"block_{i}", make_block_fn(i)) for i in range(config.n_layer)]
    fns += [("head", lambda p, x: call_block(template, p, x, method="head"))]
    return BlockwiseModel(block_fns=fns)


def gpt2_blockwise_state_dict(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """`GPT2LMHead`'s state dict regrouped by block: ``embed`` (``wte``,
    ``wpe``), ``block_i``, ``head`` (``ln_f`` and the tied ``wte``, the same
    tensor as embed's, so the solver places the two as one unit)."""
    out: dict[str, Any] = {"embed": {"wte": {"weight": state_dict["wte.weight"]},
                                     "wpe": {"weight": state_dict["wpe.weight"]}}}
    n_layer = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    for i in range(n_layer):
        out[f"block_{i}"] = state_dict_subtree(state_dict, f"blocks.{i}.")
    out["head"] = {"ln_f": state_dict_subtree(state_dict, "ln_f."),
                   "wte": {"weight": state_dict["wte.weight"]}}
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of `params_from_jax`: this module's state dict as the
    reference's param tree (nested dicts of CPU tensors, ``[in, out]``
    kernels), what `Accelerator.save_model` exports. The state dict of an
    fp8 model gives the reference's variables, ``{"params": tree,
    "fp8_meta": collection}``, as its ``init_params`` returns them."""
    if any(is_meta_key(k) for k in state_dict):
        params = {k: v for k, v in state_dict.items() if not is_meta_key(k)}
        return {"params": params_to_jax(params),
                "fp8_meta": meta_to_jax(state_dict, "blocks", "block")}
    def get(name: str) -> torch.Tensor:
        return state_dict[name].detach().to("cpu", copy=True)

    tree: dict[str, Any] = {"wte": get("wte.weight"), "wpe": get("wpe.weight"),
                            "ln_f": {"scale": get("ln_f.weight"), "bias": get("ln_f.bias")}}
    n_layer = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    for i in range(n_layer):
        pre = f"blocks.{i}."
        blk: dict[str, Any] = {ln: {"scale": get(pre + f"{ln}.weight"), "bias": get(pre + f"{ln}.bias")}
                               for ln in ("ln_1", "ln_2")}
        for group, names in (("attn", ("qkv", "proj")), ("mlp", ("up", "down"))):
            blk[group] = {name: {"kernel": get(pre + f"{group}.{name}.weight").T.contiguous(),
                                 "bias": get(pre + f"{group}.{name}.bias")} for name in names}
        tree[f"block_{i}"] = blk
    return tree


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `GPT2LMHead`'s param tree (nested dicts of numpy arrays,
    per-layer ``block_i`` layout) as this module's state dict. Flax ``Dense``
    kernels are ``[in, out]``; ``nn.Linear`` weights are ``[out, in]``, so
    kernels are transposed. Load with ``model.load_state_dict(...)``. The tree
    may also be flat, dotted as a safetensors checkpoint of the reference
    stores it (``block_0.attn.qkv.kernel``), with torch tensors for leaves,
    which keep their dtype (pass this function as
    `utils.safetensors_io.load_checkpoint_in_model`'s ``mapper``). The
    reference's variables of an fp8 model, ``{"params": ..., "fp8_meta":
    ...}``, give the scaling buffers too."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)
    if "params" in tree:
        return {**params_from_jax(tree["params"]),
                **meta_from_jax(tree.get("fp8_meta", {}), "blocks", "block")}

    def t(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def _transposed(kernel):
        # a torch leaf stays a transposed view (moved to a device as it
        # lies, `safetensors_io.to_device`); a numpy one becomes contiguous
        w = t(kernel).T
        return w if isinstance(kernel, torch.Tensor) else w.contiguous()

    sd = {
        "wte.weight": t(tree["wte"]),
        "wpe.weight": t(tree["wpe"]),
        "ln_f.weight": t(tree["ln_f"]["scale"]),
        "ln_f.bias": t(tree["ln_f"]["bias"]),
    }
    n_layer = sum(1 for key in tree if key.startswith("block_"))
    for i in range(n_layer):
        blk, pre = tree[f"block_{i}"], f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + f"{ln}.weight"] = t(blk[ln]["scale"])
            sd[pre + f"{ln}.bias"] = t(blk[ln]["bias"])
        for group, names in (("attn", ("qkv", "proj")), ("mlp", ("up", "down"))):
            for name in names:
                sd[pre + f"{group}.{name}.weight"] = _transposed(blk[group][name]["kernel"])
                sd[pre + f"{group}.{name}.bias"] = t(blk[group][name]["bias"])
    return sd


def params_from_hf_gpt2(hf_state_dict: dict, config: GPT2Config) -> dict[str, torch.Tensor]:
    """A Hugging Face transformers GPT-2 state dict (``wte.weight``,
    ``h.{i}.attn.c_attn.weight``, ..., no ``transformer.`` prefix) as this
    module's state dict. HF's ``Conv1D`` weights are already ``[in, out]``,
    the reference's kernel layout, so they are transposed into ``nn.Linear``'s
    ``[out, in]``; ``c_attn``, ``c_proj``, ``c_fc`` and ``mlp.c_proj`` become
    ``qkv``, ``proj``, ``up`` and ``down``. Values keep their dtype."""
    def t(x):
        return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))

    sd = {"wte.weight": t(hf_state_dict["wte.weight"]),
          "wpe.weight": t(hf_state_dict["wpe.weight"]),
          "ln_f.weight": t(hf_state_dict["ln_f.weight"]),
          "ln_f.bias": t(hf_state_dict["ln_f.bias"])}
    names = (("attn.qkv", "attn.c_attn"), ("attn.proj", "attn.c_proj"),
             ("mlp.up", "mlp.c_fc"), ("mlp.down", "mlp.c_proj"))
    for i in range(config.n_layer):
        hf, pre = f"h.{i}.", f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + f"{ln}.weight"] = t(hf_state_dict[hf + f"{ln}.weight"])
            sd[pre + f"{ln}.bias"] = t(hf_state_dict[hf + f"{ln}.bias"])
        for ours, theirs in names:
            sd[pre + f"{ours}.weight"] = t(hf_state_dict[hf + f"{theirs}.weight"]).T.contiguous()
            sd[pre + f"{ours}.bias"] = t(hf_state_dict[hf + f"{theirs}.bias"])
    return sd
