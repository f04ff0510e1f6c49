"""Llama family: the port of `accelerate_tpu.models.llama`, for training and
decode.

A decoder stack of RMSNorm (fp32 statistics), rotary position embeddings,
grouped-query attention, a SwiGLU MLP and no biases. With
``LlamaConfig.sliding_window`` the attention is Mistral-class: query i sees
keys in ``(i - W, i]``, and on the flash path it runs on the band kernels
(`ops.flash_attention`), with GQA K/V read unrepeated.

Numerics follow the reference: parameters live in ``param_dtype`` and every
projection computes in ``dtype`` (input and weight cast to it, as flax
``Dense(dtype=...)`` does); RMSNorm computes its statistics and the scale in
fp32 and casts the result to its input's dtype; RoPE rotates split halves in
fp32 and casts back; the untied head gives fp32 logits from compute-dtype
operands.

Decode runs over the slot KV cache (`kv_cache.SlotKVCache`, the reference's
``decode=True`` branch): the step's tokens are rotated at ``position_offset``,
written at the cache's index (int8 with fp32 scales under
``LlamaConfig.kv_cache_dtype=torch.int8``), and attend the whole
``[b, max_position_embeddings, ...]`` buffer under the mask ``k_idx <= q_pos``
(and ``k_idx > q_pos - window`` with a sliding window) through the plain
attention, which repeats GQA K/V heads as the reference's does.

Quantized weights (`utils.quantization.quantize_module`, `quantize_model`,
`load_and_quantize_model`) take GPT-2's route: a `QuantizedLinear`
projection runs through `ops.nf4_matmul.nf4_matmul` (the CUDA kernel for the
nf4 weights it routes there, ``x @ dequantize(W)`` for the rest), and the
quantized ``embed_tokens`` and ``lm_head`` (`QuantizedEmbedding`)
dequantize the rows they read and the whole head.

Ported: the full-sequence forward (training), decode, `llama_loss_fn` and
`params_from_jax`. Not yet: ``attention_impl="ring"`` (it raises
NotImplementedError naming its ROADMAP item), ``remat``, ``fp8_recipe`` and
`llama_loss_fn_fused`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..utils.environment import resolve_device
from ..utils.quantization import QuantizedEmbedding, dequantize
from ..utils.safetensors_io import unflatten_state_dict
from .gpt2 import _dense, _embed, _next_token_labels, cross_entropy_loss
from .kv_cache import (
    SlotKVCache,
    advance_index,
    decode_cache_update,
    slot_attention_mask,
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 4096
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"  # 'xla' | 'flash' | 'auto' | 'ring' (not ported)
    sliding_window: int | None = None  # Mistral-class: query i sees keys in (i-W, i]
    kv_cache_dtype: torch.dtype | None = None  # None (compute dtype) | torch.int8 (kv_cache.py)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                             num_layers=32, num_heads=32, num_kv_heads=8,
                             rope_theta=500000.0, max_position_embeddings=8192), **kw})

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config."""
        return cls(**{**dict(vocab_size=256, max_position_embeddings=128, hidden_size=64,
                             intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2), **kw})


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x * rsqrt(mean(x^2) + eps) * scale`` on fp32 copies, the result
        in x's dtype."""
        return F.rms_norm(x.float(), (x.shape[-1],), self.scale.float(), self.eps).to(x.dtype)


def rope_frequencies(head_dim: int, positions: torch.Tensor,
                     theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables ``[*positions.shape, head_dim / 2]`` in fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[b, s, h, d]``; cos and sin ``[s, d / 2]``: the split-half
    rotation in fp32, cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device: torch.device):
        super().__init__()
        self.config = config
        e, hd, pd = config.hidden_size, config.head_dim, config.param_dtype
        self.q_proj = nn.Linear(e, config.num_heads * hd, bias=False, device=device, dtype=pd)
        self.k_proj = nn.Linear(e, config.num_kv_heads * hd, bias=False, device=device, dtype=pd)
        self.v_proj = nn.Linear(e, config.num_kv_heads * hd, bias=False, device=device, dtype=pd)
        self.o_proj = nn.Linear(config.num_heads * hd, e, bias=False, device=device, dtype=pd)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, layer: int = 0,
                cache: SlotKVCache | None = None, write_mask: torch.Tensor | None = None,
                write_len: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        hd = cfg.head_dim
        q = _dense(x, self.q_proj, cfg.dtype).reshape(b, s, cfg.num_heads, hd)
        k = _dense(x, self.k_proj, cfg.dtype).reshape(b, s, cfg.num_kv_heads, hd)
        v = _dense(x, self.v_proj, cfg.dtype).reshape(b, s, cfg.num_kv_heads, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if cache is not None:
            k_all, v_all, idx = decode_cache_update(cache, layer, k, v, write_mask, write_len)
            mask = slot_attention_mask(idx, s, cache.max_len, cfg.sliding_window)
            # GQA heads are repeated inside attention(), as in training
            out = attention(q, k_all, v_all, mask=mask, implementation="xla")
        else:
            # GQA K/V go through unrepeated: the band kernels read the grouped
            # kv head directly, the other paths repeat inside attention()
            out = attention(q, k, v, causal=True, window=cfg.sliding_window,
                            implementation=cfg.attention_impl)
        return _dense(out.reshape(b, s, e), self.o_proj, cfg.dtype)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device: torch.device):
        super().__init__()
        self.config = config
        e, f, pd = config.hidden_size, config.intermediate_size, config.param_dtype
        self.gate_proj = nn.Linear(e, f, bias=False, device=device, dtype=pd)
        self.up_proj = nn.Linear(e, f, bias=False, device=device, dtype=pd)
        self.down_proj = nn.Linear(f, e, bias=False, device=device, dtype=pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        gate = _dense(x, self.gate_proj, dtype)
        return _dense(F.silu(gate) * _dense(x, self.up_proj, dtype), self.down_proj, dtype)


class LlamaBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``."""

    def __init__(self, config: LlamaConfig, device: torch.device):
        super().__init__()
        e, eps, pd = config.hidden_size, config.rms_norm_eps, config.param_dtype
        self.input_norm = RMSNorm(e, eps, device, pd)
        self.attn = LlamaAttention(config, device)
        self.post_attn_norm = RMSNorm(e, eps, device, pd)
        self.mlp = LlamaMLP(config, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, layer: int = 0,
                **decode) -> torch.Tensor:
        x = x + self.attn(self.input_norm(x), cos, sin, layer, **decode)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM. ``forward`` returns fp32 logits ``[batch, seq, vocab]``.

    ``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). Weights are drawn from ``seed``:
    normal(0.02) for ``embed_tokens`` and ``lm_head`` (the reference's
    initializers), normal(1/sqrt(fan_in)) for projection weights, unit
    RMSNorm scales. On ``device="meta"`` nothing is drawn: the module only
    has shapes, for `utils.quantization.load_and_quantize_model` to fill
    from a checkpoint."""

    # bare tables that `utils.quantization` may quantize, as the reference
    # quantizes every large leaf; forward and `logits` read them quantized
    quantizable_tables = ("embed_tokens", "lm_head")

    def __init__(self, config: LlamaConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        if config.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' is not ported yet: ring attention needs the "
                "sequence-parallel mesh on torch.distributed (ROADMAP Queue 1, item 21)"
            )
        self.config = config
        device = resolve_device(device)
        v, e, pd = config.vocab_size, config.hidden_size, config.param_dtype
        self.embed_tokens = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))
        self.layers = nn.ModuleList(LlamaBlock(config, device) for _ in range(config.num_layers))
        self.final_norm = RMSNorm(e, config.rms_norm_eps, device, pd)
        self.lm_head = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))
        if device.type != "meta":
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed_tokens.normal_(0.0, 0.02, generator=g)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=g)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
        self.lm_head.normal_(0.0, 0.02, generator=g)

    def forward(self, input_ids: torch.Tensor, position_offset: int | torch.Tensor = 0, *,
                decode: bool = False, cache: SlotKVCache | None = None,
                write_mask: torch.Tensor | None = None,
                write_len: torch.Tensor | None = None,
                return_hidden: bool = False) -> torch.Tensor:
        """The forward over ``input_ids`` ``[b, s]`` at positions
        ``position_offset + arange(s)``: causal over the input, or, with
        ``cache`` (``decode=True`` says the same and needs one), decode over
        the slot cache: the tokens are written at ``cache.index`` (see
        `kv_cache.decode_cache_update` for ``write_mask`` and ``write_len``)
        and the index advances past them. ``return_hidden`` returns the final
        RMSNorm output in the compute dtype instead of logits (see
        `logits`). ``position_offset`` may be a 0-d device tensor (a slot
        cache's index), read without a host sync, so a CUDA graph can
        capture a decode step."""
        if decode and cache is None:
            raise ValueError("decode=True needs the slot cache: pass "
                             "cache=kv_cache.make_cache(model, batch)")
        cfg = self.config
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device) + position_offset
        cos, sin = rope_frequencies(cfg.head_dim, positions, cfg.rope_theta)
        x = _embed(self.embed_tokens, input_ids).to(cfg.dtype)
        step = {} if cache is None else dict(cache=cache, write_mask=write_mask,
                                             write_len=write_len)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, i, **step)
        if cache is not None:
            advance_index(cache, s, write_mask, write_len)
        x = self.final_norm(x)
        return x if return_hidden else self.logits(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Untied LM head over compute-dtype hidden states: fp32 logits. The
        product runs on fp32 copies of the compute-dtype operands, so with
        bf16 weights the products are exact and the sums fp32: the
        reference's bf16 einsum with ``preferred_element_type=float32``."""
        dtype = self.config.dtype
        if isinstance(self.lm_head, QuantizedEmbedding):
            return F.linear(hidden.to(dtype).float(),
                            dequantize(self.lm_head.qweight, dtype).float())
        return F.linear(hidden.to(dtype).float(), self.lm_head.to(dtype).float())


def llama_loss_fn(model, batch: dict) -> torch.Tensor:
    """Next-token LM loss, usable with `Accelerator.make_train_step`."""
    logits = model(batch["input_ids"])
    return cross_entropy_loss(logits, _next_token_labels(batch))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `LlamaForCausalLM`'s param tree (nested dicts of numpy
    arrays, per-layer ``layer_i`` layout) as this module's state dict. Flax
    ``Dense`` kernels are ``[in, out]``; ``nn.Linear`` weights are ``[out,
    in]``, so kernels are transposed. ``embed_tokens`` and ``lm_head`` stay
    ``[vocab, hidden]``. Load with ``model.load_state_dict(...)``. The tree
    may also be flat, dotted as a safetensors checkpoint of the reference
    stores it (``layer_0.attn.q_proj.kernel``), with torch tensors for
    leaves, which keep their dtype (`utils.safetensors_io` reads such a
    checkpoint; pass this function as its ``mapper``)."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

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
        "embed_tokens": t(tree["embed_tokens"]),
        "lm_head": t(tree["lm_head"]),
        "final_norm.scale": t(tree["final_norm"]["scale"]),
    }
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        blk, pre = tree[f"layer_{i}"], f"layers.{i}."
        for norm in ("input_norm", "post_attn_norm"):
            sd[pre + f"{norm}.scale"] = t(blk[norm]["scale"])
        for group, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                sd[pre + f"{group}.{name}.weight"] = _transposed(blk[group][name]["kernel"])
    return sd

