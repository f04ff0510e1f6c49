"""T5: the port of `accelerate_tpu.models.t5`, the encoder-decoder family
(T5 v1.1 by default, v1.0 with ``gated_ffn=False``).

Architecture, as the reference: pre-norm blocks with an RMS LayerNorm (no
bias, no mean subtraction), a bucketed relative-position bias computed once
per stack and shared by every block's self-attention, unscaled attention
(``scale=1.0``), a gated tanh-GELU feed-forward (ReLU for v1.0), no
positional embeddings, and a tied or untied LM head (tied: the
``d_model**-0.5`` logit rescale).

Numerics follow the reference's flax modules:

  - parameters live in ``param_dtype``; every projection computes in
    ``dtype`` (input and weight cast to it, as flax ``Dense(dtype=...)``);
  - `T5LayerNorm` takes the mean square in fp32, casts the normalized
    states to ``dtype`` and multiplies by the scale cast to ``dtype``: the
    product is in ``dtype``, not fp32 (this is not BERT's LayerNorm);
  - the embeddings are ``shared[ids]`` cast to ``dtype``, unscaled;
  - the relative bias ``[1, H, Sq, Sk]`` is fp32 and is added to the fp32
    logits by `ops.attention.dot_product_attention` after the scale and
    before the masks; cross-attention takes no bias; the decoder's
    self-attention is causal and masked by ``decoder_attention_mask``;
  - the dense head runs in fp32 on fp32 hidden states; the fused head
    (`seq2seq_loss_fn_fused`) runs in the compute dtype, on the fused
    cross-entropy kernels (`ops.fused_ce`).

Attention is the plain path, as in the reference: the flash kernels take no
additive bias. Submodules carry the reference's names (``block_i``,
``self_attn``, ``ff/wi_0``, ...), so `params_from_jax` only transposes the
flax ``[in, out]`` kernels into ``[out, in]`` weights, and `params_to_jax`
(``reference_state_dict``) turns them back. Tensor and pipeline parallelism
(`t5_sharding_rules`, `t5_pipeline_forward`) wait for the multi-device
runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.fused_ce import fused_cross_entropy
from ..ops.moe import lecun_normal_
from ..utils.environment import resolve_device
from ..utils.safetensors_io import unflatten_state_dict
from .gpt2 import _dense


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.0
    tie_word_embeddings: bool = False  # v1.1 unties; v1.0 ties
    gated_ffn: bool = True  # v1.1 gated-GELU; False = v1.0 ReLU
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def base(cls, **kw) -> "T5Config":
        return cls(**kw)

    @classmethod
    def small(cls, **kw) -> "T5Config":
        return cls(**{**dict(d_model=512, d_ff=1024, num_layers=8, num_decoder_layers=8,
                             num_heads=6), **kw})

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        return cls(**{**dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                             num_decoder_layers=2, num_heads=4), **kw})


def _linear(n_in: int, n_out: int, config: T5Config, device: torch.device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=config.param_dtype)


class T5LayerNorm(nn.Module):
    """RMS norm, no bias, no mean subtraction: statistics in fp32, the scale
    applied in the compute dtype."""

    def __init__(self, config: T5Config, width: int, device: torch.device):
        super().__init__()
        self.config = config
        self.scale = nn.Parameter(torch.ones(width, device=device, dtype=config.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + cfg.layer_norm_eps)).to(cfg.dtype) * self.scale.to(cfg.dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (int32): half the buckets exact,
    half log-spaced. The reference's arithmetic in its order: ``log(n /
    max_exact + 1e-6)`` in fp32 (the ``1e-6`` is the reference's), divided by
    ``log(max_distance / max_exact)`` rounded to fp32, times the log buckets,
    truncated."""
    n = -relative_position.to(torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = float(np.float32(np.log(max_distance / max_exact)))  # the fp32 the reference divides by
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / denom * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5RelativeBias(nn.Module):
    """A stack's learned bias table ``[buckets, heads]``; returns the fp32
    bias ``[1, H, Sq, Sk]`` added to the attention logits."""

    def __init__(self, config: T5Config, bidirectional: bool, device: torch.device):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(torch.empty(
            config.relative_attention_num_buckets, config.num_heads, device=device,
            dtype=config.param_dtype))

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        cfg = self.config
        dev = self.rel_embedding.device
        ctx = torch.arange(q_len, device=dev)[:, None]
        mem = torch.arange(k_len, device=dev)[None, :]
        bucket = relative_position_bucket(mem - ctx, self.bidirectional,
                                          cfg.relative_attention_num_buckets,
                                          cfg.relative_attention_max_distance)
        bias = self.rel_embedding[bucket.long()]  # [Sq, Sk, H]
        return bias.permute(2, 0, 1)[None].float()


class T5Attention(nn.Module):
    """Self- or cross-attention, unscaled (T5 folds the scale into its
    initialization), head width ``d_kv`` independent of ``d_model``."""

    def __init__(self, config: T5Config, device: torch.device):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = _linear(config.d_model, inner, config, device)
        self.k = _linear(config.d_model, inner, config, device)
        self.v = _linear(config.d_model, inner, config, device)
        self.o = _linear(inner, config.d_model, config, device)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None,
                bias: torch.Tensor | None = None, mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        kv = x if kv is None else kv
        heads = (cfg.num_heads, cfg.d_kv)
        q = _dense(x, self.q, cfg.dtype).reshape(b, s, *heads)
        k = _dense(kv, self.k, cfg.dtype).reshape(b, kv.shape[1], *heads)
        v = _dense(kv, self.v, cfg.dtype).reshape(b, kv.shape[1], *heads)
        out = dot_product_attention(q, k, v, bias=bias, mask=mask, causal=causal, scale=1.0)
        return _dense(out.reshape(b, s, -1), self.o, cfg.dtype)


class T5FeedForward(nn.Module):
    """Gated tanh-GELU (``wi_0``, ``wi_1``, ``wo``), or ReLU (``wi``, ``wo``)
    for v1.0."""

    def __init__(self, config: T5Config, device: torch.device):
        super().__init__()
        self.config = config
        e, f = config.d_model, config.d_ff
        if config.gated_ffn:
            self.wi_0 = _linear(e, f, config, device)
            self.wi_1 = _linear(e, f, config, device)
        else:
            self.wi = _linear(e, f, config, device)
        self.wo = _linear(f, e, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        if self.config.gated_ffn:
            h = F.gelu(_dense(x, self.wi_0, dtype), approximate="tanh") * _dense(x, self.wi_1, dtype)
        else:
            h = F.relu(_dense(x, self.wi, dtype))
        return _dense(h, self.wo, dtype)


class T5Block(nn.Module):
    def __init__(self, config: T5Config, is_decoder: bool, device: torch.device):
        super().__init__()
        self.is_decoder = is_decoder
        self.ln_self = T5LayerNorm(config, config.d_model, device)
        self.self_attn = T5Attention(config, device)
        if is_decoder:
            self.ln_cross = T5LayerNorm(config, config.d_model, device)
            self.cross_attn = T5Attention(config, device)
        self.ln_ff = T5LayerNorm(config, config.d_model, device)
        self.ff = T5FeedForward(config, device)

    def forward(self, x: torch.Tensor, self_bias: torch.Tensor | None,
                enc_out: torch.Tensor | None = None, self_mask: torch.Tensor | None = None,
                cross_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.ln_self(x), bias=self_bias, mask=self_mask,
                               causal=self.is_decoder)
        if self.is_decoder:
            x = x + self.cross_attn(self.ln_cross(x), kv=enc_out, mask=cross_mask)
        return x + self.ff(self.ln_ff(x))


class T5Stack(nn.Module):
    def __init__(self, config: T5Config, is_decoder: bool, device: torch.device):
        super().__init__()
        self.rel_bias = T5RelativeBias(config, not is_decoder, device)
        n = config.num_decoder_layers if is_decoder else config.num_layers
        self.block_names = [f"block_{i}" for i in range(n)]
        for name in self.block_names:
            self.add_module(name, T5Block(config, is_decoder, device))
        self.ln_final = T5LayerNorm(config, config.d_model, device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor | None = None,
                self_mask: torch.Tensor | None = None,
                cross_mask: torch.Tensor | None = None) -> torch.Tensor:
        s = x.shape[1]
        bias = self.rel_bias(s, s)  # once per stack, shared by every block
        for name in self.block_names:
            x = getattr(self, name)(x, bias, enc_out, self_mask, cross_mask)
        return self.ln_final(x)


def _key_mask(mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if mask is None else mask[:, None, None, :].bool()


class T5ForConditionalGeneration(nn.Module):
    """The encoder-decoder LM: fp32 logits ``[b, tgt, vocab]``, or with
    ``return_hidden`` the decoder's normed states in the compute dtype.

    ``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). Weights are drawn from ``seed``
    with the reference's initializers: normal(1.0) for the shared
    embedding, normal(0.02) for the relative-bias tables, flax's lecun
    normal (a normal of std ``1/sqrt(fan_in)`` truncated at two deviations)
    for every projection and the untied head, unit norm scales."""

    def __init__(self, config: T5Config, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        v, e, pd = config.vocab_size, config.d_model, config.param_dtype
        self.shared_embedding = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))
        self.encoder = T5Stack(config, False, device)
        self.decoder = T5Stack(config, True, device)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))  # [V, e]
        if device.type != "meta":
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.shared_embedding.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.shared_embedding.normal_(0.0, 1.0, generator=g)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, g, mod.in_features)
            elif isinstance(mod, T5RelativeBias):
                mod.rel_embedding.normal_(0.0, 0.02, generator=g)
            elif isinstance(mod, T5LayerNorm):
                mod.scale.fill_(1.0)
        if not self.config.tie_word_embeddings:
            lecun_normal_(self.lm_head, g, self.config.d_model)

    def forward(self, input_ids: torch.Tensor, decoder_input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                decoder_attention_mask: torch.Tensor | None = None,
                return_hidden: bool = False) -> torch.Tensor:
        cfg = self.config
        enc_mask = _key_mask(attention_mask)
        dec_mask = _key_mask(decoder_attention_mask)
        enc_x = self.shared_embedding[input_ids.long()].to(cfg.dtype)
        enc_out = self.encoder(enc_x, self_mask=enc_mask)
        dec_x = self.shared_embedding[decoder_input_ids.long()].to(cfg.dtype)
        dec_out = self.decoder(dec_x, enc_out=enc_out, self_mask=dec_mask, cross_mask=enc_mask)
        if return_hidden:
            # the fused loss folds the head (tied rescale included) into the kernels
            return dec_out
        dec_out = dec_out.float()
        if cfg.tie_word_embeddings:
            return F.linear(dec_out * cfg.d_model ** -0.5, self.shared_embedding.float())
        return F.linear(dec_out, self.lm_head.float())

    def reference_state_dict(self) -> dict[str, Any]:
        """The weights under the reference's names and layout (nested dicts
        of CPU tensors, flax ``[in, out]`` kernels): what
        `Accelerator.save_model` exports."""
        return params_to_jax(self.state_dict())


def t5_sharding_rules() -> Any:
    """Megatron-style tensor parallelism over a device mesh: not ported yet."""
    raise NotImplementedError(
        "t5_sharding_rules splits attention, the feed-forward and the embeddings over a "
        "device mesh, which is not ported yet (ROADMAP Queue 1, item 21.3)")


def t5_pipeline_forward(config: T5Config, params: dict, mesh: Any = None,
                        num_microbatches: int | None = None, axis_name: str = "stage") -> Any:
    """Both stacks pipelined over a ``stage`` mesh axis: not ported yet. The
    reference refuses a stage axis of 1, so one card has no pipeline to
    run."""
    raise NotImplementedError(
        "t5_pipeline_forward needs a 'stage' mesh axis of more than one device, and meshes "
        "are not ported yet (ROADMAP Queue 1, item 21.3)")


def _model_inputs(batch: dict) -> tuple:
    return (batch["input_ids"], batch["decoder_input_ids"], batch.get("attention_mask"),
            batch.get("decoder_attention_mask"))


def seq2seq_loss_fn(model, batch: dict) -> torch.Tensor:
    """Cross-entropy over the decoder targets, padded labels (-100, the HF
    convention) masked out; the mean over the valid tokens (0 with none).
    Batch keys: ``input_ids``, ``decoder_input_ids``, ``labels`` and
    optionally the two attention masks. Usable with
    `Accelerator.make_train_step`."""
    logits = model(*_model_inputs(batch))
    labels = batch["labels"].long()
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(torch.log_softmax(logits.float(), dim=-1), -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def seq2seq_loss_fn_fused(model, batch: dict, block_r: int | None = None,
                          block_v: int | None = None) -> torch.Tensor:
    """`seq2seq_loss_fn` with the head fused into the cross-entropy
    (`ops.fused_ce.fused_cross_entropy`): on a CUDA model the forward, dH
    and dW run in the port's CUDA kernels and the ``[b * tgt, V]`` logits
    never reach memory; on the CPU their plain versions run. The head comes
    from ``model.params`` (the `BoundModel` of ``make_train_step``), in the
    hidden states' dtype: tied, the shared table with the ``d_model**-0.5``
    rescale folded into the hidden states; untied, ``lm_head`` ``[V, e]``.
    The head's product runs in the compute dtype (the dense path's in fp32):
    equal in fp32, within bf16 rounding otherwise. ``block_r`` and
    ``block_v`` are the reference's TPU tiles: accepted and ignored, the
    kernels choose their own."""
    del block_r, block_v
    hidden = model(*_model_inputs(batch), return_hidden=True)
    b, s, e = hidden.shape
    if "lm_head" not in model.params:
        head = model.params["shared_embedding"].to(hidden.dtype)
        hidden = hidden * e ** -0.5
    else:
        head = model.params["lm_head"].to(hidden.dtype)
    return fused_cross_entropy(hidden.reshape(b * s, e), head, batch["labels"].reshape(b * s))


def shift_tokens_right(labels: torch.Tensor, decoder_start_token_id: int = 0) -> torch.Tensor:
    """Decoder inputs from labels (teacher forcing), -100 replaced by 0."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.zeros_like(shifted), shifted)


def params_from_hf_t5(hf_state_dict: dict, config: T5Config) -> dict[str, torch.Tensor]:
    """A Hugging Face ``T5ForConditionalGeneration`` state dict (``[out,
    in]`` Linear weights) as this module's state dict, by the reference's
    mapping: the first block's relative-attention table is each stack's."""

    def t(x: Any) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return x.detach().to("cpu", torch.float32)

    def kernel(key: str) -> dict:
        return {"kernel": t(hf_state_dict[key]).T}

    tree: dict[str, Any] = {"shared_embedding": t(hf_state_dict["shared.weight"])}
    if not config.tie_word_embeddings and "lm_head.weight" in hf_state_dict:
        tree["lm_head"] = kernel("lm_head.weight")
    for side, n_layers, is_dec in (("encoder", config.num_layers, False),
                                   ("decoder", config.num_decoder_layers, True)):
        stack: dict[str, Any] = {
            "rel_bias": {"rel_embedding": t(hf_state_dict[
                f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])},
            "ln_final": {"scale": t(hf_state_dict[f"{side}.final_layer_norm.weight"])},
        }
        for i in range(n_layers):
            pre = f"{side}.block.{i}.layer"
            ff_idx = 2 if is_dec else 1
            blk: dict[str, Any] = {
                "ln_self": {"scale": t(hf_state_dict[f"{pre}.0.layer_norm.weight"])},
                "self_attn": {w: kernel(f"{pre}.0.SelfAttention.{w}.weight")
                              for w in ("q", "k", "v", "o")},
                "ln_ff": {"scale": t(hf_state_dict[f"{pre}.{ff_idx}.layer_norm.weight"])},
            }
            if is_dec:
                blk["ln_cross"] = {"scale": t(hf_state_dict[f"{pre}.1.layer_norm.weight"])}
                blk["cross_attn"] = {w: kernel(f"{pre}.1.EncDecAttention.{w}.weight")
                                     for w in ("q", "k", "v", "o")}
            names = ("wi_0", "wi_1", "wo") if config.gated_ffn else ("wi", "wo")
            blk["ff"] = {w: kernel(f"{pre}.{ff_idx}.DenseReluDense.{w}.weight") for w in names}
            stack[f"block_{i}"] = blk
        tree[side] = stack
    return params_from_jax(tree)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `T5ForConditionalGeneration`'s param tree (nested dicts
    of numpy arrays; or flat and dotted, as a safetensors export stores it,
    with torch leaves) as this module's state dict: every flax ``kernel``
    ``[in, out]`` becomes a ``weight`` ``[out, in]`` (``lm_head``'s becomes
    the ``lm_head`` parameter itself); the other leaves keep their names."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

    def t(x: Any) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}

    def visit(node: dict, prefix: str) -> None:
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                visit(value, f"{name}.")
            elif key == "kernel":
                target = "lm_head" if prefix == "lm_head." else f"{prefix}weight"
                sd[target] = t(value).T.contiguous()
            else:
                sd[name] = t(value)

    visit(tree, "")
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of `params_from_jax`: this module's state dict as the
    reference's param tree (nested dicts of CPU tensors)."""
    tree: dict[str, Any] = {}
    for key, value in state_dict.items():
        value = value.detach().to("cpu", copy=True)
        path = key.split(".")
        if key == "lm_head" or path[-1] == "weight":
            path = (path[:-1] if path[-1] == "weight" else path) + ["kernel"]
            value = value.T.contiguous()
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree

