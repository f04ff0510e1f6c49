"""Mixtral: the port of `accelerate_tpu.models.mixtral`, the Llama backbone
with a sparse top-k mixture of SwiGLU experts in every layer.

Routing follows the reference as written (`models/mixtral.py:93-142`): the
router runs in fp32, each token takes its top-k router logits, the softmax
is over those selected logits only, and the experts see the tokens through
the static-capacity dispatch and combine tensors of
`ops.moe.build_dispatch_combine` (tokens past an expert's capacity fall
through on the residual stream; ``capacity_factor >= num_experts / top_k``
drops none). The expert products are einsums, as the reference computes
them outside any kernel. The load-balancing aux loss counts every top-k
selection against the mean full-softmax probability and is divided by
``num_layers`` (Hugging Face computes one loss over every layer's gates);
it is sown per layer under ``aux_loss`` (`utils.intermediates`) and added
by the loss functions through ``collect_aux_losses(model.extra_state)``.

Attention, norms, RoPE, the embedding, the untied head and decode over the
slot cache are the Llama port's (`models.llama`): `MixtralForCausalLM` is a
`LlamaForCausalLM` whose layers are `MixtralBlock`. Expert parallelism
(`mixtral_sharding_rules`) waits for the multi-device runtime.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_ce import fused_cross_entropy
from ..ops.moe import (
    build_dispatch_combine,
    collect_aux_losses,
    expert_capacity,
    lecun_normal_,
    stacked_fan_in,
)
from ..utils.environment import resolve_device
from ..utils.intermediates import sow
from ..utils.safetensors_io import unflatten_state_dict
from .gpt2 import _next_token_labels, cross_entropy_loss
from .llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    RMSNorm,
    decoder_blockwise,
    decoder_blockwise_state_dict,
)


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 4096
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_weight: float = 0.001  # HF MixtralConfig.router_aux_loss_coef
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_policy: Any = None  # utils/remat.py
    attention_impl: str = "auto"
    sliding_window: int | None = None
    kv_cache_dtype: torch.dtype | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        return cls(**{**dict(vocab_size=256, max_position_embeddings=128, hidden_size=64,
                             intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
                             num_experts=4, top_k=2), **kw})

    def as_llama(self) -> LlamaConfig:
        """The attention and backbone settings, as the Llama port takes them."""
        return LlamaConfig(
            vocab_size=self.vocab_size, max_position_embeddings=self.max_position_embeddings,
            hidden_size=self.hidden_size, intermediate_size=self.intermediate_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, rope_theta=self.rope_theta,
            rms_norm_eps=self.rms_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            remat=self.remat, remat_policy=self.remat_policy,
            attention_impl=self.attention_impl, sliding_window=self.sliding_window,
            kv_cache_dtype=self.kv_cache_dtype,
        )


class MixtralSparseMoeBlock(nn.Module):
    """Top-k routed SwiGLU experts, ``w1`` (gate) and ``w3`` (up) ``[E, e,
    f]``, ``w2`` (down) ``[E, f, e]``, behind an fp32 ``gate`` router."""

    def __init__(self, config: MixtralConfig, device: torch.device):
        super().__init__()
        self.config = config
        E, e, f, pd = config.num_experts, config.hidden_size, config.intermediate_size, \
            config.param_dtype
        self.gate = nn.Linear(e, E, bias=False, device=device, dtype=pd)
        self.w1 = nn.Parameter(torch.empty(E, e, f, device=device, dtype=pd))
        self.w3 = nn.Parameter(torch.empty(E, e, f, device=device, dtype=pd))
        self.w2 = nn.Parameter(torch.empty(E, f, e, device=device, dtype=pd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        n_tokens, E, k, dtype = b * s, cfg.num_experts, cfg.top_k, cfg.dtype
        capacity = expert_capacity(cfg.capacity_factor, n_tokens, k, E)
        xt = x.reshape(n_tokens, e)
        router_logits = F.linear(xt.float(), self.gate.weight.float())
        top_logits, expert_idx = torch.topk(router_logits, k, dim=-1)
        gate_vals = torch.softmax(top_logits, dim=-1)
        dispatch, combine = build_dispatch_combine(expert_idx, gate_vals, E, capacity, dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch, xt.to(dtype))
        gate_h = torch.einsum("ecd,edf->ecf", expert_in, self.w1.to(dtype))
        up_h = torch.einsum("ecd,edf->ecf", expert_in, self.w3.to(dtype))
        expert_out = torch.einsum("ecf,efd->ecd", F.silu(gate_h) * up_h, self.w2.to(dtype))
        out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
        me = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
        ce = torch.softmax(router_logits, dim=-1).mean(dim=0)
        sow("aux_loss", cfg.aux_loss_weight * E * (me * ce).sum() / cfg.num_layers)
        return out.reshape(b, s, e).to(x.dtype)


class MixtralBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + moe(norm(x))``."""

    def __init__(self, config: MixtralConfig, device: torch.device):
        super().__init__()
        e, eps, pd = config.hidden_size, config.rms_norm_eps, config.param_dtype
        self.input_norm = RMSNorm(e, eps, device, pd)
        self.attn = LlamaAttention(config.as_llama(), device)
        self.post_attn_norm = RMSNorm(e, eps, device, pd)
        self.moe = MixtralSparseMoeBlock(config, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, layer: int = 0,
                **decode) -> torch.Tensor:
        x = x + self.attn(self.input_norm(x), cos, sin, layer, **decode)
        return x + self.moe(self.post_attn_norm(x))


class MixtralForCausalLM(LlamaForCausalLM):
    """Decoder-only MoE LM: `LlamaForCausalLM`'s forward (``attention_impl``,
    ``remat``, ``return_hidden``, decode over the slot cache) and fp32
    logits, over `MixtralBlock` layers.

    ``device=None`` means CUDA (pass ``device="cpu"`` for the plain path);
    on ``"meta"`` nothing is drawn. Weights come from ``seed``: normal(0.02)
    for ``embed_tokens`` and ``lm_head``, normal(1/sqrt(fan_in)) for the
    attention projections, flax's lecun normal for the router and the
    experts (the reference's initializers there), unit RMSNorm scales."""

    def __init__(self, config: MixtralConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        nn.Module.__init__(self)
        if config.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' is not ported yet: ring attention needs the "
                "sequence-parallel mesh on torch.distributed (ROADMAP Queue 1, item 21)"
            )
        self.config = config
        device = resolve_device(device)
        v, e, pd = config.vocab_size, config.hidden_size, config.param_dtype
        self.embed_tokens = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))
        self.layers = nn.ModuleList(MixtralBlock(config, device) for _ in range(config.num_layers))
        self.final_norm = RMSNorm(e, config.rms_norm_eps, device, pd)
        self.lm_head = nn.Parameter(torch.empty(v, e, device=device, dtype=pd))
        if device.type != "meta":
            self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed_tokens.normal_(0.0, 0.02, generator=g)
        for mod in self.modules():
            if isinstance(mod, MixtralSparseMoeBlock):
                lecun_normal_(mod.gate.weight, g, mod.gate.in_features)
                for w in (mod.w1, mod.w3, mod.w2):
                    lecun_normal_(w, g, stacked_fan_in(w))
            elif isinstance(mod, LlamaAttention):
                for lin in (mod.q_proj, mod.k_proj, mod.v_proj, mod.o_proj):
                    lin.weight.normal_(0.0, 1.0 / math.sqrt(lin.in_features), generator=g)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
        self.lm_head.normal_(0.0, 0.02, generator=g)


def mixtral_sharding_rules() -> Any:
    """Tensor and expert parallelism over a device mesh: not ported yet."""
    raise NotImplementedError(
        "mixtral_sharding_rules shards attention and the expert axis over a device mesh, "
        "which is not ported yet (ROADMAP Queue 1, item 21.3)")


def mixtral_blockwise(config: MixtralConfig):
    """Mixtral as a `big_modeling.BlockwiseModel` (``embed -> layer_i... ->
    head``, as the full forward computes); pair with
    `mixtral_blockwise_state_dict`. Nothing collects the routers' aux terms
    on this path."""
    return decoder_blockwise(MixtralForCausalLM(config, device="meta"))


def mixtral_blockwise_state_dict(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """`MixtralForCausalLM`'s state dict regrouped by block: ``embed``,
    ``layer_i``, ``head``."""
    return decoder_blockwise_state_dict(state_dict)


def mixtral_loss_fn(model, batch: dict) -> torch.Tensor:
    """Next-token LM loss plus the routers' aux terms of this forward, for
    `Accelerator.make_train_step` (whose `BoundModel` collects them) or on a
    `PreparedModel` (which collects them too). A bare module has no
    ``extra_state`` and raises: it would drop the aux terms."""
    logits = model(batch["input_ids"])
    aux = collect_aux_losses(model.extra_state).to(logits.device)
    return cross_entropy_loss(logits, _next_token_labels(batch)) + aux


def mixtral_loss_fn_fused(model, batch: dict, block_r: int | None = None,
                          block_v: int | None = None) -> torch.Tensor:
    """`mixtral_loss_fn` with the untied head fused into the cross-entropy
    (`ops.fused_ce.fused_cross_entropy`: the CUDA kernels on a CUDA model,
    their plain versions on the CPU), plus the aux terms. ``block_r`` and
    ``block_v`` are the reference's TPU tiles: accepted and ignored."""
    del block_r, block_v
    hidden = model(batch["input_ids"], return_hidden=True)
    aux = collect_aux_losses(model.extra_state).to(hidden.device)
    labels = _next_token_labels(batch)
    b, s, e = hidden.shape
    head = model.params["lm_head"].to(hidden.dtype)
    return fused_cross_entropy(hidden.reshape(b * s, e), head, labels.reshape(b * s)) + aux


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `MixtralForCausalLM`'s param tree (nested dicts of numpy
    arrays, or the dotted flat keys of its safetensors export) as this
    module's state dict: ``[in, out]`` Dense kernels transposed to
    ``nn.Linear``'s ``[out, in]``, the expert stacks ``w1``/``w3``/``w2``
    kept in their ``[E, in, out]`` layout. Load with
    ``model.load_state_dict(...)``."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

    def transposed(kernel: Any) -> torch.Tensor:
        w = _tensor(kernel).T
        return w if isinstance(kernel, torch.Tensor) else w.contiguous()

    sd = {"embed_tokens": _tensor(tree["embed_tokens"]), "lm_head": _tensor(tree["lm_head"]),
          "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        blk, pre = tree[f"layer_{i}"], f"layers.{i}."
        for norm in ("input_norm", "post_attn_norm"):
            sd[pre + f"{norm}.scale"] = _tensor(blk[norm]["scale"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"attn.{name}.weight"] = transposed(blk["attn"][name]["kernel"])
        sd[pre + "moe.gate.weight"] = transposed(blk["moe"]["gate"]["kernel"])
        for name in ("w1", "w3", "w2"):
            sd[pre + f"moe.{name}"] = _tensor(blk["moe"][name])
    return sd


def params_from_hf_mixtral(hf_state_dict: dict, config: MixtralConfig) -> dict[str, torch.Tensor]:
    """A Hugging Face transformers ``MixtralForCausalLM`` state dict as this
    module's: attention and router weights keep HF's ``[out, in]`` layout
    (``nn.Linear``'s), and each layer's experts ``block_sparse_moe.experts.{j}.w1/w3/w2``
    are transposed and stacked on a leading expert axis. Values keep their
    dtype."""

    def t(x: Any) -> torch.Tensor:
        return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))

    sd = {"embed_tokens": t(hf_state_dict["model.embed_tokens.weight"]),
          "final_norm.scale": t(hf_state_dict["model.norm.weight"]),
          "lm_head": t(hf_state_dict["lm_head.weight"])}
    for i in range(config.num_layers):
        hf, pre = f"model.layers.{i}.", f"layers.{i}."
        moe = hf + "block_sparse_moe."
        sd[pre + "input_norm.scale"] = t(hf_state_dict[hf + "input_layernorm.weight"])
        sd[pre + "post_attn_norm.scale"] = t(hf_state_dict[hf + "post_attention_layernorm.weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"attn.{name}.weight"] = t(hf_state_dict[hf + f"self_attn.{name}.weight"])
        sd[pre + "moe.gate.weight"] = t(hf_state_dict[moe + "gate.weight"])
        for name in ("w1", "w3", "w2"):
            sd[pre + f"moe.{name}"] = torch.stack(
                [t(hf_state_dict[moe + f"experts.{j}.{name}.weight"]).T
                 for j in range(config.num_experts)])
    return sd
