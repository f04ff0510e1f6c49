"""BERT: the port of `accelerate_tpu.models.bert` for sequence
classification (the model of `examples/nlp_example.py`).

Post-LN (original BERT): learned word, position and token-type embeddings,
LayerNorm, then per layer self-attention -> residual -> LayerNorm and a
tanh-GELU MLP -> residual -> LayerNorm, and a tanh pooler over the first
token. Numerics follow the reference: parameters live in ``param_dtype`` and
every projection computes in ``dtype`` (inputs, weight and bias cast to it,
as flax ``Dense(dtype=...)`` does); LayerNorm statistics, scale and bias are
fp32 with ``eps=1e-12`` and the result is cast back to ``dtype``; the
classifier runs in fp32 on the fp32 pooled output. Attention is
`ops.attention.dot_product_attention` with the padding mask ``[b, 1, 1, s]``,
the plain path, as in the reference (the flash kernels take no arbitrary
mask).

`params_from_jax` turns the reference's param tree into this module's state
dict, and `params_to_jax` (``reference_state_dict``) turns it back, so both
packages can run and export the same weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..utils.environment import resolve_device
from ..utils.safetensors_io import unflatten_state_dict
from .gpt2 import _dense, _layer_norm


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        return cls(**{**dict(vocab_size=1024, max_position_embeddings=128, hidden_size=64,
                             num_layers=2, num_heads=2, intermediate_size=128), **kw})


def _linear(n_in: int, n_out: int, config: BertConfig, device: torch.device) -> nn.Linear:
    return nn.Linear(n_in, n_out, device=device, dtype=config.param_dtype)


def _norm(config: BertConfig, device: torch.device) -> nn.LayerNorm:
    return nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, device=device,
                        dtype=config.param_dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device):
        super().__init__()
        self.config = config
        e = config.hidden_size
        self.qkv = _linear(e, 3 * e, config, device)
        self.out = _linear(e, e, config, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        q, k, v = _dense(x, self.qkv, cfg.dtype).reshape(b, s, 3, cfg.num_heads, -1).unbind(2)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        out = dot_product_attention(q, k, v, mask=mask).reshape(b, s, e)
        return _dense(out, self.out, cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device):
        super().__init__()
        self.config = config
        self.attention = BertSelfAttention(config, device)
        self.ln_attn = _norm(config, device)
        self.mlp_up = _linear(config.hidden_size, config.intermediate_size, config, device)
        self.mlp_down = _linear(config.intermediate_size, config.hidden_size, config, device)
        self.ln_mlp = _norm(config, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        dtype = self.config.dtype
        x = _layer_norm(x + self.attention(x, attention_mask), self.ln_attn).to(dtype)
        h = F.gelu(_dense(x, self.mlp_up, dtype), approximate="tanh")
        return _layer_norm(x + _dense(h, self.mlp_down, dtype), self.ln_mlp).to(dtype)


class BertEncoder(nn.Module):
    """Returns (sequence_output ``[b, s, e]``, pooled_output ``[b, e]``), in
    the compute dtype."""

    def __init__(self, config: BertConfig, device: torch.device):
        super().__init__()
        self.config = config
        e, pd = config.hidden_size, config.param_dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, e, device=device, dtype=pd)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, e, device=device,
                                                dtype=pd)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, e, device=device, dtype=pd)
        self.ln_embed = _norm(config, device)
        self.layers = nn.ModuleList(BertLayer(config, device) for _ in range(config.num_layers))
        self.pooler = _linear(e, e, config, device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        dtype = self.config.dtype
        input_ids = input_ids.long()
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :s]
             + self.token_type_embeddings(token_type_ids.long())).to(dtype)
        x = _layer_norm(x, self.ln_embed).to(dtype)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x, torch.tanh(_dense(x[:, 0], self.pooler, dtype))


class BertForSequenceClassification(nn.Module):
    """BERT and a classification head: fp32 logits ``[b, num_labels]``.

    ``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). Weights are drawn from ``seed``
    with the reference's initializers: normal(0.02) for the embeddings,
    flax's lecun normal (a normal of std 1/sqrt(fan_in) truncated at two
    deviations) for projection kernels, zero biases, unit LayerNorm
    scales."""

    def __init__(self, config: BertConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.bert = BertEncoder(config, device)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels, device=device,
                                    dtype=config.param_dtype)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=g)
            elif isinstance(mod, nn.Linear):
                # flax lecun_normal: std 1/sqrt(fan_in) after truncation at +-2
                std = 1.0 / math.sqrt(mod.in_features) / 0.8796256610342398
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=g)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        return F.linear(pooled.float(), self.classifier.weight.float(),
                        self.classifier.bias.float())

    def reference_state_dict(self) -> dict[str, Any]:
        """The weights under the reference's names and layout (nested dicts
        of CPU tensors, flax ``[in, out]`` kernels): what
        `Accelerator.save_model` exports."""
        return params_to_jax(self.state_dict())


def classification_loss_fn(model, batch: dict) -> torch.Tensor:
    """Softmax cross-entropy over ``batch["labels"]``, the mean over the
    batch; usable with `Accelerator.backward` and ``make_train_step``."""
    logits = model(batch["input_ids"], batch.get("attention_mask"), batch.get("token_type_ids"))
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logprobs, -1, batch["labels"].long()[:, None]).mean()


_LAYER_LINEARS = ("attention.qkv", "attention.out", "mlp_up", "mlp_down")
_LAYER_NORMS = ("ln_attn", "ln_mlp")


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `BertForSequenceClassification`'s param tree (nested
    dicts of numpy arrays, ``layer_i`` per layer; or flat and dotted, as a
    safetensors export stores it, with torch leaves) as this module's state
    dict. Flax ``Dense`` kernels are ``[in, out]`` and become ``[out, in]``
    weights."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

    def t(x: Any) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(node: dict, name: str, sd: dict) -> None:
        sd[f"{name}.weight"] = t(node["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = t(node["bias"])

    def norm(node: dict, name: str, sd: dict) -> None:
        sd[f"{name}.weight"] = t(node["scale"])
        sd[f"{name}.bias"] = t(node["bias"])

    bert, sd = tree["bert"], {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"bert.{name}.weight"] = t(bert[name])
    norm(bert["ln_embed"], "bert.ln_embed", sd)
    n_layer = sum(1 for key in bert if key.startswith("layer_"))
    for i in range(n_layer):
        layer = bert[f"layer_{i}"]
        for name in _LAYER_LINEARS:
            node = layer
            for part in name.split("."):
                node = node[part]
            dense(node, f"bert.layers.{i}.{name}", sd)
        for name in _LAYER_NORMS:
            norm(layer[name], f"bert.layers.{i}.{name}", sd)
    dense(bert["pooler"], "bert.pooler", sd)
    dense(tree["classifier"], "classifier", sd)
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of `params_from_jax`: this module's state dict as the
    reference's param tree (nested dicts of CPU tensors)."""
    def get(name: str) -> torch.Tensor:
        return state_dict[name].detach().to("cpu", copy=True)

    def dense(name: str) -> dict:
        return {"kernel": get(f"{name}.weight").T.contiguous(), "bias": get(f"{name}.bias")}

    def norm(name: str) -> dict:
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    bert: dict[str, Any] = {name: get(f"bert.{name}.weight")
                            for name in ("word_embeddings", "position_embeddings",
                                         "token_type_embeddings")}
    bert["ln_embed"] = norm("bert.ln_embed")
    n_layer = len({k.split(".")[2] for k in state_dict if k.startswith("bert.layers.")})
    for i in range(n_layer):
        pre = f"bert.layers.{i}"
        bert[f"layer_{i}"] = {"attention": {"qkv": dense(f"{pre}.attention.qkv"),
                                            "out": dense(f"{pre}.attention.out")},
                              "mlp_up": dense(f"{pre}.mlp_up"), "mlp_down": dense(f"{pre}.mlp_down"),
                              **{name: norm(f"{pre}.{name}") for name in _LAYER_NORMS}}
    bert["pooler"] = dense("bert.pooler")
    return {"bert": bert, "classifier": dense("classifier")}
