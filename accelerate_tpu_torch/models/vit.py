"""ViT: the port of `accelerate_tpu.models.vit`, the Vision Transformer for
image classification (the model of
`examples/inference/distributed/image_classification.py`).

The input is ``[B, C, H, W]``, as the reference's (Hugging Face's layout).
`patchify` cuts it into patches flattened channel-major, the order of a torch
``Conv2d`` kernel, so the patch embedding is one projection and Hugging
Face's convolution weights map to it 1:1 (`params_from_hf_vit`). A learned
CLS token and position embeddings precede pre-norm blocks over
``num_patches + 1`` tokens, bidirectional.

Numerics follow the reference's flax modules:

  - parameters live in ``param_dtype``; every projection computes in
    ``dtype`` (input, weight and bias cast to it, as flax
    ``Dense(dtype=...)``);
  - every LayerNorm computes in fp32 (statistics, scale and bias) with
    ``eps=1e-12``; inside a block its output is cast to ``dtype`` before
    the attention and the MLP, and the residual stream stays in ``dtype``;
  - the MLP's GELU is exact (``approximate=False``);
  - the CLS token after the final LayerNorm stays fp32 into an fp32
    classifier.

Attention is `ops.attention.dot_product_attention`, the plain path, as the
reference calls it. Submodules carry the reference's names (``block_i``,
``attn/query``, ``mlp_up``, ...): `params_from_jax` transposes the flax
``[in, out]`` kernels and renames LayerNorm ``scale`` to ``weight``, and
`params_to_jax` (``reference_state_dict``) turns them back. Tensor
parallelism (`vit_sharding_rules`) waits for the multi-device runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.moe import lecun_normal_
from ..utils.environment import resolve_device
from ..utils.safetensors_io import unflatten_state_dict
from .gpt2 import _dense, _layer_norm


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_labels: int = 1000
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def base(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "ViTConfig":
        return cls(**{**dict(hidden_size=1024, num_layers=24, num_heads=16), **kw})

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        return cls(**{**dict(image_size=32, patch_size=8, hidden_size=64,
                             num_layers=2, num_heads=4, num_labels=10), **kw})

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, C, H, W] -> [B, n_patches, C * patch * patch]``, channel-major
    within a patch (the flattening order of a torch ``Conv2d`` kernel)."""
    b, c, h, w = pixel_values.shape
    x = pixel_values.reshape(b, c, h // patch, patch, w // patch, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, ph, pw]
    return x.reshape(b, (h // patch) * (w // patch), c * patch * patch)


def _linear(n_in: int, n_out: int, config: ViTConfig, device: torch.device) -> nn.Linear:
    return nn.Linear(n_in, n_out, device=device, dtype=config.param_dtype)


def _norm(config: ViTConfig, device: torch.device) -> nn.LayerNorm:
    return nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, device=device,
                        dtype=config.param_dtype)


class ViTSelfAttention(nn.Module):
    def __init__(self, config: ViTConfig, device: torch.device):
        super().__init__()
        self.config = config
        e = config.hidden_size
        self.query = _linear(e, e, config, device)
        self.key = _linear(e, e, config, device)
        self.value = _linear(e, e, config, device)
        self.out = _linear(e, e, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        heads = (cfg.num_heads, e // cfg.num_heads)
        q = _dense(x, self.query, cfg.dtype).reshape(b, s, *heads)
        k = _dense(x, self.key, cfg.dtype).reshape(b, s, *heads)
        v = _dense(x, self.value, cfg.dtype).reshape(b, s, *heads)
        out = dot_product_attention(q, k, v, causal=False)
        return _dense(out.reshape(b, s, e), self.out, cfg.dtype)


class ViTBlock(nn.Module):
    def __init__(self, config: ViTConfig, device: torch.device):
        super().__init__()
        self.config = config
        e = config.hidden_size
        self.ln_before = _norm(config, device)
        self.attn = ViTSelfAttention(config, device)
        self.ln_after = _norm(config, device)
        self.mlp_up = _linear(e, config.mlp_ratio * e, config, device)
        self.mlp_down = _linear(config.mlp_ratio * e, e, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        x = x + self.attn(_layer_norm(x, self.ln_before).to(dtype))
        h = _dense(_layer_norm(x, self.ln_after).to(dtype), self.mlp_up, dtype)
        return x + _dense(F.gelu(h, approximate="none"), self.mlp_down, dtype)


class ViTForImageClassification(nn.Module):
    """fp32 logits ``[batch, num_labels]`` of images ``[B, C, H, W]``.

    ``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"`` for the plain path). Weights are drawn from ``seed``
    with the reference's initializers: flax's lecun normal (a normal of std
    ``1/sqrt(fan_in)`` truncated at two deviations) for every projection,
    zero biases, a zero CLS token, normal(0.02) position embeddings, unit
    LayerNorm scales."""

    def __init__(self, config: ViTConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        e, pd = config.hidden_size, config.param_dtype
        self.patch_embed = _linear(config.num_channels * config.patch_size ** 2, e, config, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e, device=device, dtype=pd))
        self.pos_embed = nn.Parameter(torch.empty(1, config.num_patches + 1, e, device=device,
                                                  dtype=pd))
        self.block_names = [f"block_{i}" for i in range(config.num_layers)]
        for name in self.block_names:
            self.add_module(name, ViTBlock(config, device))
        self.ln_final = _norm(config, device)
        self.classifier = _linear(e, config.num_labels, config, device)
        if device.type != "meta":
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, g, mod.in_features)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        patches = patchify(pixel_values.to(cfg.dtype), cfg.patch_size)
        x = _dense(patches, self.patch_embed, cfg.dtype)
        cls = self.cls_token.to(cfg.dtype).expand(x.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for name in self.block_names:
            x = getattr(self, name)(x)
        cls_out = _layer_norm(x, self.ln_final)[:, 0]  # fp32, as the LayerNorm leaves it
        return F.linear(cls_out, self.classifier.weight.float(), self.classifier.bias.float())

    def forward_flops(self) -> int:
        """Multiply-adds x 2 of one image's forward: every projection over its
        tokens, the attention products over every token pair, and the
        classifier over the CLS token."""
        cfg = self.config
        e, tokens = cfg.hidden_size, cfg.num_patches + 1
        per_block = tokens * (4 * e * e + 2 * cfg.mlp_ratio * e * e) + 2 * tokens * tokens * e
        macs = (cfg.num_patches * self.patch_embed.in_features * e + cfg.num_layers * per_block
                + e * cfg.num_labels)
        return 2 * macs

    def reference_state_dict(self) -> dict[str, Any]:
        """The weights under the reference's names and layout (nested dicts
        of CPU tensors, flax ``[in, out]`` kernels): what
        `Accelerator.save_model` exports."""
        return params_to_jax(self.state_dict())


def vit_sharding_rules() -> Any:
    """Megatron-style tensor parallelism over a device mesh: not ported yet."""
    raise NotImplementedError(
        "vit_sharding_rules splits the attention and MLP projections over a device mesh, "
        "which is not ported yet (ROADMAP Queue 1, item 21.3)")


def vit_loss_fn(model, batch: dict) -> torch.Tensor:
    """Softmax cross-entropy over ``batch["labels"]``, the mean over the
    batch; usable with `Accelerator.make_train_step`."""
    logits = model(batch["pixel_values"])
    return F.cross_entropy(logits.float(), batch["labels"].long())


def params_from_hf_vit(hf_state_dict: dict, config: ViTConfig) -> dict[str, torch.Tensor]:
    """A Hugging Face ``ViTForImageClassification`` state dict as this
    module's state dict, by the reference's mapping: the patch convolution
    ``[hidden, C, ph, pw]`` flattens to the patch projection (the contraction
    order of `patchify`)."""

    def t(key: str) -> torch.Tensor:
        x = hf_state_dict[key]
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return x.detach().to("cpu", torch.float32)

    def dense(weight: str, bias: str) -> dict:
        return {"kernel": t(weight).T, "bias": t(bias)}

    def ln(prefix: str) -> dict:
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")}

    conv = t("vit.embeddings.patch_embeddings.projection.weight")
    tree: dict[str, Any] = {
        "patch_embed": {"kernel": conv.reshape(conv.shape[0], -1).T,
                        "bias": t("vit.embeddings.patch_embeddings.projection.bias")},
        "cls_token": t("vit.embeddings.cls_token"),
        "pos_embed": t("vit.embeddings.position_embeddings"),
        "ln_final": ln("vit.layernorm"),
        "classifier": dense("classifier.weight", "classifier.bias"),
    }
    for i in range(config.num_layers):
        hf = f"vit.encoder.layer.{i}."
        att = hf + "attention.attention."
        tree[f"block_{i}"] = {
            "ln_before": ln(hf + "layernorm_before"),
            "ln_after": ln(hf + "layernorm_after"),
            "attn": {**{w: dense(f"{att}{w}.weight", f"{att}{w}.bias")
                        for w in ("query", "key", "value")},
                     "out": dense(hf + "attention.output.dense.weight",
                                  hf + "attention.output.dense.bias")},
            "mlp_up": dense(hf + "intermediate.dense.weight", hf + "intermediate.dense.bias"),
            "mlp_down": dense(hf + "output.dense.weight", hf + "output.dense.bias"),
        }
    return params_from_jax(tree)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `ViTForImageClassification`'s param tree (nested dicts
    of numpy arrays; or flat and dotted, as a safetensors export stores it,
    with torch leaves) as this module's state dict: flax ``kernel`` ``[in,
    out]`` -> ``weight`` ``[out, in]``, LayerNorm ``scale`` -> ``weight``."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

    def t(x: Any) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}

    def visit(node: dict, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value, f"{prefix}{key}.")
            elif key == "kernel":
                sd[f"{prefix}weight"] = t(value).T.contiguous()
            else:
                sd[prefix + ("weight" if key == "scale" else key)] = t(value)

    visit(tree, "")
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of `params_from_jax`: this module's state dict as the
    reference's param tree (nested dicts of CPU tensors)."""
    tree: dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach().to("cpu", copy=True)
        if leaf == "weight" and value.dim() == 2:
            leaf, value = "kernel", value.T.contiguous()
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
