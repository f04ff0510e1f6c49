"""ResNet: the port of `accelerate_tpu.models.resnet`, the model of
`examples/cv_example.py` (`BASELINE.json` ``configs[1]``, ResNet-50 image
classification).

The reference normalizes with GroupNorm, not BatchNorm, so the model keeps
no running statistics and has no buffers. Numerics follow the reference's
flax modules:

  - every convolution computes in ``dtype`` (input and kernel cast to it, as
    flax ``Conv(dtype=...)`` does), bias-free, with XLA's ``"SAME"``
    padding: for a stride-2 convolution on an even size that pads one more
    row and column after than before (the 7x7/s2 stem at 224 pads 2 and 3,
    a 3x3/s2 pads 0 and 1), which ``nn.Conv2d(padding=k // 2)`` would not;
    an asymmetric case is padded explicitly;
  - GroupNorm has ``min(num_groups, channels)`` groups and flax's
    ``epsilon=1e-6``, and computes in fp32 (statistics, scale and bias) even
    when the parameters arrive in bf16; the result is cast back to ``dtype``;
  - the stem's 3x3/s2 max pool pads with -inf, ``"SAME"`` as above;
  - the classifier runs in fp32 on the fp32 spatial mean.

The input is NHWC, as the reference's batches are. Inside, activations are
NCHW logical tensors in ``torch.channels_last`` memory (the permute of an
NHWC tensor is one), the layout cuDNN's NHWC convolutions read.

Weights start as flax's: ``lecun_normal`` (a normal truncated at two
standard deviations, of variance ``1 / fan_in``) for conv and dense kernels,
zero biases, GroupNorm scale 1 and bias 0. `params_from_jax` turns the
reference's param tree into this module's state dict (flax conv kernels are
HWIO, torch's OIHW; dense kernels ``[in, out]``) and `params_to_jax` turns it
back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.environment import resolve_device
from ..utils.safetensors_io import unflatten_state_dict

GN_EPS = 1e-6  # flax GroupNorm's default


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # resnet50
    num_filters: int = 64
    num_classes: int = 1000
    bottleneck: bool = True
    num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16  # compute dtype of the convolutions
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def resnet18(cls, **kw) -> "ResNetConfig":
        return cls(**{**dict(stage_sizes=(2, 2, 2, 2), bottleneck=False), **kw})

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        return cls(**{**dict(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                             bottleneck=False, num_groups=4), **kw})


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions and the odd row of padding goes
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A bias-free square convolution with ``"SAME"`` padding, computed in
    ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device: torch.device):
        super().__init__(in_channels, out_channels, kernel, stride, bias=False, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[-2:])
        x = x.to(self.compute_dtype)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        return F.conv2d(x, self.weight.to(self.compute_dtype), None, self.stride, (top, left))


class GroupNorm(nn.GroupNorm):
    """GroupNorm in fp32, the result cast to ``dtype`` (flax
    ``GroupNorm(dtype=float32)`` followed by the reference's ``astype``)."""

    def __init__(self, num_groups: int, channels: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__(num_groups, channels, eps=GN_EPS, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(self.compute_dtype)


class ResNetBlock(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1 x4) block; the 3x3
    carries the stride, and a 1x1 projection with its GroupNorm meets the
    residual when the width or the stride changes."""

    def __init__(self, in_channels: int, filters: int, config: ResNetConfig, strides: int = 1,
                 device: torch.device | None = None):
        super().__init__()
        cfg = self.config = config

        def conv(cin: int, cout: int, k: int, s: int) -> SameConv2d:
            return SameConv2d(cin, cout, k, s, cfg.dtype, cfg.param_dtype, device)

        def gn(channels: int) -> GroupNorm:
            return GroupNorm(min(cfg.num_groups, channels), channels, cfg.dtype,
                             cfg.param_dtype, device)

        if cfg.bottleneck:
            self.conv1, self.gn1 = conv(in_channels, filters, 1, 1), gn(filters)
            self.conv2, self.gn2 = conv(filters, filters, 3, strides), gn(filters)
            self.conv3, self.gn3 = conv(filters, 4 * filters, 1, 1), gn(4 * filters)
            out_filters = 4 * filters
        else:
            self.conv1, self.gn1 = conv(in_channels, filters, 3, strides), gn(filters)
            self.conv2, self.gn2 = conv(filters, filters, 3, 1), gn(filters)
            out_filters = filters
        self.out_filters = out_filters
        if in_channels != out_filters or strides != 1:
            self.conv_proj, self.gn_proj = conv(in_channels, out_filters, 1, strides), gn(out_filters)
        else:
            self.conv_proj = self.gn_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.config.bottleneck:
            y = F.relu(self.gn1(self.conv1(x)))
            y = F.relu(self.gn2(self.conv2(y)))
            y = self.gn3(self.conv3(y))
        else:
            y = F.relu(self.gn1(self.conv1(x)))
            y = self.gn2(self.conv2(y))
        if self.conv_proj is not None:
            residual = self.gn_proj(self.conv_proj(residual))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns fp32 logits ``[batch, num_classes]``; the input is NHWC.
    ``device=None`` means CUDA; ``seed`` seeds flax's initializers."""

    def __init__(self, config: ResNetConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        self.conv_stem = SameConv2d(3, cfg.num_filters, 7, 2, cfg.dtype, cfg.param_dtype, device)
        self.gn_stem = GroupNorm(min(cfg.num_groups, cfg.num_filters), cfg.num_filters, cfg.dtype,
                                 cfg.param_dtype, device)
        self.block_names: list[str] = []
        channels = cfg.num_filters
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                name = f"stage{i}_block{j}"
                block = ResNetBlock(channels, cfg.num_filters * 2**i, cfg,
                                    2 if i > 0 and j == 0 else 1, device)
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_filters
        self.classifier = nn.Linear(channels, cfg.num_classes, device=device,
                                    dtype=cfg.param_dtype)
        self.init_weights(seed)
        self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                # flax lecun_normal: std 1/sqrt(fan_in) after truncation at +-2
                std = 1.0 / math.sqrt(fan_in) / 0.8796256610342398
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW logical, channels_last memory
        x = F.relu(self.gn_stem(self.conv_stem(x)))
        (top, bottom), (left, right) = (same_pads(n, 3, 2) for n in x.shape[-2:])
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean of a bf16 tensor sums in fp32 and rounds the mean to bf16
        x = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        return F.linear(x, self.classifier.weight.float(), self.classifier.bias.float())

    def forward_flops(self, image_size: int) -> int:
        """Multiply-adds x 2 of one image's forward through the convolutions
        and the classifier, counted from their shapes at ``image_size``."""
        macs, size = 0, image_size

        def conv(mod: nn.Conv2d, n: int) -> tuple[int, int]:
            out = -(-n // mod.stride[0])
            return out * out * mod.out_channels * mod.in_channels * mod.kernel_size[0] ** 2, out

        m, size = conv(self.conv_stem, size)
        macs += m
        size = -(-size // 2)  # the max pool
        for name in self.block_names:
            block = getattr(self, name)
            convs = [block.conv1, block.conv2] + ([block.conv3] if block.config.bottleneck else [])
            n = size
            for c in convs:
                m, n = conv(c, n)
                macs += m
            if block.conv_proj is not None:
                macs += conv(block.conv_proj, size)[0]
            size = n
        macs += self.classifier.in_features * self.classifier.out_features
        return 2 * macs

    def reference_state_dict(self) -> dict[str, Any]:
        """The weights under the reference's names and layout (nested dicts
        of CPU tensors, HWIO conv and ``[in, out]`` dense kernels): what
        `Accelerator.save_model` exports."""
        return params_to_jax(self.state_dict())


def image_classification_loss_fn(model, batch: dict) -> torch.Tensor:
    """Softmax cross-entropy over ``batch["label"]``, the mean over the
    batch; usable with `Accelerator.backward` and ``make_train_step``."""
    logits = model(batch["image"])
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logprobs, -1, batch["label"].long()[:, None]).mean()


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference `ResNet`'s param tree (nested dicts of numpy arrays;
    or flat and dotted, as a safetensors export stores it, with torch
    leaves) as this module's state dict: ``kernel`` HWIO -> ``weight`` OIHW,
    dense ``[in, out]`` -> ``[out, in]``, GroupNorm ``scale`` -> ``weight``."""
    if any("." in key for key in tree):
        tree = unflatten_state_dict(tree)

    def t(x: Any) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}

    def visit(node: dict, prefix: str) -> None:
        for key, value in node.items():
            name = f"{prefix}{key}"
            if not isinstance(value, dict):
                raise ValueError(f"unexpected leaf {name!r} in a ResNet param tree")
            if "kernel" in value:
                kernel = t(value["kernel"])
                if kernel.dim() == 4:
                    sd[f"{name}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
                else:
                    sd[f"{name}.weight"] = kernel.T.contiguous()
                    sd[f"{name}.bias"] = t(value["bias"])
            elif "scale" in value:
                sd[f"{name}.weight"] = t(value["scale"])
                sd[f"{name}.bias"] = t(value["bias"])
            else:
                visit(value, f"{name}.")

    visit(tree, "")
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of `params_from_jax`: this module's state dict as the
    reference's param tree (nested dicts of CPU tensors)."""
    tree: dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach().to("cpu", copy=True)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight" and value.dim() == 4:
            node["kernel"] = value.permute(2, 3, 1, 0).contiguous()
        elif leaf == "weight" and path[-1] == "classifier":
            node["kernel"] = value.T.contiguous()
        elif leaf == "weight":
            node["scale"] = value
        else:
            node["bias"] = value
    return tree
