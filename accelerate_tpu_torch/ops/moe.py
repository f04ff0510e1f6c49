"""Mixture-of-experts layer: the port of `accelerate_tpu.ops.moe`.

Switch/GShard top-k routing with a static capacity per expert: the router
runs in fp32, each token picks its top-k experts, and dispatch and combine
are ``[tokens, experts, capacity]`` tensors that the expert products read
through einsums, as the reference computes them (outside any kernel).
Tokens over an expert's capacity are dropped: their dispatch and combine
rows stay zero, so they pass through the residual stream.

The router's aux loss (Switch Transformer's) is sown under ``aux_loss``
(`utils.intermediates`). A `accelerator.BoundModel` or
`accelerator.PreparedModel` call collects the terms of its forward into
``model.extra_state``, as tensors of that forward's autograd graph, and a
loss function adds ``collect_aux_losses(model.extra_state)`` so the router
receives gradient. A remat recompute (`utils.remat`) adds no term a second
time.

Expert parallelism (`moe_sharding_rules`) needs the multi-device runtime
and raises until it is ported.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.environment import resolve_device
from ..utils.intermediates import sow


def collect_aux_losses(extra_state: Any) -> torch.Tensor:
    """The sum of every ``aux_loss`` leaf of a forward's extra state (a
    `BoundModel`'s or `PreparedModel`'s ``extra_state``), an fp32 scalar; 0
    when there is none."""
    terms = list(_aux_loss_leaves(extra_state)) if extra_state else []
    if not terms:
        return torch.zeros((), dtype=torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=terms[0].device)
    for t in terms:
        total = total + t.float().sum()
    return total


def _aux_loss_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if k == "aux_loss":
                yield from (v if isinstance(v, (list, tuple)) else [v])
            else:
                yield from _aux_loss_leaves(v)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    hidden_size: int = 768
    intermediate_size: int = 3072
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def expert_capacity(capacity_factor: float, n_tokens: int, top_k: int, num_experts: int) -> int:
    """Slots per expert: ``max(int(cf * T * k / E), 1)``, the reference's
    rounding."""
    return max(int(capacity_factor * n_tokens * top_k / num_experts), 1)


def build_dispatch_combine(expert_idx: torch.Tensor, gate_vals: torch.Tensor, num_experts: int,
                           capacity: int, dtype: torch.dtype
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Static-capacity dispatch (``dtype``) and combine (fp32) tensors
    ``[T, E, C]`` from each token's chosen experts ``[T, k]`` and their
    gates ``[T, k]`` (reference `ops/moe.py:48-78`).

    A token's place in its expert's buffer is a masked cumsum over the
    tokens, slot by slot: slot 0 for every token first, then slot 1, each
    slot starting where the kept tokens of the earlier slots left the
    expert's fill. A token whose place is past the capacity is dropped.
    The one-hot products of the reference put at most one nonzero at each
    ``(t, e)`` (a token's k experts differ), so the kept places are
    scattered here with the same values: 1 in dispatch, the gate in
    combine, through which the gates receive gradient."""
    n_tokens, k = expert_idx.shape
    dev = expert_idx.device
    fill = torch.zeros(num_experts, dtype=torch.float32, device=dev)
    rows = torch.arange(n_tokens, device=dev)
    dispatch = torch.zeros((n_tokens, num_experts, capacity), dtype=dtype, device=dev)
    combine = torch.zeros((n_tokens, num_experts, capacity), dtype=torch.float32, device=dev)
    for slot in range(k):
        onehot = F.one_hot(expert_idx[:, slot].long(), num_experts).float()  # [T, E]
        within = torch.cumsum(onehot, dim=0) - onehot  # earlier tokens, this slot
        pos = ((within + fill[None, :]) * onehot).sum(dim=-1)  # [T]
        keep = pos < capacity
        place = (rows, expert_idx[:, slot].long(), pos.long().clamp(max=capacity - 1))
        dispatch = dispatch.index_put(place, keep.to(dtype))
        combine = combine.index_put(place, gate_vals[:, slot].float() * keep)
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
    return dispatch, combine


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, fan_in: int) -> None:
    """flax ``lecun_normal``: a normal of std ``1/sqrt(fan_in)`` truncated at
    two deviations (the std corrected for the truncation)."""
    std = 1.0 / math.sqrt(fan_in) / 0.8796256610342398
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def stacked_fan_in(weight: torch.Tensor) -> int:
    """flax's fan in of an expert-stacked ``[E, in, out]`` kernel: ``in``
    times the receptive field, the expert axis."""
    return weight.shape[-2] * math.prod(weight.shape[:-2])


class MoEMLP(nn.Module):
    """Top-k routed expert MLP over ``[batch, seq, hidden]``: fp32 router,
    softmax over all experts, top-k gates renormalised to sum to 1,
    tanh-GELU experts ``[E, e, f]`` and ``[E, f, e]``."""

    def __init__(self, config: MoEConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        E, e, f, pd = config.num_experts, config.hidden_size, config.intermediate_size, \
            config.param_dtype
        self.router = nn.Linear(e, E, bias=False, device=device, dtype=pd)
        self.w_up = nn.Parameter(torch.empty(E, e, f, device=device, dtype=pd))
        self.w_down = nn.Parameter(torch.empty(E, f, e, device=device, dtype=pd))
        if device.type != "meta":
            g = torch.Generator(device=device).manual_seed(int(seed))
            with torch.no_grad():
                lecun_normal_(self.router.weight, g, e)
                lecun_normal_(self.w_up, g, stacked_fan_in(self.w_up))
                lecun_normal_(self.w_down, g, stacked_fan_in(self.w_down))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        n_tokens, E = b * s, cfg.num_experts
        capacity = expert_capacity(cfg.capacity_factor, n_tokens, cfg.top_k, E)
        xt = x.reshape(n_tokens, e)
        router_logits = F.linear(xt.float(), self.router.weight.float())
        probs = torch.softmax(router_logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        dispatch, combine = build_dispatch_combine(expert_idx, gate_vals, E, capacity, cfg.dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch, xt.to(cfg.dtype))
        h = torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(cfg.dtype))
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ecf,efd->ecd", h, self.w_down.to(cfg.dtype))
        out = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), expert_out)
        me = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
        ce = probs.mean(dim=0)
        sow("aux_loss", cfg.aux_loss_weight * E * (me * ce).sum())
        return out.reshape(b, s, e).to(x.dtype)


def moe_sharding_rules() -> Any:
    """Expert parallelism shards the expert axis over devices, which needs
    the multi-device runtime."""
    raise NotImplementedError(
        "moe_sharding_rules shards the expert axis over a device mesh, which is not ported "
        "yet (ROADMAP Queue 1, item 21.3)")
