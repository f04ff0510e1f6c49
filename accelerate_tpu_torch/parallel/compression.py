"""Gradient reduction over the ``data`` axis and the reference's comm hooks:
the port of `accelerate_tpu.parallel.compression`.

`reduce_gradients` averages a dict of gradients over the ranks of a process
group with ``torch.distributed.all_reduce``:

- ``"no"``: the gradients themselves, in flat buckets of at most
  ``bucket_bytes`` (one all-reduce a bucket; sum, then divide by the world);
- ``"fp16"`` / ``"bf16"``: each gradient cast to the low-precision dtype,
  summed and divided in it, and cast back, which halves the bytes (the
  reference's ``pmean(g.astype(dt)).astype(g.dtype)``);
- ``"power_sgd"`` / ``"batched_power_sgd"``: each gradient of 2 or more
  dimensions and at least ``min_compression_elems`` elements is sent as a
  rank-r factorization with error feedback (Vogels et al., PowerSGD), the
  reference's algorithm step for step: ``M`` is the gradient plus this
  rank's error buffer as a matrix, ``P = M Q`` is averaged and
  orthonormalized by modified Gram-Schmidt, ``Q = Mᵀ P`` is averaged, the
  gradient becomes ``P Qᵀ`` and the residual ``M - P Qᵀ`` is the new error
  buffer; the new Q warm-starts the next round. A leaf whose residual is not
  finite keeps its old error buffer and Q. The other gradients go plain.
  Every P goes in one all-reduce and every Q in one more (both hooks batch
  alike; the sums are per element, so batching changes no value).

The hooks are computed on ``all_reduce``, not on torch's
``ddp_comm_hooks``: the module is never wrapped in
``DistributedDataParallel``. The matrix a gradient is viewed as is the
reference's: its kernels are ``[in, out]`` (flax ``Dense``) and ``[kh, kw,
in, out]`` (flax ``Conv``), so an ``nn.Linear`` weight ``[out, in]`` is
compressed as its transpose and a convolution's ``[out, in, kh, kw]`` with
its output channels last (`matrix_views`); every other leaf as
``reshape(-1, last dim)``.

State (`init_comm_state`): ``rep`` holds each compressed leaf's Q and its
round count (equal on every rank: the Q start from one seed, or from a tree
given as ``q``), ``err`` this rank's error buffers. The warm-up
(``start_powerSGD_iter`` updates with the plain reduction) is the caller's
(`Accelerator.make_train_step`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Any

import numpy as np
import torch
from torch import nn

DEFAULT_BUCKET_BYTES = 25 << 20


class DDPCommunicationHookType(str, Enum):
    """The hook names (reference `parallel/compression.py:41`)."""

    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    POWER_SGD = "power_sgd"
    BATCHED_POWER_SGD = "batched_power_sgd"


COMM_HOOK_TYPES = tuple(e.value for e in DDPCommunicationHookType)
_WIRE_DTYPES = {"no": None, "fp16": torch.float16, "bf16": torch.bfloat16}


@dataclass
class CommHookConfig:
    """A gradient hook and PowerSGD's settings (the reference's fields);
    ``wrapper`` carries PowerSGD's P and Q in fp16 or bf16 (``"no"``: fp32)."""

    comm_hook: str = "no"
    matrix_approximation_rank: int = 1
    start_powerSGD_iter: int = 2
    min_compression_elems: int = 1024
    wrapper: str = "no"

    def __post_init__(self):
        if isinstance(self.comm_hook, DDPCommunicationHookType):
            self.comm_hook = self.comm_hook.value
        if isinstance(self.wrapper, DDPCommunicationHookType):
            self.wrapper = self.wrapper.value
        if self.comm_hook not in COMM_HOOK_TYPES:
            raise ValueError(f"comm_hook must be one of {COMM_HOOK_TYPES}, got {self.comm_hook!r}")
        if self.wrapper not in _WIRE_DTYPES:
            raise ValueError(f"wrapper must be one of {tuple(_WIRE_DTYPES)}, got {self.wrapper!r}")

    @property
    def is_powersgd(self) -> bool:
        return self.comm_hook in ("power_sgd", "batched_power_sgd")

    @property
    def warmup_updates(self) -> int:
        return self.start_powerSGD_iter if self.is_powersgd else 0


def matrix_views(module: nn.Module) -> dict[str, str]:
    """Parameter name -> ``"linear"`` or ``"conv"`` for the weights whose
    reference layout is the transpose or a permutation of torch's (see the
    module docstring); other parameters are absent."""
    views = {}
    for name, mod in module.named_modules():
        kind = ("linear" if isinstance(mod, nn.Linear) else
                "conv" if isinstance(mod, nn.modules.conv._ConvNd) else None)
        if kind is not None and getattr(mod, "weight", None) is not None:
            views[f"{name}.weight" if name else "weight"] = kind
    return views


def as_matrix(g: torch.Tensor, view: str | None) -> torch.Tensor:
    """``g`` as the reference's matrix: ``[rows, last axis of its kernel]``."""
    if view == "linear":
        return g.t()
    if view == "conv":
        return g.permute(*range(2, g.ndim), 1, 0).reshape(-1, g.shape[0])
    return g.reshape(-1, g.shape[-1])


def from_matrix(m: torch.Tensor, view: str | None, shape: torch.Size) -> torch.Tensor:
    """The inverse of `as_matrix`."""
    if view == "linear":
        return m.t()
    if view == "conv":
        out, cin, *k = shape
        return m.reshape(*k, cin, out).permute(len(k) + 1, len(k), *range(len(k)))
    return m.reshape(shape)


def _compressible(shape: torch.Size, cfg: CommHookConfig) -> bool:
    return len(shape) >= 2 and math.prod(shape) >= cfg.min_compression_elems


def init_comm_state(params: dict[str, torch.Tensor], cfg: CommHookConfig, seed: int = 0,
                    q: dict[str, Any] | None = None, views: dict[str, str] | None = None
                    ) -> tuple[Any, Any]:
    """The hook's state for gradients shaped as ``params`` (name ->
    tensor): ``(rep, err)``, None for each leaf a hook does not compress and
    ``(None, None)`` for a stateless hook. A compressed leaf's Q is ``q[name]``
    when given (an array ``[n, r]``), else normal draws from one CPU
    generator seeded with ``seed``, in name order, so every rank starts from
    the same Q; its error buffer is zeros in fp32."""
    if not cfg.is_powersgd:
        return None, None
    views = views or {}
    gen = torch.Generator().manual_seed(seed)
    rep: dict[str, Any] = {}
    err: dict[str, Any] = {}
    for name, p in params.items():
        if not _compressible(p.shape, cfg):
            rep[name] = err[name] = None
            continue
        rows, n = as_matrix(torch.empty(p.shape, device="meta"), views.get(name)).shape
        r = min(cfg.matrix_approximation_rank, n, rows)
        if q is not None and name in q:
            q0 = torch.as_tensor(np.asarray(q[name], dtype=np.float32))
            if tuple(q0.shape) != (n, r):
                raise ValueError(f"q[{name!r}] has shape {tuple(q0.shape)}, expected {(n, r)}")
        else:
            q0 = torch.randn(n, r, generator=gen)
        rep[name] = {"q": q0.to(p.device), "step": 0}
        err[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return rep, err


def orthogonalize(p: torch.Tensor) -> torch.Tensor:
    """The columns of ``p`` made orthonormal by modified Gram-Schmidt; a
    column (numerically) in the span of the earlier ones becomes zero
    (reference `parallel/compression.py:156`)."""
    scale = torch.linalg.vector_norm(p) + 1e-20
    cols: list[torch.Tensor] = []
    for i in range(p.shape[-1]):
        c = p[:, i]
        for prev in cols:
            c = c - torch.dot(prev, c) * prev
        n = torch.linalg.vector_norm(c)
        c = torch.where(n > 1e-6 * scale, c / torch.clamp(n, min=1e-20), torch.zeros_like(c))
        cols.append(c)
    return torch.stack(cols, dim=-1)


def _world(group: Any) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _sum_(flat: torch.Tensor, group: Any) -> torch.Tensor:
    """``flat`` summed over the group's ranks and divided by their number,
    reduced where the backend carries it (`utils.operations`' rule: host
    memory under gloo, the current CUDA device under NCCL); a new tensor
    on ``flat``'s device."""
    import torch.distributed as dist

    from ..utils.operations import _carried

    wire, back = _carried(flat)
    dist.all_reduce(wire, group=group)
    return back(wire.div_(_world(group)))


def all_reduce_mean_(tensors: list[torch.Tensor], group: Any = None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> None:
    """Each tensor overwritten in place by its mean over the group's ranks:
    the tensors of one dtype and device packed into flat buckets of at most
    ``bucket_bytes``, one sum all-reduce a bucket, divided by the world in
    the tensors' dtype."""
    world = _world(group)
    if world == 1 or not tensors:
        return
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for members in groups.values():
        bucket: list[torch.Tensor] = []
        size = 0
        for t in members + [None]:
            if t is not None and (not bucket or size + t.numel() * t.element_size() <= bucket_bytes):
                bucket.append(t)
                size += t.numel() * t.element_size()
                continue
            if bucket:
                flat = _sum_(torch.cat([b.reshape(-1) for b in bucket]), group)
                offset = 0
                for b in bucket:
                    b.copy_(flat[offset:offset + b.numel()].view_as(b))
                    offset += b.numel()
            bucket, size = ([t], t.numel() * t.element_size()) if t is not None else ([], 0)


def reduce_gradients(grads: dict[str, torch.Tensor], rep: Any, err: Any, cfg: CommHookConfig,
                     group: Any = None, views: dict[str, str] | None = None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES
                     ) -> tuple[dict[str, torch.Tensor], Any, Any]:
    """The mean over the group's ranks of every gradient, under the hook of
    ``cfg`` (see the module docstring); returns ``(grads, rep, err)``, new
    dicts (the inputs are not written). At a world of one, the gradients as
    they are."""
    if _world(group) == 1:
        return dict(grads), rep, err
    if cfg.comm_hook in ("fp16", "bf16"):
        dt = _WIRE_DTYPES[cfg.comm_hook]
        low = {name: g.to(dt, copy=True) for name, g in grads.items()}
        all_reduce_mean_(list(low.values()), group, bucket_bytes)
        return {name: low[name].to(g.dtype) for name, g in grads.items()}, rep, err
    if not cfg.is_powersgd:
        out = {name: g.clone() for name, g in grads.items()}
        all_reduce_mean_(list(out.values()), group, bucket_bytes)
        return out, rep, err
    return _power_sgd(grads, rep, err, cfg, group, views or {}, bucket_bytes)


def _mean_flat_(parts: list[torch.Tensor], group: Any, wire: torch.dtype | None) -> list[torch.Tensor]:
    """``parts`` averaged over the ranks in one all-reduce (in ``wire``'s
    dtype when given); returns them in fp32."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    flat = _sum_(flat if wire is None else flat.to(wire), group).float()
    out, offset = [], 0
    for p in parts:
        out.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return out


def _power_sgd(grads, rep, err, cfg, group, views, bucket_bytes):
    wire = _WIRE_DTYPES[cfg.wrapper]
    out: dict[str, torch.Tensor] = {}
    plain = {name: g.clone() for name, g in grads.items() if rep.get(name) is None}
    all_reduce_mean_(list(plain.values()), group, bucket_bytes)
    out.update(plain)
    names = [name for name in grads if rep.get(name) is not None]
    if not names:
        return {name: out[name] for name in grads}, rep, err
    mats = {}
    for name in names:
        g32 = grads[name].float() + err[name]
        mats[name] = (g32, as_matrix(g32, views.get(name)))
    ps = _mean_flat_([mats[name][1] @ rep[name]["q"] for name in names], group, wire)
    ps = [orthogonalize(p) for p in ps]
    qs = _mean_flat_([mats[name][1].t() @ p for name, p in zip(names, ps)], group, wire)
    new_rep, new_err = dict(rep), dict(err)
    for name, p, q in zip(names, ps, qs):
        g32, _ = mats[name]
        approx = from_matrix(p @ q.t(), views.get(name), g32.shape)
        candidate = g32 - approx
        ok = torch.isfinite(candidate).all()
        new_err[name] = torch.where(ok, candidate, err[name])
        new_rep[name] = {"q": torch.where(ok, q, rep[name]["q"]), "step": rep[name]["step"] + 1}
        out[name] = approx.to(grads[name].dtype)
    return {name: out[name] for name in grads}, new_rep, new_err
