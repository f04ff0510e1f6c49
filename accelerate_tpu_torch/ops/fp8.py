"""fp8 training: the port of `accelerate_tpu.ops.fp8`, name for name.

Delayed-scaling fp8 matmuls for the block projections (the reference's
TransformerEngine role): activations and weights are scaled into e4m3 with
per-tensor scales taken from a rolling amax history of earlier steps, and
the incoming cotangent of the backward is scaled from its own amax (current
scaling) into e5m2 (``"HYBRID"``) or e4m3 (``"E4M3"``).

Two lowerings of the same numerics, picked by `DelayedScalingRecipe.backend`:

  - ``"qdq"``: `fp8_dot` rounds x and the kernel through fp8 and back
    (`quantize_dequantize`) and multiplies in the compute dtype;
  - ``"native"``: `fp8_dot_native` multiplies real fp8 tensors (one byte an
    element) with fp32 accumulation through `fp8_gemm`, and its backward
    saves the fp8 operands, not the compute-dtype ones.

`fp8_gemm` is the fp8 matrix product. On a CUDA tensor it is
``torch._scaled_mm`` (cuBLASLt's fp8 GEMM on the tensor cores): the
reference's fp8 product is XLA's ``dot_general``, not a Pallas kernel, so
there is no TPU kernel to port here, and the card's fp8 GEMM takes its
place as XLA's took the TPU's. On the CPU it is the plain version: an fp32
product of the upcast operands, divided by the two scales, which is what XLA
does on the CPU. Bound: at GPT-2's projection shapes (M 8192) the product
is bound by operations, 2 M K N at 1979 TFLOP/s fp8 dense. The scaling glue
(amax, scale, cast, and the transposes ``_scaled_mm``'s K-major operands
need for dX and dK) runs as separate eager PyTorch ops around it.

`Fp8Linear` is the reference's ``Fp8Dense``: an ``nn.Linear`` (weight
``[out, in]``) whose scaling state (``input`` and ``kernel``, each a 0-d
``scale`` and an ``amax_history``) lives in persistent buffers, so it rides
the state dict, `Accelerator.save_state` and the train step's
`torch.func.functional_call` (which passes the module's own buffers, so the
in-place update lands on them). The state advances once per forward in
training mode, after the product, from the compute-dtype input and weight;
the first step multiplies at scale 1.0, as the reference's does. Under
`utils.remat` the recompute of a checkpointed block replays the scales its
first forward used and does not advance the state again.

`AdamWFp8` (``adamw_fp8(..., opt_level="O2")``) keeps Adam's first moment in
e4m3 and its second in fp16, each with a per-tensor scale (the MS-AMP O2
role), and updates in fp32 in the reference's ``optax.chain`` order: the
Adam update, then the decayed weights added, then the ``-lr`` scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..utils import remat

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
F16_MAX = 65504.0
# `_scaled_mm`'s shape rule on Hopper: every dimension a multiple of 16
GEMM_MULTIPLE = 16


@dataclass(frozen=True)
class DelayedScalingRecipe:
    """The reference's recipe: ``margin``, ``amax_history_len``,
    ``fp8_format`` (``"HYBRID"``: e4m3 forward, e5m2 backward; ``"E4M3"``:
    e4m3 both ways) and ``backend`` (``"native"``: real fp8 operands through
    `fp8_gemm`; ``"qdq"``: fp8 rounding around a compute-dtype product)."""

    margin: int = 0
    amax_history_len: int = 16
    fp8_format: str = "HYBRID"
    backend: str = "native"

    def __post_init__(self):
        if self.backend not in ("native", "qdq"):
            raise ValueError(
                f"DelayedScalingRecipe.backend must be 'native' or 'qdq', got "
                f"{self.backend!r} — a typo here would silently measure the "
                "wrong matmul path."
            )


def new_meta(history_len: int, device: Any = None) -> dict[str, torch.Tensor]:
    """Fresh per-tensor scaling state: scale 1 and a zero amax history."""
    return {"scale": torch.ones((), dtype=torch.float32, device=device),
            "amax_history": torch.zeros(history_len, dtype=torch.float32, device=device)}


def _over(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """``numerator / t`` rounded once, as JAX divides (a Python scalar over
    a tensor is ``t.reciprocal() * numerator`` in torch, two roundings)."""
    return torch.full_like(t, numerator) / t


def _compute_scale(amax_history: torch.Tensor, fp8_max: float, margin: int) -> torch.Tensor:
    """``fp8_max / (2^margin * max(history))``, 1 where that max is 0 or the
    result is not finite."""
    amax = amax_history.max()
    sf = _over(fp8_max, torch.clamp(amax, min=1e-12)) / (2.0 ** margin)
    sf = torch.where(amax > 0.0, sf, torch.ones_like(sf))
    return torch.where(torch.isfinite(sf), sf, torch.ones_like(sf))


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.detach().abs().max().float()


def _update_meta(meta: dict, x: torch.Tensor, fp8_max: float, margin: int) -> dict:
    """Roll the current ``|x|max`` into the history and refresh the scale."""
    hist = torch.roll(meta["amax_history"], 1)
    hist[0] = _amax(x)
    return {"scale": _compute_scale(hist, fp8_max, margin), "amax_history": hist}


def quantize_dequantize(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                        fp8_max: float) -> torch.Tensor:
    """``x`` scaled, clipped to the format's range, rounded to ``dtype``,
    unscaled, in x's dtype: the q-dq rounding."""
    scaled = torch.clamp(x.float() * scale, -fp8_max, fp8_max)
    return (scaled.to(dtype).float() / scale).to(x.dtype)


def quantize(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
             fp8_max: float) -> torch.Tensor:
    """The real fp8 cast: ``clip(x * scale)`` stored in ``dtype`` (one byte an
    element). The result keeps x's strides (a transposed view quantizes to
    a transposed fp8 tensor)."""
    return torch.clamp(x.float() * scale, -fp8_max, fp8_max).to(dtype)


def _grad_scale(g: torch.Tensor, bmax: float) -> torch.Tensor:
    """Current scaling of a cotangent: ``bmax / amax``, 1 when it is 0."""
    g_amax = _amax(g)
    return torch.where(g_amax > 0.0, _over(bmax, torch.clamp(g_amax, min=1e-30)),
                       torch.ones_like(g_amax))


def _bwd_format(e4m3_bwd: bool) -> tuple[torch.dtype, float]:
    return (E4M3, E4M3_MAX) if e4m3_bwd else (E5M2, E5M2_MAX)


# ------------------------------------------------------------------ q-dq path
class _Fp8Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, x_scale, k_scale, e4m3_bwd):
        ctx.save_for_backward(x, kernel, x_scale, k_scale)
        ctx.e4m3_bwd = bool(e4m3_bwd)
        xq = quantize_dequantize(x, x_scale, E4M3, E4M3_MAX)
        kq = quantize_dequantize(kernel, k_scale, E4M3, E4M3_MAX)
        return xq @ kq

    @staticmethod
    def backward(ctx, g):
        x, kernel, x_scale, k_scale = ctx.saved_tensors
        bdt, bmax = _bwd_format(ctx.e4m3_bwd)
        gq = quantize_dequantize(g, _grad_scale(g, bmax), bdt, bmax)
        xq = quantize_dequantize(x, x_scale, E4M3, E4M3_MAX)
        kq = quantize_dequantize(kernel, k_scale, E4M3, E4M3_MAX)
        dx = (gq @ kq.T).to(x.dtype)
        dk = (xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])).to(kernel.dtype)
        return dx, dk, None, None, None


def fp8_dot(x: torch.Tensor, kernel: torch.Tensor, x_scale: torch.Tensor,
            k_scale: torch.Tensor, bwd_e4m3: bool) -> torch.Tensor:
    """q-dq product ``x [M, K] @ kernel [K, N]``: x and the kernel rounded to
    e4m3 at their scales, multiplied in x's dtype. The backward rounds the
    cotangent at its current scale (e5m2, or e4m3 under ``bwd_e4m3``)."""
    return _Fp8Dot.apply(x, kernel, x_scale, k_scale, bwd_e4m3)


# ----------------------------------------------------------------- native path
def fp8_gemm_reference(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                       b_scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of `fp8_gemm`: ``(a @ b) / (a_scale * b_scale)`` as an
    fp32 product of the upcast fp8 operands, cast to ``out_dtype``."""
    return ((a.float() @ b.float()) / (a_scale * b_scale)).to(out_dtype)


def _check_gemm(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fp8_gemm multiplies [M, K] by [K, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype not in (E4M3, E5M2) or b.dtype not in (E4M3, E5M2):
        raise TypeError(f"fp8_gemm takes e4m3 or e5m2 operands, got {a.dtype} and {b.dtype}")
    if a.dtype == E5M2 and b.dtype == E5M2:
        raise TypeError("fp8_gemm: the tensor cores take no e5m2 x e5m2 product")


def fp8_gemm(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor, b_scale: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``(a @ b) / (a_scale * b_scale)`` in ``out_dtype``, fp32 accumulation,
    for fp8 ``a [M, K]`` and ``b [K, N]`` (e4m3 or e5m2, not both e5m2) with
    fp32 0-d quantization scales. CPU: `fp8_gemm_reference`. CUDA:
    ``torch._scaled_mm`` with the reciprocal scales, ``a`` made row-major and
    ``b`` column-major (copies when they are not); M, K and N must be
    multiples of 16."""
    _check_gemm(a, b)
    if a.device.type == "cpu":
        return fp8_gemm_reference(a, b, a_scale, b_scale, out_dtype)
    if a.device.type != "cuda":
        raise RuntimeError(f"fp8_gemm runs on cuda or cpu, got {a.device}")
    if any(n % GEMM_MULTIPLE for n in (*a.shape, b.shape[1])):
        raise ValueError(f"fp8_gemm on CUDA needs M, K and N multiples of {GEMM_MULTIPLE}, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if not a.is_contiguous():
        a = a.contiguous()
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    out = torch._scaled_mm(a, b, scale_a=torch.reciprocal(a_scale).reshape(()),
                           scale_b=torch.reciprocal(b_scale).reshape(()), out_dtype=out_dtype)
    fp8_gemm.calls += 1
    return out


fp8_gemm.calls = 0


class _Fp8DotNative(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, x_scale, k_scale, e4m3_bwd):
        # the residuals are the fp8 tensors: the backward rereads one-byte
        # operands instead of compute-dtype ones
        xq = quantize(x, x_scale, E4M3, E4M3_MAX)
        kq = quantize(kernel, k_scale, E4M3, E4M3_MAX)
        ctx.save_for_backward(xq, kq, x_scale, k_scale)
        ctx.e4m3_bwd = bool(e4m3_bwd)
        return fp8_gemm(xq, kq, x_scale, k_scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, kq, x_scale, k_scale = ctx.saved_tensors
        bdt, bmax = _bwd_format(ctx.e4m3_bwd)
        g_scale = _grad_scale(g, bmax)
        gq = quantize(g.contiguous(), g_scale, bdt, bmax)
        # the cotangent's dtype is the output's, the compute dtype
        dx = fp8_gemm(gq, kq.T, g_scale, k_scale, g.dtype) if ctx.needs_input_grad[0] else None
        dk = None
        if ctx.needs_input_grad[1]:
            # dK^T = g^T x: the [N, K] product of the weight's own layout, as
            # a [K, N] view
            dk = fp8_gemm(gq.T, xq, g_scale, x_scale, g.dtype).T
        return dx, dk, None, None, None


def fp8_dot_native(x: torch.Tensor, kernel: torch.Tensor, x_scale: torch.Tensor,
                   k_scale: torch.Tensor, bwd_e4m3: bool) -> torch.Tensor:
    """fp8-storage product ``x [M, K] @ kernel [K, N]``: both cast to real
    e4m3 tensors at their scales (`quantize`), multiplied with fp32
    accumulation and unscaled (`fp8_gemm`), in x's dtype. The backward
    scales the cotangent from its current amax into e5m2 (e4m3 under
    ``bwd_e4m3``) and forms dX and dK from the saved fp8 operands."""
    return _Fp8DotNative.apply(x, kernel, x_scale, k_scale, bwd_e4m3)


# ------------------------------------------------------------------- the layer
_META = ("input", "kernel")


class Fp8Linear(nn.Linear):
    """The reference's ``Fp8Dense`` as an ``nn.Linear``: the product runs
    through `fp8_dot_native` (``backend="native"``) or `fp8_dot` (``"qdq"``)
    in the compute dtype, then the bias is added in it. The delayed-scaling
    state is four persistent buffers, ``input_scale``,
    ``input_amax_history``, ``kernel_scale`` and ``kernel_amax_history``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 recipe: DelayedScalingRecipe | None = None, device: Any = None,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.recipe = recipe or DelayedScalingRecipe()
        for which in _META:
            for key, value in new_meta(self.recipe.amax_history_len, device).items():
                self.register_buffer(f"{which}_{key}", value)

    def meta(self, which: str) -> dict[str, torch.Tensor]:
        """The ``input`` or ``kernel`` scaling state, as the reference's
        ``fp8_meta`` entry holds it."""
        return {"scale": getattr(self, f"{which}_scale"),
                "amax_history": getattr(self, f"{which}_amax_history")}

    def _scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (input, kernel) scales of this forward: the state's, or, in the
        recompute of a checkpointed block, the ones its first forward used."""
        frame = remat.current_frame()
        if frame is not None and frame.recompute:
            return frame.saved[id(self)]
        scales = (self.input_scale.detach().clone(), self.kernel_scale.detach().clone())
        if frame is not None:
            frame.saved[id(self)] = scales
        return scales

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        r = self.recipe
        dtype = dtype or x.dtype
        kernel = self.weight.to(dtype).T  # [in, out], the reference's layout
        xc = x.to(dtype)
        lead = xc.shape[:-1]
        x_scale, k_scale = self._scales()
        dot = fp8_dot_native if r.backend == "native" else fp8_dot
        out = dot(xc.reshape(-1, xc.shape[-1]), kernel, x_scale, k_scale,
                  r.fp8_format.upper() == "E4M3").reshape(*lead, self.out_features)
        frame = remat.current_frame()
        if self.training and not (frame is not None and frame.recompute):
            with torch.no_grad():
                for which, t in (("input", xc), ("kernel", kernel)):
                    new = _update_meta(self.meta(which), t, E4M3_MAX, r.margin)
                    getattr(self, f"{which}_amax_history").copy_(new["amax_history"])
                    getattr(self, f"{which}_scale").copy_(new["scale"])
        if self.bias is not None:
            out = out + self.bias.to(dtype)
        return out

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, recipe={self.recipe}"


def convert_dense_to_fp8(recipe: DelayedScalingRecipe | None = None) -> Callable[..., nn.Linear]:
    """The projection factory: ``make(in_features, out_features, **kw)`` builds
    an `Fp8Linear` under ``recipe``, or a plain ``nn.Linear`` when it is
    None (the reference's ``convert_dense_to_fp8``)."""
    if recipe is None:
        return nn.Linear

    def make(in_features: int, out_features: int, **kwargs: Any) -> Fp8Linear:
        return Fp8Linear(in_features, out_features, recipe=recipe, **kwargs)

    return make


# ------------------------------------------------------ MS-AMP-role opt levels
def _requant_leaf(x: torch.Tensor, dtype: torch.dtype, fmax: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` scaled so its amax sits at half the format's range, stored in
    ``dtype``; (payload, scale)."""
    amax = x.abs().max().float()
    scale = torch.where(amax > 0.0, _over(fmax / 2.0, torch.clamp(amax, min=1e-30)),
                        torch.ones_like(amax))
    return (x.float() * scale).to(dtype), scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() / scale


class AdamWFp8(torch.optim.Optimizer):
    """AdamW with its moments in scaled low precision (the reference's
    ``adamw_fp8(opt_level="O2")``, MS-AMP's O2): per parameter, ``mu`` in
    e4m3 and ``nu`` in fp16, each with an fp32 0-d scale that puts the
    tensor's amax at half the format's range. Each step dequantizes, updates
    in fp32, requantizes, and applies ``p -= lr * (adam + weight_decay *
    p)``. The step count is one for all parameters, as optax's."""

    def __init__(self, params: Iterable, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def _init(self, p: torch.Tensor) -> dict:
        return {"mu": torch.zeros(p.shape, dtype=E4M3, device=p.device),
                "mu_scale": torch.ones((), dtype=torch.float32, device=p.device),
                "nu": torch.zeros(p.shape, dtype=torch.float16, device=p.device),
                "nu_scale": torch.ones((), dtype=torch.float32, device=p.device)}

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            count = group["count"] = group.get("count", 0) + 1
            # optax's bias corrections: fp32 powers of the fp32 count
            c = torch.tensor(float(count), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(p))
                g = p.grad.float()
                mu = b1 * _dequant_leaf(state["mu"], state["mu_scale"]) + (1 - b1) * g
                nu = b2 * _dequant_leaf(state["nu"], state["nu_scale"]) + (1 - b2) * (g * g)
                update = ((mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])).to(p.grad.dtype)
                state["mu"], state["mu_scale"] = _requant_leaf(mu, E4M3, E4M3_MAX)
                state["nu"], state["nu_scale"] = _requant_leaf(nu, torch.float16, F16_MAX)
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(-group["lr"] * update)
        return loss


def adamw_fp8(params: Iterable, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0,
              opt_level: str = "O2") -> torch.optim.Optimizer:
    """AdamW over ``params`` at the reference's opt levels: ``"O1"`` is
    ``torch.optim.AdamW`` (fp32 moments), ``"O2"`` is `AdamWFp8` (e4m3 mu,
    fp16 nu, scaled). The reference's transformation takes no parameters;
    a torch optimizer is built over them."""
    if opt_level == "O1":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    if opt_level != "O2":
        raise ValueError(f"Unknown fp8 opt_level {opt_level!r}; use 'O1' or 'O2'")
    return AdamWFp8(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


# ------------------------------------------- the reference's fp8_meta collection
_META_BUFFERS = tuple(f"{which}_{key}" for which in _META for key in ("scale", "amax_history"))


def is_meta_key(name: str) -> bool:
    """Whether a state-dict key is an `Fp8Linear`'s scaling state."""
    return name.rsplit(".", 1)[-1] in _META_BUFFERS


def meta_to_jax(state_dict: dict[str, torch.Tensor], layers: str, prefix: str) -> dict:
    """The scaling buffers of a state dict (``{layers}.{i}.{group}.{name}.
    {input|kernel}_{scale|amax_history}``) as the reference's ``fp8_meta``
    collection (``{prefix}_{i}/{group}/{name}/{input|kernel}/{scale|
    amax_history}``), CPU tensors."""
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] != layers or len(parts) != 5 or not is_meta_key(key):
            continue
        _, i, group, name, buf = parts
        which, field = buf.split("_", 1)
        node = tree.setdefault(f"{prefix}_{i}", {}).setdefault(group, {}).setdefault(name, {})
        node.setdefault(which, {})[field] = value.detach().to("cpu", copy=True)
    return tree


def meta_from_jax(tree: dict, layers: str, prefix: str) -> dict[str, torch.Tensor]:
    """The inverse of `meta_to_jax`: a reference ``fp8_meta`` collection
    (numpy or torch leaves) as state-dict entries, fp32."""
    sd = {}
    for top, groups in tree.items():
        i = top[len(prefix) + 1:]
        for group, names in groups.items():
            for name, metas in names.items():
                for which, fields in metas.items():
                    for field, value in fields.items():
                        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                            np.array(value, dtype=np.float32))
                        sd[f"{layers}.{i}.{group}.{name}.{which}_{field}"] = t.float()
    return sd
