"""Flash attention and paged decode attention: the port of
`accelerate_tpu.ops.flash_attention`.

Three families of hand-written CUDA kernels, each beside its plain PyTorch
version:

  - rectangular flash attention (`flash_attention`), the reference's
    ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``, in
    ``csrc/flash_attention.cu``, wrapped by `flash_attention_fwd`,
    `flash_attention_dq` and `flash_attention_dkv` and tied together by a
    `torch.autograd.Function`;
  - band flash attention (`flash_attention` with ``window=`` or
    ``triangle_block=``: causal self-attention over the in-band tiles only,
    optionally with a sliding window, GQA K/V unrepeated), the reference's
    ``_fwd_band_kernel``, ``_dq_band_kernel`` and ``_dkv_band_kernel``, in
    the same source over the same tile bodies, wrapped by `flash_band_fwd`,
    `flash_band_dq` and `flash_band_dkv` and tied together by `_FlashBand`;
  - paged decode attention (`paged_decode_attention`), the reference's
    ``_paged_decode_kernel``, in ``csrc/paged_decode.cu``.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor or raises: there is no fall back. Each keeps a module-level
count ``<wrapper>.launches`` that grows by one per kernel launch, so a run can
show that its steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .attention import dot_product_attention

# dtype codes of the C entry points (csrc/paged_decode.cu, csrc/flash_attention.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
FLASH_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30  # the reference's mask value (not -inf)


# ------------------------------------------------------ rectangular flash attention
def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int | None = None) -> torch.Tensor:
    """fp32 ``q . k^T`` over ``[b, h, s, d]``, query i masked to keys <= i
    with NEG_INF when causal, and to keys > i - window as well under a
    window (the reference's ``_band_logits`` rule)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        keep = j <= i
        if window is not None:
            keep &= j > i - window
        s = torch.where(keep, s, NEG_INF)
    return s


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to fp32: the reference's
    ``.astype(input dtype)`` before a product with fp32 accumulation."""
    return x.to(dtype).float()


def flash_attention_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      causal: bool, window: int | None = None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel over ``[b, h, s, d]`` with q
    pre-scaled: ``(o, lse)``, o in q's dtype, lse fp32 ``[b, h, sq]``. One
    global-max softmax in fp32; p is rounded to the input dtype before P.V and
    the denominator sums the unrounded p; a row whose denominator is 0 gives
    zeros, as the kernel's ``l == 0`` guard does. ``window`` (causal only)
    narrows each row to keys > i - window."""
    s = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", _rounded(p, v.dtype), v.float()) / safe_l
    return o.to(q.dtype), (m + torch.log(safe_l))[..., 0]


def _delta(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32 ``[b, h, sq]``, computed outside the kernels as
    the reference does."""
    return (dout.float() * o.float()).sum(dim=-1)


def _probs(q, k, lse, causal, window=None):
    return torch.exp(_scores(q, k, causal, window) - lse[..., None])


def flash_attention_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                                 window: int | None = None) -> torch.Tensor:
    """The plain version of the dQ kernel: ``dS = P * (dP - delta)`` with P
    recomputed from lse, rounded to the input dtype before ``dS . K``."""
    p = _probs(q, k, lse, causal, window)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", _rounded(ds, k.dtype), k.float()).to(q.dtype)


def _dkv_fp32(q, k, v, dout, lse, delta, causal, window=None):
    """fp32 (dK, dV) over ``[b, h, s, d]``: ``dV = P^T . dO`` with P rounded
    to dO's dtype, ``dK = dS^T . Q`` with dS rounded to q's dtype."""
    p = _probs(q, k, lse, causal, window)
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(p, dout.dtype), dout.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype), q.float())
    return dk, dv


def flash_attention_dkv_reference(q, k, v, dout, lse, delta,
                                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV kernel (`_dkv_fp32`), each gradient
    rounded once to its input's dtype."""
    dk, dv = _dkv_fp32(q, k, v, dout, lse, delta, causal)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, dout,
                                       causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward over ``[b, h, s, d]``: ``(dq, dk, dv)`` in the
    input dtypes, from the forward's ``o`` and ``lse``."""
    delta = _delta(o, dout)
    dq = flash_attention_dq_reference(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_error_string.restype is not ctypes.c_char_p:
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [i, p, i, i]  # device, stream, dtype, head_dim
        for kind, n_ptrs in (("fwd", 5), ("dq", 7), ("dkv", 8)):
            rect = getattr(lib, f"flash_attention_{kind}")  # causal, ..., b * h, sq, skv
            rect.argtypes, rect.restype = head + [i] + [p] * n_ptrs + [i] * 3, i
            band = getattr(lib, f"flash_band_{kind}")  # ..., b * hq, s, groups, window
            band.argtypes, band.restype = head + [p] * n_ptrs + [i] * 4, i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _flash_launch(name: str, q: torch.Tensor, *args) -> None:
    """Call the C entry point ``name`` of ``csrc/flash_attention.cu`` on q's
    device and current stream, with q's dtype code and head_dim, then
    ``args`` (a tensor passes as its data pointer); raise if it returns a
    CUDA error."""
    lib = _flash_lib()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
                                 _DTYPE_CODES[q.dtype], q.shape[-1], *args)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {err})")


def _kernel_operands(name: str, *tensors: torch.Tensor, rows: tuple[torch.Tensor, ...] = (),
                     grouped: bool = False) -> list[torch.Tensor]:
    """Validate the kernel's ``[b, h, s, d]`` operands ``(q, k, v[, dO])``
    and fp32 ``[b, h, sq]`` ``rows`` (lse, delta): one CUDA device, shapes
    that agree, one dtype and a head_dim the kernel is built for. With
    ``grouped`` (the band kernels) K/V are ``[b, hkv, s, d]`` with ``hq`` a
    multiple of ``hkv`` and one s for all. Returns the operands, then the
    rows, contiguous and 16-byte aligned, as the kernels' vector loads and the
    bf16 forward's TMA maps need."""
    q, k, v = tensors[:3]
    dev = q.device
    if any(t.device != dev for t in tensors + rows):
        raise ValueError(f"{name}: every input must be on {dev}")
    if grouped:
        if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0]
                or k.shape[2:] != q.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
            raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                             "must be [b, hq, s, d] and [b, hkv, s, d] with one b, s and d "
                             "and hq a multiple of hkv")
    elif q.ndim != 4 or k.shape != v.shape or k.shape[:2] + k.shape[3:] != q.shape[:2] + q.shape[3:]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must be [b, h, s, d] with one b, h and d")
    if any(t.shape != q.shape for t in tensors[3:]):
        raise ValueError(f"{name}: dO must have q's shape {tuple(q.shape)}")
    if any(r.shape != q.shape[:3] for r in rows):
        raise ValueError(f"{name}: lse and delta must be [b, h, sq] = {tuple(q.shape[:3])}")
    if q.dtype not in FLASH_KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes {FLASH_KERNEL_DTYPES} inputs, got {q.dtype}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v and dO must share one dtype")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head_dim {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    out = []
    for t in tensors + tuple(r.float() for r in rows):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _on_device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, got {t.device}")
    return True


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward over ``[b, h, s, d]`` (q pre-scaled, K/V at q's head count):
    ``(o, lse)``. CPU: `flash_attention_forward_reference`; CUDA: the
    ``flash_fwd_kernel`` (fp32/bf16, head_dim 64 or 128, any lengths)."""
    if not _on_device("flash_attention_fwd", q):
        return flash_attention_forward_reference(q, k, v, causal)
    q, k, v = _kernel_operands("flash_attention_fwd", q, k, v)
    b, h, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _flash_launch("flash_attention_fwd", q, int(causal), q, k, v, o, lse, b * h, sq, k.shape[2])
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    """dQ over ``[b, h, s, d]`` from the saved lse and delta = rowsum(dO * O).
    CPU: `flash_attention_dq_reference`; CUDA: the ``flash_dq_kernel``."""
    if not _on_device("flash_attention_dq", q):
        return flash_attention_dq_reference(q, k, v, dout, lse, delta, causal)
    q, k, v, dout, lse, delta = _kernel_operands("flash_attention_dq", q, k, v, dout,
                                                  rows=(lse, delta))
    b, h, sq, _ = q.shape
    dq = torch.empty_like(q)
    _flash_launch("flash_attention_dq", q, int(causal), q, k, v, dout, lse, delta, dq,
                  b * h, sq, k.shape[2])
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, dout, lse, delta, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) over ``[b, h, s, d]``. CPU: `flash_attention_dkv_reference`;
    CUDA: the ``flash_dkv_kernel``."""
    if not _on_device("flash_attention_dkv", q):
        return flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal)
    q, k, v, dout, lse, delta = _kernel_operands("flash_attention_dkv", q, k, v, dout,
                                                  rows=(lse, delta))
    b, h, sq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("flash_attention_dkv", q, int(causal), q, k, v, dout, lse, delta, dk, dv,
                  b * h, sq, k.shape[2])
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward saves ``(q, k, v, o,
    lse)``; backward computes delta in fp32 and runs the dQ and dK/dV
    kernels. Gradients come back in the input dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        delta = _delta(o, dout)
        dq = flash_attention_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


# ------------------------------------------------------------ band flash attention
def band_block_default(sq: int) -> int | None:
    """The reference's default band block for a causal or windowed sequence:
    the largest divisor of ``sq`` that is <= 512, or None when that divisor
    is < 8 (a prime length, say). The CUDA kernels choose their own tiles;
    this only decides, as in the reference, whether a window may take the
    band route."""
    best = next(b for b in range(min(512, sq), 0, -1) if sq % b == 0)
    return best if best >= 8 else None


def _repeat_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """``[b, hkv, s, d]`` K or V repeated to the query heads (h // groups
    reads kv head h)."""
    return t.repeat_interleave(groups, dim=1) if groups > 1 else t


def flash_band_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the band forward kernel: q ``[b, hq, s, d]``
    pre-scaled, k and v ``[b, hkv, s, d]``; key j is visible from query i iff
    ``i - window < j <= i`` (``j <= i`` when ``window`` is None). ``(o,
    lse)`` with the rounding points of `flash_attention_forward_reference`."""
    groups = q.shape[1] // k.shape[1]
    return flash_attention_forward_reference(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                                             True, window)


def flash_band_dq_reference(q, k, v, dout, lse, delta, window: int | None) -> torch.Tensor:
    """The plain version of the band dQ kernel (shapes as
    `flash_band_forward_reference`)."""
    groups = q.shape[1] // k.shape[1]
    return flash_attention_dq_reference(q, _repeat_kv(k, groups), _repeat_kv(v, groups), dout,
                                        lse, delta, True, window)


def flash_band_dkv_reference(q, k, v, dout, lse, delta,
                             window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the band dK/dV kernel: each query head's fp32
    dK and dV, summed over the query heads of its kv head's group in fp32,
    then rounded once to ``[b, hkv, s, d]`` in K's and V's dtypes."""
    b, hkv, s, d = k.shape
    groups = q.shape[1] // hkv
    dk, dv = _dkv_fp32(q, _repeat_kv(k, groups), _repeat_kv(v, groups), dout, lse, delta,
                       True, window)
    dk = dk.reshape(b, hkv, groups, s, d).sum(dim=2)
    dv = dv.reshape(b, hkv, groups, s, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _band_shape(q: torch.Tensor, k: torch.Tensor, window: int | None) -> tuple[int, int, int, int]:
    """(b * hq, s, groups, window code) for the C entry points. A window of at
    least s cuts nothing and passes as 0, no lower edge, which also keeps the
    kernel's index arithmetic inside int."""
    b, hq, s, _ = q.shape
    code = 0 if window is None or window >= s else int(window)
    return b * hq, s, hq // k.shape[1], code


def flash_band_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Band forward: q ``[b, hq, s, d]`` pre-scaled, k and v ``[b, hkv, s,
    d]`` unrepeated: ``(o, lse)``, lse fp32 ``[b, hq, s]``. CPU:
    `flash_band_forward_reference`; CUDA: the ``flash_band_fwd_kernel``
    (fp32/bf16, head_dim 64 or 128, any s)."""
    if not _on_device("flash_band_fwd", q):
        return flash_band_forward_reference(q, k, v, window)
    q, k, v = _kernel_operands("flash_band_fwd", q, k, v, grouped=True)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _flash_launch("flash_band_fwd", q, q, k, v, o, lse, *_band_shape(q, k, window))
    flash_band_fwd.launches += 1
    return o, lse


def flash_band_dq(q, k, v, dout, lse, delta, window: int | None) -> torch.Tensor:
    """Band dQ from the saved lse and delta = rowsum(dO * O). CPU:
    `flash_band_dq_reference`; CUDA: the ``flash_band_dq_kernel``."""
    if not _on_device("flash_band_dq", q):
        return flash_band_dq_reference(q, k, v, dout, lse, delta, window)
    q, k, v, dout, lse, delta = _kernel_operands("flash_band_dq", q, k, v, dout,
                                                  rows=(lse, delta), grouped=True)
    dq = torch.empty_like(q)
    _flash_launch("flash_band_dq", q, q, k, v, dout, lse, delta, dq, *_band_shape(q, k, window))
    flash_band_dq.launches += 1
    return dq


def flash_band_dkv(q, k, v, dout, lse, delta,
                   window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Band (dK, dV) in kv-head shape ``[b, hkv, s, d]``, summed over each
    kv head's query heads. CPU: `flash_band_dkv_reference`; CUDA: the
    ``flash_band_dkv_kernel``."""
    if not _on_device("flash_band_dkv", q):
        return flash_band_dkv_reference(q, k, v, dout, lse, delta, window)
    q, k, v, dout, lse, delta = _kernel_operands("flash_band_dkv", q, k, v, dout,
                                                  rows=(lse, delta), grouped=True)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("flash_band_dkv", q, q, k, v, dout, lse, delta, dk, dv,
                  *_band_shape(q, k, window))
    flash_band_dkv.launches += 1
    return dk, dv


flash_band_fwd.launches = 0
flash_band_dq.launches = 0
flash_band_dkv.launches = 0


class _FlashBand(torch.autograd.Function):
    """The reference's ``_flash_band`` custom VJP (``_bwd_band``): forward
    saves ``(q, k, v, o, lse)``; backward computes delta in fp32 and runs the
    band dQ and dK/dV kernels. dK and dV come back in the kv-head shape K and
    V came in."""

    @staticmethod
    def forward(ctx, q, k, v, window: int | None):
        o, lse = flash_band_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        delta = _delta(o, dout)
        dq = flash_band_dq(q, k, v, dout, lse, delta, ctx.window)
        dk, dv = flash_band_dkv(q, k, v, dout, lse, delta, ctx.window)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    block_q: int | None = None,
    block_kv: int | None = None,
    triangle_block: int | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs, as the
    reference's `flash_attention`: q is scaled in its own dtype (``scale``
    defaults to ``1/sqrt(head_dim)``), head dims that are not a multiple of
    64 are zero-padded to a multiple of 128, and query i attends keys <= i
    when ``causal``.

    ``window=W`` (sliding window: query i attends keys in ``(i - W, i]``) or
    ``triangle_block`` takes causal self-attention onto the band kernels,
    which work on the in-band tiles only and read GQA K/V unrepeated (dK and
    dV come back in kv-head shape). Otherwise the rectangular kernels run,
    with GQA K/V repeated up to the query heads. The reference's argument
    rules hold, each a ValueError: a window needs causal self-attention and
    ``W >= 1``, and a sequence with a band block (`band_block_default`); an
    explicit ``triangle_block`` needs causal self-attention, excludes
    ``block_q``/``block_kv`` and must divide the sequence. ``triangle_block``
    and ``block_q``/``block_kv`` (default 1024, shrunk to the sequence) are
    the reference's TPU tiles: they are checked as the reference checks them,
    and the CUDA kernels choose their own tiles. The reference's
    ``ACCELERATE_TPU_FLASH_*`` environment knobs are not read."""
    b, sq, hn, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    if window is not None:
        if not causal or sq != skv:
            raise ValueError(
                "window applies only to causal self-attention (sq == skv); "
                f"got causal={causal}, sq={sq}, skv={skv}"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if triangle_block is None:
            triangle_block = band_block_default(sq)
            if triangle_block is None:  # e.g. prime sq: a 1-wide band grid is pathological
                raise ValueError(
                    f"window={window} needs a band grid, but seq {sq} has no "
                    "block divisor >= 8. Pad the sequence to a tileable "
                    "length, pass triangle_block explicitly, or use "
                    "implementation='xla'."
                )
    if triangle_block is not None:
        if not causal or sq != skv:
            raise ValueError(
                "triangle_block applies only to causal self-attention (sq == skv); "
                f"got causal={causal}, sq={sq}, skv={skv}"
            )
        if block_q is not None or block_kv is not None:
            raise ValueError("triangle_block and block_q/block_kv are mutually exclusive")
        if sq % min(triangle_block, sq):
            raise ValueError(f"triangle_block {triangle_block} must divide seq {sq}")
    if hn != hk and (hk == 0 or hn % hk):
        raise ValueError(f"q heads ({hn}) must be a multiple of kv heads ({hk})")
    if triangle_block is None:
        block_q = min(1024 if block_q is None else block_q, sq)
        block_kv = min(1024 if block_kv is None else block_kv, skv)
        if sq % block_q or skv % block_kv:
            raise ValueError(
                f"seq lengths ({sq}, {skv}) must divide block sizes ({block_q}, {block_kv})"
            )
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    # the scale rounded to q's dtype on the host (no device copy, no sync);
    # the product of two such values is exact in fp32 and rounds once, as
    # the reference's ``q * asarray(scale, q.dtype)`` does
    qt = q.transpose(1, 2) * float(torch.tensor(scale, dtype=q.dtype))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    d_pad = 0 if d % 64 == 0 else (128 - d % 128) % 128
    if d_pad:
        qt, kt, vt = (F.pad(t, (0, d_pad)) for t in (qt, kt, vt))
    if triangle_block is not None:
        out = _FlashBand.apply(qt.contiguous(), kt.contiguous(), vt.contiguous(), window)
    else:
        if hn != hk:
            kt = kt.repeat_interleave(hn // hk, dim=1)
            vt = vt.repeat_interleave(hn // hk, dim=1)
        out = _FlashAttention.apply(qt.contiguous(), kt.contiguous(), vt.contiguous(), causal)
    if d_pad:
        out = out[..., :d]
    return out.transpose(1, 2)


# ------------------------------------------------------------- paged decode



def _check_args(q, k_pool, v_pool, k_scale_pool, v_scale_pool) -> None:
    """The reference's validation (`accelerate_tpu/ops/flash_attention.py`
    ``paged_decode_attention``), with the same messages."""
    b, hq, d = q.shape
    num_blocks, block_tokens, kvh, dk = k_pool.shape
    if dk != d:
        raise ValueError(f"q head_dim {d} != pool head_dim {dk}")
    if hq % kvh:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({kvh})")
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool and v_scale_pool must be passed together")
    if k_scale_pool is not None and tuple(k_scale_pool.shape) != (num_blocks, block_tokens, kvh):
        raise ValueError(
            f"scale pool shape {tuple(k_scale_pool.shape)} != "
            f"{(num_blocks, block_tokens, kvh)} (per-block absmax planes)"
        )


def paged_decode_attention_reference(
    q: torch.Tensor,  # [b, n_heads, head_dim]: one decode query per slot row
    k_pool: torch.Tensor,  # [num_blocks, block_tokens, kv_heads, head_dim]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, blocks_per_slot] int pool block ids
    lengths: torch.Tensor,  # [b] int valid kv positions (frontier cursor + 1)
    *,
    k_scale_pool: torch.Tensor | None = None,  # [num_blocks, block_tokens, kv_heads] fp32
    v_scale_pool: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: gather each row's table
    blocks into a contiguous ``[b, span, kv_heads, head_dim]`` view and run
    masked attention over it (positions ``>= lengths[i]`` masked). Sentinel
    table ids are clamped to ``num_blocks - 1`` and a row with
    ``lengths <= 0`` returns zeros, as the kernel does. An int8 pool is
    dequantized as ``(int8 * scale)`` cast to q's dtype, the rounding of
    `models.kv_cache._dq`. Returns ``[b, n_heads, head_dim]`` in q's dtype."""
    _check_args(q, k_pool, v_pool, k_scale_pool, v_scale_pool)
    b = q.shape[0]
    num_blocks, block_tokens = k_pool.shape[:2]
    span = block_tables.shape[1] * block_tokens
    tables = block_tables.long().clamp(max=num_blocks - 1)

    def view(pool):
        return pool[tables].reshape((b, span) + tuple(pool.shape[2:]))

    k_all, v_all = view(k_pool), view(v_pool)
    if k_scale_pool is not None:
        k_all = (k_all.float() * view(k_scale_pool).float()[..., None]).to(q.dtype)
        v_all = (v_all.float() * view(v_scale_pool).float()[..., None]).to(q.dtype)
    groups = q.shape[1] // k_pool.shape[2]
    if groups > 1:  # the masked path of attention() repeats kv heads likewise
        k_all = k_all.repeat_interleave(groups, dim=2)
        v_all = v_all.repeat_interleave(groups, dim=2)
    lengths = lengths.to(q.device)
    pos = torch.arange(span, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]  # [b, 1, 1, span]
    out = dot_product_attention(q[:, None], k_all, v_all, mask=mask, scale=scale)[:, 0]
    live = (lengths > 0)[:, None, None]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float]
        fn.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [i]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pool, v_pool, block_tables, lengths, k_scale_pool, v_scale_pool,
            scale) -> torch.Tensor:
    dev = q.device
    b, hq, d = q.shape
    num_blocks, block_tokens, kvh, _ = k_pool.shape
    groups = hq // kvh
    quant = k_scale_pool is not None
    tensors = [k_pool, v_pool, block_tables, lengths]
    if quant:
        tensors += [k_scale_pool, v_scale_pool]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"paged_decode_attention: every input must be on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"paged_decode_attention kernel takes fp32/bf16/fp16 queries, got {q.dtype}")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("scale planes go with an int8 pool")
        if k_scale_pool.dtype != torch.float32 or v_scale_pool.dtype != torch.float32:
            raise TypeError("scale planes must be float32")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"pool dtype {k_pool.dtype}/{v_pool.dtype} must match q dtype {q.dtype} "
            "(or be int8 with scale planes)"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel supports head_dim {KERNEL_HEAD_DIMS}, got {d}")
    if groups not in KERNEL_GROUPS:
        raise ValueError(f"paged_decode_attention kernel supports GQA groups {KERNEL_GROUPS}, got {groups}")
    pools = [k_pool, v_pool] + ([k_scale_pool, v_scale_pool] if quant else [])
    if not all(t.is_contiguous() for t in pools):
        # a silent .contiguous() would copy the whole pool every call
        raise ValueError("paged_decode_attention kernel needs contiguous pools")
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_decode_attention(
            dev.index, stream, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], d, groups,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale_pool.data_ptr() if quant else None,
            v_scale_pool.data_ptr() if quant else None,
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            b, kvh, num_blocks, block_tokens, tables.shape[1], float(scale),
        )
    if err != 0:
        msg = lib.paged_decode_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention kernel launch failed: {msg} (cuda error {err})")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [b, n_heads, head_dim]: one decode query per slot row
    k_pool: torch.Tensor,  # [num_blocks, block_tokens, kv_heads, head_dim]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, blocks_per_slot] int32 pool block ids
    lengths: torch.Tensor,  # [b] int32 valid kv positions (frontier cursor + 1)
    *,
    k_scale_pool: torch.Tensor | None = None,  # [num_blocks, block_tokens, kv_heads]
    v_scale_pool: torch.Tensor | None = None,  # fp32 absmax planes (int8 pool)
    scale: float | None = None,
) -> torch.Tensor:
    """Single-query paged attention that reads K/V blocks in place from the
    per-layer block pool (`models.kv_cache.paged_decode_write`): the fused
    replacement for the serving engine's ``pool[table]`` gather.

    Row ``i`` attends positions ``0..lengths[i]-1`` of its logical sequence;
    position ``p`` lives in pool block ``block_tables[i, p // block_tokens]``
    at offset ``p % block_tokens``. Table entries at or past the pool size
    (the engine's released-slot sentinel) are clamped to a real block. GQA
    pools read kv head ``h // (n_heads // kv_heads)`` directly. An int8 pool
    passes its fp32 scale planes as ``k_scale_pool``/``v_scale_pool``.
    Logits are scaled after the product by ``scale`` (default
    ``1/sqrt(head_dim)``). Returns ``[b, n_heads, head_dim]`` in q's dtype.

    On the CPU this is `paged_decode_attention_reference`. On a CUDA device
    it launches the ``sm_90a`` kernel (pool dtypes fp32/bf16/fp16, or int8
    with scale planes; head_dim 64 or 128; GQA groups 1, 2, 4 or 8) and
    raises on anything it does not take."""
    _check_args(q, k_pool, v_pool, k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, lengths,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool, scale=scale,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention runs on cuda or cpu, got {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch(q, k_pool, v_pool, block_tables, lengths, k_scale_pool, v_scale_pool, scale)


paged_decode_attention.launches = 0
