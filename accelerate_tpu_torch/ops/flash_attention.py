"""Flash attention and paged decode attention: the port of
`accelerate_tpu.ops.flash_attention`.

Two families of hand-written CUDA kernels, each beside its plain PyTorch
version:

  - rectangular flash attention (`flash_attention`), the reference's
    ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``, in
    ``csrc/flash_attention.cu``, wrapped by `flash_attention_fwd`,
    `flash_attention_dq` and `flash_attention_dkv` and tied together by a
    `torch.autograd.Function`;
  - paged decode attention (`paged_decode_attention`), the reference's
    ``_paged_decode_kernel``, in ``csrc/paged_decode.cu``.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor or raises: there is no fall back. Each keeps a module-level
count ``<wrapper>.launches`` that grows by one per kernel launch, so a run can
show that its steps went through the kernels.

The reference's band kernels (``triangle_block=``/``window=``) are not ported
yet (ROADMAP Queue 2); `flash_attention` refuses those arguments.
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
def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 ``q . k^T`` over ``[b, h, s, d]``, query i masked to keys <= i
    with NEG_INF when causal, as the reference's kernels mask."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        keep = torch.arange(skv, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(keep, s, NEG_INF)
    return s


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to fp32: the reference's
    ``.astype(input dtype)`` before a product with fp32 accumulation."""
    return x.to(dtype).float()


def flash_attention_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel over ``[b, h, s, d]`` with q
    pre-scaled: ``(o, lse)``, o in q's dtype, lse fp32 ``[b, h, sq]``. One
    global-max softmax in fp32; p is rounded to the input dtype before P.V and
    the denominator sums the unrounded p; a row whose denominator is 0 gives
    zeros, as the kernel's ``l == 0`` guard does."""
    s = _scores(q, k, causal)
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


def _probs(q, k, lse, causal):
    return torch.exp(_scores(q, k, causal) - lse[..., None])


def flash_attention_dq_reference(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    """The plain version of the dQ kernel: ``dS = P * (dP - delta)`` with P
    recomputed from lse, rounded to the input dtype before ``dS . K``."""
    p = _probs(q, k, lse, causal)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", _rounded(ds, k.dtype), k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, dout, lse, delta,
                                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV kernel: ``dV = P^T . dO`` with P rounded
    to dO's dtype, ``dK = dS^T . Q`` with dS rounded to q's dtype."""
    p = _probs(q, k, lse, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(p, dout.dtype), dout.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype), q.float())
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
    if lib.flash_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [i, p, i, i, i]  # device, stream, dtype, head_dim, causal
        lib.flash_attention_fwd.argtypes = head + [p] * 5 + [i] * 3
        lib.flash_attention_dq.argtypes = head + [p] * 7 + [i] * 3
        lib.flash_attention_dkv.argtypes = head + [p] * 8 + [i] * 3
        for fn in (lib.flash_attention_fwd, lib.flash_attention_dq, lib.flash_attention_dkv):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_operands(name: str, *tensors: torch.Tensor,
                     rows: tuple[torch.Tensor, ...] = ()) -> list[torch.Tensor]:
    """Validate the kernel's ``[b, h, s, d]`` operands ``(q, k, v[, dO])``
    and fp32 ``[b, h, sq]`` ``rows`` (lse, delta): one CUDA device, shapes
    that agree, one dtype and a head_dim the kernel is built for. Returns the
    operands, then the rows, contiguous and 16-byte aligned, as the kernel's
    vector loads need."""
    q, k, v = tensors[:3]
    dev = q.device
    if any(t.device != dev for t in tensors + rows):
        raise ValueError(f"{name}: every input must be on {dev}")
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] + k.shape[3:] != q.shape[:2] + q.shape[3:]:
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


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {err})")


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
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
            _DTYPE_CODES[q.dtype], d, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b * h, sq, k.shape[2])
    _check_launch(lib, "flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    """dQ over ``[b, h, s, d]`` from the saved lse and delta = rowsum(dO * O).
    CPU: `flash_attention_dq_reference`; CUDA: the ``flash_dq_kernel``."""
    if not _on_device("flash_attention_dq", q):
        return flash_attention_dq_reference(q, k, v, dout, lse, delta, causal)
    q, k, v, dout, lse, delta = _kernel_operands("flash_attention_dq", q, k, v, dout,
                                                  rows=(lse, delta))
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dq(
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
            _DTYPE_CODES[q.dtype], d, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq, k.shape[2])
    _check_launch(lib, "flash_attention_dq", err)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, dout, lse, delta, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) over ``[b, h, s, d]``. CPU: `flash_attention_dkv_reference`;
    CUDA: the ``flash_dkv_kernel``."""
    if not _on_device("flash_attention_dkv", q):
        return flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal)
    q, k, v, dout, lse, delta = _kernel_operands("flash_attention_dkv", q, k, v, dout,
                                                  rows=(lse, delta))
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dkv(
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
            _DTYPE_CODES[q.dtype], d, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, sq, k.shape[2])
    _check_launch(lib, "flash_attention_dkv", err)
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
    reference's `flash_attention` on its rectangular path: q is scaled in its
    own dtype (``scale`` defaults to ``1/sqrt(head_dim)``), head dims that are
    not a multiple of 64 are zero-padded to a multiple of 128, GQA K/V are
    repeated up to the query heads, and query i attends keys <= i when
    ``causal``. ``block_q``/``block_kv`` are the reference's TPU tiles (default
    1024, shrunk to the sequence): they are checked to divide the sequence
    lengths as the reference requires; the CUDA kernels choose their own tiles.

    ``triangle_block`` and ``window`` select the reference's band kernels,
    which are not ported: they raise NotImplementedError."""
    if triangle_block is not None or window is not None:
        raise NotImplementedError(
            "flash_attention: the band kernels behind triangle_block=/window= "
            "(_fwd_band_kernel, _dq_band_kernel, _dkv_band_kernel) are not ported "
            "yet (ROADMAP Queue 2, item 3)"
        )
    b, sq, hn, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    if hn != hk and (hk == 0 or hn % hk):
        raise ValueError(f"q heads ({hn}) must be a multiple of kv heads ({hk})")
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
