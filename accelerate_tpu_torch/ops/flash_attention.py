"""Paged decode attention: the port of `accelerate_tpu.ops.flash_attention`
``paged_decode_attention`` and its Pallas kernel ``_paged_decode_kernel``.

`paged_decode_attention` keeps the reference's signature, layouts and
validation. On a CPU tensor it runs `paged_decode_attention_reference`, the
plain PyTorch version (gather ``pool[table]``, masked `dot_product_attention`).
On a CUDA tensor it launches the hand-written kernel in
``csrc/paged_decode.cu`` or raises: there is no fall back. The module-level
count ``paged_decode_attention.launches`` grows by one per kernel launch, so a
run can show that its decode steps went through the kernel.

The flash attention kernels of the reference (forward, backward, band) belong
to the training slice and are not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import dot_product_attention

# dtype codes of the C entry point (csrc/paged_decode.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)


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
