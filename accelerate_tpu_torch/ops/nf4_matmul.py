"""NF4 dequant-matmul: the port of `accelerate_tpu.ops.nf4_matmul`.

``nf4_matmul(x, qt)`` computes ``x @ dequantize(qt)`` for a 4-bit NF4 weight
``qt`` (``[K, N]``, the reference's layout) while reading only its packed
bytes and scales: in eager PyTorch nothing fuses a dequantize into the
product, so the dequantize route writes and reads a dense copy of the weight
on every call, and this kernel is the route that reads 4 bits a weight.

Plane packing (`plane_pack`), as the reference's: byte ``(k, j)`` of the
``[K, N/2]`` uint8 plane holds element ``(k, j)`` in its high nibble and
``(k, j + N/2)`` in its low nibble, and the blockwise scales arrive split by
plane as ``[2, K, (N/2)/64]`` fp32. It is built once on the tensor's device
and cached on the tensor.

Routing follows the reference's rule, by shape, never on failure: an nf4,
2-D tensor with 64-element blocks and ``N % 128 == 0`` whose K admits the
reference's tile search (`routes_to_kernel`) goes to the kernel; every other
tensor takes the plain dequantize route, ``x @ dequantize(qt, x.dtype)``. On
a CPU tensor the kernel's place is taken by its plain version,
`nf4_matmul_reference`; on a CUDA tensor ``csrc/nf4_matmul.cu`` runs or the
call raises. ``nf4_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.quantization import NF4_CODE, QuantizedTensor, dequantize
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the reference's default Pallas tiles, kept only for its routing rule
_BLOCK_K, _BLOCK_N = 256, 128
_TILE_BYTES = 128  # byte columns of one CTA (csrc/nf4_matmul.cu kTileBytes)
_MAX_ROWS = 16  # M rows of one CTA (csrc/nf4_matmul.cu kMaxRows)
MAX_SPLITS = 16  # CTAs of a cluster (csrc/nf4_matmul.cu kMaxSplits)
_FILL_CTAS = 4 * 132  # four CTAs for each of an H100 SXM's 132 SMs


def _block_size(qt: QuantizedTensor) -> int:
    """Elements per scale, derived from the scale count (the reference's)."""
    total = 1
    for dim in qt.shape:
        total *= dim
    n_blocks = int(qt.scales.shape[0])
    return -(-total // n_blocks) if n_blocks else 0


def kernel_supported(qt: QuantizedTensor) -> bool:
    """The reference's rule: nf4, 2-D, 64-element scale blocks, and N tiling
    two 64-wide planes (its tracer clause has no counterpart here)."""
    return (qt.bits == 4 and qt.quant_type == "nf4" and len(qt.shape) == 2
            and qt.shape[1] % 128 == 0 and _block_size(qt) == 64)


def _reference_tiles(K: int, N: int) -> tuple[int, int]:
    """The reference's tile search (``nf4_matmul`` ``:144-151``): the K tile
    halves from ``min(256, K)`` until it divides K, the N tile is the largest
    multiple of 64 up to 128 that divides N/2 (0 when none does)."""
    bk = min(_BLOCK_K, K)
    while K % bk:
        bk //= 2
    P = N // 2
    top = min(_BLOCK_N, P)
    bn = next((c for c in range(top - top % 64, 63, -64) if P % c == 0), 0)
    return bk, bn


def routes_to_kernel(qt: QuantizedTensor) -> bool:
    """True when ``nf4_matmul`` takes ``qt`` to the kernel: the reference's
    `kernel_supported` and its tile checks (``bk >= 8``, ``bn >= 64``)."""
    if not kernel_supported(qt):
        return False
    bk, bn = _reference_tiles(*qt.shape)
    return bk >= 8 and bn >= 64


def plane_pack(qt: QuantizedTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of ``qt``, on ``qt``'s device: (packed ``[K, N/2]``
    uint8, high nibble column j and low nibble column j + N/2; scales ``[2,
    K, (N/2)/64]`` fp32). Cached on the tensor, so it is built once."""
    cached = qt._plane_pack
    if cached is not None:
        return cached
    if qt.bits != 4 or qt.quant_type != "nf4":
        raise ValueError(f"plane_pack needs an nf4 tensor, got {qt.bits}-bit {qt.quant_type}")
    if len(qt.shape) != 2:
        raise ValueError(f"plane_pack needs a 2D weight, got shape {qt.shape}")
    K, N = qt.shape
    if N % 128:
        raise ValueError(f"N ({N}) must be a multiple of 128 (two 64-wide scale planes)")
    if _block_size(qt) != 64:
        raise ValueError(f"plane_pack needs 64-element scale blocks, got {_block_size(qt)}")
    d = qt.data.to(torch.uint8)
    idx = torch.stack([d >> 4, d & 0xF], dim=-1).reshape(-1)[: K * N].reshape(K, N)
    P = N // 2
    packed = ((idx[:, :P] << 4) | idx[:, P:]).contiguous()
    scales = qt.scales.float().reshape(K, N // 64)
    scales2 = torch.stack([scales[:, : P // 64], scales[:, P // 64:]]).contiguous()
    qt._plane_pack = (packed, scales2)
    return qt._plane_pack


def nf4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                         scales2: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, as the reference's kernel body computes it:
    per plane, codebook value times the expanded block scale in fp32, an fp32
    product with x ``[M, K]``, then the two planes side by side, cast to x's
    dtype: ``[M, N]``."""
    code = torch.from_numpy(NF4_CODE).to(packed.device)
    p = packed.long()
    xf = x.float()
    planes = [xf @ (code[nib] * s.repeat_interleave(64, dim=1))
              for nib, s in ((p >> 4, scales2[0]), (p & 0xF, scales2[1]))]
    return torch.cat(planes, dim=-1).to(x.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("nf4_matmul")
    fn = lib.nf4_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, p, p, p, p, i, i, i, i, i]
        fn.restype = i
        lib.nf4_matmul_error_string.argtypes = [i]
        lib.nf4_matmul_error_string.restype = ctypes.c_char_p
    return lib


def split_k(M: int, K: int, N: int) -> tuple[int, int]:
    """(K splits, rows per split) of a launch: the CTAs of one cluster that
    share an output tile (128 byte columns by up to 16 rows of x) and the K
    rows each streams. K is split while the tiles alone give the card fewer
    than four CTAs a SM, into at most `MAX_SPLITS` runs of a multiple of 8
    rows; the cluster sums the runs' fp32 partials in its shared memory, in
    split order, inside the one launch (no workspace)."""
    rows_per_cta = min(_MAX_ROWS, 1 << max(0, M - 1).bit_length())
    tiles = -(-(N // 2) // _TILE_BYTES) * -(-M // rows_per_cta)
    splits = max(1, min(MAX_SPLITS, -(-_FILL_CTAS // tiles), -(-K // 8)))
    rows = -(-K // splits)
    rows = -(-rows // 8) * 8
    return -(-K // rows), rows


def _launch(x2: torch.Tensor, packed: torch.Tensor, scales2: torch.Tensor,
            N: int) -> torch.Tensor:
    dev = x2.device
    if packed.device != dev or scales2.device != dev:
        raise ValueError(f"nf4_matmul: x is on {dev}, the weight on {packed.device}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"nf4_matmul kernel takes {tuple(_DTYPE_CODES)} inputs, got {x2.dtype}")
    if packed.dtype != torch.uint8 or scales2.dtype != torch.float32:
        raise TypeError("nf4_matmul kernel takes a uint8 plane and fp32 scales")
    if not (packed.is_contiguous() and scales2.is_contiguous()) or packed.data_ptr() % 16:
        raise ValueError("nf4_matmul kernel needs a contiguous, 16-byte aligned plane")
    M, K = x2.shape
    x2 = x2.contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    if M == 0:
        return out
    splits, rows = split_k(M, K, N)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.nf4_matmul(dev.index, torch.cuda.current_stream(dev).cuda_stream,
                             _DTYPE_CODES[x2.dtype], x2.data_ptr(), packed.data_ptr(),
                             scales2.data_ptr(), out.data_ptr(), M, K, N, splits, rows)
    if err != 0:
        msg = lib.nf4_matmul_error_string(err).decode()
        raise RuntimeError(f"nf4_matmul kernel launch failed: {msg} (cuda error {err})")
    nf4_matmul.launches += 1
    return out


def nf4_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequantize(qt)`` for x ``[..., K]`` and ``qt`` ``[K, N]``, in
    x's dtype, accumulated in fp32 on the kernel route. A tensor that
    `routes_to_kernel` rejects takes the dequantize route (any device). On
    the kernel route a CPU tensor runs `nf4_matmul_reference` and a CUDA
    tensor launches ``csrc/nf4_matmul.cu`` (fp32, bf16 or fp16 x) or raises.
    The reference's ``block_k``/``block_n`` TPU tiles have no counterpart:
    the kernel chooses its own."""
    K, N = qt.shape
    if x.shape[-1] != K:
        raise ValueError(f"nf4_matmul: x has {x.shape[-1]} features, the weight {K}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not routes_to_kernel(qt):
        return (x2 @ dequantize(qt, x.dtype)).reshape(*lead, N)
    packed, scales2 = plane_pack(qt)
    if x2.device.type == "cpu":
        out = nf4_matmul_reference(x2, packed, scales2)
    elif x2.device.type == "cuda":
        out = _launch(x2, packed, scales2, N)
    else:
        raise RuntimeError(f"nf4_matmul runs on cuda or cpu, got {x2.device}")
    return out.reshape(*lead, N)


nf4_matmul.launches = 0
