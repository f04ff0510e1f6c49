"""Fused tied LM head + cross-entropy: the port of `accelerate_tpu.ops.fused_ce`.

The ``[N, V]`` logits never reach device memory: the forward streams vocab
tiles and reduces each row online to its logsumexp and its label's logit; the
backward recomputes the logits tiles against the saved logsumexp. Three
hand-written CUDA kernels in ``csrc/fused_ce.cu``, each beside its plain
PyTorch version:

  - `fused_ce_fwd` (the reference's ``_fwd_kernel``): ``(lse, ll)``;
  - `fused_ce_dh` (``_dh_kernel``): ``dH = dlogits . W``;
  - `fused_ce_dw` (``_dw_kernel``): ``dW = dlogits^T . H``;

with ``dlogits = g_lse * exp(logits - lse) + g_ll * onehot(label)``. A
`torch.autograd.Function` ties them together and `fused_cross_entropy` is
the public entry point.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor or raises: there is no fall back. Each keeps a module-level
count ``<wrapper>.launches`` that grows by one per kernel launch.

The reference's ``block_r``/``block_v`` are TPU VMEM tiles and are not
ported: the CUDA kernels choose their own tiles. Nor is its ``[N, 8]``
lane-broadcast layout of the row vectors, a TPU tiling artifact: they are
``[N]`` here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import _on_device

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc/fused_ce.cu
E_MULTIPLE = 64  # the kernels' e chunk: the wrappers zero-pad e to a multiple
# the bf16 forward kernel's tiles (csrc/fused_ce.cu, Sm90Fwd and kFwdBN) and
# the vocab splits it takes: 128 h rows a CTA, vocab tiles of 128 w rows, a
# power of two of splits a row tile, one cluster (past 8 CTAs, the
# non-portable size)
FWD_ROW_TILE = 128
FWD_VOCAB_TILE = 128
FWD_SPLITS = (1, 2, 4, 8, 16)


# ------------------------------------------------------------ plain versions
def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``h . w^T`` from the input-dtype operands (bf16 products are exact
    in fp32): the reference's ``preferred_element_type=float32``."""
    return h.float() @ w.float().T


def _label_index(labels: torch.Tensor, v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels clamped into ``[0, V)``, whether each label is in range): a
    label outside the vocabulary matches no column, as in the kernels."""
    labels = labels.long()
    return labels.clamp(0, v - 1), (labels >= 0) & (labels < v)


def fused_ce_forward_reference(h: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: per row of ``h [N, e]``
    against ``w [V, e]``, the fp32 logsumexp over the vocab (``m + log l``
    with ``l == 0`` read as 1) and the fp32 logit of ``labels [N]`` (0 for a
    label outside ``[0, V)``)."""
    logits = _logits(h, w)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.where(l == 0.0, 1.0, l))
    idx, valid = _label_index(labels, w.shape[0])
    ll = torch.where(valid, logits.gather(1, idx[:, None])[:, 0], 0.0)
    return lse, ll


def _dlogits(h, w, labels, lse, g_lse, g_ll) -> torch.Tensor:
    """fp32 ``g_lse * exp(logits - lse) + g_ll * onehot(label)``, ``[N, V]``."""
    dl = g_lse.float()[:, None] * torch.exp(_logits(h, w) - lse.float()[:, None])
    idx, valid = _label_index(labels, w.shape[0])
    rows = torch.arange(h.shape[0], device=h.device)
    return dl.index_put_((rows, idx), torch.where(valid, g_ll.float(), 0.0), accumulate=True)


def fused_ce_dh_reference(h, w, labels, lse, g_lse, g_ll) -> torch.Tensor:
    """The plain version of the dH kernel: dlogits rounded to w's dtype
    before the product with w, fp32 sums, the result in h's dtype."""
    dl = _dlogits(h, w, labels, lse, g_lse, g_ll)
    return (dl.to(w.dtype).float() @ w.float()).to(h.dtype)


def fused_ce_dw_reference(h, w, labels, lse, g_lse, g_ll) -> torch.Tensor:
    """The plain version of the dW kernel: dlogits rounded to h's dtype
    before the product with h, fp32 sums, the result in w's dtype."""
    dl = _dlogits(h, w, labels, lse, g_lse, g_ll)
    return (dl.to(h.dtype).float().T @ h.float()).to(w.dtype)


# ----------------------------------------------------------------- wrappers
def _check(name: str, h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           rows: tuple[torch.Tensor, ...] = ()) -> None:
    """Shapes, dtypes and devices every version takes: ``h [N, e]`` and
    ``w [V, e]`` of one floating dtype, integer ``labels [N]`` and ``[N]``
    row vectors (lse, g_lse, g_ll), all on one device."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: h {tuple(h.shape)} and w {tuple(w.shape)} must be [N, e] "
                         "and [V, e] with one e")
    if labels.shape != h.shape[:1] or any(r.shape != h.shape[:1] for r in rows):
        raise ValueError(f"{name}: labels and the row vectors must be [N] = [{h.shape[0]}]")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"{name}: labels must be integers, got {labels.dtype}")
    if h.dtype != w.dtype:
        raise TypeError(f"{name}: h ({h.dtype}) and w ({w.dtype}) must share one dtype")
    if any(t.device != h.device for t in (w, labels) + rows):
        raise ValueError(f"{name}: every input must be on {h.device}")


def _operands(name: str, h, w, labels, rows=()) -> list[torch.Tensor]:
    """What the kernel takes, contiguous and 16-byte aligned: h and w in
    fp32, bf16 or fp16, zero-padded along e to a multiple of 64 (the kernels' e
    chunk; zero columns add nothing to the logits, so the loss is exact, and
    dH and dW drop them), int32 labels, fp32 row vectors. No copy of h or w
    when e is already a multiple of 64."""
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes {KERNEL_DTYPES} inputs, got {h.dtype}")
    if h.shape[0] == 0 or w.shape[0] == 0 or h.shape[1] == 0:
        raise ValueError(f"{name} kernel needs at least one row, one vocab entry and e >= 1")
    pad = -h.shape[1] % E_MULTIPLE
    if pad:
        h, w = F.pad(h, (0, pad)), F.pad(w, (0, pad))
    out = []
    for t in (h, w, labels.to(torch.int32)) + tuple(r.float() for r in rows):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce")
    if lib.fused_ce_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [i, p, i]  # device, stream, dtype
        lib.fused_ce_fwd.argtypes = head + [p] * 5 + [i] * 4
        lib.fused_ce_dh.argtypes = head + [p] * 7 + [i] * 3
        lib.fused_ce_dw.argtypes = head + [p] * 7 + [i] * 3
        for fn in (lib.fused_ce_fwd, lib.fused_ce_dh, lib.fused_ce_dw):
            fn.restype = ctypes.c_int
        lib.fused_ce_bwd_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.fused_ce_bwd_plan.restype = ctypes.c_int
        lib.fused_ce_fwd_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.fused_ce_fwd_plan.restype = ctypes.c_int
        lib.fused_ce_error_string.argtypes = [i]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
    return lib


def _run(name: str, *pointers: int, h: torch.Tensor, v: int, extra: tuple[int, ...] = ()) -> None:
    lib = _lib()
    dev = h.device
    with torch.cuda.device(dev):
        err = getattr(lib, name)(dev.index, torch.cuda.current_stream(dev).cuda_stream,
                                 _DTYPE_CODES[h.dtype], *pointers, h.shape[0], v, h.shape[1],
                                 *extra)
    if err != 0:
        msg = lib.fused_ce_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {err})")


def fwd_plan(n: int, v: int, resident: dict[int, int]) -> dict:
    """How the bf16 forward kernel splits ``N`` rows against ``V`` vocab
    entries: ``row_tiles`` of 128 rows, ``vocab_tiles`` of 128 entries, and
    ``splits`` of the vocab a row tile (its cluster), each split walking
    ``tiles_per_split`` vocab tiles (split ``y`` tiles ``[y t, (y + 1) t)``,
    those past ``vocab_tiles`` masked). ``resident[s]`` is how many
    clusters of ``s`` CTAs, for each ``s`` of `FWD_SPLITS`, the card runs at
    once (`card_limits`; on an H100 a cluster lies inside one GPC, so
    fewer than ``SMs / s``). The split count takes the fewest steps,
    ``waves x tiles_per_split`` with ``waves`` the rounds of resident
    clusters the row tiles need; then the fewest waves; then the fewest
    splits. So 1 split when the row tiles alone fill the card in whole
    waves. Also the ``grid`` (row tiles, splits) and the ``waves``."""
    if n <= 0 or v <= 0:
        raise ValueError(f"fwd_plan needs positive n and v, got {n} and {v}")
    row_tiles = -(-n // FWD_ROW_TILE)
    vocab_tiles = -(-v // FWD_VOCAB_TILE)
    best = None
    for splits in FWD_SPLITS:
        if resident[splits] <= 0 or (splits > 1 and splits > vocab_tiles):
            continue
        waves = -(-row_tiles // resident[splits])
        tiles = -(-vocab_tiles // splits)
        key = (waves * tiles, waves, splits)
        if best is None or key < best[0]:
            best = (key, {"row_tiles": row_tiles, "vocab_tiles": vocab_tiles, "splits": splits,
                          "tiles_per_split": tiles, "waves": waves, "grid": (row_tiles, splits)})
    return best[1]


@functools.lru_cache(maxsize=None)
def card_limits(index: int) -> dict[int, int]:
    """`fwd_plan`'s ``resident`` on CUDA device ``index``: the clusters of
    each split count the bf16 forward runs there at once, read once a
    process."""
    with torch.cuda.device(index):
        return {s: fwd_launch(s)["max_active_clusters"] for s in FWD_SPLITS}


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor,
                 labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lse, ll)``, fp32 ``[N]``. CPU: `fused_ce_forward_reference`; CUDA:
    ``fused_ce_fwd_kernel`` (fp32/bf16/fp16, any N, V and e; bf16 in clusters
    laid out by `fwd_plan`)."""
    _check("fused_ce_fwd", h, w, labels)
    if not _on_device("fused_ce_fwd", h):
        return fused_ce_forward_reference(h, w, labels)
    h, w, labels = _operands("fused_ce_fwd", h, w, labels)
    lse = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    ll = torch.empty_like(lse)
    plan = fwd_plan(h.shape[0], w.shape[0], card_limits(h.device.index))
    _run("fused_ce_fwd", h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
         ll.data_ptr(), h=h, v=w.shape[0], extra=(plan["splits"],))
    fused_ce_fwd.launches += 1
    return lse, ll


def fused_ce_dh(h, w, labels, lse, g_lse, g_ll) -> torch.Tensor:
    """dH ``[N, e]`` in h's dtype. CPU: `fused_ce_dh_reference`; CUDA: the
    ``fused_ce_bwd_kernel`` in its dH form."""
    _check("fused_ce_dh", h, w, labels, (lse, g_lse, g_ll))
    if not _on_device("fused_ce_dh", h):
        return fused_ce_dh_reference(h, w, labels, lse, g_lse, g_ll)
    e = h.shape[1]
    h, w, labels, lse, g_lse, g_ll = _operands("fused_ce_dh", h, w, labels, (lse, g_lse, g_ll))
    dh = torch.empty_like(h)
    _run("fused_ce_dh", h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
         g_lse.data_ptr(), g_ll.data_ptr(), dh.data_ptr(), h=h, v=w.shape[0])
    fused_ce_dh.launches += 1
    return dh if dh.shape[1] == e else dh[:, :e].contiguous()


def fused_ce_dw(h, w, labels, lse, g_lse, g_ll) -> torch.Tensor:
    """dW ``[V, e]`` in w's dtype. CPU: `fused_ce_dw_reference`; CUDA: the
    ``fused_ce_bwd_kernel`` in its dW form."""
    _check("fused_ce_dw", h, w, labels, (lse, g_lse, g_ll))
    if not _on_device("fused_ce_dw", h):
        return fused_ce_dw_reference(h, w, labels, lse, g_lse, g_ll)
    e = h.shape[1]
    h, w, labels, lse, g_lse, g_ll = _operands("fused_ce_dw", h, w, labels, (lse, g_lse, g_ll))
    dw = torch.empty_like(w)
    _run("fused_ce_dw", h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
         g_lse.data_ptr(), g_ll.data_ptr(), dw.data_ptr(), h=h, v=w.shape[0])
    fused_ce_dw.launches += 1
    return dw if dw.shape[1] == e else dw[:, :e].contiguous()


def bwd_plan(dw: bool, e: int) -> dict[str, int]:
    """How the bf16 dH (``dw`` False) or dW kernel launches at model width
    ``e`` on the current card: the clusters it runs at once
    (``cudaOccupancyMaxActiveClusters``), CTAs a cluster, ring stages, dynamic
    shared memory bytes, slices of e, and output chunks a warpgroup holds."""
    lib = _lib()
    out = (ctypes.c_int * 6)()
    err = lib.fused_ce_bwd_plan(torch.cuda.current_device(), int(dw), e, out)
    if err != 0:
        msg = lib.fused_ce_error_string(err).decode()
        raise RuntimeError(f"fused_ce_bwd_plan failed: {msg} (cuda error {err})")
    keys = ("max_active_clusters", "cluster_ctas", "ring_stages", "smem_bytes", "slices",
            "chunks_per_warpgroup")
    return dict(zip(keys, (int(x) for x in out)))


def fwd_launch(splits: int) -> dict[str, int]:
    """How the bf16 forward kernel launches with the vocab split ``splits``
    ways on the current card: the clusters of ``splits`` CTAs it runs at
    once (``cudaOccupancyMaxActiveClusters``), ring stages, dynamic shared
    memory bytes, and the rows of a vocab tile."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    err = lib.fused_ce_fwd_plan(torch.cuda.current_device(), splits, out)
    if err != 0:
        msg = lib.fused_ce_error_string(err).decode()
        raise RuntimeError(f"fused_ce_fwd_plan failed: {msg} (cuda error {err})")
    keys = ("max_active_clusters", "ring_stages", "smem_bytes", "vocab_tile")
    return dict(zip(keys, (int(x) for x in out)))


fused_ce_fwd.launches = 0
fused_ce_dh.launches = 0
fused_ce_dw.launches = 0


class _FusedHeadCE(torch.autograd.Function):
    """The reference's ``_fused_head_lse`` custom VJP with the mean over
    valid rows folded in: forward saves ``(h, w, safe labels, lse)`` and
    returns ``sum((lse - ll) * mask) / max(count, 1)``; backward forms
    ``g_lse = mask / count`` and ``g_ll = -mask / count`` (times the
    incoming gradient) and runs the dH and dW kernels."""

    @staticmethod
    def forward(ctx, h, w, safe, mask):
        lse, ll = fused_ce_fwd(h, w, safe)
        ctx.save_for_backward(h, w, safe, lse, mask)
        maskf = mask.float()
        return ((lse - ll) * maskf).sum() / maskf.sum().clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        h, w, safe, lse, mask = ctx.saved_tensors
        maskf = mask.float()
        g_lse = g.float() * maskf / maskf.sum().clamp(min=1.0)
        g_ll = -g_lse
        dh = fused_ce_dh(h, w, safe, lse, g_lse, g_ll) if ctx.needs_input_grad[0] else None
        dw = fused_ce_dw(h, w, safe, lse, g_lse, g_ll) if ctx.needs_input_grad[1] else None
        return dh, dw, None, None


def fused_cross_entropy(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = -100, block_r: int = 512,
                        block_v: int = 1024) -> torch.Tensor:
    """Mean cross-entropy over the rows of ``hidden [N, e]`` whose label is
    not ``ignore_index``, with the tied head ``wte [V, e]`` fused in: the
    ``[N, V]`` logits never reach memory. 0 (not NaN) when every row is
    ignored. Differentiable in ``hidden`` and ``wte``. Takes fp32, bf16 or
    fp16 (one dtype for both); other dtypes raise. ``block_r`` and ``block_v``
    are the reference's TPU tiles (its defaults): accepted, so a call
    written for the reference runs, and ignored, since the CUDA kernels
    choose their own tiles (`fwd_plan`)."""
    if hidden.dtype not in KERNEL_DTYPES or wte.dtype != hidden.dtype:
        raise TypeError(
            f"fused_cross_entropy takes fp32, bf16 or fp16 hidden and wte of one dtype, got "
            f"{hidden.dtype} and {wte.dtype}"
        )
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int32)
    return _FusedHeadCE.apply(hidden, wte, safe, mask)
