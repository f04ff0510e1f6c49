#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`accelerate_tpu_torch`) on one NVIDIA H100.

Phases run in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and its compute
   capability, which must be 9.0;
2. build: nvcc compiles the kernel libraries from accelerate_tpu_torch/ops/csrc/
   (one nvcc per source, all started together);
3. kernel: `paged_decode_attention` (the CUDA kernel) against
   `paged_decode_attention_reference` on the card at GPT-2-small shapes
   (ragged lengths up to 1024, block boundaries, a zero-length row and a
   sentinel-parked row), a GQA case and an int8 pool with scale planes; one
   JSON line per case with its error and its times;
4. fp32 slice: GPT-2 small at full width, seeded fp32 weights, TF32 off:
   the same greedy requests through the fused and the gather engine give equal
   token streams, and the kernel ran n_layer times per decode step;
5. bf16 slice: the same model in bf16 serves 48 seeded requests (greedy and
   sampled) through the fused engine; the first decode step's logits agree
   with the gather path; one JSON line of serving metrics;
   Then a torch.profiler window over 16 decode steps of the same engine:
   host and device ms per step, the device's idle share, and the kernels
   that take the device time;
6. flash kernels: the forward, dQ and dK/dV kernels
   (`flash_attention_fwd`/`_dq`/`_dkv`) against their plain versions on the
   card at GPT-2-small training shapes (b 8, h 12, s 1024, d 64, bf16,
   causal), in fp32, non-causal, at d 128 and at a ragged s 1000; one JSON
   line per case and kernel with its error, its times and its bound;
7. fp32 train-step parity: GPT-2 small at full width and depth, seeded fp32
   weights, TF32 off, batch 2 x 1024: one `make_train_step` step with
   ``attention_impl="flash"`` against one with ``"xla"`` (the plain path):
   loss and global gradient norm agree, and each flash kernel ran n_layer
   times;
8. bf16 training: GPT-2 small, batch 8 x 1024, ``mixed_precision="bf16"``,
   AdamW(lr 1e-4, weight decay 1e-4), bench.py's seeded batch repeated: 2
   warm-up steps and 10 timed steps; the loss falls and each flash kernel
   ran n_layer times per step; step ms, tokens/s, MFU by bench.py's FLOP
   count, peak memory. Then a torch.profiler window over 3 steps: host and
   device ms per step, the device's idle share, the top kernels and the
   device time by kind of kernel (fp32 head GEMMs, flash, bf16 GEMMs, ...);
9. fused-CE kernels: the forward, dH and dW kernels (`fused_ce_fwd`/`_dh`/
   `_dw`) against their plain versions on the card at the fused loss's
   shapes (N 8192 = 8 x 1024 rows, V 50257, e 768, bf16, 1/16 of the rows
   ignored), in fp32, at a ragged N 1000, at e 1024 (GPT-2 medium's width)
   and with every row ignored; one JSON line per case and kernel with its
   error, its times (the library yardstick is the unfused PyTorch head and
   cross-entropy) and its bound;
10. fp32 fused-CE parity: GPT-2 small, fp32, TF32 off, batch 2 x 1024: one
   `make_train_step` step with `lm_loss_fn_pallas` against one with
   `lm_loss_fn`: loss and global gradient norm agree, and each fused-CE
   kernel ran once;
11. bf16 training with the fused loss: phase 8 with `lm_loss_fn_pallas`
   (bench.py's ``BENCH_FUSED_CE=2``): the loss falls, each flash kernel ran
   n_layer times and each fused-CE kernel once per step, and the peak
   memory stays below phase 8's; then its profiler window;
12. the kernels line, the card line, and the final ``{"ok": true, ...}`` line.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUCKETS = (64, 128, 256, 512, 768)
# stated tolerances of the kernel against its plain version, by query dtype:
# fp32 differs only in summation order; bf16/fp16 outputs are rounded once by
# the kernel but twice (softmax weights, then the product) by the plain path
KERNEL_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
# first decode step of GPT-2 small in bf16, fused vs gather logits: both run
# the same bf16 model and differ only in the attention rounding above
BF16_LOGIT_ATOL = 0.1
# flash kernels against their plain versions, |err| <= atol + rtol * |ref|:
# fp32 differs in summation order over up to 1024 terms; bf16 rounds p and dS
# to bf16 before products (a value near a rounding boundary may round the
# other way) and rounds each output once more
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# fp32 GPT-2 small, one train step, flash vs plain attention: the same fp32
# arithmetic in another summation order, through 12 layers and the head
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
# fused-CE kernels against their plain versions: both take the same fp32
# logits from the same operands in another summation order. lse and ll (fp32
# rows): |err| <= 1e-4 + 1e-5 |plain|. dH and dW: |err| <= rtol |plain| +
# atol max|plain|; fp32 differs in order only; bf16 rounds dlogits to bf16
# before the products (a value near a rounding boundary may round the other
# way) and each output once more (2^-8 relative)
FUSED_CE_ROW_TOL = (1e-4, 1e-5)
FUSED_CE_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
# device kernels of the bf16 train step by kind, first match wins, case
# ignored. The only fp32 products of that step are the tied head's (logits,
# d hidden, d wte); casts run as copy kernels, so they match before the
# other elementwise kernels (GELU, residual adds, masks, AdamW's scalars).
TRAIN_KERNEL_CATEGORIES = (
    ("fused-CE kernels", r"fused_ce_(fwd|bwd)_kernel"),
    ("fp32 head GEMMs", r"f32f32|sgemm"),
    ("flash kernels", r"flash_(fwd|dq|dkv)_kernel"),
    ("bf16 GEMMs", r"nvjet|bf16bf16|gemm.*bf16|bf16.*gemm"),
    ("AdamW", r"multi_tensor_apply"),
    ("LayerNorm", r"layer_norm"),
    ("softmax and cross-entropy", r"softmax|nll_loss|gather"),
    ("copies and casts", r"copy"),
    ("other elementwise and reductions", r"elementwise|reduce"),
)
FLASH_REPLACES = {
    "flash_attention_fwd": "accelerate_tpu/ops/flash_attention.py:50",
    "flash_attention_dq": "accelerate_tpu/ops/flash_attention.py:130",
    "flash_attention_dkv": "accelerate_tpu/ops/flash_attention.py:165",
}
FUSED_CE_REPLACES = {
    "fused_ce_fwd": "accelerate_tpu/ops/fused_ce.py:47",
    "fused_ce_dh": "accelerate_tpu/ops/fused_ce.py:79",
    "fused_ce_dw": "accelerate_tpu/ops/fused_ce.py:103",
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 non-tensor-core flop/s, label) from the SKU in the
    device name, NVIDIA data sheet figures at full power."""
    if "H200" in name:
        return 4.8e12, 67e12, "H200 SXM: 4.8 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16 dense"
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe: 2.0 TB/s, 51 TFLOP/s fp32, 756 TFLOP/s bf16 dense"
    if "NVL" in name:
        return 3.9e12, 60e12, "H100 NVL: 3.9 TB/s, 60 TFLOP/s fp32, 835 TFLOP/s bf16 dense"
    return 3.35e12, 67e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16 dense"


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core flop/s of the SKU in the device name (NVIDIA
    data sheets, full power)."""
    if "PCIe" in name:
        return 756e12
    if "NVL" in name:
        return 835e12
    return 989e12


def device_ms(torch, fn, flush, samples: int = 30) -> float:
    """Median device time of ``fn`` in ms over ``samples`` runs, CUDA events
    around each. L2 is flushed before each run (as a decode step finds the
    pool cold) and the stream is held busy meanwhile, so the events time the
    device work and not the host's launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_case(torch, name, *, b, hq, kvh, d, bt, lengths, dtype, quant, seed, flush,
                parked=()):
    """One kernel-vs-plain comparison and its timings; returns the case record."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.flash_attention import (
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    span = 1024
    bps = span // bt
    num_blocks = b * bps + 8
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
    shape = (num_blocks, bt, kvh, d)
    scales = {}
    if quant:
        k_pool = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        v_pool = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        scales = dict(
            k_scale_pool=torch.rand(shape[:3], generator=g, device=dev) * 0.02 + 1e-3,
            v_scale_pool=torch.rand(shape[:3], generator=g, device=dev) * 0.02 + 1e-3)
    else:
        k_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
        v_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
    tables = torch.randperm(num_blocks, generator=g, device=dev)[: b * bps].reshape(b, bps)
    tables = tables.to(torch.int32)
    for i, n in enumerate(lengths):  # unreserved entries hold the sentinel, as in the engine
        tables[i, -(-max(n, 0) // bt):] = num_blocks
    for i in parked:
        tables[i] = num_blocks
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, tables, lens)

    out = paged_decode_attention(*args, **scales)
    ref = paged_decode_attention_reference(*args, **scales)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = KERNEL_ATOL[str(dtype).removeprefix("torch.")]
    if not (math.isfinite(err) and err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"kernel case {name}: max_abs_err {err} > atol {tol}")

    # yardstick: one library call of the same function over the gathered view
    n_live = [min(max(n, 0), span) for n in lengths]
    kg = ref_view(torch, k_pool, tables, scales.get("k_scale_pool"), dtype, num_blocks)
    vg = ref_view(torch, v_pool, tables, scales.get("v_scale_pool"), dtype, num_blocks)
    if hq != kvh:
        kg, vg = kg.repeat_interleave(hq // kvh, dim=1), vg.repeat_interleave(hq // kvh, dim=1)
    mask = (torch.arange(span, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    kernel_ms = device_ms(torch, lambda: paged_decode_attention(*args, **scales), flush)
    plain_ms = device_ms(torch, lambda: paged_decode_attention_reference(*args, **scales), flush)
    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask),
                           flush)

    # least time for the same work: every live K/V byte (and scale) read once,
    # q, tables, lengths read once, the output written once; flops of QK^T and PV
    bw, flops_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    elt = k_pool.element_size()
    kv_bytes = sum(n_live) * kvh * d * elt * 2
    scale_bytes = sum(n_live) * kvh * 4 * 2 if quant else 0
    table_bytes = sum(-(-n // bt) for n in n_live) * 4 + lens.numel() * 4
    io_bytes = q.numel() * q.element_size() * 2
    n_bytes = kv_bytes + scale_bytes + table_bytes + io_bytes
    n_flops = 4 * sum(n_live) * hq * d
    bound_ms = max(n_bytes / bw, n_flops / flops_peak) * 1e3
    rec = dict(case=name, b=b, hq=hq, kvh=kvh, d=d, bt=bt, pool=str(k_pool.dtype).removeprefix("torch."),
               q=str(dtype).removeprefix("torch."), max_abs_err=err, atol=tol, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by="bytes" if n_bytes / bw >= n_flops / flops_peak else "operations",
               bytes=n_bytes, flops=n_flops)
    print(json.dumps(rec), flush=True)
    return rec


def ref_view(torch, pool, tables, scale, dtype, num_blocks):
    """The gathered ``[b, kv_heads, span, d]`` view (dequantized for int8)."""
    b, bps = tables.shape
    t = tables.long().clamp(max=num_blocks - 1)
    view = pool[t].reshape(b, bps * pool.shape[1], *pool.shape[2:])
    if scale is not None:
        sv = scale[t].reshape(b, bps * pool.shape[1], pool.shape[2])
        view = (view.float() * sv[..., None]).to(dtype)
    return view.transpose(1, 2).contiguous()


def first_step_logits(torch, model, prompts, attention):
    """Prefill ``prompts`` one by one into a fresh paged cache, then run one
    batched decode step with ``attention`` ("fused" or "gather"); returns the
    step's logits ``[b, vocab]``."""
    from accelerate_tpu_torch.models.kv_cache import make_block_pool, scatter_rows_to_blocks

    cfg, dev, bt = model.config, model.device, 16
    b, bps = len(prompts), cfg.n_positions // bt
    cache = make_block_pool(cfg.n_layer, b, b * bps, bt, cfg.n_head, cfg.head_dim, cfg.dtype,
                            dev, attention=attention)
    tables = torch.arange(b * bps, dtype=torch.int32, device=dev).reshape(b, bps)
    first = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            kv: list = []
            logits = model(torch.tensor([p], device=dev), kv_out=kv)
            scatter_rows_to_blocks(cache, kv, torch.tensor([i], device=dev),
                                   tables[i:i + 1, : -(-len(p) // bt)],
                                   torch.tensor([len(p)], dtype=torch.int32, device=dev))
            first.append(logits[0, -1].argmax())
        pos = torch.tensor([len(p) for p in prompts], device=dev)
        return model(torch.stack(first)[:, None], pos, cache=cache, block_tables=tables)[:, -1]


def profile_steps(torch, run_step, steps: int) -> tuple[float, dict[str, float]]:
    """``steps`` calls of ``run_step`` under torch.profiler: the host wall in
    us (ending in a synchronize) and the device us of each kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        # device kernels and copies; not the user annotations the profiler
        # mirrors onto the device timeline (they overlap the kernels)
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return wall_us, by_name


def profile_record(phase: str, steps: int, wall_us: float, by_name: dict[str, float],
                   top: int = 6, **extra) -> dict:
    """Host and device ms per step, the device's idle share (1 - busy/wall,
    the kernels run on one stream) and the ``top`` kernels by device time."""
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"phase": phase, "steps": steps, **extra,
            "host_ms_per_step": wall_us / steps / 1e3, "device_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "top_kernels_ms_per_step": {n[:80]: us / steps / 1e3 for n, us in ranked}}


def profile_decode(torch, engine, requests, steps: int = 16) -> dict:
    """Admit ``requests`` (first step, unprofiled), then profile ``steps``
    decode steps: host wall per step, device busy per step (the sum of kernel
    times on the one stream) and the six kernels with the most device time."""
    for r in requests:
        engine.submit(r)
    engine.step()
    wall_us, by_name = profile_steps(torch, engine.step, steps)
    return profile_record("bf16_decode_profile", steps, wall_us, by_name, slots=engine.active_slots)


def flash_counts(fa) -> dict[str, int]:
    return {n: getattr(fa, n).launches for n in FLASH_REPLACES}


def fused_ce_counts() -> dict[str, int]:
    from accelerate_tpu_torch.ops import fused_ce

    return {n: getattr(fused_ce, n).launches for n in FUSED_CE_REPLACES}


def reset_counts(fa) -> None:
    """Every kernel wrapper's launch count to 0."""
    from accelerate_tpu_torch.ops import fused_ce

    fa.paged_decode_attention.launches = 0
    for n in FLASH_REPLACES:
        getattr(fa, n).launches = 0
    for n in FUSED_CE_REPLACES:
        getattr(fused_ce, n).launches = 0


def flash_case(torch, name, *, b, h, s, d, dtype, causal, seed, flush) -> dict:
    """The three flash kernels against their plain versions on one input
    (q pre-scaled, ``[b, h, s, d]``), with their times, SDPA's times and the
    bounds; prints one JSON line per kernel and returns them by kernel."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, s, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
    k, v, dout = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype) for _ in range(3))
    o_ref, lse_ref = fa.flash_attention_forward_reference(q, k, v, causal)
    delta = (dout.float() * o_ref.float()).sum(-1)
    bwd = (q, k, v, dout, lse_ref, delta, causal)
    plain = {"flash_attention_fwd": lambda: fa.flash_attention_forward_reference(q, k, v, causal),
             "flash_attention_dq": lambda: fa.flash_attention_dq_reference(*bwd),
             "flash_attention_dkv": lambda: fa.flash_attention_dkv_reference(*bwd)}
    kernel = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v, causal),
              "flash_attention_dq": lambda: fa.flash_attention_dq(*bwd),
              "flash_attention_dkv": lambda: fa.flash_attention_dkv(*bwd)}

    def outputs(fn) -> tuple:
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    got = {kname: outputs(fn) for kname, fn in kernel.items()}
    want = {kname: outputs(fn) for kname, fn in plain.items()}
    torch.cuda.synchronize()

    # yardstick: SDPA forward, and SDPA's backward (dq, dk and dv together)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, scale=1.0)
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                       scale=1.0), flush)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,
                                                           retain_graph=True), flush)
    library = {"flash_attention_fwd": lib_fwd, "flash_attention_dq": lib_bwd,
               "flash_attention_dkv": lib_bwd}

    # least time: each input read once, each output written once; the
    # products over the (query, key) pairs this mask keeps, 2 d flops each
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elt = q.element_size()
    tensor_bytes = b * h * s * d * elt
    row_bytes = b * h * s * 4  # one fp32 [b, h, s] vector (lse or delta)
    io = {"flash_attention_fwd": (4 * tensor_bytes + row_bytes, 2),
          "flash_attention_dq": (5 * tensor_bytes + 2 * row_bytes, 3),
          "flash_attention_dkv": (6 * tensor_bytes + 2 * row_bytes, 4)}
    dev_name = torch.cuda.get_device_name(0)
    bw, fp32_peak, _ = peak_rates(dev_name)
    peak = bf16_peak(dev_name) if dtype == torch.bfloat16 else fp32_peak
    atol, rtol = FLASH_TOL[str(dtype).removeprefix("torch.")]
    recs = {}
    for kname in FLASH_REPLACES:
        err, bad = 0.0, 0.0
        for a, w in zip(got[kname], want[kname]):
            diff = (a.float() - w.float()).abs()
            err = max(err, diff.max().item())
            bad = max(bad, (diff - atol - rtol * w.float().abs()).max().item())
        if not (math.isfinite(err) and bad <= 0):
            raise AssertionError(f"flash case {name}, {kname}: max_abs_err {err} exceeds "
                                 f"atol {atol} + rtol {rtol} * |plain|")
        n_bytes, products = io[kname]
        n_flops = products * 2 * d * pairs
        rec = dict(case=name, kernel=kname, b=b, h=h, s=s, d=d, dtype=str(dtype).removeprefix("torch."),
                   causal=causal, max_abs_err=err, atol=atol, rtol=rtol,
                   kernel_ms=device_ms(torch, kernel[kname], flush),
                   plain_ms=device_ms(torch, plain[kname], flush, samples=10),
                   library_ms=library[kname],
                   bound_ms=max(n_bytes / bw, n_flops / peak) * 1e3,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops)
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    return recs


def fused_ce_case(torch, name, *, n, v, e, dtype, ignore_every, seed, flush) -> dict:
    """The three fused-CE kernels against their plain versions on one input
    (h ``[n, e]``, w ``[v, e]`` at GPT-2's init scale, every
    ``ignore_every``-th row ignored, 1 for all of them), with the gradients
    of the mean loss (g_lse = mask / count, g_ll = -g_lse); their times, the
    unfused PyTorch head + cross-entropy's times, and the bounds. Prints one
    JSON line per kernel and returns them by kernel."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import fused_ce as fc

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, e, generator=g, device=dev).to(dtype)
    w = (torch.randn(v, e, generator=g, device=dev) * 0.02).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    labels[torch.arange(n, device=dev) % ignore_every == ignore_every - 1] = -100
    mask = labels != -100
    safe = torch.where(mask, labels, 0).to(torch.int32)
    g_lse = mask.float() / mask.sum().clamp(min=1)
    g_ll = -g_lse
    lse, _ = fc.fused_ce_forward_reference(h, w, safe)
    bwd = (h, w, safe, lse, g_lse, g_ll)
    plain = {"fused_ce_fwd": lambda: fc.fused_ce_forward_reference(h, w, safe),
             "fused_ce_dh": lambda: fc.fused_ce_dh_reference(*bwd),
             "fused_ce_dw": lambda: fc.fused_ce_dw_reference(*bwd)}
    kernel = {"fused_ce_fwd": lambda: fc.fused_ce_fwd(h, w, safe),
              "fused_ce_dh": lambda: fc.fused_ce_dh(*bwd),
              "fused_ce_dw": lambda: fc.fused_ce_dw(*bwd)}

    # yardstick: the unfused head and cross-entropy, forward, and its
    # backward (dH and dW together)
    hl, wl = (t.detach().clone().requires_grad_() for t in (h, w))
    lib_loss = F.cross_entropy(F.linear(hl, wl).float(), labels)
    lib_fwd = device_ms(torch, lambda: F.cross_entropy(F.linear(h, w).float(), labels), flush,
                        samples=10)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(lib_loss, (hl, wl), retain_graph=True),
                        flush, samples=10)
    del lib_loss, hl, wl
    library = {"fused_ce_fwd": lib_fwd, "fused_ce_dh": lib_bwd, "fused_ce_dw": lib_bwd}

    # least time: each input read once and each output written once; the
    # forward is one [n, e] x [e, v] product, dH and dW two each (the logits
    # are recomputed from lse)
    elt = h.element_size()
    inputs = (n + v) * e * elt + n * 4
    io = {"fused_ce_fwd": (inputs + 2 * n * 4, 1),
          "fused_ce_dh": (inputs + 3 * n * 4 + n * e * elt, 2),
          "fused_ce_dw": (inputs + 3 * n * 4 + v * e * elt, 2)}
    dev_name = torch.cuda.get_device_name(0)
    bw, fp32_peak, _ = peak_rates(dev_name)
    peak = bf16_peak(dev_name) if dtype == torch.bfloat16 else fp32_peak
    dtype_name = str(dtype).removeprefix("torch.")
    rtol, atol = FUSED_CE_TOL[dtype_name]
    samples = 30 if dtype == torch.bfloat16 else 5
    recs = {}
    for kname in FUSED_CE_REPLACES:
        got, want = kernel[kname](), plain[kname]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, bad = 0.0, 0.0
        for a, b in zip(got, want):
            diff = (a.float() - b.float()).abs()
            ref = b.float().abs()
            bar = (FUSED_CE_ROW_TOL[0] + FUSED_CE_ROW_TOL[1] * ref if kname == "fused_ce_fwd"
                   else rtol * ref + atol * ref.max())
            err = max(err, diff.max().item())
            bad = max(bad, (diff - bar).max().item())
        del got, want
        if not (math.isfinite(err) and bad <= 0):
            raise AssertionError(f"fused-CE case {name}, {kname}: max_abs_err {err} exceeds its bar")
        if ignore_every == 1 and kname != "fused_ce_fwd" and err != 0.0:
            raise AssertionError(f"fused-CE case {name}, {kname}: nonzero gradient, all rows ignored")
        n_bytes, products = io[kname]
        n_flops = products * 2 * n * v * e
        rec = dict(phase="fused_ce_kernels", case=name, kernel=kname, n=n, v=v, e=e, dtype=dtype_name,
                   ignored_rows=int((~mask).sum().item()), max_abs_err=err,
                   tol=FUSED_CE_ROW_TOL if kname == "fused_ce_fwd" else (rtol, atol),
                   kernel_ms=device_ms(torch, kernel[kname], flush, samples=samples),
                   plain_ms=device_ms(torch, plain[kname], flush, samples=5),
                   library_ms=library[kname],
                   bound_ms=max(n_bytes / bw, n_flops / peak) * 1e3,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops)
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    torch.cuda.empty_cache()
    return recs


def train_flops_per_token(model, seq: int) -> int:
    """bench.py's count: 6 N for the forward and backward of N parameters,
    plus 12 s e per layer per token for attention."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    return 6 * n_params + cfg.n_layer * 12 * seq * cfg.n_embd


def train_parity(torch, np, seed: int) -> dict:
    """One fp32 train step of GPT-2 small (TF32 off) with flash attention and
    one with the plain path, from the same weights and batch: loss and global
    gradient norm (before the optimizer) agree; each flash kernel ran n_layer
    times in the flash step."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 50257, (2, 1024))).to("cuda")
    out = {}
    for impl in ("xla", "flash"):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl=impl),
                           device="cuda", seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        # a clip threshold no norm reaches: the step records the norm, scales by 1
        step = acc.make_train_step(lm_loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[impl] = (loss, step.grad_norm.item(), flash_counts(fa))
        del model, acc, step
        torch.cuda.empty_cache()
    n_layer = GPT2Config.small().n_layer
    (loss_x, norm_x, _), (loss_f, norm_f, counts) = out["xla"], out["flash"]
    rec = {"phase": "fp32_train_parity", "batch": 2, "seq": 1024, "loss_plain": loss_x,
           "loss_flash": loss_f, "loss_abs_diff": abs(loss_f - loss_x), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_norm_plain": norm_x, "grad_norm_flash": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
           "launches": counts}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_x) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 train step: flash loss {loss_f} vs plain {loss_x}")
    if not abs(norm_f - norm_x) <= TRAIN_GRAD_NORM_RTOL * norm_x:
        raise AssertionError(f"fp32 train step: flash grad norm {norm_f} vs plain {norm_x}")
    if any(n != n_layer for n in counts.values()):
        raise AssertionError(f"fp32 flash step launches {counts}, expected {n_layer} each")
    return rec


def fused_ce_parity(torch, np, seed: int) -> dict:
    """One fp32 train step of GPT-2 small (TF32 off, flash attention) with
    `lm_loss_fn_pallas` and one with `lm_loss_fn`, from the same weights and
    batch: loss and global gradient norm (before the optimizer) agree; each
    fused-CE kernel ran once in the fused step and never in the other."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
        lm_loss_fn,
        lm_loss_fn_pallas,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 50257, (2, 1024))).to("cuda")
    out = {}
    for loss_fn in (lm_loss_fn, lm_loss_fn_pallas):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl="flash"),
                           device="cuda", seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[loss_fn.__name__] = (loss, step.grad_norm.item(), fused_ce_counts())
        del model, acc, step
        torch.cuda.empty_cache()
    (loss_p, norm_p, plain_counts), (loss_f, norm_f, counts) = (out["lm_loss_fn"],
                                                                out["lm_loss_fn_pallas"])
    rec = {"phase": "fp32_fused_ce_parity", "batch": 2, "seq": 1024, "loss_plain": loss_p,
           "loss_fused": loss_f, "loss_abs_diff": abs(loss_f - loss_p), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_norm_plain": norm_p, "grad_norm_fused": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_p) / norm_p, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
           "launches": counts, "launches_plain_loss": plain_counts}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_p) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 train step: fused-CE loss {loss_f} vs plain {loss_p}")
    if not abs(norm_f - norm_p) <= TRAIN_GRAD_NORM_RTOL * norm_p:
        raise AssertionError(f"fp32 train step: fused-CE grad norm {norm_f} vs plain {norm_p}")
    if any(n != 1 for n in counts.values()) or any(plain_counts.values()):
        raise AssertionError(f"fp32 fused-CE launches {counts} (plain loss {plain_counts}), "
                             "expected 1 each (0 each)")
    return rec


def train_bf16(torch, np, seed: int, card: str, fused_ce: bool = False, warmup: int = 2,
               steps: int = 10) -> tuple[dict, dict]:
    """bench.py's training path on GPT-2 small: bf16 mixed precision, AdamW
    (lr 1e-4, weight decay 1e-4, optax's default), batch 8 x 1024 of seeded
    ids repeated; ``warmup`` then ``steps`` timed steps with the launch counts
    set to 0 just before them. Then a profiler window over 3 steps. The loss
    is `lm_loss_fn`, or with ``fused_ce`` `lm_loss_fn_pallas`
    (``BENCH_FUSED_CE=2``)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn, lm_loss_fn_pallas
    from accelerate_tpu_torch.ops import flash_attention as fa

    batch, seq = 8, 1024
    cfg = GPT2Config.small(dtype=torch.bfloat16, attention_impl="flash")
    model = GPT2LMHead(cfg, device="cuda", seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn_pallas if fused_ce else lm_loss_fn)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    data = {"input_ids": torch.from_numpy(ids).to("cuda")}

    losses = [step(data).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    timed = [step(data) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**flash_counts(fa), **fused_ce_counts()}
    losses += [t.item() for t in timed]
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_per_token = train_flops_per_token(model, seq)
    mfu = tokens_per_s * flops_per_token / bf16_peak(torch.cuda.get_device_name(0))
    phase = "bf16_train_fused_ce" if fused_ce else "bf16_train"
    rec = {"phase": phase, "model": "gpt2-small", "batch": batch, "seq": seq,
           "warmup_steps": warmup, "steps": steps, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
           "mfu": mfu, "flops_per_token": flops_per_token,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "launches": counts, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 training: the loss did not fall: {losses}")
    expected = {**{n: cfg.n_layer * steps for n in FLASH_REPLACES},
                **{n: steps if fused_ce else 0 for n in FUSED_CE_REPLACES}}
    if counts != expected:
        raise AssertionError(f"{phase} launches {counts}, expected {expected}")

    n_prof = 3
    wall_us, by_name = profile_steps(torch, lambda: step(data), n_prof)

    categories: dict[str, float] = {}
    for kname, us in by_name.items():
        cat = next((c for c, pattern in TRAIN_KERNEL_CATEGORIES
                    if re.search(pattern, kname, re.IGNORECASE)), "other")
        categories[cat] = categories.get(cat, 0.0) + us / n_prof / 1e3
    prof = profile_record(f"{phase}_profile", n_prof, wall_us, by_name, top=8,
                          categories_ms_per_step=categories)
    print(json.dumps(prof), flush=True)
    del model, acc, step
    torch.cuda.empty_cache()
    return rec, prof


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (ROOT / "accelerate_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (accelerate_tpu_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; capability {cap}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    print(f"peak rates used for bounds: {peak_rates(name)[2]}", flush=True)

    # 2. build
    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libraries = ("paged_decode", "flash_attention", "fused_ce")
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, libraries))
    for lib_name in libraries:
        _build.load(lib_name)
    build_s = time.perf_counter() - t0
    for lib_name in libraries:
        log = _build.build_log(lib_name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = len(re.findall(r"[1-9]\d* bytes spill stores", log))
        print(json.dumps({"phase": "build", "library": lib_name, "build_s": build_s,
                          "kernels": len(regs), "max_registers": max(regs, default=0),
                          "kernels_spilling": spills}), flush=True)

    # 3. kernel against its plain version
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention

    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 64 MiB > L2
    ragged = [1, 15, 16, 17, 100, 255, 256, 257, 511, 512, 640, 767, 900, 1023, 1024, 40]
    gpt2 = dict(b=16, hq=12, kvh=12, d=64, bt=16, flush=flush)
    cases = [
        kernel_case(torch, "gpt2_small_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed, parked=(15,), **gpt2),
        kernel_case(torch, "gpt2_small_fp32", lengths=ragged[:-1] + [0], dtype=torch.float32,
                    quant=False, seed=args.seed + 1, **gpt2),
        kernel_case(torch, "gqa_32q_8kv_d128_bf16", lengths=ragged, dtype=torch.bfloat16,
                    quant=False, seed=args.seed + 2, parked=(15,),
                    **{**gpt2, "hq": 32, "kvh": 8, "d": 128}),
        kernel_case(torch, "gpt2_small_int8_pool", lengths=ragged, dtype=torch.bfloat16,
                    quant=True, seed=args.seed + 3, parked=(15,), **gpt2),
    ]
    del flush
    torch.cuda.empty_cache()

    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        PagedKVConfig,
        Request,
        SamplingParams,
        ServingEngine,
    )

    rng = np.random.default_rng(args.seed)

    def prompts(n):
        return [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, n)]

    # 4. fp32 slice: fused == gather, token for token
    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=args.seed)
    n_layer = model.config.n_layer
    fp32_prompts = prompts(8)

    def fp32_requests():
        return [Request(prompt=p, params=SamplingParams(max_new_tokens=32)) for p in fp32_prompts]

    gather = ServingEngine(model, paged_attention="gather", max_concurrency=8,
                           prompt_buckets=BUCKETS)
    gather_out = [o.tokens for o in gather.run(fp32_requests())]
    paged_decode_attention.launches = 0
    fused = ServingEngine(model, paged_attention="fused", max_concurrency=8,
                          prompt_buckets=BUCKETS)
    fused_out = [o.tokens for o in fused.run(fp32_requests())]
    launches = paged_decode_attention.launches
    steps = fused.metrics.decode_steps.value
    solo = generate(model, torch.tensor([fp32_prompts[0]]), 32)[0].tolist()
    print(json.dumps({"phase": "fp32_slice", "requests": len(fused_out),
                      "tokens_equal": fused_out == gather_out, "solo_equal": solo == fused_out[0],
                      "decode_steps": steps, "launches": launches,
                      "launches_expected": n_layer * steps}), flush=True)
    if fused_out != gather_out or solo != fused_out[0]:
        raise AssertionError("fp32 token streams differ between fused, gather and solo generate")
    if any(len(t) != 32 for t in fused_out):
        raise AssertionError("an fp32 request did not emit its 32 tokens")
    if launches != n_layer * steps or steps == 0:
        raise AssertionError(f"kernel launches {launches} != n_layer x decode steps {n_layer * steps}")
    del model, gather, fused
    torch.cuda.empty_cache()

    # 5. bf16 slice: serving through the fused engine
    model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                       device="cuda", seed=args.seed)
    check = prompts(16)
    fused_logits = first_step_logits(torch, model, check, "fused")
    gather_logits = first_step_logits(torch, model, check, "gather")
    logit_err = (fused_logits - gather_logits).abs().max().item()
    if not (math.isfinite(logit_err) and logit_err <= BF16_LOGIT_ATOL):
        raise AssertionError(f"bf16 first-step logits: fused vs gather {logit_err} > {BF16_LOGIT_ATOL}")

    serve_prompts = prompts(48)

    def bf16_requests():
        return [Request(prompt=p, params=SamplingParams(
                    max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                    top_k=50 if i % 2 else None, seed=i))
                for i, p in enumerate(serve_prompts)]

    def engine():
        return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                             paged_attention="fused", max_concurrency=16, prompt_buckets=BUCKETS)

    engine().run(bf16_requests()[:4])  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    reset_counts(fa)
    t0 = time.perf_counter()
    outs = eng.run(bf16_requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    serving_flash = flash_counts(fa)
    m = eng.metrics
    steps = m.decode_steps.value
    bad = [o.request_id for o in outs if o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64]
    serving = {
        "phase": "bf16_serving", "requests": len(outs), "max_new_tokens": 64,
        "generated_tokens": m.tokens_generated.value, "wall_s": wall,
        "tokens_per_s": m.tokens_generated.value / wall,
        "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
        "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
        "decode_steps": steps, "kernel_launches": launches, "flash_launches": serving_flash,
        "first_step_logit_max_abs_diff": logit_err, "logit_atol": BF16_LOGIT_ATOL,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }
    print(json.dumps(serving), flush=True)
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 64 tokens")
    if launches != n_layer * steps or steps == 0:
        raise AssertionError(f"kernel launches {launches} != n_layer x decode steps {n_layer * steps}")
    long_requests = [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
                     for p in serve_prompts[:16]]
    print(json.dumps(profile_decode(torch, engine(), long_requests)), flush=True)
    del model, eng
    torch.cuda.empty_cache()

    # 6. flash kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    small = dict(b=8, h=12, s=1024, d=64, flush=flush)
    flash_cases = [
        flash_case(torch, "gpt2_small_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed, **small),
        flash_case(torch, "gpt2_small_fp32_causal", dtype=torch.float32, causal=True,
                   seed=args.seed + 1, **small),
        flash_case(torch, "gpt2_small_bf16_full", dtype=torch.bfloat16, causal=False,
                   seed=args.seed + 2, **small),
        flash_case(torch, "d128_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 3, **{**small, "d": 128}),
        flash_case(torch, "ragged_s1000_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 4, **{**small, "s": 1000}),
    ]
    del flush
    torch.cuda.empty_cache()

    # 7. fp32 train-step parity, flash against plain attention
    train_parity(torch, np, args.seed)

    # 8. bf16 training: bench.py's path
    train, _ = train_bf16(torch, np, args.seed, card)

    # 9. fused-CE kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    head = dict(n=8192, v=50257, e=768, flush=flush)
    fused_cases = [
        fused_ce_case(torch, "gpt2_small_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed, **head),
        fused_ce_case(torch, "gpt2_small_fp32", dtype=torch.float32, ignore_every=16,
                      seed=args.seed + 1, **head),
        fused_ce_case(torch, "ragged_n1000_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 2, **{**head, "n": 1000}),
        fused_ce_case(torch, "e1024_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 3, **{**head, "e": 1024}),
        fused_ce_case(torch, "all_ignored_bf16", dtype=torch.bfloat16, ignore_every=1,
                      seed=args.seed + 4, **head),
    ]
    del flush
    torch.cuda.empty_cache()

    # 10. fp32 train-step parity, fused CE against the plain loss
    fused_ce_parity(torch, np, args.seed)

    # 11. bf16 training with the fused loss: bench.py's BENCH_FUSED_CE=2 path
    fused_train, _ = train_bf16(torch, np, args.seed, card, fused_ce=True)
    if not fused_train["peak_mem_bytes"] < train["peak_mem_bytes"]:
        raise AssertionError(f"fused-CE training peak {fused_train['peak_mem_bytes']} B is not below "
                             f"the default loss's {train['peak_mem_bytes']} B")

    # 12. summary lines
    main_case = cases[0]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "accelerate_tpu/ops/flash_attention.py:734",
        "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    for kname, replaces in FLASH_REPLACES.items():
        main_rec = flash_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": train["launches"][kname],
            "max_abs_err": max(c[kname]["max_abs_err"] for c in flash_cases),
            "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        })
    for kname, replaces in FUSED_CE_REPLACES.items():
        main_rec = fused_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/fused_ce.cu", "replaces": replaces,
            "launches": fused_train["launches"][kname],
            "max_abs_err": max(c[kname]["max_abs_err"] for c in fused_cases),
            "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
