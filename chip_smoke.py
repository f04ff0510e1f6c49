#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`accelerate_tpu_torch`) on one NVIDIA H100.

Phases run in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and its compute
   capability, which must be 9.0;
2. build: nvcc compiles the kernel libraries from accelerate_tpu_torch/ops/csrc/
   (one nvcc per source, all started together); ptxas's registers, spills
   and static shared memory of each flash forward kernel, of each bf16
   dQ and dK/dV kernel, of each bf16 fused-CE dH and dW kernel (with the
   dH and dW launches at e 768: CTAs a cluster, ring stages, shared memory
   and how many clusters the card runs at once) and of the bf16 fused-CE
   forward (with its launch at each split count), of every paged-decode
   kernel (register and general bodies) and of every nf4 kernel, and none
   of them may spill;
3. kernel: `paged_decode_attention` (the CUDA kernel) against
   `paged_decode_attention_reference` on the card at GPT-2-small shapes
   (ragged lengths up to 1024, block boundaries, a zero-length row and a
   sentinel-parked row), a GQA case, an int8 pool with scale planes, and the
   shapes the general body takes: head_dim 96 and 256, 3 and 6 query heads
   per kv head, beside an int8 pool at head_dim 128 with 4; one JSON line
   per case with its error, its times (SDPA over the gathered view as the
   library yardstick), its bound and the share of the bound it reaches;
4. fp32 slice: GPT-2 small at full width, seeded fp32 weights, TF32 off:
   the same greedy requests through the paged gather engine, through the
   slot-pool engine (the default) and through the paged fused engine, both
   at ``pipeline_depth`` 2 with ``tokens_per_sync`` 1 and 4 (each decode
   step one CUDA graph replay) give exactly the streams `generate` (over
   the slot cache, its decode step replayed from a graph of its own) gives
   for each request alone; the slot engine's
   graph holds no kernel; the paged kernel ran n_layer times per decode
   forward, counted through the replays, and a profiler window around one
   replay holds n_layer x tokens_per_sync paged-decode kernels;
5. bf16 slice: the same model in bf16 serves 48 seeded requests (greedy and
   sampled) through the fused engine at (depth, tokens_per_sync) (1, 1),
   (2, 1) and (2, 4): identical token streams, sampled ones included; the
   first decode step's logits agree with the gather path; one serving line
   each (tokens/s, TTFT and ITL p50/p99, the host's blocked time per fetch,
   decode replays, the kernel's launches through the replays, peak
   memory). Then the slot-pool engine at (2, 1) over the same requests: one
   serving line (``bf16_serving_slot``: no paged kernel launched, its
   streams beside the fused engine's). Then a torch.profiler window over the
   decode steps of an engine at each of the three, and of the slot engine:
   host and device ms per step and per decode iteration, the device's idle
   share, and the kernels that take the device time;
6. flash kernels: the forward, dQ and dK/dV kernels
   (`flash_attention_fwd`/`_dq`/`_dkv`) against their plain versions on the
   card at GPT-2-small training shapes (b 8, h 12, s 1024, d 64, bf16,
   causal), in fp32, non-causal, at d 128 and at a ragged s 1000; each
   output held to FLASH_TOL and lse to LSE_ATOL; one JSON line per case and
   kernel with its error, its times, its bound, its achieved TFLOP/s and
   the share of the bound it reaches;
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
   device ms per step, the device's idle share, the top kernels, the
   device time by kind of kernel (fp32 head GEMMs, flash, bf16 GEMMs, ...)
   and by flash kernel (forward, dQ, dK/dV);
9. fused-CE kernels: the forward, dH and dW kernels (`fused_ce_fwd`/`_dh`/
   `_dw`) against their plain versions on the card at the fused loss's
   shapes (N 8192 = 8 x 1024 rows, V 50257, e 768, bf16, 1/16 of the rows
   ignored), in fp32, at a ragged N 1000, at e 1024 (GPT-2 medium's width),
   at Mistral-7B's untied head (N 8192, V 32000, e 4096) and with every row
   ignored; one JSON line per case and kernel with its error, its times (the
   library yardstick is the unfused PyTorch head and cross-entropy), its
   bound, its achieved TFLOP/s and the share of the bound it reaches; the
   bf16 forward's lines also give its plan (vocab splits, the cluster, ring
   stages);
10. fp32 fused-CE parity: GPT-2 small, fp32, TF32 off, batch 2 x 1024: one
   `make_train_step` step with `lm_loss_fn_pallas` against one with
   `lm_loss_fn`: loss and global gradient norm agree, and each fused-CE
   kernel ran once;
11. bf16 training with the fused loss: phase 8 with `lm_loss_fn_pallas`
   (bench.py's ``BENCH_FUSED_CE=2``): the loss falls, each flash kernel ran
   n_layer times and each fused-CE kernel once per step, and the peak
   memory stays below phase 8's; then its profiler window, which also splits
   the fused-CE kernels' device time into forward, dH and dW;
12. band flash kernels: the forward, dQ and dK/dV band kernels
   (`flash_band_fwd`/`_dq`/`_dkv`) against their plain versions on the card
   at the Mistral training shapes (b 1, 32 query heads over 8 kv heads,
   s 8192, d 128, window 4096, bf16; the plain versions one kv head's group
   at a time), at GPT-2 small's causal shapes through ``triangle_block``
   (beside the rectangular kernels' times on the same function), at a
   ragged fp32 s 1000 with window 100 and 4 query heads per kv head, at
   window 1, and at a window past the sequence (held to the rectangular
   kernels' causal output too); each output held to FLASH_TOL, lse to
   LSE_ATOL, and at the Mistral shapes each output also to a bar
   scaled by its own size (BAND_MAIN_RMS_TOL); one JSON line per case and
   kernel with its error, its times (the library yardstick is SDPA over an
   explicit boolean band mask with ``enable_gqa``), its bound, its achieved
   TFLOP/s and the share of the bound it reaches;
13. fp32 Llama parity: a narrow Mistral shape (hidden 1024, 8 heads over 2
   kv heads, 2 layers, vocab 32000, batch 1 x 2048, window 512), fp32, TF32
   off: one `make_train_step(llama_loss_fn)` step with
   ``attention_impl="flash"`` against one with ``"xla"``: loss and global
   gradient norm agree, and each band kernel ran once per layer;
14. bf16 Mistral training, this slice's path: the Mistral-7B-width model
   (hidden 4096, 32 heads over 8 kv heads, intermediate 14336, vocab 32000,
   window 4096) cut to 4 layers, fp32 masters, ``mixed_precision="bf16"``,
   AdamW(lr 1e-4, weight decay 1e-4), one seeded 1 x 8192 batch repeated:
   2 warm-up and 10 timed steps; the loss falls, each band kernel ran 4
   times per step and the rectangular ones never; step ms, tokens/s, MFU,
   peak memory; then its profiler window;
15. nf4 kernel: `nf4_matmul` (the CUDA dequant-matmul) against
   `nf4_matmul_reference` on the card at the Llama-7B decode shapes of the
   reference's kernel bench (M 1 and 16, bf16), at GPT-2 small's four
   projections (M 16, a decode step, and M 512, a prefill), in fp32, with
   leading dims, and on a weight the kernel does not take (N 192: the
   dequantize route, no launch); each routed call is one launch (a
   profiler window around one call holds one runtime launch and no device
   kernel but the nf4 one); one JSON line per case with its error, its
   times, its bound, the share of the bound it reaches and the dense bf16
   cuBLAS product as a yardstick of another function;
16. fp32 quantized-serving parity: GPT-2 small at full width and depth,
   seeded fp32 weights, TF32 off, engines at depth 2: the nf4 engine's
   greedy streams equal a dense engine's over the dequantized copy of the
   same packed weights, with 4 x n_layer nf4 launches per forward (decode
   step, counted through the replays, or admission prefill) and as many nf4
   kernels in a profiler window around one replay; an int8-KV engine's
   fused streams equal its gather streams;
17. bf16 quantized serving: phase 5's 48 requests through the nf4 engine
   over an int8 KV pool, then through the int8-weights engine, at depth 2;
   one serving-metrics line each with `quant_stats()` and the memory held
   after load against the dense engine's; the plane-pack cache's bytes; a
   profiler window over 16 nf4 decode steps with the nf4 kernel's share;
   then KV bytes per token (fp32, bf16, int8) and the peak concurrent
   streams of an fp32 and an int8 pool of equal bytes over one trace;
18. fp32 Llama decode parity: Llama-2-7B's width (hidden 4096, 32 heads,
   intermediate 11008, vocab 32000) cut to 2 layers, 512 positions, seeded
   fp32 weights, TF32 off: `generate` over the slot cache gives the no-cache
   forward's argmax at every step and the eager step's tokens (batch 2, a
   64-token prompt, 16 tokens), and the nf4 model (its projections on the
   nf4 kernel, 7 launches a layer each forward, counted through the
   replays of `generate`'s graph, 7 a layer in a profiler window around one
   replay) gives the tokens of the dense model over its dequantized
   weights;
19. big-model inference, the reference tool's flow
   (``tools/bench_inference.py`` at its defaults): Llama-2-7B at full depth
   (``BIG_MODEL_LAYERS``), 512 positions, a synthetic fp16 safetensors
   checkpoint written to a temporary directory (removed after), a 64-token
   prompt and 20 new tokens through `generate` (a second call, its decode
   step replayed from the CUDA graph the first captured, its nf4 launches
   counted through the replays, and once more eagerly: equal tokens); one
   line per row, fp16 -> bf16, nf4, int8 and nf4 over an int8 KV cache,
   each built alone and freed before the next: ``load_s``, ``s_per_token``
   and ``s_per_token_eager``, the bytes bound of a token, ``packed_gb``,
   peak memory, the host and device ms of a replayed decode step (and the
   nf4 kernels in one replay: 7 a layer for nf4, none otherwise) and of an
   eager one;
20. the kernels line, the card line, and the final ``{"ok": true, ...}`` line.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import gc
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
# the forward kernels' lse, rect and band, every dtype: |err| <= LSE_ATOL
# (both sides sum the same fp32 scores in another order, the bf16 kernel in
# base 2 with the hardware's ex2; the backward kernels recompute p from this
# lse, so FLASH_TOL's 2e-2 would be far too loose for it). At the Mistral
# shape FLASH_TOL's atol is about a typical value of o, dq and dk in the
# rows that attend thousands of keys (|o| ~ 0.02 at W 4096), so there each
# output is also held to rtol |plain| + BAND_MAIN_RMS_TOL rms(plain), rtol
# FLASH_TOL's: set at about 2.5x the largest reading (0.0213 for o, 0.0052
# for dq and dk/dv, seed 0), where bf16 rounding of p and dS at other
# running maxima leaves a small excess on elements that cancel. Not for
# window 1: there dq and dk are 0 up to rounding and have no size to scale by
LSE_ATOL = 1e-4
BAND_MAIN_RMS_TOL = {"flash_band_fwd": 0.05, "flash_band_dq": 0.015, "flash_band_dkv": 0.015}
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
# device kernels of the bf16 train steps by kind, first match wins, case
# ignored. The only fp32 products of those steps are the heads' (logits,
# d hidden, d head weight); casts run as copy kernels, so they match before
# the other elementwise kernels (GELU, residual adds, masks, AdamW's
# scalars); SiLU (the Llama steps) before all elementwise. PyTorch runs
# `F.rms_norm` (the Llama steps) through its layer-norm kernels, so one
# category holds both norms.
TRAIN_KERNEL_CATEGORIES = (
    ("band flash kernels", r"flash_band_(fwd|dq|dkv)_kernel"),
    ("fused-CE kernels", r"fused_ce_(fwd|bwd)_kernel"),
    ("fp32 head GEMMs", r"f32f32|sgemm"),
    ("flash kernels", r"flash_(fwd|dq|dkv)_kernel"),
    ("bf16 GEMMs", r"nvjet|bf16bf16|gemm.*bf16|bf16.*gemm"),
    ("AdamW", r"multi_tensor_apply"),
    ("LayerNorm and RMSNorm", r"layer_norm|rms_norm"),
    ("SiLU", r"silu"),
    ("softmax and cross-entropy", r"softmax|nll_loss|gather"),
    ("copies and casts", r"copy"),
    ("other elementwise and reductions", r"elementwise|reduce"),
)
FLASH_REPLACES = {
    "flash_attention_fwd": "accelerate_tpu/ops/flash_attention.py:50",
    "flash_attention_dq": "accelerate_tpu/ops/flash_attention.py:130",
    "flash_attention_dkv": "accelerate_tpu/ops/flash_attention.py:165",
}
BAND_REPLACES = {
    "flash_band_fwd": "accelerate_tpu/ops/flash_attention.py:340",
    "flash_band_dq": "accelerate_tpu/ops/flash_attention.py:372",
    "flash_band_dkv": "accelerate_tpu/ops/flash_attention.py:399",
}
FUSED_CE_REPLACES = {
    "fused_ce_fwd": "accelerate_tpu/ops/fused_ce.py:47",
    "fused_ce_dh": "accelerate_tpu/ops/fused_ce.py:79",
    "fused_ce_dw": "accelerate_tpu/ops/fused_ce.py:103",
}
NF4_REPLACES = "accelerate_tpu/ops/nf4_matmul.py:43"
# nf4 kernel against its plain version, |err| <= atol + rtol |plain|: both sum
# the same fp32 products of the same dequantized weights, in another order
# (split-K and warp partials against one fp32 GEMM); a bf16 output is then
# rounded once (2^-8 relative), a sum near a rounding boundary possibly the
# other way
NF4_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# the Llama-7B decode shapes of the reference's kernel bench
# (tools/bench_nf4_kernel.py:30), and GPT-2 small's projections (qkv, proj,
# up, down), all [in, out]
LLAMA_NF4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
GPT2_NF4_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log: str, pattern: str):
    """(the regex match, ptxas's resources) of each kernel whose mangled
    name matches ``pattern`` in a build log: registers at entry, spill
    bytes and static shared memory (the sm_90a kernels' tiles are dynamic
    shared memory, set at launch)."""
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(pattern, block.split("'", 1)[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        yield m, {"registers": int(regs.group(1)) if regs else None,
                  "spill_store_bytes": int(spill.group(1)) if spill else None,
                  "spill_load_bytes": int(spill.group(2)) if spill else None,
                  "static_smem_bytes": int(smem.group(1)) if smem else 0}


def kernel_resources(log: str, pattern: str, fields: tuple[str, ...]) -> list[dict]:
    """`ptxas_entries` of each kernel whose name matches the regex
    ``pattern`` (no capturing groups): its name, its element type
    (``dtype``) and each further template argument, an int or a bool, under
    the next name of ``fields`` (fewer arguments, fewer keys)."""
    out = []
    mangled = rf"({pattern})I(13__nv_bfloat16|f)((?:L[bi]\d+E)*?(?:L[bi]\d+)?)EEEv"
    for m, res in ptxas_entries(log, mangled):
        values = [bool(int(x)) if kind == "b" else int(x)
                  for kind, x in re.findall(r"L([bi])(\d+)", m.group(3))]
        out.append({"kernel": m.group(1), "dtype": "float32" if m.group(2) == "f" else "bfloat16",
                    **dict(zip(fields, values)), **res})
    return out


FLASH_FIELDS = ("d", "causal")  # the flash kernels' template arguments after the type


def forward_resources(log: str) -> list[dict]:
    """`kernel_resources` of the flash forward kernels (``flash_fwd_kernel``
    and ``flash_band_fwd_kernel``)."""
    return kernel_resources(log, r"flash_(?:band_)?fwd_kernel", FLASH_FIELDS)


def dq_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 dQ kernels (``flash_dq_kernel``,
    ``flash_band_dq_kernel``), the ones built on wgmma and TMA."""
    return [k for k in kernel_resources(log, r"flash_(?:band_)?dq_kernel", FLASH_FIELDS)
            if k["dtype"] == "bfloat16"]


def dkv_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 dK/dV kernels (``flash_dkv_kernel``,
    ``flash_band_dkv_kernel``), the ones built on wgmma and TMA."""
    return [k for k in kernel_resources(log, r"flash_(?:band_)?dkv_kernel", FLASH_FIELDS)
            if k["dtype"] == "bfloat16"]


def fused_ce_bwd_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 fused-CE dH and dW kernels
    (``fused_ce_bwd_kernel<bf16, DW, NH>``: ``dw`` and the output chunks a
    warpgroup holds), the ones built on wgmma, TMA and clusters."""
    return [k for k in kernel_resources(log, r"fused_ce_bwd_kernel", ("dw", "chunks_per_warpgroup"))
            if k["dtype"] == "bfloat16"]


def fused_ce_fwd_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 fused-CE forward kernel
    (``fused_ce_fwd_kernel<bf16, BN>``: ``vocab_tile`` BN), the one built on
    wgmma, TMA and a cluster split of the vocab."""
    return [k for k in kernel_resources(log, r"fused_ce_fwd_kernel", ("vocab_tile",))
            if k["dtype"] == "bfloat16"]


def entry_resources(log: str, pattern: str, fields: tuple[str, ...]) -> list[dict]:
    """`ptxas_entries` of each kernel whose mangled name matches the regex
    ``pattern``, whose groups name the kernel's template arguments under
    ``fields`` (a type as its mangled name, a number as an int)."""
    return [{**{k: int(v) if v.isdigit() else v for k, v in zip(fields, m.groups())}, **res}
            for m, res in ptxas_entries(log, pattern)]


_MANGLED_TYPES = r"(f|13__nv_bfloat16|6__half)"


def paged_decode_resources(log: str) -> list[dict]:
    """`entry_resources` of the paged-decode kernels
    (``paged_decode_kernel<TQ, TKV, QUANT, D, G, PB>``: D and G 0 for the
    general body; pool ``S1_`` is q's type, ``a`` int8)."""
    pattern = rf"paged_decode_kernelI{_MANGLED_TYPES}(f|S1_|a)Lb([01])ELi(\d+)ELi(\d+)ELi(\d+)E"
    return entry_resources(log, pattern, ("q", "pool", "quant", "d", "groups", "piece_bytes"))


def nf4_resources(log: str) -> list[dict]:
    """`entry_resources` of the nf4 kernels (``nf4_matmul_kernel<T, ROWS>``)."""
    return entry_resources(log, rf"nf4_matmul_kernelI{_MANGLED_TYPES}Li(\d+)E", ("dtype", "rows"))


def device_work(torch, fn) -> tuple[int, list[str]]:
    """What one call of ``fn`` puts on the device, from a torch.profiler
    window around it: (the runtime calls that launch a kernel, set or copy
    memory, the device kernels by name, one per launch). The call sits
    between two spin kernels of PyTorch's own of about a millisecond each,
    left out of both: the profiler can drop device kernels near a short
    window's edges (and then the runtime calls still count them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        fn()
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    events = prof.events()
    calls = sum(ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy")) for ev in events)
    kernels = [ev.name for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation
               and "spin_kernel" not in ev.name]
    return calls - 2, kernels


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


def timed_steps(torch, step, data, warmup: int, steps: int) -> tuple[list[float], float]:
    """``warmup`` train steps, then ``steps`` timed ones with the launch
    counts set to 0 and the peak-memory counter reset just before them:
    (the loss of every step, the timed steps' host wall in s, ending in a
    synchronize). Earlier phases' objects that sit in reference cycles (a
    serving engine and its KV pool) are collected first, so the peak counts
    what the training holds."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    losses = [step(data).item() for _ in range(warmup)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    timed = [step(data) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return losses + [t.item() for t in timed], wall


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
               bound_share=bound_ms / kernel_ms,
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


def profile_decode(torch, engine, requests, steps: int = 16,
                   phase: str = "bf16_decode_profile") -> dict:
    """Admit ``requests`` (first step, unprofiled), then profile ``steps``
    `step` calls, each one decode dispatch of ``tokens_per_sync``
    iterations: host wall per step and per decode iteration, device busy
    per step and per iteration (the sum of kernel times on the one stream),
    the six kernels with the most device time and the share of device time
    in the nf4 kernels."""
    for r in requests:
        engine.submit(r)
    engine.step()
    wall_us, by_name = profile_steps(torch, engine.step, steps)
    nf4_us = sum(us for n, us in by_name.items() if "nf4_" in n)
    rec = profile_record(phase, steps, wall_us, by_name, slots=engine.active_slots,
                         pipeline_depth=engine.pipeline_depth,
                         tokens_per_sync=engine.tokens_per_sync,
                         nf4_share_of_device=nf4_us / max(sum(by_name.values()), 1e-9))
    rec["host_ms_per_iteration"] = rec["host_ms_per_step"] / engine.tokens_per_sync
    rec["device_ms_per_iteration"] = rec["device_ms_per_step"] / engine.tokens_per_sync
    return rec


def replay_launches(engine, name: str, eager: int) -> int:
    """Launches of the kernel behind wrapper ``name`` (``paged_decode_attention``,
    ``nf4_matmul``) in a serving run: ``eager``, the wrapper's own count over
    the run (the admission prefills it launched), plus what one decode
    replay launches (counted by the wrapper while the engine captured its
    graph) times the decode replays."""
    return eager + engine.graph_launches.get(name, 0) * engine.metrics.decode_dispatches.value


def graph_kernels(torch, engine, pattern: str) -> int:
    """Device kernels whose name holds ``pattern`` in a profiler window
    around one replay of ``engine``'s decode graph (every slot frozen, so
    the replay changes nothing that is read)."""
    if engine.active_slots:
        raise AssertionError("graph_kernels replays a decode step: every slot must be free")
    _, kernels = device_work(torch, engine._graph.replay)
    return sum(pattern in k for k in kernels)


def serving_line(engine, outs, wall_s: float, launches: int, peak_mem_bytes: int, card: str,
                 phase: str = "bf16_serving", **extra) -> dict:
    """One serving run's line: the engine's depth and iterations per
    dispatch, tokens/s over the run's host wall, TTFT and ITL p50/p99, the
    host's blocked time per fetch p50, decode replays and the forwards they
    ran, the paged kernel's launches counted through the replays, and the
    peak memory."""
    m = engine.metrics
    return {"phase": phase, "pipeline_depth": engine.pipeline_depth,
            "tokens_per_sync": engine.tokens_per_sync, "requests": len(outs),
            "generated_tokens": m.tokens_generated.value, "wall_s": wall_s,
            "tokens_per_s": m.tokens_generated.value / wall_s,
            "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
            "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
            "host_blocked_p50_s": m.host_blocked_s.quantile(0.5),
            "decode_replays": m.decode_dispatches.value, "decode_steps": m.decode_steps.value,
            "kernel_launches": launches, "peak_mem_bytes": peak_mem_bytes, **extra, "card": card}


def flash_counts(fa) -> dict[str, int]:
    return {n: getattr(fa, n).launches for n in FLASH_REPLACES}


def band_counts(fa) -> dict[str, int]:
    return {n: getattr(fa, n).launches for n in BAND_REPLACES}


def fused_ce_counts() -> dict[str, int]:
    from accelerate_tpu_torch.ops import fused_ce

    return {n: getattr(fused_ce, n).launches for n in FUSED_CE_REPLACES}


def reset_counts(fa) -> None:
    """Every kernel wrapper's launch count to 0."""
    from accelerate_tpu_torch.ops import fused_ce

    from accelerate_tpu_torch.ops import nf4_matmul

    fa.paged_decode_attention.launches = 0
    nf4_matmul.nf4_matmul.launches = 0
    for n in (*FLASH_REPLACES, *BAND_REPLACES):
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
    lse_err = (got["flash_attention_fwd"][1] - lse_ref).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"flash case {name}: lse max_abs_err {lse_err} > {LSE_ATOL}")

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
        kernel_ms = device_ms(torch, kernel[kname], flush)
        bound_ms = max(n_bytes / bw, n_flops / peak) * 1e3
        rec = dict(case=name, kernel=kname, b=b, h=h, s=s, d=d, dtype=str(dtype).removeprefix("torch."),
                   causal=causal, max_abs_err=err, atol=atol, rtol=rtol,
                   **({"lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL}
                      if kname == "flash_attention_fwd" else {}),
                   kernel_ms=kernel_ms,
                   plain_ms=device_ms(torch, plain[kname], flush, samples=10),
                   library_ms=library[kname], bound_ms=bound_ms,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops, tflops=n_flops / kernel_ms * 1e-9,
                   bound_share=bound_ms / kernel_ms)
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
        err, bad, share = 0.0, 0.0, 0.0
        for a, b in zip(got, want):
            diff = (a.float() - b.float()).abs()
            ref = b.float().abs()
            bar = (FUSED_CE_ROW_TOL[0] + FUSED_CE_ROW_TOL[1] * ref if kname == "fused_ce_fwd"
                   else rtol * ref + atol * ref.max())
            err = max(err, diff.max().item())
            bad = max(bad, (diff - bar).max().item())
            share = max(share, (diff / bar.clamp(min=1e-30)).max().item())
        del got, want
        if not (math.isfinite(err) and bad <= 0):
            raise AssertionError(f"fused-CE case {name}, {kname}: max_abs_err {err} exceeds its bar")
        if ignore_every == 1 and kname != "fused_ce_fwd" and err != 0.0:
            raise AssertionError(f"fused-CE case {name}, {kname}: nonzero gradient, all rows ignored")
        n_bytes, products = io[kname]
        n_flops = products * 2 * n * v * e
        rec = dict(phase="fused_ce_kernels", case=name, kernel=kname, n=n, v=v, e=e, dtype=dtype_name,
                   ignored_rows=int((~mask).sum().item()), max_abs_err=err, err_over_bar=share,
                   tol=FUSED_CE_ROW_TOL if kname == "fused_ce_fwd" else (rtol, atol),
                   kernel_ms=device_ms(torch, kernel[kname], flush, samples=samples),
                   plain_ms=device_ms(torch, plain[kname], flush, samples=5),
                   library_ms=library[kname],
                   bound_ms=max(n_bytes / bw, n_flops / peak) * 1e3,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops)
        rec.update(tflops=n_flops / rec["kernel_ms"] * 1e-9, bound_share=rec["bound_ms"] / rec["kernel_ms"])
        if kname == "fused_ce_fwd" and dtype == torch.bfloat16:  # the cluster split of the vocab
            plan = fc.fwd_plan(n, v, fc.card_limits(torch.cuda.current_device()))
            rec.update(plan=plan, cluster_ctas=plan["splits"],
                       ring_stages=fc.fwd_launch(plan["splits"])["ring_stages"])
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    torch.cuda.empty_cache()
    return recs


def fused_ce_part(kname: str) -> str | None:
    """Which fused-CE kernel a profiled kernel name is: ``forward``, ``dH`` or
    ``dW`` (the bool after the type in ``fused_ce_bwd_kernel<T, DW, ...>``),
    else None."""
    if "fused_ce_fwd_kernel" in kname:
        return "forward"
    m = re.search(r"fused_ce_bwd_kernel<[^,>]+, (false|true)\b", kname)
    return ("dW" if m.group(1) == "true" else "dH") if m else None


def profile_train(torch, run_step, phase: str, steps: int = 3, **extra) -> dict:
    """A profiler window over ``steps`` train steps: host and device ms per
    step, the idle share, the top kernels, the device ms per step of each
    kind of kernel (TRAIN_KERNEL_CATEGORIES), of each flash kernel (the
    forward, dQ and dK/dV split of the flash categories) and of each fused-CE
    kernel (forward, dH, dW); prints and returns the record."""
    wall_us, by_name = profile_steps(torch, run_step, steps)
    categories: dict[str, float] = {}
    flash: dict[str, float] = {}
    fused: dict[str, float] = {}
    for kname, us in by_name.items():
        cat = next((c for c, pattern in TRAIN_KERNEL_CATEGORIES
                    if re.search(pattern, kname, re.IGNORECASE)), "other")
        categories[cat] = categories.get(cat, 0.0) + us / steps / 1e3
        m = re.search(r"flash_(?:band_)?(?:fwd|dq|dkv)_kernel", kname)
        if m:
            flash[m.group(0)] = flash.get(m.group(0), 0.0) + us / steps / 1e3
        part = fused_ce_part(kname)
        if part:
            fused[part] = fused.get(part, 0.0) + us / steps / 1e3
    prof = profile_record(phase, steps, wall_us, by_name, top=8, **extra,
                          categories_ms_per_step=categories, flash_kernels_ms_per_step=flash,
                          fused_ce_kernels_ms_per_step=fused)
    print(json.dumps(prof), flush=True)
    return prof


def band_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs one head attends on the band: sum over i of
    min(i + 1, window)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def band_case(torch, name, *, b, hq, hkv, s, d, window, dtype, seed, flush, card,
              by_group=False, rect=False, rms_tol=None) -> dict:
    """The three band kernels against their plain versions on one input (q
    pre-scaled ``[b, hq, s, d]``, K/V ``[b, hkv, s, d]``), with their times,
    the times of SDPA over an explicit boolean band mask with
    ``enable_gqa=True`` (forward, and its backward: dq, dk and dv together),
    and the bounds; prints one JSON line per kernel and returns them by
    kernel. Each output is held to FLASH_TOL, lse to LSE_ATOL, and with
    ``rms_tol`` (by kernel) each output also to rtol |plain| + rms_tol
    rms(plain). ``by_group`` evaluates the plain versions one kv head's group at
    a time, to bound their memory. ``rect`` also times the rectangular
    kernels on the same (causal) function, with K/V repeated to the query
    heads, and holds the band forward's output to theirs."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, hq, s, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=g, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn(b, hq, s, d, generator=g, device=dev).to(dtype)
    groups = hq // hkv
    spans = [(j, j + 1) for j in range(hkv)] if by_group else [(0, hkv)]

    def plain_fwd():
        outs = [fa.flash_band_forward_reference(q[:, lo * groups:hi * groups], k[:, lo:hi],
                                                v[:, lo:hi], window) for lo, hi in spans]
        return torch.cat([o for o, _ in outs], 1), torch.cat([m for _, m in outs], 1)

    o_ref, lse_ref = plain_fwd()
    delta = (dout.float() * o_ref.float()).sum(-1)

    def split(lo, hi):
        r = slice(lo * groups, hi * groups)
        return (q[:, r], k[:, lo:hi], v[:, lo:hi], dout[:, r], lse_ref[:, r], delta[:, r], window)

    def plain_dq():
        return torch.cat([fa.flash_band_dq_reference(*split(lo, hi)) for lo, hi in spans], 1)

    def plain_dkv():
        outs = [fa.flash_band_dkv_reference(*split(lo, hi)) for lo, hi in spans]
        return torch.cat([a for a, _ in outs], 1), torch.cat([c for _, c in outs], 1)

    bwd = (q, k, v, dout, lse_ref, delta, window)
    plain = {"flash_band_fwd": plain_fwd, "flash_band_dq": plain_dq, "flash_band_dkv": plain_dkv}
    kernel = {"flash_band_fwd": lambda: fa.flash_band_fwd(q, k, v, window),
              "flash_band_dq": lambda: fa.flash_band_dq(*bwd),
              "flash_band_dkv": lambda: fa.flash_band_dkv(*bwd)}
    dtype_name = str(dtype).removeprefix("torch.")
    atol, rtol = FLASH_TOL[dtype_name]

    def check(what, got, want, over_rms_tol=math.inf):
        """(max |err|, max (|err| - rtol |plain|) / rms(plain), rms(plain))
        over the outputs; raises past FLASH_TOL or ``over_rms_tol``."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, bad, over_rms, rms_seen = 0.0, 0.0, 0.0, []
        for a, w in zip(got, want):
            if a.shape != w.shape:
                raise AssertionError(f"band case {name}, {what}: shape {tuple(a.shape)} "
                                     f"!= {tuple(w.shape)}")
            w = w.float()
            diff = (a.float() - w).abs()
            err = max(err, diff.max().item())
            bad = max(bad, (diff - atol - rtol * w.abs()).max().item())
            rms = w.square().mean().sqrt().item()
            rms_seen.append(rms)
            over_rms = max(over_rms, (diff - rtol * w.abs()).max().item() / max(rms, 1e-30))
        if not (math.isfinite(err) and bad <= 0 and over_rms <= over_rms_tol):
            raise AssertionError(f"band case {name}, {what}: max_abs_err {err}, "
                                 f"(|err| - {rtol} |plain|) / rms(plain) up to {over_rms}: "
                                 f"exceeds atol {atol} + rtol {rtol} * |plain| or "
                                 f"{rtol} * |plain| + {over_rms_tol} * rms(plain)")
        return err, over_rms, rms_seen

    rms_tol = rms_tol or {}
    errs, over, rms = {}, {}, {}
    o, lse = kernel["flash_band_fwd"]()
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"band case {name}: lse max_abs_err {lse_err} > {LSE_ATOL}")
    errs["flash_band_fwd"], over["flash_band_fwd"], rms["flash_band_fwd"] = check(
        "flash_band_fwd", o, o_ref, rms_tol.get("flash_band_fwd", math.inf))
    errs["flash_band_fwd"] = max(errs["flash_band_fwd"], lse_err)
    del o, lse
    for kname in ("flash_band_dq", "flash_band_dkv"):
        got = kernel[kname]()
        torch.cuda.synchronize()
        errs[kname], over[kname], rms[kname] = check(kname, got, plain[kname](),
                                                     rms_tol.get(kname, math.inf))
        del got
    rect_rec = {}
    if rect:
        kr, vr = (t.repeat_interleave(groups, dim=1) for t in (k, v))
        rbwd = (q, kr, vr, dout, lse_ref, delta, True)
        rect_fns = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, kr, vr, True),
                    "flash_attention_dq": lambda: fa.flash_attention_dq(*rbwd),
                    "flash_attention_dkv": lambda: fa.flash_attention_dkv(*rbwd)}
        rect_rec["rect_o_max_abs_err"] = check("rect forward", rect_fns["flash_attention_fwd"]()[0],
                                               o_ref)[0]
        rect_rec["rect_ms"] = {n: device_ms(torch, fn, flush) for n, fn in rect_fns.items()}
        del kr, vr, rbwd, rect_fns

    # yardstick: SDPA over the explicit band mask (it does the full s^2
    # work), forward and backward
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    mask = (j <= i) & ((j > i - window) if window is not None else True)
    sdpa = dict(attn_mask=mask, scale=1.0, enable_gqa=groups > 1)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), flush,
                        samples=10)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,
                                                           retain_graph=True), flush, samples=10)
    del sdpa_out, qs, ks, vs, mask
    library = {"flash_band_fwd": lib_fwd, "flash_band_dq": lib_bwd, "flash_band_dkv": lib_bwd}

    # least time: each input read once, each output written once; 2 d flops
    # per attended (query, key) pair and product
    pairs = b * hq * band_pairs(s, window)
    elt = q.element_size()
    q_bytes, kv_bytes, rows = b * hq * s * d * elt, b * hkv * s * d * elt, b * hq * s * 4
    io = {"flash_band_fwd": (2 * q_bytes + 2 * kv_bytes + rows, 2),
          "flash_band_dq": (3 * q_bytes + 2 * kv_bytes + 2 * rows, 3),
          "flash_band_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * rows, 4)}
    bw, fp32_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    peak = bf16_peak(torch.cuda.get_device_name(0)) if dtype == torch.bfloat16 else fp32_peak
    recs = {}
    for kname in BAND_REPLACES:
        n_bytes, products = io[kname]
        n_flops = products * 2 * d * pairs
        kernel_ms = device_ms(torch, kernel[kname], flush)
        bound_ms = max(n_bytes / bw, n_flops / peak) * 1e3
        rec = dict(phase="flash_band_kernels", case=name, kernel=kname, b=b, hq=hq, hkv=hkv, s=s,
                   d=d, window=window, dtype=dtype_name, max_abs_err=errs[kname], atol=atol,
                   rtol=rtol, err_over_rms=over[kname], plain_rms=rms[kname],
                   rms_tol=rms_tol.get(kname),
                   **({"lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL}
                      if kname == "flash_band_fwd" else {}),
                   kernel_ms=kernel_ms,
                   plain_ms=device_ms(torch, plain[kname], flush, samples=5),
                   library_ms=library[kname], bound_ms=bound_ms,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops, tflops=n_flops / kernel_ms * 1e-9,
                   bound_share=bound_ms / kernel_ms, **rect_rec, card=card)
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    del q, k, v, dout, o_ref, lse_ref, delta
    torch.cuda.empty_cache()
    return recs


def mistral_config(torch, **kw):
    """Mistral-7B's published width (mistralai/Mistral-7B-v0.1 config.json;
    arXiv 2310.06825, Table 1) as a `LlamaConfig`, depth cut to 4 layers:
    7.24 B parameters at 16 bytes of training state each exceed the card."""
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=4,
        num_heads=32, num_kv_heads=8, rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=8192, sliding_window=4096, attention_impl="flash",
        dtype=torch.bfloat16), **kw})


def llama_band_parity(torch, np, seed: int, card: str) -> dict:
    """One fp32 train step (TF32 off) of a narrow Mistral shape (hidden 1024,
    8 heads, 2 kv heads, intermediate 3584, 2 layers, vocab 32000, batch
    1 x 2048, window 512) with ``attention_impl="flash"`` (the band kernels)
    and one with ``"xla"`` (the plain path), from the same weights and
    batch: loss and global gradient norm agree; each band kernel ran once
    per layer in the flash step and never in the other."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    shape = dict(hidden_size=1024, num_heads=8, num_kv_heads=2, intermediate_size=3584,
                 num_layers=2, max_position_embeddings=2048, sliding_window=512,
                 dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 32000, (1, 2048))).to("cuda")
    out = {}
    for impl in ("xla", "flash"):
        model = LlamaForCausalLM(mistral_config(torch, attention_impl=impl, **shape), seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(llama_loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[impl] = (loss, step.grad_norm.item(), {**band_counts(fa), **flash_counts(fa)})
        del model, acc, step
        torch.cuda.empty_cache()
    (loss_x, norm_x, counts_x), (loss_f, norm_f, counts) = out["xla"], out["flash"]
    rec = {"phase": "fp32_llama_band_parity", "batch": 1, "seq": 2048, "window": 512,
           "loss_plain": loss_x, "loss_flash": loss_f, "loss_abs_diff": abs(loss_f - loss_x),
           "loss_atol": TRAIN_LOSS_ATOL, "grad_norm_plain": norm_x, "grad_norm_flash": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x,
           "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL, "launches": counts, "launches_plain": counts_x,
           "card": card}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_x) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 Llama step: band loss {loss_f} vs plain {loss_x}")
    if not abs(norm_f - norm_x) <= TRAIN_GRAD_NORM_RTOL * norm_x:
        raise AssertionError(f"fp32 Llama step: band grad norm {norm_f} vs plain {norm_x}")
    expected = {**{n: shape["num_layers"] for n in BAND_REPLACES}, **{n: 0 for n in FLASH_REPLACES}}
    if counts != expected or any(counts_x.values()):
        raise AssertionError(f"fp32 Llama launches {counts} (plain step {counts_x}), "
                             f"expected {expected} (none)")
    return rec


def train_mistral(torch, np, seed: int, card: str, warmup: int = 2, steps: int = 10) -> dict:
    """The slice's path: the Mistral-7B-width model (4 layers, window 4096),
    fp32 masters, ``Accelerator(mixed_precision="bf16")``, AdamW (lr 1e-4,
    weight decay 1e-4), ``make_train_step(llama_loss_fn)`` on one seeded
    batch of 1 x 8192 ids, repeated; ``warmup`` then ``steps`` timed steps
    with the launch counts set to 0 just before them. The loss falls over
    the ``warmup + steps`` steps, and each band kernel ran once per layer per
    timed step, the rectangular flash kernels never. MFU counts 6 N per
    token for the N matmul parameters plus 12 L e w per token for
    attention, w the mean number of keys a query sees. Then a profiler
    window over 3 steps."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    batch, seq = 1, 8192
    cfg = mistral_config(torch)
    model = LlamaForCausalLM(cfg, seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(llama_loss_fn)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    data = {"input_ids": torch.from_numpy(ids).to("cuda")}

    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = {**band_counts(fa), **flash_counts(fa)}
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = sum(p.numel() for p in model.parameters() if p.ndim == 2) - model.embed_tokens.numel()
    mean_keys = band_pairs(seq, cfg.sliding_window) / seq
    flops_per_token = 6 * n_matmul + 12 * cfg.num_layers * cfg.hidden_size * mean_keys
    tokens_per_s = batch * seq * steps / wall
    mfu = tokens_per_s * flops_per_token / bf16_peak(torch.cuda.get_device_name(0))
    rec = {"phase": "bf16_train_mistral", "model": "mistral-7b-width, 4 layers", "batch": batch,
           "seq": seq, "window": cfg.sliding_window, "params": n_params,
           "matmul_params": n_matmul, "mean_keys_per_query": mean_keys,
           "warmup_steps": warmup, "steps": steps, "step_ms": wall / steps * 1e3,
           "tokens_per_s": tokens_per_s, "mfu": mfu, "flops_per_token": flops_per_token,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "launches": counts, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mistral training: the loss did not fall: {losses}")
    expected = {**{n: cfg.num_layers * steps for n in BAND_REPLACES},
                **{n: 0 for n in FLASH_REPLACES}}
    if counts != expected:
        raise AssertionError(f"bf16_train_mistral launches {counts}, expected {expected}")
    profile_train(torch, lambda: step(data), "bf16_train_mistral_profile", card=card)
    del model, acc, step
    torch.cuda.empty_cache()
    return rec


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

    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = {**flash_counts(fa), **fused_ce_counts()}
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

    prof = profile_train(torch, lambda: step(data), f"{phase}_profile")
    del model, acc, step
    torch.cuda.empty_cache()
    return rec, prof


def nf4_case(torch, name, *, M, K, N, dtype, seed, flush, lead=()) -> dict:
    """`nf4_matmul` against its plain version on one seeded nf4 weight ``[K,
    N]`` and x ``[M, K]`` (``lead`` splits M into leading dims), with its
    time, the plain version's, the bound and the library yardstick: ``x @ W``
    through cuBLAS over a dense bf16 copy of the weight, the dense route that
    nf4 serving replaces (not the same function; the port never calls it). A
    weight the kernel does not take must launch nothing and match the
    dequantize route. Prints one JSON line and returns it."""
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, dequantize, quantize

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quantize(torch.randn(K, N, generator=g, device=dev) / math.sqrt(K),
                  QuantizationConfig(load_in_4bit=True, quant_type="nf4",
                                     compute_dtype=torch.float32))
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    xin = x.reshape(*lead, M // math.prod(lead), K) if lead else x
    routed = nm.routes_to_kernel(qt)
    before = nm.nf4_matmul.launches
    out = nm.nf4_matmul(xin, qt).reshape(M, N)
    launched = nm.nf4_matmul.launches - before
    if routed:
        packed, scales2 = nm.plane_pack(qt)

        def plain():
            return nm.nf4_matmul_reference(x, packed, scales2)
    else:
        def plain():
            return x @ dequantize(qt, dtype)
    ref = plain()
    torch.cuda.synchronize()
    dtype_name = str(dtype).removeprefix("torch.")
    atol, rtol = NF4_TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff - atol - rtol * ref.float().abs()).max().item()
    if launched != int(routed) or not (math.isfinite(err) and bad <= 0):
        raise AssertionError(f"nf4 case {name}: {launched} launches (routed {routed}), "
                             f"max_abs_err {err} exceeds atol {atol} + rtol {rtol} |plain|")
    calls, on_device = device_work(torch, lambda: nm.nf4_matmul(xin, qt)) if routed else (0, [])
    if routed and (calls != 1 or len(on_device) > 1
                   or any("nf4_matmul_kernel" not in k for k in on_device)):
        raise AssertionError(f"nf4 case {name}: one call made {calls} launches and ran {on_device} "
                             "on the device, not the one nf4 kernel")
    dense = dequantize(qt, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    kernel_ms = device_ms(torch, lambda: nm.nf4_matmul(x, qt), flush)
    plain_ms = device_ms(torch, plain, flush, samples=10)
    library_ms = device_ms(torch, lambda: xb @ dense, flush)
    # least time: payload and scales, x read once, the output written once;
    # 2 M K N fp32 flops on the CUDA cores (the weight stays fp32)
    elt = x.element_size()
    n_bytes = qt.nbytes + M * K * elt + M * N * elt
    n_flops = 2 * M * K * N
    bw, fp32_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    rec = dict(phase="nf4_kernels", case=name, M=M, K=K, N=N, lead=list(lead), dtype=dtype_name,
               routed=routed, launches=launched, max_abs_err=err, tol=(atol, rtol),
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               library="x_bf16 @ dense bf16 W, cuBLAS: the dense route, a different function",
               splits=nm.split_k(M, K, N)[0] if routed else None,
               device_launches_per_call=calls, device_kernels_seen=len(on_device),
               bound_ms=max(n_bytes / bw, n_flops / fp32_peak) * 1e3,
               bound_share=max(n_bytes / bw, n_flops / fp32_peak) * 1e3 / kernel_ms,
               bound_by="bytes" if n_bytes / bw >= n_flops / fp32_peak else "operations",
               bytes=n_bytes, flops=n_flops, gb_per_s=n_bytes / kernel_ms / 1e6)
    print(json.dumps(rec), flush=True)
    del qt, dense, x, xb, out, ref
    return rec


def count_admissions(engine) -> list:
    """Wrap ``engine``'s admission so each group that is seated (one prefill
    forward) adds one to the returned counter's first entry, and the host
    wall of every admission call (the eager prefill's launches, and at depth
    1 its fetch) to its second."""
    counter = [0, 0.0]
    admit = engine._admit_group

    def counted(group, finished):
        t0 = time.perf_counter()
        seated = admit(group, finished)
        counter[1] += time.perf_counter() - t0
        counter[0] += int(seated)
        return seated

    engine._admit_group = counted
    return counter


def quant_parity(torch, seed: int, prompts: list[list[int]]) -> dict:
    """fp32 GPT-2 small, TF32 off. (a) The nf4 engine against a dense engine
    over the dequantized copy of the same packed weights: equal greedy
    streams, and 4 x n_layer nf4 launches per forward (decode step or
    admission prefill; a decode step's counted through the replays, and
    seen in a profiler window around one replay), none in the dense run. (b)
    An int8-KV model: the fused engine against the gather engine, equal
    streams, the paged kernel n_layer times per decode step."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention
    from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine
    from accelerate_tpu_torch.utils.quantization import dequantize_module

    kw = dict(max_concurrency=8, prompt_buckets=BUCKETS, paged_kv=True)

    def run(engine):
        admissions = count_admissions(engine)
        outs = engine.run([Request(prompt=p, params=SamplingParams(max_new_tokens=32))
                           for p in prompts])
        return [o.tokens for o in outs], engine.metrics.decode_steps.value, admissions[0]

    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
    per_forward = 4 * model.config.n_layer
    nf4 = ServingEngine(model, weight_quant="nf4", paged_attention="fused", **kw)
    del model
    nm.nf4_matmul.launches = 0
    nf4_out, steps, admissions = run(nf4)
    launches = replay_launches(nf4, "nf4_matmul", nm.nf4_matmul.launches)
    nf4_in_replay = graph_kernels(torch, nf4, "nf4_matmul_kernel")
    dense = ServingEngine(dequantize_module(nf4.model), paged_attention="fused", **kw)
    nm.nf4_matmul.launches = 0
    dense_out, _, _ = run(dense)
    dense_launches = replay_launches(dense, "nf4_matmul", nm.nf4_matmul.launches)
    del nf4, dense
    model8 = GPT2LMHead(GPT2Config.small(dtype=torch.float32, kv_cache_dtype=torch.int8),
                        device="cuda", seed=seed)
    gather_out, _, _ = run(ServingEngine(model8, paged_attention="gather", **kw))
    fused = ServingEngine(model8, paged_attention="fused", **kw)
    paged_decode_attention.launches = 0
    fused_out, fused_steps, _ = run(fused)
    paged = replay_launches(fused, "paged_decode_attention", paged_decode_attention.launches)
    del fused
    rec = {"phase": "fp32_quant_parity", "requests": len(prompts), "pipeline_depth": 2,
           "nf4_tokens_equal_dense_dequantized": nf4_out == dense_out,
           "nf4_decode_steps": steps, "nf4_admission_forwards": admissions,
           "nf4_launches": launches, "nf4_launches_expected": per_forward * (steps + admissions),
           "nf4_launches_per_forward": per_forward, "nf4_kernels_in_one_replay": nf4_in_replay,
           "dense_run_nf4_launches": dense_launches,
           "int8_kv_fused_tokens_equal_gather": fused_out == gather_out,
           "int8_kv_decode_steps": fused_steps, "int8_kv_paged_launches": paged,
           "int8_kv_paged_launches_expected": model8.config.n_layer * fused_steps}
    print(json.dumps(rec), flush=True)
    if nf4_in_replay != per_forward:
        raise AssertionError(f"one nf4 replay ran {nf4_in_replay} nf4 kernels, not {per_forward}")
    if nf4_out != dense_out or fused_out != gather_out:
        raise AssertionError("fp32 quantized streams differ: nf4 vs dense-dequantized, or int8-KV "
                             "fused vs gather")
    if any(len(t) != 32 for t in nf4_out + fused_out):
        raise AssertionError("an fp32 quantized request did not emit its 32 tokens")
    if launches != rec["nf4_launches_expected"] or steps == 0 or dense_launches != 0:
        raise AssertionError(f"nf4 launches {launches} != {per_forward} x (decode steps {steps} + "
                             f"admissions {admissions}), or the dense run launched {dense_launches}")
    if paged != rec["int8_kv_paged_launches_expected"] or fused_steps == 0:
        raise AssertionError(f"int8-KV paged launches {paged} != n_layer x decode steps")
    del model8
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def quant_serving(torch, seed: int, requests, long_requests, card: str) -> dict:
    """bf16 GPT-2 small served with quantized weights (this slice's path):
    the nf4 engine over an int8 KV pool, then the int8-weights engine over a
    bf16 pool, each over phase 5's 48 requests after a 4-request warm-up;
    one serving-metrics line each with `quant_stats()`, the launches, and the
    memory allocated after load with the dense model freed, beside the dense
    engine's; the plane-pack cache's bytes on a line of their own; then a
    profiler window over 16 nf4 decode steps. Returns the nf4 line."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.serving import FINISH_LENGTH, PagedKVConfig, ServingEngine
    from accelerate_tpu_torch.utils.quantization import QuantizedLinear

    def build(weight_quant, kv_dtype):
        """An engine and the device bytes it holds (model and pool) once the
        dense model it was built from is freed."""
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                            kv_cache_dtype=kv_dtype), device="cuda", seed=seed)
        engine = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                               paged_attention="fused", max_concurrency=16,
                               prompt_buckets=BUCKETS, weight_quant=weight_quant)
        del model
        gc.collect()
        return engine, torch.cuda.memory_allocated() - base

    dense, dense_bytes = build(None, None)
    del dense
    n_layer = GPT2Config.small().n_layer
    lines = {}
    for mode, kv_dtype in (("nf4", torch.int8), ("int8", None)):
        kv_name = "int8" if kv_dtype is not None else "bf16"
        build(mode, kv_dtype)[0].run(requests()[:4])  # warm-up: handles, allocator pools
        torch.cuda.synchronize()
        eng, held = build(mode, kv_dtype)
        admissions = count_admissions(eng)
        reset_counts(fa)
        t0 = time.perf_counter()
        outs = eng.run(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = replay_launches(eng, "nf4_matmul", nm.nf4_matmul.launches)
        paged = replay_launches(eng, "paged_decode_attention", fa.paged_decode_attention.launches)
        m = eng.metrics
        steps = m.decode_steps.value
        bad = [o.request_id for o in outs
               if o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64]
        expected = 4 * n_layer * (steps + admissions[0]) if mode == "nf4" else 0
        rec = {"phase": f"bf16_quant_serving_{mode}_w_{kv_name}_kv", "requests": len(outs),
               "max_new_tokens": 64, "generated_tokens": m.tokens_generated.value, "wall_s": wall,
               "tokens_per_s": m.tokens_generated.value / wall,
               "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
               "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
               "pipeline_depth": eng.pipeline_depth, "decode_replays": m.decode_dispatches.value,
               "decode_steps": steps, "admission_forwards": admissions[0],
               "nf4_launches": launches, "nf4_launches_expected": expected,
               "paged_decode_launches": paged, "quant_stats": eng.quant_stats(),
               "memory_allocated_after_load": held, "dense_engine_memory_allocated": dense_bytes,
               "card": card}
        print(json.dumps(rec), flush=True)
        if bad:
            raise AssertionError(f"{mode}: requests {bad} did not finish with 64 tokens")
        if launches != expected or paged != n_layer * steps or steps == 0:
            raise AssertionError(f"{mode}: nf4 launches {launches} (expected {expected}), paged "
                                 f"launches {paged} (expected {n_layer * steps})")
        if mode == "nf4":
            pack = sum(t.numel() * t.element_size()
                       for mod in eng.model.modules() if isinstance(mod, QuantizedLinear)
                       for t in (mod.qweight._plane_pack or ()))
            print(json.dumps({"phase": "nf4_plane_pack_cache", "bytes": pack,
                              "not_in": "weight_packed_bytes"}), flush=True)
            lines[mode] = rec
            prof = profile_decode(torch, build(mode, kv_dtype)[0], long_requests(),
                                  phase="bf16_quant_decode_profile")
            print(json.dumps(prof), flush=True)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return lines["nf4"]


def kv_capacity(torch, np, seed: int, card: str) -> dict:
    """The reference's ``BENCH_SERVE_WORKLOAD=quant`` rows: KV bytes per
    token of an fp32, a bf16 and an int8 pool at equal block geometry (pool
    bytes over token capacity, scale planes counted), and the peak concurrent
    streams of one all-at-once ragged trace through an fp32-KV engine and an
    int8-KV engine whose pool holds as many bytes (fp32 compute on both, so
    KV storage is the only variable)."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.kv_cache import make_block_pool
    from accelerate_tpu_torch.serving import PagedKVConfig, Request, SamplingParams, ServingEngine

    cfg = GPT2Config.small()
    bt, probe_blocks = 16, 64
    per_token, per_block = {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        cache = make_block_pool(cfg.n_layer, 1, probe_blocks, bt, cfg.n_head, cfg.head_dim, dtype,
                                "cuda")
        views = [t for i in range(cfg.n_layer)
                 for t in (*cache.pools(i), *(cache.scale_pools(i) or ()))]
        total = sum(t.numel() * t.element_size() for t in views)
        per_token[name], per_block[name] = total / (probe_blocks * bt), total // probe_blocks
        del cache, views
    fp_blocks = 256
    int8_blocks = fp_blocks * per_block["fp32"] // per_block["int8"]
    rng = np.random.default_rng(seed + 7)
    trace = [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, 48)]
    peaks, steps = {}, {}
    for name, kv_dtype, blocks in (("fp32", None, fp_blocks), ("int8", torch.int8, int8_blocks)):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, kv_cache_dtype=kv_dtype),
                           device="cuda", seed=seed)
        eng = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=bt, num_blocks=blocks),
                            paged_attention="fused", max_concurrency=64, prompt_buckets=BUCKETS)
        for p in trace:
            if not eng.submit(Request(prompt=p, params=SamplingParams(max_new_tokens=32))).accepted:
                raise AssertionError("capacity trace: a request was rejected")
        peak = 0
        while eng.has_work:
            eng.step()
            peak = max(peak, eng.active_slots)
        peaks[name], steps[name] = peak, eng.metrics.steps.value
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    rec = {"phase": "kv_capacity", "kv_bytes_per_token": per_token,
           "int8_over_bf16": per_token["int8"] / per_token["bf16"],
           "pool_blocks": {"fp32": fp_blocks, "int8": int8_blocks},
           "pool_bytes": {"fp32": fp_blocks * per_block["fp32"],
                          "int8": int8_blocks * per_block["int8"]},
           "requests": len(trace), "max_new_tokens": 32, "peak_streams": peaks,
           "int8_over_fp32_peak": peaks["int8"] / peaks["fp32"], "steps": steps, "card": card}
    print(json.dumps(rec), flush=True)
    if not rec["int8_over_bf16"] <= 0.55:
        raise AssertionError(f"int8 KV bytes per token {rec['int8_over_bf16']} of bf16's > 0.55")
    if not peaks["int8"] > peaks["fp32"]:
        raise AssertionError(f"int8 pool seated {peaks['int8']} streams, fp32 {peaks['fp32']}")
    return rec


LLAMA_7B_PROMPT, LLAMA_7B_NEW_TOKENS, LLAMA_7B_POSITIONS = 64, 20, 512
# the big-model phase's depth: Llama-2-7B's own 32 layers
BIG_MODEL_LAYERS = 32


def top2_margin(torch, logits) -> float:
    """The smallest gap between the two largest logits of any row."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def captured_launches(held, eager: int, replays: int) -> int:
    """nf4 kernel launches of one `generate` call: ``eager``, the wrapper's
    own count over the call (the prefill it launched), plus what one replay
    of the kept decode graph launches (counted by the wrapper while the
    graph was recorded) times the replays the call made (``replays``, the
    kept step's count before it)."""
    return eager + held.launches.get("nf4_matmul", 0) * (held.replays - replays)


def counted_generate(nm, generation, model, ids, n_new: int):
    """A `generate` call that replays the decode graph an earlier call
    captured, its nf4 launches counted (`captured_launches`): (tokens,
    launches). Fails if the call captured anew."""
    held = generation._CAPTURED[model]
    graph, replays = held.graph, held.replays
    nm.nf4_matmul.launches = 0
    out = generation.generate(model, ids, n_new)
    if generation._CAPTURED.get(model) is not held or held.graph is not graph:
        raise AssertionError("the counted generate captured its decode step anew")
    return out, captured_launches(held, nm.nf4_matmul.launches, replays)


def replay_kernels(torch, generation, model, pattern: str) -> int:
    """Device kernels whose name holds ``pattern`` in a profiler window
    around one replay of the decode graph `generate` keeps for ``model``
    (the replay writes past the last call's tokens, which the next call
    masks)."""
    _, kernels = device_work(torch, generation._CAPTURED[model].graph.replay)
    return sum(pattern in k for k in kernels)


def llama_decode_parity(torch, np, seed: int, card: str) -> dict:
    """Llama-2-7B's width (hidden 4096, 32 heads, intermediate 11008, vocab
    32000) cut to 2 layers, 512 positions, seeded fp32 weights, TF32 off.
    (a) `generate` over the slot cache (a 64-token prefill, then one decode
    step a token, replayed from a captured CUDA graph) gives the eager
    step's tokens and the no-cache forward's argmax at each step, batch 2,
    16 tokens. (b) The nf4 copy of the model (every projection on the nf4
    kernel, the embedding and head quantized too) gives the tokens of a dense
    model over its dequantized weights and of its own eager step. Its second
    `generate` call replays the first call's graph: 7 nf4 launches a layer
    each forward (the prefill's counted by the wrapper, the decode steps'
    through the replays), 7 a layer in a profiler window around one replay,
    and none in the dense model's call or graph."""
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.generation import _generate, generate
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        dequantize_module,
        quantize_module,
    )

    cfg = LlamaConfig.llama2_7b(num_layers=2, dtype=torch.float32, param_dtype=torch.float32,
                                max_position_embeddings=LLAMA_7B_POSITIONS)
    model = LlamaForCausalLM(cfg, seed=seed)
    n_new = 16
    ids = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (2, LLAMA_7B_PROMPT))).cuda()

    def eager(m):
        return _generate(m, ids, n_new, 0.0, None, None, m.device, capture=False)

    cached = generate(model, ids, n_new)
    eager_tokens = eager(model)
    seq, margins = ids, []
    with torch.no_grad():
        for _ in range(n_new):
            last = model(seq)[:, -1]
            margins.append(top2_margin(torch, last))
            seq = torch.cat([seq, last.argmax(-1)[:, None]], dim=1)
    nocache = seq[:, LLAMA_7B_PROMPT:]
    qmodel = quantize_module(model, QuantizationConfig(load_in_4bit=True,
                                                       compute_dtype=torch.float32))
    generation.release_captured(model)
    del model
    dense = dequantize_module(qmodel)
    nf4_eager = eager(qmodel)
    generate(qmodel, ids, n_new)  # captures the nf4 decode step
    nf4_tokens, nf4_launches = counted_generate(nm, generation, qmodel, ids, n_new)
    nf4_in_replay = replay_kernels(torch, generation, qmodel, "nf4_matmul_kernel")
    generate(dense, ids, n_new)
    dense_tokens, dense_launches = counted_generate(nm, generation, dense, ids, n_new)
    dense_in_replay = replay_kernels(torch, generation, dense, "nf4_matmul_kernel")
    per_forward = 7 * cfg.num_layers
    rec = {"phase": "fp32_llama_decode_parity", "model": "llama-2-7b width, 2 layers",
           "batch": 2, "prompt": LLAMA_7B_PROMPT, "new_tokens": n_new,
           "max_positions": LLAMA_7B_POSITIONS,
           "cached_equal_nocache_argmax": torch.equal(cached, nocache),
           "captured_equal_eager": torch.equal(cached, eager_tokens),
           "nf4_captured_equal_eager": torch.equal(nf4_tokens, nf4_eager),
           "nocache_min_top2_margin": min(margins),
           "nf4_tokens_equal_dense_dequantized": torch.equal(nf4_tokens, dense_tokens),
           "nf4_launches": nf4_launches, "nf4_launches_per_forward": per_forward,
           "nf4_launches_expected": per_forward * n_new,
           "nf4_kernels_in_one_replay": nf4_in_replay,
           "dense_run_nf4_launches": dense_launches,
           "dense_replay_nf4_kernels": dense_in_replay, "card": card}
    print(json.dumps(rec), flush=True)
    if not (rec["cached_equal_nocache_argmax"] and rec["captured_equal_eager"]
            and rec["nf4_captured_equal_eager"]):
        raise AssertionError("Llama slot-cache decode: captured, eager and no-cache argmax "
                             f"tokens differ: {rec}")
    if not rec["nf4_tokens_equal_dense_dequantized"]:
        raise AssertionError("nf4 Llama tokens differ from the dense dequantized model's")
    if (nf4_launches != per_forward * n_new or nf4_in_replay != per_forward
            or dense_launches or dense_in_replay):
        raise AssertionError(f"nf4 launches {nf4_launches} != {per_forward} x {n_new} forwards, "
                             f"{nf4_in_replay} nf4 kernels in a replay (want {per_forward}), "
                             f"or the dense model launched {dense_launches} "
                             f"({dense_in_replay} in a replay)")
    del qmodel, dense
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def synthetic_checkpoint(torch, cfg, path) -> int:
    """The reference tool's synthetic checkpoint (``tools/bench_inference.py``):
    zeros in fp16, in the reference's param layout (``layer_i`` blocks,
    ``[in, out]`` kernels), sharded at 5 GB with an index. Returns the
    parameter count."""
    from accelerate_tpu_torch.utils.safetensors_io import save_safetensors_checkpoint

    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvd = cfg.num_kv_heads * cfg.head_dim

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float16)

    tree = {"embed_tokens": z(v, e), "final_norm": {"scale": z(e)}, "lm_head": z(v, e)}
    for i in range(cfg.num_layers):
        tree[f"layer_{i}"] = {
            "input_norm": {"scale": z(e)}, "post_attn_norm": {"scale": z(e)},
            "attn": {"q_proj": {"kernel": z(e, e)}, "k_proj": {"kernel": z(e, kvd)},
                     "v_proj": {"kernel": z(e, kvd)}, "o_proj": {"kernel": z(e, e)}},
            "mlp": {"gate_proj": {"kernel": z(e, f)}, "up_proj": {"kernel": z(e, f)},
                    "down_proj": {"kernel": z(f, e)}}}
    save_safetensors_checkpoint(tree, path, max_shard_size="5GB")
    return sum(t.numel() for t in _tensors(tree))


def _tensors(tree):
    for value in tree.values():
        yield from (_tensors(value) if isinstance(value, dict) else (value,))


def big_model_inference(torch, card: str) -> list[dict]:
    """The reference's big-model-inference row (``tools/bench_inference.py``,
    its defaults: Llama-2-7B capped at 512 positions, a 64-token prompt of
    ones, 20 new tokens) through the port, on the card. The synthetic fp16
    checkpoint is written once to a temporary directory, removed at the end.
    Rows, built one after another and each freed before the next: fp16 ->
    bf16 (`load_checkpoint_in_model`, cast on the card), nf4, int8, and nf4
    over an int8 KV cache (`load_and_quantize_model` into a model on the
    meta device: each leaf quantized on the card). ``load_s`` is disk to
    card, quantization included (the checkpoint read once before, so every
    row reads it from the page cache); ``s_per_token`` is a second
    `generate`'s wall over its new tokens, prefill included, as the tool
    times it (the first call captured the decode step's graph, as the
    tool's first call compiles; the second replays it, its nf4 launches
    counted: the prefill's by the wrapper, the decode steps' through the
    replays), and ``s_per_token_eager`` the same with every step run
    eagerly (`generation._generate`), whose tokens must be the replayed
    ones. Each line has the bytes bound of a token (the weight bytes and the
    slot cache's bytes, which every decode step reads whole, over the HBM
    rate), the peak memory, a profile of three replays of the decode graph
    (host against device ms, the nf4 kernels in one replay) and one of an
    eager decode step."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.generation import _generate, generate
    from accelerate_tpu_torch.models.kv_cache import make_cache, tree_nbytes
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        load_and_quantize_model,
        quantized_nbytes,
    )
    from accelerate_tpu_torch.utils.safetensors_io import (
        load_checkpoint_in_model,
        load_safetensors_checkpoint,
    )

    bw = peak_rates(torch.cuda.get_device_name(0))[0]
    tmp = Path(tempfile.mkdtemp(prefix="bench_inference_llama2_7b_"))
    lines = []
    try:
        base = LlamaConfig.llama2_7b(num_layers=BIG_MODEL_LAYERS, dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16,
                                     max_position_embeddings=LLAMA_7B_POSITIONS)
        t0 = time.perf_counter()
        n_params = synthetic_checkpoint(torch, base, tmp)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in tmp.iterdir())
        t0 = time.perf_counter()
        load_safetensors_checkpoint(tmp)  # into the page cache; the host read's time
        read_s = time.perf_counter() - t0
        for quant, kv in (("", None), ("nf4", None), ("int8", None), ("nf4", torch.int8)):
            cfg = LlamaConfig.llama2_7b(num_layers=BIG_MODEL_LAYERS, dtype=torch.bfloat16,
                                        param_dtype=torch.bfloat16,
                                        max_position_embeddings=LLAMA_7B_POSITIONS,
                                        kv_cache_dtype=kv)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if quant:
                qcfg = QuantizationConfig(load_in_4bit=quant == "nf4", load_in_8bit=quant == "int8",
                                          compute_dtype=cfg.dtype)
                model = load_and_quantize_model(LlamaForCausalLM(cfg, device="meta"), tmp, qcfg,
                                                mapper=params_from_jax)
            else:
                model = LlamaForCausalLM(cfg, device="meta").to_empty(device="cuda")
                load_checkpoint_in_model(model, tmp, mapper=params_from_jax)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated()
            weight_bytes = quantized_nbytes(model)
            prompt = torch.ones((1, LLAMA_7B_PROMPT), dtype=torch.long, device="cuda")
            generate(model, prompt, LLAMA_7B_NEW_TOKENS)  # warm-up, as the tool's first call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, launches = counted_generate(nm, generation, model, prompt,
                                             LLAMA_7B_NEW_TOKENS)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            replay = profile_record("replay_step", 3,
                                    *profile_steps(torch, generation._CAPTURED[model].graph.replay,
                                                   3), top=5)
            nf4_in_replay = replay_kernels(torch, generation, model, "nf4_matmul_kernel")
            t0 = time.perf_counter()
            eager = _generate(model, prompt, LLAMA_7B_NEW_TOKENS, 0.0, None, None, model.device,
                              capture=False)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            cache = make_cache(model, 1, per_slot=False)
            kv_bytes = tree_nbytes(cache)
            with torch.no_grad():
                model(prompt, 0, cache=cache)
                pos = [LLAMA_7B_PROMPT]

                def decode_step():
                    model(prompt[:, :1], pos[0], cache=cache)
                    pos[0] += 1

                decode_step()
                wall_us, by_name = profile_steps(torch, decode_step, 3)
            prof = profile_record("eager_step", 3, wall_us, by_name, top=5)
            bound_s = (weight_bytes + kv_bytes) / bw
            rec = {"phase": "big_model_inference", "preset": "llama2_7b",
                   "layers": cfg.num_layers, "quant": quant or "fp16", "kv_cache": "int8" if kv
                   else "full", "params_b": n_params / 1e9,
                   "load_s": load_s, "s_per_token": gen_s / LLAMA_7B_NEW_TOKENS,
                   "s_per_token_eager": eager_s / LLAMA_7B_NEW_TOKENS,
                   "captured_equal_eager": torch.equal(out, eager),
                   "new_tokens": LLAMA_7B_NEW_TOKENS, "prompt": LLAMA_7B_PROMPT,
                   "max_positions": LLAMA_7B_POSITIONS,
                   "bound_s_per_token": bound_s, "bound_share": bound_s * LLAMA_7B_NEW_TOKENS / gen_s,
                   "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
                   **({"packed_gb": weight_bytes / 1e9} if quant else {}),
                   "nf4_launches": launches, "nf4_kernels_in_one_replay": nf4_in_replay,
                   "peak_mem_bytes_load": load_peak,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": write_s,
                   "checkpoint_read_s": read_s,
                   "replay_step_host_ms": replay["host_ms_per_step"],
                   "replay_step_device_ms": replay["device_ms_per_step"],
                   "replay_step_idle_share": replay["device_idle_share"],
                   "replay_step_top_kernels_ms": replay["top_kernels_ms_per_step"],
                   "eager_step_host_ms": prof["host_ms_per_step"],
                   "eager_step_device_ms": prof["device_ms_per_step"],
                   "eager_step_idle_share": prof["device_idle_share"],
                   "eager_step_top_kernels_ms": prof["top_kernels_ms_per_step"],
                   "reference_row": "GPT-J-6B fp16: 8.7 s load, 0.05 s/token "
                                    "(BASELINE.md, 2x Titan RTX)", "card": card}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
            if tuple(out.shape) != (1, LLAMA_7B_NEW_TOKENS) or not bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()):
                raise AssertionError(f"big-model {quant or 'fp16'}: bad tokens {out.tolist()}")
            if not rec["captured_equal_eager"]:
                raise AssertionError(f"big-model {quant or 'fp16'}: captured and eager tokens "
                                     "differ")
            per_forward = 7 * cfg.num_layers if quant == "nf4" else 0
            if launches != per_forward * LLAMA_7B_NEW_TOKENS or nf4_in_replay != per_forward:
                raise AssertionError(f"big-model {quant or 'fp16'}: the timed generate launched "
                                     f"the nf4 kernel {launches} times, {nf4_in_replay} in one "
                                     f"replay; want {per_forward} a forward")
            generation.release_captured(model)
            del model, cache, out, eager
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return lines


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
    libraries = ("paged_decode", "flash_attention", "fused_ce", "nf4_matmul")
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
    flash_log = _build.build_log("flash_attention")
    for phase, found in (("build_flash_forward", forward_resources(flash_log)),
                         ("build_flash_dq", dq_resources(flash_log)),
                         ("build_flash_dkv", dkv_resources(flash_log))):
        print(json.dumps({"phase": phase, "kernels": found}), flush=True)
        if any(k["spill_store_bytes"] or k["spill_load_bytes"] for k in found):
            raise AssertionError(f"{phase}: a kernel spills: {found}")
    from accelerate_tpu_torch.ops import fused_ce as fc

    found = fused_ce_bwd_resources(_build.build_log("fused_ce"))
    found_fwd = fused_ce_fwd_resources(_build.build_log("fused_ce"))
    print(json.dumps({"phase": "build_fused_ce", "kernels": found, "forward": found_fwd,
                      "launch_e768": {"dH": fc.bwd_plan(False, 768), "dW": fc.bwd_plan(True, 768)},
                      "forward_launch_by_splits": {s: fc.fwd_launch(s) for s in fc.FWD_SPLITS}}),
          flush=True)
    if len(found) != 8 or len(found_fwd) != 1 or any(
            k["spill_store_bytes"] or k["spill_load_bytes"] for k in found + found_fwd):
        raise AssertionError(f"build_fused_ce: a bf16 forward, dH or dW kernel is missing or spills: "
                             f"{found_fwd} {found}")
    for phase, found in (("build_paged_decode", paged_decode_resources(_build.build_log("paged_decode"))),
                         ("build_nf4", nf4_resources(_build.build_log("nf4_matmul")))):
        spilling = [k for k in found if k["spill_store_bytes"] or k["spill_load_bytes"]]
        if phase == "build_paged_decode":  # 65 instances: the register body's main one, and maxima
            summary = {"kernels": len(found),
                       "main": [k for k in found if (k["q"], k["pool"], k["d"], k["groups"])
                                == ("13__nv_bfloat16", "S1_", 64, 1)],
                       "max_registers_register_body": max(k["registers"] for k in found if k["d"]),
                       "max_registers_general_body": max(k["registers"] for k in found if not k["d"])}
        else:
            summary = {"kernels": found}
        print(json.dumps({"phase": phase, **summary, "spilling": spilling}), flush=True)
        if not found or spilling:
            raise AssertionError(f"{phase}: a kernel is missing or spills: {spilling}")

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
        # the general body: head_dims off 64 and 128, group counts off 1, 2, 4, 8
        kernel_case(torch, "d96_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 4, parked=(15,), **{**gpt2, "d": 96}),
        kernel_case(torch, "d256_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 5, parked=(15,), **{**gpt2, "hq": 16, "kvh": 16, "d": 256}),
        kernel_case(torch, "gqa3_6q_2kv_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 6, parked=(15,), **{**gpt2, "hq": 6, "kvh": 2}),
        kernel_case(torch, "gqa6_12q_2kv_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 7, parked=(15,), **{**gpt2, "hq": 12, "kvh": 2}),
        kernel_case(torch, "int8_pool_32q_8kv_d128", lengths=ragged, dtype=torch.bfloat16,
                    quant=True, seed=args.seed + 8, parked=(15,),
                    **{**gpt2, "hq": 32, "kvh": 8, "d": 128}),
    ]
    del flush
    torch.cuda.empty_cache()

    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.kv_cache import tree_nbytes
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

    # 4. fp32 slice: the graph engines == gather == generate, token for token
    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=args.seed)
    n_layer = model.config.n_layer
    fp32_prompts = prompts(8)

    def fp32_requests():
        return [Request(prompt=p, params=SamplingParams(max_new_tokens=32)) for p in fp32_prompts]

    gather = ServingEngine(model, paged_kv=True, paged_attention="gather", max_concurrency=8,
                           prompt_buckets=BUCKETS)
    gather_out = [o.tokens for o in gather.run(fp32_requests())]
    del gather
    solos = [generate(model, torch.tensor([p]), 32)[0].tolist() for p in fp32_prompts]
    fp32 = {"phase": "fp32_slice", "requests": len(fp32_prompts), "pipeline_depth": 2,
            "gather_equal_generate": gather_out == solos}
    for sync in (1, 4):
        # the slot-pool engine (the default): one replay a step, no kernel in it
        slot = ServingEngine(model, max_concurrency=8, prompt_buckets=BUCKETS, pipeline_depth=2,
                             tokens_per_sync=sync)
        slot_out = [o.tokens for o in slot.run(fp32_requests())]
        fp32[f"slot_k{sync}"] = {"tokens_equal_generate": slot_out == solos,
                                 "tokens_equal_paged_gather": slot_out == gather_out,
                                 "decode_steps": slot.metrics.decode_steps.value,
                                 "decode_replays": slot.metrics.decode_dispatches.value,
                                 "graph_launches": slot.graph_launches}
        if slot_out != solos or slot._graph is None or any(slot.graph_launches.values()):
            raise AssertionError(f"fp32 slot engine (tokens_per_sync {sync}): streams differ from "
                                 f"generate's, or no graph, or kernels in it: {fp32}")
        del slot
        fused = ServingEngine(model, paged_kv=True, paged_attention="fused", max_concurrency=8,
                              prompt_buckets=BUCKETS, pipeline_depth=2, tokens_per_sync=sync)
        paged_decode_attention.launches = 0
        fused_out = [o.tokens for o in fused.run(fp32_requests())]
        steps = fused.metrics.decode_steps.value
        launches = replay_launches(fused, "paged_decode_attention", paged_decode_attention.launches)
        in_replay = graph_kernels(torch, fused, "paged_decode_kernel")
        fp32[f"k{sync}"] = {"tokens_equal_generate": fused_out == solos, "decode_steps": steps,
                            "decode_replays": fused.metrics.decode_dispatches.value,
                            "launches": launches, "launches_expected": n_layer * steps,
                            "paged_kernels_in_one_replay": in_replay,
                            "expected_in_one_replay": n_layer * sync}
        if fused_out != solos:
            raise AssertionError(f"fp32 graph engine (tokens_per_sync {sync}) streams differ "
                                 "from generate's")
        if launches != n_layer * steps or steps == 0:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"{n_layer * steps}")
        if in_replay != n_layer * sync:
            raise AssertionError(f"one replay ran {in_replay} paged-decode kernels, not "
                                 f"n_layer x tokens_per_sync = {n_layer * sync}")
        del fused
    print(json.dumps(fp32), flush=True)
    if gather_out != solos:
        raise AssertionError("fp32 token streams differ between the gather engine and generate")
    if any(len(t) != 32 for t in solos):
        raise AssertionError("an fp32 request did not emit its 32 tokens")
    del model
    gc.collect()
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

    def engine(depth=2, sync=1):
        return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                             paged_attention="fused", max_concurrency=16, prompt_buckets=BUCKETS,
                             pipeline_depth=depth, tokens_per_sync=sync)

    engine().run(bf16_requests()[:4])  # warm-up: cuBLAS handles, allocator pools
    streams, lines = {}, {}
    for depth, sync in ((1, 1), (2, 1), (2, 4)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the engine's pool, buffers and graph count
        eng = engine(depth, sync)
        admissions = count_admissions(eng)
        reset_counts(fa)
        t0 = time.perf_counter()
        outs = eng.run(bf16_requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = replay_launches(eng, "paged_decode_attention", paged_decode_attention.launches)
        steps = eng.metrics.decode_steps.value
        line = serving_line(eng, outs, wall, launches, torch.cuda.max_memory_allocated(), card,
                            max_new_tokens=64, admission_forwards=admissions[0],
                            admission_host_s=admissions[1],
                            admission_share_of_wall=admissions[1] / wall,
                            flash_launches=flash_counts(fa),
                            first_step_logit_max_abs_diff=logit_err, logit_atol=BF16_LOGIT_ATOL)
        print(json.dumps(line), flush=True)
        bad = [o.request_id for o in outs
               if o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64]
        if bad:
            raise AssertionError(f"requests {bad} did not finish with 64 tokens")
        if launches != n_layer * steps or steps == 0:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"{n_layer * steps}")
        streams[(depth, sync)], lines[(depth, sync)] = [o.tokens for o in outs], line
        del eng
    if not streams[(1, 1)] == streams[(2, 1)] == streams[(2, 4)]:
        raise AssertionError("bf16 streams differ across (depth, tokens_per_sync) (1, 1), (2, 1), "
                             "(2, 4)")
    serving = lines[(2, 1)]
    # the slot-pool engine (the default) at (2, 1): no kernel on its decode path
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slot = ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS, pipeline_depth=2)
    admissions = count_admissions(slot)
    reset_counts(fa)
    t0 = time.perf_counter()
    outs = slot.run(bf16_requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slot_streams = [o.tokens for o in outs]
    line = serving_line(slot, outs, wall, replay_launches(slot, "paged_decode_attention",
                                                          paged_decode_attention.launches),
                        torch.cuda.max_memory_allocated(), card, phase="bf16_serving_slot",
                        max_new_tokens=64, admission_forwards=admissions[0],
                        admission_host_s=admissions[1], admission_share_of_wall=admissions[1] / wall,
                        streams_equal_fused=sum(a == b for a, b in zip(slot_streams,
                                                                       streams[(2, 1)])),
                        kv_cache_bytes=tree_nbytes(slot._cache))
    print(json.dumps(line), flush=True)
    if any(o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64 for o in outs):
        raise AssertionError("bf16 slot engine: a request did not finish with 64 tokens")
    if line["kernel_launches"] or slot.metrics.decode_steps.value == 0:
        raise AssertionError(f"bf16 slot engine ran {line['kernel_launches']} paged kernels")
    del slot
    long_requests = [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
                     for p in serve_prompts[:16]]
    for depth, sync, steps in ((1, 1, 16), (2, 1, 16), (2, 4, 8)):
        print(json.dumps(profile_decode(torch, engine(depth, sync), long_requests, steps=steps)),
              flush=True)
    print(json.dumps(profile_decode(
        torch, ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS, pipeline_depth=2),
        long_requests, phase="bf16_decode_profile_slot")), flush=True)
    del model
    gc.collect()
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
        fused_ce_case(torch, "mistral_head_e4096_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 5, **{**head, "v": 32000, "e": 4096}),
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

    # 12. band flash kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    band_common = dict(flush=flush, card=card)
    band_cases = [
        band_case(torch, "mistral_bf16_w4096", b=1, hq=32, hkv=8, s=8192, d=128, window=4096,
                  dtype=torch.bfloat16, seed=args.seed, by_group=True, rms_tol=BAND_MAIN_RMS_TOL,
                  **band_common),
        band_case(torch, "gpt2_small_bf16_triangle", b=8, hq=12, hkv=12, s=1024, d=64,
                  window=None, dtype=torch.bfloat16, seed=args.seed + 1, rect=True, **band_common),
        band_case(torch, "ragged_fp32_w100_g4", b=2, hq=4, hkv=1, s=1000, d=64, window=100,
                  dtype=torch.float32, seed=args.seed + 2, **band_common),
        band_case(torch, "window1_bf16", b=1, hq=8, hkv=8, s=512, d=128, window=1,
                  dtype=torch.bfloat16, seed=args.seed + 3, **band_common),
        band_case(torch, "window_ge_seq_fp32_g2", b=1, hq=4, hkv=2, s=1024, d=128, window=2048,
                  dtype=torch.float32, seed=args.seed + 4, rect=True, **band_common),
    ]
    del flush
    torch.cuda.empty_cache()

    # 13. fp32 Llama train-step parity, band kernels against plain attention
    llama_band_parity(torch, np, args.seed, card)

    # 14. bf16 training of the Mistral-7B-width model: this slice's path
    mistral = train_mistral(torch, np, args.seed, card)

    # 15. nf4 kernel against its plain version
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    nf4_cases = [nf4_case(torch, f"llama7b_{K}x{N}_m{M}_bf16", M=M, K=K, N=N,
                          dtype=torch.bfloat16, seed=args.seed + i, flush=flush)
                 for i, (K, N) in enumerate(LLAMA_NF4_SHAPES) for M in (1, 16)]
    gpt2_nf4 = [nf4_case(torch, f"gpt2_{K}x{N}_m{M}_bf16", M=M, K=K, N=N, dtype=torch.bfloat16,
                         seed=args.seed + i, flush=flush)
                for i, (K, N) in enumerate(GPT2_NF4_SHAPES) for M in (16, 512)]
    nf4_cases += gpt2_nf4 + [
        nf4_case(torch, "gpt2_768x2304_m16_fp32", M=16, K=768, N=2304, dtype=torch.float32,
                 seed=args.seed, flush=flush),
        nf4_case(torch, "lead_2x8_768x3072_bf16", M=16, K=768, N=3072, dtype=torch.bfloat16,
                 seed=args.seed, flush=flush, lead=(2,)),
        nf4_case(torch, "unsupported_n192_fp32", M=16, K=768, N=192, dtype=torch.float32,
                 seed=args.seed, flush=flush),
    ]
    del flush
    torch.cuda.empty_cache()

    # 16. fp32 quantized-serving parity
    quant_parity(torch, args.seed, fp32_prompts)

    # 17. bf16 quantized serving: this slice's path; then KV capacity
    quant = quant_serving(torch, args.seed, bf16_requests,
                          lambda: [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
                                   for p in serve_prompts[:16]], card)
    kv_capacity(torch, np, args.seed, card)

    # 18. Llama decode parity at Llama-2-7B's width, 2 layers, fp32
    llama_decode_parity(torch, np, args.seed, card)

    # 19. big-model inference: the reference tool's flow at Llama-2-7B
    big_model_inference(torch, card)

    # 20. summary lines
    main_case = cases[0]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "accelerate_tpu/ops/flash_attention.py:734",
        "launches": serving["kernel_launches"], "max_abs_err": max(c["max_abs_err"] for c in cases),
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
    nf4_main = next(c for c in gpt2_nf4 if c["K"] == 768 and c["N"] == 3072 and c["M"] == 16)
    kernels.append({
        "name": "nf4_matmul", "route": "cuda", "source": "accelerate_tpu_torch/ops/csrc/nf4_matmul.cu",
        "replaces": NF4_REPLACES, "launches": quant["nf4_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in nf4_cases),
        "ms": nf4_main["kernel_ms"], "plain_ms": nf4_main["plain_ms"],
        "bound_ms": nf4_main["bound_ms"], "bound_by": nf4_main["bound_by"],
        # no PyTorch call computes x @ dequantize_nf4(W); the dense bf16
        # product, another function, stands in the nf4_kernels lines
        "library_ms": None,
    })
    for kname, replaces in BAND_REPLACES.items():
        main_rec = band_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": mistral["launches"][kname],
            "max_abs_err": max(c[kname]["max_abs_err"] for c in band_cases),
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
