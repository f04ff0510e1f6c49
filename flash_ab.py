#!/usr/bin/env python3
"""Time the port's bf16 flash and fused-CE kernels of one source tree on the
GPU, for A/B comparisons of two trees in one run on one card.

Each run imports ``accelerate_tpu_torch`` from ``--tree`` (default: this
checkout), builds its kernels there, and prints one JSON line: the card's
name and power limit and each kernel's median device ms (CUDA events, L2
flushed before each launch), at the shapes ``chip_smoke.py`` holds as main:
the rect kernels at GPT-2 small's training shape (b 8, h 12, s 1024, d 64,
causal; dQ and dK/dV also full and at d 128), the band kernels at Mistral-7B's
width (b 1, hq 32, hkv 8, s 8192, d 128, window 4096), and the fused-CE dH and
dW kernels and the forward at GPT-2 small's head (N 8192, V 50257, e 768,
every sixteenth row ignored), and the serving kernels: paged decode at
``chip_smoke.py``'s main case (GPT-2 small, 16 rows of ragged length up to
1024, bf16) and the nf4 dequant-matmul at GPT-2 small's ``up`` projection
(768 x 3072) at M 16 and 512 and Llama-7B's 4096 x 4096 at M 1 and 16 and
4096 x 32000 at M 1. To
compare a change with its parent, unpack the parent into a directory
``.gitignore`` lists and alternate within one call::

    for t in .archive/parent . . .archive/parent; do python3 flash_ab.py --tree $t; done

``--probe serving`` times the serving kernels alone (a quick A/B of them).
``--probe engine`` serves ``chip_smoke.py`` phase 5's traffic (bf16 GPT-2
small, 48 requests of 16..700 prompt tokens and 64 new ones, every second
sampled, 16 slots) through the tree's fused engine after a 4-request
warm-up: one line per engine setting the tree takes (``pipeline_depth`` and
``tokens_per_sync`` (1, 1), (2, 1) and (2, 4) where it has them, else the
engine at depth 1) with tokens/s, the host wall per decode forward, TTFT
and ITL p50/p99, peak memory, and a hash of every token stream, which must
agree across trees and settings.
``--probe decode`` admits 16 of that traffic's requests into the tree's
fused engine at (2, 1) and profiles 32 replays of its captured decode graph
alone (no host bookkeeping between them): device us per replay, by kernel
name too, and the kernels a replay runs; run in turns with the parent, it
shows what a change adds to the decode step's device work (the health flag).
``--probe fwd`` times the fused-CE forward alone at ``chip_smoke.py``'s
bf16 cases: GPT-2 small's head (N 8192, V 50257, e 768), a ragged N 1000,
e 1024, and Mistral-7B's untied head (N 8192, V 32000, e 4096); where the
tree has the vocab-split plan, also at every split count the case can take
(``fwd_s<splits>``), beside the clusters of each size the card holds.
``--probe resnet`` times 10 bf16 ResNet-50 training steps at batch 128
(224 x 224, SGD with momentum, after 2 warm-up steps) four times in turns,
with the model's convolution weights as it builds them (channels_last) and
moved to NCHW memory: channels_last, NCHW, NCHW, channels_last, one line
each with the step's ms and images/s.
``--probe widths`` and ``--probe precision`` look at the fused-CE dH and dW
alone, on inputs drawn as
``tests/test_torch_cuda_kernels.py`` draws them: ``--probe widths`` prints
their median ms at N 8192 and V 50257 for e 768 and e 1024 (GPT-2 medium).
``--probe precision`` prints one line per shape (e 768 to 4096): for dH and
dW, the elements past the ``cuda`` tests' bar ``1e-2 |plain| + 1e-3
max|plain|`` and the worst error over its bar, the same for dH built from
two other summation orders of the fp32 logits (64 columns at a time in
reverse, and PyTorch's bf16 product with fp32 output), and the fused-CE
forward kernel's lse error. A variant of a kernel constant (cluster size,
ring depth) is a copied tree with the constant edited, run in turns with
the tree itself.

One tree per process: two copies of the package cannot share one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--probe", choices=("serving", "engine", "decode", "fwd", "widths",
                                            "precision", "resnet"),
                        default=None,
                        help="the serving kernels alone, the serving engine, its decode "
                             "graph alone, the fused-CE forward alone, or the fused-CE dH and "
                             "dW alone, or a ResNet-50 step by weight layout (default: the A/B "
                             "timing of every kernel)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    if not (tree / "accelerate_tpu_torch").is_dir():
        print(f"flash_ab: no accelerate_tpu_torch/ under {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False

    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 64 MiB > L2

    def ms(fn, samples: int = 30, cold: bool = True) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(samples):
            if cold:  # else the inputs stay in L2 from the run before
                flush.zero_()
            torch.cuda._sleep(2_000_000)  # keep the stream busy while the host enqueues
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def inputs(g, b, hq, hkv, s, d):
        q = (torch.randn(b, hq, s, d, generator=g, device="cuda") / math.sqrt(d)).bfloat16()
        k, v = (torch.randn(b, hkv, s, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        dout = torch.randn(b, hq, s, d, generator=g, device="cuda").bfloat16()
        return q, k, v, dout

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": str(tree), "card": card.splitlines()[0]}
    if args.probe == "serving":
        serving(res, g, ms)
        print(json.dumps(res), flush=True)
    elif args.probe == "engine":
        for rec in probe_engine(torch):
            print(json.dumps({**res, **rec}), flush=True)
    elif args.probe == "decode":
        print(json.dumps({**res, **probe_decode(torch)}), flush=True)
    elif args.probe == "fwd":
        print(json.dumps({**res, **probe_fwd(torch, ms)}), flush=True)
    elif args.probe == "widths":
        print(json.dumps({**res, **probe_widths(torch, ms)}), flush=True)
    elif args.probe == "precision":
        for rec in probe_precision(torch):
            print(json.dumps({**res, **rec}), flush=True)
    elif args.probe == "resnet":
        for layout in ("channels_last", "nchw", "nchw", "channels_last"):
            print(json.dumps({**res, **probe_resnet(torch, layout)}), flush=True)
    else:
        flash(res, g, ms, inputs)
        fused_ce(res, g, ms)
        serving(res, g, ms)
        print(json.dumps(res), flush=True)
    return 0


def flash(res: dict, g, ms, inputs) -> None:
    """The rect kernels at GPT-2 small's shape and the band kernels at
    Mistral-7B's width, into ``res``."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    for d in (64, 128):
        q, k, v, dout = inputs(g, 8, 12, 12, 1024, d)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        delta = (dout.float() * o.float()).sum(-1)
        bwd = (q, k, v, dout, lse, delta)
        if d == 64:
            res["rect_fwd"] = ms(lambda: fa.flash_attention_fwd(q, k, v, True))
            res["rect_dq"] = ms(lambda: fa.flash_attention_dq(*bwd, True))
            res["rect_dq_full"] = ms(lambda: fa.flash_attention_dq(*bwd, False))
            res["rect_dkv"] = ms(lambda: fa.flash_attention_dkv(*bwd, True))
            res["rect_dkv_full"] = ms(lambda: fa.flash_attention_dkv(*bwd, False))
        else:
            res["rect_dq_d128"] = ms(lambda: fa.flash_attention_dq(*bwd, True))
            res["rect_dkv_d128"] = ms(lambda: fa.flash_attention_dkv(*bwd, True))
    window = 4096
    q, k, v, dout = inputs(g, 1, 32, 8, 8192, 128)
    o, lse = fa.flash_band_fwd(q, k, v, window)
    bwd = (q, k, v, dout, lse, (dout.float() * o.float()).sum(-1), window)
    res["band_fwd"] = ms(lambda: fa.flash_band_fwd(q, k, v, window), 10)
    res["band_dq"] = ms(lambda: fa.flash_band_dq(*bwd), 10)
    res["band_dkv"] = ms(lambda: fa.flash_band_dkv(*bwd), 10)


def head_inputs(g, n, v, e):
    """h, w, safe labels and the mean loss's g_lse, as ``chip_smoke.py``'s
    fused-CE cases draw them (w at GPT-2's init scale, every sixteenth row
    ignored)."""
    import torch

    h = torch.randn(n, e, generator=g, device="cuda").bfloat16()
    w = (torch.randn(v, e, generator=g, device="cuda") * 0.02).bfloat16()
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    labels[torch.arange(n, device="cuda") % 16 == 15] = -100
    mask = labels != -100
    return h, w, torch.where(mask, labels, 0).to(torch.int32), mask.float() / mask.sum()


def fused_ce(res: dict, g, ms) -> None:
    """The fused-CE forward, dH and dW at GPT-2 small's head, as
    ``chip_smoke.py``'s main fused-CE case draws it, into ``res``."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    h, w, safe, g_lse = head_inputs(g, 8192, 50257, 768)
    lse, _ = fc.fused_ce_fwd(h, w, safe)
    bwd = (h, w, safe, lse, g_lse, -g_lse)
    res["fused_ce_fwd"] = ms(lambda: fc.fused_ce_fwd(h, w, safe), 10)
    res["fused_ce_dh"] = ms(lambda: fc.fused_ce_dh(*bwd), 10)
    res["fused_ce_dw"] = ms(lambda: fc.fused_ce_dw(*bwd), 10)


def serving(res: dict, g, ms) -> None:
    """Paged decode at ``chip_smoke.py``'s main case (also with its inputs
    left in L2, and with every row at 1024 tokens) and the nf4 kernel at
    GPT-2's ``up`` projection and Llama-7B's 4096 x 4096 and 4096 x 32000
    (M 1 also warm), into ``res``, beside the floor of the timing itself
    (one tiny elementwise kernel)."""
    import torch

    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention
    from accelerate_tpu_torch.ops.nf4_matmul import nf4_matmul
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    b, h, d, bt, bps = 16, 12, 64, 16, 64
    lengths = [1, 15, 16, 17, 100, 255, 256, 257, 511, 512, 640, 767, 900, 1023, 1024, 40]
    num_blocks = b * bps + 8
    q = torch.randn(b, h, d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(num_blocks, bt, h, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    tables = torch.randperm(num_blocks, generator=g, device="cuda")[: b * bps].reshape(b, bps).int()
    for i, n in enumerate(lengths):
        tables[i, -(-n // bt):] = num_blocks
    tables[15] = num_blocks
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    # the timing's floor: the same events around one tiny PyTorch kernel
    tiny = torch.zeros(16, device="cuda")
    res["floor_tiny_add"] = ms(lambda: tiny.add_(1.0))
    res["paged_decode_gpt2_bf16"] = ms(lambda: paged_decode_attention(q, k, v, tables, lens))
    res["paged_decode_gpt2_bf16_warm"] = ms(lambda: paged_decode_attention(q, k, v, tables, lens),
                                            cold=False)
    full = torch.full_like(lens, bps * bt)
    whole = torch.randperm(num_blocks, generator=g, device="cuda")[: b * bps].reshape(b, bps).int()
    res["paged_decode_all_1024"] = ms(lambda: paged_decode_attention(q, k, v, whole, full))
    for name, M, K, N in (("nf4_gpt2_up_m16", 16, 768, 3072), ("nf4_gpt2_up_m512", 512, 768, 3072),
                          ("nf4_llama_4096_m1", 1, 4096, 4096), ("nf4_llama_4096_m16", 16, 4096, 4096),
                          ("nf4_llama_4096x32000_m1", 1, 4096, 32000)):
        qt = quantize(torch.randn(K, N, generator=g, device="cuda") / math.sqrt(K),
                      QuantizationConfig(load_in_4bit=True, quant_type="nf4",
                                         compute_dtype=torch.float32))
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        res[name] = ms(lambda: nf4_matmul(x, qt))
        if name == "nf4_llama_4096_m1":
            res[name + "_warm"] = ms(lambda: nf4_matmul(x, qt), cold=False)


def probe_engine(torch) -> list[dict]:
    """`ServingEngine` end to end at ``chip_smoke.py`` phase 5's traffic, one
    record per engine setting the tree takes."""
    import gc
    import hashlib
    import inspect
    import time

    import numpy as np

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import PagedKVConfig, Request, SamplingParams, ServingEngine

    model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                       device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, 48)]

    def requests():
        return [Request(prompt=p, params=SamplingParams(
                    max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                    top_k=50 if i % 2 else None, seed=i))
                for i, p in enumerate(prompts)]

    overlapped = "tokens_per_sync" in inspect.signature(ServingEngine.__init__).parameters
    settings = ((1, 1), (2, 1), (2, 4)) if overlapped else ((1, 1),)

    def engine(depth, sync):
        kw = dict(tokens_per_sync=sync) if overlapped else {}
        return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                             paged_attention="fused", max_concurrency=16,
                             prompt_buckets=(64, 128, 256, 512, 768), pipeline_depth=depth, **kw)

    engine(*settings[0]).run(requests()[:4])  # warm-up: cuBLAS handles, allocator pools
    records = []
    for depth, sync in settings:
        gc.collect()  # an engine sits in a reference cycle: free the last one's pool and graph
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = engine(depth, sync)
        t0 = time.perf_counter()
        outs = eng.run(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = eng.metrics
        streams = json.dumps([o.tokens for o in outs]).encode()
        records.append({
            "probe": "engine", "pipeline_depth": depth, "tokens_per_sync": sync,
            "tokens_per_s": m.tokens_generated.value / wall, "wall_s": wall,
            "decode_steps": m.decode_steps.value,
            "wall_ms_per_decode_step": wall * 1e3 / m.decode_steps.value,
            "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
            "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "streams_sha1": hashlib.sha1(streams).hexdigest()})
        del eng
    return records


def probe_decode(torch, replays: int = 32) -> dict:
    """The fused engine's captured decode step at (2, 1) with 16 slots live
    (``probe_engine``'s model and prompts, 64 new tokens each): ``replays``
    replays of the graph alone in a profiler window, device us per replay
    in all and by kernel name, and kernels per replay."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import PagedKVConfig, Request, SamplingParams, ServingEngine

    model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                       device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, 48)]
    engine = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16), paged_attention="fused",
                           max_concurrency=16, prompt_buckets=(64, 128, 256, 512, 768),
                           pipeline_depth=2)
    for p in prompts[:16]:
        engine.submit(Request(prompt=p, params=SamplingParams(max_new_tokens=64)))
    engine.step()  # admits all 16 and dispatches the first decode step
    for _ in range(3):
        engine._graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            engine._graph.replay()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    count = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name[:90]] = by_name.get(ev.name[:90], 0.0) + ev.time_range.elapsed_us()
            count += 1
    return {"probe": "decode", "replays": replays, "slots": engine.active_slots,
            "device_us_per_replay": sum(by_name.values()) / replays,
            "kernels_per_replay": count / replays,
            "kernels_us_per_replay": {n: us / replays for n, us in
                                      sorted(by_name.items(), key=lambda kv: -kv[1])}}


def probe_resnet(torch, weights: str, batch: int = 128, steps: int = 10) -> dict:
    """``steps`` bf16 ResNet-50 training steps at ``batch`` after 2 warm-up
    steps, the convolution weights channels_last as the model builds them
    or moved to NCHW memory: the step's host wall in ms (ending in a
    synchronize) and images/s."""
    import gc
    import time

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig, image_classification_loss_fn

    acc = Accelerator(mixed_precision="bf16")
    module = ResNet(ResNetConfig.resnet50(), seed=0)
    if weights == "nchw":
        module.to(memory_format=torch.contiguous_format)
    model = acc.prepare(module)
    acc.prepare(torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9))
    step = acc.make_train_step(image_classification_loss_fn)
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {"image": torch.randn(batch, 224, 224, 3, device="cuda", generator=g),
            "label": torch.randint(0, 1000, (batch,), device="cuda", generator=g)}
    for _ in range(2):
        step(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(data) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"probe": "resnet", "weights": weights, "batch": batch, "steps": steps,
           "step_ms": wall / steps * 1e3, "images_per_s": batch * steps / wall,
           "last_loss": losses[-1].item()}
    del acc, model, step, data, losses
    gc.collect()
    torch.cuda.empty_cache()
    return rec


FWD_SHAPES = {"gpt2_small": (8192, 50257, 768), "ragged_n1000": (1000, 50257, 768),
              "e1024": (8192, 50257, 1024), "mistral_head_e4096": (8192, 32000, 4096)}


def probe_fwd(torch, ms) -> dict:
    """The fused-CE forward's median ms at FWD_SHAPES; where the tree has
    the vocab-split plan, its plan and the kernel at every split count the
    case can take (the C entry called directly with that count)."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    res = {}
    split = hasattr(fc, "fwd_plan")
    if split:
        res["resident_clusters"] = fc.card_limits(torch.cuda.current_device())
    for name, (n, v, e) in FWD_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        h, w, safe, _ = head_inputs(g, n, v, e)
        res[f"fwd_{name}"] = ms(lambda: fc.fused_ce_fwd(h, w, safe), 10)
        if split:
            plan = fc.fwd_plan(n, v, fc.card_limits(torch.cuda.current_device()))
            res[f"plan_{name}"] = plan
            lse, ll = (torch.empty(n, device="cuda") for _ in range(2))
            for k in fc.FWD_SPLITS:
                if k <= plan["vocab_tiles"]:
                    res[f"fwd_{name}_s{k}"] = ms(lambda: fc._run(
                        "fused_ce_fwd", h.data_ptr(), w.data_ptr(), safe.data_ptr(),
                        lse.data_ptr(), ll.data_ptr(), h=h, v=v, extra=(k,)), 10)
        del h, w
    return res


def probe_inputs(torch, n, v, e, seed=0):
    """h, w, labels, g_lse, g_ll as the ``cuda`` tests draw them: w at 0.05,
    every eighth row ignored, the mean loss's gradients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, e, generator=g, device="cuda").bfloat16()
    w = (torch.randn(v, e, generator=g, device="cuda") * 0.05).bfloat16()
    labels = torch.randint(0, v, (n,), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.arange(n, device="cuda") % 8 != 3
    labels = torch.where(mask, labels, 0)
    g_lse = mask.float() / mask.sum()
    return h, w, labels, g_lse, -g_lse


def probe_widths(torch, ms) -> dict:
    """dH and dW ms at N 8192, V 50257, e 768 and 1024."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    res = {}
    for e in (768, 1024):
        h, w, labels, g_lse, g_ll = probe_inputs(torch, 8192, 50257, e)
        lse, _ = fc.fused_ce_forward_reference(h, w, labels)
        args = (h, w, labels, lse, g_lse, g_ll)
        res[f"dh_e{e}"] = ms(lambda: fc.fused_ce_dh(*args), 10)
        res[f"dw_e{e}"] = ms(lambda: fc.fused_ce_dw(*args), 10)
        del h, w, args
    return res


PROBE_SHAPES = ((130, 300, 4096), (130, 700, 4096), (300, 1000, 768), (100, 300, 1280),
                (256, 640, 1024))


def probe_precision(torch) -> list[dict]:
    """dH and dW against the ``cuda`` tests' bar, beside dH from two other
    summation orders of the logits, at PROBE_SHAPES."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    def over_bar(got, want) -> dict:
        diff = (got.float() - want.float()).abs()
        bar = 1e-2 * want.float().abs() + 1e-3 * want.float().abs().max()
        return {"n_over": int((diff > bar).sum()),
                "max_ratio": float((diff / bar.clamp(min=1e-30)).max()),
                "max_err": float(diff.max()), "max_want": float(want.float().abs().max())}

    def dh_from_logits(logits, h, w, labels, lse, g_lse, g_ll):
        dl = g_lse[:, None] * torch.exp(logits - lse[:, None])
        idx, valid = fc._label_index(labels, w.shape[0])
        rows = torch.arange(h.shape[0], device="cuda")
        dl = dl.index_put_((rows, idx), torch.where(valid, g_ll, 0.0), accumulate=True)
        return (dl.to(torch.bfloat16).float() @ w.float()).to(torch.bfloat16)

    out = []
    for n, v, e in PROBE_SHAPES:
        h, w, labels, g_lse, g_ll = probe_inputs(torch, n, v, e)
        lse, _ = fc.fused_ce_forward_reference(h, w, labels)
        args = (h, w, labels, lse, g_lse, g_ll)
        want_h = fc.fused_ce_dh_reference(*args)
        rec = {"n": n, "v": v, "e": e,
               "lse_fwd_kernel_err": float((fc.fused_ce_fwd(h, w, labels)[0] - lse).abs().max()),
               "dh_kernel": over_bar(fc.fused_ce_dh(*args), want_h),
               "dw_kernel": over_bar(fc.fused_ce_dw(*args), fc.fused_ce_dw_reference(*args))}
        hf, wf = h.float(), w.float()
        plain = hf @ wf.T
        reverse = torch.zeros(n, v, device="cuda")
        for c in reversed(range(e // 64)):
            reverse += hf[:, 64 * c:64 * c + 64] @ wf[:, 64 * c:64 * c + 64].T
        tensor_core = torch.mm(h, w.T, out_dtype=torch.float32)
        for name, logits in (("reverse_chunks", reverse), ("bf16_product", tensor_core)):
            rec[f"{name}_logits_err"] = float((logits - plain).abs().max())
            rec[f"dh_{name}"] = over_bar(dh_from_logits(logits, h, w, labels, lse, g_lse, g_ll),
                                         want_h)
        out.append(rec)
    return out


if __name__ == "__main__":
    sys.exit(main())
