#!/usr/bin/env python3
"""Time the port's bf16 flash kernels of one source tree on the GPU, for A/B
comparisons of two trees in one run on one card.

Each run imports ``accelerate_tpu_torch`` from ``--tree`` (default: this
checkout), builds its kernels there, and prints one JSON line: the card's
name and power limit and each kernel's median device ms (CUDA events, L2
flushed before each launch), at the shapes ``chip_smoke.py`` holds as main:
the rect kernels at GPT-2 small's training shape (b 8, h 12, s 1024, d 64,
causal; dQ and dK/dV also full and at d 128) and the band kernels at Mistral-7B's
width (b 1, hq 32, hkv 8, s 8192, d 128, window 4096). To compare a change
with its parent, unpack the parent into a directory ``.gitignore`` lists and
alternate within one call::

    for t in .archive/parent . . .archive/parent; do python3 flash_ab.py --tree $t; done

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
    from accelerate_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 64 MiB > L2

    def ms(fn, samples: int = 30) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(samples):
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
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
