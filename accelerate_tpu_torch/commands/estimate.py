"""``estimate-memory``: a model's memory without its weights, the port of
`accelerate_tpu.commands.estimate`.

The reference's names (``gpt2``, ``gpt2-small``, ``gpt2-medium``,
``gpt2-large``) are counted from the port's `models.gpt2.GPT2LMHead` built
on the meta device (`big_modeling.init_empty_weights`): shapes, no storage.
Any other name goes through ``transformers`` when it is installed, from a
config already on this machine (``local_files_only``: nothing is
downloaded), else raises the reference's ValueError. The table and its
``--dtypes``, ``--fsdp`` and ``--tensor`` divisors are the reference's
arithmetic.
"""

from __future__ import annotations

import argparse

DTYPE_BYTES = {"float32": 4, "bf16": 2, "bfloat16": 2, "fp16": 2, "float16": 2, "int8": 1, "fp8": 1}
GPT2_SIZES = {"gpt2": "small", "gpt2-small": "small", "gpt2-medium": "medium",
              "gpt2-large": "large"}


def _fmt(nbytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if nbytes < 1024:
            return f"{nbytes:.2f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.2f} PB"


def estimate_parameters(model_name: str) -> int:
    """The parameter count of ``model_name`` (a tied weight counts once)."""
    if model_name in GPT2_SIZES:
        from ..big_modeling import init_empty_weights
        from ..models.gpt2 import GPT2Config, GPT2LMHead

        with init_empty_weights() as meta:
            model = meta.init(GPT2LMHead, getattr(GPT2Config, GPT2_SIZES[model_name])())
        return sum(p.numel() for p in model.parameters())
    try:
        import torch
        from transformers import AutoConfig, AutoModel

        cfg = AutoConfig.from_pretrained(model_name, local_files_only=True)
        with torch.device("meta"):
            model = AutoModel.from_config(cfg)
        return sum(p.numel() for p in model.parameters())
    except (ImportError, OSError, ValueError) as e:
        raise ValueError(f"Unknown model {model_name!r}: not an in-repo spec and transformers "
                         f"meta-load failed ({e})") from e


def estimate_command(args: argparse.Namespace) -> None:
    """The reference's table for each name in turn."""
    for name in args.model_name:
        _table(name, estimate_parameters(name), args)


def _table(model_name: str, n: int, args: argparse.Namespace) -> None:
    # fsdp shards params, grads and optimizer state; tensor shards params and
    # grads; per-device bytes divide by the sharding degree
    shard = max(1, args.fsdp) * max(1, args.tensor)
    rows = []
    for dtype in args.dtypes:
        b = DTYPE_BYTES[dtype]
        params = n * b
        # training ~= params + grads + adam (2x fp32 moments) + fp32 masters
        train = params + n * b + 2 * n * 4 + (n * 4 if b < 4 else 0)
        rows.append((dtype, _fmt(params), _fmt(train), _fmt(params / shard), _fmt(train / shard)))
    w = max(len(r[1]) for r in rows) + 2
    print(f"Model: {model_name} — {n:,} parameters")
    header = f"{'dtype':8} {'inference':>{w}} {'training (adam)':>{w+8}}"
    if shard > 1:
        header += f" {'per-chip inf':>{w+4}} {'per-chip train':>{w+6}}"
    print(header)
    for dtype, inf, train, pinf, ptrain in rows:
        line = f"{dtype:8} {inf:>{w}} {train:>{w+8}}"
        if shard > 1:
            line += f" {pinf:>{w+4}} {ptrain:>{w+6}}"
        print(line)
    if shard > 1:
        print(f"(sharded over fsdp={args.fsdp} x tensor={args.tensor} = {shard} chips; "
              "activations/KV cache not included)")


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("estimate-memory", help="estimate model memory usage")
    p.add_argument("model_name", nargs="+", help="one or more names")
    p.add_argument("--dtypes", nargs="+", default=["float32", "bf16"], choices=list(DTYPE_BYTES))
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp-axis degree: divide param/grad/optimizer bytes per device")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-axis degree: divide param/grad bytes per device")
    p.set_defaults(func=estimate_command)
