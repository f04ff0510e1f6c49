"""Feature: profiling (the reference's `by_feature/profiler.py`).

``accelerator.profile()`` wraps ``torch.profiler``: host activity, and the
CUDA kernels on the card, written as a Chrome trace (open it in
ui.perfetto.dev). One epoch runs first to warm up, outside the trace.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.profiler --tiny --project_dir DIR
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from ...accelerator import Accelerator
from ...data_loader import DataLoaderShard
from ...utils.random import set_seed
from ._common import base_parser, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    args = base_parser(num_epochs=1).parse_args(argv)
    set_seed(args.seed)
    trace_dir = args.project_dir or tempfile.mkdtemp(prefix="profile_traces_")
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    n_train = 4 if args.tiny else 8
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)))
    step = accelerator.make_train_step(loss_fn)

    for batch in train_dl:  # warm-up, outside the trace
        loss = step(batch)
    with accelerator.profile(log_dir=trace_dir):
        for batch in train_dl:
            loss = step(batch)

    traces = sorted(str(p) for p in Path(trace_dir).rglob("*.json"))
    accelerator.print(f"loss={float(loss):.4f}; wrote {len(traces)} trace files under "
                      f"{trace_dir} (open them in ui.perfetto.dev)")
    return {"loss": float(loss), "traces": traces}


if __name__ == "__main__":
    main()
