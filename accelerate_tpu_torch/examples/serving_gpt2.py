"""GPT-2 continuous-batching serving, the port of the reference's
`examples/serving_gpt2.py`: six ragged requests with their own sampling
settings (greedy and seeded sampling side by side) stream through the
`serving.ServingEngine`'s decode step over a fixed pool of four slots, and
the engine's metrics go to a `tracking.JSONLTracker` every 8 steps.

The default is the reference's demo: `GPT2Config.tiny` at fp32 with seeded
random weights. A deployment passes ``GPT2Config.small()`` (real weights
load through `models.gpt2.params_from_hf_gpt2`) and the engine's paged pool
with the decode-attention kernel, ``paged_kv=True,
paged_attention="fused"``, which ``main``'s ``**engine_kwargs`` forward.

Run:
    python -m accelerate_tpu_torch.examples.serving_gpt2
    python -m accelerate_tpu_torch.examples.serving_gpt2 --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any

import numpy as np
import torch

from ..models.gpt2 import GPT2Config, GPT2LMHead
from ..serving import Request, SamplingParams, ServingEngine
from ..tracking import JSONLTracker

# the reference's engine settings
ENGINE_SETTINGS = dict(
    max_concurrency=4,        # decode batch width == resident requests
    prompt_buckets=(16, 32),  # admission pad targets
    eos_token_id=0,           # recycle a slot early on this token
    metrics_log_every=8,
)
# (prompt length, sampling settings) of the reference's six requests
REQUESTS = (
    (5, dict(max_new_tokens=12)),
    (11, dict(temperature=0.8, top_k=20, seed=7, max_new_tokens=20)),
    (23, dict(temperature=1.0, seed=123, max_new_tokens=8)),
    (8, dict(max_new_tokens=30)),
    (17, dict(temperature=0.6, top_k=10, seed=1, max_new_tokens=16)),
    (3, dict(max_new_tokens=6)),
)


def make_requests(vocab_size: int) -> list[Request]:
    """The reference's six requests: prompts drawn from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, vocab_size, (n,)).astype(np.int32).tolist(),
                    params=SamplingParams(**settings))
            for n, settings in REQUESTS]


def make_engine(config: GPT2Config | None = None, device: str | torch.device | None = None,
                logging_dir: str | None = None, model: GPT2LMHead | None = None,
                **engine_kwargs: Any) -> tuple[ServingEngine, JSONLTracker]:
    """The example's engine and its metrics tracker. ``device=None`` means
    CUDA; ``model`` (loaded weights) replaces the one drawn from seed 0, as
    the reference's key 0; ``engine_kwargs`` override the engine's settings."""
    if model is None:
        model = GPT2LMHead(config if config is not None else GPT2Config.tiny(dtype=torch.float32),
                           device=device, seed=0)
    tracker = JSONLTracker("serving_demo", logging_dir=logging_dir or tempfile.gettempdir())
    engine = ServingEngine(model, device=model.device, tracker=tracker,
                           **{**ENGINE_SETTINGS, **engine_kwargs})
    return engine, tracker


def serve(engine: ServingEngine, tracker: JSONLTracker, quiet: bool = False) -> list:
    """Run the six requests to completion; prints each and the metrics."""
    outputs = engine.run(make_requests(engine.model.config.vocab_size))
    if not quiet:
        for out in outputs:
            print(f"req {out.request_id}: prompt_len={out.prompt_len:2d} "
                  f"-> {len(out.tokens):2d} tokens ({out.finish_reason}): "
                  f"{out.tokens[:8]}{'...' if len(out.tokens) > 8 else ''}")
        m = engine.metrics
        print(f"\n{m.requests_finished.value} requests, "
              f"{m.tokens_generated.value} tokens in {m.steps.value} steps; "
              f"mean slot occupancy {m.slot_occupancy.mean:.0%}; "
              f"metrics stream: {tracker.path}")
    return outputs


def main(config: GPT2Config | None = None, device: str | torch.device | None = None,
         logging_dir: str | None = None, quiet: bool = False,
         model: GPT2LMHead | None = None, **engine_kwargs: Any) -> dict[str, Any]:
    """`make_engine`, then `serve`; returns ``{"outputs", "engine",
    "tracker"}``."""
    engine, tracker = make_engine(config, device, logging_dir, model, **engine_kwargs)
    return {"outputs": serve(engine, tracker, quiet), "engine": engine, "tracker": tracker}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GPT-2 continuous-batching serving demo")
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    p.add_argument("--logging_dir", default=None, help="where the metrics stream goes "
                   "(default: the temporary directory)")
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    main(device=args.device, logging_dir=args.logging_dir)
