"""Prompt-sharded batch text generation, the port of the reference's
`examples/inference/distributed/batch_text_generation.py`: each process takes
its `split_between_processes` slice of the prompt list, decodes greedily with
`models.generation.generate` over the KV cache, and `gather_object`
reassembles every completion everywhere. Real weights load through
`models.gpt2.params_from_hf_gpt2`.

Run:
    python -m accelerate_tpu_torch.examples.inference.distributed.batch_text_generation
    python -m accelerate_tpu_torch.examples.inference.distributed.batch_text_generation --device cpu
"""

from __future__ import annotations

import argparse

import torch

from ....models.generation import generate
from ....models.gpt2 import GPT2Config, GPT2LMHead
from ....state import PartialState
from ....utils.operations import gather_object

PROMPTS = (
    [2, 3, 5, 7, 11, 13, 17, 19],
    [1, 2, 3, 4, 5, 6, 7, 8],
    [42, 42, 42, 42, 42, 42, 42, 42],
    [9, 8, 7, 6, 5, 4, 3, 2],
    [100, 101, 102, 103, 104, 105, 106, 107],
)


def run(args: argparse.Namespace) -> list[list[int]]:
    """The gathered completions, one per prompt (on every process)."""
    state = PartialState(args.device)
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device=state.device, seed=args.seed)

    completions = []
    with state.split_between_processes(list(PROMPTS)) as my_prompts:  # uneven over processes
        for prompt in my_prompts:
            ids = torch.tensor([prompt], device=state.device)
            out = generate(model, ids, max_new_tokens=args.max_new_tokens, device=state.device)
            completions.append(out[0].tolist())

    all_completions = gather_object(completions)
    if state.is_main_process:
        for i, toks in enumerate(all_completions):
            print(f"prompt {i}: +{toks}")
    return all_completions


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="greedy GPT-2 completions over process-sharded prompts")
    p.add_argument("--max_new_tokens", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return p


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
