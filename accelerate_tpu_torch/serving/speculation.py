"""Speculative-decoding drafters for the serving engine: the port of
`accelerate_tpu.serving.speculation`.

A drafter is any object with a ``draft_tokens`` int attribute and a
``propose(prompt, emitted) -> sequence[int]`` method returning up to
``draft_tokens`` candidate next tokens for one slot. The engine feeds the
proposals into one k+1-position verify forward of the target model and
accepts the longest prefix that matches the target's own greedy choices, so
a drafter is only a hint: a wrong, stale or empty proposal costs acceptance,
never correctness, and greedy output stays what it is with speculation off.

Two drafters:

- `NGramDrafter`, prompt-lookup decoding, no second model: the slot's own
  context (prompt + emitted tokens) is searched for the most recent earlier
  occurrence of its current n-gram tail, and the tokens that followed it are
  proposed. Pure host string matching; strongest where the output restates
  its context (summaries, code edits, retrieval).
- `ModelDrafter`: a small port model proposes by its own greedy
  `models.generation.generate` over the slot's trailing context window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class Drafter(Protocol):
    """The interface the engine requires of ``speculation=`` objects."""

    draft_tokens: int

    def propose(self, prompt: Sequence[int], emitted: Sequence[int]) -> Sequence[int]:
        ...


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """The engine's ``speculation=`` settings. ``draft_tokens`` (k) is the
    verify segment's depth: a dispatch scores k + 1 positions, so a forward
    costs more as k grows while the payoff is capped by the accept length.
    ``drafter`` wins when set; otherwise an `NGramDrafter` is built from the
    n-gram knobs."""

    draft_tokens: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    drafter: Any = None


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the context's current n-gram tail.

    Longer tails are tried first (``max_ngram`` down to ``min_ngram``), so a
    more specific match beats a more frequent one; within a tail length the
    most recent earlier occurrence wins. Returns at most ``draft_tokens``
    tokens, possibly none."""

    def __init__(self, draft_tokens: int = 4, max_ngram: int = 3, min_ngram: int = 1):
        draft_tokens, max_ngram, min_ngram = int(draft_tokens), int(max_ngram), int(min_ngram)
        if draft_tokens < 1:
            raise ValueError(f"draft_tokens must be >= 1, got {draft_tokens}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got {min_ngram}..{max_ngram}")
        self.draft_tokens = draft_tokens
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, prompt: Sequence[int], emitted: Sequence[int]) -> list[int]:
        ctx = list(prompt) + list(emitted)
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1):
            tail = ctx[n_ctx - n:]
            # match starts right to left: the first hit is the most recent
            # occurrence strictly before the tail itself
            for start in range(n_ctx - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    cont = ctx[start + n:start + n + self.draft_tokens]
                    if cont:
                        return cont
        return []


class ModelDrafter:
    """Small-model drafter: greedy `models.generation.generate` of a port
    model (a `models.gpt2.GPT2LMHead` or `models.llama.LlamaForCausalLM`)
    over the slot's trailing context window.

    The context is cut to its largest power-of-two tail (capped by
    ``context_tokens`` and the draft model's own positions), as the
    reference does to bound its compiles; here it bounds the captured decode
    graphs `generate` keeps. Cutting costs acceptance only."""

    def __init__(self, model: Any, draft_tokens: int = 4, context_tokens: int = 64):
        if int(draft_tokens) < 1:
            raise ValueError(f"draft_tokens must be >= 1, got {draft_tokens}")
        self.model = model
        self.draft_tokens = int(draft_tokens)
        cfg = model.config
        n_pos = int(getattr(cfg, "n_positions", getattr(cfg, "max_position_embeddings",
                                                        context_tokens)))
        if n_pos <= self.draft_tokens:
            raise ValueError(
                f"draft model has n_positions={n_pos} but must generate "
                f"draft_tokens={self.draft_tokens} past at least one context "
                f"token: use a draft model with n_positions > draft_tokens")
        self.context_tokens = max(1, min(int(context_tokens), n_pos - self.draft_tokens))

    def _window(self, ctx: list[int]) -> list[int]:
        n = min(len(ctx), self.context_tokens)
        n = 1 << (n.bit_length() - 1)  # the largest power of two <= n
        return ctx[len(ctx) - n:]

    def propose(self, prompt: Sequence[int], emitted: Sequence[int]) -> list[int]:
        from ..models.generation import generate

        ctx = list(prompt) + list(emitted)
        if not ctx:
            return []
        ids = torch.tensor([self._window(ctx)], dtype=torch.long, device=self.model.device)
        out = generate(self.model, ids, max_new_tokens=self.draft_tokens, temperature=0.0,
                       device=self.model.device)
        return [int(t) for t in out[0].tolist()]


def resolve_drafter(speculation: Any) -> tuple[Any, int]:
    """The engine's ``speculation=`` argument as ``(drafter, k)``: an int k
    (an `NGramDrafter` of that depth), a `SpeculationConfig`, or any
    `Drafter`."""
    if isinstance(speculation, bool):
        raise ValueError(
            "speculation takes a draft depth (int k), a SpeculationConfig, or "
            "a drafter: a bare bool does not say how deep to draft")
    if isinstance(speculation, int):
        drafter: Any = NGramDrafter(draft_tokens=speculation)
    elif isinstance(speculation, SpeculationConfig):
        drafter = speculation.drafter
        if drafter is None:
            drafter = NGramDrafter(draft_tokens=speculation.draft_tokens,
                                   max_ngram=speculation.max_ngram,
                                   min_ngram=speculation.min_ngram)
    elif hasattr(speculation, "propose") and hasattr(speculation, "draft_tokens"):
        drafter = speculation
    else:
        raise ValueError(f"speculation must be an int, SpeculationConfig, or Drafter "
                         f"(got {type(speculation).__name__})")
    k = int(drafter.draft_tokens)
    if k < 1:
        raise ValueError(f"draft_tokens must be >= 1, got {k}")
    return drafter, k
