"""Request/response surface of the serving engine: the port of
`accelerate_tpu.serving.request`, for the fields the port's engine reads
(``cache_prefix`` since the prefix cache). The reference's SLO, tenant,
priority and crash-resume fields come with the modules that read them."""

from __future__ import annotations

from dataclasses import dataclass, field

# finish reasons
FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ABORTED = "aborted"  # run() step budget exhausted

# rejection reason codes (SubmitResult.reason); human detail rides separately
REJECT_QUEUE_FULL = "queue_full"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_EMPTY_PROMPT = "empty_prompt"


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode settings: temperature=0 is greedy, otherwise
    Gumbel-max sampling with optional top-k; ``seed`` seeds the request's own
    `torch.Generator`, so a sampled request is reproducible across runs and
    batch compositions."""

    temperature: float = 0.0
    top_k: int | None = None
    seed: int = 0
    max_new_tokens: int = 32


@dataclass
class Request:
    """One generation request: a token-id prompt plus its sampling params.
    ``request_id``/``arrival_time`` are stamped by `ServingEngine.submit`;
    supply ``arrival_time`` explicitly to replay a recorded trace.
    ``cache_prefix=False`` opts the request out of prefix-KV reuse (an engine
    with ``prefix_cache=``): it neither reads cached blocks nor donates its
    prompt's."""

    prompt: list[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    request_id: int | None = None
    arrival_time: float | None = None
    cache_prefix: bool = True

    @property
    def prefill_len(self) -> int:
        """Tokens admission prefills (and must fit in a prompt bucket)."""
        return len(self.prompt)


@dataclass
class RequestOutput:
    """Tokens generated for one request, with host-clock latency marks."""

    request_id: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str
    arrival_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None


@dataclass(frozen=True)
class SubmitResult:
    """Admission verdict: accepted into the queue, or rejected with a reason
    code (backpressure: the caller decides whether to retry or shed load)."""

    accepted: bool
    request_id: int | None = None
    reason: str | None = None
    detail: str | None = None
