"""Request/response surface of the serving engine: the port of
`accelerate_tpu.serving.request`, every field of it: ``cache_prefix`` (the
prefix cache), the crash-recovery and reliability fields ``deadline_s``,
``retries`` and ``resume_tokens`` (the journal, snapshot and resume, the
health flag's quarantine), the latency objective ``slo`` (`SLOSpec`, the
goodput accounting and the front door's predictive admission), and
``priority`` and ``tenant`` (the supervisor's brownout and the
`FairScheduler`'s classes and fair shares), with the front door's
`SubmitOptions` and its ``REJECT_PREDICTED_TTFT``."""

from __future__ import annotations

from dataclasses import dataclass, field

# finish reasons
FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ABORTED = "aborted"  # cancelled / drained / run() step budget exhausted
FINISH_ERROR = "error"  # health flag: second poisoned step for the same request

# rejection reason codes (SubmitResult.reason); human detail rides separately
REJECT_QUEUE_FULL = "queue_full"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_EMPTY_PROMPT = "empty_prompt"
REJECT_DEADLINE = "deadline"  # queued past its deadline, never admitted
REJECT_DRAINING = "draining"  # engine is draining toward shutdown
# supervisor rejections (`serving.supervisor`): the restart budget is
# exhausted and the engine is being failed loudly, or the overload brownout is
# shedding low-priority admissions
REJECT_UNHEALTHY = "unhealthy"
REJECT_OVERLOAD = "overload"
# front-door predictive admission (`serving.frontend`): the TTFT this request
# would see, estimated from capacity headroom, queue depth and the step-phase
# timings, already exceeds its SLOSpec.ttft_s bound, so it is shed before a
# slot and a prefill are spent on a reply the client counts as a miss.
# Distinct from REJECT_OVERLOAD, the supervisor's reactive brownout
REJECT_PREDICTED_TTFT = "predicted_ttft"


@dataclass(frozen=True)
class SLOSpec:
    """A latency service-level objective one request is served under.

    ``ttft_s`` bounds time-to-first-token (arrival -> first generated token on
    the host); ``itl_p99_s`` bounds the request's own p99 inter-token gap
    (nearest-rank over its observed decode gaps). Either bound may be None
    (unconstrained). ``name`` is the SLO *class*: per-class attainment
    counters aggregate under it in `ServingMetrics.goodput`.

    A request **attains** its SLO iff it finishes cleanly (EOS or length:
    aborted, errored and expired requests are misses by definition) and every
    set bound holds. Tokens from attaining requests are *goodput*."""

    ttft_s: float | None = None
    itl_p99_s: float | None = None
    name: str = "default"


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

    ``deadline_s`` is a queue-wait budget: a request still queued
    ``deadline_s`` seconds after arrival is expired with `REJECT_DEADLINE`
    instead of being admitted. ``retries`` is stamped by the engine's health
    flag: a poisoned step re-prefills the request once from its prompt, a
    second poisoning retires it with `FINISH_ERROR`.

    ``cache_prefix=False`` opts the request out of prefix-KV reuse (an engine
    with ``prefix_cache=``): it neither reads cached blocks nor donates its
    prompt's.

    ``slo`` optionally attaches an `SLOSpec`: the engine judges its TTFT and
    per-request ITL-p99 bounds at retirement and feeds the per-class
    attainment and goodput counters of `metrics.ServingMetrics` (a request
    without one is unconstrained and counts as goodput on a clean finish).
    It is host-side accounting only, never scheduling, and not journaled.

    ``priority`` is the admission priority class (higher is more important,
    0 the lowest): the supervisor's overload brownout sheds new admissions
    with ``priority < level`` (`REJECT_OVERLOAD`), and the `FairScheduler`
    serves higher classes first within its starvation bound. Under the
    default `FIFOScheduler` the order stays FIFO. ``tenant`` is the
    `FairScheduler`'s fair-share account: requests of one tenant share one
    deficit budget, so one chatty client cannot monopolize its class. It is
    journaled and restored across resume and replica migration; ``""`` is
    the anonymous shared tenant.

    ``resume_tokens`` is the crash-recovery handle: the tokens this request
    had already emitted before an engine restart. Admission then prefills
    ``prompt + resume_tokens`` in one pass and fast-forwards the request's
    generator past ``len(resume_tokens)`` draws, so decode continues
    mid-stream as the uninterrupted run does. Stamped by
    `ServingEngine.resume`; a normal submission leaves it empty."""

    prompt: list[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    request_id: int | None = None
    arrival_time: float | None = None
    deadline_s: float | None = None
    retries: int = 0
    cache_prefix: bool = True
    slo: SLOSpec | None = None
    resume_tokens: list[int] = field(default_factory=list)
    priority: int = 0
    tenant: str = ""

    @property
    def prefill_len(self) -> int:
        """Tokens admission prefills (and must fit in a prompt bucket): the
        prompt plus any resumed stream prefix."""
        return len(self.prompt) + len(self.resume_tokens)

    def prefill_source(self) -> list[int]:
        """The token sequence admission prefills for this request."""
        return self.prompt + self.resume_tokens if self.resume_tokens else self.prompt


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
class SubmitOptions:
    """Per-request front-door knobs (`serving.frontend`): what a caller
    chooses about a submission rather than in it.

    ``priority`` picks the scheduling class (higher served first, within the
    `FairScheduler`'s starvation bound); ``tenant`` names the fair-share
    account the request bills; ``slo`` attaches the latency objective that
    predictive admission (`REJECT_PREDICTED_TTFT` when the estimated TTFT
    already exceeds ``slo.ttft_s``) and the goodput accounting read;
    ``deadline_s`` is the queue-wait budget (`REJECT_DEADLINE`);
    ``cache_prefix=False`` opts out of prefix-KV reuse.
    ``admit_despite_slo`` submits even when predictive admission would
    reject (the caller prefers a late answer to none)."""

    priority: int = 0
    tenant: str = ""
    slo: SLOSpec | None = None
    deadline_s: float | None = None
    cache_prefix: bool = True
    admit_despite_slo: bool = False

    def apply(self, request: Request) -> Request:
        """Stamp these options onto ``request`` (mutates and returns it)."""
        request.priority = int(self.priority)
        request.tenant = str(self.tenant)
        if self.slo is not None:
            request.slo = self.slo
        if self.deadline_s is not None:
            request.deadline_s = float(self.deadline_s)
        request.cache_prefix = bool(self.cache_prefix)
        return request


@dataclass(frozen=True)
class SubmitResult:
    """Admission verdict: accepted into the queue, or rejected with a reason
    code (backpressure: the caller decides whether to retry or shed load)."""

    accepted: bool
    request_id: int | None = None
    reason: str | None = None
    detail: str | None = None
