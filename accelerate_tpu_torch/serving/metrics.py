"""Serving counters and histograms: the port of the part of
`accelerate_tpu.serving.metrics` the port's engine feeds (requests,
generated and prefilled tokens, tokens/s, TTFT, inter-token latency, steps,
the overlapped dispatch's host-blocked time, depth, admission batch sizes
and tokens per fetch, the prefix cache's counters, the speculative verify
step's, and the reliability and recovery counters: expiries, quarantines,
resumes and the journal's appends), and the reference's flat
`ServingMetrics.snapshot` for them.
Host-side bookkeeping only; nothing here touches the device."""

from __future__ import annotations

import math
import time
from typing import Any


def nearest_rank(ordered: list[float], q: float) -> float:
    """Nearest-rank quantile over a *sorted* sample list:
    ``ordered[max(0, ceil(q*n) - 1)]`` (inverse CDF)."""
    if not ordered:
        return 0.0
    n = len(ordered)
    return ordered[min(n - 1, max(0, math.ceil(q * n) - 1))]


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Streaming histogram: exact count, sum, min and max plus a bounded,
    deterministically strided sample reservoir for quantiles (no RNG: a
    metrics read must never perturb per-request seeding)."""

    def __init__(self, max_samples: int = 4096):
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._max_samples = int(max_samples)
        self._stride = 1
        self._samples: list[float] = []

    @property
    def min(self) -> float:
        """Smallest observed value; 0.0 before any observation."""
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        """Largest observed value; 0.0 before any observation."""
        return self._max if self.count else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self._min = min(self._min, value)
        self._max = max(self._max, value)
        if self.count % self._stride == 0:
            self._samples.append(value)
            if len(self._samples) > self._max_samples:
                # decimate and double the stride: memory stays bounded while
                # the reservoir keeps spanning the whole stream
                self._samples = self._samples[::2]
                self._stride *= 2

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile of the reservoir."""
        return nearest_rank(sorted(self._samples), q)

    def summary(self) -> dict[str, float]:
        """``count``, and once observed ``mean``, ``min``, ``max``, ``p50``,
        ``p90``, ``p99`` (the reference's keys)."""
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean, "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class ServingMetrics:
    """The engine's counters and histograms in one bag. Latencies are host
    wall seconds: ``ttft_s`` (submit -> first token fetched) and
    ``inter_token_s`` (gap between consecutive tokens of one request; a
    fetch that lands k tokens of a slot at once counts its gap split evenly
    over them), and ``host_blocked_s`` (the host blocked in one fetch: what
    overlapped dispatch exists to shrink). ``steps`` counts
    `ServingEngine.step` calls, ``decode_dispatches`` the decode steps
    dispatched (one CUDA graph replay each on CUDA) and ``decode_steps`` the
    decode forwards they ran (``tokens_per_sync`` a dispatch; each runs
    every layer's attention once). ``dispatch_depth`` (dispatches in flight
    at each decode dispatch, 1 = synchronous) is sampled at each dispatch,
    ``admit_batch_size`` (requests per prefill) at each admission, and
    ``tokens_per_dispatch`` (tokens one decode fetch appended over all
    slots) at each decode fetch. ``prefill_tokens`` counts the prompt tokens
    admissions ran through the model (only the uncached suffix of a prefix
    hit).

    Prefix cache (`serving.prefix_cache`): ``prefix_hits`` and
    ``prefix_misses`` count admissions that reused at least one cached block
    or none, ``prefix_tokens_reused`` the prompt tokens whose prefill a hit
    skipped, ``prefix_blocks_donated`` the blocks retirements gave the trie,
    ``prefix_evictions`` the blocks LRU eviction took back; ``ttft_hit_s`` and
    ``ttft_miss_s`` split TTFT by outcome.

    Speculation (`serving.speculation`): ``spec_proposed`` and
    ``spec_accepted`` count draft tokens proposed and accepted (greedy slots),
    ``spec_forwards`` the verify dispatches, ``spec_tokens`` the tokens they
    emitted, and ``spec_accept_len`` is each greedy slot's accepted draft
    length per verify (0..k). ``serving/accepted_tokens_per_forward`` in
    `snapshot` is ``spec_tokens / spec_forwards`` over all slots.

    Reliability: ``requests_expired`` counts requests queued past their
    deadline, ``requests_retried`` quarantined requests re-prefilled from
    their prompt, ``steps_poisoned`` the fetched steps in which at least one
    slot's health flag was down. Recovery (`serving.journal`, the engine's
    snapshot and resume): ``journal_records``, ``journal_bytes`` and
    ``journal_compactions`` count what the journal appended and how often it
    compacted; ``requests_resumed`` the requests a `resume` re-admitted
    mid-stream, ``requests_restored`` those it put back in the queue, and
    ``replayed_tokens`` the prompt and stream tokens re-prefilled only
    because of the restart."""

    def __init__(self):
        self.requests_submitted = Counter()
        self.requests_rejected = Counter()
        self.requests_finished = Counter()
        self.requests_cancelled = Counter()
        self.requests_expired = Counter()
        self.requests_retried = Counter()
        self.steps_poisoned = Counter()
        self.journal_records = Counter()
        self.journal_bytes = Counter()
        self.journal_compactions = Counter()
        self.requests_resumed = Counter()
        self.requests_restored = Counter()
        self.replayed_tokens = Counter()
        self.tokens_generated = Counter()
        self.prefill_tokens = Counter()
        self.prefix_hits = Counter()
        self.prefix_misses = Counter()
        self.prefix_tokens_reused = Counter()
        self.prefix_blocks_donated = Counter()
        self.prefix_evictions = Counter()
        self.spec_proposed = Counter()
        self.spec_accepted = Counter()
        self.spec_forwards = Counter()
        self.spec_tokens = Counter()
        self.steps = Counter()
        self.decode_dispatches = Counter()
        self.decode_steps = Counter()
        self.ttft_s = Histogram()
        self.ttft_hit_s = Histogram()
        self.ttft_miss_s = Histogram()
        self.inter_token_s = Histogram()
        self.host_blocked_s = Histogram()
        self.dispatch_depth = Histogram()
        self.admit_batch_size = Histogram()
        self.tokens_per_dispatch = Histogram()
        self.spec_accept_len = Histogram()
        self._start: float | None = None

    def mark_start(self) -> None:
        """First-event clock for the aggregate tokens/sec rate."""
        if self._start is None:
            self._start = time.perf_counter()

    def tokens_per_sec(self) -> float:
        """Generated tokens per wall second since the first submit."""
        if self._start is None:
            return 0.0
        dt = time.perf_counter() - self._start
        return self.tokens_generated.value / dt if dt > 0 else 0.0

    def snapshot(self) -> dict[str, Any]:
        """Flat scalar dict under the reference's ``serving/...`` keys: every
        counter, ``tokens_per_sec``, ``accepted_tokens_per_forward``, and each
        histogram's `Histogram.summary` as ``serving/<name>/<stat>``."""
        out: dict[str, Any] = {
            f"serving/{name}": getattr(self, name).value for name in (
                "requests_submitted", "requests_rejected", "requests_finished",
                "requests_expired", "requests_cancelled", "requests_retried", "steps_poisoned",
                "journal_records", "journal_bytes", "journal_compactions", "requests_resumed",
                "requests_restored", "replayed_tokens", "tokens_generated", "prefill_tokens", "prefix_hits",
                "prefix_misses", "prefix_tokens_reused", "prefix_blocks_donated",
                "prefix_evictions", "steps", "decode_dispatches", "decode_steps",
                "spec_proposed", "spec_accepted", "spec_forwards", "spec_tokens")
        }
        out["serving/tokens_per_sec"] = self.tokens_per_sec()
        out["serving/accepted_tokens_per_forward"] = (
            self.spec_tokens.value / self.spec_forwards.value if self.spec_forwards.value else 0.0)
        for name in ("ttft_s", "ttft_hit_s", "ttft_miss_s", "inter_token_s", "host_blocked_s",
                     "dispatch_depth", "admit_batch_size", "tokens_per_dispatch",
                     "spec_accept_len"):
            for stat, value in getattr(self, name).summary().items():
                out[f"serving/{name}/{stat}"] = value
        return out
