"""Serving counters and histograms: the port of the part of
`accelerate_tpu.serving.metrics` the paged GPT-2 slice feeds (requests,
generated tokens, tokens/s, TTFT, inter-token latency, steps, and the
overlapped dispatch's host-blocked time, depth, admission batch sizes and
tokens per fetch). Host-side bookkeeping only; nothing here touches the
device."""

from __future__ import annotations

import math
import time


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
    slots) at each decode fetch."""

    def __init__(self):
        self.requests_submitted = Counter()
        self.requests_rejected = Counter()
        self.requests_finished = Counter()
        self.requests_cancelled = Counter()
        self.tokens_generated = Counter()
        self.steps = Counter()
        self.decode_dispatches = Counter()
        self.decode_steps = Counter()
        self.ttft_s = Histogram()
        self.inter_token_s = Histogram()
        self.host_blocked_s = Histogram()
        self.dispatch_depth = Histogram()
        self.admit_batch_size = Histogram()
        self.tokens_per_dispatch = Histogram()
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
