"""Serving counters and histograms: the port of the part of
`accelerate_tpu.serving.metrics` the paged GPT-2 slice feeds (requests,
generated tokens, tokens/s, TTFT, inter-token latency, steps). Host-side
bookkeeping only; nothing here touches the device."""

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
    """Streaming histogram: exact count and sum plus a bounded,
    deterministically strided sample reservoir for quantiles (no RNG: a
    metrics read must never perturb per-request seeding)."""

    def __init__(self, max_samples: int = 4096):
        self.count = 0
        self.sum = 0.0
        self._max_samples = int(max_samples)
        self._stride = 1
        self._samples: list[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
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
    ``inter_token_s`` (gap between consecutive tokens of one request).
    ``steps`` counts `ServingEngine.step` calls, ``decode_steps`` the decode
    forwards among them (each runs every layer's attention once)."""

    def __init__(self):
        self.requests_submitted = Counter()
        self.requests_rejected = Counter()
        self.requests_finished = Counter()
        self.requests_cancelled = Counter()
        self.tokens_generated = Counter()
        self.steps = Counter()
        self.decode_steps = Counter()
        self.ttft_s = Histogram()
        self.inter_token_s = Histogram()
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
