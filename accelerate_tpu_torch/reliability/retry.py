"""Retry with backoff: the port of `accelerate_tpu.reliability.retry`.

One policy object serves every transient-failure site (storage I/O, a flaky
RPC). Deliberately deterministic: the jitter stream is seeded per `delays`
call with numpy's ``default_rng(seed)``, as the reference's is, so a retried
operation backs off the same way on every replay, and the same policy gives
the same delays in both packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np


class RetryError(Exception):
    """All attempts failed (or the deadline expired first). ``attempts`` holds
    every underlying exception in order; ``__cause__`` is the last one."""

    def __init__(self, message: str, attempts: list[BaseException]):
        super().__init__(message)
        self.attempts = attempts


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded jitter, attempt cap, wall deadline,
    and a retryable-exception filter.

    Delay before retry ``i`` (0-based) is ``min(max_delay_s, base_delay_s *
    multiplier**i)`` scaled by a uniform factor in ``[1-jitter, 1+jitter]``
    drawn from a ``seed``-keyed stream. Exceptions not matching ``retryable``
    — or matching ``non_retryable``, which wins — propagate immediately: a
    corrupt checkpoint or missing file must not be retried like a flaky disk.
    ``deadline_s`` bounds total elapsed time including sleeps: a retry that
    cannot start before the deadline is not attempted.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: float | None = None
    retryable: tuple[type[BaseException], ...] = (OSError,)
    non_retryable: tuple[type[BaseException], ...] = (FileNotFoundError, IsADirectoryError)
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delays(self) -> Iterator[float]:
        """The deterministic backoff sequence (one delay per retry)."""
        rng = np.random.default_rng(self.seed)
        for i in range(self.max_attempts - 1):
            delay = min(self.max_delay_s, self.base_delay_s * self.multiplier**i)
            if self.jitter:
                delay *= 1.0 + self.jitter * (2.0 * float(rng.random()) - 1.0)
            yield delay

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        **kwargs: Any,
    ) -> Any:
        """Invoke ``fn(*args, **kwargs)``, retrying retryable failures under
        this policy. ``sleep``/``clock`` are injectable so tests run in zero
        wall time while asserting the exact backoff schedule."""
        start = clock()
        attempts: list[BaseException] = []
        delay_iter = self.delays()
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retryable as exc:  # type: ignore[misc]
                if isinstance(exc, self.non_retryable):
                    raise
                attempts.append(exc)
                delay = next(delay_iter, None)
                if delay is None:
                    raise RetryError(
                        f"{fn!r} failed after {len(attempts)} attempts", attempts
                    ) from exc
                if (self.deadline_s is not None
                        and clock() - start + delay > self.deadline_s):
                    raise RetryError(
                        f"{fn!r} deadline {self.deadline_s}s exhausted after "
                        f"{len(attempts)} attempts", attempts
                    ) from exc
                sleep(delay)
