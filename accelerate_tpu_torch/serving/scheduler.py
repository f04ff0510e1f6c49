"""Admission queue with prompt-length bucketing and bounded backpressure: the
port of `accelerate_tpu.serving.scheduler` ``FIFOScheduler``.

Bucketing pads a prompt to the smallest configured bucket that holds it, so
batched admission prefills same-shape groups. The queue is bounded; a full
queue rejects with a reason instead of growing without limit.
"""

from __future__ import annotations

from collections import deque

from .request import (
    REJECT_EMPTY_PROMPT,
    REJECT_PROMPT_TOO_LONG,
    REJECT_QUEUE_FULL,
    Request,
    SubmitResult,
)


class FIFOScheduler:
    """Admission control for the serving engine: validate, enqueue in arrival
    order, hand requests to free slots, and push back when full."""

    def __init__(
        self,
        prompt_buckets: tuple[int, ...] = (32, 128, 512),
        max_queue: int = 128,
        max_prompt_len: int | None = None,
    ):
        self.buckets = tuple(sorted({int(b) for b in prompt_buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"prompt_buckets must be positive ints, got {prompt_buckets}")
        self.max_queue = int(max_queue)
        # the engine caps this at n_positions - 1 so every admitted request has
        # room for at least one generated token
        self.max_prompt_len = int(max_prompt_len or self.buckets[-1])
        # paged-KV capacity hook (set by the engine): maps the front run's
        # requests to how many of them the block pool can seat right now, so
        # admission is gated on blocks, not just free slots
        self.capacity_fn = None
        self._queue: deque[Request] = deque()

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket holding ``prompt_len`` (the prefill pad target)."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket {self.buckets[-1]}"
        )

    @staticmethod
    def decode_extent(request: Request, max_len: int) -> int:
        """The furthest KV position + 1 this request can ever occupy:
        ``min(prompt + max_new_tokens, max_len)``. It prices paged block
        reservations and bounds every decode write."""
        return min(len(request.prompt) + int(request.params.max_new_tokens), int(max_len))

    def _validate(self, request: Request) -> SubmitResult | None:
        """Admission validation (None = admissible)."""
        if len(request.prompt) == 0:
            return SubmitResult(False, request.request_id, REJECT_EMPTY_PROMPT,
                                "prompt has no tokens")
        n = request.prefill_len
        if n > self.max_prompt_len or n > self.buckets[-1]:
            return SubmitResult(
                False, request.request_id, REJECT_PROMPT_TOO_LONG,
                f"prompt length {n} > max {min(self.max_prompt_len, self.buckets[-1])}",
            )
        if self.queue_depth >= self.max_queue:
            return SubmitResult(
                False, request.request_id, REJECT_QUEUE_FULL,
                f"{self.queue_depth} requests already queued",
            )
        return None

    def submit(self, request: Request) -> SubmitResult:
        """Enqueue or reject-with-reason (never blocks, never raises on load)."""
        rejected = self._validate(request)
        if rejected is not None:
            return rejected
        self._queue.append(request)
        return SubmitResult(True, request.request_id)

    def peek_run(self, max_n: int) -> int:
        """Length (up to ``max_n``) of the contiguous run of queued requests at
        the front that share the head's prompt bucket: the group one batched
        admission can prefill together, shrunk to what ``capacity_fn`` says
        the block pool can seat. Only the front run counts: batching later
        arrivals past a differently-bucketed head would break FIFO order."""
        if not self._queue or max_n <= 0:
            return 0
        head = self.bucket_for(self._queue[0].prefill_len)
        n = 0
        for r in self._queue:
            if n >= max_n or self.bucket_for(r.prefill_len) != head:
                break
            n += 1
        if n and self.capacity_fn is not None:
            n = max(0, min(n, int(self.capacity_fn([self._queue[i] for i in range(n)]))))
        return n

    def pop_run(self, n: int) -> list[Request]:
        """Pop the ``n`` front requests (the group sized via `peek_run`)."""
        return [self._queue.popleft() for _ in range(min(n, len(self._queue)))]

    def requeue(self, request: Request) -> None:
        """Put a request back at the FRONT of the queue (a group that found
        the block pool short goes back in its original order)."""
        self._queue.appendleft(request)

    def cancel(self, request_id: int) -> Request | None:
        """Remove a queued request by id (None if not queued here)."""
        for r in self._queue:
            if r.request_id == request_id:
                self._queue.remove(r)
                return r
        return None

    def drain_queue(self) -> list[Request]:
        """Remove and return everything queued (abort path)."""
        drained = list(self._queue)
        self._queue.clear()
        return drained

    @property
    def queue_depth(self) -> int:
        return len(self._queue)
