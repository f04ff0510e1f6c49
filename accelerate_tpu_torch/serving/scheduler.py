"""Admission queue with prompt-length bucketing and bounded backpressure: the
port of `accelerate_tpu.serving.scheduler` ``FIFOScheduler``.

Bucketing pads a prompt to the smallest configured bucket that holds it, so
batched admission prefills same-shape groups. With a prefix cache the engine
sets ``prefill_len_fn`` and a request is bucketed by the uncached suffix it
will prefill, and a run never mixes requests that read the cache with ones
that opted out or resume a stream. The queue is bounded; a full queue rejects
with a reason instead of growing without limit. A request's queue-wait
deadline is enforced by `pop_expired`, and `snapshot_queue` lets the engine's
snapshot read the queue without draining it.
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
        # prefix-cache hook (set by the engine when its prefix cache is on):
        # maps a request to the prompt tokens admission will actually
        # prefill, its uncached suffix, so runs group by suffix bucket
        self.prefill_len_fn = None
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

    def prefill_bucket_for(self, request: Request) -> int:
        """The bucket admission pads this request's prefill to: its prompt's,
        or with a prefix cache probing through ``prefill_len_fn``, that of
        just the uncached suffix."""
        n = request.prefill_len
        if self.prefill_len_fn is not None:
            n = max(1, min(n, int(self.prefill_len_fn(request))))
        return self.bucket_for(n)

    def _run_key(self, request: Request) -> tuple[int, bool]:
        """The batched-admission grouping key: the prefill bucket and, with a
        prefix cache probing, whether the request may read the cache (its
        ``cache_prefix`` flag, and no ``resume_tokens``: a resumed stream's
        continuation prefill never reads the block pool): a cached and a
        plain admission take different paths and never share a run."""
        return (self.prefill_bucket_for(request),
                (bool(request.cache_prefix) and not request.resume_tokens)
                if self.prefill_len_fn is not None else False)

    @staticmethod
    def decode_extent(request: Request, max_len: int) -> int:
        """The furthest KV position + 1 this request can ever occupy:
        ``min(prompt + max_new_tokens, max_len)``. It prices paged block
        reservations and bounds every decode write: the admission budget
        keeps ``pos + remaining + 1 <= extent`` for a live slot, which lets
        a speculative verify segment cap its write at ``remaining + 1``."""
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
        the front that share the head's prefill bucket (the suffix bucket when
        a prefix cache probes) and, with the cache, its ``cache_prefix`` flag
        (`_run_key`): the group one batched admission can prefill together,
        shrunk to what ``capacity_fn`` says the block pool can seat. Only the
        front run counts: batching later arrivals past a differently-bucketed
        head would break FIFO order."""
        if not self._queue or max_n <= 0:
            return 0
        head = self._run_key(self._queue[0])
        n = 0
        for r in self._queue:
            if n >= max_n or self._run_key(r) != head:
                break
            n += 1
        if n and self.capacity_fn is not None:
            n = max(0, min(n, int(self.capacity_fn([self._queue[i] for i in range(n)]))))
        return n

    def pop_run(self, n: int) -> list[Request]:
        """Pop the ``n`` front requests (the group sized via `peek_run`)."""
        return [self._queue.popleft() for _ in range(min(n, len(self._queue)))]

    def requeue(self, request: Request) -> None:
        """Put a request back at the FRONT of the queue: a group that found
        the block pool short goes back in its original order, and a
        quarantined request must not wait behind new arrivals."""
        self._queue.appendleft(request)

    def pop_expired(self, now: float) -> list[Request]:
        """Remove and return every queued request whose ``deadline_s`` queue
        budget has elapsed (the engine rejects them with REJECT_DEADLINE)."""
        expired = [r for r in self._queue
                   if r.deadline_s is not None and r.arrival_time is not None
                   and now - r.arrival_time >= r.deadline_s]
        if expired:
            dead = set(map(id, expired))
            self._queue = deque(r for r in self._queue if id(r) not in dead)
        return expired

    def cancel(self, request_id: int) -> Request | None:
        """Remove a queued request by id (None if not queued here)."""
        for r in self._queue:
            if r.request_id == request_id:
                self._queue.remove(r)
                return r
        return None

    def snapshot_queue(self) -> list[Request]:
        """The queued requests in order, without removing them (the engine's
        `snapshot` serializes the queue through this)."""
        return list(self._queue)

    def drain_queue(self) -> list[Request]:
        """Remove and return everything queued (abort path)."""
        drained = list(self._queue)
        self._queue.clear()
        return drained

    @property
    def queue_depth(self) -> int:
        return len(self._queue)
