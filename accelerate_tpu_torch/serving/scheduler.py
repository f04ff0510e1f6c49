"""Admission queues with prompt-length bucketing and bounded backpressure: the
port of `accelerate_tpu.serving.scheduler`. Two schedulers share one
interface:

- `FIFOScheduler`: strict arrival order, the engine's default and the parity
  oracle: every ordering policy degenerates to it with one priority class and
  one tenant, so greedy streams stay token for token the FIFO path's;
- `FairScheduler`: priority classes served highest first, per-tenant deficit
  round-robin inside a class and a bypass-count starvation bound across
  classes. Every ordering decision is host-side integer bookkeeping: the
  decode step never sees the policy, so switching schedulers cannot change
  the device's numbers.

Bucketing pads a prompt to the smallest configured bucket that holds it, so
batched admission prefills same-shape groups. With a prefix cache the engine
sets ``prefill_len_fn`` and a request is bucketed by the uncached suffix it
will prefill, and a run never mixes requests that read the cache with ones
that opted out or resume a stream. The queue is bounded; a full queue rejects
with a reason instead of growing without limit. A request's queue-wait
deadline is enforced by `pop_expired`, and `snapshot_queue` lets the engine's
snapshot read the queue without draining it. The engine shares its tracer
(``scheduler.tracer``), so every QUEUED edge, a fresh acceptance or a
requeue, is stamped where the queue changes.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .request import (
    REJECT_EMPTY_PROMPT,
    REJECT_PROMPT_TOO_LONG,
    REJECT_QUEUE_FULL,
    Request,
    SubmitResult,
)
from .trace import EV_QUEUED, NULL_TRACER


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
        # the engine replaces this with its own tracer (serving.trace)
        self.tracer = NULL_TRACER
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
        if self.tracer.enabled:
            self.tracer.emit(EV_QUEUED, request.request_id, queue_depth=len(self._queue),
                             bucket=self.prefill_bucket_for(request))
        return SubmitResult(True, request.request_id)

    def next_ready(self) -> Request | None:
        """Pop the oldest queued request (FIFO), or None when idle."""
        return self._queue.popleft() if self._queue else None

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
        if self.tracer.enabled:
            self.tracer.emit(EV_QUEUED, request.request_id, queue_depth=len(self._queue),
                             bucket=self.prefill_bucket_for(request), requeued=True)

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


@dataclass
class _Entry:
    """One queued request with the fair scheduler's bookkeeping: its arrival
    sequence number and how many later arrivals were served ahead of it (the
    starvation-bound counter)."""

    req: Request
    seq: int
    bypass: int = 0


class FairScheduler(FIFOScheduler):
    """Class-based admission order: priority classes served highest first,
    per-tenant deficit round-robin (DRR) inside a class, and a deterministic
    starvation bound across everything.

    The rules, in precedence order:

    1. **requeues** (`requeue`: the health flag's quarantine, a group the
       block pool could not seat) go first, as FIFO's ``appendleft``;
    2. **starved requests**: a request that has watched ``starvation_bound``
       later arrivals served ahead of it is promoted to absolute precedence,
       oldest first. The bound is a count, not a wall-clock wait, so it is
       deterministic under replay: no request is bypassed more than
       ``starvation_bound`` times, whatever the class and tenant mix;
    3. **deficit round-robin** in the highest non-empty class: tenants take
       turns, each visit grants ``quantum_tokens`` of budget, and a tenant
       serves queued requests while its deficit covers their cost
       (``prefill_len + max_new_tokens``). A tenant whose queue empties
       forfeits its deficit (no hoarding while idle).

    With one class and one tenant the rotation has one member and DRR is
    arrival order: FIFO exactly. `peek_run`/`pop_run` keep the batched
    admission contract: the run is the contiguous same-`_run_key` group at
    the front of the service order, and `peek_run` never commits DRR state;
    only `pop_run` advances deficits, the rotation and the bypass counters.
    """

    def __init__(
        self,
        prompt_buckets: tuple[int, ...] = (32, 128, 512),
        max_queue: int = 128,
        max_prompt_len: int | None = None,
        quantum_tokens: int = 64,
        starvation_bound: int = 8,
    ):
        super().__init__(prompt_buckets, max_queue, max_prompt_len)
        if quantum_tokens < 1:
            raise ValueError(f"quantum_tokens must be >= 1, got {quantum_tokens}")
        if starvation_bound < 1:
            raise ValueError(f"starvation_bound must be >= 1, got {starvation_bound}")
        self.quantum_tokens = int(quantum_tokens)
        self.starvation_bound = int(starvation_bound)
        self._seq = 0
        # requeues: absolute precedence, last in first
        self._front: deque[_Entry] = deque()
        # priority -> tenant -> FIFO of entries; a tenant key exists iff its
        # deque is non-empty iff it is in its class's rotation
        self._classes: dict[int, dict[str, deque[_Entry]]] = {}
        # priority -> tenant visit order, kept across pop_run calls
        self._rotation: dict[int, deque[str]] = {}
        # priority -> tenant -> accumulated token deficit
        self._deficit: dict[int, dict[str, int]] = {}

    @staticmethod
    def _cost(entry: _Entry) -> int:
        """Tokens a request bills its tenant: its prefill and its whole
        decode budget."""
        r = entry.req
        return max(1, r.prefill_len + int(r.params.max_new_tokens))

    def _enqueue(self, request: Request) -> None:
        p = int(request.priority)
        t = str(request.tenant or "")
        tenants = self._classes.setdefault(p, {})
        if t not in tenants:
            tenants[t] = deque()
            self._rotation.setdefault(p, deque()).append(t)
        self._seq += 1
        tenants[t].append(_Entry(request, self._seq))

    def _remove_entry(self, entry: _Entry) -> None:
        if entry in self._front:
            self._front.remove(entry)
            return
        for p, tenants in self._classes.items():
            for t, dq in tenants.items():
                if entry in dq:
                    dq.remove(entry)
                    if not dq:
                        self._forget_tenant(p, t)
                    return

    def _forget_tenant(self, p: int, t: str) -> None:
        """Drop an emptied tenant: its deque, its rotation slot and its
        deficit."""
        tenants = self._classes.get(p, {})
        if t in tenants and not tenants[t]:
            del tenants[t]
        rot = self._rotation.get(p)
        if rot is not None and t in rot:
            rot.remove(t)
        self._deficit.get(p, {}).pop(t, None)
        if not tenants:
            self._classes.pop(p, None)
            self._rotation.pop(p, None)
            self._deficit.pop(p, None)

    def _entries(self):
        yield from self._front
        for tenants in self._classes.values():
            for dq in tenants.values():
                yield from dq

    def _ordered(self, commit_n: int | None = None) -> list[_Entry]:
        """The whole service order under the current state.

        With ``commit_n=None`` a pure peek: DRR runs on copies and nothing
        changes. With ``commit_n=k`` the first ``k`` entries are served:
        removed, the rotation and deficits advanced exactly as far as the
        simulation got at the k-th, and every entry still queued has its
        bypass count raised once per later arrival served ahead of it."""
        front = deque(self._front)
        classes = {p: {t: deque(dq) for t, dq in ts.items()}
                   for p, ts in self._classes.items()}
        rotation = {p: deque(r) for p, r in self._rotation.items()}
        deficit = {p: dict(d) for p, d in self._deficit.items()}
        order: list[_Entry] = []
        limit = self.queue_depth if commit_n is None else min(commit_n, self.queue_depth)

        def done() -> bool:
            return commit_n is not None and len(order) >= limit

        # 1. requeues, in deque order
        while front and not done():
            order.append(front.popleft())
        # 2. starved entries, oldest arrival first
        if not done():
            starved = sorted((e for ts in classes.values() for dq in ts.values()
                              for e in dq if e.bypass >= self.starvation_bound),
                             key=lambda e: e.seq)
            for e in starved:
                if done():
                    break
                for ts in classes.values():
                    for dq in ts.values():
                        if e in dq:
                            dq.remove(e)
                order.append(e)
        # 3. DRR over the classes, highest first
        for p in sorted(classes, reverse=True):
            tenants = classes[p]
            rot = rotation.setdefault(p, deque())
            defs = deficit.setdefault(p, {})
            while not done() and any(tenants.get(t) for t in rot):
                t = rot[0]
                dq = tenants.get(t)
                if not dq:
                    rot.popleft()
                    defs.pop(t, None)
                    continue
                defs[t] = defs.get(t, 0) + self.quantum_tokens
                while dq and defs[t] >= self._cost(dq[0]) and not done():
                    e = dq.popleft()
                    defs[t] -= self._cost(e)
                    order.append(e)
                if not dq:
                    rot.popleft()
                    defs.pop(t, None)
                else:
                    rot.rotate(-1)
            if done():
                break

        if commit_n is None:
            return order
        served = order[:limit]
        # commit: write the copies back, prune emptied tenants, bump bypasses
        self._front = front
        self._classes = {p: {t: dq for t, dq in ts.items() if dq}
                         for p, ts in classes.items()}
        self._classes = {p: ts for p, ts in self._classes.items() if ts}
        self._rotation = {p: deque(t for t in rotation.get(p, ()) if t in self._classes[p])
                          for p in self._classes}
        self._deficit = {p: {t: v for t, v in deficit.get(p, {}).items()
                             if t in self._classes[p]}
                         for p in self._classes}
        for e in self._entries():
            e.bypass += sum(1 for s in served if s.seq > e.seq)
        return served

    def submit(self, request: Request) -> SubmitResult:
        rejected = self._validate(request)
        if rejected is not None:
            return rejected
        self._enqueue(request)
        if self.tracer.enabled:
            self.tracer.emit(EV_QUEUED, request.request_id, queue_depth=self.queue_depth,
                             bucket=self.prefill_bucket_for(request),
                             priority=int(request.priority), tenant=str(request.tenant or ""))
        return SubmitResult(True, request.request_id)

    def next_ready(self) -> Request | None:
        popped = self._ordered(commit_n=1)
        return popped[0].req if popped else None

    def peek_run(self, max_n: int) -> int:
        if self.queue_depth == 0 or max_n <= 0:
            return 0
        order = self._ordered()
        head = self._run_key(order[0].req)
        n = 0
        for e in order:
            if n >= max_n or self._run_key(e.req) != head:
                break
            n += 1
        if n and self.capacity_fn is not None:
            n = max(0, min(n, int(self.capacity_fn([order[i].req for i in range(n)]))))
        return n

    def pop_run(self, n: int) -> list[Request]:
        return [e.req for e in self._ordered(commit_n=n)]

    def requeue(self, request: Request) -> None:
        self._seq += 1
        self._front.appendleft(_Entry(request, self._seq))
        if self.tracer.enabled:
            self.tracer.emit(EV_QUEUED, request.request_id, queue_depth=self.queue_depth,
                             bucket=self.prefill_bucket_for(request), requeued=True)

    def pop_expired(self, now: float) -> list[Request]:
        expired = [e for e in self._entries()
                   if e.req.deadline_s is not None and e.req.arrival_time is not None
                   and now - e.req.arrival_time >= e.req.deadline_s]
        for e in expired:
            self._remove_entry(e)
        return [e.req for e in expired]

    def cancel(self, request_id: int) -> Request | None:
        for e in list(self._entries()):
            if e.req.request_id == request_id:
                self._remove_entry(e)
                return e.req
        return None

    def snapshot_queue(self) -> list[Request]:
        """The queued requests in service order (what would be admitted
        next): a fresh scheduler fed this sequence derives the same order."""
        return [e.req for e in self._ordered()]

    def drain_queue(self) -> list[Request]:
        drained = [e.req for e in self._ordered()]
        self._front.clear()
        self._classes.clear()
        self._rotation.clear()
        self._deficit.clear()
        return drained

    @property
    def queue_depth(self) -> int:
        return len(self._front) + sum(len(dq) for ts in self._classes.values()
                                      for dq in ts.values())

    def class_stats(self) -> dict[int, dict[str, object]]:
        """Per-priority-class queue state: depth, per-tenant depths and how
        many entries are starvation-promoted now (requeues under class -1)."""
        stats: dict[int, dict[str, object]] = {}
        for p, tenants in self._classes.items():
            depths = {t: len(dq) for t, dq in tenants.items()}
            starved = sum(1 for dq in tenants.values() for e in dq
                          if e.bypass >= self.starvation_bound)
            stats[p] = {"depth": sum(depths.values()), "tenants": depths, "starved": starved}
        if self._front:
            stats.setdefault(-1, {"depth": 0, "tenants": {}, "starved": 0})
            stats[-1]["depth"] = len(self._front)
        return stats

    def class_gauges(self) -> dict[str, object]:
        """`class_stats` as the ``serving/class/<p>/...`` telemetry gauges."""
        out: dict[str, object] = {}
        for p, st in self.class_stats().items():
            out[f"serving/class/{p}/queue_depth"] = st["depth"]
            out[f"serving/class/{p}/starved"] = st["starved"]
            out[f"serving/class/{p}/tenants"] = len(st["tenants"])
        return out
