"""The serving front door: the port of `accelerate_tpu.serving.frontend`.
Token streaming, class-based submission and SLO-predictive admission over a
`ServingEngine`, an `EngineSupervisor` or a `ServingCluster`.

Three capabilities, all on the host (the decode step never sees any of this,
so a streamed request's tokens are the completed output's, token for token):

- **token streaming**: `ServingFrontend.submit_stream` returns a
  `TokenStream` that yields `StreamEvent`s (first token, progress deltas,
  finish or error) read off the request journal's FIRST_TOKEN/PROGRESS/FINISH
  records. Reading the journal rather than an in-process callback is the
  design: the journal is the engine's crash-exact replay frontier, so a
  stream survives a kill and `resume()`, and a cluster's replica migration,
  with no token duplicated and none lost. Exactly-once delivery follows from
  the records' cumulative ``n``: a stream remembers how many tokens it
  delivered and emits only the suffix beyond that, which absorbs crash
  replays, quarantine rewinds and migration re-journaling alike;
- **class-based submission**: `SubmitOptions` (priority class, tenant, SLO,
  deadline) stamped onto each request; with a `scheduler.FairScheduler` on
  the engine they give priority classes with per-tenant fair shares and a
  starvation bound. With the default FIFO scheduler they still ride along
  (the brownout and the SLO accounting read them) but the order stays FIFO;
- **predictive admission**: `predict_ttft` estimates the TTFT a new request
  would see from `capacity_headroom()`, the queue depth and the step-phase
  timings, and `submit` rejects with `REJECT_PREDICTED_TTFT` before an
  ``SLOSpec.ttft_s`` is doomed: a reason distinct from the supervisor's
  reactive brownout (`REJECT_OVERLOAD`). It never rejects blind: without an
  observed rate it admits.

The tailer keeps its own copy of the journal's framing and record names (the
format `serving.journal` writes, the reference's byte for byte).
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Iterator

from .request import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_LENGTH,
    REJECT_PREDICTED_TTFT,
    Request,
    SamplingParams,
    SubmitOptions,
    SubmitResult,
)

# the journal's framing: file magic, then <u32 length><u32 crc32> + JSON
_MAGIC = b"ATSJRNL1"
_FRAME = struct.Struct("<II")
_MAX_RECORD_BYTES = 1 << 26
_REC_FIRST_TOKEN = "first_token"
_REC_PROGRESS = "progress"
_REC_FINISH = "finish"

# StreamEvent kinds
EV_STREAM_FIRST = "first_token"
EV_STREAM_DELTA = "delta"
EV_STREAM_FINISH = "finish"
EV_STREAM_ERROR = "error"

# finish reasons that end a stream normally; any other (FINISH_ERROR,
# "rejected:*", the supervisor's fail-loud reasons) is an EV_STREAM_ERROR, so
# a caller tells "done" from "gave up" without matching strings
_CLEAN_FINISH = frozenset({FINISH_EOS, FINISH_LENGTH, FINISH_ABORTED})


class StreamStall(RuntimeError):
    """Iterating a `TokenStream` stepped the serving target repeatedly
    without the stream's journal frontier moving (the request neither
    progresses nor finishes: a wiring fault, not a transient), or a
    re-journaled prefix disagrees with what was delivered."""


@dataclass(frozen=True)
class StreamEvent:
    """One delivery on a `TokenStream`. ``tokens`` is the new suffix (never
    delivered before on this stream), ``n`` the stream's length after it;
    ``finish_reason`` is set on finish and error events only; ``lag_s`` is
    the journal append -> delivery latency of the record behind the event."""

    kind: str
    request_id: int
    tokens: tuple[int, ...] = ()
    n: int = 0
    finish_reason: str | None = None
    lag_s: float | None = None


class _JournalTailer:
    """Incremental reader of one journal file: parses the frames appended
    since the last poll and keeps each request's cumulative tokens, with the
    base-rewind rule of `RequestJournal.scan`.

    A torn tail (a short frame or a bad CRC at the frontier) ends the poll:
    the bytes are read again next time, when the writer has finished the
    frame or (on reopen) truncated it. A file that shrank (compaction, a
    writer's reopen) resets the tailer to read again from the magic; the
    replayed records are absorbed by `TokenStream`'s cumulative dedup."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._offset = len(_MAGIC)
        # rid -> cumulative tokens / (reason, tokens) / wall ts of the last
        # record that touched it
        self.tokens: dict[int, list[int]] = {}
        self.finishes: dict[int, tuple[str, list[int]]] = {}
        self.last_ts: dict[int, float] = {}

    def _reset(self) -> None:
        self._offset = len(_MAGIC)
        self.tokens.clear()
        self.finishes.clear()
        self.last_ts.clear()

    def poll(self) -> bool:
        """Consume the complete frames appended since the last poll; True if
        there were any."""
        try:
            size = self.path.stat().st_size
        except OSError:
            return False
        if size < self._offset:
            self._reset()
        if size <= self._offset:
            return False
        with open(self.path, "rb") as f:
            if self._offset == len(_MAGIC):
                if f.read(len(_MAGIC)) != _MAGIC:
                    return False
            else:
                f.seek(self._offset)
            data = f.read(size - self._offset)
        # consume complete frames; what is left is the torn tail: the offset
        # stays at the last complete frame, so the next poll reads it again
        pos = 0
        while pos + _FRAME.size <= len(data):
            length, crc = _FRAME.unpack_from(data, pos)
            start = pos + _FRAME.size
            if length > _MAX_RECORD_BYTES or start + length > len(data):
                break
            payload = data[start:start + length]
            if zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            self._apply(rec)
            pos = start + length
        self._offset += pos
        return pos > 0

    def _apply(self, rec: dict[str, Any]) -> None:
        rtype = rec.get("t")
        rid = rec.get("rid")
        if rid is None:
            return
        rid = int(rid)
        if rtype in (_REC_FIRST_TOKEN, _REC_PROGRESS):
            toks = [int(t) for t in rec.get("toks", ())]
            have = self.tokens.setdefault(rid, [])
            base = int(rec.get("n", 0)) - len(toks)
            if 0 <= base <= len(have):
                self.tokens[rid] = have[:base] + toks
            self.last_ts[rid] = float(rec.get("ts", 0.0))
        elif rtype == _REC_FINISH:
            self.finishes[rid] = (str(rec.get("reason", "")),
                                  [int(t) for t in rec.get("toks", ())])
            self.last_ts[rid] = float(rec.get("ts", 0.0))


class TokenStream(Iterator[StreamEvent]):
    """A live view of one request's tokens, read off the journal
    (`ServingFrontend.submit_stream` / `resume_stream`).

    Iterate it to drive the serving target until the request finishes::

        stream = frontend.submit_stream([1, 2, 3])
        assert stream.result.accepted
        for ev in stream:          # steps the engine or cluster as needed
            consume(ev.tokens)

    or call ``stream.poll()`` from a loop that steps the target itself: it
    returns whatever events are newly available.

    ``delivered`` is the exactly-once frontier: each token in it was yielded
    once, and a re-journaled prefix below it (a resume, a migration, a
    quarantine rewind) is checked against it: a divergence raises
    `StreamStall` (determinism is what makes journal-fed streaming
    exactly-once, so a violation must be loud)."""

    def __init__(self, frontend: "ServingFrontend", request_id: int, result: SubmitResult, *,
                 delivered: list[int] | None = None):
        self._frontend = frontend
        self.request_id = int(request_id)
        self.result = result
        self.delivered: list[int] = list(delivered or [])
        self.finish_reason: str | None = None
        self._pending: deque[StreamEvent] = deque()
        self._first_delivered = bool(self.delivered)
        self._t_submit = frontend._clock()

    @property
    def delivered_n(self) -> int:
        return len(self.delivered)

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def poll(self) -> list[StreamEvent]:
        """The events newly journaled (never steps the target)."""
        if self.finished:
            out = list(self._pending)
            self._pending.clear()
            return out
        fe = self._frontend
        placed = fe._placement(self.request_id)
        if placed is None:
            return []
        tailer, erid = fe._tailer_for(placed[0]), placed[1]
        tailer.poll()
        cum = tailer.tokens.get(erid, [])
        fin = tailer.finishes.get(erid)
        if fin is not None and len(fin[1]) >= len(cum):
            # the FINISH record carries the whole stream, which may run past
            # the last PROGRESS record
            cum = fin[1]
        self._emit_suffix(cum, tailer.last_ts.get(erid))
        if fin is not None:
            reason = fin[0]
            self.finish_reason = reason
            self._pending.append(StreamEvent(
                kind=EV_STREAM_FINISH if reason in _CLEAN_FINISH else EV_STREAM_ERROR,
                request_id=self.request_id, n=self.delivered_n, finish_reason=reason,
                lag_s=self._lag(tailer.last_ts.get(erid))))
            fe._close_stream(self)
        out = list(self._pending)
        self._pending.clear()
        return out

    @staticmethod
    def _lag(rec_ts: float | None) -> float | None:
        return max(0.0, time.time() - rec_ts) if rec_ts else None

    def _emit_suffix(self, cum: list[int], rec_ts: float | None) -> None:
        have = self.delivered_n
        if len(cum) <= have:
            return
        # exactly once: check the re-journaled overlap, emit the unseen suffix
        if cum[:have] != self.delivered:
            raise StreamStall(f"stream {self.request_id}: a re-journaled prefix diverges from "
                              "the delivered tokens (journal replay must be deterministic)")
        new = cum[have:]
        self.delivered.extend(new)
        lag = self._lag(rec_ts)
        metrics = self._frontend.metrics
        if lag is not None:
            metrics.stream_lag_s.observe(lag)
        kind = EV_STREAM_DELTA
        if not self._first_delivered:
            self._first_delivered = True
            metrics.streamed_ttft_s.observe(self._frontend._clock() - self._t_submit)
            kind = EV_STREAM_FIRST
        self._pending.append(StreamEvent(kind=kind, request_id=self.request_id,
                                         tokens=tuple(new), n=self.delivered_n, lag_s=lag))
        metrics.stream_events.inc()

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> StreamEvent:
        if self._pending:
            return self._pending.popleft()
        if not self.result.accepted:
            raise StopIteration
        stalls = 0
        while True:
            events = self.poll()
            if events:
                self._pending.extend(events[1:])
                return events[0]
            if self.finished:
                raise StopIteration
            self._frontend.target.step()
            stalls += 1
            if stalls > self._frontend.max_stall_steps:
                raise StreamStall(f"stream {self.request_id}: no progress after {stalls} steps "
                                  "(the request neither decodes nor finishes)")


def predict_ttft(headroom: dict[str, Any], step_timings: dict[str, float] | None = None, *,
                 max_concurrency: int | None = None) -> float | None:
    """The TTFT a request submitted now would see, from an engine's
    `capacity_headroom()` gauges and its last step-phase breakdown (the
    reference's model: coarse, deterministic and monotone in load):

    - a free slot with no queue ahead costs one engine step (the admission
      prefill rides the next `step`): the timings' ``total_s``;
    - otherwise the request waits for ``queue_depth - slots_free + 1``
      retirements: the first at ``est_slot_free_s``, the rest spread over the
      drain time (``decode_tokens_remaining / decode_tokens_per_sec`` over
      the busy slots).

    None when no prediction is possible (no observed rate and no free slot):
    the caller must read None as "admit", never as a rejection."""
    step_s = float((step_timings or {}).get("total_s", 0.0) or 0.0)
    free = int(headroom.get("slots_free", 0))
    queue = int(headroom.get("queue_depth", 0))
    if free > queue:
        return step_s
    waits_for = queue - free + 1
    w0 = headroom.get("est_slot_free_s")
    if w0 is None:
        return None
    rate = float(headroom.get("decode_tokens_per_sec") or 0.0)
    drain_tokens = float(headroom.get("decode_tokens_remaining", 0))
    busy = None if max_concurrency is None else max(1, int(max_concurrency) - free)
    per_retire = (drain_tokens / rate) / busy if rate > 0 and busy else float(w0)
    return float(w0) + (waits_for - 1) * per_retire + step_s


class ServingFrontend:
    """The front door over a serving target: a `ServingEngine`, an
    `EngineSupervisor` or a `ServingCluster` (anything with ``submit``,
    ``step`` and ``has_work`` and a journal behind it).

    ``admission=True`` (the default) turns on predictive admission for
    requests that carry an ``SLOSpec.ttft_s``; ``admission_margin`` scales the
    bound (1.0 rejects when the estimate exceeds the bound; 0.8 keeps 20%
    predicted slack). ``clock`` is injectable, so admission decisions are
    deterministic under test. Streaming (`submit_stream`) needs a journaled
    target: the journal is the stream's transport. `submit` works either
    way."""

    def __init__(self, target: Any, *, admission: bool = True, admission_margin: float = 1.0,
                 clock: Any = time.perf_counter, max_stall_steps: int = 4096):
        self.target = target
        self.admission = bool(admission)
        self.admission_margin = float(admission_margin)
        self._clock = clock
        self.max_stall_steps = int(max_stall_steps)
        self._streams: dict[int, TokenStream] = {}
        self._tailers: dict[Path, _JournalTailer] = {}

    # --- the target ----------------------------------------------------------
    @property
    def _is_cluster(self) -> bool:
        return hasattr(self.target, "replicas")

    @property
    def metrics(self) -> Any:
        """The `ServingMetrics` the front door counts into: the target's own
        for an engine or a supervisor; for a cluster the first replica's (the
        cluster's metrics view is a read-only sum over its replicas, so what
        replica 0 counts shows there)."""
        if self._is_cluster:
            return self.target.replicas[0].metrics
        return self.target.metrics

    def _engine(self) -> Any:
        t = self.target
        return t.engine if hasattr(t, "engine") else t

    def _accepting(self) -> list[Any]:
        """A cluster's replicas that take new placements (a draining
        replica's pace and slots say nothing about a fresh admission)."""
        return [rep for rep in self.target.replicas if rep.accepting]

    def _headroom(self) -> dict[str, Any] | None:
        fn = getattr(self.target, "capacity_headroom", None)
        if fn is None:
            fn = getattr(self._engine(), "capacity_headroom", None)
        return fn() if callable(fn) else None

    def _step_timings(self) -> dict[str, float]:
        """The engine's last step-phase breakdown, or the slowest accepting
        replica's for a cluster (the conservative one)."""
        if self._is_cluster:
            best: dict[str, float] = {}
            for rep in self._accepting():
                t = rep.engine.last_step_timings
                if t and t.get("total_s", 0.0) >= best.get("total_s", 0.0):
                    best = t
            return best
        return getattr(self._engine(), "last_step_timings", {}) or {}

    def _max_concurrency(self) -> int | None:
        if self._is_cluster:
            return sum(int(rep.engine.max_concurrency) for rep in self._accepting()) or None
        return getattr(self._engine(), "max_concurrency", None)

    def _scale_relief(self) -> float:
        """While the cluster's autoscaler wants more replicas than accept
        (``target_replicas > actual``), capacity is on its way: admission
        scales its estimate by ``actual / target`` and sheds less, so
        requests ride out the spawn instead of bouncing. 1.0 otherwise."""
        scaler = getattr(self.target, "autoscaler", None) if self._is_cluster else None
        if scaler is None:
            return 1.0
        target = int(scaler.target_replicas)
        actual = len(self._accepting())
        return actual / target if target > actual > 0 else 1.0

    # --- journal resolution ----------------------------------------------------
    def _placement(self, rid: int) -> tuple[Path, int] | None:
        """(journal path, engine rid) serving stream ``rid`` now: resolved at
        every poll, so a cluster migration or a supervisor restart re-points
        the tailer."""
        t = self.target
        if self._is_cluster:
            placed = t.placement(rid)
            if placed is None:
                return None
            rep_idx, erid = placed
            return Path(t.replicas[rep_idx].journal_path), erid
        journal = getattr(self._engine(), "journal", None)
        if journal is None:
            return None
        return Path(journal.path), rid

    def _tailer_for(self, path: Path) -> _JournalTailer:
        tailer = self._tailers.get(path)
        if tailer is None:
            tailer = self._tailers[path] = _JournalTailer(path)
        return tailer

    # --- admission ----------------------------------------------------------------
    def predict_ttft_now(self) -> float | None:
        """The TTFT estimate `submit` would gate on now."""
        headroom = self._headroom()
        if headroom is None:
            return None
        return predict_ttft(headroom, self._step_timings(),
                            max_concurrency=self._max_concurrency())

    def _admission_check(self, request: Request,
                         options: SubmitOptions | None) -> SubmitResult | None:
        slo = request.slo
        if (not self.admission or slo is None or slo.ttft_s is None
                or (options is not None and options.admit_despite_slo)):
            return None
        predicted = self.predict_ttft_now()
        if predicted is None:
            return None
        predicted *= self._scale_relief()
        self.metrics.predicted_ttft_s.observe(predicted)
        if predicted <= float(slo.ttft_s) * self.admission_margin:
            return None
        self.metrics.observe_shed(request.priority)
        self.metrics.requests_rejected.inc()
        return SubmitResult(False, request.request_id, REJECT_PREDICTED_TTFT,
                            f"predicted TTFT {predicted:.3f}s > slo {float(slo.ttft_s):.3f}s "
                            f"({slo.name})")

    # --- submission -----------------------------------------------------------------
    @staticmethod
    def _build_request(prompt: Request | Iterable[int], params: SamplingParams | None,
                       options: SubmitOptions | None) -> Request:
        request = (prompt if isinstance(prompt, Request)
                   else Request(prompt=list(prompt), params=params or SamplingParams()))
        if options is not None:
            options.apply(request)
        return request

    def submit(self, prompt: Request | Iterable[int], params: SamplingParams | None = None,
               options: SubmitOptions | None = None) -> SubmitResult:
        """Class-aware, admission-gated submit, with `ServingEngine.submit`'s
        backpressure contract: it never blocks and rejects with a reason."""
        request = self._build_request(prompt, params, options)
        rejected = self._admission_check(request, options)
        if rejected is not None:
            return rejected
        return self.target.submit(request)

    def submit_stream(self, prompt: Request | Iterable[int], params: SamplingParams | None = None,
                      options: SubmitOptions | None = None) -> TokenStream:
        """Submit and return a live `TokenStream` over the request's journal
        records. Check ``stream.result.accepted`` before iterating: a
        rejected submission yields no events."""
        request = self._build_request(prompt, params, options)
        result = self._admission_check(request, options) or self.target.submit(request)
        if not result.accepted:
            return TokenStream(self, -1 if result.request_id is None else result.request_id,
                               result)
        if self._placement(result.request_id) is None:
            raise ValueError("submit_stream needs a journaled target: the journal is the "
                             "stream's transport (pass journal= to the engine, or use a "
                             "supervisor or a cluster)")
        return self._open(TokenStream(self, result.request_id, result))

    def resume_stream(self, request_id: int, delivered: list[int] | None = None) -> TokenStream:
        """Attach a stream to a request the target already knows: after a
        crash-exact `resume()`, or to watch a request submitted elsewhere.
        ``delivered`` is the prefix the caller already consumed: delivery
        resumes just after it (and the overlap decoded again is checked
        against it)."""
        return self._open(TokenStream(self, request_id, SubmitResult(True, request_id),
                                      delivered=delivered))

    def _open(self, stream: TokenStream) -> TokenStream:
        self._streams[stream.request_id] = stream
        self.metrics.streams_opened.inc()
        return stream

    def _close_stream(self, stream: TokenStream) -> None:
        self.metrics.streams_finished.inc()
        self._streams.pop(stream.request_id, None)

    # --- pumping --------------------------------------------------------------------
    def open_streams(self) -> list[TokenStream]:
        return list(self._streams.values())

    def pump(self) -> list[StreamEvent]:
        """Poll every open stream once (no stepping): the hook for a caller
        that owns the step loop."""
        events: list[StreamEvent] = []
        for stream in list(self._streams.values()):
            events.extend(stream.poll())
        return events
