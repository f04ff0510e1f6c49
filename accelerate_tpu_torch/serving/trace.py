"""Request-level tracing for the serving engine: the port of
`accelerate_tpu.serving.trace`, event for event and in the same export
format, so a trace either package writes loads and validates in the other.

The aggregate counters and histograms in `serving.metrics` answer "how is the
engine doing"; this module answers "where did *this* request's latency go".
The engine emits one flat, append-only stream of :class:`TraceEvent` records,
cheap tuples stamped with a single monotonic host clock, from which three
views are derived *at export time*, never on the hot path:

  - **per-request span streams**: SUBMIT -> QUEUED -> ADMIT[bucket, cache hit]
    -> every decode DISPATCH/FETCH batch the request rode -> terminal
    FINISH/REJECT (with QUARANTINE and re-QUEUED edges in between when the
    health flag intervenes), each edge carrying slot id, slot generation
    counter and the pipeline depth at emission;
  - **engine-level dispatch spans**: one per dispatch (a decode step's CUDA
    graph replay, an admission's eager prefill), flagged compile or replay,
    paired with the host fetch that later drains it (overlapped dispatches
    overlap, so these are exported as Chrome *async* spans);
  - **slot-occupancy tenancies**: admit -> retire/quarantine per slot.

Design constraints:

  - **zero overhead by default**: engines get the module-level
    :data:`NULL_TRACER` singleton unless a real :class:`Tracer` is passed;
    every engine-side emission site is guarded by ``tracer.enabled`` (a plain
    attribute read) and the null tracer's methods are no-ops;
  - **host clocks only**: an emission reads the injected host clock and
    nothing on the device, so tracing adds no stream synchronisation to the
    overlapped dispatch;
  - **deterministic**: no RNG anywhere; timestamps come from one injected
    monotonic clock (default ``time.perf_counter``), so event *order* equals
    emission order and validation needs no tolerance windows;
  - **bounded**: a ring buffer caps the event count; once full, the oldest
    event is discarded and ``dropped`` increments, and the loss is reported.

`export(path)` writes Chrome trace-event JSON (the ``{"traceEvents": [...]}``
object form) that Perfetto (ui.perfetto.dev) and ``chrome://tracing`` open;
the raw event stream rides along under the ``accelerateTpuTrace`` key
(viewers ignore unknown top-level keys), so `load_exported` and `validate`
re-check a trace file without the live tracer.

With ``annotate=True`` every dispatch is additionally wrapped in
``torch.profiler.record_function(key)``, so inside a ``torch.profiler``
window the host span of each replay or admission sits around the kernels it
launched in the same Perfetto view. The import is lazy and failure-tolerant:
tracing never requires the profiler.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable

# ----------------------------------------------------------------- event kinds
# Request lifecycle edges (``rid`` is set):
EV_SUBMIT = "submit"          # request offered to the engine (or restored by resume)
EV_QUEUED = "queued"          # scheduler accepted / requeued after quarantine
EV_ADMIT = "admit"            # prefilled into a slot [bucket, cache hit, slot, gen]
EV_QUARANTINE = "quarantine"  # watchdog evicted the slot (requeue or terminal error)
EV_FINISH = "finish"          # terminal: retired with a finish_reason
EV_REJECT = "reject"          # terminal: never admitted (submit-time or deadline)

# Engine-level edges (``rid`` is None; ``seq`` pairs them up):
EV_DISPATCH = "dispatch"      # a dispatch (replay / admission) entered the pipeline
EV_FETCH = "fetch"            # its results were drained to the host (or discarded)

# Supervisor edges (``rid`` is None; `serving.supervisor`): a hang
# watchdog classification, an
# engine rebuild on the restart ladder, and an overload-brownout phase change
# (``phase`` = "enter" | "exit", strictly alternating starting inactive).
EV_STALL = "stall"            # heartbeat went stale past the stall timeout
EV_RESTART = "restart"        # engine rebuilt + journal-resumed [reason, attempt]
EV_BROWNOUT = "brownout"      # overload brownout entered/exited [phase, level]
EV_ANOMALY = "anomaly"        # detector fired/cleared [detector, phase, zscore]
#                               (serving/anomaly.py — enter may carry ``bundle``,
#                               the flight-recorder debug-bundle path)

# Cluster edges (the reference's serving/cluster.py, not ported yet; kept
# so traces of either package validate alike): ``rid`` is the ENGINE-level id on the replica whose tracer
# carries the event. Deliberately outside REQUEST_KINDS: a routed request's
# lifecycle on its replica stays a valid single-engine stream, and the
# cluster edges annotate placement without perturbing `validate`'s
# per-request schema.
EV_ROUTE = "route"            # router placed a submit [replica, policy, resumed]
EV_MIGRATE = "migrate"        # journal-backed move [from_replica, to_replica, resumed]
EV_SCALE = "scale"            # fleet size change [action, replica, target, actual]
#                               (serving/autoscaler.py — action = "up" |
#                               "retire" | "replace"; drain freezes ride
#                               EV_ANOMALY detector="autoscale_thrash")

TERMINAL_KINDS = frozenset({EV_FINISH, EV_REJECT})
REQUEST_KINDS = frozenset(
    {EV_SUBMIT, EV_QUEUED, EV_ADMIT, EV_QUARANTINE, EV_FINISH, EV_REJECT}
)
SUPERVISOR_KINDS = frozenset({EV_STALL, EV_RESTART, EV_BROWNOUT, EV_ANOMALY})
CLUSTER_KINDS = frozenset({EV_ROUTE, EV_MIGRATE, EV_SCALE})


@dataclass(frozen=True)
class TraceEvent:
    """One edge in the trace stream. ``ts`` is monotonic-clock seconds;
    ``rid`` is the request id for lifecycle edges and ``None`` for
    engine-level dispatch/fetch edges; ``data`` holds the edge's attributes
    (slot, gen, depth, bucket, seq, ...; the reference's
    ``docs/observability.md`` gives the full per-kind schema)."""

    ts: float
    kind: str
    rid: int | None
    data: dict[str, Any] = field(default_factory=dict)


class NullTracer:
    """The zero-overhead default: every method is a no-op and ``enabled`` is
    False so engine call sites can skip even argument construction. Stateless
    and shared — use the module-level :data:`NULL_TRACER` singleton."""

    enabled = False
    dropped = 0
    capacity = 0

    def emit(self, kind: str, rid: int | None = None, **data: Any) -> None:
        pass

    def events(self) -> list[TraceEvent]:
        return []

    def annotation(self, name: str):
        return nullcontext()

    def export(self, path: str | Path) -> dict[str, Any]:
        raise RuntimeError("cannot export from the disabled NullTracer; "
                           "pass a serving.Tracer to the engine")


NULL_TRACER = NullTracer()


class Tracer:
    """Bounded, deterministic event recorder.

    ``capacity`` caps the ring buffer (oldest events drop first, counted in
    ``dropped``); ``clock`` must be monotonic (injectable for tests);
    ``annotate=True`` wraps engine dispatches in
    ``torch.profiler.record_function`` so host spans appear in device
    profiles.
    """

    enabled = True

    def __init__(
        self,
        capacity: int = 1 << 16,
        *,
        clock: Callable[[], float] = time.perf_counter,
        annotate: bool = False,
    ):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._events: deque[TraceEvent] = deque()
        self.dropped = 0
        self.annotate = bool(annotate)
        self._annotation_cls = None
        self._seq = 0

    # ------------------------------------------------------------- recording
    def emit(self, kind: str, rid: int | None = None, **data: Any) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(TraceEvent(self._clock(), kind, rid, data))

    def next_seq(self) -> int:
        """Monotonic dispatch sequence number; pairs EV_DISPATCH with the
        EV_FETCH that later drains it."""
        seq = self._seq
        self._seq += 1
        return seq

    def events(self) -> list[TraceEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    # ------------------------------------------- device-profile interleaving
    def annotation(self, name: str):
        """A context manager wrapping one dispatch. With ``annotate=False``
        (default) this is a shared ``nullcontext``; with ``annotate=True`` it
        is ``torch.profiler.record_function(name)``, so the host span shows
        up around the dispatch's kernels when a ``torch.profiler`` window is
        open. The engine wraps a graph replay or an eager admission, never
        the inside of a graph capture."""
        if not self.annotate:
            return nullcontext()
        if self._annotation_cls is None:
            try:
                from torch.profiler import record_function
            except Exception:  # profiler unavailable: degrade, don't fail
                self.annotate = False
                return nullcontext()
            self._annotation_cls = record_function
        return self._annotation_cls(name)

    # -------------------------------------------------------------- analysis
    def validate(self) -> dict[str, Any]:
        return validate(self.events(), dropped=self.dropped)

    def export(self, path: str | Path) -> dict[str, Any]:
        """Write Chrome trace-event JSON to ``path`` (Perfetto-loadable) and
        return a summary dict ``{path, events, dropped, trace_events}``."""
        events = self.events()
        doc = to_chrome(events, dropped=self.dropped)
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc))
        return {
            "path": str(path),
            "events": len(events),
            "dropped": self.dropped,
            "trace_events": len(doc["traceEvents"]),
        }


# --------------------------------------------------------------------- helpers
def request_streams(events: Iterable[TraceEvent]) -> dict[int, list[TraceEvent]]:
    """Group lifecycle events into per-request streams (emission order
    preserved). Engine-level dispatch/fetch events are excluded — a request's
    *rides* are recovered from each dispatch event's ``reqs`` tuple."""
    streams: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.rid is not None and ev.kind in REQUEST_KINDS:
            streams.setdefault(ev.rid, []).append(ev)
    return streams


def validate(events: list[TraceEvent], *, dropped: int = 0) -> dict[str, Any]:
    """Check the trace-stream invariants the engine is contracted to uphold
    (the engine's tests assert these over the pipeline-depth x admit
    matrix, and exported files are re-checked through `load_exported`):

      - timestamps are globally non-decreasing (one monotonic clock);
      - every request stream opens with SUBMIT and ends with *exactly one*
        terminal event (FINISH or REJECT), with nothing after it. A
        ``recovered`` SUBMIT (emitted by `ServingEngine.resume` / the
        supervisor's restart ladder over a SHARED tracer) splits the stream
        into a new lifetime segment: each segment carries at most one
        terminal with nothing after it, and the final segment must end
        terminal — so a request that finished pre-restart and is then
        re-announced by recovery replay is one clean stream, not a
        duplicate-terminal anomaly;
      - ADMIT edges carry slot/generation, and an admitted request is
        eventually terminal;
      - supervisor edges are well-formed: STALL carries ``elapsed_s``,
        RESTART carries ``reason``/``attempt``, and BROWNOUT ``phase``
        enter/exit markers strictly alternate starting from inactive;
      - cluster edges are well-formed: ROUTE carries ``replica`` and
        MIGRATE carries ``from_replica``/``to_replica`` (placement
        annotations — they never alter per-request stream validity);
      - DISPATCH/FETCH pairs are balanced at every pipeline depth: fetches
        drain strictly in dispatch order (the in-flight queue is FIFO), every
        fetch matches a recorded dispatch, and only a *trailing* run of
        dispatches — work still in flight when the trace was read — may be
        unfetched; consequently every dispatch a request rode has its fetch;
      - a ring-buffer-truncated trace (``dropped > 0``) cannot prove stream
        completeness, so only clock monotonicity is checked and the result is
        flagged ``"truncated": True``.

    Returns ``{"clean": bool, "anomalies": [str], "requests": int,
    "events": int, "dropped": int, "truncated": bool}``.
    """
    anomalies: list[str] = []
    last_ts = float("-inf")
    for i, ev in enumerate(events):
        if ev.ts < last_ts:
            anomalies.append(
                f"event {i} ({ev.kind}) ts {ev.ts!r} < predecessor {last_ts!r}"
            )
        last_ts = ev.ts

    streams = request_streams(events)
    truncated = dropped > 0
    if not truncated:
        for rid, stream in sorted(streams.items()):
            if stream[0].kind != EV_SUBMIT:
                anomalies.append(f"rid {rid}: stream opens with {stream[0].kind}, "
                                 f"not {EV_SUBMIT}")
            # split into lifetime segments at each recovery-replay SUBMIT:
            # a restart re-announces the request on the shared tracer, so
            # "exactly one terminal" holds per segment, not per stream
            segments: list[list[TraceEvent]] = [[]]
            for ev in stream:
                if (ev.kind == EV_SUBMIT and ev.data.get("recovered")
                        and segments[-1]):
                    segments.append([])
                segments[-1].append(ev)
            for si, seg in enumerate(segments):
                terminals = [ev for ev in seg if ev.kind in TERMINAL_KINDS]
                final = si == len(segments) - 1
                if final and len(terminals) != 1:
                    anomalies.append(
                        f"rid {rid}: {len(terminals)} terminal events in "
                        f"final segment (want exactly 1)")
                elif len(terminals) > 1:
                    anomalies.append(
                        f"rid {rid}: {len(terminals)} terminal events in "
                        f"segment {si} (want at most 1)")
                elif terminals and seg[-1].kind not in TERMINAL_KINDS:
                    anomalies.append(f"rid {rid}: {seg[-1].kind} after "
                                     f"terminal {terminals[0].kind}")
            for ev in stream:
                if ev.kind == EV_ADMIT and ("slot" not in ev.data
                                            or "gen" not in ev.data):
                    anomalies.append(f"rid {rid}: admit without slot/gen")

        # supervisor edges: schema + brownout enter/exit alternation
        brownout_active = False
        anomaly_active: set[str] = set()
        for ev in events:
            if ev.kind == EV_STALL and "elapsed_s" not in ev.data:
                anomalies.append("stall without elapsed_s")
            elif ev.kind == EV_RESTART and not {"reason", "attempt"} <= set(ev.data):
                anomalies.append("restart without reason/attempt")
            elif ev.kind == EV_ANOMALY:
                # anomaly markers (serving/anomaly.py): per-detector strict
                # enter/exit alternation, the brownout convention
                det = ev.data.get("detector")
                phase = ev.data.get("phase")
                if det is None or phase not in ("enter", "exit"):
                    anomalies.append(f"anomaly without detector/phase: "
                                     f"{ev.data!r}")
                elif (phase == "enter") == (det in anomaly_active):
                    state = "active" if det in anomaly_active else "inactive"
                    anomalies.append(f"anomaly {phase} for {det!r} while "
                                     f"{state}")
                elif phase == "enter":
                    anomaly_active.add(det)
                else:
                    anomaly_active.discard(det)
            elif ev.kind == EV_BROWNOUT:
                phase = ev.data.get("phase")
                if phase not in ("enter", "exit"):
                    anomalies.append(f"brownout with phase {phase!r} "
                                     f"(want enter|exit)")
                elif (phase == "enter") == brownout_active:
                    anomalies.append(f"brownout {phase} while "
                                     f"{'active' if brownout_active else 'inactive'}")
                else:
                    brownout_active = phase == "enter"
            # cluster edges (serving/cluster.py): placement annotations
            # riding alongside the request stream — schema only
            elif ev.kind == EV_ROUTE and "replica" not in ev.data:
                anomalies.append("route without replica")
            elif (ev.kind == EV_MIGRATE
                  and not {"from_replica", "to_replica"} <= set(ev.data)):
                anomalies.append("migrate without from_replica/to_replica")

        # dispatch/fetch pairing
        dispatch_by_seq: dict[int, TraceEvent] = {}
        fetched: list[int] = []
        for ev in events:
            if ev.kind == EV_DISPATCH:
                seq = ev.data.get("seq")
                if seq is None:
                    anomalies.append("dispatch without seq")
                elif seq in dispatch_by_seq:
                    anomalies.append(f"duplicate dispatch seq {seq}")
                else:
                    dispatch_by_seq[seq] = ev
                # multi-token decode (tokens_per_sync): the attribute is
                # optional (older traces), but a present value must be a
                # positive iteration count
                if "tokens" in ev.data and int(ev.data["tokens"]) < 1:
                    anomalies.append(
                        f"dispatch seq {seq} with tokens {ev.data['tokens']}")
            elif ev.kind == EV_FETCH:
                seq = ev.data.get("seq")
                if seq not in dispatch_by_seq:
                    anomalies.append(f"fetch seq {seq!r} without dispatch")
                else:
                    fetched.append(seq)
                    # one fetch drains the WHOLE k-token dispatch (still
                    # FIFO, still seq-paired) — its tokens attribute, when
                    # both sides carry one, must echo the dispatch's
                    dt = dispatch_by_seq[seq].data.get("tokens")
                    ft = ev.data.get("tokens")
                    if dt is not None and ft is not None and dt != ft:
                        anomalies.append(
                            f"fetch seq {seq} tokens {ft} != dispatch {dt}")
                    # speculative verify pair: the dispatch proposed k drafts
                    # ("drafted"), so no slot can have accepted more than
                    # k + 1 tokens (k survivors + the always-emitted base)
                    drafted = dispatch_by_seq[seq].data.get("drafted")
                    accepted = ev.data.get("accepted")
                    if (drafted is not None and accepted is not None
                            and int(accepted) > int(drafted) + 1):
                        anomalies.append(
                            f"fetch seq {seq} accepted {accepted} > "
                            f"drafted {drafted} + 1")
        if fetched != sorted(fetched):
            anomalies.append("fetches drained out of dispatch (FIFO) order")
        if len(set(fetched)) != len(fetched):
            anomalies.append("dispatch fetched more than once")
        unfetched = sorted(set(dispatch_by_seq) - set(fetched))
        if unfetched and fetched and unfetched[0] < max(fetched):
            anomalies.append(
                f"non-trailing unfetched dispatch seqs {unfetched[:4]} "
                f"(pipeline skipped an in-flight entry)"
            )
        # per-request ride balance: every dispatch the request rode is fetched
        fetched_set = set(fetched)
        rode: dict[int, list[int]] = {}
        for seq, ev in dispatch_by_seq.items():
            for _slot, rid, _gen in ev.data.get("reqs", ()):
                rode.setdefault(rid, []).append(seq)
        for rid, seqs in sorted(rode.items()):
            missing = [s for s in seqs if s not in fetched_set]
            # trailing in-flight work is legitimate for a live engine, but a
            # *terminated* request must have every ride drained
            stream = streams.get(rid, [])
            if missing and stream and stream[-1].kind in TERMINAL_KINDS:
                anomalies.append(
                    f"rid {rid}: rode dispatch seqs {missing[:4]} never fetched"
                )

    return {
        "clean": not anomalies,
        "anomalies": anomalies,
        "requests": len(streams),
        "events": len(events),
        "dropped": dropped,
        "truncated": truncated,
    }


# ----------------------------------------------------------------- export path
_PID_REQUESTS = 1
_PID_ENGINE = 2
_PID_SLOTS = 3


def to_chrome(events: list[TraceEvent], *, dropped: int = 0) -> dict[str, Any]:
    """Render the raw stream as a Chrome trace-event JSON object (Perfetto /
    ``chrome://tracing`` loadable). Three synthetic "processes":

      - pid 1 *requests* — one thread per request id, with ``queued`` /
        ``prefill`` / ``serve`` duration spans and instant markers for
        terminal and quarantine edges;
      - pid 2 *engine* — async spans for every dispatch (name =
        compile key, ``[compile]`` suffix on first-dispatch compiles), begin
        at DISPATCH, end at the paired FETCH (pipelined spans overlap);
      - pid 3 *slots* — one thread per slot, a duration span per tenancy
        (admit → retire/quarantine) named by the occupying request.

    The raw events are embedded under ``accelerateTpuTrace`` (ignored by
    viewers) so `load_exported` can re-validate exported files.
    """
    out: list[dict[str, Any]] = []
    if events:
        t0 = min(ev.ts for ev in events)
    else:
        t0 = 0.0

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 3)

    def meta(pid: int, name: str) -> None:
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": name}})

    meta(_PID_REQUESTS, "requests")
    meta(_PID_ENGINE, "engine dispatches")
    meta(_PID_SLOTS, "slots")

    streams = request_streams(events)
    fetch_by_seq = {ev.data.get("seq"): ev for ev in events if ev.kind == EV_FETCH}

    # --- per-request spans -------------------------------------------------
    for rid, stream in sorted(streams.items()):
        out.append({"ph": "M", "pid": _PID_REQUESTS, "tid": rid,
                    "name": "thread_name", "args": {"name": f"req {rid}"}})
        for i, ev in enumerate(stream):
            nxt = stream[i + 1] if i + 1 < len(stream) else None
            if ev.kind == EV_QUEUED:
                end = nxt.ts if nxt is not None else ev.ts
                out.append({"ph": "X", "pid": _PID_REQUESTS, "tid": rid,
                            "name": "queued", "cat": "request",
                            "ts": us(ev.ts), "dur": max(0.0, us(end) - us(ev.ts)),
                            "args": {"rid": rid, **ev.data}})
            elif ev.kind == EV_ADMIT:
                end = nxt.ts if nxt is not None else ev.ts
                out.append({"ph": "X", "pid": _PID_REQUESTS, "tid": rid,
                            "name": f"serve slot{ev.data.get('slot')}",
                            "cat": "request", "ts": us(ev.ts),
                            "dur": max(0.0, us(end) - us(ev.ts)),
                            "args": {"rid": rid, **ev.data}})
                fetch = fetch_by_seq.get(ev.data.get("seq"))
                if fetch is not None:
                    out.append({"ph": "X", "pid": _PID_REQUESTS, "tid": rid,
                                "name": "prefill", "cat": "request",
                                "ts": us(ev.ts),
                                "dur": max(0.0, us(fetch.ts) - us(ev.ts)),
                                "args": {"rid": rid,
                                         "bucket": ev.data.get("bucket")}})
            elif ev.kind in TERMINAL_KINDS or ev.kind == EV_QUARANTINE:
                label = ev.data.get("reason", "")
                out.append({"ph": "i", "pid": _PID_REQUESTS, "tid": rid,
                            "name": f"{ev.kind}:{label}" if label else ev.kind,
                            "cat": "request", "ts": us(ev.ts), "s": "t",
                            "args": {"rid": rid, **ev.data}})

    # --- engine dispatch spans (async: pipelined spans overlap) ------------
    kind_tid = {"step": 1, "admit": 2, "cached_admit": 3}
    for ev in events:
        if ev.kind != EV_DISPATCH:
            continue
        seq = ev.data.get("seq")
        name = str(ev.data.get("key", ev.data.get("what", "dispatch")))
        if ev.data.get("compiled"):
            name += " [compile]"
        tid = kind_tid.setdefault(ev.data.get("what", "?"), len(kind_tid) + 1)
        base = {"cat": "dispatch", "id": seq, "pid": _PID_ENGINE, "tid": tid,
                "name": name}
        out.append({**base, "ph": "b", "ts": us(ev.ts), "args": dict(ev.data)})
        fetch = fetch_by_seq.get(seq)
        if fetch is not None:
            out.append({**base, "ph": "e", "ts": us(fetch.ts),
                        "args": dict(fetch.data)})

    # --- supervisor markers (stall / restart / brownout, engine-wide) ------
    for ev in events:
        if ev.kind not in SUPERVISOR_KINDS:
            continue
        label = ev.kind
        if ev.kind == EV_RESTART:
            label = f"restart:{ev.data.get('reason', '?')}"
        elif ev.kind == EV_BROWNOUT:
            label = f"brownout:{ev.data.get('phase', '?')}"
        elif ev.kind == EV_ANOMALY:
            label = (f"anomaly:{ev.data.get('detector', '?')}:"
                     f"{ev.data.get('phase', '?')}")
        out.append({"ph": "i", "pid": _PID_ENGINE, "tid": 0, "name": label,
                    "cat": "supervisor", "ts": us(ev.ts), "s": "p",
                    "args": dict(ev.data)})

    # --- slot tenancies ----------------------------------------------------
    open_tenancy: dict[int, tuple[float, int]] = {}  # slot -> (start_ts, rid)
    for ev in events:
        slot = ev.data.get("slot")
        if slot is None or ev.rid is None:
            continue
        if ev.kind == EV_ADMIT:
            open_tenancy[slot] = (ev.ts, ev.rid)
        elif ev.kind in (EV_FINISH, EV_QUARANTINE) and slot in open_tenancy:
            start, rid = open_tenancy.pop(slot)
            if rid != ev.rid:
                continue  # stale pairing; tenancy view is best-effort
            out.append({"ph": "X", "pid": _PID_SLOTS, "tid": slot,
                        "name": f"r{rid}", "cat": "slot", "ts": us(start),
                        "dur": max(0.0, us(ev.ts) - us(start)),
                        "args": {"rid": rid, "end": ev.kind}})

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "accelerateTpuTrace": {
            "version": 1,
            "dropped": dropped,
            "events": [[ev.ts, ev.kind, ev.rid, ev.data] for ev in events],
        },
    }


def load_exported(doc: dict[str, Any]) -> tuple[list[TraceEvent], int]:
    """Reconstruct ``(events, dropped)`` from an `export`-ed JSON document.
    Raises ``ValueError`` when the document is not one of ours."""
    section = doc.get("accelerateTpuTrace")
    if not isinstance(section, dict) or "events" not in section:
        raise ValueError("not an accelerate_tpu trace export "
                         "(missing accelerateTpuTrace section)")
    events = []
    for row in section["events"]:
        ts, kind, rid, data = row
        # JSON round-trips dict keys/lists fine, but tuples in "reqs" become
        # lists — normalize so validate() sees the shape emit() produced
        if "reqs" in data:
            data = {**data, "reqs": [tuple(r) for r in data["reqs"]]}
        events.append(TraceEvent(float(ts), str(kind),
                                 None if rid is None else int(rid), data))
    return events, int(section.get("dropped", 0))


def nearest_rank(ordered: list[float], q: float) -> float:
    """Nearest-rank quantile over a *sorted* sample list:
    ``ordered[max(0, ceil(q*n) - 1)]`` — the inverse-CDF convention
    `serving/metrics.py` histograms use. Shared here so per-request ITL p99
    (SLO attainment) and the reservoir quantiles agree by construction."""
    if not ordered:
        return 0.0
    n = len(ordered)
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    return ordered[idx]
