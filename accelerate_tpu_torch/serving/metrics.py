"""Serving counters and histograms: the port of the part of
`accelerate_tpu.serving.metrics` the port's engine feeds (requests,
generated and prefilled tokens, tokens/s, TTFT, inter-token latency, steps,
the overlapped dispatch's host-blocked time, depth, admission batch sizes
and tokens per fetch, the prefix cache's counters, the speculative verify
step's, the reliability and recovery counters: expiries, quarantines,
resumes and the journal's appends, the SLO goodput accounting, the per-step
phase timings, the compile count, the supervisor's counters and the front
door's stream and predictive-admission counters), the reference's flat
`ServingMetrics.snapshot` for them, `log_to`, which hands that snapshot to
any tracker with a ``log(values, step=)`` method, and `aggregate_snapshots`,
which combines a cluster's replica snapshots.
Histograms also keep exact counts over a fixed log-spaced bucket ladder, so
the Prometheus export (`serving.telemetry`) renders them as real histograms.
Host-side bookkeeping only; nothing here touches the device."""

from __future__ import annotations

import bisect
import math
import time
from typing import Any

from .trace import nearest_rank


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
    metrics read must never perturb per-request seeding), plus exact counts
    over a fixed log-spaced bucket ladder for the Prometheus histogram
    series (``_bucket``/``_sum``/``_count``)."""

    # 1-2-5 per decade, 1e-4 .. 5e4 (the reference's ladder): one shared
    # ladder keeps bucket counts of different engines addable key by key
    BUCKETS: tuple[float, ...] = tuple(
        m * (10.0 ** e) for e in range(-4, 5) for m in (1.0, 2.0, 5.0))

    def __init__(self, max_samples: int = 4096):
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._max_samples = int(max_samples)
        self._stride = 1
        self._samples: list[float] = []
        self._bucket_counts = [0] * len(self.BUCKETS)

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
        i = bisect.bisect_left(self.BUCKETS, value)
        if i < len(self._bucket_counts):
            self._bucket_counts[i] += 1
        # values past the last boundary land only in the implicit +Inf
        # bucket, whose cumulative count is `count` itself
        if self.count % self._stride == 0:
            self._samples.append(value)
            if len(self._samples) > self._max_samples:
                # decimate and double the stride: memory stays bounded while
                # the reservoir keeps spanning the whole stream
                self._samples = self._samples[::2]
                self._stride *= 2

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs (count of observations ``<=
        le``); boundaries whose cumulative count is still zero are omitted."""
        out: list[tuple[float, int]] = []
        cum = 0
        for le, n in zip(self.BUCKETS, self._bucket_counts):
            cum += n
            if cum:
                out.append((le, cum))
        return out

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

    Host-RAM KV tier (`serving.kv_tier`): ``host_page_ins`` and
    ``host_page_outs`` count KV blocks moved device <- host and device ->
    host, ``host_hibernated`` and ``host_wakeups`` whole requests parked and
    woken, ``host_thrash_events`` the thrash guard's freeze edges;
    ``host_page_in_s`` and ``host_page_out_s`` are each transfer's seconds
    (device time between CUDA events on the card, read once the copy is
    done), exported as ``serving/host_tier/page_in_s`` and ``page_out_s``.

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
    because of the restart.

    Observability (`serving.trace`, `serving.telemetry`): ``request_latency_s``
    (submit -> finish), ``queue_depth`` and ``slot_occupancy`` (sampled once a
    step by `observe_step`), the step-phase histograms ``step_phase_*_s`` and
    ``step_total_s`` (one `StepTimings` a step, `observe_step_phases`),
    ``compile_count``/``compile_s``/``compiles`` (`record_compile`: each CUDA
    graph capture and each dispatch that built or loaded a kernel library),
    and the SLO accounting (`observe_slo`, `goodput`). The supervisor
    (`serving.supervisor`) counts ``supervisor_restarts``, ``_stalls``,
    ``_storms``, ``_shed`` and ``_brownouts``, and keeps the
    ``supervisor_brownout_active`` gauge and ``supervisor_time_in_brownout_s``.

    Front door (`serving.frontend`): ``streams_opened`` and
    ``streams_finished`` count token streams, ``stream_events`` the events
    delivered; ``streamed_ttft_s`` is TTFT as a streaming caller sees it
    (submit -> first event read off the journal) and ``stream_lag_s`` that
    delivery's lag alone (journal append -> event); ``predicted_ttft_s``
    records every predictive-admission estimate and
    ``requests_shed_predicted`` the submissions rejected with
    ``REJECT_PREDICTED_TTFT``, per priority class in ``class_shed``
    (``serving/class/<p>/shed``). ``replica_occupancy`` is one slot-occupancy
    observation per replica a step (`observe_replicas`)."""

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
        # the host-RAM KV tier (serving.kv_tier)
        self.host_page_ins = Counter()
        self.host_page_outs = Counter()
        self.host_hibernated = Counter()
        self.host_wakeups = Counter()
        self.host_thrash_events = Counter()
        self.host_page_in_s = Histogram()
        self.host_page_out_s = Histogram()
        self.spec_proposed = Counter()
        self.spec_accepted = Counter()
        self.spec_forwards = Counter()
        self.spec_tokens = Counter()
        self.steps = Counter()
        self.decode_dispatches = Counter()
        self.decode_steps = Counter()
        # the supervisor's ladder and brownout (serving.supervisor)
        self.supervisor_restarts = Counter()
        self.supervisor_stalls = Counter()
        self.supervisor_storms = Counter()
        self.supervisor_shed = Counter()
        self.supervisor_brownouts = Counter()
        self.supervisor_brownout_active = 0
        self.supervisor_time_in_brownout_s = 0.0
        # compiles: a CUDA graph capture, or a dispatch that built or loaded
        # a kernel library, keyed ``kind[pb{N}b{M}]``
        self.compile_count = Counter()
        self.compile_s = Histogram()
        self.compiles: dict[str, float] = {}
        self.ttft_s = Histogram()
        self.ttft_hit_s = Histogram()
        self.ttft_miss_s = Histogram()
        self.inter_token_s = Histogram()
        self.request_latency_s = Histogram()
        self.host_blocked_s = Histogram()
        self.queue_depth = Histogram()
        self.slot_occupancy = Histogram()
        self.dispatch_depth = Histogram()
        self.admit_batch_size = Histogram()
        self.tokens_per_dispatch = Histogram()
        self.spec_accept_len = Histogram()
        # SLO goodput: tokens of requests that attained their SLO, and the
        # per-class counters {"requests", "attained", "ttft_miss", "itl_miss",
        # "goodput_tokens"} keyed by SLOSpec.name
        self.goodput_tokens = Counter()
        self.slo_classes: dict[str, dict[str, int]] = {}
        # one observation a step of each phase of `ServingEngine.step`
        self.step_phase_schedule_s = Histogram()
        self.step_phase_draft_s = Histogram()
        self.step_phase_dispatch_s = Histogram()
        self.step_phase_fetch_blocked_s = Histogram()
        self.step_phase_deliver_s = Histogram()
        self.step_phase_journal_s = Histogram()
        self.step_phase_telemetry_s = Histogram()
        self.step_total_s = Histogram()
        # the front door (serving.frontend)
        self.streams_opened = Counter()
        self.streams_finished = Counter()
        self.stream_events = Counter()
        self.streamed_ttft_s = Histogram()
        self.stream_lag_s = Histogram()
        self.predicted_ttft_s = Histogram()
        self.requests_shed_predicted = Counter()
        self.class_shed: dict[int, int] = {}
        self.replica_occupancy = Histogram()
        self._start: float | None = None
        # rate window: tokens_per_sec() and goodput() measure from the later
        # of mark_start() and the last reset_rate_window()
        self._win_t0: float | None = None
        self._win_tokens = 0
        self._win_goodput = 0

    def mark_start(self) -> None:
        """First-event clock for the aggregate tokens/sec rate."""
        if self._start is None:
            self._start = time.perf_counter()
            self._win_t0 = self._start

    def reset_rate_window(self) -> None:
        """Start a fresh rate window: `tokens_per_sec` and the goodput rate
        count only tokens generated after this call. Cumulative counters and
        histograms are untouched."""
        self._win_t0 = time.perf_counter()
        self._win_tokens = self.tokens_generated.value
        self._win_goodput = self.goodput_tokens.value

    def observe_slo(self, slo: Any, *, clean: bool, ttft_ok: bool, itl_ok: bool,
                    tokens: int) -> bool:
        """Record one terminal request's SLO outcome; returns attainment.
        ``slo`` is the request's `request.SLOSpec` or None (unconstrained:
        attains iff the finish was clean, tracked under no class); ``clean``
        means EOS or length; ``tokens`` (the tokens it generated) count as
        goodput only on attainment."""
        attained = clean and ttft_ok and itl_ok
        if slo is not None:
            cls = self.slo_classes.setdefault(
                slo.name, {"requests": 0, "attained": 0, "ttft_miss": 0, "itl_miss": 0,
                           "goodput_tokens": 0})
            cls["requests"] += 1
            cls["attained"] += int(attained)
            cls["ttft_miss"] += int(not ttft_ok)
            cls["itl_miss"] += int(not itl_ok)
            cls["goodput_tokens"] += tokens if attained else 0
        if attained:
            self.goodput_tokens.inc(tokens)
        return attained

    def goodput(self) -> dict[str, Any]:
        """SLO goodput over the current rate window: goodput tokens/sec,
        attainment across SLO-carrying requests (1.0 when none carried one)
        and the per-class counter dicts with their attainment."""
        slo_requests = sum(c["requests"] for c in self.slo_classes.values())
        slo_attained = sum(c["attained"] for c in self.slo_classes.values())
        win = self._win_t0 if self._win_t0 is not None else self._start
        dt = (time.perf_counter() - win) if win is not None else 0.0
        gp_tokens = self.goodput_tokens.value - self._win_goodput
        return {
            "goodput_tokens": self.goodput_tokens.value,
            "goodput_tokens_per_sec": gp_tokens / dt if dt > 0 else 0.0,
            "slo_requests": slo_requests,
            "slo_attainment": slo_attained / slo_requests if slo_requests else 1.0,
            "classes": {
                name: {**stats, "attainment": (stats["attained"] / stats["requests"]
                                               if stats["requests"] else 1.0)}
                for name, stats in sorted(self.slo_classes.items())
            },
        }

    def observe_shed(self, priority: int) -> None:
        """One predictive-admission rejection (`REJECT_PREDICTED_TTFT`),
        counted under its priority class."""
        self.requests_shed_predicted.inc()
        p = int(priority)
        self.class_shed[p] = self.class_shed.get(p, 0) + 1

    def observe_replicas(self, active_per_replica: list[int], capacity: int) -> None:
        """One step's slot occupancy of each replica (``capacity`` slots
        each)."""
        for active in active_per_replica:
            self.replica_occupancy.observe(active / capacity if capacity else 0.0)

    def observe_step(self, active: int, capacity: int, queue_depth: int) -> None:
        """One engine step: the step count, slot occupancy and queue depth."""
        self.steps.inc()
        self.slot_occupancy.observe(active / capacity if capacity else 0.0)
        self.queue_depth.observe(queue_depth)

    def observe_step_phases(self, t: Any) -> None:
        """Record one step's phase breakdown (a `StepTimings`, or any object
        with the phase attributes) into the per-phase histograms."""
        self.step_phase_schedule_s.observe(t.schedule_s)
        self.step_phase_draft_s.observe(t.draft_s)
        self.step_phase_dispatch_s.observe(t.dispatch_s)
        self.step_phase_fetch_blocked_s.observe(t.fetch_blocked_s)
        self.step_phase_deliver_s.observe(t.deliver_s)
        self.step_phase_journal_s.observe(t.journal_s)
        self.step_phase_telemetry_s.observe(t.telemetry_s)
        self.step_total_s.observe(t.total_s)

    def record_compile(self, key: str, seconds: float) -> None:
        """One compile: a CUDA graph capture, or the dispatch that built or
        loaded a kernel library, keyed ``kind[pb{prompt_bucket}b{batch}]``."""
        self.compile_count.inc()
        self.compile_s.observe(seconds)
        self.compiles[key] = round(float(seconds), 4)

    def tokens_per_sec(self) -> float:
        """Generated tokens per wall second over the current rate window
        (since the first submit without `reset_rate_window`)."""
        if self._start is None:
            return 0.0
        win = self._win_t0 if self._win_t0 is not None else self._start
        dt = time.perf_counter() - win
        n = self.tokens_generated.value - self._win_tokens
        return n / dt if dt > 0 else 0.0

    def snapshot(self) -> dict[str, Any]:
        """Flat scalar dict under the reference's ``serving/...`` and
        ``supervisor/...`` keys: every counter the reference exports (the
        port's own ``decode_dispatches`` and ``decode_steps`` are read as
        attributes, not exported), ``tokens_per_sec``,
        ``accepted_tokens_per_forward``, the goodput and per-class SLO keys,
        each compile's seconds, and each histogram's `Histogram.summary` as
        ``serving/<name>/<stat>`` (with ``/sum`` and the cumulative
        ``/bucket/<le>`` counts once observed)."""
        out: dict[str, Any] = {
            f"serving/{name}": getattr(self, name).value for name in (
                "requests_submitted", "requests_rejected", "requests_finished",
                "requests_expired", "requests_cancelled", "requests_retried", "steps_poisoned",
                "journal_records", "journal_bytes", "journal_compactions", "requests_resumed",
                "requests_restored", "replayed_tokens", "tokens_generated", "prefill_tokens",
                "prefix_hits", "prefix_misses", "prefix_tokens_reused", "prefix_blocks_donated",
                "prefix_evictions", "steps", "compile_count", "spec_proposed", "spec_accepted",
                "spec_forwards", "spec_tokens", "streams_opened", "streams_finished",
                "stream_events", "requests_shed_predicted")
        }
        for name in ("page_ins", "page_outs", "hibernated", "wakeups", "thrash_events"):
            out[f"serving/host_tier/{name}"] = getattr(self, f"host_{name}").value
        out["serving/tokens_per_sec"] = self.tokens_per_sec()
        out["serving/accepted_tokens_per_forward"] = (
            self.spec_tokens.value / self.spec_forwards.value if self.spec_forwards.value else 0.0)
        out.update({
            "supervisor/restarts": self.supervisor_restarts.value,
            "supervisor/stalls_detected": self.supervisor_stalls.value,
            "supervisor/storms_detected": self.supervisor_storms.value,
            "supervisor/shed_requests": self.supervisor_shed.value,
            "supervisor/brownouts": self.supervisor_brownouts.value,
            "supervisor/brownout_active": int(self.supervisor_brownout_active),
            "supervisor/time_in_brownout_s": round(float(self.supervisor_time_in_brownout_s), 6),
        })
        gp = self.goodput()
        out["serving/goodput_tokens"] = gp["goodput_tokens"]
        out["serving/goodput_tokens_per_sec"] = gp["goodput_tokens_per_sec"]
        out["serving/slo_attainment"] = gp["slo_attainment"]
        for name, stats in gp["classes"].items():
            for stat in ("requests", "attained", "attainment", "ttft_miss", "itl_miss",
                         "goodput_tokens"):
                out[f"serving/slo/{name}/{stat}"] = stats[stat]
        for key, seconds in self.compiles.items():
            out[f"serving/compile/{key}"] = seconds
        for p, n in sorted(self.class_shed.items()):
            out[f"serving/class/{p}/shed"] = n
        for name in ("replica_occupancy", "compile_s", "ttft_s", "ttft_hit_s", "ttft_miss_s", "inter_token_s",
                     "request_latency_s", "host_blocked_s", "queue_depth", "slot_occupancy",
                     "dispatch_depth", "admit_batch_size", "tokens_per_dispatch",
                     "spec_accept_len", "streamed_ttft_s", "stream_lag_s", "predicted_ttft_s",
                     "step_phase_schedule_s", "step_phase_draft_s",
                     "step_phase_dispatch_s", "step_phase_fetch_blocked_s",
                     "step_phase_deliver_s", "step_phase_journal_s", "step_phase_telemetry_s",
                     "step_total_s", "host_tier/page_in_s", "host_tier/page_out_s"):
            hist = getattr(self, name.replace("host_tier/", "host_"))
            for stat, value in hist.summary().items():
                out[f"serving/{name}/{stat}"] = value
            if hist.count:
                # the exact series of the Prometheus histogram exposition
                out[f"serving/{name}/sum"] = hist.sum
                for le, cum in hist.buckets():
                    out[f"serving/{name}/bucket/{le:g}"] = cum
        return out

    def log_to(self, tracker: Any, step: int | None = None) -> None:
        """Emit the snapshot through a tracker (anything with
        ``log(values, step=)``)."""
        tracker.log(self.snapshot(), step=step)


# Histogram-summary stat suffixes (`Histogram.summary`): summing any of these
# is wrong, so `aggregate_snapshots` treats them apart
_HIST_WEIGHTED = ("mean", "p50", "p90", "p99")
_HIST_MIN = ("min",)
_HIST_MAX = ("max",)


def aggregate_snapshots(snapshots: list[dict[str, Any]]) -> dict[str, Any]:
    """Combine per-replica `ServingMetrics.snapshot` dicts into one cluster
    total (the `serving.cluster` metrics view), as the reference does.

    Counters and rates sum: a cluster's tokens/s is the sum of its
    replicas'. For each histogram ``<base>/<stat>``: ``count`` sums,
    ``min``/``max`` take the extremes, and ``mean``/``p50``/``p90``/``p99``
    the count-weighted average (exact for the mean, an approximation for the
    quantiles: the reservoirs are not merged). Ratio keys are recomputed
    from their summed parts (``slo_attainment``, each class's
    ``attainment``, ``accepted_tokens_per_forward``). A non-numeric value
    keeps the first replica's."""
    present: dict[str, list[tuple[dict[str, Any], Any]]] = {}
    for snap in snapshots:
        for key, value in snap.items():
            present.setdefault(key, []).append((snap, value))
    out: dict[str, Any] = {}
    for key, entries in present.items():
        values = [v for _, v in entries]
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
            out[key] = values[0]
            continue
        base, _, stat = key.rpartition("/")
        if stat in _HIST_WEIGHTED and base:
            weights = [snap.get(f"{base}/count", 0) for snap, _ in entries]
            total = sum(weights)
            out[key] = (sum(w * v for w, v in zip(weights, values)) / total
                        if total else 0.0)
        elif stat in _HIST_MIN and base:
            out[key] = min(values)
        elif stat in _HIST_MAX and base:
            out[key] = max(values)
        else:
            out[key] = sum(values)
    forwards = out.get("serving/spec_forwards", 0)
    if "serving/accepted_tokens_per_forward" in out:
        out["serving/accepted_tokens_per_forward"] = (
            out.get("serving/spec_tokens", 0) / forwards if forwards else 0.0)
    cls_requests = 0
    cls_attained = 0
    for key in list(out):
        if key.startswith("serving/slo/") and key.endswith("/attainment"):
            base = key[: -len("/attainment")]
            requests = out.get(f"{base}/requests", 0)
            attained = out.get(f"{base}/attained", 0)
            out[key] = attained / requests if requests else 1.0
            cls_requests += requests
            cls_attained += attained
    if "serving/slo_attainment" in out:
        out["serving/slo_attainment"] = cls_attained / cls_requests if cls_requests else 1.0
    return out
