"""Anomaly detection and the flight recorder: the port of
`accelerate_tpu.serving.anomaly`, detector for detector.

The serving stack records everything (traces, metrics, telemetry, journal),
but nothing *watches* it: a tail-latency regression would be found by a
human reading dashboards after the trace ring had wrapped past the
interesting window. `AnomalyMonitor` runs deterministic windowed detectors
over the engine's own health signals (ITL p99, TTFT p99, queue depth, free
KV blocks, goodput). On a trigger it emits an `EV_ANOMALY` trace marker and
cuts a **debug bundle**: one atomically written JSON file freezing the last
N trace events, the metrics snapshot, `memory_stats()`,
`capacity_headroom()`, the scheduler queue, the journal append frontier and
the most recent step-phase breakdown.

Detector design (host-side, no RNG, no wall-clock reads in the decision
path: deterministic given the sample sequence):

  - each sample is EWMA-smoothed (``ewma_alpha``; 1.0 disables) and scored
    with a **robust z**: ``(x - median) / max(1.4826 * MAD, |median| * 1e-3,
    1e-9)`` over a bounded baseline window, median/MAD so one earlier spike
    cannot inflate the spread and mask the next one;
  - entry and exit are **hysteretic** like the supervisor's brownout:
    ``enter_steps`` consecutive out-of-band samples arm, then ``exit_steps``
    consecutive samples inside ``zscore * exit_fraction`` disarm;
  - while a detector is active its baseline window is **frozen**, and
    samples that scored anomalous are never added to it.

The zero-overhead default mirrors `NULL_TRACER`/`NULL_TELEMETRY`: engines
carry `NULL_ANOMALY`, and the only per-step cost of the feature being off is
one ``self.anomaly.enabled`` attribute read in `ServingEngine.step`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterator

from .trace import EV_ANOMALY

__all__ = [
    "AnomalyConfig",
    "AnomalyMonitor",
    "Detector",
    "NullAnomalyMonitor",
    "NULL_ANOMALY",
    "BUNDLE_FORMAT",
]

# debug-bundle file format tag, bumped on schema changes
BUNDLE_FORMAT = "accelerate_tpu/anomaly-bundle-v1"

# (name, direction, floor): the engine signals `observe` samples each step.
# direction "high" fires on values far ABOVE baseline (latencies, queue),
# "low" on collapses BELOW it (free blocks, goodput). ``floor`` suppresses
# high-direction triggers while the absolute value is still trivially small
# (a queue going 0 -> 3 is statistically wild but operationally nothing).
DETECTOR_SPECS: tuple[tuple[str, str, float], ...] = (
    ("itl_p99_s", "high", 0.0),
    ("ttft_p99_s", "high", 0.0),
    ("queue_depth", "high", 4.0),
    ("blocks_free", "low", 0.0),
    ("goodput_tokens_per_sec", "low", 0.0),
)


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Detector sizing and flight-recorder knobs (the reference's).

    ``window``/``min_samples`` size the robust-z baseline; ``zscore`` is the
    trigger threshold on the robust z-score (median/MAD units — 6.0 is far
    out on any plausible latency distribution, deliberately conservative);
    ``enter_steps``/``exit_steps``/``exit_fraction`` are the brownout-style
    hysteresis. ``bundle_dir`` enables the flight recorder (None = markers
    only); ``bundle_events`` caps the trace tail embedded per bundle;
    ``bundle_min_interval_s`` rate-limits bundle writes (measured on the
    monitor's injected clock) so a flapping fleet cannot fill a disk.
    """

    window: int = 64
    min_samples: int = 8
    zscore: float = 6.0
    ewma_alpha: float = 1.0
    enter_steps: int = 3
    exit_steps: int = 8
    exit_fraction: float = 0.5
    observe_every: int = 1
    bundle_dir: str | os.PathLike | None = None
    bundle_events: int = 256
    bundle_min_interval_s: float = 60.0


class Detector:
    """One watched signal: robust-z scoring over a bounded baseline window
    with hysteretic enter/exit. Pure function of its sample sequence."""

    def __init__(self, name: str, direction: str, config: AnomalyConfig,
                 floor: float = 0.0):
        if direction not in ("high", "low"):
            raise ValueError(f"direction must be 'high' or 'low', got {direction!r}")
        self.name = name
        self.direction = direction
        self.floor = float(floor)
        self.cfg = config
        self.window: deque[float] = deque(maxlen=config.window)
        self.active = False
        self.trips = 0
        self.last: dict[str, float] = {}
        self._ewma: float | None = None
        self._hot = 0
        self._calm = 0

    def update(self, raw: float) -> str | None:
        """Feed one sample; returns "enter"/"exit" on a state edge, else None."""
        raw = float(raw)
        a = self.cfg.ewma_alpha
        x = raw if self._ewma is None else a * raw + (1.0 - a) * self._ewma
        self._ewma = x
        if len(self.window) < self.cfg.min_samples:
            self.window.append(x)
            return None
        ordered = sorted(self.window)
        med = _median(ordered)
        mad = _median(sorted(abs(v - med) for v in ordered))
        scale = max(1.4826 * mad, abs(med) * 1e-3, 1e-9)
        z = (x - med) / scale
        score = z if self.direction == "high" else -z
        if self.direction == "high" and x <= self.floor:
            score = 0.0
        self.last = {"value": raw, "smoothed": x, "median": med,
                     "zscore": z, "score": score}
        if not self.active:
            if score > self.cfg.zscore:
                self._hot += 1
                if self._hot >= self.cfg.enter_steps:
                    self.active = True
                    self.trips += 1
                    self._hot = self._calm = 0
                    return "enter"
            else:
                self._hot = 0
                self.window.append(x)
            return None
        # active: baseline frozen; exit needs exit_steps consecutive samples
        # comfortably back inside the band (hysteresis, brownout-style)
        if score <= self.cfg.zscore * self.cfg.exit_fraction:
            self._calm += 1
            if self._calm >= self.cfg.exit_steps:
                self.active = False
                self._calm = 0
                self.window.append(x)
                return "exit"
        else:
            self._calm = 0
        return None


def _median(ordered: list[float]) -> float:
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


class AnomalyMonitor:
    """The engine-facing watcher: one `observe(engine)` per step samples the
    standard signals (DETECTOR_SPECS) through `ingest`, which runs the
    detector and — on an enter edge — emits `EV_ANOMALY` on the engine's
    tracer and cuts a rate-limited debug bundle.

    ``clock`` (monotonic) feeds the rate limiter and age gauges; ``wall_clock``
    only stamps bundles. Both injectable so every test is deterministic.
    Bundle writes are atomic (tmp + fsync + `os.replace` in the target dir) —
    a crash mid-write leaves no partial bundle — and a write failure is
    swallowed into ``bundle_errors``: the flight recorder must never take the
    serving loop down with it.
    """

    enabled = True

    def __init__(
        self,
        config: AnomalyConfig | None = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.config = config or AnomalyConfig()
        self._clock = clock
        self._wall = wall_clock
        self.detectors: dict[str, Detector] = {
            name: Detector(name, direction, self.config, floor)
            for name, direction, floor in DETECTOR_SPECS
        }
        self._tick = 0
        self.events = 0
        self.bundles_written = 0
        self.bundle_errors = 0
        self.last_event_t: float | None = None
        self.last_bundle_t: float | None = None
        self.last_bundle_path: str | None = None

    # ------------------------------------------------------------- observing
    @property
    def active(self) -> list[str]:
        return sorted(n for n, d in self.detectors.items() if d.active)

    def observe(self, engine: Any) -> list[dict[str, Any]]:
        """Sample the engine's health signals once; returns the state-edge
        dicts (usually empty). Called from `ServingEngine.step` when enabled."""
        self._tick += 1
        every = self.config.observe_every
        if every > 1 and self._tick % every:
            return []
        edges = []
        for name, value in self._samples(engine):
            info = self.ingest(name, value, engine)
            if info is not None:
                edges.append(info)
        return edges

    def _samples(self, engine: Any) -> Iterator[tuple[str, float]]:
        m = engine.metrics
        # latency signals only once they have data — a window of synthetic
        # zeros would make the first real sample look anomalous
        if m.inter_token_s.count:
            yield "itl_p99_s", m.inter_token_s.quantile(0.99)
        if m.ttft_s.count:
            yield "ttft_p99_s", m.ttft_s.quantile(0.99)
        yield "queue_depth", float(engine.scheduler.queue_depth)
        alloc = getattr(engine, "_allocator", None)
        if alloc is not None:
            yield "blocks_free", float(alloc.free_count)
        yield ("goodput_tokens_per_sec",
               float(m.goodput()["goodput_tokens_per_sec"]))

    def ingest(self, name: str, value: float, engine: Any = None
               ) -> dict[str, Any] | None:
        """Feed one sample to one detector (creating a high-direction
        detector for unknown names — tests and custom signals). Returns the
        edge info dict on enter/exit, else None."""
        det = self.detectors.get(name)
        if det is None:
            det = self.detectors[name] = Detector(name, "high", self.config)
        edge = det.update(value)
        if edge is None:
            return None
        self.events += 1
        self.last_event_t = self._clock()
        info: dict[str, Any] = {"detector": name, "phase": edge,
                                **{k: round(float(v), 6)
                                   for k, v in det.last.items()}}
        bundle = None
        if edge == "enter":
            bundle = self._maybe_write_bundle(name, det, engine)
            info["bundle"] = bundle
        tracer = getattr(engine, "tracer", None) if engine is not None else None
        if tracer is not None and getattr(tracer, "enabled", False):
            extra = {"bundle": bundle} if bundle else {}
            tracer.emit(EV_ANOMALY, None, detector=name, phase=edge,
                        value=round(float(value), 6),
                        zscore=round(float(det.last.get("zscore", 0.0)), 3),
                        **extra)
        return info

    # ------------------------------------------------------ flight recorder
    def _maybe_write_bundle(self, name: str, det: Detector, engine: Any
                            ) -> str | None:
        cfg = self.config
        if cfg.bundle_dir is None or engine is None:
            return None
        now = self._clock()
        if (self.last_bundle_t is not None
                and now - self.last_bundle_t < cfg.bundle_min_interval_s):
            return None  # rate-limited: the first bundle has the evidence
        try:
            bundle = self._collect(name, det, engine)
            path = (Path(cfg.bundle_dir)
                    / f"anomaly-{self.bundles_written:04d}-{name}.json")
            path.parent.mkdir(parents=True, exist_ok=True)
            _atomic_write_json(path, bundle)
        except Exception:
            self.bundle_errors += 1
            return None
        self.last_bundle_t = now
        self.bundles_written += 1
        self.last_bundle_path = str(path)
        return str(path)

    def _collect(self, name: str, det: Detector, engine: Any
                 ) -> dict[str, Any]:
        from .telemetry import sanitize_scalars

        tracer = getattr(engine, "tracer", None)
        tail: list[list[Any]] = []
        if tracer is not None and getattr(tracer, "enabled", False):
            events = tracer.events()[-self.config.bundle_events:]
            tail = [[ev.ts, ev.kind, ev.rid, ev.data] for ev in events]
        metrics = getattr(engine, "metrics", None)
        mem = getattr(engine, "memory_stats", None)
        head = getattr(engine, "capacity_headroom", None)
        scheduler = getattr(engine, "scheduler", None)
        queue: list[dict[str, Any]] = []
        if scheduler is not None and hasattr(scheduler, "snapshot_queue"):
            from .journal import request_record
            queue = [request_record(r) for r in scheduler.snapshot_queue()]
        journal = getattr(engine, "journal", None)
        jinfo = None
        if journal is not None:
            jinfo = {
                "path": str(journal.path),
                "tail_offset": int(getattr(journal, "tail_offset", 0)),
                "bytes_written": int(getattr(journal, "bytes_written", 0)),
            }
        return {
            "format": BUNDLE_FORMAT,
            "ts": self._wall(),
            "step": int(getattr(engine, "_step_count", 0)),
            "trigger": {"detector": name, "direction": det.direction,
                        **{k: round(float(v), 6)
                           for k, v in det.last.items()}},
            "active": self.active,
            "trace_tail": tail,
            "metrics": (sanitize_scalars(metrics.snapshot())
                        if metrics is not None else {}),
            "memory_stats": sanitize_scalars(mem()) if callable(mem) else {},
            "capacity_headroom": (sanitize_scalars(head())
                                  if callable(head) else {}),
            "queue": queue,
            "journal": jinfo,
            "step_timings": dict(getattr(engine, "last_step_timings", {}) or {}),
        }

    # ------------------------------------------------------------- reporting
    def gauges(self) -> dict[str, Any]:
        """Flat telemetry gauges, merged into `TelemetryExporter.sample`
        points under ``anomaly/``. The bundle path and detector names are
        strings: JSONL only (the Prometheus renderer drops non-numeric
        values by design)."""
        active = self.active
        out: dict[str, Any] = {
            "anomaly/active": len(active),
            "anomaly/events": self.events,
            "anomaly/bundles": self.bundles_written,
            "anomaly/bundle_errors": self.bundle_errors,
        }
        if active:
            out["anomaly/active_detectors"] = ",".join(active)
        if self.last_event_t is not None:
            out["anomaly/last_event_age_s"] = round(
                max(0.0, self._clock() - self.last_event_t), 6)
        if self.last_bundle_path is not None:
            out["anomaly/last_bundle"] = self.last_bundle_path
        return out


def _atomic_write_json(path: Path, doc: dict[str, Any]) -> None:
    """tmp-in-target-dir + flush + fsync + `os.replace`: a reader never sees
    a partial bundle, and a crash mid-write leaves only the final file or
    nothing (the tmp is unlinked on any failure)."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"), allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class NullAnomalyMonitor:
    """Inert default, the `NULL_TRACER` pattern: `ServingEngine.step`'s only
    cost with anomaly detection off is one ``enabled`` attribute read."""

    enabled = False
    detectors: dict[str, Detector] = {}
    active: list[str] = []
    last_bundle_path = None

    def observe(self, engine: Any) -> list[dict[str, Any]]:
        return []

    def ingest(self, name: str, value: float, engine: Any = None) -> None:
        return None

    def gauges(self) -> dict[str, Any]:
        return {}


NULL_ANOMALY = NullAnomalyMonitor()
