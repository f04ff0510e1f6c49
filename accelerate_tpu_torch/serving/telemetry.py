"""Continuous serving telemetry: the port of `accelerate_tpu.serving.telemetry`.
Memory and capacity gauges sampled on a cadence, exported as Prometheus text
and a JSONL time series.

The tracer (`serving.trace`) answers *where did THIS request's latency go*;
the metrics (`serving.metrics`) answer *how is the engine doing right now*.
This module answers *how is the engine doing over time, and how close is it
to the wall*: a `TelemetryExporter` polled from the engine's step loop
samples `ServingMetrics.snapshot()` plus the live gauges of
`ServingEngine.memory_stats` and `ServingEngine.capacity_headroom` into a
bounded ring of time-series points, and exports them three ways:

  - **Prometheus text-exposition format**: `prometheus_text()` /
    `write_prometheus(path)` (atomic tmp + rename, so a scraper never reads a
    torn file), optionally served live by a stdlib `http.server` endpoint on
    127.0.0.1 (`serve_http(port)` -> bound port, GET /metrics). Dependency
    free both ways: `parse_prometheus_text` round-trips the output;
  - **JSONL time series**: one `json.dumps` line per sample, with ``_step``
    and ``_ts`` bookkeeping keys;
  - the ring itself: `points()` / `latest()` for in-process consumers.

Design constraints, shared with the tracer:

  - **zero overhead by default**: an engine built without telemetry gets the
    `NULL_TELEMETRY` singleton (``enabled`` is False); the single guard in
    `ServingEngine.step` is a plain attribute read;
  - **bounded**: the ring caps memory (`TelemetryConfig.capacity`); once full
    the oldest point drops and ``exporter.dropped`` counts the loss;
  - **host-side only**: sampling reads host mirrors, allocation-time
    constants and the CUDA allocator's counters; it never waits on the
    stream;
  - **non-finite values never escape**: NaN/Inf gauges serialize as JSON null
    and are dropped from the Prometheus text.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any

__all__ = [
    "TelemetryConfig",
    "TelemetryExporter",
    "NullTelemetry",
    "NULL_TELEMETRY",
    "finite_or_none",
    "sanitize_scalars",
    "prometheus_name",
    "to_prometheus_text",
    "parse_prometheus_text",
]

# every exported metric is namespaced; '/'-separated gauge keys sanitize into
# this prefix + underscores (serving/mem/pool -> accelerate_tpu_serving_mem_pool),
# the reference's names, so one dashboard reads either package
PROM_NAMESPACE = "accelerate_tpu"

# the quantized-serving gauge family (`ServingEngine.quant_stats`, lifted out
# of the memory_stats namespace by `sample` below), emitted only when a
# quantized mode is active. Keep it in sync with quant_stats.
QUANT_GAUGES = (
    "serving/quant/weight_bits",
    "serving/quant/weight_packed_bytes",
    "serving/quant/weight_dense_bytes",
    "serving/quant/weight_saved_bytes",
    "serving/quant/kv_bits",
    "serving/quant/kv_payload_bytes",
    "serving/quant/kv_scale_bytes",
)


# ------------------------------------------------------- non-finite guard
def finite_or_none(value: Any) -> Any:
    """NaN/Inf floats -> None (JSON null); everything else unchanged."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def sanitize_scalars(values: dict) -> dict:
    """Copy of ``values`` with every non-finite float replaced by None, so
    `json.dumps(..., allow_nan=False)` can hold the line downstream."""
    return {k: finite_or_none(v) for k, v in values.items()}


# ------------------------------------------------------- Prometheus text
def prometheus_name(key: str) -> str:
    """Sanitize a ``serving/...`` gauge key into a legal Prometheus metric
    name: every char outside ``[a-zA-Z0-9_]`` becomes ``_``, a leading digit
    gets a ``_`` escape, and the result is namespaced under
    ``accelerate_tpu_``."""
    name = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in key)
    if name and name[0].isdigit():
        name = "_" + name
    return f"{PROM_NAMESPACE}_{name}"


# per-replica gauge namespace (`serving.cluster`, a telemetry source through
# `ServingCluster.replica_samples`): a cluster point carries each replica's
# gauges under this prefix; the Prometheus render turns the
# prefix into a {replica="i"} label so per-replica and cluster-total series
# share a metric name without colliding
_REPLICA_PREFIX = re.compile(r"^replica(\d+)/(.+)$")


def to_prometheus_text(values: dict) -> str:
    """Text-exposition render. Strings and non-finite floats are dropped — a
    scrape must never see ``nan``/``inf`` literals. A ``replica<i>/``-prefixed
    key (the cluster's per-replica namespace) renders as the unprefixed
    metric name with a ``{replica="i"}`` label; every metric name gets
    exactly one ``# TYPE`` line however many labeled samples share it.

    A key family carrying cumulative ``<base>/bucket/<le>`` entries (what
    `ServingMetrics.snapshot` emits per `metrics.Histogram`) renders as a
    REAL Prometheus histogram — ``_bucket{le="..."}`` series in ascending
    ``le`` order, the implicit ``le="+Inf"`` bucket equal to the count, and
    ``_sum``/``_count`` — instead of point gauges, so quantiles are
    computable downstream (``histogram_quantile``). The family consumes the
    flat ``<base>/sum`` and ``<base>/count`` keys (their sample lines would
    otherwise collide with the histogram's own); the summary-stat gauges
    (``<base>/p50`` ...) keep their distinct names and stay gauges."""

    def split(key: str) -> tuple[str, str]:
        m = _REPLICA_PREFIX.match(key)
        if m is not None:
            return f'replica="{m.group(1)}"', m.group(2)
        return "", key

    hist_bases: set[tuple[str, str]] = set()
    for key in values:
        label, rest = split(key)
        if "/bucket/" in rest:
            hist_bases.add((label, rest.split("/bucket/", 1)[0]))

    gauges: dict[str, list[tuple[str, Any]]] = {}
    # family name -> label -> {"buckets": [(le, le_str, v)], "sum": v, "count": v}
    hists: dict[str, dict[str, dict[str, Any]]] = {}
    for key in values:
        v = values[key]
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        if isinstance(v, float) and not math.isfinite(v):
            continue
        label, rest = split(key)
        if "/bucket/" in rest:
            base, le = rest.split("/bucket/", 1)
            fam = hists.setdefault(prometheus_name(base), {}).setdefault(
                label, {"buckets": []})
            fam["buckets"].append((float(le), le, v))
            continue
        base, _, stat = rest.rpartition("/")
        if stat in ("sum", "count") and (label, base) in hist_bases:
            fam = hists.setdefault(prometheus_name(base), {}).setdefault(
                label, {"buckets": []})
            fam[stat] = v
            continue
        name = prometheus_name(rest)
        gauges.setdefault(name, []).append(
            (f"{{{label}}}" if label else "", v))
    lines: list[str] = []
    for name in sorted(set(gauges) | set(hists)):
        if name in hists:
            lines.append(f"# TYPE {name} histogram")
            # cluster total (no label) first, then replicas in index order
            for label in sorted(hists[name]):
                fam = hists[name][label]
                pre = f"{label}," if label else ""
                for _, le, v in sorted(fam["buckets"]):
                    lines.append(f'{name}_bucket{{{pre}le="{le}"}} {v!r}')
                count = fam.get("count", 0)
                lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {count!r}')
                lab = f"{{{label}}}" if label else ""
                lines.append(f"{name}_sum{lab} {fam.get('sum', 0.0)!r}")
                lines.append(f"{name}_count{lab} {count!r}")
        if name in gauges:
            lines.append(f"# TYPE {name} gauge")
            for label, v in sorted(gauges[name]):
                lines.append(f"{name}{label} {v!r}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Inverse of `to_prometheus_text` (gauges only) — the round-trip half
    the format tests rely on. A labeled sample keeps its label block in the
    key (``name{replica="0"}``). Raises ``ValueError`` on a sample line
    whose value is not a float literal."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.partition(" ")
        out[name] = float(value)
    return out


# ------------------------------------------------------------- exporters
@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for `TelemetryExporter`.

    ``interval_s`` is the sampling cadence `poll` enforces (0.0 = sample
    every poll). ``capacity`` bounds the in-memory ring. ``jsonl_path`` /
    ``prometheus_path`` turn on the file exports; ``http_port`` starts the
    /metrics endpoint at construction (0 = ephemeral port, read it back from
    ``exporter.http_port``)."""

    interval_s: float = 1.0
    capacity: int = 4096
    jsonl_path: str | os.PathLike | None = None
    prometheus_path: str | os.PathLike | None = None
    http_port: int | None = None


class NullTelemetry:
    """Telemetry that does nothing — `NULL_TELEMETRY` is the engine default,
    mirroring `trace.NULL_TRACER`: ``enabled`` is False and the engine's
    only per-step cost is that attribute read."""

    enabled = False

    def poll(self, engine: Any) -> None:
        return None

    def sample(self, engine: Any) -> None:
        return None

    def close(self) -> None:
        return None


NULL_TELEMETRY = NullTelemetry()


class TelemetryExporter:
    """Samples an engine's gauges into a bounded time-series ring and fans
    them out to the configured exports. Duck-typed over the engine: anything
    with a ``metrics`` (required) and optionally ``memory_stats()`` /
    ``capacity_headroom()`` samples cleanly, so tests can feed it stubs.
    ``http_port`` binds 127.0.0.1 only.

    The clock is injected (default `time.perf_counter`) so cadence tests are
    deterministic, matching the tracer's convention.
    """

    enabled = True

    def __init__(self, config: TelemetryConfig | None = None, *,
                 clock: Any = time.perf_counter, **overrides: Any):
        if config is None:
            config = TelemetryConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self._clock = clock
        self._points: deque[dict] = deque(maxlen=max(1, int(config.capacity)))
        self.dropped = 0
        self._last_sample_t: float | None = None
        self._jsonl_fh = (open(config.jsonl_path, "a")
                          if config.jsonl_path is not None else None)
        self._server: Any = None
        self._server_thread: threading.Thread | None = None
        self.http_port: int | None = None
        if config.http_port is not None:
            self.serve_http(config.http_port)

    # ------------------------------------------------------------ sampling
    def poll(self, engine: Any) -> dict | None:
        """Cadence-gated `sample`: a no-op (returns None) until
        ``interval_s`` has elapsed since the last sample. This is the hook
        `ServingEngine.step` calls every step."""
        now = self._clock()
        if (self._last_sample_t is not None
                and now - self._last_sample_t < self.config.interval_s):
            return None
        return self.sample(engine)

    def sample(self, engine: Any) -> dict:
        """Take one time-series point NOW (ignoring the cadence): metrics
        snapshot + ``serving/mem/*`` + ``serving/headroom/*`` gauges,
        sanitized (non-finite -> None), appended to the ring and written to
        the configured exports. Returns the point."""
        self._last_sample_t = self._clock()
        gauges: dict[str, Any] = {}
        metrics = getattr(engine, "metrics", None)
        if metrics is not None:
            gauges.update(metrics.snapshot())
        mem = getattr(engine, "memory_stats", None)
        if mem is not None:
            for k, v in mem().items():
                # quantized-serving gauges (engine.quant_stats, present only
                # when a quantized mode is active) are a first-class family,
                # not a memory detail: lift them to serving/quant/...
                if k.startswith("quant/"):
                    gauges[f"serving/{k}"] = v
                else:
                    gauges[f"serving/mem/{k}"] = v
        head = getattr(engine, "capacity_headroom", None)
        if head is not None:
            for k, v in head().items():
                gauges[f"serving/headroom/{k}"] = v
        # class-based scheduler (the reference's FairScheduler): per-class
        # queue depth / starvation-promotion gauges under serving/class/...
        # (absent for the FIFO scheduler: no classes, no rows)
        sched = getattr(engine, "scheduler", None)
        class_gauges = getattr(sched, "class_gauges", None)
        if callable(class_gauges):
            gauges.update(class_gauges())
        # anomaly monitor (serving.anomaly): active-detector count, event/
        # bundle counters, last-event age, and the latest bundle path (a
        # string — JSONL-only; the Prometheus render drops it by design)
        anomaly = getattr(engine, "anomaly", None)
        if anomaly is not None and getattr(anomaly, "enabled", False):
            gauges.update(anomaly.gauges())
        # multi-replica source (`ServingCluster.replica_samples`): each
        # replica's gauges ride the same point under `replica<i>/...`, so
        # per-replica and cluster-total series never collide — in JSONL by
        # key, in Prometheus by the {replica="i"} label the render adds.
        # Samples arrive as (stable index, gauges) pairs — RETIRED replicas
        # stop emitting and the survivors keep their indices, so a series
        # never renumbers across a retire/replace; a bare dict list falls
        # back to positional indices
        replicas = getattr(engine, "replica_samples", None)
        if callable(replicas):
            for i, sub in enumerate(replicas()):
                if (isinstance(sub, tuple) and len(sub) == 2
                        and isinstance(sub[1], dict)):
                    i, sub = sub
                for k, v in sub.items():
                    gauges[f"replica{int(i)}/{k}"] = v
        point = sanitize_scalars(gauges)
        point["_step"] = (int(metrics.steps.value)
                          if metrics is not None else len(self._points))
        point["_ts"] = time.time()
        if len(self._points) == self._points.maxlen:
            self.dropped += 1
        self._points.append(point)
        if self._jsonl_fh is not None:
            # allow_nan=False holds the line: sanitize_scalars already nulled
            # every non-finite gauge
            self._jsonl_fh.write(json.dumps(point, allow_nan=False) + "\n")
            self._jsonl_fh.flush()
        if self.config.prometheus_path is not None:
            self.write_prometheus()
        return point

    def points(self) -> list[dict]:
        return list(self._points)

    def latest(self) -> dict | None:
        return self._points[-1] if self._points else None

    # ------------------------------------------------------------- exports
    def prometheus_text(self) -> str:
        """Text-exposition render of the latest point ('' before the first
        sample). ``_step``/``_ts`` bookkeeping keys are not gauges and stay
        out."""
        latest = self.latest()
        if latest is None:
            return ""
        return to_prometheus_text(
            {k: v for k, v in latest.items() if not k.startswith("_")}
        )

    def write_prometheus(self, path: str | os.PathLike | None = None) -> str:
        """Atomically write `prometheus_text()` to ``path`` (default the
        configured ``prometheus_path``); returns the text written."""
        path = path if path is not None else self.config.prometheus_path
        if path is None:
            raise ValueError("no prometheus_path configured or given")
        text = self.prometheus_text()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return text

    def serve_http(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve GET /metrics (Prometheus text of the latest sample) from a
        daemon thread; returns the bound port (pass 0 for ephemeral). The
        handler only reads `prometheus_text()`, so a scrape never touches
        the engine. The endpoint binds the loopback address 127.0.0.1 only;
        any other ``host`` is refused."""
        import http.server

        if host != "127.0.0.1":
            raise ValueError(f"serve_http binds 127.0.0.1 only, got host={host!r}")

        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep scrapes off stderr
                return

        self._server = http.server.ThreadingHTTPServer((host, int(port)),
                                                       _Handler)
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="telemetry-http",
        )
        self._server_thread.start()
        self.http_port = int(self._server.server_address[1])
        return self.http_port

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self.http_port = None
        if self._jsonl_fh is not None:
            self._jsonl_fh.close()
            self._jsonl_fh = None

    def __enter__(self) -> "TelemetryExporter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
