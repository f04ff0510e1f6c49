"""serve_top: live ASCII view of a serving telemetry time-series, the port of
the repository's ``tools/serve_top.py`` (the same JSONL format).

Reads the JSONL time-series a `serving.TelemetryExporter` writes
(``jsonl_path=``) and
renders the latest point as a top(1)-style screen: slot/queue occupancy
bars, decode rate vs goodput, latency percentiles, speculation accept
telemetry (when the engine drafts), KV slot-pool and prefix block-pool byte
accounting, the capacity headroom estimate, and the front-door view
(`docs/serving.md` "Front door": open token streams with delivery lag, one
row per scheduler priority class with queue depth / starvation / predictive
shed counts, per-SLO-class attainment) — plus a sparkline of the decode rate
over the trailing window. Cluster points render one row per replica with a
stream-lag column (the delivery lag of streams tailing that replica's
journal) and a lifecycle column (ok / DRAINING / DEAD / RETIRED); when a
`FleetAutoscaler` rides the cluster a ``fleet`` line shows target vs actual
replica counts, drains in flight, and a ``SCALE FROZEN`` marker while the
thrash guard holds scaling.

One-shot by default (render the latest point and exit); ``--watch N``
re-reads the file every N seconds until interrupted, like ``top``. All
analysis is host-side JSON arithmetic.

Exit status: 0 = rendered, 2 = not a telemetry time-series (unreadable, or
no points carrying ``serving/`` gauges).

Run:
    python -m accelerate_tpu_torch.tools.serve_top PATH [--watch SECONDS] [--width N]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

_SPARK = " .:-=+*#%@"

# per-replica gauge namespace a ServingCluster point carries
# (serving/telemetry.py `replica<i>/...` keys)
_REPLICA_KEY = re.compile(r"^replica(\d+)/(.+)$")

# per-priority-class scheduler gauges (`FairScheduler.class_gauges`; class -1
# is the watchdog-requeue front deque) and per-SLO-class attainment
_CLASS_KEY = re.compile(r"^serving/class/(-?\d+)/(.+)$")
_SLO_ATTAIN = re.compile(r"^serving/slo/([^/]+)/attainment$")


def load_points(path: str) -> list[dict]:
    """Parse one telemetry JSONL file. Raises ``ValueError`` unless at least
    one line is a JSON object carrying ``serving/`` gauges and a ``_ts``
    stamp (the `TelemetryExporter` conventions)."""
    points: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if (isinstance(doc, dict) and "_ts" in doc
                    and any(k.startswith("serving/") for k in doc)):
                points.append(doc)
    if not points:
        raise ValueError(f"{path} is not a telemetry time-series "
                         "(no serving/ gauge points)")
    return points


def _bar(frac: float, width: int) -> str:
    frac = min(max(frac, 0.0), 1.0)
    fill = int(round(frac * width))
    return "[" + "#" * fill + " " * (width - fill) + "]"


def _sparkline(values: list[float], width: int) -> str:
    if not values:
        return ""
    tail = values[-width:]
    hi = max(tail)
    if hi <= 0:
        return " " * len(tail)
    return "".join(
        _SPARK[min(int(v / hi * (len(_SPARK) - 1)), len(_SPARK) - 1)]
        for v in tail
    )


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def render(point: dict, history: list[dict] | None = None,
           width: int = 30) -> str:
    """Render one time-series point (plus optional trailing history for the
    rate sparkline) as the serve_top screen. Importable — the CLI tests and
    doc examples call it directly."""
    g = point.get  # gauges; missing ones render as absent lines
    lines: list[str] = []
    ts = point.get("_ts")
    stamp = time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "?"
    lines.append(f"serve_top — step {point.get('_step', '?')} @ {stamp}")

    total = g("serving/mem/slots_total")
    active = g("serving/mem/slots_active")
    if total:
        lines.append(f"slots  {_bar(active / total, width)} "
                     f"{active}/{total} active, "
                     f"{g('serving/mem/slots_free')} free")
    qd = g("serving/mem/queue_depth")
    if qd is not None:
        lines.append(f"queue  depth {qd}, inflight dispatches "
                     f"{g('serving/mem/inflight_dispatches')}")

    tps = g("serving/tokens_per_sec", g("serving/headroom/decode_tokens_per_sec"))
    if tps is not None:
        spark = ""
        if history:
            rates = [p.get("serving/headroom/decode_tokens_per_sec") or 0.0
                     for p in history]
            spark = f"  [{_sparkline(rates, width)}]"
        lines.append(f"rate   {tps:.1f} tok/s{spark}")
    gps = g("serving/goodput_tokens_per_sec")
    if gps is not None:
        lines.append(f"goodput {gps:.1f} tok/s, "
                     f"attainment {g('serving/slo_attainment', 1.0):.2%}")
    ttft_p50 = g("serving/ttft_s/p50")
    if ttft_p50 is not None:
        lines.append(f"ttft   p50 {1e3 * ttft_p50:.1f} ms, "
                     f"p99 {1e3 * g('serving/ttft_s/p99', 0.0):.1f} ms")

    # front-door gauges (serving/frontend.py, scheduler.py FairScheduler —
    # docs/serving.md "Front door"): open streams + delivery lag, one row
    # per scheduler priority class, per-SLO-class attainment, and the
    # predictive-admission shed count (distinct from brownout shed)
    opened = g("serving/streams_opened")
    if opened:
        lag = g("serving/stream_lag_s/p50")
        sttft = g("serving/streamed_ttft_s/p50")
        extra = ""
        if sttft is not None:
            extra += f", streamed ttft p50 {1e3 * sttft:.1f} ms"
        if lag is not None:
            extra += f", lag p50 {1e3 * lag:.1f} ms"
        lines.append(
            f"stream {int(opened) - int(g('serving/streams_finished', 0))} "
            f"open ({int(opened)} opened, "
            f"{int(g('serving/stream_events', 0))} events{extra})")
    classes: dict[int, dict] = {}
    for k, v in point.items():
        m = _CLASS_KEY.match(k)
        if m is not None:
            classes.setdefault(int(m.group(1)), {})[m.group(2)] = v
    shed_predicted = int(g("serving/requests_shed_predicted", 0) or 0)
    if classes or shed_predicted:
        lines.append(f"class  {len(classes)} scheduler class(es), "
                     f"predictive shed {shed_predicted}")
        for p in sorted(classes, reverse=True):
            c = classes[p].get
            label = "requeue" if p < 0 else f"p{p}"
            starved = int(c("starved", 0) or 0)
            starve_txt = f", {starved} starved" if starved else ""
            lines.append(
                f"  {label:<7} queue {int(c('queue_depth', 0) or 0)} "
                f"({int(c('tenants', 0) or 0)} tenant(s){starve_txt}), "
                f"shed {int(c('shed', 0) or 0)}")
    slo_classes = {m.group(1): point[k] for k in point
                   if (m := _SLO_ATTAIN.match(k)) is not None}
    if slo_classes:
        lines.append("slo    " + ", ".join(
            f"{name} {frac:.1%} "
            f"({int(point.get(f'serving/slo/{name}/requests', 0))} req)"
            for name, frac in sorted(slo_classes.items())))

    if g("serving/spec_forwards"):
        proposed = int(g("serving/spec_proposed", 0))
        accepted = int(g("serving/spec_accepted", 0))
        lines.append(
            f"spec   {g('serving/accepted_tokens_per_forward', 0.0):.2f} "
            f"tok/forward, accept len mean "
            f"{g('serving/spec_accept_len/mean', 0.0):.2f}, "
            f"accept rate {accepted / max(proposed, 1):.0%} "
            f"({accepted}/{proposed} drafted)")

    pool = g("serving/mem/slot_pool_bytes")
    if pool is not None:
        by_dtype = ", ".join(
            f"{k.rsplit('/', 1)[-1]} {_human_bytes(v)}"
            for k, v in sorted(point.items())
            if k.startswith("serving/mem/slot_pool_bytes/"))
        # quantized serving (serving/quant/* gauges, absent on fp engines):
        # active KV storage dtype and weight-quant mode with the exact
        # packed-vs-dense byte savings (docs/serving.md "Quantized serving")
        quant = ""
        kv_bits = g("serving/quant/kv_bits")
        if kv_bits:
            quant += f", kv int{int(kv_bits)}"
        w_bits = g("serving/quant/weight_bits")
        if w_bits:
            mode = "int8" if int(w_bits) == 8 else "nf4"
            quant += (f", weights {mode} "
                      f"{_human_bytes(g('serving/quant/weight_packed_bytes', 0))}"
                      f" (saves "
                      f"{_human_bytes(g('serving/quant/weight_saved_bytes', 0))}"
                      f" vs dense)")
        lines.append(f"kv     slot pool {_human_bytes(pool)}"
                     + (f" ({by_dtype})" if by_dtype else "") + quant)
    bt = g("serving/mem/block_pool/blocks_total")
    if bt:
        resident = g("serving/mem/block_pool/blocks_resident", 0)
        private = g("serving/mem/block_pool/blocks_private", 0)
        # paged engines report private (slot-held) blocks too — the bar is
        # total pool occupancy; a prefix-cache-only pool has private == 0
        # and renders exactly as before
        used = resident + private
        priv = f" + {private} private" if private else ""
        lines.append(
            f"blocks {_bar(used / bt, width)} {resident}/{bt} resident{priv} "
            f"({g('serving/mem/block_pool/blocks_pinned', 0)} pinned, "
            f"{g('serving/mem/block_pool/blocks_evictable', 0)} evictable), "
            f"frag {g('serving/mem/block_pool/fragmentation', 0.0):.2f}, "
            f"pool {_human_bytes(g('serving/mem/block_pool/pool_bytes', 0))}")

    # host-tier line (serving/kv_tier.py — docs/serving.md "KV tiering &
    # hibernation"): present only on tier-enabled engines. Page traffic is
    # shown as a rate over the trailing history when two stamped points
    # carry the counters, as lifetime totals otherwise; a DEAD-style FROZEN
    # marker flags the thrash guard holding further spill.
    htb = g("serving/mem/host_tier/blocks")
    if htb is not None:
        rate_txt = (f"page in/out {int(g('serving/mem/host_tier/page_ins', 0))}"
                    f"/{int(g('serving/mem/host_tier/page_outs', 0))} total")
        if history and len(history) >= 2:
            prev = next((p for p in reversed(history[:-1])
                         if "serving/mem/host_tier/page_ins" in p
                         and p.get("_ts") is not None), None)
            dt = ((ts or 0) - prev["_ts"]) if prev is not None else 0
            if prev is not None and dt > 0:
                pin = (g("serving/mem/host_tier/page_ins", 0)
                       - prev.get("serving/mem/host_tier/page_ins", 0)) / dt
                pout = (g("serving/mem/host_tier/page_outs", 0)
                        - prev.get("serving/mem/host_tier/page_outs", 0)) / dt
                rate_txt = f"page in/out {pin:.1f}/{pout:.1f} blk/s"
        state = ("SPILL FROZEN"
                 if g("serving/mem/host_tier/spill_frozen", 0) else "ok")
        lines.append(
            f"host   [{state:<12}] "
            f"{_human_bytes(g('serving/mem/host_tier/bytes', 0))} "
            f"({int(htb)} blocks), "
            f"{int(g('serving/mem/host_tier/hibernated', 0))} hibernated, "
            f"{rate_txt}, "
            f"{int(g('serving/mem/host_tier/thrash_events', 0))} thrash")

    adm = g("serving/headroom/admissible_requests")
    if adm is not None:
        exhaust = g("serving/headroom/seconds_to_exhaustion")
        lines.append(
            f"head   {adm} admissible, "
            f"{g('serving/headroom/token_capacity_remaining')} tokens left, "
            f"exhaustion "
            + (f"{exhaust:.1f}s" if exhaust is not None else "idle"))

    restarts = g("supervisor/restarts")
    if restarts is not None:
        brownout = (
            f"ACTIVE ({g('supervisor/time_in_brownout_s', 0.0):.1f}s)"
            if g("supervisor/brownout_active", 0) else "-")
        lines.append(
            f"health restarts {restarts} "
            f"(stalls {g('supervisor/stalls_detected', 0)}, "
            f"storms {g('supervisor/storms_detected', 0)}), "
            f"shed {g('supervisor/shed_requests', 0)}, "
            f"brownout {brownout}")

    # anomaly gauges appear only when an AnomalyMonitor is attached
    # (serving/anomaly.py — docs/observability.md "Flight recorder")
    if g("anomaly/active") is not None:
        active = int(g("anomaly/active", 0))
        detectors = g("anomaly/active_detectors", "")
        state = (f"FIRING [{detectors}]" if active else "quiet")
        age = g("anomaly/last_event_age_s")
        last = f", last event {age:.1f}s ago" if age is not None else ""
        bundle = g("anomaly/last_bundle")
        bundle = f", bundle {bundle}" if bundle else ""
        lines.append(
            f"alerts {state}, {int(g('anomaly/events', 0))} event(s), "
            f"{int(g('anomaly/bundles', 0))} bundle(s){last}{bundle}")

    # multi-replica points (serving/cluster.py): a cluster-total line plus
    # one health/occupancy row per replica<i>/ namespace. The totals above
    # already aggregate across replicas — this section shows the split.
    replicas: dict[int, dict] = {}
    for k, v in point.items():
        m = _REPLICA_KEY.match(k)
        if m is not None:
            replicas.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if replicas:
        healthy = sum(1 for sub in replicas.values()
                      if sub.get("cluster/healthy", 1))
        lines.append(
            f"cluster {healthy}/{len(replicas)} replicas healthy, "
            f"{int(g('cluster/migrations', 0))} migration(s), "
            f"{int(g('cluster/migrated_requests', 0))} request(s) moved, "
            f"routed prefix {int(g('cluster/routed_prefix', 0))} / "
            f"rr {int(g('cluster/routed_round_robin', 0))}")
        # fleet line (serving/autoscaler.py — docs/reliability.md "Elastic
        # fleet"): present only when a FleetAutoscaler rides the cluster.
        # SCALE FROZEN marks the ThrashGuard holding further size changes.
        target = g("autoscaler/target_replicas")
        if target is not None:
            frozen = (" — SCALE FROZEN"
                      if g("autoscaler/scale_frozen", 0) else "")
            lines.append(
                f"fleet  target {int(target)} / actual "
                f"{int(g('autoscaler/actual_replicas', 0))} "
                f"({int(g('autoscaler/draining_replicas', 0))} draining), "
                f"{int(g('autoscaler/scale_ups', 0))} scale-up(s), "
                f"{int(g('autoscaler/retires', 0))} retire(s), "
                f"{int(g('autoscaler/replaced', 0))} replaced, "
                f"spawn retries {int(g('autoscaler/spawn_retries', 0))}"
                f"{frozen}")
        # retired replicas stop emitting rather than renumbering, so index
        # gaps below the highest live index ARE the retired replicas — show
        # them as RETIRED rows to keep the fleet's history readable
        for i in range(max(replicas) + 1):
            if i not in replicas:
                lines.append(f"  r{i} [{'?':<7}] RETIRED")
                continue
            r = replicas[i].get
            state = str(r("cluster/state", "") or "")
            if state == "retired":
                lines.append(f"  r{i} [{r('cluster/role', '?'):<7}] RETIRED")
                continue
            if state == "dead" or not r("cluster/healthy", 1):
                lines.append(f"  r{i} [{r('cluster/role', '?'):<7}] DEAD   "
                             f"restarts {int(r('cluster/restarts', 0))}")
                continue
            total = r("serving/mem/slots_total") or 0
            active = r("serving/mem/slots_active") or 0
            occ = f"{int(active)}/{int(total)} slots" if total else "slots ?"
            level = int(r("cluster/brownout_level", 0))
            if state == "draining" or r("cluster/draining", 0):
                col = "DRAINING"
            elif level:
                col = f"BROWNOUT L{level}"
            else:
                col = "ok"
            # stream-lag column: journal-append -> caller delivery for the
            # streams tailing THIS replica's journal (the frontend accounts
            # on the replica it reads, so replicas without streams show "-")
            lag = r("serving/stream_lag_s/p50")
            lag_txt = f"{1e3 * lag:.1f} ms" if lag is not None else "-"
            lines.append(
                f"  r{i} [{r('cluster/role', '?'):<7}] {col:<12}"
                f"{r('serving/tokens_per_sec', 0.0):>8.1f} tok/s  {occ}, "
                f"queue {int(r('serving/mem/queue_depth', 0) or 0)}, "
                f"lag {lag_txt}, "
                f"restarts {int(r('cluster/restarts', 0))}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="telemetry JSONL written by "
                                     "serving.telemetry.TelemetryExporter")
    parser.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                        help="re-read and re-render every N seconds "
                             "(default: render once and exit)")
    parser.add_argument("--width", type=int, default=30,
                        help="bar/sparkline width (default 30)")
    args = parser.parse_args(argv)
    while True:
        try:
            points = load_points(args.path)
        except (OSError, ValueError) as exc:
            print(json.dumps({"path": args.path, "error": str(exc)}),
                  flush=True)
            return 2
        screen = render(points[-1], history=points, width=args.width)
        if args.watch > 0:
            print("\x1b[2J\x1b[H" + screen, flush=True)  # clear + home
            try:
                time.sleep(args.watch)
            except KeyboardInterrupt:
                return 0
        else:
            print(screen, flush=True)
            return 0


if __name__ == "__main__":
    sys.exit(main())
