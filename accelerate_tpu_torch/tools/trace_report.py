"""Summarize a serving trace file without a browser: the port of the
repository's ``tools/trace_report.py`` over the PyTorch port's
`serving.trace` (the same export format).

Takes the Chrome trace-event JSON a `serving.Tracer.export` wrote (the raw
event stream rides along under its ``accelerateTpuTrace`` key), re-runs the
trace-stream invariant checks (`trace.validate`), and prints:

  - a per-phase latency breakdown — queue wait / prefill / decode / total,
    count + mean/p50/p99 milliseconds (nearest-rank, the same convention as
    the engine's histograms);
  - the engine dispatch mix (step / admit / cached-admit counts, compiles
    vs replays, mean host-blocked fetch time);
  - a slot-occupancy timeline (busy fraction per slot plus an ASCII bar —
    the prefill-stalls-decode bubble is visible as synchronized gaps);
  - the top-N slowest requests with their phase split;
  - with ``--slo``, per-class SLO attainment and goodput recomputed from
    the embedded raw stream (the engine stamps class + attained on every
    classed terminal), so trace files and metrics snapshots tell one story.

``--json`` prints the full report as one JSON document instead of text
(the SLO section always rides in the JSON under ``slo``).

Exit status: 0 = clean trace, 1 = malformed spans (invariant violations —
an engine bug, not a viewer problem), 2 = not a trace file at all
(unreadable / not our export format).

Multiple paths — the shape a `ServingCluster` run leaves, one trace per
replica — report per-file sections with request ids prefixed ``r<i>:`` (ids
are per-ENGINE, so the prefix is what keeps replica 0's rid 3 distinct from
replica 1's), followed by a combined summary and a cross-replica slowest
list. Exit status is the worst per-file status.

Run:
    python -m accelerate_tpu_torch.tools.trace_report PATH [PATH ...] [--top N] [--no-slots]
        [--json]

(All the analysis is host-side JSON arithmetic — nothing here touches a
device; the only import of the port is its trace module.)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from ..serving.trace import (
    EV_ADMIT,
    EV_DISPATCH,
    EV_FETCH,
    EV_FINISH,
    EV_QUARANTINE,
    TERMINAL_KINDS,
    load_exported,
    nearest_rank,
    request_streams,
    validate,
)

_BAR_WIDTH = 40


def _stats(samples: list[float]) -> dict:
    if not samples:
        return {"count": 0}
    ordered = sorted(samples)
    return {
        "count": len(samples),
        "mean_ms": 1e3 * sum(samples) / len(samples),
        "p50_ms": 1e3 * nearest_rank(ordered, 0.50),
        "p99_ms": 1e3 * nearest_rank(ordered, 0.99),
        "max_ms": 1e3 * ordered[-1],
    }


def report(path: str, *, top: int = 5, slots: bool = True) -> dict:
    """Parse + validate one exported trace; return the report dict
    (importable). Raises ``ValueError`` /
    ``OSError`` when ``path`` is not a readable trace export."""
    with open(path, "rb") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path} is not a trace-event JSON object")
    events, dropped = load_exported(doc)
    valid = validate(events, dropped=dropped)

    fetch_by_seq = {ev.data.get("seq"): ev for ev in events
                    if ev.kind == EV_FETCH}

    # --- per-request phase decomposition -----------------------------------
    phases: dict[str, list[float]] = {
        "queue_wait": [], "prefill": [], "decode": [], "total": [],
    }
    requests: list[dict] = []
    for rid, stream in sorted(request_streams(events).items()):
        submit_ts = stream[0].ts
        admits = [ev for ev in stream if ev.kind == EV_ADMIT]
        terminal = stream[-1] if stream[-1].kind in TERMINAL_KINDS else None
        row = {"rid": rid, "terminal": None, "reason": None,
               "queue_wait_s": None, "prefill_s": None, "decode_s": None,
               "total_s": None, "tokens": 0,
               "quarantines": sum(1 for ev in stream
                                  if ev.kind == EV_QUARANTINE)}
        if admits:
            row["queue_wait_s"] = admits[0].ts - submit_ts
            phases["queue_wait"].append(row["queue_wait_s"])
            first_fetch = fetch_by_seq.get(admits[0].data.get("seq"))
            if first_fetch is not None:
                row["prefill_s"] = first_fetch.ts - admits[0].ts
                phases["prefill"].append(row["prefill_s"])
        if terminal is not None:
            row["terminal"] = terminal.kind
            row["reason"] = terminal.data.get("reason")
            row["tokens"] = int(terminal.data.get("tokens", 0))
            row["total_s"] = terminal.ts - submit_ts
            phases["total"].append(row["total_s"])
            if admits:
                last_fetch = fetch_by_seq.get(admits[-1].data.get("seq"))
                decode_from = (last_fetch.ts if last_fetch is not None
                               else admits[-1].ts)
                row["decode_s"] = max(0.0, terminal.ts - decode_from)
                phases["decode"].append(row["decode_s"])
        requests.append(row)

    # --- engine dispatch mix ----------------------------------------------
    dispatch: dict[str, dict] = {}
    for ev in events:
        if ev.kind != EV_DISPATCH:
            continue
        what = str(ev.data.get("what", "?"))
        d = dispatch.setdefault(
            what, {"dispatches": 0, "compiles": 0, "blocked_s": []}
        )
        d["dispatches"] += 1
        d["compiles"] += int(bool(ev.data.get("compiled")))
        fetch = fetch_by_seq.get(ev.data.get("seq"))
        if fetch is not None and "blocked_s" in fetch.data:
            d["blocked_s"].append(float(fetch.data["blocked_s"]))
    for d in dispatch.values():
        blocked = d.pop("blocked_s")
        d["mean_blocked_ms"] = (1e3 * sum(blocked) / len(blocked)
                                if blocked else 0.0)

    # --- slot-occupancy timeline ------------------------------------------
    occupancy: dict[int, dict] = {}
    if slots and events:
        t0 = min(ev.ts for ev in events)
        t1 = max(ev.ts for ev in events)
        span = max(t1 - t0, 1e-9)
        open_t: dict[int, float] = {}
        busy: dict[int, list[tuple[float, float]]] = {}
        for ev in events:
            slot = ev.data.get("slot")
            if slot is None or ev.rid is None:
                continue
            if ev.kind == EV_ADMIT:
                open_t[slot] = ev.ts
            elif ev.kind in (EV_FINISH, EV_QUARANTINE) and slot in open_t:
                busy.setdefault(slot, []).append((open_t.pop(slot), ev.ts))
        for slot, start in open_t.items():  # still occupied at trace end
            busy.setdefault(slot, []).append((start, t1))
        for slot, spans in sorted(busy.items()):
            frac = sum(b - a for a, b in spans) / span
            cells = [" "] * _BAR_WIDTH
            for a, b in spans:
                lo = int((a - t0) / span * (_BAR_WIDTH - 1))
                hi = int((b - t0) / span * (_BAR_WIDTH - 1))
                for c in range(lo, hi + 1):
                    cells[c] = "#"
            occupancy[slot] = {
                "tenancies": len(spans),
                "busy_frac": frac,
                "bar": "".join(cells),
            }

    slowest = sorted(
        (r for r in requests if r["total_s"] is not None),
        key=lambda r: -r["total_s"],
    )[: max(0, top)]

    # --- SLO attainment / goodput from the raw stream ---------------------
    # one story with metrics.goodput() (docs/observability.md): class from
    # the submit edge (or the terminal's own stamp), attainment from the
    # engine-stamped ``attained`` flag on the terminal; traces predating the
    # flag fall back to clean-finish (reason eos/length, matching
    # request.FINISH_EOS/FINISH_LENGTH)
    slo_classes: dict[str, dict] = {}
    for rid, stream in sorted(request_streams(events).items()):
        cls = None
        for ev in stream:
            if ev.data.get("slo") is not None:
                cls = str(ev.data["slo"])
        if cls is None:
            continue
        terminal = stream[-1] if stream[-1].kind in TERMINAL_KINDS else None
        if terminal is not None and "attained" in terminal.data:
            attained = bool(terminal.data["attained"])
        else:
            attained = (terminal is not None
                        and terminal.data.get("reason") in ("eos", "length"))
        c = slo_classes.setdefault(
            cls, {"requests": 0, "attained": 0, "goodput_tokens": 0})
        c["requests"] += 1
        c["attained"] += int(attained)
        if attained and terminal is not None:
            c["goodput_tokens"] += int(terminal.data.get("tokens", 0))
    span = (max(ev.ts for ev in events) - min(ev.ts for ev in events)
            if events else 0.0)
    slo_requests = sum(c["requests"] for c in slo_classes.values())
    slo_attained = sum(c["attained"] for c in slo_classes.values())
    goodput_tokens = sum(c["goodput_tokens"] for c in slo_classes.values())
    slo = {
        "classes": {
            name: {**c, "attainment": c["attained"] / c["requests"]}
            for name, c in sorted(slo_classes.items())
        },
        "slo_requests": slo_requests,
        "slo_attainment": (slo_attained / slo_requests
                           if slo_requests else 1.0),
        "goodput_tokens": goodput_tokens,
        "goodput_tokens_per_sec": (goodput_tokens / span if span > 0
                                   else 0.0),
    }

    return {
        "path": str(path),
        "events": valid["events"],
        "dropped": valid["dropped"],
        "truncated": valid["truncated"],
        "requests": valid["requests"],
        "malformed_spans": len(valid["anomalies"]),
        "anomalies": valid["anomalies"],
        "clean": valid["clean"],
        "phases": {name: _stats(vals) for name, vals in phases.items()},
        "dispatch": dict(sorted(dispatch.items())),
        "slots": occupancy,
        "slowest": slowest,
        "slo": slo,
    }


def _trace_replica_index(path: str, fallback: int) -> int:
    """The ``replica<i>`` index a cluster trace path encodes (filename or any
    parent dir), else ``fallback``. An elastic fleet leaves non-contiguous
    indices behind (retired replicas keep theirs, successors take fresh
    ones), so the positional index is only the last resort."""
    for part in reversed(os.path.normpath(path).split(os.sep)):
        m = re.search(r"replica(\d+)", part)
        if m:
            return int(m.group(1))
    return fallback


def multi_report(paths: list[str], *, top: int = 5, slots: bool = True) -> dict:
    """Per-file `report` over a cluster's per-replica traces, with every
    request id prefixed ``r<i>:`` (engine-level ids collide across replicas;
    the prefix is the cluster-level name — ``i`` is the stable replica index
    parsed from the path when present, so retired/replaced replicas with
    index gaps keep their names), plus a combined roll-up and a
    cross-replica slowest list. Raises like `report` on the FIRST unreadable
    path — partial cluster reports would hide a missing replica."""
    reports: list[dict] = []
    for i, path in enumerate(paths):
        rep = report(path, top=top, slots=slots)
        idx = _trace_replica_index(str(path), i)
        rep["replica"] = idx
        for row in rep["slowest"]:
            row["rid"] = f"r{idx}:{row['rid']}"
        reports.append(rep)
    slowest = sorted(
        (row for rep in reports for row in rep["slowest"]),
        key=lambda row: -row["total_s"],
    )[: max(0, top)]
    return {
        "paths": [str(p) for p in paths],
        "reports": reports,
        "events": sum(r["events"] for r in reports),
        "requests": sum(r["requests"] for r in reports),
        "dropped": sum(r["dropped"] for r in reports),
        "malformed_spans": sum(r["malformed_spans"] for r in reports),
        "slowest": slowest,
        "clean": all(r["clean"] for r in reports),
    }


def _print_slo(rep: dict) -> None:
    slo = rep["slo"]
    print(f"\nSLO attainment ({slo['slo_requests']} classed requests, "
          f"overall {slo['slo_attainment']:.1%}, goodput "
          f"{slo['goodput_tokens']} tok @ "
          f"{slo['goodput_tokens_per_sec']:.1f} tok/s):")
    if not slo["classes"]:
        print("  (no requests carried an SLO class)")
    for name, c in slo["classes"].items():
        print(f"  {name:<14}{c['requests']:>6} requests, "
              f"{c['attained']} attained ({c['attainment']:.1%}), "
              f"{c['goodput_tokens']} goodput tokens")


def _print_text(rep: dict) -> None:
    print(f"trace {rep['path']}: {rep['events']} events, "
          f"{rep['requests']} requests, dropped={rep['dropped']}, "
          f"malformed_spans={rep['malformed_spans']}")
    for a in rep["anomalies"][:10]:
        print(f"  ANOMALY: {a}")
    print("\nper-phase latency breakdown:")
    print(f"  {'phase':<12}{'count':>7}{'mean ms':>10}{'p50 ms':>10}"
          f"{'p99 ms':>10}{'max ms':>10}")
    for name, st in rep["phases"].items():
        if not st["count"]:
            print(f"  {name:<12}{0:>7}")
            continue
        print(f"  {name:<12}{st['count']:>7}{st['mean_ms']:>10.2f}"
              f"{st['p50_ms']:>10.2f}{st['p99_ms']:>10.2f}"
              f"{st['max_ms']:>10.2f}")
    if rep["dispatch"]:
        print("\nengine dispatches:")
        for what, d in rep["dispatch"].items():
            print(f"  {what:<14}{d['dispatches']:>6} dispatched, "
                  f"{d['compiles']} compiled, "
                  f"mean fetch block {d['mean_blocked_ms']:.2f} ms")
    if rep["slots"]:
        print("\nslot occupancy:")
        for slot, occ in rep["slots"].items():
            print(f"  slot {slot:>3} {occ['busy_frac']:>6.1%} "
                  f"[{occ['bar']}] {occ['tenancies']} tenancies")
    if rep["slowest"]:
        print(f"\ntop {len(rep['slowest'])} slowest requests:")
        for r in rep["slowest"]:
            parts = [f"total {1e3 * r['total_s']:.2f} ms"]
            for key, label in (("queue_wait_s", "queue"),
                               ("prefill_s", "prefill"),
                               ("decode_s", "decode")):
                if r[key] is not None:
                    parts.append(f"{label} {1e3 * r[key]:.2f}")
            q = f", {r['quarantines']} quarantine(s)" if r["quarantines"] else ""
            print(f"  rid {r['rid']:>5} {r['terminal']}:{r['reason']} "
                  f"({r['tokens']} tok) — {', '.join(parts)}{q}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="+", metavar="PATH",
                        help="trace-event JSON written by "
                             "serving.Tracer.export (several = one per "
                             "cluster replica, rids prefixed r<i>:)")
    parser.add_argument("--top", type=int, default=5,
                        help="how many slowest requests to list (default 5)")
    parser.add_argument("--no-slots", action="store_true",
                        help="skip the slot-occupancy timeline")
    parser.add_argument("--slo", action="store_true",
                        help="print per-class SLO attainment and goodput "
                             "from the embedded raw stream")
    parser.add_argument("--json", action="store_true",
                        help="print the full report as JSON instead of text")
    args = parser.parse_args(argv)
    if len(args.paths) == 1:
        try:
            rep = report(args.paths[0], top=args.top, slots=not args.no_slots)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            print(json.dumps({"path": args.paths[0], "error": str(exc)}),
                  flush=True)
            return 2
        if args.json:
            print(json.dumps(rep), flush=True)
        else:
            _print_text(rep)
            if args.slo:
                _print_slo(rep)
        return 0 if rep["clean"] else 1
    try:
        combined = multi_report(args.paths, top=args.top,
                                slots=not args.no_slots)
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print(json.dumps({"paths": args.paths, "error": str(exc)}),
              flush=True)
        return 2
    if args.json:
        print(json.dumps(combined), flush=True)
        return 0 if combined["clean"] else 1
    for rep in combined["reports"]:
        print(f"=== replica {rep['replica']}: {rep['path']} ===")
        _print_text(rep)
        if args.slo:
            _print_slo(rep)
        print()
    print(f"cluster: {len(combined['reports'])} traces, "
          f"{combined['events']} events, {combined['requests']} requests, "
          f"dropped={combined['dropped']}, "
          f"malformed_spans={combined['malformed_spans']}")
    if combined["slowest"]:
        print(f"top {len(combined['slowest'])} slowest across replicas:")
        for row in combined["slowest"]:
            print(f"  rid {row['rid']:>8} {row['terminal']}:{row['reason']} "
                  f"({row['tokens']} tok) — "
                  f"total {1e3 * row['total_s']:.2f} ms")
    return 0 if combined["clean"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `trace_report ... | head` is normal usage
        sys.exit(0)
