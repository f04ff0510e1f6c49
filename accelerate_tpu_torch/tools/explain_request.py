"""Explain where ONE request's wall time went: the port of the repository's
``tools/explain_request.py`` over the PyTorch port's trace and journal
modules (the same file formats).

Takes a request id and the forensic artifacts a serving run leaves — a trace
export (or several, one per cluster replica), optionally the telemetry JSONL
and the request journal — and prints a per-request wall-time attribution:

  - contiguous named segments partitioning submit -> terminal: ``queue_wait``
    (submit to admission), ``prefill`` per admission (compile vs replay,
    the jitted dispatch wall, prompt bucket, prefix-cache outcome),
    ``decode`` (first token to the next lifecycle edge), and
    ``requeue_wait`` after a quarantine;
  - per-token-batch gaps inside decode, each annotated with everything that
    overlapped it — supervisor stalls, restarts, brownout windows, anomaly
    markers, migrations of this rid, and speculative-verify dispatches (with
    their accepted length);
  - the attribution coverage (segments sum / total wall) — by construction
    ~100% on a well-formed stream, printed so a torn stream is visible;
  - with ``--journal``, the journal's view of the same rid (records, token
    frontier, finish) cross-checked against the trace; with ``--telemetry``,
    the engine-health gauges from the nearest telemetry points as context.

Request ids are per-ENGINE. With several trace files (a cluster run), name
the request ``r<i>:<rid>`` — replica ``i``'s trace is consulted, and the
attribution is identical to running against that file alone.

Exit status: 0 = request found, stream clean; 1 = request found but the
stream is incomplete or malformed (no terminal yet / invariant violations);
2 = not a trace export, or the rid is not in it (JSON error on stdout).

Run:
    python -m accelerate_tpu_torch.tools.explain_request RID TRACE [TRACE ...]
        [--journal PATH] [--telemetry PATH] [--gaps N] [--json]

(Host-side JSON arithmetic only — the port's imports are its trace and
journal modules; nothing touches a device.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..serving.trace import (
    EV_ADMIT,
    EV_ANOMALY,
    EV_BROWNOUT,
    EV_DISPATCH,
    EV_FETCH,
    EV_MIGRATE,
    EV_QUARANTINE,
    EV_RESTART,
    EV_STALL,
    TERMINAL_KINDS,
    load_exported,
    request_streams,
    validate,
)

_DECODE_WHATS = ("step", "spec")


def _load(path: str):
    with open(path, "rb") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path} is not a trace-event JSON object")
    return load_exported(doc)


def _brownout_windows(events, t_end: float) -> list[tuple[float, float]]:
    windows, start = [], None
    for ev in events:
        if ev.kind != EV_BROWNOUT:
            continue
        if ev.data.get("phase") == "enter":
            start = ev.ts
        elif start is not None:
            windows.append((start, ev.ts))
            start = None
    if start is not None:
        windows.append((start, t_end))
    return windows


def explain(rid: int, events, dropped: int = 0, *, path: str = "",
            gaps_top: int = 5) -> dict:
    """Attribution report for one rid over one engine's event stream
    (importable — tests and chaos_serve call it directly). Raises
    ``ValueError`` when the rid has no stream in the trace."""
    valid = validate(events, dropped=dropped)
    streams = request_streams(events)
    if rid not in streams:
        raise ValueError(f"rid {rid} not found in {path or 'trace'} "
                         f"({len(streams)} requests)")
    stream = streams[rid]
    submit = stream[0]
    terminal = stream[-1] if stream[-1].kind in TERMINAL_KINDS else None
    t_end = terminal.ts if terminal is not None else max(ev.ts for ev in events)
    base = submit.ts

    fetch_by_seq = {ev.data.get("seq"): ev for ev in events
                    if ev.kind == EV_FETCH}
    dispatch_by_seq = {ev.data.get("seq"): ev for ev in events
                       if ev.kind == EV_DISPATCH}

    def clamp(ts: float) -> float:
        # EV_FETCH is stamped after delivery, so the fetch that retired the
        # request can postdate its terminal by the delivery time — attribution
        # never runs past the terminal edge
        return min(ts, t_end)

    # --- lifecycle boundaries: a contiguous partition of submit..terminal --
    admits = [ev for ev in stream if ev.kind == EV_ADMIT]
    bounds: list[tuple[float, str, dict]] = [(base, "submit", {})]
    prefills: list[dict] = []
    for ev in admits:
        seq = ev.data.get("seq")
        disp = dispatch_by_seq.get(seq)
        fetch = fetch_by_seq.get(seq)
        detail = {
            "bucket": ev.data.get("bucket"),
            "cache_hit": bool(ev.data.get("cache_hit")),
            "cached_tokens": int(ev.data.get("cached_tokens", 0) or 0),
            "compiled": bool(disp.data.get("compiled")) if disp else None,
            "dispatch_s": (float(disp.data.get("dispatch_s", 0.0))
                           if disp else None),
            "key": disp.data.get("key") if disp else None,
        }
        prefills.append(detail)
        bounds.append((clamp(ev.ts), "admit", detail))
        if fetch is not None:
            bounds.append((clamp(fetch.ts), "first_fetch", {}))
    for ev in stream:
        if ev.kind == EV_QUARANTINE:
            bounds.append((clamp(ev.ts), "quarantine",
                           {"reason": ev.data.get("reason")}))
    if terminal is not None:
        bounds.append((t_end, "terminal",
                       {"kind": terminal.kind,
                        "reason": terminal.data.get("reason")}))
    bounds.sort(key=lambda b: b[0])

    # --- decode token-batch arrivals + overlap windows ---------------------
    arrivals: list[tuple[float, dict, dict]] = []  # (ts, dispatch, fetch)
    for seq, disp in dispatch_by_seq.items():
        if disp.data.get("what") not in _DECODE_WHATS:
            continue
        if not any(r[1] == rid for r in disp.data.get("reqs", ())):
            continue
        fetch = fetch_by_seq.get(seq)
        if fetch is None or fetch.ts < base or disp.ts > t_end:
            continue
        arrivals.append((clamp(fetch.ts), disp.data, fetch.data))
    arrivals.sort(key=lambda a: a[0])

    stalls = [ev for ev in events if ev.kind == EV_STALL]
    restarts = [ev for ev in events if ev.kind == EV_RESTART]
    anomalies_ev = [ev for ev in events if ev.kind == EV_ANOMALY]
    migrations = [ev for ev in events
                  if ev.kind == EV_MIGRATE and ev.rid == rid]
    brownouts = _brownout_windows(events, t_end)

    def overlaps(a: float, b: float) -> list[str]:
        notes = []
        for ev in stalls:
            if a < ev.ts <= b:
                notes.append(f"stall(elapsed={ev.data.get('elapsed_s')}s)")
        for ev in restarts:
            if a < ev.ts <= b:
                notes.append(f"restart:{ev.data.get('reason')}")
        for lo, hi in brownouts:
            if lo < b and hi > a:
                notes.append("brownout")
        for ev in anomalies_ev:
            if a < ev.ts <= b and ev.data.get("phase") == "enter":
                notes.append(f"anomaly:{ev.data.get('detector')}")
        for ev in migrations:
            if a < ev.ts <= b:
                notes.append(f"migrate:r{ev.data.get('from_replica')}->"
                             f"r{ev.data.get('to_replica')}")
        return notes

    # --- named segments ----------------------------------------------------
    _NAME_FOR_LEFT = {"submit": "queue_wait", "admit": "prefill",
                      "first_fetch": "decode", "quarantine": "requeue_wait"}
    segments: list[dict] = []
    phase_totals: dict[str, float] = {}
    for (t0, kind0, detail0), (t1, kind1, _) in zip(bounds, bounds[1:]):
        name = _NAME_FOR_LEFT.get(kind0)
        if name is None:
            continue
        dur = max(0.0, t1 - t0)
        seg = {"phase": name, "start_s": round(t0 - base, 6),
               "dur_s": round(dur, 6), "until": kind1,
               "overlaps": overlaps(t0, t1)}
        if name == "prefill" and detail0:
            seg["compiled"] = detail0.get("compiled")
            seg["dispatch_s"] = detail0.get("dispatch_s")
            seg["key"] = detail0.get("key")
            seg["cache_hit"] = detail0.get("cache_hit")
        segments.append(seg)
        phase_totals[name] = phase_totals.get(name, 0.0) + dur

    total_s = (t_end - base) if terminal is not None else None
    attributed = sum(s["dur_s"] for s in segments)
    coverage = (attributed / total_s if total_s else
                (1.0 if not segments else None))

    # --- per-token-batch gaps with annotations -----------------------------
    gap_list: list[dict] = []
    first_fetches = sorted(t for t, k, _ in bounds if k == "first_fetch")
    marks = sorted(set(first_fetches + [t for t, _, _ in arrivals]))
    for a, b in zip(marks, marks[1:]):
        if b - a <= 0:
            continue
        disp_at_b = next((d for t, d, f in arrivals if t == b), None)
        notes = overlaps(a, b)
        if disp_at_b is not None and disp_at_b.get("what") == "spec":
            fetch_at_b = next((f for t, d, f in arrivals if t == b), {})
            notes.append(f"spec(drafted={disp_at_b.get('drafted')},"
                         f"accepted={fetch_at_b.get('accepted')})")
        gap_list.append({"start_s": round(a - base, 6),
                         "gap_s": round(b - a, 6), "overlaps": notes})
    gap_durs = sorted(g["gap_s"] for g in gap_list)
    slowest_gaps = sorted(gap_list, key=lambda g: -g["gap_s"])[:max(0, gaps_top)]

    return {
        "path": str(path),
        "rid": rid,
        "found": True,
        "clean": valid["clean"],
        "anomalies": valid["anomalies"],
        "terminal": terminal.kind if terminal is not None else None,
        "reason": (terminal.data.get("reason")
                   if terminal is not None else None),
        "tokens": (int(terminal.data.get("tokens", 0))
                   if terminal is not None else 0),
        "admissions": len(admits),
        "prefills": prefills,
        "total_s": round(total_s, 6) if total_s is not None else None,
        "segments": segments,
        "phase_totals": {k: round(v, 6)
                         for k, v in sorted(phase_totals.items())},
        "attributed_s": round(attributed, 6),
        "coverage": round(coverage, 4) if coverage is not None else None,
        "gaps": {
            "count": len(gap_durs),
            "mean_ms": (1e3 * sum(gap_durs) / len(gap_durs)
                        if gap_durs else 0.0),
            "max_ms": 1e3 * gap_durs[-1] if gap_durs else 0.0,
            "annotated": sum(1 for g in gap_list if g["overlaps"]),
        },
        "slowest_gaps": slowest_gaps,
        "overlap_events": {
            "stalls": len(stalls),
            "restarts": len(restarts),
            "brownout_windows": len(brownouts),
            "anomaly_markers": len(anomalies_ev),
            "migrations": len(migrations),
        },
    }


def parse_rid(text: str, n_paths: int) -> tuple[int, int]:
    """``"7"`` -> (0, 7); ``"r1:7"`` -> (1, 7). The replica index must name
    one of the given trace files."""
    replica = 0
    if text.startswith("r") and ":" in text:
        head, _, tail = text.partition(":")
        replica, text = int(head[1:]), tail
    rid = int(text)
    if not 0 <= replica < n_paths:
        raise ValueError(f"replica r{replica} but only {n_paths} trace "
                         f"file(s) given")
    return replica, rid


def journal_view(path: str, rid: int) -> dict:
    """The journal's story for the same rid (`serving/journal.py`), for
    cross-checking the trace: present?, token frontier, finish record."""
    from ..serving.journal import RequestJournal

    scan = RequestJournal.scan(path)
    fin = scan.finishes.get(rid)
    return {
        "path": str(path),
        "present": rid in scan.submits,
        "tokens_journaled": len(scan.tokens.get(rid, [])),
        "finished": fin is not None,
        "finish_reason": fin[0] if fin is not None else None,
        "records": scan.records,
        "truncated_tail_bytes": scan.truncated_tail_bytes,
    }


def telemetry_view(path: str) -> dict:
    """Engine-health context from the telemetry JSONL: last point's latency
    / queue / anomaly gauges (wall clocks differ from the trace's monotonic
    timestamps, so this is context, not a join)."""
    last = None
    points = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            last = json.loads(line)
            points += 1
    if last is None:
        raise ValueError(f"{path} has no telemetry points")
    keys = ("serving/ttft_s/p99", "serving/inter_token_s/p99",
            "serving/queue_depth/p99", "serving/tokens_per_sec",
            "serving/goodput_tokens_per_sec", "anomaly/active",
            "anomaly/active_detectors", "anomaly/last_bundle")
    return {"path": str(path), "points": points,
            "last": {k: last[k] for k in keys if k in last}}


def _print_text(rep: dict, label: str) -> None:
    term = (f"{rep['terminal']}:{rep['reason']}" if rep["terminal"]
            else "STILL IN FLIGHT")
    total = (f"{1e3 * rep['total_s']:.2f} ms" if rep["total_s"] is not None
             else "n/a")
    cov = (f"{rep['coverage']:.1%}" if rep["coverage"] is not None else "n/a")
    print(f"request {label} ({rep['path']}): {term}, {rep['tokens']} tokens, "
          f"total {total}, attribution coverage {cov}")
    for a in rep["anomalies"][:5]:
        print(f"  TRACE ANOMALY: {a}")
    print("\nsegments:")
    for seg in rep["segments"]:
        extra = ""
        if seg["phase"] == "prefill":
            mode = ("compile" if seg.get("compiled")
                    else "replay" if seg.get("compiled") is not None else "?")
            extra = f" [{mode} {seg.get('key')}"
            if seg.get("cache_hit"):
                extra += ", prefix hit"
            extra += "]"
        notes = f"  << {', '.join(seg['overlaps'])}" if seg["overlaps"] else ""
        print(f"  {seg['phase']:<13}{1e3 * seg['dur_s']:>10.2f} ms  "
              f"@+{1e3 * seg['start_s']:.2f}{extra}{notes}")
    pt = rep["phase_totals"]
    print("\nphase totals: "
          + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in pt.items()))
    g = rep["gaps"]
    if g["count"]:
        print(f"\ntoken gaps: {g['count']} gaps, mean {g['mean_ms']:.2f} ms, "
              f"max {g['max_ms']:.2f} ms, {g['annotated']} annotated")
        for gap in rep["slowest_gaps"]:
            notes = (f"  << {', '.join(gap['overlaps'])}"
                     if gap["overlaps"] else "")
            print(f"  @+{1e3 * gap['start_s']:>10.2f} ms  "
                  f"gap {1e3 * gap['gap_s']:.2f} ms{notes}")
    ov = rep["overlap_events"]
    print(f"\nengine context: {ov['stalls']} stall(s), "
          f"{ov['restarts']} restart(s), "
          f"{ov['brownout_windows']} brownout window(s), "
          f"{ov['anomaly_markers']} anomaly marker(s), "
          f"{ov['migrations']} migration(s) of this rid")
    if "journal" in rep:
        j = rep["journal"]
        state = ("finished:" + str(j["finish_reason"]) if j["finished"]
                 else "in flight" if j["present"] else "ABSENT")
        print(f"journal {j['path']}: {state}, "
              f"{j['tokens_journaled']} tokens journaled")
    if "telemetry" in rep:
        t = rep["telemetry"]
        gauges = ", ".join(f"{k.split('/', 1)[1]}={v}"
                           for k, v in t["last"].items())
        print(f"telemetry {t['path']}: {t['points']} points; last: {gauges}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("rid", help="request id; r<i>:<rid> with several "
                                    "trace files (replica i's id space)")
    parser.add_argument("paths", nargs="+", metavar="TRACE",
                        help="trace-event JSON written by "
                             "serving.Tracer.export (several = one per "
                             "cluster replica)")
    parser.add_argument("--journal", default=None,
                        help="request journal to cross-check the rid against")
    parser.add_argument("--telemetry", default=None,
                        help="telemetry JSONL for engine-health context")
    parser.add_argument("--gaps", type=int, default=5,
                        help="slowest token gaps to list (default 5)")
    parser.add_argument("--json", action="store_true",
                        help="print the report as one JSON document")
    args = parser.parse_args(argv)
    try:
        replica, rid = parse_rid(args.rid, len(args.paths))
        path = args.paths[replica]
        events, dropped = _load(path)
        rep = explain(rid, events, dropped, path=path, gaps_top=args.gaps)
        rep["replica"] = replica
        if args.journal is not None:
            rep["journal"] = journal_view(args.journal, rid)
        if args.telemetry is not None:
            rep["telemetry"] = telemetry_view(args.telemetry)
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print(json.dumps({"rid": args.rid, "paths": args.paths,
                          "error": str(exc)}), flush=True)
        return 2
    if args.json:
        print(json.dumps(rep), flush=True)
    else:
        _print_text(rep, args.rid)
    return 0 if (rep["clean"] and rep["terminal"] is not None) else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # piping into `head` is normal usage
        sys.exit(0)
