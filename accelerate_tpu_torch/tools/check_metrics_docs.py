"""Lint `docs/observability.md` against the PyTorch port's metric and trace
surface: the port of the repository's ``tools/check_metrics_docs.py``.

The doc is the reference package's, unchanged; the surface is the port's
(`accelerate_tpu_torch.serving`). A name the doc lacks is a port name that
drifted from the reference's.

Two one-way checks, code -> docs:

  - every metric FAMILY a fresh engine can export must be named in the doc.
    Families come from a live ``ServingMetrics().snapshot()`` plus a fresh
    ``AnomalyMonitor().gauges()``, with summary-stat suffixes stripped
    (``serving/ttft_s/p99`` -> ``serving/ttft_s``); the per-SLO-class and
    per-compile-key families are dynamic (request-dependent key tails) and
    are checked as their prefixes;
  - every trace event KIND (each ``EV_*`` constant in `serving/trace.py`)
    must appear in the doc as a code span (`` `kind` `` — the event schema
    table).

The check is deliberately NOT docs -> code: prose may discuss retired or
planned names (and the reference's mesh gauges, which the port has not).

Exit status: 0 = docs cover the surface; 1 = drift (each missing name
printed); 2 = doc unreadable / surface import failed.

Run:
    python -m accelerate_tpu_torch.tools.check_metrics_docs [--doc docs/observability.md] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_STAT_SUFFIXES = frozenset(
    {"count", "mean", "min", "max", "p50", "p90", "p99", "sum"})
# families whose key tails are request-dependent (SLO class names, compile
# cache keys, scheduler priority classes): documented as a prefix, not
# per-member
_DYNAMIC_PREFIXES = ("serving/slo/", "serving/compile/", "serving/class/",
                     "serving/host_tier/", "autoscaler/")
_DEFAULT_DOC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "observability.md")


def metric_families() -> list[str]:
    """Every family name a snapshot/telemetry export can produce, suffixes
    stripped and dynamic tails reduced to their documented prefix."""
    from ..serving.anomaly import AnomalyMonitor
    from ..serving.autoscaler import FleetAutoscaler
    from ..serving.metrics import ServingMetrics
    from ..serving.telemetry import QUANT_GAUGES

    keys = set(ServingMetrics().snapshot())
    keys |= set(AnomalyMonitor().gauges())
    # the fleet autoscaler's gauges ride the cluster metrics view's snapshot
    # (serving/autoscaler.py — no live cluster needed, the names are static)
    keys |= set(FleetAutoscaler.GAUGES)
    # quantized-serving gauges only exist on a quantized engine's points, so
    # a fresh fp surface can't produce them — lint the static name list
    # (serving/telemetry.QUANT_GAUGES, kept in sync with engine.quant_stats)
    keys |= set(QUANT_GAUGES)
    families = set()
    for key in keys:
        dyn = next((p for p in _DYNAMIC_PREFIXES if key.startswith(p)), None)
        if dyn is not None:
            families.add(dyn.rstrip("/"))
            continue
        parts = key.split("/")
        if len(parts) > 2 and parts[-1] in _STAT_SUFFIXES:
            parts = parts[:-1]
        elif "bucket" in parts:
            parts = parts[:parts.index("bucket")]
        families.add("/".join(parts))
    return sorted(families)


def trace_kinds() -> list[str]:
    """Every EV_* kind string `serving/trace.py` defines."""
    from ..serving import trace as trace_mod

    return sorted({value for name, value in vars(trace_mod).items()
                   if name.startswith("EV_") and isinstance(value, str)})


def check(doc_path: str) -> dict:
    """Importable core: ``{"doc", "families", "kinds", "missing_metrics",
    "missing_kinds", "clean"}``. Raises ``OSError`` on an unreadable doc."""
    with open(doc_path) as f:
        text = f.read()
    families = metric_families()
    kinds = trace_kinds()
    missing_metrics = [fam for fam in families if fam not in text]
    missing_kinds = [k for k in kinds if f"`{k}`" not in text]
    return {
        "doc": str(doc_path),
        "families": len(families),
        "kinds": len(kinds),
        "missing_metrics": missing_metrics,
        "missing_kinds": missing_kinds,
        "clean": not missing_metrics and not missing_kinds,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--doc", default=_DEFAULT_DOC,
                        help="doc to lint (default docs/observability.md)")
    parser.add_argument("--json", action="store_true",
                        help="print the report as one JSON document")
    args = parser.parse_args(argv)
    try:
        rep = check(args.doc)
    except (OSError, ValueError, ImportError) as exc:
        print(json.dumps({"doc": args.doc, "error": str(exc)}), flush=True)
        return 2
    if args.json:
        print(json.dumps(rep), flush=True)
    else:
        print(f"{rep['doc']}: {rep['families']} metric families, "
              f"{rep['kinds']} trace kinds")
        for fam in rep["missing_metrics"]:
            print(f"  MISSING metric family: {fam}")
        for kind in rep["missing_kinds"]:
            print(f"  MISSING trace kind (as `{kind}`)")
        print("clean" if rep["clean"] else
              f"DRIFT: {len(rep['missing_metrics'])} metric(s), "
              f"{len(rep['missing_kinds'])} kind(s) undocumented")
    return 0 if rep["clean"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
