"""Offline audit / compaction for serving request journals: the port of the
repository's ``tools/journal_fsck.py`` over the PyTorch port's
`serving.journal.RequestJournal` (the same file format).

Validates every CRC-framed record, partitions requests into finished vs
in-flight (what a `ServingEngine.resume` would replay), and reports a torn
final record as the TOLERATED crash frontier — truncated tail bytes are
expected after a SIGKILL, not corruption. ``--compact`` rewrites the journal
in place (atomic replace): each in-flight request's PROGRESS chain collapses
to one cumulative record and finished requests are dropped (keep them with
``--keep-finished``), which is standard WAL checkpointing.

Prints ONE JSON report line. Exit status: 0 = clean (a truncated tail alone
is still clean), 1 = mid-file anomalies (records out of order, unknown types,
tokens for never-submitted rids — a crash cannot explain these), 2 = not a
journal at all (bad magic / unreadable).

``--all DIR`` audits every ``*.journal`` under a directory tree — the shape
a `ServingCluster` workdir leaves behind (``replica{i}/requests.journal``
per replica) — and reports one aggregate line whose exit status is the
WORST per-file status, so one command answers "is this whole cluster's
durable state sound".

Run:
    python -m accelerate_tpu_torch.tools.journal_fsck.py PATH [--compact]
        [--keep-finished]
    python -m accelerate_tpu_torch.tools.journal_fsck.py --all DIR [--compact]
        [--keep-finished]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

from ..serving.journal import JournalError, RequestJournal


def fsck(path: str, *, compact: bool = False, keep_finished: bool = False) -> dict:
    """Scan (and optionally compact) one journal; return the report dict
    (importable)."""
    scan = RequestJournal.scan(path)
    report = {
        "path": str(path),
        "records": scan.records,
        "records_by_type": dict(sorted(scan.records_by_type.items())),
        "bytes": scan.total_bytes,
        "valid_bytes": scan.valid_bytes,
        # > 0 marks the record being appended when the process died — the
        # crash frontier `scan` stops at, tolerated by design
        "truncated_tail_bytes": scan.truncated_tail_bytes,
        "anomalies": scan.anomalies,
        "submitted": len(scan.submits),
        "finished": len(scan.finishes),
        "in_flight": [
            {"rid": rid, "tokens": len(scan.tokens.get(rid, []))}
            for rid in scan.incomplete()
        ],
        "clean": scan.anomalies == 0,
    }
    if compact:
        RequestJournal.compact(path, keep_finished=keep_finished)
        report["compacted_bytes"] = os.path.getsize(path)
    return report


def fsck_all(directory: str, *, compact: bool = False,
             keep_finished: bool = False) -> tuple[dict, int]:
    """Audit every ``*.journal`` under ``directory`` (recursive — a cluster
    workdir keeps one per ``replica{i}/`` subdir). Returns ``(aggregate
    report, exit code)``: per-file reports (unreadable files become
    ``{"path", "error"}`` entries instead of aborting the sweep) and the
    aggregate exit code is the WORST per-file code — 2 when any file is not
    a journal or the directory holds none at all."""
    paths = sorted(Path(directory).rglob("*.journal"))
    if not paths:
        return ({"path": str(directory),
                 "error": "no *.journal files found"}, 2)
    reports: list[dict] = []
    code = 0
    for path in paths:
        try:
            rep = fsck(str(path), compact=compact,
                       keep_finished=keep_finished)
        except (JournalError, OSError) as exc:
            rep = {"path": str(path), "error": str(exc)}
            code = 2
        replica = _replica_index(path)
        if replica is not None:
            rep["replica"] = replica
        reports.append(rep)
        if "error" not in rep and not rep["clean"]:
            code = max(code, 1)
    # an elastic fleet's workdir legitimately holds retired/replaced replica
    # dirs (closed journals, successor indices past the live count, index
    # gaps where nothing was ever spawned under a reused number) — stable
    # indices are the contract, not contiguity, so the sweep reports them
    # and never flags a gap as an anomaly
    indices = sorted({r["replica"] for r in reports if "replica" in r})
    return ({
        "path": str(directory),
        "journals": len(paths),
        "clean_journals": sum(1 for r in reports if r.get("clean")),
        "replica_indices": indices,
        "submitted": sum(r.get("submitted", 0) for r in reports),
        "finished": sum(r.get("finished", 0) for r in reports),
        "in_flight": sum(len(r.get("in_flight", ())) for r in reports),
        "reports": reports,
        "clean": code == 0,
    }, code)


def _replica_index(path: Path) -> int | None:
    """The ``replica<i>`` index a cluster journal's directory encodes, or
    None for a standalone journal."""
    for part in reversed(path.parts):
        m = re.fullmatch(r"replica(\d+)", part)
        if m:
            return int(m.group(1))
    return None


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", default=None,
                        help="journal file to audit")
    parser.add_argument("--all", metavar="DIR", default=None,
                        help="audit every *.journal under DIR (recursive); "
                             "exit with the worst per-file status")
    parser.add_argument("--compact", action="store_true",
                        help="rewrite in place: collapse progress chains, "
                             "drop finished requests")
    parser.add_argument("--keep-finished", action="store_true",
                        help="with --compact: keep finished requests' "
                             "terminal records")
    args = parser.parse_args(argv)
    if (args.path is None) == (args.all is None):
        parser.error("give exactly one of PATH or --all DIR")
    if args.all is not None:
        report, code = fsck_all(args.all, compact=args.compact,
                                keep_finished=args.keep_finished)
        print(json.dumps(report), flush=True)
        return code
    try:
        report = fsck(args.path, compact=args.compact,
                      keep_finished=args.keep_finished)
    except (JournalError, OSError) as exc:
        print(json.dumps({"path": args.path, "error": str(exc)}), flush=True)
        return 2
    print(json.dumps(report), flush=True)
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
