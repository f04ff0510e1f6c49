"""Durable write-ahead request journal: the port of
`accelerate_tpu.serving.journal`, byte for byte in its format, so a journal
either package writes scans in the other.

The serving durability contract is: **every ``SubmitResult(accepted=True)``
survives SIGKILL**. The engine appends a journal record at each request
lifecycle edge — SUBMIT when the scheduler accepts, FIRST_TOKEN when the
admission prefill's token lands on the host, PROGRESS every few decode tokens,
FINISH (with the full token stream) at retirement — and a restarted process
replays the journal to reconstruct exactly which requests were accepted,
which completed (and with which tokens), and how far each in-flight stream
had got. Seeded `SamplingParams` make the remainder of an interrupted stream
deterministically re-derivable, so lost PROGRESS suffixes cost re-decode
work, never correctness.

On-disk format (append-only, crash-tolerant):

  - 8-byte file magic ``ATSJRNL1``;
  - each record is ``<u32 payload_len><u32 crc32(payload)><payload>``
    (little-endian) with a UTF-8 JSON payload ``{"t": <type>, ...}``;
  - SUBMIT and FINISH records are fsync'd before the append returns (the
    durability edge — acceptance and completion must survive power loss);
    PROGRESS/FIRST_TOKEN are written+flushed but not synced (their loss only
    moves the replay frontier back);
  - a torn/truncated tail — the record being written when the process died —
    fails its length or CRC check and is TOLERATED: `scan` stops at the last
    valid frame and reports the tail bytes, and a writer reopening the file
    truncates them (`RequestJournal.compact` rewrites a journal offline).

PROGRESS records carry a token DELTA plus the cumulative count ``n``; replay
reconstructs ``tokens[: n - len(delta)] + delta``, which also makes a
quarantine's re-prefill (the stream legitimately rewinds) self-describing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Any

MAGIC = b"ATSJRNL1"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
# sanity bound: a frame longer than this is garbage, not a record (the
# largest real payload is a FINISH with a full token stream — kilobytes)
MAX_RECORD_BYTES = 1 << 26

# record types
REC_SUBMIT = "submit"
REC_FIRST_TOKEN = "first_token"
REC_PROGRESS = "progress"
REC_FINISH = "finish"

# fsync policies: "accept" (default) syncs SUBMIT/FIRST_TOKEN/FINISH — the
# records whose loss would break the accepted-work guarantee; "always" syncs
# every record (slow, exact frontier); "never" only flushes (tests).
FSYNC_ACCEPT = "accept"
FSYNC_ALWAYS = "always"
FSYNC_NEVER = "never"
_DURABLE_TYPES = frozenset({REC_SUBMIT, REC_FIRST_TOKEN, REC_FINISH})


class JournalError(RuntimeError):
    """The file is not a journal (bad magic) or violates the format in a way
    a crash cannot explain (a torn TAIL is never an error — see `scan`)."""


def request_record(request: Any) -> dict[str, Any]:
    """The JSON-serializable identity of a request: everything `resume` needs
    to reconstruct it (prompt, sampling params incl. the seed that makes the
    stream replayable, deadline, cache opt-out, priority). ``tenant`` is the
    reference's fair-share field, which the port's requests do not carry
    yet: it is written as ``""``, so the record is the reference's."""
    sp = request.params
    return {
        "rid": request.request_id,
        "prompt": [int(t) for t in request.prompt],
        "params": {
            "temperature": float(sp.temperature),
            "top_k": None if sp.top_k is None else int(sp.top_k),
            "seed": int(sp.seed),
            "max_new_tokens": int(sp.max_new_tokens),
        },
        "deadline_s": request.deadline_s,
        "cache_prefix": bool(request.cache_prefix),
        "priority": int(getattr(request, "priority", 0)),
        "tenant": str(getattr(request, "tenant", "") or ""),
    }


@dataclasses.dataclass
class JournalScan:
    """Replay of a journal: the accepted / in-flight / finished partition a
    restarted engine recovers from (`ServingEngine.resume`).

    ``submits`` preserves append order (== FIFO submit order); ``admit_order``
    lists rids by their first FIRST_TOKEN/PROGRESS record (== admission
    order). ``truncated_tail_bytes > 0`` marks a torn final record — the
    crash frontier, tolerated by design.
    """

    submits: dict[int, dict[str, Any]] = dataclasses.field(default_factory=dict)
    tokens: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    finishes: dict[int, tuple[str, list[int]]] = dataclasses.field(default_factory=dict)
    admit_order: list[int] = dataclasses.field(default_factory=list)
    records: int = 0
    records_by_type: dict[str, int] = dataclasses.field(default_factory=dict)
    valid_bytes: int = 0
    total_bytes: int = 0
    last_ts: float = 0.0
    anomalies: int = 0

    @property
    def truncated_tail_bytes(self) -> int:
        return self.total_bytes - self.valid_bytes

    def incomplete(self) -> list[int]:
        """rids accepted but with no FINISH — the work a restart must replay,
        admitted (in admission order) before queued (in submit order)."""
        admitted = [r for r in self.admit_order if r not in self.finishes]
        seen = set(admitted)
        queued = [r for r in self.submits
                  if r not in self.finishes and r not in seen]
        return admitted + queued


class RequestJournal:
    """Append-only writer over the format above. One journal per engine; the
    engine calls the ``log_*`` methods at each request lifecycle edge, and
    `ServingEngine.resume` replays via `scan`.

    ``progress_every`` is the engine's PROGRESS cadence (decode tokens per
    slot between records — the replay frontier granularity vs. write
    amplification trade). ``metrics`` (a `ServingMetrics`) gets
    ``journal_records``/``journal_bytes`` incremented per append.

    ``compact_threshold_bytes`` bounds the file on long runs: once the journal
    grows past it, the writer runs the offline `compact` in place — always at
    a record boundary (triggered only after a complete append, never
    mid-frame), swapping its own file handle around the atomic replace. Each
    firing counts in ``compactions`` (and ``metrics.journal_compactions``);
    the threshold then re-arms at ``max(threshold, 2 * compacted size)`` so a
    journal whose LIVE records already exceed the threshold does not compact
    on every append. None (default) keeps the append-only behavior.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        *,
        fsync: str = FSYNC_ACCEPT,
        progress_every: int = 8,
        metrics: Any = None,
        compact_threshold_bytes: int | None = None,
    ):
        if fsync not in (FSYNC_ACCEPT, FSYNC_ALWAYS, FSYNC_NEVER):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.path = Path(path)
        self.fsync = fsync
        self.progress_every = max(1, int(progress_every))
        self.metrics = metrics
        self.bytes_written = 0
        # cumulative host wall seconds spent inside `_append` (serialize +
        # write + flush + fsync): what the journal costs a serving run
        self.append_s = 0.0
        self.compact_threshold_bytes = (
            None if compact_threshold_bytes is None
            else max(len(MAGIC) + 1, int(compact_threshold_bytes)))
        self.compactions = 0
        self._next_compact_at = self.compact_threshold_bytes
        existing = self.path.exists() and self.path.stat().st_size > 0
        if existing:
            # validate magic AND truncate any torn tail before appending:
            # records written after leftover partial-frame bytes would be
            # unreachable forever (`scan` stops at the first bad frame)
            head = RequestJournal.scan(self.path)
            if head.truncated_tail_bytes:
                with open(self.path, "r+b") as f:
                    f.truncate(head.valid_bytes)
        self._f = open(self.path, "ab" if existing else "wb")
        if not existing:
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        self._size = self.path.stat().st_size if existing else len(MAGIC)

    @property
    def tail_offset(self) -> int:
        """Byte offset of the append frontier: the file size after the last
        complete frame."""
        return self._size

    # ------------------------------------------------------------- appending
    def _append(self, rec: dict[str, Any]) -> None:
        t0 = time.perf_counter()
        rec.setdefault("ts", time.time())
        payload = json.dumps(rec, separators=(",", ":")).encode()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        self._f.write(frame)
        self._f.flush()
        if self.fsync == FSYNC_ALWAYS or (
            self.fsync == FSYNC_ACCEPT and rec["t"] in _DURABLE_TYPES
        ):
            os.fsync(self._f.fileno())
        self.append_s += time.perf_counter() - t0
        self.bytes_written += len(frame)
        self._size += len(frame)
        if self.metrics is not None:
            self.metrics.journal_records.inc()
            self.metrics.journal_bytes.inc(len(frame))
        if self._next_compact_at is not None and self._size >= self._next_compact_at:
            self._compact_now()

    def _compact_now(self) -> None:
        """In-place auto-compaction at a record boundary: the just-finished
        append is a complete frame, so closing here loses nothing. The handle
        is reopened on the replaced file before returning — callers never see
        a closed journal."""
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass
        self._f.close()
        RequestJournal.compact(self.path)
        self._f = open(self.path, "ab")
        self._size = self.path.stat().st_size
        self.compactions += 1
        if self.metrics is not None:
            self.metrics.journal_compactions.inc()
        # re-arm above BOTH the configured threshold and twice the live size:
        # a journal whose live records alone exceed the threshold must not
        # pay a full rewrite on every subsequent append
        self._next_compact_at = max(self.compact_threshold_bytes, self._size * 2)

    def log_submit(self, request: Any) -> None:
        """WRITE-AHEAD: called after the scheduler accepts and BEFORE the
        accepted `SubmitResult` is returned — an acceptance the caller saw is
        on disk."""
        self._append({"t": REC_SUBMIT, **request_record(request)})

    def log_first_token(self, rid: int, token: int, n: int) -> None:
        """The admission token landed on the host; ``n`` is the cumulative
        stream length after it (1 for a fresh request, ``k+1`` for a stream
        resumed at ``k`` journal-known tokens)."""
        self._append({"t": REC_FIRST_TOKEN, "rid": int(rid),
                      "toks": [int(token)], "n": int(n)})

    def log_progress(self, rid: int, delta: list[int], n: int) -> None:
        self._append({"t": REC_PROGRESS, "rid": int(rid),
                      "toks": [int(t) for t in delta], "n": int(n)})

    def log_finish(self, rid: int, reason: str, tokens: list[int]) -> None:
        """Terminal record: the FULL token stream rides along so a completed
        request is parity-checkable (and dedupable) from the journal alone."""
        self._append({"t": REC_FINISH, "rid": int(rid), "reason": str(reason),
                      "toks": [int(t) for t in tokens]})

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- scanning
    @staticmethod
    def scan(path: str | os.PathLike) -> JournalScan:
        """Replay a journal into a `JournalScan`. A torn final frame (short
        header, short payload, or CRC mismatch at the very end of the file)
        is the tolerated crash frontier; a bad frame with MORE valid-looking
        data after it is indistinguishable from one, so scanning always stops
        at the first bad frame and reports the remainder as tail bytes."""
        path = Path(path)
        data = path.read_bytes()
        out = JournalScan(total_bytes=len(data))
        if len(data) < len(MAGIC) or data[: len(MAGIC)] != MAGIC:
            raise JournalError(f"{path} is not a request journal (bad magic)")
        pos = len(MAGIC)
        out.valid_bytes = pos
        while pos + _FRAME.size <= len(data):
            length, crc = _FRAME.unpack_from(data, pos)
            start = pos + _FRAME.size
            if length > MAX_RECORD_BYTES or start + length > len(data):
                break  # torn tail
            payload = data[start : start + length]
            if zlib.crc32(payload) != crc:
                break  # torn tail (or corruption — frontier either way)
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            pos = start + length
            out.valid_bytes = pos
            out.records += 1
            rtype = rec.get("t", "?")
            out.records_by_type[rtype] = out.records_by_type.get(rtype, 0) + 1
            out.last_ts = max(out.last_ts, float(rec.get("ts", 0.0)))
            rid = rec.get("rid")
            if rtype == REC_SUBMIT:
                out.submits[rid] = rec
                out.tokens.setdefault(rid, [])
            elif rtype in (REC_FIRST_TOKEN, REC_PROGRESS):
                if rid not in out.submits:
                    out.anomalies += 1
                    continue
                if rid not in out.admit_order:
                    out.admit_order.append(rid)
                toks = [int(t) for t in rec.get("toks", ())]
                n = int(rec.get("n", 0))
                have = out.tokens.setdefault(rid, [])
                base = n - len(toks)
                if 0 <= base <= len(have):
                    # normal append (base == len(have)) or a legitimate
                    # rewind (watchdog re-prefill replays from ``base``)
                    out.tokens[rid] = have[:base] + toks
                else:
                    out.anomalies += 1  # gap — a record order violation
            elif rtype == REC_FINISH:
                if rid not in out.submits:
                    out.anomalies += 1
                    continue
                out.finishes[rid] = (
                    str(rec.get("reason", "")),
                    [int(t) for t in rec.get("toks", ())],
                )
            else:
                out.anomalies += 1
        return out

    # ------------------------------------------------------------ compaction
    @staticmethod
    def compact(path: str | os.PathLike, *, keep_finished: bool = False
                ) -> JournalScan:
        """Rewrite a journal in place (atomic replace), collapsing each
        incomplete request's PROGRESS chain to one cumulative record and —
        unless ``keep_finished`` — dropping completed requests entirely
        (standard WAL checkpointing: the terminal outputs were already
        delivered). Returns the pre-compaction scan."""
        path = Path(path)
        scan = RequestJournal.scan(path)
        tmp = path.with_suffix(path.suffix + ".compact")
        writer = RequestJournal(tmp, fsync=FSYNC_NEVER)
        try:
            for rid, sub in scan.submits.items():
                finished = rid in scan.finishes
                if finished and not keep_finished:
                    continue
                writer._append({k: v for k, v in sub.items()})
                if finished:
                    reason, toks = scan.finishes[rid]
                    writer.log_finish(rid, reason, toks)
                elif scan.tokens.get(rid):
                    toks = scan.tokens[rid]
                    writer.log_progress(rid, toks, len(toks))
            writer._f.flush()
            os.fsync(writer._f.fileno())
        finally:
            writer.close()
        os.replace(tmp, path)
        return scan
