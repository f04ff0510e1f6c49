"""Host-RAM KV block tier and request hibernation behind the paged pool: the
port of `accelerate_tpu.serving.kv_tier`.

Without it every paged engine is bounded by the card's memory: when
``blocks_free`` reaches zero, admission backpressures. The paged pool already
made KV blocks an ownership abstraction (block tables, ref-counted trie
pins, journal-backed frontier cursors), which is the handle a tiered store
needs: the logical layout (tables, trie, positions) stays fixed while the
bytes move between the device pool and pinned host buffers underneath.

Two spill granularities, coldest first:

  - **trie block spill**: evictable (unpinned) prefix-cache blocks are
    copied out to pinned host memory instead of discarded. The trie node
    stays in place with ``block_id = None``, so a later prompt match still
    hits and pages the bytes back in (one upload through the engine's
    ``_tier_upload``) instead of prefilling them again;
  - **request hibernation**: a whole admitted stream copies its written
    blocks out, releases every device block through the engine's
    `_release_slot` (the same generation bump and table-row parking that
    makes a cancelled slot's in-flight writes drop) and parks as a host
    record. Waking chooses per request between re-prefill from
    ``resume_tokens`` (the journal-proven path) and uploading the host
    blocks, whichever `choose_wake` prices cheaper under the measured
    transfer rate, and re-enters through the scheduler's front lane or
    straight into a free slot.

Copies on the card: a spill gathers the blocks on the engine's stream
(``index_select`` per pool leaf) behind every dispatch in flight, copies
them into one pinned host buffer, records an event and waits on it before
the content hashes are taken or the blocks are freed. An upload copies the
pinned buffer to the device ``non_blocking`` and scatters it into the pool
(``index_copy_``) in place; the host buffer is held, untouched, until the
upload's event has passed (`KVTier.poll` and `KVTier.settle` release it).
Transfer rates come from the device time between two CUDA events around
the copy, read once the copy is done, never from the enqueue.

Durability: host buffers are volatile. The journal, flushed at hibernation,
is the durable tier, so a crash mid-spill loses nothing: `ServingEngine.resume`
replays hibernated streams as it replays crashed ones.

A thrash guard (sliding event window with enter/exit hysteresis, injectable
clock) freezes further spill when the tier starts churning: the engine then
behaves as tier-off (discard eviction and requeue backpressure), and the
freeze raises an ``EV_ANOMALY`` trace event and a
``host_tier/thrash_events`` count. The fleet autoscaler
(`serving.autoscaler`) reuses the same guard to refuse to flap.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from .scheduler import FIFOScheduler
from .trace import EV_ANOMALY


@dataclasses.dataclass(frozen=True)
class KVTierConfig:
    """Knobs for the engine's ``kv_tier=`` argument (the reference's).
    Default-constructed the tier is demand-driven: it spills only when a
    block reservation falls short (spill-then-admit), never in the
    background.

    - ``low_water_blocks``: background spill trigger; when ``blocks_free``
      drops below it, the per-step poll pages evictable trie blocks out until
      free recovers (0 disables background spill);
    - ``hibernate_idle_s``: an admitted stream with no token progress for
      this long is hibernated by the poll (inf disables idle hibernation;
      pressure hibernation is governed by ``spill_on_pressure``);
    - ``spill_on_pressure``: let the reservation shortfall path hibernate
      cold slots (long-idle first, then oldest arrival) after trie spill
      alone falls short;
    - ``min_resident_slots``: pressure hibernation never drops the active
      slot count below this floor;
    - ``wake_policy``: ``"auto"`` runs `choose_wake` per request;
      ``"upload"`` / ``"prefill"`` force one path;
    - ``wake_cooldown_s``: a just-woken request is exempt from pressure
      hibernation for this long;
    - ``headroom_discount``: the fraction at which `capacity_headroom`
      counts host-backed blocks as token capacity;
    - ``prefill_speedup``: the wake cost model prices replay at
      ``decode_rate * speedup`` tokens/s;
    - ``max_host_blocks``: cap on host-resident trie blocks (LRU spilled
      subtrees are dropped past it; hibernated records never are, their
      durable tier is the journal). None is unbounded;
    - ``thrash_*``: the guard; freeze when ``thrash_enter_events`` page
      events land within ``thrash_window_s``, unfreeze only after the window
      stays at or below ``thrash_exit_fraction * enter`` for
      ``thrash_exit_s``."""

    low_water_blocks: int = 0
    hibernate_idle_s: float = float("inf")
    spill_on_pressure: bool = True
    min_resident_slots: int = 1
    wake_policy: str = "auto"
    wake_cooldown_s: float = 0.0
    headroom_discount: float = 0.5
    prefill_speedup: float = 8.0
    max_host_blocks: int | None = None
    thrash_window_s: float = 5.0
    thrash_enter_events: int = 64
    thrash_exit_fraction: float = 0.25
    thrash_exit_s: float = 5.0

    def __post_init__(self):
        if self.wake_policy not in ("auto", "upload", "prefill"):
            raise ValueError(
                f"wake_policy must be 'auto', 'upload' or 'prefill', got {self.wake_policy!r}")
        if self.min_resident_slots < 0:
            raise ValueError(f"min_resident_slots must be >= 0, got {self.min_resident_slots}")
        if self.thrash_enter_events < 1:
            raise ValueError(f"thrash_enter_events must be >= 1, got {self.thrash_enter_events}")


def choose_wake(host_bytes: int, replay_tokens: int, page_in_bytes_per_s: float,
                prefill_tokens_per_s: float) -> str:
    """Per-request wake decision: ``"upload"`` when restoring the host bytes
    is measurably cheaper than replaying the stream through a continuation
    prefill, else ``"prefill"`` (also the answer whenever either rate is
    unmeasured: an unproven path is never bet on a guess)."""
    if host_bytes <= 0 or page_in_bytes_per_s <= 0 or prefill_tokens_per_s <= 0:
        return "prefill"
    upload_s = host_bytes / page_in_bytes_per_s
    replay_s = replay_tokens / prefill_tokens_per_s
    return "upload" if upload_s < replay_s else "prefill"


@dataclasses.dataclass
class HostBlocks:
    """Host copies of ``n`` pool blocks in one buffer (pinned on CUDA):
    ``layout`` holds, for each pool leaf in `KVTier.leaves` order (layer by
    layer K, V and, for an int8 pool, the K and V scale planes), its byte
    offset in ``buf``, dtype and per-block shape; leaf ``j`` is
    ``[n, *shape]`` at its offset. ``crcs`` is one crc32 per block, chained
    over that block's bytes in leaf order; ``nbytes`` the exact KV bytes
    (``n * block_bytes``). A page-in hashes again and refuses corrupt
    bytes."""

    buf: torch.Tensor
    layout: tuple[tuple[int, torch.dtype, tuple[int, ...]], ...]
    n: int
    crcs: tuple[int, ...]
    nbytes: int

    def leaves(self, buf: torch.Tensor | None = None) -> list[torch.Tensor]:
        """Each leaf's ``[n, *shape]`` view of ``buf`` (default this host
        buffer; the engine's upload passes its device copy)."""
        buf = self.buf if buf is None else buf
        out = []
        for off, dtype, shape in self.layout:
            size = self.n * int(np.prod(shape)) * _itemsize(dtype)
            out.append(buf[off:off + size].view(dtype).view((self.n,) + shape))
        return out


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class HostBlockMap:
    """LRU map of spilled blocks: opaque key (a trie node) -> `HostBlocks`.
    Insertion refreshes recency; `lru_key` is the drop candidate when
    ``max_host_blocks`` bites."""

    def __init__(self):
        self._entries: OrderedDict[Any, HostBlocks] = OrderedDict()

    def put(self, key: Any, hb: HostBlocks) -> None:
        self._entries[key] = hb
        self._entries.move_to_end(key)

    def pop(self, key: Any) -> HostBlocks:
        return self._entries.pop(key)

    def get(self, key: Any) -> HostBlocks | None:
        return self._entries.get(key)

    def clear(self) -> None:
        self._entries.clear()

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def lru_key(self) -> Any | None:
        return next(iter(self._entries), None)

    @property
    def blocks(self) -> int:
        return sum(hb.n for hb in self._entries.values())

    @property
    def nbytes(self) -> int:
        return sum(hb.nbytes for hb in self._entries.values())


class ThrashGuard:
    """Sliding-window event-rate detector with enter/exit hysteresis.

    ``record(n)`` logs n events (page-ins and page-outs alike: churn is
    churn) and freezes when the window holds ``enter_events`` or more; while
    frozen, ``poll()`` unfreezes only after the window count stays at or
    below ``exit_fraction * enter_events`` for ``exit_s`` continuous
    seconds, so the guard itself cannot flap. ``clock`` is injectable (tests
    drive the hysteresis deterministically)."""

    def __init__(self, window_s: float, enter_events: int,
                 exit_fraction: float, exit_s: float, clock=time.perf_counter):
        self.window_s = float(window_s)
        self.enter_events = int(enter_events)
        self.exit_events = int(enter_events * exit_fraction)
        self.exit_s = float(exit_s)
        self.clock = clock
        self.frozen = False
        self._events: deque[float] = deque()
        self._calm_since: float | None = None

    def _prune(self, now: float) -> None:
        while self._events and now - self._events[0] > self.window_s:
            self._events.popleft()

    def record(self, n: int = 1) -> bool:
        """Log ``n`` events; True exactly when this call froze the guard (the
        caller raises the anomaly on that edge)."""
        now = self.clock()
        self._events.extend([now] * int(n))
        self._prune(now)
        if not self.frozen and len(self._events) >= self.enter_events:
            self.frozen = True
            self._calm_since = None
            return True
        return False

    def poll(self) -> bool:
        """Advance the hysteresis; True exactly when this call unfroze."""
        if not self.frozen:
            return False
        now = self.clock()
        self._prune(now)
        if len(self._events) > self.exit_events:
            self._calm_since = None
            return False
        if self._calm_since is None:
            self._calm_since = now
        if now - self._calm_since >= self.exit_s:
            self.frozen = False
            self._events.clear()
            self._calm_since = None
            return True
        return False

    @property
    def window_events(self) -> int:
        return len(self._events)


@dataclasses.dataclass
class HibernatedRequest:
    """A whole parked stream: the request (seed, params, prompt), its
    emitted tokens (the wake frontier, journal-flushed before parking), and
    host copies of its written KV blocks for the upload wake."""

    request: Any
    tokens: list[int]
    blocks: HostBlocks
    n_content: int            # leading table blocks the host copy covers
    first_token_time: float | None
    hit: bool                 # prefix-cache hit flag, restored on wake
    t_hibernated: float


class _Ema:
    """First-sample-seeded exponential moving average (transfer rates)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self.value = 0.0
        self._seeded = False

    def update(self, x: float) -> None:
        if not self._seeded:
            self.value, self._seeded = float(x), True
        else:
            self.value += self.alpha * (float(x) - self.value)


@dataclasses.dataclass
class _Upload:
    """A host-to-device copy still in flight: the host buffers it reads
    (``keep``, held untouched until ``end`` has passed), its timing events
    and what to record once it is done."""

    keep: tuple[Any, ...]
    start: Any
    end: Any
    nbytes: int
    t0: float


class KVTier:
    """The engine-side tier: the host block map, the hibernation
    records, the thrash guard and every spill and wake decision. Device work
    is the engine's (`ServingEngine._tier_upload`) or a gather here on the
    engine's stream. Built by `ServingEngine` when ``kv_tier=`` is set
    (paged mode only); ``clock`` is injectable for the policy and thrash
    tests, while transfer rates always use device (CUDA) or wall (CPU)
    time."""

    def __init__(self, engine: Any, config: KVTierConfig | None = None,
                 clock=time.perf_counter):
        self.engine = engine
        self.cfg = config or KVTierConfig()
        self.clock = clock
        self.guard = ThrashGuard(self.cfg.thrash_window_s, self.cfg.thrash_enter_events,
                                 self.cfg.thrash_exit_fraction, self.cfg.thrash_exit_s,
                                 clock=clock)
        self.trie_blocks = HostBlockMap()
        self._hibernated: OrderedDict[int, HibernatedRequest] = OrderedDict()
        self._wake_t: dict[int, float] = {}
        self._xfer = _Ema()  # bytes/s over observed spills and uploads
        self._uploads: deque[_Upload] = deque()
        self._cuda = engine.device.type == "cuda"
        # exact per-block KV bytes over the pool leaves (the write cursor is
        # per-slot state, not block content)
        self.block_bytes = sum(int(np.prod(t.shape[1:])) * t.element_size()
                               for t in self.leaves())

    def leaves(self) -> list[torch.Tensor]:
        """The engine's pool storages, sink block included, layer by layer:
        K, V and, for an int8 pool, the K and V scale planes."""
        cache = self.engine._cache
        return [t for layer in range(len(cache.k)) for t in cache.storages(layer)]

    # ------------------------------------------------------------- accounting
    @property
    def host_blocks(self) -> int:
        return self.trie_blocks.blocks + sum(r.n_content for r in self._hibernated.values())

    @property
    def host_bytes(self) -> int:
        return self.trie_blocks.nbytes + sum(r.blocks.nbytes for r in self._hibernated.values())

    @property
    def hibernated_count(self) -> int:
        return len(self._hibernated)

    @property
    def trie_host_blocks(self) -> int:
        return self.trie_blocks.blocks

    @property
    def trie_host_bytes(self) -> int:
        return self.trie_blocks.nbytes

    @property
    def uploads_in_flight(self) -> int:
        """Uploads whose host buffers are still held (their copy has not
        been seen to finish)."""
        return len(self._uploads)

    def records(self) -> list[HibernatedRequest]:
        """Hibernated records in park order (the wake order): the engine's
        snapshot and abort paths walk these like active slots."""
        return list(self._hibernated.values())

    def pop_record(self, request_id: int) -> HibernatedRequest | None:
        return self._hibernated.pop(request_id, None)

    def memory_stats(self) -> dict[str, int | float]:
        """The ``host_tier/*`` gauges (the reference's keys): current host
        occupancy and the lifetime tier counters. The device ledger is
        untouched by tiering (``free + resident + private == total`` holds
        through every spill and page-in); the host side adds ``bytes ==
        blocks * block_bytes``."""
        m = self.engine.metrics
        return {
            "bytes": self.host_bytes,
            "blocks": self.host_blocks,
            "block_bytes": self.block_bytes,
            "hibernated": len(self._hibernated),
            "page_ins": int(m.host_page_ins.value),
            "page_outs": int(m.host_page_outs.value),
            "wakeups": int(m.host_wakeups.value),
            "thrash_events": int(m.host_thrash_events.value),
            "spill_frozen": int(self.guard.frozen),
        }

    # ------------------------------------------------------------ host copies
    def _check_not_capturing(self) -> None:
        if self._cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the KV tier cannot copy blocks while a CUDA graph is captured")

    def _gather(self, block_ids: list[int]) -> tuple[HostBlocks, float]:
        """Host copies of pool blocks ``block_ids`` and the copy's seconds.
        On CUDA the gather and the device-to-host copy are enqueued behind
        every dispatch in flight (so the copy holds their writes), and the
        host waits on the copy's event before hashing; the seconds are the
        device time between the events around the copy."""
        self._check_not_capturing()
        eng = self.engine
        leaves = self.leaves()
        n = len(block_ids)
        layout, total = [], 0
        for t in leaves:
            shape = tuple(t.shape[1:])
            layout.append((total, t.dtype, shape))
            total += -(-(n * int(np.prod(shape)) * t.element_size()) // 16) * 16
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=self._cuda)
        hb = HostBlocks(buf=buf, layout=tuple(layout), n=n, crcs=(), nbytes=n * self.block_bytes)
        ids = torch.tensor(block_ids, dtype=torch.long)
        if self._cuda:
            ids = ids.pin_memory().to(eng.device, non_blocking=True)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for src, dst in zip(leaves, hb.leaves()):
                dst.copy_(src.index_select(0, ids), non_blocking=True)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for src, dst in zip(leaves, hb.leaves()):
                dst.copy_(src.index_select(0, ids))
            seconds = time.perf_counter() - t0
        hb.crcs = self._crcs(hb)
        return hb, max(seconds, 1e-9)

    @staticmethod
    def _crcs(hb: HostBlocks) -> tuple[int, ...]:
        """One crc32 per block, chained over its bytes in leaf order (the
        int8 pool's scale planes included)."""
        raw = hb.buf.numpy()
        spans = []
        for off, dtype, shape in hb.layout:
            per = int(np.prod(shape)) * _itemsize(dtype)
            spans.append((off, per))
        out = []
        for i in range(hb.n):
            c = 0
            for off, per in spans:
                c = zlib.crc32(raw[off + i * per:off + (i + 1) * per], c)
            out.append(c)
        return tuple(out)

    def _start_upload(self) -> tuple[Any, Any, float]:
        """Timing events (CUDA) and the wall clock before an upload."""
        self._check_not_capturing()
        start = end = None
        if self._cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        return start, end, time.perf_counter()

    def _finish_upload(self, keep: tuple[Any, ...], start: Any, end: Any, t0: float,
                       nbytes: int) -> None:
        """Hold an upload's host buffers until its copy has run, then record
        its seconds (`settle`): at once on the CPU, where the copy is done."""
        if end is not None:
            end.record()
        self._uploads.append(_Upload(keep, start, end, nbytes, t0))
        if not self._cuda:
            self.settle()

    def settle(self, block: bool = False) -> None:
        """Release the host buffers of every finished upload, oldest first,
        and record its seconds (device time between its events on CUDA) into
        ``host_tier/page_in_s`` and the transfer-rate average. ``block``
        waits for every upload still in flight."""
        m = self.engine.metrics
        while self._uploads:
            up = self._uploads[0]
            if up.end is not None:
                if not block and not up.end.query():
                    return
                up.end.synchronize()
                seconds = up.start.elapsed_time(up.end) / 1e3
            else:
                seconds = time.perf_counter() - up.t0
            self._uploads.popleft()
            seconds = max(seconds, 1e-9)
            m.host_page_in_s.observe(seconds)
            self._xfer.update(up.nbytes / seconds)

    def _anomaly(self, phase: str) -> None:
        """The guard's edge as an ``EV_ANOMALY`` marker. The reference marks
        only the freeze, as ``edge="enter"``; the port marks both edges with
        ``phase``, the enter/exit alternation `trace.validate` holds every
        anomaly detector to, so a traced run that froze stays clean."""
        if self.engine.tracer.enabled:
            self.engine.tracer.emit(EV_ANOMALY, None, detector="host_tier_thrash", phase=phase,
                                    window_events=self.guard.window_events)

    def _record_page_events(self, n: int) -> None:
        if self.guard.record(n):
            self.engine.metrics.host_thrash_events.inc()
            self._anomaly("enter")

    def _spilled(self, hb: HostBlocks, seconds: float, blocks: int) -> None:
        """Count one page-out of ``blocks`` blocks taking ``seconds``."""
        m = self.engine.metrics
        m.host_page_outs.inc(blocks)
        m.host_page_out_s.observe(seconds)
        self._xfer.update(hb.nbytes / seconds)
        self._record_page_events(blocks)

    # -------------------------------------------------------------- trie spill
    def _spill_victim(self) -> Any | None:
        """The LRU unpinned device-backed trie node with no device-backed
        child (deepest first by construction: a node qualifies only once its
        subtree is host-resident, so device-backed implies parent
        device-backed, and page-in can always restore top-down)."""
        pc = self.engine.prefix_cache
        victim = None
        stack = list(pc._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.ref > 0 or node.block_id is None:
                continue
            if any(c.block_id is not None for c in node.children.values()):
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        return victim

    def page_out_trie(self, n: int) -> int:
        """Spill up to ``n`` evictable trie blocks to host (they stay
        hit-able; the discard path this replaces is `PrefixCache.reclaim`).
        Returns the device blocks freed."""
        if self.engine.prefix_cache is None or self.guard.frozen:
            return 0
        freed = 0
        while freed < n and not self.guard.frozen:
            victim = self._spill_victim()
            if victim is None:
                break
            self._spill_node(victim)
            freed += 1
        return freed

    def _spill_node(self, node: Any) -> None:
        eng = self.engine
        hb, seconds = self._gather([node.block_id])
        self.trie_blocks.put(node, hb)
        eng._allocator.free([node.block_id])
        node.block_id = None
        self._spilled(hb, seconds, 1)
        cap = self.cfg.max_host_blocks
        while cap is not None and self.trie_blocks.blocks > cap:
            lru = self.trie_blocks.lru_key()
            if lru is None or lru is node:
                break
            self._drop_spilled(lru)

    def _drop_spilled(self, node: Any) -> None:
        """Host-capacity eviction of a spilled trie subtree: past the host
        cap the content exists nowhere, so the nodes leave the trie (their
        descendants are all spilled: device-backed implies parent
        device-backed)."""
        if node.parent is not None and node.parent.children.get(node.key) is node:
            del node.parent.children[node.key]
        stack = [node]
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            if cur in self.trie_blocks:
                self.trie_blocks.pop(cur)
            if self.engine.metrics is not None:
                self.engine.metrics.prefix_evictions.inc()

    def page_in_node(self, node: Any) -> bool:
        """Restore one spilled trie block into a fresh device block. All or
        nothing: an allocation failure changes nothing (no gauge moves, the
        host copy stays); a content-hash mismatch raises."""
        eng = self.engine
        hb = self.trie_blocks.get(node)
        if hb is None:
            return False
        ids = eng._allocator.alloc(1)
        if ids is None:
            return False
        if self._crcs(hb) != hb.crcs:
            eng._allocator.free(ids)
            raise RuntimeError("host-tier content hash mismatch on trie page-in "
                               "(host buffer corrupted)")
        eng._tier_upload(ids, hb)
        self.trie_blocks.pop(node)
        node.block_id = int(ids[0])
        eng.metrics.host_page_ins.inc()
        self._record_page_events(1)
        return True

    def ensure_resident(self, path: list[Any]) -> list[Any]:
        """Page a matched trie path's spilled nodes back in, in order;
        returns the longest leading run that is device-backed (a failed
        page-in truncates the match: the caller pins only what it got)."""
        for i, node in enumerate(path):
            if node.block_id is not None:
                continue
            if self.guard.frozen or not self.page_in_node(node):
                return path[:i]
        return path

    def revive(self, node: Any, block_id: int) -> None:
        """Donation met a spilled node whose bytes a retiring slot just
        wrote on the device (`PrefixCache.adopt`): take the fresh device
        block and drop the host copy, a free page-in."""
        if node in self.trie_blocks:
            self.trie_blocks.pop(node)
        node.block_id = int(block_id)

    # ------------------------------------------------------------- hibernation
    def _victims(self, now: float) -> list[int]:
        """Pressure-hibernation candidates, coldest first: long-idle slots
        (idle >= ``hibernate_idle_s``) by descending idleness, then the rest
        by arrival order. Slots inside their wake cooldown, or without a
        first emitted token, are exempt."""
        eng, cfg = self.engine, self.cfg
        out = []
        for slot in np.flatnonzero(eng._active):
            slot = int(slot)
            request, o = eng._slot_req[slot], eng._slot_out[slot]
            if request is None or o is None or not o.tokens:
                continue
            rid = request.request_id
            woken = self._wake_t.get(rid)
            if woken is not None and now - woken < cfg.wake_cooldown_s:
                continue
            idle = now - eng._slot_last_token_t[slot]
            long_idle = idle >= cfg.hibernate_idle_s
            arrival = request.arrival_time if request.arrival_time is not None else 0.0
            out.append((slot, long_idle, idle, arrival, rid))
        out.sort(key=lambda t: (not t[1], -t[2] if t[1] else 0.0, t[3], t[4]))
        return [t[0] for t in out]

    def hibernate_slot(self, slot: int) -> int:
        """Park one admitted stream: flush its unjournaled tokens (the
        durable tier), copy its written blocks to host, then tear the slot
        down through `_release_slot` (the generation bump and table-row
        parking that make lagged in-flight writes drop). Returns the device
        blocks freed (the slot's private blocks)."""
        eng = self.engine
        request, out = eng._slot_req[slot], eng._slot_out[slot]
        if request is None or out is None or not out.tokens:
            return 0
        if eng.journal is not None and len(out.tokens) > eng._slot_logged[slot]:
            eng.journal.log_progress(out.request_id, out.tokens[int(eng._slot_logged[slot]):],
                                     len(out.tokens))
            eng._slot_logged[slot] = len(out.tokens)
        plen, m = out.prompt_len, len(out.tokens)
        # the KV written so far covers positions [0, plen + m - 2]; the
        # device may be ahead of the host by dispatches in flight, whose
        # bytes are the deterministic continuation the wake decodes again,
        # so a fresher copy is still the same copy
        n_content = -(-(plen + m - 1) // eng._block_tokens)
        ids = [int(x) for x in eng._slot_table_host[slot][:n_content]]
        hb, seconds = self._gather(ids)
        rec = HibernatedRequest(request=request, tokens=list(out.tokens), blocks=hb,
                                n_content=n_content, first_token_time=out.first_token_time,
                                hit=bool(eng._slot_hit[slot]), t_hibernated=self.clock())
        freed = len(eng._slot_priv[slot])
        eng._release_slot(slot)
        self._hibernated[request.request_id] = rec
        eng.metrics.host_hibernated.inc()
        self._spilled(hb, seconds, n_content)
        return freed

    # --------------------------------------------------------------- pressure
    def release_for(self, demand_blocks: int) -> None:
        """Spill-then-admit (`ServingEngine._reserve_blocks`): free device
        blocks until the allocator covers ``demand_blocks``, evictable trie
        blocks to host first, then (``spill_on_pressure``) the coldest slots
        hibernated, which unpins their trie prefixes for the next round. A
        frozen guard makes this a no-op; the caller then falls back to
        discard eviction and requeue, the tier-off behaviour."""
        eng, cfg = self.engine, self.cfg
        alloc = eng._allocator
        while alloc.free_count < demand_blocks and not self.guard.frozen:
            if self.page_out_trie(demand_blocks - alloc.free_count):
                continue
            if not cfg.spill_on_pressure:
                return
            if int(eng._active.sum()) <= cfg.min_resident_slots:
                return
            victims = self._victims(self.clock())
            if not victims:
                return
            self.hibernate_slot(victims[0])

    def pressure_headroom(self) -> int:
        """Blocks the pressure path could free now beyond the free list and
        plain trie eviction (`ServingEngine._paged_capacity`'s optimistic
        probe): private blocks of hibernatable slots above the residency
        floor. 0 while frozen."""
        eng, cfg = self.engine, self.cfg
        if self.guard.frozen or not cfg.spill_on_pressure:
            return 0
        spare = max(0, int(eng._active.sum()) - cfg.min_resident_slots)
        if spare == 0:
            return 0
        victims = self._victims(self.clock())
        return sum(len(eng._slot_priv[s]) for s in victims[:spare])

    # -------------------------------------------------------------------- wake
    def _choose(self, rec: HibernatedRequest) -> str:
        if self.cfg.wake_policy != "auto":
            return self.cfg.wake_policy
        replay = len(rec.request.prompt) + len(rec.tokens)
        prefill_tps = self.engine.metrics.tokens_per_sec() * self.cfg.prefill_speedup
        return choose_wake(rec.blocks.nbytes, replay, self._xfer.value, prefill_tps)

    def _wake_prefill(self, rec: HibernatedRequest) -> None:
        """Re-enter through the scheduler's front lane: the continuation
        prefill from ``resume_tokens`` is the journal-proven path. Host
        blocks are dropped (tokens past the bucket cap are decoded again,
        deterministically, as `ServingEngine.resume` does)."""
        eng = self.engine
        request = rec.request
        plen = len(request.prompt)
        keep = max(0, min(len(rec.tokens), eng.scheduler.max_prompt_len - plen))
        request.resume_tokens = [int(t) for t in rec.tokens[:keep]]
        request.deadline_s = None  # consumed at its first admission
        eng.scheduler.requeue(request)

    def try_wakes(self, max_wakes: int = 1) -> int:
        """Wake up to ``max_wakes`` hibernated streams (park order). An
        upload wake needs a free slot and an all-or-nothing block
        reservation; short of blocks it spills trie blocks (never other
        slots: waking must not evict the working set) and otherwise defers,
        except on an idle engine, where deferring would deadlock: the wake
        then falls back to re-prefill and rides admission backpressure.
        Returns how many woke."""
        eng = self.engine
        woken = 0
        while self._hibernated and woken < max_wakes:
            if not eng._free:
                break
            rid, rec = next(iter(self._hibernated.items()))
            mode = self._choose(rec)
            idle_engine = not eng._active.any() and eng.scheduler.queue_depth == 0
            if mode == "upload":
                need = -(-FIFOScheduler.decode_extent(rec.request, eng.max_len)
                         // eng._block_tokens)
                if eng._allocator.free_count < need:
                    self.page_out_trie(need - eng._allocator.free_count)
                if eng._allocator.free_count < need:
                    if not idle_engine:
                        break
                    mode = "prefill"
            if mode == "upload" and not eng._wake_hibernated_upload(rec):
                if not idle_engine:
                    break
                mode = "prefill"
            if mode == "prefill":
                self._wake_prefill(rec)
            del self._hibernated[rid]
            self._wake_t[rid] = self.clock()
            eng.metrics.host_wakeups.inc()
            woken += 1
        return woken

    # -------------------------------------------------------------------- poll
    def poll(self) -> None:
        """The per-step tier tick (start of the engine's admission): release
        finished uploads' host buffers, advance the thrash hysteresis, run
        background low-water spill and idle hibernation, then attempt one
        wake."""
        self.settle()
        if self.guard.poll():
            self._anomaly("exit")
        eng, cfg = self.engine, self.cfg
        now = self.clock()
        if (cfg.low_water_blocks > 0 and not self.guard.frozen
                and eng._allocator.free_count < cfg.low_water_blocks):
            self.page_out_trie(cfg.low_water_blocks - eng._allocator.free_count)
        if cfg.hibernate_idle_s != float("inf") and not self.guard.frozen:
            for slot in np.flatnonzero(eng._active):
                slot = int(slot)
                out = eng._slot_out[slot]
                if out is None or not out.tokens:
                    continue
                if now - eng._slot_last_token_t[slot] >= cfg.hibernate_idle_s:
                    self.hibernate_slot(slot)
        self.try_wakes()

    def release(self) -> None:
        """Drop every host buffer (an engine that will not step again:
        `ServingEngine._release_device`): wait for the uploads in flight,
        then clear the spilled trie blocks and the hibernated records. The
        journal still holds every hibernated stream for a `resume`."""
        self.settle(block=True)
        self.trie_blocks.clear()
        self._hibernated.clear()
