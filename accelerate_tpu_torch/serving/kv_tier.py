"""The host-RAM KV tier's thrash guard: the port of `ThrashGuard` from
`accelerate_tpu.serving.kv_tier`.

The reference module is a host-memory block tier behind the paged pool
(`KVTier`: trie blocks spilled to host and paged back in, whole requests
hibernated and woken). That tier rewires the engine's admission and the
prefix cache's ``tier`` hook and is a later slice of the port (ROADMAP item
17). What this module holds now is the one class another module reads: the
sliding-window event-rate detector with enter/exit hysteresis that freezes
the tier when it churns, and that the fleet autoscaler
(`serving.autoscaler`) reuses to refuse to flap.
"""

from __future__ import annotations

import time
from collections import deque


class ThrashGuard:
    """Sliding-window event-rate detector with enter/exit hysteresis.

    ``record(n)`` logs n events and freezes when the window holds
    ``enter_events`` or more; while frozen, ``poll()`` unfreezes only after
    the window count stays at or below ``exit_fraction * enter_events`` for
    ``exit_s`` continuous seconds, so the guard itself cannot flap. ``clock``
    is injectable (tests drive the hysteresis deterministically)."""

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
