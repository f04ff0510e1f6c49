"""Opt-in SIGTERM preemption handling: the port of
`accelerate_tpu.reliability.preemption`.

Maintenance events and spot reclamation deliver ``SIGTERM`` with a short
grace window. `PreemptionHandler` installs a handler that lands the work a
preemption must not lose inside that window and then exits, or chains to
whatever handler was installed before it. `ServingPreemptionHandler` drains a
serving engine within ``grace_s`` and snapshots what is left
(`serving.engine.ServingEngine.snapshot`), for `ServingEngine.resume` in the
next process. The training handler (`PreemptionHandler` on an
accelerator) writes a synchronous ``accelerator.save_state`` (async would
race the kill) and waits for it to land.

Opt-in by construction: nothing installs it implicitly; a library must never
steal a host application's signal disposition::

    handler = install_serving_preemption_handler(engine, "engine.snap")
    ...serving loop...             # SIGTERM now drains, then snapshots
    handler.uninstall()            # restore the previous disposition

    handler = install_preemption_handler(accelerator)
    ...training loop...            # SIGTERM now checkpoints before exit
"""

from __future__ import annotations

import signal
import time
from typing import Any

# conventional exit status for "terminated by SIGTERM" (128 + 15)
SIGTERM_EXIT_CODE = 143


class PreemptionHandler:
    """SIGTERM -> synchronous ``save_state`` -> exit (or chain).

    ``exit_on_preempt=False`` turns the handler into a checkpoint-and-continue
    hook (useful under test, or when an outer supervisor owns process death);
    ``preempted``/``checkpoint_dir`` record what happened either way.
    ``output_dir`` None takes the accelerator's own choice (the next
    automatic ``checkpoint_<n>`` with ``automatic_checkpoint_naming``).
    """

    def __init__(
        self,
        accelerator: Any,
        output_dir: str | None = None,
        *,
        exit_on_preempt: bool = True,
        exit_code: int = SIGTERM_EXIT_CODE,
    ):
        self.accelerator = accelerator
        self.output_dir = output_dir
        self.exit_on_preempt = exit_on_preempt
        self.exit_code = exit_code
        self.preempted = False
        self.checkpoint_dir: str | None = None
        # every SIGTERM delivery, including ones swallowed by the re-entrancy
        # guard while a save is already in flight
        self.signals_seen = 0
        self._previous: Any = None
        self._installed = False
        self._handling = False

    def install(self) -> "PreemptionHandler":
        """Register on ``SIGTERM`` (main thread only — CPython restriction),
        keeping the previous disposition for chaining/uninstall."""
        if self._installed:
            return self
        self._previous = signal.signal(signal.SIGTERM, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the pre-install SIGTERM disposition."""
        if self._installed:
            signal.signal(signal.SIGTERM, self._previous or signal.SIG_DFL)
            self._installed = False

    def _handle(self, signum, frame) -> None:
        self.signals_seen += 1
        if self._handling:
            # re-entrant SIGTERM while the synchronous save is mid-write:
            # re-entering save_state would corrupt the very checkpoint the
            # grace window exists to land (and double-chaining the previous
            # handler could exit before the first save returns). Count it
            # and return — the in-flight handler finishes and then exits.
            return
        self._handling = True
        self.preempted = True
        try:
            self._on_preempt()
        finally:
            self._handling = False
            previous = self._previous
            if callable(previous):
                previous(signum, frame)
            elif self.exit_on_preempt:
                raise SystemExit(self.exit_code)

    def _on_preempt(self) -> None:
        """The work a preemption must land before the process dies (subclass
        hook; the base writes a training checkpoint)."""
        # imported here: checkpointing imports this package (retry and
        # fault points), so a module-level import would be circular
        from ..checkpointing import wait_for_checkpoint_saves

        # synchronous on purpose: the grace window ends in seconds and an
        # async save's writer thread would die with the process
        self.checkpoint_dir = self.accelerator.save_state(self.output_dir, async_save=False)
        wait_for_checkpoint_saves(self.accelerator)


class ServingPreemptionHandler(PreemptionHandler):
    """SIGTERM for a serving process: drain inside the grace window, snapshot
    whatever could not finish, then exit (or chain).

    On preemption the handler (a) flips the engine into drain mode so new
    `submit` calls are rejected with ``REJECT_DRAINING``, (b) steps the engine
    until either all in-flight and queued work finishes or ``grace_s`` wall
    seconds elapse, and (c) if work remains, writes an engine snapshot to
    ``snapshot_path`` (`ServingEngine.snapshot`) that a replacement process
    resumes from with `ServingEngine.resume` — bit-for-bit, mid-stream.
    Completed outputs collected while draining land in ``drained`` so the
    host can flush responses before the exit. Size ``grace_s`` BELOW the
    platform's kill window: the snapshot write itself (queue + per-slot token
    JSON, fsync'd) must also fit inside it.

    When the engine also has a durable request journal, a SIGKILL that beats
    this handler entirely still loses nothing: `resume` replays from the
    journal instead of the snapshot.

    Deliver-at-step-boundary: a serving loop should block SIGTERM around each
    ``engine.step()`` call (``signal.pthread_sigmask``) and unblock between
    steps, so the drain here never re-enters a step the signal interrupted
    halfway.
    """

    def __init__(
        self,
        engine: Any,
        snapshot_path: str,
        *,
        grace_s: float = 5.0,
        exit_on_preempt: bool = True,
        exit_code: int = SIGTERM_EXIT_CODE,
    ):
        super().__init__(
            accelerator=None,
            output_dir=None,
            exit_on_preempt=exit_on_preempt,
            exit_code=exit_code,
        )
        self.engine = engine
        self.snapshot_path = str(snapshot_path)
        self.grace_s = float(grace_s)
        self.drained: list[Any] = []
        self.snapshotted = False

    def _on_preempt(self) -> None:
        engine = self.engine
        engine.begin_drain()
        deadline = time.perf_counter() + self.grace_s
        finished: list[Any] = []
        try:
            while engine.has_work and time.perf_counter() < deadline:
                finished.extend(engine.step())
        finally:
            # exit path: disposition is moot; checkpoint-and-continue path
            # (exit_on_preempt=False / chained handler): the engine must
            # accept work again once the handler returns
            engine.end_drain()
        if engine.has_work:
            finished.extend(engine.snapshot(self.snapshot_path))
            self.snapshotted = True
            self.checkpoint_dir = self.snapshot_path
        self.drained = finished


def install_preemption_handler(
    accelerator: Any, output_dir: str | None = None, **kwargs: Any
) -> PreemptionHandler:
    """Install and return a `PreemptionHandler` (see class docs for knobs)."""
    return PreemptionHandler(accelerator, output_dir, **kwargs).install()


def install_serving_preemption_handler(
    engine: Any, snapshot_path: str, **kwargs: Any
) -> ServingPreemptionHandler:
    """Install and return a `ServingPreemptionHandler` (drain-or-snapshot on
    SIGTERM; see class docs for the grace-window contract)."""
    return ServingPreemptionHandler(engine, snapshot_path, **kwargs).install()
