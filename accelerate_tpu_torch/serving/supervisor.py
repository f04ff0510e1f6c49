"""Self-healing serving, the engine supervisor: the port of
`accelerate_tpu.serving.supervisor`.

`ServingEngine` already survives crashes *passively* (the request journal
plus `resume()` make a restart lossless), but something still has to notice
that the engine is sick and drive that restart. That is the
:class:`EngineSupervisor`: it owns the engine, wraps every `step()` in a
health check, classifies failures, and walks an **escalating recovery
ladder**:

1. **soft**: the engine's own health flag (quarantine and re-prefill of a
   poisoned slot) keeps handling isolated bad steps; the supervisor only
   counts them;
2. **rebuild**: a stall (step wall time past ``stall_timeout_s`` with no
   compile to excuse it), a NaN **storm** (``storm_quarantines``
   quarantines inside a ``storm_window_steps`` window) or a device/runtime
   error escaping the step tears the engine down and rebuilds it through the
   caller's factory, then replays the journal with `ServingEngine.resume`.
   The old engine's device memory (its CUDA graph and pool, KV pools and
   pinned rings) is released before the new one captures its graph, so a
   restart does not leak device memory. A compile is a CUDA graph capture or
   a dispatch that built or loaded a kernel library (nvcc at first use), so
   a start-up step is never taken for a stall;
3. **shed**: restarts are metered by a :class:`RestartBudget` (seeded
   backoff through `reliability.RetryPolicy`); when the budget runs out the
   supervisor fails LOUDLY instead of flapping: every queued or active
   request is retired as ``rejected:unhealthy``, new submits are rejected
   with `REJECT_UNHEALTHY`, and further `step()` calls raise
   :class:`EngineUnhealthyError`.

A rebuild inside the process heals what the engine's own state can carry:
an injected or transient fault. A sticky CUDA error (an illegal address, a
device-side assert) poisons the process's CUDA context, and no engine built
in it can run again: recovery then is a new process that resumes the same
journal (`ServingEngine.resume`, or a supervisor built over it).

Orthogonally, the supervisor runs an overload **brownout** driven by
`ServingEngine.capacity_headroom`: when the predicted slot wait or the paged
pool's free blocks cross the configured thresholds it raises a brownout
*level* that sheds the lowest-priority admissions (`REJECT_OVERLOAD` for
``priority < level``) and clamps ``max_new_tokens``, then recovers
**hysteretically**: the level only drops after ``brownout_exit_steps``
consecutive calm steps well inside the threshold (``brownout_exit_fraction``).

Everything is synchronous and deterministic: no threads, an injectable clock
and sleep, and every decision derives from the engine's own metrics and the
shared tracer.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from ..reliability.retry import RetryPolicy
from .journal import MAGIC, RequestJournal
from .metrics import ServingMetrics
from .request import (
    FINISH_ERROR,
    REJECT_DRAINING,
    REJECT_OVERLOAD,
    REJECT_UNHEALTHY,
    Request,
    RequestOutput,
    SamplingParams,
    SubmitResult,
)
from .trace import EV_BROWNOUT, EV_FETCH, EV_RESTART, EV_STALL

# failure classifications (EV_RESTART ``reason`` / RecoveryReport bookkeeping)
FAIL_STALL = "stall"
FAIL_STORM = "nan_storm"
FAIL_DEVICE_ERROR = "device_error"


class EngineUnhealthyError(RuntimeError):
    """The restart budget is exhausted and the engine was failed loudly;
    `step()` refuses to pretend otherwise. The backlog was already accounted
    for — every in-flight request came back ``rejected:unhealthy``."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Knobs for the health loop (the reference's defaults).

    - ``stall_timeout_s``: a step slower than this — with no compile during
      the step to excuse it (a graph capture or a kernel build) — is
      classified `FAIL_STALL`;
    - ``storm_window_steps`` / ``storm_quarantines``: `FAIL_STORM` when the
      engine's soft watchdog quarantined this many requests inside the
      window (isolated poisoned steps stay on the soft rung);
    - ``max_restarts`` / ``restart_policy``: the restart budget — backoff
      delays come from ``restart_policy.delays()`` (seeded jittered
      exponential), and restart ``max_restarts + 1`` is refused: the
      supervisor fails unhealthy instead of flapping;
    - ``recoverable``: exception types from `step()` that mean *the device*
      failed (rebuild), as opposed to a programming error (propagate); a
      CUDA error surfaces as a ``RuntimeError``;
    - brownout: entered when predicted slot wait exceeds
      ``brownout_ttft_s`` or free blocks drop below
      ``brownout_min_blocks_free`` (either None disables that trigger; both
      None disables the brownout entirely). Each overloaded step raises the
      level by 1 up to ``brownout_max_level``; at level L admissions with
      ``priority < L`` are shed and ``max_new_tokens`` is clamped to
      ``brownout_clamp_tokens`` (None = no clamp). The level drops by 1
      only after ``brownout_exit_steps`` consecutive steps *well* inside
      the threshold (x ``brownout_exit_fraction``) — the hysteresis band.
    """

    stall_timeout_s: float = 5.0
    storm_window_steps: int = 16
    storm_quarantines: int = 3
    max_restarts: int = 3
    restart_policy: RetryPolicy = RetryPolicy(
        max_attempts=4, base_delay_s=0.05, max_delay_s=2.0, seed=0)
    recoverable: tuple[type[BaseException], ...] = (RuntimeError, OSError)
    brownout_ttft_s: float | None = None
    brownout_min_blocks_free: int | None = None
    brownout_exit_fraction: float = 0.5
    brownout_exit_steps: int = 3
    brownout_max_level: int = 3
    brownout_clamp_tokens: int | None = None


class RestartBudget:
    """Seeded-backoff restart metering on top of `reliability.RetryPolicy`.

    ``acquire()`` returns the backoff delay (seconds) the caller must sleep
    before restart number ``used`` — 0.0 for the first restart (the journal
    made it free), then the policy's jittered exponential sequence — or
    ``None`` when the budget is exhausted and the caller must fail loudly.
    """

    def __init__(self, max_restarts: int, policy: RetryPolicy):
        self.max_restarts = max(0, int(max_restarts))
        self.policy = policy
        self.used = 0
        self._backoffs = list(policy.delays())

    @property
    def exhausted(self) -> bool:
        return self.used >= self.max_restarts

    def acquire(self) -> float | None:
        if self.used >= self.max_restarts:
            return None
        # restart 1 is immediate; restart n>1 waits the policy's (n-1)-th
        # delay (clamped to the last one when the budget outruns the policy)
        if self.used == 0:
            delay = 0.0
        elif self._backoffs:
            delay = self._backoffs[min(self.used - 1, len(self._backoffs) - 1)]
        else:
            delay = float(self.policy.max_delay_s)
        self.used += 1
        return delay


class EngineSupervisor:
    """Owns a `ServingEngine` and keeps it serving (module docstring).

    ``engine_factory`` builds a fresh engine; it MUST forward its keyword
    arguments (``journal``, ``metrics``, ``tracer``) into the
    `ServingEngine` constructor and reuse the SAME model object on every
    call, so a rebuilt engine serves the same weights (on CUDA it captures
    its own decode graph, which counts as a compile; the kernel libraries
    stay loaded)::

        sup = EngineSupervisor(
            lambda **kw: ServingEngine(model, eos_token_id=eos, **kw),
            workdir / "requests.journal",
            config=SupervisorConfig(stall_timeout_s=2.0),
        )

    The supervisor mirrors the engine's serving API (``submit`` / ``step`` /
    ``has_work``) so callers swap it in transparently; the engine stays
    reachable at ``.engine`` for everything else. If ``journal_path``
    already holds records from a dead process, construction auto-resumes it
    — the first ``step()`` delivers the recovered outputs.

    ``headroom_fn`` overrides the brownout's capacity probe (default: the
    live engine's `capacity_headroom`); ``clock``/``sleep`` are injectable
    for tests.
    """

    def __init__(
        self,
        engine_factory: Callable[..., Any],
        journal_path: str | Path,
        *,
        config: SupervisorConfig | None = None,
        metrics: ServingMetrics | None = None,
        tracer: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] = time.sleep,
        headroom_fn: Callable[[], dict[str, Any]] | None = None,
    ):
        self.config = config if config is not None else SupervisorConfig()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._factory = engine_factory
        self._journal_path = Path(journal_path)
        self._tracer = tracer
        self._clock = clock
        self._sleep = sleep
        self._headroom_fn = headroom_fn
        self._budget = RestartBudget(self.config.max_restarts,
                                     self.config.restart_policy)
        self._quarantines: deque[int] = deque(
            maxlen=max(1, int(self.config.storm_window_steps)))
        self._unhealthy = False
        self._draining = False
        self._last_failure: tuple[str, BaseException | None] | None = None
        self._delivered: set[int] = set()
        self._pending: list[RequestOutput] = []
        self._last_step_s = 0.0
        self._last_step_end = clock()
        self._brownout_level = 0
        self._calm_steps = 0
        self._brownout_mark = clock()
        self.last_recovery = None
        # a journal with records beyond the magic means a dead process left
        # work behind — recover it NOW, before the first submit could race
        # the replay (resume() requires an idle engine)
        preexisting = (self._journal_path.exists()
                       and self._journal_path.stat().st_size > len(MAGIC))
        self._engine = self._build_engine()
        if self._engine.journal is None:
            raise ValueError(
                "engine_factory must forward journal= into ServingEngine — "
                "the supervisor's restart ladder is journal-backed")
        if preexisting:
            report = self._engine.resume()
            self.last_recovery = report
            self._pending.extend(o for _, o in sorted(report.completed.items()))
            self._pending.extend(report.expired)
            self._note_delivered(self._pending)

    # ----------------------------------------------------------- construction
    def _build_engine(self) -> Any:
        return self._factory(journal=str(self._journal_path),
                             metrics=self.metrics, tracer=self._tracer)

    def _note_delivered(self, outputs: list[RequestOutput]) -> None:
        self._delivered.update(o.request_id for o in outputs)

    # -------------------------------------------------------------- serving API
    @property
    def engine(self) -> Any:
        """The live engine (replaced across restarts — don't cache it)."""
        return self._engine

    @property
    def journal_path(self) -> Path:
        """The write-ahead journal backing every rebuild of this engine."""
        return self._journal_path

    @property
    def unhealthy(self) -> bool:
        return self._unhealthy

    @property
    def draining(self) -> bool:
        """A sticky drain mark for drain-aware stepping: unlike the engine's
        own ``begin_drain`` flag, this one survives the restart ladder (an
        engine that stalls and rebuilds mid-drain comes back still refusing
        admissions)."""
        return self._draining

    def begin_drain(self) -> None:
        """Stop admissions but keep stepping. Idempotent; persists across
        restarts until `end_drain`."""
        self._draining = True
        if not self._unhealthy:
            self._engine.begin_drain()

    def end_drain(self) -> None:
        self._draining = False
        if not self._unhealthy:
            self._engine.end_drain()

    @property
    def restarts(self) -> int:
        return self._budget.used

    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    @property
    def has_work(self) -> bool:
        if self._unhealthy:
            return False
        return bool(self._pending) or self._engine.has_work

    def heartbeat(self) -> dict[str, Any]:
        """The health line: last step wall time, how
        stale the loop is, the shared tracer's dispatch-sequence watermark
        (a stuck watermark across wall time = a wedged dispatch), and the
        ladder's position."""
        tracer = getattr(self._engine, "tracer", None)
        return {
            "unhealthy": self._unhealthy,
            "draining": self._draining,
            "last_step_s": self._last_step_s,
            "age_s": max(0.0, self._clock() - self._last_step_end),
            "dispatch_seq": int(getattr(tracer, "_seq", 0)),
            "stalled": self._last_step_s > self.config.stall_timeout_s,
            "restarts": self._budget.used,
            "restarts_remaining": self._budget.max_restarts - self._budget.used,
            "brownout_level": self._brownout_level,
            # the engine's most recent StepTimings.as_dict() ({} before the
            # first step / on engines predating phase timing) — the per-phase
            # view of the same wall time ``last_step_s`` totals
            "step_phases": dict(
                getattr(self._engine, "last_step_timings", None) or {}),
        }

    def submit(self, request: Request | Any,
               params: SamplingParams | None = None) -> SubmitResult:
        """Admission with the supervisor's gates in front of the engine's:
        unhealthy rejects everything (`REJECT_UNHEALTHY`); an active
        brownout sheds ``priority < level`` (`REJECT_OVERLOAD`) and clamps
        ``max_new_tokens``; whatever passes goes to `ServingEngine.submit`."""
        if self._unhealthy:
            self.metrics.requests_rejected.inc()
            self.metrics.supervisor_shed.inc()
            return SubmitResult(False, None, REJECT_UNHEALTHY,
                                "restart budget exhausted — engine failed")
        if self._draining:
            self.metrics.requests_rejected.inc()
            return SubmitResult(False, None, REJECT_DRAINING,
                                "replica is draining toward retirement")
        if not isinstance(request, Request):
            request = Request(prompt=list(request),
                             params=params or SamplingParams())
        level = self._brownout_level
        if level > 0:
            if request.priority < level:
                self.metrics.requests_rejected.inc()
                self.metrics.supervisor_shed.inc()
                return SubmitResult(
                    False, None, REJECT_OVERLOAD,
                    f"brownout level {level} sheds priority < {level}")
            clamp = self.config.brownout_clamp_tokens
            if clamp is not None and request.params.max_new_tokens > clamp:
                request.params = dataclasses.replace(
                    request.params, max_new_tokens=int(clamp))
        return self._engine.submit(request, params)

    def step(self) -> list[RequestOutput]:
        """One supervised engine step: run it, classify any failure, walk
        the recovery ladder, update the brownout. Returns the outputs the
        caller would have seen from an unsupervised engine PLUS anything a
        restart recovered (completed/expired at resume, deduplicated against
        what this supervisor already delivered)."""
        if self._unhealthy:
            raise EngineUnhealthyError(
                f"engine is unhealthy (restart budget "
                f"{self._budget.max_restarts} exhausted; last failure: "
                f"{self._last_failure and self._last_failure[0]})")
        outputs: list[RequestOutput] = self._pending
        self._pending = []
        metrics = self.metrics
        compiles0 = metrics.compile_count.value
        retried0 = metrics.requests_retried.value
        failure: str | None = None
        error: BaseException | None = None
        t0 = self._clock()
        try:
            produced = self._engine.step()
        except self.config.recoverable as e:
            produced = []
            failure = FAIL_DEVICE_ERROR
            # the traceback's frames hold the failed engine: drop them, so
            # the restart frees it
            error = e.with_traceback(None)
        now = self._clock()
        self._last_step_s = now - t0
        self._last_step_end = now
        tracer = getattr(self._engine, "tracer", None)
        if failure is None:
            # stall: the step's wall time blew past the timeout and no
            # compile happened during it (a graph capture or a kernel build
            # is slow legitimately: restarting on it would flap forever)
            compiled = metrics.compile_count.value > compiles0
            if self._last_step_s > self.config.stall_timeout_s and not compiled:
                failure = FAIL_STALL
                metrics.supervisor_stalls.inc()
                if tracer is not None and tracer.enabled:
                    tracer.emit(EV_STALL, None,
                                elapsed_s=round(self._last_step_s, 6),
                                timeout_s=self.config.stall_timeout_s,
                                dispatch_seq=int(getattr(tracer, "_seq", 0)))
            else:
                # storm: soft-rung interventions this step = health-flag
                # re-prefills (requests_retried delta) + terminal errors
                quarantined = (metrics.requests_retried.value - retried0
                               + sum(1 for o in produced
                                     if o.finish_reason == FINISH_ERROR))
                self._quarantines.append(quarantined)
                if sum(self._quarantines) >= self.config.storm_quarantines:
                    failure = FAIL_STORM
                    metrics.supervisor_storms.inc()
        self._note_delivered(produced)
        outputs.extend(produced)
        if failure is not None:
            outputs.extend(self._recover(failure, error))
        self._update_brownout(self._clock())
        return outputs

    def drain(self, max_steps: int | None = None) -> list[RequestOutput]:
        """Supervised graceful shutdown: step until idle (recovering along
        the way), bounded by ``max_steps``."""
        self._engine.begin_drain()
        outputs: list[RequestOutput] = []
        steps = 0
        try:
            while self.has_work:
                outputs.extend(self.step())
                steps += 1
                if max_steps is not None and steps >= max_steps and self.has_work:
                    aborted = self._engine.abort_all()
                    self._note_delivered(aborted)
                    outputs.extend(aborted)
                    break
        finally:
            if not self._unhealthy:
                self._engine.end_drain()
        return outputs

    def close(self) -> None:
        if self._engine.journal is not None:
            self._engine.journal.close()

    # --------------------------------------------------------- recovery ladder
    def _recover(self, kind: str, error: BaseException | None
                 ) -> list[RequestOutput]:
        delay = self._budget.acquire()
        if delay is None:
            return self._fail_unhealthy(kind, error)
        return self._restart(kind, delay, error)

    def _restart(self, kind: str, delay: float, error: BaseException | None
                 ) -> list[RequestOutput]:
        """Rung 2: tear the engine down, rebuild through the factory, replay
        the journal. The shared tracer spans the restart, so the old
        engine's never-fetched in-flight dispatches are drained as
        *discarded* fetches first (dispatch/fetch stays balanced). The old
        engine's device memory is released before the factory runs, so the
        new engine's capture does not stack on it."""
        old = self._engine
        if delay > 0:
            self._sleep(delay)
        tracer = getattr(old, "tracer", None)
        try:
            if tracer is not None and tracer.enabled:
                inflight = list(getattr(old, "_inflight", ()))
                for i, entry in enumerate(inflight):
                    tracer.emit(EV_FETCH, None, seq=entry.seq,
                                what=entry.kind, discarded=True,
                                depth=len(inflight) - i - 1)
            getattr(old, "_inflight", deque()).clear()
            if old.journal is not None:
                # the rebuilt engine reopens the same file — the old handle
                # must be flushed and closed first, or the two writers race
                old.journal.close()
            old._release_device()
        except Exception:
            pass  # teardown of a broken engine is best-effort by definition
        del old
        self._engine = None
        gc.collect()
        self._engine = self._build_engine()
        if self._draining:
            # the rebuilt engine starts admitting by default; a draining
            # replica must come back still closed to new work
            self._engine.begin_drain()
        report = self._engine.resume()
        self.last_recovery = report
        self._last_failure = (kind, error)
        self._quarantines.clear()
        self.metrics.supervisor_restarts.inc()
        tracer = getattr(self._engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.emit(EV_RESTART, None, reason=kind,
                        attempt=self._budget.used,
                        backoff_s=round(delay, 6),
                        resumed=len(report.resumed),
                        restored=len(report.restored),
                        error=repr(error) if error is not None else None)
        recovered = [o for rid, o in sorted(report.completed.items())
                     if rid not in self._delivered]
        recovered += [o for o in report.expired
                      if o.request_id not in self._delivered]
        self._note_delivered(recovered)
        return recovered

    def _fail_unhealthy(self, kind: str, error: BaseException | None
                        ) -> list[RequestOutput]:
        """Rung 3: the budget is spent — fail LOUDLY, never flap. Every
        queued/active request is retired as ``rejected:unhealthy`` (journal
        and trace included), admission is closed, and the caller gets the
        full accounting back."""
        self._unhealthy = True
        self._last_failure = (kind, error)
        reason = f"rejected:{REJECT_UNHEALTHY}"
        try:
            outs = self._engine.abort_all(reason=reason)
        except Exception:
            # the engine is too broken even to abort — account for the
            # backlog straight from the journal, the source of truth
            outs = self._outputs_from_journal(reason)
        try:
            self._engine.begin_drain()
        except Exception:
            pass
        try:
            if self._engine.journal is not None:
                self._engine.journal.close()
        except Exception:
            pass
        outs = [o for o in outs if o.request_id not in self._delivered]
        self._note_delivered(outs)
        self.metrics.supervisor_shed.inc(len(outs))
        return outs

    def _outputs_from_journal(self, reason: str) -> list[RequestOutput]:
        try:
            scan = RequestJournal.scan(self._journal_path)
        except Exception:
            return []
        now = self._clock()
        return [
            RequestOutput(
                request_id=rid,
                prompt_len=len(scan.submits[rid].get("prompt", ())),
                tokens=list(scan.tokens.get(rid, [])),
                finish_reason=reason, finish_time=now,
            )
            for rid in scan.incomplete()
        ]

    # ---------------------------------------------------------------- brownout
    def _update_brownout(self, now: float) -> None:
        cfg = self.config
        if cfg.brownout_ttft_s is None and cfg.brownout_min_blocks_free is None:
            return
        if self._brownout_level > 0:
            self.metrics.supervisor_time_in_brownout_s += max(
                0.0, now - self._brownout_mark)
        self._brownout_mark = now
        head = (self._headroom_fn() if self._headroom_fn is not None
                else self._engine.capacity_headroom())
        overloaded = False
        calm = True
        if cfg.brownout_ttft_s is not None:
            wait = head.get("est_slot_free_s")
            if wait is not None:
                if wait > cfg.brownout_ttft_s:
                    overloaded = True
                if wait > cfg.brownout_ttft_s * cfg.brownout_exit_fraction:
                    calm = False
        if cfg.brownout_min_blocks_free is not None:
            free = head.get("blocks_free")
            if free is not None:
                if free < cfg.brownout_min_blocks_free:
                    overloaded = True
                if free * cfg.brownout_exit_fraction < cfg.brownout_min_blocks_free:
                    calm = False
        previous = self._brownout_level
        if overloaded:
            self._calm_steps = 0
            self._brownout_level = min(cfg.brownout_max_level, previous + 1)
        elif calm and previous > 0:
            # hysteresis: only sustained, comfortably-inside-threshold calm
            # steps walk the level back down; the band between "calm" and
            # "overloaded" holds the level steady
            self._calm_steps += 1
            if self._calm_steps >= cfg.brownout_exit_steps:
                self._calm_steps = 0
                self._brownout_level = previous - 1
        else:
            self._calm_steps = 0
        level = self._brownout_level
        tracer = getattr(self._engine, "tracer", None)
        if previous == 0 and level > 0:
            self.metrics.supervisor_brownouts.inc()
            self.metrics.supervisor_brownout_active = 1
            if tracer is not None and tracer.enabled:
                tracer.emit(EV_BROWNOUT, None, phase="enter", level=level)
        elif previous > 0 and level == 0:
            self.metrics.supervisor_brownout_active = 0
            if tracer is not None and tracer.enabled:
                tracer.emit(EV_BROWNOUT, None, phase="exit", level=0)
