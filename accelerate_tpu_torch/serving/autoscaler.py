"""The elastic fleet, the autoscaling control loop over `ServingCluster`: the
port of `accelerate_tpu.serving.autoscaler`.

The cluster routes around and migrates off dead replicas, and the front door
sheds load predictively; both only ever shrink the fleet. The
:class:`FleetAutoscaler` closes the loop: the replica count becomes a
controlled variable, driven by the predicted-TTFT model the front door
admits against (`frontend.predict_ttft`), with four behaviours:

- **scale up**: when the fleet's TTFT prediction stays past
  ``target_ttft_s`` for ``scale_up_windows`` consecutive evaluations, spawn
  one replica through the cluster's factory (`ServingCluster.add_replica`)
  under a fresh, never-reused index. The factory closes over one model, so a
  spawn costs a KV pool and a decode-graph capture, not a second copy of the
  weights;
- **drain and retire**: when the fleet stays idle (free-slot share at or
  above ``idle_slots_fraction`` with an empty queue) for
  ``scale_down_idle_windows`` evaluations, the least-loaded replica (the
  newest on a tie) is retired (`ServingCluster.retire_replica`): DRAINING
  until its work finishes, then RETIRED. A drain that outlives
  ``drain_grace_evals`` evaluations is forced: its work journal-migrates to
  peers and it retires anyway, losing nothing;
- **replace**: a DEAD (restart budget spent) replica is replaced by a
  successor plus the dead-journal migration (`ServingCluster.replace_replica`);
- **refuse to flap**: every scale event feeds a `kv_tier.ThrashGuard`
  window; ``thrash_enter_events`` events in it freeze scaling and raise
  ``EV_ANOMALY autoscale_thrash`` (enter and exit alternate), unfrozen only
  after the window stays calm for ``thrash_exit_s``. ``dwell_s`` spaces
  events even unfrozen. Spawn failures (the ``cluster.replica_spawn`` fault
  point) retry under a seeded `RetryPolicy`; when the retries run out the
  target falls back to the fleet's actual size.

Everything is synchronous and deterministic: ``clock`` and ``sleep`` are
injectable, every decision derives from the cluster's gauges, and the loop
runs inside `ServingCluster.step` (one evaluation a step, gated by
``eval_interval_s``), so callers keep their serving loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from ..reliability.retry import RetryPolicy
from .frontend import predict_ttft
from .kv_tier import ThrashGuard
from .request import RequestOutput
from .trace import EV_ANOMALY, EV_SCALE

# the EV_ANOMALY detector name of a frozen (thrashing) autoscaler
DETECTOR_THRASH = "autoscale_thrash"


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs of the fleet control loop (the reference's defaults).

    - ``min_replicas`` / ``max_replicas``: the fleet's size envelope;
    - ``target_ttft_s`` / ``scale_up_windows``: scale up after this many
      consecutive evaluations predicting a TTFT past the target;
    - ``idle_slots_fraction`` / ``scale_down_idle_windows``: drain and retire
      after this many consecutive evaluations with an empty queue and at
      least this share of the fleet's slots free;
    - ``eval_interval_s``: evaluations closer together are no-ops (0: every
      cluster step evaluates);
    - ``dwell_s``: least seconds between scale events (up, retire, replace);
    - ``drain_grace_evals``: evaluations a DRAINING replica may take to go
      idle before its work is force-migrated;
    - ``thrash_*``: the `ThrashGuard` window: ``thrash_enter_events`` events
      within ``thrash_window_s`` freeze scaling, which unfreezes after the
      window holds at most ``thrash_exit_fraction`` of that for
      ``thrash_exit_s``;
    - ``spawn_retry``: the seeded backoff of spawns.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    target_ttft_s: float = 1.0
    scale_up_windows: int = 3
    idle_slots_fraction: float = 0.5
    scale_down_idle_windows: int = 5
    eval_interval_s: float = 0.0
    dwell_s: float = 0.0
    drain_grace_evals: int = 8
    thrash_window_s: float = 60.0
    thrash_enter_events: int = 4
    thrash_exit_fraction: float = 0.25
    thrash_exit_s: float = 30.0
    spawn_retry: RetryPolicy = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                                           seed=0)

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(f"max_replicas ({self.max_replicas}) must be >= "
                             f"min_replicas ({self.min_replicas})")
        if self.scale_up_windows < 1 or self.scale_down_idle_windows < 1:
            raise ValueError("scale windows must be >= 1")
        if not 0.0 < self.idle_slots_fraction <= 1.0:
            raise ValueError(f"idle_slots_fraction must be in (0, 1], "
                             f"got {self.idle_slots_fraction}")


class FleetAutoscaler:
    """The fleet control loop (module docstring). It attaches itself to the
    cluster, whose `step` then calls `evaluate` once a step::

        cluster = ServingCluster(factory, workdir, replicas=1)
        scaler = FleetAutoscaler(cluster, AutoscalerConfig(
            max_replicas=3, target_ttft_s=0.5, dwell_s=2.0))
        while cluster.has_work:
            for out in cluster.step(): ...   # scaling happens inside

    ``tracer`` (optional) receives the EV_ANOMALY freeze/unfreeze pairs: a
    tracer of its own, because the anomaly validator wants enter and exit to
    alternate on one event stream and replica tracers come and go with their
    replicas. EV_SCALE events go to the involved replica's own tracer."""

    GAUGES = (
        "autoscaler/target_replicas",
        "autoscaler/actual_replicas",
        "autoscaler/draining_replicas",
        "autoscaler/replaced",
        "autoscaler/spawn_retries",
        "autoscaler/spawn_failures",
        "autoscaler/scale_frozen",
        "autoscaler/scale_ups",
        "autoscaler/retires",
    )

    def __init__(self, cluster: Any, config: AutoscalerConfig | None = None, *,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep, tracer: Any = None):
        self.cluster = cluster
        self.config = config if config is not None else AutoscalerConfig()
        self._clock = clock
        self._sleep = sleep
        self.tracer = tracer
        cfg = self.config
        self.guard = ThrashGuard(cfg.thrash_window_s, cfg.thrash_enter_events,
                                 cfg.thrash_exit_fraction, cfg.thrash_exit_s, clock=clock)
        self.target_replicas = max(cfg.min_replicas,
                                   min(cfg.max_replicas,
                                       sum(1 for r in cluster.replicas if r.accepting)))
        self.scale_ups = 0
        self.retires = 0
        self.spawn_retries = 0
        self.spawn_failures = 0
        self.evaluations = 0
        self._last_eval_t: float | None = None
        self._last_scale_t: float | None = None
        self._breach_windows = 0
        self._idle_windows = 0
        self._drain_ages: dict[int, int] = {}
        cluster.autoscaler = self

    # --- the fleet -----------------------------------------------------------------
    def _live(self) -> list[Any]:
        return [r for r in self.cluster.replicas if not r.retired and not r.supervisor.unhealthy]

    def _accepting(self) -> list[Any]:
        return [r for r in self.cluster.replicas if r.accepting]

    def predict_fleet_ttft(self) -> float | None:
        """The fleet's TTFT estimate the loop steers on: the front door's
        model (`frontend.predict_ttft`) over the cluster's headroom, the
        slowest accepting replica's step phases and the accepting replicas'
        summed concurrency."""
        accepting = self._accepting()
        if not accepting:
            return None
        timings: dict[str, float] = {}
        total_conc = 0
        for rep in accepting:
            t = getattr(rep.engine, "last_step_timings", None) or {}
            if t.get("total_s", 0.0) >= timings.get("total_s", 0.0):
                timings = t
            total_conc += int(rep.engine.max_concurrency)
        return predict_ttft(self.cluster.capacity_headroom(), timings,
                            max_concurrency=total_conc or None)

    # --- control -------------------------------------------------------------------
    def evaluate(self) -> list[RequestOutput]:
        """One evaluation (gated by the cadence): replace DEAD replicas, age
        drains toward the forced-migration grace, then decide scale up or
        down under dwell and the thrash guard. Returns the cluster-id
        outputs a forced drain delivered (`ServingCluster.step` passes them
        on)."""
        cfg = self.config
        now = self._clock()
        if self._last_eval_t is not None and now - self._last_eval_t < cfg.eval_interval_s:
            return []
        self._last_eval_t = now
        self.evaluations += 1
        if self.guard.poll() and self.tracer is not None and self.tracer.enabled:
            self.tracer.emit(EV_ANOMALY, None, detector=DETECTOR_THRASH, phase="exit",
                             window_events=0)
        self._replace_dead()
        outputs = self._age_drains()
        predicted = self.predict_fleet_ttft()
        actual = len(self._accepting())
        draining = sum(1 for r in self._live() if r.draining)
        if predicted is not None and predicted > cfg.target_ttft_s:
            self._breach_windows += 1
            self._idle_windows = 0
        else:
            self._breach_windows = 0
            self._idle_windows = self._idle_windows + 1 if self._fleet_idle() else 0
        if (self._breach_windows >= cfg.scale_up_windows
                and actual + draining < cfg.max_replicas and self._may_scale(now)):
            self.target_replicas = min(cfg.max_replicas, max(self.target_replicas, actual) + 1)
        if self.target_replicas > actual + draining:
            # a scale-up in flight: the target leads until the spawn lands
            # (the front door sheds less while this gap is open)
            if self._spawn_one():
                self._mark_scale_event(now)
                self._breach_windows = 0
            else:
                # the retries ran out: fold the target back to what the fleet
                # has (the breach windows build it up again)
                self.target_replicas = actual + draining
        elif (self._idle_windows >= cfg.scale_down_idle_windows
              and actual > cfg.min_replicas and self._may_scale(now)):
            self._retire_least_loaded()
            self._mark_scale_event(now)
            self._idle_windows = 0
            self.target_replicas = max(cfg.min_replicas, actual - 1)
        return outputs

    def _fleet_idle(self) -> bool:
        head = self.cluster.capacity_headroom()
        if int(head.get("queue_depth", 0)) > 0:
            return False
        total = sum(int(r.engine.max_concurrency) for r in self._accepting())
        if total <= 0:
            return False
        return int(head.get("slots_free", 0)) / total >= self.config.idle_slots_fraction

    def _may_scale(self, now: float) -> bool:
        if self.guard.frozen:
            return False
        if self._last_scale_t is None or self.config.dwell_s <= 0:
            return True
        return now - self._last_scale_t >= self.config.dwell_s

    def _mark_scale_event(self, now: float) -> None:
        self._last_scale_t = now
        if self.guard.record(1) and self.tracer is not None and self.tracer.enabled:
            self.tracer.emit(EV_ANOMALY, None, detector=DETECTOR_THRASH, phase="enter",
                             window_events=self.guard.window_events,
                             window_s=self.config.thrash_window_s)

    # --- spawns --------------------------------------------------------------------
    def _with_spawn_retry(self, fn: Callable[[], Any]) -> Any | None:
        """Run a spawn under the seeded retry policy: its result, or None
        when the retries ran out (the caller folds the target back)."""
        policy = self.config.spawn_retry
        for attempt, delay in enumerate([0.0] + list(policy.delays())):
            if delay > 0:
                self._sleep(delay)
            if attempt > 0:
                self.spawn_retries += 1
            try:
                return fn()
            except policy.non_retryable:
                raise
            except policy.retryable:
                continue
        self.spawn_failures += 1
        return None

    def _spawn_one(self) -> bool:
        """One scale-up spawn, with retries; True when it landed."""
        rep = self._with_spawn_retry(lambda: self.cluster.add_replica())
        if rep is None:
            return False
        self.scale_ups += 1
        tracer = getattr(rep.engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.emit(EV_SCALE, None, action="up", replica=rep.index,
                        target=self.target_replicas, actual=len(self._accepting()))
        return True

    def _replace_dead(self) -> None:
        """Spawn successors of DEAD, non-draining replicas (the dead-journal
        migration rides `replace_replica`). A dead DRAINING replica is not
        replaced: the fleet was shrinking through it, and
        `ServingCluster.step` retires it."""
        for rep in list(self.cluster.replicas):
            if rep.retired or rep.draining or not rep.supervisor.unhealthy:
                continue
            if self._with_spawn_retry(lambda idx=rep.index: self.cluster.replace_replica(idx)) \
                    is None:
                break  # stays DEAD until a later evaluation's spawn lands

    # --- drains --------------------------------------------------------------------
    def _age_drains(self) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        for rep in self.cluster.replicas:
            if rep.retired or not rep.draining:
                self._drain_ages.pop(rep.index, None)
                continue
            age = self._drain_ages.get(rep.index, 0) + 1
            self._drain_ages[rep.index] = age
            if age > self.config.drain_grace_evals:
                outputs.extend(self.cluster.retire_replica(rep.index, force=True))
                self._drain_ages.pop(rep.index, None)
        return outputs

    def _retire_least_loaded(self) -> None:
        candidates = self._accepting()
        if len(candidates) <= self.config.min_replicas:
            return
        # least load first; the newest (highest index) on a tie, so the
        # longest-lived replicas, the warmest tries, survive
        candidates.sort(key=lambda r: (r.engine.scheduler.queue_depth + r.engine.active_slots,
                                       -r.index))
        victim = candidates[0]
        self.cluster.retire_replica(victim.index)
        self.retires += 1
        self._drain_ages[victim.index] = 0

    # --- telemetry -----------------------------------------------------------------
    @property
    def frozen(self) -> bool:
        return self.guard.frozen

    def gauges(self) -> dict[str, Any]:
        """The ``autoscaler/*`` gauges (merged into the cluster metrics
        view's snapshot, so telemetry exports them)."""
        return {
            "autoscaler/target_replicas": self.target_replicas,
            "autoscaler/actual_replicas": len(self._accepting()),
            "autoscaler/draining_replicas": sum(1 for r in self.cluster.replicas
                                                if not r.retired and r.draining),
            "autoscaler/replaced": self.cluster.replaced_replicas,
            "autoscaler/spawn_retries": self.spawn_retries,
            "autoscaler/spawn_failures": self.spawn_failures,
            "autoscaler/scale_frozen": int(self.guard.frozen),
            "autoscaler/scale_ups": self.scale_ups,
            "autoscaler/retires": self.retires,
        }
