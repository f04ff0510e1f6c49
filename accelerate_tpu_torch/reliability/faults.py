"""Deterministic, scoped fault injection: the port of
`accelerate_tpu.reliability.faults`.

Preemptions, transient I/O errors and poisoned decode steps are routine at
scale, so every recovery path (the serving engine's health flag and
quarantine, the preemption handler, retried I/O) is proven under *injected*
faults. The injector is:

- **seeded**: every decision (scheduled or probabilistic) derives from
  ``(seed, scope, kind, spec index)`` through numpy's ``default_rng``, as in
  the reference, so the same seed and specs fire at the same calls and slots
  in both packages, and a failing chaos run replays bit for bit;
- **scoped**: faults fire only at named fault points (``serving.decode``,
  ``serving.dispatch``, ``preemption``, ``checkpoint.save``, ...); the rest
  of the system is untouched;
- **free when inactive**: a fault point is one module-global ``None`` check
  (`fault_point`, `active_injector`), nothing else.

Activation is lexical, via the ``inject`` context manager::

    inj = FaultInjector(seed=7, specs=[FaultSpec.poison(at_steps=(2,), slots=(1,))])
    with inject(inj):
        engine.run(requests)   # decode step 2 gives slot 1 NaN logits
    assert inj.fired  # the fault log records (scope, call index, kind, slots)
"""

from __future__ import annotations

import os
import signal
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

# canonical fault-point names (callers may define their own scopes freely)
SCOPE_CHECKPOINT_SAVE = "checkpoint.save"
SCOPE_CHECKPOINT_RESTORE = "checkpoint.restore"
SCOPE_SERVING_DECODE = "serving.decode"
SCOPE_SERVING_DISPATCH = "serving.dispatch"
SCOPE_PREEMPTION = "preemption"
SCOPE_REPLICA_SPAWN = "cluster.replica_spawn"

# fault kinds
KIND_IO_ERROR = "io_error"
KIND_POISON_NAN = "poison_nan"
KIND_PREEMPT = "preempt"
KIND_HANG = "step_hang"
KIND_DEVICE_ERROR = "device_error"

# sentinel: a poison spec with no explicit slots poisons every active slot
ALL_SLOTS: tuple[int, ...] = ()


class TransientIOError(OSError):
    """The injected stand-in for a transient storage failure (flaky NFS/GCS,
    preempted writer, ...). An ``OSError`` subclass on purpose: the default
    `retry.RetryPolicy` retryable filter catches exactly what real transient
    I/O raises, so injected and organic faults exercise the same path."""


class DeviceLostError(RuntimeError):
    """The injected stand-in for a device or runtime failure surfacing from a
    dispatch (a CUDA ``RuntimeError`` from a lost or reset card). A
    ``RuntimeError`` subclass on purpose: a recoverable-exception filter
    catches exactly what real device loss raises, so injected and organic
    failures exercise the same path."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled or probabilistic fault at one scope.

    ``at_calls`` fires at exact 0-based call indices of the scope's fault
    point (fully deterministic); ``probability`` fires by a seeded per-spec
    Bernoulli stream (deterministic given the injector seed). ``max_faults``
    caps total firings; ``slots`` narrows a poison fault to specific serving
    slots (empty = all active slots); ``hang_s`` is how long a ``step_hang``
    fault blocks the dispatching host thread.
    """

    scope: str
    kind: str
    at_calls: tuple[int, ...] = ()
    probability: float = 0.0
    max_faults: int | None = None
    slots: tuple[int, ...] = ALL_SLOTS
    hang_s: float = 0.0

    @classmethod
    def io_error(cls, scope: str, at_calls: Sequence[int] = (),
                 probability: float = 0.0, max_faults: int | None = None) -> "FaultSpec":
        return cls(scope, KIND_IO_ERROR, tuple(at_calls), probability, max_faults)

    @classmethod
    def poison(cls, at_steps: Sequence[int] = (), probability: float = 0.0,
               slots: Sequence[int] = ALL_SLOTS, max_faults: int | None = None,
               scope: str = SCOPE_SERVING_DECODE) -> "FaultSpec":
        return cls(scope, KIND_POISON_NAN, tuple(at_steps), probability,
                   max_faults, tuple(slots))

    @classmethod
    def preempt(cls, at_calls: Sequence[int] = (), probability: float = 0.0,
                scope: str = SCOPE_PREEMPTION) -> "FaultSpec":
        return cls(scope, KIND_PREEMPT, tuple(at_calls), probability, max_faults=1)

    @classmethod
    def step_hang(cls, at_calls: Sequence[int] = (), hang_s: float = 0.05,
                  probability: float = 0.0, max_faults: int | None = None,
                  scope: str = SCOPE_SERVING_DISPATCH) -> "FaultSpec":
        """A wedged dispatch: the engine's dispatch path blocks for
        ``hang_s`` seconds (``at_calls`` indexes dispatches: decode steps and
        admissions alike)."""
        return cls(scope, KIND_HANG, tuple(at_calls), probability, max_faults,
                   hang_s=float(hang_s))

    @classmethod
    def device_error(cls, at_calls: Sequence[int] = (), probability: float = 0.0,
                     max_faults: int | None = None,
                     scope: str = SCOPE_SERVING_DISPATCH) -> "FaultSpec":
        """A lost device: the dispatch raises `DeviceLostError`, the way a
        dead card surfaces."""
        return cls(scope, KIND_DEVICE_ERROR, tuple(at_calls), probability,
                   max_faults)


@dataclass
class FaultEvent:
    """One firing, recorded in `FaultInjector.fired` for assertions/replay."""

    scope: str
    call_index: int
    kind: str
    slots: tuple[int, ...] = ALL_SLOTS


class FaultInjector:
    """Seeded, scoped fault source. Thread-compatible for the single-writer
    pattern the engine and checkpointing use (one host thread hits each
    scope); not a general concurrent primitive."""

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._calls: dict[str, int] = {}
        self._spec_fired: dict[int, int] = {}
        self._spec_rng: dict[int, np.random.Generator] = {}
        self.fired: list[FaultEvent] = []

    # ------------------------------------------------------------- internals
    def _rng_for(self, spec_idx: int, spec: FaultSpec) -> np.random.Generator:
        rng = self._spec_rng.get(spec_idx)
        if rng is None:
            # a per-spec substream keyed on (seed, scope, kind, position):
            # adding a spec never perturbs another spec's draw sequence
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(spec.scope.encode()),
                 zlib.crc32(spec.kind.encode()), spec_idx]
            )
            self._spec_rng[spec_idx] = rng
        return rng

    def _matching(self, scope: str, kinds: tuple[str, ...], call_idx: int
                  ) -> Iterator[tuple[int, FaultSpec]]:
        """Specs of ``kinds`` at ``scope`` that fire at this call index.
        Probability draws happen for every matching call so the stream is a
        pure function of the call sequence, not of prior firings."""
        for i, spec in enumerate(self.specs):
            if spec.scope != scope or spec.kind not in kinds:
                continue
            fires = call_idx in spec.at_calls
            if spec.probability > 0.0:
                draw = float(self._rng_for(i, spec).random())
                fires = fires or draw < spec.probability
            if not fires:
                continue
            if spec.max_faults is not None and self._spec_fired.get(i, 0) >= spec.max_faults:
                continue
            self._spec_fired[i] = self._spec_fired.get(i, 0) + 1
            yield i, spec

    def _tick(self, scope: str) -> int:
        idx = self._calls.get(scope, 0)
        self._calls[scope] = idx + 1
        return idx

    # ------------------------------------------------------------ fault points
    def maybe_raise(self, scope: str) -> None:
        """I/O fault point: raise `TransientIOError` when a spec fires."""
        idx = self._tick(scope)
        for _, spec in self._matching(scope, (KIND_IO_ERROR,), idx):
            self.fired.append(FaultEvent(scope, idx, KIND_IO_ERROR))
            raise TransientIOError(f"injected transient I/O fault at {scope}#{idx}")

    def poison_slots(self, scope: str = SCOPE_SERVING_DECODE) -> tuple[int, ...] | None:
        """Decode-step fault point: the slots to poison with NaN logits this
        step, or ``None`` when no spec fires. An empty tuple (the `ALL_SLOTS`
        sentinel) means every active slot. Each call advances the scope's
        step counter, so ``at_steps`` indexes the engine's decode steps."""
        idx = self._tick(scope)
        hit: tuple[int, ...] | None = None
        for _, spec in self._matching(scope, (KIND_POISON_NAN,), idx):
            self.fired.append(FaultEvent(scope, idx, KIND_POISON_NAN, spec.slots))
            hit = spec.slots if hit is None else tuple(sorted({*hit, *spec.slots}))
            if spec.slots == ALL_SLOTS:
                hit = ALL_SLOTS
        return hit

    def maybe_preempt(self, scope: str = SCOPE_PREEMPTION) -> bool:
        """Preemption fault point: deliver a real ``SIGTERM`` to this process
        when a spec fires (exercising the installed `preemption` handler the
        way a maintenance event or a spot reclamation would). Returns whether
        it fired."""
        idx = self._tick(scope)
        for _, spec in self._matching(scope, (KIND_PREEMPT,), idx):
            self.fired.append(FaultEvent(scope, idx, KIND_PREEMPT))
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        return False

    def dispatch_faults(self, scope: str = SCOPE_SERVING_DISPATCH,
                        sleep=time.sleep) -> float:
        """Dispatch-path fault point (the serving engine evaluates it once
        before each dispatch, so ``at_calls`` indexes dispatches: decode
        steps and admissions alike). One shared call-index stream covers BOTH
        kinds: a ``step_hang`` spec blocks the host thread for its ``hang_s``
        (returned, for assertions) and a ``device_error`` spec raises
        `DeviceLostError` — the two failure modes a wedged accelerator
        presents. ``sleep`` is injectable so unit tests can observe
        the hang without paying the wall time."""
        idx = self._tick(scope)
        slept = 0.0
        for _, spec in self._matching(scope, (KIND_HANG, KIND_DEVICE_ERROR), idx):
            self.fired.append(FaultEvent(scope, idx, spec.kind))
            if spec.kind == KIND_HANG:
                sleep(spec.hang_s)
                slept += spec.hang_s
            else:
                raise DeviceLostError(
                    f"injected device/runtime fault at {scope}#{idx}")
        return slept

    def calls(self, scope: str) -> int:
        """How many times ``scope``'s fault point has been evaluated."""
        return self._calls.get(scope, 0)


# --------------------------------------------------------------- activation
_ACTIVE: FaultInjector | None = None


def active_injector() -> FaultInjector | None:
    """The injector currently activated by `inject`, or None (production)."""
    return _ACTIVE


@contextmanager
def inject(injector: FaultInjector):
    """Activate ``injector`` for the dynamic extent of the block (nestable;
    the previous injector is restored on exit)."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = previous


def fault_point(scope: str) -> None:
    """Production hook: raise an injected I/O fault if an active injector
    schedules one here; a no-op (one global load) otherwise."""
    if _ACTIVE is not None:
        _ACTIVE.maybe_raise(scope)
