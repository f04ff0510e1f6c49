"""The port's engine supervisor (`serving.supervisor`) against the
reference's, on the CPU, tiny GPT-2 in fp32 (parameters carried across by
`params_from_jax`).

Each case runs the reference's `EngineSupervisor` over the reference engine
and the port's over the port engine, on the same greedy requests, under the
same `FaultInjector` specs (each package's own) and the same brownout
headroom sequence. The supervisors' clocks are one fake clock per run that
moves only when an injected ``step_hang`` sleeps, and the backoff sleeps are
recorded, not slept: a stall is then the hang alone, whatever the host's
speed. The cases: hangs past ``stall_timeout_s`` (stall restarts), one
``device_error`` (a device restart), a poison storm (a storm restart), an
exhausted budget (every request ``rejected:unhealthy``, `REJECT_UNHEALTHY`,
`EngineUnhealthyError`), and a brownout over mixed priorities. The restart
reasons and their order, the brownout levels and reject reasons step by
step, the delivered outputs token for token (equal to an uninterrupted run)
and the unhealthy end must be the reference's. As in the trace tests, the
reference engines the factory builds see every dispatch ready at their
reap, as the port's CPU engine does.

A JIT engine compiles at the first dispatch of each program; the reference
excuses a slow step that compiled. The port's compiles are CUDA graph
captures and kernel builds, none of which happen on the CPU, so the hangs
are placed at dispatches where the reference compiles nothing either; a
port-only test holds that a step during which a kernel library loads is
never a stall.
"""

import functools
import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.reliability import FaultInjector as JaxFaultInjector  # noqa: E402
from accelerate_tpu.reliability import FaultSpec as JaxFaultSpec  # noqa: E402
from accelerate_tpu.reliability import RetryPolicy as JaxRetryPolicy  # noqa: E402
from accelerate_tpu.reliability import inject as jax_inject  # noqa: E402
from accelerate_tpu.serving import EngineSupervisor as JaxEngineSupervisor  # noqa: E402
from accelerate_tpu.serving import EngineUnhealthyError as JaxEngineUnhealthyError  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import RestartBudget as JaxRestartBudget  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving import SupervisorConfig as JaxSupervisorConfig  # noqa: E402
from accelerate_tpu.serving import Tracer as JaxTracer  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.ops import _build  # noqa: E402
from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, RetryPolicy, inject  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_LENGTH,
    REJECT_OVERLOAD,
    REJECT_UNHEALTHY,
    EngineSupervisor,
    EngineUnhealthyError,
    Request,
    RestartBudget,
    SamplingParams,
    ServingEngine,
    SupervisorConfig,
    Tracer,
)
from accelerate_tpu_torch.serving.trace import EV_BROWNOUT, EV_RESTART, EV_STALL  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BUCKETS = (16, 32)


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


PKG = {
    "jax": dict(Request=JaxRequest, SamplingParams=JaxSamplingParams, FaultSpec=JaxFaultSpec,
                FaultInjector=JaxFaultInjector, inject=jax_inject, Tracer=JaxTracer,
                Supervisor=JaxEngineSupervisor, Config=JaxSupervisorConfig,
                Unhealthy=JaxEngineUnhealthyError),
    "torch": dict(Request=Request, SamplingParams=SamplingParams, FaultSpec=FaultSpec,
                  FaultInjector=FaultInjector, inject=inject, Tracer=Tracer,
                  Supervisor=EngineSupervisor, Config=SupervisorConfig,
                  Unhealthy=EngineUnhealthyError),
}


def _prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, n).tolist() for n in lens]


def _requests(pkg, prompts, n_new, priorities=None):
    p = PKG[pkg]
    return [p["Request"](list(x), p["SamplingParams"](max_new_tokens=n_new, seed=100 + i),
                         priority=0 if priorities is None else priorities[i])
            for i, x in enumerate(prompts)]


def _all_ready(engine):
    """The reference engine sees every dispatch ready at its reap, as the
    port's CPU engine does (its fetches land at dispatch); the reference's
    own readiness follows XLA's CPU threads."""
    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap


class FakeTime:
    """The supervisor's clock: moves only when an injected hang sleeps.
    Backoff sleeps are recorded and do not move it."""

    def __init__(self):
        self.t = 0.0
        self.backoffs = []

    def clock(self):
        return self.t

    def hang(self, seconds):
        self.t += seconds


def _factory(pkg, models, concurrency=2):
    jmod, params, model = models
    if pkg == "jax":
        def build(**kw):
            engine = JaxServingEngine(jmod, params, max_concurrency=concurrency,
                                      prompt_buckets=BUCKETS, max_queue=32, **kw)
            _all_ready(engine)
            return engine
        return build
    return lambda **kw: ServingEngine(model, device="cpu", max_concurrency=concurrency,
                                      prompt_buckets=BUCKETS, max_queue=32, **kw)


def _supervise(pkg, models, tmp_path, specs, config, requests, *, headroom=None,
               concurrency=2):
    """One supervised run: submit everything, step to the end (or to the
    unhealthy end); the outputs, restart reasons in order, the per-step
    brownout levels, the supervisor and its tracer."""
    p = PKG[pkg]
    fake = FakeTime()
    inj = p["FaultInjector"](seed=0, specs=[getattr(p["FaultSpec"], kind)(**kw)
                                            for kind, kw in specs])
    inj.dispatch_faults = functools.partial(inj.dispatch_faults, sleep=fake.hang)
    tracer = p["Tracer"](clock=fake.clock)
    sup = p["Supervisor"](_factory(pkg, models, concurrency), tmp_path / f"{pkg}.journal",
                          config=p["Config"](**config), tracer=tracer, clock=fake.clock,
                          sleep=fake.backoffs.append, headroom_fn=headroom)
    outs, levels = {}, []
    with p["inject"](inj):
        rids = [sup.submit(r).request_id for r in requests]
        while sup.has_work:
            for o in sup.step():
                assert o.request_id not in outs, "delivered twice"
                outs[o.request_id] = (o.tokens, o.finish_reason)
            levels.append(sup.brownout_level)
    reasons = [ev.data["reason"] for ev in tracer.events() if ev.kind == EV_RESTART]
    fired = [(e.scope, e.call_index, e.kind) for e in inj.fired]
    return dict(rids=rids, outs=outs, reasons=reasons, levels=levels, sup=sup, tracer=tracer,
                fired=fired, backoffs=fake.backoffs)


def _pair(models, tmp_path, specs, config, prompts, n_new):
    ref = _supervise("jax", models, tmp_path, specs, config, _requests("jax", prompts, n_new))
    got = _supervise("torch", models, tmp_path, specs, config, _requests("torch", prompts, n_new))
    return ref, got


@pytest.fixture(scope="module")
def clean(models, tmp_path_factory):
    """The uninterrupted port run every fault case must deliver."""
    prompts = _prompts(1, (5, 9, 7, 11, 6))
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
    outs = engine.run(_requests("torch", prompts, 8))
    return prompts, {o.request_id: (o.tokens, o.finish_reason) for o in outs}


CASES = {
    # two hangs at decode dispatches of the first engine and of its rebuild,
    # where neither engine compiles
    "stall": ([("step_hang", dict(at_calls=(6, 14), hang_s=0.4))],
              dict(stall_timeout_s=0.15, max_restarts=3), ["stall", "stall"]),
    "device_error": ([("device_error", dict(at_calls=(7,)))],
                     dict(max_restarts=3), ["device_error"]),
    # different slots at consecutive decode steps: two quarantines inside the
    # window is a storm; no request is poisoned twice
    "storm": ([("poison", dict(at_steps=(3,), slots=(0,))),
               ("poison", dict(at_steps=(4,), slots=(1,)))],
              dict(storm_quarantines=2, storm_window_steps=8, max_restarts=3), ["nan_storm"]),
    "mixed": ([("step_hang", dict(at_calls=(6,), hang_s=0.4)),
               ("device_error", dict(at_calls=(12,)))],
              dict(stall_timeout_s=0.15, max_restarts=3), ["stall", "device_error"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_restart_ladder_matches_the_reference(models, clean, tmp_path, case):
    specs, config, want_reasons = CASES[case]
    prompts, uninterrupted = clean
    ref, got = _pair(models, tmp_path, specs, config, prompts, 8)
    assert got["fired"] == ref["fired"] and got["fired"]
    assert got["reasons"] == ref["reasons"] == want_reasons
    assert got["outs"] == ref["outs"] == uninterrupted
    assert all(reason == FINISH_LENGTH for _, reason in got["outs"].values())
    assert got["backoffs"] == ref["backoffs"]
    sup, ref_sup = got["sup"], ref["sup"]
    assert sup.restarts == ref_sup.restarts == len(want_reasons)
    for name in ("supervisor_restarts", "supervisor_stalls", "supervisor_storms",
                 "supervisor_shed", "requests_finished", "requests_resumed",
                 "requests_restored"):
        assert getattr(sup.metrics, name).value == getattr(ref_sup.metrics, name).value, name
    stalls = [(ev.data["elapsed_s"], ev.data["timeout_s"]) for ev in got["tracer"].events()
              if ev.kind == EV_STALL]
    assert stalls == [(ev.data["elapsed_s"], ev.data["timeout_s"])
                      for ev in ref["tracer"].events() if ev.kind == EV_STALL]
    restarts = [{k: ev.data[k] for k in ("reason", "attempt", "backoff_s", "resumed", "restored")}
                for ev in got["tracer"].events() if ev.kind == EV_RESTART]
    assert restarts == [{k: ev.data[k] for k in ("reason", "attempt", "backoff_s", "resumed",
                                                 "restored")}
                        for ev in ref["tracer"].events() if ev.kind == EV_RESTART]
    report = got["tracer"].validate()
    assert report["clean"], report["anomalies"]
    hb, ref_hb = sup.heartbeat(), ref_sup.heartbeat()
    assert set(hb) == set(ref_hb)
    for key in ("unhealthy", "draining", "restarts", "restarts_remaining", "brownout_level",
                "stalled", "dispatch_seq"):
        assert hb[key] == ref_hb[key], key
    assert set(hb["step_phases"]) == set(ref_hb["step_phases"])
    sup.close()
    ref_sup.close()


def test_exhausted_budget_fails_loud_like_the_reference(models, tmp_path):
    prompts = _prompts(3, (5, 8, 6))
    specs = [("device_error", dict(at_calls=(4,)))]
    ref, got = _pair(models, tmp_path, specs, dict(max_restarts=0), prompts, 8)
    assert got["outs"] == ref["outs"]
    assert sorted(got["outs"]) == sorted(got["rids"])
    assert {r for _, r in got["outs"].values()} >= {f"rejected:{REJECT_UNHEALTHY}"}
    for res in (got, ref):
        sup, p = res["sup"], PKG["torch" if res is got else "jax"]
        assert sup.unhealthy and not sup.has_work and sup.restarts == 0
        probe = sup.submit(p["Request"]([1, 2, 3], p["SamplingParams"](max_new_tokens=2)))
        assert not probe.accepted and probe.reason == REJECT_UNHEALTHY
        with pytest.raises(p["Unhealthy"]):
            sup.step()
    assert (got["sup"].metrics.supervisor_shed.value
            == ref["sup"].metrics.supervisor_shed.value >= 1)
    snap, ref_snap = got["sup"].metrics.snapshot(), ref["sup"].metrics.snapshot()
    for key in ref_snap:
        if key.startswith("supervisor/"):
            assert snap[key] == ref_snap[key], key


def test_brownout_levels_and_sheds_match_the_reference(models, tmp_path):
    """The same headroom sequence and a burst of priorities 0..3 over two
    steps: the same level each step, the same sheds and clamps, the same
    enter/exit markers, the same outputs."""
    seq = [0.0, 5.0, 5.0, 0.7, 0.7, 5.0, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2] + [0.0] * 40
    config = dict(brownout_ttft_s=1.0, brownout_exit_fraction=0.5, brownout_exit_steps=2,
                  brownout_max_level=2, brownout_clamp_tokens=4)
    prompts = _prompts(5, (6, 9, 5, 7, 8, 10, 4, 6))
    prios = [0, 1, 2, 3, 0, 3, 2, 1]

    def run(pkg):
        p = PKG[pkg]
        it = iter(seq)
        fake = FakeTime()
        tracer = p["Tracer"](clock=fake.clock)
        sup = p["Supervisor"](_factory(pkg, models), tmp_path / f"b-{pkg}.journal",
                              config=p["Config"](**config), tracer=tracer, clock=fake.clock,
                              sleep=fake.backoffs.append,
                              headroom_fn=lambda: {"est_slot_free_s": next(it)})
        reqs = _requests(pkg, prompts, 8, prios)
        verdicts, levels, outs = [], [], {}
        for step in range(len(seq) - 1):
            if step in (2, 4, 6):  # a burst at level 1, at level 2 and after calm
                for r in reqs[:3] if step == 2 else reqs[3:6] if step == 4 else reqs[6:]:
                    res = sup.submit(r)
                    verdicts.append((step, r.priority, res.accepted, res.reason,
                                     r.params.max_new_tokens))
            if not sup.has_work and step > 8:
                break
            for o in sup.step():
                outs[o.request_id] = (o.tokens, o.finish_reason)
            levels.append(sup.brownout_level)
        phases = [(ev.data["phase"], ev.data["level"]) for ev in tracer.events()
                  if ev.kind == EV_BROWNOUT]
        assert tracer.validate()["clean"]
        return verdicts, levels, outs, phases, sup

    ref, got = run("jax"), run("torch")
    assert got[:4] == ref[:4]
    verdicts, levels = got[0], got[1]
    assert max(levels) == 2 and levels[-1] == 0
    assert any(reason == REJECT_OVERLOAD for *_, reason, _ in verdicts)
    assert any(accepted and n == 4 for _, _, accepted, _, n in verdicts)  # clamped
    assert got[3][0] == ("enter", 1) and got[3][-1] == ("exit", 0)
    for name in ("supervisor_brownouts", "supervisor_shed", "requests_rejected"):
        assert getattr(got[4].metrics, name).value == getattr(ref[4].metrics, name).value


def test_restart_budget_meters_the_reference_backoff():
    """The first restart is free, later ones walk the policy's seeded
    jittered backoff, the budget then stays exhausted: the reference's
    sequence, delay for delay."""
    for n, kw in ((3, dict(max_attempts=4, base_delay_s=0.05, max_delay_s=2.0, seed=0)),
                  (5, dict(max_attempts=3, base_delay_s=0.1, max_delay_s=1.0, seed=7)),
                  (0, dict(max_attempts=2, seed=1))):
        port, ref = RestartBudget(n, RetryPolicy(**kw)), JaxRestartBudget(n, JaxRetryPolicy(**kw))
        got = [port.acquire() for _ in range(n + 2)]
        assert got == [ref.acquire() for _ in range(n + 2)]
        assert got[n:] == [None, None] and port.exhausted
        assert n == 0 or got[0] == 0.0


def test_supervisor_requires_a_journal(models, tmp_path):
    with pytest.raises(ValueError, match="journal"):
        EngineSupervisor(lambda **kw: ServingEngine(models[2], device="cpu", max_concurrency=2,
                                                    metrics=kw.get("metrics")),
                         tmp_path / "requests.journal")


def test_restart_releases_the_old_engine(models, clean, tmp_path):
    """The rebuild drops the old engine before building the new one: its
    device state is released and the object itself is collected."""
    prompts, uninterrupted = clean
    got = _supervise("torch", models, tmp_path, [("device_error", dict(at_calls=(7,)))],
                     dict(max_restarts=3), _requests("torch", prompts, 8))
    assert got["outs"] == uninterrupted
    fake = FakeTime()
    sup = EngineSupervisor(_factory("torch", models), tmp_path / "w.journal", clock=fake.clock)
    old = weakref.ref(sup.engine)
    inj = FaultInjector(seed=0, specs=[FaultSpec.device_error(at_calls=(2,))])
    with inject(inj):
        for r in _requests("torch", prompts[:2], 4):
            sup.submit(r)
        while sup.has_work:
            sup.step()
    assert sup.restarts == 1
    gc.collect()
    assert old() is None
    sup.close()


def test_a_step_that_builds_a_kernel_is_not_a_stall(models, tmp_path, monkeypatch):
    """A dispatch during which a kernel library is built or loaded (nvcc at
    first use, on the card) counts as a compile, and the slow step it makes
    is excused, as the reference excuses a first-dispatch JIT compile."""
    fake = FakeTime()
    sup = EngineSupervisor(_factory("torch", models), tmp_path / "k.journal",
                           config=SupervisorConfig(stall_timeout_s=0.1), clock=fake.clock)
    engine = sup.engine
    real = engine._dispatch_step
    builds = []

    def building(poison):
        if not builds:  # the first decode dispatch builds a library for 30 s
            builds.append(1)
            monkeypatch.setattr(_build, "LOAD_LOG", _build.LOAD_LOG + [("fake", 30.0, True)])
            fake.hang(30.0)
        return real(poison)

    engine._dispatch_step = building
    for r in _requests("torch", _prompts(2, (5, 7)), 4):
        sup.submit(r)
    while sup.has_work:
        sup.step()
    assert builds and sup.restarts == 0 and sup.metrics.supervisor_stalls.value == 0
    assert sup.metrics.compile_count.value == 1
    assert sup.metrics.compiles == {"step": pytest.approx(sup.metrics.compiles["step"])}
    sup.close()


def test_drain_and_auto_resume(models, clean, tmp_path):
    """A supervisor built over a dead process's journal resumes it at
    construction and delivers every request once; `drain` serves the rest."""
    prompts, uninterrupted = clean
    path = tmp_path / "dead.journal"
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           journal=str(path))
    for r in _requests("torch", prompts, 8):
        engine.submit(r)
    pre = {}
    for _ in range(3):
        for o in engine.step():
            pre[o.request_id] = (o.tokens, o.finish_reason)
    engine.journal.close()
    sup = EngineSupervisor(_factory("torch", models), path)
    assert sup.last_recovery is not None
    # the journal's finished requests come back once more (the dead process
    # may not have delivered them), the rest are served to the end
    outs = {o.request_id: (o.tokens, o.finish_reason) for o in sup.drain()}
    assert outs == uninterrupted
    assert all(outs[rid] == out for rid, out in pre.items())
    sup.close()


def test_a_device_error_at_an_admission_loses_no_request(models, tmp_path):
    """A device error at an admission's dispatch puts the admitting group
    back in the queue before it propagates, so the unhealthy end accounts for
    every accepted request (the reference's engine drops such a group: it
    has left the queue and holds no slot)."""
    prompts = _prompts(4, (5, 8, 6))
    got = _supervise("torch", models, tmp_path, [("device_error", dict(at_calls=(0,)))],
                     dict(max_restarts=0), _requests("torch", prompts, 4))
    assert got["fired"] == [("serving.dispatch", 0, "device_error")]
    assert sorted(got["outs"]) == sorted(got["rids"])
    assert {r for _, r in got["outs"].values()} == {f"rejected:{REJECT_UNHEALTHY}"}
    engine = got["sup"].engine
    assert engine.scheduler.queue_depth == 0 and engine.active_slots == 0
