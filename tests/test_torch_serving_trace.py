"""The port's request tracer (`serving.trace`), SLO goodput, step timings,
`memory_stats` and `capacity_headroom` against the reference engine's, on the
CPU, tiny GPT-2 in fp32 (parameters carried across by `params_from_jax`).

Both engines serve the same seeded requests, with the same SLO classes, a
queue deadline, a cancel and (in one case) the same `FaultInjector` poison,
each under a `Tracer` whose injected clock counts emissions, so every event
matches field for field, timestamps included: the per-request streams
(submit, queued, admit with bucket, seq, slot and generation, quarantine,
finish and reject with the SLO verdict) and the dispatch/fetch pairs, also
with four tokens a dispatch and with speculation (``drafted`` and
``accepted``).
Deadlines (``deadline_s=0``: expired at the next admission) and the SLO
bounds (0 or 1e9 seconds) are chosen so no verdict depends on the wall
clock, and the decode rate that `capacity_headroom` reads is pinned on both
engines. The reference engine's fetch readiness depends on XLA's CPU
threads; the port's CPU fetches are ready at once, so the reference engine
is made to see every dispatch ready, which is the same flow.

The port's exported file reloads through both packages' `load_exported` and
passes both packages' `validate`. The byte gauges of `memory_stats` are the
port's exact tensor bytes: they differ from the reference's by the paged
pool's sink block and by the write cursor, which the port keeps once and the
reference once per layer; the test computes that difference from the port's
own tensors. Every other key is equal.
"""

import itertools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.reliability import FaultInjector as JaxFaultInjector  # noqa: E402
from accelerate_tpu.reliability import FaultSpec as JaxFaultSpec  # noqa: E402
from accelerate_tpu.reliability import inject as jax_inject  # noqa: E402
from accelerate_tpu.serving import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving import SLOSpec as JaxSLOSpec  # noqa: E402
from accelerate_tpu.serving import trace as jax_trace  # noqa: E402
from accelerate_tpu.serving.request import REJECT_PROMPT_TOO_LONG  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    NULL_TRACER,
    PagedKVConfig,
    Request,
    SamplingParams,
    ServingEngine,
    SLOSpec,
    StepTimings,
    Tracer,
)
from accelerate_tpu_torch.serving import trace as port_trace  # noqa: E402
from accelerate_tpu_torch.serving.trace import (  # noqa: E402
    EV_ADMIT,
    EV_DISPATCH,
    EV_FETCH,
    EV_FINISH,
    EV_QUARANTINE,
    EV_REJECT,
    EV_SUBMIT,
    request_streams,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

BUCKETS = (16, 32)
RATE = 250.0  # the decode rate both engines report to capacity_headroom


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _prompts():
    """Eight greedy prompts (the packages draw sampled tokens from
    different generators): three share a 16-token prefix (prefix-cache hits
    in the paged case), one is too long for the largest bucket."""
    r = np.random.default_rng(7)
    shared = r.integers(0, 256, 16).tolist()
    lens = (5, 9, 12, 7)
    plain = [r.integers(0, 256, n).tolist() for n in lens]
    tails = [shared + r.integers(0, 256, n).tolist() for n in (3, 6, 5)]
    return [plain[0], tails[0], plain[1], tails[1], plain[2], tails[2], plain[3],
            r.integers(0, 256, 40).tolist()]


# (SLO name, ttft_s, itl_p99_s): bounds of 0 always miss, of 1e9 always
# attain, so the verdicts do not depend on the host's clock
SLOS = [None, ("lax", 1e9, 1e9), ("ttft_strict", 0.0, None), ("itl_strict", None, 0.0),
        ("lax", 1e9, None), None, ("ttft_strict", 0.0, 1e9), ("lax", 1e9, 1e9)]


def _requests(pkg):
    req_cls, sp_cls, slo_cls = ((JaxRequest, JaxSamplingParams, JaxSLOSpec) if pkg == "jax"
                                else (Request, SamplingParams, SLOSpec))
    reqs = []
    for i, p in enumerate(_prompts()):
        slo = SLOS[i]
        reqs.append(req_cls(
            list(p), sp_cls(max_new_tokens=6 + (i % 3) * 3, seed=10 + i),
            slo=None if slo is None else slo_cls(ttft_s=slo[1], itl_p99_s=slo[2], name=slo[0]),
            deadline_s=0.0 if i == 4 else None))
    return reqs


def _ticks():
    c = itertools.count()
    return lambda: float(next(c))


def _all_ready(engine):
    """The reference engine sees every dispatch ready at its reap, as the
    port's CPU engine does (its fetches land at dispatch)."""
    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap


def _drive(engine, reqs, poison):
    """Submit everything, cancel one queued request after the first step and
    one seated request after the third, step to the end; the per-step
    (memory_stats, capacity_headroom, last_step_timings keys) and outputs."""
    engine.metrics.tokens_per_sec = lambda: RATE
    rids = [engine.submit(r).request_id for r in reqs]
    per_step, outs = [], {}
    step = 0
    with poison:
        while engine.has_work:
            for o in engine.step():
                outs[o.request_id] = (o.tokens, o.finish_reason)
            step += 1
            if step == 1:
                got = engine.cancel(rids[6])
                outs[rids[6]] = (got.tokens, got.finish_reason)
            if step == 3:
                seated = next(r.request_id for r in engine._slot_req if r is not None)
                got = engine.cancel(seated)
                outs[seated] = (got.tokens, got.finish_reason)
            per_step.append((engine.memory_stats(), engine.capacity_headroom(),
                             sorted(engine.last_step_timings)))
    return rids, per_step, outs


def _ref_run(models, mode, depth, poison_specs, **extra):
    jmod, params, _ = models
    kw = dict(paged_kv=JaxPagedKVConfig(block_tokens=16), prefix_cache=True) if mode == "paged" else {}
    kw.update(extra)
    tracer = jax_trace.Tracer(clock=_ticks())
    engine = JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=BUCKETS,
                              pipeline_depth=depth, tracer=tracer, **kw)
    _all_ready(engine)
    inj = JaxFaultInjector(seed=3, specs=[JaxFaultSpec.poison(**s) for s in poison_specs])
    got = _drive(engine, _requests("jax"), jax_inject(inj))
    return engine, tracer, got


def _port_run(models, mode, depth, poison_specs, **extra):
    _, _, model = models
    kw = dict(paged_kv=PagedKVConfig(block_tokens=16), prefix_cache=True) if mode == "paged" else {}
    kw.update(extra)
    tracer = Tracer(clock=_ticks())
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           pipeline_depth=depth, tracer=tracer, **kw)
    inj = FaultInjector(seed=3, specs=[FaultSpec.poison(**s) for s in poison_specs])
    got = _drive(engine, _requests("torch"), inject(inj))
    return engine, tracer, got


# the engine-level fields that are host timings or compile keys, which
# differ between a JIT-compiling and an eager engine by nature
TIMING_FIELDS = ("key", "compiled", "dispatch_s", "blocked_s", "phases")


def _engine_events(events):
    return [(ev.ts, ev.kind, {k: v for k, v in ev.data.items() if k not in TIMING_FIELDS})
            for ev in events if ev.kind in (EV_DISPATCH, EV_FETCH)]


def _streams(events):
    return {rid: [(ev.ts, ev.kind, ev.data) for ev in stream]
            for rid, stream in request_streams(events).items()}


def _layout_delta(engine):
    """Port bytes less reference bytes, by dtype: a paged pool's sink block
    (each layer's K and V) and the n_layer - 1 cursors the reference keeps
    beside the port's one."""
    cache = engine._cache
    n_layer, b = len(cache.k), engine.max_concurrency
    delta = {"int32": -(n_layer - 1) * b * 4}
    if engine.paged:
        sink = sum(t[-1:].numel() * t.element_size() for t in cache.k + cache.v)
        delta[str(cache.k[0].dtype).removeprefix("torch.")] = sink
    return delta


CASES = {
    "slot_d1": ("slot", 1, []),
    "slot_d2": ("slot", 2, []),
    "paged_d1": ("paged", 1, []),
    "paged_d2": ("paged", 2, []),
    "slot_d2_poison": ("slot", 2, [dict(at_steps=(2,), slots=(1,))]),
    "slot_d2_sync4": ("slot", 2, [], dict(tokens_per_sync=4)),
    "paged_d2_spec": ("paged", 2, [], dict(speculation=2)),
}


@pytest.fixture(scope="module")
def runs(models):
    return {name: (_ref_run(models, *case[:3], **(case[3] if len(case) > 3 else {})),
                   _port_run(models, *case[:3], **(case[3] if len(case) > 3 else {})))
            for name, case in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_request_streams_equal_the_reference(runs, case):
    (ref_engine, ref_tr, (ref_rids, _, ref_outs)), (engine, tr, (rids, _, outs)) = runs[case]
    assert rids == ref_rids and outs == ref_outs
    assert tr.dropped == ref_tr.dropped == 0
    got, want = _streams(tr.events()), _streams(ref_tr.events())
    assert got == want
    kinds = {ev.kind for ev in tr.events()}
    assert {EV_SUBMIT, EV_ADMIT, EV_FINISH, EV_REJECT} <= kinds
    if CASES[case][2]:
        assert EV_QUARANTINE in kinds
    if CASES[case][0] == "paged":
        assert any(ev.data.get("cache_hit") for ev in tr.events() if ev.kind == EV_ADMIT)


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_and_fetch_events_equal_the_reference(runs, case):
    """Every dispatch and fetch: sequence number, kind, depth, step, the
    (slot, rid, gen) riders, tokens; timings and compile keys aside."""
    (_, ref_tr, _), (_, tr, _) = runs[case]
    assert _engine_events(tr.events()) == _engine_events(ref_tr.events())
    extra = CASES[case][3] if len(CASES[case]) > 3 else {}
    dispatches = [ev.data for ev in tr.events() if ev.kind == EV_DISPATCH]
    fetches = [ev.data for ev in tr.events() if ev.kind == EV_FETCH]
    if "speculation" in extra:
        assert any(d.get("drafted") == 2 for d in dispatches)
        assert any(f.get("accepted", 0) > 1 for f in fetches)
    if "tokens_per_sync" in extra:
        assert any(d["what"] == "step" and d["tokens"] == 4 for d in dispatches)


@pytest.mark.parametrize("case", list(CASES))
def test_slo_attainment_and_goodput_equal_the_reference(runs, case):
    (ref_engine, _, _), (engine, _, _) = runs[case]
    got, want = engine.metrics.goodput(), ref_engine.metrics.goodput()
    for gp in (got, want):
        gp.pop("goodput_tokens_per_sec")  # tokens over this run's wall time
    assert got == want
    assert set(got["classes"]) == {"lax", "ttft_strict", "itl_strict"}
    assert 0.0 < got["slo_attainment"] < 1.0
    snap, ref_snap = engine.metrics.snapshot(), ref_engine.metrics.snapshot()
    for key in ref_snap:
        if key.startswith("serving/slo") or key == "serving/goodput_tokens":
            assert snap[key] == ref_snap[key], key


@pytest.mark.parametrize("case", list(CASES))
def test_memory_stats_and_headroom_equal_the_reference_step_by_step(runs, case):
    (_, _, (_, ref_steps, _)), (engine, _, (_, steps, _)) = runs[case]
    assert len(steps) == len(ref_steps)
    delta = _layout_delta(engine)
    for (mem, head, phases), (ref_mem, ref_head, ref_phases) in zip(steps, ref_steps):
        assert head == ref_head
        assert phases == ref_phases == sorted(StepTimings().as_dict())
        assert not any(k.startswith("device") for k in mem)
        assert set(mem) == set(ref_mem)
        want = dict(ref_mem)
        for dtype, d in delta.items():
            want[f"slot_pool_bytes/{dtype}"] += d
            want["slot_pool_bytes"] += d
            if "block_pool/pool_bytes" in want and engine.paged:
                want["block_pool/pool_bytes"] += d
        assert mem == want


@pytest.mark.parametrize("case", ["slot_d2", "paged_d2", "slot_d2_poison"])
def test_trace_validates_and_exports_through_both_packages(runs, case, tmp_path):
    """The port's trace is clean, and its exported file reloads through the
    reference's `load_exported` and passes the reference's `validate`; the
    Chrome document is byte-identical to the reference's own rendering of
    the same events."""
    _, (_, tr, _) = runs[case]
    report = tr.validate()
    assert report["clean"], report["anomalies"]
    assert report["requests"] == len(_prompts()) and not report["truncated"]
    summary = tr.export(tmp_path / "trace.json")
    assert summary["events"] == len(tr.events()) and summary["dropped"] == 0
    doc = json.loads((tmp_path / "trace.json").read_text())
    events, dropped = jax_trace.load_exported(doc)
    assert dropped == 0 and len(events) == len(tr.events())
    ref_report = jax_trace.validate(events, dropped=dropped)
    assert ref_report["clean"], ref_report["anomalies"]
    back, _ = port_trace.load_exported(doc)
    assert [(e.ts, e.kind, e.rid, e.data) for e in back] == [
        (e.ts, e.kind, e.rid, e.data) for e in events]
    assert json.dumps(port_trace.to_chrome(back)) == json.dumps(jax_trace.to_chrome(events))


def test_step_timings_partition_the_step(models):
    """The phases of each step add up to its wall (the port's clocks), the
    metrics hold one observation of each phase a step, and the dispatch
    event carries the step's phases so far."""
    _, _, model = models
    tracer = Tracer()
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           tracer=tracer)
    for r in _requests("torch")[:4]:
        engine.submit(r)
    n = 0
    while engine.has_work:
        engine.step()
        n += 1
        t = engine.last_step_timings
        parts = sum(v for k, v in t.items() if k != "total_s")
        assert parts <= t["total_s"] + 1e-4
        assert parts >= 0.5 * t["total_s"] - 1e-4
    m = engine.metrics
    assert m.step_total_s.count == m.step_phase_dispatch_s.count == n == m.steps.value
    assert m.step_phase_dispatch_s.sum > 0 and m.step_phase_deliver_s.sum > 0
    steps = [ev for ev in tracer.events() if ev.kind == EV_DISPATCH and ev.data["what"] == "step"]
    assert steps and all(set(ev.data["phases"]) == {"schedule_s", "draft_s", "dispatch_s"}
                         for ev in steps)


def test_null_tracer_is_the_default_and_emits_nothing(models):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
    assert engine.tracer is NULL_TRACER and engine.scheduler.tracer is NULL_TRACER
    assert not engine.tracer.enabled and engine.tracer.events() == []
    engine.run(_requests("torch")[:2])
    with pytest.raises(RuntimeError, match="NullTracer"):
        engine.tracer.export("unused.json")


def test_ring_buffer_drops_oldest_and_validate_flags_truncation(models):
    _, _, model = models
    tracer = Tracer(capacity=16)
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           tracer=tracer)
    engine.run(_requests("torch")[:4])
    assert len(tracer.events()) == 16 and tracer.dropped > 0
    report = tracer.validate()
    assert report["truncated"] and report["clean"]
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_submit_rejection_is_a_terminal_stream(models):
    _, _, model = models
    tracer = Tracer()
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           tracer=tracer)
    res = engine.submit(Request(list(range(40)), SamplingParams(max_new_tokens=2)))
    assert res.reason == REJECT_PROMPT_TOO_LONG
    stream = request_streams(tracer.events())[res.request_id]
    assert [ev.kind for ev in stream] == [EV_SUBMIT, EV_REJECT]
    assert stream[1].data == {"reason": REJECT_PROMPT_TOO_LONG}
    assert tracer.validate()["clean"]


def test_annotate_wraps_dispatches_in_profiler_ranges(models):
    """``annotate=True``: each dispatch runs inside
    ``torch.profiler.record_function(key)``, so a profiler window shows the
    dispatch keys (the CPU's eager step; the card's graph replay)."""
    from torch.profiler import ProfilerActivity, profile

    _, _, model = models
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           tracer=Tracer(annotate=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run(_requests("torch")[:2])
    names = {ev.name for ev in prof.events()}
    assert "step" in names
    assert any(n.startswith("admit[pb16b") for n in names)
