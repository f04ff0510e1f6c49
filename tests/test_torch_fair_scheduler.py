"""The port's `FairScheduler` (`serving.scheduler`) against the reference's,
host-side, and its wiring into the port's engine (``scheduler=``), on the CPU.

The service order is held exactly (tolerance: none) to the reference's on
seeded random mixes of priority classes, tenants, costs, requeues, cancels,
deadline expiries and batched `peek_run`/`pop_run` admissions with a
capacity clamp: every call returns the same requests and leaves the same
class stats. With one class and one tenant the order is the port's
`FIFOScheduler`'s. The reference's own ordering cases (classes highest
first, deficit round-robin, a heavy tenant, the starvation bound as a count,
requeues first, a peek that commits nothing, the class gauges) are mirrored.
The engine stamps its geometry on a given scheduler, serves a single class
exactly as FIFO, and journals and restores ``tenant``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.serving.request import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving.request import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving.request import SLOSpec as JaxSLOSpec  # noqa: E402
from accelerate_tpu.serving.request import SubmitOptions as JaxSubmitOptions  # noqa: E402
from accelerate_tpu.serving.scheduler import FairScheduler as JaxFairScheduler  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FairScheduler,
    FIFOScheduler,
    Request,
    RequestJournal,
    SamplingParams,
    ServingEngine,
    SLOSpec,
    SubmitOptions,
)
from torch_threads import one_torch_thread  # noqa: E402,F401


def _req(rid, *, plen=4, new=4, priority=0, tenant="", deadline=None, arrival=None, pkg="torch"):
    R, S = (Request, SamplingParams) if pkg == "torch" else (JaxRequest, JaxSamplingParams)
    return R(prompt=[1] * plen, params=S(max_new_tokens=new), request_id=rid, priority=priority,
             tenant=tenant, deadline_s=deadline, arrival_time=arrival)


def _ids(reqs):
    return [r.request_id for r in reqs]


def _mix(seed):
    """One seeded operation script: (op, args) tuples."""
    r = np.random.default_rng(seed)
    ops, rid, popped = [], 0, []
    for _ in range(260):
        x = r.random()
        if x < 0.5:
            ops.append(("submit", dict(
                rid=rid, plen=int(r.integers(1, 30)), new=int(r.integers(1, 50)),
                priority=int(r.integers(0, 4)), tenant=f"t{int(r.integers(0, 4))}",
                deadline=float(r.integers(5, 40)) if r.random() < 0.2 else None,
                arrival=float(len(ops)))))
            rid += 1
        elif x < 0.62:
            ops.append(("next_ready", {}))
        elif x < 0.8:
            ops.append(("run", dict(max_n=int(r.integers(1, 5)), cap=int(r.integers(0, 4)))))
        elif x < 0.86 and rid:
            ops.append(("requeue", dict(rid=int(r.integers(0, rid)))))
        elif x < 0.92 and rid:
            ops.append(("cancel", dict(rid=int(r.integers(0, rid)))))
        else:
            ops.append(("expire", dict(now=float(len(ops)))))
    return ops


def _play(sched, ops, pkg):
    """Run the script; the per-call results and the class stats after each."""
    made, trail = {}, []
    for op, kw in ops:
        if op == "submit":
            req = _req(kw["rid"], plen=kw["plen"], new=kw["new"], priority=kw["priority"],
                       tenant=kw["tenant"], deadline=kw["deadline"], arrival=kw["arrival"],
                       pkg=pkg)
            made[kw["rid"]] = req
            out = sched.submit(req).accepted
        elif op == "next_ready":
            got = sched.next_ready()
            out = None if got is None else got.request_id
        elif op == "run":
            sched.capacity_fn = lambda reqs, cap=kw["cap"]: min(len(reqs), cap + 1)
            n = sched.peek_run(kw["max_n"])
            assert sched.peek_run(kw["max_n"]) == n  # a peek commits nothing
            out = (n, _ids(sched.pop_run(n)))
        elif op == "requeue":
            sched.requeue(made[kw["rid"]])
            out = True
        elif op == "cancel":
            got = sched.cancel(kw["rid"])
            out = None if got is None else got.request_id
        else:
            out = _ids(sched.pop_expired(kw["now"]))
        trail.append((op, out, sched.queue_depth, sched.class_stats(),
                      _ids(sched.snapshot_queue())))
    return trail + [("drain", _ids(sched.drain_queue()))]


@pytest.mark.parametrize("seed", range(8))
def test_service_order_equals_the_reference(seed):
    """Tolerance: none. Each call of a seeded random script returns what
    the reference scheduler's does, with the same queue depth, class stats
    and service-order snapshot after it."""
    r = np.random.default_rng(1000 + seed)
    kw = dict(prompt_buckets=(32,), max_queue=int(r.integers(20, 200)),
              quantum_tokens=int(r.integers(4, 80)), starvation_bound=int(r.integers(1, 10)))
    ops = _mix(seed)
    got = _play(FairScheduler(**kw), ops, "torch")
    want = _play(JaxFairScheduler(**kw), ops, "jax")
    assert got == want
    assert any(op == "run" and out[0] > 1 for op, out, *_ in got[:-1])


def test_single_class_single_tenant_is_exact_fifo():
    fair = FairScheduler(prompt_buckets=(32,), max_queue=256)
    fifo = FIFOScheduler(prompt_buckets=(32,), max_queue=256)
    rng = np.random.default_rng(0)
    rid, popped_fair, popped_fifo = 0, [], []
    for _ in range(200):
        if rng.random() < 0.6 or fair.queue_depth == 0:
            plen, new = int(rng.integers(1, 30)), int(rng.integers(1, 50))
            assert fair.submit(_req(rid, plen=plen, new=new)).accepted
            assert fifo.submit(_req(rid, plen=plen, new=new)).accepted
            rid += 1
        elif rng.random() < 0.5:
            popped_fair.append(fair.next_ready().request_id)
            popped_fifo.append(fifo.next_ready().request_id)
        else:
            n = fair.peek_run(3)
            assert fifo.peek_run(3) == n
            popped_fair += _ids(fair.pop_run(n))
            popped_fifo += _ids(fifo.pop_run(n))
    popped_fair += _ids(fair.drain_queue())
    popped_fifo += _ids(fifo.drain_queue())
    assert popped_fair == popped_fifo == sorted(popped_fair)


def test_priority_classes_served_highest_first():
    s = FairScheduler(prompt_buckets=(32,))
    for rid, p in enumerate([0, 2, 1, 2, 0]):
        assert s.submit(_req(rid, priority=p)).accepted
    assert [s.next_ready().request_id for _ in range(5)] == [1, 3, 2, 0, 4]


def test_tenant_deficit_round_robin():
    s = FairScheduler(prompt_buckets=(32,), quantum_tokens=8)
    for rid in range(4):
        assert s.submit(_req(rid, tenant="a")).accepted
    for rid in range(4, 6):
        assert s.submit(_req(rid, tenant="b")).accepted
    assert [s.next_ready().request_id for _ in range(6)] == [0, 4, 1, 5, 2, 3]


def test_heavy_tenant_cannot_monopolize():
    s = FairScheduler(prompt_buckets=(32,), quantum_tokens=10)
    for rid in (0, 1):
        assert s.submit(_req(rid, plen=10, new=20, tenant="heavy")).accepted
    for rid in range(2, 6):
        assert s.submit(_req(rid, plen=4, new=6, tenant="cheap")).accepted
    order = [s.next_ready().request_id for _ in range(6)]
    assert order.index(0) >= 2 and order.index(1) == 5
    assert [r for r in order if r >= 2] == [2, 3, 4, 5]


@pytest.mark.parametrize("bound", [1, 3, 6])
def test_starvation_bound_is_a_hard_count(bound):
    """Under a steady stream of a higher class, a class-0 request is served
    by pop ``bound + 1`` at the latest, at the pop the reference serves it."""
    served = {}
    for name, cls, R in (("torch", FairScheduler, "torch"), ("jax", JaxFairScheduler, "jax")):
        s = cls(prompt_buckets=(32,), starvation_bound=bound)
        assert s.submit(_req(0, priority=0, pkg=R)).accepted
        for pop in range(1, 20):
            assert s.submit(_req(100 + pop, priority=5, pkg=R)).accepted
            if s.next_ready().request_id == 0:
                served[name] = pop
                break
    assert served["torch"] == served["jax"] <= bound + 1


def test_requeue_precedes_everything():
    s = FairScheduler(prompt_buckets=(32,))
    assert s.submit(_req(0, priority=9)).accepted
    s.requeue(_req(7))
    assert s.next_ready().request_id == 7
    assert s.next_ready().request_id == 0


def test_peek_never_commits_drr_state():
    s = FairScheduler(prompt_buckets=(32,), quantum_tokens=8)
    for rid, t in enumerate("abab"):
        assert s.submit(_req(rid, tenant=t)).accepted
    before = (_ids(s.snapshot_queue()), dict(s._deficit), {p: list(r) for p, r in
                                                           s._rotation.items()})
    assert s.peek_run(4) == s.peek_run(4)
    assert (_ids(s.snapshot_queue()), dict(s._deficit),
            {p: list(r) for p, r in s._rotation.items()}) == before
    assert _ids(s.pop_run(4)) == before[0]


def test_class_gauges_equal_the_reference():
    gauges = []
    for cls, pkg in ((FairScheduler, "torch"), (JaxFairScheduler, "jax")):
        s = cls(prompt_buckets=(32,))
        for rid, (p, t) in enumerate([(1, "a"), (1, "b"), (0, ""), (2, "a")]):
            assert s.submit(_req(rid, priority=p, tenant=t, pkg=pkg)).accepted
        s.requeue(_req(9, pkg=pkg))
        gauges.append(s.class_gauges())
    assert gauges[0] == gauges[1]
    assert gauges[0]["serving/class/1/queue_depth"] == 2
    assert gauges[0]["serving/class/1/tenants"] == 2
    assert gauges[0]["serving/class/-1/queue_depth"] == 1


def test_submit_options_apply_like_the_reference():
    slo = dict(ttft_s=0.5, name="interactive")
    for kw in (dict(), dict(priority=2, tenant="acme", deadline_s=3.0, cache_prefix=False),
               dict(priority=1, slo=True, admit_despite_slo=True)):
        port_kw = {**kw, "slo": SLOSpec(**slo)} if kw.get("slo") else kw
        ref_kw = {**kw, "slo": JaxSLOSpec(**slo)} if kw.get("slo") else kw
        got = SubmitOptions(**port_kw).apply(Request([1, 2], SamplingParams()))
        want = JaxSubmitOptions(**ref_kw).apply(JaxRequest([1, 2], JaxSamplingParams()))
        for field in ("priority", "tenant", "deadline_s", "cache_prefix"):
            assert getattr(got, field) == getattr(want, field), field
        assert (got.slo is None) == (want.slo is None)


@pytest.fixture(scope="module")
def model():
    return GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu", seed=0)


def _prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, n).tolist() for n in lens]


def test_engine_stamps_its_geometry_and_serves_one_class_as_fifo(model):
    """Tolerance: none. A `FairScheduler` handed to the engine takes the
    engine's buckets, queue bound and prompt cap; one class and one tenant
    serve the FIFO engine's streams, admission for admission."""
    sched = FairScheduler(prompt_buckets=(512,), max_queue=3)
    fair = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 32, 512),
                         max_queue=32, scheduler=sched)
    assert fair.scheduler is sched
    assert (sched.buckets, sched.max_queue, sched.max_prompt_len) == ((16, 32), 32, 32)
    fifo = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 32),
                         max_queue=32)
    prompts = _prompts(4, (5, 9, 12, 7, 3, 20))

    def reqs():
        return [Request(list(p), SamplingParams(max_new_tokens=6, seed=i,
                                                temperature=0.9 if i % 2 else 0.0))
                for i, p in enumerate(prompts)]

    assert ([o.tokens for o in fair.run(reqs())] == [o.tokens for o in fifo.run(reqs())])


def test_engine_journals_and_restores_tenant(model, tmp_path):
    """``tenant`` rides the SUBMIT record (the reference's field) and comes
    back with `resume`, so a restored request bills its own fair share."""
    jpath = tmp_path / "requests.journal"
    engine = ServingEngine(model, device="cpu", max_concurrency=1, prompt_buckets=(16, 32),
                           journal=jpath, scheduler=FairScheduler())
    for i, p in enumerate(_prompts(6, (5, 7, 9))):
        r = Request(list(p), SamplingParams(max_new_tokens=8))
        SubmitOptions(priority=i % 2, tenant=f"t{i}").apply(r)
        assert engine.submit(r).accepted
    engine.step()
    engine.journal.close()
    scan = RequestJournal.scan(jpath)
    assert [scan.submits[i]["tenant"] for i in range(3)] == ["t0", "t1", "t2"]
    fresh = ServingEngine(model, device="cpu", max_concurrency=1, prompt_buckets=(16, 32),
                          journal=tmp_path / "fresh.journal", scheduler=FairScheduler())
    report = fresh.resume(jpath)
    queued = {r.request_id: (r.tenant, r.priority) for r in fresh.scheduler.snapshot_queue()}
    assert report.resumed + report.restored
    assert queued == {i: (f"t{i}", i % 2) for i in queued}
    assert fresh.scheduler.class_stats()
