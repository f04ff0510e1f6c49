"""The port's front door (`serving.frontend`) against the reference's, on the
CPU, tiny GPT-2 in fp32 (parameters carried across by `params_from_jax`).

Held to the reference, tolerance none:

- `predict_ttft` on seeded random headroom and step-timing dicts, and the
  admit/reject decisions (reason, detail, shed counters) of both packages'
  `ServingFrontend` over the same scripted target, including the
  autoscaler's scale relief;
- the journal tailer: the port's `_JournalTailer`, fed a journal the
  reference engine wrote, byte prefix by byte prefix (torn frames
  included) and after the file shrinks, holds the reference tailer's
  tokens, finishes and timestamps;
- streams: greedy requests streamed through a `FairScheduler` engine, one
  class and then mixed classes and tenants, deliver the reference
  frontend's tokens and event kinds (each reference stream's top-2 margin
  asserted), with the same admission order, and equal the FIFO engine's
  completed outputs.

Port only: a stream over a supervisor restart, a stream re-attached after a
crash with `resume_stream`, streams over journals with fsync ``never`` and
``always``, and streams over a 2-replica cluster one of whose replicas is
killed mid-stream, each equal to the uninterrupted outputs with no token
delivered twice.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import FairScheduler as JaxFairScheduler  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving import ServingFrontend as JaxServingFrontend  # noqa: E402
from accelerate_tpu.serving import ServingMetrics as JaxServingMetrics  # noqa: E402
from accelerate_tpu.serving import SLOSpec as JaxSLOSpec  # noqa: E402
from accelerate_tpu.serving import SubmitOptions as JaxSubmitOptions  # noqa: E402
from accelerate_tpu.serving import SubmitResult as JaxSubmitResult  # noqa: E402
from accelerate_tpu.serving import predict_ttft as jax_predict_ttft  # noqa: E402
from accelerate_tpu.serving.frontend import _JournalTailer as JaxTailer  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    EV_STREAM_FINISH,
    EV_STREAM_FIRST,
    FINISH_LENGTH,
    REJECT_PREDICTED_TTFT,
    ClusterConfig,
    EngineSupervisor,
    FairScheduler,
    Request,
    RequestJournal,
    SamplingParams,
    ServingCluster,
    ServingEngine,
    ServingFrontend,
    ServingMetrics,
    SLOSpec,
    SubmitOptions,
    SubmitResult,
    SupervisorConfig,
    predict_ttft,
)
from accelerate_tpu_torch.serving.frontend import _JournalTailer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BUCKETS = (16, 32)
MIN_MARGIN = 1e-3  # as in the cluster tests: a smaller top-2 gap is a near-tie


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (n,)).astype(np.int32).tolist() for n in lens]


# prompts whose reference greedy streams stay clear of near-ties at 10 tokens
PROMPTS = _prompts(23, (6, 13, 9, 17))
N_NEW = 10


def _all_ready(engine):
    """The reference engine sees every dispatch ready at its reap, as the
    port's CPU engine does."""
    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap


# --- predictive admission -----------------------------------------------------------
def _headroom(r):
    h = {"slots_free": int(r.integers(0, 5)), "queue_depth": int(r.integers(0, 9))}
    if r.random() < 0.8:
        h["est_slot_free_s"] = None if r.random() < 0.15 else float(r.exponential(1.0))
    if r.random() < 0.8:
        h["decode_tokens_per_sec"] = float(r.choice([0.0, r.exponential(50.0)]))
        h["decode_tokens_remaining"] = int(r.integers(0, 400))
    return h


def test_predict_ttft_equals_the_reference():
    """Tolerance: none (the same arithmetic in the same order)."""
    r = np.random.default_rng(0)
    seen = set()
    for _ in range(400):
        head = _headroom(r)
        timings = None if r.random() < 0.2 else {"total_s": float(r.exponential(0.05))}
        conc = None if r.random() < 0.3 else int(r.integers(1, 9))
        got = predict_ttft(head, timings, max_concurrency=conc)
        assert got == jax_predict_ttft(head, timings, max_concurrency=conc)
        seen.add(got is None)
    assert seen == {True, False}
    assert predict_ttft({"slots_free": 1, "queue_depth": 0}, {"total_s": 0.1}) == 0.1
    assert predict_ttft({"slots_free": 0, "queue_depth": 1, "est_slot_free_s": 1.0,
                         "decode_tokens_per_sec": 10.0, "decode_tokens_remaining": 20},
                        {"total_s": 0.1}, max_concurrency=2) == pytest.approx(2.1)


class _StubTarget:
    """A headroom-scripted target (the reference test's): submit, metrics,
    capacity headroom and step timings, no engine."""

    def __init__(self, metrics, result_cls, headroom, timings=None):
        self.metrics = metrics
        self._result = result_cls
        self.headroom = dict(headroom)
        self.last_step_timings = dict(timings or {"total_s": 0.1})
        self.max_concurrency = 2
        self.submitted = []

    def capacity_headroom(self):
        return dict(self.headroom)

    def submit(self, request):
        request.request_id = len(self.submitted)
        self.submitted.append(request)
        return self._result(True, request.request_id)

    def step(self):
        return []

    @property
    def has_work(self):
        return False


class _StubCluster(_StubTarget):
    """A scripted cluster with an autoscaler wanting ``target`` replicas."""

    def __init__(self, metrics, result_cls, headroom, accepting, target):
        super().__init__(metrics, result_cls, headroom)
        eng = type("E", (), {"max_concurrency": 2, "last_step_timings": {"total_s": 0.2}})()
        self.replicas = [type("Rep", (), {"accepting": i < accepting, "healthy": True,
                                          "engine": eng, "metrics": metrics})()
                         for i in range(3)]
        self.autoscaler = type("A", (), {"target_replicas": target})()


def _decide(pkg, seed):
    rng = np.random.default_rng(seed)
    head = _headroom(rng)
    margin = float(rng.choice([0.1, 0.8, 1.0, 2.0]))
    kind = rng.integers(0, 3)
    if pkg == "torch":
        M, Res, Opt, Slo, FE = ServingMetrics, SubmitResult, SubmitOptions, SLOSpec, ServingFrontend
    else:
        M, Res, Opt, Slo, FE = (JaxServingMetrics, JaxSubmitResult, JaxSubmitOptions, JaxSLOSpec,
                                JaxServingFrontend)
    metrics = M()
    target = (_StubCluster(metrics, Res, head, int(rng.integers(1, 4)), int(rng.integers(0, 5)))
              if kind == 2 else _StubTarget(metrics, Res, head))
    fe = FE(target, admission_margin=margin, admission=bool(kind or rng.random() < 0.5))
    out = []
    for i in range(6):
        slo = None if rng.random() < 0.2 else Slo(ttft_s=float(rng.exponential(2.0)),
                                                  name=f"c{i % 2}")
        opts = Opt(priority=int(rng.integers(0, 3)), slo=slo,
                   admit_despite_slo=bool(rng.random() < 0.15))
        res = fe.submit([1, 2, 3], options=opts)
        out.append((res.accepted, res.reason, res.detail))
    snap = metrics.snapshot()
    out.append({k: v for k, v in snap.items()
                if k.startswith(("serving/class/", "serving/requests_", "serving/predicted"))
                and not k.endswith("_sec")})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_admission_decisions_equal_the_reference(seed):
    """Tolerance: none. The same scripted targets give the same accept and
    reject verdicts, reason codes, details and shed counters."""
    got = [_decide("torch", 100 * seed + k) for k in range(8)]
    want = [_decide("jax", 100 * seed + k) for k in range(8)]
    assert got == want
    reasons = {res[1] for run in got for res in run[:-1]}
    assert REJECT_PREDICTED_TTFT in reasons and None in reasons


def test_rejected_stream_yields_no_events_and_streams_need_a_journal(models):
    busy = {"slots_free": 0, "queue_depth": 4, "est_slot_free_s": 2.0,
            "decode_tokens_per_sec": 10.0, "decode_tokens_remaining": 40}
    fe = ServingFrontend(_StubTarget(ServingMetrics(), SubmitResult, busy))
    stream = fe.submit_stream([1, 2], options=SubmitOptions(slo=SLOSpec(ttft_s=0.001)))
    assert not stream.result.accepted and stream.result.reason == REJECT_PREDICTED_TTFT
    assert list(stream) == [] and fe.open_streams() == []
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
    with pytest.raises(ValueError, match="journal"):
        ServingFrontend(engine).submit_stream([1, 2, 3])
    assert engine.scheduler.queue_depth == 1
    engine.abort_all()


# --- the tailer -------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_journal(models, tmp_path_factory):
    """A journal the reference engine wrote: greedy and sampled requests, a
    PROGRESS cadence of 3, every request finished."""
    jmod, params, _ = models
    path = tmp_path_factory.mktemp("ref") / "requests.journal"
    from accelerate_tpu.serving import RequestJournal as JaxRequestJournal
    engine = JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=BUCKETS,
                              journal=JaxRequestJournal(path, progress_every=3))
    reqs = [JaxRequest(list(p), JaxSamplingParams(max_new_tokens=N_NEW, seed=i,
                                                  temperature=0.9 if i % 2 else 0.0))
            for i, p in enumerate(PROMPTS)]
    outs = {o.request_id: o.tokens for o in engine.run(reqs)}
    engine.journal.close()
    return path, outs


def _tailer_state(t):
    return dict(tokens=t.tokens, finishes=t.finishes, last_ts=t.last_ts)


def test_tailer_reads_the_reference_journal_like_the_reference(ref_journal, tmp_path):
    """Tolerance: none. Both tailers follow a copy of the reference journal
    that grows by byte prefixes cut anywhere (mid-frame tails included), then
    shrinks back to the magic and grows again: after every poll they hold the
    same tokens, finishes and timestamps, and at the end every finish
    carries the engine's outputs."""
    src, outs = ref_journal
    data = src.read_bytes()
    path = tmp_path / "tail.journal"
    port, ref = _JournalTailer(path), JaxTailer(path)
    cuts = sorted(set(np.random.default_rng(0).integers(8, len(data), 40).tolist()))
    for cut in cuts + [len(data), 8] + cuts[::3] + [len(data)]:
        path.write_bytes(data[:cut])
        assert port.poll() == ref.poll()
        assert _tailer_state(port) == _tailer_state(ref)
    assert {rid: toks for rid, (_, toks) in port.finishes.items()} == outs
    assert all(reason == FINISH_LENGTH for reason, _ in port.finishes.values())


# --- streams --------------------------------------------------------------------------
def _stream_run(pkg, models, tmp_path, options):
    """Stream PROMPTS through a FairScheduler engine with a journal; return
    each stream's delivered tokens and event kinds and n's, and the
    journal's admission order."""
    jmod, params, model = models
    jpath = tmp_path / f"{pkg}.journal"
    if pkg == "jax":
        engine = JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=BUCKETS,
                                  max_queue=32, scheduler=JaxFairScheduler(quantum_tokens=16,
                                                                           starvation_bound=2),
                                  journal=str(jpath))
        _all_ready(engine)
        fe, Opt, S = JaxServingFrontend(engine), JaxSubmitOptions, JaxSamplingParams
    else:
        engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                               max_queue=32, scheduler=FairScheduler(quantum_tokens=16,
                                                                     starvation_bound=2),
                               journal=str(jpath))
        fe, Opt, S = ServingFrontend(engine), SubmitOptions, SamplingParams
    streams = [fe.submit_stream(list(p), S(max_new_tokens=N_NEW),
                                Opt(**options[i]) if options else None)
               for i, p in enumerate(PROMPTS)]
    assert all(s.result.accepted for s in streams)
    events = {s.request_id: [] for s in streams}
    while engine.has_work or fe.open_streams():
        engine.step()
        for ev in fe.pump():
            events[ev.request_id].append(ev)
    engine.journal.close()
    from accelerate_tpu_torch.serving.journal import RequestJournal as PortJournal
    out = {}
    for s in streams:
        evs = events[s.request_id]
        assert [t for ev in evs for t in ev.tokens] == s.delivered
        assert [ev.n for ev in evs] == sorted(ev.n for ev in evs)
        out[s.request_id] = (s.delivered, s.finish_reason, [ev.kind for ev in evs])
    snap = engine.metrics.snapshot()
    return out, PortJournal.scan(jpath).admit_order, (snap["serving/streams_opened"],
                                                      snap["serving/streams_finished"])


def _assert_clear_of_ties(models, streams):
    jmod, params, _ = models
    for rid, p in enumerate(PROMPTS):
        full = np.asarray([p + streams[rid][0][:-1]], np.int32)
        logits = np.asarray(jmod.apply({"params": params}, jnp.asarray(full)))[0, len(p) - 1:]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MIN_MARGIN, f"near-tie in reference stream {rid}"


@pytest.mark.parametrize("classes", ["single", "mixed"])
def test_streams_equal_the_reference_frontend(models, tmp_path, classes):
    """Tolerance: none. One class, then mixed priority classes and tenants:
    each stream's tokens, finish and event kinds, the admission order, and
    the stream counters are the reference's, and each stream equals the FIFO
    engine's completed output."""
    options = None if classes == "single" else [
        dict(priority=i % 2, tenant=f"t{i % 3}") for i in range(len(PROMPTS))]
    want, want_order, want_counts = _stream_run("jax", models, tmp_path, options)
    got, order, counts = _stream_run("torch", models, tmp_path, options)
    _assert_clear_of_ties(models, want)
    assert got == want and order == want_order and counts == want_counts == (4, 4)
    fifo = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
    completed = [o.tokens for o in fifo.run(
        [Request(list(p), SamplingParams(max_new_tokens=N_NEW)) for p in PROMPTS])]
    assert [got[i][0] for i in range(len(PROMPTS))] == completed
    for _, reason, kinds in got.values():
        assert reason == FINISH_LENGTH and kinds[0] == EV_STREAM_FIRST
        assert kinds[-1] == EV_STREAM_FINISH
    if classes == "mixed":
        assert order != sorted(order)  # the classes reordered admission


def _mixed_requests(n_new=12):
    return [Request(list(p), SamplingParams(max_new_tokens=n_new, seed=i,
                                            temperature=0.9 if i % 2 else 0.0,
                                            top_k=5 if i % 2 else None))
            for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def uninterrupted(models):
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
    return [o.tokens for o in engine.run(_mixed_requests())]


def _consume(fe, streams, step):
    """Step and pump until every stream finished; events per stream."""
    events = {s.request_id: [] for s in streams}
    while fe.open_streams():
        step()
        for ev in fe.pump():
            events[ev.request_id].append(ev)
    return events


def test_stream_survives_a_supervisor_restart(models, tmp_path, uninterrupted):
    """A device error mid-stream: the supervisor rebuilds the engine and
    resumes its journal; every stream delivers the uninterrupted tokens
    exactly once."""
    model = models[2]
    sup = EngineSupervisor(lambda **kw: ServingEngine(model, device="cpu", max_concurrency=2,
                                                      prompt_buckets=BUCKETS, **kw),
                           tmp_path / "requests.journal", config=SupervisorConfig(max_restarts=2),
                           sleep=lambda s: None)
    fe = ServingFrontend(sup)
    inj = FaultInjector(seed=0, specs=[FaultSpec.device_error(at_calls=(6,))])
    with inject(inj):
        streams = [fe.submit_stream(r) for r in _mixed_requests()]
        events = _consume(fe, streams, sup.step)
    assert sup.restarts == 1
    assert [s.delivered for s in streams] == uninterrupted
    for s in streams:
        assert [t for ev in events[s.request_id] for t in ev.tokens] == s.delivered


def test_resume_stream_after_a_crash(models, tmp_path, uninterrupted):
    """Streams cut by a crash (the engine dropped mid-decode) and re-attached
    to a fresh engine's `resume` at the delivered frontier continue with
    exactly the rest of the uninterrupted tokens."""
    model = models[2]
    jpath = tmp_path / "requests.journal"
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           journal=jpath)
    fe = ServingFrontend(engine)
    streams = [fe.submit_stream(r) for r in _mixed_requests()]
    for _ in range(5):
        engine.step()
        fe.pump()
    before = {s.request_id: list(s.delivered) for s in streams}
    assert any(before.values()) and not all(s.finished for s in streams)
    engine.journal.close()
    del engine
    fresh = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                          journal=jpath)
    report = fresh.resume()
    fe2 = ServingFrontend(fresh)
    resumed = [fe2.resume_stream(rid, delivered=before[rid]) for rid in sorted(before)]
    events = _consume(fe2, resumed, fresh.step)
    for s in resumed:
        rest = [t for ev in events[s.request_id] for t in ev.tokens]
        assert before[s.request_id] + rest == uninterrupted[s.request_id]
    assert report.resumed or report.completed


@pytest.mark.parametrize("fsync", ["never", "always"])
def test_streams_over_fsync_modes(models, tmp_path, uninterrupted, fsync):
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS,
                           journal=RequestJournal(tmp_path / "j", fsync=fsync, progress_every=2))
    fe = ServingFrontend(engine)
    streams = [fe.submit_stream(r) for r in _mixed_requests()]
    _consume(fe, streams, engine.step)
    assert [s.delivered for s in streams] == uninterrupted


def test_stream_survives_a_replica_kill(models, tmp_path, uninterrupted):
    """A `FairScheduler` 2-replica cluster with two tenants and two classes;
    replica 0 is killed mid-stream. The tailer follows each stream to the
    replica it migrated to, and every stream's events concatenate to the
    uninterrupted tokens, none delivered twice."""
    model = models[2]
    cluster = ServingCluster(
        lambda **kw: ServingEngine(model, device="cpu", max_concurrency=2,
                                   prompt_buckets=BUCKETS, scheduler=FairScheduler(), **kw),
        tmp_path, replicas=2, config=ClusterConfig(policy="round_robin"),
        supervisor_config=SupervisorConfig(max_restarts=0))
    fe = ServingFrontend(cluster)
    streams = [fe.submit_stream(r, options=SubmitOptions(priority=i % 2, tenant="ab"[i // 2]))
               for i, r in enumerate(_mixed_requests())]
    for _ in range(3):
        cluster.step()
        fe.pump()
    before = {s.request_id: list(s.delivered) for s in streams}
    assert any(before[s.request_id] and not s.finished
               for s in streams if cluster.placement(s.request_id)[0] == 0)

    def boom():
        raise RuntimeError("injected device loss")

    cluster.replicas[0].engine.step = boom
    events = _consume(fe, streams, cluster.step)
    assert cluster.migrations == 1
    for s in streams:
        rest = [t for ev in events[s.request_id] for t in ev.tokens]
        assert before[s.request_id] + rest == s.delivered == uninterrupted[s.request_id]
    lag = cluster.replicas[0].metrics.stream_lag_s
    assert lag.count > 0 and lag.quantile(0.99) >= lag.quantile(0.5) >= 0.0
    cluster.close()
