"""Crash-exact serving in the port: the engine's journal, snapshot and resume
(`ServingEngine(journal=)`, `snapshot`, `resume`), against uninterrupted runs
and against the reference engine, on the CPU, tiny GPT-2 in fp32.

The contract is the reference's: a run interrupted mid-decode (the engine
dropped with its journal behind, a snapshot taken, or the serving process
killed with SIGKILL) and resumed in a fresh engine emits, per request, the
tokens of an uninterrupted run, greedy and sampled, in the slot and paged
gather engines, at ``tokens_per_sync`` 1 and 4, and with the prefix cache at
depth 2. Resumed greedy streams equal the reference engine's uninterrupted
ones (each reference step's top-2 margin asserted), and the port's and the
reference's `resume` of one journal report the same completed, resumed,
restored and expired ids. A queued request whose deadline passes during the
downtime expires; a restored in-flight one never does.
"""

import json
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_LENGTH,
    REJECT_DEADLINE,
    PrefixCacheConfig,
    Request,
    RequestJournal,
    SamplingParams,
    ServingEngine,
)

ROOT = Path(__file__).resolve().parents[1]
# a reference step whose top-2 gap is below this could flip on fp32
# summation-order differences: reported as a near-tie, not as a port fault
MIN_MARGIN = 1e-3


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


def _mixed(prompts, n_new, first_budget=None):
    """Greedy and seeded sampled requests in turn; ``first_budget`` gives
    request 0 a short budget, so it finishes before the crash."""
    reqs = [Request(list(p), SamplingParams(max_new_tokens=n_new, temperature=0.9 if i % 2 else 0.0,
                                            top_k=5 if i % 2 else None, seed=100 + i))
            for i, p in enumerate(prompts)]
    if first_budget is not None:
        reqs[0] = Request(reqs[0].prompt, SamplingParams(max_new_tokens=first_budget, seed=100))
    return reqs


def _copy(reqs):
    return [Request(list(r.prompt), r.params) for r in reqs]


def _drive(engine, outputs):
    while engine.has_work:
        for out in engine.step():
            outputs[out.request_id] = out
    return outputs


def _streams(outputs):
    return {rid: o.tokens for rid, o in outputs.items()}


MODES = {
    "slot": dict(),
    "paged": dict(paged_kv=True),
}


def _build(model, **kw):
    return ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 32), **kw)


def _uninterrupted(model, reqs, **kw):
    return {o.request_id: o.tokens for o in _build(model, **kw).run(_copy(reqs))}


def _crash(model, reqs, steps, jpath, **kw):
    """Serve ``reqs`` for ``steps`` steps with a journal, then drop the
    engine (its journal file is all that survives). Returns the outputs the
    dead engine delivered."""
    engine = _build(model, journal=jpath, **kw)
    for r in _copy(reqs):
        assert engine.submit(r).accepted
    pre = {}
    for _ in range(steps):
        for out in engine.step():
            pre[out.request_id] = out
    del engine
    return pre


@pytest.mark.parametrize("sync", [1, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_from_journal_is_crash_exact(models, tmp_path, mode, sync):
    _, _, model = models
    kw = dict(MODES[mode], tokens_per_sync=sync)
    reqs = _mixed(_prompts(0, (5, 9, 14, 7)), 12, first_budget=3)
    want = _uninterrupted(model, reqs, **kw)
    jpath = tmp_path / "requests.journal"
    pre = _crash(model, reqs, 6 if sync == 1 else 3, jpath, **kw)
    fresh = _build(model, journal=jpath, **kw)
    report = fresh.resume()
    assert report.source == "journal"
    assert set(report.completed) == set(pre)  # finished work is never re-run
    assert set(report.resumed) | set(report.restored) == set(want) - set(pre)
    assert report.resumed, "at least one request must resume mid-stream"
    final = _drive(fresh, dict(report.completed))
    assert _streams(final) == want
    assert fresh.metrics.requests_resumed.value == len(report.resumed)
    assert fresh.metrics.requests_restored.value == len(report.restored)
    assert fresh.metrics.replayed_tokens.value > 0
    if mode == "paged":
        assert fresh._allocator.free_count == fresh._allocator.num_blocks


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_with_prefix_cache_at_depth_2(models, tmp_path, mode):
    """Resumed continuation prefills bypass the prefix cache, and lagged
    dispatches at depth 2 replay cleanly."""
    _, _, model = models
    kw = dict(MODES[mode], pipeline_depth=2, prefix_cache=PrefixCacheConfig(block_tokens=16))
    base = _prompts(7, (17, 23))
    reqs = _mixed(base + [list(base[0]), list(base[1])], 8)
    want = _uninterrupted(model, reqs, **kw)
    jpath = tmp_path / "requests.journal"
    pre = _crash(model, reqs, 5, jpath, **kw)
    fresh = _build(model, journal=jpath, **kw)
    report = fresh.resume()
    final = _drive(fresh, {**report.completed, **pre})
    assert _streams(final) == want
    assert fresh.metrics.prefix_hits.value <= len(report.restored)  # never a resumed stream


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snapshot_restore_is_crash_exact(models, tmp_path, mode):
    _, _, model = models
    kw = MODES[mode]
    reqs = _mixed(_prompts(3, (5, 9, 14)), 12, first_budget=3)
    want = _uninterrupted(model, reqs, **kw)
    engine = _build(model, pipeline_depth=2, **kw)
    for r in _copy(reqs):
        assert engine.submit(r).accepted
    pre = {}
    for _ in range(5):
        for out in engine.step():
            pre[out.request_id] = out
    snap = tmp_path / "engine.snap"
    for out in engine.snapshot(snap):  # fetches what is in flight first
        pre[out.request_id] = out
    assert not engine._inflight
    fresh = _build(model, **kw)
    report = fresh.resume(snap)
    assert report.source == "snapshot" and not report.expired and report.resumed
    final = _drive(fresh, {**report.completed, **pre})
    assert _streams(final) == want


def test_resume_refuses_an_engine_that_is_not_idle(models, tmp_path):
    _, _, model = models
    jpath = tmp_path / "requests.journal"
    with RequestJournal(jpath) as j:
        j.log_submit(Request([1, 2], SamplingParams(max_new_tokens=2), request_id=0))
    engine = _build(model, journal=jpath)
    engine.submit(Request([3, 4], SamplingParams(max_new_tokens=2)))
    with pytest.raises(RuntimeError, match="idle"):
        engine.resume()
    with pytest.raises(ValueError, match="journal"):
        _build(model).resume()


@pytest.fixture(scope="module")
def downtime_restore(models, tmp_path_factory):
    """One snapshot with both deadline cases: requests 0 and 1 admitted
    (mid-stream), request 2 queued with a 0.2 s budget that the downtime
    alone blows."""
    _, _, model = models
    snap = tmp_path_factory.mktemp("deadline") / "engine.snap"
    prompt = _prompts(11, (14,))[0]
    a = _build(model, pipeline_depth=1)
    a.submit(Request(list(prompt), SamplingParams(max_new_tokens=12), deadline_s=0.2))
    a.submit(Request(_prompts(12, (5,))[0], SamplingParams(max_new_tokens=3)))
    a.step()  # both admitted, first tokens out
    a.submit(Request([4, 5], SamplingParams(max_new_tokens=4), deadline_s=0.2))
    a.snapshot(snap)
    time.sleep(0.35)
    b = _build(model)
    report = b.resume(snap)
    return b, report, _drive(b, {}), prompt


def test_queued_deadline_elapsed_during_downtime_expires_on_restore(downtime_restore):
    b, report, final, _ = downtime_restore
    assert [o.request_id for o in report.expired] == [2]
    assert report.expired[0].finish_reason == f"rejected:{REJECT_DEADLINE}"
    assert b.metrics.requests_expired.value == 1 and report.downtime_s >= 0.35
    assert 2 not in final


def test_restored_inflight_request_never_expires(models, downtime_restore):
    _, _, model = models
    _, report, final, prompt = downtime_restore
    assert sorted(report.resumed) == [0, 1]
    assert final[0].finish_reason == FINISH_LENGTH
    want = _uninterrupted(model, [Request(list(prompt), SamplingParams(max_new_tokens=12))])
    assert final[0].tokens == want[0]


CHILD = """
import sys, time, torch
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine
import json
weights, journal, reqs, steps = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4])
model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
model.load_state_dict(torch.load(weights))
engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 32),
                       pipeline_depth=2, journal=journal)
for prompt, p in reqs:
    assert engine.submit(Request(prompt, SamplingParams(**p))).accepted
for _ in range(steps):
    engine.step()
print("READY", flush=True)
time.sleep(600)
"""


def test_sigkill_of_a_serving_child_then_resume(models, tmp_path):
    """A child process serves with a journal and is killed with SIGKILL
    mid-run (after a fixed number of steps, so the cut is the same every
    run); the test resumes from the journal in a fresh engine."""
    _, _, model = models
    reqs = _mixed(_prompts(5, (6, 11, 15, 8)), 10, first_budget=2)
    want = _uninterrupted(model, reqs, pipeline_depth=2)
    weights, jpath = tmp_path / "weights.pt", tmp_path / "requests.journal"
    torch.save(model.state_dict(), weights)
    spec = [[r.prompt, dict(max_new_tokens=r.params.max_new_tokens,
                            temperature=r.params.temperature, top_k=r.params.top_k,
                            seed=r.params.seed)] for r in reqs]
    child = subprocess.Popen([sys.executable, "-c", CHILD, str(weights), str(jpath),
                              json.dumps(spec), "5"], cwd=ROOT, stdout=subprocess.PIPE,
                             text=True)
    try:
        assert child.stdout.readline().strip() == "READY"
        child.send_signal(signal.SIGKILL)
        assert child.wait(timeout=60) == -signal.SIGKILL
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    fresh = _build(model, pipeline_depth=2, journal=jpath)
    report = fresh.resume()
    assert report.completed and report.resumed
    final = _drive(fresh, dict(report.completed))
    assert _streams(final) == want


def _jax_engine(jmod, params, **kw):
    return JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=(16, 32),
                            pipeline_depth=1, **kw)


def test_recovery_reports_equal_the_reference(models, tmp_path):
    """One journal, resumed by the port and by the reference engine (each
    from its own copy): equal completed, resumed, restored and expired ids,
    and the reference engine then serves the resumed streams to the port's
    tokens."""
    jmod, params, model = models
    reqs = _mixed(_prompts(9, (5, 9, 14, 7)), 12, first_budget=3)
    port_j, ref_j = tmp_path / "port.journal", tmp_path / "ref.journal"
    engine = _build(model, journal=port_j)
    for r in _copy(reqs):
        assert engine.submit(r).accepted
    for _ in range(6):
        engine.step()
    # queued at the crash with a spent queue budget: expires on resume
    assert engine.submit(Request([4, 5, 6], SamplingParams(max_new_tokens=4),
                                 deadline_s=0.0)).accepted
    del engine
    shutil.copy(port_j, ref_j)
    port = _build(model, journal=port_j).resume()
    jeng = _jax_engine(jmod, params, journal=ref_j)
    ref = jeng.resume()
    for field in ("resumed", "restored"):
        assert getattr(port, field) == getattr(ref, field), field
    assert sorted(port.completed) == sorted(ref.completed)
    assert {k: v.tokens for k, v in port.completed.items()} == \
        {k: v.tokens for k, v in ref.completed.items()}
    assert [o.request_id for o in port.expired] == [o.request_id for o in ref.expired] == [4]
    assert port.resumed and port.restored


def test_resumed_greedy_streams_equal_the_reference_engine(models, tmp_path):
    """Greedy requests cut mid-decode and resumed by the port equal the
    reference engine's uninterrupted streams, every reference step's top-2
    margin asserted."""
    jmod, params, model = models
    # prompts whose reference streams stay clear of near-ties (the margin
    # assert below would refuse a seed that did not)
    prompts = _prompts(23, (6, 13, 9, 17))
    n_new = 10
    ref_out = _jax_engine(jmod, params).run(
        [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=n_new))
         for p in prompts])
    ref = {o.request_id: o.tokens for o in ref_out}
    for rid, p in enumerate(prompts):
        full = np.asarray([p + ref[rid][:-1]], np.int32)
        logits = np.asarray(jmod.apply({"params": params}, jnp.asarray(full)))[0, len(p) - 1:]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MIN_MARGIN, f"near-tie in reference stream {rid}"
    reqs = [Request(list(p), SamplingParams(max_new_tokens=n_new)) for p in prompts]
    jpath = tmp_path / "requests.journal"
    pre = _crash(model, reqs, 5, jpath, pipeline_depth=2)
    fresh = _build(model, journal=jpath)
    report = fresh.resume()
    assert report.resumed
    assert _streams(_drive(fresh, {**report.completed, **pre})) == ref
