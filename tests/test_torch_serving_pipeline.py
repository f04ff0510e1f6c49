"""The port's overlapped decode dispatch (``pipeline_depth`` > 1,
``tokens_per_sync``, ``cancel``) against the reference engine.

The reference's streams are computed once per module, through the JAX
package's ``ServingEngine(paged_kv=True, pipeline_depth=1)`` on the same
weights; its own parity matrix holds them equal across depth, admit batch
and ``tokens_per_sync``. The port's paged engine, gather and fused (the
kernel's plain version on the CPU), must give them token for token across
(depth 1, 2) x (admit 1, 4) x (``tokens_per_sync`` 1, 4), with a budget and
a planted EOS landing mid-scan, and through a cancel under a full pipeline.
Sampled streams are compared port against port: ``jax.random`` and
`torch.Generator` draw different numbers from one seed.
"""

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
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_LENGTH,
    FIFOScheduler,
    Request,
    SamplingParams,
    ServingEngine,
)

N_NEW = 12
ENGINE_KW = dict(max_concurrency=4, prompt_buckets=(16, 64))
CANCEL_KW = dict(max_concurrency=2, prompt_buckets=(8,))
# the port's paged engine (its default is the slot pool, as the reference's)
PAGED = dict(paged_kv=True, paged_attention="fused")


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


def _jax_run(jmod, params, prompts, n_new, eos=None, **kw):
    engine = JaxServingEngine(jmod, params, paged_kv=True, pipeline_depth=1, eos_token_id=eos,
                              **kw)
    reqs = [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=n_new))
            for p in prompts]
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(reqs)}


def _requests(prompts, n_new=N_NEW):
    return [Request(prompt=list(p), params=SamplingParams(max_new_tokens=n_new)) for p in prompts]


def _port_run(model, prompts, n_new=N_NEW, **kw):
    engine = ServingEngine(model, device="cpu", **{**PAGED, **ENGINE_KW, **kw})
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(_requests(prompts, n_new))}


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's streams, without and with a planted EOS that
    first appears at a decode step in the middle of a 4-iteration scan, and
    its 24-token streams of the cancel test's prompts."""
    jmod, params, _ = models
    prompts = _prompts(7, (5, 23, 40, 9))
    plain = _jax_run(jmod, params, prompts, N_NEW, **ENGINE_KW)
    # token t of a stream comes from decode step t; step t sits mid-scan
    # when t % 4 != 0
    rid, cut = next((rid, t) for rid in sorted(plain) for t in range(2, N_NEW)
                    if t % 4 != 0 and plain[rid][0][t] not in plain[rid][0][:t])
    eos = plain[rid][0][cut]
    with_eos = _jax_run(jmod, params, prompts, N_NEW, eos=eos, **ENGINE_KW)
    assert with_eos[rid] == (plain[rid][0][:cut + 1], FINISH_EOS)
    cancel_prompts = _prompts(22, (4, 6, 5))
    cancel = _jax_run(jmod, params, cancel_prompts, 24, **CANCEL_KW)
    return prompts, plain, eos, with_eos, cancel_prompts, cancel


@pytest.mark.parametrize("sync", [1, 4])
@pytest.mark.parametrize("admit", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("attention", ["fused", "gather"])
def test_parity_matrix(models, reference, attention, depth, admit, sync):
    _, _, model = models
    prompts, plain, *_ = reference
    got = _port_run(model, prompts, paged_attention=attention, pipeline_depth=depth,
                    admit_batch=admit, tokens_per_sync=sync)
    assert got == plain
    assert all(reason == FINISH_LENGTH and len(toks) == N_NEW for toks, reason in got.values())


@pytest.mark.parametrize("attention", ["fused", "gather"])
def test_budget_lands_mid_scan(models, reference, attention):
    """A 6-token budget is the admission's token and 5 decode tokens: the
    second 4-iteration dispatch finishes the rows at its iteration 1, and the
    host appends exactly the tokens before the stop."""
    _, _, model = models
    prompts, plain, *_ = reference
    got = _port_run(model, prompts, n_new=6, paged_attention=attention, pipeline_depth=2,
                    tokens_per_sync=4)
    assert got == {rid: (toks[:6], FINISH_LENGTH) for rid, (toks, _) in plain.items()}


@pytest.mark.parametrize("attention", ["fused", "gather"])
def test_planted_eos_lands_mid_scan(models, reference, attention):
    _, _, model = models
    prompts, _, eos, with_eos, *_ = reference
    got = _port_run(model, prompts, paged_attention=attention, pipeline_depth=2,
                    tokens_per_sync=4, eos_token_id=eos)
    assert got == with_eos
    assert any(reason == FINISH_EOS for _, reason in got.values())


@pytest.mark.parametrize("sync", [1, 4])
def test_cancel_mid_flight_with_full_pipeline(models, reference, sync):
    """cancel() while dispatches are in flight: the partial stream is a clean
    prefix of the reference's, the stale in-flight results are dropped by the
    slot's generation bump, and a request seated in the freed slot while
    they are in flight is parity-exact."""
    _, _, model = models
    *_, prompts, cancel = reference
    refs = [cancel[i][0] for i in range(3)]
    engine = ServingEngine(model, device="cpu", pipeline_depth=4, tokens_per_sync=sync,
                           **PAGED, **CANCEL_KW)
    a = engine.submit(Request(prompts[0], SamplingParams(max_new_tokens=24)))
    b = engine.submit(Request(prompts[1], SamplingParams(max_new_tokens=24)))
    for _ in range(4 if sync > 1 else 6):  # past the pipeline's depth, short of the budget
        engine.step()
    assert engine._inflight  # results for the slot about to be cancelled are in flight
    cancelled = engine.cancel(a.request_id)
    assert cancelled.finish_reason == FINISH_ABORTED
    assert 0 < len(cancelled.tokens) < 24
    assert cancelled.tokens == refs[0][:len(cancelled.tokens)]
    c = engine.submit(Request(prompts[2], SamplingParams(max_new_tokens=24)))
    outs = []
    while engine.has_work:
        outs.extend(engine.step())
    by_id = {o.request_id: o for o in outs}
    assert by_id[b.request_id].tokens == refs[1]
    assert by_id[c.request_id].tokens == refs[2]
    assert a.request_id not in by_id
    assert engine.metrics.requests_cancelled.value == 1
    assert engine._allocator.free_count == engine._allocator.num_blocks


def test_cancel_queued_and_unknown_requests(models):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", **PAGED, **CANCEL_KW)
    ids = [engine.submit(Request([1, 2, 3], SamplingParams(max_new_tokens=4))).request_id
           for _ in range(3)]
    engine.step()  # seats two; the third stays queued
    queued = engine.cancel(ids[2])
    assert (queued.finish_reason, queued.tokens) == (FINISH_ABORTED, [])
    assert engine.scheduler.queue_depth == 0
    assert engine.cancel(ids[2]) is None and engine.cancel(99) is None
    outs = engine.run([])  # serves the two seated requests to their budgets
    assert [(o.request_id, len(o.tokens), o.finish_reason) for o in outs] == [
        (ids[0], 4, FINISH_LENGTH), (ids[1], 4, FINISH_LENGTH)]
    assert not engine.has_work
    assert engine.metrics.requests_cancelled.value == 1


def test_scheduler_cancel_removes_only_the_queued_request():
    s = FIFOScheduler(prompt_buckets=(8,))
    reqs = [Request([1, 2], request_id=i) for i in range(3)]
    for r in reqs:
        s.submit(r)
    assert s.cancel(1) is reqs[1]
    assert s.cancel(1) is None
    assert s.pop_run(3) == [reqs[0], reqs[2]]


def test_depth_one_admit_one_is_the_synchronous_flow(models):
    """pipeline_depth=1 with admit_batch=1: every dispatch is fetched
    before the next, so finishes surface in the step() call that produced
    them."""
    _, _, model = models
    engine = ServingEngine(model, device="cpu", pipeline_depth=1, admit_batch=1, **PAGED,
                           **CANCEL_KW)
    for p in _prompts(23, (4, 5)):
        engine.submit(Request(p, SamplingParams(max_new_tokens=3)))
    per_step = [len(engine.step()) for _ in range(3)]
    assert not engine.has_work
    # call 0 admits (token 1) and decodes (token 2); call 1's decode hits the
    # 3-token budget, observed in that same call
    assert per_step == [0, 2, 0]
    assert engine.metrics.dispatch_depth.max == 1
    assert engine.metrics.admit_batch_size.max == 1


def test_depth_two_observes_a_finish_one_call_later(models):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", pipeline_depth=2, admit_batch=1, **PAGED,
                           **CANCEL_KW)
    for p in _prompts(23, (4, 5)):
        engine.submit(Request(p, SamplingParams(max_new_tokens=3)))
    per_step = [len(engine.step()) for _ in range(3)]
    assert not engine.has_work
    # call 1's decode finishes both rows, fetched at the start of call 2
    assert per_step == [0, 0, 2]
    assert engine.metrics.dispatch_depth.max == 2
    assert engine.metrics.decode_dispatches.value == 2


@pytest.mark.parametrize("depth,sync", [(1, 1), (2, 1), (2, 4), (3, 4)])
def test_sampled_streams_equal_generate_at_every_depth_and_sync(models, depth, sync):
    """Each sampled request's noise comes from its own generator, one draw
    per token in order, whatever the depth and iterations per dispatch: its
    stream equals a batch-1 `generate` with the same seed, beside greedy
    neighbours."""
    _, _, model = models
    prompts = _prompts(3, (6, 19, 30, 11, 44))
    reqs = [Request(list(p), SamplingParams(temperature=0.8 if i % 2 == 0 else 0.0,
                                            top_k=7 if i % 4 == 0 else None, seed=10 + i,
                                            max_new_tokens=10))
            for i, p in enumerate(prompts)]
    engine = ServingEngine(model, device="cpu", pipeline_depth=depth, tokens_per_sync=sync,
                           **PAGED, **ENGINE_KW)
    outs = engine.run(reqs)
    for r, o in zip(reqs, outs):
        sp = r.params
        gen = torch.Generator().manual_seed(sp.seed) if sp.temperature > 0 else None
        solo = generate(model, torch.tensor([r.prompt]), 10, temperature=sp.temperature,
                        top_k=sp.top_k, generator=gen, device="cpu")[0].tolist()
        assert o.tokens == solo
    greedy = generate(model, torch.tensor([prompts[0]]), 10, device="cpu")[0].tolist()
    assert outs[0].tokens != greedy  # the sampler really sampled


@pytest.mark.parametrize("depth,sync", [(1, 1), (2, 4)])
def test_dispatch_metrics(models, reference, depth, sync):
    _, _, model = models
    prompts, *_ = reference
    engine = ServingEngine(model, device="cpu", pipeline_depth=depth, tokens_per_sync=sync,
                           **PAGED, **ENGINE_KW)
    outs = engine.run(_requests(prompts))
    m = engine.metrics
    tokens = sum(len(o.tokens) for o in outs)
    assert m.tokens_generated.value == tokens == len(prompts) * N_NEW
    assert m.decode_steps.value == sync * m.decode_dispatches.value
    assert m.tokens_per_dispatch.sum == tokens - len(prompts)  # first tokens come from admission
    assert m.tokens_per_dispatch.max <= sync * ENGINE_KW["max_concurrency"]
    assert m.inter_token_s.count == tokens - len(prompts) and m.inter_token_s.min >= 0
    assert m.ttft_s.count == len(prompts)
    # one fetch per admission and per decode dispatch, none dropped
    assert m.host_blocked_s.count == m.admit_batch_size.count + m.decode_dispatches.value
    assert m.admit_batch_size.sum == len(prompts)
    assert m.dispatch_depth.max <= depth
