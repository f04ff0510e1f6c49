"""The port engine's health flag and quarantine, queue deadlines and drain,
against the reference engine, on the CPU, tiny GPT-2 in fp32; and the TPU
tile keywords on every entry that the reference gives them.

Both engines run under the same `FaultInjector(seed, specs)` (each
package's own): the poisoned slots get NaN logits inside the step, the health
flag freezes them, and the host quarantines only them: the first offence
requeues the request to re-prefill from its prompt, the second retires it
with ``error``. The same request ids are quarantined, the same ones end in
``error``, the injectors fire at the same calls, and every stream and
counter is equal, in the plain decode step, the paged gather engine, the
multi-token step and the verify step. Deadlines and drain give the
reference's reasons, counters and outputs. The reference engine runs at
``pipeline_depth=1`` (its fetches are then synchronous); the port at depth 2
is held to the same streams.
"""

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
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config,
    GPT2LMHead,
    lm_loss_fn,
    lm_loss_fn_pallas,
    params_from_jax,
)
from accelerate_tpu_torch.ops.attention import attention  # noqa: E402
from accelerate_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402
from accelerate_tpu_torch.ops.nf4_matmul import nf4_matmul  # noqa: E402
from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_ABORTED,
    FINISH_ERROR,
    FINISH_LENGTH,
    REJECT_DEADLINE,
    REJECT_DRAINING,
    Request,
    SamplingParams,
    ServingEngine,
)
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BUCKETS = (8, 16)


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


def _spy(engine):
    """Record the request id of every quarantine (both engines call
    ``_quarantine(slot, now, finished)``)."""
    seen = []
    real = engine._quarantine

    def spy(slot, now, finished):
        seen.append(engine._slot_req[slot].request_id)
        return real(slot, now, finished)

    engine._quarantine = spy
    return seen


def _fired(inj):
    return [(e.scope, e.call_index, e.kind, tuple(e.slots)) for e in inj.fired]


def _counters(engine):
    m = engine.metrics
    return {name: getattr(m, name).value for name in (
        "steps_poisoned", "requests_retried", "requests_expired", "requests_cancelled",
        "requests_rejected", "requests_finished", "requests_submitted")}


def _ref_run(models, prompts, budgets, specs, max_concurrency, **kw):
    jmod, params, _ = models
    engine = JaxServingEngine(jmod, params, max_concurrency=max_concurrency,
                              prompt_buckets=BUCKETS, pipeline_depth=1, **kw)
    seen = _spy(engine)
    inj = JaxFaultInjector(seed=5, specs=[JaxFaultSpec.poison(**s) for s in specs])
    with jax_inject(inj):
        outs = engine.run([JaxRequest(list(p), JaxSamplingParams(max_new_tokens=n))
                           for p, n in zip(prompts, budgets)])
    return ({o.request_id: (o.tokens, o.finish_reason) for o in outs}, seen, _fired(inj),
            _counters(engine))


def _port_run(models, prompts, budgets, specs, max_concurrency, **kw):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", max_concurrency=max_concurrency,
                           prompt_buckets=BUCKETS, **kw)
    seen = _spy(engine)
    inj = FaultInjector(seed=5, specs=[FaultSpec.poison(**s) for s in specs])
    with inject(inj):
        outs = engine.run([Request(list(p), SamplingParams(max_new_tokens=n))
                           for p, n in zip(prompts, budgets)])
    assert not engine.has_work and engine.active_slots == 0
    assert not engine._d_poison.any()  # cleared after each poisoned dispatch
    return ({o.request_id: (o.tokens, o.finish_reason) for o in outs}, seen, _fired(inj),
            _counters(engine), engine)


# poison scenarios: (prompt lengths, budgets, poison specs, slots)
SCENARIOS = {
    # one slot poisoned once: requeued, then token for token the clean stream
    "once": ((4, 6), (12, 12), [dict(at_steps=(1,), slots=(1,))], 2),
    # the same request poisoned twice: FINISH_ERROR, partial tokens kept
    "twice": ((5,), (12,), [dict(at_steps=(1, 4), slots=(0,))], 1),
    # four requests over two slots, slot 0 poisoned at three steps and every
    # slot at one: some requests requeued, one errored, the rest clean
    "crowd": ((4, 7, 5, 6), (7, 9, 6, 8),
              [dict(at_steps=(1, 3, 6), slots=(0,)), dict(at_steps=(9,))], 2),
}


@pytest.fixture(scope="module")
def reference(models):
    return {(name, sync): _ref_run(models, *_scenario(name), tokens_per_sync=sync)
            for name in SCENARIOS for sync in (1, 4)}


def _scenario(name):
    i = sorted(SCENARIOS).index(name)
    lens, budgets, specs, b = SCENARIOS[name]
    return _prompts(10 + i, lens), budgets, specs, b


@pytest.mark.parametrize("mode,sync", [("slot", 1), ("paged", 1), ("slot", 4)])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_poisoned_slots_quarantine_as_in_the_reference(models, reference, name, mode, sync):
    prompts, budgets, specs, b = _scenario(name)
    kw = dict(paged_kv=True) if mode == "paged" else {}
    outs, seen, fired, counters, _ = _port_run(models, prompts, budgets, specs, b,
                                               pipeline_depth=1, tokens_per_sync=sync, **kw)
    ref_outs, ref_seen, ref_fired, ref_counters = reference[(name, sync)]
    assert outs == ref_outs
    assert seen == ref_seen and fired == ref_fired and counters == ref_counters
    assert counters["steps_poisoned"] >= 1
    errored = [rid for rid, (_, reason) in outs.items() if reason == FINISH_ERROR]
    if name == "once":
        assert seen == [1] and not errored
    if name == "twice":
        assert seen == [0, 0] and errored == [0] and 0 < len(outs[0][0]) < 12


@pytest.mark.parametrize("depth,sync", [(2, 1), (2, 4)])
def test_lagged_results_of_a_quarantined_slot_are_dropped(models, depth, sync):
    """At depth 2 (and 4 tokens a dispatch) a poisoned slot's lagged results
    arrive after it was requeued: its epoch drops them, and the stream is
    the clean one. The decode steps are numbered by dispatch, so the
    injector's step 1 is another point of the run than at depth 1; what
    must hold is that every stream comes out clean and one request was
    requeued."""
    prompts, budgets, specs, b = _scenario("once")
    clean, *_ = _port_run(models, prompts, budgets, [], b, pipeline_depth=1)
    outs, seen, _, counters, _ = _port_run(models, prompts, budgets, specs, b,
                                           pipeline_depth=depth, tokens_per_sync=sync)
    assert outs == clean and len(seen) == 1 and counters["requests_retried"] == 1


def test_poisoned_verify_step_quarantines_as_in_the_reference(models):
    """The verify step's health covers its whole segment: a poisoned row
    emits nothing, rewinds to its position, and is quarantined."""
    prompts, budgets, specs, b = _scenario("crowd")
    outs, seen, fired, counters, engine = _port_run(models, prompts, budgets, specs, b,
                                                    pipeline_depth=1, speculation=2)
    assert engine.metrics.spec_forwards.value > 0
    ref_outs, ref_seen, ref_fired, ref_counters = _ref_run(models, prompts, budgets, specs, b,
                                                           speculation=2)
    assert outs == ref_outs and seen == ref_seen and fired == ref_fired
    assert counters == ref_counters


def test_no_injector_uploads_no_poison(models):
    prompts, budgets, _, b = _scenario("once")
    *_, engine = _port_run(models, prompts, budgets, [], b)
    assert engine.poison_uploads == 0
    inj = FaultInjector(specs=[FaultSpec.poison(at_steps=(1,), slots=(0,))])
    engine2 = ServingEngine(models[2], device="cpu", max_concurrency=b, prompt_buckets=BUCKETS)
    with inject(inj):
        engine2.run([Request(list(p), SamplingParams(max_new_tokens=n))
                     for p, n in zip(prompts, budgets)])
    assert engine2.poison_uploads == 1  # one poisoned dispatch, one upload


# ---------------------------------------------------------- deadlines, drain
def _pair(models, max_concurrency):
    """The reference and the port engine at one configuration, each with
    its package's request types."""
    jmod, params, model = models
    return [
        (JaxServingEngine(jmod, params, max_concurrency=max_concurrency, prompt_buckets=(8,),
                          pipeline_depth=1), JaxRequest, JaxSamplingParams),
        (ServingEngine(model, device="cpu", max_concurrency=max_concurrency,
                       prompt_buckets=(8,), pipeline_depth=1), Request, SamplingParams),
    ]


def _outs(outs):
    return [(o.request_id, o.tokens, o.finish_reason) for o in outs]


def _serve(engine):
    outs = []
    while engine.has_work:
        outs.extend(engine.step())
    return outs


def test_queued_request_past_its_deadline_is_rejected(models):
    long_p, short_p = _prompts(12, [4, 4])
    got = []
    for engine, R, S in _pair(models, 1):
        engine.submit(R(long_p, S(max_new_tokens=16)))
        engine.submit(R(short_p, S(max_new_tokens=4), deadline_s=0.0))
        got.append((sorted(_outs(_serve(engine))), _counters(engine)))
    assert got[0] == got[1]
    assert {rid: reason for rid, _, reason in got[1][0]} == {
        0: FINISH_LENGTH, 1: f"rejected:{REJECT_DEADLINE}"}
    assert got[1][1]["requests_expired"] == 1


def test_drain_serves_the_backlog_and_rejects_while_draining(models):
    prompts = _prompts(14, [4, 5, 6])
    got = []
    for engine, R, S in _pair(models, 2):
        for p in prompts:
            assert engine.submit(R(p, S(max_new_tokens=4))).accepted
        outs = _outs(engine.drain())
        assert not engine.draining and not engine.has_work
        engine.begin_drain()
        rejected = [engine.submit(R(p, S(max_new_tokens=4))) for p in prompts]
        engine.end_drain()
        accepted = engine.submit(R(prompts[0], S(max_new_tokens=4)))
        got.append((outs, [(r.accepted, r.reason) for r in rejected], accepted.accepted,
                    _counters(engine)))
    assert got[0] == got[1]
    outs, rejected, accepted, counters = got[1]
    assert [rid for rid, _, _ in outs] == [0, 1, 2]  # completion order
    assert rejected == [(False, REJECT_DRAINING)] * 3 and accepted
    assert counters["requests_rejected"] == 3


def test_drain_returns_outputs_in_completion_order(models):
    long_p, short_p = _prompts(22, [4, 4])
    got = []
    for engine, R, S in _pair(models, 2):
        engine.submit(R(long_p, S(max_new_tokens=24)))
        engine.submit(R(short_p, S(max_new_tokens=3)))
        got.append(_outs(engine.drain()))
    assert got[0] == got[1] and [rid for rid, _, _ in got[1]] == [1, 0]


def test_abort_all_orders_the_queue_then_the_slots(models):
    prompts = _prompts(23, [4, 4, 4, 4, 4])
    got = []
    for engine, R, S in _pair(models, 2):
        for p in prompts:
            engine.submit(R(p, S(max_new_tokens=32)))
        engine.step()  # 0 and 1 seated, 2-4 queued
        got.append((_outs(engine.abort_all()), _counters(engine)))
        assert not engine.has_work and engine.active_slots == 0
    assert got[0] == got[1]
    outs = got[1][0]
    assert [rid for rid, _, _ in outs] == [2, 3, 4, 0, 1]
    assert all(reason == FINISH_ABORTED for _, _, reason in outs)
    assert all(not t for _, t, _ in outs[:3]) and all(t for _, t, _ in outs[3:])


def test_run_max_steps_aborts_leftovers_and_keeps_completed(models):
    prompts = _prompts(16, [4, 4])
    got = []
    for engine, R, S in _pair(models, 2):
        outs = engine.run([R(prompts[0], S(max_new_tokens=2)),
                           R(prompts[1], S(max_new_tokens=64))], max_steps=5)
        got.append(_outs(outs))
    assert got[0] == got[1]
    assert [reason for _, _, reason in got[1]] == [FINISH_LENGTH, FINISH_ABORTED]


def test_cancel_journals_nothing_it_should_not_and_counts(models):
    prompts = _prompts(13, [4, 4])
    got = []
    for engine, R, S in _pair(models, 1):
        a = engine.submit(R(prompts[0], S(max_new_tokens=32))).request_id
        b = engine.submit(R(prompts[1], S(max_new_tokens=32))).request_id
        engine.step()
        got.append((_outs([engine.cancel(b), engine.cancel(a)]), engine.cancel(999),
                    _counters(engine)))
    assert got[0] == got[1]
    assert got[1][2]["requests_cancelled"] == 2


# ---------------------------------------------------------- TPU tile keywords
def test_every_entry_accepts_and_ignores_the_tpu_tile_keywords(models):
    """A call written for the reference, with its TPU tile keywords, runs
    on each entry and gives what the call without them gives."""
    _, _, model = models
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 256, (2, 8), generator=g)

    class Bound:  # what make_train_step hands a loss: the module and its params
        params = {"wte.weight": model.wte.weight}

        def __call__(self, *a, **k):
            return model(*a, **k)

    bound = Bound()
    batch = {"input_ids": ids}
    with torch.no_grad():
        plain = lm_loss_fn_pallas(bound, batch)
        assert torch.equal(lm_loss_fn_pallas(bound, batch, block_r=256, block_v=512), plain)
        torch.testing.assert_close(plain, lm_loss_fn(model, batch), atol=1e-5, rtol=1e-5)
    h = torch.randn(6, 16, generator=g)
    w = torch.randn(40, 16, generator=g)
    labels = torch.tensor([1, 2, -100, 39, 0, 5])
    assert torch.equal(fused_cross_entropy(h, w, labels, block_r=128, block_v=256),
                       fused_cross_entropy(h, w, labels))
    qt = quantize(torch.randn(128, 64, generator=g),
                  QuantizationConfig(load_in_4bit=True, quant_type="nf4", block_size=64))
    x = torch.randn(3, 128, generator=g)
    assert torch.equal(nf4_matmul(x, qt, block_k=128, block_n=64), nf4_matmul(x, qt))
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g) for _ in range(3))
    for impl in ("xla", "flash"):
        torch.testing.assert_close(
            attention(q, k, v, causal=True, implementation=impl, block_q=8, block_kv=8),
            attention(q, k, v, causal=True, implementation="xla"), atol=1e-5, rtol=1e-5)
    # checked as the reference checks them on the flash path
    with pytest.raises(ValueError, match="block sizes"):
        attention(q, k, v, causal=True, implementation="flash", block_q=5)
