"""The port's slot-pool `ServingEngine` (``paged_kv=False``, the default)
against the reference's slot-pool engine, on the CPU.

The reference's streams come from the JAX package's ``ServingEngine`` in its
default slot mode (``pipeline_depth=1``) on the same weights; its own parity
matrix holds them equal across depth, admit batch and ``tokens_per_sync``.
The port's slot engine must give them token for token across (depth 1, 2) x
(admit 1, 4) x (``tokens_per_sync`` 1, 4), with a budget and a planted EOS
landing mid-scan, through a cancel under a full pipeline, and with nf4
weights over an int8 slot cache (streams and `quant_stats`). A finished slot
that waits for the host to retire it keeps its cache row and index bit for
bit while later steps run. Sampled streams are compared port against port
(`generate` with a generator seeded alike).
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
from accelerate_tpu_torch.models.kv_cache import SlotKVCache  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_LENGTH,
    Request,
    SamplingParams,
    ServingEngine,
)

N_NEW = 12
ENGINE_KW = dict(max_concurrency=4, prompt_buckets=(16, 64))
CANCEL_KW = dict(max_concurrency=2, prompt_buckets=(8,))


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
    engine = JaxServingEngine(jmod, params, pipeline_depth=1, eos_token_id=eos, **kw)
    reqs = [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=n_new))
            for p in prompts]
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(reqs)}, engine


def _requests(prompts, n_new=N_NEW):
    return [Request(prompt=list(p), params=SamplingParams(max_new_tokens=n_new)) for p in prompts]


def _port_run(model, prompts, n_new=N_NEW, **kw):
    engine = ServingEngine(model, device="cpu", **{**ENGINE_KW, **kw})
    assert isinstance(engine._cache, SlotKVCache)
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(_requests(prompts, n_new))}


@pytest.fixture(scope="module")
def reference(models):
    """The reference slot engine's streams: 7 requests over 4 slots, the
    same with an EOS planted mid-scan, and the cancel test's 24-token
    streams."""
    jmod, params, _ = models
    prompts = _prompts(7, (5, 23, 40, 9, 16, 33, 61))
    plain, _ = _jax_run(jmod, params, prompts, N_NEW, **ENGINE_KW)
    # token t of a stream comes from decode step t; step t sits mid-scan
    # when t % 4 != 0
    rid, cut = next((rid, t) for rid in sorted(plain) for t in range(2, N_NEW)
                    if t % 4 != 0 and plain[rid][0][t] not in plain[rid][0][:t])
    eos = plain[rid][0][cut]
    with_eos, _ = _jax_run(jmod, params, prompts, N_NEW, eos=eos, **ENGINE_KW)
    assert with_eos[rid] == (plain[rid][0][:cut + 1], FINISH_EOS)
    cancel_prompts = _prompts(22, (4, 6, 5))
    cancel, _ = _jax_run(jmod, params, cancel_prompts, 24, **CANCEL_KW)
    return prompts, plain, eos, with_eos, cancel_prompts, cancel


@pytest.mark.parametrize("sync", [1, 4])
@pytest.mark.parametrize("admit", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_parity_matrix(models, reference, depth, admit, sync):
    _, _, model = models
    prompts, plain, *_ = reference
    got = _port_run(model, prompts, pipeline_depth=depth, admit_batch=admit, tokens_per_sync=sync)
    assert got == plain
    assert all(reason == FINISH_LENGTH and len(toks) == N_NEW for toks, reason in got.values())


def test_budget_lands_mid_scan(models, reference):
    _, _, model = models
    prompts, plain, *_ = reference
    got = _port_run(model, prompts, n_new=6, pipeline_depth=2, tokens_per_sync=4)
    assert got == {rid: (toks[:6], FINISH_LENGTH) for rid, (toks, _) in plain.items()}


def test_planted_eos_lands_mid_scan(models, reference):
    _, _, model = models
    prompts, _, eos, with_eos, *_ = reference
    got = _port_run(model, prompts, pipeline_depth=2, tokens_per_sync=4, eos_token_id=eos)
    assert got == with_eos
    assert any(reason == FINISH_EOS for _, reason in got.values())


@pytest.mark.parametrize("sync", [1, 4])
def test_cancel_mid_flight_with_full_pipeline(models, reference, sync):
    """cancel() while dispatches are in flight: the partial stream is a
    clean prefix of the reference's, and a request seated in the freed slot
    (its row overwritten by the admission while stale steps are in flight)
    is parity-exact."""
    _, _, model = models
    *_, prompts, cancel = reference
    refs = [cancel[i][0] for i in range(3)]
    engine = ServingEngine(model, device="cpu", pipeline_depth=4, tokens_per_sync=sync,
                           **CANCEL_KW)
    a = engine.submit(Request(prompts[0], SamplingParams(max_new_tokens=24)))
    b = engine.submit(Request(prompts[1], SamplingParams(max_new_tokens=24)))
    for _ in range(4 if sync > 1 else 6):
        engine.step()
    assert engine._inflight
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


@pytest.mark.parametrize("sync", [1, 4])
def test_finished_slot_row_is_frozen_until_retired(models, sync):
    """At depth 2 the host retires a finished slot one `step` call after
    the device finished it, and decode keeps running every slot meanwhile:
    the finished slot's cache row (every layer, K and V) and write index
    stay bit-identical from the step that finished it to the end."""
    _, _, model = models
    engine = ServingEngine(model, device="cpu", pipeline_depth=2, tokens_per_sync=sync,
                           **CANCEL_KW)
    short, long = _prompts(31, (5, 7))
    engine.submit(Request(short, SamplingParams(max_new_tokens=3)))
    engine.submit(Request(long, SamplingParams(max_new_tokens=17)))
    cache, frozen, checks = engine._cache, None, 0
    while engine.has_work:
        engine.step()
        if frozen is None and bool(engine._d_finished[0]):
            frozen = ([t[0].clone() for t in cache.k + cache.v], int(cache.index[0]))
        elif frozen is not None and engine._inflight:
            assert all(torch.equal(t[0], f) for t, f in zip(cache.k + cache.v, frozen[0]))
            assert int(cache.index[0]) == frozen[1]
            checks += 1
    assert frozen is not None and checks > 0
    assert frozen[1] == len(short) + 2  # prompt, then the two decode tokens' writes


@pytest.mark.parametrize("depth,sync", [(1, 1), (2, 4)])
def test_sampled_streams_equal_generate(models, depth, sync):
    _, _, model = models
    prompts = _prompts(3, (6, 19, 30, 11, 44))
    reqs = [Request(list(p), SamplingParams(temperature=0.8 if i % 2 == 0 else 0.0,
                                            top_k=7 if i % 4 == 0 else None, seed=10 + i,
                                            max_new_tokens=10))
            for i, p in enumerate(prompts)]
    engine = ServingEngine(model, device="cpu", pipeline_depth=depth, tokens_per_sync=sync,
                           **ENGINE_KW)
    outs = engine.run(reqs)
    for r, o in zip(reqs, outs):
        sp = r.params
        gen = torch.Generator().manual_seed(sp.seed) if sp.temperature > 0 else None
        solo = generate(model, torch.tensor([r.prompt]), 10, temperature=sp.temperature,
                        top_k=sp.top_k, generator=gen, device="cpu")[0].tolist()
        assert o.tokens == solo
    greedy = generate(model, torch.tensor([prompts[0]]), 10, device="cpu")[0].tolist()
    assert outs[0].tokens != greedy  # the sampler really sampled


def test_nf4_weights_over_an_int8_slot_cache_match_reference(models):
    """``weight_quant="nf4"`` over an int8 slot cache in both packages:
    equal greedy streams and equal `quant_stats` (packed weight bytes, int8
    payload and fp32 scale bytes of the slot rows)."""
    _, params, _ = models
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, kv_cache_dtype=jnp.int8))
    prompts = _prompts(17, (5, 23, 40, 9, 16))
    want, ref_engine = _jax_run(jmod, params, prompts, 8, weight_quant="nf4", **ENGINE_KW)
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, kv_cache_dtype=torch.int8),
                       device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    engine = ServingEngine(model, device="cpu", weight_quant="nf4", **ENGINE_KW)
    got = {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(_requests(prompts, 8))}
    assert got == want
    assert engine._cache.k[0].dtype == torch.int8
    assert engine.quant_stats() == ref_engine.quant_stats()


def test_fused_attention_requires_the_paged_pool(models):
    _, _, model = models
    with pytest.raises(ValueError, match="requires paged_kv"):
        ServingEngine(model, device="cpu", paged_attention="fused", **ENGINE_KW)
