"""The port's speculative decoding (`serving.speculation`, the engine's
``speculation=``) against the reference's, on the CPU.

The drafter rules are the reference's own tests, ported. Then the engines,
on the same tiny GPT-2 weights (`params_from_jax`): the reference's engine
with ``speculation=4`` gives the greedy streams the port's engine must give
with speculation on, in slot and paged-gather modes, across (depth 1, 2) x
(admit 1, 4), and so must the port with speculation off. An EOS inside an
accepted run, a budget shorter than k, the write cursor after every
rollback, and the accounting identities (``spec_tokens`` is what the verify
forwards emitted; no more drafts accepted than proposed) follow. Sampled
requests are held port against port: a sampled slot takes one token a
verify, its own draw, so its stream is the one speculation off gives.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_EOS,
    FINISH_LENGTH,
    ModelDrafter,
    NGramDrafter,
    PagedKVConfig,
    Request,
    SamplingParams,
    ServingEngine,
    SpeculationConfig,
)
from accelerate_tpu_torch.serving.speculation import resolve_drafter  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

K = 4
N_NEW = 12
ENGINE_KW = dict(max_concurrency=3, prompt_buckets=(16, 64))


# ------------------------------------------------------------------ drafters
def test_ngram_drafter_lookup_rules():
    d = NGramDrafter(draft_tokens=3, max_ngram=2, min_ngram=1)
    assert d.propose([1, 9, 2, 3, 9, 5, 6, 7], [9]) == [5, 6, 7]
    assert d.propose([1, 3, 9, 5, 9, 8], [3, 9]) == [5, 9, 8]  # the longer tail wins
    assert len(d.propose(list(range(4)) * 3, [])) <= 3
    assert d.propose([1, 2, 3, 4], [5]) == []
    assert d.propose([7, 8], [1, 2, 7, 8, 5, 7, 8]) == [5, 7, 8]
    with pytest.raises(ValueError):
        NGramDrafter(draft_tokens=0)
    with pytest.raises(ValueError):
        NGramDrafter(min_ngram=3, max_ngram=2)


def test_resolve_drafter_accepts_int_config_and_drafter():
    d, k = resolve_drafter(3)
    assert isinstance(d, NGramDrafter) and k == 3
    d, k = resolve_drafter(SpeculationConfig(draft_tokens=2, max_ngram=4))
    assert isinstance(d, NGramDrafter) and k == 2 and d.max_ngram == 4

    class Custom:
        draft_tokens = 5

        def propose(self, prompt, emitted):
            return []

    d, k = resolve_drafter(Custom())
    assert isinstance(d, Custom) and k == 5
    custom = Custom()
    assert resolve_drafter(SpeculationConfig(drafter=custom))[0] is custom
    for bad in (True, "4", 0, SpeculationConfig(draft_tokens=0)):
        with pytest.raises(ValueError):
            resolve_drafter(bad)


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def test_model_drafter_window_and_greedy_proposal(models):
    model = models[2]
    d = ModelDrafter(model, draft_tokens=3, context_tokens=8)
    prompt = np.random.default_rng(3).integers(0, 256, (11,)).tolist()
    assert len(d._window(prompt)) == 8 and len(d._window(prompt[:5])) == 4
    want = generate(model, torch.tensor([prompt[-8:]]), 3, device="cpu")[0].tolist()
    assert d.propose(prompt, []) == want
    assert d.propose([], []) == []
    with pytest.raises(ValueError, match="n_positions"):
        ModelDrafter(model, draft_tokens=model.config.n_positions)


def test_engine_refuses_speculation_with_a_token_scan(models):
    with pytest.raises(ValueError, match="tokens_per_sync"):
        ServingEngine(models[2], device="cpu", speculation=2, tokens_per_sync=4)


# ------------------------------------------------------------------- engines
def _prompts():
    """Ragged prompts that restate a pattern, so the n-gram drafter has
    proposals to make from the first verify on."""
    r = np.random.default_rng(30)
    out = []
    for i, n in enumerate((5, 9, 14, 20, 7, 30)):
        pat = r.integers(0, 256, (3 + i % 3,)).tolist()
        out.append((pat * 12)[:n])
    return out


def _jax_streams(models, prompts, paged, spec, n_new=N_NEW, eos=None):
    jmod, params, _ = models
    engine = JaxServingEngine(jmod, params, pipeline_depth=1, eos_token_id=eos,
                              paged_kv=JaxPagedKVConfig(block_tokens=16) if paged else False,
                              speculation=spec, **ENGINE_KW)
    outs = engine.run([JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=n_new))
                       for p in prompts])
    return [(o.tokens, o.finish_reason) for o in sorted(outs, key=lambda o: o.request_id)]


def _port_engine(models, paged, spec, **kw):
    return ServingEngine(models[2], device="cpu", speculation=spec,
                         paged_kv=PagedKVConfig(block_tokens=16) if paged else False,
                         **{**ENGINE_KW, **kw})


def _requests(prompts, n_new=N_NEW, sampled=False):
    return [Request(prompt=list(p), params=SamplingParams(
                max_new_tokens=n_new, temperature=0.7 if sampled and i % 2 else 0.0,
                top_k=8 if sampled and i % 4 == 1 else None, seed=i))
            for i, p in enumerate(prompts)]


def _port_streams(engine, requests):
    outs = engine.run(requests)
    return [(o.tokens, o.finish_reason) for o in sorted(outs, key=lambda o: o.request_id)]


@pytest.fixture(scope="module")
def reference(models):
    """The reference's spec-on streams, slot and paged, which its own tests
    hold equal to spec-off."""
    prompts = _prompts()
    return {paged: _jax_streams(models, prompts, paged, K) for paged in (False, True)}


@pytest.mark.parametrize("admit", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_spec_streams_match_reference_and_spec_off(models, reference, paged, depth, admit):
    prompts = _prompts()
    engine = _port_engine(models, paged, K, pipeline_depth=depth, admit_batch=admit)
    got = _port_streams(engine, _requests(prompts))
    assert got == reference[paged]
    off = _port_streams(_port_engine(models, paged, None, pipeline_depth=depth,
                                     admit_batch=admit), _requests(prompts))
    assert got == off
    assert all(reason == FINISH_LENGTH and len(t) == N_NEW for t, reason in got)
    m = engine.metrics
    # the accounting identities: every token past each first (admission)
    # token came from a verify forward
    assert m.spec_tokens.value == m.tokens_generated.value - len(prompts)
    assert m.spec_forwards.value == m.decode_dispatches.value > 0
    assert 0 < m.spec_accepted.value <= m.spec_proposed.value
    assert m.spec_accept_len.sum == m.spec_accepted.value
    assert m.spec_tokens.value / m.spec_forwards.value > 1.0  # the drafts paid here
    snap = m.snapshot()
    assert snap["serving/accepted_tokens_per_forward"] == m.spec_tokens.value / m.spec_forwards.value


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_eos_inside_an_accepted_run(models, reference, paged):
    """An EOS the verify step accepts mid-segment truncates the stream there,
    as single steps would."""
    prompts = _prompts()
    streams = reference[paged]
    # a token some stream emits after its 2nd position and never before it
    eos = next(toks[t] for toks, _ in streams for t in range(2, N_NEW) if toks[t] not in toks[:t])
    want = _jax_streams(models, prompts, paged, None, eos=eos)
    got = _port_streams(_port_engine(models, paged, K, eos_token_id=eos), _requests(prompts))
    assert got == want
    assert any(reason == FINISH_EOS for _, reason in got)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_budget_shorter_than_the_draft_depth(models, reference, paged):
    got = _port_streams(_port_engine(models, paged, K), _requests(_prompts(), n_new=2))
    assert got == [(toks[:2], FINISH_LENGTH) for toks, _ in reference[paged]]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_write_cursor_is_exact_after_every_rollback(models, paged):
    """At depth 1 every result is fetched in the step that made it: after
    each step, every seated slot's write cursor and position sit at its
    prompt plus the tokens it emitted, less the last (not yet written)."""
    engine = _port_engine(models, paged, K, pipeline_depth=1)
    for request in _requests(_prompts()):
        engine.submit(request)
    checked = 0
    while engine.has_work:
        engine.step()
        for slot in np.flatnonzero(engine._active):
            out = engine._slot_out[slot]
            frontier = out.prompt_len + len(out.tokens) - 1
            assert int(engine._cache.index[slot]) == int(engine._d_pos[slot]) == frontier
            checked += 1
    assert checked > 0 and engine.metrics.spec_accepted.value > 0


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_sampled_streams_equal_speculation_off(models, paged):
    prompts = _prompts()
    on = _port_engine(models, paged, K, pipeline_depth=2, admit_batch=4)
    got = _port_streams(on, _requests(prompts, sampled=True))
    off = _port_streams(_port_engine(models, paged, None, pipeline_depth=2, admit_batch=4),
                        _requests(prompts, sampled=True))
    assert got == off
    # sampled slots draft nothing and take one token a verify
    greedy = [i for i in range(len(prompts)) if i % 2 == 0]
    assert on.metrics.spec_accept_len.count <= on.metrics.spec_forwards.value * len(greedy)
