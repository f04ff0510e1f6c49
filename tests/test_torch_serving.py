"""The port's paged `ServingEngine` against the reference's.

The same greedy requests go through the JAX package's
``ServingEngine(paged_kv=True, paged_attention="fused", pipeline_depth=1)``
(its Pallas kernel under the interpreter) and through the port's engine on the
CPU, on the same weights: more requests than slots (backfill), ragged prompts
over two buckets, and a run with an EOS planted mid-stream. Greedy streams
must be equal per request id, and equal to the port's solo `generate`.
Sampled requests are compared port against port only: ``jax.random`` and
`torch.Generator` draw different numbers from one seed.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.kv_cache import _paged_frontier_write as jax_frontier_write  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import (  # noqa: E402
    BlockAllocator,
    make_block_pool,
    paged_frontier_write,
    scatter_rows_to_blocks,
)
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_EOS,
    FINISH_LENGTH,
    REJECT_EMPTY_PROMPT,
    REJECT_PROMPT_TOO_LONG,
    PagedKVConfig,
    Request,
    SamplingParams,
    ServingEngine,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

PROMPT_LENS = (5, 23, 40, 9, 16, 33, 61)  # 7 requests over 4 slots; buckets 16 and 64
N_NEW = 12
ENGINE_KW = dict(max_concurrency=4, prompt_buckets=(16, 64))
# the port's paged engine (its default is the slot pool, as the reference's)
PAGED = dict(paged_kv=True, paged_attention="fused")


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _prompts(seed=7, lens=PROMPT_LENS):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (n,)).astype(np.int32).tolist() for n in lens]


def _jax_run(jmod, params, prompts, eos=None):
    engine = JaxServingEngine(jmod, params, paged_kv=True, paged_attention="fused",
                              pipeline_depth=1, eos_token_id=eos, **ENGINE_KW)
    reqs = [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=N_NEW, seed=i))
            for i, p in enumerate(prompts)]
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(reqs)}


def _port_engine(model, **kw):
    return ServingEngine(model, device="cpu", **{**PAGED, **ENGINE_KW, **kw})


def _port_run(model, prompts, params=None, **kw):
    engine = _port_engine(model, **kw)
    reqs = [Request(prompt=list(p), params=params or SamplingParams(max_new_tokens=N_NEW, seed=i))
            for i, p in enumerate(prompts)]
    return {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(reqs)}


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's streams, without and with a planted EOS."""
    jmod, params, _ = models
    prompts = _prompts()
    plain = _jax_run(jmod, params, prompts)
    # the EOS: a token that first appears mid-stream in some request
    rid, cut = next((rid, t) for rid in sorted(plain) for t in range(2, N_NEW - 1)
                    if plain[rid][0][t] not in plain[rid][0][:t])
    eos = plain[rid][0][cut]
    return prompts, plain, eos, _jax_run(jmod, params, prompts, eos=eos)


@pytest.mark.parametrize("attention", ["fused", "gather"])
def test_greedy_streams_match_reference_engine(models, reference, attention):
    _, _, model = models
    prompts, plain, _, _ = reference
    got = _port_run(model, prompts, paged_attention=attention)
    assert got == plain
    assert all(reason == FINISH_LENGTH and len(toks) == N_NEW for toks, reason in got.values())


def test_greedy_streams_match_solo_generate(models, reference):
    _, _, model = models
    prompts, plain, _, _ = reference
    for rid, p in enumerate(prompts):
        solo = generate(model, torch.tensor([p]), N_NEW, device="cpu")[0].tolist()
        assert solo == plain[rid][0]


def test_planted_eos_matches_reference_engine(models, reference):
    _, _, model = models
    prompts, _, eos, with_eos = reference
    got = _port_run(model, prompts, eos_token_id=eos)
    assert got == with_eos
    assert any(reason == FINISH_EOS for _, reason in got.values())


def test_block_allocator_all_or_nothing_and_double_free():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert len(got) == 3 and a.free_count == 1 and a.owned_count == 3
    assert a.alloc(2) is None and a.free_count == 1  # never a partial grant
    assert a.alloc(0) == []
    last = a.alloc(1)
    a.free(got + last)
    assert a.free_count == 4 and a.owned_count == 0
    a.alloc(1)
    with pytest.raises(ValueError, match="double free"):
        a.free([got[0], got[0]])
    with pytest.raises(ValueError):
        BlockAllocator(0)


def test_block_exhaustion_delays_admission(models, reference):
    """A pool of 8 blocks seats at most two of these requests at a time:
    admission waits for retirements (slots stay free while the queue is
    not empty) and every stream still comes out equal to the reference."""
    _, _, model = models
    prompts, plain, _, _ = reference
    engine = _port_engine(model, paged_kv=PagedKVConfig(block_tokens=16, num_blocks=8))
    for i, p in enumerate(prompts):
        assert engine.submit(Request(prompt=list(p),
                                     params=SamplingParams(max_new_tokens=N_NEW, seed=i))).accepted
    outs, starved = {}, False
    while engine.has_work:
        for o in engine.step():
            outs[o.request_id] = (o.tokens, o.finish_reason)
        starved |= engine.active_slots < engine.max_concurrency and engine.scheduler.queue_depth > 0
        assert engine._allocator.free_count >= 0
    assert starved
    assert outs == plain
    assert engine._allocator.free_count == 8


def test_retired_slot_table_row_parks_at_sentinel(models):
    _, _, model = models
    engine = _port_engine(model, pipeline_depth=1)  # synchronous: a finish shows in its step
    sentinel = engine._allocator.num_blocks
    engine.submit(Request(prompt=[1, 2, 3], params=SamplingParams(max_new_tokens=2)))
    engine.submit(Request(prompt=list(range(30)), params=SamplingParams(max_new_tokens=8)))
    finished = engine.step()  # admits both; the 2-token request retires after one decode
    assert [o.request_id for o in finished] == [0]
    tables = engine._d_tables
    assert (tables[0] == sentinel).all()  # slot 0: retired, parked
    assert (tables[1, :3] < sentinel).all() and (tables[1, 3:] == sentinel).all()
    while engine.has_work:
        engine.step()
    assert (engine._d_tables == sentinel).all()
    assert engine._allocator.free_count == sentinel


@pytest.mark.parametrize("kw,exc,match", [
    (dict(paged_kv=PagedKVConfig(block_tokens=6)), ValueError, "power of two dividing"),
    (dict(paged_kv=PagedKVConfig(block_tokens=256)), ValueError, "power of two dividing"),
    (dict(paged_kv=PagedKVConfig(num_blocks=4)), ValueError, "num_blocks"),
    (dict(paged_attention="pallas"), ValueError, "gather.*fused"),
    (dict(paged_kv=False, paged_attention="fused"), ValueError, "requires paged_kv"),
    (dict(pipeline_depth=0), ValueError, "pipeline_depth"),
    (dict(tokens_per_sync=0), ValueError, "tokens_per_sync"),
    (dict(max_concurrency=0), ValueError, "max_concurrency"),
    (dict(admit_batch=0), ValueError, "admit_batch"),
    (dict(prompt_buckets=(512,)), ValueError, "no prompt bucket"),
])
def test_engine_validation(models, kw, exc, match):
    _, _, model = models
    with pytest.raises(exc, match=match):
        _port_engine(model, **kw)


def test_engine_defaults_pinned_beside_the_reference():
    """The port's engine defaults are the reference's (the slot pool, the
    gather oracle, depth 2, and every observability hook off: no tracer,
    telemetry, anomaly monitor, tracker or shared metrics): pinned on both
    sides, so a change to either shows here."""
    import inspect

    def defaults(cls):
        sig = inspect.signature(cls.__init__).parameters
        return {k: sig[k].default for k in (
            "pipeline_depth", "paged_kv", "paged_attention", "tracer", "telemetry", "anomaly",
            "tracker", "metrics_log_every", "metrics")}

    assert defaults(ServingEngine) == defaults(JaxServingEngine) == dict(
        pipeline_depth=2, paged_kv=False, paged_attention="gather", tracer=None, telemetry=None,
        anomaly=None, tracker=None, metrics_log_every=0, metrics=None)


def test_paged_kv_false_serves_from_the_slot_pool(models, reference):
    """``paged_kv=False`` (the default) builds the slot-pool engine: no block
    pool, allocator or tables, a ``[max_concurrency]`` write index, and the
    reference paged engine's greedy streams, which its own tests hold equal
    to its slot engine's."""
    _, _, model = models
    prompts, plain, _, _ = reference
    engine = ServingEngine(model, device="cpu", paged_kv=False, **ENGINE_KW)
    assert not engine.paged and engine._allocator is None and engine._d_tables is None
    assert tuple(engine._cache.index.shape) == (ENGINE_KW["max_concurrency"],)
    reqs = [Request(prompt=list(p), params=SamplingParams(max_new_tokens=N_NEW, seed=i))
            for i, p in enumerate(prompts)]
    assert {o.request_id: (o.tokens, o.finish_reason) for o in engine.run(reqs)} == plain


def test_submit_rejections(models):
    _, _, model = models
    engine = _port_engine(model)
    assert engine.submit([]).reason == REJECT_EMPTY_PROMPT
    assert engine.submit(list(range(65))).reason == REJECT_PROMPT_TOO_LONG
    assert not engine.has_work
    outs = engine.run([Request(prompt=[]), Request(prompt=[4, 5], params=SamplingParams(max_new_tokens=2))])
    assert outs[0].finish_reason == f"rejected:{REJECT_EMPTY_PROMPT}"


def test_sampled_requests_are_deterministic_alone_or_batched(models):
    _, _, model = models
    prompts = _prompts(3, (6, 19, 30, 11, 44))
    sp = SamplingParams(temperature=0.8, top_k=7, seed=5, max_new_tokens=10)
    alone = _port_run(model, prompts[:1], params=sp)[0][0]
    mixed = [Request(prompt=list(prompts[0]), params=sp)] + [
        Request(prompt=list(p), params=SamplingParams(
            temperature=0.8 if i % 2 else 0.0, top_k=None, seed=100 + i, max_new_tokens=10))
        for i, p in enumerate(prompts[1:])]
    batched = _port_engine(model).run(mixed)[0].tokens
    solo = generate(model, torch.tensor([prompts[0]]), 10, temperature=0.8, top_k=7,
                    generator=torch.Generator().manual_seed(5), device="cpu")[0].tolist()
    assert alone == batched == solo
    greedy = _port_run(model, prompts[:1], params=SamplingParams(max_new_tokens=10))[0][0]
    assert alone != greedy  # the sampler really sampled


def test_run_max_steps_aborts_the_rest(models):
    _, _, model = models
    # synchronous, so every dispatched token is fetched before the abort
    outs = _port_engine(model, pipeline_depth=1).run(
        [Request(prompt=[1, 2, 3], params=SamplingParams(max_new_tokens=50)) for _ in range(6)],
        max_steps=3)
    assert len(outs) == 6 and all(o.finish_reason == "aborted" for o in outs)
    # four slots, three steps: the first step's admission samples a token too
    assert sum(len(o.tokens) for o in outs) == 4 * (1 + 3)


def test_device_none_means_cuda(monkeypatch, models):
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model)


def test_frontier_write_matches_reference():
    """One decode write with a frozen row and a sentinel-parked row: the
    reference's ``mode="drop"`` scatter and the port's sink block leave the
    same pool."""
    r = np.random.default_rng(0)
    nb, bt, kvh, d, b = 6, 4, 2, 8, 4
    pool = r.standard_normal((nb, bt, kvh, d)).astype(np.float32)
    new = r.standard_normal((b, 1, kvh, d)).astype(np.float32)
    idx = np.asarray([0, 5, 3, 7], np.int32)
    mask = np.asarray([True, False, True, True])
    tables = np.asarray([[2, 0], [1, 3], [nb, nb], [4, 5]], np.int32)
    (want,), _ = jax_frontier_write((jnp.asarray(pool),), (jnp.asarray(new),), jnp.asarray(idx),
                                    jnp.asarray(mask), None, nb, bt, jnp.asarray(tables))
    storage = torch.cat([torch.from_numpy(pool), torch.zeros(1, bt, kvh, d)])
    paged_frontier_write((storage,), (torch.from_numpy(new),), torch.from_numpy(idx),
                         torch.from_numpy(mask), torch.from_numpy(tables))
    np.testing.assert_array_equal(storage[:nb].numpy(), np.asarray(want))


def test_scatter_rows_to_blocks_lands_rows_in_their_blocks():
    bt, kvh, d = 4, 2, 3
    cache = make_block_pool(1, 3, 8, bt, kvh, d, torch.float32, "cpu")
    rows = torch.randn(2, 6, kvh, d)  # two prefilled rows of bucket 6
    dest = torch.tensor([[5, 2], [7, 8]])  # row 1's second piece is pad: dropped (id 8)
    scatter_rows_to_blocks(cache, [(rows, rows + 1)], torch.tensor([2, 0]), dest,
                           torch.tensor([6, 3], dtype=torch.int32))
    k, v = cache.pools(0)
    torch.testing.assert_close(k[5], rows[0, :4])
    torch.testing.assert_close(k[2, :2], rows[0, 4:])
    torch.testing.assert_close(k[7], rows[1, :4])
    torch.testing.assert_close(v[7], rows[1, :4] + 1)
    assert cache.index.tolist() == [3, 0, 6]
    assert not k[[0, 1, 3, 4, 6]].any()  # nothing else written
